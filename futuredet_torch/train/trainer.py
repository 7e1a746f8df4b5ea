"""Training loop: hooks, interval logging, per-epoch checkpoints, resume,
preemption.

Port of `futuredet_tpu/train/trainer.py:113-261` for one device (the
reference's torchie Trainer and hooks,
`det3d/torchie/trainer/trainer.py:155-587`): a lean loop over
`train_step`, a log line every `cfg.train.log_interval` steps, a checkpoint
every `checkpoint_interval_epochs` epochs, `resume=True` to continue from
the latest one, SIGTERM / SIGUSR1 (cluster preemption notices) turned
into a checkpoint at the next step boundary and a clean return, and
`val_fn(state)` at each epoch's end (the reference's Trainer.val phase),
its dict logged.

Batches come through the prefetcher (`data/prefetch.py`, `prefetch_depth`
batches ahead on one thread, as the JAX trainer has it), so the host
pipeline of the next batch runs while the card computes this one; pinned
batches (`data/pipeline.py::batches_from_dataset(pin_memory=True)`) then
copy to the card behind the host. `TensorBoardHook` logs the scalar
metrics.

The sparse middle never drops a site; the only budget is the voxelizer's
`max_voxels_train` per sample, and a sample that reaches it draws a
warning (the counterpart of the JAX package's capacity check).

Data parallel: in a `torch.distributed` process group
(`parallel/collectives.py::initialize_multihost`) every rank runs this
loop on its own batches from the same seeded init; the step averages the
statistics and gradients over the ranks, so the models stay equal, the
logged losses are rank means, and rank 0 alone writes checkpoints (every
rank reads one to resume). With `n_space` > 1 (the JAX trainer's
`n_space`, futuredet_tpu/train/trainer.py:116-138) the ranks form the
(data, space) layout of `parallel/mesh.py::make_space_group`: the ranks
of a space group take the same batches, each holding a band of the
canvas (`train/step.py`).
"""
from __future__ import annotations

import logging
import signal
import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional

import torch
from torch import nn

from ..config import ExperimentConfig
from ..data.prefetch import prefetch
from ..models.detector import build_detector, resolve_device
from ..parallel.collectives import rank
from ..utils.profiling import Recorder, span, totals, unit
from .checkpoints import CheckpointManager
from .step import make_optimizer, train_step

log = logging.getLogger("futuredet_torch")


@dataclass
class TrainState:
    step: int                        # updates done
    model: nn.Module
    optimizer: torch.optim.Optimizer


class Hook:
    """Training-hook protocol (the reference's hook registry reduced to the
    four events the loop fires). Hooks run in registration order."""

    def before_step(self, step: int, state: TrainState, batch: Dict):
        pass

    def after_step(self, step: int, state: TrainState, metrics: Dict):
        pass

    def after_epoch(self, epoch: int, state: TrainState):
        pass

    def after_train(self, state: TrainState):
        pass


class TensorBoardHook(Hook):
    """Scalar logging to TensorBoard (ref torchie TensorboardLoggerHook,
    det3d/torchie/trainer/hooks/logger/tensorboard.py), as the JAX
    package's hook: the means of the 0-d metrics over each `interval`
    steps as `train/<key>` at the window's last step, and the partial
    window past the last boundary at the end. Without
    `torch.utils.tensorboard` (or its event writer) one warning, then no
    logging."""

    def __init__(self, log_dir: str, interval: int = 25):
        self.interval = interval
        self._buf = MetricBuffer()
        self._last_step = 0
        try:
            from torch.utils.tensorboard import SummaryWriter
            self.writer = SummaryWriter(log_dir=log_dir)
        except Exception as e:
            log.warning("tensorboard unavailable (%s): TB logging disabled",
                        e)
            self.writer = None

    def after_step(self, step: int, state: TrainState, metrics: Dict):
        if self.writer is None:
            return
        self._buf.push({k: v for k, v in metrics.items()
                        if torch.as_tensor(v).dim() == 0})
        self._last_step = step
        if (step + 1) % self.interval == 0:
            for k, v in self._buf.mean_and_clear().items():
                self.writer.add_scalar(f"train/{k}", v, step + 1)

    def after_train(self, state: TrainState):
        if self.writer is None:
            return
        # the partial window past the last interval boundary
        for k, v in self._buf.mean_and_clear().items():
            self.writer.add_scalar(f"train/{k}", v, self._last_step + 1)
        self.writer.flush()
        self.writer.close()


class MetricBuffer:
    """Windowed means for log lines (ref torchie LogBuffer). `push` keeps
    the device tensors; `mean_and_clear` copies them to the host once."""

    def __init__(self):
        self.buf: Dict[str, List[torch.Tensor]] = {}

    def push(self, metrics: Dict[str, torch.Tensor]) -> None:
        for k, v in metrics.items():
            self.buf.setdefault(k, []).append(v)

    def mean_and_clear(self) -> Dict[str, float]:
        if not self.buf:
            return {}
        keys = list(self.buf)
        means = torch.stack([
            torch.stack([torch.as_tensor(x).float().mean()
                         for x in self.buf[k]]).mean() for k in keys])
        self.buf = {}
        return dict(zip(keys, means.cpu().tolist()))


def _to_device(batch: Dict, dev: torch.device) -> Dict:
    """Copy a batch's tensors to `dev`. From pinned memory the copies run
    behind the host; the caching host allocator keeps a pinned block from
    reuse until the copy that reads it is done."""
    return {k: (_to_device(v, dev) if isinstance(v, dict)
                else v.to(dev, non_blocking=True)
                if isinstance(v, torch.Tensor) else v)
            for k, v in batch.items()}


def train(cfg: ExperimentConfig, batches: Iterable[Dict], *,
          steps_per_epoch: int, work_dir: Optional[str] = None,
          resume: bool = False, hooks: Optional[List[Hook]] = None,
          val_fn: Optional[Callable[[TrainState], Dict]] = None,
          device=None, prefetch_depth: int = 2, n_space: int = 1,
          init_transform: Optional[Callable[[TrainState],
                                            TrainState]] = None,
          log_fn: Callable[[str], None] = log.info) -> TrainState:
    """Run the schedule of `cfg.train.total_epochs` epochs over `batches`
    (an iterator of {"points", "points_valid", "targets_raw"} batches, with
    "bev_map" for a bev_map config,
    e.g. `data/synthetic.py::make_batch` or `data/pipeline.py::
    batches_from_dataset`) on `device` (default: the card), from
    `build_detector(cfg, seed=cfg.train.seed)`. With `prefetch_depth` > 0
    a thread keeps that many batches ready ahead of the loop; 0 takes
    each batch from `batches` when the step needs it. At each epoch's end
    `val_fn(state)`, if given, runs with the model in eval mode and no
    autograd, and its dict is logged. `init_transform(state)`, if given,
    runs after the build and before a resume or any step (e.g. grafting a
    trained first stage into a two-stage model, JAX trainer.py:140-145).
    `n_space` > 1 shards the canvas's rows over space groups of that many
    ranks of the process group. Returns the state after the last step
    taken."""
    from ..models.detector import lay_out_space_
    from ..parallel.mesh import make_space_group
    total_steps = steps_per_epoch * cfg.train.total_epochs
    dev = resolve_device(device)
    model = lay_out_space_(build_detector(cfg, device=dev,
                                          seed=cfg.train.seed),
                           make_space_group(n_space)).train()
    state = TrainState(0, model, make_optimizer(cfg, model, total_steps))
    if init_transform is not None:
        state = init_transform(state)
    ckpt = CheckpointManager(work_dir) if work_dir else None
    if resume and ckpt and ckpt.latest_step() is not None:
        state.step = ckpt.restore(model, state.optimizer)
        log_fn(f"resumed from step {state.step}")
    if rank() != 0:
        ckpt = None                  # rank 0 writes the checkpoints

    # preemption notice -> checkpoint at the next step boundary
    preempted: List[int] = []
    olds = {}

    def _on_preempt(signum, frame):
        preempted.append(signum)
        log_fn(f"signal {signum}: will checkpoint and stop at the next "
               "step boundary")

    for sig in (signal.SIGTERM, signal.SIGUSR1):
        try:
            olds[sig] = signal.signal(sig, _on_preempt)
        except ValueError:          # not in the main thread
            pass
    it = prefetch(iter(batches), depth=prefetch_depth) \
        if prefetch_depth > 0 else iter(batches)
    # the log line's data and step seconds: the totals of the "data" and
    # "step" spans that `rec` recorded since the last line
    rec = Recorder().start()
    try:
        _run_loop(cfg, state, it, dev, total_steps, steps_per_epoch, ckpt,
                  hooks or [], val_fn, preempted, log_fn, rec)
    finally:
        rec.stop()
        if prefetch_depth > 0:
            it.close()
        # a leaked handler would make the process ignore later SIGTERMs
        for sig, old in olds.items():
            signal.signal(sig, old)
    for h in hooks or []:
        h.after_train(state)
    return state


def _validate(state: TrainState, val_fn) -> Dict:
    state.model.eval()
    try:
        with torch.no_grad():
            return val_fn(state)
    finally:
        state.model.train()


def _run_loop(cfg, state, it, dev, total_steps, steps_per_epoch, ckpt,
              hooks, val_fn, preempted, log_fn, rec):
    buf = MetricBuffer()
    budget = cfg.voxel.max_voxels_train
    warned = False
    t0 = time.perf_counter()
    start = state.step
    for step in range(start, total_steps):
        unit(step)
        with span("data"):
            batch = _to_device(next(it), dev)
        for h in hooks:
            h.before_step(step, state, batch)
        with span("step"):
            metrics = train_step(state.model, state.optimizer, batch, step)
        state.step = step + 1
        buf.push({"loss": metrics["loss"]})
        for h in hooks:
            h.after_step(step, state, metrics)
        full = [n for n in getattr(state.model, "num_voxels", [])
                if n >= budget]
        if full and not warned:
            log.warning("a sample of step %d holds %d voxels, the "
                        "max_voxels_train budget: voxels past it were "
                        "dropped", step, full[0])
            warned = True

        if preempted:
            if ckpt:
                ckpt.save(step + 1, state.model, state.optimizer,
                          {"config": cfg.name, "preempted": True})
                log_fn(f"preemption checkpoint @ step {step + 1}")
            return
        if (step + 1) % cfg.train.log_interval == 0:
            m = buf.mean_and_clear()
            elapsed = time.perf_counter() - t0
            t = totals(rec.stop())
            rec.start()
            log_fn(f"step {step + 1}/{total_steps} loss {m['loss']:.4f} "
                   f"data {t.get('data', 0.0):.2f}s step "
                   f"{t.get('step', 0.0):.2f}s "
                   f"({elapsed / (step + 1 - start):.2f}s/it)")
        if (step + 1) % steps_per_epoch == 0:
            epoch = (step + 1) // steps_per_epoch
            if val_fn is not None:
                log_fn(f"val @ epoch {epoch}: {_validate(state, val_fn)}")
            for h in hooks:
                h.after_epoch(epoch, state)
            if ckpt and epoch % cfg.train.checkpoint_interval_epochs == 0:
                ckpt.save(step + 1, state.model, state.optimizer,
                          {"config": cfg.name, "epoch": epoch})
                log_fn(f"checkpoint @ step {step + 1} (epoch {epoch})")
