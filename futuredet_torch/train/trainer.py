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

The sparse middle never drops a site; the only budget is the voxelizer's
`max_voxels_train` per sample, and a sample that reaches it draws a
warning (the counterpart of the JAX package's capacity check). The
TensorBoard hook, the prefetcher and data parallelism are queued in
ROADMAP.md.
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
from ..models.detector import build_detector, resolve_device
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
    return {k: (_to_device(v, dev) if isinstance(v, dict)
                else v.to(dev, non_blocking=True)
                if isinstance(v, torch.Tensor) else v)
            for k, v in batch.items()}


def train(cfg: ExperimentConfig, batches: Iterable[Dict], *,
          steps_per_epoch: int, work_dir: Optional[str] = None,
          resume: bool = False, hooks: Optional[List[Hook]] = None,
          val_fn: Optional[Callable[[TrainState], Dict]] = None,
          device=None, log_fn: Callable[[str], None] = log.info
          ) -> TrainState:
    """Run the schedule of `cfg.train.total_epochs` epochs over `batches`
    (an iterator of {"points", "points_valid", "targets_raw"} batches,
    e.g. `data/synthetic.py::make_batch`) on `device` (default: the card),
    from `build_detector(cfg, seed=cfg.train.seed)`. At each epoch's end
    `val_fn(state)`, if given, runs with the model in eval mode and no
    autograd, and its dict is logged. Returns the state after the last step
    taken."""
    total_steps = steps_per_epoch * cfg.train.total_epochs
    dev = resolve_device(device)
    model = build_detector(cfg, device=dev, seed=cfg.train.seed).train()
    state = TrainState(0, model, make_optimizer(cfg, model, total_steps))
    ckpt = CheckpointManager(work_dir) if work_dir else None
    if resume and ckpt and ckpt.latest_step() is not None:
        state.step = ckpt.restore(model, state.optimizer)
        log_fn(f"resumed from step {state.step}")

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
    try:
        _run_loop(cfg, state, iter(batches), dev, total_steps,
                  steps_per_epoch, ckpt, hooks or [], val_fn, preempted,
                  log_fn)
    finally:
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
              hooks, val_fn, preempted, log_fn):
    buf = MetricBuffer()
    budget = cfg.voxel.max_voxels_train
    warned = False
    t_data = t_step = 0.0
    t0 = time.perf_counter()
    start = state.step
    for step in range(start, total_steps):
        td = time.perf_counter()
        batch = _to_device(next(it), dev)
        t_data += time.perf_counter() - td
        for h in hooks:
            h.before_step(step, state, batch)
        ts = time.perf_counter()
        metrics = train_step(state.model, state.optimizer, batch, step)
        t_step += time.perf_counter() - ts
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
            log_fn(f"step {step + 1}/{total_steps} loss {m['loss']:.4f} "
                   f"data {t_data:.2f}s step {t_step:.2f}s "
                   f"({elapsed / (step + 1 - start):.2f}s/it)")
            t_data = t_step = 0.0
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
