"""Training CLI on nuScenes infos or synthetic scenes, with per-epoch
validation.

The port's counterpart of `futuredet_tpu/cli/train.py` (reference
`train.py` + `tools/train.py`): model names resolve to configs, work dirs
are `models/{experiment}/{dataset}_{architecture}_{model}_detection`.
`--info_path` trains on the infos pkl of `cli/create_data.py` through the
data pipeline (`data/pipeline.py`: CBGS, GT-AUG from the dbinfos next to
the infos unless `--no_gt_aug`, the augmentations), prefetched on a
thread; `--synthetic N` trains on N scenes of `data/synthetic.py` (seeds
seed + i, lidar-statistics clutter), cycled. `--tensorboard` logs the
scalars to {work_dir}/tb.

  python -m futuredet_torch.cli.train --model forecast_n3dtf \\
      --info_path R/infos_train_20sweeps_withvelo_filter_True.pkl
  python -m futuredet_torch.cli.train --model pp_forecast_n3dtf \\
      --synthetic 64 --epochs 2 --val_synthetic 4

A `_two_stage` config trains the RoI head and the vel / rot branches of
its first stage (`models/two_stage.py`); `--first_stage_checkpoint DIR`
grafts the latest checkpoint of the single-stage config (the name without
`_two_stage`, its tiny variant under `--tiny`) into the first stage before
the first step:

  python -m futuredet_torch.cli.train --model pp_forecast_n3dtf_two_stage \\
      --synthetic 64 --first_stage_checkpoint work/pp --work_dir work/pp2

It runs on the card unless given `--device cpu`, and raises when no card is
found.

Data-parallel training runs one process per card, each started with the
same flags and its own `--process_id` (0 .. `--num_processes` - 1), all
meeting at `--coordinator_address host:port` (rank 0 listens there): NCCL
between cards, gloo with `--device cpu`. Each rank takes its strided
share of the infos (`batches_from_dataset(num_shards, shard_id)`; every
rank trains on the same `--synthetic` scenes, as the JAX CLI does), the
step averages BatchNorm statistics and gradients over the ranks, and rank
0 writes the checkpoints. `--autoscale_lr` scales lr_max by the world
size. `--batch_size` is per rank:

  python -m futuredet_torch.cli.train --model forecast_n3dtf --info_path P \
      --coordinator_address 10.0.0.1:29500 --num_processes 8 --process_id R

`--profile DIR` wraps the training in a `torch.profiler` trace of the
host and the card (`utils/profiling.py::trace`), written into DIR.

`--space S` shards the BEV canvas's rows over S ranks (the JAX CLI's
GSPMD spatial sharding; `parallel/mesh.py`, `train/step.py`): the
`--num_processes` ranks are `n_data x S`, rank r is data index r // S and
space index r % S, the ranks of a space group read the same batches (the
shard of their data index) and each holds a band of the rows through the
RPN and the head. Steps per epoch and `--autoscale_lr` count the data
ranks. Under NCCL every rank needs its own card (NCCL refuses two ranks
on one device); on the CPU, gloo ranks with `--device cpu`:

  python -m futuredet_torch.cli.train --model pp_forecast_n3dtf --tiny \
      --device cpu --synthetic 4 --space 2 --num_processes 2 \
      --process_id R --coordinator_address 127.0.0.1:29500

Every config takes `--space`; a two-stage config's RoI stage runs whole on
every rank of a space group, on the gathered maps:

  python -m futuredet_torch.cli.train --model pp_forecast_n3dtf_two_stage \
      --tiny --device cpu --synthetic 4 --space 2 --num_processes 2 \
      --process_id R --coordinator_address 127.0.0.1:29500
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import itertools
import logging
import os

import numpy as np

log = logging.getLogger(__name__)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train a futuredet_torch model")
    p.add_argument("--model", default="forecast_n0",
                   help="config name (forecast_n0/n3/n3dtf[m], "
                        "pedestrian_*, pp_*, *_two_stage)")
    p.add_argument("--experiment", default="FutureDetection")
    p.add_argument("--dataset", default="nusc")
    p.add_argument("--architecture", default="centerpoint")
    p.add_argument("--info_path", default=None, help="nuScenes infos pkl")
    p.add_argument("--db_info_path", default=None,
                   help="GT-AUG dbinfos pkl (default: dbinfos_train_"
                        "{nsweeps}sweeps_withvelo.pkl next to --info_path)")
    p.add_argument("--no_gt_aug", action="store_true",
                   help="disable GT-AUG paste sampling even when dbinfos "
                        "exist (ref db_sampler, configs n3dtf:110-141)")
    p.add_argument("--synthetic", type=int, default=0,
                   help="train on N synthetic scenes")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--checkpoint_interval", type=int, default=None,
                   help="epochs between checkpoint saves (default: the "
                        "config's, every epoch)")
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--work_dir", default=None)
    p.add_argument("--resume_from", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--val_synthetic", type=int, default=0,
                   help="per-epoch validation on N synthetic samples "
                        "(ref Trainer.val workflow)")
    p.add_argument("--autoscale_lr", action="store_true",
                   help="scale lr_max linearly by the number of data-"
                        "parallel ranks (ref tools/train.py:94-95)")
    p.add_argument("--space", type=int, default=1,
                   help="ranks of a space group, which shard the BEV rows "
                        "of one batch (it divides --num_processes)")
    p.add_argument("--first_stage_checkpoint", default=None,
                   help="a *_two_stage config: graft the latest checkpoint "
                        "in this directory of the single-stage config into "
                        "the first stage")
    p.add_argument("--coordinator_address", default=None,
                   help="data-parallel training: host:port of rank 0, where "
                        "the torch.distributed process group meets")
    p.add_argument("--num_processes", type=int, default=None,
                   help="ranks of the process group, one per card")
    p.add_argument("--process_id", type=int, default=None,
                   help="this process's rank")
    p.add_argument("--tiny", action="store_true",
                   help="shrunken geometry for smoke tests")
    p.add_argument("--debug", action="store_true",
                   help="accepted as the JAX CLI accepts it; reads nothing")
    p.add_argument("--profile", default=None,
                   help="capture a torch.profiler trace (host and card) to "
                        "this log dir")
    p.add_argument("--tensorboard", action="store_true",
                   help="log scalars to {work_dir}/tb (ref torchie "
                        "TensorboardLoggerHook)")
    p.add_argument("--device", default="cuda",
                   help="torch device; cuda (the default) raises without a "
                        "card, cpu runs the plain PyTorch versions")
    return p.parse_args(argv)


def train_config(cfg, args, n_devices: int = 1):
    """cfg with the flags applied by `dataclasses.replace`, which keeps
    every field the flags do not name."""
    tc = cfg.train
    if args.epochs or args.checkpoint_interval:
        tc = dataclasses.replace(
            tc, total_epochs=args.epochs or tc.total_epochs, seed=args.seed,
            checkpoint_interval_epochs=args.checkpoint_interval
            or tc.checkpoint_interval_epochs)
    if args.autoscale_lr:
        tc = dataclasses.replace(tc, optim=dataclasses.replace(
            tc.optim, lr_max=tc.optim.lr_max * n_devices))
    return cfg.replace(train=tc)


def make_val_fn(cfg, n: int, device):
    """Per-epoch validation (ref Trainer.val) on a fixed synthetic split
    (seed 10 000), as the JAX CLI runs it: inference, then class-labeled
    detection metrics for multitask class groups, or linking
    (velocity_constant for standard heads, velocity_dense otherwise) and
    the joint metrics; a two-stage model scores its refined detections
    (JAX cli/train.py:192-195). Returns state -> {"mAP", "mFAP"}."""
    from ..data.synthetic import make_batch
    from ..eval.decode import decode_and_nms
    from ..eval.evaluator import (evaluate_detections,
                                  evaluate_detections_multitask)
    from ..models.two_stage import refined_detections

    vb = make_batch(cfg, max(n, 1), seed=10_000, clutter_mode="lidar",
                    device=device)
    tokens = [f"v{i}" for i in range(vb["points"].shape[0])]
    h = cfg.model.head
    mode = "velocity_constant" if h.standard else "velocity_dense"

    def val_fn(state):
        out = state.model(vb["points"], vb["points_valid"],
                          vb.get("bev_map"))
        det = (refined_detections(*out[1:]) if cfg.model.two_stage_refine
               else decode_and_nms(cfg, out))
        if h.multitask:
            res = evaluate_detections_multitask(cfg, det, vb["gt"], tokens)
        else:
            res = evaluate_detections(cfg, det, vb["gt"], tokens,
                                      forecast_mode=mode,
                                      classname=cfg.data.class_names[0])
        return {"mAP": round(float(np.mean(
                    list(res.mean_dist_aps.values()))), 4),
                "mFAP": round(float(np.mean(
                    list(res.mean_dist_faps.values()))), 4)}
    return val_fn


def first_stage_graft(args, device):
    """The trainer's `init_transform` for --first_stage_checkpoint (JAX
    cli/train.py:213-241): the latest checkpoint of the single-stage config
    restored into its own detector, then merged under the two-stage
    model's `first_stage.` keys by `adopt_first_stage` (the two-stage
    convs and the RoI head keep their init)."""
    from ..config import get_config, tiny_variant
    from ..models.detector import build_detector
    from ..models.two_stage import adopt_first_stage
    from ..train.checkpoints import CheckpointManager

    single = get_config(args.model.removesuffix("_two_stage"))
    if args.tiny:
        single = tiny_variant(single)

    def init_transform(state):
        first = build_detector(single, device=device)
        step = CheckpointManager(args.first_stage_checkpoint).restore(first)
        log.info("grafted first-stage checkpoint step %d from %s", step,
                 args.first_stage_checkpoint)
        state.model.load_state_dict(adopt_first_stage(
            state.model.state_dict(), first.state_dict()))
        return state
    return init_transform


def info_batches(cfg, args, batch_size: int, pin_memory: bool):
    """The real-data branch of the JAX CLI: GT-AUG unless --no_gt_aug, the
    CBGS-resampled train dataset of --info_path, and the strided share of
    its looping batches of this rank's data index (the ranks of a
    `--space` group share one) without the host `gt` and `tokens`.
    Returns (cfg with the data's point width, batches, steps per
    epoch)."""
    from ..data.pipeline import batches_from_dataset, info_dataset
    from ..parallel.collectives import rank, world_size
    n_data = world_size() // args.space

    # GT-AUG paste sampler (ref Preprocess builds it whenever the config
    # carries a db_sampler dict, preprocess.py:103-106; groups from
    # cfg.data.sample_groups mirror configs n3dtf:110-123)
    cfg, ds = info_dataset(cfg, args.info_path, train=True, seed=args.seed,
                           gt_aug=not args.no_gt_aug,
                           db_info_path=args.db_info_path)
    if ds.db_sampler is not None:
        log.info("GT-AUG enabled (groups %s)", dict(cfg.data.sample_groups))
    elif not args.no_gt_aug:
        log.warning("GT-AUG disabled: no dbinfos next to %s", args.info_path)
    batches = ({k: v for k, v in b.items() if k not in ("gt", "tokens")}
               for b in batches_from_dataset(ds, cfg, batch_size,
                                             seed=args.seed,
                                             pin_memory=pin_memory,
                                             num_shards=n_data,
                                             shard_id=rank() // args.space))
    return cfg, batches, max(len(ds) // (batch_size * n_data), 1)


def main(argv=None):
    from ..config import get_config, tiny_variant
    from ..models.detector import resolve_device
    from ..parallel.collectives import initialize_multihost, leave, rank
    from ..parallel.mesh import data_axis_size

    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    cfg = get_config(args.model)
    if args.tiny:
        cfg = tiny_variant(cfg)
    if args.first_stage_checkpoint and not cfg.model.two_stage_refine:
        raise SystemExit("--first_stage_checkpoint requires a *_two_stage "
                         "config")
    if not args.synthetic and not args.info_path:
        raise SystemExit(
            "no dataset: pass --info_path <infos pkl> or --synthetic N")
    dev = resolve_device(args.device)
    n_proc = initialize_multihost(args.coordinator_address,
                                  args.num_processes, args.process_id, dev)
    try:
        if n_proc > 1:
            log.info("data-parallel training: process %d/%d, %d ranks a "
                     "space group", rank(), n_proc, args.space)
        return _train(args, cfg, dev, data_axis_size(args.space))
    finally:
        leave(args.coordinator_address)


def _train(args, cfg, dev, n_data: int):
    from ..data.synthetic import make_batch
    from ..parallel.collectives import rank
    from ..train.trainer import TensorBoardHook, train
    from ..utils.profiling import trace

    cfg = train_config(cfg, args, n_data)
    work_dir = args.work_dir or os.path.abspath(
        f"models/{args.experiment}/{args.dataset}_{args.architecture}_"
        f"{args.model}_detection")
    batch_size = args.batch_size or cfg.train.batch_size_per_device

    if args.synthetic:
        n_batches = max(args.synthetic // batch_size, 1)
        cached = []
        for i in range(n_batches):
            b = make_batch(cfg, batch_size, seed=args.seed + i,
                           clutter_mode="lidar")
            b.pop("gt")
            cached.append(b)
        batches, steps_per_epoch = itertools.cycle(cached), n_batches
    else:
        cfg, batches, steps_per_epoch = info_batches(
            cfg, args, batch_size, pin_memory=dev.type == "cuda")

    val_fn = make_val_fn(cfg, args.val_synthetic, dev) \
        if args.val_synthetic else None
    hooks = []
    if args.tensorboard and rank() == 0:
        hooks.append(TensorBoardHook(os.path.join(work_dir, "tb"),
                                     interval=cfg.train.log_interval))
    init_transform = (first_stage_graft(args, dev)
                      if args.first_stage_checkpoint else None)
    with (trace(args.profile) if args.profile
          else contextlib.nullcontext()):
        state = train(cfg, batches, steps_per_epoch=steps_per_epoch,
                      work_dir=work_dir, resume=args.resume_from,
                      val_fn=val_fn, hooks=hooks, device=dev,
                      init_transform=init_transform, n_space=args.space)
    log.info("training done at step %d; checkpoints in %s", state.step,
             work_dir)
    return state


if __name__ == "__main__":
    main()
