"""Training CLI on synthetic scenes, with per-epoch validation.

The port's counterpart of `futuredet_tpu/cli/train.py` (reference
`train.py` + `tools/train.py`): model names resolve to configs, work dirs
are `models/{experiment}/{dataset}_{architecture}_{model}_detection`, and
`--synthetic N` trains on N scenes of `data/synthetic.py` (seeds seed + i,
lidar-statistics clutter), cycled.

  python -m futuredet_torch.cli.train --model pp_forecast_n3dtf \\
      --synthetic 64 --epochs 2 --val_synthetic 4

It runs on the card unless given `--device cpu`, and raises when no card is
found. The real-data pipeline, two-stage grafting, TensorBoard, the
profiler, spatial sharding and multi-process training raise, naming their
ROADMAP.md items.
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import logging
import os

import numpy as np

log = logging.getLogger(__name__)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train a futuredet_torch model")
    p.add_argument("--model", default="pp_forecast_n3dtf",
                   help="config name (forecast_n3dtf, pp_forecast_n3dtf, ...)")
    p.add_argument("--experiment", default="FutureDetection")
    p.add_argument("--dataset", default="nusc")
    p.add_argument("--architecture", default="centerpoint")
    p.add_argument("--info_path", default=None, help="nuScenes infos pkl")
    p.add_argument("--db_info_path", default=None, help="GT-AUG dbinfos pkl")
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
                        "parallel devices (ref tools/train.py:94-95)")
    p.add_argument("--space", type=int, default=1,
                   help="spatial sharding of the BEV rows (not ported)")
    p.add_argument("--first_stage_checkpoint", default=None,
                   help="two-stage configs (not ported)")
    p.add_argument("--coordinator_address", default=None,
                   help="multi-process training (not ported)")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--tiny", action="store_true",
                   help="shrunken geometry for smoke tests")
    p.add_argument("--profile", default=None, help="trace dir (not ported)")
    p.add_argument("--tensorboard", action="store_true",
                   help="scalars to {work_dir}/tb (not ported)")
    p.add_argument("--device", default="cuda",
                   help="torch device; cuda (the default) raises without a "
                        "card, cpu runs the plain PyTorch versions")
    return p.parse_args(argv)


def refuse_unported(args, cfg) -> None:
    """Flags whose paths the port does not have yet raise, naming their
    ROADMAP.md item."""
    if args.info_path or args.db_info_path:
        raise NotImplementedError(
            "--info_path / --db_info_path: the nuScenes data pipeline and "
            "GT-AUG are not ported yet (ROADMAP.md, queue 1: the data "
            "pipeline); use --synthetic N")
    if args.first_stage_checkpoint or cfg.model.two_stage_refine:
        raise NotImplementedError(
            "two-stage configs and --first_stage_checkpoint are not ported "
            "yet (ROADMAP.md, queue 1: long tail, models/two_stage.py)")
    if args.tensorboard:
        raise NotImplementedError(
            "--tensorboard: the TensorBoard hook is not ported yet "
            "(ROADMAP.md, queue 1: the trainer's extras)")
    if args.profile:
        raise NotImplementedError(
            "--profile: utils/profiling.py is not ported yet (ROADMAP.md, "
            "queue 1: long tail)")
    if args.space > 1 or args.coordinator_address \
            or (args.num_processes or 1) > 1:
        raise NotImplementedError(
            "--space > 1 and multi-process training are not ported yet "
            "(ROADMAP.md, queue 1: DDP)")


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
    """Per-epoch validation (ref Trainer.val): inference, linking and the
    joint metrics on a fixed synthetic split (seed 10 000), as the JAX CLI
    runs it (its multitask branch waits for a multitask decode). Returns
    state -> {"mAP", "mFAP"}."""
    from ..data.synthetic import make_batch
    from ..eval.decode import decode_and_nms
    from ..eval.evaluator import evaluate_detections

    vb = make_batch(cfg, max(n, 1), seed=10_000, clutter_mode="lidar",
                    device=device)
    tokens = [f"v{i}" for i in range(vb["points"].shape[0])]
    mode = ("velocity_constant" if cfg.model.head.standard
            else "velocity_dense")

    def val_fn(state):
        det = decode_and_nms(cfg, state.model(vb["points"],
                                              vb["points_valid"]))
        res = evaluate_detections(cfg, det, vb["gt"], tokens,
                                  forecast_mode=mode,
                                  classname=cfg.data.class_names[0])
        return {"mAP": round(float(np.mean(
                    list(res.mean_dist_aps.values()))), 4),
                "mFAP": round(float(np.mean(
                    list(res.mean_dist_faps.values()))), 4)}
    return val_fn


def main(argv=None):
    from ..config import get_config, tiny_variant
    from ..data.synthetic import make_batch
    from ..models.detector import resolve_device
    from ..train.trainer import train

    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    cfg = get_config(args.model)
    if args.tiny:
        cfg = tiny_variant(cfg)
    refuse_unported(args, cfg)
    if not args.synthetic:
        raise SystemExit("no dataset: pass --synthetic N")
    dev = resolve_device(args.device)
    cfg = train_config(cfg, args)
    work_dir = args.work_dir or os.path.abspath(
        f"models/{args.experiment}/{args.dataset}_{args.architecture}_"
        f"{args.model}_detection")
    batch_size = args.batch_size or cfg.train.batch_size_per_device

    n_batches = max(args.synthetic // batch_size, 1)
    cached = []
    for i in range(n_batches):
        b = make_batch(cfg, batch_size, seed=args.seed + i,
                       clutter_mode="lidar")
        b.pop("gt")
        cached.append(b)

    val_fn = make_val_fn(cfg, args.val_synthetic, dev) \
        if args.val_synthetic else None
    state = train(cfg, itertools.cycle(cached), steps_per_epoch=n_batches,
                  work_dir=work_dir, resume=args.resume_from, val_fn=val_fn,
                  device=dev)
    log.info("training done at step %d; checkpoints in %s", state.step,
             work_dir)
    return state


if __name__ == "__main__":
    main()
