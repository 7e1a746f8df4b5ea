"""Evaluation CLI: inference on the card, linking and the joint detection +
forecasting metrics.

The port's counterpart of `futuredet_tpu/cli/evaluate.py`, with the
reference `evaluate.py`'s flags (README.md:174-185): --forecast_mode,
--rerank, --tp_pct, --cohort_analysis, --K, --static_only, --nogroup,
--extractBox. It writes the metrics JSON and the reference CSV columns of
evaluate.py:22-54.

  python -m futuredet_torch.cli.evaluate --model forecast_n3dtf \\
      --info_path R/infos_val_20sweeps_withvelo_filter_True.pkl
  python -m futuredet_torch.cli.evaluate --model pp_forecast_n3dtf \\
      --synthetic 8 --checkpoint_dir work/pp --forecast_mode velocity_dense \\
      --cohort_analysis --K 5

`--info_path` evaluates the infos pkl of `cli/create_data.py` in order
through the data pipeline (`data/pipeline.py`, no augmentation). Its
batches stream from a prefetch thread: where the JAX CLI holds the whole
evaluation set in memory, this one holds a few batches. `--synthetic N`
evaluates N scenes of `data/synthetic.py`.

It runs on the card unless given `--device cpu`, and raises when no card is
found. Per batch, `build_detector` -> forward -> `decode_and_nms` (or a
double flip, `--tta map|box`; a two-stage model's refined detections,
without `--tta`) runs on the device; the detections are copied
to the host behind the batch's work, and the host tail of a batch (linking,
records) runs while the card computes the next one (a queue of depth 2).

Multi-process evaluation, one process per card with the train CLI's
`--coordinator_address`, `--num_processes` and `--process_id` (NCCL; gloo
with `--device cpu`): each rank evaluates a strided share of the batches
(synthetic) or samples (infos, `batches_from_dataset(num_shards,
shard_id)`), every batch's detections, GT and tokens are gathered to
every rank (`parallel/collectives.py::gather_eval_batch`), each rank
scores the whole set, and rank 0 writes the metrics and the
`--extractBox` pickle, as the JAX CLI does
(`futuredet_tpu/cli/evaluate.py:90-127,249-256`). Every rank must get as
many batches as the others.

`--space S` shards the BEV rows of each batch over S ranks (the train
CLI's layout: rank r is data index r // S and space index r % S): the
ranks of a space group run the forward of the same batches, their data
index's share, and the first rank of each space group decodes, gathers
its share's detections over the data ranks and scores the set; rank 0
writes the metrics. Under NCCL every rank needs its own card.
"""
from __future__ import annotations

import argparse
import csv
import json
import logging
import os
import pickle
import time
from collections import deque

import numpy as np

log = logging.getLogger(__name__)

CSV_COLUMNS = {"mAP": "mean_dist_aps", "mAR": "mean_dist_ars",
               "mFAP": "mean_dist_faps", "mFAR": "mean_dist_fars",
               "mAAP": "mean_dist_aaps", "mAAR": "mean_dist_aars"}
TP_COLUMNS = {"ATE": "trans_err", "ASE": "scale_err", "AOE": "orient_err",
              "AVE": "vel_err", "AAE": "attr_err", "ADE": "avg_disp_err",
              "FDE": "final_disp_err", "MR": "miss_rate"}
# the reference CSV's column order (evaluate.py:34-53)
CSV_HEADER = ["CLASS", "mAP", "mAR", "mFAP", "mFAR", "mAAP", "mAAR", "ATE",
              "ASE", "AOE", "AVE", "AAE", "ADE", "FDE", "MR", "mFAP_MR"]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Evaluate a futuredet_torch "
                                            "model")
    p.add_argument("--model", default="forecast_n0")
    p.add_argument("--experiment", default="FutureDetection")
    p.add_argument("--dataset", default="nusc")
    p.add_argument("--architecture", default="centerpoint")
    p.add_argument("--info_path", default=None)
    p.add_argument("--synthetic", type=int, default=0)
    p.add_argument("--checkpoint_dir", default=None)
    p.add_argument("--modelCheckPoint", default="latest",
                   help="latest, epoch_N or a step")
    p.add_argument("--forecast_mode", default="velocity_forward")
    p.add_argument("--rerank", default="last",
                   choices=["first", "last", "add", "mult"])
    p.add_argument("--tp_pct", type=float, default=0.6)
    p.add_argument("--K", type=int, default=1)
    p.add_argument("--cohort_analysis", action="store_true")
    p.add_argument("--static_only", action="store_true")
    p.add_argument("--nogroup", action="store_true")
    p.add_argument("--association_oracle", action="store_true")
    p.add_argument("--jitter", action="store_true")
    p.add_argument("--C", type=float, default=1.0)
    p.add_argument("--postprocess", action="store_true",
                   help="snap trajectories to train-set prototypes "
                        "({classname}_trajectory.pkl, a numpy pickle)")
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--space", type=int, default=1,
                   help="ranks of a space group, which shard the BEV rows "
                        "of one batch (it divides --num_processes)")
    p.add_argument("--extractBox", action="store_true",
                   help="save the decoded detections to a pkl after "
                        "inference (ref tools/dist_test.py:156,252)")
    p.add_argument("--eval_only", action="store_true",
                   help="skip inference and evaluate a saved detections pkl")
    p.add_argument("--predictions_path", default=None,
                   help="pkl path for --extractBox / --eval_only")
    p.add_argument("--speed_test", action="store_true",
                   help="log the mean per-sample inference latency over the "
                        "middle third of the eval set, synchronised "
                        "(ref tools/dist_test.py:204-240)")
    p.add_argument("--feed_dtype", default="fp32",
                   choices=["fp32", "fp16", "int16"],
                   help="host -> device point format (data/feed.py): fp32 "
                        "is exact; int16 fixed point halves the bytes with "
                        "up to 2 mm coordinate error")
    p.add_argument("--tta", default="none", choices=["none", "map", "box"],
                   help="double-flip test-time augmentation: 'map' averages "
                        "unflipped head maps (the reference's formulation), "
                        "'box' ensembles per-flip detections")
    p.add_argument("--out", default=None, help="metrics json path")
    p.add_argument("--coordinator_address", default=None,
                   help="multi-process evaluation: host:port of rank 0, "
                        "where the torch.distributed process group meets")
    p.add_argument("--num_processes", type=int, default=None,
                   help="ranks of the process group, one per card")
    p.add_argument("--process_id", type=int, default=None,
                   help="this process's rank")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tiny", action="store_true",
                   help="shrunken geometry for smoke tests")
    p.add_argument("--device", default="cuda",
                   help="torch device; cuda (the default) raises without a "
                        "card, cpu runs the plain PyTorch versions")
    return p.parse_args(argv)


def synthetic_batches(cfg, n: int, batch_size: int, seed: int):
    """The JAX CLI's synthetic eval set: batches of `make_batch` scenes with
    lidar-statistics clutter, seeds seed + i, tokens syn{i}_{j}."""
    from ..data.synthetic import make_batch
    out = []
    for i in range(max(n // batch_size, 1)):
        b = make_batch(cfg, batch_size, seed=seed + i, clutter_mode="lidar")
        b["tokens"] = [f"syn{i}_{j}" for j in range(batch_size)]
        out.append(b)
    return out


def restore_model(cfg, args, dev, space=None):
    """build_detector(cfg, seed=0) under the space layout `space` (if any)
    with the checkpoint that --checkpoint_dir / --modelCheckPoint name
    restored into it; without a checkpoint, a warning and the seeded
    init."""
    from ..models.detector import build_detector, lay_out_space_
    from ..train.checkpoints import CheckpointManager

    model = lay_out_space_(build_detector(cfg, device=dev, seed=0), space)
    ckpt_dir = args.checkpoint_dir or os.path.abspath(
        f"models/{args.experiment}/{args.dataset}_{args.architecture}_"
        f"{args.model}_detection")
    step = None
    if os.path.isdir(ckpt_dir):
        mgr = CheckpointManager(ckpt_dir)
        try:
            # ref evaluate.py:92,149: --modelCheckPoint latest|epoch_N
            # (here also a bare step)
            step = mgr.resolve(args.modelCheckPoint)
        except FileNotFoundError as e:
            raise SystemExit(f"--modelCheckPoint: {e}")
        if step is not None:
            mgr.restore(model, step=step)
            log.info("restored checkpoint step %d (%s) from %s", step,
                     args.modelCheckPoint, ckpt_dir)
    if step is None:
        log.warning("no checkpoint in %s: evaluating the seeded init",
                    ckpt_dir)
    return model.eval()


def make_infer(cfg, model, tta: str, decode: bool = True):
    """points, valid (and a bev_map config's ego map) on the device ->
    Detections on the device: a two-stage model's refined detections (JAX
    evaluate.py:187-197). Without `decode` (a space group's other ranks)
    the forward alone, and None; under --tta every rank decodes."""
    import torch

    from ..data.feed import unpack_points
    from ..eval.decode import decode_and_nms
    from ..eval.tta import infer_double_flip, infer_double_flip_map
    from ..models.two_stage import refined_detections

    tta_fn = {"map": infer_double_flip_map, "box": infer_double_flip}.get(tta)

    @torch.no_grad()
    def infer(points, valid, bev_map=None):
        points = unpack_points(points)
        if tta_fn is not None:
            return tta_fn(cfg, model, points, valid)
        out = model(points, valid, bev_map)
        if not decode:
            return None
        if cfg.model.two_stage_refine:
            return refined_detections(*out[1:])
        return decode_and_nms(cfg, out)
    return infer


def write_csv(summary, path: str) -> None:
    """The reference CSV layout (ref evaluate.py:34-53,203-209)."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(CSV_HEADER)
        for cls in summary["mean_dist_aps"]:
            row = {"CLASS": cls,
                   "mFAP_MR": summary["mean_dist_faps_mr"][cls]}
            row.update({col: summary[k][cls]
                        for col, k in CSV_COLUMNS.items()})
            row.update({col: summary["label_tp_errors"][cls][k]
                        for col, k in TP_COLUMNS.items()})
            w.writerow([row[c] for c in CSV_HEADER])


def main(argv=None):
    from ..config import get_config, tiny_variant
    from ..models.detector import resolve_device
    from ..parallel.collectives import initialize_multihost, leave, rank

    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    cfg = get_config(args.model)
    if args.tiny:
        cfg = tiny_variant(cfg)
    n_proc = initialize_multihost(
        args.coordinator_address, args.num_processes, args.process_id,
        resolve_device(args.device) if args.coordinator_address else None)
    try:
        return _evaluate(args, cfg, n_proc, rank())
    finally:
        leave(args.coordinator_address)


def _evaluate(args, cfg, n_proc: int, me: int):
    import torch

    from ..data.feed import pack_points
    from ..data.pipeline import batches_from_dataset, info_dataset
    from ..data.prefetch import prefetch
    from ..eval.evaluator import (detections_to_predictions,
                                  gt_records_from_arrays,
                                  gt_records_multiclass, host_detections,
                                  multitask_detection_records)
    from ..eval.metrics import evaluate_forecasts
    from ..models.detector import resolve_device
    from ..parallel.collectives import gather_eval_batch
    from ..parallel.mesh import data_axis_size, make_space_group

    if n_proc > 1:
        log.info("multi-process evaluation: process %d/%d", me, n_proc)
    # the (data, space) layout: this rank's data share, and whether it
    # decodes (the first rank of its space group) and in which group it
    # gathers
    n_data = data_axis_size(args.space)
    space = None if args.eval_only else make_space_group(args.space)
    shard = me // args.space
    decoder = space is None or space.index == 0
    group = None if space is None else space.data
    if args.tta != "none" and cfg.model.head.bev_map:
        # the JAX package's TTA forward takes no map either
        # (futuredet_tpu/cli/evaluate.py:197-204)
        raise SystemExit("--tta is not supported for bev_map configs: the "
                         "flipped forwards take no ego map")
    if args.tta != "none" and cfg.model.two_stage_refine:
        # as the JAX CLI (futuredet_tpu/cli/evaluate.py:190-192)
        raise SystemExit("--tta is not supported for two-stage configs")
    classname = cfg.data.class_names[0]
    # multitask class groups are detection-only: labels are global class
    # ids and there is no forecast linking (classic CenterPoint evaluation)
    multitask = cfg.model.head.multitask
    eval_classes = list(cfg.data.class_names) if multitask else [classname]

    if args.eval_only:
        # re-scoring a saved detections pkl needs no model or checkpoint
        eval_batches, n_b = [], 0
    elif args.synthetic:
        # this rank's strided share (the JAX CLI's)
        eval_batches = synthetic_batches(cfg, args.synthetic,
                                         args.batch_size,
                                         args.seed)[shard::n_data]
        n_b = len(eval_batches)
    elif args.info_path:
        cfg, ds = info_dataset(cfg, args.info_path, train=False)
        eval_batches = prefetch(batches_from_dataset(
            ds, cfg, args.batch_size, shuffle=False, loop=False,
            num_shards=n_data, shard_id=shard), depth=2)
        n_b = len(range(shard, len(ds), n_data)) // args.batch_size
    else:
        raise SystemExit(
            "no dataset: pass --info_path <infos pkl> or --synthetic N")

    prototypes = None
    if args.postprocess:
        proto_path = f"{classname}_trajectory.pkl"
        if os.path.exists(proto_path):
            with open(proto_path, "rb") as f:
                prototypes = pickle.load(f)
        else:
            log.warning("%s not found: run the trajectory tool first",
                        proto_path)

    preds, gts, saved = [], [], []
    pred_path = args.predictions_path or f"prediction_{args.model}.pkl"

    def consume(item):
        det, ready, gt, tokens = item
        if ready is not None:
            ready.synchronize()       # this batch's copy, not the next one
        if not decoder:
            return
        if n_data > 1 and not args.eval_only:
            # every rank scores the whole batch (the JAX CLI's gather)
            det, gt, tokens = gather_eval_batch(det, gt, tokens, group)
        else:
            det = host_detections(det)
        if args.extractBox:
            saved.append((det, gt, tokens))
        if multitask:
            p = multitask_detection_records(cfg, det, tokens)
            g = gt_records_multiclass(gt["boxes"], gt["valid"],
                                      gt["classes"], tokens,
                                      cfg.data.class_names)
        else:
            p = detections_to_predictions(
                cfg, det, tokens, forecast_mode=args.forecast_mode,
                classname=classname, rerank=args.rerank,
                nogroup=args.nogroup, jitter=args.jitter, jitter_K=args.K,
                jitter_C=args.C, prototypes=prototypes,
                sample_times=gt.get("times"))
            g = gt_records_from_arrays(gt["boxes"], gt["valid"],
                                       gt.get("traj"), tokens, classname,
                                       attrs=gt.get("attr"))
        for x in p:
            x.yaw = float(-x.yaw - np.pi / 2)
        preds.extend(p)
        gts.extend(g)

    if args.eval_only:
        with open(pred_path, "rb") as f:
            for det, gt, tokens in pickle.load(f):
                consume((det, None, gt, tokens))
    else:
        dev = resolve_device(args.device)
        on_card = dev.type == "cuda"
        model = restore_model(cfg, args, dev, space)
        infer = make_infer(cfg, model, args.tta, decode=decoder)

        def dev_slice(b):
            # the wire format of --feed_dtype, decoded on the device; the
            # ego map of a bev_map config beside it
            pts = torch.from_numpy(pack_points(b["points"].numpy(),
                                               args.feed_dtype))
            if on_card:
                pts = pts.pin_memory()
            bev = b.get("bev_map")
            return (pts.to(dev, non_blocking=True),
                    b["points_valid"].to(dev, non_blocking=True),
                    None if bev is None else bev.to(dev, non_blocking=True))

        def to_host(det):
            """The detections' copy to pinned host memory, queued behind
            the batch's work, and an event that marks its end."""
            if not on_card or det is None:
                return det, None
            det = type(det)(*(x.to("cpu", non_blocking=True) for x in det))
            ready = torch.cuda.Event()
            ready.record()
            return det, ready

        def sync():
            if on_card:
                torch.cuda.synchronize()

        # never time batch 0 (first launches, kernel builds)
        lo_t = max(n_b // 3, 1)
        hi_t = max(2 * n_b // 3, lo_t + 1)
        lat, inflight = [], deque()
        budget = cfg.voxel.max_voxels_eval
        it = iter(eval_batches)

        def next_slice():
            b = next(it, None)
            return None if b is None else (b, dev_slice(b))

        # the next batch's points go to the device while this one computes
        upcoming = next_slice()
        bi = 0
        while upcoming is not None:
            b, feed = upcoming
            probe = args.speed_test and lo_t <= bi < hi_t and n_b >= 3
            if probe:
                # drain pending work so the probe times only this batch
                while inflight:
                    consume(inflight.popleft())
                sync()
            else:
                upcoming = next_slice()
            t0 = time.perf_counter()
            det = infer(*feed)
            if probe:
                sync()
                lat.append((time.perf_counter() - t0) / feed[0].shape[0])
                upcoming = next_slice()
            if bi == 0 and hasattr(model, "num_voxels"):
                # the port never drops a sparse site; the voxelizer's
                # budget is the only limit
                full = max(model.num_voxels) >= budget
                (log.warning if full else log.info)(
                    "voxel budget: the first batch holds %s voxels a "
                    "sample, max_voxels_eval %d%s", model.num_voxels,
                    budget, " (reached: voxels past it were dropped)"
                    if full else " (not reached)")
            inflight.append((*to_host(det), b["gt"], b["tokens"]))
            while len(inflight) >= 2:
                consume(inflight.popleft())
            bi += 1
        while inflight:
            consume(inflight.popleft())
        if args.speed_test and lat:
            log.info("speed test: %.3f ms/sample over %d middle-third "
                     "batches (%.1f samples/s)", 1e3 * float(np.mean(lat)),
                     len(lat), 1.0 / float(np.mean(lat)))
        if args.extractBox and me == 0:
            with open(pred_path, "wb") as f:
                pickle.dump(saved, f)
            log.info("detections saved to %s", pred_path)

    if not decoder:
        # the space group's first rank decodes and scores its share
        return None
    results = evaluate_forecasts(
        preds, gts, eval_classes, tp_pct=args.tp_pct,
        cohort_analysis=args.cohort_analysis, topk=args.K,
        static_only=args.static_only,
        association_oracle=args.association_oracle)
    summary = results.summary()
    if me != 0:
        # every rank holds the gathered records and the same metrics; rank
        # 0 writes them
        return summary
    out_path = args.out or f"metrics_{args.model}_{args.forecast_mode}.json"
    with open(out_path, "w") as f:
        json.dump(summary, f, indent=2)
    csv_path = out_path.rsplit(".", 1)[0] + ".csv"
    write_csv(summary, csv_path)
    for cls, v in summary["mean_dist_aps"].items():
        e = summary["label_tp_errors"][cls]
        log.info("%s: mAP %.4f mFAP %.4f mAAP %.4f ADE %.3f FDE %.3f "
                 "MR %.3f", cls, v, summary["mean_dist_faps"][cls],
                 summary["mean_dist_aaps"][cls], e["avg_disp_err"],
                 e["final_disp_err"], e["miss_rate"])
    log.info("metrics written to %s and %s", out_path, csv_path)
    return summary


if __name__ == "__main__":
    main()
