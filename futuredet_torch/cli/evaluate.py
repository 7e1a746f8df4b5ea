"""Evaluation CLI: inference on the card, linking and the joint detection +
forecasting metrics.

The port's counterpart of `futuredet_tpu/cli/evaluate.py`, with the
reference `evaluate.py`'s flags (README.md:174-185): --forecast_mode,
--rerank, --tp_pct, --cohort_analysis, --K, --static_only, --nogroup,
--extractBox. It writes the metrics JSON and the reference CSV columns of
evaluate.py:22-54.

  python -m futuredet_torch.cli.evaluate --model pp_forecast_n3dtf \\
      --synthetic 8 --checkpoint_dir work/pp --forecast_mode velocity_dense \\
      --cohort_analysis --K 5

It runs on the card unless given `--device cpu`, and raises when no card is
found. Per batch, `build_detector` -> forward -> `decode_and_nms` (or a
double flip, `--tta map|box`) runs on the device; the detections are copied
to the host behind the batch's work, and the host tail of a batch (linking,
records) runs while the card computes the next one (a queue of depth 2).
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
    p.add_argument("--model", default="pp_forecast_n3dtf")
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
                   help="spatial sharding of the BEV rows (not ported)")
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
                   help="multi-process evaluation (not ported)")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tiny", action="store_true",
                   help="shrunken geometry for smoke tests")
    p.add_argument("--device", default="cuda",
                   help="torch device; cuda (the default) raises without a "
                        "card, cpu runs the plain PyTorch versions")
    return p.parse_args(argv)


def refuse_unported(args, cfg) -> None:
    """Flags whose paths the port does not have yet raise, naming their
    ROADMAP.md item."""
    if args.info_path:
        raise NotImplementedError(
            "--info_path: the nuScenes data pipeline is not ported yet "
            "(ROADMAP.md, queue 1: the data pipeline); use --synthetic N")
    if args.space > 1 or args.coordinator_address \
            or (args.num_processes or 1) > 1:
        raise NotImplementedError(
            "--space > 1 and multi-process evaluation are not ported yet "
            "(ROADMAP.md, queue 1: DDP)")
    if cfg.model.two_stage_refine:
        raise NotImplementedError(
            "two-stage configs are not ported yet (ROADMAP.md, queue 1: "
            "long tail, models/two_stage.py)")


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


def restore_model(cfg, args, dev):
    """build_detector(cfg, seed=0) with the checkpoint that
    --checkpoint_dir / --modelCheckPoint name restored into it; without a
    checkpoint, a warning and the seeded init."""
    from ..models.detector import build_detector
    from ..train.checkpoints import CheckpointManager

    model = build_detector(cfg, device=dev, seed=0)
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


def make_infer(cfg, model, tta: str):
    """points, valid on the device -> Detections on the device."""
    import torch

    from ..data.feed import unpack_points
    from ..eval.decode import decode_and_nms
    from ..eval.tta import infer_double_flip, infer_double_flip_map

    tta_fn = {"map": infer_double_flip_map, "box": infer_double_flip}.get(tta)

    @torch.no_grad()
    def infer(points, valid):
        points = unpack_points(points)
        if tta_fn is not None:
            return tta_fn(cfg, model, points, valid)
        return decode_and_nms(cfg, model(points, valid))
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
    import torch

    from ..config import get_config, tiny_variant
    from ..data.feed import pack_points
    from ..eval.evaluator import (detections_to_predictions,
                                  gt_records_from_arrays, host_detections)
    from ..eval.metrics import evaluate_forecasts
    from ..models.detector import resolve_device

    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    cfg = get_config(args.model)
    if args.tiny:
        cfg = tiny_variant(cfg)
    refuse_unported(args, cfg)
    classname = cfg.data.class_names[0]

    if args.eval_only:
        # re-scoring a saved detections pkl needs no model or checkpoint
        eval_batches = []
    elif args.synthetic:
        eval_batches = synthetic_batches(cfg, args.synthetic,
                                         args.batch_size, args.seed)
    else:
        raise SystemExit("no dataset: pass --synthetic N")

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
        det = host_detections(det)
        if args.extractBox:
            saved.append((det, gt, tokens))
        p = detections_to_predictions(
            cfg, det, tokens, forecast_mode=args.forecast_mode,
            classname=classname, rerank=args.rerank, nogroup=args.nogroup,
            jitter=args.jitter, jitter_K=args.K, jitter_C=args.C,
            prototypes=prototypes, sample_times=gt.get("times"))
        g = gt_records_from_arrays(gt["boxes"], gt["valid"], gt.get("traj"),
                                   tokens, classname, attrs=gt.get("attr"))
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
        model = restore_model(cfg, args, dev)
        infer = make_infer(cfg, model, args.tta)

        def dev_slice(b):
            # the wire format of --feed_dtype, decoded on the device
            pts = torch.from_numpy(pack_points(b["points"].numpy(),
                                               args.feed_dtype))
            if on_card:
                pts = pts.pin_memory()
            return (pts.to(dev, non_blocking=True),
                    b["points_valid"].to(dev, non_blocking=True))

        def to_host(det):
            """The detections' copy to pinned host memory, queued behind
            the batch's work, and an event that marks its end."""
            if not on_card:
                return det, None
            det = type(det)(*(x.to("cpu", non_blocking=True) for x in det))
            ready = torch.cuda.Event()
            ready.record()
            return det, ready

        def sync():
            if on_card:
                torch.cuda.synchronize()

        n_b = len(eval_batches)
        # never time batch 0 (first launches, kernel builds)
        lo_t = max(n_b // 3, 1)
        hi_t = max(2 * n_b // 3, lo_t + 1)
        lat, inflight = [], deque()
        budget = cfg.voxel.max_voxels_eval
        # the next batch's points go to the device while this one computes
        dev_q = deque([dev_slice(eval_batches[0])] if eval_batches else [])
        for bi, b in enumerate(eval_batches):
            probe = args.speed_test and lo_t <= bi < hi_t and n_b >= 3
            if probe:
                # drain pending work so the probe times only this batch
                while inflight:
                    consume(inflight.popleft())
                sync()
            feed = dev_q.popleft()
            if not probe and bi + 1 < n_b:
                dev_q.append(dev_slice(eval_batches[bi + 1]))
            t0 = time.perf_counter()
            det = infer(*feed)
            if probe:
                sync()
                lat.append((time.perf_counter() - t0) / feed[0].shape[0])
                if bi + 1 < n_b:
                    dev_q.append(dev_slice(eval_batches[bi + 1]))
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
        while inflight:
            consume(inflight.popleft())
        if args.speed_test and lat:
            log.info("speed test: %.3f ms/sample over %d middle-third "
                     "batches (%.1f samples/s)", 1e3 * float(np.mean(lat)),
                     len(lat), 1.0 / float(np.mean(lat)))
        if args.extractBox:
            with open(pred_path, "wb") as f:
                pickle.dump(saved, f)
            log.info("detections saved to %s", pred_path)

    results = evaluate_forecasts(
        preds, gts, [classname], tp_pct=args.tp_pct,
        cohort_analysis=args.cohort_analysis, topk=args.K,
        static_only=args.static_only,
        association_oracle=args.association_oracle)
    summary = results.summary()
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
