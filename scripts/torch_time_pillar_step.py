"""Time full-width pp_forecast_n3dtf train steps on the card, on a scene that
fills the point buffer and on one that is mostly padding.

    python3 scripts/torch_time_pillar_step.py [--root TREE] [--steps N]

Uses the futuredet_torch found under `--root` (default: this checkout; a
parent tree unpacked by `git archive` times the same work on older code).
Two B = 1 scenes of `data/synthetic.py::make_batch` in the config's
300,000-point buffer: `full`, chip_smoke.py phase 14's lidar-family scene
(48 objects, 140,000 clutter points, seed 21; ~147k points), and `cli`, the
train CLI's scene (12 objects of 600 points over 20,000 lidar clutter
points, seed 0; ~22k points, the rest of the buffer padding). Per scene:
the median ms of `--steps` train steps, each timed on the host clock around
a synced step, after 3 warm-ups; then one profiled step and the device ms
of its kernels by name (the top 5, and the sum of
`indexing_backward_kernel`, the sorted accumulate behind a gather's
backward). One JSON line per scene, with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME = "pp_forecast_n3dtf"
WARMUP = 3


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def scenes(cfg, make_batch):
    full = make_batch(cfg, 1, seed=21, n_objects=48, points_per_object=500,
                      n_clutter=140000, max_objs=500, clutter_mode="lidar")
    cli = make_batch(cfg, 1, seed=0, clutter_mode="lidar")
    return {"full": full, "cli": cli}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    from torch.profiler import ProfilerActivity, profile

    import futuredet_torch
    where = os.path.abspath(futuredet_torch.__file__)
    if not where.startswith(root + os.sep):
        raise RuntimeError(f"imported {where}, not from {root}")
    from futuredet_torch.config import get_config
    from futuredet_torch.data.synthetic import make_batch
    from futuredet_torch.models.detector import build_detector
    from futuredet_torch.train.step import make_optimizer, train_step
    from futuredet_torch.train.trainer import _to_device

    if not torch.cuda.is_available():
        print("torch_time_pillar_step: no card", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    cfg = get_config(NAME)
    for name, batch in scenes(cfg, make_batch).items():
        batch = _to_device({k: v for k, v in batch.items() if k != "gt"},
                           dev)
        n_points = int(batch["points_valid"].sum())
        model = build_detector(cfg, device=dev, seed=0).train()
        total = WARMUP + args.steps + 1
        opt = make_optimizer(cfg, model, total)
        ms = []
        for i in range(WARMUP + args.steps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            train_step(model, opt, batch, i)
            torch.cuda.synchronize()
            if i >= WARMUP:
                ms.append((time.perf_counter() - t) * 1e3)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            train_step(model, opt, batch, total - 1)
            torch.cuda.synchronize()
        kernels = {}
        for e in prof.key_averages():
            t = getattr(e, "self_device_time_total",
                        getattr(e, "self_cuda_time_total", 0.0))
            if t > 0:
                kernels[e.key] = kernels.get(e.key, 0.0) + t / 1e3
        top = sorted(kernels.items(), key=lambda kv: -kv[1])[:5]
        print(json.dumps({
            "tree": args.root, "scene": name, "card": card,
            "points": n_points, "buffer": int(batch["points"].shape[1]),
            "step_ms_median": statistics.median(ms), "steps": len(ms),
            "device_ms_profiled_step": sum(kernels.values()),
            "indexing_backward_ms": sum(
                v for k, v in kernels.items()
                if "indexing_backward_kernel" in k),
            "top_kernels_ms": [[k[:80], v] for k, v in top]}), flush=True)
        del model, opt
    return 0


if __name__ == "__main__":
    sys.exit(main())
