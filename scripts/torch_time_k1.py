#!/usr/bin/env python3
"""K1 (rotated NMS) device time on fixed inputs, for one tree of the port,
so that two trees can be timed in turns on one card.

    python3 scripts/torch_time_k1.py --record PATH
    python3 scripts/torch_time_k1.py --inputs PATH [--root TREE]

`--record` runs chip_smoke.py's pillar main path (pp_forecast_n3dtf, full
width, seeded random weights, the uniform scene), keeps the 7 x 1000 NMS
problems K1 is given there, adds chip_smoke.py's dense cluster (7 x 1000
boxes of 1.5-5 m with centres in a 1.4 m square: the cull skips no pair)
and writes both to PATH. `--inputs` loads them and times
`rotate_nms_alive` of the futuredet_torch found under `--root` (default:
this checkout) on each: the median device time of one call between CUDA
events (chip_smoke.time_device: 3 warm-ups, median of 20), the device time
of each of its kernels by name from torch.profiler over 20 calls, and
whether its survivors equal that tree's plain version. One JSON line per
case, with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def record(path):
    sys.path.insert(0, HERE)
    import dataclasses

    import chip_smoke as cs
    from futuredet_torch.config import get_config
    from futuredet_torch.eval.decode import decode_and_nms
    from futuredet_torch.models.detector import build_detector
    from futuredet_torch.ops import nms as nms_mod

    torch.backends.cudnn.allow_tf32 = False       # as chip_smoke.py
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(cs.NAME)
    cfg = cfg.replace(voxel=dataclasses.replace(
        cfg.voxel, max_points=cs.MAX_POINTS, max_voxels_eval=30000))
    model = build_detector(cfg, device="cuda", seed=0)
    pts, valid = cs.scene_uniform(cfg, np.random.default_rng(0))
    seen = []
    kernel = nms_mod.rotate_nms_alive

    def recorder(b, v, thr):
        seen.append((b.clone(), v.clone(), thr))
        return kernel(b, v, thr)

    nms_mod.rotate_nms_alive = recorder
    with torch.no_grad():
        decode_and_nms(cfg, model(torch.from_numpy(pts).cuda(),
                                  torch.from_numpy(valid).cuda()))
    nms_mod.rotate_nms_alive = kernel
    b, v, thr = seen[0]
    dense = torch.from_numpy(cs.k1_dense_cluster(
        b.shape[0], b.shape[1], np.random.default_rng(4))).cuda()
    ones = torch.ones_like(v)
    torch.save({"main_path_7x1000": (b.cpu(), v.cpu(), thr),
                "dense_cluster_7x1000": (dense.cpu(), ones.cpu(), thr)}, path)


def time_tree(path, root):
    sys.path.insert(0, os.path.abspath(root))
    import chip_smoke as cs
    from futuredet_torch.ops import pallas_nms
    from torch.profiler import ProfilerActivity, profile

    where = os.path.abspath(pallas_nms.__file__)
    if not where.startswith(os.path.abspath(root) + os.sep):
        raise RuntimeError(f"imported {where}, not from {root}")
    card = cs.card_line()
    for name, (b, v, thr) in torch.load(path).items():
        b, v = b.cuda(), v.cuda()
        ms = cs.time_device(lambda: pallas_nms.rotate_nms_alive(b, v, thr))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(cs.REPS):
                pallas_nms.rotate_nms_alive(b, v, thr)
            torch.cuda.synchronize()
        kernels = {}
        for e in prof.key_averages():
            us = getattr(e, "device_time_total", None) or getattr(
                e, "cuda_time_total", 0.0)
            if "nms_" in e.key and us > 0:
                kernels[e.key[:80]] = us / 1e3 / cs.REPS
        same = torch.equal(pallas_nms.rotate_nms_alive(b, v, thr),
                           pallas_nms.nms_alive_plain(b, v, thr))
        print(json.dumps({"tree": root, "case": name, "shape": list(b.shape),
                          "thr": thr, "k1_ms": ms,
                          "kernel_ms_per_call": kernels,
                          "identical_to_plain": same, "card": card}),
              flush=True)
        if not same:
            raise RuntimeError(f"{root}: K1 differs from its plain version "
                               f"on {name}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--record", help="write the inputs to this path")
    ap.add_argument("--inputs", help="time K1 on the inputs at this path")
    ap.add_argument("--root", default=HERE,
                    help="the checkout whose futuredet_torch is timed")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_time_k1: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if args.record:
        record(args.record)
    if args.inputs:
        time_tree(args.inputs, args.root)
    return 0


if __name__ == "__main__":
    sys.exit(main())
