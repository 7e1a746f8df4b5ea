#!/usr/bin/env python3
"""Where the time of futuredet_torch's main path goes, on one NVIDIA GPU.

    python3 scripts/torch_profile.py [--model pp_forecast_n3dtf|forecast_n3dtf]
                                     [--scene uniform|clustered] [--iters 5]
                                     [--trace PATH]

Builds the full-width model with seeded random weights and the scenes of
chip_smoke.py, runs a scene through the model's stages (pillars: reader ->
neck -> head -> decode_and_nms; voxelnet: voxelize -> middle -> z_crush ->
neck -> head -> decode_and_nms), each under its own `record_function`
range, and traces `--iters` runs with torch.profiler after 3 warm-up runs.
Prints JSON lines: the device time of each stage, the wall time and peak
device memory of each stage in one run synchronised after every stage,
the 15 kernels with the most device time, the dense conv FLOPs of one run
and the device's busy share of the traced wall time. TF32 is off, as in
chip_smoke.py. `--trace` writes the Chrome trace.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import (MAX_POINTS, NAME, VOX_NAME,  # noqa: E402
                        scene_blobs, scene_clustered, scene_lidar,
                        scene_uniform)

STAGES = {NAME: ("reader", "neck", "head", "decode_and_nms"),
          VOX_NAME: ("voxelize", "middle", "z_crush", "neck", "head",
                     "decode_and_nms")}


def conv_flops(model, pts, valid):
    """2 * MACs of every Conv2d / ConvTranspose2d in one forward."""
    total = [0]

    def hook(m, inp, out):
        k = m.weight.shape[2] * m.weight.shape[3]
        if isinstance(m, torch.nn.ConvTranspose2d):
            total[0] += 2 * inp[0].numel() * m.out_channels * k
        else:
            total[0] += 2 * out.numel() * (m.in_channels // m.groups) * k

    hs = [m.register_forward_hook(hook) for m in model.modules()
          if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))]
    with torch.no_grad():
        model(pts, valid)
    for h in hs:
        h.remove()
    return total[0]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default=NAME, choices=tuple(STAGES))
    ap.add_argument("--scene", default="uniform",
                    choices=("uniform", "clustered"))
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--trace", help="write the Chrome trace to this path")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_profile: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from futuredet_torch.config import get_config
    from futuredet_torch.eval.decode import decode_and_nms
    from futuredet_torch.models.detector import build_detector

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    stages = STAGES[args.model]
    cfg = get_config(args.model)
    seed = 0 if args.scene == "uniform" else 1
    if args.model == NAME:
        cfg = cfg.replace(voxel=dataclasses.replace(
            cfg.voxel, max_points=MAX_POINTS, max_voxels_eval=30000))
        make = scene_uniform if args.scene == "uniform" else scene_clustered
    else:
        make = scene_blobs if args.scene == "uniform" else scene_lidar
    model = build_detector(cfg, seed=0)
    p, v = make(cfg, np.random.default_rng(seed))
    pts, valid = torch.from_numpy(p).cuda(), torch.from_numpy(v).cuda()
    peak_mib, wall = {}, {}

    def stage(name, fn, *a):
        t0 = time.perf_counter()
        with record_function(name):
            out = fn(*a)
        if track:
            torch.cuda.synchronize()
            wall[name] = (time.perf_counter() - t0) * 1e3
            peak_mib[name] = torch.cuda.max_memory_allocated() / 2**20
            torch.cuda.reset_peak_memory_stats()
        return out

    def run():
        with torch.no_grad():
            if args.model == NAME:
                x = stage("reader", model.reader, pts, valid)
                x = x.permute(0, 3, 1, 2)
            else:
                feats, vm = stage("voxelize", model.voxelize, pts, valid)
                bev, zmask = stage("middle", model.backbone, feats,
                                   vm.coords, vm.batch, 1)
                x = stage("z_crush", model.crush, bev, zmask)
            x = stage("neck", model.neck, x)
            preds = stage("head", model.bbox_head, x)
            return stage("decode_and_nms", decode_and_nms, cfg, preds)

    # 3 warm-up runs, then one run with a synchronize after each stage
    # for its wall time and peak memory
    track = False
    for _ in range(3):
        run()
    track = True
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run()
    track = False
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.iters):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "device_time_total", None) or getattr(
            e, "cuda_time_total", 0.0)

    stage_ms = {e.key: dev_us(e) / 1e3 / args.iters for e in events
                if e.key in stages}
    kernels = sorted((e for e in events if dev_us(e) > 0
                      and e.key not in stages
                      and str(getattr(e, "device_type", "")).endswith("CUDA")),
                     key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    print(json.dumps({"card": card, "model": args.model,
                      "scene": args.scene,
                      "iters": args.iters, "wall_ms_per_run":
                      wall_ms / args.iters,
                      "device_busy_ms_per_run": busy_ms / args.iters,
                      "device_busy_share": busy_ms / wall_ms,
                      "stage_device_ms_per_run": stage_ms,
                      "stage_wall_ms_synced": wall,
                      "stage_peak_mib": peak_mib,
                      "conv_gflop_per_run": conv_flops(model, pts, valid)
                      / 1e9}), flush=True)
    for e in kernels[:15]:
        print(json.dumps({"kernel": e.key[:120], "calls_per_run":
                          e.count / args.iters, "device_ms_per_run":
                          dev_us(e) / 1e3 / args.iters}), flush=True)
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)),
                    exist_ok=True)
        prof.export_chrome_trace(args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
