#!/usr/bin/env python3
"""Where the time of futuredet_torch's main path goes, on one NVIDIA GPU.

    python3 scripts/torch_profile.py [--model pp_forecast_n3dtf|forecast_n3dtf]
                                     [--scene uniform|clustered] [--iters 5]
                                     [--knob KEY=VALUE ...]
                                     [--decode-ops] [--train]
                                     [--trace PATH]
    python3 scripts/torch_profile.py --train --model forecast_n3dtfm
    python3 scripts/torch_profile.py --model forecast_n3dtf \
        --knob compute_dtype=bfloat16 --knob middle_sparse_dtype=bfloat16

Builds the full-width model with seeded random weights and the scenes of
chip_smoke.py, runs a scene through the model's stages (pillars: reader ->
neck -> head -> decode_and_nms; voxelnet: voxelize -> middle -> z_crush ->
neck -> head -> decode_and_nms), each under its own `record_function`
range, and traces `--iters` runs with torch.profiler after 3 warm-up runs.
Prints JSON lines: the device time of each stage, the wall time (median of
5 runs synchronised after every stage) and peak device memory of each stage,
the 15 kernels with the most device time, every kernel of the port's own
(PORT_KERNELS: K1's nms_* passes, K2's narrow_kernel and wide_kernel),
the dense conv FLOPs of one run and the
device's busy share of the traced wall time. `--knob` sets a field of the
model config (a JSON value or a string: compute_dtype=bfloat16,
middle_dense_from_stage=2, middle=dense; under middle=dense the "middle"
stage is the dense BEV tower and there is no z_crush). `--decode-ops` then traces
decode_and_nms alone on one run's head outputs: decode_single,
rotate_nms, top_k_stable (the stable sort), rotate_nms_alive (K1) and
_compact (the survivor compaction) each run under a record_function range
of their name, wrapped around the library function here; it prints each
range's and each aten op's host and device time per run, every kernel of
the stage, and the stage's synced wall. `--train` instead traces
full-width train steps of the model on chip_smoke.py's train scene
(`train_ops`); with `--train`, `--model` takes any single-stage name of
CONFIG_NAMES (a bev_map config gets its scene's ego map). TF32 is off, as
in chip_smoke.py. `--trace` writes the Chrome trace.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import statistics
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

# the names of the port's own kernels (csrc/*.cu)
PORT_KERNELS = r"nms_|narrow_kernel|wide_kernel|bf16_kernel"
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


def decode_ops(cfg, preds, iters, card, dev_us):
    """decode_and_nms alone on fixed head outputs, split by operation: each
    library function below runs under a record_function range of its name
    (the ranges nest: rotate_nms holds top_k_stable, K1 and _compact)."""
    from futuredet_torch.eval import decode
    from futuredet_torch.ops import nms
    names = {(decode, "decode_single"), (decode, "rotate_nms"),
             (nms, "top_k_stable"), (nms, "rotate_nms_alive"),
             (nms, "_compact")}
    saved = {(m, n): getattr(m, n) for m, n in names}

    def ranged(name, fn):
        def inner(*a, **k):
            with record_function(name):
                return fn(*a, **k)
        return inner

    for (m, n), fn in saved.items():
        setattr(m, n, ranged(n, fn))
    try:
        walls = []
        with torch.no_grad():
            for _ in range(3):
                decode.decode_and_nms(cfg, preds)
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                decode.decode_and_nms(cfg, preds)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(iters):
                    with record_function("decode_and_nms"):
                        decode.decode_and_nms(cfg, preds)
                torch.cuda.synchronize()
    finally:
        for (m, n), fn in saved.items():
            setattr(m, n, fn)
    events = prof.key_averages()
    ranges = {n for _, n in names} | {"decode_and_nms"}
    print(json.dumps({"decode_stage_wall_ms_synced": statistics.median(walls),
                      "card": card}), flush=True)
    rows = [e for e in events if e.key in ranges or (
        e.key.startswith("aten::") and e.cpu_time_total > 0)]
    rows.sort(key=lambda e: e.cpu_time_total, reverse=True)
    for e in rows[:30]:
        print(json.dumps({"decode_op": e.key, "calls_per_run":
                          e.count / iters, "host_ms_per_run":
                          e.cpu_time_total / 1e3 / iters,
                          "device_ms_per_run": dev_us(e) / 1e3 / iters}),
              flush=True)
    for e in events:
        if str(getattr(e, "device_type", "")).endswith("CUDA") \
                and dev_us(e) > 0 and e.key not in ranges:
            print(json.dumps({"decode_kernel": e.key[:120], "calls_per_run":
                              e.count / iters, "device_ms_per_run":
                              dev_us(e) / 1e3 / iters}), flush=True)


def train_ops(name, iters, card, dev_us):
    """Full-width train steps of `name` on chip_smoke.py's train scene of
    that model (phases 10-13 or 14-16), each part under its own range
    (targets, forward_loss, backward, optimizer; chip_smoke.py phases 13
    and 16 time them synced). Prints
    the device's busy ms per step and busy share of the traced wall, the
    backward split by autograd node (the engine's evaluate_function
    events, which hold the kernels that node launched) and the 25 kernels
    with the most device time."""
    import dataclasses

    from chip_smoke import (MAX_POINTS, PILLAR_TRAIN_CLUTTER, TRAIN_CLUTTER,
                            TRAIN_SEED, train_batch)
    from futuredet_torch.config import get_config
    from futuredet_torch.data.targets import build_targets_batch
    from futuredet_torch.models.detector import build_detector
    from futuredet_torch.models.losses import center_head_loss
    from futuredet_torch.train.step import apply_update, make_optimizer

    cfg = get_config(name)
    clutter = TRAIN_CLUTTER
    if name == NAME:
        cfg = cfg.replace(voxel=dataclasses.replace(cfg.voxel,
                                                    max_points=MAX_POINTS))
        clutter = PILLAR_TRAIN_CLUTTER
    model = build_detector(cfg, seed=0).train()
    opt = make_optimizer(cfg, model, 1000)
    batch = train_batch(cfg, TRAIN_SEED, "cuda", clutter)
    parts = ("targets", "forward_loss", "backward", "optimizer")

    def step(i):
        opt.zero_grad(set_to_none=True)
        with record_function("targets"):
            targets = build_targets_batch(cfg, batch["targets_raw"])
        with record_function("forward_loss"):
            loss = center_head_loss(
                cfg.model.head, model(batch["points"], batch["points_valid"],
                                      batch.get("bev_map")),
                targets)["loss"]
        with record_function("backward"):
            loss.backward()
        with record_function("optimizer"):
            apply_update(model, opt, i)

    for i in range(3):
        step(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(iters):
            step(3 + i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()

    def is_range(e):
        # the device side of a record_function range (the parts here,
        # torch.optim's "Optimizer.step#AdamW.step") spans kernels: no kernel
        return (getattr(e, "is_user_annotation", False) or e.key in parts
                or e.key.startswith("Optimizer."))

    kernels = sorted((e for e in events if dev_us(e) > 0 and not is_range(e)
                      and str(getattr(e, "device_type", "")).endswith("CUDA")),
                     key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    print(json.dumps({
        "card": card, "model": name, "train_iters": iters,
        "wall_ms_per_step": wall_ms / iters,
        "device_busy_ms_per_step": busy_ms / iters,
        "device_busy_share": busy_ms / wall_ms}), flush=True)
    tag = "autograd::engine::evaluate_function: "
    nodes = sorted((e for e in events if e.key.startswith(tag)),
                   key=dev_us, reverse=True)
    for e in nodes[:20]:
        print(json.dumps({"backward_node": e.key[len(tag):],
                          "calls_per_step": e.count / iters,
                          "host_ms_per_step": e.cpu_time_total / 1e3 / iters,
                          "device_ms_per_step": dev_us(e) / 1e3 / iters}),
              flush=True)
    for e in kernels[:25]:
        print(json.dumps({"train_kernel": e.key[:120],
                          "calls_per_step": e.count / iters,
                          "device_ms_per_step": dev_us(e) / 1e3 / iters}),
              flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default=NAME)
    ap.add_argument("--scene", default="uniform",
                    choices=("uniform", "clustered"))
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--decode-ops", action="store_true",
                    help="split decode_and_nms by operation")
    ap.add_argument("--train", action="store_true",
                    help="profile the model's train steps instead")
    ap.add_argument("--trace", help="write the Chrome trace to this path")
    ap.add_argument("--knob", action="append", default=[],
                    help="KEY=VALUE, a model config field")
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

    def dev_us(e):
        return getattr(e, "device_time_total", None) or getattr(
            e, "cuda_time_total", 0.0)

    if args.train:
        train_ops(args.model, args.iters, card, dev_us)
        return 0
    if args.model not in STAGES:
        ap.error(f"--model {args.model}: inference stages are split for "
                 f"{sorted(STAGES)} only")
    stages = STAGES[args.model]
    cfg = get_config(args.model)
    knobs = {}
    for kv in args.knob:
        k, v = kv.split("=", 1)
        try:
            knobs[k] = json.loads(v)
        except json.JSONDecodeError:
            knobs[k] = v
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, **knobs))
    dense = cfg.model.middle == "dense"
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
    peak_mib, walls = {}, {}

    def stage(name, fn, *a):
        t0 = time.perf_counter()
        with record_function(name):
            out = fn(*a)
        if track:
            torch.cuda.synchronize()
            walls.setdefault(name, []).append(
                (time.perf_counter() - t0) * 1e3)
            peak_mib[name] = max(peak_mib.get(name, 0.0),
                                 torch.cuda.max_memory_allocated() / 2**20)
            torch.cuda.reset_peak_memory_stats()
        return out

    def run():
        with torch.no_grad():
            if args.model == NAME:
                x = stage("reader", model.reader, pts, valid)
                x = x.permute(0, 3, 1, 2)
            else:
                feats, vm = stage("voxelize", model.voxelize, pts, valid)
                if dense:
                    x = stage("middle", model.dense_bev, feats, vm, 1)
                else:
                    bev, zmask = stage("middle", model.backbone, feats,
                                       vm.coords, vm.batch, 1)
                    x = stage("z_crush", model.crush, bev, zmask)
            x = stage("neck", model.neck, x)
            preds = stage("head", model.bbox_head, x)
            return stage("decode_and_nms", decode_and_nms, cfg, preds)

    # 3 warm-up runs, then 5 runs with a synchronize after each stage for
    # its wall time (median) and peak memory
    track = False
    for _ in range(3):
        run()
    track = True
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(5):
        run()
    track = False
    wall = {k: statistics.median(v) for k, v in walls.items()}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.iters):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    stage_ms = {e.key: dev_us(e) / 1e3 / args.iters for e in events
                if e.key in stages}
    kernels = sorted((e for e in events if dev_us(e) > 0
                      and e.key not in stages
                      and str(getattr(e, "device_type", "")).endswith("CUDA")),
                     key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    print(json.dumps({"card": card, "model": args.model,
                      "knobs": knobs, "scene": args.scene,
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
    for e in kernels:
        if re.search(PORT_KERNELS, e.key):
            print(json.dumps({"port_kernel": e.key[:120], "card": card,
                              "calls_per_run": e.count / args.iters,
                              "device_ms_per_run":
                              dev_us(e) / 1e3 / args.iters}), flush=True)
    if args.decode_ops:
        with torch.no_grad():
            preds = model(pts, valid)
        decode_ops(cfg, preds, args.iters, card, dev_us)
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)),
                    exist_ok=True)
        prof.export_chrome_trace(args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
