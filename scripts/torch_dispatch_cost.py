"""The cost of the torch.library dispatcher in front of kernels K1 and K2,
on one NVIDIA GPU.

    python3 scripts/torch_dispatch_cost.py [--rounds N]

Since K1 and K2 are the custom operators `torch.ops.futuredet.nms_alive`
and `torch.ops.futuredet.gather_conv`, each call goes through PyTorch's
dispatcher before the kernel's ctypes launch. This script keeps the direct
call (the wrappers' checks, then the same launch, with no operator in
between) and times both in turns (direct, operator, operator, direct, N
rounds): the host microseconds of one call (the enqueue of 50 calls on
the host clock, no synchronise inside, over 50; K1 at the main path's
7 x 1000 boxes, K2 at a 60,000-site, 32 -> 32 conv) and the ms of a
whole scene as chip_smoke.py's phases 5 and 9 time it (3 warm-ups, then
the median of 20 synced scenes), with the direct call patched in where
the model calls the kernels. Both routes run the same kernel on the same
inputs, so their outputs are compared bit for bit. One JSON line each,
the card's name and power limit in each.
"""
import argparse
import dataclasses
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.chdir(ROOT)
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from futuredet_torch.config import get_config  # noqa: E402
from futuredet_torch.eval.decode import decode_and_nms  # noqa: E402
from futuredet_torch.models.detector import build_detector  # noqa: E402
from futuredet_torch.ops import _build, pallas_gather, pallas_nms  # noqa
from futuredet_torch.ops import nms as nms_mod  # noqa: E402
from futuredet_torch.ops import sparse_conv as sc_mod  # noqa: E402

CALLS = 50


def direct_k1(boxes, valid, thr):
    """K1 without the operator: the wrapper's checks, then the launch."""
    if boxes.dim() != 3 or boxes.shape[-1] != 5 or boxes.dtype != \
            torch.float32 or valid.shape != boxes.shape[:2]:
        raise ValueError("K1's inputs")
    if not (boxes.is_contiguous() and valid.is_contiguous()):
        raise ValueError("nms_boxes and valid must be contiguous")
    return pallas_nms.launch_with_mask(boxes.detach(), valid, thr)[0]


def direct_k2(features, table, weights, bias=None):
    """K2 without the operator: the wrapper's checks, then the launch."""
    pallas_gather._check(features, table, weights, bias)
    return pallas_gather._gather_conv_cuda(features, table, weights, bias)


def host_us(fn):
    """Host microseconds of one call: CALLS calls enqueued, then synced
    outside the clock; the median of 20 such batches after 3."""
    ts = []
    for i in range(23):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(CALLS):
            fn()
        t = time.perf_counter() - t0
        torch.cuda.synchronize()
        if i >= 3:
            ts.append(t / CALLS * 1e6)
    return statistics.median(ts)


def in_turns(rounds, measure):
    """{route: [numbers]} from direct, operator, operator, direct turns."""
    out = {"direct": [], "operator": []}
    for _ in range(rounds):
        for route in ("direct", "operator", "operator", "direct"):
            out[route].append(measure(route))
    return out


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--rounds", type=int, default=2)
    args = p.parse_args()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = cs.card_line()
    _build.build_all()
    rng = np.random.default_rng(0)

    # one call each --------------------------------------------------------
    boxes = torch.from_numpy(cs.k1_dense_cluster(7, 1000, rng)).to(dev)
    boxes[..., :2] *= 50.0                       # spread over the canvas
    valid = torch.ones(7, 1000, dtype=torch.bool, device=dev)
    V = 60000
    feats = torch.randn(V, 32, device=dev)
    table = torch.randint(0, V + 1, (27, V), dtype=torch.int32, device=dev)
    w = torch.randn(27, 32, 32, device=dev) / 30
    b = torch.randn(32, device=dev)
    calls = {"k1": {"direct": lambda: direct_k1(boxes, valid, 0.2),
                    "operator": lambda: pallas_nms.rotate_nms_alive(
                        boxes, valid, 0.2)},
             "k2": {"direct": lambda: direct_k2(feats, table, w, b),
                    "operator": lambda: pallas_gather.gather_conv(
                        feats, table, w, b)}}
    for k, fns in calls.items():
        same = torch.equal(fns["direct"](), fns["operator"]())
        cs.check(same, f"{k}: the operator's output differs from the "
                 "direct launch")
        got = in_turns(args.rounds, lambda r, f=fns: host_us(f[r]))
        print(json.dumps({
            "what": f"{k}_host_us_per_call", "card": card,
            "shape": ([7, 1000, 5] if k == "k1" else
                      {"V": V, "N": V, "cin": 32, "cout": 32}),
            "identical": same, "turns": got,
            "direct_us": statistics.median(got["direct"]),
            "operator_us": statistics.median(got["operator"]),
            "operator_minus_direct_us": statistics.median(got["operator"])
            - statistics.median(got["direct"])}), flush=True)

    # a whole scene (phases 5 and 9) --------------------------------------
    for name in (cs.NAME, cs.VOX_NAME):
        cfg = get_config(name)
        if name == cs.NAME:
            cfg = cfg.replace(voxel=dataclasses.replace(
                cfg.voxel, max_points=cs.MAX_POINTS, max_voxels_eval=30000))
            pts, pv = cs.scene_uniform(cfg, np.random.default_rng(0))
        else:
            pts, pv = cs.scene_blobs(cfg, np.random.default_rng(0))
        pts, pv = torch.from_numpy(pts).to(dev), torch.from_numpy(pv).to(dev)
        model = build_detector(cfg, device=dev, seed=0)

        def run():
            with torch.no_grad():
                return decode_and_nms(cfg, model(pts, pv))

        k1, k2 = nms_mod.rotate_nms_alive, sc_mod.gather_conv
        outs = {}

        def scene(route):
            if route == "direct":
                nms_mod.rotate_nms_alive, sc_mod.gather_conv = \
                    direct_k1, direct_k2
            try:
                outs.setdefault(route, run())
                return cs.time_host(run)
            finally:
                nms_mod.rotate_nms_alive, sc_mod.gather_conv = k1, k2

        got = in_turns(args.rounds, scene)
        same = all(torch.equal(a, c) for a, c in
                   zip(outs["direct"], outs["operator"]))
        print(json.dumps({
            "what": "ms_per_scene", "model": name, "card": card,
            "scene": "uniform" if name == cs.NAME else "uniform_blobs",
            "identical_detections": same, "turns": got,
            "direct_ms": statistics.median(got["direct"]),
            "operator_ms": statistics.median(got["operator"])}),
            flush=True)


if __name__ == "__main__":
    main()
