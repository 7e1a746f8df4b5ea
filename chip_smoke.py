#!/usr/bin/env python3
"""Smoke run of futuredet_torch on one NVIDIA GPU: the quickest proof that
the port builds, agrees with itself and starts on the card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card and the
CUDA toolkit. Phases, one JSON line each:

  1. device and build: card name and power limit, then the CUDA kernels of
     futuredet_torch/csrc built into build/torch_kernels/.
  2. main path: full-width pp_forecast_n3dtf (150k points, 512x512 canvas,
     RPN (64,128,256) x (3,5,5), 7 chained heads, 7 x 1000-box NMS) with
     seeded random weights, on a uniform and a clustered scene, through
     build_detector -> decode_and_nms. Launch counts are zeroed just before
     and read just after: each scene must launch kernel K1 exactly once.
  3. K1 against its plain PyTorch version on the card: the 7 x 1000 NMS
     problems of the uniform scene's decode, a 1000-deep suppression chain
     and axis-aligned boxes with collinear edges. Survivor masks must be
     identical.
  4. the uniform scene through the same weights on the CPU (plain
     versions): post-sigmoid heatmaps within 1e-3, detections matched.
  5. times: 3 warm-up runs, then the median of 20.

TF32 is turned off for convolutions and matmuls, so that the card computes
in fp32 as the CPU does. Any failure raises; the last line is the result.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

NAME = "pp_forecast_n3dtf"
MAX_POINTS = 150000
WARMUP, REPS = 3, 20
HM_ATOL = 1e-3            # card vs CPU, fp32 convs in another order
CANVAS_ATOL = 1e-4        # card vs CPU reader output, sums in another order
FP32_PEAK = 67e12         # H100 SXM fp32 vector peak, FLOP/s
HBM_RATE = 3.35e12        # H100 SXM device memory, bytes/s
# fp32 operations of one K1 pair test (csrc/nms_kernel.cu): 8 clipped edges
# of ~50 operations each, the victim's 4 corners (32), the two sums, eps
# shifts and the IoU ratio (~20); the sin/cos of each box are not counted
K1_OPS_PER_PAIR = 450


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond, msg) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def scene_uniform(cfg, rng):
    """bench.py's uniform scene: xy over the whole range."""
    lo, hi = cfg.voxel.pc_range[0], cfg.voxel.pc_range[3]
    pts = np.concatenate([
        rng.uniform(lo, hi, (1, MAX_POINTS, 2)),
        rng.uniform(-4, 2, (1, MAX_POINTS, 1)),
        rng.uniform(0, 1, (1, MAX_POINTS, 2))], -1).astype(np.float32)
    return pts, np.ones((1, MAX_POINTS), bool)


def scene_clustered(cfg, rng, n_objects=60):
    """Object-sized blobs (car-sized boxes of points at random headings,
    60% of the points) over a sparse ground background."""
    lo, hi = cfg.voxel.pc_range[0], cfg.voxel.pc_range[3]
    per_object = int(0.6 * MAX_POINTS) // n_objects
    n_obj_pts = n_objects * per_object
    centres = rng.uniform(0.94 * lo, 0.94 * hi, (n_objects, 2))
    yaw = rng.uniform(-np.pi, np.pi, n_objects)
    size = np.stack([rng.uniform(3.5, 5.5, n_objects),
                     rng.uniform(1.6, 2.2, n_objects)], -1)
    local = rng.uniform(-0.5, 0.5, (n_objects, per_object, 2)) * size[:, None]
    c, s = np.cos(yaw)[:, None], np.sin(yaw)[:, None]
    xy = np.stack([c * local[..., 0] - s * local[..., 1],
                   s * local[..., 0] + c * local[..., 1]], -1)
    xy = (xy + centres[:, None]).reshape(-1, 2)
    z = rng.uniform(-1.8, -0.2, (n_obj_pts, 1))
    n_bg = MAX_POINTS - n_obj_pts
    bg = np.concatenate([rng.uniform(lo, hi, (n_bg, 2)),
                         rng.uniform(-2.0, -1.7, (n_bg, 1))], -1)
    xyz = np.concatenate([np.concatenate([xy, z], -1), bg], 0)
    feats = rng.uniform(0, 1, (MAX_POINTS, 2))
    pts = np.concatenate([xyz, feats], -1)[None].astype(np.float32)
    return pts, np.ones((1, MAX_POINTS), bool)


def assert_detections_match(boxes, scores, labels, rboxes, rscores, rlabels,
                            score_floor=0.1, center_tol=0.1,
                            score_tol=1e-2):
    """Greedy same-label centre matching: every confident reference
    detection needs a counterpart within center_tol with score within
    score_tol and geometry within 0.05 (the matcher of the JAX package's
    checkpoint-parity test)."""
    want = rscores >= score_floor
    rboxes, rscores, rlabels = rboxes[want], rscores[want], rlabels[want]
    used = np.zeros(len(boxes), bool)
    for rb, rs, rl in zip(rboxes, rscores, rlabels):
        d = np.linalg.norm(boxes[:, :2] - rb[:2], axis=1)
        d = np.where((labels == rl) & ~used, d, np.inf)
        j = int(np.argmin(d))
        check(d[j] <= center_tol,
              f"reference detection at {rb[:3]} (label {rl}, score "
              f"{rs:.3f}) has no match within {center_tol} m (closest "
              f"{d[j]:.3f})")
        used[j] = True
        check(abs(scores[j] - rs) <= score_tol, (scores[j], rs))
        np.testing.assert_allclose(boxes[j][:6], rb[:6], atol=0.05)
        np.testing.assert_allclose(
            [np.sin(boxes[j][8]), np.cos(boxes[j][8])],
            [np.sin(rb[8]), np.cos(rb[8])], atol=0.05)


def time_host(fn):
    """Median wall ms of fn() ending in a synchronize."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def time_device(fn):
    """Median device ms of one fn() between CUDA events. The card is kept
    busy while the host enqueues, so host launch overhead is not counted."""
    for _ in range(WARMUP):
        fn()
    ts = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        ts.append(start.elapsed_time(end))
    return statistics.median(ts)


def kill_bits(mask, n):
    """(G, N, W) int64 words -> (G, N, N) bool, bit j of row i = kill."""
    shifts = torch.arange(64, device=mask.device)
    bits = (mask[..., None] >> shifts) & 1
    return bits.reshape(*mask.shape[:2], -1)[..., :n].bool()


def k1_needed_pairs(kills, alive, valid):
    """Pair tests greedy NMS needs on this data: each surviving box i
    against every later valid box j that no survivor before i removed."""
    G, N, _ = kills.shape
    idx = torch.arange(N, device=kills.device)
    later = idx[None, :] > idx[:, None]
    k = kills & later & alive[:, :, None]
    # first survivor that removes j (N if none)
    first = torch.where(k, idx[None, :, None], N).amin(1)
    # survivors i < j with i <= first[j] test j
    upto = torch.minimum(idx[None, :] - 1, first).clamp_min(-1)
    cum = torch.cumsum(alive.long(), -1)
    tested = torch.where(upto >= 0, cum.gather(1, upto.clamp_min(0)), 0)
    return int((tested * valid.long()).sum())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    try:
        import futuredet_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: futuredet_torch not importable ({e}); run from "
              "the root of a checkout", file=sys.stderr)
        return 3
    import dataclasses

    from futuredet_torch.config import get_config
    from futuredet_torch.eval.decode import decode_and_nms
    from futuredet_torch.models.detector import build_detector
    from futuredet_torch.ops import _build
    from futuredet_torch.ops import nms as nms_mod
    from futuredet_torch.ops import pallas_nms
    from futuredet_torch.ops.rotated_iou import pairwise_iou_bev

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()

    # 1. device and build -------------------------------------------------
    t0 = time.perf_counter()
    secs = _build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in _build.build_log("nms_kernel.cu")
             .splitlines() if "registers" in ln or "Compiling" in ln]
    emit({"phase": "device_build", "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": round(build_s, 3), "per_source_s": secs,
          "ptxas": ptxas, "tf32": False})

    cfg = get_config(NAME)
    cfg = cfg.replace(voxel=dataclasses.replace(
        cfg.voxel, max_points=MAX_POINTS, max_voxels_eval=30000))
    model = build_detector(cfg, device=dev, seed=0)
    scenes = {"uniform": scene_uniform(cfg, np.random.default_rng(0)),
              "clustered": scene_clustered(cfg, np.random.default_rng(1))}
    on_card = {k: (torch.from_numpy(p).to(dev), torch.from_numpy(v).to(dev))
               for k, (p, v) in scenes.items()}

    def run(pts, valid, m=model):
        with torch.no_grad():
            preds = m(pts, valid)
            return preds, decode_and_nms(cfg, preds)

    # 2. main path, K1 inputs recorded ------------------------------------
    recorded = []

    def recorder(b, v, thr):
        recorded.append((b.clone(), v.clone(), thr))
        return kernel(b, v, thr)

    kernel = nms_mod.rotate_nms_alive
    nms_mod.rotate_nms_alive = recorder
    kernel.launches = 0
    outputs, per_scene = {}, {}
    for name, (pts, valid) in on_card.items():
        before = kernel.launches
        outputs[name] = run(pts, valid)
        torch.cuda.synchronize()
        per_scene[name] = kernel.launches - before
    launches = kernel.launches
    nms_mod.rotate_nms_alive = kernel
    T = cfg.model.head.timesteps
    post = cfg.test.nms.post_max_size
    for name, (preds, det) in outputs.items():
        check(per_scene[name] == 1, f"{name}: K1 launched "
              f"{per_scene[name]} times")
        for p in preds:
            for k, v in p.items():
                check(bool(torch.isfinite(v).all()), f"{name} {k} not finite")
        check(bool(torch.isfinite(det.boxes).all()
                   and torch.isfinite(det.scores).all()),
              f"{name} detections not finite")
        check(det.boxes.shape == (1, T * post, 9), det.boxes.shape)
        per_t = det.valid.reshape(T, post).sum(-1).tolist()
        check(sum(per_t) > 0, f"{name}: no detections")
        emit({"phase": "main_path", "scene": name,
              "k1_launches": per_scene[name], "detections_per_t": per_t,
              "hm_max": float(torch.sigmoid(preds[0]["hm"]).max())})
    check(launches == 2, f"main path launched K1 {launches} times")

    # 3. K1 against its plain version on the card -------------------------
    b_main, v_main, thr = recorded[0]
    check(tuple(b_main.shape) == (T, cfg.test.nms.pre_max_size, 5),
          b_main.shape)
    n = 1000
    chain = torch.zeros(1, n, 5, device=dev)
    chain[0, :, 0] = torch.arange(n, device=dev) * 1.2
    chain[0, :, 2:4] = 2.0
    chain[0, :, 4] = -math.pi / 2
    grid = torch.zeros(1, 400, 5, device=dev)
    gi = torch.arange(400, device=dev)
    grid[0, :, 0] = (gi % 20).float() * 2.0
    grid[0, :, 1] = (gi // 20).float() * 1.0      # rows half-overlapping
    grid[0, :, 2:4] = 2.0
    cases = {"main_path_7x1000": (b_main, v_main, thr),
             "chain_1000": (chain, torch.ones(1, n, dtype=torch.bool,
                                              device=dev), 0.1),
             "collinear_grid_400": (grid, torch.ones(1, 400,
                                                     dtype=torch.bool,
                                                     device=dev), 0.2)}
    k1_err = 0.0
    for cname, (b, v, th) in cases.items():
        got, mask = pallas_nms.launch_with_mask(b, v, th)
        want = pallas_nms.nms_alive_plain(b, v, th)
        torch.cuda.synchronize()
        iou = pairwise_iou_bev(b, b).transpose(-1, -2)
        N = b.shape[1]
        later = torch.ones(N, N, dtype=torch.bool, device=dev).triu_(1)
        kb = kill_bits(mask, N) & later
        kp = (iou > th) & later
        pair_diff = int((kb != kp).sum())
        same = bool(torch.equal(got, want))
        line = {"phase": "k1_vs_plain", "case": cname,
                "shape": list(b.shape), "survivors": int(got.sum()),
                "identical": same, "pair_bits_differing": pair_diff}
        if pair_diff or not same:
            g, i, j = torch.nonzero(kb != kp)[:10].T.tolist() or ([], [], [])
            cpu_iou = pairwise_iou_bev(b.cpu(), b.cpu())
            line["pairs"] = [
                {"g": gg, "killer": ii, "victim": jj,
                 "kernel_kill": bool(kb[gg, ii, jj]),
                 "plain_iou_card": float(iou[gg, ii, jj]),
                 "plain_iou_cpu": float(cpu_iou[gg, jj, ii])}
                for gg, ii, jj in zip(g, i, j)]
        emit(line)
        check(same, f"K1 differs from its plain version on {cname}")
        k1_err = max(k1_err, float((got != want).sum()))
    chain_alive = pallas_nms.rotate_nms_alive(*cases["chain_1000"][:2], 0.1)
    check(int(chain_alive.sum()) == n // 2, "chain survivors")

    # 4. the same weights on the CPU --------------------------------------
    t0 = time.perf_counter()
    cpu_model = build_detector(cfg, device="cpu", seed=0)
    pts, valid = scenes["uniform"]
    cpu_preds, cpu_det = run(torch.from_numpy(pts), torch.from_numpy(valid),
                             cpu_model)
    cpu_s = time.perf_counter() - t0
    gpu_preds, gpu_det = outputs["uniform"]
    # the pillar canvas first: a point in another pillar shows here as an
    # O(1) difference, summation order only as ~1e-6
    with torch.no_grad():
        canvas_err = float((model.reader(*on_card["uniform"]).cpu()
                            - cpu_model.reader(torch.from_numpy(pts),
                                               torch.from_numpy(valid))
                            ).abs().max())
    check(canvas_err <= CANVAS_ATOL, f"pillar canvas card vs CPU {canvas_err}")
    hm_err = max(float((torch.sigmoid(g["hm"]).cpu()
                        - torch.sigmoid(c["hm"])).abs().max())
                 for g, c in zip(gpu_preds, cpu_preds))
    check(hm_err <= HM_ATOL, f"heatmap card vs CPU {hm_err}")
    gk = gpu_det.valid[0].cpu().numpy()
    ck = cpu_det.valid[0].numpy()
    assert_detections_match(
        gpu_det.boxes[0].cpu().numpy()[gk], gpu_det.scores[0].cpu().numpy()[gk],
        gpu_det.labels[0].cpu().numpy()[gk], cpu_det.boxes[0].numpy()[ck],
        cpu_det.scores[0].numpy()[ck], cpu_det.labels[0].numpy()[ck])
    emit({"phase": "cpu_cross_check", "scene": "uniform",
          "layer_nums": list(cfg.model.rpn.layer_nums),
          "cpu_s": round(cpu_s, 3), "canvas_max_abs_err": canvas_err,
          "canvas_atol": CANVAS_ATOL, "hm_max_abs_err": hm_err,
          "hm_atol": HM_ATOL, "detections_card": int(gk.sum()),
          "detections_cpu": int(ck.sum())})

    # 5. times --------------------------------------------------------------
    times = {}
    for name, (p, v) in on_card.items():
        torch.cuda.reset_peak_memory_stats()
        times[name] = time_host(lambda p=p, v=v: run(p, v))
        times[name + "_peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
    k1_ms = time_device(lambda: pallas_nms.rotate_nms_alive(
        b_main, v_main, thr))
    plain_ms = time_device(lambda: pallas_nms.nms_alive_plain(
        b_main, v_main, thr))
    # bound: bytes in and out once, or the pair tests this data needs
    alive = pallas_nms.nms_alive_plain(b_main, v_main, thr)
    iou = pairwise_iou_bev(b_main, b_main).transpose(-1, -2)
    pairs = k1_needed_pairs(iou > thr, alive, v_main)
    nbytes = b_main.numel() * 4 + v_main.numel() + alive.numel()
    bytes_ms = nbytes / HBM_RATE * 1e3
    ops_ms = pairs * K1_OPS_PER_PAIR / FP32_PEAK * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    emit({"phase": "times", "card": card,
          "main_path_ms_per_scene": {k: times[k] for k in on_card},
          "main_path_peak_mib": {k: times[k + "_peak_mib"] for k in on_card},
          "k1_ms": k1_ms, "plain_ms": plain_ms, "k1_bound_ms": bound_ms,
          "k1_pairs_needed": pairs, "k1_pairs_all": int(
              T * b_main.shape[1] * (b_main.shape[1] - 1) // 2),
          "k1_bytes": nbytes, "warmup": WARMUP, "reps": REPS})

    print(card, flush=True)
    emit({"kernels": [{
        "name": "K1 rotated NMS survivor mask",
        "route": "cuda", "source": "futuredet_torch/csrc/nms_kernel.cu",
        "replaces": "futuredet_tpu/ops/pallas_nms.py:82",
        "launches": launches, "matched": True, "max_abs_err": k1_err,
        "ms": k1_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": None}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
