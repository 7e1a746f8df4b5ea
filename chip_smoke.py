#!/usr/bin/env python3
"""Smoke run of futuredet_torch on one NVIDIA GPU: the quickest proof that
the port builds, agrees with itself and starts on the card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card and the
CUDA toolkit. Phases, one JSON line each (several for some):

  1. device and build: card name and power limit, then the CUDA kernels of
     futuredet_torch/csrc (K1 nms_kernel.cu, K2 gather_conv_kernel.cu) built
     at once into build/torch_kernels/, with ptxas's lines for each.

  The pillar path, pp_forecast_n3dtf:
  2. main path: full width (150k points, 512x512 canvas, RPN (64,128,256) x
     (3,5,5), 7 chained heads, 7 x 1000-box NMS) with seeded random weights,
     on a uniform and a clustered scene, through build_detector ->
     decode_and_nms. Launch counts are zeroed just before and read just
     after: each scene must launch K1 exactly once and K2 never.
  3. K1 against its plain PyTorch version on the card: the 7 x 1000 NMS
     problems of the uniform scene's decode, a 1000-deep suppression chain
     and axis-aligned boxes with collinear edges. Survivor masks must be
     identical.
  4. the uniform scene through the same weights on the CPU (plain
     versions): post-sigmoid heatmaps within 1e-3, detections matched.
  5. times: 3 warm-up runs, then the median of 20.

  The sparse VoxelNet path, forecast_n3dtf:
  6. main path: full width (300k points into a 1440x1440x41 grid at
     0.075 x 0.075 x 0.2 m, up to 160k voxels, the 4-stage sparse middle
     encoder 16/32/64/128 over 20 sparse convs, z_crush, RPN (5,5) x
     (128,256) at 180x180, 7 chained heads on 512 channels, 7 x 1000-box
     NMS) with seeded random weights, on a blobbed-uniform and a clustered
     scene. Counts zeroed just before and read just after: each scene must
     launch K2 exactly 20 times and K1 once; the voxel budget must not
     bind.
  7. K2 against its plain PyTorch version on the card: the 20 convs of the
     uniform scene as the main path gave them (max |diff| <= 1e-5 *
     max(1, max|plain|), fp32 summation order), one conv launched again
     (bit-identical), and adversarial tables: Cin = 5, N = 1 and N = 65, a
     table of absent entries only (exactly the bias), a tile whose 64
     sites have all 27 neighbours.
  8. the uniform scene through the same weights on the CPU: voxel coords
     and counts identical and features within 1e-6, per-stage site counts
     identical, post-sigmoid heatmaps within 1e-3, detections matched.
  9. times: ms per scene (3 warm-ups, median of 20) and peak memory; K2
     per launch for four representative convs; K2, its plain version, the
     stacked index_select + mm yardstick and the bound for all 20 convs.

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
VOX_NAME = "forecast_n3dtf"
WARMUP, REPS = 3, 20
HM_ATOL = 1e-3            # card vs CPU, fp32 convs in another order
CANVAS_ATOL = 1e-4        # card vs CPU reader output, sums in another order
VOXEL_FEAT_ATOL = 1e-6    # card vs CPU voxel means, the same adds in order
K2_RTOL = 1e-5            # K2 vs plain: of max(1, max|plain|), fp32 order
FP32_PEAK = 67e12         # H100 SXM fp32 vector peak, FLOP/s
HBM_RATE = 3.35e12        # H100 SXM device memory, bytes/s
# fp32 operations of one K1 pair test (csrc/nms_kernel.cu): 8 clipped edges
# of ~50 operations each, the victim's 4 corners (32), the two sums, eps
# shifts and the IoU ratio (~20); the sin/cos of each box are not counted
K1_OPS_PER_PAIR = 450
# the four K2 launches timed alone: index of the conv in the encoder's
# order (stage 0: conv_input, 4 block convs; stages 1-3: down, 4 block
# convs each)
K2_REPRESENTATIVE = {"s0_conv_input_5to16": 0, "s0_subm_16to16": 1,
                     "down1_16to32": 5, "s3_subm_128to128": 16}


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


def scene_blobs(cfg, rng):
    """bench.py's `_uniform_blob_points`: the whole range covered by
    blobs of 4x4x3 voxels (about 2 points per voxel), max_voxels_eval /
    48 blobs. Unlike bench.py's, the blob corners snap to the voxel grid:
    each blob then covers exactly 48 voxels and the scene stays within the
    160k voxel budget (bench.py's blobs straddle voxel faces and, on this
    seed, occupy 176,101 voxels)."""
    P = cfg.voxel.max_points
    lo, hi = cfg.voxel.pc_range[0], cfg.voxel.pc_range[3]
    vs = np.array(cfg.voxel.voxel_size)
    rmin = np.array(cfg.voxel.pc_range[:3])
    bz, by, bx = 3, 4, 4
    n_blobs = cfg.voxel.max_voxels_eval // (bz * by * bx)
    oz, oy, ox = np.meshgrid(np.arange(bz), np.arange(by), np.arange(bx),
                             indexing="ij")
    offs = np.stack([ox.ravel(), oy.ravel(), oz.ravel()], -1) * vs
    centers = np.concatenate([
        rng.uniform(lo, hi - bx * vs[0], (n_blobs, 2)),
        rng.uniform(-4, 2 - bz * vs[2], (n_blobs, 1))], -1)
    centers = rmin + np.floor((centers - rmin) / vs) * vs
    base = (centers[:, None, :] + offs[None, :, :]).reshape(-1, 3)
    xyz = np.tile(base, (-(-P // len(base)), 1))[:P]
    xyz = xyz + rng.uniform(0.05, 0.95, xyz.shape) * vs
    pts = np.concatenate([xyz, rng.uniform(0, 1, (P, 2))], -1)
    return pts[None].astype(np.float32), np.ones((1, P), bool)


def scene_lidar(cfg, rng, n_objects=40):
    """A clustered scene for the voxel grid: half the points on the sides
    and tops of car-sized boxes at random headings, half on 24 ground rings
    around the sensor (denser near it), so that about 1.7 to 2.5 points
    share a voxel and the scene holds ~133k voxels, under the budget."""
    P = cfg.voxel.max_points
    lo, hi = cfg.voxel.pc_range[0], cfg.voxel.pc_range[3]
    per = (P // 2) // n_objects
    centres = rng.uniform(0.9 * lo, 0.9 * hi, (n_objects, 2))
    yaw = rng.uniform(-np.pi, np.pi, n_objects)
    size = np.stack([rng.uniform(3.5, 5.5, n_objects),
                     rng.uniform(1.6, 2.2, n_objects),
                     rng.uniform(1.4, 1.9, n_objects)], -1)
    u = rng.uniform(-0.5, 0.5, (n_objects, per, 3))
    face = rng.integers(0, 5, (n_objects, per))    # 4 sides, then the top
    ax = np.where(face < 2, 0, np.where(face < 4, 1, 2))
    side = np.where(ax == 2, 0.5, np.where(face % 2 == 0, -0.5, 0.5))
    np.put_along_axis(u, ax[..., None], side[..., None], -1)
    local = u * size[:, None]
    c, s = np.cos(yaw)[:, None], np.sin(yaw)[:, None]
    cx, cy = centres[:, None, 0], centres[:, None, 1]
    obj = np.stack([c * local[..., 0] - s * local[..., 1] + cx,
                    s * local[..., 0] + c * local[..., 1] + cy,
                    local[..., 2] + size[:, None, 2] / 2 - 1.8], -1)
    obj = obj.reshape(-1, 3)
    n_bg = P - len(obj)
    r = 3.0 * 1.1 ** rng.integers(0, 24, n_bg) \
        * (1 + rng.normal(0, 0.002, n_bg))
    az = rng.uniform(-np.pi, np.pi, n_bg)
    bg = np.stack([r * np.cos(az), r * np.sin(az),
                   -1.8 + rng.normal(0, 0.03, n_bg)], -1)
    pts = np.concatenate([np.concatenate([obj, bg], 0),
                          rng.uniform(0, 1, (P, 2))], -1)
    return pts[None].astype(np.float32), np.ones((1, P), bool)


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


def check_detections_match(gpu_det, cpu_det):
    gk = gpu_det.valid[0].cpu().numpy()
    ck = cpu_det.valid[0].numpy()
    assert_detections_match(
        gpu_det.boxes[0].cpu().numpy()[gk],
        gpu_det.scores[0].cpu().numpy()[gk],
        gpu_det.labels[0].cpu().numpy()[gk], cpu_det.boxes[0].numpy()[ck],
        cpu_det.scores[0].numpy()[ck], cpu_det.labels[0].numpy()[ck])
    return int(gk.sum()), int(ck.sum())


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


def k2_bound(features, table, weights, bias):
    """(bytes ms, operations ms, present pairs) of one gather-conv: every
    input read once and the output written once at the memory rate, and
    2 * present (k, n) pairs * Cin * Cout fp32 operations at the fp32
    peak."""
    V, cin = features.shape
    N, cout = table.shape[1], weights.shape[2]
    present = int(((table >= 0) & (table < V)).sum())
    nbytes = 4 * (features.numel() + table.numel() + weights.numel()
                  + (0 if bias is None else cout) + N * cout)
    return (nbytes / HBM_RATE * 1e3,
            2 * present * cin * cout / FP32_PEAK * 1e3, present)


def k2_library_call(features, table, weights, bias):
    """The stacked form as two PyTorch calls, a yardstick that no path
    calls: index_select of the 27*N rows (n-major), then one fp32 mm (addmm
    with the bias) of the (N, 27*Cin) block. The flat table and the padded
    features are made outside the timed function."""
    V, cin = features.shape
    N, cout = table.shape[1], weights.shape[2]
    padded = torch.cat([features, features.new_zeros(1, cin)])
    flat = table.t().reshape(-1).contiguous()
    w2 = weights.reshape(27 * cin, cout)
    b = bias if bias is not None else features.new_zeros(cout)

    def fn():
        return torch.addmm(b, padded.index_select(0, flat).view(N, 27 * cin),
                           w2)
    return fn


def pillar_path(dev, card):
    """Phases 2-5. Returns K1's numbers of this path."""
    import dataclasses

    from futuredet_torch.config import get_config
    from futuredet_torch.eval.decode import decode_and_nms
    from futuredet_torch.models.detector import build_detector
    from futuredet_torch.ops import nms as nms_mod
    from futuredet_torch.ops import pallas_gather, pallas_nms
    from futuredet_torch.ops.rotated_iou import pairwise_iou_bev

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
    kernel.launches = pallas_gather.gather_conv.launches = 0
    outputs, per_scene = {}, {}
    for name, (pts, valid) in on_card.items():
        before = kernel.launches
        outputs[name] = run(pts, valid)
        torch.cuda.synchronize()
        per_scene[name] = kernel.launches - before
    launches = kernel.launches
    k2_launches = pallas_gather.gather_conv.launches
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
        emit({"phase": "main_path", "model": NAME, "scene": name,
              "k1_launches": per_scene[name], "detections_per_t": per_t,
              "hm_max": float(torch.sigmoid(preds[0]["hm"]).max())})
    check(launches == 2, f"main path launched K1 {launches} times")
    check(k2_launches == 0, f"the pillar path launched K2 {k2_launches} "
          "times")

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
    n_card, n_cpu = check_detections_match(gpu_det, cpu_det)
    emit({"phase": "cpu_cross_check", "model": NAME, "scene": "uniform",
          "layer_nums": list(cfg.model.rpn.layer_nums),
          "cpu_s": round(cpu_s, 3), "canvas_max_abs_err": canvas_err,
          "canvas_atol": CANVAS_ATOL, "hm_max_abs_err": hm_err,
          "hm_atol": HM_ATOL, "detections_card": n_card,
          "detections_cpu": n_cpu})

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
    emit({"phase": "times", "model": NAME, "card": card,
          "main_path_ms_per_scene": {k: times[k] for k in on_card},
          "main_path_peak_mib": {k: times[k + "_peak_mib"] for k in on_card},
          "k1_ms": k1_ms, "plain_ms": plain_ms, "k1_bound_ms": bound_ms,
          "k1_pairs_needed": pairs, "k1_pairs_all": int(
              T * b_main.shape[1] * (b_main.shape[1] - 1) // 2),
          "k1_bytes": nbytes, "warmup": WARMUP, "reps": REPS})
    return {"launches": launches, "k2_launches": k2_launches,
            "max_abs_err": k1_err, "ms": k1_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def k2_compare(features, table, weights, bias):
    """K2 and its plain version on the same inputs: (line, ok)."""
    from futuredet_torch.ops import pallas_gather
    got = pallas_gather.gather_conv(features, table, weights, bias)
    want = pallas_gather.gather_conv_plain(features, table, weights, bias)
    torch.cuda.synchronize()
    diff = (got - want).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    tol = K2_RTOL * max(1.0, float(want.abs().max()) if want.numel() else 0.0)
    line = {"V": features.shape[0], "N": table.shape[1],
            "cin": features.shape[1], "cout": weights.shape[2],
            "max_abs_err": err, "tol": tol}
    if err > tol:
        rows = diff.amax(1).topk(min(5, diff.shape[0])).indices
        line["worst_rows"] = [
            {"n": int(r), "kernel": got[r].tolist()[:8],
             "plain": want[r].tolist()[:8],
             "table": table[:, r].tolist()} for r in rows]
    return line, err <= tol, err


def voxelnet_path(dev, card):
    """Phases 6-9. Returns the numbers of K1 and K2 on this path."""
    from futuredet_torch.config import get_config
    from futuredet_torch.eval.decode import decode_and_nms
    from futuredet_torch.models.detector import build_detector
    from futuredet_torch.ops import pallas_gather, pallas_nms
    from futuredet_torch.ops import sparse_conv as sc_mod
    from futuredet_torch.ops.voxelize import point_voxel_map, run_means

    cfg = get_config(VOX_NAME)
    v = cfg.voxel
    model = build_detector(cfg, device=dev, seed=0)
    scenes = {"uniform_blobs": scene_blobs(cfg, np.random.default_rng(0)),
              "clustered": scene_lidar(cfg, np.random.default_rng(1))}
    on_card = {k: (torch.from_numpy(p).to(dev), torch.from_numpy(q).to(dev))
               for k, (p, q) in scenes.items()}

    def run(pts, valid, m=model):
        with torch.no_grad():
            preds = m(pts, valid)
            return preds, decode_and_nms(cfg, preds)

    # 6. main path, K2 inputs of the first scene recorded -----------------
    k2 = pallas_gather.gather_conv
    k1 = pallas_nms.rotate_nms_alive
    recorded = []

    def recorder(f, t, w, b=None):
        if record[0]:
            recorded.append((f.clone(), t.clone(), w.clone(),
                             None if b is None else b.clone()))
        return k2(f, t, w, b)

    record = [True]
    sc_mod.gather_conv = recorder
    k2.launches = k1.launches = 0
    outputs, per_scene, sites = {}, {}, {}
    for name, (pts, valid) in on_card.items():
        b2, b1 = k2.launches, k1.launches
        outputs[name] = run(pts, valid)
        torch.cuda.synchronize()
        per_scene[name] = (k2.launches - b2, k1.launches - b1)
        sites[name] = (list(model.num_voxels),
                       list(model.backbone.site_counts))
        record[0] = False
    launches = {"k2": k2.launches, "k1": k1.launches}
    sc_mod.gather_conv = k2
    T = cfg.model.head.timesteps
    post = cfg.test.nms.post_max_size
    for name, (preds, det) in outputs.items():
        n2, n1 = per_scene[name]
        check(n2 == 20, f"{name}: K2 launched {n2} times")
        check(n1 == 1, f"{name}: K1 launched {n1} times")
        nvox = sites[name][0][0]
        check(nvox < v.max_voxels_eval,
              f"{name}: {nvox} voxels, the budget {v.max_voxels_eval} bound")
        for p in preds:
            for k, t in p.items():
                check(bool(torch.isfinite(t).all()), f"{name} {k} not finite")
        check(bool(torch.isfinite(det.boxes).all()
                   and torch.isfinite(det.scores).all()),
              f"{name} detections not finite")
        check(det.boxes.shape == (1, T * post, 9), det.boxes.shape)
        per_t = det.valid.reshape(T, post).sum(-1).tolist()
        check(sum(per_t) > 0, f"{name}: no detections")
        emit({"phase": "main_path", "model": VOX_NAME, "scene": name,
              "k2_launches": n2, "k1_launches": n1, "voxels": nvox,
              "voxel_budget": v.max_voxels_eval,
              "sites_per_stage": sites[name][1],
              "detections_per_t": per_t,
              "hm_max": float(torch.sigmoid(preds[0]["hm"]).max())})
    check(launches == {"k2": 40, "k1": 2},
          f"voxelnet main path launches {launches}")
    check(len(recorded) == 20, f"{len(recorded)} K2 launches recorded")

    # 7. K2 against its plain version on the card -------------------------
    convs, ok_all, k2_err = [], True, 0.0
    for i, args in enumerate(recorded):
        line, ok, err = k2_compare(*args)
        line["conv"] = i
        convs.append(line)
        ok_all &= ok
        k2_err = max(k2_err, err)
    emit({"phase": "k2_vs_plain", "case": "main_path_20_convs",
          "rtol_of_max_plain": K2_RTOL, "convs": convs})
    check(ok_all, "K2 differs from its plain version on the main path")
    f, t, w, b = recorded[1]
    first = k2(f, t, w, b)
    again = k2(f, t, w, b)
    same = bool(torch.equal(first, again))
    emit({"phase": "k2_vs_plain", "case": "relaunch_s0_subm",
          "bit_identical": same})
    check(same, "K2 is not bit-identical from launch to launch")
    rng = np.random.default_rng(2)

    def case(V, N, cin, cout, absent):
        tab = rng.integers(0, V, (27, N))
        tab[rng.random((27, N)) < absent] = V
        return (torch.from_numpy(rng.normal(size=(V, cin)).astype(
                    np.float32)).to(dev),
                torch.from_numpy(tab.astype(np.int32)).to(dev),
                torch.from_numpy((rng.normal(size=(27, cin, cout))
                                  / math.sqrt(27 * cin)).astype(
                                      np.float32)).to(dev),
                torch.from_numpy(rng.normal(size=cout).astype(
                    np.float32)).to(dev))

    adversarial = {"cin5": case(4000, 4000, 5, 16, 0.5),
                   "n1": case(3000, 1, 64, 128, 0.3),
                   "n65": case(3000, 65, 32, 64, 0.3),
                   "all_absent": case(2000, 300, 16, 32, 1.0),
                   "all_27_present_tile": case(5000, 64, 128, 128, 0.0)}
    for cname, args in adversarial.items():
        line, ok, err = k2_compare(*args)
        if cname == "all_absent":
            got = k2(*args)
            ok &= bool(torch.equal(got, args[3].expand_as(got)))
            line["exactly_bias"] = ok
        if cname == "all_27_present_tile":
            ok &= bool((args[1] < args[0].shape[0]).all())
        emit({"phase": "k2_vs_plain", "case": cname, **line})
        check(ok, f"K2 differs from its plain version on {cname}")
        k2_err = max(k2_err, err)

    # 8. the same weights on the CPU --------------------------------------
    t0 = time.perf_counter()
    cpu_model = build_detector(cfg, device="cpu", seed=0)
    pts, valid = scenes["uniform_blobs"]
    cpu_in = (torch.from_numpy(pts), torch.from_numpy(valid))
    cpu_preds, cpu_det = run(*cpu_in, cpu_model)
    cpu_s = time.perf_counter() - t0
    cpu_sites = (list(cpu_model.num_voxels),
                 list(cpu_model.backbone.site_counts))
    check(cpu_sites == sites["uniform_blobs"],
          f"site counts card {sites['uniform_blobs']} vs CPU {cpu_sites}")
    kw = dict(grid_size=v.grid_size, max_voxels=v.max_voxels_eval,
              max_points=v.max_points_per_voxel)
    gm = point_voxel_map(*on_card["uniform_blobs"], v.pc_range,
                         v.voxel_size, **kw)
    cm = point_voxel_map(*cpu_in, v.pc_range, v.voxel_size, **kw)
    check(torch.equal(gm.coords.cpu(), cm.coords)
          and torch.equal(gm.num_points.cpu(), cm.num_points),
          "voxel coords or point counts differ card vs CPU")
    feat_err = float((run_means(gm).cpu() - run_means(cm)).abs().max())
    check(feat_err <= VOXEL_FEAT_ATOL, f"voxel features card vs CPU "
          f"{feat_err}")
    gpu_preds, gpu_det = outputs["uniform_blobs"]
    hm_err = max(float((torch.sigmoid(g["hm"]).cpu()
                        - torch.sigmoid(c["hm"])).abs().max())
                 for g, c in zip(gpu_preds, cpu_preds))
    check(hm_err <= HM_ATOL, f"heatmap card vs CPU {hm_err}")
    n_card, n_cpu = check_detections_match(gpu_det, cpu_det)
    emit({"phase": "cpu_cross_check", "model": VOX_NAME,
          "scene": "uniform_blobs", "cpu_s": round(cpu_s, 3),
          "voxels": cpu_sites[0], "sites_per_stage": cpu_sites[1],
          "voxel_feat_max_abs_err": feat_err,
          "voxel_feat_atol": VOXEL_FEAT_ATOL, "hm_max_abs_err": hm_err,
          "hm_atol": HM_ATOL, "detections_card": n_card,
          "detections_cpu": n_cpu})

    # 9. times --------------------------------------------------------------
    times, peak = {}, {}
    for name, (p, q) in on_card.items():
        torch.cuda.reset_peak_memory_stats()
        times[name] = time_host(lambda p=p, q=q: run(p, q))
        peak[name] = torch.cuda.max_memory_allocated() / 2**20
    per_conv = []
    for i, args in enumerate(recorded):
        bytes_ms, ops_ms, present = k2_bound(*args)
        lib = k2_library_call(*args)
        check(float((lib() - pallas_gather.gather_conv_plain(*args)).abs()
                    .max()) <= K2_RTOL * max(1.0, float(lib().abs().max())),
              f"the stacked yardstick disagrees on conv {i}")
        per_conv.append({
            "conv": i, "V": args[0].shape[0], "N": args[1].shape[1],
            "cin": args[0].shape[1], "cout": args[2].shape[2],
            "present_pairs": present,
            "ms": time_device(lambda a=args: k2(*a)),
            "plain_ms": time_device(
                lambda a=args: pallas_gather.gather_conv_plain(*a)),
            "library_ms": time_device(lib),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"})
    total = {k: sum(c[k] for c in per_conv)
             for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    ops_share = sum(c["bound_ms"] for c in per_conv
                    if c["bound_by"] == "operations") / total["bound_ms"]
    emit({"phase": "times", "model": VOX_NAME, "card": card,
          "main_path_ms_per_scene": times, "main_path_peak_mib": peak,
          "k2_per_launch_ms": {k: per_conv[i]["ms"]
                               for k, i in K2_REPRESENTATIVE.items()},
          "k2_per_scene": total, "k2_per_conv": per_conv,
          "warmup": WARMUP, "reps": REPS})
    return {"k2": {"launches": launches["k2"], "max_abs_err": k2_err,
                   **total,
                   "bound_by": "operations" if ops_share >= 0.5 else "bytes"},
            "k1_launches": launches["k1"]}


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
    from futuredet_torch.ops import _build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()

    # 1. device and build -------------------------------------------------
    t0 = time.perf_counter()
    secs = _build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in _build.build_log(name).splitlines()
                    if "registers" in ln or "Compiling" in ln]
             for name in secs}
    check(set(secs) >= {"nms_kernel.cu", "gather_conv_kernel.cu"},
          f"built {sorted(secs)}")
    emit({"phase": "device_build", "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": round(build_s, 3), "per_source_s": secs,
          "ptxas": ptxas, "tf32": False})

    k1 = pillar_path(dev, card)
    vox = voxelnet_path(dev, card)

    print(card, flush=True)
    k2 = vox["k2"]
    emit({"kernels": [{
        "name": "K1 rotated NMS survivor mask",
        "route": "cuda", "source": "futuredet_torch/csrc/nms_kernel.cu",
        "replaces": "futuredet_tpu/ops/pallas_nms.py:82",
        "launches": k1["launches"] + vox["k1_launches"],
        "launches_by_path": {NAME: k1["launches"],
                             VOX_NAME: vox["k1_launches"]},
        "matched": True, "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"], "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
        "library_ms": None}, {
        "name": "K2 sparse gather-conv",
        "route": "cuda",
        "source": "futuredet_torch/csrc/gather_conv_kernel.cu",
        "replaces": "futuredet_tpu/ops/pallas_gather.py:49",
        "launches": k1["k2_launches"] + k2["launches"],
        "launches_by_path": {NAME: k1["k2_launches"],
                             VOX_NAME: k2["launches"]},
        "matched": True, "max_abs_err": k2["max_abs_err"],
        "ms": k2["ms"], "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
        "library_ms": k2["library_ms"],
        "times_are": "sums over the 20 convs of one scene"}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
