#!/usr/bin/env python3
"""Smoke run of futuredet_torch on one NVIDIA GPU: the quickest proof that
the port builds, agrees with itself and starts on the card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card and the
CUDA toolkit. Phases, one JSON line each (several for some):

  1. device and build: card name and power limit, then the CUDA kernels of
     futuredet_torch/csrc (K1 nms_kernel.cu, K2 gather_conv_kernel.cu) and
     the metric engine's host C++ matcher (host_accumulate.cpp, g++) built
     at once into build/torch_kernels/, with ptxas's lines for each kernel;
     no K1 or K2 function may spill registers.

  The pillar path, pp_forecast_n3dtf:
  2. main path: full width (150k points, 512x512 canvas, RPN (64,128,256) x
     (3,5,5), 7 chained heads, 7 x 1000-box NMS) with seeded random weights,
     on a uniform and a clustered scene, through build_detector ->
     decode_and_nms. Launch counts are zeroed just before and read just
     after: each scene must launch K1 exactly once and K2 never.
  3. K1 against its plain PyTorch version on the card: the 7 x 1000 NMS
     problems of the uniform scene's decode, a 1000-deep suppression chain,
     axis-aligned boxes with collinear edges, a dense cluster where the
     cull skips no pair, a 15 m cluster, and pairs at the cull's edge.
     Survivor masks must be identical, and so must every kill bit of a
     pair j > i (a pair the cull skips has plain IoU exactly 0).
  4. the uniform scene through the same weights on the CPU (plain
     versions): post-sigmoid heatmaps within 1e-3, detections matched
     timestep by timestep (a reference box may be missing only where its
     score lies within twice the measured heatmap difference, and within
     1e-6, of the card's cut: the lowest kept score of a full timestep, or
     the score threshold; such boxes are listed as let_off_at_the_cut, at
     most 2 a scene).
  5. times: 3 warm-up runs, then the median of 20; K1 on the main path's
     7 x 1000 and on the dense cluster, each beside its plain version and
     its bound for the pair tests that data needs (k1_bound: the pairs the
     kernel's cull skips cost the cull test, the rest the full test).

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
     max(1, max|plain|): fp32 summation order, and 3xTF32 on the tensor
     cores for the wide family), each launched again (bit-identical), and
     adversarial tables: Cin = 5, N = 1, 65 and 129, Cout = 8 in both
     families, a table of absent entries only (exactly the bias), tiles
     whose sites have all 27 neighbours. Each line names the conv's family
     (route: narrow or wide) and its bounds.
  8. the uniform scene through the same weights on the CPU: voxel coords
     and counts identical and features within 1e-6, per-stage site counts
     identical, post-sigmoid heatmaps within 1e-3, detections matched as in
     phase 4 (the untrained heads score every box within 7e-4 above the
     0.1 threshold, so neighbouring ranks lie ~2e-7 apart).
  9. times: ms per scene (3 warm-ups, median of 20) and peak memory; K2
     per launch for four representative convs; K2, its plain version, the
     stacked index_select + mm yardstick, the bound at the fp32 rate
     (bound_ms) and, for the wide family, at the 3xTF32 tensor-core rate
     (tc_bound_ms) for all 20 convs, each with its route.

  Training of the sparse VoxelNet, forecast_n3dtf:
  10. main path: full width from build_detector(cfg, seed=0).train() on a
      lidar-family scene of futuredet_torch/data/synthetic.py (~288k points,
      under max_voxels_train voxels, 48 objects with GT boxes for 7
      timesteps, M = 500), through futuredet_torch.train.trainer.train for 5
      steps into a temporary work dir. Counts zeroed before each step and
      read after it: 20 K2 forward launches, 19 K2 input-gradient (dx)
      launches and no K1; every metric finite. Then 10 steps of a fresh
      model on one repeated batch must bring the loss below step 0's, and
      the trainer's checkpoint restored into a fresh model and optimizer
      must give their saved state exactly.
  11. K2's backward against its plain version on the card, on the 20 convs
      of the first train step as the main path gave them (x, W, b, the
      table or the strided conv's inverse table, and dy): each of the 19 dx
      launches against torch.autograd through gather_conv_plain (max |diff|
      <= 1e-5 * max(1, max|plain|)), bit-identical when launched again;
      the Function's dW and db against the plain autograd ones (DW_RTOL of
      max(1, max|plain|)). Each line names the dx conv's route and bounds.
  12. one train step of the same weights and batch on the CPU (plain
      versions, full width), with every BatchNorm bias raised by
      BN_BIAS_SHIFT so that no ReLU input lies near 0 (a ReLU decision that
      rounding flips moves the gradients before it by per cents, whatever
      the arithmetic): loss within 1e-4 relative, global gradient norm
      within 1e-3, running statistics within 1e-4 of max(1, max|CPU|),
      each gradient within GRAD_FRACTION of its max |g| (tensors zero up to
      rounding, the conv biases under a train-mode BatchNorm, only small);
      the CPU's gradients fed to both optimizers give updates within
      PARAM_ATOL.
  13. times: ms per train step (2 warm-ups, median of 10, host clock around
      synced steps), split into targets, forward + loss, backward and
      optimizer; peak memory; per step the K2 forward and dx ms, the dW + db
      ms (PyTorch ops), the plain versions' ms and the bounds.

  Training of the pillar model, pp_forecast_n3dtf:
  14. main path: full width (512x512 canvas, B = 1) from
      build_detector(cfg, seed=0).train() on a lidar-family scene of ~150k
      points with GT boxes for 7 timesteps, through trainer.train for 5
      steps. Counts zeroed before each step and read after it: no K1 and no
      K2 launch (the pillar train path reaches no kernel); every metric
      finite. Then 10 steps on one repeated batch must bring the loss below
      step 0's, and the checkpoint must round-trip exactly, as in phase 10.
  15. one train step card against the CPU, to phase 12's limits, with the
      CPU run in float64 as the reference: this model's float32 gradients
      are conditioned worse than the limit (the CPU's own float32 run lies
      up to 1.7e-2 of a tensor's max from the float64 one, in the reader's
      first linear layer and the neck's first block, whose sums over 65,536
      positions of a zero-mean gradient cancel), so the line also gives the
      CPU's float32 run against the reference, and the card's against it.
  16. times: as phase 13, without the sparse convs.

  The evaluation path, through the CLIs a user runs (futuredet_torch.cli):
  17. pp_forecast_n3dtf at full width: cli.train.main on one synthetic
      scene (seed CLI_SEED, lidar clutter) for CLI_EPOCHS epochs of one
      step, validating each epoch (--val_synthetic 1), then
      cli.evaluate.main on that scene from its checkpoint with
      --forecast_mode velocity_dense --cohort_analysis --extractBox. Counts
      zeroed just before the evaluation and read just after: K1 exactly
      once, K2 never. Every summary key present and finite; the same
      detections scored per class (--eval_only) must give mAP(car) >
      MAP_FLOOR (a scene the model overfit, not a measure of quality). The
      metrics JSON and CSV go to build/chip_smoke/.
  18. forecast_n3dtf at full width: cli.evaluate.main from phase 10's
      trainer checkpoint on EVAL_SCENES synthetic scenes with --speed_test:
      per scene K2 exactly 20 times and K1 once; the speed test's ms per
      sample beside phase 9's ms per scene; the CLI's voxel-budget line
      (the budget must not be reached); the host tail (linking and
      records, then the metric engine) in ms per scene with the C++
      matcher and with numpy, whose summaries agree within GOLDEN_ATOL.
  19. double-flip TTA, both models (phase 17's and phase 10's checkpoints,
      one scene): cli.evaluate.main with --tta map (per scene K1 once, K2
      80 times on VoxelNet) and --tta box (K1 4 times, K2 80 times); the
      same weights and scene through the port on the CPU: every flip's
      heatmaps within 1e-3, detections matched timestep by timestep as in
      phase 4 (map) and flip by flip (box); ms per scene.
  20. the metric engine: evaluate_forecasts on tests/fixtures/
      metrics_golden.{npz,json}, all 5 settings, with the built C++ matcher
      and with numpy, each within GOLDEN_ATOL of the fixture; and the GT
      of two scenes fed back as Detections on the card: mAP and mFAP >
      ORACLE_FLOOR.

TF32 is turned off for convolutions and matmuls, so that the card computes
in fp32 as the CPU does. Any failure raises; the last line is the result.
"""
from __future__ import annotations

import json
import logging
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

NAME = "pp_forecast_n3dtf"
MAX_POINTS = 150000
VOX_NAME = "forecast_n3dtf"
WARMUP, REPS = 3, 20
TRAIN_WARMUP, TRAIN_REPS = 2, 10
# the lidar-family train scene: clutter points (with 48 objects of up to
# 500 points, ~288k points in all, ~60k voxels) and its seed
TRAIN_CLUTTER, TRAIN_SEED = 280000, 21
# the pillar train scene: ~150k points (MAX_POINTS) of the same family
PILLAR_TRAIN_CLUTTER = 140000
TRAIN_STEPS, OVERFIT_STEPS = 5, 10
DW_RTOL = 1e-5            # dW, db vs plain autograd: sums over the sites
# card vs CPU train step (phase 12)
LOSS_RTOL, NORM_RTOL, STAT_RTOL = 1e-4, 1e-3, 1e-4
# of each tensor's max |g|. 1e-3 held 427 of the 433 tensors; the other 6
# (up to 4.5e-3 on an NVIDIA H100 80GB HBM3 at 700 W) lie in task 0's
# forecast conv, whose gradient sums those of the 7 chained heads, and in
# the neck's last block, each just before a train-mode BatchNorm, whose
# input gradient sums to zero per channel: sums of 32,400 terms that
# cancel, for which their own max is no scale of the rounding
GRAD_FRACTION = 1e-2
ZERO_FRACTION = 1e-6      # of the model's max |g|: zero up to rounding
PARAM_ATOL = 1e-6         # AdamW updates of the same gradients
BN_BIAS_SHIFT = 3.0
HM_ATOL = 1e-3            # card vs CPU, fp32 convs in another order
CANVAS_ATOL = 1e-4        # card vs CPU reader output, sums in another order
VOXEL_FEAT_ATOL = 1e-6    # card vs CPU voxel means, the same adds in order
K2_RTOL = 1e-5            # K2 vs plain: of max(1, max|plain|), fp32 order
# card vs CPU detections: a reference box within twice the measured heatmap
# difference, and within NEAR_CAP, of the card's cut may be missing (a near
# tie; measured differences are 3e-8 to 1.3e-7), at most MAX_LET_OFF a scene
NEAR_CAP = 1e-6
MAX_LET_OFF = 2
FP32_PEAK = 67e12         # H100 SXM fp32 vector peak, FLOP/s
# H100 SXM dense TF32 tensor-core peak over the three MMAs of 3xTF32
TF32X3_PEAK = 495e12 / 3
HBM_RATE = 3.35e12        # H100 SXM device memory, bytes/s
# fp32 operations of one K1 pair test (csrc/nms_kernel.cu): 8 clipped edges
# of ~50 operations each, the victim's 4 corners (32), the two sums, eps
# shifts and the IoU ratio (~20); the sin/cos of each box are not counted
K1_OPS_PER_PAIR = 450
# fp32 operations of the cull test that skips a far pair: two centre
# differences, their squares and sum, the reach sum, its square, the compare
K1_OPS_PER_CULL = 8
# the evaluation phases (17-20): phase 17 trains pp_forecast_n3dtf through
# the train CLI on one scene (seed CLI_SEED, B = 1, one step an epoch) for
# CLI_EPOCHS steps, validating each epoch, then evaluates that scene. At
# 250 steps (train loss 0.05) the model in eval mode kept no box above the
# 0.1 threshold at any timestep (mAP 0), its BatchNorm running statistics
# trailing the schedule (scripts/torch_probe_bn_lag.py); at 600, 12-13
# boxes a timestep and mAP(car) 1.0 (an NVIDIA H100 80GB HBM3 at 700 W)
CLI_EPOCHS, CLI_SEED = 600, 0
MAP_FLOOR = 0.05          # phase 17: mAP(car) on the overfit scene
EVAL_SCENES = 3           # phase 18's scenes
TTA_SEED, TTA_REPS = 7, 10
GOLDEN_ATOL = 2e-6        # the C++ matcher's fp32 against numpy's fp64
ORACLE_FLOOR = 0.9        # GT fed back as detections: mAP and mFAP
SUMMARY_KEYS = ("mean_dist_aps", "mean_dist_ars", "mean_dist_faps",
                "mean_dist_fars", "mean_dist_aaps", "mean_dist_aars",
                "mean_dist_faps_mr", "label_tp_errors")
GOLDEN_SETTINGS = {
    "plain": dict(tp_pct=0.6, cohort_analysis=False, topk=1),
    "cohort": dict(tp_pct=0.6, cohort_analysis=True, topk=1),
    "cohort_top5": dict(tp_pct=0.6, cohort_analysis=True, topk=5),
    "static_only": dict(tp_pct=0.6, cohort_analysis=False, topk=1,
                        static_only=True),
    "oracle_top5": dict(tp_pct=0.6, cohort_analysis=False, topk=5,
                        association_oracle=True),
}
ROOT = os.path.dirname(os.path.abspath(__file__))
# the metrics JSON and CSV the evaluate CLI writes in phases 17-19
OUT_DIR = os.path.join(ROOT, "build", "chip_smoke")
# the four K2 launches timed alone: index of the conv in the encoder's
# order (stage 0: conv_input, 4 block convs; stages 1-3: down, 4 block
# convs each)
K2_REPRESENTATIVE = {"s0_conv_input_5to16": 0, "s0_subm_16to16": 1,
                     "down1_16to32": 5, "s3_subm_128to128": 16}


T_START = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line carries the seconds since the start."""
    if "phase" in obj:
        obj = {**obj, "t_s": round(time.perf_counter() - T_START, 1)}
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
                            score_tol=1e-2, cut=None, near=0.0):
    """Greedy same-label centre matching: every confident reference
    detection needs a counterpart within center_tol with score within
    score_tol and geometry within 0.05 (a copy of the matcher of the JAX
    package's checkpoint-parity test). A reference detection whose score
    lies within `near` of `cut` (the card's lowest kept score of its
    timestep, or the score threshold) may be missing: scores that differ
    by `near` can cross the cut. Returns the reference detections let off
    so."""
    want = rscores >= score_floor
    rboxes, rscores, rlabels = rboxes[want], rscores[want], rlabels[want]
    used = np.zeros(len(boxes), bool)
    let_off = []
    for rb, rs, rl in zip(rboxes, rscores, rlabels):
        d = np.linalg.norm(boxes[:, :2] - rb[:2], axis=1)
        d = np.where((labels == rl) & ~used, d, np.inf)
        j = int(np.argmin(d))
        if d[j] > center_tol and cut is not None and rs <= cut + near:
            let_off.append({"score": float(rs), "cut": float(cut),
                            "label": int(rl), "closest_m": float(d[j])})
            continue
        check(d[j] <= center_tol,
              f"reference detection at {rb[:3]} (label {rl}, score "
              f"{rs:.7f}) has no match within {center_tol} m (closest "
              f"{d[j]:.3f}; the card's cut {cut}, near {near})")
        used[j] = True
        check(abs(scores[j] - rs) <= score_tol, (scores[j], rs))
        np.testing.assert_allclose(boxes[j][:6], rb[:6], atol=0.05)
        np.testing.assert_allclose(
            [np.sin(boxes[j][8]), np.cos(boxes[j][8])],
            [np.sin(rb[8]), np.cos(rb[8])], atol=0.05)
    return let_off


def check_detections_match(cfg, gpu_det, cpu_det, score_err):
    """Card against CPU detections, timestep by timestep. The card's
    scores differ from the CPU's by up to `score_err` (the measured
    heatmap difference), so at a timestep that keeps post_max_size boxes a
    reference box within near = min(2 * score_err, NEAR_CAP) of the card's
    lowest kept score may have been displaced by a near tie, and one within
    near of the score threshold may have crossed it; every other reference
    box must be matched, and at most MAX_LET_OFF boxes of the scene may be
    let off. Returns (card detections, CPU detections, those let off)."""
    post = cfg.test.nms.post_max_size
    T = gpu_det.valid.shape[1] // post
    near = min(2 * score_err, NEAR_CAP)
    let_off = []
    for t in range(T):
        sl = slice(t * post, (t + 1) * post)
        gk = gpu_det.valid[0, sl].cpu().numpy()
        ck = cpu_det.valid[0, sl].numpy()
        gs = gpu_det.scores[0, sl].cpu().numpy()[gk]
        cut = float(gs.min()) if gk.sum() == post else \
            cfg.test.score_threshold
        let_off += assert_detections_match(
            gpu_det.boxes[0, sl].cpu().numpy()[gk], gs,
            gpu_det.labels[0, sl].cpu().numpy()[gk],
            cpu_det.boxes[0, sl].numpy()[ck], cpu_det.scores[0, sl].numpy()[ck],
            cpu_det.labels[0, sl].numpy()[ck], cut=cut, near=near)
    check(len(let_off) <= MAX_LET_OFF,
          f"{len(let_off)} reference boxes let off at the cut (at most "
          f"{MAX_LET_OFF}): {let_off}")
    return (int(gpu_det.valid.sum()), int(cpu_det.valid.sum()), let_off)


def time_host(fn, warmup=WARMUP, reps=REPS):
    """Median wall ms of fn() ending in a synchronize."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
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


def k1_pairs(boxes, valid, thr):
    """The pair tests greedy NMS needs on this data, each surviving box i
    against every later valid box j that no survivor before i removed,
    split by the kernel's cull: `culled` pairs cost the cull test, `full`
    ones the whole IoU. `all` counts every pair j > i."""
    from futuredet_torch.ops.pallas_nms import cull_skips, nms_alive_plain
    from futuredet_torch.ops.rotated_iou import pairwise_iou_bev
    G, N, _ = boxes.shape
    kills = pairwise_iou_bev(boxes, boxes).transpose(-1, -2) > thr
    alive = nms_alive_plain(boxes, valid, thr)
    idx = torch.arange(N, device=boxes.device)
    later = idx[None, :] > idx[:, None]
    # first survivor that removes j (N if none)
    first = torch.where(kills & later & alive[:, :, None],
                        idx[None, :, None], N).amin(1)
    needed = (later & alive[:, :, None] & valid[:, None, :]
              & (idx[None, :, None] <= first[:, None, :]))
    n_needed = int(needed.sum())
    culled = int((needed & cull_skips(boxes, thr)).sum())
    return {"needed": n_needed, "culled": culled, "full": n_needed - culled,
            "all": G * N * (N - 1) // 2}


def k1_bound(boxes, valid, thr):
    """The least time of one K1 call on these inputs: the larger of its
    bytes (boxes and valid read once, alive written once) at the memory rate
    and its operations (K1_OPS_PER_PAIR for each needed pair the cull keeps,
    K1_OPS_PER_CULL for each it skips) at the fp32 peak."""
    pairs = k1_pairs(boxes, valid, thr)
    nbytes = boxes.numel() * 4 + 2 * valid.numel()
    bytes_ms = nbytes / HBM_RATE * 1e3
    ops = pairs["full"] * K1_OPS_PER_PAIR + pairs["culled"] * K1_OPS_PER_CULL
    ops_ms = ops / FP32_PEAK * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "bytes": nbytes, "pairs_needed": pairs["needed"],
            "pairs_full": pairs["full"], "pairs_culled": pairs["culled"],
            "pairs_all": pairs["all"]}


def k1_dense_cluster(G, n, rng):
    """(G, n, 5) boxes of 1.5-5 m with centres in a 1.4 m square: every
    pair overlaps its circles, so the cull skips none."""
    return np.concatenate([
        rng.uniform(-0.7, 0.7, (G, n, 2)), rng.uniform(1.5, 5.0, (G, n, 2)),
        rng.uniform(-np.pi, np.pi, (G, n, 1))], -1).astype(np.float32)


def k1_margin_pairs(n, rng, ulps=(-2, -1, 0, 1, 2)):
    """(n, 5): n // 2 killer-victim pairs whose corners point at each other
    along the line of centres, the victim at the cull's edge (the sum of
    the two reaches) moved by a few fp32 ulps of that distance either way;
    pairs lie 30 m apart over the main path's range."""
    from futuredet_torch.ops.pallas_nms import cull_reach
    m = n // 2
    size = rng.uniform(0.5, 6.0, (m, 2, 2))
    head = rng.uniform(-np.pi, np.pi, m)
    b = np.zeros((n, 5), np.float32)
    b[:] = [60.0, 60.0, 1.0, 1.0, 0.0]     # an odd box out, far away
    k, v = slice(0, 2 * m, 2), slice(1, 2 * m, 2)
    side = int(np.ceil(np.sqrt(m)))
    b[k, 0] = (np.arange(m) % side) * 30.0 - 58.0
    b[k, 1] = (np.arange(m) // side) * 30.0 - 58.0
    b[k, 2:4] = size[:, 0]
    b[v, 2:4] = size[:, 1]
    b[k, 4] = head - np.arctan2(size[:, 0, 1], size[:, 0, 0])
    b[v, 4] = head + np.pi - np.arctan2(size[:, 1, 1], size[:, 1, 0])
    scale = 1 + np.resize(np.asarray(ulps), m) * np.float32(2.0 ** -23)
    for _ in range(3):      # the reach grows with |x| + |y|: settle
        reach = cull_reach(torch.from_numpy(b)).numpy()
        d = (reach[k] + reach[v]) * scale
        b[v, 0] = b[k, 0] + d * np.cos(head)
        b[v, 1] = b[k, 1] + d * np.sin(head)
    return b


def k2_bound(features, table, weights, bias):
    """The least time of one gather-conv on these inputs: the larger of
    its bytes (every input read once and the output written once) at the
    memory rate and its 2 * present (k, n) pairs * Cin * Cout operations,
    at the fp32 peak (bound_ms) and, for the wide family, which
    does them as 3xTF32 on the tensor cores, at a third of the dense TF32
    peak (tc_bound_ms; None for the narrow family)."""
    from futuredet_torch.ops.pallas_gather import k2_route
    V, cin = features.shape
    N, cout = table.shape[1], weights.shape[2]
    present = int(((table >= 0) & (table < V)).sum())
    nbytes = 4 * (features.numel() + table.numel() + weights.numel()
                  + (0 if bias is None else cout) + N * cout)
    bytes_ms = nbytes / HBM_RATE * 1e3
    ops = 2 * present * cin * cout
    ops_ms = ops / FP32_PEAK * 1e3
    route = k2_route(cin, cout)
    return {"route": route, "present_pairs": present,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "tc_bound_ms": (max(bytes_ms, ops / TF32X3_PEAK * 1e3)
                            if route == "wide" else None)}


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
    rng = np.random.default_rng(4)
    ones = torch.ones(T, n, dtype=torch.bool, device=dev)
    dense = torch.from_numpy(k1_dense_cluster(T, n, rng)).to(dev)
    cluster = torch.from_numpy(k1_dense_cluster(T, n, rng)).to(dev)
    cluster[..., :2] *= 7.5 / 0.7                  # centres in a 15 m square
    margin = torch.from_numpy(np.stack([k1_margin_pairs(n, rng)
                                        for _ in range(2)])).to(dev)
    cases = {"main_path_7x1000": (b_main, v_main, thr),
             "dense_cluster_7x1000": (dense, ones, thr),
             "cluster_15m_7x1000": (cluster, ones, thr),
             "cull_margin_2x1000": (margin, ones[:2], thr),
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
        culled = pallas_nms.cull_skips(b, th) & later
        line = {"phase": "k1_vs_plain", "case": cname,
                "shape": list(b.shape), "survivors": int(got.sum()),
                "identical": same, "pair_bits_differing": pair_diff,
                "pairs_culled": int(culled.sum()),
                "pairs_all": int(later.sum()) * b.shape[0],
                "culled_with_iou_not_0": int((culled & (iou != 0)).sum())}
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
        check(same and pair_diff == 0 and not line["culled_with_iou_not_0"],
              f"K1 differs from its plain version on {cname}")
        k1_err = max(k1_err, float((got != want).sum()))
    chain_alive = pallas_nms.rotate_nms_alive(*cases["chain_1000"][:2], 0.1)
    check(int(chain_alive.sum()) == n // 2, "chain survivors")
    check(not bool(pallas_nms.cull_skips(dense, thr).any()),
          "the dense cluster has a culled pair")

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
    n_card, n_cpu, let_off = check_detections_match(cfg, gpu_det, cpu_det,
                                                    hm_err)
    emit({"phase": "cpu_cross_check", "model": NAME, "scene": "uniform",
          "layer_nums": list(cfg.model.rpn.layer_nums),
          "cpu_s": round(cpu_s, 3), "canvas_max_abs_err": canvas_err,
          "canvas_atol": CANVAS_ATOL, "hm_max_abs_err": hm_err,
          "hm_atol": HM_ATOL, "detections_card": n_card,
          "detections_cpu": n_cpu, "let_off_at_the_cut": let_off})

    # 5. times --------------------------------------------------------------
    times = {}
    for name, (p, v) in on_card.items():
        torch.cuda.reset_peak_memory_stats()
        times[name] = time_host(lambda p=p, v=v: run(p, v))
        times[name + "_peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
    k1 = {}
    for cname in ("main_path_7x1000", "dense_cluster_7x1000"):
        b, v, th = cases[cname]
        k1[cname] = {
            "ms": time_device(lambda b=b, v=v, th=th:
                              pallas_nms.rotate_nms_alive(b, v, th)),
            "plain_ms": time_device(lambda b=b, v=v, th=th:
                                    pallas_nms.nms_alive_plain(b, v, th)),
            **k1_bound(b, v, th)}
    main = k1["main_path_7x1000"]
    emit({"phase": "times", "model": NAME, "card": card,
          "main_path_ms_per_scene": {k: times[k] for k in on_card},
          "main_path_peak_mib": {k: times[k + "_peak_mib"] for k in on_card},
          "k1_ms": main["ms"], "plain_ms": main["plain_ms"],
          "k1_bound_ms": main["bound_ms"],
          "k1_pairs_needed": main["pairs_needed"],
          "k1_pairs_full": main["pairs_full"],
          "k1_pairs_culled": main["pairs_culled"],
          "k1_pairs_all": main["pairs_all"], "k1_bytes": main["bytes"],
          "k1_by_case": k1, "warmup": WARMUP, "reps": REPS})
    return {"launches": launches, "k2_launches": k2_launches,
            "max_abs_err": k1_err, "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"],
            "dense_ms": k1["dense_cluster_7x1000"]["ms"]}


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
            **k2_bound(features, table, weights, bias),
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
    convs, ok_all, same_all, k2_err = [], True, True, 0.0
    for i, args in enumerate(recorded):
        line, ok, err = k2_compare(*args)
        line["conv"] = i
        line["bit_identical"] = bool(torch.equal(k2(*args), k2(*args)))
        convs.append(line)
        ok_all &= ok
        same_all &= line["bit_identical"]
        k2_err = max(k2_err, err)
    emit({"phase": "k2_vs_plain", "case": "main_path_20_convs",
          "rtol_of_max_plain": K2_RTOL, "convs": convs})
    check(ok_all, "K2 differs from its plain version on the main path")
    check(same_all, "K2 is not bit-identical from launch to launch")
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
                   "n129_wide": case(3000, 129, 32, 32, 0.3),
                   "n129_narrow": case(3000, 129, 16, 16, 0.3),
                   "cout8_wide": case(700, 700, 32, 8, 0.6),
                   "cout8_narrow": case(700, 700, 16, 8, 0.6),
                   "all_absent": case(2000, 300, 16, 32, 1.0),
                   "all_absent_wide": case(2000, 300, 64, 128, 1.0),
                   "all_27_present_tile": case(5000, 128, 128, 128, 0.0),
                   "all_27_present_narrow": case(5000, 256, 16, 32, 0.0)}
    for cname, args in adversarial.items():
        line, ok, err = k2_compare(*args)
        line["bit_identical"] = bool(torch.equal(k2(*args), k2(*args)))
        ok &= line["bit_identical"]
        if cname.startswith("all_absent"):
            got = k2(*args)
            line["exactly_bias"] = bool(torch.equal(
                got, args[3].expand_as(got)))
            ok &= line["exactly_bias"]
        if cname.startswith("all_27_present"):
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
    n_card, n_cpu, let_off = check_detections_match(cfg, gpu_det, cpu_det,
                                                    hm_err)
    emit({"phase": "cpu_cross_check", "model": VOX_NAME,
          "scene": "uniform_blobs", "cpu_s": round(cpu_s, 3),
          "voxels": cpu_sites[0], "sites_per_stage": cpu_sites[1],
          "voxel_feat_max_abs_err": feat_err,
          "voxel_feat_atol": VOXEL_FEAT_ATOL, "hm_max_abs_err": hm_err,
          "hm_atol": HM_ATOL, "detections_card": n_card,
          "detections_cpu": n_cpu, "let_off_at_the_cut": let_off})

    # 9. times --------------------------------------------------------------
    times, peak = {}, {}
    for name, (p, q) in on_card.items():
        torch.cuda.reset_peak_memory_stats()
        times[name] = time_host(lambda p=p, q=q: run(p, q))
        peak[name] = torch.cuda.max_memory_allocated() / 2**20
    per_conv = []
    for i, args in enumerate(recorded):
        lib = k2_library_call(*args)
        check(float((lib() - pallas_gather.gather_conv_plain(*args)).abs()
                    .max()) <= K2_RTOL * max(1.0, float(lib().abs().max())),
              f"the stacked yardstick disagrees on conv {i}")
        per_conv.append({
            "conv": i, "V": args[0].shape[0], "N": args[1].shape[1],
            "cin": args[0].shape[1], "cout": args[2].shape[2],
            **k2_bound(*args),
            "ms": time_device(lambda a=args: k2(*a)),
            "plain_ms": time_device(
                lambda a=args: pallas_gather.gather_conv_plain(*a)),
            "library_ms": time_device(lib)})
    total = {k: sum(c[k] for c in per_conv)
             for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    # the bound of the arithmetic K2 does: 3xTF32 for the wide convs
    total["tc_bound_ms"] = sum(c["tc_bound_ms"] or c["bound_ms"]
                               for c in per_conv)
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
            "k1_launches": launches["k1"], "scene_ms": times}


def state_equal(a, b) -> bool:
    """Nested state dicts (tensors, numbers, lists, dicts) equal exactly."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(state_equal(a[k], b[k])
                                            for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(state_equal(x, y)
                                        for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.shape == b.shape
                and torch.equal(a.cpu(), b.cpu()))
    return a == b


def grad_ratios(got, want):
    """Per tensor max |got - want| / max |want|; None for a tensor whose
    max |want| is below ZERO_FRACTION of the model's largest (zero up to
    rounding: a conv bias under a train-mode BatchNorm), checked small on
    both sides."""
    top = max(float(w.abs().max()) for w in want.values())
    out = {}
    for name, w in want.items():
        g = got[name]
        check(g.shape == w.shape, f"gradient shape of {name}")
        scale = float(w.abs().max())
        if scale <= ZERO_FRACTION * top:
            check(float(g.abs().max()) <= 2 * ZERO_FRACTION * top,
                  f"{name}: gradient zero up to rounding on the CPU, "
                  f"{float(g.abs().max())} on the card")
            out[name] = None
        else:
            out[name] = float((g - w).abs().max()) / scale
    return out


def shift_bn_biases(model) -> None:
    """Raise every BatchNorm bias by BN_BIAS_SHIFT: no ReLU input then lies
    near 0, where fp32 rounding can flip a ReLU decision between two
    devices."""
    from futuredet_torch.models.readers import MaskedBatchNorm
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (MaskedBatchNorm, torch.nn.BatchNorm2d)):
                m.bias.add_(BN_BIAS_SHIFT)


def dx_operands(entry):
    """The K2 call of a recorded conv's input gradient: (dy, the table it
    gathers over, the weights it takes), as subm_conv_dx makes them."""
    w, inv = entry["w"], entry["inv"]
    if inv is None:
        return (entry["dy"], entry["table"],
                torch.flip(w, (0,)).transpose(1, 2).contiguous())
    return entry["dy"], inv, w.transpose(1, 2).contiguous()


def dw_bound(features, table, dy):
    """The least time of dW = gather(x)^T @ dy and db = sum(dy): x, the
    table and dy read once, dW and db written once; 2 * present pairs *
    Cin * Cout operations at the fp32 peak."""
    V, cin = features.shape
    cout = dy.shape[1]
    present = int(((table >= 0) & (table < V)).sum())
    nbytes = 4 * (features.numel() + table.numel() + dy.numel()
                  + 27 * cin * cout + cout)
    bytes_ms = nbytes / HBM_RATE * 1e3
    ops_ms = 2 * present * cin * cout / FP32_PEAK * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def train_batch(cfg, seed, device, n_clutter):
    """A train scene of phases 10-16: one lidar-family sample of
    futuredet_torch/data/synthetic.py per device batch (48 objects with GT
    boxes for 7 timesteps, M = 500, over `n_clutter` clutter points)."""
    from futuredet_torch.data.synthetic import SCENE_FAMILIES, make_batch
    n_obj, ppo, mode = SCENE_FAMILIES["lidar"]
    return make_batch(cfg, cfg.train.batch_size_per_device, seed=seed,
                      device=device, n_objects=n_obj, points_per_object=ppo,
                      n_clutter=n_clutter, max_objs=500, clutter_mode=mode)


def run_trainer(cfg, dev, clutter, hooks, work_dir=None):
    """futuredet_torch.train.trainer.train for TRAIN_STEPS steps (one epoch)
    into `work_dir` (default: a temporary dir, removed after), then its
    checkpoint restored into a fresh model and optimizer. Returns (state,
    the checkpoint's round trip, the trainer's log lines, its seconds)."""
    import contextlib
    import dataclasses
    import itertools
    import tempfile

    from futuredet_torch.models.detector import build_detector
    from futuredet_torch.train import trainer
    from futuredet_torch.train.checkpoints import CheckpointManager
    from futuredet_torch.train.step import make_optimizer

    cfg_run = cfg.replace(train=dataclasses.replace(
        cfg.train, total_epochs=1, log_interval=TRAIN_STEPS))
    logs = []
    with (contextlib.nullcontext(work_dir) if work_dir
          else tempfile.TemporaryDirectory()) as work:
        stream = (train_batch(cfg, TRAIN_SEED + i, "cpu", clutter)
                  for i in itertools.count())
        t0 = time.perf_counter()
        state = trainer.train(cfg_run, stream, steps_per_epoch=TRAIN_STEPS,
                              work_dir=work, hooks=hooks, device=dev,
                              log_fn=logs.append)
        train_s = time.perf_counter() - t0
        mgr = CheckpointManager(work)
        fresh = build_detector(cfg, device=dev, seed=1).train()
        fresh_opt = make_optimizer(cfg, fresh, TRAIN_STEPS)
        restored = mgr.restore(fresh, fresh_opt)
        ckpt = {"steps": mgr.all_steps(), "restored_step": restored,
                "model_identical": state_equal(fresh.state_dict(),
                                               state.model.state_dict()),
                "optimizer_identical": state_equal(
                    fresh_opt.state_dict(), state.optimizer.state_dict())}
    check(ckpt["steps"] == [TRAIN_STEPS]
          and ckpt["restored_step"] == TRAIN_STEPS
          and ckpt["model_identical"] and ckpt["optimizer_identical"],
          f"{cfg.name}: checkpoint round trip {ckpt}")
    return state, ckpt, logs, train_s


def overfit(cfg, dev, clutter):
    """OVERFIT_STEPS train steps of a fresh model on one repeated batch;
    the loss after them must lie below step 0's. Returns (model, optimizer,
    batch, the step losses, the loss after)."""
    from futuredet_torch.data.targets import build_targets_batch
    from futuredet_torch.models.detector import build_detector
    from futuredet_torch.models.losses import center_head_loss
    from futuredet_torch.train.step import make_optimizer, train_step

    batch = train_batch(cfg, TRAIN_SEED, dev, clutter)
    model = build_detector(cfg, device=dev, seed=0).train()
    opt = make_optimizer(cfg, model, OVERFIT_STEPS)
    losses = [float(train_step(model, opt, batch, i)["loss"])
              for i in range(OVERFIT_STEPS)]
    with torch.no_grad():
        after = float(center_head_loss(
            cfg.model.head, model(batch["points"], batch["points_valid"]),
            build_targets_batch(cfg, batch["targets_raw"]))["loss"])
    check(math.isfinite(after) and after < losses[0],
          f"{cfg.name}: loss {losses[0]} -> {after} after {OVERFIT_STEPS} "
          "steps on one batch")
    return model, opt, batch, losses, after


def train_cross_check(cfg, dev, clutter, reference=torch.float32):
    """One train step of the same weights and batch on the card and on the
    CPU (plain versions, full width), every BatchNorm bias raised by
    BN_BIAS_SHIFT: emits the phase's line and checks the card against the
    CPU run in `reference` precision. In float64 the line also gives the
    CPU's own float32 run against it, and the card's against that run."""
    from futuredet_torch.models.detector import build_detector
    from futuredet_torch.train.step import (apply_update, forward_backward,
                                            make_optimizer)
    runs = {"card": (dev, torch.float32), "cpu": ("cpu", torch.float32)}
    if reference == torch.float64:
        runs["cpu64"] = ("cpu", torch.float64)
    nets = {}
    for where, (d, dtype) in runs.items():
        m = build_detector(cfg, device=d, seed=0).train()
        shift_bn_biases(m)
        b_ = train_batch(cfg, TRAIN_SEED, d, clutter)
        if dtype == torch.float64:
            m = m.double()
            b_ = dict(b_, points=b_["points"].double())
        t0 = time.perf_counter()
        out = forward_backward(m, b_)
        if where == "card":
            torch.cuda.synchronize()
        nets[where] = (m, float(out["loss"].detach()),
                       time.perf_counter() - t0)
    ref = "cpu64" if "cpu64" in nets else "cpu"
    (mr, lr, _), (mg, lg, card_s) = nets[ref], nets["card"]
    want = {n: p.grad.double() for n, p in mr.named_parameters()}
    grads = {w: {n: p.grad.double().cpu() for n, p in nets[w][0]
                 .named_parameters()} for w in ("card", "cpu")}
    ratios = grad_ratios(grads["card"], want)
    real = {n: r for n, r in ratios.items() if r is not None}
    worst = max(real, key=real.get)

    def norm(g):
        return float(torch.sqrt(sum(torch.sum(t ** 2) for t in g.values())))

    norm_r, norm_g = norm(want), norm(grads["card"])
    loss_err = abs(lg - lr) / abs(lr)
    stats_r = {n: t.double() for n, t in mr.named_buffers()
               if n.endswith(("running_mean", "running_var"))}
    stats_g = {n: t.double().cpu() for n, t in mg.named_buffers()
               if n in stats_r}
    stat_err = max(float((stats_g[n] - t).abs().max())
                   / max(1.0, float(t.abs().max()))
                   for n, t in stats_r.items())
    line = {"phase": "train_cpu_cross_check", "model": cfg.name,
            "reference": f"cpu_{str(reference).split('.')[-1]}",
            "cpu_s": round(nets[ref][2], 3), "card_s": round(card_s, 3),
            "bn_bias_shift": BN_BIAS_SHIFT, "loss_card": lg,
            "loss_reference": lr, "loss_rel_err": loss_err,
            "loss_rtol": LOSS_RTOL, "grad_norm_card": norm_g,
            "grad_norm_reference": norm_r,
            "grad_norm_rel_err": abs(norm_g - norm_r) / norm_r,
            "grad_norm_rtol": NORM_RTOL, "stat_rel_err": stat_err,
            "stat_rtol": STAT_RTOL, "worst_grad_ratio": real[worst],
            "worst_grad_tensor": worst, "grad_fraction": GRAD_FRACTION,
            "worst_grad_ratios": dict(sorted(real.items(),
                                             key=lambda kv: -kv[1])[:8]),
            "tensors_above_1e-3": sum(r > 1e-3 for r in real.values()),
            "tensors_zero_up_to_rounding": sum(r is None
                                               for r in ratios.values()),
            "tensors": len(ratios)}
    if ref == "cpu64":
        # the float32 runs' own distance from the float64 one, and from
        # each other: how well float32 conditions these gradients
        for name, got, base in (("cpu32_vs_reference", grads["cpu"], want),
                                ("card_vs_cpu32", grads["card"],
                                 grads["cpu"])):
            r = {n: v for n, v in grad_ratios(got, base).items()
                 if v is not None}
            w = max(r, key=r.get)
            line[name] = {"worst_grad_ratio": r[w], "worst_grad_tensor": w,
                          "tensors_above_1e-2": sum(v > 1e-2
                                                    for v in r.values())}
    # AdamW on the same (reference) gradients, card and CPU in float32
    mc = nets["cpu"][0]
    for m in (mg, mc):
        for n, p in m.named_parameters():
            p.grad = want[n].to(p.device, torch.float32)
        apply_update(m, make_optimizer(cfg, m, 1), 0)
    param_err = max(float((pg.detach().cpu() - pc.detach()).abs().max())
                    for (_, pg), (_, pc) in zip(mg.named_parameters(),
                                                mc.named_parameters()))
    line.update(param_update_max_abs_err=param_err, param_atol=PARAM_ATOL)
    emit(line)
    check(loss_err <= LOSS_RTOL, f"{cfg.name}: train loss card vs CPU "
          f"{loss_err}")
    check(abs(norm_g - norm_r) <= NORM_RTOL * norm_r,
          f"{cfg.name}: gradient norm card {norm_g} vs CPU {norm_r}")
    check(stat_err <= STAT_RTOL, f"{cfg.name}: running statistics card vs "
          f"CPU {stat_err}")
    check(real[worst] <= GRAD_FRACTION,
          f"{cfg.name}: gradient of {worst} card vs CPU: {real[worst]} of "
          "its max")
    check(param_err <= PARAM_ATOL, f"{cfg.name}: AdamW updates card vs CPU "
          f"{param_err}")


def step_times(cfg, model, opt, batch, count):
    """ms per train step (TRAIN_WARMUP warm-ups, median of TRAIN_REPS, host
    clock around synced steps), its split into targets, forward + loss,
    backward and optimizer, and the peak MiB; updates continue from
    `count`."""
    from futuredet_torch.data.targets import build_targets_batch
    from futuredet_torch.models.losses import center_head_loss
    from futuredet_torch.train.step import apply_update, train_step
    n = [count]

    def one_step():
        train_step(model, opt, batch, n[0])
        n[0] += 1

    torch.cuda.reset_peak_memory_stats()
    step_ms = time_host(one_step, TRAIN_WARMUP, TRAIN_REPS)
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    parts = {k: [] for k in ("targets", "forward_loss", "backward",
                             "optimizer")}
    for r in range(TRAIN_WARMUP + TRAIN_REPS):
        opt.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        t = [time.perf_counter()]
        targets = build_targets_batch(cfg, batch["targets_raw"])
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        out = center_head_loss(cfg.model.head,
                               model(batch["points"], batch["points_valid"]),
                               targets)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        out["loss"].backward()
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        apply_update(model, opt, n[0])
        n[0] += 1
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        if r >= TRAIN_WARMUP:
            for k, a, z in zip(parts, t, t[1:]):
                parts[k].append((z - a) * 1e3)
    return step_ms, {k: statistics.median(x) for k, x in parts.items()}, \
        peak_mib


def train_path(dev, card, work_dir=None):
    """Phases 10-13, the trainer's checkpoint into `work_dir` (default: a
    temporary dir). Returns K2's numbers of this path."""
    from futuredet_torch.config import get_config
    from futuredet_torch.models import middle as middle_mod
    from futuredet_torch.ops import pallas_gather, pallas_nms
    from futuredet_torch.ops import sparse_conv as sc_mod
    from futuredet_torch.train import trainer

    cfg = get_config(VOX_NAME)
    v = cfg.voxel

    # 10. main path: the trainer, counts per step, conv inputs recorded --
    k2 = pallas_gather.gather_conv
    k1 = pallas_nms.rotate_nms_alive
    dx_fn, apply_fn = sc_mod.subm_conv_dx, middle_mod.subm_conv_apply
    dx_launches = [0]
    recorded, record = [], [True]

    def counting_dx(*args):
        before = k2.launches
        out = dx_fn(*args)
        dx_launches[0] += k2.launches - before
        return out

    def recording_apply(x, table, w, b=None, inv=None):
        out = apply_fn(x, table, w, b, inv)
        if record[0]:
            e = {"x": x.detach().clone(), "needs_dx": x.requires_grad,
                 "table": table, "w": w.detach().clone(),
                 "b": None if b is None else b.detach().clone(), "inv": inv}
            recorded.append(e)
            out.register_hook(lambda g, e=e: e.__setitem__(
                "dy", g.detach().clone()))
        return out

    per_step = []

    class Count(trainer.Hook):
        def before_step(self, step, state, batch):
            k2.launches = k1.launches = dx_launches[0] = 0

        def after_step(self, step, state, metrics):
            torch.cuda.synchronize()
            record[0] = False
            m = {k: t.detach().cpu() for k, t in metrics.items()}
            per_step.append({
                "step": step, "k2_forward": k2.launches - dx_launches[0],
                "k2_dx": dx_launches[0], "k1": k1.launches,
                "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                "finite": all(bool(torch.isfinite(t).all())
                              for t in m.values()),
                "voxels": list(state.model.num_voxels),
                "sites_per_stage": list(state.model.backbone.site_counts)})

    sc_mod.subm_conv_dx = counting_dx
    middle_mod.subm_conv_apply = recording_apply
    try:
        state, ckpt, logs, train_s = run_trainer(cfg, dev, TRAIN_CLUTTER,
                                                 [Count()], work_dir)
    finally:
        sc_mod.subm_conv_dx = dx_fn
        middle_mod.subm_conv_apply = apply_fn
    del state
    for rec in per_step:
        emit({"phase": "train_main_path", "model": VOX_NAME, **rec,
              "voxel_budget": v.max_voxels_train})
        check(rec["k2_forward"] == 20 and rec["k2_dx"] == 19
              and rec["k1"] == 0,
              f"train step {rec['step']}: K2 {rec['k2_forward']} forward + "
              f"{rec['k2_dx']} dx launches, K1 {rec['k1']}")
        check(rec["finite"], f"train step {rec['step']}: metric not finite")
        check(max(rec["voxels"]) < v.max_voxels_train,
              f"train step {rec['step']}: {rec['voxels']} voxels reach the "
              f"budget {v.max_voxels_train}")
    check(len(per_step) == TRAIN_STEPS, f"{len(per_step)} train steps")
    check(len(recorded) == 20 and all("dy" in e for e in recorded),
          f"{len(recorded)} convs recorded")
    check(sum(e["needs_dx"] for e in recorded) == 19,
          "19 convs need their input gradient")
    model, opt, batch, losses, after = overfit(cfg, dev, TRAIN_CLUTTER)
    emit({"phase": "train_main_path", "model": VOX_NAME,
          "trainer_s": round(train_s, 3), "trainer_log": logs,
          "checkpoint": ckpt, "repeated_batch_losses": losses,
          "loss_after_repeated_batch": after})

    # 11. K2's backward against its plain version on the card -------------
    plain = pallas_gather.gather_conv_plain
    lines, dx_err, ok = [], 0.0, True
    for i, e in enumerate(recorded):
        x, tab, w, b, inv, dy = (e["x"], e["table"], e["w"], e["b"],
                                 e["inv"], e["dy"])
        grads = {}
        for name, fn in (("function", lambda *a: sc_mod.subm_conv_apply(
                *a, inv)), ("plain", plain)):
            xg = x.clone().requires_grad_(e["needs_dx"])
            wg = w.clone().requires_grad_()
            bg = None if b is None else b.clone().requires_grad_()
            leaves = [wg] + ([bg] if bg is not None else []) \
                + ([xg] if e["needs_dx"] else [])
            grads[name] = torch.autograd.grad(fn(xg, tab, wg, bg), leaves,
                                              dy)
        torch.cuda.synchronize()
        line = {"conv": i, "strided": inv is not None, "V": x.shape[0],
                "N": tab.shape[1], "cin": x.shape[1], "cout": w.shape[2]}
        for k, name in enumerate(["dW"] + (["db"] if b is not None else [])):
            got, want = grads["function"][k], grads["plain"][k]
            err = float((got - want).abs().max())
            tol = DW_RTOL * max(1.0, float(want.abs().max()))
            line[f"{name}_max_abs_err"], line[f"{name}_tol"] = err, tol
            ok &= err <= tol
        if e["needs_dx"]:
            ops = dx_operands(e)
            got = sc_mod.subm_conv_dx(dy, tab, w, inv)
            again = sc_mod.subm_conv_dx(dy, tab, w, inv)
            want = grads["plain"][-1]
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            tol = K2_RTOL * max(1.0, float(want.abs().max()))
            same = bool(torch.equal(got, again))
            check(torch.equal(grads["function"][-1], got),
                  f"conv {i}: the Function's dx is not subm_conv_dx's")
            line.update({"dx_max_abs_err": err, "dx_tol": tol,
                         "dx_bit_identical": same,
                         "dx": {"V": ops[0].shape[0], "N": ops[1].shape[1],
                                "cin": ops[2].shape[1],
                                "cout": ops[2].shape[2],
                                **k2_bound(*ops, None)}})
            ok &= err <= tol and same
            dx_err = max(dx_err, err)
        lines.append(line)
    emit({"phase": "k2_backward_vs_plain", "rtol_of_max_plain": K2_RTOL,
          "dw_rtol_of_max_plain": DW_RTOL, "convs": lines})
    check(ok, "K2's backward or the Function's dW / db differ from plain "
          "autograd")

    # 12. the same step on the CPU ---------------------------------------
    train_cross_check(cfg, dev, TRAIN_CLUTTER)

    # 13. times -------------------------------------------------------------
    step_ms, split_ms, peak_mib = step_times(cfg, model, opt, batch,
                                             OVERFIT_STEPS)
    fwd = [(e["x"], e["table"], e["w"], e["b"]) for e in recorded]
    dxs = [dx_operands(e) + (None,) for e in recorded if e["needs_dx"]]

    def dw(e):
        return lambda: (sc_mod.subm_conv_dw(e["x"], e["table"], e["dy"]),
                        e["dy"].sum(0))

    sums = {
        "k2_forward_ms": sum(time_device(lambda a=a: k2(*a)) for a in fwd),
        "plain_forward_ms": sum(time_device(lambda a=a: plain(*a))
                                for a in fwd),
        "k2_dx_ms": sum(time_device(lambda a=a: k2(*a)) for a in dxs),
        "plain_dx_ms": sum(time_device(lambda a=a: plain(*a)) for a in dxs),
        "library_dx_ms": sum(time_device(k2_library_call(*a)) for a in dxs),
        "dw_db_ms": sum(time_device(dw(e)) for e in recorded),
        "k2_forward_bound_ms": sum(k2_bound(*a)["bound_ms"] for a in fwd),
        "k2_forward_tc_bound_ms": sum(k2_bound(*a)["tc_bound_ms"]
                                      or k2_bound(*a)["bound_ms"]
                                      for a in fwd),
        "k2_dx_bound_ms": sum(k2_bound(*a)["bound_ms"] for a in dxs),
        "k2_dx_tc_bound_ms": sum(k2_bound(*a)["tc_bound_ms"]
                                 or k2_bound(*a)["bound_ms"] for a in dxs),
        "dw_db_bound_ms": sum(dw_bound(e["x"], e["table"], e["dy"])
                              ["bound_ms"] for e in recorded)}
    emit({"phase": "train_times", "model": VOX_NAME, "card": card,
          "train_step_ms": step_ms, "train_step_split_ms": split_ms,
          "train_step_peak_mib": peak_mib, "per_step": sums,
          "warmup": TRAIN_WARMUP, "reps": TRAIN_REPS,
          "kernel_warmup": WARMUP, "kernel_reps": REPS})
    return {"launches": sum(r["k2_forward"] + r["k2_dx"] for r in per_step),
            "k1_launches": sum(r["k1"] for r in per_step),
            "forward_per_step": 20, "dx_per_step": 19,
            "dx_max_abs_err": dx_err, "train_step_ms": step_ms, **sums}


def pillar_train_path(dev, card):
    """Phases 14-16. Returns the launches of K1 and K2 on this path (none
    may happen)."""
    import dataclasses

    from futuredet_torch.config import get_config
    from futuredet_torch.ops import pallas_gather, pallas_nms
    from futuredet_torch.train import trainer

    cfg = get_config(NAME)
    cfg = cfg.replace(voxel=dataclasses.replace(cfg.voxel,
                                                max_points=MAX_POINTS))
    k2 = pallas_gather.gather_conv
    k1 = pallas_nms.rotate_nms_alive

    # 14. main path: the trainer, counts per step -------------------------
    per_step = []

    class Count(trainer.Hook):
        def before_step(self, step, state, batch):
            k2.launches = k1.launches = 0

        def after_step(self, step, state, metrics):
            torch.cuda.synchronize()
            m = {k: t.detach().cpu() for k, t in metrics.items()}
            per_step.append({
                "step": step, "k1": k1.launches, "k2": k2.launches,
                "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                "finite": all(bool(torch.isfinite(t).all())
                              for t in m.values())})

    state, ckpt, logs, train_s = run_trainer(cfg, dev, PILLAR_TRAIN_CLUTTER,
                                             [Count()])
    del state
    for rec in per_step:
        emit({"phase": "train_main_path", "model": NAME, **rec})
        check(rec["k1"] == 0 and rec["k2"] == 0,
              f"pillar train step {rec['step']}: K1 {rec['k1']}, K2 "
              f"{rec['k2']} launches")
        check(rec["finite"], f"pillar train step {rec['step']}: metric not "
              "finite")
    check(len(per_step) == TRAIN_STEPS, f"{len(per_step)} pillar train steps")
    model, opt, batch, losses, after = overfit(cfg, dev,
                                               PILLAR_TRAIN_CLUTTER)
    valid = batch["points_valid"]
    emit({"phase": "train_main_path", "model": NAME,
          "points": int(valid.sum()), "trainer_s": round(train_s, 3),
          "trainer_log": logs, "checkpoint": ckpt,
          "repeated_batch_losses": losses,
          "loss_after_repeated_batch": after})

    # 15. the same step on the CPU, in float64 ---------------------------
    train_cross_check(cfg, dev, PILLAR_TRAIN_CLUTTER, torch.float64)

    # 16. times -------------------------------------------------------------
    step_ms, split_ms, peak_mib = step_times(cfg, model, opt, batch,
                                             OVERFIT_STEPS)
    emit({"phase": "train_times", "model": NAME, "card": card,
          "train_step_ms": step_ms, "train_step_split_ms": split_ms,
          "train_step_peak_mib": peak_mib, "warmup": TRAIN_WARMUP,
          "reps": TRAIN_REPS})
    return {"k1": sum(r["k1"] for r in per_step),
            "k2": sum(r["k2"] for r in per_step)}


class LogCapture(logging.Handler):
    """The messages futuredet_torch's loggers (the trainer's, the CLIs')
    give while the capture is entered, at INFO and above."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []
        self.logger = logging.getLogger("futuredet_torch")

    def emit(self, record):
        self.lines.append(record.getMessage())

    def __enter__(self):
        self.old = self.logger.level
        self.logger.addHandler(self)
        self.logger.setLevel(logging.INFO)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self)
        self.logger.setLevel(self.old)


def run_evaluate(argv):
    """futuredet_torch.cli.evaluate.main(argv), the K1 and K2 launches of
    each inference call of it counted (the counts zeroed just before, read
    just after). Returns (summary, [(K1, K2) per call], (K1, K2) in all,
    the log, seconds)."""
    from futuredet_torch.cli import evaluate
    from futuredet_torch.ops import pallas_gather, pallas_nms
    k1, k2 = pallas_nms.rotate_nms_alive, pallas_gather.gather_conv
    make, per_call = evaluate.make_infer, []

    def counted_make(*a, **kw):
        infer = make(*a, **kw)

        def counted(points, valid):
            b1, b2 = k1.launches, k2.launches
            out = infer(points, valid)
            per_call.append((k1.launches - b1, k2.launches - b2))
            return out
        return counted

    evaluate.make_infer = counted_make
    try:
        k1.launches = k2.launches = 0
        t0 = time.perf_counter()
        with LogCapture() as logs:
            summary = evaluate.main(argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        total = (k1.launches, k2.launches)
    finally:
        evaluate.make_infer = make
    return summary, per_call, total, logs.lines, secs


def summary_leaves(summary):
    """(key path, value) of every number in a metrics summary."""
    for k, v in summary.items():
        if isinstance(v, dict):
            for kk, vv in summary_leaves(v):
                yield f"{k}/{kk}", vv
        else:
            yield k, v


def check_summary(summary, what):
    check(set(summary) == set(SUMMARY_KEYS),
          f"{what}: summary keys {sorted(summary)}")
    bad = [k for k, v in summary_leaves(summary) if not math.isfinite(v)]
    check(not bad, f"{what}: summary values not finite: {bad}")


def headline(summary, cls):
    e = summary["label_tp_errors"][cls]
    return {"mAP": summary["mean_dist_aps"][cls],
            "mFAP": summary["mean_dist_faps"][cls],
            "mAAP": summary["mean_dist_aaps"][cls],
            "ADE": e["avg_disp_err"], "FDE": e["final_disp_err"],
            "MR": e["miss_rate"]}


def metrics_path(out_name):
    return os.path.join(OUT_DIR, out_name + ".json")


def eval_args(dev, model, out_name, *extra):
    """The evaluate CLI's arguments of phases 17-19: the car forecasts
    linked by velocity_dense, the metrics JSON and CSV under OUT_DIR."""
    return ["--model", model, "--device", str(dev), "--forecast_mode",
            "velocity_dense", "--out", metrics_path(out_name), *extra]


def cfg_post(name):
    from futuredet_torch.config import get_config
    return get_config(name).test.nms.post_max_size


def cli_pillar_path(dev, card, work):
    """Phase 17. Returns the launches of the evaluation and the train
    CLI's work dir."""
    import pickle

    from futuredet_torch.cli import train
    from futuredet_torch.config import get_config

    train_dir = os.path.join(work, "pp_cli")
    # each validation timed alone, synchronised
    make_val, val_ms = train.make_val_fn, []

    def timed_make_val(*a, **kw):
        val_fn = make_val(*a, **kw)

        def timed(state):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = val_fn(state)
            torch.cuda.synchronize()
            val_ms.append((time.perf_counter() - t) * 1e3)
            return out
        return timed

    train.make_val_fn = timed_make_val
    t0 = time.perf_counter()
    with LogCapture() as logs:
        state = train.main([
            "--model", NAME, "--device", str(dev), "--synthetic", "1",
            "--seed", str(CLI_SEED),
            "--epochs", str(CLI_EPOCHS), "--checkpoint_interval",
            str(CLI_EPOCHS), "--val_synthetic", "1", "--work_dir",
            train_dir])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train.make_val_fn = make_val
    check(next(state.model.parameters()).device.type == dev.type,
          f"the train CLI ran on {next(state.model.parameters()).device}")
    steps = state.step
    del state
    vals = [ln for ln in logs.lines if ln.startswith("val @ epoch")]
    check(steps == CLI_EPOCHS and len(vals) == CLI_EPOCHS,
          f"train CLI: {steps} steps, {len(vals)} validations")
    pkl = os.path.join(OUT_DIR, f"detections_{NAME}.pkl")
    summary, per_call, total, elog, eval_s = run_evaluate(eval_args(
        dev, NAME, f"metrics_{NAME}", "--synthetic", "1", "--seed",
        str(CLI_SEED), "--checkpoint_dir", train_dir, "--cohort_analysis",
        "--extractBox", "--predictions_path", pkl))
    check(per_call == [(1, 0)] and total == (1, 0),
          f"{NAME} eval: (K1, K2) launches {per_call}, {total} in all")
    check(any(f"restored checkpoint step {CLI_EPOCHS}" in ln for ln in elog),
          "the evaluate CLI did not restore the train CLI's checkpoint")
    check_summary(summary, f"{NAME} eval")
    with open(pkl, "rb") as f:
        saved = pickle.load(f)
    per_t = saved[0][0].valid.reshape(-1, cfg_post(NAME)).sum(-1).tolist()
    tails = host_tail_ms(get_config(NAME), saved)
    # the same detections scored per class, without cohorts
    plain, _, _, _, _ = run_evaluate(eval_args(
        dev, NAME, f"metrics_{NAME}_car", "--eval_only", "--predictions_path",
        pkl))
    check_summary(plain, f"{NAME} eval, car")
    car = headline(plain, "car")
    emit({"phase": "cli_train_evaluate", "model": NAME, "card": card,
          "scene": f"synthetic seed {CLI_SEED}, lidar clutter",
          "train_steps": steps, "train_s": round(train_s, 3),
          "val_ms_median": statistics.median(val_ms),
          "val_ms_sum": sum(val_ms),
          "train_log": [ln for ln in logs.lines if ln.startswith("step")],
          "val_first_last": [vals[0], vals[-1]],
          "eval_s": round(eval_s, 3), "launches_per_scene": per_call,
          "detections_per_t": per_t, "host_tail": tails, "car": car,
          "cohorts": {c: headline(summary, c) for c in
                      summary["mean_dist_aps"]},
          "metrics_json": os.path.relpath(metrics_path(f"metrics_{NAME}"),
                                          ROOT),
          "metrics_csv": os.path.relpath(metrics_path(f"metrics_{NAME}")
                                         [:-5] + ".csv", ROOT),
          "note": "an overfit training scene, not a measure of model "
                  "quality"})
    check(car["mAP"] > MAP_FLOOR, f"{NAME}: mAP(car) {car['mAP']} on the "
          f"scene it overfit (at most {MAP_FLOOR})")
    return {"k1": total[0], "k2": total[1], "checkpoint_dir": train_dir}


def host_tail(cfg, saved, native):
    """The evaluate CLI's host tail on saved detections: linking and
    records, then the metric engine. Returns (summary, link s, metrics s)."""
    from futuredet_torch.eval.evaluator import (detections_to_predictions,
                                                gt_records_from_arrays)
    from futuredet_torch.eval.metrics import evaluate_forecasts
    cls = cfg.data.class_names[0]
    t0 = time.perf_counter()
    preds, gts = [], []
    for det, gt, tokens in saved:
        p = detections_to_predictions(cfg, det, tokens,
                                      forecast_mode="velocity_dense",
                                      classname=cls)
        for x in p:
            x.yaw = float(-x.yaw - np.pi / 2)
        preds += p
        gts += gt_records_from_arrays(gt["boxes"], gt["valid"], gt["traj"],
                                      tokens, cls)
    t1 = time.perf_counter()
    res = evaluate_forecasts(preds, gts, [cls], cohort_analysis=True,
                             native=native)
    return res.summary(), t1 - t0, time.perf_counter() - t1


def host_tail_ms(cfg, saved):
    """The host tail of saved detections in ms per scene (median of 3), with
    the C++ matcher and with numpy, whose summaries must agree within
    GOLDEN_ATOL."""
    tails, n = {}, sum(len(tokens) for _, _, tokens in saved)
    for name, native in (("native", True), ("numpy", False)):
        runs = [host_tail(cfg, saved, native) for _ in range(3)]
        tails[name] = {
            "link_ms_per_scene": statistics.median(r[1] for r in runs)
            * 1e3 / n,
            "metrics_ms_per_scene": statistics.median(r[2] for r in runs)
            * 1e3 / n, "summary": runs[0][0]}
    a, b = (dict(summary_leaves(tails[k].pop("summary")))
            for k in ("native", "numpy"))
    tails["native_vs_numpy_max_abs_err"] = max(abs(a[k] - b[k]) for k in a)
    check(tails["native_vs_numpy_max_abs_err"] <= GOLDEN_ATOL,
          f"native vs numpy matcher {tails}")
    return tails


def cli_voxelnet_path(dev, card, ckpt_dir, scene_ms):
    """Phase 18. Returns the launches of the evaluation."""
    import pickle

    from futuredet_torch.config import get_config

    pkl = os.path.join(OUT_DIR, f"detections_{VOX_NAME}.pkl")
    summary, per_call, total, logs, eval_s = run_evaluate(eval_args(
        dev, VOX_NAME, f"metrics_{VOX_NAME}", "--synthetic", str(EVAL_SCENES),
        "--checkpoint_dir", ckpt_dir, "--cohort_analysis", "--speed_test",
        "--extractBox", "--predictions_path", pkl))
    check(per_call == [(1, 20)] * EVAL_SCENES
          and total == (EVAL_SCENES, 20 * EVAL_SCENES),
          f"{VOX_NAME} eval: (K1, K2) launches {per_call}, {total} in all")
    check(any(f"restored checkpoint step {TRAIN_STEPS}" in ln
              for ln in logs), "the evaluate CLI did not restore phase "
          "10's checkpoint")
    check_summary(summary, f"{VOX_NAME} eval")
    speed = [ln for ln in logs if ln.startswith("speed test:")]
    budget = [ln for ln in logs if ln.startswith("voxel budget")]
    check(len(speed) == 1 and len(budget) == 1, f"{speed} {budget}")
    check("(not reached)" in budget[0], budget[0])
    with open(pkl, "rb") as f:
        saved = pickle.load(f)
    tails = host_tail_ms(get_config(VOX_NAME), saved)
    emit({"phase": "cli_evaluate", "model": VOX_NAME, "card": card,
          "scenes": EVAL_SCENES, "checkpoint": "phase 10's trainer, step "
          f"{TRAIN_STEPS}", "launches_per_scene": per_call,
          "eval_s": round(eval_s, 3), "speed_test": speed[0],
          "phase_9_ms_per_scene": scene_ms, "voxel_budget": budget[0],
          "detections_per_scene": [int(d.valid.sum()) for d, _, _ in saved],
          "host_tail": tails,
          "cohorts": {c: headline(summary, c) for c in
                      summary["mean_dist_aps"]}})
    return {"k1": total[0], "k2": total[1]}


def tta_path(dev, card, ckpts):
    """Phase 19. Returns the launches of each model's --tta map and box."""
    from futuredet_torch.cli import evaluate
    from futuredet_torch.config import get_config
    from futuredet_torch.eval.decode import Detections
    from futuredet_torch.eval.tta import (FLIPS, infer_double_flip,
                                          infer_double_flip_map)

    out = {}
    for name, ckpt in ckpts.items():
        cfg = get_config(name)
        per_flip_k2 = 20 if name == VOX_NAME else 0
        for mode, k1_want in (("map", 1), ("box", len(FLIPS))):
            summary, per_call, total, _, _ = run_evaluate(eval_args(
                dev, name, f"metrics_{name}_tta_{mode}", "--synthetic", "1",
                "--seed", str(TTA_SEED), "--checkpoint_dir", ckpt, "--tta",
                mode))
            want = (k1_want, per_flip_k2 * len(FLIPS))
            check(per_call == [want] and total == want,
                  f"{name} --tta {mode}: (K1, K2) launches {per_call}")
            check_summary(summary, f"{name} --tta {mode}")
            out[f"{name}_tta_{mode}"] = {"k1": total[0], "k2": total[1]}
        # the same weights and scene through the port on the CPU
        args = evaluate.parse_args(["--model", name, "--checkpoint_dir",
                                    ckpt])
        batch = evaluate.synthetic_batches(cfg, 1, 1, TTA_SEED)[0]
        runs = {}
        for where_name, where in (("card", dev),
                                  ("cpu", torch.device("cpu"))):
            model = evaluate.restore_model(cfg, args, where)
            pts = batch["points"].to(where)
            valid = batch["points_valid"].to(where)
            rec = []

            def forward(p, v, model=model, rec=rec):
                rec.append(model(p, v))
                return rec[-1]

            t0 = time.perf_counter()
            with torch.no_grad():
                det_map = infer_double_flip_map(cfg, forward, pts, valid)
                replay = iter(list(rec))      # the four flips, in order
                det_box = infer_double_flip(cfg, lambda p, v: next(replay),
                                            pts, valid)
            torch.cuda.synchronize()
            runs[where_name] = (model, pts, valid, rec, det_map, det_box,
                                time.perf_counter() - t0)
        (gm, gp, gv, grec, gmap, gbox, _), cpu = runs["card"], runs["cpu"]
        hm_err = max(float((torch.sigmoid(g["hm"]).cpu()
                            - torch.sigmoid(c["hm"])).abs().max())
                     for gf, cf in zip(grec, cpu[3]) for g, c in zip(gf, cf))
        check(hm_err <= HM_ATOL, f"{name} flipped heatmaps card vs CPU "
              f"{hm_err}")
        matched = {"map": check_detections_match(cfg, gmap, cpu[4], hm_err)}
        n = gmap.valid.shape[1]
        for i in range(len(FLIPS)):
            # one flip of the box ensemble, its scores back to the flip's
            part = [Detections(*(x[:, i * n:(i + 1) * n] for x in d))
                    for d in (gbox, cpu[5])]
            part = [d._replace(scores=d.scores * len(FLIPS)) for d in part]
            matched[f"box_flip_{i}"] = check_detections_match(cfg, *part,
                                                              hm_err)
        ms = {}
        for mode in ("map", "box"):
            infer = evaluate.make_infer(cfg, gm, mode)
            ms[mode] = time_host(lambda: infer(gp, gv), reps=TTA_REPS)
        emit({"phase": "tta", "model": name, "card": card,
              "scene": f"synthetic seed {TTA_SEED}",
              "launches_per_scene": {m: out[f"{name}_tta_{m}"]
                                     for m in ("map", "box")},
              "cpu_s": round(cpu[6], 3), "hm_max_abs_err": hm_err,
              "hm_atol": HM_ATOL,
              "detections_card_cpu_let_off": matched,
              "ms_per_scene": ms, "warmup": WARMUP, "reps": TTA_REPS})
    return out


def golden_records():
    from futuredet_torch.eval.metrics import GTRecord, PredRecord
    z = np.load(os.path.join(ROOT, "tests", "fixtures",
                             "metrics_golden.npz"))
    preds = [PredRecord(
        sample=str(z["pred_sample"][i]), centers=z["pred_centers"][i],
        size=z["pred_size"][i], yaw=float(z["pred_yaw"][i]),
        vel=z["pred_vel"][i], det_score=float(z["pred_det_score"][i]),
        forecast_score=float(z["pred_forecast_score"][i]),
        forecast_id=int(z["pred_forecast_id"][i]),
        classname=str(z["pred_classname"][i]), attr=str(z["pred_attr"][i]))
        for i in range(len(z["pred_sample"]))]
    gts = [GTRecord(
        sample=str(z["gt_sample"][i]), centers=z["gt_centers"][i],
        size=z["gt_size"][i], yaw=float(z["gt_yaw"][i]), vel=z["gt_vel"][i],
        classname=str(z["gt_classname"][i]), cohort=str(z["gt_cohort"][i]),
        attr=str(z["gt_attr"][i]))
        for i in range(len(z["gt_sample"]))]
    return preds, gts


def metrics_engine_path(dev, card):
    """Phase 20."""
    from futuredet_torch.config import get_config
    from futuredet_torch.data.synthetic import make_batch
    from futuredet_torch.eval.decode import Detections
    from futuredet_torch.eval.evaluator import evaluate_detections
    from futuredet_torch.eval.metrics import evaluate_forecasts

    with open(os.path.join(ROOT, "tests", "fixtures",
                           "metrics_golden.json")) as f:
        golden = json.load(f)
    preds, gts = golden_records()
    settings = {}
    for setting, kw in GOLDEN_SETTINGS.items():
        want = dict(summary_leaves(golden[setting]))
        for name, native in (("native", True), ("numpy", False)):
            t0 = time.perf_counter()
            res = evaluate_forecasts(preds, gts, ["car", "pedestrian"],
                                     horizon_seconds=3.0, native=native,
                                     **kw)
            ms = (time.perf_counter() - t0) * 1e3
            got = dict(summary_leaves(res.summary()))
            check(got.keys() == want.keys(), f"golden {setting} keys")
            err = max(abs(got[k] - want[k]) for k in want)
            settings[f"{setting}_{name}"] = {"max_abs_err": err, "ms": ms}
            check(err <= GOLDEN_ATOL, f"golden {setting} on the {name} "
                  f"matcher: {err}")

    # the GT fed back as Detections on the card (tests/test_e2e_eval.py)
    cfg = get_config(NAME)
    batch = make_batch(cfg, 2, seed=5, n_objects=5, n_clutter=100,
                       max_objs=16)
    gt = batch["gt"]
    T, post = cfg.model.head.timesteps, cfg.test.nms.post_max_size
    boxes = np.zeros((2, T * post, 9), np.float32)
    scores = np.zeros((2, T * post), np.float32)
    labels = np.zeros((2, T * post), np.int64)
    valid = np.zeros((2, T * post), bool)
    for b in range(2):
        i = 0
        for t in range(T):
            for k in np.nonzero(gt["valid"][b][t])[0]:
                g = gt["boxes"][b][t, k]
                boxes[b, i] = [*g[:8], g[10]]
                scores[b, i], labels[b, i], valid[b, i] = 0.9, t, True
                i += 1
    det = Detections(*(torch.from_numpy(a).to(dev)
                       for a in (boxes, scores, labels, valid)))
    res = evaluate_detections(cfg, det, gt, ["s0", "s1"],
                              forecast_mode="velocity_dense")
    oracle = headline(res.summary(), "car")
    emit({"phase": "metrics_engine", "card": card,
          "golden_atol": GOLDEN_ATOL, "golden": settings,
          "oracle_gt_as_detections": oracle,
          "oracle_floor": ORACLE_FLOOR})
    check(oracle["mAP"] > ORACLE_FLOOR and oracle["mFAP"] > ORACLE_FLOOR,
          f"the GT-as-predictions oracle: {oracle}")


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
                    if "registers" in ln or "Compiling" in ln
                    or "spill" in ln]
             for name in secs}
    check(set(secs) >= {"nms_kernel.cu", "gather_conv_kernel.cu",
                        "host_accumulate.cpp"}, f"built {sorted(secs)}")
    spills = [ln for name in ("nms_kernel.cu", "gather_conv_kernel.cu")
              for ln in ptxas[name] if re.search(r"[1-9]\d* bytes spill", ln)]
    check(not spills, f"K1 or K2 spills registers: {spills}")
    emit({"phase": "device_build", "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": round(build_s, 3), "per_source_s": secs,
          "ptxas": ptxas, "tf32": False})

    os.makedirs(OUT_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory() as work:
        k1 = pillar_path(dev, card)
        vox = voxelnet_path(dev, card)
        vox_ckpt = os.path.join(work, "voxelnet_train")
        train = train_path(dev, card, vox_ckpt)
        pillar_train = pillar_train_path(dev, card)
        pp_eval = cli_pillar_path(dev, card, work)
        vox_eval = cli_voxelnet_path(dev, card, vox_ckpt, vox["scene_ms"])
        tta = tta_path(dev, card, {NAME: pp_eval.pop("checkpoint_dir"),
                                   VOX_NAME: vox_ckpt})
    metrics_engine_path(dev, card)

    evals = {NAME + "_eval": pp_eval, VOX_NAME + "_eval": vox_eval, **tta}
    print(card, flush=True)
    k2 = vox["k2"]
    emit({"kernels": [{
        "name": "K1 rotated NMS survivor mask",
        "route": "cuda", "source": "futuredet_torch/csrc/nms_kernel.cu",
        "replaces": "futuredet_tpu/ops/pallas_nms.py:82",
        "launches": k1["launches"] + vox["k1_launches"]
        + sum(e["k1"] for e in evals.values()),
        "launches_by_path": {NAME: k1["launches"],
                             VOX_NAME: vox["k1_launches"],
                             VOX_NAME + "_train": train["k1_launches"],
                             NAME + "_train": pillar_train["k1"],
                             **{p: e["k1"] for p, e in evals.items()}},
        "matched": True, "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"], "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
        "dense_cluster_ms": k1["dense_ms"],
        "library_ms": None}, {
        "name": "K2 sparse gather-conv",
        "route": "cuda",
        "source": "futuredet_torch/csrc/gather_conv_kernel.cu",
        "replaces": "futuredet_tpu/ops/pallas_gather.py:49",
        "launches": k1["k2_launches"] + k2["launches"] + train["launches"]
        + sum(e["k2"] for e in evals.values()),
        "launches_by_path": {NAME: k1["k2_launches"],
                             VOX_NAME: k2["launches"],
                             VOX_NAME + "_train": train["launches"],
                             NAME + "_train": pillar_train["k2"],
                             **{p: e["k2"] for p, e in evals.items()}},
        "train_launches_per_step": {"forward": train["forward_per_step"],
                                    "dx": train["dx_per_step"]},
        "matched": True,
        "max_abs_err": max(k2["max_abs_err"], train["dx_max_abs_err"]),
        "ms": k2["ms"], "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
        "tc_bound_ms": k2["tc_bound_ms"],
        "library_ms": k2["library_ms"],
        "times_are": "sums over the 20 convs of one scene",
        "train_per_step": {k: train[k] for k in (
            "train_step_ms", "k2_forward_ms", "k2_dx_ms", "plain_dx_ms",
            "library_dx_ms", "dw_db_ms", "k2_dx_bound_ms",
            "k2_dx_tc_bound_ms", "dw_db_bound_ms")}}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
