#!/usr/bin/env python3
"""Smoke run of futuredet_torch on one NVIDIA GPU: the quickest proof that
the port builds, agrees with itself and starts on the card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card and the
CUDA toolkit. Phases, one JSON line each (several for some):

  1. device and build: card name and power limit, then the CUDA kernels of
     futuredet_torch/csrc (K1 nms_kernel.cu, K2 gather_conv_kernel.cu and
     its bf16 family gather_conv_bf16_kernel.cu) and the metric engine's
     host C++ matcher (host_accumulate.cpp, g++) built at once into
     build/torch_kernels/, with ptxas's lines for each kernel; no K1 or K2
     function may spill registers.

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

  Real nuScenes-format data, through the CLIs a user runs:
  21. write_nuscenes writes a v1.0-trainval dataset from NUSC_SEED (a
      train and a val scene of NUSC_KEYFRAMES keyframes at 2 Hz, 9 sweeps
      at 20 Hz between them and 19 before the first, NUSC_SWEEP_POINTS
      points a sweep: lidar clutter and the surface points of
      NUSC_OBJECTS static, linear and nonlinear cars, in the sensor's
      moving frame); cli.create_data nuscenes_data_prep --gt_database
      (seconds, infos, database objects). Then cli.train --info_path
      --db_info_path (GT-AUG, the prefetched pipeline, --tensorboard where
      tensorboard imports) for one epoch of NUSC_KEYFRAMES steps at B = 1,
      for forecast_n3dtf and pp_forecast_n3dtf: counts zeroed before each
      step and read after it, 20 K2 forward + 19 K2 dx launches and no K1
      a VoxelNet step, none at all a pillar step; every metric finite,
      the checkpoint written; voxels a sample and how many reached
      max_voxels_train. The host pipeline of one sample by part (native
      sweep load, GT-AUG sample_all, augmentations, shuffle and pack,
      whole sample; median of NUSC_HOST_REPS) with its points before and
      after the pack. The VoxelNet trainer on these batches with
      prefetch_depth 2 and 0 in turns (2, 0, 2, 0; NUSC_TURN_STEPS synced
      steps each): the median wait for data against the median step, the
      median period (wait + step), what the prefetch thread adds to the
      step (depth 2's median step less depth 0's), and the card's busy
      share under torch.profiler.
  22. cli.evaluate --info_path of the val infos from phase 21's
      checkpoints with --speed_test: per sample K2 20 times and K1 once
      (VoxelNet), K1 once (pillars); the metrics finite. One val sample
      through the same weights on the CPU: heatmaps within HM_ATOL,
      detections matched as in phase 8. The same train info sampled
      twice by two datasets from the same seeds: identical arrays. The
      native sweep loader against the numpy reader (use_native=False) on
      a full keyframe: identical. A pinned batch's copy on the card
      against its pageable copy: identical.

  The single-stage head modes (models/center_head.py, eval/decode.py,
  models/losses.py, data/targets.py in every mode):
  23. inference at full width with seeded weights, on phase 4's uniform
      scene (pillars) or phase 8's uniform_blobs scene (VoxelNet): the
      named configs forecast_n0, forecast_n3, forecast_n3dtfm (the ego map
      of rasterize_scene_map), centerpoint_multitask and
      pp_centerpoint_multitask, then the reverse, sparse, classify and
      wide_head flags on forecast_n3 and dcn_head on forecast_n0. Counts
      zeroed just before and read just after: K1 once on G = pseudo-tasks
      problems (7; 14 sparse; 6 multitask), K2 20 times a VoxelNet scene;
      every map finite and of the head's widths. Per mode ms a scene
      (median of HEAD_MODE_REPS after HEAD_MODE_WARMUP, synced) and peak
      MiB. The named configs and DCN card against the CPU: heatmaps within
      HM_ATOL, detections matched as in phase 8 (forecast_n0's seven
      replicated pseudo-tasks equal on the card, the first one matched).
  24. one full-width B = 1 train step each of forecast_n0, forecast_n3,
      forecast_n3dtfm and centerpoint_multitask on phase 10's lidar-family
      scene: 20 K2 forward + 19 K2 dx launches and no K1, metrics finite;
      ms a step and peak MiB; a centerpoint_multitask step card against
      the CPU to phase 12's limits.
  25. cli.evaluate.main on HEAD_MODE_CLI_SCENES synthetic scenes of its
      own from the seeded init: forecast_n0 --forecast_mode
      velocity_constant, and centerpoint_multitask with class-labeled
      metrics over its ten classes; K1 once and K2 20 times a scene, the
      metrics JSON and CSV under build/chip_smoke/.

  Two-stage RoI refinement (models/two_stage.py):
  26. inference at full width with seeded weights:
      pp_forecast_n3dtf_two_stage on phase 4's uniform scene and
      forecast_n3dtf_two_stage on phase 8's uniform_blobs scene. Counts
      zeroed just before and read just after: K1 once on G = 7 problems,
      K2 20 (VoxelNet) or 0 times; refined boxes and fused scores finite,
      the score 0 exactly where a proposal is invalid. ms a scene (median
      of HEAD_MODE_REPS after HEAD_MODE_WARMUP, synced) and peak MiB, the
      single-stage config timed in the same call beside it. The same
      weights and scene on the CPU: heatmaps within HM_ATOL, proposals
      matched as in phase 8, and on the matched proposals the RoI logits,
      residuals, refined boxes and fused scores within ROI_RTOL of
      max(1, max|CPU|).
  27. one full-width B = 1 train step of each two-stage config on phase
      10's lidar-family scene: K1 once inside the forward, K2 20 forward
      + 19 dx (VoxelNet) or none; every frozen parameter bit-identical
      after the step, every trainable one with a gradient moved, the
      frozen BatchNorms' running statistics moved, 92 trainable tensors;
      metrics finite, hm_loss 0. ms a step split as phase 13, with the
      decode + NMS and proposal-target shares, and peak MiB. Then 10
      steps of a fresh model on the same batch: roi_cls_loss at the last
      below the first. The pillar step card against a float64 CPU run (as
      phase 15): loss, gradient norm, statistics and every trainable
      gradient to phase 12's limits; the frozen gradients, which reach only
      the gradient norm, within twice the CPU's own float32 distance.
  28. cli.train.main of pp_forecast_n3dtf_two_stage grafting phase 17's
      checkpoint (--first_stage_checkpoint) for TWO_STAGE_CLI_EPOCHS
      one-step epochs (K1 once a step), then cli.evaluate.main of its
      checkpoint on phase 17's scene (K1 once), the metrics JSON and CSV
      under build/chip_smoke/, mAP beside phase 17's (no floor: the RoI
      head's init moves the boxes); --tta map on it exits non-zero.

  The bf16 serving mode (compute_dtype, middle_sparse_dtype,
  middle_gather_algo="window_bf16"; models/layers.py, models/middle.py)
  and K2's bf16 family:
  29. K2's bf16 family against its plain version on the 20 bf16 convs of
      phase 30's first scene as the main path gave them (within K2_RTOL of
      max(1, max|plain|), bit-identical launch to launch): ms a scene, the
      plain version's, the stacked bf16 index_select + addmm into fp32
      (library_ms), the bound at the bf16 tensor-core rate and at the
      bytes of bf16 rows and weights, and the sub-path each conv takes
      (plan: W resident or streamed, the site tile, 16- or 2-byte rows).
  30. each serving knob beside its fp32 config on phase 8's uniform_blobs
      scene (VoxelNet) or phase 4's uniform scene (pillars), seeded
      weights: (a) compute_dtype and middle_sparse_dtype bfloat16, (b)
      window_bf16, (c) bf16_packed, and pp_forecast_n3dtf with
      compute_dtype. Counts zeroed just before and read just after: K1
      once, K2 20 a VoxelNet scene, all on the bf16 route under (a) and
      (b), none under (c); every head map finite, fp32, and within
      SERVING_RTOL of max(1, max|fp32|) of the card's fp32 forward of the
      same weights. ms a scene (median of HEAD_MODE_REPS after
      HEAD_MODE_WARMUP, synced) and peak MiB, fp32 / knob / knob / fp32 in
      turns.

  The VoxelNet dense middle forms (models/middle.py, models/detector.py):
  31. the dense canvas's bytes at middle_dense_from_stage = DENSE_FROM,
      then (d) dense_from_stage DENSE_FROM, fp32 and with
      middle_dense_dtype bfloat16, and (e) middle="dense" on phase 8's
      uniform_blobs scene: K1 once, K2 only for the sparse stages below
      DENSE_FROM (none under (e)); the (d) middle's output within
      DENSE_RTOL (bf16: DENSE_BF16_RTOL) of max(1, max|sparse|) of the
      sparse middle's, z-mask and active cells equal; ms a scene and peak
      MiB, the sparse config's ms beside.
  32. one full-width B = 1 train step of (e) on phase 10's scene through
      plain autograd: finite loss, no K2.

  Training under the bf16 knobs and data parallelism (models/layers.py,
  ops/sparse_conv.py::SparseConvFunction, parallel/):
  33. a B = 1 train step on phase 10's scene under each BF16_TRAIN knob:
      forecast_n3dtf under (a) compute_dtype + middle_sparse_dtype
      bfloat16 (K2 20 forward on the bf16 route, 19 dx on the fp32
      families) and (d) middle_dense_from_stage DENSE_FROM with
      middle_dense_dtype (K2 10 + 9 dx, fp32), pp_forecast_n3dtf and
      pp_forecast_n3dtf_two_stage (K1 once) under compute_dtype; counts
      zeroed just before the step and read just after. The step split
      (phase 13's) and peak MiB beside the fp32 step's; under (a), the
      knob that runs K2's bf16 family, the card against the CPU's step
      under the same knob by the BF16_* rule (the card's fp32 step must
      break it); OVERFIT_STEPS steps of finite losses.
      scripts/torch_train_bf16_phases.py times the steps in turns and
      holds every knob's step to the CPU's.
  34. cli.train and cli.evaluate of forecast_n3dtf with
      --coordinator_address / --num_processes 1 / --process_id 0 (a
      one-rank NCCL group, left at the end; K2 39 a step, K1 once and K2
      20 a scene); one pp_forecast_n3dtf step in the group against the
      plain step under torch's deterministic algorithms, bit for bit when
      two plain steps agree bit for bit, else within DP_SPREAD times
      their distance; the step's ms in and out of the group; the
      collectives two or more ranks add a
      step (one differentiable all-reduce per BatchNorm with its
      backward, one flat all-reduce of the gradients) timed at world size
      1. NCCL refuses two ranks on one device: no multi-GPU figure.

  The tools, the profiler and the FLOP count (K1 and K2 are the custom
  operators torch.ops.futuredet.nms_alive / gather_conv):
  35. cli.tools export --check of pp_forecast_n3dtf and forecast_n3dtf at
      full width (the configs' 300,000-point buffers): the .pt2 holds K1
      (and the VoxelNet's 20 sparse convs, K2) as the operators; loaded,
      it runs phase 4's uniform scene (padded with invalid rows to the
      buffer) or phase 8's uniform_blobs scene with phases 2 and 6's
      seeded weights, under torch's deterministic algorithms: K1 once (K2
      20) a scene, detections bit-identical to the eager program's. The
      export's seconds, the artifact's bytes, ms a scene exported against
      eager in turns (median of 20 after 3). The same round trip, untimed,
      of forecast_n3dtf under middle_dense_from_stage 0 (no K2) and 2
      (K2 10) and of pp_forecast_n3dtf under circular_nms (seven
      circle_nms operators, no K1), through tools.export_config.
  36. cli.train --model forecast_n3dtf --profile DIR: two B = 1 steps of
      the CLI's synthetic scene (seed TRAIN_SEED); K2 20 + 19 a step; the
      trace file parses as JSON and names K2's kernels (39 launches a
      step) and cuDNN's convolutions; device_memory_stats() reports the
      card's live bytes; the step's ms with the profiler and without it
      (the same command again).
  37. model_flops of pp_forecast_n3dtf and forecast_n3dtf at full width
      on the card (the JAX function's inputs: the buffer's zero points,
      all valid) must equal analytic_flops (every conv, deconv and linear
      layer from its shapes, K2's 2 N 27 Cin Cout from its tables); GFLOP
      a scene, and the analytic GFLOP of phases 5 and 9's scenes over
      their ms as achieved TFLOP/s (a figure, not a gate).
  38. tools trajectory on phase 21's train infos, then cli.evaluate
      --postprocess of pp_forecast_n3dtf on its val infos from phase 21's
      checkpoint: the prototypes file found, K1 once a sample, the
      metrics JSON written; tools statistics on the train infos; tools
      compare of phase 17's and phase 21's pillar checkpoints (most
      parameters changed) and of one with itself (none); the sorted
      reader (PillarFeatureNet over point_voxel_map, then scatter_to_bev)
      on phase 4's scene, card against CPU within 1e-5 of max(1,
      max|CPU|).

  Spatial sharding of the canvas (--space; parallel/, models/layers.py):
  39. gloo groups of 2 and 3 processes on this card (NCCL refuses two
      ranks on one device; the collectives are staged through the host,
      so no figure here is a multi-card one), each rank holding a band
      of the canvas rows, with phases 2 and 6's seeded weights, TF32 off
      and torch's deterministic algorithms: (a) pp_forecast_n3dtf's eval
      forward at 2 and 3 ranks (bands of 32 / 32 and 22 / 22 / 20 coarse
      rows) on phase 4's scene, (b) forecast_n3dtf's at 2 ranks on phase
      8's scene, (c) a B = 1 train step of each at 2 ranks on phase 10's
      scene, (d) the eval forward and a B = 1 step of
      pp_forecast_n3dtf_two_stage and of forecast_n0 under dcn_head (its
      offset convs seeded, DCN_OFFSET_STD) at 2 ranks. Against the
      unsharded card runs in this process: every rank's head maps within
      SPACE_RTOL of max |unsharded|, the first rank's detections (a
      two-stage model's refined ones, the same on every rank) matched as
      in phase 4, K1 once a single-stage scene on it and never on the
      others, once a two-stage scene or step on every rank, K2 20 a
      VoxelNet scene on every rank and 20 + 19 dx a VoxelNet step, one
      DCN gather a forward and two a step; each step's losses,
      grad_norm, gradients and running statistics within DP_SPREAD times
      the spread of the unsharded step on weights nudged by SPACE_NUDGE
      (the two-stage and DCN steps' losses and gradients also within
      phase 12's limits, a two-stage step's frozen gradients within
      phase 27's gate from its float64 run; `space_train_rule`), and the
      ranks' gradients
      and statistics bit-identical. Per rank ms of the forward or step
      and peak MiB beside the unsharded ones, halo exchanges and bytes
      and the DCN gathers' bytes a forward or step. Every phase line
      carries t_s and phase_s.

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
# of a layer's max |x|: the furthest a ReLU input may lie from 0 where the
# card decided its sign otherwise than the CPU reference (the card's fp32
# ReLU inputs lie up to 2.0e-4 of their max from float64 in the pillar
# neck's first block, scripts/torch_probe_relu_ties.py)
RELU_TIE_RTOL = 1e-4
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
BF16_PEAK = 989e12        # H100 SXM dense bf16 tensor-core peak, FLOP/s
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
# the real-data phases (21-22): a nuScenes-format dataset written from
# NUSC_SEED, one train and one val scene (data/splits.py), NUSC_KEYFRAMES
# keyframes each at 2 Hz with NUSC_SWEEPS_BETWEEN sweeps at 20 Hz between
# them, NUSC_SWEEP_POINTS points a sweep (about the per-sweep count of
# nuScenes' 32-beam LIDAR_TOP) and NUSC_OBJECTS cars a keyframe within
# NUSC_EXTENT m; NUSC_NSWEEPS sweeps a sample, so an aggregate of ~690k
# points goes to the config's 300,000-point budget
NUSC_SEED = 8
NUSC_SCENES = ("scene-0001", "scene-0003")
NUSC_KEYFRAMES, NUSC_SWEEPS_BETWEEN = 8, 9
NUSC_SWEEP_POINTS, NUSC_OBJECTS, NUSC_EXTENT = 34720, 40, 50.0
NUSC_NSWEEPS = 20
NUSC_HOST_REPS = 5        # phase 21.3: median of these
NUSC_TURN_STEPS = 6       # phase 21.4: trainer steps a prefetch turn
# the head-mode phases (23-25): the named single-stage configs, then the
# flag-only heads on forecast_n3's VoxelNet and DCN on forecast_n0, each
# timed as HEAD_MODE_REPS synced scenes (or steps) after HEAD_MODE_WARMUP
HEAD_MODES = (("forecast_n0", None), ("forecast_n3", None),
              ("forecast_n3dtfm", None), ("centerpoint_multitask", None),
              ("pp_centerpoint_multitask", None), ("forecast_n3", "reverse"),
              ("forecast_n3", "sparse"), ("forecast_n3", "classify"),
              ("forecast_n3", "wide_head"), ("forecast_n0", "dcn_head"))
HEAD_MODES_TRAIN = ("forecast_n0", "forecast_n3", "forecast_n3dtfm",
                    "centerpoint_multitask")
HEAD_MODES_CLI = (("forecast_n0", ["--forecast_mode", "velocity_constant"]),
                  ("centerpoint_multitask", []))
HEAD_MODE_WARMUP, HEAD_MODE_REPS = 2, 5
HEAD_MODE_MAP_SEED = 3     # the lidar-family scene whose map phase 23 uses
HEAD_MODE_CLI_SCENES = 2
# the two-stage phases (26-28): each two-stage config beside the
# single-stage config its first stage is
TWO_STAGE_NAMES = (("pp_forecast_n3dtf_two_stage", NAME),
                   ("forecast_n3dtf_two_stage", VOX_NAME))
# card vs CPU RoI outputs on the matched proposals, of max(1, max|CPU|):
# the neck's fp32 difference through the RoI head's 1920- or 2560-long sums
ROI_RTOL = 1e-4
PROPOSAL_MATCH_M = 1e-3    # a card proposal's CPU counterpart: its centre
TWO_STAGE_TRAINABLE = 92   # 7 tasks x (vel, rot) x 6 tensors + the RoI's 8
TWO_STAGE_CLI_EPOCHS = 3   # phase 28: one-step epochs of the train CLI
# the bf16 serving phases (29-30): each knob beside its fp32 config, on
# phase 8's uniform_blobs scene (VoxelNet) or phase 4's uniform scene
# (pillars); the tags' letters are those of the docstring
SERVING = (("a_bf16", VOX_NAME, {"compute_dtype": "bfloat16",
                                 "middle_sparse_dtype": "bfloat16"}),
           ("b_window_bf16", VOX_NAME, {"middle_gather_algo": "window_bf16"}),
           ("c_bf16_packed", VOX_NAME, {"middle_sparse_dtype": "bf16_packed"}),
           ("pillars_bf16", NAME, {"compute_dtype": "bfloat16"}))
# every head map of a serving knob against the card's fp32 forward of the
# same weights, of max(1, max|fp32|): the JAX package's own tolerance for
# its bf16 serving mode (tests/test_models.py:126-151)
SERVING_RTOL = 0.05
# the dense middle forms (phase 31), against the sparse middle's output:
# fp32 sums in another order (tests/test_dense_middle.py), and bf16 conv
# operands
DENSE_FROM = 2
DENSE_RTOL, DENSE_BF16_RTOL = 2e-4, 5e-2
# the bf16 training phase (33): each knob's B = 1 train step beside its
# fp32 step on phase 10's lidar-family scene
BF16_TRAIN = (("a_bf16", VOX_NAME, {"compute_dtype": "bfloat16",
                                    "middle_sparse_dtype": "bfloat16"}),
              ("d_dense_bf16", VOX_NAME, {"middle_dense_from_stage":
                                          DENSE_FROM,
                                          "middle_dense_dtype": "bfloat16"}),
              ("pillars_bf16", NAME, {"compute_dtype": "bfloat16"}),
              ("two_stage_bf16", "pp_forecast_n3dtf_two_stage",
               {"compute_dtype": "bfloat16"}))
# phase 33's card-vs-CPU rule, that of tests/test_torch_train_bf16_*.py:
# per quantity (each loss, grad_norm, and per top-level module the
# gradients and the running statistics as one relative distance), the
# card's distance from the CPU's bf16 step against the CPU fp32 step's
# ("gap") and the CPU bf16 step's on the weights scaled by 1 + BF16_NUDGE
# ("noise", the rounding flips that a bf16 forward amplifies layer by
# layer): within max(BF16_GAP_FRACTION * gap, BF16_NOISE_FACTOR * noise,
# a floor), and within BF16_GAP_FRACTION * gap where the gap stands
# BF16_SIGNAL times above the noise. The CPU tests hold the port to 1.5x
# JAX's own noise; the card and the CPU differ in every reduction's
# order, hence 2x here
BF16_GAP_FRACTION, BF16_NOISE_FACTOR, BF16_SIGNAL = 0.25, 2.0, 5.0
BF16_NUDGE = 2.0 ** -20
BF16_LOSS_ULPS, BF16_FP32_FLOOR = 2.0 ** -7, 1e-5
# phase 34: a world-size-1 step against the plain step, when two plain
# steps differ (an op without a deterministic kernel): within this many
# times their distance (seen: 0.74x and 1.52x with no deterministic mode)
DP_SPREAD = 4.0
SORTED_READER_RTOL = 1e-5   # phase 38: card vs CPU, sums in another order
ROOT = os.path.dirname(os.path.abspath(__file__))
# the metrics JSON and CSV the evaluate CLI writes in phases 17-19
OUT_DIR = os.path.join(ROOT, "build", "chip_smoke")
# the four K2 launches timed alone: index of the conv in the encoder's
# order (stage 0: conv_input, 4 block convs; stages 1-3: down, 4 block
# convs each)
K2_REPRESENTATIVE = {"s0_conv_input_5to16": 0, "s0_subm_16to16": 1,
                     "down1_16to32": 5, "s3_subm_128to128": 16}


T_START = time.perf_counter()


_LAST_PHASE_LINE = [T_START]


def emit(obj) -> None:
    """One JSON line; a phase's line carries the seconds since the start
    (t_s) and since the previous phase line (phase_s: the phase's seconds,
    shared among its lines where it prints several)."""
    if "phase" in obj:
        now = time.perf_counter()
        obj = {**obj, "t_s": round(now - T_START, 1),
               "phase_s": round(now - _LAST_PHASE_LINE[0], 1)}
        _LAST_PHASE_LINE[0] = now
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
    its bytes (every input read once and the output written once: x and W
    in their own type, 2 bytes for the bf16 family) at the memory rate and
    its 2 * present (k, n) pairs * Cin * Cout operations, at the fp32 peak
    (bound_ms; the bf16 tensor-core peak for the bf16 family) and, for the
    wide family, which does them as 3xTF32 on the tensor cores, at a third
    of the dense TF32 peak (tc_bound_ms; None for the other families)."""
    from futuredet_torch.ops.pallas_gather import k2_route
    V, cin = features.shape
    N, cout = table.shape[1], weights.shape[2]
    present = int(((table >= 0) & (table < V)).sum())
    nbytes = (features.element_size() * (features.numel() + weights.numel())
              + 4 * (table.numel() + (0 if bias is None else cout)
                     + N * cout))
    bytes_ms = nbytes / HBM_RATE * 1e3
    ops = 2 * present * cin * cout
    route = k2_route(cin, cout, features.dtype)
    ops_ms = ops / (BF16_PEAK if route == "bf16" else FP32_PEAK) * 1e3
    return {"route": route, "present_pairs": present, "bytes": nbytes,
            "bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "tc_bound_ms": (max(bytes_ms, ops / TF32X3_PEAK * 1e3)
                            if route == "wide" else None)}


def k2_library_call(features, table, weights, bias):
    """The stacked form as two PyTorch calls, a yardstick that no path
    calls: index_select of the 27*N rows (n-major), then one mm (addmm
    with the bias) of the (N, 27*Cin) block, fp32, or for bf16 inputs
    bf16 into an fp32 output (addmm's out_dtype). The flat table and the
    padded features are made outside the timed function."""
    V, cin = features.shape
    N, cout = table.shape[1], weights.shape[2]
    padded = torch.cat([features, features.new_zeros(1, cin)])
    flat = table.t().reshape(-1).contiguous()
    w2 = weights.reshape(27 * cin, cout)
    b = bias if bias is not None else torch.zeros(
        cout, dtype=torch.float32, device=features.device)
    kw = ({"out_dtype": torch.float32}
          if features.dtype == torch.bfloat16 else {})

    def fn():
        return torch.addmm(b, padded.index_select(0, flat).view(N, 27 * cin),
                           w2, **kw)
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
            "scene_ms": {k: times[k] for k in on_card},
            "max_abs_err": k1_err, "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"],
            "dense_ms": k1["dense_cluster_7x1000"]["ms"]}


def analytic_flops(model, points, valid):
    """The flops of one forward, counted without FlopCounterMode: 2 x the
    multiply-adds of every conv, deconv and linear layer, from its weight
    shape and its output (a deconv: its input) size, plus each sparse
    conv's dense contraction 2 N 27 Cin Cout (K2's formula), N from its
    table. Returns (total, {"conv": ..., "deconv": ..., "linear": ...,
    "k2": ...})."""
    from torch import nn

    from futuredet_torch.ops import sparse_conv as sc_mod

    parts = dict.fromkeys(("conv", "deconv", "linear", "k2"), 0)

    def layer(m, inp, out):
        if isinstance(m, nn.Linear):
            parts["linear"] += 2 * out.numel() * m.in_features
        elif isinstance(m, nn.ConvTranspose2d):
            x = inp[0]
            parts["deconv"] += (2 * x.shape[0] * math.prod(x.shape[2:])
                                * m.weight.numel())
        else:
            parts["conv"] += 2 * out.numel() * m.weight[0].numel()

    def k2(features, table, weights, bias=None):
        parts["k2"] += (2 * table.shape[1] * table.shape[0]
                        * weights.shape[1] * weights.shape[2])
        return kernel(features, table, weights, bias)

    kernel = sc_mod.gather_conv
    hooks = [m.register_forward_hook(layer) for m in model.modules()
             if isinstance(m, (nn.Linear, nn.Conv2d, nn.Conv3d,
                               nn.ConvTranspose2d))]
    sc_mod.gather_conv = k2
    try:
        with torch.no_grad():
            model(points, valid)
    finally:
        sc_mod.gather_conv = kernel
        for h in hooks:
            h.remove()
    return sum(parts.values()), parts


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
    """Raise every BatchNorm bias by BN_BIAS_SHIFT: few ReLU inputs then lie
    near 0, where fp32 rounding can flip a ReLU decision between two
    devices (`ReluDecisions` takes the rest)."""
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


def grad_of(p):
    """p.grad in float64, zeros where the loss does not reach p (a
    two-stage model's heatmap branches: its first stage has no heatmap
    loss)."""
    return (torch.zeros_like(p) if p.grad is None else p.grad).double()


class ReluDecisions:
    """The ReLU decisions (input > 0) of every `nn.ReLU` module of a card
    run, call by call (`record`), replayed into the CPU reference run of
    the same model (`replay`): there each passes x * (the card's
    decision). An input within rounding of 0, whose sign the card's fp32
    sums (their order set by atomics, run to run) can flip, then does not
    decide which gradient flows: one such flip at a GT pixel of a head
    branch moves that branch's BatchNorm weight gradient by per cents of
    its max. `flips` lists each layer where the decisions differ (count,
    and the largest |x| / max |x| of the reference's input there); each
    must lie within RELU_TIE_RTOL of its tie."""

    def __init__(self):
        self.masks, self.flips, self.handles = {}, [], []

    def _hook(self, model, fn):
        for name, m in model.named_modules():
            if isinstance(m, torch.nn.ReLU):
                self.handles.append(m.register_forward_hook(
                    lambda mod, inp, out, name=name: fn(name, inp[0])))

    def record(self, model) -> None:
        self._hook(model, lambda name, x: self.masks.setdefault(
            name, []).append(x.detach() > 0))

    def replay(self, model) -> None:
        def use(name, x):
            calls = self.masks.get(name)
            check(bool(calls), f"ReLU {name}: no card decision to replay")
            want = calls.pop(0).to(x.device)
            check(want.shape == x.shape, f"ReLU {name}: card decisions "
                  f"{tuple(want.shape)}, reference input {tuple(x.shape)}")
            xd = x.detach()
            differ = (xd > 0) != want
            if bool(differ.any()):
                top = float(xd.abs().max())
                self.flips.append({
                    "layer": name, "count": int(differ.sum()),
                    "margin": float(xd.abs()[differ].max()) / top})
            return x * want.to(x.dtype)
        self._hook(model, use)

    def remove(self) -> None:
        for h in self.handles:
            h.remove()
        self.handles = []


def train_cross_check(cfg, dev, clutter, reference=torch.float32):
    """One train step of the same weights and batch on the card and on the
    CPU (plain versions, full width), every BatchNorm bias raised by
    BN_BIAS_SHIFT: emits the phase's line and checks the card against the
    CPU run in `reference` precision, which takes the card's ReLU
    decisions (`ReluDecisions`; the line lists where they differ from its
    own). In float64 the line also gives the CPU's own float32 run against
    it, and the card's against that run.

    A two-stage step (float64 reference) holds each trainable gradient to
    GRAD_FRACTION. Its frozen gradients reach only the grad_norm metric,
    held to NORM_RTOL; each is held to twice the worst distance of the
    CPU's own float32 run from the reference (at least GRAD_FRACTION):
    with no heatmap loss, the neck's frozen BatchNorm gradients are sums
    of 65,536 terms that cancel, and float32 itself lies per cents of
    their max from float64 there."""
    from futuredet_torch.models.detector import build_detector
    from futuredet_torch.train.step import (apply_update, forward_backward,
                                            make_optimizer)
    runs = {"card": (dev, torch.float32), "cpu": ("cpu", torch.float32)}
    if reference == torch.float64:
        runs["cpu64"] = ("cpu", torch.float64)
    ref = "cpu64" if "cpu64" in runs else "cpu"
    relus = ReluDecisions()
    nets = {}
    for where, (d, dtype) in runs.items():
        m = build_detector(cfg, device=d, seed=0).train()
        shift_bn_biases(m)
        if where == "card":
            relus.record(m)
        elif where == ref:
            relus.replay(m)
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
        relus.remove()
    left = {n: len(c) for n, c in relus.masks.items() if c}
    check(not left, f"{cfg.name}: card ReLU calls the reference did not "
          f"make: {left}")
    (mr, lr, _), (mg, lg, card_s) = nets[ref], nets["card"]
    want = {n: grad_of(p) for n, p in mr.named_parameters()}
    grads = {w: {n: grad_of(p).cpu() for n, p in nets[w][0]
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
            "tensors": len(ratios), "relu_flips": relus.flips,
            "relu_tie_rtol": RELU_TIE_RTOL}
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
    gates = {n: GRAD_FRACTION for n in real}
    if cfg.model.two_stage_refine and ref == "cpu64":
        from futuredet_torch.models.two_stage import two_stage_trainable_mask
        mask = two_stage_trainable_mask(mg)
        frozen_gate = max(GRAD_FRACTION,
                          2 * line["cpu32_vs_reference"]["worst_grad_ratio"])
        gates = {n: GRAD_FRACTION if n in mask else frozen_gate
                 for n in real}
        trained = {n: r for n, r in real.items() if n in mask}
        tw = max(trained, key=trained.get)
        line.update(worst_trainable_grad_ratio=trained[tw],
                    worst_trainable_grad_tensor=tw,
                    frozen_grad_gate=frozen_gate)
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
    far = [f for f in relus.flips if f["margin"] > RELU_TIE_RTOL]
    check(not far, f"{cfg.name}: ReLU decisions card vs CPU differ away "
          f"from their ties: {far}")
    over = {n: r for n, r in real.items() if r > gates[n]}
    check(not over, f"{cfg.name}: gradients card vs CPU over their gates "
          f"(of their max): {over}")
    check(param_err <= PARAM_ATOL, f"{cfg.name}: AdamW updates card vs CPU "
          f"{param_err}")


def forward_loss(cfg, model, batch, targets):
    """The loss of `train/step.py::forward_backward` on built targets: the
    head's, plus the RoI head's for a two-stage model."""
    from futuredet_torch.models.losses import center_head_loss
    from futuredet_torch.models.two_stage import two_stage_loss
    out = model(batch["points"], batch["points_valid"], batch.get("bev_map"))
    if not cfg.model.two_stage_refine:
        return center_head_loss(cfg.model.head, out, targets)["loss"]
    preds, det, roi = out
    return (center_head_loss(cfg.model.head, preds, targets)["loss"]
            + two_stage_loss(roi["logits"], roi["resid"], det.boxes,
                             targets["gt_boxes"], targets["gt_valid"],
                             det.valid)["loss"])


class SyncedShare:
    """While entered, the named functions of the given modules are timed
    (host clock, synced before and after each call); `ms` sums per name."""

    def __init__(self, *targets):
        self.targets = targets            # (module, function name)
        self.ms = {name: 0.0 for _, name in targets}

    def __enter__(self):
        self.saved = [(mod, name, getattr(mod, name))
                      for mod, name in self.targets]
        for mod, name, fn in self.saved:
            def timed(*a, _fn=fn, _name=name, **kw):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = _fn(*a, **kw)
                torch.cuda.synchronize()
                self.ms[_name] += (time.perf_counter() - t) * 1e3
                return out
            setattr(mod, name, timed)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def step_times(cfg, model, opt, batch, count):
    """ms per train step (TRAIN_WARMUP warm-ups, median of TRAIN_REPS, host
    clock around synced steps), its split into targets, forward + loss,
    backward and optimizer, and the peak MiB; updates continue from
    `count`. For a two-stage model the split also gives, inside forward +
    loss, the first stage's decode + NMS (K1) and the RoI head's proposal
    targets (the rotated IoU of every proposal against the GT)."""
    from futuredet_torch.data.targets import build_targets_batch
    from futuredet_torch.eval import decode as decode_mod
    from futuredet_torch.models import two_stage as ts_mod
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
    two_stage = cfg.model.two_stage_refine
    if two_stage:
        parts.update(decode_nms=[], proposal_targets=[])
    for r in range(TRAIN_WARMUP + TRAIN_REPS):
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        t = [time.perf_counter()]
        targets = build_targets_batch(cfg, batch["targets_raw"])
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        with SyncedShare((decode_mod, "decode_and_nms"),
                         (ts_mod, "proposal_targets")) as share:
            loss = forward_loss(cfg, model, batch, targets)
            torch.cuda.synchronize()
        t.append(time.perf_counter())
        loss.backward()
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        apply_update(model, opt, n[0])
        n[0] += 1
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        if r >= TRAIN_WARMUP:
            for k, a, z in zip(parts, t, t[1:]):
                parts[k].append((z - a) * 1e3)
            if two_stage:
                parts["decode_nms"].append(share.ms["decode_and_nms"])
                parts["proposal_targets"].append(
                    share.ms["proposal_targets"])
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

        def counted(*args):
            b1, b2 = k1.launches, k2.launches
            out = infer(*args)
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
    return {"k1": total[0], "k2": total[1], "checkpoint_dir": train_dir,
            "mAP": car["mAP"]}


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


# ---------------------------------------------------------------------------
# The real-data phases (21-22): a nuScenes-format dataset written from a seed
# ---------------------------------------------------------------------------

def _quat_z(yaw):
    return [math.cos(yaw / 2), 0.0, 0.0, math.sin(yaw / 2)]


def _rot_z(yaw):
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def _car_surface(rng, n, centre, heading, size):
    """n points on the 4 sides and the top of a car box (global frame)."""
    w, l, h = size
    u = rng.uniform(-0.5, 0.5, (n, 3))
    face = rng.integers(0, 5, n)
    ax = np.where(face < 2, 0, np.where(face < 4, 1, 2))
    side = np.where(ax == 2, 0.5, np.where(face % 2 == 0, -0.5, 0.5))
    u[np.arange(n), ax] = side
    local = u * [l, w, h] + [0.0, 0.0, h / 2]
    return local @ _rot_z(heading).T + centre


def write_nuscenes(root, seed, keyframes, between, points, objects, extent,
                   lead, scenes=NUSC_SCENES):
    """A nuScenes-format v1.0-trainval dataset under `root`, from `seed`:
    the scene, sample, sample_data, ego_pose, calibrated_sensor,
    sample_annotation, instance, category, attribute, log and map (no
    raster) tables, and one LIDAR_TOP .bin of `points` points for each
    sample_data. Each scene (a train name, then a val name of
    data/splits.py) holds `keyframes` keyframes at 2 Hz with `between`
    sweeps at 20 Hz between two of them and `lead` before the first; the
    ego drives at 4-8 m/s on a gentle curve. `objects` cars a keyframe,
    static, linear and nonlinear in turns, stand within `extent` m of the
    ego's start; each sweep holds their surface points (more near the
    sensor) and the lidar clutter of data/synthetic.py in the sensor's
    frame, which moves with the ego. Returns the version."""
    from futuredet_torch.data.synthetic import _lidar_clutter

    rng = np.random.default_rng(seed)
    version = "v1.0-trainval"
    for d in (version, "samples/LIDAR_TOP", "sweeps/LIDAR_TOP"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    cs_t = np.array([0.94, 0.0, 1.84])
    t = {k: [] for k in ("scene", "sample", "sample_data", "ego_pose",
                         "sample_annotation", "instance", "log")}
    t["calibrated_sensor"] = [{"token": "cs_lidar", "sensor_token": "lidar",
                               "translation": cs_t.tolist(),
                               "rotation": [1.0, 0.0, 0.0, 0.0],
                               "camera_intrinsic": []}]
    t["category"] = [{"token": "cat_car", "name": "vehicle.car",
                      "description": ""}]
    t["attribute"] = [{"token": "attr_parked", "name": "vehicle.parked"},
                      {"token": "attr_moving", "name": "vehicle.moving"}]
    t["map"] = [{"token": "map0", "filename": "", "category":
                 "semantic_prior", "log_tokens": []}]
    step = 0.5 / (between + 1)
    for si, name in enumerate(scenes):
        pre = f"s{si}_"
        t["log"].append({"token": pre + "log", "location": "synthetic"})
        t["map"][0]["log_tokens"].append(pre + "log")
        speed, turn = rng.uniform(4, 8), rng.uniform(-0.04, 0.04)

        def ego(tt):
            yaw = turn * tt
            return (np.array([speed * tt, 0.5 * turn * speed * tt ** 2,
                              0.0]), yaw)

        # cars: (kind, start centre, heading, size, speed, turn rate)
        cars = []
        while len(cars) < objects:
            c = np.append(rng.uniform(-0.8 * extent, 0.8 * extent, 2), 0.0)
            if np.hypot(*c[:2]) < 6 or any(
                    np.hypot(*(c - o[1])[:2]) < 7 for o in cars):
                continue
            kind = ("static", "linear", "nonlinear")[len(cars) % 3]
            cars.append((kind, c, rng.uniform(-np.pi, np.pi),
                         (rng.uniform(1.7, 2.1), rng.uniform(4.2, 5.0),
                          rng.uniform(1.5, 1.9)),
                         0.0 if kind == "static" else rng.uniform(3, 9),
                         rng.uniform(0.3, 0.6) * rng.choice([-1, 1])
                         if kind == "nonlinear" else 0.0))

        def car_at(car, tt):
            _, c0, h0, _, v, w = car
            if w == 0.0:
                return c0 + v * tt * np.array([np.cos(h0), np.sin(h0),
                                               0.0]), h0
            h = h0 + w * tt
            return c0 + (v / w) * np.array([np.sin(h) - np.sin(h0),
                                            np.cos(h0) - np.cos(h), 0.0]), h

        n_sd = lead + (keyframes - 1) * (between + 1) + 1
        key_at = {lead + j * (between + 1): j for j in range(keyframes)}
        t0_us = 1_500_000_000_000_000 + si * 10 ** 9
        for k in range(n_sd):
            tt = (k - lead) * step
            sd_tok, pose_tok = f"{pre}sd{k}", f"{pre}pose{k}"
            j = key_at.get(k)
            # a sweep belongs to the next keyframe's sample
            nxt = min((kk for kk in key_at if kk >= k), default=None)
            sample_tok = f"{pre}sample{key_at[nxt]}"
            e_t, e_yaw = ego(tt)
            r_e = _rot_z(e_yaw)
            parts, counts = [], []
            for car in cars:
                c, h = car_at(car, tt)
                rng_m = np.hypot(*(c - e_t)[:2])
                # 300 points at 10 m, 30 at 100 m, in a sweep of 34,720
                n = max(1, int(min(0.0864 * points / max(rng_m, 1.0),
                                   0.00864 * points)))
                parts.append(_car_surface(rng, n, c, h, car[3]))
                counts.append(n)
            obj = np.concatenate(parts, 0)
            obj = (obj - e_t) @ r_e - cs_t          # global -> sensor frame
            clutter = _lidar_clutter(rng, points - len(obj), extent)
            pts = np.concatenate([obj, clutter[:, :3]], 0)
            feats = np.stack([rng.uniform(0, 255, points),
                              rng.integers(0, 32, points)], -1)
            fname = (f"{'samples' if j is not None else 'sweeps'}/"
                     f"LIDAR_TOP/{pre}{k:04d}.bin")
            np.concatenate([pts, feats], -1).astype(np.float32).tofile(
                os.path.join(root, fname))
            stamp = t0_us + int(round((k - lead) * step * 1e6))
            t["ego_pose"].append({"token": pose_tok, "timestamp": stamp,
                                  "translation": e_t.tolist(),
                                  "rotation": _quat_z(e_yaw)})
            t["sample_data"].append({
                "token": sd_tok, "sample_token": sample_tok,
                "ego_pose_token": pose_tok,
                "calibrated_sensor_token": "cs_lidar", "timestamp": stamp,
                "fileformat": "pcd", "is_key_frame": j is not None,
                "height": 0, "width": 0, "filename": fname,
                "prev": f"{pre}sd{k - 1}" if k else "",
                "next": f"{pre}sd{k + 1}" if k + 1 < n_sd else ""})
            if j is None:
                continue
            anns = []
            for o, car in enumerate(cars):
                c, h = car_at(car, tt)
                tok = f"{pre}ann{j}_{o}"
                anns.append(tok)
                t["sample_annotation"].append({
                    "token": tok, "sample_token": sample_tok,
                    "instance_token": f"{pre}inst{o}",
                    "translation": (c + [0.0, 0.0, car[3][2] / 2]).tolist(),
                    "size": list(car[3]), "rotation": _quat_z(h),
                    "prev": f"{pre}ann{j - 1}_{o}" if j else "",
                    "next": f"{pre}ann{j + 1}_{o}"
                    if j + 1 < keyframes else "",
                    "num_lidar_pts": counts[o], "num_radar_pts": 0,
                    "visibility_token": "4",
                    "attribute_tokens": ["attr_parked" if car[0] == "static"
                                         else "attr_moving"]})
            t["sample"].append({
                "token": sample_tok, "scene_token": pre + "scene",
                "timestamp": stamp,
                "prev": f"{pre}sample{j - 1}" if j else "",
                "next": f"{pre}sample{j + 1}" if j + 1 < keyframes else "",
                "data": {"LIDAR_TOP": sd_tok}, "anns": anns})
        for o in range(objects):
            t["instance"].append({
                "token": f"{pre}inst{o}", "category_token": "cat_car",
                "nbr_annotations": keyframes,
                "first_annotation_token": f"{pre}ann0_{o}",
                "last_annotation_token": f"{pre}ann{keyframes - 1}_{o}"})
        t["scene"].append({
            "token": pre + "scene", "name": name, "description": "",
            "log_token": pre + "log", "nbr_samples": keyframes,
            "first_sample_token": f"{pre}sample0",
            "last_sample_token": f"{pre}sample{keyframes - 1}"})
    for name, rows in t.items():
        with open(os.path.join(root, version, f"{name}.json"), "w") as f:
            json.dump(rows, f)
    return version


class StepCounts:
    """A trainer hook: the K1, K2 forward and K2 dx launches of each step
    (the counts zeroed just before it and read just after it, synced), its
    metrics, voxels a sample, and the host clock: the wait for the batch
    (from the previous step's end) and the step itself."""

    def __init__(self):
        from futuredet_torch.ops import pallas_gather, pallas_nms
        from futuredet_torch.ops import sparse_conv as sc_mod
        self.k1, self.k2 = pallas_nms.rotate_nms_alive, \
            pallas_gather.gather_conv
        self.sc, self.dx_fn = sc_mod, sc_mod.subm_conv_dx
        self.dx = 0
        self.steps = []
        self.t_end = None

    def __enter__(self):
        def counting_dx(*args):
            before = self.k2.launches
            out = self.dx_fn(*args)
            self.dx += self.k2.launches - before
            return out
        self.sc.subm_conv_dx = counting_dx
        return self

    def __exit__(self, *exc):
        self.sc.subm_conv_dx = self.dx_fn

    def before_step(self, step, state, batch):
        self.t_begin = time.perf_counter()
        self.k1.launches = self.k2.launches = self.dx = 0

    def after_step(self, step, state, metrics):
        torch.cuda.synchronize()
        t = time.perf_counter()
        m = {k: v.detach().cpu() for k, v in metrics.items()}
        self.steps.append({
            "step": step, "k2_forward": self.k2.launches - self.dx,
            "k2_dx": self.dx, "k1": self.k1.launches,
            "loss": float(m["loss"]),
            "finite": all(bool(torch.isfinite(v).all())
                          for v in m.values()),
            "voxels": list(getattr(state.model, "num_voxels", [])),
            "data_wait_ms": None if self.t_end is None
            else (self.t_begin - self.t_end) * 1e3,
            "step_ms": (t - self.t_begin) * 1e3})
        self.t_end = t

    def after_epoch(self, epoch, state):
        pass

    def after_train(self, state):
        pass


def run_train_cli(argv, hook):
    """futuredet_torch.cli.train.main(argv) with `hook` added to the
    trainer's. Returns (state, the log, seconds)."""
    from futuredet_torch.train import trainer
    real = trainer.train

    def with_hook(*a, **kw):
        kw["hooks"] = list(kw.get("hooks") or []) + [hook]
        return real(*a, **kw)

    from futuredet_torch.cli import train
    trainer.train = with_hook
    try:
        t0 = time.perf_counter()
        with LogCapture() as logs, hook:
            state = train.main(argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        trainer.train = real
    return state, logs.lines, secs


def nusc_create_data(card, root):
    """Phase 21.1: the dataset, then create_data with the GT database.
    Returns the train and val infos and the dbinfos pkl."""
    import pickle

    from futuredet_torch.cli import create_data

    t0 = time.perf_counter()
    version = write_nuscenes(root, NUSC_SEED, NUSC_KEYFRAMES,
                             NUSC_SWEEPS_BETWEEN, NUSC_SWEEP_POINTS,
                             NUSC_OBJECTS, NUSC_EXTENT, NUSC_NSWEEPS - 1)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    train_pkl, val_pkl = create_data.main([
        "nuscenes_data_prep", "--root_path", root, "--version", version,
        "--nsweeps", str(NUSC_NSWEEPS), "--gt_database", "--model",
        VOX_NAME])
    prep_s = time.perf_counter() - t0
    db_pkl = os.path.join(root, f"dbinfos_train_{NUSC_NSWEEPS}sweeps_"
                                "withvelo.pkl")
    n = {}
    for key, p in (("train", train_pkl), ("val", val_pkl), ("db", db_pkl)):
        with open(p, "rb") as f:
            obj = pickle.load(f)
        n[key] = sum(len(v) for v in obj.values()) if key == "db" \
            else len(obj)
    files = [f for d in ("samples", "sweeps")
             for f in os.listdir(os.path.join(root, d, "LIDAR_TOP"))]
    emit({"phase": "nusc_create_data", "card": card,
          "dataset": {"scenes": list(NUSC_SCENES),
                      "keyframes_per_scene": NUSC_KEYFRAMES,
                      "sweeps_between_keyframes": NUSC_SWEEPS_BETWEEN,
                      "points_per_sweep": NUSC_SWEEP_POINTS,
                      "cars_per_keyframe": NUSC_OBJECTS,
                      "lidar_files": len(files), "seed": NUSC_SEED},
          "write_s": round(write_s, 3), "create_data_s": round(prep_s, 3),
          "infos_train": n["train"], "infos_val": n["val"],
          "db_objects": n["db"]})
    check(n["train"] == n["val"] == NUSC_KEYFRAMES,
          f"create_data wrote {n['train']} train and {n['val']} val infos")
    check(n["db"] > 0, "the GT database holds no object")
    return train_pkl, val_pkl, db_pkl


def nusc_train_cli(dev, card, model, train_pkl, db_pkl, work):
    """Phase 21.2: cli.train on the train infos, GT-AUG from the dbinfos,
    one epoch at B = 1, TensorBoard where it imports; launches counted per
    step. Returns the hook's steps."""
    from futuredet_torch.config import get_config

    try:
        import torch.utils.tensorboard  # noqa: F401
        tb = True
    except ImportError:
        tb = False
    hook = StepCounts()
    state, logs, secs = run_train_cli(
        ["--model", model, "--device", str(dev), "--info_path", train_pkl,
         "--db_info_path", db_pkl, "--epochs", "1", "--batch_size", "1",
         "--work_dir", work] + (["--tensorboard"] if tb else []), hook)
    steps = hook.steps
    want = (20, 19, 0) if model == VOX_NAME else (0, 0, 0)
    for rec in steps:
        check((rec["k2_forward"], rec["k2_dx"], rec["k1"]) == want,
              f"{model} real-data train step {rec['step']}: K2 "
              f"{rec['k2_forward']} forward + {rec['k2_dx']} dx, K1 "
              f"{rec['k1']} (want {want})")
        check(rec["finite"], f"{model} train step {rec['step']}: metric "
              "not finite")
    check(state.step == len(steps) == NUSC_KEYFRAMES,
          f"{model}: {state.step} steps, {len(steps)} counted")
    check(f"step_{state.step}.pt" in os.listdir(work),
          f"{model}: no checkpoint in {os.listdir(work)}")
    check(any("GT-AUG enabled" in ln for ln in logs), "GT-AUG is off")
    tb_files = sorted(os.listdir(os.path.join(work, "tb"))) if tb else []
    check(not tb or tb_files, "--tensorboard wrote no event file")
    budget = get_config(model).voxel.max_voxels_train
    voxels = [v for rec in steps for v in rec["voxels"]]
    emit({"phase": "nusc_train_cli", "model": model, "card": card,
          "steps": state.step, "train_s": round(secs, 3),
          "tensorboard": tb_files if tb else "not importable",
          "launches_per_step": [(r["k2_forward"], r["k2_dx"], r["k1"])
                                for r in steps],
          "losses": [r["loss"] for r in steps],
          "voxels_per_sample": voxels,
          "samples_at_max_voxels_train": sum(v >= budget for v in voxels),
          "max_voxels_train": budget,
          "data_wait_ms": [r["data_wait_ms"] for r in steps],
          "step_ms": [r["step_ms"] for r in steps],
          "budget_warning": [ln for ln in logs if "budget" in ln]})
    return steps


def nusc_host_times(card, train_pkl, db_pkl):
    """Phase 21.3: one sample's host pipeline in parts, median of
    NUSC_HOST_REPS, on the CLI's train dataset."""
    from futuredet_torch.config import get_config
    from futuredet_torch.data import pipeline
    from futuredet_torch.data.augment import apply_train_augmentations
    from futuredet_torch.data.gt_database import build_db_sampler

    cfg = get_config(VOX_NAME)
    ds = pipeline.NuScenesForecastDataset(
        cfg, train_pkl, train=True, seed=0,
        db_sampler=build_db_sampler(cfg, train_pkl, db_pkl, seed=0))
    info = ds.infos[0]
    rng = np.random.default_rng(0)
    parts = {}

    def timed(name, fn):
        ts = []
        for _ in range(NUSC_HOST_REPS):
            t0 = time.perf_counter()
            out = fn()
            ts.append((time.perf_counter() - t0) * 1e3)
        parts[name] = statistics.median(ts)
        return out

    pts = timed("native_sweep_load", lambda: pipeline.aggregate_sweeps(
        info, cfg.data.nsweeps))
    gt, cls, valid, traj, _ = pipeline.pack_gt(
        cfg, info["gt_boxes"], info["gt_names"], info["gt_trajectory"],
        cfg.data.class_names)
    n0 = int(valid[0].sum())
    sampled = timed("gt_aug_sample_all",
                    lambda: ds.db_sampler.sample_all(gt[0, :n0]))
    pasted = np.concatenate([sampled["points"][:, :pts.shape[1]], pts], 0)
    d = cfg.data
    timed("augmentations", lambda: apply_train_augmentations(
        gt, pasted, rng, rot_noise=d.global_rot_noise,
        scale_noise=d.global_scale_noise,
        translate_std=d.global_translate_std))

    def shuffle_pack():
        p = pasted
        if d.shuffle_points and len(p) <= cfg.voxel.max_points:
            p = p[rng.permutation(len(p))]
        return pipeline.pack_points(p, cfg.voxel.max_points, rng)

    packed, pvalid = timed("shuffle_and_pack", shuffle_pack)
    timed("whole_sample", lambda: ds.sample(0))
    emit({"phase": "nusc_host_times", "card": card, "host_ms": parts,
          "reps": NUSC_HOST_REPS, "points_aggregated": len(pts),
          "points_pasted": len(sampled["points"]),
          "points_after_pack": int(pvalid.sum()),
          "max_points": cfg.voxel.max_points,
          "objects_pasted": len(sampled["gt_names"])})
    return parts


def cuda_profiler():
    """torch.profiler over the card's activity alone (no host events)."""
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CUDA])


def nusc_prefetch_turns(dev, card, train_pkl, db_pkl):
    """Phase 21.4: the trainer on the CLI's real-data batches with
    prefetch_depth 2 and 0 in turns, NUSC_TURN_STEPS steps each, every
    step synced: the wait for data and the step on the host clock, and
    the card's busy share (its kernels' time under torch.profiler over
    the wall of steps 1 on)."""
    import dataclasses

    from futuredet_torch.cli import train as train_cli
    from futuredet_torch.config import get_config
    from futuredet_torch.train import trainer

    cfg = get_config(VOX_NAME)
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, total_epochs=1, log_interval=NUSC_TURN_STEPS))
    args = train_cli.parse_args(["--model", VOX_NAME, "--info_path",
                                 train_pkl, "--db_info_path", db_pkl])
    turns = {2: [], 0: []}
    for depth in (2, 0, 2, 0):
        cfg_d, batches, _ = train_cli.info_batches(cfg, args, 1,
                                                   pin_memory=True)
        hook = StepCounts()
        prof = cuda_profiler()
        real_before = hook.before_step

        def before(step, state, batch, real_before=real_before, prof=prof,
                   hook=hook):
            if step == 1:
                torch.cuda.synchronize()
                hook.t_prof = time.perf_counter()
                prof.start()
            real_before(step, state, batch)

        hook.before_step = before
        with hook:
            trainer.train(cfg_d, batches, steps_per_epoch=NUSC_TURN_STEPS,
                          hooks=[hook], device=dev, prefetch_depth=depth)
        torch.cuda.synchronize()
        wall = time.perf_counter() - hook.t_prof
        prof.stop()
        busy_us = sum(getattr(e, "device_time_total", 0.0)
                      or getattr(e, "cuda_time_total", 0.0)
                      for e in prof.key_averages()
                      if str(getattr(e, "device_type", "")).endswith("CUDA"))
        turns[depth].append({
            "data_wait_ms": [r["data_wait_ms"] for r in hook.steps[1:]],
            "step_ms": [r["step_ms"] for r in hook.steps[1:]],
            "busy_share": busy_us / 1e6 / wall})
    out = {}
    for depth, runs in turns.items():
        waits = [w for r in runs for w in r["data_wait_ms"]]
        steps = [s for r in runs for s in r["step_ms"]]
        out[f"prefetch_depth_{depth}"] = {
            "data_wait_ms_median": statistics.median(waits),
            "step_ms_median": statistics.median(steps),
            "period_ms_median": statistics.median(
                w + s for w, s in zip(waits, steps)),
            "wait_share": statistics.median(waits) / (
                statistics.median(waits) + statistics.median(steps)),
            "busy_share_per_turn": [r["busy_share"] for r in runs],
            "data_wait_ms": waits, "step_ms": steps}
    # the prefetch thread's host work runs beside the step's launches:
    # what it adds to the step itself
    step_inflation = (out["prefetch_depth_2"]["step_ms_median"]
                      - out["prefetch_depth_0"]["step_ms_median"])
    emit({"phase": "nusc_prefetch", "model": VOX_NAME, "card": card,
          "steps_per_turn": NUSC_TURN_STEPS,
          "turns": "depth 2, 0, 2, 0; step 0 of each not counted",
          "step_ms_added_by_the_thread": step_inflation, **out})
    return out


def nusc_eval_cli(dev, card, model, val_pkl, ckpt_dir):
    """Phase 22.1: cli.evaluate on the val infos from phase 21's
    checkpoint, with --speed_test. Returns the launches."""
    summary, per_call, total, logs, secs = run_evaluate(eval_args(
        dev, model, f"metrics_{model}_nusc", "--info_path", val_pkl,
        "--checkpoint_dir", ckpt_dir, "--cohort_analysis", "--speed_test"))
    want = (1, 20) if model == VOX_NAME else (1, 0)
    check(per_call == [want] * NUSC_KEYFRAMES,
          f"{model} real-data eval: (K1, K2) launches {per_call}")
    check(any(f"restored checkpoint step {NUSC_KEYFRAMES}" in ln
              for ln in logs), f"{model}: phase 21's checkpoint not restored")
    check_summary(summary, f"{model} real-data eval")
    check(os.path.exists(metrics_path(f"metrics_{model}_nusc")),
          "no metrics JSON")
    speed = [ln for ln in logs if ln.startswith("speed test:")]
    check(len(speed) == 1, f"{speed}")
    emit({"phase": "nusc_eval_cli", "model": model, "card": card,
          "samples": len(per_call), "launches_per_sample": per_call,
          "eval_s": round(secs, 3), "speed_test": speed[0],
          "voxel_budget": [ln for ln in logs if ln.startswith("voxel")],
          "cohorts": {c: headline(summary, c)
                      for c in summary["mean_dist_aps"]}})
    return {"k1": total[0], "k2": total[1]}


def nusc_checks(dev, card, train_pkl, val_pkl, db_pkl, ckpts):
    """Phase 22.2-5: one val sample card against CPU for each model, the
    same train info sampled twice, the native sweep loader against the
    numpy reader on a full keyframe, and a pinned batch's copy on the card
    against its pageable copy."""
    import pickle

    from futuredet_torch.config import get_config
    from futuredet_torch.data import pipeline
    from futuredet_torch.data.gt_database import build_db_sampler
    from futuredet_torch.eval.decode import decode_and_nms
    from futuredet_torch.models.detector import build_detector
    from futuredet_torch.train.checkpoints import CheckpointManager

    out = {}
    # 2. card against CPU, one val sample, the phase-21 weights
    for model, ckpt in ckpts.items():
        cfg, ds = pipeline.info_dataset(get_config(model), val_pkl,
                                        train=False)
        b = next(pipeline.batches_from_dataset(ds, cfg, 1, shuffle=False,
                                               loop=False))
        runs = {}
        for d in (dev, torch.device("cpu")):
            m = build_detector(cfg, device=d, seed=0)
            CheckpointManager(ckpt).restore(m)
            m.eval()
            with torch.no_grad():
                preds = m(b["points"].to(d), b["points_valid"].to(d))
                runs[d.type] = (preds, decode_and_nms(cfg, preds))
        hm_err = max(float((torch.sigmoid(g["hm"]).cpu()
                            - torch.sigmoid(c["hm"])).abs().max())
                     for g, c in zip(runs[dev.type][0], runs["cpu"][0]))
        check(hm_err <= HM_ATOL, f"{model} real data: heatmap card vs CPU "
              f"{hm_err}")
        n_card, n_cpu, let_off = check_detections_match(
            cfg, runs[dev.type][1], runs["cpu"][1], hm_err)
        out[model] = {"hm_max_abs_err": hm_err, "hm_atol": HM_ATOL,
                      "detections_card": n_card, "detections_cpu": n_cpu,
                      "let_off_at_the_cut": let_off}
    # 3. the same info sampled twice: two datasets from the same seeds
    cfg = get_config(VOX_NAME)
    samples = [pipeline.NuScenesForecastDataset(
        cfg, train_pkl, train=True, seed=0,
        db_sampler=build_db_sampler(cfg, train_pkl, db_pkl, seed=0)
    ).sample(0) for _ in range(2)]
    same = all(np.array_equal(samples[0][k], samples[1][k])
               for k in samples[0] if isinstance(samples[0][k], np.ndarray))
    check(same, "the same info sampled twice differs")
    # 4. the native sweep loader against the numpy reader
    with open(val_pkl, "rb") as f:
        info = pickle.load(f)[NUSC_KEYFRAMES - 1]
    t0 = time.perf_counter()
    nat = pipeline.aggregate_sweeps(info, NUSC_NSWEEPS)
    nat_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    ref = pipeline.aggregate_sweeps(info, NUSC_NSWEEPS, use_native=False)
    ref_ms = (time.perf_counter() - t0) * 1e3
    check(nat.shape == ref.shape and np.array_equal(nat, ref),
          f"native sweeps {nat.shape} differ from numpy's {ref.shape}")
    # 5. a pinned batch on the card against its pageable copy
    ds_pin, ds_page = (pipeline.NuScenesForecastDataset(
        cfg, val_pkl, train=False, class_balanced=False) for _ in range(2))
    pinned = next(pipeline.batches_from_dataset(ds_pin, cfg, 1,
                                                shuffle=False, loop=False,
                                                pin_memory=True))
    page = next(pipeline.batches_from_dataset(ds_page, cfg, 1,
                                              shuffle=False, loop=False))
    leaves = [("points",), ("points_valid",)] + [
        ("targets_raw", k) for k in pinned["targets_raw"]]

    def get(b, path):
        for k in path:
            b = b[k]
        return b

    check(all(get(pinned, p).is_pinned() for p in leaves),
          "a batch of pin_memory=True holds a pageable tensor")
    on_card = [get(pinned, p).to(dev, non_blocking=True) for p in leaves]
    ref_card = [get(page, p).to(dev) for p in leaves]
    torch.cuda.synchronize()
    check(all(torch.equal(a, r) for a, r in zip(on_card, ref_card)),
          "a pinned batch's copy differs from the pageable one")
    emit({"phase": "nusc_checks", "card": card, "card_vs_cpu": out,
          "same_info_twice_identical": same,
          "native_vs_numpy_identical": True, "keyframe_points": len(nat),
          "native_ms": nat_ms, "numpy_ms": ref_ms,
          "pinned_vs_pageable_identical": True,
          "pinned_tensors": len(leaves)})


def nusc_path(dev, card, work):
    """Phases 21-22. Returns the launches of each real-data path."""
    root = os.path.join(work, "nuscenes")
    train_pkl, val_pkl, db_pkl = nusc_create_data(card, root)
    ckpts, launches = {}, {}
    for model in (VOX_NAME, NAME):
        ckpts[model] = os.path.join(work, f"nusc_{model}")
        steps = nusc_train_cli(dev, card, model, train_pkl, db_pkl,
                               ckpts[model])
        launches[f"{model}_nusc_train"] = {
            "k1": sum(r["k1"] for r in steps),
            "k2": sum(r["k2_forward"] + r["k2_dx"] for r in steps)}
    nusc_host_times(card, train_pkl, db_pkl)
    nusc_prefetch_turns(dev, card, train_pkl, db_pkl)
    for model in (VOX_NAME, NAME):
        launches[f"{model}_nusc_eval"] = nusc_eval_cli(
            dev, card, model, val_pkl, ckpts[model])
    nusc_checks(dev, card, train_pkl, val_pkl, db_pkl, ckpts)
    return launches


def head_mode_config(name, flag=None):
    """The named config at full width, with the head flag `flag` set; a
    pillar config takes phase 2's 150k-point buffer and voxel budget."""
    import dataclasses

    from futuredet_torch.config import get_config
    cfg = get_config(name)
    if flag:
        cfg = cfg.replace(name=f"{name}+{flag}", model=dataclasses.replace(
            cfg.model, head=dataclasses.replace(cfg.model.head,
                                                **{flag: True})))
    if cfg.model.detector == "pointpillars":
        cfg = cfg.replace(voxel=dataclasses.replace(
            cfg.voxel, max_points=MAX_POINTS, max_voxels_eval=30000))
    return cfg


def head_mode_scene(cfg):
    """Phase 4's uniform scene for a pillar config, phase 8's
    uniform_blobs scene for a VoxelNet one, and for a bev_map config the
    `rasterize_scene_map` of a lidar-family scene of the same config (a
    map of road corridors, not symmetric): (points, valid, map or None)
    as numpy."""
    from futuredet_torch.data.synthetic import (make_family_scene,
                                                rasterize_scene_map)
    rng = np.random.default_rng(0)
    pts, valid = (scene_uniform(cfg, rng)
                  if cfg.model.detector == "pointpillars"
                  else scene_blobs(cfg, rng))
    bev = None
    if cfg.model.head.bev_map:
        bev = rasterize_scene_map(
            cfg, make_family_scene(cfg, "lidar", n_clutter=100,
                                   seed=HEAD_MODE_MAP_SEED))[None, ..., None]
    return pts, valid, bev


def first_pseudo_task(cfg, det):
    """A timesteps == 1 standard head replicates its one vel map into
    target_timesteps identical pseudo-tasks: the card's copies must be
    equal, label apart; returns the first one's slots."""
    from futuredet_torch.eval.decode import Detections
    post = cfg.test.nms.post_max_size
    T = det.valid.shape[1] // post
    for f in ("boxes", "scores", "valid"):
        x = getattr(det, f).reshape(det.valid.shape[0], T, post, -1)
        check(bool((x == x[:, :1]).all()),
              f"{cfg.name}: replicated pseudo-tasks differ in {f}")
    return Detections(*(x[:, :post] for x in det))


def head_modes_path(dev, card):
    """Phase 23. Returns per head mode {"k1", "k2", "g"}."""
    from futuredet_torch.eval.decode import decode_and_nms
    from futuredet_torch.models.center_head import CenterHead
    from futuredet_torch.models.detector import build_detector
    from futuredet_torch.ops import nms as nms_mod
    from futuredet_torch.ops import pallas_gather

    k1, k2 = nms_mod.rotate_nms_alive, pallas_gather.gather_conv
    problems = []

    def recorder(b, v, thr):
        problems.append(b.shape[0])
        return k1(b, v, thr)

    out = {}
    for name, flag in HEAD_MODES:
        cfg = head_mode_config(name, flag)
        h = cfg.model.head
        model = build_detector(cfg, device=dev, seed=0)
        pts, valid, bev = head_mode_scene(cfg)
        inputs = [torch.from_numpy(pts).to(dev),
                  torch.from_numpy(valid).to(dev),
                  None if bev is None else torch.from_numpy(bev).to(dev)]

        def run(m=model, args=inputs):
            with torch.no_grad():
                preds = m(*args)
                return preds, decode_and_nms(cfg, preds)

        # counts zeroed just before the main-path call, read just after
        problems.clear()
        nms_mod.rotate_nms_alive = recorder
        try:
            k1.launches = k2.launches = 0
            preds, det = run()
            torch.cuda.synchronize()
            n1, n2 = k1.launches, k2.launches
        finally:
            nms_mod.rotate_nms_alive = k1
        multitask = h.multitask
        pseudo = (len(h.tasks) if multitask else 2 * h.timesteps
                  if h.sparse else h.target_timesteps)
        W, H = cfg.feature_map_size
        check(n1 == 1 and problems == [pseudo],
              f"{cfg.name}: K1 launched {n1} times on {problems} problems")
        check(n2 == (20 if cfg.model.detector == "voxelnet" else 0),
              f"{cfg.name}: K2 launched {n2} times")
        check(len(preds) == len(h.num_classes), f"{cfg.name}: tasks")
        for pd, heads in zip(preds, CenterHead.task_heads(h)):
            for k, (ch, _) in heads:
                check(tuple(pd[k].shape) == (1, H, W, ch),
                      f"{cfg.name} {k} shape {tuple(pd[k].shape)}")
                check(bool(torch.isfinite(pd[k]).all()),
                      f"{cfg.name} {k} not finite")
        post = cfg.test.nms.post_max_size
        check(det.boxes.shape == (1, pseudo * post, 9), det.boxes.shape)
        check(bool(torch.isfinite(det.boxes).all()
                   and torch.isfinite(det.scores).all()),
              f"{cfg.name} detections not finite")
        torch.cuda.reset_peak_memory_stats()
        ms = time_host(run, HEAD_MODE_WARMUP, HEAD_MODE_REPS)
        peak = torch.cuda.max_memory_allocated() / 2**20
        line = {"phase": "head_modes", "model": cfg.name, "card": card,
                "detector": cfg.model.detector,
                "scene": ("uniform" if cfg.model.detector == "pointpillars"
                          else "uniform_blobs"),
                "bev_map": bev is not None, "ms_per_scene": ms,
                "peak_mib": peak, "k1_launches": n1, "k1_problems_g": pseudo,
                "k2_launches": n2,
                "detections_per_pseudo_task": det.valid.reshape(
                    pseudo, post).sum(-1).tolist(),
                "hm_max": max(float(torch.sigmoid(p["hm"]).max())
                              for p in preds),
                "warmup": HEAD_MODE_WARMUP, "reps": HEAD_MODE_REPS}
        if flag is None or flag == "dcn_head":
            # the named configs (and DCN): the same weights on the CPU
            t0 = time.perf_counter()
            cpu_model = build_detector(cfg, device="cpu", seed=0)
            cpu_preds, cpu_det = run(cpu_model, [
                torch.from_numpy(pts), torch.from_numpy(valid),
                None if bev is None else torch.from_numpy(bev)])
            line["cpu_s"] = round(time.perf_counter() - t0, 3)
            hm_err = max(float((torch.sigmoid(g["hm"]).cpu()
                                - torch.sigmoid(c["hm"])).abs().max())
                         for g, c in zip(preds, cpu_preds))
            check(hm_err <= HM_ATOL, f"{cfg.name}: heatmap card vs CPU "
                  f"{hm_err}")
            gd, cd = det, cpu_det
            if not multitask and h.standard and h.timesteps == 1:
                gd, cd = first_pseudo_task(cfg, det), first_pseudo_task(
                    cfg, cpu_det)
            n_card, n_cpu, let_off = check_detections_match(cfg, gd, cd,
                                                            hm_err)
            line.update(hm_max_abs_err=hm_err, hm_atol=HM_ATOL,
                        detections_card=n_card, detections_cpu=n_cpu,
                        let_off_at_the_cut=let_off)
            del cpu_model
        emit(line)
        out[cfg.name] = {"k1": n1, "k2": n2, "g": pseudo}
        del model
    return out


def head_modes_train_path(dev, card):
    """Phase 24. Returns per config {"k1", "k2_forward", "k2_dx"} of the
    main-path step."""
    from futuredet_torch.config import get_config
    from futuredet_torch.models.detector import build_detector
    from futuredet_torch.ops import pallas_gather, pallas_nms
    from futuredet_torch.ops import sparse_conv as sc_mod
    from futuredet_torch.train.step import make_optimizer, train_step

    k1, k2 = pallas_nms.rotate_nms_alive, pallas_gather.gather_conv
    dx_fn, dx = sc_mod.subm_conv_dx, [0]

    def counting_dx(*args):
        before = k2.launches
        res = dx_fn(*args)
        dx[0] += k2.launches - before
        return res

    out = {}
    for name in HEAD_MODES_TRAIN:
        cfg = get_config(name)
        batch = train_batch(cfg, TRAIN_SEED, dev, TRAIN_CLUTTER)
        model = build_detector(cfg, device=dev, seed=0).train()
        opt = make_optimizer(cfg, model, HEAD_MODE_WARMUP
                             + HEAD_MODE_REPS + 1)
        n = [0]

        def one_step():
            m = train_step(model, opt, batch, n[0])
            n[0] += 1
            return m

        sc_mod.subm_conv_dx = counting_dx
        try:
            # counts zeroed just before the first step, read just after
            k1.launches = k2.launches = dx[0] = 0
            metrics = one_step()
            torch.cuda.synchronize()
            counts = {"k1": k1.launches, "k2_forward": k2.launches - dx[0],
                      "k2_dx": dx[0]}
        finally:
            sc_mod.subm_conv_dx = dx_fn
        m = {k: v.detach().cpu() for k, v in metrics.items()}
        check(all(bool(torch.isfinite(v).all()) for v in m.values()),
              f"{name}: train metrics not finite {m}")
        check(counts == {"k1": 0, "k2_forward": 20, "k2_dx": 19},
              f"{name}: train step launches {counts}")
        torch.cuda.reset_peak_memory_stats()
        ms = time_host(one_step, HEAD_MODE_WARMUP, HEAD_MODE_REPS)
        peak = torch.cuda.max_memory_allocated() / 2**20
        emit({"phase": "head_modes_train", "model": name, "card": card,
              "scene": f"lidar family, seed {TRAIN_SEED}",
              "voxels": list(model.num_voxels), "ms_per_step": ms,
              "peak_mib": peak, **counts, "loss": float(m["loss"]),
              "hm_loss": m["hm_loss"].tolist(),
              "grad_norm": float(m["grad_norm"]),
              "warmup": HEAD_MODE_WARMUP, "reps": HEAD_MODE_REPS})
        out[name] = counts
        del model, opt
    # one multitask step card against the CPU, to phase 12's limits
    train_cross_check(get_config("centerpoint_multitask"), dev,
                      TRAIN_CLUTTER)
    return out


def head_modes_cli_path(dev, card):
    """Phase 25. Returns per run {"k1", "k2"}."""
    out = {}
    for name, extra in HEAD_MODES_CLI:
        tag = f"{name}_head_mode_eval"
        argv = ["--model", name, "--device", str(dev), "--synthetic",
                str(HEAD_MODE_CLI_SCENES), "--checkpoint_dir",
                os.path.join(OUT_DIR, "no_checkpoint"), "--out",
                metrics_path(tag), *extra]
        summary, per_call, total, logs, secs = run_evaluate(argv)
        check_summary(summary, tag)
        classes = list(summary["mean_dist_aps"])
        check(per_call and all(c == per_call[0] for c in per_call),
              f"{tag}: launches per call {per_call}")
        n1, n2 = per_call[0]
        check(n1 == 1 and n2 == 20, f"{tag}: K1 {n1}, K2 {n2} a scene")
        check(os.path.exists(metrics_path(tag)) and os.path.exists(
            metrics_path(tag)[:-5] + ".csv"), f"{tag}: metrics not written")
        if "--forecast_mode" not in extra:
            from futuredet_torch.config import get_config
            check(classes == list(get_config(name).data.class_names),
                  f"{tag}: classes {classes}")
        emit({"phase": "head_modes_cli", "model": name, "card": card,
              "argv": argv[:2] + extra, "scenes": len(per_call),
              "k1_per_scene": n1, "k2_per_scene": n2, "seconds":
              round(secs, 3), "classes": classes,
              "mAP": {c: summary["mean_dist_aps"][c] for c in classes},
              "metrics": os.path.relpath(metrics_path(tag), ROOT)})
        out[tag] = {"k1": total[0], "k2": total[1]}
    return out


def matched_proposals(cfg, gdet, cdet):
    """(card slot, CPU slot) pairs of one sample: per pseudo-task, each
    valid card proposal and the valid CPU proposal whose centre lies within
    PROPOSAL_MATCH_M of it."""
    post = cfg.test.nms.post_max_size
    gv, cv = gdet.valid[0].cpu().numpy(), cdet.valid[0].numpy()
    gb, cb = gdet.boxes[0].cpu().numpy(), cdet.boxes[0].numpy()
    pairs = []
    for t in range(len(gv) // post):
        sl = np.arange(t * post, (t + 1) * post)
        cand = sl[cv[sl]]
        for i in sl[gv[sl]]:
            if len(cand):
                d = np.abs(cb[cand, :2] - gb[i, :2]).max(-1)
                j = int(np.argmin(d))
                if d[j] <= PROPOSAL_MATCH_M:
                    pairs.append((int(i), int(cand[j])))
    return pairs


def two_stage_path(dev, card):
    """Phase 26. Returns per two-stage config {"k1", "k2", "g"}."""
    from futuredet_torch.eval.decode import decode_and_nms
    from futuredet_torch.models.detector import build_detector
    from futuredet_torch.models.two_stage import refined_detections
    from futuredet_torch.ops import nms as nms_mod
    from futuredet_torch.ops import pallas_gather

    k1, k2 = nms_mod.rotate_nms_alive, pallas_gather.gather_conv
    problems = []

    def recorder(b, v, thr):
        problems.append(b.shape[0])
        return k1(b, v, thr)

    out = {}
    for name, single in TWO_STAGE_NAMES:
        cfg, scfg = head_mode_config(name), head_mode_config(single)
        vox = cfg.model.detector == "voxelnet"
        pts, valid, _ = head_mode_scene(cfg)
        inputs = [torch.from_numpy(pts).to(dev),
                  torch.from_numpy(valid).to(dev)]
        model = build_detector(cfg, device=dev, seed=0)

        def run(m=model, args=inputs):
            with torch.no_grad():
                return m(*args)

        # counts zeroed just before the main-path call, read just after
        problems.clear()
        nms_mod.rotate_nms_alive = recorder
        try:
            k1.launches = k2.launches = 0
            preds, det, roi = run()
            torch.cuda.synchronize()
            n1, n2 = k1.launches, k2.launches
        finally:
            nms_mod.rotate_nms_alive = k1
        pseudo = cfg.model.head.target_timesteps
        check(n1 == 1 and problems == [pseudo],
              f"{name}: K1 launched {n1} times on {problems} problems")
        check(n2 == (20 if vox else 0), f"{name}: K2 launched {n2} times")
        ref = refined_detections(det, roi)
        check(bool(torch.isfinite(ref.boxes).all()
                   and torch.isfinite(ref.scores).all()),
              f"{name}: refined detections not finite")
        check(not ref.scores[~det.valid].any()
              and bool((ref.scores[det.valid] > 0).all()),
              f"{name}: fused scores not 0 exactly where a proposal is "
              "invalid")
        torch.cuda.reset_peak_memory_stats()
        ms = time_host(run, HEAD_MODE_WARMUP, HEAD_MODE_REPS)
        peak = torch.cuda.max_memory_allocated() / 2**20
        # the single-stage config in the same call: the RoI's cost is the
        # difference
        smodel = build_detector(scfg, device=dev, seed=0)

        def run_single():
            with torch.no_grad():
                return decode_and_nms(scfg, smodel(*inputs))

        torch.cuda.reset_peak_memory_stats()
        single_ms = time_host(run_single, HEAD_MODE_WARMUP, HEAD_MODE_REPS)
        single_peak = torch.cuda.max_memory_allocated() / 2**20
        del smodel
        # the same weights and scene on the CPU
        t0 = time.perf_counter()
        cpreds, cdet, croi = run(build_detector(cfg, device="cpu", seed=0),
                                 [torch.from_numpy(pts),
                                  torch.from_numpy(valid)])
        cpu_s = time.perf_counter() - t0
        hm_err = max(float((torch.sigmoid(g["hm"]).cpu()
                            - torch.sigmoid(c["hm"])).abs().max())
                     for g, c in zip(preds, cpreds))
        check(hm_err <= HM_ATOL, f"{name}: heatmap card vs CPU {hm_err}")
        n_card, n_cpu, let_off = check_detections_match(cfg, det, cdet,
                                                        hm_err)
        pairs = matched_proposals(cfg, det, cdet)
        check(len(pairs) >= n_cpu - len(let_off),
              f"{name}: {len(pairs)} proposals matched of {n_cpu} "
              f"({len(let_off)} let off)")
        gi, ci = (list(x) for x in zip(*pairs))
        roi_err = {}
        for k in ("logits", "resid", "boxes", "scores"):
            g, c = roi[k][0].cpu()[gi], croi[k][0][ci]
            roi_err[k] = float((g - c).abs().max()) / max(
                1.0, float(c.abs().max()))
        check(all(e <= ROI_RTOL for e in roi_err.values()),
              f"{name}: RoI outputs card vs CPU {roi_err}")
        emit({"phase": "two_stage", "model": name, "card": card,
              "scene": "uniform_blobs" if vox else "uniform",
              "ms_per_scene": ms, "peak_mib": peak,
              "single_stage_model": single,
              "single_stage_ms_per_scene": single_ms,
              "single_stage_peak_mib": single_peak,
              "roi_ms": ms - single_ms, "k1_launches": n1,
              "k1_problems_g": pseudo, "k2_launches": n2,
              "proposals": int(det.valid.sum()), "cpu_s": round(cpu_s, 3),
              "hm_max_abs_err": hm_err, "hm_atol": HM_ATOL,
              "proposals_card": n_card, "proposals_cpu": n_cpu,
              "let_off_at_the_cut": let_off, "proposals_matched": len(pairs),
              "roi_rel_err": roi_err, "roi_rtol": ROI_RTOL,
              "warmup": HEAD_MODE_WARMUP, "reps": HEAD_MODE_REPS})
        out[name] = {"k1": n1, "k2": n2, "g": pseudo}
        del model
    return out


def two_stage_train_path(dev, card):
    """Phase 27. Returns per two-stage config {"k1", "k2_forward", "k2_dx"}
    of the main-path step."""
    import dataclasses

    from futuredet_torch.config import get_config
    from futuredet_torch.models.detector import build_detector
    from futuredet_torch.models.two_stage import two_stage_trainable_mask
    from futuredet_torch.ops import pallas_gather, pallas_nms
    from futuredet_torch.ops import sparse_conv as sc_mod
    from futuredet_torch.train.step import make_optimizer, train_step

    k1, k2 = pallas_nms.rotate_nms_alive, pallas_gather.gather_conv
    dx_fn, dx = sc_mod.subm_conv_dx, [0]

    def counting_dx(*args):
        before = k2.launches
        res = dx_fn(*args)
        dx[0] += k2.launches - before
        return res

    out = {}
    for name, _ in TWO_STAGE_NAMES:
        cfg = get_config(name)
        vox = cfg.model.detector == "voxelnet"
        clutter = TRAIN_CLUTTER if vox else PILLAR_TRAIN_CLUTTER
        if not vox:
            cfg = cfg.replace(voxel=dataclasses.replace(
                cfg.voxel, max_points=MAX_POINTS))
        batch = train_batch(cfg, TRAIN_SEED, dev, clutter)
        model = build_detector(cfg, device=dev, seed=0).train()
        mask = two_stage_trainable_mask(model)
        check(len(mask) == TWO_STAGE_TRAINABLE,
              f"{name}: {len(mask)} trainable tensors")
        # the step, then step_times' two runs of warm-ups and reps
        opt = make_optimizer(cfg, model, 1 + 2 * (TRAIN_WARMUP + TRAIN_REPS))
        params0 = {n: p.detach().clone() for n, p in model.named_parameters()}
        stats0 = {n: b.clone() for n, b in model.named_buffers()
                  if n.endswith("running_mean")}
        sc_mod.subm_conv_dx = counting_dx
        try:
            # counts zeroed just before the step, read just after
            k1.launches = k2.launches = dx[0] = 0
            metrics = train_step(model, opt, batch, 0)
            torch.cuda.synchronize()
            counts = {"k1": k1.launches, "k2_forward": k2.launches - dx[0],
                      "k2_dx": dx[0]}
        finally:
            sc_mod.subm_conv_dx = dx_fn
        m = {k: v.detach().cpu() for k, v in metrics.items()}
        check(counts == {"k1": 1, "k2_forward": 20 if vox else 0,
                         "k2_dx": 19 if vox else 0},
              f"{name}: train step launches {counts}")
        check(all(bool(torch.isfinite(v).all()) for v in m.values()),
              f"{name}: train metrics not finite {m}")
        check(not m["hm_loss"].any(), f"{name}: hm_loss {m['hm_loss']}")
        params = dict(model.named_parameters())
        moved_frozen = [n for n in params0 if n not in mask
                        and not torch.equal(params[n].detach(), params0[n])]
        check(not moved_frozen, f"{name}: frozen parameters moved "
              f"{moved_frozen[:5]}")
        still = [n for n in mask if params[n].grad is not None
                 and bool(params[n].grad.any())
                 and torch.equal(params[n].detach(), params0[n])]
        check(not still, f"{name}: trainable parameters with a gradient did "
              f"not move {still[:5]}")
        bufs = dict(model.named_buffers())
        frozen_bn = [n for n in stats0
                     if n.rsplit(".", 1)[0] + ".weight" not in mask]
        unmoved = [n for n in frozen_bn if torch.equal(bufs[n], stats0[n])]
        check(frozen_bn and not unmoved, f"{name}: running statistics of "
              f"frozen BatchNorms did not move {unmoved[:5]}")
        step_ms, split_ms, peak_mib = step_times(cfg, model, opt, batch, 1)
        # 10 steps of a fresh model on the same batch
        del model, opt
        fresh = build_detector(cfg, device=dev, seed=0).train()
        fopt = make_optimizer(cfg, fresh, OVERFIT_STEPS)
        roi_losses = [float(train_step(fresh, fopt, batch, i)
                            ["roi_cls_loss"]) for i in range(OVERFIT_STEPS)]
        del fresh, fopt
        check(roi_losses[-1] < roi_losses[0],
              f"{name}: roi_cls_loss {roi_losses[0]} -> {roi_losses[-1]} "
              f"over {OVERFIT_STEPS} steps on one batch")
        emit({"phase": "two_stage_train", "model": name, "card": card,
              "scene": f"lidar family, seed {TRAIN_SEED}", **counts,
              "trainable_tensors": len(mask),
              "frozen_tensors": len(params0) - len(mask),
              "frozen_bn_statistics_moved": len(frozen_bn),
              "loss": float(m["loss"]), "hm_loss": m["hm_loss"].tolist(),
              "roi_cls_loss": float(m["roi_cls_loss"]),
              "roi_reg_loss": float(m["roi_reg_loss"]),
              "grad_norm": float(m["grad_norm"]),
              "train_step_ms": step_ms, "train_step_split_ms": split_ms,
              "train_step_peak_mib": peak_mib,
              "repeated_batch_roi_cls_losses": roi_losses,
              "warmup": TRAIN_WARMUP, "reps": TRAIN_REPS})
        out[name] = counts
        if not vox:
            # the pillar step card against the CPU, to phase 12's limits
            # (the CPU in float64, as phase 15)
            train_cross_check(cfg, dev, clutter, torch.float64)
    return out


def two_stage_cli_path(dev, card, pp_dir, pp_map):
    """Phase 28: the train CLI of pp_forecast_n3dtf_two_stage grafting phase
    17's checkpoint, then the evaluate CLI of its checkpoint. Returns the
    launches of each run."""
    from futuredet_torch.cli import evaluate

    name = TWO_STAGE_NAMES[0][0]
    work = os.path.join(os.path.dirname(pp_dir), "pp_two_stage_cli")
    hook = StepCounts()
    state, logs, train_s = run_train_cli([
        "--model", name, "--device", str(dev), "--synthetic", "1",
        "--seed", str(CLI_SEED), "--epochs", str(TWO_STAGE_CLI_EPOCHS),
        "--first_stage_checkpoint", pp_dir, "--work_dir", work], hook)
    steps = state.step
    del state
    check(steps == TWO_STAGE_CLI_EPOCHS, f"{name} train CLI: {steps} steps")
    check(any(ln.startswith(f"grafted first-stage checkpoint step "
                            f"{CLI_EPOCHS} from") for ln in logs),
          f"{name}: phase 17's checkpoint not grafted")
    for rec in hook.steps:
        check(rec["k1"] == 1 and rec["k2_forward"] == rec["k2_dx"] == 0
              and rec["finite"], f"{name} train CLI step {rec}")
    summary, per_call, total, elog, eval_s = run_evaluate(eval_args(
        dev, name, f"metrics_{name}", "--synthetic", "1", "--seed",
        str(CLI_SEED), "--checkpoint_dir", work))
    check(per_call == [(1, 0)] and total == (1, 0),
          f"{name} eval: (K1, K2) launches {per_call}, {total} in all")
    check(any(f"restored checkpoint step {TWO_STAGE_CLI_EPOCHS}" in ln
              for ln in elog), f"{name}: the train CLI's checkpoint was not "
          "restored")
    check_summary(summary, f"{name} eval")
    check(os.path.exists(metrics_path(f"metrics_{name}"))
          and os.path.exists(metrics_path(f"metrics_{name}")[:-5] + ".csv"),
          f"{name}: metrics not written")
    # --tta on a two-stage config exits non-zero, as the JAX CLI does
    try:
        evaluate.main(eval_args(dev, name, "unused", "--synthetic", "1",
                                "--tta", "map"))
        code = 0
    except SystemExit as e:
        code = e.code
    check(code not in (None, 0), f"{name} --tta map exited {code!r}")
    emit({"phase": "two_stage_cli", "model": name, "card": card,
          "scene": f"synthetic seed {CLI_SEED}, lidar clutter",
          "first_stage_checkpoint": "phase 17", "train_steps": steps,
          "train_s": round(train_s, 3),
          "train_launches_per_step": [(r["k1"], r["k2_forward"])
                                      for r in hook.steps],
          "eval_s": round(eval_s, 3), "launches_per_scene": per_call,
          "mAP_car": summary["mean_dist_aps"]["car"],
          "mAP_car_phase_17": pp_map, "tta_exit": str(code),
          "metrics": os.path.relpath(metrics_path(f"metrics_{name}"), ROOT),
          "note": "no floor: the RoI head's init moves the boxes"})
    return {f"{name}_cli_train": {"k1": sum(r["k1"] for r in hook.steps),
                                  "k2": 0},
            f"{name}_cli_eval": {"k1": total[0], "k2": total[1]}}


def knob_config(base_name, change, tag):
    """head_mode_config(base_name) with the model knobs `change`."""
    import dataclasses
    base = head_mode_config(base_name)
    return base, base.replace(name=f"{base_name}+{tag}",
                              model=dataclasses.replace(base.model, **change))


def maps_rel_err(preds, ref):
    """max over the head maps of max|preds - ref| / max(1, max|ref|)."""
    return max(float((p[k].float() - r[k].float()).abs().max())
               / max(1.0, float(r[k].float().abs().max()))
               for p, r in zip(preds, ref) for k in r)


def serving_path(dev, card):
    """Phases 29-30. Returns {"k2_bf16": the bf16 family's numbers on (a)'s
    20 convs, "paths": per knob {"k1", "k2", "k2_bf16"}}."""
    from futuredet_torch.eval.decode import decode_and_nms
    from futuredet_torch.models.detector import build_detector
    from futuredet_torch.ops import pallas_gather, pallas_nms
    from futuredet_torch.ops import sparse_conv as sc_mod

    k1, k2 = pallas_nms.rotate_nms_alive, pallas_gather.gather_conv
    recorded = []

    def recorder(f, t, w, b=None):
        recorded.append(tuple(None if a is None else a.clone()
                              for a in (f, t, w, b)))
        return k2(f, t, w, b)

    paths = {}
    for tag, base_name, change in SERVING:
        base, cfg = knob_config(base_name, change, tag)
        vox = cfg.model.detector == "voxelnet"
        pts, valid, _ = head_mode_scene(cfg)
        inputs = (torch.from_numpy(pts).to(dev),
                  torch.from_numpy(valid).to(dev))
        models = {"fp32": (build_detector(base, device=dev, seed=0), base),
                  tag: (build_detector(cfg, device=dev, seed=0), cfg)}

        def run(key):
            m, c = models[key]
            with torch.no_grad():
                preds = m(*inputs)
                return preds, decode_and_nms(c, preds)

        # 30. the main path: counts zeroed just before, read just after
        if tag == "a_bf16":
            sc_mod.gather_conv = recorder
        try:
            pallas_gather.reset_launches()
            k1.launches = 0
            preds, det = run(tag)
            torch.cuda.synchronize()
            n1, n2 = k1.launches, k2.launches
            by_route = dict(k2.launches_by_route)
        finally:
            sc_mod.gather_conv = k2
        bf16_route = tag in ("a_bf16", "b_window_bf16")
        check(n1 == 1, f"{cfg.name}: K1 launched {n1} times")
        check(n2 == (20 if vox else 0), f"{cfg.name}: K2 launched {n2} times")
        check(by_route["bf16"] == (20 if bf16_route else 0),
              f"{cfg.name}: K2 routes {by_route}")
        for p in preds:
            for k, t in p.items():
                check(bool(torch.isfinite(t).all()), f"{cfg.name} {k}")
                check(k == "feats" or t.dtype == torch.float32,
                      f"{cfg.name} {k} is {t.dtype}")
        check(bool(torch.isfinite(det.boxes).all()
                   and torch.isfinite(det.scores).all()),
              f"{cfg.name} detections not finite")
        ref, ref_det = run("fp32")
        err = maps_rel_err(preds, ref)
        check(err <= SERVING_RTOL, f"{cfg.name}: head maps {err} of max "
              f"from the fp32 forward")
        # times in turns: fp32, knob, knob, fp32
        times, peak = {k: [] for k in models}, dict.fromkeys(models, 0.0)
        for key in ("fp32", tag, tag, "fp32"):
            torch.cuda.reset_peak_memory_stats()
            times[key].append(time_host(lambda key=key: run(key),
                                        HEAD_MODE_WARMUP, HEAD_MODE_REPS))
            peak[key] = max(peak[key],
                            torch.cuda.max_memory_allocated() / 2**20)
        emit({"phase": "serving", "model": cfg.name, "card": card,
              "knobs": change,
              "scene": "uniform_blobs" if vox else "uniform",
              "k1_launches": n1, "k2_launches": n2,
              "k2_launches_by_route": by_route,
              "head_maps_rel_err_vs_fp32": err, "rtol": SERVING_RTOL,
              "detections": int(det.valid.sum()),
              "detections_fp32": int(ref_det.valid.sum()),
              "ms_per_scene_turns": times[tag],
              "fp32_ms_per_scene_turns": times["fp32"],
              "peak_mib": peak[tag], "fp32_peak_mib": peak["fp32"],
              "warmup": HEAD_MODE_WARMUP, "reps": HEAD_MODE_REPS})
        paths[cfg.name] = {"k1": n1, "k2": n2, "k2_bf16": by_route["bf16"]}
        del models

    # 29. the bf16 family on (a)'s 20 convs, as the main path gave them ----
    check(len(recorded) == 20 and all(a[0].dtype == torch.bfloat16
                                      for a in recorded),
          f"{len(recorded)} bf16 convs recorded")
    convs, k2_err = [], 0.0
    sms = (torch.cuda.get_device_properties(dev).multi_processor_count
           if dev.type == "cuda" else pallas_gather.H100_SMS)
    for i, args in enumerate(recorded):
        line, ok, err = k2_compare(*args)
        line["conv"] = i
        line["plan"] = pallas_gather.k2_bf16_plan(
            line["cin"], line["cout"], line["N"], sms)
        line["bit_identical"] = bool(torch.equal(k2(*args), k2(*args)))
        check(ok and line["bit_identical"],
              f"K2's bf16 family on conv {i}: {line}")
        k2_err = max(k2_err, err)
        lib = k2_library_call(*args)
        plain = pallas_gather.gather_conv_plain(*args)
        line["library_rel_err"] = float((lib() - plain).abs().max()) / max(
            1.0, float(plain.abs().max()))
        line.update(ms=time_device(lambda a=args: k2(*a)),
                    plain_ms=time_device(
                        lambda a=args: pallas_gather.gather_conv_plain(*a)),
                    library_ms=time_device(lib))
        convs.append(line)
    total = {k: sum(c[k] for c in convs)
             for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    ops_share = sum(c["bound_ms"] for c in convs
                    if c["bound_by"] == "operations") / total["bound_ms"]
    emit({"phase": "k2_bf16_vs_plain", "model": VOX_NAME + "+a_bf16",
          "card": card, "rtol_of_max_plain": K2_RTOL, "k2_per_scene": total,
          "convs": convs, "warmup": WARMUP, "reps": REPS})
    return {"k2_bf16": {"max_abs_err": k2_err, **total,
                        "bound_by": ("operations" if ops_share >= 0.5
                                     else "bytes")},
            "paths": paths}


def dense_canvas_bytes(cfg):
    """The bytes of the dense stages' fp32 tensors at DENSE_FROM: the
    scattered canvas of the last sparse stage and each dense stage's
    conv output, with the stage's mask."""
    from futuredet_torch.models.middle import stage_pads
    from futuredet_torch.ops.sparse_conv import out_dims_of
    gx, gy, gz = cfg.voxel.grid_size
    dims, ch = (gz + 1, gy, gx), cfg.model.middle_channels
    out = {}
    for s in range(1, 4):
        if s == DENSE_FROM:
            out["canvas_in"] = 4 * math.prod(dims) * ch[s - 1]
        dims = out_dims_of(dims, stage_pads(s, dims))
        if s >= DENSE_FROM:
            out[f"stage{s}_out"] = (4 * ch[s] + 1) * math.prod(dims)
    return out


def dense_middle_path(dev, card):
    """Phases 31-32. Returns per path {"k1", "k2"}."""
    from futuredet_torch.eval.decode import decode_and_nms
    from futuredet_torch.models.detector import build_detector
    from futuredet_torch.ops import pallas_gather, pallas_nms
    from futuredet_torch.train.step import make_optimizer, train_step

    k1, k2 = pallas_nms.rotate_nms_alive, pallas_gather.gather_conv
    base = head_mode_config(VOX_NAME)
    pts, valid, _ = head_mode_scene(base)
    inputs = (torch.from_numpy(pts).to(dev), torch.from_numpy(valid).to(dev))
    sparse = build_detector(base, device=dev, seed=0)
    with torch.no_grad():
        feats, vm = sparse.voxelize(*inputs)
        want, want_z = sparse.backbone(feats, vm.coords, vm.batch, 1)
    sites = list(sparse.backbone.site_counts)
    canvas = dense_canvas_bytes(base)
    emit({"phase": "dense_canvas", "model": VOX_NAME, "card": card,
          "dense_from_stage": DENSE_FROM, "sites_per_stage": sites,
          "bytes": canvas, "mib": sum(canvas.values()) / 2**20})
    out = {}
    forms = (("d_dense_from2", {"middle_dense_from_stage": DENSE_FROM},
              DENSE_RTOL),
             ("d_dense_from2_bf16", {"middle_dense_from_stage": DENSE_FROM,
                                     "middle_dense_dtype": "bfloat16"},
              DENSE_BF16_RTOL),
             ("e_dense", {"middle": "dense"}, None))
    for tag, change, rtol in forms:
        _, cfg = knob_config(VOX_NAME, change, tag)
        model = build_detector(cfg, device=dev, seed=0)

        def run(m=model, c=cfg):
            with torch.no_grad():
                preds = m(*inputs)
                return preds, decode_and_nms(c, preds)

        pallas_gather.reset_launches()
        k1.launches = 0
        preds, det = run()
        torch.cuda.synchronize()
        n1, n2 = k1.launches, k2.launches
        n_sparse = 5 * DENSE_FROM if rtol is not None else 0
        check(n1 == 1, f"{cfg.name}: K1 launched {n1} times")
        check(n2 == n_sparse and k2.launches_by_route["bf16"] == 0,
              f"{cfg.name}: K2 launched {n2} times "
              f"{k2.launches_by_route}")
        check(all(bool(torch.isfinite(t).all()) for p in preds
                  for t in p.values()), f"{cfg.name}: maps not finite")
        line = {"phase": "dense_middle", "model": cfg.name, "card": card,
                "knobs": change, "scene": "uniform_blobs",
                "k1_launches": n1, "k2_launches": n2,
                "detections": int(det.valid.sum())}
        if rtol is not None:
            # the middle's output and z-mask against the sparse middle's
            with torch.no_grad():
                got, got_z = model.backbone(feats, vm.coords, vm.batch, 1)
            err = float((got - want).abs().max())
            tol = rtol * max(1.0, float(want.abs().max()))
            check(err <= tol and torch.equal(got_z, want_z),
                  f"{cfg.name}: middle {err} (tol {tol}), z-mask equal "
                  f"{torch.equal(got_z, want_z)}")
            check(model.backbone.site_counts == sites,
                  f"{cfg.name}: active cells {model.backbone.site_counts}")
            line.update(middle_max_abs_err=err, middle_tol=tol,
                        zmask_equal=True)
        torch.cuda.reset_peak_memory_stats()
        line["ms_per_scene"] = time_host(run, HEAD_MODE_WARMUP,
                                         HEAD_MODE_REPS)
        line["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
        if tag == "e_dense":
            # 32. one B = 1 train step through plain autograd
            model.train()
            opt = make_optimizer(cfg, model, 10)
            batch = train_batch(cfg, TRAIN_SEED, dev, TRAIN_CLUTTER)
            pallas_gather.reset_launches()
            k1.launches = 0
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            m = train_step(model, opt, batch, 0)
            loss = float(m["loss"])
            line.update(train_step_s=time.perf_counter() - t0,
                        train_loss=loss, train_grad_norm=float(
                            m["grad_norm"]),
                        train_peak_mib=torch.cuda.max_memory_allocated()
                        / 2**20, train_k1=k1.launches,
                        train_k2=k2.launches)
            check(math.isfinite(loss) and k2.launches == 0,
                  f"{cfg.name}: train step loss {loss}, K2 {k2.launches}")
        line.update(warmup=HEAD_MODE_WARMUP, reps=HEAD_MODE_REPS)
        emit(line)
        out[cfg.name] = {"k1": n1, "k2": n2}
        del model
    sparse_ms = time_host(lambda: decode_and_nms(base, sparse(*inputs)),
                          HEAD_MODE_WARMUP, HEAD_MODE_REPS)
    emit({"phase": "dense_middle", "model": VOX_NAME, "card": card,
          "ms_per_scene_sparse_beside": sparse_ms})
    return out


def bf16_measures(runs, got):
    """{quantity: (err, gap, noise, floor)} of run `got` against the CPU's
    bf16 run "cpu" (phase 33's rule): "cpu32" gives the gap, "nudged" the
    noise. Each run is {"losses", "grads", "stats"} of float64 CPU
    tensors."""
    ref = runs["cpu"]

    def rel(a, b):
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)

    def dist(r, kind, names):
        num = sum(float(((runs[r][kind][n] - ref[kind][n]) ** 2).sum())
                  for n in names)
        den = sum(float((ref[kind][n] ** 2).sum()) for n in names)
        return math.sqrt(num / max(den, 1e-60))
    out = {}
    for k in ref["losses"]:
        out[f"loss:{k}"] = (rel(runs[got]["losses"][k], ref["losses"][k]),
                            rel(runs["cpu32"]["losses"][k],
                                ref["losses"][k]),
                            rel(runs["nudged"]["losses"][k],
                                ref["losses"][k]), BF16_LOSS_ULPS)
    names = list(ref["grads"])

    def norm(r):
        return math.sqrt(sum(float((runs[r]["grads"][n] ** 2).sum())
                             for n in names))
    out["grad_norm"] = (abs(norm(got) - norm("cpu")) / norm("cpu"),
                        abs(norm("cpu32") - norm("cpu")) / norm("cpu"),
                        dist("nudged", "grads", names), BF16_FP32_FLOOR)
    for kind in ("grads", "stats"):
        pool = list(ref[kind])
        for top in sorted({n.split(".")[0] for n in pool}):
            sel = [n for n in pool if n.split(".")[0] == top]
            out[f"{kind}:{top}"] = (dist(got, kind, sel),
                                    dist("cpu32", kind, sel),
                                    dist("nudged", kind, sel),
                                    BF16_FP32_FLOOR)
    return out


def bf16_violations(measures):
    """The quantities of `bf16_measures` beyond phase 33's limits."""
    bad = {}
    for key, (err, gap, noise, floor) in measures.items():
        if gap >= BF16_SIGNAL * max(noise, BF16_FP32_FLOOR):
            limit = BF16_GAP_FRACTION * gap
        else:
            limit = max(BF16_GAP_FRACTION * gap, BF16_NOISE_FACTOR * noise,
                        floor)
        if not err <= limit:
            bad[key] = (err, limit)
    return bad


def bf16_cross_check(cfg, base, dev, clutter):
    """Phase 33's correctness: one train step of the same weights and batch
    under the knob on the card and on the CPU, with the CPU's fp32 step
    and its bf16 step on nudged weights beside them (every BatchNorm bias
    raised by BN_BIAS_SHIFT, as phase 12), and the card's fp32 step, which
    the rule must reject. Returns the phase line's fields."""
    from futuredet_torch.models.detector import build_detector
    from futuredet_torch.train.step import forward_backward
    runs = {}
    for key, c, d, nudge in (("card", cfg, dev, 0.0), ("cpu", cfg, "cpu", 0.0),
                             ("cpu32", base, "cpu", 0.0),
                             ("nudged", cfg, "cpu", BF16_NUDGE),
                             ("card32", base, dev, 0.0)):
        m = build_detector(c, device=d, seed=0).train()
        shift_bn_biases(m)
        if nudge:
            with torch.no_grad():
                for p in m.parameters():
                    p.mul_(1 + nudge)
        b_ = train_batch(c, TRAIN_SEED, d, clutter)
        losses = forward_backward(m, b_)
        runs[key] = {
            "losses": {k: v.detach().double().cpu() for k, v in
                       losses.items()},
            "grads": {n: grad_of(p).cpu() for n, p in m.named_parameters()},
            "stats": {n: t.double().cpu() for n, t in m.named_buffers()
                      if n.endswith(("running_mean", "running_var"))}}
        del m, b_
    card = bf16_measures(runs, "card")
    bad = bf16_violations(card)
    fp32_bad = bf16_violations(bf16_measures(runs, "card32"))
    signal = [k for k, (_, gap, noise, _) in card.items()
              if gap >= BF16_SIGNAL * max(noise, BF16_FP32_FLOOR)]
    check(not bad, f"{cfg.name}: bf16 step card vs CPU beyond its limits "
          f"{bad}")
    check(fp32_bad, f"{cfg.name}: the card's fp32 step passes the bf16 rule")
    return {"card_vs_cpu": {k: {"err": e, "gap": g, "noise": n}
                            for k, (e, g, n, _) in card.items()},
            "signal_quantities": signal,
            "card_fp32_breaks": sorted(fp32_bad),
            "gap_fraction": BF16_GAP_FRACTION,
            "noise_factor": BF16_NOISE_FACTOR, "signal": BF16_SIGNAL,
            "nudge": BF16_NUDGE}


def bf16_train_path(dev, card, turns=False, cross_checked=None):
    """Phase 33: a B = 1 train step under each BF16_TRAIN knob at full
    width: launches by kernel and route, the step split (phase 13's) and
    peak MiB beside the fp32 step's (in turns fp32, knob, knob, fp32 with
    `turns`, else once each), the card against the CPU for the knobs of
    `cross_checked` (default: all; three full-width CPU steps a knob), and
    OVERFIT_STEPS steps of finite losses. Returns per config {"k1", "k2",
    "k2_bf16"} of the main-path step."""
    import dataclasses

    from futuredet_torch.config import get_config
    from futuredet_torch.models.detector import build_detector
    from futuredet_torch.ops import pallas_gather, pallas_nms
    from futuredet_torch.ops import sparse_conv as sc_mod
    from futuredet_torch.train.step import make_optimizer, train_step

    k1, k2 = pallas_nms.rotate_nms_alive, pallas_gather.gather_conv
    dx_fn = sc_mod.subm_conv_dx
    dx = dict.fromkeys(pallas_gather.ROUTES, 0)

    def counting_dx(*args):
        before = dict(k2.launches_by_route)
        res = dx_fn(*args)
        for r in dx:
            dx[r] += k2.launches_by_route[r] - before[r]
        return res

    out = {}
    for tag, base_name, change in BF16_TRAIN:
        base = get_config(base_name)
        vox = base.model.detector == "voxelnet"
        clutter = TRAIN_CLUTTER if vox else PILLAR_TRAIN_CLUTTER
        if not vox:
            base = base.replace(voxel=dataclasses.replace(
                base.voxel, max_points=MAX_POINTS))
        cfg = base.replace(name=f"{base_name}+{tag}",
                           model=dataclasses.replace(base.model, **change))
        two = cfg.model.two_stage_refine
        batch = train_batch(cfg, TRAIN_SEED, dev, clutter)
        reps = 2 * (TRAIN_WARMUP + TRAIN_REPS) * (2 if turns else 1)
        models = {key: build_detector(c, device=dev, seed=0).train()
                  for key, c in (("fp32", base), (tag, cfg))}
        opts = {key: make_optimizer(c, models[key], 1 + reps)
                for key, c in (("fp32", base), (tag, cfg))}
        # the main path: counts zeroed just before the step, read after
        sc_mod.subm_conv_dx = counting_dx
        try:
            pallas_gather.reset_launches()
            k1.launches = 0
            dx.update(dict.fromkeys(dx, 0))
            metrics = train_step(models[tag], opts[tag], batch, 0)
            torch.cuda.synchronize()
            routes = dict(k2.launches_by_route)
            counts = {"k1": k1.launches,
                      "k2_forward": k2.launches - sum(dx.values()),
                      "k2_dx": sum(dx.values()),
                      "k2_forward_by_route": {r: routes[r] - dx[r]
                                              for r in dx},
                      "k2_dx_by_route": dict(dx)}
        finally:
            sc_mod.subm_conv_dx = dx_fn
        m = {k: v.detach().float().cpu() for k, v in metrics.items()}
        check(all(bool(torch.isfinite(v).all()) for v in m.values()),
              f"{cfg.name}: train metrics not finite {m}")
        want_fwd = {"a_bf16": 20, "d_dense_bf16": 10}.get(tag, 0)
        check(counts["k1"] == (1 if two else 0)
              and counts["k2_forward"] == want_fwd
              and counts["k2_dx"] == max(want_fwd - 1, 0)
              and counts["k2_forward_by_route"]["bf16"]
              == (20 if tag == "a_bf16" else 0)
              and counts["k2_dx_by_route"]["bf16"] == 0,
              f"{cfg.name}: train step launches {counts}")
        train_step(models["fp32"], opts["fp32"], batch, 0)
        times = {k: [] for k in models}
        splits, peaks = dict.fromkeys(models), dict.fromkeys(models, 0.0)
        for i, key in enumerate(("fp32", tag, tag, "fp32") if turns
                                else ("fp32", tag)):
            c = base if key == "fp32" else cfg
            n_done = 1 + (TRAIN_WARMUP + TRAIN_REPS) * 2 * (
                i // 2 if turns else 0)
            ms, split, peak = step_times(c, models[key], opts[key], batch,
                                         n_done)
            times[key].append(ms)
            splits[key] = split
            peaks[key] = max(peaks[key], peak)
        del models, opts
        line = {"phase": "bf16_train", "model": cfg.name, "card": card,
                "knobs": change, "scene": f"lidar family, seed {TRAIN_SEED}",
                **counts, "loss": float(m["loss"]),
                "grad_norm": float(m["grad_norm"]),
                "train_step_ms": times[tag],
                "fp32_train_step_ms": times["fp32"],
                "train_step_split_ms": splits[tag],
                "fp32_train_step_split_ms": splits["fp32"],
                "train_step_peak_mib": peaks[tag],
                "fp32_train_step_peak_mib": peaks["fp32"],
                "warmup": TRAIN_WARMUP, "reps": TRAIN_REPS}
        # OVERFIT_STEPS steps of a fresh model: every loss finite
        fresh = build_detector(cfg, device=dev, seed=0).train()
        fopt = make_optimizer(cfg, fresh, OVERFIT_STEPS)
        steps = [{k: v.detach().float().cpu()
                  for k, v in train_step(fresh, fopt, batch, i).items()}
                 for i in range(OVERFIT_STEPS)]
        del fresh, fopt
        check(all(bool(torch.isfinite(v).all()) for s_ in steps
                  for v in s_.values()),
              f"{cfg.name}: a loss of {OVERFIT_STEPS} steps not finite")
        line["repeated_batch_losses"] = [float(s_["loss"]) for s_ in steps]
        if cross_checked is None or tag in cross_checked:
            line.update(bf16_cross_check(cfg, base, dev, clutter))
        else:
            line["card_vs_cpu"] = ("in scripts/torch_train_bf16_phases.py "
                                   "(phase 33 with every knob's CPU steps)")
        emit(line)
        out[cfg.name + "_train"] = {
            "k1": counts["k1"], "k2": counts["k2_forward"] + counts["k2_dx"],
            "k2_bf16": counts["k2_forward_by_route"]["bf16"]}
    return out


def free_port() -> int:
    """A free TCP port on localhost."""
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def dp_path(dev, card, work):
    """Phase 34: data parallelism at world size 1 on the card's backend
    (NCCL; gloo when rehearsed on the CPU). The train CLI and the evaluate
    CLI with --coordinator_address / --num_processes 1 / --process_id 0;
    one step in the group against the plain step on the same weights and
    batch (and a second plain step: the card's own run-to-run spread);
    the step's ms outside, inside and again outside the group (the
    wrapper adds no collective at world size 1); and the collectives a
    step of two or more ranks would add, run and timed at world size 1. NCCL refuses two ranks on one device, so no
    multi-GPU figure is taken. Returns the K1 / K2 counts of the CLIs."""
    import dataclasses

    import torch.distributed as dist
    from torch.distributed.nn.functional import all_reduce

    from futuredet_torch.config import get_config
    from futuredet_torch.models.detector import build_detector
    from futuredet_torch.models.layers import BatchNorm2d
    from futuredet_torch.models.readers import MaskedBatchNorm
    from futuredet_torch.ops import pallas_gather, pallas_nms
    from futuredet_torch.parallel import collectives as coll
    from futuredet_torch.train import trainer
    from futuredet_torch.train.step import make_optimizer, train_step

    k1, k2 = pallas_nms.rotate_nms_alive, pallas_gather.gather_conv
    backend = "nccl" if dev.type == "cuda" else "gloo"
    joined = []
    init = coll.initialize_multihost

    def recording_init(*a, **kw):
        n = init(*a, **kw)
        joined.append((dist.get_backend(), n, coll.rank()))
        return n

    def flags():
        return ["--coordinator_address", f"127.0.0.1:{free_port()}",
                "--num_processes", "1", "--process_id", "0"]

    # 34.1 the train CLI (VoxelNet, one scene, two one-step epochs) ----
    per_step = []

    class Count(trainer.Hook):
        def before_step(self, step, state, batch):
            k1.launches = k2.launches = 0

        def after_step(self, step, state, metrics):
            torch.cuda.synchronize()
            per_step.append({"k1": k1.launches, "k2": k2.launches,
                             "loss": float(metrics["loss"])})

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            pass

    ckpt_dir = os.path.join(work, "dp_train")
    coll.initialize_multihost = recording_init
    try:
        state, logs, train_s = run_train_cli(
            ["--model", VOX_NAME, "--synthetic", "1", "--epochs", "2",
             "--batch_size", "1", "--work_dir", ckpt_dir,
             "--device", dev.type] + flags(), Count())
        out_path = os.path.join(OUT_DIR, "metrics_dp_eval.json")
        summary, calls, totals, elogs, eval_s = run_evaluate(
            ["--model", VOX_NAME, "--synthetic", "2", "--batch_size", "1",
             "--checkpoint_dir", ckpt_dir, "--out", out_path,
             "--device", dev.type] + flags())
    finally:
        coll.initialize_multihost = init
    del state
    check(joined == [(backend, 1, 0)] * 2 and not dist.is_initialized(),
          f"the CLIs' process groups {joined}")
    check(len(per_step) == 2 and all(
        s_["k1"] == 0 and s_["k2"] == 39 and math.isfinite(s_["loss"])
        for s_ in per_step), f"DP train CLI steps {per_step}")
    check(calls == [(1, 20)] * 2 and os.path.exists(out_path),
          f"DP evaluate CLI: {calls}, {out_path}")
    check_summary(summary, "DP evaluate CLI")

    # 34.2 one step in the group against the plain step ----------------
    cfg = get_config(NAME)
    cfg = cfg.replace(voxel=dataclasses.replace(cfg.voxel,
                                                max_points=MAX_POINTS))
    batch = train_batch(cfg, TRAIN_SEED, dev, PILLAR_TRAIN_CLUTTER)

    def one_step():
        # deterministic kernels where torch has them (the pillar reader's
        # index_add_ and the cuDNN backward otherwise sum in a run-to-run
        # order), so that the group's step can be held bit for bit
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.backends.cudnn.deterministic = True
        try:
            m = build_detector(cfg, device=dev, seed=0).train()
            opt = make_optimizer(cfg, m, 1)
            metrics = train_step(m, opt, batch, 0)
            seen = {n: p.grad.detach().clone()
                    for n, p in m.named_parameters()}
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
            torch.backends.cudnn.deterministic = False
        return float(metrics["loss"]), seen, m

    # the step's ms outside the group, in it, and outside again, on one
    # model (its updates go on)
    timed = build_detector(cfg, device=dev, seed=0).train()
    timed_opt = make_optimizer(cfg, timed, 3 * (TRAIN_WARMUP + TRAIN_REPS))
    count = [0]

    def timed_step():
        train_step(timed, timed_opt, batch, count[0])
        count[0] += 1

    step_ms = [time_host(timed_step, TRAIN_WARMUP, TRAIN_REPS)]
    loss_a, grads_a, _ = one_step()
    address = f"127.0.0.1:{free_port()}"
    coll.initialize_multihost(address, 1, 0, dev)
    try:
        step_ms.append(time_host(timed_step, TRAIN_WARMUP, TRAIN_REPS))
        loss_dp, grads_dp, model = one_step()
        # 34.3 what two or more ranks would add a step: one pmean of the
        # statistics of every BatchNorm with its backward, and one flat
        # all-reduce of the gradients
        bns = [mod for mod in model.modules()
               if isinstance(mod, (BatchNorm2d, MaskedBatchNorm))]
        stats = [torch.zeros(2 * mod.weight.numel(), device=dev,
                             requires_grad=True) for mod in bns]
        flat = torch.cat([g.reshape(-1) for g in grads_dp.values()])

        def collectives():
            total = sum(all_reduce(s_).sum() for s_ in stats)
            total.backward()
            dist.all_reduce(flat)

        coll_ms = time_host(collectives, WARMUP, REPS)
        x = torch.arange(6.0, device=dev).requires_grad_()
        y = all_reduce(x)
        y.backward(torch.ones_like(y))
        check(torch.equal(y.detach(), x.detach())
              and torch.equal(x.grad, torch.ones_like(x)),
              "a differentiable all_reduce of one rank is not the identity")
        gathered = coll._all_gather_np(np.arange(12, dtype=np.int32)
                                       .reshape(3, 4))
        check(np.array_equal(gathered, np.arange(12).reshape(3, 4)),
              "all_gather of one rank")
        del model
    finally:
        coll.leave(address)
    step_ms.append(time_host(timed_step, TRAIN_WARMUP, TRAIN_REPS))
    del timed, timed_opt
    loss_b, grads_b, _ = one_step()

    def worst(g):
        return max(float((g[n] - grads_a[n]).abs().max()) for n in g)
    spread, dp_err = worst(grads_b), worst(grads_dp)
    # the group adds no arithmetic at world size 1: bit for bit where two
    # plain steps agree bit for bit; where an op without a deterministic
    # kernel moves them apart, within DP_SPREAD times their distance
    repeatable = spread == 0.0 and loss_b == loss_a
    check((dp_err == 0.0 and loss_dp == loss_a) if repeatable
          else dp_err <= DP_SPREAD * spread,
          f"the world-size-1 step {dp_err} off the plain step (loss "
          f"{loss_dp} vs {loss_a}); two plain steps lie {spread} apart")
    emit({"phase": "data_parallel", "card": card, "backend": backend,
          "world_size": 1, "process_groups": joined,
          "train_cli_steps": per_step, "train_cli_s": round(train_s, 3),
          "evaluate_cli_launches": calls, "evaluate_cli_s": round(eval_s, 3),
          "metrics": os.path.relpath(out_path, ROOT),
          "step_model": NAME, "loss_plain": loss_a, "loss_dp": loss_dp,
          "loss_plain_again": loss_b,
          "grad_max_abs_err_dp_vs_plain": dp_err,
          "grad_max_abs_err_plain_vs_plain": spread,
          "plain_steps_bit_identical": repeatable, "dp_spread": DP_SPREAD,
          "bit_identical": dp_err == 0.0 and loss_dp == loss_a,
          "collectives_added_ms_a_step_at_two_or_more_ranks": coll_ms,
          "batchnorms": len(bns), "gradient_floats": int(flat.numel()),
          "step_ms_plain_group_plain": step_ms,
          "added_ms_a_step_at_world_size_1":
              step_ms[1] - (step_ms[0] + step_ms[2]) / 2,
          "multi_gpu": "not measured: one card, and NCCL refuses two "
                       "ranks on one device"})
    return {VOX_NAME + "_dp_train_cli": {"k1": sum(s_["k1"]
                                                   for s_ in per_step),
                                         "k2": sum(s_["k2"]
                                                   for s_ in per_step)},
            VOX_NAME + "_dp_eval_cli": {"k1": totals[0], "k2": totals[1]}}


# phase 35's programs: (config name, tag, the knob on the config, the
# exported program's (nms_alive, circle_nms, gather_conv) nodes, timed in
# turns beside eager). Under middle_dense_from_stage 2 the first two
# stages' 10 sparse convs stay K2, under 0 none do; the circle NMS is one
# node a pseudo-task and no kernel
EXPORT_PROGRAMS = (
    (NAME, "", None, (1, 0, 0), True),
    (VOX_NAME, "", None, (1, 0, 20), True),
    (VOX_NAME, "_dense_from_stage0", {"middle_dense_from_stage": 0},
     (1, 0, 0), False),
    (VOX_NAME, "_dense_from_stage2", {"middle_dense_from_stage": 2},
     (1, 0, 10), False),
    (NAME, "_circular_nms", {"circular_nms": True}, (0, 7, 0), False),
)


def export_config_of(name, knob):
    """The full-width config of a phase 35 program: `knob` replaces a
    field of its model config, or `circular_nms` of its test config."""
    import dataclasses

    from futuredet_torch.config import get_config
    cfg = get_config(name)
    if not knob:
        return cfg
    if "circular_nms" in knob:
        return cfg.replace(test=dataclasses.replace(cfg.test, **knob))
    return cfg.replace(model=dataclasses.replace(cfg.model, **knob))


def export_path(dev, card, work):
    """Phase 35: each of EXPORT_PROGRAMS through `tools export --check`
    (`tools.export_config` for a knob: the CLI names configs only), its
    operator nodes counted, the loaded program against eager on phase 4's
    or 8's scene, bit for bit, K1 and K2 counted on both. Returns the
    launches of the exported programs' scenes."""
    import dataclasses

    from futuredet_torch.cli import tools
    from futuredet_torch.models.detector import build_detector
    from futuredet_torch.ops import pallas_gather, pallas_nms

    k1, k2 = pallas_nms.rotate_nms_alive, pallas_gather.gather_conv
    launches = {}
    for name, tag, knob, want_nodes, timed in EXPORT_PROGRAMS:
        cfg = export_config_of(name, knob)
        out = os.path.join(work, name + tag + ".pt2")
        t0 = time.perf_counter()
        with LogCapture() as logs:
            if knob is None:
                tools.main(["export", "--model", name, "--check", "--out",
                            out, "--device", str(dev)])
            else:
                tools.export_config(cfg, out, dev, check=True)
        export_s = time.perf_counter() - t0
        check(any(ln.startswith("roundtrip check ok") for ln in logs.lines),
              f"{name}{tag} export --check: {logs.lines}")
        loaded = torch.export.load(out)
        targets = [str(n.target) for n in loaded.graph.nodes
                   if n.op == "call_function"]
        nodes = tuple(targets.count(f"futuredet.{op}.default") for op in (
            "nms_alive", "circle_nms", "gather_conv"))
        check(nodes == want_nodes, f"{name}{tag}: the exported program "
              f"holds (K1, circle NMS, K2) operators {nodes}")
        exported = loaded.module()
        want_launches = (want_nodes[0], want_nodes[2])

        P = cfg.voxel.max_points
        if name == NAME:    # phase 4's scene, padded with invalid rows
            pts, valid = scene_uniform(cfg.replace(voxel=dataclasses.replace(
                cfg.voxel, max_points=MAX_POINTS)), np.random.default_rng(0))
            pts = np.concatenate([pts, np.zeros(
                (1, P - pts.shape[1], 5), np.float32)], 1)
            valid = np.concatenate([valid, np.zeros(
                (1, P - valid.shape[1]), bool)], 1)
        else:               # phase 8's scene
            pts, valid = scene_blobs(cfg, np.random.default_rng(0))
        pts = torch.from_numpy(pts).to(dev)
        valid = torch.from_numpy(valid).to(dev)
        program = tools.inference_program(cfg,
                                          build_detector(cfg, dev, seed=0))
        runs = {}
        # the pillar reader's scatter-adds take torch's deterministic
        # kernels, so that two runs of the same ops agree bit for bit
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            for route, fn in (("exported", exported), ("eager", program)):
                k1.launches = k2.launches = 0
                with torch.no_grad():
                    runs[route] = fn(pts, valid)
                torch.cuda.synchronize()
                runs[route + "_launches"] = (k1.launches, k2.launches)
        finally:
            torch.use_deterministic_algorithms(False)
        check(runs["exported_launches"] == runs["eager_launches"]
              == want_launches, f"{name}{tag}: (K1, K2) launches exported "
              f"{runs['exported_launches']}, eager {runs['eager_launches']}")
        same = [bool(torch.equal(a, b)) for a, b in zip(runs["exported"],
                                                        runs["eager"])]
        n_det = int(runs["eager"][3].sum())
        check(all(same) and n_det > 0, f"{name}{tag} exported vs eager: "
              f"{dict(zip(('boxes', 'scores', 'labels', 'valid'), same))}, "
              f"{n_det} detections")
        line = {"phase": "export", "model": name + tag, "knob": knob,
                "card": card, "export_and_check_s": round(export_s, 3),
                "artifact_bytes": os.path.getsize(out),
                "export_log": logs.lines, "points_buffer": P,
                "points_valid": int(valid.sum()), "detections": n_det,
                "bit_identical": True,
                "operator_nodes": dict(zip(("nms_alive", "circle_nms",
                                            "gather_conv"), nodes)),
                "launches_exported": runs["exported_launches"],
                "launches_eager": runs["eager_launches"]}
        if timed:
            def timed_run(fn):
                def run():
                    with torch.no_grad():
                        return fn(pts, valid)
                return time_host(run)
            turns = {"eager": [], "exported": []}
            for route in ("eager", "exported", "exported", "eager"):
                turns[route].append(timed_run(program if route == "eager"
                                              else exported))
            line.update(ms_per_scene_turns=turns,
                        eager_ms=statistics.median(turns["eager"]),
                        exported_ms=statistics.median(turns["exported"]))
        emit(line)
        launches[name + tag + "_exported"] = {"k1": want_launches[0],
                                              "k2": want_launches[1]}
        del program, exported, loaded, runs
        torch.cuda.empty_cache()
    return launches


def profile_path(dev, card, work):
    """Phase 36. Returns the launches of the profiled steps."""
    import glob

    from futuredet_torch.utils.profiling import device_memory_stats

    trace_dir = os.path.join(work, "profile")
    runs = {}
    for name, extra in (("profiled", ["--profile", trace_dir]),
                        ("unprofiled", [])):
        argv = ["--model", VOX_NAME, "--device", str(dev), "--synthetic",
                "1", "--batch_size",
                "1", "--epochs", "2", "--seed", str(TRAIN_SEED),
                "--work_dir", os.path.join(work, f"profile_{name}"), *extra]
        hook = StepCounts()
        state, logs, secs = run_train_cli(argv, hook)
        check(state.step == 2, f"{name}: {state.step} steps")
        runs[name] = {"steps": hook.steps, "cli_s": round(secs, 3)}
        for st in hook.steps:
            check((st["k2_forward"], st["k2_dx"], st["k1"]) == (20, 19, 0)
                  and st["finite"], f"{name} step {st}")
    files = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
    check(len(files) == 1, f"trace files {files}")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    k2_names = ("narrow_kernel", "wide_kernel", "bf16_kernel")
    k2_events = [k for k in kernels if any(n in k for n in k2_names)]
    conv_events = [k for k in kernels if re.search(r"(?i)cudnn|conv", k)
                   and k not in k2_events]
    check(len(k2_events) == 2 * 39, f"the trace holds {len(k2_events)} K2 "
          "launches for 2 steps")
    check(conv_events, "the trace names no cuDNN convolution")
    mem = device_memory_stats()
    check(mem and all(v > 0 for v in mem.values()), f"memory stats {mem}")
    emit({"phase": "profile", "model": VOX_NAME, "card": card,
          "trace_bytes": os.path.getsize(files[0]),
          "kernel_events": len(kernels),
          "k2_events_per_step": len(k2_events) / 2,
          "k2_kernel_names": sorted(set(k2_events))[:6],
          "conv_kernel_names": sorted(set(conv_events))[:6],
          "device_memory_stats": mem,
          "step_ms_profiled": [st["step_ms"]
                               for st in runs["profiled"]["steps"]],
          "step_ms_unprofiled": [st["step_ms"]
                                 for st in runs["unprofiled"]["steps"]],
          "cli_s": {k: v["cli_s"] for k, v in runs.items()}})
    return {VOX_NAME + "_profiled_train": {"k1": 0, "k2": 2 * 39}}


def flops_path(dev, card, scene_ms):
    """Phase 37: model_flops against the analytic count, at full width;
    the timed scenes' analytic flops over their ms."""
    import dataclasses

    from futuredet_torch.config import get_config
    from futuredet_torch.models.detector import build_detector
    from futuredet_torch.utils.flops import model_flops

    for name, scene in ((NAME, "uniform"), (VOX_NAME, "uniform_blobs")):
        cfg = get_config(name)
        t0 = time.perf_counter()
        got = model_flops(cfg, device=dev)
        count_s = time.perf_counter() - t0
        P = cfg.voxel.max_points
        model = build_detector(cfg, dev, seed=0)
        want, parts = analytic_flops(
            model, torch.zeros(1, P, 5, device=dev),
            torch.ones(1, P, dtype=torch.bool, device=dev))
        check(got["flops"] == want, f"{name}: model_flops {got['flops']} "
              f"!= analytic {want} ({parts})")
        if name == NAME:       # phase 5's uniform scene in its buffer
            pts, valid = scene_uniform(cfg.replace(voxel=dataclasses.replace(
                cfg.voxel, max_points=MAX_POINTS)), np.random.default_rng(0))
        else:                  # phase 9's uniform_blobs scene
            pts, valid = scene_blobs(cfg, np.random.default_rng(0))
        timed, timed_parts = analytic_flops(
            model, torch.from_numpy(pts).to(dev),
            torch.from_numpy(valid).to(dev))
        ms = scene_ms[name][scene]
        emit({"phase": "flops", "model": name, "card": card,
              "gflop_per_scene": got["flops"] / 1e9,
              "analytic_parts_gflop": {k: v / 1e9 for k, v in parts.items()},
              "bytes_accessed_unfused": got["bytes_accessed"],
              "count_s": round(count_s, 3), "scene": scene,
              "scene_gflop": timed / 1e9,
              "scene_parts_gflop": {k: v / 1e9
                                    for k, v in timed_parts.items()},
              "scene_ms": ms,
              "achieved_tflop_per_s": timed / (ms * 1e-3) / 1e12,
              "note": "the timed scene's analytic flops over its ms: a "
                      "figure, not a gate"})


def tools_path(dev, card, work, pp_dir):
    """Phase 38. Returns the launches of the --postprocess evaluation."""
    import copy
    import dataclasses
    import glob

    from futuredet_torch.cli import tools
    from futuredet_torch.config import get_config
    from futuredet_torch.models.readers import (PillarFeatureNet,
                                                scatter_to_bev)
    from futuredet_torch.ops.voxelize import point_voxel_map

    root = os.path.join(work, "nuscenes")
    train_pkl, = glob.glob(os.path.join(root, "infos_train_*.pkl"))
    val_pkl, = glob.glob(os.path.join(root, "infos_val_*.pkl"))
    nusc_ckpt = os.path.join(work, f"nusc_{NAME}")
    post_dir = os.path.join(work, "postprocess")
    os.makedirs(post_dir)
    here = os.getcwd()
    os.chdir(post_dir)       # evaluate reads ./car_trajectory.pkl
    try:
        protos = tools.main(["trajectory", "--info_path", train_pkl])
        check(protos and os.path.exists("car_trajectory.pkl"),
              f"{len(protos)} prototypes")
        summary, per_call, total, logs, secs = run_evaluate(eval_args(
            dev, NAME, f"metrics_{NAME}_postprocess", "--info_path",
            val_pkl, "--checkpoint_dir", nusc_ckpt, "--postprocess"))
    finally:
        os.chdir(here)
    check(not any("not found" in ln for ln in logs),
          "the prototypes file was not found")
    check(per_call == [(1, 0)] * NUSC_KEYFRAMES,
          f"--postprocess: (K1, K2) launches {per_call}")
    check_summary(summary, "--postprocess")
    check(os.path.exists(metrics_path(f"metrics_{NAME}_postprocess")),
          "no metrics JSON")
    counts = tools.main(["statistics", "--info_path", train_pkl])
    check(sum(counts.values()) > 0, f"statistics {counts}")
    changed, same = tools.main(["compare", pp_dir, nusc_ckpt])
    check(len(changed) > len(same), f"compare: {len(changed)} changed, "
          f"{len(same)} identical")
    changed_self, same_self = tools.main(["compare", pp_dir, pp_dir])
    check(not changed_self and len(same_self) == len(changed) + len(same),
          "compare of a checkpoint with itself")

    # the sorted reader on phase 4's scene, card against CPU
    cfg = get_config(NAME)
    v = cfg.voxel
    pts, valid = scene_uniform(cfg.replace(voxel=dataclasses.replace(
        v, max_points=MAX_POINTS)), np.random.default_rng(0))
    H, W = v.grid_size[1], v.grid_size[0]
    rng = np.random.default_rng(5)
    cpu = PillarFeatureNet(5, tuple(cfg.model.pillar_filters),
                           v.voxel_size[:2], v.pc_range).eval()
    for layer in cpu.pfn_layers:
        layer.norm.running_mean.copy_(torch.from_numpy(rng.normal(
            0, 0.2, layer.norm.running_mean.shape).astype(np.float32)))
        layer.norm.running_var.copy_(torch.from_numpy(rng.uniform(
            0.5, 1.5, layer.norm.running_var.shape).astype(np.float32)))
    card_mod = copy.deepcopy(cpu).to(dev)
    canvases = {}
    for where, mod, d in (("card", card_mod, dev), ("cpu", cpu, "cpu")):
        m = point_voxel_map(torch.from_numpy(pts).to(d),
                            torch.from_numpy(valid).to(d), v.pc_range,
                            v.voxel_size, grid_size=v.grid_size,
                            max_voxels=v.max_voxels_eval,
                            max_points=v.max_points_per_voxel)
        with torch.no_grad():
            canvases[where] = (scatter_to_bev(mod(m), m.coords, (H, W))
                               .cpu(), len(m.first))
    (gc, n_card), (cc, n_cpu) = canvases["card"], canvases["cpu"]
    err = float((gc - cc).abs().max())
    tol = SORTED_READER_RTOL * max(1.0, float(cc.abs().max()))
    check(n_card == n_cpu and err <= tol,
          f"sorted reader card vs CPU: {err} > {tol} ({n_card} vs {n_cpu} "
          "pillars)")
    emit({"phase": "tools", "card": card, "prototypes": len(protos),
          "postprocess_launches_per_sample": per_call,
          "postprocess_eval_s": round(secs, 3),
          "car": headline(summary, "car") if "car" in
          summary["mean_dist_aps"] else None,
          "statistics": counts, "compare_changed": len(changed),
          "compare_identical": same,
          "compare_identical_self": len(same_self),
          "sorted_reader_pillars": n_card,
          "sorted_reader_max_abs_err": err, "sorted_reader_tol": tol})
    return {NAME + "_postprocess_eval": {"k1": total[0], "k2": total[1]}}


# ---------------------------------------------------------------------------
# 39. Spatial sharding of the canvas (--space) on gloo ranks of one card
# ---------------------------------------------------------------------------

# the jobs of each layout's ranks, in order (one process a rank): pp the
# pillar config, vox forecast_n3dtf, pp2 the pillar two-stage config, dcn
# forecast_n0 with dcn_head (seeded random offset convs)
SPACE_JOBS = {2: ("pp_eval", "vox_eval", "pp_train", "vox_train",
                  "pp2_eval", "pp2_train", "dcn_eval", "dcn_train"),
              3: ("pp_eval",)}
SPACE_CONFIGS = {"pp": NAME, "vox": VOX_NAME, "pp2": NAME + "_two_stage",
                 "dcn": "forecast_n0"}
# the dcn jobs' offset convs: seeded weights of this std (the zero init
# makes a deformable conv a plain 3x3, which would hide a wrong gather;
# tests/test_torch_head_modes.py's), so that taps reach across the bands
DCN_OFFSET_STD, DCN_OFFSET_SEED = 0.5, 39
SPACE_RTOL = 1e-5          # a head map's max |diff| of its max |unsharded|
SPACE_WARMUP, SPACE_REPS = 1, 3
SPACE_NUDGE = 2.0 ** -20   # phase 39's spread: weights scaled by 1 + this
SPACE_TIMEOUT_S = 420      # a layout's ranks, all jobs
# the CPU rehearsal (tests/test_torch_chip_smoke_spatial.py): the ranks
# take the tiny configs and count K1 and K2's plain versions
SPACE_REHEARSAL = False


def space_config(job):
    """The config of a phase 39 job (SPACE_CONFIGS): a pillar config at
    phase 2's buffer (eval) or phase 14's (train), forecast_n3dtf, or
    forecast_n0 under dcn_head."""
    import dataclasses

    from futuredet_torch.config import get_config, tiny_variant
    kind = job.split("_")[0]
    cfg = get_config(SPACE_CONFIGS[kind])
    if kind == "dcn":
        cfg = cfg.replace(model=dataclasses.replace(
            cfg.model, head=dataclasses.replace(cfg.model.head,
                                                dcn_head=True)))
    if SPACE_REHEARSAL:
        return tiny_variant(cfg)
    if cfg.model.detector != "pointpillars":
        return cfg
    if job.endswith("eval"):
        return cfg.replace(voxel=dataclasses.replace(
            cfg.voxel, max_points=MAX_POINTS, max_voxels_eval=30000))
    return cfg.replace(voxel=dataclasses.replace(
        cfg.voxel, max_points=MAX_POINTS))


def random_offsets_(model) -> None:
    """The DCN offset convs' weights drawn from DCN_OFFSET_SEED at
    DCN_OFFSET_STD, their biases left at 0 (nothing for other heads)."""
    from futuredet_torch.models.center_head import FeatureAdaption
    g = torch.Generator().manual_seed(DCN_OFFSET_SEED)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, FeatureAdaption):
                w = m.conv_offset.weight
                w.copy_(torch.randn(w.shape, generator=g) * DCN_OFFSET_STD)


def space_inputs(job, cfg, dev):
    """A job's scene: phase 4's uniform scene, phase 8's uniform_blobs
    scene, or phase 10's lidar-family train batch (phase 14's clutter for
    the pillars)."""
    vox = space_config(job).model.detector == "voxelnet"
    if job.endswith("train"):
        clutter = ((1500 if vox else 800) if SPACE_REHEARSAL
                   else TRAIN_CLUTTER if vox else PILLAR_TRAIN_CLUTTER)
        return train_batch(cfg, TRAIN_SEED, dev, clutter)
    scene = (scene_blobs if vox else scene_uniform)(
        cfg, np.random.default_rng(0))
    return tuple(torch.from_numpy(a).to(dev) for a in scene)


def space_sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def space_ms(fn, dev):
    """Median wall ms of fn() synced, SPACE_REPS after SPACE_WARMUP (one
    run on the CPU)."""
    reps = SPACE_REPS if dev.type == "cuda" else 1
    for _ in range(SPACE_WARMUP if dev.type == "cuda" else 0):
        fn()
    ts = []
    for _ in range(reps):
        space_sync(dev)
        t0 = time.perf_counter()
        fn()
        space_sync(dev)
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def space_job(job, dev, space=None, nudge=0.0, dtype=None):
    """One job of phase 39 on `dev`, whole (`space` None) or on this rank's
    band: its outputs (eval: the head maps and, on a space group's first
    rank or whole, the detections, a two-stage model's refined ones on
    every rank; train: the first step's metrics, gradients before the clip
    and running statistics), its launches (K1, K2, K2 dx; counts zeroed
    just before the forward or step, read just after), the halo exchanges
    and bytes it made and the DCN gathers', ms of the forward or step and
    peak MiB. `nudge` scales every weight by 1 + nudge after the
    BatchNorm biases are raised (train); `dtype` (train, unsharded) runs
    the step's model and points in it, untimed."""
    from futuredet_torch.eval.decode import decode_and_nms
    from futuredet_torch.models.detector import (build_detector,
                                                 lay_out_space_)
    from futuredet_torch.models.two_stage import refined_detections
    from futuredet_torch.ops import pallas_gather, pallas_nms
    from futuredet_torch.ops import sparse_conv as sc_mod
    from futuredet_torch.parallel import collectives as coll
    from futuredet_torch.train import step as step_mod

    cfg = space_config(job)
    inputs = space_inputs(job, cfg, dev)
    k1, k2 = pallas_nms.rotate_nms_alive, pallas_gather.gather_conv
    card = dev.type == "cuda"
    if card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    model = build_detector(cfg, device=dev, seed=0)
    random_offsets_(model)
    if dtype is not None:
        model = model.to(dtype)
        inputs = dict(inputs, points=inputs["points"].to(dtype))
    model = lay_out_space_(model, space)
    two = cfg.model.two_stage_refine
    out = {"job": job}
    dx_fn, dx = sc_mod.subm_conv_dx, [0]

    def counting_dx(*args):
        before = k2.launches
        res = dx_fn(*args)
        dx[0] += k2.launches - before
        return res

    k1.launches = k2.launches = 0
    coll.reset_halo_stats()
    if job.endswith("eval"):
        decoder = space is None or space.index == 0
        with torch.no_grad():
            preds = model(*inputs)
            if two:         # every rank ran the RoI stage whole
                preds, det = preds[0], refined_detections(*preds[1:])
            else:
                det = decode_and_nms(cfg, preds) if decoder else None
        space_sync(dev)
        out["maps"] = [{k: v.cpu() for k, v in t.items() if k != "feats"}
                       for t in preds]
        out["det"] = None if det is None else type(det)(
            *(x.cpu() for x in det))
        counts_halo = dict(coll.HALO_STATS)
        k1_n, k2_n = k1.launches, k2.launches

        def forward():
            with torch.no_grad():
                model(*inputs)
        out["ms"] = space_ms(forward, dev)
    else:
        model.train()
        shift_bn_biases(model)
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(1.0 + nudge)
        opt = step_mod.make_optimizer(cfg, model, 2 + 2 * SPACE_REPS)
        name_of = {id(p): n for n, p in model.named_parameters()}
        out["trainable"] = {name_of[id(p)] for g in opt.param_groups
                            for p in g["params"]}
        seen = {}
        apply_update = step_mod.apply_update

        def recording(m, o, count):
            seen.update({n: grad_of(p).float().cpu()
                         for n, p in m.named_parameters()})
            return apply_update(m, o, count)

        step_mod.apply_update, sc_mod.subm_conv_dx = recording, counting_dx
        try:
            metrics = step_mod.train_step(model, opt, inputs, 0)
            space_sync(dev)
        finally:
            step_mod.apply_update, sc_mod.subm_conv_dx = apply_update, dx_fn
        counts_halo = dict(coll.HALO_STATS)
        k1_n, k2_n = k1.launches, k2.launches
        out["metrics"] = {k: v.detach().float().cpu()
                          for k, v in metrics.items()}
        out["grads"] = seen
        # copies: on the CPU `.cpu()` would alias the buffers, which the
        # timed steps below update again
        out["stats"] = {n: t.detach().to("cpu", copy=True)
                        for n, t in model.named_buffers()
                        if n.endswith(("running_mean", "running_var"))}
        count = [1]

        def step():
            step_mod.train_step(model, opt, inputs, count[0])
            count[0] += 1
        out["ms"] = space_ms(step, dev) if dtype is None else None
    out["launches"] = {"k1": k1_n, "k2": k2_n, "k2_dx": dx[0]}
    out["halo"] = counts_halo
    out["peak_mib"] = (torch.cuda.max_memory_allocated() / 2 ** 20
                       if card else 0.0)
    del model
    return out


def count_plain_versions():
    """The CPU rehearsal: K1 and K2's wrappers count their plain versions'
    calls (on the card they count their launches)."""
    from futuredet_torch.ops import pallas_gather, pallas_nms
    for mod, name, wrapper in (
            (pallas_nms, "nms_alive_plain", pallas_nms.rotate_nms_alive),
            (pallas_gather, "gather_conv_plain", pallas_gather.gather_conv)):
        def counted(*args, plain=getattr(mod, name), wrapper=wrapper):
            wrapper.launches += 1
            return plain(*args)
        setattr(mod, name, counted)


def space_rank(rank_, world, port, out_path, device, rehearsal):
    """One rank of phase 39: a gloo group of `world` processes on this
    card (NCCL refuses two ranks on one device), the space layout of one
    space group, every job of SPACE_JOBS[world] on its band under torch's
    deterministic algorithms, TF32 off; the results saved to
    `out_path`."""
    import torch.distributed as dist

    from futuredet_torch.parallel.mesh import make_space_group
    global SPACE_REHEARSAL
    SPACE_REHEARSAL = rehearsal
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    else:
        torch.set_num_threads(1)
        count_plain_versions()
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank_)
    try:
        space = make_space_group(world)
        res = {"rank": dist.get_rank(), "backend": dist.get_backend(),
               "device": str(dev), "index": space.index,
               "jobs": [space_job(job, dev, space)
                        for job in SPACE_JOBS[world]]}
        torch.save(res, out_path)
    finally:
        dist.destroy_process_group()


def run_space_ranks(world, dev, work):
    """Phase 39's `world` ranks, each its own process, waited for with
    SPACE_TIMEOUT_S; a rank that fails or times out fails the phase (every
    rank is killed). Returns the ranks' results and the seconds."""
    port = free_port()
    outs = [os.path.join(work, f"space{world}_rank{r}.pt")
            for r in range(world)]
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import chip_smoke as cs; cs.space_rank(int(sys.argv[2]), "
            "int(sys.argv[3]), sys.argv[4], sys.argv[5], sys.argv[6], "
            "sys.argv[7] == '1')")
    env = dict(os.environ, PYTHONPATH=ROOT)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, ROOT, str(r), str(world), str(port),
         outs[r], dev.type, "1" if SPACE_REHEARSAL else "0"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=SPACE_TIMEOUT_S)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        check(p.returncode == 0, f"space rank {r}/{world} failed "
              f"(exit {p.returncode}): {log[-3000:]}")
    return ([torch.load(o, weights_only=False) for o in outs],
            time.perf_counter() - t0)


def frozen_gate(plain, exact):
    """Phase 27's gate for a two-stage step's frozen gradients, as a
    fraction of each tensor's max |g|: twice the worst distance of the
    float32 step `plain` from the float64 one `exact` over its gradient
    tensors (each of its max; tensors zero up to rounding left out), at
    least GRAD_FRACTION."""
    top = max(float(g.abs().max()) for g in exact["grads"].values())
    worst = max(float((plain["grads"][n] - g).abs().max())
                / float(g.abs().max())
                for n, g in exact["grads"].items()
                if float(g.abs().max()) > ZERO_FRACTION * top)
    return max(GRAD_FRACTION, 2.0 * worst)


def space_train_rule(got, plain, other, piecewise=False, exact=None):
    """Phase 39's rule for a sharded train step `got` against the
    unsharded one `plain` on the same weights and batch: within DP_SPREAD
    times the distance of `other`, the unsharded step with every weight
    nudged by SPACE_NUDGE (rounding-sized changes, carried through the
    model as the banded step's other order of additions is), quantity by
    quantity; a gradient tensor whose own spread is below ZERO_FRACTION
    of the model's max |g| by that floor.

    A `piecewise` step is one whose gradients jump at rounding-sized
    changes that a uniform nudge of the weights cannot make: a two-stage
    model's (the RoI MLP's ReLUs, with no BatchNorm bias to raise; the
    rotated IoU's clip cases and thresholds in the proposal targets, in
    the proposals' boxes) and dcn_head's (the ReLU after the deformable
    conv, which has no bias: scaling its weights never flips an output's
    sign). Its losses are also let within LOSS_RTOL and its gradients
    within GRAD_FRACTION of their tensor's max |g|: phase 12's limits for
    a card step against the CPU's. (The card, PR 16: a two-stage step's
    first-stage gradients 0.2-0.35% of their max from the unsharded, one
    RoI-MLP ReLU flip moved a weight gradient 0.1% of its max in the
    tiny rehearsal, a DCN adaption weight's 0.26%.) `exact`, the
    unsharded step in float64 (a two-stage step's), also lets each frozen
    gradient (not in the optimizer: it reaches only grad_norm) within
    `frozen_gate` of its max: phase 27's gate for a two-stage step's
    frozen gradients, whose sums of cancelling terms (no heatmap loss)
    float32 holds only to per cents (the card, PR 16: `forecast_conv.1.
    bias` of a pseudo-task 2.1% of its max from the unsharded). Returns
    {quantity: (err, limit)} and the violations."""
    out = {}
    for k in ("loss", "hm_loss", "loc_loss", "roi_cls_loss", "roi_reg_loss",
              "grad_norm"):
        if k not in plain["metrics"]:
            continue
        a, b, c = (x["metrics"][k].double() for x in (got, plain, other))
        ulp = 2.0 ** -23 * float(b.abs().max())
        limit = DP_SPREAD * max(float((c - b).abs().max()), ulp)
        if piecewise and k != "grad_norm":
            limit = max(limit, LOSS_RTOL * float(b.abs().max()))
        out[f"metric:{k}"] = (float((a - b).abs().max()), limit)
    top = max(float(g.abs().max()) for g in plain["grads"].values())
    gate = None if exact is None else frozen_gate(plain, exact)
    for n, g in plain["grads"].items():
        spread = float((other["grads"][n] - g).abs().max())
        limit = DP_SPREAD * max(spread, ZERO_FRACTION * top)
        if piecewise:
            limit = max(limit, GRAD_FRACTION * float(g.abs().max()))
        if exact is not None and n not in plain["trainable"]:
            limit = max(limit, gate * float(g.abs().max()))
        out[f"grad:{n}"] = (float((got["grads"][n] - g).abs().max()), limit)
    for n, s in plain["stats"].items():
        spread = float((other["stats"][n] - s).abs().max())
        out[f"stat:{n}"] = (float((got["stats"][n] - s).abs().max()),
                            DP_SPREAD * max(spread, 2.0 ** -23 * float(
                                s.abs().max())))
    return out, {k: v for k, v in out.items() if not v[0] <= v[1]}


def space_path(dev, card, work):
    """Phase 39: spatial sharding of the canvas on gloo ranks of this card
    (host-staged collectives; NCCL refuses two ranks on one device, so
    this is no multi-card figure). The unsharded references in this
    process, under torch's deterministic algorithms and flax's
    BatchNorm formula (the banded one's): phase 4's pillar scene, phase
    8's VoxelNet scene and a B = 1 train step of each model on phase 10's
    scene (every BatchNorm bias raised by BN_BIAS_SHIFT, as phase 12), the
    step again on weights nudged by SPACE_NUDGE (the spread); the same
    for the pillar two-stage config (and its step in float64) and for
    forecast_n0 under dcn_head;
    then SPACE_JOBS on 2 ranks and pp_eval on 3 (uneven bands). Checks:
    every rank's head maps within SPACE_RTOL of max |unsharded|, the first
    rank's detections (a two-stage model's refined ones) matched as in
    phase 4 (near ties let off at the cut within NEAR_CAP); K1 once a
    single-stage scene on the first rank and never on the others, once a
    two-stage scene and a two-stage step on every rank (each decodes the
    gathered maps for its RoI stage), whose refined detections are the
    same on every rank; K2 20 a VoxelNet scene on every rank, 20 + 19 a
    VoxelNet step; one DCN gather a DCNSepHead forward and one more in
    its backward; the step by `space_train_rule` on every rank
    (`piecewise` for the two-stage and dcn jobs), the ranks' gradients and
    running statistics bit-identical. Figures: per
    rank ms of the forward or step and peak MiB beside the unsharded
    ones, halo exchanges and bytes and the DCN gathers' bytes a forward or
    step. Returns the launches of the ranks' runs."""
    from futuredet_torch.models.layers import BatchNorm2d
    from futuredet_torch.parallel import collectives as coll

    t0 = time.perf_counter()
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    # the banded BatchNorms take flax's formula: so does the reference
    BatchNorm2d.flax_stats = True
    try:
        ref = {job: space_job(job, dev) for job in SPACE_JOBS[2]}
        other = {job: space_job(job, dev, nudge=SPACE_NUDGE)
                 for job in SPACE_JOBS[2] if job.endswith("train")}
        exact = {job: space_job(job, dev, dtype=torch.float64)
                 for job in SPACE_JOBS[2] if job.endswith("train")
                 and space_config(job).model.two_stage_refine}
    finally:
        BatchNorm2d.flax_stats = False
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
    check(coll.HALO_STATS["exchanges"] == 0, "the unsharded runs exchanged "
          "halos")
    ref_s = time.perf_counter() - t0
    runs = {w: run_space_ranks(w, dev, work) for w in sorted(SPACE_JOBS)}
    launches = {}
    for world, (ranks, secs) in runs.items():
        line = {"phase": "spatial_sharding", "card": card,
                "backend": ranks[0]["backend"], "ranks": world,
                "ranks_on": sorted({r["device"] for r in ranks}),
                "collectives": "gloo, staged through the host: one card, "
                               "not a multi-card figure",
                "ranks_s": round(secs, 3), "references_s": round(ref_s, 3)}
        for j, job in enumerate(SPACE_JOBS[world]):
            got = [r["jobs"][j] for r in ranks]
            base = ref[job]
            cfg = space_config(job)
            vox = cfg.model.detector == "voxelnet"
            two = cfg.model.two_stage_refine
            per = {"ms": [g["ms"] for g in got], "unsharded_ms": base["ms"],
                   "peak_mib": [g["peak_mib"] for g in got],
                   "unsharded_peak_mib": base["peak_mib"],
                   "launches": [g["launches"] for g in got],
                   "halo_exchanges": [g["halo"]["exchanges"] for g in got],
                   "halo_bytes": [g["halo"]["bytes"] for g in got],
                   "dcn_gathers": [g["halo"]["gathers"] for g in got],
                   "dcn_gather_bytes": [g["halo"]["gather_bytes"]
                                        for g in got]}
            check(all(g["halo"]["exchanges"] > 0 for g in got),
                  f"{job} at {world} ranks: no halo exchange")
            # a DCNSepHead gathers its input once a forward, and sums its
            # cotangent once a backward
            n_dcn = (len(cfg.model.head.num_classes)
                     * (2 if job.endswith("train") else 1)
                     if cfg.model.head.dcn_head else 0)
            check(per["dcn_gathers"] == [n_dcn] * world,
                  f"{job} at {world} ranks: DCN gathers "
                  f"{per['dcn_gathers']}, want {n_dcn} a rank")
            if job.endswith("eval"):
                err = 0.0
                for g in got:
                    for t_got, t_ref in zip(g["maps"], base["maps"]):
                        check(set(t_got) == set(t_ref), f"{job}: map keys")
                        for k, v in t_ref.items():
                            e = float((t_got[k] - v).abs().max())
                            check(e <= SPACE_RTOL * float(v.abs().max()),
                                  f"{job} at {world} ranks, {k}: {e} off "
                                  f"(max {float(v.abs().max())})")
                            err = max(err, e)
                hm_err = max(float((torch.sigmoid(a["hm"])
                                    - torch.sigmoid(b["hm"])).abs().max())
                             for g in got
                             for a, b in zip(g["maps"], base["maps"]))
                # the regression maps' differences move boxes, and with
                # them NMS decisions among the untrained heads' near ties
                # at the cut: a cut of NEAR_CAP, as phases 4 and 8 reach
                match = check_detections_match(cfg, got[0]["det"],
                                               base["det"], NEAR_CAP)
                if two:
                    # every rank decoded the gathered maps (K1) and ran
                    # the RoI stage: one result
                    for g in got[1:]:
                        check(all(torch.equal(a, b) for a, b in
                                  zip(g["det"], got[0]["det"])),
                              f"{job}: the ranks' refined detections "
                              "differ")
                else:
                    check(all(g["det"] is None for g in got[1:]),
                          f"{job}: a rank other than the first decoded")
                want = [{"k1": int(two or i == 0), "k2": 20 if vox else 0,
                         "k2_dx": 0} for i in range(world)]
                check(per["launches"] == want,
                      f"{job} at {world} ranks: launches {per['launches']}")
                per.update(max_abs_err=err, heatmap_max_abs_err=hm_err,
                           kept=match[:2], let_off_at_the_cut=match[2])
            else:
                for g in got[1:]:
                    for kind in ("grads", "stats"):
                        for n, a in got[0][kind].items():
                            check(torch.equal(a, g[kind][n]),
                                  f"{job}: ranks' {kind} {n} differ")
                measures, bad = space_train_rule(
                    got[0], base, other[job],
                    piecewise=two or cfg.model.head.dcn_head,
                    exact=exact.get(job))
                check(not bad, f"{job} at {world} ranks beyond the rule: "
                      f"{dict(list(bad.items())[:8])}")
                worst = max(measures.items(),
                            key=lambda kv: kv[1][0] / max(kv[1][1], 1e-300))
                # a two-stage step decodes (K1) on every rank
                want = [{"k1": int(two), "k2": 39 if vox else 0,
                         "k2_dx": 19 if vox else 0}] * world
                check(per["launches"] == want,
                      f"{job} at {world} ranks: launches {per['launches']}")
                per.update(loss=float(got[0]["metrics"]["loss"]),
                           unsharded_loss=float(base["metrics"]["loss"]),
                           grad_norm=float(got[0]["metrics"]["grad_norm"]),
                           unsharded_grad_norm=float(
                               base["metrics"]["grad_norm"]),
                           worst_of_rule={worst[0]: worst[1]},
                           quantities=len(measures), dp_spread=DP_SPREAD,
                           piecewise=two or cfg.model.head.dcn_head,
                           float64_reference=job in exact,
                           frozen_grad_gate=(frozen_gate(base, exact[job])
                                             if job in exact else None))
            line[job] = per
            launches[f"{cfg.name}_space{world}_{job}"] = {
                "k1": sum(x["k1"] for x in per["launches"]),
                "k2": sum(x["k2"] for x in per["launches"])}
        emit(line)
    return launches


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
                        "gather_conv_bf16_kernel.cu",
                        "host_accumulate.cpp"}, f"built {sorted(secs)}")
    spills = [ln for name in ("nms_kernel.cu", "gather_conv_kernel.cu",
                              "gather_conv_bf16_kernel.cu")
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
        pp_dir, pp_map = pp_eval.pop("checkpoint_dir"), pp_eval.pop("mAP")
        vox_eval = cli_voxelnet_path(dev, card, vox_ckpt, vox["scene_ms"])
        tta = tta_path(dev, card, {NAME: pp_dir, VOX_NAME: vox_ckpt})
        nusc = nusc_path(dev, card, work)
        metrics_engine_path(dev, card)
        modes = head_modes_path(dev, card)
        modes_train = head_modes_train_path(dev, card)
        modes_cli = head_modes_cli_path(dev, card)
        two = two_stage_path(dev, card)
        two_train = two_stage_train_path(dev, card)
        two_cli = two_stage_cli_path(dev, card, pp_dir, pp_map)
        serving = serving_path(dev, card)
        dense = dense_middle_path(dev, card)
        # the CPU cross-check of the knob that runs K2's bf16 family; the
        # other three knobs' are scripts/torch_train_bf16_phases.py's
        bf16_train = bf16_train_path(dev, card, cross_checked=("a_bf16",))
        dp = dp_path(dev, card, work)
        exported = export_path(dev, card, work)
        profiled = profile_path(dev, card, work)
        flops_path(dev, card, {NAME: k1["scene_ms"],
                               VOX_NAME: vox["scene_ms"]})
        post = tools_path(dev, card, work, pp_dir)
        space = space_path(dev, card, work)

    evals = {NAME + "_eval": pp_eval, VOX_NAME + "_eval": vox_eval, **tta,
             **nusc, **modes_cli, **two_cli, **serving["paths"], **dense,
             **{f"{n}_head_mode": v for n, v in modes.items()},
             **{f"{n}_head_mode_train": {"k1": v["k1"], "k2": v["k2_forward"]
                                         + v["k2_dx"]}
                for n, v in modes_train.items()},
             **{n: {"k1": v["k1"], "k2": v["k2"]} for n, v in two.items()},
             **bf16_train, **dp, **exported, **profiled, **post, **space,
             **{f"{n}_train": {"k1": v["k1"], "k2": v["k2_forward"]
                               + v["k2_dx"]}
                for n, v in two_train.items()}}
    emit({"phase": "total", "script_s": round(time.perf_counter() - T_START,
                                              1)})
    print(card, flush=True)
    k2, bf16 = vox["k2"], serving["k2_bf16"]
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
        "problems_g_by_head_mode": {n: v["g"] for n, v in
                                    {**modes, **two}.items()},
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
            "k2_dx_tc_bound_ms", "dw_db_bound_ms")}}, {
        "name": "K2 sparse gather-conv, bf16 family",
        "route": "cuda",
        "source": "futuredet_torch/csrc/gather_conv_bf16_kernel.cu",
        "replaces": "futuredet_tpu/ops/pallas_gather.py:49",
        "launches": sum(v["k2_bf16"] for v in {**serving["paths"],
                                                **bf16_train}.values()),
        "launches_by_path": {p: v["k2_bf16"] for p, v in
                             {**serving["paths"], **bf16_train}.items()},
        "matched": True, "max_abs_err": bf16["max_abs_err"],
        "ms": bf16["ms"], "plain_ms": bf16["plain_ms"],
        "bound_ms": bf16["bound_ms"], "bound_by": bf16["bound_by"],
        "library_ms": bf16["library_ms"],
        "times_are": "sums over the 20 bf16 convs of one scene under "
                     "compute_dtype and middle_sparse_dtype bfloat16"}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
