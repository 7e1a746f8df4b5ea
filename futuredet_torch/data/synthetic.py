"""Synthetic nuScenes-like scenes, the port's own copy.

A numpy copy of `futuredet_tpu/data/synthetic.py` (`make_scene`,
`_lidar_clutter`, `SCENE_FAMILIES` and their constants; tests hold the two
bit-identical), so that the port and `chip_smoke.py` get scenes and GT
boxes without the JAX package. It samples objects with static / linear /
nonlinear trajectories over `timesteps` keyframes, the 12-dim per-timestep
GT layout of the reference infos (ref nusc_common.py:531), and lidar-like
points on the box walls over ground clutter. `make_batch` stacks scenes
into torch tensors on a device with the raw GT under "targets_raw", the
input of `train/step.py::train_step`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from ..config import ExperimentConfig

DT = 0.5  # seconds between keyframes (2 Hz, ref README 3s horizon / 7 steps)

# trajectory classes (futuredet_tpu/core/trajectory.py)
STATIC, LINEAR, NONLINEAR = 0, 1, 2

# per-class size priors (w, l, h) ~ nuScenes means, for multi-class scenes
CLASS_SIZES = {
    "car": (1.9, 4.6, 1.7), "truck": (2.5, 6.9, 2.8), "bus": (2.9, 11.0, 3.5),
    "trailer": (2.9, 12.3, 3.9), "construction_vehicle": (2.8, 6.4, 3.2),
    "pedestrian": (0.67, 0.73, 1.77), "motorcycle": (0.77, 2.1, 1.5),
    "bicycle": (0.6, 1.7, 1.3), "barrier": (2.5, 0.5, 1.0),
    "traffic_cone": (0.41, 0.41, 1.07),
}


@dataclass
class Scene:
    points: np.ndarray        # (P, 5) x,y,z,intensity,time-lag
    points_valid: np.ndarray  # (P,)
    gt_boxes: np.ndarray      # (T, M, 12)
    gt_classes: np.ndarray    # (T, M) 1-based; 0 invalid
    gt_valid: np.ndarray      # (T, M)
    traj_classes: np.ndarray  # (M,) 1-based static/linear/nonlinear; 0 invalid


def _lidar_clutter(rng: np.random.Generator, n: int, hi: float) -> np.ndarray:
    """Structured lidar-statistics background: ground-ring ARCS at half-voxel
    step (contiguous strings of multi-hit voxels), wall point grids at
    azimuth/elevation resolution, plus a small isolated-noise fraction.

    Real aggregated sweeps concentrate points on the ground sheet and
    vertical structure with ~3-8 points per occupied voxel and strong
    voxel ADJACENCY — which sets the generative strided-conv site growth
    (spconv rule) to ~1x per stage. The former 1/r isolated-point clutter
    had ~1 point per voxel, a non-physical worst case whose generative
    growth is ~3.4x (scripts/occupancy.py).
    """
    vox = 0.075                      # bench xy voxel size (config voxel_size)
    parts = []
    n_ground = int(n * 0.765)
    n_wall = int(n * 0.22)
    n_noise = n - n_ground - n_wall

    # ground: beams at downward elevations -> rings r = h / tan(el);
    # 20 sweeps shift ring centers with ego motion; each (beam, sweep)
    # contributes one contiguous arc sampled at half-voxel steps
    elev = np.deg2rad(np.linspace(1.2, 24.0, 24))
    radii = np.clip(1.84 / np.tan(elev), 2.5, hi * 1.35)
    sweeps = 20
    arcs = []
    budget = n_ground
    per_arc = max(budget // (len(radii) * sweeps), 8)
    for s in range(sweeps):
        ego = np.array([0.35 * s, 0.0])
        for r in radii:
            m = min(per_arc, budget)
            if m <= 0:
                break
            phi0 = rng.uniform(-np.pi, np.pi)
            dphi = (vox * 0.12) / r  # ~8 hits per voxel along the arc
            phi = phi0 + np.arange(m) * dphi
            x = ego[0] + r * np.cos(phi)
            y = ego[1] + r * np.sin(phi)
            z = -1.84 + 0.01 * r * rng.normal(0, 0.004, m)
            arcs.append(np.stack([x, y, z], -1))
            budget -= m
    if arcs:
        parts.append(np.concatenate(arcs, 0))

    # walls: vertical planes scanned at range-scaled azimuth spacing with
    # beam-elevation rows (strings of adjacent voxels per row)
    walls = []
    budget = n_wall
    for _ in range(14):
        if budget <= 0:
            break
        d = rng.uniform(6.0, hi * 0.9)
        th = rng.uniform(-np.pi, np.pi)
        c = np.array([d * np.cos(th), d * np.sin(th)])
        ori = rng.uniform(-np.pi, np.pi)
        L = rng.uniform(8.0, 30.0)
        h_spacing = max(vox * 0.2, d * np.deg2rad(0.1))
        cols = int(L / h_spacing)
        z_rows = np.arange(-1.8, 2.4, max(0.07, d * 0.010))
        m = min(cols * len(z_rows), budget)
        if cols < 2 or m <= 0:
            continue
        u = (np.arange(cols) - cols / 2) * h_spacing
        xy = c[None, :] + np.stack([u * np.cos(ori), u * np.sin(ori)], -1)
        g = np.repeat(xy, len(z_rows), 0)
        z = np.tile(z_rows, cols)
        w = np.concatenate([g, z[:, None]], -1)[:m]
        walls.append(w)
        budget -= m
    if walls:
        parts.append(np.concatenate(walls, 0))

    # isolated noise (vegetation, spurious returns): 1/r radial draw
    r = rng.uniform(1.0, hi, n_noise)
    th = rng.uniform(-np.pi, np.pi, n_noise)
    parts.append(np.stack([r * np.cos(th), r * np.sin(th),
                           rng.uniform(-2.0, 0.5, n_noise)], -1))

    xyz = np.concatenate(parts, 0)[:n]
    if len(xyz) < n:
        xyz = np.concatenate([xyz, xyz[: n - len(xyz)]], 0)
    inten = rng.uniform(0, 1, n)
    return np.stack([xyz[:, 0], xyz[:, 1], xyz[:, 2], inten,
                     np.zeros(n)], -1)


def make_scene(cfg: ExperimentConfig, n_objects: int = 12,
               n_clutter: int = 20000, points_per_object: int = 600,
               seed: int = 0, max_objs: Optional[int] = None,
               speed_range: tuple = (3.0, 10.0),
               radial_clutter: bool = False,
               clutter_mode: Optional[str] = None) -> Scene:
    """clutter_mode selects the background-point statistics:
      'uniform' — uniform-area isolated points (default);
      'spread'  — ~1/r areal density isolated points (uniform radius draw;
                  the pre-round-3 'realistic' mode, kept for comparability);
      'lidar'   — structured ground-ring arcs / wall grids / noise matching
                  real aggregated-sweep statistics (multi-hit adjacent
                  voxels) — the realistic bench mode.
    radial_clutter=True is a deprecated alias for clutter_mode='spread'."""
    rng = np.random.default_rng(seed)
    T = max(cfg.timesteps, 1)
    M = max_objs or cfg.assigner.max_objs
    P = cfg.voxel.max_points
    lo, hi = cfg.voxel.pc_range[0], cfg.voxel.pc_range[3]
    span = (hi - lo) * 0.4

    mode = clutter_mode or ("spread" if radial_clutter else "uniform")
    mode_scan = mode == "lidar"

    gt_boxes = np.zeros((T, M, 12), np.float32)
    gt_classes = np.zeros((T, M), np.int32)
    gt_valid = np.zeros((T, M), bool)
    traj = np.zeros((M,), np.int32)

    pts_list = []
    names = list(cfg.data.class_names)
    for k in range(n_objects):
        cx, cy = rng.uniform(-span, span, 2)
        cz = rng.uniform(-1.5, -0.5)
        # multi-class configs sample a class per object with its size prior;
        # single-class keeps the original car-like distribution
        cls_id = 1 if len(names) <= 1 else int(rng.integers(1, len(names) + 1))
        if len(names) > 1:
            bw, bl, bh = CLASS_SIZES.get(names[cls_id - 1], (1.9, 4.6, 1.7))
            w, l, h = (bw * rng.uniform(0.9, 1.1), bl * rng.uniform(0.9, 1.1),
                       bh * rng.uniform(0.9, 1.1))
        else:
            w, l, h = (rng.uniform(1.6, 2.2), rng.uniform(3.8, 5.2),
                       rng.uniform(1.4, 1.9))
        yaw = rng.uniform(-np.pi, np.pi)
        kind = rng.choice([STATIC, LINEAR, NONLINEAR], p=[0.4, 0.4, 0.2])
        speed = 0.0 if kind == STATIC else rng.uniform(*speed_range)
        heading = np.array([np.cos(yaw), np.sin(yaw)])
        turn = 0.0 if kind != NONLINEAR else rng.choice([-1, 1]) * rng.uniform(0.25, 0.5)

        pos = np.array([cx, cy], np.float64)
        ang = yaw
        for t in range(T):
            vel = speed * np.array([np.cos(ang), np.sin(ang)])
            gt_boxes[t, k] = [pos[0], pos[1], cz, w, l, h, vel[0], vel[1],
                              vel[0], vel[1], -ang - np.pi / 2, -ang - np.pi / 2]
            gt_classes[t, k] = cls_id
            gt_valid[t, k] = True
            pos = pos + vel * DT
            ang = ang + turn * DT
        traj[k] = kind + 1

        # lidar hits on the walls + roof of the t=0 box
        n = points_per_object
        if mode_scan:
            # scan-line sampling: dense point strings on the two
            # sensor-facing faces at range-scaled azimuth spacing and
            # beam-elevation rows — real aggregated-sweep statistics
            # (adjacent multi-hit voxels) instead of isolated speckle.
            # Budget falls off with range like real returns do.
            d = max(np.hypot(cx, cy), 3.0)
            n = min(n, max(int(n * (12.0 / d) ** 1.5), 30))
            # 20 aggregated ego-shifted sweeps multiply the single-sweep
            # azimuth density — ~3x effective resolution
            h_sp = max(0.02, d * np.deg2rad(0.12) / 3)
            v_sp = max(0.1, d * 0.014)
            z_rows = np.arange(cz - h / 2, cz + h / 2, v_sp)
            # fit the scan grid to the point budget by COARSENING the
            # column spacing (a random subsample would break adjacency)
            total = int((l + w) / h_sp) * len(z_rows)
            if total > n:
                h_sp *= total / n
            cols_l = max(int(l / h_sp), 2)
            cols_w = max(int(w / h_sp), 2)
            face_pts = []
            for cols, extent, fixed in ((cols_l, l, ("w", -0.5)),
                                        (cols_w, w, ("l", -0.5))):
                u_ = (np.arange(cols) / cols - 0.5) * extent
                if fixed[0] == "w":
                    loc = np.stack([u_, np.full(cols, fixed[1] * w)], -1)
                else:
                    loc = np.stack([np.full(cols, fixed[1] * l), u_], -1)
                g = np.repeat(loc, len(z_rows), 0)
                zz_ = np.tile(z_rows, cols)
                face_pts.append(np.concatenate([g, zz_[:, None]], -1))
            fp = np.concatenate(face_pts, 0)
            if len(fp) > n:
                fp = fp[rng.permutation(len(fp))[:n]]
            c0, s0 = np.cos(yaw), np.sin(yaw)
            world = fp[:, :2] @ np.array([[c0, s0], [-s0, c0]])
            world += np.array([cx, cy])
            m_ = len(fp)
            pts_list.append(np.stack(
                [world[:, 0], world[:, 1], fp[:, 2],
                 rng.uniform(0, 1, m_), np.zeros(m_)], -1))
            continue
        face = rng.integers(0, 4, n)
        u = rng.uniform(-0.5, 0.5, n)
        local = np.zeros((n, 2))
        local[face == 0] = np.stack([np.full((face == 0).sum(), 0.5),
                                     u[face == 0]], -1)
        local[face == 1] = np.stack([np.full((face == 1).sum(), -0.5),
                                     u[face == 1]], -1)
        local[face == 2] = np.stack([u[face == 2],
                                     np.full((face == 2).sum(), 0.5)], -1)
        local[face == 3] = np.stack([u[face == 3],
                                     np.full((face == 3).sum(), -0.5)], -1)
        local *= np.array([l, w])  # local x rotates onto the heading -> length
        c0, s0 = np.cos(yaw), np.sin(yaw)
        world = local @ np.array([[c0, s0], [-s0, c0]])
        world += np.array([cx, cy])
        z = rng.uniform(cz - h / 2, cz + h / 2, n)
        inten = rng.uniform(0, 1, n)
        pts_list.append(np.stack([world[:, 0], world[:, 1], z, inten,
                                  np.zeros(n)], -1))

    if mode == "lidar":
        clutter = _lidar_clutter(rng, n_clutter, hi)
    elif mode == "spread":
        # uniform radius -> areal density ~ 1/r (lidar range falloff)
        r = rng.uniform(1.0, hi, n_clutter)
        th = rng.uniform(-np.pi, np.pi, n_clutter)
        cx_, cy_ = r * np.cos(th), r * np.sin(th)
        clutter = np.stack([
            cx_, cy_, rng.uniform(-2.0, -1.6, n_clutter),
            rng.uniform(0, 1, n_clutter), np.zeros(n_clutter)], -1)
    else:
        clutter = np.stack([
            rng.uniform(lo, hi, n_clutter), rng.uniform(lo, hi, n_clutter),
            rng.uniform(-2.0, -1.8, n_clutter), rng.uniform(0, 1, n_clutter),
            np.zeros(n_clutter)], -1)
    pts_list.append(clutter)
    pts = np.concatenate(pts_list, 0).astype(np.float32)

    points = np.zeros((P, 5), np.float32)
    valid = np.zeros((P,), bool)
    n = min(len(pts), P)
    sel = rng.permutation(len(pts))[:n]
    points[:n] = pts[sel]
    valid[:n] = True
    return Scene(points=points, points_valid=valid, gt_boxes=gt_boxes,
                 gt_classes=gt_classes, gt_valid=gt_valid, traj_classes=traj)


# synthetic scene FAMILIES for the sparse-capacity growth envelope
# (scripts/occupancy.py sweep + tests/test_capacity.py zero-drop guard):
# styles spanning the physical lidar regimes the growth bounds must cover.
# (n_objects, points_per_object, clutter_mode)
SCENE_FAMILIES = {
    "lidar":   (48, 500, "lidar"),    # the realistic bench scene
    "urban":   (96, 800, "lidar"),    # dense: many near objects + walls
    "highway": (12, 300, "lidar"),    # sparse: few distant objects
    "gtaug":   (128, 600, "lidar"),   # heavy GT-AUG paste worst case
}


def make_family_scene(cfg: ExperimentConfig, family: str, n_clutter: int,
                      seed: int = 7) -> Scene:
    n_obj, ppo, mode = SCENE_FAMILIES[family]
    return make_scene(cfg, n_objects=n_obj, points_per_object=ppo,
                      n_clutter=n_clutter, seed=seed, max_objs=500,
                      clutter_mode=mode)


def rasterize_scene_map(cfg: ExperimentConfig, scene: Scene,
                        road_halfwidth: float = 3.0) -> np.ndarray:
    """Synthetic drivable-area raster (H, W) float32: cells within
    `road_halfwidth` metres of any valid object's centre at any timestep
    are road (1.0). Canvas orientation: row = y bin, column = x bin, as the
    targets' heatmaps."""
    W, H = cfg.feature_map_size
    pc = cfg.voxel.pc_range
    sx = (pc[3] - pc[0]) / W
    sy = (pc[4] - pc[1]) / H
    xs = pc[0] + (np.arange(W) + 0.5) * sx
    ys = pc[1] + (np.arange(H) + 0.5) * sy
    gx, gy = np.meshgrid(xs, ys)
    out = np.zeros((H, W), np.float32)
    for cx, cy in scene.gt_boxes[scene.gt_valid][:, :2]:
        out[(gx - cx) ** 2 + (gy - cy) ** 2 <= road_halfwidth ** 2] = 1.0
    return out


def make_batch(cfg: ExperimentConfig, batch_size: int, seed: int = 0,
               device=None, **kw) -> Dict:
    """`batch_size` scenes (seeds seed, seed + 1, ...; `make_scene`'s
    keywords) stacked into tensors on `device` (default the CPU):
    {"points" (B, P, 5) f32, "points_valid" (B, P) bool, "targets_raw":
    {"gt_boxes" (B, T, M, 12), "gt_classes" (B, T, M), "gt_valid"
    (B, T, M), "traj_classes" (B, M)}}, and the same GT as host numpy for
    the evaluator under "gt": {"boxes", "classes", "valid", "traj"}, as the
    JAX package's `make_batch` gives it; a bev_map config also gets
    "bev_map" (B, H, W, 1), each scene's `rasterize_scene_map`."""
    scenes = [make_scene(cfg, seed=seed + i, **kw) for i in range(batch_size)]

    def host(field):
        return np.stack([getattr(s, field) for s in scenes])

    def stack(field):
        return torch.from_numpy(host(field)).to(device)

    batch = {"points": stack("points"), "points_valid": stack("points_valid"),
             "targets_raw": {"gt_boxes": stack("gt_boxes"),
                             "gt_classes": stack("gt_classes"),
                             "gt_valid": stack("gt_valid"),
                             "traj_classes": stack("traj_classes")},
             "gt": {"boxes": host("gt_boxes"), "classes": host("gt_classes"),
                    "valid": host("gt_valid"), "traj": host("traj_classes")}}
    if cfg.model.head.bev_map:
        batch["bev_map"] = torch.from_numpy(np.stack(
            [rasterize_scene_map(cfg, s)[..., None] for s in scenes])
        ).to(device)
    return batch
