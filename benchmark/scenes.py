"""Seeded LiDAR sweeps for the benchmark: one general generator that every
traffic mix (`traffic/<mix>.json`) parameterises.

A frozen adaptation of `chip_smoke.py::scene_lidar` (objects on their
sides and tops over ground rings, denser near the sensor) with the
changes that make it an aggregated nuScenes sample rather than one frame:

  * the points are drawn from `nsweeps` sweeps of a 32-beam sensor; the
    fifth column is each point's sweep lag (sweep index x sweep period);
  * the ego vehicle moves during the sweeps, so each sweep's ground rings
    are centred where the sensor was (the sweeps are in the current ego
    frame, as nuScenes aggregates them);
  * a share of the objects move; their points are smeared back along
    their heading by speed x lag;
  * clutter (vegetation, walls) lies at the edge of the range;
  * every scene fills the config's point budget, and each scene is
    checked against the config's voxel (or pillar) budget.

A training scene also carries its GT boxes at the config's timesteps, in
the layout of `futuredet_torch/data/synthetic.py` ([x, y, z, w, l, h, vx,
vy, rvx, rvy, rot, rrot], rot = -yaw - pi/2), with static / linear /
nonlinear trajectories.

Everything is drawn with one `torch.Generator` on the given device, in a
few large calls a scene, so that a seed gives the same pool on that
device. Nothing here imports the program.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch

# HDL-32E: 32 beams from -30.67 to +10.67 degrees, 1.33 apart; the downward
# ones meet the ground in rings
BEAM_ELEVATIONS_DEG = [-30.67 + 1.33 * k for k in range(32)]


def _u(g, n, lo, hi, dev):
    return lo + (hi - lo) * torch.rand(n, generator=g, device=dev)


def _count_cells(xyz: torch.Tensor, pc_range, cell) -> int:
    """Distinct in-range cells of size `cell` (x, y, z) that the points
    occupy."""
    lo = torch.tensor(pc_range[:3], dtype=xyz.dtype, device=xyz.device)
    hi = torch.tensor(pc_range[3:], dtype=xyz.dtype, device=xyz.device)
    vs = torch.tensor(cell, dtype=xyz.dtype, device=xyz.device)
    dims = torch.round((hi - lo) / vs).to(torch.int64)
    c = torch.floor((xyz - lo) / vs).to(torch.int64)
    ok = ((c >= 0) & (c < dims)).all(-1)
    c = c[ok]
    ids = (c[:, 2] * dims[1] + c[:, 1]) * dims[0] + c[:, 0]
    return int(torch.unique(ids).numel())


def cell_budget(experiment: Dict, training: bool):
    """(cell size, budget) of the config: voxels of the sparse VoxelNet, or
    pillars (the whole z range in one cell)."""
    v = experiment["voxel"]
    budget = v["max_voxels_train"] if training else v["max_voxels_eval"]
    return tuple(v["voxel_size"]), budget


def one_scene(experiment: Dict, mix: Dict, g: torch.Generator, dev,
              with_gt: bool) -> Dict[str, torch.Tensor]:
    """One aggregated sample: points (P, 5) f32 with P the config's budget,
    and with `with_gt` its GT at the config's timesteps."""
    v = experiment["voxel"]
    P = v["max_points"]
    hi = v["pc_range"][3]
    nsweeps = experiment["data"]["nsweeps"]
    period = mix["sweep_period_s"]
    ground_z = -mix["sensor_height_m"]

    # ego motion over the sweeps: the sensor of sweep s sat at
    # -v_ego * lag_s along the ego heading (x)
    ego_speed = float(_u(g, 1, *mix["ego_speed_mps"], dev))

    # objects ---------------------------------------------------------
    o = mix["objects"]
    n_obj = int(torch.randint(o["count"][0], o["count"][1] + 1, (1,),
                              generator=g, device=dev))
    r = torch.sqrt(_u(g, n_obj, o["range_m"][0] ** 2, o["range_m"][1] ** 2,
                      dev))
    az = _u(g, n_obj, -math.pi, math.pi, dev)
    cx, cy = r * torch.cos(az), r * torch.sin(az)
    yaw = _u(g, n_obj, -math.pi, math.pi, dev)
    length = _u(g, n_obj, *o["length_m"], dev)
    width = _u(g, n_obj, *o["width_m"], dev)
    height = _u(g, n_obj, *o["height_m"], dev)
    moving = _u(g, n_obj, 0.0, 1.0, dev) < o["moving_share"]
    speed = torch.where(moving, _u(g, n_obj, *o["speed_mps"], dev),
                        torch.zeros_like(r))
    # returns fall off with range: points ~ (ref / d)^2, clipped
    per = torch.clamp(o["points_at_ref"] * (o["ref_range_m"] / r) ** 2,
                      o["points_min"], o["points_max"]).to(torch.int64)
    n_obj_pts = int(per.sum())
    owner = torch.repeat_interleave(torch.arange(n_obj, device=dev), per)
    # the two sensor-facing sides and the top, by visible area
    to_sensor = torch.atan2(-cy, -cx) - yaw
    side_l = torch.sign(torch.sin(to_sensor))   # which long side faces it
    side_w = torch.sign(torch.cos(to_sensor))   # which short side
    area = torch.stack([length * height * torch.sin(to_sensor).abs(),
                        width * height * torch.cos(to_sensor).abs(),
                        o["top_weight"] * length * width], -1)
    face = torch.multinomial(area[owner], 1, generator=g)[:, 0]
    uu = _u(g, (n_obj_pts, 3), -0.5, 0.5, dev)
    lx = torch.where(face == 1, 0.5 * side_w[owner], uu[:, 0])
    ly = torch.where(face == 0, 0.5 * side_l[owner], uu[:, 1])
    lz = torch.where(face == 2, torch.full_like(uu[:, 2], 0.5), uu[:, 2])
    lx, ly = lx * length[owner], ly * width[owner]
    c, s = torch.cos(yaw[owner]), torch.sin(yaw[owner])
    lag_o = torch.randint(0, nsweeps, (n_obj_pts,), generator=g,
                          device=dev).to(torch.float32) * period
    back = speed[owner] * lag_o                 # smeared along the heading
    ox = cx[owner] + c * lx - s * ly - back * c
    oy = cy[owner] + s * lx + c * ly - back * s
    oz = ground_z + (lz + 0.5) * height[owner]
    obj = torch.stack([ox, oy, oz, lag_o], -1)

    # clutter at the edge of the range ------------------------------
    cl = mix["clutter"]
    n_cl = int(P * cl["share"])
    rc = _u(g, n_cl, cl["radius_share"][0] * hi, cl["radius_share"][1] * hi,
            dev)
    ac = _u(g, n_cl, -math.pi, math.pi, dev)
    clutter = torch.stack([
        rc * torch.cos(ac), rc * torch.sin(ac),
        _u(g, n_cl, ground_z, ground_z + cl["height_m"], dev),
        torch.randint(0, nsweeps, (n_cl,), generator=g,
                      device=dev).to(torch.float32) * period], -1)

    # ground rings: the rest of the budget, one share per downward beam
    n_gr = P - n_obj_pts - n_cl
    if n_gr < 0:
        raise ValueError("objects and clutter exceed the point budget")
    els = torch.tensor([e for e in BEAM_ELEVATIONS_DEG if e < -1.0],
                       device=dev)
    radii = mix["sensor_height_m"] / torch.tan(-els * math.pi / 180)
    radii = radii[radii < hi * mix["ground_reach_share"]]
    beam = torch.randint(0, len(radii), (n_gr,), generator=g, device=dev)
    sweep = torch.randint(0, nsweeps, (n_gr,), generator=g, device=dev)
    lag_g = sweep.to(torch.float32) * period
    phi = _u(g, n_gr, -math.pi, math.pi, dev)
    rg = radii[beam] * (1 + mix["ring_jitter"] * torch.randn(
        n_gr, generator=g, device=dev))
    ground = torch.stack([
        rg * torch.cos(phi) - ego_speed * lag_g, rg * torch.sin(phi),
        ground_z + mix["ground_noise_m"] * torch.randn(n_gr, generator=g,
                                                       device=dev),
        lag_g], -1)

    xyzt = torch.cat([obj, clutter, ground])
    order = torch.randperm(P, generator=g, device=dev)
    xyzt = xyzt[order]
    inten = torch.rand(P, generator=g, device=dev)
    points = torch.stack([xyzt[:, 0], xyzt[:, 1], xyzt[:, 2], inten,
                          xyzt[:, 3]], -1).contiguous()
    scene = {"points": points,
             "points_valid": torch.ones(P, dtype=torch.bool, device=dev)}
    if with_gt:
        scene["gt"] = _gt(experiment, mix, g, dev, cx, cy, yaw, length,
                          width, height, speed, ground_z)
    return scene


def _gt(experiment, mix, g, dev, cx, cy, yaw, length, width, height, speed,
        ground_z) -> Dict[str, torch.Tensor]:
    """GT at the config's timesteps, `keyframe_s` apart: static objects
    stay, linear ones keep their heading, nonlinear ones turn."""
    T = experiment["timesteps"]
    M = experiment["assigner"]["max_objs"]
    n = len(cx)
    if n > M:
        raise ValueError(f"{n} objects exceed the GT budget {M}")
    dt = mix["gt"]["keyframe_s"]
    moving = speed > 0
    turning = moving & (_u(g, n, 0.0, 1.0, dev) < mix["gt"]["turning_share"])
    turn = torch.where(turning, _u(g, n, *mix["gt"]["turn_rate"], dev)
                       * torch.sign(_u(g, n, -1.0, 1.0, dev)),
                       torch.zeros_like(cx))
    boxes = torch.zeros(T, M, 12, device=dev)
    x, y, ang = cx.clone(), cy.clone(), yaw.clone()
    cz = ground_z + height / 2
    for t in range(T):
        vx, vy = speed * torch.cos(ang), speed * torch.sin(ang)
        rot = -ang - math.pi / 2
        boxes[t, :n] = torch.stack([x, y, cz, width, length, height, vx, vy,
                                    vx, vy, rot, rot], -1)
        x, y, ang = x + vx * dt, y + vy * dt, ang + turn * dt
    valid = torch.zeros(T, M, dtype=torch.bool, device=dev)
    valid[:, :n] = True
    traj = torch.zeros(M, dtype=torch.int64, device=dev)
    # 1 static, 2 linear, 3 nonlinear (futuredet_torch/data/synthetic.py)
    traj[:n] = 1 + moving.to(torch.int64) + turning.to(torch.int64)
    return {"gt_boxes": boxes, "gt_classes": valid.to(torch.int64),
            "gt_valid": valid, "traj_classes": traj}


def make_pool(experiment: Dict, mix: Dict, seed: int, dev,
              training: bool) -> List[Dict[str, torch.Tensor]]:
    """`mix["pool"]` scenes from `seed` on `dev`, each checked against the
    config's cell budget; the cell counts per scene are returned under
    "cells"."""
    g = torch.Generator(device=dev).manual_seed(seed)
    cell, budget = cell_budget(experiment, training)
    pool = []
    for _ in range(mix["pool"]):
        scene = one_scene(experiment, mix, g, dev, with_gt=training)
        n = _count_cells(scene["points"][:, :3], experiment["voxel"]
                         ["pc_range"], cell)
        if n > budget:
            raise ValueError(f"a scene occupies {n} cells, over the "
                             f"config's budget of {budget}")
        scene["cells"] = n
        pool.append(scene)
    return pool
