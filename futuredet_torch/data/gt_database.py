"""GT-AUG: ground-truth database creation + trajectory-conditioned sampling.

The port's copy of `futuredet_tpu/data/gt_database.py`: the same database
files and dbinfos pkl, and the same draws from the sampler's
`np.random.Generator` in the same order. Behavioral ports:
  * create_groundtruth_database — ref
    `det3d/datasets/utils/create_gt_database.py:17-175`: crop each t=0 GT
    box's points (relative to box center) into a per-object .bin; dbinfos
    entries keyed by class name carry per-timestep boxes + trajectory labels.
  * DataBaseSampler — ref `det3d/core/sampler/sample_ops.py:13-253` +
    `BatchSampler` (`core/sampler/preprocess.py:19-55`): sample objects per
    `{trajectory}_{class}` group (e.g. static_car=2, linear_car=4,
    nonlinear_car=6, ref configs n3dtf:116-123), reject collisions against
    scene boxes and each other, paste cropped points at the stored box pose.
    Pasted boxes keep their t=0 position across all timesteps with
    per-timestep velocity/rotation columns (the reference's
    `sampled_gt_boxes[j][-6:] = gt_forecast[j][i]` semantics,
    preprocess.py:169-174).
"""
from __future__ import annotations

import os
import pickle
from pathlib import Path
from typing import Dict

import numpy as np

from ..config import ExperimentConfig


def _points_in_box_np(points, box):
    d = points[:, :3] - box[:3]
    # stored yaw is -yaw-pi/2; physical heading = -(stored)-pi/2
    yaw = -box[10] - np.pi / 2
    c, s = np.cos(yaw), np.sin(yaw)
    lx = c * d[:, 0] + s * d[:, 1]    # along heading -> length (box[4])
    ly = -s * d[:, 0] + c * d[:, 1]   # lateral       -> width  (box[3])
    return ((np.abs(lx) <= box[4] / 2) & (np.abs(ly) <= box[3] / 2)
            & (np.abs(d[:, 2]) <= box[5] / 2))


def create_groundtruth_database(cfg: ExperimentConfig, dataset, out_dir: str,
                                point_features: int = 5) -> str:
    """dataset: NuScenesForecastDataset-like with .infos and .sample(idx)
    yielding unaugmented points + gt arrays. Writes gt .bins + dbinfos pkl."""
    db_path = Path(out_dir) / f"gt_database_{cfg.data.nsweeps}sweeps_withvelo"
    db_path.mkdir(parents=True, exist_ok=True)
    dbinfo_path = (Path(out_dir)
                   / f"dbinfos_train_{cfg.data.nsweeps}sweeps_withvelo.pkl")

    all_db_infos: Dict[str, list] = {}
    class_names = list(cfg.data.class_names)
    for idx in range(len(dataset)):
        s = dataset.sample(idx)
        pts = s["points"][s["points_valid"]]
        boxes = s["gt_boxes"]          # (T, M, 12)
        valid = s["gt_valid"][0]
        for i in np.where(valid)[0]:
            name = class_names[int(s["gt_classes"][0, i]) - 1]
            traj = ["static", "linear", "nonlinear"][
                int(s["traj_classes"][i]) - 1]
            box0 = boxes[0, i]
            inside = _points_in_box_np(pts, box0)
            gt_points = pts[inside].copy()
            gt_points[:, :3] -= box0[:3]
            fname = f"{idx}_{name}_{i}.bin"
            d = db_path / name
            d.mkdir(exist_ok=True)
            gt_points[:, :point_features].astype(np.float32).tofile(
                str(d / fname))
            info = {
                "name": [name] * boxes.shape[0],
                "trajectory": [traj] * boxes.shape[0],
                "path": os.path.join(db_path.name, name, fname),
                "gt_idx": int(i),
                "box3d_lidar": [boxes[t, i].copy()
                                for t in range(boxes.shape[0])],
                "num_points_in_gt": int(inside.sum()),
            }
            all_db_infos.setdefault(name, []).append(info)

    with open(dbinfo_path, "wb") as f:
        pickle.dump(all_db_infos, f)
    return str(dbinfo_path)


def build_db_sampler(cfg: ExperimentConfig, info_path: str,
                     db_info_path: str = None, seed: int = 0):
    """Default GT-AUG construction for the train CLI (the reference's
    `build_dbsampler`: built whenever the config carries a db_sampler
    dict; the dict's `enable` key is ignored there).

    Looks for `dbinfos_train_{nsweeps}sweeps_withvelo.pkl` next to the infos
    pkl (the reference's data_root naming, configs n3dtf:128). Returns None
    when the config has no sample groups or no dbinfos file exists."""
    if not cfg.data.sample_groups:
        return None
    root = os.path.dirname(os.path.abspath(info_path))
    db_info_path = db_info_path or os.path.join(
        root, f"dbinfos_train_{cfg.data.nsweeps}sweeps_withvelo.pkl")
    if not os.path.exists(db_info_path):
        return None
    return DataBaseSampler(db_info_path, root,
                           sample_groups=dict(cfg.data.sample_groups),
                           min_points=cfg.data.gt_aug_min_points,
                           sampler_type=cfg.data.sampler_type, seed=seed,
                           global_rot_range=cfg.data.gt_aug_global_rot_range)


def _corners_bev(boxes: np.ndarray, rot_col: int) -> np.ndarray:
    """(N, 12) boxes -> (N, 4, 2) BEV corners, numpy (host pipeline).
    Mirrors ref box_np_ops.center_to_corner_box2d (corners_nd order +
    right-multiplied rotation)."""
    if len(boxes) == 0:
        return np.zeros((0, 4, 2))
    norm = np.array([[-0.5, -0.5], [-0.5, 0.5], [0.5, 0.5], [0.5, -0.5]])
    corners = boxes[:, None, 3:5] * norm[None]            # (N, 4, 2)
    ang = boxes[:, rot_col]
    c, s = np.cos(ang), np.sin(ang)
    rot = np.stack([np.stack([c, -s], -1), np.stack([s, c], -1)], -2)
    return np.einsum("nkj,njm->nkm", corners, rot) + boxes[:, None, :2]


class _Pool:
    """Epoch-shuffled sampling pool (ref BatchSampler, preprocess.py:19-55)."""

    def __init__(self, items, rng):
        self.items = items
        self.rng = rng
        self._reset()

    def _reset(self):
        self.order = self.rng.permutation(len(self.items))
        self.pos = 0

    def sample(self, n):
        if self.pos + n > len(self.items):
            self._reset()
        take = self.order[self.pos:self.pos + n]
        self.pos += n
        return [self.items[i] for i in take]


class DataBaseSampler:
    """ref DataBaseSamplerV2.sample_all (sample_ops.py:101-253)."""

    def __init__(self, db_info_path: str, root_path: str,
                 sample_groups: Dict[str, int],
                 min_points: int = 5, sampler_type: str = "trajectory",
                 point_features: int = 5, seed: int = 0,
                 global_rot_range=None):
        self.root = root_path
        self.rng = np.random.default_rng(seed)
        self.point_features = point_features
        # ref global_random_rotation_range_per_object (sample_ops.py:87-95):
        # "place samples to any place in a circle"; every shipped config
        # ships [0, 0] so this is OFF by default
        if global_rot_range is not None:
            lo, hi = float(global_rot_range[0]), float(global_rot_range[1])
            if abs(lo - hi) < 1e-3:
                global_rot_range = None
            else:
                global_rot_range = (lo, hi)
        self.global_rot_range = global_rot_range
        with open(db_info_path, "rb") as f:
            db = pickle.load(f)
        # filter by min points (ref db_prep_steps filter_by_min_num_points)
        db = {k: [x for x in v if x["num_points_in_gt"] >= min_points]
              for k, v in db.items()}
        # regroup by trajectory_class when trajectory-conditioned
        pools: Dict[str, list] = {}
        for name, items in db.items():
            for it in items:
                key = (f"{it['trajectory'][0]}_{name}"
                       if sampler_type != "standard" else name)
                pools.setdefault(key, []).append(it)
        self.pools = {k: _Pool(v, self.rng) for k, v in pools.items() if v}
        self.sample_groups = sample_groups

    def sample_all(self, gt_boxes_t0: np.ndarray):
        """gt_boxes_t0 (N, 12) existing scene boxes. Returns dict with
        sampled boxes (S, T, 12), names, trajectories, points (P, F)."""
        picked = []
        for key, n in self.sample_groups.items():
            if key in self.pools and n > 0:
                picked += self.pools[key].sample(n)
        if not picked:
            return None

        # joint collision matrix over [existing gt, candidates] with
        # sequential accept/reject — rejected candidates drop out of the
        # matrix so they never block later ones (ref sample_class_v2,
        # sample_ops.py:306-351, backed by the numba box_collision_test
        # ported in core.boxes). Angle columns mirror the reference exactly:
        # gt corners from column -2 (rot) and candidate corners from column
        # -1 — which for the 12-column forecast boxes is rrot, a reference
        # quirk preserved for parity.
        from ..core.boxes import box_collision_test
        num_gt = len(gt_boxes_t0)
        sp = np.stack([np.asarray(it["box3d_lidar"][0], np.float64)
                       for it in picked])

        # optional per-object radial re-placement (ref sample_ops.py:318-323
        # + noise_per_object_v3_): candidates may move anywhere on their
        # ego-circle before collision testing. Deviations from the
        # reference's DEAD path (every shipped config disables it), which
        # misreads the 12-col layout (rotates column 6 = vx, updates
        # column -1 = rrot): we rotate the TRUE rot column (10) and apply
        # the same delta to every timestep; velocities stay untouched like
        # the reference.
        rot_t = np.zeros(len(picked))
        if self.global_rot_range is not None:
            from .augment import noise_per_object
            joint = (np.concatenate(
                [np.asarray(gt_boxes_t0, np.float64), sp], 0)
                if num_gt else sp)
            joint7 = joint[:, [0, 1, 2, 3, 4, 5, 10]]
            vmask = np.zeros(len(joint), bool)
            vmask[num_gt:] = True
            out7, _, _ = noise_per_object(
                joint7, None, vmask, rotation_perturb=0.0,
                center_noise_std=0.0, global_rot_range=self.global_rot_range,
                num_try=100, rng=self.rng)
            new = out7[num_gt:]
            rot_t = new[:, 6] - sp[:, 10]
            sp[:, :2] = new[:, :2]
            sp[:, 10] = new[:, 6]

        gt_bv = _corners_bev(np.asarray(gt_boxes_t0, np.float64), -2) \
            if num_gt else np.zeros((0, 4, 2))
        sp_bv = _corners_bev(sp, -1)
        total = np.concatenate([gt_bv, sp_bv], 0)
        coll = box_collision_test(total, total)
        np.fill_diagonal(coll, False)
        kept = []
        for i in range(num_gt, num_gt + len(picked)):
            if coll[i].any():
                coll[i] = False
                coll[:, i] = False
            else:
                kept.append(i - num_gt)
        if not kept:
            return None

        T = len(picked[kept[0]]["box3d_lidar"])
        boxes = np.zeros((len(kept), T, 12), np.float32)
        pts_list = []
        names, trajs = [], []
        for j, cand in enumerate(kept):
            it = picked[cand]
            b0 = np.asarray(it["box3d_lidar"][0], np.float32).copy()
            b0[:2] = sp[cand, :2]          # moved placement (identity when
            b0[10] = sp[cand, 10]          # global_rot_range is off)
            for t in range(T):
                bt = np.asarray(it["box3d_lidar"][min(t, T - 1)], np.float32)
                # position frozen at t0, last-6 per timestep (ref quirk)
                boxes[j, t, :6] = b0[:6]
                boxes[j, t, 6:] = bt[6:]
                boxes[j, t, 10] += rot_t[cand]
            p = np.fromfile(os.path.join(self.root, it["path"]),
                            np.float32).reshape(-1, self.point_features)
            p = np.hstack([p, np.zeros((len(p), 1), np.float32)])  # time lag
            if rot_t[cand]:
                # db points are box-relative: rotate about the origin before
                # translating (ref rot_transform, sample_ops.py:203-207)
                c, s = np.cos(rot_t[cand]), np.sin(rot_t[cand])
                x_, y_ = p[:, 0].copy(), p[:, 1].copy()
                p[:, 0] = x_ * c + y_ * s      # p @ [[c,-s],[s,c]]
                p[:, 1] = -x_ * s + y_ * c
            p[:, :3] += b0[:3]
            pts_list.append(p)
            names.append(it["name"][0])
            trajs.append(it["trajectory"][0])
        return {"gt_boxes": boxes, "gt_names": np.array(names),
                "gt_trajectory": np.array(trajs),
                "points": np.concatenate(pts_list, 0)}
