"""Dataset pipeline: infos-pkl loading, sweep aggregation, augmentation,
fixed-shape example assembly, batching.

The port's copy of `futuredet_tpu/data/pipeline.py`. Samples are the same
host numpy arrays, from the same draws of the dataset's
`np.random.Generator` in the same order; `batches_from_dataset` yields
torch CPU tensors where the JAX module has `jnp.asarray`, in pinned memory
when the batches go to the card (`pin_memory=True`). The sweeps load
through the port's threaded C++ loader (`utils/native.py`), whose failed
build raises; the numpy reader runs only for `use_native=False` or
painted points.

Behavioral ports:
  * sweep aggregation + time-lag channel + remove_close —
    `det3d/datasets/pipelines/loading.py:36-140` (seeded random sweep subset,
    rng(0).choice, ref :128-133)
  * class-balanced resampling (CBGS) — `nuscenes.py:556-597`
  * train augmentation sequence — `pipelines/preprocess.py:189-192`
  * fixed-shape packing: gt (T, M, 12) + class/trajectory ids; points padded
    to cfg.voxel.max_points

Target rasterization happens on the device (data/targets.py) — the
reference's host-side AssignLabel is gone from the loader.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Dict, Iterator, Sequence

import numpy as np
import torch

from ..config import ExperimentConfig
from ..core.trajectory import TRAJECTORY_NAMES
from .augment import apply_train_augmentations

TRAJ_TO_ID = {name: i + 1 for i, name in enumerate(TRAJECTORY_NAMES)}


def read_lidar_bin(path: str, num_features: int = 5) -> np.ndarray:
    """nuScenes .bin: float32 x,y,z,intensity,ring (ref loading.py:31)."""
    return np.fromfile(path, dtype=np.float32).reshape(-1, 5)[:, :num_features]


def read_painted(path: str) -> np.ndarray:
    """Segmentation-painted points (ref loading.py:24-29): a .npy next to the
    sweep under a `painted_` directory, ring index dropped, 14 features."""
    dir_path = os.path.join(*path.split("/")[:-2],
                            "painted_" + path.split("/")[-2])
    if path.startswith("/"):
        dir_path = "/" + dir_path
    painted_path = os.path.join(dir_path, path.split("/")[-1] + ".npy")
    pts = np.load(painted_path)
    return pts[:, [0, 1, 2, 3, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14]]


def remove_close(points: np.ndarray, radius: float = 1.0) -> np.ndarray:
    """ref loading.py:36-45 (points row-major here)."""
    keep = ~((np.abs(points[:, 0]) < radius) & (np.abs(points[:, 1]) < radius))
    return points[keep]


def aggregate_sweeps(info: dict, nsweeps: int, num_features: int = 5,
                     seed: int = 0, use_native: bool = True,
                     painted: bool = False) -> np.ndarray:
    """Load the keyframe + (nsweeps-1) transformed sweeps with a time-lag
    column (ref loading.py:112-140). Returns (P, num_features+1).

    The sweeps are `rng(seed).choice` of the info's chain, reseeded on
    every call (the reference's rng(0).choice). The threaded C++ loader
    (`utils/native.py::load_sweeps_native`) reads them; `use_native=False`
    and painted points take the numpy reader, with the same output."""
    if painted:
        use_native = False  # painted .npy path is python-only
    if use_native:
        from ..utils import native
        rng = np.random.default_rng(seed)
        n = len(info["sweeps"])
        take = rng.choice(n, min(nsweeps - 1, n), replace=False)
        paths = [str(info["lidar_path"])]
        tms = [None]
        lags = [0.0]
        for i in take:
            sw = info["sweeps"][i]
            paths.append(str(sw["lidar_path"]))
            tms.append(sw.get("transform_matrix"))
            lags.append(float(sw["time_lag"]))
        return native.load_sweeps_native(
            paths, tms, lags, max_points=4 * 1000 * 1000, file_feats=5,
            keep_feats=num_features)
    reader = read_painted if painted else (
        lambda p: read_lidar_bin(p, num_features))
    points = reader(str(info["lidar_path"]))
    sweep_pts = [points]
    sweep_times = [np.zeros((points.shape[0], 1), np.float32)]
    rng = np.random.default_rng(seed)
    n = len(info["sweeps"])
    take = rng.choice(n, min(nsweeps - 1, n), replace=False)
    for i in take:
        sweep = info["sweeps"][i]
        p = reader(str(sweep["lidar_path"])).T
        p = remove_close(p.T, 1.0).T
        tm = sweep.get("transform_matrix")
        if tm is not None:
            hom = np.vstack([p[:3], np.ones((1, p.shape[1]))])
            p[:3] = (np.asarray(tm) @ hom)[:3]
        sweep_pts.append(p.T)
        sweep_times.append(np.full((p.shape[1], 1), sweep["time_lag"],
                                   np.float32))
    pts = np.concatenate(sweep_pts, 0)
    times = np.concatenate(sweep_times, 0).astype(pts.dtype)
    return np.hstack([pts, times])


def pack_points(points: np.ndarray, max_points: int, rng=None):
    """Pad/subsample to the fixed point budget."""
    P = len(points)
    out = np.zeros((max_points, points.shape[1]), np.float32)
    valid = np.zeros((max_points,), bool)
    if P > max_points:
        sel = (rng or np.random.default_rng(0)).permutation(P)[:max_points]
        points = points[sel]
        P = max_points
    out[:P] = points
    valid[:P] = True
    return out, valid


def pack_gt(cfg: ExperimentConfig, gt_boxes, gt_names, gt_trajectory,
            class_names: Sequence[str]):
    """info gt arrays (N, T, 12)/(N, T) -> fixed (T, M, 12) + ids.

    Applies the class filter and the BEV-range filter on t=0 boxes
    (ref Voxelization :249-254). Returns (boxes, cls, valid, traj, idx)
    where idx are the kept source rows (for aligning per-object side
    arrays like gt_attributes)."""
    T = cfg.timesteps
    M = cfg.assigner.max_objs
    out_boxes = np.zeros((T, M, 12), np.float32)
    out_cls = np.zeros((T, M), np.int32)
    out_valid = np.zeros((T, M), bool)
    out_traj = np.zeros((M,), np.int32)

    if len(gt_boxes) == 0:
        return out_boxes, out_cls, out_valid, out_traj, np.zeros(0, np.int64)

    gt_boxes = np.asarray(gt_boxes, np.float32)
    if gt_boxes.ndim == 2:  # single-timestep infos
        gt_boxes = gt_boxes[:, None, :]
        gt_names = np.asarray(gt_names)[:, None]
        gt_trajectory = np.asarray(gt_trajectory)[:, None]
    gt_boxes = np.nan_to_num(gt_boxes)

    names0 = np.asarray(gt_names)[:, 0]
    keep = np.isin(names0, list(class_names))
    pc = cfg.voxel.pc_range
    b0 = gt_boxes[:, 0]
    # any-corner BEV range test (ref prep.filter_gt_box_outside_range,
    # core/sampler/preprocess.py:113-127: corners from (w, l) and the LAST
    # box column as angle — rrot for 12-col forecast boxes, quirk preserved)
    from .gt_database import _corners_bev
    corners = _corners_bev(b0.astype(np.float64), -1)
    inside = ((corners[..., 0] >= pc[0]) & (corners[..., 0] <= pc[3])
              & (corners[..., 1] >= pc[1]) & (corners[..., 1] <= pc[4]))
    keep &= inside.any(axis=1)
    idx = np.where(keep)[0][:M]
    n = len(idx)
    Ti = min(T, gt_boxes.shape[1])
    for t in range(T):
        ts = min(t, Ti - 1)
        out_boxes[t, :n] = gt_boxes[idx, ts, :12]
        out_cls[t, :n] = [list(class_names).index(nm) + 1
                          for nm in names0[idx]]
        out_valid[t, :n] = True
    out_traj[:n] = [TRAJ_TO_ID.get(str(tr), 1)
                    for tr in np.asarray(gt_trajectory)[idx, 0]]
    return out_boxes, out_cls, out_valid, out_traj, idx


class NuScenesForecastDataset:
    """Reads the reference's infos pkl format (create_nuscenes_infos output,
    ref nusc_common.py:605-664) and yields fixed-shape samples."""

    def __init__(self, cfg: ExperimentConfig, info_path: str,
                 train: bool = True, class_balanced: bool = True,
                 seed: int = 0, db_sampler=None, painted: bool = False):
        self.cfg = cfg
        self.train = train
        self.painted = painted  # segmentation-painted 14-feature points
        self.db_sampler = db_sampler  # GT-AUG (data.gt_database.DataBaseSampler)
        # columns of a sample's points: the features read, then the time lag
        self.point_features = 15 if painted else 6
        self.rng = np.random.default_rng(seed)
        with open(info_path, "rb") as f:
            infos = pickle.load(f)
        if isinstance(infos, dict):
            flat = []
            for v in infos.values():
                flat.extend(v)
            infos = flat
        if train and class_balanced:
            infos = self._resample(infos)
        self.infos = infos

    def _resample(self, infos):
        """CBGS-style class-balanced duplication (ref nuscenes.py:556-597)."""
        cls_infos = {name: [] for name in self.cfg.data.class_names}
        for info in infos:
            names = info.get("gt_names")
            if names is None or len(names) == 0:
                continue
            arr = np.asarray(names)
            first = arr[:, 0] if arr.ndim > 1 else arr
            for name in set(first.tolist()):
                if name in cls_infos:
                    cls_infos[name].append(info)
        dup = sum(len(v) for v in cls_infos.values())
        if dup == 0:
            return infos
        frac = 1.0 / len(cls_infos)
        out = []
        for name, ci in cls_infos.items():
            ratio = frac / (len(ci) / dup) if ci else 0
            sel = self.rng.choice(len(ci), int(len(ci) * ratio)) if ci else []
            out += [ci[i] for i in sel]
        return out or infos

    def __len__(self):
        return len(self.infos)

    def sample(self, idx: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        info = self.infos[idx]
        pts = aggregate_sweeps(info, cfg.data.nsweeps, painted=self.painted)
        gt_boxes, gt_cls, gt_valid, gt_traj, kept = pack_gt(
            cfg, info.get("gt_boxes", []), info.get("gt_names", []),
            info.get("gt_trajectory", []), cfg.data.class_names)
        M = gt_boxes.shape[1]
        gt_attr = np.full((M,), "", object)
        src_attr = info.get("gt_attributes")
        if src_attr is not None and len(kept):
            gt_attr[:len(kept)] = np.asarray(src_attr, object)[kept]
        if self.train and self.db_sampler is not None:
            # GT-AUG paste (ref Preprocess :147-182)
            n0 = int(gt_valid[0].sum())
            sampled = self.db_sampler.sample_all(gt_boxes[0, :n0])
            if sampled is not None:
                S = len(sampled["gt_names"])
                M = gt_boxes.shape[1]
                room = min(S, M - n0)
                cls_list = list(cfg.data.class_names)
                for j in range(room):
                    gt_boxes[:, n0 + j] = sampled["gt_boxes"][j]
                    gt_cls[:, n0 + j] = cls_list.index(
                        sampled["gt_names"][j]) + 1
                    gt_valid[:, n0 + j] = True
                    gt_traj[n0 + j] = TRAJ_TO_ID.get(
                        str(sampled["gt_trajectory"][j]), 1)
                pts = np.concatenate(
                    [sampled["points"][:, :pts.shape[1]], pts], 0)
        aug = None
        if self.train:
            gtb = gt_boxes.copy()
            gtb[~gt_valid] = 0
            gtb, pts, aug = apply_train_augmentations(
                gtb, pts, self.rng, rot_noise=cfg.data.global_rot_noise,
                scale_noise=cfg.data.global_scale_noise,
                translate_std=cfg.data.global_translate_std)
            gt_boxes = gtb
        if cfg.data.shuffle_points and len(pts) <= cfg.voxel.max_points:
            # a permutation gather, not Generator.shuffle (numpy's 2-D
            # shuffle is a row-swap loop). Over-budget clouds skip it:
            # pack_points' random subsample below already yields a
            # uniformly random subset in uniformly random order.
            pts = pts[self.rng.permutation(len(pts))]
        points, pvalid = pack_points(pts, cfg.voxel.max_points, self.rng)
        out = {"points": points, "points_valid": pvalid,
               "gt_boxes": gt_boxes, "gt_classes": gt_cls,
               "gt_valid": gt_valid, "traj_classes": gt_traj,
               "gt_attr": gt_attr,
               "token": info.get("token", str(idx))}
        # per-sample keyframe gaps (ref get_time); the evaluator falls back
        # to the nominal 2 Hz spacing when the horizon length mismatches
        times = info.get("sample_times")
        out["times"] = (np.asarray(times, np.float32) if times is not None
                        else np.zeros((0,), np.float32))
        if cfg.model.head.bev_map:
            bev = np.asarray(info.get("bev", np.zeros((180, 180))),
                             np.float32)
            # stored format (infos.py / ref nusc_common.py:508-509) is the
            # map-IMAGE orientation: row 0 = max ego y. Flip to the canvas
            # orientation (row = y bin increasing, the targets.py heatmap
            # convention) so the map channel is spatially aligned with the
            # feature map it is concatenated to.
            bev = np.ascontiguousarray(np.flipud(bev))
            if aug is not None:
                # warp with the SAME global aug as points/boxes (ref
                # get_mask at preprocess.py:212; see warp_bev_map)
                from .augment import warp_bev_map
                bev = warp_bev_map(bev, aug, cfg.voxel.pc_range)
            if bev.ndim == 2:
                bev = bev[..., None]
            out["bev_map"] = bev / 255.0 if bev.max() > 1.5 else bev
        return out


def with_point_features(cfg: ExperimentConfig, ds) -> ExperimentConfig:
    """cfg whose model takes the width of `ds`'s points (6 for nuScenes
    sweeps: x, y, z, intensity, ring, time lag). The JAX model takes its
    input width from the first batch at init; the port builds from the
    config."""
    return cfg.replace(model=dataclasses.replace(
        cfg.model, num_input_features=ds.point_features))


def info_dataset(cfg: ExperimentConfig, info_path: str, train: bool,
                 seed: int = 0, gt_aug: bool = False,
                 db_info_path: str = None):
    """The CLIs' dataset of an infos pkl: for training CBGS-resampled and
    augmented, with GT-AUG (`gt_database.build_db_sampler`, None when no
    dbinfos pkl is found) when `gt_aug`; for evaluation in order and
    unaugmented. Returns (cfg with the data's point width, the dataset)."""
    if not os.path.exists(info_path):
        raise SystemExit(f"no dataset: {info_path} does not exist")
    db_sampler = None
    if gt_aug:
        from .gt_database import build_db_sampler
        db_sampler = build_db_sampler(cfg, info_path,
                                      db_info_path=db_info_path, seed=seed)
    ds = NuScenesForecastDataset(cfg, info_path, train=train,
                                 class_balanced=train, seed=seed,
                                 db_sampler=db_sampler)
    return with_point_features(cfg, ds), ds


def _collate(samples, cfg: ExperimentConfig, device_targets: bool,
             pin_memory: bool) -> Dict:
    """Stack samples into one batch of torch CPU tensors (pinned when
    `pin_memory`), with the host `gt` dict and `tokens` beside them."""
    from .targets import build_targets

    def tensor(key, pick=lambda x: x):
        t = torch.from_numpy(np.stack([pick(s[key]) for s in samples]))
        return t.pin_memory() if pin_memory else t

    batch = {"points": tensor("points"),
             "points_valid": tensor("points_valid")}
    if device_targets:
        batch["targets_raw"] = {k: tensor(k) for k in (
            "gt_boxes", "gt_classes", "gt_valid", "traj_classes")}
    else:
        tgts = [build_targets(cfg, *(torch.from_numpy(s[k]) for k in (
            "gt_boxes", "gt_classes", "gt_valid", "traj_classes")))
            for s in samples]
        batch["targets"] = {k: torch.stack([t[k] for t in tgts])
                            for k in tgts[0]}
        if cfg.model.two_stage_refine:
            # RoI target assignment needs the raw t0 GT boxes
            # (ref gt_boxes_and_cls through collate, two_stage.py:181)
            batch["targets"]["gt_boxes"] = tensor("gt_boxes",
                                                  lambda x: x[0])
            batch["targets"]["gt_valid"] = tensor("gt_valid",
                                                  lambda x: x[0])
        if pin_memory:
            batch["targets"] = {k: v.pin_memory()
                                for k, v in batch["targets"].items()}
    if "bev_map" in samples[0]:
        batch["bev_map"] = tensor("bev_map")
    batch["tokens"] = [s["token"] for s in samples]
    batch["gt"] = {
        "boxes": np.stack([s["gt_boxes"] for s in samples]),
        "valid": np.stack([s["gt_valid"] for s in samples]),
        "classes": np.stack([s["gt_classes"] for s in samples]),
        "traj": np.stack([s["traj_classes"] for s in samples]),
        "attr": [s["gt_attr"] for s in samples],
        "times": [s["times"] for s in samples],
    }
    return batch


def batches_from_dataset(ds, cfg: ExperimentConfig, batch_size: int,
                         shuffle: bool = True, seed: int = 0,
                         loop: bool = True, device_targets: bool = True,
                         pin_memory: bool = False, num_shards: int = 1,
                         shard_id: int = 0) -> Iterator[dict]:
    """Assemble batches of torch CPU tensors.

    device_targets=True (default): batches carry the raw GT arrays under
    "targets_raw", and the train step renders the heatmap targets on the
    device (`data/targets.py::build_targets_batch`). False renders them on
    the host with `build_targets` into "targets".

    pin_memory=True puts every tensor in page-locked memory, so that its
    copy to the card with `non_blocking=True` runs behind the host; the
    caller asks for it only when the batches go to a card (pinning needs
    one). Under the prefetcher the pinning runs in its thread.

    num_shards / shard_id: the rank's strided share of each epoch's order
    in a data-parallel run (`futuredet_tpu/data/pipeline.py:301-329`, the
    reference's DistributedGroupSampler): every rank draws the same
    permutation from the same seed and takes every num_shards-th sample
    from shard_id on. The per-epoch reseed (ref DistSamplerSeedHook) falls
    out of advancing one rng stream each epoch."""
    rng = np.random.default_rng(seed)
    if loop and len(ds) // num_shards < batch_size:
        raise ValueError(
            f"dataset shard ({len(ds)} samples / {num_shards} shards) is "
            f"smaller than batch_size={batch_size}: the loop would never "
            f"yield a batch (and the other ranks would wait on this one)")
    while True:
        order = rng.permutation(len(ds)) if shuffle else np.arange(len(ds))
        order = order[shard_id::num_shards]
        for i in range(0, len(order) - batch_size + 1, batch_size):
            samples = [ds.sample(int(j)) for j in order[i:i + batch_size]]
            yield _collate(samples, cfg, device_targets, pin_memory)
        if not loop:
            return
