"""Global augmentations — synchronized across all forecast timesteps.

The port's copy of `futuredet_tpu/data/augment.py`: every draw from the
caller's `np.random.Generator` comes in the same order, so the same seed
gives identical arrays. Behavioral ports of `det3d/core/sampler/preprocess.py`:
  random_flip_both   :815-857   x/y flips, angles mirrored, velocities flipped
  global_rotation    :776-799   rotate points, centers, velocities, yaw
  global_scaling_v2  :860+      scale points/centers/sizes/velocities
  global_translate_  :967+      translate points/centers

gt_boxes layout (T, M, 12): [x,y,z,w,l,h,vx,vy,rvx,rvy,rot,rrot]
(angles are the stored -yaw-pi/2 convention; the flip rules below operate on
the stored columns exactly as the reference does).
Host-side numpy; applied before voxelization like the reference pipeline.
"""
from __future__ import annotations

import numpy as np


def _rot_xy(arr_xy, angle):
    c, s = np.cos(angle), np.sin(angle)
    x = arr_xy[..., 0] * c - arr_xy[..., 1] * s
    y = arr_xy[..., 0] * s + arr_xy[..., 1] * c
    return np.stack([x, y], -1)


def random_flip_both(gt_boxes, points, rng, probability=0.5):
    """ref :815-857. gt_boxes (T, M, 12) mutated copy; returns flips."""
    gt = gt_boxes.copy()
    pts = points.copy()
    flips = []
    # x flip (mirror y)
    if rng.random() < probability:
        pts[:, 1] = -pts[:, 1]
        gt[..., 1] = -gt[..., 1]
        gt[..., 10] = -gt[..., 10] + np.pi
        gt[..., 11] = -gt[..., 11] + np.pi
        gt[..., 7] = -gt[..., 7]
        gt[..., 9] = -gt[..., 9]
        flips.append(True)
    else:
        flips.append(False)
    # y flip (mirror x)
    if rng.random() < probability:
        pts[:, 0] = -pts[:, 0]
        gt[..., 0] = -gt[..., 0]
        gt[..., 10] = -gt[..., 10] + 2 * np.pi
        gt[..., 11] = -gt[..., 11] + 2 * np.pi
        gt[..., 6] = -gt[..., 6]
        gt[..., 8] = -gt[..., 8]
        flips.append(True)
    else:
        flips.append(False)
    return gt, pts, flips


def global_rotation(gt_boxes, points, rng, rotation=(-np.pi / 4, np.pi / 4)):
    noise = rng.uniform(rotation[0], rotation[1])
    pts = points.copy()
    pts[:, :2] = _rot_xy(pts[:, :2], noise)
    gt = gt_boxes.copy()
    gt[..., :2] = _rot_xy(gt[..., :2], noise)
    gt[..., 6:8] = _rot_xy(gt[..., 6:8], noise)
    gt[..., 8:10] = _rot_xy(gt[..., 8:10], noise)
    gt[..., 10] += noise
    gt[..., 11] += noise
    return gt, pts, noise


def global_scaling(gt_boxes, points, rng, min_scale=0.9, max_scale=1.1):
    s = rng.uniform(min_scale, max_scale)
    pts = points.copy()
    pts[:, :3] *= s
    gt = gt_boxes.copy()
    gt[..., :6] *= s
    gt[..., 6:10] *= s
    return gt, pts, s


def global_translate(gt_boxes, points, rng, std=0.5):
    if std == 0:
        return gt_boxes, points, np.zeros(3)
    t = rng.normal(0, std, 3)
    pts = points.copy()
    pts[:, :3] += t
    gt = gt_boxes.copy()
    gt[..., :3] += t
    return gt, pts, t


def apply_train_augmentations(gt_boxes, points, rng, *, rot_noise,
                              scale_noise, translate_std):
    """The reference train-time sequence (preprocess.py:189-192)."""
    gt, pts, flips = random_flip_both(gt_boxes, points, rng)
    gt, pts, rot = global_rotation(gt, pts, rng, rot_noise)
    gt, pts, scale = global_scaling(gt, pts, rng, *scale_noise)
    gt, pts, trans = global_translate(gt, pts, rng, translate_std)
    return gt, pts, {"flips": flips, "rot": rot, "scale": scale,
                     "trans": trans}


def warp_bev_map(bev, aug, pc_range):
    """Warp the rasterized ego BEV map with the SAME global augmentation that
    was applied to the points/boxes, so the map branch (n3dtfm configs) trains
    on geometrically consistent input.

    Behavioral counterpart of the reference's `get_mask`
    (`det3d/datasets/pipelines/preprocess.py:75-90`, applied at :212 with the
    `flip_aug/rot_aug/scale_aug/trans_aug` params of the SAME Preprocess call).
    The reference composes cv2 warps whose translation step applies the
    metric noise directly as PIXELS (:84-88 — at the 180 px / 108 m canvas
    that is a 0.6x error); here the warp is one geometrically exact
    inverse-mapped bilinear resample in world coordinates.

    bev: (H, W) or (H, W, C) in CANVAS orientation — row = y bin from
    pc_range[1], col = x bin from pc_range[0] (the data/targets.py heatmap
    convention, `ind = y * W + x`). aug: dict from
    `apply_train_augmentations` ({flips, rot, scale, trans}).
    Out-of-range source regions become 0 (cv2 BORDER_CONSTANT parity).
    """
    bev = np.asarray(bev, np.float32)
    squeeze = bev.ndim == 2
    if squeeze:
        bev = bev[..., None]
    H, W = bev.shape[:2]
    sx = (pc_range[3] - pc_range[0]) / W
    sy = (pc_range[4] - pc_range[1]) / H
    # destination pixel centers in (augmented) world coordinates
    xs = pc_range[0] + (np.arange(W) + 0.5) * sx
    ys = pc_range[1] + (np.arange(H) + 0.5) * sy
    gx, gy = np.meshgrid(xs, ys)
    # invert aug = T . S . R . F  (flip, rotate, scale, translate):
    # g^-1 = F . R^-1 . S^-1 . T^-1
    t = np.asarray(aug.get("trans", np.zeros(3)), np.float64)
    gx = gx - t[0]
    gy = gy - t[1]
    s = float(aug.get("scale", 1.0))
    gx, gy = gx / s, gy / s
    rot = float(aug.get("rot", 0.0))
    c_, s_ = np.cos(-rot), np.sin(-rot)
    gx, gy = gx * c_ - gy * s_, gx * s_ + gy * c_
    flips = aug.get("flips", (False, False))
    if flips[0]:   # x-flip mirrors y (random_flip_both above)
        gy = -gy
    if flips[1]:   # y-flip mirrors x
        gx = -gx
    # world -> continuous source pixel index (centers at +0.5)
    fc = (gx - pc_range[0]) / sx - 0.5
    fr = (gy - pc_range[1]) / sy - 0.5
    r0 = np.floor(fr).astype(np.int64)
    c0 = np.floor(fc).astype(np.int64)
    ar = (fr - r0).astype(np.float32)
    ac = (fc - c0).astype(np.float32)
    out = np.zeros_like(bev)
    for dr in (0, 1):
        for dc in (0, 1):
            rr, cc = r0 + dr, c0 + dc
            wgt = (ar if dr else 1 - ar) * (ac if dc else 1 - ac)
            ok = (rr >= 0) & (rr < H) & (cc >= 0) & (cc < W)
            out += ((wgt * ok)[..., None]
                    * bev[np.clip(rr, 0, H - 1), np.clip(cc, 0, W - 1)])
    return out[..., 0] if squeeze else out


# ---------------------------------------------------------------------------
# per-object noise (ref noise_per_object_v3_, preprocess.py:567-744)
# ---------------------------------------------------------------------------

_CORNERS_NORM = (np.array([[0.0, 0.0], [0.0, 1.0], [1.0, 1.0], [1.0, 0.0]],
                          np.float64) - 0.5)


def _box2d_corners(boxes5):
    """(N, 5) [x,y,w,l,rot] -> (N, 4, 2); ref box2d_to_corner_jit
    (box_np_ops.py:289-307): dims*corners_norm @ [[c,-s],[s,c]] + center."""
    c, s = np.cos(boxes5[:, 4]), np.sin(boxes5[:, 4])
    rot_t = np.stack([np.stack([c, -s], -1), np.stack([s, c], -1)], -2)
    corners = boxes5[:, None, 2:4] * _CORNERS_NORM[None]
    return np.einsum("nkj,njm->nkm", corners, rot_t) + boxes5[:, None, :2]


def _accept_noise(boxes5, valid_mask, loc_noises, rot_noises,
                  global_rot_noises=None):
    """Sequential accept loop of ref noise_per_box / noise_per_box_v2_
    (preprocess.py:219-247, 374-428): per box, the M candidate placements
    are tested in order against the CURRENT corner state (earlier accepted
    boxes have already moved); the first non-colliding candidate wins and
    updates the state. Vectorized over the M tries; the outer loop is
    inherently sequential (FCFS corner updates). MUTATES loc/rot_noises in
    the grot mode exactly like the reference (accepted entries absorb the
    radial displacement). Returns success index per box (-1 = keep)."""
    from ..core.boxes import box_collision_test

    N, M = rot_noises.shape
    box_corners = _box2d_corners(boxes5)
    success = -np.ones((N,), np.int64)
    for i in range(N):
        if not valid_mask[i]:
            continue
        if global_rot_noises is None:
            base = box_corners[i] - boxes5[i, :2]            # (4, 2)
            ang = rot_noises[i]                               # (M,)
            c, s = np.cos(ang), np.sin(ang)
            rot_t = np.stack([np.stack([c, -s], -1),
                              np.stack([s, c], -1)], -2)      # (M, 2, 2)
            cands = (np.einsum("kj,mjl->mkl", base, rot_t)
                     + boxes5[i, :2] + loc_noises[i, :, :2][:, None, :])
        else:
            radius = np.hypot(boxes5[i, 0], boxes5[i, 1])
            grot = np.arctan2(boxes5[i, 0], boxes5[i, 1])     # ref arg order
            dst_grot = grot + global_rot_noises[i]            # (M,)
            dst_pos = radius * np.stack(
                [np.sin(dst_grot), np.cos(dst_grot)], -1)     # (M, 2)
            rot2 = boxes5[i, 4] + (dst_grot - grot)
            c, s = np.cos(rot2), np.sin(rot2)
            rot_t = np.stack([np.stack([c, -s], -1),
                              np.stack([s, c], -1)], -2)
            base = boxes5[i, 2:4] * _CORNERS_NORM             # (4, 2)
            cen = np.einsum("kj,mjl->mkl", base, rot_t)       # centered
            ang = rot_noises[i]
            c2, s2 = np.cos(ang), np.sin(ang)
            rot_t2 = np.stack([np.stack([c2, -s2], -1),
                               np.stack([s2, c2], -1)], -2)
            cands = (np.einsum("mkj,mjl->mkl", cen, rot_t2)
                     + dst_pos[:, None, :] + loc_noises[i, :, :2][:, None, :])
        coll = box_collision_test(cands, box_corners)         # (M, N)
        coll[:, i] = False
        ok = ~coll.any(1)
        if ok.any():
            j = int(np.argmax(ok))
            success[i] = j
            box_corners[i] = cands[j]
            if global_rot_noises is not None:
                loc_noises[i, j, :2] += dst_pos[j] - boxes5[i, :2]
                rot_noises[i, j] += dst_grot[j] - grot
    return success


def noise_per_object(gt_boxes, points=None, valid_mask=None, *,
                     rotation_perturb=np.pi / 4, center_noise_std=1.0,
                     global_rot_range=0.0, num_try=100, rng=None):
    """Per-object placement noise — behavioral port of the reference's
    `noise_per_object_v3_` (`det3d/core/sampler/preprocess.py:567-744`; numba kernels noise_per_box/_v2_,
    points_transform_, box3d_transform_).

    gt_boxes: (N, 7) [x, y, z, w, l, h, rot] (the function's documented
    contract in the reference; its only reachable call site —
    sample_ops.py:321 with 12-col forecast boxes — is dead code there,
    gated on global_random_rotation_range_per_object=[0,0] in every
    shipped config. That call would misread column 6 (vx) as rotation; we
    do NOT reproduce that layout quirk — callers pass a 7-col view).
    points: optional (P, >=3); points inside a moved box move with it
    (first containing valid box wins, ref points_transform_:431-448).
    Returns (gt_boxes, points, success) — new arrays, not mutated.
    """
    from ..core.boxes import points_in_rbbox

    gt = np.array(gt_boxes, np.float64)
    N = len(gt)
    if rng is None:
        rng = np.random.default_rng(0)
    if valid_mask is None:
        valid_mask = np.ones((N,), bool)
    if np.ndim(rotation_perturb) == 0:
        rotation_perturb = [-rotation_perturb, rotation_perturb]
    if np.ndim(global_rot_range) == 0:
        global_rot_range = [-global_rot_range, global_rot_range]
    if np.ndim(center_noise_std) == 0:
        center_noise_std = [center_noise_std] * 3
    enable_grot = abs(global_rot_range[0] - global_rot_range[1]) >= 1e-3

    loc_noises = rng.normal(
        scale=center_noise_std, size=(N, num_try, 3))
    rot_noises = rng.uniform(
        rotation_perturb[0], rotation_perturb[1], (N, num_try))
    grot_noises = None
    if enable_grot:
        gt_grots = np.arctan2(gt[:, 0], gt[:, 1])
        grot_noises = rng.uniform(
            global_rot_range[0] - gt_grots[:, None],
            global_rot_range[1] - gt_grots[:, None], (N, num_try))

    success = _accept_noise(gt[:, [0, 1, 3, 4, 6]], valid_mask,
                            loc_noises, rot_noises, grot_noises)

    sel = np.maximum(success, 0)
    hit = (success >= 0)
    loc_t = np.where(hit[:, None], loc_noises[np.arange(N), sel], 0.0)
    rot_t = np.where(hit, rot_noises[np.arange(N), sel], 0.0)

    pts = None
    if points is not None:
        pts = np.array(points, np.float64)
        if N:
            # first containing VALID box claims the point (ref :443-448);
            # masks from the ORIGINAL boxes, before the transform
            masks = np.asarray(points_in_rbbox(pts[:, :3], gt[:, :7]))
            masks = masks & valid_mask[None, :]
            owner = np.argmax(masks, 1)
            owned = masks.any(1)
            c_, s_ = np.cos(rot_t[owner]), np.sin(rot_t[owner])
            ctr = gt[owner, :3]
            rel = pts[:, :3] - ctr
            rx = rel[:, 0] * c_ + rel[:, 1] * s_      # rel @ [[c,-s],[s,c]]
            ry = -rel[:, 0] * s_ + rel[:, 1] * c_
            moved = np.stack([rx, ry, rel[:, 2]], -1) + ctr + loc_t[owner]
            pts[:, :3] = np.where(owned[:, None], moved, pts[:, :3])
        pts = pts.astype(points.dtype)

    gt[:, :3] += np.where(valid_mask[:, None], loc_t, 0.0)
    gt[:, 6] += np.where(valid_mask, rot_t, 0.0)
    return gt.astype(np.asarray(gt_boxes).dtype), pts, success
