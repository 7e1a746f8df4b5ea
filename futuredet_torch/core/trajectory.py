"""Trajectory classification: static / linear / nonlinear.

The port's copy of `futuredet_tpu/core/trajectory.py` (reference
`trajectory()`, det3d/datasets/nuscenes/nusc_common.py:311-333): a
tracklet's final position is compared with (a) its start box held static
and (b) a constant-velocity extrapolation; the threshold is max(w, l) of
the final box. Host numpy, vectorised over N tracklets.
"""
from __future__ import annotations

import numpy as np

STATIC, LINEAR, NONLINEAR = 0, 1, 2
TRAJECTORY_NAMES = ("static", "linear", "nonlinear")


def classify_trajectories(centers, velocities, wlh_last, times):
    """centers: (N, T, 2) per-timestep xy in the reference frame;
    velocities: (N, 2) velocity of the first box;
    wlh_last: (N, 2) (w, l) of the final box;
    times: (T-1,) elapsed seconds between consecutive keyframes.

    Returns int array (N,): 0 = static, 1 = linear, 2 = nonlinear.
    """
    centers = np.asarray(centers, np.float64)
    target = centers[:, -1]
    start = centers[:, 0]
    linear = start + velocities * np.sum(times)

    thresh = np.maximum(wlh_last[:, 0], wlh_last[:, 1])
    d_static = np.linalg.norm(target - start, axis=-1)
    d_linear = np.linalg.norm(target - linear, axis=-1)

    out = np.full(centers.shape[0], NONLINEAR, np.int32)
    out[d_linear < thresh] = LINEAR
    out[d_static < thresh] = STATIC   # static first, as the reference checks
    return out
