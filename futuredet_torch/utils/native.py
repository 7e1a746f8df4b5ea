"""ctypes bindings of the port's host C++: the metric engine's matcher
(csrc/host_accumulate.cpp) and the data path's sweep loader, voxelizer and
shuffle (csrc/host_data.cpp).

The port's copy of `futuredet_tpu/utils/native.py`. Each library is built
with g++ at its first use into `build/torch_kernels/` (`ops/_build.py`)
and loaded with `ctypes.CDLL`, which lets go of the GIL for the call, so
the prefetch thread's sweep loads overlap the train step. Where the JAX
package returns None and drops to numpy when the build fails, this raises:
the numpy versions run only when the caller asks for them
(`eval/metrics.py::evaluate_forecasts(native=False)`,
`data/pipeline.py::aggregate_sweeps(use_native=False)`).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import numpy as np

from ..ops import _build

_SRC = "host_accumulate.cpp"
_DATA_SRC = "host_data.cpp"
_I32 = ctypes.POINTER(ctypes.c_int32)
_F32 = ctypes.POINTER(ctypes.c_float)
_U8 = ctypes.POINTER(ctypes.c_uint8)
_F64 = ctypes.POINTER(ctypes.c_double)
# the member and GT arrays of fd_accumulate2, in its argument order
_ARRAYS = ((np.int32, _I32), (np.int32, _I32), (np.float32, _F32),
           (np.float32, _F32), (np.float32, _F32), (np.float32, _F32),
           (np.int32, _I32), (np.int32, _I32), (np.float32, _F32),
           (np.float32, _F32), (np.float32, _F32), (np.float32, _F32),
           (np.int32, _I32))


def _lib() -> ctypes.CDLL:
    lib = _build.load(_SRC)
    fn = lib.fd_accumulate2
    if fn.argtypes is None:
        fn.argtypes = ([_I32, ctypes.c_int64]
                       + [t for _, t in _ARRAYS[1:]]
                       + [ctypes.c_int, ctypes.c_float, ctypes.c_float,
                          ctypes.c_int, ctypes.c_uint8, ctypes.c_float,
                          _U8, _F32, _U8])
        fn.restype = None
    return lib


def accumulate_native(unit_offsets, mem_sample, mem_centers, mem_size,
                      mem_yaw, mem_vel, mem_attr, gt_offsets, gt_centers,
                      gt_size, gt_yaw, gt_vel, gt_attr, *, dist_th: float,
                      final_match_th: Optional[float], match_timestep: int,
                      association_oracle: bool, mr_thresh: float):
    """The greedy matcher of the joint-metrics engine (`fd_accumulate2`) on
    the arrays of `eval/metrics.py::_flatten_for_native`. Returns (tp (U,)
    uint8, errs (U, 8) float32). Error columns: trans, scale, orient, vel,
    attr, ade, fde, miss; the attr column is NaN for TPs whose GT has no
    attribute (id -1)."""
    lib = _lib()
    arrays = [np.ascontiguousarray(a, dt) for a, (dt, _) in zip(
        (unit_offsets, mem_sample, mem_centers, mem_size, mem_yaw, mem_vel,
         mem_attr, gt_offsets, gt_centers, gt_size, gt_yaw, gt_vel,
         gt_attr), _ARRAYS)]
    offs, sample, centers, gt_offs, gt_centers = (arrays[i]
                                                  for i in (0, 1, 2, 7, 8))
    U, M = len(offs) - 1, len(sample)
    G, T = gt_centers.shape[0], gt_centers.shape[1]
    if (U < 0 or offs[-1] != M or centers.shape != (M, T, 2)
            or len(gt_offs) < 1 or gt_offs[-1] != G
            or not 0 <= match_timestep < T):
        raise ValueError("accumulate_native: inconsistent flattened arrays")
    tp = np.zeros((U,), np.uint8)
    errs = np.zeros((U, 8), np.float32)
    taken = np.zeros((max(G, 1),), np.uint8)
    ptrs = [a.ctypes.data_as(t) for a, (_, t) in zip(arrays, _ARRAYS)]
    lib.fd_accumulate2(
        ptrs[0], U, *ptrs[1:], T, dist_th,
        -1.0 if final_match_th is None else final_match_th, match_timestep,
        1 if association_oracle else 0, mr_thresh,
        tp.ctypes.data_as(_U8), errs.ctypes.data_as(_F32),
        taken.ctypes.data_as(_U8))
    return tp, errs


def _data_lib() -> ctypes.CDLL:
    lib = _build.load(_DATA_SRC)
    if lib.fd_load_sweeps.argtypes is None:
        lib.fd_load_sweeps.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), _U8, _F64, _F64,
            ctypes.c_int64, ctypes.c_double, _F32, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int]
        lib.fd_load_sweeps.restype = ctypes.c_int64
        lib.fd_voxelize.argtypes = [
            _F32, ctypes.c_int64, ctypes.c_int, _F64, _F64, ctypes.c_int,
            ctypes.c_int64, _F32, _I32, _I32, _I32]
        lib.fd_voxelize.restype = ctypes.c_int64
        lib.fd_shuffle.argtypes = [_F32, ctypes.c_int64, ctypes.c_int,
                                   ctypes.c_uint64]
        lib.fd_shuffle.restype = None
    return lib


def load_sweeps_native(paths: Sequence[str], transforms, time_lags,
                       max_points: int, file_feats: int = 5,
                       keep_feats: int = 5, close_radius: float = 1.0
                       ) -> np.ndarray:
    """Threaded sweep aggregation (`fd_load_sweeps`): the keyframe
    `paths[0]` as it is, then each sweep with its close points (|x| and
    |y| < close_radius) dropped and its (4, 4) transform (or None) applied
    to xyz, each row with its time lag appended. Returns (N, keep_feats +
    1) float32, at most max_points rows; raises OSError naming a file that
    cannot be read."""
    lib = _data_lib()
    n = len(paths)
    if not (len(transforms) == len(time_lags) == n):
        raise ValueError("load_sweeps_native: paths, transforms and "
                         "time_lags differ in length")
    c_paths = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    has_tm = np.array([t is not None for t in transforms], np.uint8)
    tms = np.zeros((n, 16), np.float64)
    for i, t in enumerate(transforms):
        if t is not None:
            tms[i] = np.asarray(t, np.float64).reshape(16)
    lags = np.asarray(time_lags, np.float64)
    # rows past the returned count are never read: no memset
    out = np.empty((max_points, keep_feats + 1), np.float32)
    total = lib.fd_load_sweeps(
        c_paths, has_tm.ctypes.data_as(_U8), tms.ctypes.data_as(_F64),
        lags.ctypes.data_as(_F64), n, close_radius,
        out.ctypes.data_as(_F32), max_points, file_feats, keep_feats)
    if total < 0:
        raise OSError(f"fd_load_sweeps cannot read {paths[-total - 1]}")
    return out[:total]


def voxelize_native(points: np.ndarray, voxel_size, coors_range,
                    max_points: int, max_voxels: int):
    """The reference's hard voxelizer (`fd_voxelize`): points (N, F) ->
    (voxels (V, max_points, F) float32, coors (V, 3) int32 zyx,
    num_points (V,) int32), V <= max_voxels, voxels in order of their
    first point."""
    lib = _data_lib()
    points = np.ascontiguousarray(points, np.float32)
    n, f = points.shape
    vs = np.asarray(voxel_size, np.float64)
    cr = np.asarray(coors_range, np.float64)
    grid = np.round((cr[3:] - cr[:3]) / vs).astype(np.int64)
    voxels = np.zeros((max_voxels, max_points, f), np.float32)
    coors = np.zeros((max_voxels, 3), np.int32)
    nump = np.zeros((max_voxels,), np.int32)
    scratch = np.full(int(np.prod(grid)), -1, np.int32)
    num = lib.fd_voxelize(
        points.ctypes.data_as(_F32), n, f, vs.ctypes.data_as(_F64),
        cr.ctypes.data_as(_F64), max_points, max_voxels,
        voxels.ctypes.data_as(_F32), coors.ctypes.data_as(_I32),
        nump.ctypes.data_as(_I32), scratch.ctypes.data_as(_I32))
    return voxels[:num], coors[:num], nump[:num]


def shuffle_native(points: np.ndarray, seed: int = 0) -> None:
    """Shuffle the rows of a C-contiguous float32 (N, F) array in place
    (`fd_shuffle`: Fisher-Yates over a seeded mt19937_64)."""
    if (not isinstance(points, np.ndarray) or points.dtype != np.float32
            or points.ndim != 2 or not points.flags.c_contiguous):
        raise ValueError("shuffle_native shuffles a C-contiguous float32 "
                         "(N, F) array in place")
    _data_lib().fd_shuffle(points.ctypes.data_as(_F32), points.shape[0],
                           points.shape[1], seed)
