"""ctypes binding of the port's host C++ matcher (csrc/host_accumulate.cpp).

The accumulate part of `futuredet_tpu/utils/native.py`. The library is
built with g++ at its first use into `build/torch_kernels/`
(`ops/_build.py`). Where the JAX package returns None and drops to numpy
when the build fails, this raises: the numpy matcher runs only when the
caller asks for it (`eval/metrics.py::evaluate_forecasts(native=False)`).
The sweep loader, voxelizer and shuffle of that module wait for the data
pipeline (ROADMAP.md).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from ..ops import _build

_SRC = "host_accumulate.cpp"
_I32 = ctypes.POINTER(ctypes.c_int32)
_F32 = ctypes.POINTER(ctypes.c_float)
_U8 = ctypes.POINTER(ctypes.c_uint8)
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
