"""Compact host -> device point feeds for the evaluation path.

The port's copy of `futuredet_tpu/data/feed.py`. `pack_points` encodes an
fp32 (..., F) point array on the host; `unpack_points` decodes it on the
device of the tensor it is given, before any consumer. The port's default
feed is `fp32`, which is exact: the int16 fixed point of the JAX CLI moves
coordinates by up to 2 mm, and a box's points can cross a voxel boundary.

  * `int16`: fixed point per channel, xyz scaled by 256 (ulp 3.9 mm, range
    +-128 m), every other channel (intensity, time lag) by 64 (ulp 0.016,
    range +-512); 10 bytes a point instead of 20.
  * `fp16`: the same wire size, an 11-bit mantissa (~3 cm ulp at |x| in
    [32, 64) m).

Both decode bit for bit as the JAX package does: a cast to fp32, then for
int16 one multiply by the fp32 reciprocal of the scale.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

FEED_DTYPES = ("fp32", "fp16", "int16")
_XYZ_SCALE = 256.0
_AUX_SCALE = 64.0


def _scales(num_features: int) -> np.ndarray:
    s = np.full((num_features,), _AUX_SCALE, np.float32)
    s[:3] = _XYZ_SCALE
    return s


def pack_points(points: np.ndarray, feed_dtype: str) -> np.ndarray:
    """Host-side wire encoding of a (..., F) fp32 point array."""
    if feed_dtype == "fp32":
        return np.asarray(points, np.float32)
    if feed_dtype == "fp16":
        return np.asarray(points, np.float16)
    if feed_dtype == "int16":
        s = _scales(points.shape[-1])
        return np.clip(np.round(points * s), -32768, 32767).astype(np.int16)
    raise ValueError(f"unknown feed_dtype: {feed_dtype}")


def unpack_points(arr: torch.Tensor) -> torch.Tensor:
    """Decode on the tensor's device (identity for fp32)."""
    if arr.dtype == torch.float32:
        return arr
    if arr.dtype == torch.float16:
        return arr.float()
    if arr.dtype == torch.int16:
        s = torch.from_numpy(1.0 / _scales(arr.shape[-1])).to(arr.device)
        return arr.float() * s
    raise ValueError(f"unknown feed dtype: {arr.dtype}")


def unpack_batch(batch: Dict) -> Dict:
    """Decode the packed points of a feed dict (the other keys pass)."""
    out = dict(batch)
    if "points" in out:
        out["points"] = unpack_points(out["points"])
    return out
