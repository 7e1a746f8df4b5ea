"""Submanifold and strided sparse 3D convolution over gather tables.

Port of the semantic core of `futuredet_tpu/ops/sparse_conv.py`, the
replacement of spconv's SubMConv3d / SparseConv3d used by the reference
middle encoder (`det3d/models/backbones/scn.py:2-3`):

  * active sites: coords (N, 3) zyx with their sample index, sorted by
    the batch-folded linear id `batch * prod(dims) + (z*Y + y)*X + x`, so
    one table and one conv launch serve a whole batch;
  * neighbour lookup: `torch.searchsorted` over the sorted ids, giving
    (27, N) int32 tables whose absent entries hold N (the conv reads a zero
    row there), the JAX package's tables on the same sites;
  * conv: `out[n] = sum_k x[table[k, n]] @ W[k]`, kernel K2
    (`ops/pallas_gather.py::gather_conv`);
  * strided conv: spconv's generative rule, every output site that
    receives an active input under the kernel-3 stride-2 footprint.

Like spconv, every stage is sized per scene and no site is ever dropped,
so there is no capacity and no drop counter. The JAX package's x-packed
9-probe tables, (R, 128) probe rows and popcount-bitmap maps are TPU
formulations of the same tables and are not ported.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from .pallas_gather import gather_conv


class SparseGrid(NamedTuple):
    """Active sites of a batch, ascending `ids` (strictly: one row per
    site)."""
    coords: torch.Tensor   # (N, 3) int64 zyx
    batch: torch.Tensor    # (N,) int64 sample index
    ids: torch.Tensor      # (N,) int64 batch * prod(dims) + linear id


def linear_ids(coords: torch.Tensor, dims) -> torch.Tensor:
    z, y, x = coords[..., 0], coords[..., 1], coords[..., 2]
    return (z * dims[1] + y) * dims[2] + x


def make_grid(coords: torch.Tensor, dims, batch: torch.Tensor = None
              ) -> Tuple[SparseGrid, torch.Tensor]:
    """coords (N, 3) zyx of distinct sites in any order, batch (N,) sample
    index (default 0) -> (sorted SparseGrid, the sorting permutation)."""
    coords = coords.to(torch.int64)
    if batch is None:
        batch = torch.zeros(len(coords), dtype=torch.int64,
                            device=coords.device)
    ids = batch.to(torch.int64) * math.prod(dims) + linear_ids(coords, dims)
    ids, order = torch.sort(ids)
    return SparseGrid(coords[order], batch.to(torch.int64)[order], ids), order


def _offsets(kernel: int = 3):
    """(dz, dy, dx) row-major: K = (dz+1)*9 + (dy+1)*3 + (dx+1)."""
    r = kernel // 2
    return [(dz, dy, dx) for dz in range(-r, r + 1)
            for dy in range(-r, r + 1) for dx in range(-r, r + 1)]


def _lookup(grid: SparseGrid, batch: torch.Tensor, q: torch.Tensor,
            dims) -> torch.Tensor:
    """Index into `grid` of the site at coords q (..., 3) of sample
    `batch` (...), or N where q lies outside `dims` or holds no site."""
    N = len(grid.ids)
    inb = ((q >= 0) & (q < torch.tensor(dims, device=q.device))).all(-1)
    key = batch * math.prod(dims) + linear_ids(q, dims)
    pos = torch.searchsorted(grid.ids, key)
    if N == 0:
        return torch.zeros(key.shape, dtype=torch.int32, device=q.device)
    found = inb & (grid.ids[pos.clamp_max(N - 1)] == key)
    return torch.where(found, pos, N).to(torch.int32)


def neighbor_table(grid: SparseGrid, dims, kernel: int = 3) -> torch.Tensor:
    """(K, N) int32 submanifold gather table; N where a neighbour is
    absent."""
    offs = torch.tensor(_offsets(kernel), device=grid.coords.device)
    q = grid.coords[None] + offs[:, None]                     # (K, N, 3)
    return _lookup(grid, grid.batch[None].expand(len(offs), -1), q, dims)


def out_dims_of(dims, pads) -> Tuple[int, int, int]:
    """Grid of a kernel-3 stride-2 conv with per-axis padding `pads`."""
    return tuple((d + 2 * p - 3) // 2 + 1 for d, p in zip(dims, pads))


def downsample_coords(grid: SparseGrid, out_dims,
                      pads: Tuple[int, int, int] = (1, 1, 1)) -> SparseGrid:
    """Output sites of a kernel-3 stride-2 sparse conv (spconv's generative
    rule, `scn.py:109-146`). Per axis, input p reaches q = (p + pad - k) / 2
    for k in {0, 1, 2} of matching parity: hi = (p + pad) // 2 always, and
    hi - 1 when p + pad is even, so each site yields up to 8 candidates.
    `torch.unique` of the candidates gives every output site once, in
    ascending id order. Nothing is dropped."""
    dev = grid.coords.device
    p = grid.coords + torch.tensor(pads, device=dev)
    hi = torch.div(p, 2, rounding_mode="floor")
    has2 = (p % 2) == 0
    odz = torch.tensor(out_dims, device=dev)
    total = math.prod(out_dims)
    keys = []
    for bz in (0, 1):
        for by in (0, 1):
            for bx in (0, 1):
                sel = torch.tensor([bz, by, bx], device=dev)
                q = hi - sel
                ok = ((q >= 0) & (q < odz)).all(-1)
                ok &= ((sel == 0) | has2).all(-1)
                keys.append((grid.batch * total + linear_ids(q, out_dims))[ok])
    ids = torch.unique(torch.cat(keys))                       # sorted
    b = torch.div(ids, total, rounding_mode="floor")
    lin = ids - b * total
    Y, X = out_dims[1], out_dims[2]
    coords = torch.stack([lin // (Y * X), (lin // X) % Y, lin % X], -1)
    return SparseGrid(coords, b, ids)


def strided_gather_table(in_grid: SparseGrid, out_grid: SparseGrid, dims,
                         kernel: int = 3,
                         pads: Tuple[int, int, int] = (1, 1, 1)
                         ) -> torch.Tensor:
    """(K, N_out) int32 indices into the input sites of a kernel-3 stride-2
    conv: input position of output o at offset k is 2*o + k - pad. `dims`
    is the INPUT grid; absent entries hold N_in."""
    dev = out_grid.coords.device
    offs = torch.tensor(_offsets(kernel), device=dev)
    shift = 1 - torch.tensor(pads, device=dev)
    c = 2 * out_grid.coords[None] + offs[:, None] + shift      # (K, N, 3)
    return _lookup(in_grid, out_grid.batch[None].expand(len(offs), -1), c,
                   dims)


def scatter_dense(features: torch.Tensor, grid: SparseGrid, dims,
                  batch_size: int = 1) -> torch.Tensor:
    """(N, C) site features -> dense (B, Z, Y, X, C), zero where empty."""
    C = features.shape[-1]
    canvas = features.new_zeros((batch_size * math.prod(dims), C))
    canvas.index_copy_(0, grid.ids, features)
    return canvas.reshape(batch_size, *dims, C)


def subm_conv_apply(features: torch.Tensor, table: torch.Tensor,
                    weights: torch.Tensor, bias: torch.Tensor = None
                    ) -> torch.Tensor:
    """Sparse conv over a gather table (submanifold or strided): features
    (N_in, Cin), table (27, N_out) int32, weights (27, Cin, Cout) ->
    (N_out, Cout). Kernel K2 on the card, its plain version on the CPU."""
    return gather_conv(features, table, weights, bias)
