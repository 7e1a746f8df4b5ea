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
    (`ops/pallas_gather.py::gather_conv`), on fp32 or bf16 x and W;
  * strided conv: spconv's generative rule, every output site that
    receives an active input under the kernel-3 stride-2 footprint;
  * gradients (`SparseConvFunction`, the port of the custom VJPs
    `_subm_conv_sym_vjp` and `_strided_conv_vjp`): the input gradient is
    again a gather-conv through K2, over the same table with flipped,
    transposed weights (submanifold) or over the inverse table
    (`strided_inverse_table`, strided); the weight gradient is one stacked
    gather and one matmul per conv. Under bf16 features the forward runs
    on K2's bf16 family and the backward on its fp32 families, as the JAX
    VJPs do.

Like spconv, every stage is sized per scene and no site is ever dropped,
so there is no capacity and no drop counter. The JAX package's x-packed
9-probe tables, (R, 128) probe rows and popcount-bitmap maps are TPU
formulations of the same tables and are not ported.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from .pallas_gather import K_TAPS, gather_conv


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
        batch = torch.zeros(coords.shape[0], dtype=torch.int64,
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
    inb = ((q >= 0) & (q < torch.tensor(dims, device=q.device))).all(-1)
    key = batch * math.prod(dims) + linear_ids(q, dims)
    pos = torch.searchsorted(grid.ids, key)
    # position N reads a sentinel that no key of the grid equals
    ids = torch.cat([grid.ids, grid.ids.new_full((1,), -1)])
    found = inb & (ids[pos] == key)
    return torch.where(found, pos, grid.ids.shape[0]).to(torch.int32)


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


def strided_inverse_table(in_grid: SparseGrid, out_grid: SparseGrid,
                          out_dims, kernel: int = 3,
                          pads: Tuple[int, int, int] = (1, 1, 1)
                          ) -> torch.Tensor:
    """(K, N_in) int32 indices into the OUTPUT sites of a kernel-3 stride-2
    conv: row k holds the output o with `strided_gather_table`'s
    tab[k][o] == u, i.e. 2*o + offs[k] + 1 - pad == in_coords[u], and N_out
    where there is none. Each input feeds at most one output per offset
    (the parity must match), so the transpose of a strided conv is again a
    gather-conv. Port of `futuredet_tpu/ops/sparse_conv.py:698-725`."""
    dev = in_grid.coords.device
    offs = torch.tensor(_offsets(kernel), device=dev)
    shift = 1 - torch.tensor(pads, device=dev)
    num = in_grid.coords[None] - offs[:, None] - shift        # (K, N_in, 3)
    even = (num % 2 == 0).all(-1, keepdim=True)
    # an odd offset lands between outputs: -1 lies outside the grid
    oc = torch.where(even, torch.div(num, 2, rounding_mode="floor"), -1)
    return _lookup(out_grid, in_grid.batch[None].expand(len(offs), -1), oc,
                   out_dims)


def bf16_truncate(x: torch.Tensor) -> torch.Tensor:
    """fp32 x rounded toward zero to bf16, as fp32: the numbers of the JAX
    package's bf16-pair packing (`pack_bf16_pairs` then
    `unpack_pairs_fp32`, `futuredet_tpu/ops/sparse_conv.py:477-497`),
    which `conv_x3_packed` feeds to an fp32 product."""
    return (x.contiguous().view(torch.int32) & -65536).view(torch.float32)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor starting 16-byte aligned, as K2 reads it
    (autograd may hand over a strided or offset view)."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def subm_conv_dx(dy: torch.Tensor, table: torch.Tensor,
                 weights: torch.Tensor,
                 inverse_table: torch.Tensor = None) -> torch.Tensor:
    """Input gradient of a sparse conv, (N_out, Cout) -> (N_in, Cin), as
    one K2 launch:

      submanifold (inverse_table None): tap k of site v reaches u exactly
        when tap 26 - k of u reaches v, so dx = gather_conv(dy, table,
        flip_k(W)^T) over the same table (`sparse_conv.py:646-695`);
      strided: dx = gather_conv(dy, inverse_table, W^T), no flip
        (`sparse_conv.py:728-768`).

    Each row of dx is one thread's fixed-order sum: no atomics, so the
    gradient is the same from run to run."""
    if inverse_table is None:
        w = torch.flip(weights, (0,)).transpose(1, 2)
        return gather_conv(_aligned(dy), table, _aligned(w))
    return gather_conv(_aligned(dy), inverse_table,
                       _aligned(weights.transpose(1, 2)))


def subm_conv_dw(features: torch.Tensor, table: torch.Tensor,
                 dy: torch.Tensor) -> torch.Tensor:
    """Weight gradient, dW[k] = gather(x, table[k])^T @ dy, in the stacked
    form: one row gather into (N_out, 27 * Cin), n-major, and one matmul.
    The JAX package computes it outside its kernels too
    (`sparse_conv.py:680-689`)."""
    cin = features.shape[1]
    padded = torch.cat([features, features.new_zeros(1, cin)])
    g = padded.index_select(0, table.t().reshape(-1))
    g = g.view(table.shape[1], K_TAPS * cin)
    return (g.t() @ dy).view(K_TAPS, cin, dy.shape[1])


class SparseConvFunction(torch.autograd.Function):
    """K2 forward; dx through K2 (`subm_conv_dx`) only where the input
    needs it (the voxel features of `conv_input` do not: 5 input channels
    are no K2 output width); dW (`subm_conv_dw`) and db = sum(dy) as
    PyTorch ops.

    `weights` are the parameters' own fp32, whatever the features' type.
    bf16 features take the weights rounded to bf16 in the forward alone
    (K2's bf16 family), as the JAX `_gather_conv` rounds them inside its
    custom VJP (`futuredet_tpu/ops/sparse_conv.py:621-629`, `conv_x3`
    `:466-469`). The backward is the JAX one (`_subm_conv_sym_vjp`
    `:675-691`, `_strided_conv_vjp` `:749-764`): dx is an fp32
    gather-conv of the fp32 cotangent with the fp32 weights (K2's fp32
    families), rounded to the features' type as `dx.astype(x.dtype)`
    does; dW is an fp32 product of the gathered (bf16-valued) rows and
    the fp32 cotangent, and stays fp32."""

    @staticmethod
    def forward(ctx, features, table, weights, bias, inverse_table):
        ctx.save_for_backward(features, table, weights, inverse_table)
        return gather_conv(features, table, weights.to(features.dtype),
                           bias)

    @staticmethod
    def backward(ctx, dy):
        features, table, weights, inverse_table = ctx.saved_tensors
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            if inverse_table is None and table.shape[1] != len(features):
                raise ValueError("a strided conv's input gradient needs its "
                                 "inverse table")
            dx = subm_conv_dx(dy, table, weights, inverse_table).to(
                features.dtype)
        if ctx.needs_input_grad[2]:
            dw = subm_conv_dw(features.to(dy.dtype), table, dy)
        if ctx.needs_input_grad[3]:
            db = dy.sum(0)
        return dx, None, dw, db, None


def subm_conv_apply(features: torch.Tensor, table: torch.Tensor,
                    weights: torch.Tensor, bias: torch.Tensor = None,
                    inverse_table: torch.Tensor = None) -> torch.Tensor:
    """Sparse conv over a gather table (submanifold or strided): features
    (N_in, Cin) fp32 or bf16, table (27, N_out) int32, weights (27, Cin,
    Cout) -> (N_out, Cout) fp32. The weights are rounded to the features'
    type for the product (`SparseConvFunction`). Kernel K2 on the card,
    its plain version on the CPU. Differentiable: a strided conv's input
    gradient needs `inverse_table` (`strided_inverse_table`); a
    submanifold one reuses `table`. Where nothing needs a gradient
    (inference under no_grad) K2 runs without the autograd Function,
    which would keep its inputs."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (features, weights, bias)):
        return SparseConvFunction.apply(features, table, weights, bias,
                                        inverse_table)
    return gather_conv(features, table, weights.to(features.dtype), bias)
