"""Submanifold and strided sparse 3D convolution over gather tables.

Port of the semantic core of `futuredet_tpu/ops/sparse_conv.py`, the
replacement of spconv's SubMConv3d / SparseConv3d used by the reference
middle encoder (`det3d/models/backbones/scn.py:2-3`):

  * active sites: coords (N, 3) zyx with their sample index, sorted by
    the batch-folded linear id `batch * prod(dims) + (z*Y + y)*X + x`, so
    one table and one conv launch serve a whole batch;
  * site map (`SparseGrid.sitemap`, `sitemap_plain`): a bit per cell of
    each sample's grid, in 32-bit words, and the count of sites in the
    words before each, so that a site's index in the sorted grid is the
    rank of its bit;
  * gather tables: (27, N) int32 tables whose absent entries hold N (the
    conv reads a zero row there), the JAX package's tables on the same
    sites;
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

The table builders (`make_grid`, `neighbor_table`, `downsample_coords`,
`strided_gather_table`, `strided_inverse_table`) are the custom operators
`torch.ops.futuredet.<name>`. Their CPU implementations are the plain
builders, the oracle: `torch.sort`, `torch.searchsorted` probes of the
sorted ids, `torch.unique` of a downsample's candidates. Their CUDA
implementations are the kernels of `csrc/sparse_tables.cu` (design in its
header), which look every site up by its rank in a site map and give the
same tables bit for bit, with one host sync a downsample (its site count
sizes the output) and none elsewhere. The device of the coords picks the
implementation. Their fake implementations give the shapes, a
downsample's site count as an unbacked size, so that `torch.export` keeps
each builder as one node.

Like spconv, every stage is sized per scene and no site is ever dropped,
so there is no capacity and no drop counter. The JAX package's x-packed
9-probe tables, (R, 128) probe rows and popcount-bitmap maps are TPU
formulations of the same tables and are not ported.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Tuple

import torch
from torch import Tensor

from ..utils.profiling import span
from . import _build
from .pallas_gather import K_TAPS, gather_conv

_SRC = "sparse_tables.cu"
# words a block of the site map's scan (csrc/sparse_tables.cu: kScanWords)
SCAN_WORDS = 2048
# the lookups of `futuredet_sparse_table` (csrc/sparse_tables.cu: TableKind)
_SUBM, _STRIDED, _INVERSE = 0, 1, 2


class SparseGrid(NamedTuple):
    """Active sites of a batch, ascending `ids` (strictly: one row per
    site), and their site map."""
    coords: torch.Tensor   # (N, 3) int64 zyx
    batch: torch.Tensor    # (N,) int64 sample index
    ids: torch.Tensor      # (N,) int64 batch * prod(dims) + linear id
    sitemap: torch.Tensor  # (B, sitemap_words(dims), 2) int32


def linear_ids(coords: torch.Tensor, dims) -> torch.Tensor:
    z, y, x = coords[..., 0], coords[..., 1], coords[..., 2]
    return (z * dims[1] + y) * dims[2] + x


def sitemap_words(dims) -> int:
    """32-cell words a sample of a site map over `dims`."""
    return -(-math.prod(dims) // 32)


def sitemap_plain(ids: torch.Tensor, dims, batch_size: int) -> torch.Tensor:
    """The site map of ascending, distinct batch-folded `ids` over `dims`:
    (B, W, 2) int32, W = `sitemap_words(dims)`. [b, w, 0] has bit j set
    where cell 32 w + j of sample b is a site; [b, w, 1] counts the sites
    of the words before (b, w). The site at bit j of word (b, w) is then
    site `[b, w, 1] + popcount([b, w, 0] & ((1 << j) - 1))` of the sorted
    grid, as `csrc/sparse_tables.cu` looks it up."""
    cells, words = math.prod(dims), sitemap_words(dims)
    b = torch.div(ids, cells, rounding_mode="floor")
    cell = ids - b * cells
    word = b * words + cell // 32
    m = batch_size * words
    # distinct sites: the sum of their bits is their OR
    bits = torch.zeros(m, dtype=torch.int64, device=ids.device).index_add_(
        0, word, torch.ones_like(cell) << (cell % 32))
    bits = torch.where(bits >= 2**31, bits - 2**32, bits)  # int32's bits
    count = torch.bincount(word, minlength=m)
    prefix = torch.cumsum(count, 0) - count
    return torch.stack([bits, prefix], -1).to(torch.int32).view(
        batch_size, words, 2)


def _offsets(kernel: int = 3):
    """(dz, dy, dx) row-major: K = (dz+1)*9 + (dy+1)*3 + (dx+1)."""
    r = kernel // 2
    return [(dz, dy, dx) for dz in range(-r, r + 1)
            for dy in range(-r, r + 1) for dx in range(-r, r + 1)]


# ---- the plain builders: the operators' CPU implementations -------------

def _make_grid_cpu(coords: Tensor, batch: Optional[Tensor], dims,
                   batch_size: int):
    coords = coords.to(torch.int64)
    if batch is None:
        batch = torch.zeros(coords.shape[0], dtype=torch.int64,
                            device=coords.device)
    batch = batch.to(torch.int64)
    hi = torch.tensor(dims, device=coords.device)
    inside = ((coords >= 0) & (coords < hi)).all(-1)
    if not bool((inside & (batch >= 0) & (batch < batch_size)).all()):
        raise ValueError("make_grid: a site outside the grid or the batch")
    ids = batch * math.prod(dims) + linear_ids(coords, dims)
    ids, order = torch.sort(ids)
    if bool((ids[1:] == ids[:-1]).any()):
        raise ValueError("make_grid: two sites in one cell")
    return (coords[order], batch[order], ids, order,
            sitemap_plain(ids, dims, batch_size))


def _lookup(ids: Tensor, batch: Tensor, q: Tensor, dims) -> Tensor:
    """Index into the sorted `ids` of the site at coords q (..., 3) of
    sample `batch` (...), or N where q lies outside `dims` or holds no
    site."""
    inb = ((q >= 0) & (q < torch.tensor(dims, device=q.device))).all(-1)
    key = batch * math.prod(dims) + linear_ids(q, dims)
    pos = torch.searchsorted(ids, key)
    # position N reads a sentinel that no key of the grid equals
    padded = torch.cat([ids, ids.new_full((1,), -1)])
    found = inb & (padded[pos] == key)
    return torch.where(found, pos, ids.shape[0]).to(torch.int32)


def _neighbor_table_cpu(coords: Tensor, batch: Tensor, ids: Tensor,
                        sitemap: Tensor, dims) -> Tensor:
    offs = torch.tensor(_offsets(), device=coords.device)
    q = coords[None] + offs[:, None]                           # (K, N, 3)
    return _lookup(ids, batch[None].expand(len(offs), -1), q, dims)


def _downsample_coords_cpu(coords: Tensor, batch: Tensor, out_dims, pads,
                           batch_size: int):
    dev = coords.device
    p = coords + torch.tensor(pads, device=dev)
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
                keys.append((batch * total + linear_ids(q, out_dims))[ok])
    ids = torch.unique(torch.cat(keys))                       # sorted
    b = torch.div(ids, total, rounding_mode="floor")
    lin = ids - b * total
    Y, X = out_dims[1], out_dims[2]
    out = torch.stack([lin // (Y * X), (lin // X) % Y, lin % X], -1)
    return out, b, ids, sitemap_plain(ids, out_dims, batch_size)


def _strided_gather_table_cpu(coords: Tensor, batch: Tensor, ids: Tensor,
                              sitemap: Tensor, dims, pads) -> Tensor:
    dev = coords.device
    offs = torch.tensor(_offsets(), device=dev)
    shift = 1 - torch.tensor(pads, device=dev)
    c = 2 * coords[None] + offs[:, None] + shift               # (K, N, 3)
    return _lookup(ids, batch[None].expand(len(offs), -1), c, dims)


def _strided_inverse_table_cpu(coords: Tensor, batch: Tensor, ids: Tensor,
                               sitemap: Tensor, out_dims, pads) -> Tensor:
    dev = coords.device
    offs = torch.tensor(_offsets(), device=dev)
    shift = 1 - torch.tensor(pads, device=dev)
    num = coords[None] - offs[:, None] - shift                # (K, N_in, 3)
    even = (num % 2 == 0).all(-1, keepdim=True)
    # an odd offset lands between outputs: -1 lies outside the grid
    oc = torch.where(even, torch.div(num, 2, rounding_mode="floor"), -1)
    return _lookup(ids, batch[None].expand(len(offs), -1), oc, out_dims)


# ---- the card's builders: csrc/sparse_tables.cu --------------------------

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    "futuredet_make_grid": [_P, _I, _P, _L] + [_I] * 4 + [_P] * 7,
    "futuredet_downsample_mark": [_P, _P, _L] + [_I] * 7 + [_P] * 4,
    "futuredet_downsample_compact": [_P] + [_I] * 4 + [_P] * 4,
    "futuredet_sparse_table": [_I, _P, _P, _L] + [_I] * 6
    + [_P, _I, _I, _P, _P],
}


def _launch(entry: str, *args) -> None:
    fn = getattr(_build.load(_SRC), entry)
    fn.argtypes = _ARGTYPES[entry]
    fn.restype = ctypes.c_int
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} failed: cudaError {err}")


def _check_card(*tensors: Optional[Tensor]) -> None:
    for t in tensors:
        if t is not None and not t.is_contiguous():
            raise ValueError("the card's table builders take contiguous "
                             "tensors")


def _check_sites(coords: Tensor, batch: Tensor) -> None:
    if coords.dtype != torch.int64 or batch.dtype != torch.int64:
        raise ValueError("a grid's coords and batch must be int64")


def _check_map(sitemap: Tensor, dims) -> None:
    if (sitemap.dtype != torch.int32 or sitemap.dim() != 3
            or sitemap.shape[1:] != (sitemap_words(dims), 2)):
        raise ValueError(f"sitemap must be (B, {sitemap_words(dims)}, 2) "
                         f"int32 for dims {tuple(dims)}, got "
                         f"{tuple(sitemap.shape)} {sitemap.dtype}")


def _empty_map(dims, batch_size: int, dev) -> Tuple[Tensor, Tensor]:
    """A site map to fill and its scan's block sums."""
    words = batch_size * sitemap_words(dims)
    return (torch.empty((batch_size, sitemap_words(dims), 2),
                        dtype=torch.int32, device=dev),
            torch.empty(-(-words // SCAN_WORDS), dtype=torch.int32,
                        device=dev))


def _make_grid_cuda(coords: Tensor, batch: Optional[Tensor], dims,
                    batch_size: int):
    if coords.dtype not in (torch.int32, torch.int64) or (
            batch is not None and batch.dtype != torch.int64):
        raise ValueError("make_grid takes int32 or int64 coords and an "
                         "int64 batch")
    _check_card(coords, batch)
    n, dev = coords.shape[0], coords.device
    sitemap, sums = _empty_map(dims, batch_size, dev)
    out = [torch.empty((n, 3), dtype=torch.int64, device=dev)] + [
        torch.empty(n, dtype=torch.int64, device=dev) for _ in range(3)]
    with torch.cuda.device(dev):
        _launch("futuredet_make_grid", coords.data_ptr(),
                coords.element_size(),
                None if batch is None else batch.data_ptr(), n, *dims,
                batch_size, sitemap.data_ptr(), sums.data_ptr(),
                *(t.data_ptr() for t in out))
    make_grid.launches += 1
    return (*out, sitemap)


def _downsample_coords_cuda(coords: Tensor, batch: Tensor, out_dims, pads,
                            batch_size: int):
    _check_sites(coords, batch)
    _check_card(coords, batch)
    dev = coords.device
    sitemap, sums = _empty_map(out_dims, batch_size, dev)
    total = torch.empty(1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _launch("futuredet_downsample_mark", coords.data_ptr(),
                batch.data_ptr(), coords.shape[0], *out_dims, *pads,
                batch_size, sitemap.data_ptr(), sums.data_ptr(),
                total.data_ptr())
        n = int(total)        # the one host sync: the count sizes the sites
        out = (torch.empty((n, 3), dtype=torch.int64, device=dev),
               torch.empty(n, dtype=torch.int64, device=dev),
               torch.empty(n, dtype=torch.int64, device=dev))
        if n:
            _launch("futuredet_downsample_compact", sitemap.data_ptr(),
                    batch_size, *out_dims, *(t.data_ptr() for t in out))
    downsample_coords.launches += 1
    return (*out, sitemap)


def _table_cuda(kind: int, coords: Tensor, batch: Tensor, ids: Tensor,
                sitemap: Tensor, dims, shift) -> Tensor:
    _check_sites(coords, batch)
    _check_map(sitemap, dims)
    _check_card(coords, batch, sitemap)
    n = coords.shape[0]
    table = torch.empty((K_TAPS, n), dtype=torch.int32, device=coords.device)
    if n:
        with torch.cuda.device(coords.device):
            _launch("futuredet_sparse_table", kind, coords.data_ptr(),
                    batch.data_ptr(), n, *dims, *shift, sitemap.data_ptr(),
                    sitemap.shape[0], ids.shape[0], table.data_ptr())
    return table


def _neighbor_table_cuda(coords: Tensor, batch: Tensor, ids: Tensor,
                         sitemap: Tensor, dims) -> Tensor:
    table = _table_cuda(_SUBM, coords, batch, ids, sitemap, dims, (0, 0, 0))
    neighbor_table.launches += 1
    return table


def _strided_gather_table_cuda(coords: Tensor, batch: Tensor, ids: Tensor,
                               sitemap: Tensor, dims, pads) -> Tensor:
    table = _table_cuda(_STRIDED, coords, batch, ids, sitemap, dims,
                        [1 - p for p in pads])
    strided_gather_table.launches += 1
    return table


def _strided_inverse_table_cuda(coords: Tensor, batch: Tensor, ids: Tensor,
                                sitemap: Tensor, out_dims, pads) -> Tensor:
    table = _table_cuda(_INVERSE, coords, batch, ids, sitemap, out_dims,
                        [p - 1 for p in pads])
    strided_inverse_table.launches += 1
    return table


# ---- fake implementations: shapes for tracing ----------------------------

def _make_grid_fake(coords: Tensor, batch: Optional[Tensor], dims,
                    batch_size: int):
    n = coords.shape[0]
    return (coords.new_empty((n, 3), dtype=torch.int64),
            *(coords.new_empty(n, dtype=torch.int64) for _ in range(3)),
            coords.new_empty((batch_size, sitemap_words(dims), 2),
                             dtype=torch.int32))


def _table_fake(coords: Tensor, *args) -> Tensor:
    return coords.new_empty((K_TAPS, coords.shape[0]), dtype=torch.int32)


def _downsample_coords_fake(coords: Tensor, batch: Tensor, out_dims, pads,
                            batch_size: int):
    n = torch.library.get_ctx().new_dynamic_size()
    return (coords.new_empty((n, 3), dtype=torch.int64),
            coords.new_empty(n, dtype=torch.int64),
            coords.new_empty(n, dtype=torch.int64),
            coords.new_empty((batch_size, sitemap_words(out_dims), 2),
                             dtype=torch.int32))


_LIB = torch.library.Library("futuredet", "FRAGMENT")
_TABLE = ("(Tensor coords, Tensor batch, Tensor ids, Tensor sitemap, "
          "int[] dims{}) -> Tensor")
for _name, _schema, _cpu, _cuda, _fake in (
        ("make_grid", "(Tensor coords, Tensor? batch, int[] dims, "
         "int batch_size) -> (Tensor, Tensor, Tensor, Tensor, Tensor)",
         _make_grid_cpu, _make_grid_cuda, _make_grid_fake),
        ("neighbor_table", _TABLE.format(""), _neighbor_table_cpu,
         _neighbor_table_cuda, _table_fake),
        ("downsample_coords", "(Tensor coords, Tensor batch, int[] out_dims, "
         "int[] pads, int batch_size) -> (Tensor, Tensor, Tensor, Tensor)",
         _downsample_coords_cpu, _downsample_coords_cuda,
         _downsample_coords_fake),
        ("strided_gather_table", _TABLE.format(", int[] pads"),
         _strided_gather_table_cpu, _strided_gather_table_cuda, _table_fake),
        ("strided_inverse_table", _TABLE.format(", int[] pads"),
         _strided_inverse_table_cpu, _strided_inverse_table_cuda,
         _table_fake)):
    _LIB.define(_name + _schema)
    _LIB.impl(_name, _cpu, "CPU")
    _LIB.impl(_name, _cuda, "CUDA")
    torch.library.register_fake(f"futuredet::{_name}", _fake, lib=_LIB)
_OPS = torch.ops.futuredet


# ---- the builders --------------------------------------------------------

def make_grid(coords: torch.Tensor, dims, batch: torch.Tensor = None,
              batch_size: int = None) -> Tuple[SparseGrid, torch.Tensor]:
    """coords (N, 3) int zyx of distinct sites inside `dims`, in any order,
    batch (N,) sample index (default 0) of a batch of `batch_size` samples
    (default: 1 + the largest index, which a card tensor reads with a host
    sync) -> (sorted SparseGrid, the sorting permutation). A site outside
    the grid or the batch, or two in one cell, raise ValueError on the CPU
    and fail a device-side assert on the card."""
    if batch_size is None:
        batch_size = (1 if batch is None or batch.numel() == 0
                      else int(batch.max()) + 1)
    if coords.dtype not in (torch.int32, torch.int64):
        coords = coords.to(torch.int64)
    if batch is not None:
        batch = batch.to(torch.int64)
    c, b, ids, order, sitemap = _OPS.make_grid(coords, batch, list(dims),
                                               batch_size)
    return SparseGrid(c, b, ids, sitemap), order


def neighbor_table(grid: SparseGrid, dims) -> torch.Tensor:
    """(27, N) int32 submanifold gather table; N where a neighbour is
    absent."""
    return _OPS.neighbor_table(grid.coords, grid.batch, grid.ids,
                               grid.sitemap, list(dims))


def out_dims_of(dims, pads) -> Tuple[int, int, int]:
    """Grid of a kernel-3 stride-2 conv with per-axis padding `pads`."""
    return tuple((d + 2 * p - 3) // 2 + 1 for d, p in zip(dims, pads))


def downsample_coords(grid: SparseGrid, out_dims,
                      pads: Tuple[int, int, int] = (1, 1, 1)) -> SparseGrid:
    """Output sites of a kernel-3 stride-2 sparse conv (spconv's generative
    rule, `scn.py:109-146`). Per axis, input p reaches q = (p + pad - k) / 2
    for k in {0, 1, 2} of matching parity: hi = (p + pad) // 2 always, and
    hi - 1 when p + pad is even, so each site yields up to 8 candidates.
    Every output site comes once, in ascending id order (the plain builder
    takes `torch.unique` of the candidates). Nothing is dropped."""
    return SparseGrid(*_OPS.downsample_coords(
        grid.coords, grid.batch, list(out_dims), list(pads),
        grid.sitemap.shape[0]))


def strided_gather_table(in_grid: SparseGrid, out_grid: SparseGrid, dims,
                         pads: Tuple[int, int, int] = (1, 1, 1)
                         ) -> torch.Tensor:
    """(K, N_out) int32 indices into the input sites of a kernel-3 stride-2
    conv: input position of output o at offset k is 2*o + k - pad. `dims`
    is the INPUT grid; absent entries hold N_in."""
    return _OPS.strided_gather_table(out_grid.coords, out_grid.batch,
                                     in_grid.ids, in_grid.sitemap,
                                     list(dims), list(pads))


def scatter_dense(features: torch.Tensor, grid: SparseGrid, dims,
                  batch_size: int = 1) -> torch.Tensor:
    """(N, C) site features -> dense (B, Z, Y, X, C), zero where empty."""
    C = features.shape[-1]
    canvas = features.new_zeros((batch_size * math.prod(dims), C))
    canvas.index_copy_(0, grid.ids, features)
    return canvas.reshape(batch_size, *dims, C)


def strided_inverse_table(in_grid: SparseGrid, out_grid: SparseGrid,
                          out_dims,
                          pads: Tuple[int, int, int] = (1, 1, 1)
                          ) -> torch.Tensor:
    """(K, N_in) int32 indices into the OUTPUT sites of a kernel-3 stride-2
    conv: row k holds the output o with `strided_gather_table`'s
    tab[k][o] == u, i.e. 2*o + offs[k] + 1 - pad == in_coords[u], and N_out
    where there is none. Each input feeds at most one output per offset
    (the parity must match), so the transpose of a strided conv is again a
    gather-conv. Port of `futuredet_tpu/ops/sparse_conv.py:698-725`."""
    return _OPS.strided_inverse_table(in_grid.coords, in_grid.batch,
                                      out_grid.ids, out_grid.sitemap,
                                      list(out_dims), list(pads))


# each builder's `.launches` counts the calls of its CUDA implementation
TABLE_BUILDERS = (make_grid, neighbor_table, downsample_coords,
                  strided_gather_table, strided_inverse_table)
for _fn in TABLE_BUILDERS:
    _fn.launches = 0


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
            with span("sparse.dx"):
                dx = subm_conv_dx(dy, table, weights, inverse_table).to(
                    features.dtype)
        with span("sparse.dw"):
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
