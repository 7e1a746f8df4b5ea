"""Sparse 3D middle encoder, the VoxelNet backbone.

Port of `futuredet_tpu/models/middle.py` (`SparseConv`, `SparseBasicBlock`,
`SparseMiddleEncoder`; reference `SpMiddleResNetFHD`,
`det3d/models/backbones/scn.py:84-177`): 4 stages of {stride-2 sparse conv
+ 2 submanifold residual blocks}, 16 -> 32 -> 64 -> 128 channels over the
(41, 1440, 1440) grid, then a scatter of the last stage to a dense
(B, Z, Y, X, C) canvas whose z-stack is folded into channels z-major
(channel z*C + c). Every sparse conv goes through kernel K2
(`ops/sparse_conv.py::subm_conv_apply`). One table per stage serves all its
submanifold convs (spconv's indice_key, `scn.py:20,99`).

Training: every BatchNorm takes its statistics per sample (the sites'
sample index), as the JAX encoder does under `nn.vmap`, and, with
gradients on, each strided conv builds its inverse table, over which K2
computes that conv's input gradient.

Parameters carry the reference keys (`conv_input.{0,1}`,
`conv1.{j}.conv1/bn1/conv2/bn2`, `conv{s+1}.{0,1,3+j}`) and the spconv
weight layout (kd, kh, kw, Cin, Cout), viewed as (27, Cin, Cout) at call
time, so a reference backbone loads as it is.

The input form of each sparse conv follows the JAX encoder's knobs
(`futuredet_tpu/models/middle.py:149-179,225-238`; `conv_form`):

  * `sparse_dtype="bfloat16"` and `gather_algo="window_bf16"`: x and W
    rounded to bf16, products summed in fp32 (K2's bf16 family; in
    training the backward runs on the fp32 weights, K2's fp32 families,
    `ops/sparse_conv.py::SparseConvFunction`); under
    `window` with bf16 inputs only x is rounded (the Pallas kernel selects
    bf16 rows and multiplies in fp32);
  * `packed_pairs` (`middle_sparse_dtype="bf16_packed"`): at the stages
    the JAX package packs (algo `xpack`, 128 < 3 * Cin <= 256, never in
    training) the inputs are truncated to bf16 and K2's fp32 family runs,
    the numbers of `conv_x3_packed` without its bit packing;
  * `window*` at B > 1 is `loop` and `hybrid` is `stacked` (the JAX
    detector, `futuredet_tpu/models/detector.py:146-149`); in training
    `window*` and `hybrid` are `stacked`: exact fp32 either way.

BatchNorm, the residual and the outputs stay fp32.

`dense_from_stage` (`futuredet_tpu/models/middle.py:75-146,190-223,
322-378`): stages from that one on run as masked dense 3D convs on the
scattered canvas (cuDNN `conv3d`, as the JAX package runs them outside
any Pallas kernel), re-masked after every conv, with the active cells of
a strided stage from a kernel-3 stride-2 max-pool of the mask (the
generative rule). Inactive cells hold zeros, so the sums are the sparse
path's in another order. The dense forms use the sparse modules'
parameters, so one state_dict runs either form. `dense_dtype` rounds the
dense convs' operands to bf16 and sums their products in fp32
(`preferred_element_type=float32`).
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.sparse_conv import (SparseGrid, bf16_truncate, downsample_coords,
                               make_grid, neighbor_table, out_dims_of,
                               scatter_dense, strided_gather_table,
                               strided_inverse_table, subm_conv_apply)
from .readers import MaskedBatchNorm

# K2 input forms of a sparse conv (`conv_form`): fp32 (None), x and W in
# bf16, x rounded to bf16 with fp32 W, x truncated to bf16 with fp32 W
BF16, ROUND_X, TRUNC_X = "bf16", "round_x", "trunc_x"


class SparseConv(nn.Module):
    """One 3x3x3 sparse conv (submanifold or strided: the table decides).
    `weight` is spconv's (3, 3, 3, Cin, Cout)."""

    def __init__(self, cin: int, cout: int, bias: bool = True):
        super().__init__()
        self.cin, self.cout = cin, cout
        self.weight = nn.Parameter(torch.zeros(3, 3, 3, cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Uniform +-(27 * Cin)^-1/2 (the JAX package's `_kernel_init`,
        torch's Conv3d scaling), drawn on the CPU from `generator`; zero
        bias."""
        std = 1.0 / math.sqrt(27 * self.cin)
        u = torch.rand(self.weight.shape, generator=generator)
        self.weight.copy_((2 * u - 1) * std)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor, table: torch.Tensor,
                inverse_table: torch.Tensor = None,
                form: Optional[str] = None) -> torch.Tensor:
        """(N_in, Cin) fp32 -> (N_out, Cout) fp32, with the input `form`
        of `conv_form`. Under BF16 only x is cast here, outside the conv
        (the JAX encoder's `cast`); the fp32 weights go into
        `subm_conv_apply`, which rounds them for the forward alone, so
        that the backward runs on them in fp32 as the JAX VJPs do."""
        w = self.weight.reshape(27, self.cin, self.cout)
        if form == BF16:
            x = x.to(torch.bfloat16)
        elif form == ROUND_X:
            x = x.to(torch.bfloat16).float()
        elif form == TRUNC_X:
            x = bf16_truncate(x)
        return subm_conv_apply(x, table, w, self.bias, inverse_table)

    def dense(self, canvas: torch.Tensor, stride: int = 1,
              pads: Tuple[int, int, int] = (1, 1, 1),
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """The same conv over a dense (B, Cin, Z, Y, X) canvas ->
        (B, Cout, Z', Y', X') fp32 (the JAX `DenseConv3d`). With `dtype`
        the operands are rounded to it and the products summed in fp32.

        Its gradients under `dtype` are computed in fp32 and each is
        rounded to `dtype` on its way back through the rounding of its
        operand, then widened again: d(canvas) and dW carry bf16 values.
        That is JAX's rule for a mixed-precision product (the transpose of
        `dot_general` converts its fp32 result to the operand's dtype).
        The JAX `DenseConv3d` itself cannot be differentiated under a
        compute dtype: the transpose of `conv_general_dilated` passes the
        fp32 cotangent and the bf16 operand to one conv, which raises
        (jax 0.9.0; `tests/test_torch_train_bf16_dense.py`)."""
        w = self.weight.permute(4, 3, 0, 1, 2)        # (Cout, Cin, kd, kh, kw)
        if dtype is not None:
            canvas, w = canvas.to(dtype).float(), w.to(dtype).float()
        return F.conv3d(canvas, w, self.bias, stride, pads)


def _bn_dense(bn: MaskedBatchNorm, x: torch.Tensor, mask: torch.Tensor
              ) -> torch.Tensor:
    """`bn` over a (B, C, Z, Y, X) canvas whose active cells are `mask`
    (B, Z, Y, X): in training the statistics of each sample's active
    cells, averaged over the samples, as the sparse path takes them;
    in eval every cell normalised with the running statistics."""
    if not bn.training:
        return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                            bn.bias, False, 0.0, bn.eps)
    B, C = x.shape[:2]
    rows = x.permute(0, 2, 3, 4, 1).reshape(-1, C)
    sample = torch.arange(B, device=x.device).repeat_interleave(
        rows.shape[0] // B)
    y = bn(rows, mask.reshape(-1), sample, B)
    return y.reshape(B, *x.shape[2:], C).permute(0, 4, 1, 2, 3)


def _masked_relu(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask[:, None], torch.relu(x), 0.0)


def mask_downsample(mask: torch.Tensor, out_dims,
                    pads: Tuple[int, int, int] = (1, 1, 1)) -> torch.Tensor:
    """(B, Z, Y, X) active cells -> those of a kernel-3 stride-2 conv: a
    cell is active iff any input under its window is (the generative rule
    of `downsample_coords`; the JAX `_mask_downsample`)."""
    out = F.max_pool3d(mask[:, None].float(), 3, 2, pads)[:, 0] > 0
    if tuple(out.shape[1:]) != tuple(out_dims):
        raise ValueError(f"mask {tuple(out.shape[1:])} != {out_dims}")
    return out


class SparseBasicBlock(nn.Module):
    """Two submanifold convs with BN and a residual (ref scn.py:37-80)."""

    def __init__(self, features: int):
        super().__init__()
        self.conv1 = SparseConv(features, features)
        self.bn1 = MaskedBatchNorm(features)
        self.conv2 = SparseConv(features, features)
        self.bn2 = MaskedBatchNorm(features)

    def forward(self, x: torch.Tensor, table: torch.Tensor,
                grid: SparseGrid, batch_size: int,
                form: Optional[str] = None) -> torch.Tensor:
        identity = x
        x = torch.relu(self.bn1(self.conv1(x, table, form=form), None,
                                grid.batch, batch_size))
        x = self.bn2(self.conv2(x, table, form=form), None, grid.batch,
                     batch_size)
        return torch.relu(x + identity)

    def dense(self, canvas: torch.Tensor, mask: torch.Tensor,
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """The JAX `DenseBasicBlock`: the same block on a (B, C, Z, Y, X)
        canvas, re-masked after each conv."""
        x = _masked_relu(_bn_dense(self.bn1, self.conv1.dense(
            canvas, dtype=dtype), mask), mask)
        x = _bn_dense(self.bn2, self.conv2.dense(x, dtype=dtype), mask)
        return _masked_relu(x + canvas, mask)


def stage_pads(s: int, dims) -> Tuple[int, int, int]:
    """Stage 3 uses z padding 0 (ref conv4 padding [0, 1, 1],
    `scn.py:129`), giving the 41 -> 21 -> 11 -> 5 depth chain; a z-grid
    too shallow for that falls back to padding 1."""
    pads = (0, 1, 1) if s == 3 else (1, 1, 1)
    if out_dims_of(dims, pads)[0] < 1:
        pads = (1, 1, 1)
    return pads


class SparseMiddleEncoder(nn.Module):
    """`site_counts` holds the active sites of stages 0..3 of the last
    forward (over the whole batch; the active cells of a dense stage,
    counted on the device and copied to the host when read).
    The knobs are the JAX encoder's (module docstring): `gather_algo`,
    `xpack_max_cin`, `sparse_dtype` and `packed_pairs` set each sparse
    conv's input form, `dense_from_stage` and `dense_dtype` the dense
    tail."""

    def __init__(self, num_input_features: int = 5,
                 channels: Tuple[int, ...] = (16, 32, 64, 128),
                 grid_zyx: Tuple[int, int, int] = (41, 1440, 1440),
                 gather_algo: str = "xpack", xpack_max_cin: int = 64,
                 sparse_dtype: Optional[torch.dtype] = None,
                 packed_pairs: bool = False,
                 dense_from_stage: Optional[int] = None,
                 dense_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.grid_zyx = tuple(grid_zyx)
        self.channels = tuple(channels)
        self.gather_algo = gather_algo
        self.xpack_max_cin = xpack_max_cin
        self.sparse_dtype = sparse_dtype
        self.packed_pairs = packed_pairs
        self.dense_from_stage = dense_from_stage
        self.dense_dtype = dense_dtype
        c = channels
        self.conv_input = nn.ModuleList([
            SparseConv(num_input_features, c[0], bias=False),
            MaskedBatchNorm(c[0])])
        self.conv1 = nn.ModuleList([SparseBasicBlock(c[0]) for _ in range(2)])
        for s in range(1, 4):
            self.add_module(f"conv{s + 1}", nn.ModuleList([
                SparseConv(c[s - 1], c[s], bias=False), MaskedBatchNorm(c[s]),
                nn.ReLU(), SparseBasicBlock(c[s]), SparseBasicBlock(c[s])]))
        self._site_counts: List = []

    @property
    def site_counts(self) -> List[int]:
        """The active sites per stage of the last forward ([] before one):
        a sparse stage's count is its table's length, a dense stage's a
        device tensor copied here rather than in the forward (an exported
        program keeps no state, and a copy there would sync every
        forward)."""
        return [int(c) for c in self._site_counts]

    def conv_algo(self, batch_size: int) -> str:
        """The gather algo the JAX package runs at this batch size and
        mode: `window*` -> `loop` and `hybrid` -> `stacked` at B > 1
        (the detector, detector.py:146-149), both -> `stacked` in training
        (the encoder, middle.py:230-233)."""
        algo = self.gather_algo
        if algo.startswith("window") or algo == "hybrid":
            if self.training:
                return "stacked"
            if batch_size > 1:
                return "loop" if algo.startswith("window") else "stacked"
        return algo

    def conv_form(self, algo: str, s: int, cin: int,
                  packable: bool = True) -> Optional[str]:
        """K2's input form for a conv of `cin` inputs whose gather algo is
        stage `s`'s (`xpack` beyond `xpack_max_cin` channels runs
        `stacked`): TRUNC_X where the JAX package packs bf16 pairs
        (middle.py:235-238), BF16 under `window_bf16` or bf16 inputs,
        ROUND_X for bf16 inputs under the fp32 `window`, else None."""
        if algo == "xpack" and self.channels[s] > self.xpack_max_cin:
            algo = "stacked"
        if (packable and self.packed_pairs and not self.training
                and algo == "xpack" and 128 < 3 * cin <= 256):
            return TRUNC_X
        if algo == "window_bf16":
            return BF16
        if self.sparse_dtype is not None:
            return ROUND_X if algo == "window" else BF16
        return None

    def forward(self, voxel_feats: torch.Tensor, coords: torch.Tensor,
                batch: torch.Tensor = None, batch_size: int = 1
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """voxel_feats (N, C), coords (N, 3) zyx of distinct voxels, batch
        (N,) sample index (default 0) -> (dense BEV (B, Y, X, Z*C) with
        channel z*C + c, active z-mask of the reference extra_conv
        (B, Y, X, Dz))."""
        B = batch_size
        dims = self.grid_zyx
        dense_start = (4 if self.dense_from_stage is None
                       else self.dense_from_stage)
        algo = self.conv_algo(B)
        grid, order = make_grid(coords, dims, batch)
        x = voxel_feats[order]
        canvas = mask = None          # the dense tail's, once it starts
        conv, bn = self.conv_input
        if dense_start <= 0:
            canvas, mask = _to_dense(x, grid, dims, B)
            canvas = _masked_relu(_bn_dense(bn, conv.dense(
                canvas, dtype=self.dense_dtype), mask), mask)
            for block in self.conv1:
                canvas = block.dense(canvas, mask, self.dense_dtype)
            counts = [mask.sum()]
        else:
            table = neighbor_table(grid, dims)
            x = torch.relu(bn(conv(x, table, form=self.conv_form(
                algo, 0, conv.cin, packable=False)), None, grid.batch, B))
            for block in self.conv1:
                x = block(x, table, grid, B,
                          self.conv_form(algo, 0, self.channels[0]))
            counts = [grid.ids.shape[0]]
        for s in range(1, 4):
            down, bn, _relu, *blocks = getattr(self, f"conv{s + 1}")
            pads = stage_pads(s, dims)
            out_dims = out_dims_of(dims, pads)
            if s >= dense_start:
                if canvas is None:            # the sparse -> dense turn
                    canvas, mask = _to_dense(x, grid, dims, B)
                canvas = down.dense(canvas, 2, pads, self.dense_dtype)
                mask = mask_downsample(mask, out_dims, pads)
                canvas = _masked_relu(_bn_dense(bn, canvas, mask), mask)
                dims = out_dims
                for block in blocks:
                    canvas = block.dense(canvas, mask, self.dense_dtype)
                counts.append(mask.sum())
                continue
            ngrid = downsample_coords(grid, out_dims, pads)
            # the strided conv reads the previous stage's sites
            dtable = strided_gather_table(grid, ngrid, dims, pads=pads)
            inv = (strided_inverse_table(grid, ngrid, out_dims, pads=pads)
                   if torch.is_grad_enabled() else None)
            form = self.conv_form(algo, s - 1, self.channels[s - 1])
            x = torch.relu(bn(down(x, dtable, inv, form), None, ngrid.batch,
                              B))
            grid, dims = ngrid, out_dims
            table = neighbor_table(grid, dims)
            for block in blocks:
                x = block(x, table, grid, B,
                          self.conv_form(algo, s, self.channels[s]))
            counts.append(grid.ids.shape[0])
        if not torch.compiler.is_exporting():
            self._site_counts = counts

        # z-crush input (ref extra_conv :140-146 and .dense() :165-168):
        # the last stage on a dense canvas, z folded into channels
        if canvas is None:
            canvas, mask = _to_dense(x, grid, dims, B)
        _, C, Z, Y, X = canvas.shape
        # active sites of the ref extra_conv output ((3,1,1) kernel, stride
        # (2,1,1), no z padding): the detector re-masks z_crush with it
        if Z >= 3:
            zmask = torch.stack([mask[:, 2 * d:2 * d + 3].any(1)
                                 for d in range((Z - 3) // 2 + 1)], -1)
        else:
            zmask = mask.any(1)[..., None]
        return canvas.permute(0, 3, 4, 2, 1).reshape(B, Y, X, Z * C), zmask


def _to_dense(x: torch.Tensor, grid: SparseGrid, dims, batch_size: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Site features (N, C) -> the (B, C, Z, Y, X) canvas, zero where
    empty, and its (B, Z, Y, X) active cells."""
    canvas = scatter_dense(x, grid, dims, batch_size)
    mask = torch.zeros(batch_size * math.prod(dims), dtype=torch.bool,
                       device=x.device)
    mask[grid.ids] = True
    return (canvas.permute(0, 4, 1, 2, 3).contiguous(),
            mask.reshape(batch_size, *dims))
