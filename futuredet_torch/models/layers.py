"""Shared NN building blocks (NCHW inside, like torch).

Port of `futuredet_tpu/models/layers.py`. Norm semantics match the
reference's `build_norm_layer(dict(type="BN", eps=1e-3, momentum=0.01))`,
with flax's running variance in training (`BatchNorm2d`).
The blocks are flat `nn.Sequential`s so that their `state_dict` keys are the
reference det3d keys (`.0` conv, `.1` BN, `.2` ReLU).

`compute_dtype` is the flax `dtype` of the JAX package's layers (the
config's `compute_dtype="bfloat16"`, its serving mode,
`futuredet_tpu/models/layers.py:26-61`): parameters stay fp32; a conv
casts its input, weight and bias to bf16 and returns bf16; a BatchNorm
computes its statistics and normalises in fp32 and returns bf16, as
`flax.linen.BatchNorm(dtype=bf16)` does. Without it, an input of another
float type is promoted to the parameters' type, as jnp promotes bf16 with
fp32. Training follows flax's dtype at every step of the backward: a
bf16 conv's gradients are bf16 products (dW promoted to the fp32
parameter by the cast's backward), the BatchNorm's fp32 (`BatchNorm2d`).

Spatial sharding (`--space`, `parallel/mesh.py::SpaceGroup`): a layer
whose `space` is set and `banded` true holds a band of the canvas rows.
A conv of kernel k, stride s and padding p reads p rows of the band above
and k - s - p rows of the band below (`parallel/collectives.py::
halo_rows`: 1 and 1 for a 3x3 stride-1 conv, 1 and 0 for the stride-2
stems after `BandPad2d`, none for a 1x1 conv, the 2x2 stride-2 conv and a
transposed conv whose kernel is its stride); every band starts on a
multiple of the stride. A BatchNorm in training sums its band's x, x^2
and count over the space group and averages the means over the data
group. A layer with `space` set and `banded` false runs whole on every
rank of the space group (the prefix before the canvas): its statistics
are averaged over the data group alone, the ranks of a space group
holding the same ones.

Eval BatchNorm folds into the conv before it (`Stack`, the container of
every conv + BatchNorm2d + ReLU block): in eval at fp32 with autograd off,
conv(x, W, b) then BatchNorm is conv(x, W s, (b - mean) s + beta), s =
gamma / sqrt(var + eps) per output channel (dim 1 of a transposed conv's
weight), so the BatchNorm kernel leaves the forward. The folded weights
are plain cached tensors on the BatchNorm, computed once in float64 and
rebuilt when any of their six sources changes (`BatchNorm2d.fold`); the
parameters, buffers and state_dict keys are the unfolded ones. Training,
`compute_dtype` (flax's order: a bf16 conv, then the BatchNorm in fp32),
eval with autograd recording and `torch.export` keep the unfolded path,
so an exported program computes what the eager model computes with
autograd on. `folded` counts
the conv forwards that ran with their BatchNorm folded, `fold_builds` the
folded weights computed.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.collectives import halo_rows, pmean, psum, world_size

BN_EPS = 1e-3
BN_MOMENTUM = 0.01  # torch convention; flax momentum 0.99

# eval BatchNorm folding (module docstring)
folded = 0
fold_builds = 0


def torch_dtype(name: Optional[str]) -> Optional[torch.dtype]:
    """A config's dtype name ("bfloat16" or None) -> torch dtype or None
    (fp32)."""
    if name is None:
        return None
    if name == "bfloat16":
        return torch.bfloat16
    raise ValueError(f"dtype {name!r}: the port takes 'bfloat16' or None")


def band_halo(kernel: int, stride: int, pad: int) -> Tuple[int, int]:
    """The rows a banded window of `kernel` rows at `stride` reads above
    and below its band after `pad` rows of zeros (a band starting on a
    multiple of the stride)."""
    bot = kernel - stride - pad
    if bot < 0:
        raise ValueError(f"a {kernel}-row window at stride {stride}, pad "
                         f"{pad} does not map bands onto bands")
    return pad, bot


class Conv2d(nn.Conv2d):
    """nn.Conv2d (same parameters and keys) in `compute_dtype`, where the
    bias is added to the conv's rounded output, as flax's `nn.Conv` adds
    it. Banded under a space layout (module docstring); a conv after a
    `BandPad2d` (`after_band_pad`) reads the rows that pad exchanged."""
    space = None
    banded = False
    after_band_pad = False

    def __init__(self, *args, compute_dtype: Optional[torch.dtype] = None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def cast(self, t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        return None if t is None else t.to(self.compute_dtype
                                           or self.weight.dtype)

    def rows(self, x: torch.Tensor):
        """(x with its halo rows, the conv's padding, the output rows to
        crop at each end): the padding itself outside a band. Inside one
        a stride-1 conv keeps its padding and crops the rows that padding
        adds, as a conv padded by columns alone ((0, p)) is one that
        cuDNN's heuristics can run through an FFT algorithm at band
        shapes: 179 ms and a 16.8 GB workspace for the VoxelNet head's
        512 -> 64 conv on 92 x 180 rows, where (p, p) takes 0.39 ms
        (scripts/torch_probe_band_convs.py, NVIDIA H100 80GB HBM3,
        700 W)."""
        if not self.banded or self.after_band_pad:
            return x, self.padding, 0
        p = self.padding[0]
        top, bot = band_halo(self.kernel_size[0], self.stride[0], p)
        x = halo_rows(x, top, bot, self.space)
        if self.stride[0] == 1 and top == bot == p:
            return x, self.padding, p
        return x, (0, self.padding[1]), 0

    @staticmethod
    def crop(y: torch.Tensor, rows: int) -> torch.Tensor:
        return y[:, :, rows:y.shape[2] - rows] if rows else y

    def conv(self, x, w, b) -> torch.Tensor:
        x, pad, crop = self.rows(x)
        return self.crop(F.conv2d(x, w, b, self.stride, pad, self.dilation,
                                  self.groups), crop)

    def forward(self, x: torch.Tensor, fold=None) -> torch.Tensor:
        """`fold`: the (weight, bias) of this conv with the BatchNorm after
        it folded in (`BatchNorm2d.fold`), in place of its own."""
        if fold is not None:
            return self.conv(self.cast(x), *fold)
        if self.compute_dtype is None or self.bias is None:
            return self.conv(self.cast(x), self.cast(self.weight),
                             self.cast(self.bias))
        y = self.conv(self.cast(x), self.cast(self.weight), None)
        return y + self.cast(self.bias)[:, None, None]


class ConvTranspose2d(nn.ConvTranspose2d):
    """nn.ConvTranspose2d (same parameters and keys) in `compute_dtype`;
    no output_size argument. With kernel = stride and no padding (the
    RPN's deblocks) a band of rows maps onto a band: no halo."""

    def __init__(self, *args, compute_dtype: Optional[torch.dtype] = None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor, fold=None) -> torch.Tensor:
        """`fold` as Conv2d's."""
        dt = self.compute_dtype or self.weight.dtype
        w, b = fold or (self.weight.to(dt),
                        None if self.bias is None else self.bias.to(dt))
        return F.conv_transpose2d(x.to(dt), w, b, self.stride, self.padding,
                                  self.output_padding, self.groups,
                                  self.dilation)


class BandPad2d(nn.ZeroPad2d):
    """nn.ZeroPad2d(pad) before an unpadded conv of `kernel` rows at
    `stride` (the RPN's stem). Banded, its rows are the halo that conv
    reads (`band_halo`), its columns zeros."""
    space = None
    banded = False

    def __init__(self, pad: int, kernel: int = 3, stride: int = 1):
        super().__init__(pad)
        self.halo = band_halo(kernel, stride, pad)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.banded:
            return super().forward(x)
        left, right = self.padding[:2]
        return F.pad(halo_rows(x, *self.halo, self.space), (left, right))


class SplitInputConv2d(Conv2d):
    """A Conv2d computed as the sum of convs over groups of at most
    MAX_CIN input channels (the same parameters and keys as Conv2d).

    cuDNN's heuristics (torch 2.11, CUDA 12.8, fp32 without TF32) pick an
    FFT algorithm for the 256 -> 128 3x3 conv at 180x180, the stem of the
    VoxelNet RPN: 167-250 ms and a 16.7 GB workspace on an H100, where the
    same conv as two 128-channel convs takes 0.5 ms
    (scripts/torch_probe_stem.py)."""
    MAX_CIN = 128

    def conv(self, x, w, b) -> torch.Tensor:
        if self.in_channels <= self.MAX_CIN or self.groups != 1:
            return super().conv(x, w, b)
        x, pad, crop = self.rows(x)
        out = None
        for c0 in range(0, self.in_channels, self.MAX_CIN):
            y = F.conv2d(x[:, c0:c0 + self.MAX_CIN],
                         w[:, c0:c0 + self.MAX_CIN], None,
                         self.stride, pad, self.dilation)
            out = y if out is None else out + y
        out = self.crop(out, crop)
        return out if b is None else out + b[:, None, None]


class BatchNorm2d(nn.BatchNorm2d):
    """torch's BatchNorm2d (same parameters, buffers and keys) whose
    training step updates `running_var` with the BIASED batch variance, as
    flax's BatchNorm does (`futuredet_tpu/models/layers.py:43-45`); torch's
    own update uses the unbiased one. The batch is normalised with the
    biased variance either way.

    In `compute_dtype`, eval normalises in fp32 with the running
    statistics and casts the output to it. Training under
    `compute_dtype`, and every training step of a data-parallel run,
    takes flax's own formula (`flax.linen.normalization._compute_stats`,
    `_normalize`): E[x] and E[x^2] in fp32 over the batch, averaged over
    the ranks (`parallel/collectives.py::pmean`, differentiable, the JAX
    `axis_name`), var = max(0, E[x^2] - E[x]^2), then (x - mean) *
    (rsqrt(var + eps) * weight) + bias in fp32, whose gradient reaches a
    bf16 x rounded to bf16, as jnp's promotion does. Banded, E[x] and
    E[x^2] are the space group's sums of x and x^2 over its summed count
    (bands differ in rows), then averaged over the data group, as XLA
    takes them over the global batch: each data index holds as many
    rows. `flax_stats` (a class switch) takes flax's formula in every
    training step, so that a single-process step can be held to a
    data-parallel or banded one by their order of additions alone."""
    space = None
    banded = False
    flax_stats = False

    def __init__(self, *args, compute_dtype: Optional[torch.dtype] = None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype
        self._folded = None

    def fold(self, conv: nn.Module):
        """(weight, bias) of `conv` with this BatchNorm folded in, for a
        conv whose output this BatchNorm normalises next, or None where
        the fold does not apply: in training, under `compute_dtype`, with
        autograd recording (the gradients reach the BatchNorm's parameters
        through the unfolded path), or for a conv of another kind. Cached
        against the six sources' identity, storage and version counter,
        so that a load, an in-place edit, an optimizer step, a move and a
        training forward each rebuild it, and a steady forward rebuilds
        nothing. An exported program keeps the unfolded path: traced into
        its graph, the fold would run on every call, a dozen small
        kernels a conv."""
        global folded, fold_builds
        if (self.training or torch.is_grad_enabled()
                or self.compute_dtype is not None
                or not isinstance(conv, (Conv2d, ConvTranspose2d))
                or conv.compute_dtype is not None
                or torch.compiler.is_exporting()):
            return None
        # the dicts, not the attributes: nn.Module's __getattr__ costs the
        # host a microsecond a name, and the pillar head is host-bound
        p, q, r = conv._parameters, self._parameters, self._buffers
        src = (p["weight"], p["bias"], q["weight"], q["bias"],
               r["running_mean"], r["running_var"])
        # the cache holds src, so no id in it is reused while it lives
        stamp = [(id(t), t._version, t.data_ptr()) for t in src
                 if t is not None]
        cache = self._folded
        if cache is None or cache[0] != stamp:
            cache = self._folded = (stamp, src, self._fold_weights(conv))
            fold_builds += 1
        folded += 1
        return cache[2]

    def _fold_weights(self, conv: nn.Module):
        """W s and (b - mean) s + beta in float64, rounded once to W's
        dtype; s scales the output channels, dim 1 of a transposed conv's
        (in, out, kh, kw) weight."""
        w = conv.weight
        s = self.weight.double() / torch.sqrt(
            self.running_var.double() + self.eps)
        shape = (1, -1, 1, 1) if isinstance(conv, ConvTranspose2d) \
            else (-1, 1, 1, 1)
        b = -self.running_mean.double()
        if conv.bias is not None:
            b = b + conv.bias.double()
        return ((w.double() * s.reshape(shape)).to(w.dtype),
                (b * s + self.bias.double()).to(w.dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and (self.compute_dtype is not None
                              or self.flax_stats or world_size() > 1):
            return self._flax_train(x)
        y = self._normalize(x.to(self.weight.dtype))
        return y if self.compute_dtype is None else y.to(self.compute_dtype)

    def _moments(self, xf: torch.Tensor):
        """(E[x], E[x^2]) per channel over the batch of every rank."""
        sq = torch.square(xf)
        if not self.banded:
            return pmean(xf.mean((0, 2, 3)), sq.mean((0, 2, 3)),
                         group=None if self.space is None
                         else self.space.data)
        n = xf.new_tensor([xf.numel() // xf.shape[1]])
        s1, s2, n = psum(xf.sum((0, 2, 3)), sq.sum((0, 2, 3)), n,
                         group=self.space.space)
        return pmean(s1 / n, s2 / n, group=self.space.data)

    def _flax_train(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(self.weight.dtype)
        mean, mean2 = self._moments(xf)
        var = torch.clamp_min(mean2 - torch.square(mean), 0.0)
        with torch.no_grad():
            keep = 1.0 - self.momentum
            self.running_mean.mul_(keep).add_(self.momentum * mean)
            self.running_var.mul_(keep).add_(self.momentum * var)
            self.num_batches_tracked.add_(1)
        m, v, w, b = (t[:, None, None]
                      for t in (mean, var, self.weight, self.bias))
        y = (x - m) * (torch.rsqrt(v + self.eps) * w) + b
        return y if self.compute_dtype is None else y.to(self.compute_dtype)

    def _normalize(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                         self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            keep = 1.0 - self.momentum
            self.running_mean.mul_(keep).add_(self.momentum * mean)
            self.running_var.mul_(keep).add_(self.momentum * var)
            self.num_batches_tracked.add_(1)
        return y


def conv_bn_relu(cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 bias: bool = True, padding: int = None,
                 conv=Conv2d, compute_dtype: Optional[torch.dtype] = None
                 ) -> List[nn.Module]:
    """[conv, BatchNorm2d, ReLU], for a `Stack`. Padding defaults to the
    explicit symmetric (k-1)//2, which is torch's own: a stride-2 3x3
    window starts at -1, as the JAX package forces with explicit
    padding."""
    p = (kernel - 1) // 2 if padding is None else padding
    return [conv(cin, cout, kernel, stride=stride, padding=p, bias=bias,
                 compute_dtype=compute_dtype),
            BatchNorm2d(cout, eps=BN_EPS, momentum=BN_MOMENTUM,
                        compute_dtype=compute_dtype),
            nn.ReLU()]


class Stack(nn.Sequential):
    """nn.Sequential (the same keys) that runs a conv followed by a
    BatchNorm2d as the conv alone, with the BatchNorm folded into its
    weight and bias, wherever the BatchNorm allows (`BatchNorm2d.fold`);
    the ReLU after stays. The folded conv is called as a module, with its
    hooks; the BatchNorm then is not called."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        layers = list(self)
        i = 0
        while i < len(layers):
            bn = layers[i + 1] if i + 1 < len(layers) else None
            fold = bn.fold(layers[i]) if isinstance(bn, BatchNorm2d) \
                else None
            if fold is None:
                x = layers[i](x)
                i += 1
            else:
                x = layers[i](x, fold=fold)
                i += 2
        return x


class ConvBNReLU(Stack):
    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 bias: bool = True, conv=Conv2d,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__(*conv_bn_relu(cin, cout, kernel, stride, bias,
                                       conv=conv,
                                       compute_dtype=compute_dtype))


class DeconvBNReLU(Stack):
    """k == stride transposed conv (the RPN "deblock"), no bias."""

    def __init__(self, cin: int, cout: int, stride: int,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__(
            ConvTranspose2d(cin, cout, stride, stride=stride, bias=False,
                            compute_dtype=compute_dtype),
            BatchNorm2d(cout, eps=BN_EPS, momentum=BN_MOMENTUM,
                        compute_dtype=compute_dtype),
            nn.ReLU())


BAND_AWARE = (Conv2d, BandPad2d, BatchNorm2d)


def lay_out_rows_(module: nn.Module, space, banded: bool) -> None:
    """Give every band-aware layer of `module` the space layout `space`:
    `banded` for the layers after the canvas's band is cut, not for the
    prefix that every rank of a space group runs whole."""
    from .readers import MaskedBatchNorm
    for m in module.modules():
        if isinstance(m, BAND_AWARE + (MaskedBatchNorm,)):
            m.space = space
            m.banded = banded and not isinstance(m, MaskedBatchNorm)


def _fan_in(m: nn.Module) -> int:
    w = m.weight
    if isinstance(m, nn.ConvTranspose2d):     # (in, out, kh, kw)
        return w.shape[0] * w.shape[2] * w.shape[3]
    return math.prod(w.shape[1:])             # (out, in, ...) / (out, in)


@torch.no_grad()
def init_weights_(root: nn.Module, generator: torch.Generator) -> None:
    """LeCun-normal weights (the flax default: std 1/sqrt(fan_in)) drawn from
    `generator` in module order, zero biases, unit BN. Runs on the CPU so the
    same seed gives the same weights whatever device the model goes to."""
    for m in root.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            w = torch.randn(m.weight.shape, generator=generator)
            m.weight.copy_(w / math.sqrt(_fan_in(m)))
            if m.bias is not None:
                m.bias.zero_()
