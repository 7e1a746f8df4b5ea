"""Greedy rotated-BEV NMS survivor mask: kernel K1 of the port, in CUDA.

Counterpart of `futuredet_tpu/ops/pallas_nms.py` (the Pallas `_nms_kernel`
behind `nms_alive_mask`); the module keeps that name so the pair is easy to
find, but the kernel here is CUDA C++ for Hopper, `csrc/nms_kernel.cu`
(design and bound in its header). `rotate_nms_alive` launches it for a CUDA
tensor and runs `nms_alive_plain`, the plain PyTorch version, for a CPU
tensor; both take at most `MAX_BOXES` boxes per problem.

Both compute, per problem, over boxes already sorted by score:

    alive[i] = valid[i] and no j < i has alive[j] and IoU_K1(j, i) > thr

where IoU_K1(killer, victim) is K1's formula: the victim's edges are clipped
to the killer shrunk by eps and the killer's edges to the victim grown by
eps. `ops/rotated_iou.py::pairwise_iou_bev(a, b)` clips a's edges to a
shrunk b, so IoU_K1(j, i) = pairwise_iou_bev(boxes, boxes)[i, j]. The XLA
path of the JAX package (`ops/nms.py::rotate_nms`) assigns the roles the
other way round; the two agree except on ties of collinear edges.

The kernel skips the full test of a pair whose centres lie farther apart
than the sum of the two boxes' reaches (for a threshold >= 0 only); such a
pair's IoU is exactly 0. `cull_skips` is the same predicate in PyTorch, with
the kernel's constants, for the tests and `chip_smoke.py`; no path calls it.

The survivor mask is the custom operator `torch.ops.futuredet.nms_alive`
(`torch.library`): its CUDA implementation is the kernel's launch, its CPU
implementation `nms_alive_plain`, and its fake implementation gives the
(G, N) bool shape, so `torch.export` keeps K1 as one node of the program
and a loaded program launches the kernel. `rotate_nms_alive` checks its
inputs and calls the operator.
"""
from __future__ import annotations

import ctypes

import torch
from torch import Tensor

from . import _build
from .rotated_iou import _CLIP_EPS, pairwise_iou_bev

_SRC = "nms_kernel.cu"
_BLOCK = 64
# boxes per problem: pass 2 stages 3 x 64 x ceil(N/64) mask words (192 KB of
# shared memory at N = 8192) and keeps at most 4 bitset words a lane
MAX_BOXES = 8192
# the cull's reach, R + 2 _CLIP_EPS + _CULL_REL (|x| + |y| + R) + _CULL_ABS
# (csrc/nms_kernel.cu: kClipEps, kCullRel, kCullAbs)
_CULL_REL = 1e-4
_CULL_ABS = 1e-4


def nms_alive_plain(nms_boxes: torch.Tensor, valid: torch.Tensor,
                    iou_threshold: float) -> torch.Tensor:
    """(G, N, 5) [x, y, dx, dy, ang] score-sorted, (G, N) bool -> (G, N)
    bool survivors. The full (G, N, N) IoU, then a sequential greedy walk."""
    iou = pairwise_iou_bev(nms_boxes, nms_boxes).transpose(-1, -2)
    return greedy_alive(iou > iou_threshold, valid)


def greedy_alive(kills: torch.Tensor, alive0: torch.Tensor) -> torch.Tensor:
    """Sequential greedy suppression. kills (G, N, N) bool [g, killer,
    victim] in score order (only killer < victim is used); alive0 (G, N)."""
    N = kills.shape[-1]
    kills = kills & torch.ones(N, N, dtype=torch.bool,
                               device=kills.device).triu_(1)
    alive = alive0.clone()
    for i in range(N):
        alive &= ~(kills[:, i] & alive[:, i:i + 1])
    return alive


def cull_reach(nms_boxes: torch.Tensor) -> torch.Tensor:
    """(..., N, 5) -> (..., N) f32 reach of each box, as the kernel's pair
    pass computes it: inf for a box with a non-finite field or reach."""
    x, y, dx, dy, ang = nms_boxes.float().unbind(-1)
    hx, hy = dx * 0.5, dy * 0.5
    r = torch.sqrt(hx * hx + hy * hy)
    reach = (r + 2 * _CLIP_EPS + _CULL_REL * (x.abs() + y.abs() + r)
             + _CULL_ABS)
    ok = torch.isfinite(reach) & torch.isfinite(ang)
    return torch.where(ok, reach, torch.full_like(reach, float("inf")))


def cull_skips(nms_boxes: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """(..., N, 5) -> (..., N, N) bool [killer, victim]: the pairs whose
    full test the kernel skips (every pair, j > i or not; none when the
    threshold is below 0). The same fp32 operations in the same order as
    csrc/nms_kernel.cu."""
    b = nms_boxes.float()
    reach = cull_reach(b)
    dx = b[..., None, :, 0] - b[..., :, None, 0]
    dy = b[..., None, :, 1] - b[..., :, None, 1]
    r = reach[..., :, None] + reach[..., None, :]
    skip = dx * dx + dy * dy > r * r
    return skip & (iou_threshold >= 0)


def _check_size(n: int) -> None:
    if n > MAX_BOXES:
        raise ValueError(f"N={n} boxes per problem exceeds the kernel's "
                         f"limit (N <= {MAX_BOXES})")


def launch_with_mask(nms_boxes, valid, iou_threshold):
    """One K1 launch; returns (alive (G, N) bool, the pass-1 kill bitmask
    (G, N, ceil(N/64)) int64). Mask words left of the diagonal block are
    never written. The bitmask is for checks; `rotate_nms_alive` is the
    entry point."""
    G, N, _ = nms_boxes.shape
    _check_size(N)
    col_blocks = -(-N // _BLOCK)
    dev = nms_boxes.device
    mask = torch.empty((G, N, col_blocks), dtype=torch.int64, device=dev)
    alive = torch.empty((G, N), dtype=torch.bool, device=dev)
    fn = _build.load(_SRC).futuredet_rotate_nms_alive
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(nms_boxes.data_ptr(), valid.data_ptr(), G, N,
                 float(iou_threshold), mask.data_ptr(), alive.data_ptr(),
                 stream)
    if err != 0:
        raise RuntimeError(f"nms_kernel launch failed: cudaError {err}")
    rotate_nms_alive.launches += 1
    return alive, mask


def _nms_alive_cpu(nms_boxes: Tensor, valid: Tensor,
                   iou_threshold: float) -> Tensor:
    # looks the plain version up at each call, so that a rehearsal on the
    # CPU can count the operator's calls, a loaded program's among them
    return nms_alive_plain(nms_boxes, valid, iou_threshold)


def _nms_alive_cuda(nms_boxes: Tensor, valid: Tensor,
                    iou_threshold: float) -> Tensor:
    if not (nms_boxes.is_contiguous() and valid.is_contiguous()):
        raise ValueError("nms_boxes and valid must be contiguous")
    return launch_with_mask(nms_boxes, valid, iou_threshold)[0]


def _nms_alive_fake(nms_boxes: Tensor, valid: Tensor,
                    iou_threshold: float) -> Tensor:
    return torch.empty_like(valid, memory_format=torch.contiguous_format)


# the operator: the low-level registration keeps the dispatcher's cost to
# a few microseconds a call (`torch.library.custom_op` wraps each call in
# Python; scripts/torch_dispatch_cost.py)
_LIB = torch.library.Library("futuredet", "FRAGMENT")
_LIB.define("nms_alive(Tensor nms_boxes, Tensor valid, float iou_threshold)"
            " -> Tensor")
_LIB.impl("nms_alive", _nms_alive_cpu, "CPU")
_LIB.impl("nms_alive", _nms_alive_cuda, "CUDA")
torch.library.register_fake("futuredet::nms_alive", _nms_alive_fake,
                            lib=_LIB)
nms_alive_op = torch.ops.futuredet.nms_alive.default


def rotate_nms_alive(nms_boxes: torch.Tensor, valid: torch.Tensor,
                     iou_threshold: float) -> torch.Tensor:
    """K1: (G, N, 5) f32 contiguous, (G, N) bool -> (G, N) bool survivors,
    N <= MAX_BOXES, through `torch.ops.futuredet.nms_alive`.

    A CUDA tensor goes to the kernel (or raises); a CPU tensor goes to
    `nms_alive_plain`. `rotate_nms_alive.launches` counts kernel launches.
    The mask has no gradient: the boxes enter it detached.
    """
    if nms_boxes.dim() != 3 or nms_boxes.shape[-1] != 5:
        raise ValueError(f"nms_boxes must be (G, N, 5), got "
                         f"{tuple(nms_boxes.shape)}")
    if valid.shape != nms_boxes.shape[:2] or valid.dtype != torch.bool:
        raise ValueError("valid must be a (G, N) bool tensor")
    if nms_boxes.dtype != torch.float32:
        raise TypeError(f"nms_boxes must be float32, got {nms_boxes.dtype}")
    if valid.device != nms_boxes.device:
        raise ValueError("nms_boxes and valid lie on different devices")
    _check_size(nms_boxes.shape[1])
    if nms_boxes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {nms_boxes.device}")
    return nms_alive_op(nms_boxes.detach(), valid, float(iou_threshold))


rotate_nms_alive.launches = 0
