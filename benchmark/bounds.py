"""The yardstick's arithmetic: operations and bytes of K1 and K2 calls, and
the FLOP count of a scene and of a training step.

Frozen copies of `chip_smoke.py::k2_bound` and `k1_bound` / `k1_pairs`,
changed so:

  * K2's operations are taken at the fastest fp32-accurate rate of the
    card, 3xTF32 on the tensor cores (495 / 3 TFLOP/s), for every conv,
    whatever family the program routes it to (`chip_smoke.py` used the
    67 TFLOP/s CUDA-core rate, which a tensor-core K2 can beat); the
    count comes from the reference's own tables, not the program's;
  * K1's pair tests stay at the 67 TFLOP/s rate (scalar work); the pairs
    that the data needs come from the reference's IoU;
  * a scene's FLOP count (replacing `chip_smoke.py::analytic_flops`,
    which hooked the program's modules and counted K2 densely) is 2 x the
    multiply-adds of the reference's dense layers, from their shapes,
    plus 2 x present (tap, site) pairs x Cin x Cout of each sparse conv.

Each input byte is counted read once and each output byte written once.
"""
from __future__ import annotations

from typing import Dict, List

import torch
from torch import nn

from .reference import nets
from .reference.detect import iou_bev

# fp32 operations of one K1 pair test (csrc/nms_kernel.cu): 8 clipped
# edges of ~50 operations each, the victim's 4 corners (32), the two sums,
# eps shifts and the IoU ratio (~20); of the cull test that skips a pair
# whose circumscribed circles lie apart: 8
K1_OPS_PER_PAIR, K1_OPS_PER_CULL = 450, 8
_CLIP_EPS, _CULL_REL, _CULL_ABS = 1e-5, 1e-4, 1e-4


def sparse_convs(ref: nn.Module, points: torch.Tensor, valid: torch.Tensor
                 ) -> List[Dict]:
    """The output sites, input sites, widths and present (tap, site) pairs
    of each sparse conv of a reference VoxelNet forward on one scene (none
    for a detector without a sparse middle), from the reference's own
    tables."""
    if not hasattr(ref, "backbone"):
        return []
    _, coords = ref.voxels(points, valid)
    out = []
    for table, n_in, cin, cout in ref.backbone.convs(coords):
        out.append({"n_out": table.shape[1], "n_in": n_in, "cin": cin,
                    "cout": cout,
                    "pairs": int((table < n_in).sum())})
    return out


def k2_bound_s(conv: Dict, peaks: Dict, backward: bool = False) -> float:
    """The least seconds of one K2 call: the larger of its bytes (features,
    weights, the int32 table and the fp32 output, each once) at the memory
    rate and its 2 x pairs x Cin x Cout operations at the matmul rate. The
    input gradient (`backward`) is the same contraction transposed: it
    reads the output gradient and writes one row per input site."""
    cin, cout = conv["cin"], conv["cout"]
    n_read, n_write = ((conv["n_out"], conv["n_in"]) if backward
                       else (conv["n_in"], conv["n_out"]))
    c_read, c_write = (cout, cin) if backward else (cin, cout)
    nbytes = 4 * (n_read * c_read + 27 * cin * cout + 27 * n_write
                  + n_write * c_write)
    ops = 2 * conv["pairs"] * cin * cout
    return max(nbytes / peaks["bytes_per_s"],
               ops / peaks["matmul_flops_per_s"])


def _reach(b: torch.Tensor) -> torch.Tensor:
    x, y, dx, dy, _ = b.unbind(-1)
    r = torch.sqrt((dx * 0.5) ** 2 + (dy * 0.5) ** 2)
    return r + 2 * _CLIP_EPS + _CULL_REL * (x.abs() + y.abs() + r) + _CULL_ABS


def k1_bound_s(boxes: torch.Tensor, valid: torch.Tensor, thr: float,
               peaks: Dict) -> float:
    """The least seconds of one K1 call on (G, N, 5) score-sorted boxes in
    the NMS frame: the larger of its bytes (boxes and valid read, survivors
    written) at the memory rate and the pair tests greedy NMS needs on
    these boxes (each survivor against every later valid box that no
    earlier survivor removed; a full test where the circumscribed circles
    meet, a cull test elsewhere) at the fp32 scalar rate."""
    G, N, _ = boxes.shape
    iou = iou_bev(boxes, boxes).transpose(-1, -2)      # [g, victim, killer]
    kills = (iou > thr).transpose(-1, -2)              # [g, killer, victim]
    idx = torch.arange(N, device=boxes.device)
    later = idx[None, :] > idx[:, None]
    alive = valid.clone()
    for i in range(N):
        alive &= ~(kills[:, i] & later[i] & alive[:, i:i + 1])
    first = torch.where(kills & later & alive[:, :, None],
                        idx[None, :, None], N).amin(1)
    needed = (later & alive[:, :, None] & valid[:, None, :]
              & (idx[None, :, None] <= first[:, None, :]))
    reach = _reach(boxes)
    d2 = ((boxes[..., None, :, 0] - boxes[..., :, None, 0]) ** 2
          + (boxes[..., None, :, 1] - boxes[..., :, None, 1]) ** 2)
    far = d2 > (reach[..., :, None] + reach[..., None, :]) ** 2
    culled = int((needed & far).sum())
    full = int(needed.sum()) - culled
    nbytes = boxes.numel() * 4 + 2 * valid.numel()
    return max(nbytes / peaks["bytes_per_s"],
               (full * K1_OPS_PER_PAIR + culled * K1_OPS_PER_CULL)
               / peaks["scalar_flops_per_s"])


def dense_flops(ref: nn.Module, points: torch.Tensor, valid: torch.Tensor
                ) -> float:
    """The forward FLOPs of the dense layers in one reference forward on a
    scene: 2 x the multiply-adds of each Conv2d, ConvTranspose2d and
    Linear call."""
    calls: List[float] = []

    def hook(m, inp, out):
        if isinstance(m, nn.Linear):
            calls.append(2.0 * out.numel() * m.in_features)
        elif isinstance(m, nn.ConvTranspose2d):
            x = inp[0]
            calls.append(2.0 * x.shape[0] * x[0, 0].numel() * m.weight.numel())
        else:
            calls.append(2.0 * out.numel() * m.weight[0].numel())

    hooks = [m.register_forward_hook(hook) for m in nets.dense_layers(ref)]
    try:
        with torch.no_grad():
            ref(points[None], valid[None])
    finally:
        for h in hooks:
            h.remove()
    return sum(calls)
