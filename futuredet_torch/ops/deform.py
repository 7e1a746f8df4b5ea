"""Deformable convolution v1 as bilinear gathers and one matmul.

Port of `futuredet_tpu/ops/deform.py` (reference CUDA extension
`det3d/ops/dcn/`, wrapper `deform_conv.py:14-324`), used by the DCN
center head (`models/center_head.py::DCNSepHead`). The JAX package
computes it in plain XLA, outside any Pallas kernel, and so does the port
in plain PyTorch: each tap's input is sampled at its offset position with
four gathers, and the sampled taps are contracted with the weights in one
matmul.
"""
from __future__ import annotations

import torch


def bilinear_sample(img: torch.Tensor, ys: torch.Tensor,
                    xs: torch.Tensor) -> torch.Tensor:
    """img (H, W, C); ys, xs (...,) float pixel coordinates -> (..., C).
    Taps outside the image read zero, as the reference kernel's boundary
    handling does."""
    H, W, _ = img.shape
    y0, x0 = torch.floor(ys), torch.floor(xs)
    wy, wx = (ys - y0)[..., None], (xs - x0)[..., None]

    def tap(yi, xi):
        ok = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        v = img[yi.clamp(0, H - 1).long(), xi.clamp(0, W - 1).long()]
        return torch.where(ok[..., None], v, torch.zeros((), dtype=v.dtype,
                                                         device=v.device))

    return ((1 - wy) * ((1 - wx) * tap(y0, x0) + wx * tap(y0, x0 + 1))
            + wy * ((1 - wx) * tap(y0 + 1, x0) + wx * tap(y0 + 1, x0 + 1)))


def deform_conv2d(x: torch.Tensor, offsets: torch.Tensor,
                  weight: torch.Tensor, deformable_groups: int = 4,
                  row0: int = 0) -> torch.Tensor:
    """3x3 deformable conv, stride 1, pad 1, no bias.

    x (B, Cin, H, W); offsets (B, G * 9 * 2, Ho, W) of the output rows
    row0 .. row0 + Ho - 1 (all H rows by default; a band of them under a
    space layout, where x is the whole input and H the whole canvas's
    height), channels laid out (G, K, (dy, dx)) with the 9 taps K = (ky +
    1) * 3 + (kx + 1) in row-major (ky, kx) order, the reference's layout;
    weight (Cout, Cin, 3, 3). Input channel group g (Cin / G channels)
    samples tap k at (y + ky + dy, x + kx + dx), zero outside the H x W
    input. Returns (B, Cout, Ho, W). Zero offsets give F.conv2d(x, weight,
    padding=1)'s rows."""
    B, Cin, H, W = x.shape
    Ho = offsets.shape[2]
    G, K = deformable_groups, 9
    cg = Cin // G
    dev, dt = x.device, x.dtype
    off = offsets.reshape(B, G, K, 2, Ho, W)
    taps = torch.arange(K, device=dev)
    ky = (taps // 3 - 1).to(dt).view(1, 1, K, 1, 1)
    kx = (taps % 3 - 1).to(dt).view(1, 1, K, 1, 1)
    gy = torch.arange(row0, row0 + Ho, device=dev,
                      dtype=dt).view(1, 1, 1, Ho, 1)
    gx = torch.arange(W, device=dev, dtype=dt).view(1, 1, 1, 1, W)
    ys = gy + ky + off[:, :, :, 0]                       # (B, G, K, Ho, W)
    xs = gx + kx + off[:, :, :, 1]
    y0, x0 = torch.floor(ys), torch.floor(xs)
    wy, wx = ys - y0, xs - x0
    flat = x.reshape(B, G, cg, H * W)
    n = K * Ho * W

    def tap(yi, xi):
        ok = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        idx = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).long()
        v = torch.gather(flat, 3, idx.reshape(B, G, 1, n)
                         .expand(B, G, cg, n))
        return v * ok.reshape(B, G, 1, n).to(dt)

    def w(t):
        return t.reshape(B, G, 1, n)

    samp = (w((1 - wy) * (1 - wx)) * tap(y0, x0)
            + w((1 - wy) * wx) * tap(y0, x0 + 1)
            + w(wy * (1 - wx)) * tap(y0 + 1, x0)
            + w(wy * wx) * tap(y0 + 1, x0 + 1))           # (B, G, cg, n)
    samp = samp.reshape(B, Cin * K, Ho * W)               # row c * 9 + k
    out = torch.matmul(weight.reshape(weight.shape[0], Cin * K), samp)
    return out.reshape(B, -1, Ho, W)
