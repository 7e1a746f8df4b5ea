"""CenterNet gaussian heatmap targets.

Port of `futuredet_tpu/core/gaussian.py:21-152` (reference
`det3d/core/utils/center_utils.py:17-64` and the velocity-scaled radius of
AssignLabel, `det3d/datasets/pipelines/preprocess.py:489-497`).

A heatmap is the max over objects of separable gaussians, so each class
map is the exp of a max-plus product of two log-domain axis tables,
(M, H) and (M, W): out[y, x] = max_m ly[m, y] + lx[m, x]. The sum runs in
the log domain and `exp` comes last, then values under fp32 eps become 0,
as in the JAX package: an exp per axis multiplied would differ by an ulp.
Every function takes any leading batch dimensions.
"""
from __future__ import annotations

import torch

# log-domain "minus infinity": exp underflows to exact 0, and a sum of two
# stays finite in fp32
_NEG = -1e30
_EPS32 = float(torch.finfo(torch.float32).eps)


def gaussian_radius(height: torch.Tensor, width: torch.Tensor,
                    min_overlap: float = 0.5) -> torch.Tensor:
    """Least radius keeping IoU >= min_overlap (the three quadratic cases
    of the reference, elementwise min)."""
    a1 = 1.0
    b1 = height + width
    c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 + torch.sqrt(torch.clamp_min(b1 ** 2 - 4 * a1 * c1, 0.0))) / 2

    a2 = 4.0
    b2 = 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    r2 = (b2 + torch.sqrt(torch.clamp_min(b2 ** 2 - 4 * a2 * c2, 0.0))) / 2

    a3 = 4.0 * min_overlap
    b3 = -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    r3 = (b3 + torch.sqrt(torch.clamp_min(b3 ** 2 - 4 * a3 * c3, 0.0))) / 2
    return torch.minimum(torch.minimum(r1, r2), r3)


def radius_with_mult(w_feat: torch.Tensor, l_feat: torch.Tensor,
                     vel_norm: torch.Tensor, timestep, *,
                     gaussian_overlap: float, min_radius: int,
                     radius_mult: bool) -> torch.Tensor:
    """int32 radius max(min_radius, floor(mult * gaussian_radius(l, w))),
    mult = clip(|v| * (1 + t) / 2, 1, 4) when radius_mult, else 1."""
    base = gaussian_radius(l_feat, w_feat, gaussian_overlap)
    if radius_mult:
        mult = torch.clamp(vel_norm * (1.0 + timestep) / 2.0, 1.0, 4.0)
    else:
        mult = 1.0
    r = torch.floor(mult * base).to(torch.int32)
    return torch.clamp_min(r, min_radius)


def _log_axis_tables(centers_int, radii, valid, fmap_w, fmap_h):
    """ly (..., M, H) and lx (..., M, W): -(d^2) / 2 sigma^2 within the
    radius of a valid object, _NEG elsewhere; sigma = (2r + 1) / 6."""
    sigma = (2 * radii + 1).to(torch.float32) / 6.0
    inv = 1.0 / (2.0 * sigma * sigma)

    def axis(cts, n):
        d = (torch.arange(n, dtype=torch.int32, device=cts.device)
             - cts[..., None])                                # (..., M, n)
        lg = -(d.to(torch.float32) ** 2) * inv[..., None]
        ok = (d.abs() <= radii[..., None]) & valid[..., None]
        return torch.where(ok, lg, torch.full_like(lg, _NEG))

    return axis(centers_int[..., 1], fmap_h), axis(centers_int[..., 0],
                                                   fmap_w)


def _maxplus(ly: torch.Tensor, lx: torch.Tensor) -> torch.Tensor:
    """out[..., y, x] = max_m ly[..., m, y] + lx[..., m, x]."""
    return torch.amax(ly[..., :, None] + lx[..., None, :], dim=-3)


def render_heatmap(centers_int: torch.Tensor, radii: torch.Tensor,
                   valid: torch.Tensor, cls_ids: torch.Tensor,
                   num_classes: int, fmap_w: int, fmap_h: int,
                   class_blocked: bool = False) -> torch.Tensor:
    """(..., num_classes, H, W) max-composited heatmaps, draw_umich_gaussian
    centred on the integer cell (gaussian2D of size 2r+1, sigma (2r+1)/6).

    centers_int (..., M, 2) int cells (x, y), radii (..., M) int, valid
    (..., M) bool, cls_ids (..., M) int. class_blocked: the caller
    guarantees cls_ids == repeat(arange(C), M / C) along M (the forecast
    family), so class c renders its own M / C slice only."""
    ly, lx = _log_axis_tables(centers_int, radii, valid, fmap_w, fmap_h)
    M = centers_int.shape[-2]
    maps = []
    if class_blocked:
        if M % num_classes:
            raise ValueError(f"class_blocked needs M ({M}) divisible by "
                             f"num_classes ({num_classes})")
        blk = M // num_classes
        for c in range(num_classes):
            sl = slice(c * blk, (c + 1) * blk)
            maps.append(_maxplus(ly[..., sl, :], lx[..., sl, :]))
    else:
        for c in range(num_classes):
            lyc = torch.where((cls_ids == c)[..., None], ly,
                              torch.full_like(ly, _NEG))
            maps.append(_maxplus(lyc, lx))
    g = torch.exp(torch.stack(maps, -3))
    return torch.where(g < _EPS32, torch.zeros_like(g), g)
