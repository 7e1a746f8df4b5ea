"""CUDA kernels of futuredet_torch against their plain PyTorch versions, on
the card. Skipped without one; imports nothing of JAX, so it also runs where
only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from futuredet_torch.ops.pallas_nms import (  # noqa: E402
    nms_alive_plain, rotate_nms_alive)


def rand_nms_boxes(G, n, rng, span=40.0):
    """(G, n, 5) pcdet-frame boxes [x, y, dx, dy, ang]."""
    return np.stack([
        rng.uniform(-span, span, (G, n)), rng.uniform(-span, span, (G, n)),
        rng.uniform(1.0, 6.0, (G, n)), rng.uniform(1.0, 3.0, (G, n)),
        rng.uniform(-np.pi, np.pi, (G, n))], -1).astype(np.float32)


def k1_case(case, G, n, rng):
    """(boxes (G, n, 5), valid (G, n), threshold) of a named card case."""
    valid = np.ones((G, n), bool)
    thr = 0.2
    nb = rand_nms_boxes(G, n, rng)
    if case == "mixed":
        # problem 0 a suppression chain as deep as N, problem 1 axis-aligned
        # boxes with shared (collinear) edges, 5% invalid elsewhere
        nb[0] = 0.0
        nb[0, :, 0] = np.arange(n) * 1.2
        nb[0, :, 2:4] = 2.0
        nb[1, :100] = 0.0
        nb[1, :100, 0] = np.repeat(np.arange(50) * 2.0, 2)
        nb[1, :100, 1] = np.tile([0.0, 1.0], 50)
        nb[1, :100, 2:4] = 2.0
        valid = rng.random((G, n)) < 0.95
        valid[0] = True
        thr = 0.1
    elif case == "spread":
        nb = rand_nms_boxes(G, n, rng, span=61.2)
    elif case == "chain":
        nb[:] = 0.0
        nb[:, :, 0] = np.arange(n) * 1.2
        nb[:, :, 2:4] = 2.0
        nb[:, :, 4] = -np.pi / 2
        thr = 0.1
    elif case == "collinear_grid":
        i = np.arange(n)
        nb[:] = 0.0
        nb[:, :, 0] = (i % 20) * 2.0
        nb[:, :, 1] = (i // 20) * 1.0          # rows half-overlapping
        nb[:, :, 2:4] = 2.0
    elif case == "all_invalid":
        valid[:] = False
    elif case == "dense_cluster":
        nb = chip_smoke.k1_dense_cluster(G, n, rng)
    elif case == "cluster_15m":
        nb = chip_smoke.k1_dense_cluster(G, n, rng)
        nb[..., :2] *= 7.5 / 0.7
    elif case == "cull_margin":
        nb = np.stack([chip_smoke.k1_margin_pairs(n, rng) for _ in range(G)])
    elif case.startswith("non_finite"):
        bad = rng.random((G, n)) < 0.05
        field = rng.integers(0, 5, (G, n))
        vals = rng.choice(np.float32([np.nan, np.inf, -np.inf]), (G, n))
        for f in range(5):
            nb[..., f] = np.where(bad & (field == f), vals, nb[..., f])
        if case == "non_finite_thr_negative":
            thr = -1.0
    elif case == "thr_negative":
        thr = -1.0
    return (torch.from_numpy(nb).cuda(), torch.from_numpy(valid).cuda(),
            thr)


# (case, G, N): the edges of the 64-box blocks, the main path's 7 x 1000,
# B = 4 (28 problems), N at the kernel's limit, and inputs that stress the
# cull, the walk and the arithmetic
K1_CASES = [
    ("spread", 1, 1), ("spread", 1, 63), ("spread", 1, 64), ("spread", 1, 65),
    ("mixed", 7, 1000), ("spread", 7, 1000), ("spread", 28, 1000),
    ("spread", 1, 8192), ("chain", 1, 1000), ("collinear_grid", 1, 400),
    ("all_invalid", 3, 200), ("dense_cluster", 7, 1000),
    ("cluster_15m", 7, 1000), ("cull_margin", 2, 1000),
    ("non_finite", 2, 300), ("non_finite_thr_negative", 2, 300),
    ("thr_negative", 2, 300),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case,G,n", K1_CASES)
def test_k1_matches_plain_version_on_the_card(case, G, n):
    """K1 against its plain version on the card: identical survivors, one
    launch per call, every kill bit of a pair j > i equal to plain IoU >
    thr (a pair the cull skips has plain IoU exactly 0)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from futuredet_torch.ops.pallas_nms import cull_skips, launch_with_mask
    from futuredet_torch.ops.rotated_iou import pairwise_iou_bev
    boxes, valid, thr = k1_case(case, G, n, np.random.default_rng(n + G))
    before = rotate_nms_alive.launches
    got = rotate_nms_alive(boxes, valid, thr)
    torch.cuda.synchronize()
    assert rotate_nms_alive.launches == before + 1
    want = nms_alive_plain(boxes, valid, thr)
    assert torch.equal(got, want)
    assert not bool(got[~valid].any())
    alive, mask = launch_with_mask(boxes, valid, thr)
    assert torch.equal(alive, want)
    later = torch.ones(n, n, dtype=torch.bool, device="cuda").triu_(1)
    kill = pairwise_iou_bev(boxes, boxes).transpose(-1, -2) > thr
    assert torch.equal(chip_smoke.kill_bits(mask, n) & later, kill & later)
    skipped = int((cull_skips(boxes, thr) & later).sum())
    if case in ("mixed", "chain"):     # greedy keeps every other box
        assert int(got[0].sum()) == n // 2
    if case in ("dense_cluster", "thr_negative") or thr < 0:
        assert skipped == 0
    if case in ("spread", "cull_margin") and n >= 1000:
        assert skipped > 0


def k2_case(rng, V, N, cin, cout, absent=0.6):
    """Random features, a (27, N) table with a share of absent entries
    (index V), weights and bias, on the card."""
    x = torch.from_numpy(rng.normal(size=(V, cin)).astype(np.float32))
    tab = rng.integers(0, V, (27, N))
    tab[rng.random((27, N)) < absent] = V
    w = (rng.normal(size=(27, cin, cout)) / np.sqrt(27 * cin)).astype(
        np.float32)
    b = rng.normal(size=cout).astype(np.float32)
    return (x.cuda(), torch.from_numpy(tab.astype(np.int32)).cuda(),
            torch.from_numpy(w).cuda(), torch.from_numpy(b).cuda())


# (V, N, Cin, Cout, share of absent entries): every (Cin, Cout) of the
# voxelnet main path, N off the 64- and 128-site tiles, Cout = 8 in both
# families, and tiles in which every site has all 27 neighbours
K2_CASES = [
    (5000, 5000, 5, 16, 0.6),        # conv_input, narrow
    (4000, 4000, 16, 16, 0.6),       # stage-0 subm, narrow
    (3000, 1111, 16, 32, 0.8),       # down1 (strided, N < V), narrow
    (3000, 3000, 32, 32, 0.6),       # stage-1 subm, wide
    (3000, 1500, 32, 64, 0.8),       # down2, wide
    (2000, 2000, 64, 64, 0.6),       # stage-2 subm, wide
    (2000, 1200, 64, 128, 0.8),      # down3, wide
    (1000, 1000, 128, 128, 0.55),    # stage-3 subm, wide
    (1000, 1, 128, 128, 0.3),        # N = 1
    (2000, 65, 64, 64, 0.6),         # N = 65
    (3000, 129, 32, 32, 0.6),        # N = 129, wide
    (3000, 129, 16, 16, 0.6),        # N = 129, narrow
    (700, 700, 32, 8, 0.6),          # Cout = 8, wide
    (700, 700, 16, 8, 0.6),          # Cout = 8, narrow
    (5000, 128, 128, 128, 0.0),      # all 27 taps present, wide
    (5000, 256, 16, 32, 0.0),        # all 27 taps present, narrow
]


@pytest.mark.cuda
@pytest.mark.parametrize("V,N,cin,cout,absent", K2_CASES)
def test_k2_matches_plain_version_on_the_card(V, N, cin, cout, absent):
    """The gather-conv kernel against its plain version, within fp32
    summation order (1e-5 of max(1, max|plain|)), bit-identical when
    launched again, and exactly the bias for a table with no neighbour."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from futuredet_torch.ops.pallas_gather import (gather_conv,
                                                   gather_conv_plain)
    torch.backends.cuda.matmul.allow_tf32 = False
    x, tab, w, b = k2_case(np.random.default_rng(V + N + cin), V, N, cin,
                           cout, absent)
    before = gather_conv.launches
    got = gather_conv(x, tab, w, b)
    again = gather_conv(x, tab, w, b)
    torch.cuda.synchronize()
    assert gather_conv.launches == before + 2
    want = gather_conv_plain(x, tab, w, b)
    tol = 1e-5 * max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= tol
    assert torch.equal(got, again)
    # a table with no neighbour at all gives exactly the bias
    empty = torch.full_like(tab, V)
    assert torch.equal(gather_conv(x, empty, w, b), b.expand(N, cout))
    assert torch.equal(gather_conv(x, empty, w),
                       torch.zeros(N, cout, device="cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout", [(32, 32), (128, 128)])
@pytest.mark.parametrize("side", ["64_sites", "128_sites"])
def test_k2_wide_family_on_both_sides_of_its_tile_switch(cin, cout, side):
    """The wide family takes 128-site tiles from N = 2 * 128 * SMs on (two
    tiles per SM), 64-site ones below: one N on each side of that switch,
    the upper one off the tile, against the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from futuredet_torch.ops.pallas_gather import (gather_conv,
                                                   gather_conv_plain)
    torch.backends.cuda.matmul.allow_tf32 = False
    switch = 2 * 128 * torch.cuda.get_device_properties(0).multi_processor_count
    N = switch - 1 if side == "64_sites" else switch + 65
    x, tab, w, b = k2_case(np.random.default_rng(N + cin), 4000, N, cin, cout)
    got = gather_conv(x, tab, w, b)
    want = gather_conv_plain(x, tab, w, b)
    tol = 1e-5 * max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= tol
    assert torch.equal(got, gather_conv(x, tab, w, b))


@pytest.mark.cuda
def test_voxelnet_rpn_stem_avoids_the_fft_conv():
    """cuDNN (fp32, TF32 off) picks an FFT algorithm for the 256 -> 128
    3x3 conv at 180x180, the VoxelNet RPN stem: ~200 ms and a 16.7 GB
    workspace. The port's stem splits its input channels and must stay
    under 10 ms and 1 GiB."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from futuredet_torch.models.backbone2d import RPN
    torch.backends.cudnn.allow_tf32 = False
    rpn = RPN(256).cuda().eval()
    stem = rpn.blocks[0][1]
    x = torch.randn(1, 256, 182, 182, device="cuda")
    with torch.no_grad():
        stem(x)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        stem(x)
        end.record()
        end.synchronize()
    assert start.elapsed_time(end) < 10.0
    assert torch.cuda.max_memory_allocated() - base < 2**30


def sparse_case(rng, dims, n, strided):
    """n random distinct sites of one sample: (grid, the conv's table, the
    inverse table of a strided conv or None, output sites)."""
    from futuredet_torch.ops import sparse_conv as sc
    lin = rng.choice(int(np.prod(dims)), n, replace=False)
    coords = np.stack([lin // (dims[1] * dims[2]), (lin // dims[2]) % dims[1],
                       lin % dims[2]], -1)
    grid, _ = sc.make_grid(torch.from_numpy(coords).cuda(), dims)
    if not strided:
        return sc.neighbor_table(grid, dims), None, n
    pads = (1, 1, 1)
    out_dims = sc.out_dims_of(dims, pads)
    out = sc.downsample_coords(grid, out_dims, pads)
    return (sc.strided_gather_table(grid, out, dims, pads=pads),
            sc.strided_inverse_table(grid, out, out_dims, pads=pads),
            len(out.ids))


# (Cin, Cout, strided) of the forward conv; its input gradient runs K2 at
# (Cout -> Cin): the strided downs give 32 -> 16 (the wide family at
# Cout = 16), 64 -> 32 and 128 -> 64, the submanifold blocks the squares
# with flipped weights
DX_CASES = [(16, 32, True), (32, 64, True), (64, 128, True), (16, 16, False),
            (32, 32, False), (64, 64, False), (128, 128, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout,strided", DX_CASES)
def test_sparse_conv_backward_on_the_card(cin, cout, strided):
    """The sparse conv's gradients against torch.autograd through the plain
    version on the card: dx (one K2 launch) within 1e-5 of max(1,
    max|plain|) and bit-identical when launched again, dW and db within
    1e-5 of theirs; a table of absent entries only gives dx = 0 exactly."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from futuredet_torch.ops import sparse_conv as sc
    from futuredet_torch.ops.pallas_gather import (gather_conv,
                                                   gather_conv_plain)
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(cin + cout + strided)
    table, inv, n_out = sparse_case(rng, (41, 96, 96), 6000, strided)
    x = torch.from_numpy(rng.normal(size=(6000, cin)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(27, cin, cout))
                          / np.sqrt(27 * cin)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=cout).astype(np.float32))
    dy = torch.from_numpy(rng.normal(size=(n_out, cout)).astype(np.float32))
    x, w, b, dy = x.cuda(), w.cuda(), b.cuda(), dy.cuda()
    grads = {}
    for name, fn in (("function", lambda x_, w_, b_: sc.subm_conv_apply(
            x_, table, w_, b_, inv)),
                     ("plain", lambda x_, w_, b_: gather_conv_plain(
                         x_, table, w_, b_))):
        leaves = [t.clone().requires_grad_() for t in (x, w, b)]
        before = gather_conv.launches
        grads[name] = torch.autograd.grad(fn(*leaves), leaves, dy)
        torch.cuda.synchronize()
        if name == "function":
            assert gather_conv.launches == before + 2   # forward and dx
    for got, want in zip(grads["function"], grads["plain"]):
        tol = 1e-5 * max(1.0, float(want.abs().max()))
        assert float((got - want).abs().max()) <= tol
    dx = sc.subm_conv_dx(dy, table, w, inv)
    assert torch.equal(dx, sc.subm_conv_dx(dy, table, w, inv))
    assert torch.equal(dx, grads["function"][0])
    absent = torch.full_like(inv if strided else table, n_out)
    assert torch.equal(sc.subm_conv_dx(dy, table if strided else absent, w,
                                       absent if strided else None),
                       torch.zeros_like(x))


@pytest.mark.cuda
def test_small_train_step_card_against_the_cpu():
    """One train step of a small forecast_n3dtf on the card and on the CPU
    from the same weights and batch, BatchNorm biases raised so that no
    ReLU input lies near 0: loss within 1e-4, each gradient within 1e-3 of
    its max |g|, running statistics within 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    import dataclasses

    from futuredet_torch import config
    from futuredet_torch.data.synthetic import make_batch
    from futuredet_torch.models.detector import build_detector
    from futuredet_torch.train.step import forward_backward
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = config.tiny_variant(config.get_config("forecast_n3dtf"))
    cfg = cfg.replace(voxel=dataclasses.replace(
        cfg.voxel, max_points=4096, max_voxels_train=4096))
    batch = make_batch(cfg, 2, seed=3, n_objects=8, n_clutter=2000)
    out = {}
    for dev in ("cpu", "cuda"):
        m = build_detector(cfg, device=dev, seed=0).train()
        chip_smoke.shift_bn_biases(m)
        # the host GT under "gt" (numpy, for the evaluator) stays put
        b = {k: (v.to(dev) if isinstance(v, torch.Tensor) else
                 {kk: (vv.to(dev) if isinstance(vv, torch.Tensor) else vv)
                  for kk, vv in v.items()})
             for k, v in batch.items()}
        loss = float(forward_backward(m, b)["loss"].detach())
        out[dev] = (loss, {n: p.grad.cpu() for n, p in m.named_parameters()},
                    {n: t.cpu() for n, t in m.named_buffers()
                     if n.endswith(("running_mean", "running_var"))},
                    list(m.backbone.site_counts))
    (lc, gc, sc_, sites_c), (lg, gg, sg, sites_g) = out["cpu"], out["cuda"]
    assert sites_c == sites_g and sites_c[0] > 500
    assert abs(lg - lc) <= 1e-4 * abs(lc)
    ratios = chip_smoke.grad_ratios(gg, gc)
    assert max(r for r in ratios.values() if r is not None) <= 1e-3
    for n, t in sc_.items():
        assert float((sg[n] - t).abs().max()) <= 1e-4 * max(
            1.0, float(t.abs().max())), n


@pytest.mark.cuda
def test_pillar_reader_trains_on_the_card_as_on_the_cpu():
    """The pillar reader in train mode (two PFN layers, pad floor at 10) on
    the card and on the CPU from the same weights, on a scene with
    duplicated points (exact ties in the pillar max) and layer-0 channels
    that ReLU zeroes everywhere (ties at zero): canvas within 1e-5, running
    statistics within 1e-6, each parameter's gradient of a random
    projection of the canvas within 1e-4 of max(1, max |CPU|); and the
    pillar max and the floor split tied gradients evenly on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from futuredet_torch.models import readers
    torch.backends.cuda.matmul.allow_tf32 = False
    v = torch.tensor([[3.0], [3.0], [1.0], [5.0], [5.0], [5.0]],
                     device="cuda", requires_grad=True)
    seg = torch.tensor([0, 0, 0, 1, 1, 1], device="cuda")
    out = readers._segment_max(v, seg, 2)
    (out * torch.tensor([[3.0], [1.0]], device="cuda")).sum().backward()
    assert torch.allclose(v.grad.cpu()[:, 0], torch.tensor(
        [1.5, 1.5, 0.0, 1 / 3, 1 / 3, 1 / 3]), rtol=1e-7, atol=0)
    a = torch.tensor([1.0, 2.0], device="cuda", requires_grad=True)
    torch.maximum(a, torch.tensor([1.0, 1.0], device="cuda")).sum().backward()
    assert a.grad.tolist() == [0.5, 1.0]

    rng = np.random.default_rng(8)
    B, P = 2, 4000
    pts = np.zeros((B, P, 5), np.float32)
    centres = rng.uniform(-7, 7, (8, 2))
    pts[:, :800, :2] = centres[rng.integers(0, 8, (B, 800))] \
        + rng.normal(0, 0.15, (B, 800, 2))
    pts[:, 800:, :2] = rng.uniform(-9, 9, (B, P - 800, 2))
    pts[..., 2] = rng.uniform(-3.5, 3.5, (B, P))
    pts[..., 3:] = rng.uniform(0, 1, (B, P, 2))
    pts[:, 3000:3300] = pts[:, :300]
    valid = rng.random((B, P)) < 0.9
    proj = torch.from_numpy(rng.normal(size=(B, 32, 32, 16))
                            .astype(np.float32))
    ref = readers.PillarFeatureNetDirect(
        num_filters=(16, 16), voxel_size=(0.5, 0.5),
        pc_range=(-8.0, -8.0, -3.0, 8.0, 8.0, 3.0), grid_hw=(32, 32),
        pad_floor_cap=10)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for n, p in ref.named_parameters():
            scale = 0.5 if n.endswith("linear.weight") else 0.2
            p.copy_(torch.randn(p.shape, generator=g) * scale
                    + (1.0 if n.endswith("norm.weight") else 0.0))
        ref.pfn_layers[0].norm.bias[:3] = -50.0
    got = {}
    for dev in ("cpu", "cuda"):
        m = readers.PillarFeatureNetDirect(
            num_filters=(16, 16), voxel_size=(0.5, 0.5),
            pc_range=(-8.0, -8.0, -3.0, 8.0, 8.0, 3.0), grid_hw=(32, 32),
            pad_floor_cap=10)
        m.load_state_dict(ref.state_dict())
        m = m.to(dev).train()
        canvas = m(torch.from_numpy(pts).to(dev),
                   torch.from_numpy(valid).to(dev))
        (canvas * proj.to(dev)).sum().backward()
        got[dev] = (canvas.detach().cpu(),
                    {n: p.grad.cpu() for n, p in m.named_parameters()},
                    {n: b.cpu() for n, b in m.named_buffers()
                     if n.endswith(("running_mean", "running_var"))})
    (cc, gc, sc_), (cg, gg, sg) = got["cpu"], got["cuda"]
    assert float((cg - cc).abs().max()) <= 1e-5
    for n, t in sc_.items():
        assert float((sg[n] - t).abs().max()) <= 1e-6, n
    for n, t in gc.items():
        tol = 1e-4 * max(1.0, float(t.abs().max()))
        assert float((gg[n] - t).abs().max()) <= tol, n
    assert not gc["pfn_layers.0.norm.bias"][:3].any()


# (V, N, Cin, Cout, share of absent entries[, taps absent at every site])
# of K2's bf16 family: every (Cin, Cout) of the voxelnet main path, Cin not
# a multiple of 8 (2-byte row loads) or of 64 (several taps a 64-slot
# chunk; a chunk that straddles two taps at Cin = 72), N off the 64- and
# 128-site tiles (128 where N / 128 rounded up >= 132 SMs), Cout = 8 with
# W resident and streamed, a packed chunk whose taps no site has,
# persistent grids
# with more than two tiles a block, tiles whose sites have all 27
# neighbours, and W resident (<= 128 KB packed) or streamed
K2_BF16_CASES = [
    (5000, 5000, 5, 16, 0.6), (4000, 4000, 16, 16, 0.6),
    (3000, 1111, 16, 32, 0.8), (3000, 3000, 32, 32, 0.6),
    (3000, 1500, 32, 64, 0.8), (2000, 2000, 64, 64, 0.6),
    (2000, 1200, 64, 128, 0.8), (1000, 1000, 128, 128, 0.55),
    (1000, 1, 128, 128, 0.3), (2000, 65, 40, 64, 0.6),
    (700, 700, 24, 8, 0.6), (700, 129, 3, 32, 0.5),
    (5000, 128, 128, 128, 0.0), (5000, 256, 16, 32, 0.0),
    # around the 64-site tile (small N) and the 128-site one (N > 16,768)
    (3000, 127, 32, 32, 0.5), (3000, 128, 64, 64, 0.5),
    (3000, 129, 16, 16, 0.5), (3000, 255, 128, 128, 0.5),
    (9000, 17919, 32, 64, 0.6), (9000, 17920, 16, 16, 0.6),
    (9000, 17921, 64, 128, 0.6),
    # Cin = 8 (eight taps a chunk) and 16 (four), Cin = 12 (two granules a
    # tap, the second half zeros), Cin = 72 (chunks straddling two taps)
    (3000, 3000, 8, 32, 0.6), (3000, 20000, 16, 64, 0.6),
    (1500, 1500, 12, 16, 0.5), (1000, 1500, 72, 64, 0.5),
    # Cin = 5 with taps 8-15 (the second packed chunk) absent everywhere
    (5000, 20000, 5, 16, 0.6, tuple(range(8, 16))),
    # no neighbour at all: one chunk of zeros, the bias alone
    (500, 300, 16, 32, 1.0),
    # persistent grids: more than two tiles a block
    (40000, 80000, 32, 32, 0.6), (35000, 35000, 128, 128, 0.55),
    # Cout = 8: W resident (Cin = 16) and streamed (Cin = 1024)
    (3000, 20000, 16, 8, 0.5), (500, 300, 1024, 8, 0.7),
]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "case", K2_BF16_CASES,
    ids=lambda c: "-".join(map(str, c[:5])) + ("-dead" if c[5:] else ""))
def test_k2_bf16_family_matches_plain_version_on_the_card(case):
    """The bf16 family against its plain version (bf16 rows, fp32 products
    and sums): 1e-5 of max(1, max|plain|), bit-identical when launched
    again, exactly the bias for a table with no neighbour, counted on its
    route."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from futuredet_torch.ops.pallas_gather import (gather_conv,
                                                   gather_conv_plain)
    torch.backends.cuda.matmul.allow_tf32 = False
    V, N, cin, cout, absent = case[:5]
    x, tab, w, b = k2_case(np.random.default_rng(V + N + cin), V, N, cin,
                           cout, absent)
    if len(case) > 5:
        tab[list(case[5])] = V
    x, w = x.bfloat16(), w.bfloat16()
    before = dict(gather_conv.launches_by_route)
    got = gather_conv(x, tab, w, b)
    again = gather_conv(x, tab, w, b)
    torch.cuda.synchronize()
    assert gather_conv.launches_by_route["bf16"] == before["bf16"] + 2
    assert got.dtype == torch.float32
    want = gather_conv_plain(x, tab, w, b)
    tol = 1e-5 * max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= tol
    assert torch.equal(got, again)
    empty = torch.full_like(tab, V)
    assert torch.equal(gather_conv(x, empty, w, b), b.expand(N, cout))


@pytest.mark.cuda
@pytest.mark.parametrize("change", [
    dict(compute_dtype="bfloat16", middle_sparse_dtype="bfloat16"),
    dict(middle_gather_algo="window_bf16"),
    dict(middle_sparse_dtype="bf16_packed"),
    dict(middle_dense_from_stage=2, middle_dense_dtype="bfloat16")])
def test_voxelnet_serving_knobs_card_against_the_cpu(change):
    """A small VoxelNet (middle channels 8/16/64/64) under each serving
    knob on the card and on the CPU from the same weights: K2 20 launches
    less the dense stages', on the bf16 route where the knob rounds x and W,
    and every head map within the bf16 tolerance of the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import dataclasses
    from futuredet_torch import config
    from futuredet_torch.models.detector import build_detector
    from futuredet_torch.ops.pallas_gather import gather_conv
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = config.tiny_variant(config.get_config("forecast_n3dtf"))
    voxel = dataclasses.replace(
        cfg.voxel, pc_range=(-16.0, -16.0, -3.0, 16.0, 16.0, 3.0),
        voxel_size=(0.5, 0.5, 0.15), max_voxels_eval=2048, max_points=2048)
    cfg = cfg.replace(voxel=voxel, model=dataclasses.replace(
        cfg.model, middle_channels=(8, 16, 64, 64), **change))
    rng = np.random.default_rng(4)
    P = voxel.max_points
    pts = np.concatenate([rng.uniform(-16, 16, (1, P, 2)),
                          rng.uniform(-3, 3, (1, P, 1)),
                          rng.uniform(0, 1, (1, P, 2))], -1).astype(
                              np.float32)
    valid = rng.random((1, P)) < 0.95
    out = {}
    for dev in ("cpu", "cuda"):
        model = build_detector(cfg, device=dev, seed=0)
        before = dict(gather_conv.launches_by_route)
        with torch.no_grad():
            out[dev] = model(torch.from_numpy(pts).to(dev),
                             torch.from_numpy(valid).to(dev))
        torch.cuda.synchronize()
        launched = {k: gather_conv.launches_by_route[k] - before[k]
                    for k in before}
    bf16 = "compute_dtype" in change or "window_bf16" in str(change)
    dense = "middle_dense_from_stage" in change
    assert sum(launched.values()) == (10 if dense else 20), launched
    assert (launched["bf16"] == 20) == bf16, launched
    for g, c in zip(out["cuda"], out["cpu"]):
        for k in c:
            ref = c[k].float()
            tol = 0.05 * max(1.0, float(ref.abs().max()))
            assert float((g[k].float().cpu() - ref).abs().max()) <= tol, k
