"""CUDA kernels of futuredet_torch against their plain PyTorch versions, on
the card. Skipped without one; imports nothing of JAX, so it also runs where
only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from futuredet_torch.ops.pallas_nms import nms_alive_plain, rotate_nms_alive


def rand_nms_boxes(G, n, rng, span=40.0):
    """(G, n, 5) pcdet-frame boxes [x, y, dx, dy, ang]."""
    return np.stack([
        rng.uniform(-span, span, (G, n)), rng.uniform(-span, span, (G, n)),
        rng.uniform(1.0, 6.0, (G, n)), rng.uniform(1.0, 3.0, (G, n)),
        rng.uniform(-np.pi, np.pi, (G, n))], -1).astype(np.float32)


@pytest.mark.cuda
def test_k1_matches_plain_version_on_the_card():
    """The 7 x 1000 main-path shape with a 1000-deep suppression chain in
    problem 0 and axis-aligned boxes with collinear edges in problem 1."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    G, n = 7, 1000
    rng = np.random.default_rng(0)
    nb = rand_nms_boxes(G, n, rng)
    nb[0] = 0.0
    nb[0, :, 0] = np.arange(n) * 1.2          # each overlaps its neighbours
    nb[0, :, 2:4] = 2.0
    nb[1, :100] = 0.0
    nb[1, :100, 0] = np.repeat(np.arange(50) * 2.0, 2)   # shared edges
    nb[1, :100, 1] = np.tile([0.0, 1.0], 50)
    nb[1, :100, 2:4] = 2.0
    boxes = torch.from_numpy(nb).cuda()
    valid = torch.from_numpy(rng.random((G, n)) < 0.95).cuda()
    valid[0] = True
    before = rotate_nms_alive.launches
    got = rotate_nms_alive(boxes, valid, 0.1)
    torch.cuda.synchronize()
    assert rotate_nms_alive.launches == before + 1
    assert torch.equal(got, nms_alive_plain(boxes, valid, 0.1))
    assert int(got[0].sum()) == n // 2
    assert not bool(got[~valid].any())


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


@pytest.mark.cuda
@pytest.mark.parametrize("V,N,cin,cout", [
    (5000, 5000, 5, 16), (4000, 4000, 16, 16), (3000, 1111, 16, 32),
    (2000, 65, 64, 64), (1000, 1, 128, 128), (700, 700, 32, 8)])
def test_k2_matches_plain_version_on_the_card(V, N, cin, cout):
    """The gather-conv kernel against its plain version, within fp32
    summation order (1e-5 of the largest output), and bit-identical when
    launched again."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from futuredet_torch.ops.pallas_gather import (gather_conv,
                                                   gather_conv_plain)
    torch.backends.cuda.matmul.allow_tf32 = False
    x, tab, w, b = k2_case(np.random.default_rng(V + N), V, N, cin, cout)
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
