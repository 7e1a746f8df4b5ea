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
