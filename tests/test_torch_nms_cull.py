"""K1's cull of far pairs, on the CPU: the kernel (csrc/nms_kernel.cu) skips
the full IoU test of a pair whose centres lie farther apart than the sum of
the two boxes' reaches. `pallas_nms.cull_skips` is the same predicate with
the kernel's constants; every pair it skips must have plain IoU exactly 0,
NaN and inf boxes must never be skipped, nor any pair below a threshold of
0. The CUDA kernel itself is held to the plain version in
tests/test_torch_cuda.py."""
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from futuredet_torch.config import get_config
from futuredet_torch.ops import pallas_nms
from futuredet_torch.ops.pallas_nms import cull_reach, cull_skips
from futuredet_torch.ops.rotated_iou import _CLIP_EPS, pairwise_iou_bev

LIMIT = get_config("pp_forecast_n3dtf").test.post_center_limit_range[3]
CU = Path(pallas_nms.__file__).resolve().parents[1] / "csrc" / "nms_kernel.cu"


def k1_iou(boxes):
    """(..., N, 5) -> (..., N, N) IoU_K1 [killer, victim]."""
    return pairwise_iou_bev(boxes, boxes).transpose(-1, -2)


def assert_skips_exact(boxes, thr=0.2):
    """Every pair the predicate skips has plain IoU exactly 0; returns the
    skip matrix."""
    skip = cull_skips(boxes, thr)
    iou = k1_iou(boxes)
    bad = skip & (iou != 0)
    assert not bool(bad.any()), iou[bad][:5]
    return skip


def corner_to_corner(k, v, gap_ulps=0, centre=(0.0, 0.0), heading=0.0):
    """Killer k = (dx, dy) and victim v = (dx, dy), each turned so that one
    corner points at the other box along `heading`: their circumcircles, and
    corners, meet on the line of centres. The victim sits at the least fp32
    distance the predicate skips, moved by `gap_ulps` ulps of its x."""
    kdx, kdy = k
    vdx, vdy = v
    ux, uy = math.cos(heading), math.sin(heading)
    ka = heading - math.atan2(kdy, kdx)
    va = heading + math.pi - math.atan2(vdy, vdx)
    b = torch.tensor([[centre[0], centre[1], kdx, kdy, ka],
                      [0.0, 0.0, vdx, vdy, va]], dtype=torch.float32)
    reach = cull_reach(b)
    d = float(reach[0] + reach[1])
    b[1, 0] = centre[0] + d * ux
    b[1, 1] = centre[1] + d * uy
    # walk x to the first value the predicate skips, then by gap_ulps
    step = 1 if ux >= 0 else -1
    while bool(cull_skips(b, 0.2)[0, 1]):
        b[1, 0] = float(np.nextafter(np.float32(b[1, 0]),
                                     np.float32(-step * np.inf)))
    while not bool(cull_skips(b, 0.2)[0, 1]):
        b[1, 0] = float(np.nextafter(np.float32(b[1, 0]),
                                     np.float32(step * np.inf)))
    x = np.float32(b[1, 0])
    for _ in range(abs(gap_ulps)):
        x = np.nextafter(x, np.float32(np.sign(gap_ulps) * step * np.inf))
    b[1, 0] = float(x)
    return b


def test_kernel_constants_match_the_python_copy():
    src = CU.read_text()

    def const(name):
        m = re.search(rf"constexpr \w+ {name} = ([0-9.e+-]+)f?;", src)
        assert m, name
        return float(m.group(1))

    assert const("kClipEps") == _CLIP_EPS
    assert const("kCullRel") == pallas_nms._CULL_REL
    assert const("kCullAbs") == pallas_nms._CULL_ABS
    assert const("kMaxColBlocks") * const("kBlock") == pallas_nms.MAX_BOXES


L32 = float(np.float32(LIMIT))
box = st.tuples(
    st.floats(-L32, L32, width=32), st.floats(-L32, L32, width=32),
    st.floats(0.0, 60.0, width=32), st.floats(0.0, 60.0, width=32),
    st.floats(-6.25, 6.25, width=32))


@settings(max_examples=300, deadline=None)
@given(k=box, v=box, scale=st.sampled_from([1.0, 1e-3, 1e3]),
       near=st.floats(0.0, 1.0))
def test_a_skipped_pair_has_iou_exactly_zero(k, v, scale, near):
    """Any two boxes (sizes up to 60 m, or scaled by 1e-3 or 1e3, as exp of
    a head output may give), the victim also pulled towards the killer until
    the two circles nearly touch: a skipped pair has plain IoU exactly 0."""
    b = torch.tensor([k, v], dtype=torch.float32)
    b[:, 2:4] *= scale
    assert_skips_exact(b)
    # slide the victim along the line of centres to `near` of the way
    # between where the circles touch and where the predicate starts to skip
    reach = cull_reach(b)
    d = b[1, :2] - b[0, :2]
    n = float(torch.linalg.norm(d))
    if n > 0:
        r = float(reach[0] + reach[1])
        touch = r - 2 * pallas_nms._CULL_ABS
        b[1, :2] = b[0, :2] + d / n * (touch + near * (r - touch) * 1.01)
        assert_skips_exact(b)


@pytest.mark.parametrize("case", [
    "tangent_plus_1ulp", "tangent_at_the_edge", "tangent_minus_1ulp",
    "corners_45_degrees", "edge_of_limit_range", "zero_size"])
def test_cull_edge_cases(case):
    """Pairs at the cull's boundary. Where the predicate skips, the plain
    IoU is exactly 0; one ulp nearer than its edge it does not skip."""
    if case.startswith("tangent"):
        gap = {"tangent_plus_1ulp": 1, "tangent_at_the_edge": 0,
               "tangent_minus_1ulp": -1}[case]
        b = corner_to_corner((4.6, 1.9), (0.5, 4.1), gap_ulps=gap,
                             centre=(3.7, -12.25), heading=0.3)
        assert bool(cull_skips(b, 0.2)[0, 1]) == (gap >= 0)
    elif case == "corners_45_degrees":
        # an axis-aligned killer and a victim turned by 45 degrees whose
        # corner points at the killer's right edge, at the skip edge: their
        # true gap is the whole margin beyond the circles
        b = torch.tensor([[10.0, 5.0, 4.0, 2.0, 0.0],
                          [0.0, 5.0, 2.0, 2.0, math.pi / 4]])
        for _ in range(3):      # the reach grows with |x|: settle
            reach = cull_reach(b)
            b[1, 0] = 10.0 + float(reach[0] + reach[1]) * 1.000001
        assert bool(cull_skips(b, 0.2)[0, 1])
        # and at the true touch of the two boxes: no skip, IoU 0 or not
        b[1, 0] = 10.0 + 2.0 + math.sqrt(2.0)
        assert not bool(cull_skips(b, 0.2)[0, 1])
    elif case == "edge_of_limit_range":
        b = corner_to_corner((5.0, 2.0), (4.5, 1.9), gap_ulps=0,
                             centre=(LIMIT - 3.0, -LIMIT + 0.5),
                             heading=math.pi * 0.75)
        assert bool(cull_skips(b, 0.2)[0, 1])
        b2 = corner_to_corner((3.0, 3.0), (2.0, 1.0), centre=(LIMIT, LIMIT),
                              heading=-math.pi / 2)
        assert bool(cull_skips(b2, 0.2)[0, 1])
        assert_skips_exact(b2)
    else:
        b = torch.tensor([[1.0, 2.0, 0.0, 0.0, 0.3],
                          [1.0, 2.001, 0.0, 0.0, 1.0],
                          [1.0, 2.0, 0.0, 0.0, 0.0]])
        skip = cull_skips(b, 0.2)
        assert bool(skip[0, 1]) and not bool(skip[0, 2])
    assert_skips_exact(b)
    # the pair is symmetric: victim and killer swapped skip alike
    skip = cull_skips(b, 0.2)
    assert torch.equal(skip, skip.T)


@pytest.mark.parametrize("field,value", [
    (2, float("nan")), (3, float("inf")), (2, float("-inf")),
    (0, float("nan")), (1, float("inf")), (4, float("nan")),
    (4, float("inf"))])
def test_non_finite_boxes_are_never_skipped(field, value):
    """A NaN or inf field (exp overflow of a random head) gives the box an
    infinite reach: its pairs take the full test, whose answer (NaN IoU
    kills nothing at a threshold >= 0) the kernel then gives as the plain
    version does."""
    b = torch.tensor([[0.0, 0.0, 2.0, 1.0, 0.1],
                      [50.0, -40.0, 3.0, 1.5, 0.2],
                      [-50.0, 40.0, 3.0, 1.5, 0.2]])
    b[1, field] = value
    skip = cull_skips(b, 0.2)
    assert math.isinf(float(cull_reach(b)[1]))
    assert not bool(skip[1].any()) and not bool(skip[:, 1].any())
    assert bool(skip[0, 2]) and bool(skip[2, 0])


@pytest.mark.parametrize("thr", [-1.0, -1e-9])
def test_nothing_is_skipped_below_a_zero_threshold(thr):
    """Below 0, an IoU of 0 kills: every pair needs the full test."""
    rng = np.random.default_rng(3)
    b = torch.from_numpy(np.stack([
        rng.uniform(-LIMIT, LIMIT, 50), rng.uniform(-LIMIT, LIMIT, 50),
        rng.uniform(1, 5, 50), rng.uniform(1, 3, 50),
        rng.uniform(-np.pi, np.pi, 50)], -1).astype(np.float32))
    assert not bool(cull_skips(b, thr).any())
    assert bool(cull_skips(b, 0.0).any())


def test_the_cull_skips_most_pairs_of_a_spread_scene_exactly():
    """1000 car-sized boxes over the whole range, as the untrained heads
    give them, and 300 in a cluster: the predicate skips ~99% of the
    spread pairs and each skipped pair's IoU is exactly 0."""
    rng = np.random.default_rng(0)

    def scene(n, span, lo, hi):
        return torch.from_numpy(np.stack([
            rng.uniform(-span, span, n), rng.uniform(-span, span, n),
            rng.uniform(lo, hi, n), rng.uniform(lo, hi, n),
            rng.uniform(-np.pi, np.pi, n)], -1).astype(np.float32))

    spread = assert_skips_exact(scene(1000, LIMIT, 1.0, 6.0))
    assert float(spread.float().mean()) > 0.98
    cluster = assert_skips_exact(scene(300, 7.5, 1.5, 5.0))
    assert 0.1 < float(cluster.float().mean()) < 0.9


def test_wrapper_refuses_more_boxes_than_the_kernel_takes():
    """N <= MAX_BOXES (8192) on either device, checked before anything is
    built or launched; the CPU path counts no launch."""
    from futuredet_torch.ops.pallas_nms import (MAX_BOXES, launch_with_mask,
                                                rotate_nms_alive)
    before = rotate_nms_alive.launches
    b = torch.zeros(1, MAX_BOXES + 1, 5)
    v = torch.ones(1, MAX_BOXES + 1, dtype=torch.bool)
    with pytest.raises(ValueError, match="N <= 8192"):
        rotate_nms_alive(b, v, 0.2)
    with pytest.raises(ValueError, match="N <= 8192"):
        launch_with_mask(b, v, 0.2)
    got = rotate_nms_alive(b[:, :65], v[:, :65], 0.2)
    assert got.dtype == torch.bool and got.shape == (1, 65)
    assert rotate_nms_alive.launches == before
