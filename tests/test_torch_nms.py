"""futuredet_torch rotated IoU and NMS vs the JAX package: the XLA
`rotate_nms`, the Pallas kernel K1 in interpret mode, and the numpy oracles.
Index results must be identical."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from futuredet_tpu.ops import nms as JN
from futuredet_tpu.ops.pallas_nms import rotate_nms_pallas
from futuredet_tpu.ops.rotated_iou import pairwise_iou_bev as jax_iou
from futuredet_torch.ops import nms as TN
from futuredet_torch.ops.pallas_nms import rotate_nms_alive
from futuredet_torch.ops.rotated_iou import pairwise_iou_bev

# same formula, fp32: cos/sin and the corner sums round differently
IOU_ATOL = 1e-5


def rand_boxes7(n, seed=0, span=12.0):
    rng = np.random.default_rng(seed)
    b = np.zeros((n, 7), np.float32)
    b[:, 0] = rng.uniform(-span, span, n)
    b[:, 1] = rng.uniform(-span, span, n)
    b[:, 3] = rng.uniform(1.0, 3.0, n)   # w
    b[:, 4] = rng.uniform(1.0, 6.0, n)   # l
    b[:, 5] = rng.uniform(1.0, 2.0, n)
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    return b


def rand_boxes5(n, seed=0, span=6.0):
    rng = np.random.default_rng(seed)
    return np.stack([
        rng.uniform(-span, span, n), rng.uniform(-span, span, n),
        rng.uniform(1.0, 6.0, n), rng.uniform(1.0, 3.0, n),
        rng.uniform(-np.pi, np.pi, n)], -1).astype(np.float32)


def chain_boxes(n):
    """A row of 2 m boxes 1.2 m apart, scores decreasing: each overlaps only
    its neighbours, greedy keeps every other one, and the suppression chain
    is as deep as the row (tests/test_nms.py)."""
    boxes = np.zeros((n, 7), np.float32)
    boxes[:, 0] = np.arange(n) * 1.2
    boxes[:, 3] = 2.0
    boxes[:, 4] = 2.0
    boxes[:, 5] = 1.5
    return boxes, np.linspace(1.0, 0.1, n).astype(np.float32)


def port_nms(boxes, scores, valid=None, **kw):
    valid = np.ones(len(scores), bool) if valid is None else valid
    sel, cnt = TN.rotate_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                             torch.from_numpy(valid), **kw)
    return sel.numpy(), int(cnt)


def jax_nms(boxes, scores, valid=None, **kw):
    valid = np.ones(len(scores), bool) if valid is None else valid
    sel, cnt = JN.rotate_nms(jnp.asarray(boxes), jnp.asarray(scores),
                             jnp.asarray(valid), **kw)
    return np.asarray(sel), int(cnt)


def test_pairwise_iou_matches_jax():
    a = rand_boxes5(24, 0)
    b = rand_boxes5(16, 1)
    # axis-aligned boxes sharing edges, and a box with itself
    b[:4] = [[0, 0, 2, 2, 0], [2, 0, 2, 2, 0], [1, 0, 2, 2, 0],
             [0, 0, 4, 2, 0.3]]
    a[:2] = [[0, 0, 2, 2, 0], [0, 0, 4, 2, 0.3]]
    want = np.asarray(jax_iou(jnp.asarray(a), jnp.asarray(b)))
    got = pairwise_iou_bev(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, atol=IOU_ATOL, rtol=0)
    assert abs(got[0, 2] - 2.0 / 6.0) < 1e-5 and abs(got[1, 3] - 1) < 1e-5
    # leading batch dimensions broadcast
    got2 = pairwise_iou_bev(torch.from_numpy(np.stack([a, a])),
                            torch.from_numpy(np.stack([b[:16], b[:16]])))
    np.testing.assert_array_equal(got2[1].numpy(), got)


@pytest.mark.parametrize("n,seed,span", [(60, 4, 10.0), (150, 5, 12.0)])
def test_rotate_nms_matches_numpy_oracles(n, seed, span):
    boxes = rand_boxes7(n, seed, span)
    scores = np.random.default_rng(seed + 1).uniform(0, 1, n).astype(
        np.float32)
    kw = dict(iou_threshold=0.2, pre_max=n, post_max=n)
    sel, cnt = port_nms(boxes, scores, **kw)
    got = sel[:cnt]
    assert np.all(sel[cnt:] == -1)
    b64 = boxes.astype(np.float64)
    np.testing.assert_array_equal(
        got, TN.rotate_nms_np(b64, scores, 0.2, pre_max=n, post_max=n))
    np.testing.assert_array_equal(
        got, JN.rotate_nms_np(b64, scores, 0.2, pre_max=n, post_max=n))
    np.testing.assert_array_equal(sel, jax_nms(boxes, scores, **kw)[0])


@pytest.mark.parametrize("n", [400, 1000])
def test_rotate_nms_matches_xla_with_valid_mask(n):
    boxes = rand_boxes7(n, n, span=3.0 * np.sqrt(n))
    rng = np.random.default_rng(n + 1)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    valid = rng.random(n) < 0.85
    kw = dict(iou_threshold=0.2, pre_max=1000, post_max=83)
    sel, cnt = port_nms(boxes, scores, valid, **kw)
    want, wcnt = jax_nms(boxes, scores, valid, **kw)
    assert cnt == wcnt
    np.testing.assert_array_equal(sel, want)


def test_rotate_nms_batched_problems_match_one_by_one():
    """G problems in one call (one K1 launch on the card) give each
    problem's own answer."""
    G, n = 3, 200
    boxes = np.stack([rand_boxes7(n, 20 + g, 15.0) for g in range(G)])
    rng = np.random.default_rng(9)
    scores = rng.uniform(0, 1, (G, n)).astype(np.float32)
    valid = rng.random((G, n)) < 0.9
    sel, cnt = TN.rotate_nms(torch.from_numpy(boxes),
                             torch.from_numpy(scores),
                             torch.from_numpy(valid), iou_threshold=0.3,
                             pre_max=128, post_max=50)
    assert sel.shape == (G, 50) and cnt.shape == (G,)
    for g in range(G):
        want, wcnt = jax_nms(boxes[g], scores[g], valid[g],
                             iou_threshold=0.3, pre_max=128, post_max=50)
        assert int(cnt[g]) == wcnt
        np.testing.assert_array_equal(sel[g].numpy(), want)


@pytest.mark.parametrize("n", [64, 1000])
def test_rotate_nms_long_suppression_chain(n):
    boxes, scores = chain_boxes(n)
    kw = dict(iou_threshold=0.1, pre_max=n, post_max=n)
    sel, cnt = port_nms(boxes, scores, **kw)
    assert cnt == n // 2
    np.testing.assert_array_equal(sel, jax_nms(boxes, scores, **kw)[0])
    if n <= 64:
        np.testing.assert_array_equal(
            sel[:cnt], TN.rotate_nms_np(boxes, scores, 0.1, pre_max=n,
                                        post_max=n))


def test_rotate_nms_matches_pallas_kernel_interpret():
    """K1 itself (interpret mode), at n=60, on random boxes plus axis-
    aligned boxes with collinear edges, where K1's clip roles decide."""
    n = 60
    boxes = rand_boxes7(n, 1)
    boxes[:12, 6] = 0.0
    boxes[:12, 3:5] = 2.0
    boxes[:12, 0] = np.repeat(np.arange(6) * 2.0, 2)
    boxes[:12, 1] = np.tile([0.0, 1.0], 6)
    scores = np.random.default_rng(2).uniform(0, 1, n).astype(np.float32)
    sel_p, cnt_p = rotate_nms_pallas(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.ones(n, bool),
        iou_threshold=0.2, pre_max=64, post_max=83, interpret=True)
    sel, cnt = port_nms(boxes, scores, iou_threshold=0.2, pre_max=64,
                        post_max=83)
    assert cnt == int(cnt_p)
    np.testing.assert_array_equal(sel, np.asarray(sel_p))


def test_top_k_ties_follow_lax_top_k():
    rng = np.random.default_rng(0)
    scores = rng.choice(np.float32([0.1006, 0.3, 0.7]), 300)
    want_s, want_i = jax.lax.top_k(jnp.asarray(scores), 100)
    got_s, got_i = TN.top_k_stable(torch.from_numpy(scores), 100)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


def test_rotate_nms_equal_scores_match_xla():
    """Untrained heads give equal scores in empty regions: overlapping
    boxes with one score must keep the lower index, as lax.top_k orders."""
    n = 120
    boxes = rand_boxes7(n, 7, span=6.0)
    scores = np.full(n, 0.1006, np.float32)
    scores[::7] = 0.5
    kw = dict(iou_threshold=0.2, pre_max=100, post_max=83)
    sel, cnt = port_nms(boxes, scores, **kw)
    want, wcnt = jax_nms(boxes, scores, **kw)
    assert cnt == wcnt
    np.testing.assert_array_equal(sel, want)


def test_circle_nms_matches_jax():
    rng = np.random.default_rng(4)
    n = 200
    centers = rng.uniform(-10, 10, (n, 2)).astype(np.float32)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    valid = rng.random(n) < 0.8
    sel, cnt = TN.circle_nms(torch.from_numpy(centers),
                             torch.from_numpy(scores),
                             torch.from_numpy(valid), min_radius=1.0,
                             post_max=83)
    want, wcnt = JN.circle_nms(jnp.asarray(centers), jnp.asarray(scores),
                               jnp.asarray(valid), min_radius=1.0,
                               post_max=83)
    assert int(cnt) == int(wcnt)
    np.testing.assert_array_equal(sel.numpy(), np.asarray(want))


def test_wrapper_checks_inputs_and_counts_no_cpu_launch():
    b = torch.zeros(2, 10, 5)
    v = torch.ones(2, 10, dtype=torch.bool)
    before = rotate_nms_alive.launches
    assert rotate_nms_alive(b, v, 0.2).shape == (2, 10)
    assert rotate_nms_alive.launches == before
    with pytest.raises(TypeError):
        rotate_nms_alive(b.double(), v, 0.2)
    with pytest.raises(ValueError):
        rotate_nms_alive(b[..., :4], v, 0.2)
    with pytest.raises(ValueError):
        rotate_nms_alive(b, v[:, :5], 0.2)
