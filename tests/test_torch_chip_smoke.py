"""chip_smoke.py's checks and bounds, on the CPU with synthetic inputs: the
card-against-CPU detection matcher at near ties, K1's pair counts and
bound, and K2's two bounds."""
import os
import sys
import types

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from futuredet_torch.config import get_config  # noqa: E402

CFG = get_config("forecast_n3dtf")
POST = CFG.test.nms.post_max_size
T = 7


def dets(boxes, scores, labels, valid=None):
    if valid is None:
        valid = np.ones(len(scores), bool)
    return types.SimpleNamespace(
        boxes=torch.from_numpy(boxes)[None],
        scores=torch.from_numpy(scores)[None],
        labels=torch.from_numpy(labels)[None],
        valid=torch.from_numpy(valid)[None])


def reference(seed=0):
    """T timesteps of POST boxes each, scores packed just above the 0.1
    threshold as an untrained head gives them, descending per timestep."""
    rng = np.random.default_rng(seed)
    boxes = rng.uniform(-50, 50, (T * POST, 9)).astype(np.float32)
    boxes[:, 2:6] = 1.0
    scores = np.sort(rng.uniform(0.1, 0.1007, (T, POST)), -1)[:, ::-1]
    labels = rng.integers(0, 6, T * POST)
    return boxes, scores.reshape(-1).astype(np.float32), labels


def test_identical_detections_match_with_none_let_off():
    b, s, lab = reference()
    n_card, n_cpu, let_off = cs.check_detections_match(
        CFG, dets(b, s, lab), dets(b, s, lab), 1e-7)
    assert (n_card, n_cpu, let_off) == (T * POST, T * POST, [])


def test_a_near_tie_at_the_rank_cut_is_let_off():
    """The card keeps another box in last place of a full timestep, with a
    score within the heatmap difference of the reference's last box."""
    b, s, lab = reference()
    b2, s2 = b.copy(), s.copy()
    last = POST - 1
    b2[last, :2] += 30.0
    s2[last] = s[last] + 1e-8
    let_off = cs.check_detections_match(CFG, dets(b2, s2, lab),
                                        dets(b, s, lab), 1e-7)[2]
    assert len(let_off) == 1 and let_off[0]["label"] == lab[last]


def test_a_box_missing_above_the_cut_fails():
    b, s, lab = reference()
    b2 = b.copy()
    b2[POST + 10, :2] += 30.0      # timestep 1, rank 10
    with pytest.raises(RuntimeError, match="no match"):
        cs.check_detections_match(CFG, dets(b2, s, lab), dets(b, s, lab),
                                  1e-7)


def test_a_box_at_the_threshold_may_cross_it():
    """A timestep that keeps fewer than POST boxes: its cut is the score
    threshold, and a reference box within the difference of it may be
    missing on the card; one clearly above it may not."""
    b, s, lab = reference()
    valid = np.ones(T * POST, bool)
    valid[POST - 20:POST] = False            # timestep 0 keeps 63
    s2 = s.copy()
    s2[POST - 21] = CFG.test.score_threshold + 1e-8
    cpu = dets(b, s2, lab, valid)
    card_valid = valid.copy()
    card_valid[POST - 21] = False
    let_off = cs.check_detections_match(CFG, dets(b, s2, lab, card_valid),
                                        cpu, 1e-7)[2]
    assert len(let_off) == 1
    card_valid = valid.copy()
    card_valid[5] = False
    with pytest.raises(RuntimeError, match="no match"):
        cs.check_detections_match(CFG, dets(b, s2, lab, card_valid), cpu,
                                  1e-7)


def test_the_let_off_is_capped_whatever_the_heatmap_difference():
    """A heatmap difference near the 1e-3 limit must not excuse a reference
    box 1e-5 above the card's cut: the let-off reaches at most 1e-6."""
    b, s, lab = reference()
    b2, s2 = b.copy(), s.copy()
    last = POST - 1
    b2[last, :2] += 30.0
    s2[last] = s[last] - 1e-5
    with pytest.raises(RuntimeError, match="no match"):
        cs.check_detections_match(CFG, dets(b2, s2, lab), dets(b, s, lab),
                                  9e-4)


@pytest.mark.parametrize("moved,fails", [(2, False), (3, True)])
def test_more_than_two_let_offs_a_scene_fail(moved, fails):
    """Near ties at the cut of `moved` timesteps: two are let off, a third
    means the scores moved, not a tie."""
    b, s, lab = reference()
    b2, s2 = b.copy(), s.copy()
    for t in range(moved):
        last = (t + 1) * POST - 1
        b2[last, :2] += 30.0
        s2[last] = s[last] + 1e-8
    if fails:
        with pytest.raises(RuntimeError, match="let off at the cut"):
            cs.check_detections_match(CFG, dets(b2, s2, lab),
                                      dets(b, s, lab), 1e-7)
    else:
        assert len(cs.check_detections_match(
            CFG, dets(b2, s2, lab), dets(b, s, lab), 1e-7)[2]) == moved


@pytest.mark.parametrize("cin,cout,route", [(5, 16, "narrow"),
                                            (128, 128, "wide")])
def test_k2_bounds(cin, cout, route):
    """bytes once at 3.35 TB/s; 2 * present pairs * Cin * Cout at 67
    TFLOP/s (bound_ms) and, for the wide family, at 495 / 3 TFLOP/s."""
    V, N = 40, 30
    table = torch.full((27, N), V, dtype=torch.int32)
    table[0] = torch.arange(N)
    table[26, :7] = 3
    got = cs.k2_bound(torch.zeros(V, cin), table, torch.zeros(27, cin, cout),
                      torch.zeros(cout))
    present = N + 7
    nbytes = 4 * (V * cin + 27 * N + 27 * cin * cout + cout + N * cout)
    ops = 2 * present * cin * cout
    assert got["route"] == route and got["present_pairs"] == present
    assert got["bound_ms"] == pytest.approx(
        max(nbytes / 3.35e12, ops / 67e12) * 1e3)
    if route == "wide":
        assert got["tc_bound_ms"] == pytest.approx(
            max(nbytes / 3.35e12, ops / (495e12 / 3)) * 1e3)
        assert got["tc_bound_ms"] <= got["bound_ms"]
    else:
        assert got["tc_bound_ms"] is None


def test_k1_pairs_and_bound():
    """A suppression chain of 5 boxes (2 m, 1.2 m apart, threshold 0.1):
    0 kills 1, 2 kills 3, 0, 2 and 4 survive. Needed tests: 0 against 1-4,
    2 against 3 and 4; of these the cull skips (0, 3) and (0, 4), whose
    circles lie apart. The bound counts the others at the full test."""
    b = torch.zeros(1, 5, 5)
    b[0, :, 0] = torch.arange(5) * 1.2
    b[0, :, 2:4] = 2.0
    valid = torch.ones(1, 5, dtype=torch.bool)
    got = cs.k1_bound(b, valid, 0.1)
    assert (got["pairs_needed"], got["pairs_full"], got["pairs_culled"],
            got["pairs_all"]) == (6, 4, 2, 10)
    ops = 4 * cs.K1_OPS_PER_PAIR + 2 * cs.K1_OPS_PER_CULL
    nbytes = 5 * 5 * 4 + 2 * 5
    assert got["bytes"] == nbytes
    assert got["bound_ms"] == pytest.approx(
        max(nbytes / 3.35e12, ops / 67e12) * 1e3)
    # an invalid victim needs no test (0 and 2 against 4 go); below a zero
    # threshold none is culled
    valid[0, 4] = False
    assert cs.k1_pairs(b, valid, 0.1)["needed"] == 4
    neg = cs.k1_pairs(b, torch.ones(1, 5, dtype=torch.bool), -1.0)
    assert (neg["needed"], neg["culled"]) == (4, 0)


def test_k1_case_inputs():
    """The dense cluster leaves the cull no pair; the margin pairs straddle
    its edge, each skipped one with plain IoU exactly 0."""
    from futuredet_torch.ops.pallas_nms import cull_skips
    from futuredet_torch.ops.rotated_iou import pairwise_iou_bev
    rng = np.random.default_rng(0)
    dense = torch.from_numpy(cs.k1_dense_cluster(2, 300, rng))
    assert not bool(cull_skips(dense, 0.2).any())
    m = torch.from_numpy(cs.k1_margin_pairs(101, rng))
    skip = cull_skips(m, 0.2)
    pair = skip[torch.arange(0, 100, 2), torch.arange(1, 101, 2)]
    assert 0 < int(pair.sum()) < 50
    assert not bool((skip & (pairwise_iou_bev(m, m).T != 0)).any())
