"""Each metric's arithmetic against a hand count, on a tiny conv, a tiny
NMS problem and a made-up run record."""
from __future__ import annotations

import math

import pytest
import torch
from torch import nn

from conftest import ROOT  # noqa: F401  (puts the repo on sys.path)

PEAKS = {"matmul_flops_per_s": 1e12, "scalar_flops_per_s": 1e11,
         "bytes_per_s": 1e9}


def test_k2_bound_counts_present_pairs_and_bytes_once():
    from benchmark import bounds
    # 3 input sites, 2 output sites; 4 of the 54 (tap, site) pairs present
    table = torch.full((27, 2), 3, dtype=torch.int64)
    table[13, 0], table[13, 1], table[0, 0], table[5, 1] = 0, 1, 2, 0
    conv = {"n_out": 2, "n_in": 3, "cin": 4, "cout": 8,
            "pairs": int((table < 3).sum())}
    assert conv["pairs"] == 4
    ops = 2 * 4 * 4 * 8
    nbytes = 4 * (3 * 4 + 27 * 4 * 8 + 27 * 2 + 2 * 8)
    assert bounds.k2_bound_s(conv, PEAKS) == max(ops / 1e12, nbytes / 1e9)
    back = 4 * (2 * 8 + 27 * 4 * 8 + 27 * 3 + 3 * 4)
    assert bounds.k2_bound_s(conv, PEAKS, backward=True) == \
        max(ops / 1e12, back / 1e9)


def test_k1_bound_counts_the_pairs_greedy_nms_needs():
    from benchmark import bounds
    # score order: 0 kills 1 (same box), 2 lies far away; needed tests:
    # 0 against 1 and 2 (full: 0-1 overlap; cull: 0-2 far), 2 alone after
    boxes = torch.tensor([[[0.0, 0.0, 2.0, 1.0, 0.0],
                           [0.1, 0.0, 2.0, 1.0, 0.0],
                           [30.0, 0.0, 2.0, 1.0, 0.0]]])
    valid = torch.ones(1, 3, dtype=torch.bool)
    peaks = dict(PEAKS, bytes_per_s=1e30)
    want = (1 * bounds.K1_OPS_PER_PAIR + 1 * bounds.K1_OPS_PER_CULL) / 1e11
    assert bounds.k1_bound_s(boxes, valid, 0.2, peaks) == pytest.approx(want)


def test_dense_flops_of_a_tiny_net():
    from benchmark import bounds

    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            self.conv = nn.Conv2d(2, 3, 3, padding=1)
            self.up = nn.ConvTranspose2d(3, 4, 2, stride=2)
            self.fc = nn.Linear(4, 6)

        def forward(self, pts, valid):
            x = self.up(self.conv(pts.view(1, 2, 4, 4)))
            return self.fc(x.view(-1, 4)[:3])

    n = Net()
    x = torch.zeros(1, 32)
    conv = 2 * (3 * 4 * 4) * (2 * 3 * 3)
    up = 2 * (4 * 4) * (3 * 4 * 2 * 2)
    fc = 2 * (3 * 6) * 4
    assert bounds.dense_flops(n, x[0], x[0] > 0) == conv + up + fc


def _record(loop):
    return {"loop": loop, "setup_s": 3.0, "window_s": 2.0, "units": 4,
            "first_unit": 1, "latencies_s": [0.1, 0.2, 0.3, 0.4, 1.0],
            "peaks": {"matmul_flops_per_s": 1e12},
            "memory_peak_bytes": 3 * 2 ** 20,
            "stages_ms": {"backbone": [1.0, 5.0, 2.0], "forward": [4.0]},
            "trace": {"busy_s": 0.2, "window_s": 1.0, "units": 2,
                      "by_op": {"void (anonymous namespace)::wide_kernel<64,"
                                " 128>(float const*)": 0.002,
                                "narrow_kernel(float const*)": 0.002,
                                "nms_pair_kernel(x)": 0.003,
                                "nms_walk_kernel(y)": 0.001,
                                "at::native::index_select": 0.5}},
            "flops_per_pool_scene": [1e9, 2e9, 3e9],
            "k2_bound_s": 0.001, "k1_bound_s": 0.0004}


def test_readers_against_hand_counts():
    from benchmark import harness
    s, t = _record("stream"), _record("train")
    r = harness.reader
    assert r("setup_s")(s) == 3.0
    assert r("scene_ms")(s) == 500.0 and r("scene_ms")(t) is None
    assert r("train_step_ms")(t) == 500.0
    assert r("infer.middle_ms")(s) == 2.0
    assert r("train.forward_ms")(t) == 4.0
    assert r("infer.k2_ms")(s) == pytest.approx(2.0)     # 4 ms / 2 scenes
    assert r("infer.k2_roofline")(s) == pytest.approx(25.0)
    assert r("infer.k1_roofline")(s) == pytest.approx(10.0)
    # units 1, 2, 0, 1 of the pool: 2 + 3 + 1 + 2 GFLOP over 2 s at 1 TF/s
    assert r("infer.mfu")(s) == pytest.approx(100 * 8e9 / 2e12)
    # 0.1 s busy a unit of 0.5 s wall
    assert r("infer.device_idle")(s) == pytest.approx(80.0)
    assert r("train.peak_mib")(t) == 3.0
    # a reader with nothing to read returns nothing, never 0
    empty = dict(s, trace={"busy_s": 0.0, "window_s": 1.0, "units": 1,
                           "by_op": {}}, k2_bound_s=0.0)
    assert r("infer.k2_roofline")(empty) is None
    assert r("infer.device_idle")(empty) is None


def test_p95_is_the_tail_of_every_scene():
    from benchmark import harness
    lat = [0.01 * i for i in range(1, 101)]
    rec = dict(_record("stream"), latencies_s=lat)
    # statistics.quantiles' 95th of 100: between the 95th and 96th values
    assert harness.reader("scene_p95_ms")(rec) == pytest.approx(959.5)


def test_trace_summary_busy_and_gaps():
    from benchmark import trace

    def ev(name, a, b, dev=True):
        return {"name": name, "device": dev, "start": a, "end": b}
    events = [ev("void k_a<1>(int)", 0, 10), ev("k_b(float)", 5, 20),
              ev("void ns::k_c<2>(x)", 50, 60), ev("aten::mm", 0, 100, False),
              ev("void (anonymous namespace)::k_d<3>(y)", 70, 75)]
    s = trace.summary(events, 1e-4)
    assert s["busy_s"] == pytest.approx(35e-6)
    assert s["breakdown"]["idle_gaps"] == [
        ["before k_c", pytest.approx(30e-6)],
        ["before k_d", pytest.approx(10e-6)]]
    assert s["breakdown"]["device_ops"][0][0] == "k_b(float)"
    assert not math.isnan(s["busy_s"])
