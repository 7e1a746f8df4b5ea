"""chip_smoke.py's checks and bounds, on the CPU with synthetic inputs: the
card-against-CPU detection matcher at near ties, K1's pair counts and
bound, and K2's two bounds; and its training phases (10-16) rehearsed on
the CPU at small configs, with K2 replaced by a counting plain version."""
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


def test_dw_bound():
    """dW = gather(x)^T @ dy and db = sum(dy): x, the table and dy read
    once, dW and db written once; 2 * present pairs * Cin * Cout
    operations at 67 TFLOP/s."""
    V, N, cin, cout = 40, 30, 16, 32
    table = torch.full((27, N), V, dtype=torch.int32)
    table[13] = torch.arange(N)
    table[0, :5] = 7
    got = cs.dw_bound(torch.zeros(V, cin), table, torch.zeros(N, cout))
    nbytes = 4 * (V * cin + 27 * N + N * cout + 27 * cin * cout + cout)
    bytes_ms, ops_ms = nbytes / 3.35e12 * 1e3, 2 * 35 * cin * cout / 67e12 * 1e3
    assert got["bound_ms"] == pytest.approx(max(bytes_ms, ops_ms))
    assert got["bound_by"] == ("bytes" if bytes_ms > ops_ms else "operations")


def test_grad_ratios():
    """Each tensor's max |diff| over its max |reference|; a tensor zero up
    to rounding (below ZERO_FRACTION of the largest) gets None and must be
    as small on the other side."""
    want = {"a": torch.tensor([1.0, -2.0]), "z": torch.tensor([1e-9, 0.0])}
    got = {"a": torch.tensor([1.0, -2.002]), "z": torch.tensor([0.0, 1e-9])}
    r = cs.grad_ratios(got, want)
    assert r["a"] == pytest.approx(1e-3, rel=1e-3) and r["z"] is None
    got["z"] = torch.tensor([0.0, 1e-3])
    with pytest.raises(RuntimeError, match="zero up to rounding"):
        cs.grad_ratios(got, want)


def test_state_equal():
    a = {"w": torch.ones(2), "s": [{"m": torch.zeros(1)}], "n": 3}
    assert cs.state_equal(a, {"w": torch.ones(2), "s": [{"m": torch.zeros(1)}],
                              "n": 3})
    assert not cs.state_equal(a, {"w": torch.ones(2),
                                  "s": [{"m": torch.ones(1)}], "n": 3})
    assert not cs.state_equal(a, {"w": torch.ones(2), "s": [], "n": 3})


@pytest.mark.parametrize("strided", [False, True])
def test_dx_operands_are_those_of_subm_conv_dx(strided):
    """Phases 11 and 13 time and bound K2's input-gradient launches from
    dx_operands: they are the operands subm_conv_dx hands K2."""
    from futuredet_torch.ops import sparse_conv as sc
    from futuredet_torch.ops.pallas_gather import gather_conv_plain
    rng = np.random.default_rng(int(strided))
    dims = (9, 12, 12)
    lin = rng.choice(int(np.prod(dims)), 300, replace=False)
    coords = np.stack(np.unravel_index(lin, dims), -1)
    grid, _ = sc.make_grid(torch.from_numpy(coords), dims)
    cin, cout = 8, 16
    inv = None
    if strided:
        pads = (1, 1, 1)
        out_dims = sc.out_dims_of(dims, pads)
        out = sc.downsample_coords(grid, out_dims, pads)
        table = sc.strided_gather_table(grid, out, dims, pads=pads)
        inv = sc.strided_inverse_table(grid, out, out_dims, pads=pads)
    else:
        table = sc.neighbor_table(grid, dims)
    w = torch.from_numpy(rng.normal(size=(27, cin, cout)).astype(np.float32))
    dy = torch.from_numpy(
        rng.normal(size=(table.shape[1], cout)).astype(np.float32))
    e = {"w": w, "inv": inv, "dy": dy, "table": table}
    assert torch.equal(gather_conv_plain(*cs.dx_operands(e)),
                       sc.subm_conv_dx(dy, table, w, inv))


@pytest.fixture
def train_phases_on_the_cpu(monkeypatch):
    """chip_smoke's training phases on the CPU: the small VoxelNet of
    tests/test_torch_voxelnet.py and tiny_variant(pp_forecast_n3dtf) for
    the two full-width configs, small scenes, K2 as a counting plain
    version, and no-op device synchronisation, memory and timers."""
    from futuredet_torch import config
    from futuredet_torch.ops import pallas_gather
    from futuredet_torch.ops import sparse_conv
    from tests.test_torch_voxelnet import voxelnet_config
    small = {cs.VOX_NAME: voxelnet_config(config),
             cs.NAME: config.tiny_variant(config.get_config(cs.NAME))}
    monkeypatch.setattr(config, "get_config", lambda name: small[name])

    def counting_k2(*args):
        counting_k2.launches += 1
        return pallas_gather.gather_conv_plain(*args)
    counting_k2.launches = 0
    monkeypatch.setattr(pallas_gather, "gather_conv", counting_k2)
    monkeypatch.setattr(sparse_conv, "gather_conv", counting_k2)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats",
                        lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(cs, "time_device", lambda fn: (fn(), 0.0)[1])
    monkeypatch.setattr(cs, "TRAIN_REPS", 2)
    monkeypatch.setattr(cs, "TRAIN_CLUTTER", 1500)
    monkeypatch.setattr(cs, "MAX_POINTS", 1024)
    monkeypatch.setattr(cs, "PILLAR_TRAIN_CLUTTER", 800)
    lines = []
    monkeypatch.setattr(cs, "emit", lines.append)
    # the small models run fastest on one thread, and the suite runs in
    # several processes at once
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield lines
    torch.set_num_threads(n)


def test_voxelnet_train_phases_rehearse_on_the_cpu(train_phases_on_the_cpu):
    lines = train_phases_on_the_cpu
    out = cs.train_path(torch.device("cpu"), "cpu")
    assert out["launches"] == cs.TRAIN_STEPS * 39
    assert out["k1_launches"] == 0 and out["dx_max_abs_err"] < 1e-5
    phases = [ln.get("phase") for ln in lines]
    assert phases.count("train_main_path") == cs.TRAIN_STEPS + 1
    assert phases[-3:] == ["k2_backward_vs_plain", "train_cpu_cross_check",
                           "train_times"]
    assert lines[-2]["loss_rel_err"] == 0.0
    assert lines[-2]["reference"] == "cpu_float32"


def test_pillar_train_phases_rehearse_on_the_cpu(train_phases_on_the_cpu):
    lines = train_phases_on_the_cpu
    out = cs.pillar_train_path(torch.device("cpu"), "cpu")
    assert out["k1"] == 0 and out["k2"] == 0
    assert [ln["phase"] for ln in lines] == \
        ["train_main_path"] * (cs.TRAIN_STEPS + 1) + [
            "train_cpu_cross_check", "train_times"]
    assert all(ln["model"] == cs.NAME for ln in lines)
    cross = lines[-2]
    assert cross["reference"] == "cpu_float64"
    assert cross["card_vs_cpu32"]["worst_grad_ratio"] == 0.0
    assert 0 < cross["cpu32_vs_reference"]["worst_grad_ratio"] < 1e-2
    overfit = lines[cs.TRAIN_STEPS]
    assert overfit["loss_after_repeated_batch"] < \
        overfit["repeated_batch_losses"][0]
    assert overfit["checkpoint"]["model_identical"]
    assert set(lines[-1]["train_step_split_ms"]) == {
        "targets", "forward_loss", "backward", "optimizer"}


@pytest.fixture
def eval_phases_on_the_cpu(train_phases_on_the_cpu, monkeypatch, tmp_path):
    """chip_smoke's evaluation phases on the CPU, on top of the training
    rehearsal's small configs and counting K2: K1 as a counting plain
    version too, the CLI's outputs under tmp_path, few train steps and no
    timing runs."""
    from futuredet_torch.ops import nms, pallas_nms

    def counting_k1(boxes, valid, thr):
        counting_k1.launches += 1
        return pallas_nms.nms_alive_plain(boxes, valid, thr)
    counting_k1.launches = 0
    monkeypatch.setattr(pallas_nms, "rotate_nms_alive", counting_k1)
    monkeypatch.setattr(nms, "rotate_nms_alive", counting_k1)
    monkeypatch.setattr(cs, "OUT_DIR", str(tmp_path / "out"))
    monkeypatch.setattr(cs, "CLI_EPOCHS", 40)
    # the tiny model does not overfit its scene in the rehearsal's steps
    # (its future timesteps keep no box, so velocity_dense links none):
    # the floor holds the full-width model on the card
    monkeypatch.setattr(cs, "MAP_FLOOR", -1.0)
    monkeypatch.setattr(cs, "TTA_REPS", 1)
    monkeypatch.setattr(cs, "time_host", lambda fn, warmup=0, reps=0:
                        (fn(), 0.0)[1])
    os.makedirs(cs.OUT_DIR)
    return train_phases_on_the_cpu


def test_eval_phases_rehearse_on_the_cpu(eval_phases_on_the_cpu, tmp_path):
    lines = eval_phases_on_the_cpu
    from futuredet_torch import config
    dev = torch.device("cpu")
    vox_ckpt = str(tmp_path / "vox")
    cs.run_trainer(config.get_config(cs.VOX_NAME), dev, cs.TRAIN_CLUTTER,
                   [], vox_ckpt)
    pp = cs.cli_pillar_path(dev, "cpu", str(tmp_path))
    assert (pp["k1"], pp["k2"]) == (1, 0)
    vox = cs.cli_voxelnet_path(dev, "cpu", vox_ckpt, {"scene": 0.0})
    assert (vox["k1"], vox["k2"]) == (cs.EVAL_SCENES, 20 * cs.EVAL_SCENES)
    tta = cs.tta_path(dev, "cpu", {cs.NAME: pp["checkpoint_dir"],
                                   cs.VOX_NAME: vox_ckpt})
    assert tta == {f"{cs.NAME}_tta_map": {"k1": 1, "k2": 0},
                   f"{cs.NAME}_tta_box": {"k1": 4, "k2": 0},
                   f"{cs.VOX_NAME}_tta_map": {"k1": 1, "k2": 80},
                   f"{cs.VOX_NAME}_tta_box": {"k1": 4, "k2": 80}}
    cs.metrics_engine_path(dev, "cpu")
    assert [ln["phase"] for ln in lines] == [
        "cli_train_evaluate", "cli_evaluate", "tta", "tta",
        "metrics_engine"]
    first = lines[0]
    assert first["train_steps"] == cs.CLI_EPOCHS
    assert first["car"]["mAP"] > cs.MAP_FLOOR
    assert os.path.exists(os.path.join(cs.ROOT, first["metrics_csv"]))
    tails = lines[1]["host_tail"]
    assert set(tails) == {"native", "numpy", "native_vs_numpy_max_abs_err"}
    assert tails["native_vs_numpy_max_abs_err"] <= cs.GOLDEN_ATOL
    assert "(not reached)" in lines[1]["voxel_budget"]
    for ln in lines[2:4]:
        assert ln["hm_max_abs_err"] == 0.0
        assert set(ln["detections_card_cpu_let_off"]) == {
            "map", "box_flip_0", "box_flip_1", "box_flip_2", "box_flip_3"}
    golden = lines[-1]["golden"]
    assert len(golden) == 10
    assert max(g["max_abs_err"] for g in golden.values()) <= cs.GOLDEN_ATOL
    assert lines[-1]["oracle_gt_as_detections"]["mAP"] > cs.ORACLE_FLOOR
