"""chip_smoke.py's checks and bounds, on the CPU with synthetic inputs: the
card-against-CPU detection matcher at near ties, K1's pair counts and
bound, and K2's two bounds; and its training phases (10-16) rehearsed on
the CPU at small configs, with K2 replaced by a counting plain version."""
import copy
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
                                            (128, 128, "wide"),
                                            (128, 128, "bf16")])
def test_k2_bounds(cin, cout, route):
    """bytes once at 3.35 TB/s (x and W in 2 bytes for the bf16 family);
    2 * present pairs * Cin * Cout at 67 TFLOP/s (bound_ms; 989 for the
    bf16 family) and, for the wide family, at 495 / 3 TFLOP/s."""
    V, N = 40, 30
    dtype = torch.bfloat16 if route == "bf16" else torch.float32
    table = torch.full((27, N), V, dtype=torch.int32)
    table[0] = torch.arange(N)
    table[26, :7] = 3
    got = cs.k2_bound(torch.zeros(V, cin, dtype=dtype), table,
                      torch.zeros(27, cin, cout, dtype=dtype),
                      torch.zeros(cout))
    present = N + 7
    elt = 2 if route == "bf16" else 4
    nbytes = elt * (V * cin + 27 * cin * cout) + 4 * (27 * N + cout
                                                      + N * cout)
    ops = 2 * present * cin * cout
    peak = 989e12 if route == "bf16" else 67e12
    assert got["route"] == route and got["present_pairs"] == present
    assert got["bytes"] == nbytes
    assert got["bytes_ms"] == pytest.approx(nbytes / 3.35e12 * 1e3)
    assert got["ops_ms"] == pytest.approx(ops / peak * 1e3)
    assert got["bound_ms"] == pytest.approx(
        max(nbytes / 3.35e12, ops / peak) * 1e3)
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


def test_relu_decisions_replay_the_card_run_into_the_reference():
    """The reference run takes the recorded run's ReLU decisions, call by
    call: an input at its tie whose sign the two runs take differently
    passes (and takes gradient) as recorded, and is listed with its
    margin; a decision that differs away from its tie fails."""
    torch.manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Linear(4, 6), torch.nn.ReLU(),
                              torch.nn.Linear(6, 1))
    x = torch.randn(5, 4)
    relus = cs.ReluDecisions()
    relus.record(net)
    pre = net[0](x).detach()
    net(x).sum().backward()
    relus.remove()
    card = [p.grad.clone() for p in net.parameters()]
    # the reference: one ReLU input moved across 0 to 1e-6 of the layer's
    # max (the other inputs of its channel move with it)
    ref = copy.deepcopy(net).double()
    i, j = (pre.abs() == pre.abs().min()).nonzero()[0].tolist()
    with torch.no_grad():
        ref[0].bias[j] -= float(pre[i, j]) + float(torch.sign(pre[i, j])
                                                   * 1e-6 * pre.abs().max())
    plain = copy.deepcopy(ref)
    plain.zero_grad()
    plain(x.double()).sum().backward()
    ref.zero_grad()
    relus.replay(ref)
    ref(x.double()).sum().backward()
    relus.remove()
    assert len(relus.flips) == 1 and relus.flips[0]["count"] == 1
    assert relus.flips[0]["layer"] == "1"
    assert relus.flips[0]["margin"] < cs.RELU_TIE_RTOL
    assert not relus.masks["1"]
    # the first layer's weight gradient flows where the card's ReLUs let it:
    # as the card's with the decisions replayed, a row off without
    assert torch.allclose(ref[0].weight.grad.float(), card[0], atol=1e-6)
    assert (plain[0].weight.grad.float() - card[0])[j].abs().max() > 1e-3
    # a second replay has no decision left to take
    relus.replay(ref)
    with pytest.raises(RuntimeError, match="no card decision"):
        ref(x.double())
    relus.remove()


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


def test_table_recorder_and_the_plain_check(monkeypatch):
    """Phases 6 and 10 record the builders' calls through the operators;
    phases 7 and 11 hold each to the plain builder, and a table off by
    one entry fails."""
    from futuredet_torch.ops import sparse_conv as sc
    rec = cs.TableRecorder(sc._OPS)
    monkeypatch.setattr(sc, "_OPS", rec)
    rng = np.random.default_rng(4)
    dims, pads = (7, 10, 12), (0, 1, 1)
    lin = rng.choice(int(np.prod(dims)), 200, replace=False)
    coords = torch.from_numpy(np.stack(np.unravel_index(lin, dims), -1))
    grid, _ = sc.make_grid(coords, dims)
    out_dims = sc.out_dims_of(dims, pads)
    out = sc.downsample_coords(grid, out_dims, pads)
    sc.neighbor_table(grid, dims)
    sc.strided_gather_table(grid, out, dims, pads=pads)
    rec.on = False
    sc.strided_inverse_table(grid, out, out_dims, pads=pads)
    assert rec.builds == 5
    assert [c[0] for c in rec.calls] == [
        "make_grid", "downsample_coords", "neighbor_table",
        "strided_gather_table"]
    lines, same = cs.tables_vs_plain(rec.calls)
    assert same and all(ln["bit_identical"] for ln in lines)
    assert lines[0]["shapes"][-1] == [1, sc.sitemap_words(dims), 2]
    rec.calls[3][2][5, 7] += 1               # one strided gather entry
    lines, same = cs.tables_vs_plain(rec.calls)
    assert not same
    assert [ln["bit_identical"] for ln in lines] == [True] * 3 + [False]


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
    assert phases[-4:] == ["k2_backward_vs_plain", "tables_vs_plain",
                           "train_cpu_cross_check", "train_times"]
    # the CPU runs the plain builders: 14 builds a step, none on a card
    builds = lines[-3]["builds"]
    assert len(builds) == cs.TABLE_BUILDS["step"]
    assert all(b["bit_identical"] and b["device"] == "cpu" for b in builds)
    assert [b["op"] for b in builds].count("strided_inverse_table") == 3
    assert out["table_launches"] == 0
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
        # K1's own dtype rule
        assert boxes.dtype == torch.float32, boxes.dtype
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


@pytest.fixture
def head_mode_phases_on_the_cpu(eval_phases_on_the_cpu, monkeypatch):
    """chip_smoke's head-mode phases (23-25) on the CPU, on top of the
    evaluation rehearsal: every config they name at the small VoxelNet (or
    tiny_variant for pillars) with its own head, data and sampler."""
    from futuredet_torch import config
    from tests.test_torch_train_modes import mode_config
    names = {n for n, _ in cs.HEAD_MODES} | set(cs.HEAD_MODES_TRAIN) \
        | {n for n, _ in cs.HEAD_MODES_CLI}
    # the module's own get_config: the config module's is patched already
    unpatched = types.SimpleNamespace(get_config=get_config,
                                      tiny_variant=config.tiny_variant)
    small = {n: (config.tiny_variant(get_config(n)) if n.startswith("pp_")
                 else mode_config(unpatched, n)) for n in names}
    monkeypatch.setattr(config, "get_config", lambda name: small[name])
    return eval_phases_on_the_cpu


def test_head_mode_phases_rehearse_on_the_cpu(head_mode_phases_on_the_cpu):
    lines = head_mode_phases_on_the_cpu
    dev = torch.device("cpu")
    modes = cs.head_modes_path(dev, "cpu")
    assert len(modes) == len(cs.HEAD_MODES) == 10
    assert {n: v["g"] for n, v in modes.items()} == {
        "forecast_n0": 7, "forecast_n3": 7, "forecast_n3dtfm": 7,
        "centerpoint_multitask": 6, "pp_centerpoint_multitask": 6,
        "forecast_n3+reverse": 7, "forecast_n3+sparse": 14,
        "forecast_n3+classify": 7, "forecast_n3+wide_head": 7,
        "forecast_n0+dcn_head": 7}
    assert all(v["k1"] == 1 for v in modes.values())
    assert modes["pp_centerpoint_multitask"]["k2"] == 0
    assert modes["forecast_n3+wide_head"]["k2"] == 20
    checked = [ln for ln in lines if "hm_max_abs_err" in ln]
    assert [ln["model"] for ln in checked] == [
        "forecast_n0", "forecast_n3", "forecast_n3dtfm",
        "centerpoint_multitask", "pp_centerpoint_multitask",
        "forecast_n0+dcn_head"]
    assert all(ln["hm_max_abs_err"] == 0.0 and not ln["let_off_at_the_cut"]
               for ln in checked)
    assert [ln["bev_map"] for ln in lines].count(True) == 1

    del lines[:]
    train = cs.head_modes_train_path(dev, "cpu")
    assert set(train) == set(cs.HEAD_MODES_TRAIN)
    assert all(v == {"k1": 0, "k2_forward": 20, "k2_dx": 19}
               for v in train.values())
    assert [ln["phase"] for ln in lines] == ["head_modes_train"] * 4 + [
        "train_cpu_cross_check"]
    assert lines[-1]["model"] == "centerpoint_multitask"
    assert lines[-1]["loss_rel_err"] == 0.0
    assert len(lines[3]["hm_loss"]) == 6

    del lines[:]
    cli = cs.head_modes_cli_path(dev, "cpu")
    n = cs.HEAD_MODE_CLI_SCENES
    assert cli == {"forecast_n0_head_mode_eval": {"k1": n, "k2": 20 * n},
                   "centerpoint_multitask_head_mode_eval":
                   {"k1": n, "k2": 20 * n}}
    assert lines[0]["classes"] == ["car"]
    assert len(lines[1]["classes"]) == 10
    for ln in lines:
        assert os.path.exists(os.path.join(cs.ROOT, ln["metrics"]))


@pytest.fixture
def two_stage_phases_on_the_cpu(eval_phases_on_the_cpu, monkeypatch):
    """chip_smoke's two-stage phases (26-28) on the CPU, on top of the
    evaluation rehearsal: the two-stage configs at tiny_variant (pillars)
    and the small VoxelNet of tests/test_torch_voxelnet.py, beside their
    single-stage configs."""
    from futuredet_torch import config
    from tests.test_torch_two_stage import pp_config, vox_config
    from tests.test_torch_voxelnet import voxelnet_config
    unpatched = types.SimpleNamespace(get_config=get_config,
                                      tiny_variant=config.tiny_variant)
    small = {cs.NAME: config.tiny_variant(get_config(cs.NAME)),
             cs.VOX_NAME: voxelnet_config(unpatched),
             "pp_forecast_n3dtf_two_stage": pp_config(unpatched),
             "forecast_n3dtf_two_stage": vox_config(unpatched)}
    monkeypatch.setattr(config, "get_config", lambda name: small[name])
    return eval_phases_on_the_cpu


def test_two_stage_phases_rehearse_on_the_cpu(two_stage_phases_on_the_cpu,
                                              tmp_path):
    lines = two_stage_phases_on_the_cpu
    dev = torch.device("cpu")
    pp = cs.cli_pillar_path(dev, "cpu", str(tmp_path))
    del lines[:]

    two = cs.two_stage_path(dev, "cpu")
    assert two == {"pp_forecast_n3dtf_two_stage": {"k1": 1, "k2": 0, "g": 7},
                   "forecast_n3dtf_two_stage": {"k1": 1, "k2": 20, "g": 7}}
    assert [ln["phase"] for ln in lines] == ["two_stage"] * 2
    for ln in lines:
        assert ln["hm_max_abs_err"] == 0.0 and not ln["let_off_at_the_cut"]
        assert ln["proposals_matched"] == ln["proposals"] > 0
        assert max(ln["roi_rel_err"].values()) == 0.0

    del lines[:]
    train = cs.two_stage_train_path(dev, "cpu")
    assert train == {
        "pp_forecast_n3dtf_two_stage": {"k1": 1, "k2_forward": 0,
                                        "k2_dx": 0},
        "forecast_n3dtf_two_stage": {"k1": 1, "k2_forward": 20,
                                     "k2_dx": 19}}
    assert [ln["phase"] for ln in lines] == [
        "two_stage_train", "train_cpu_cross_check", "two_stage_train"]
    for ln in (lines[0], lines[2]):
        assert ln["trainable_tensors"] == cs.TWO_STAGE_TRAINABLE
        assert not any(ln["hm_loss"])
        assert {"decode_nms", "proposal_targets"} <= set(
            ln["train_step_split_ms"])
        roi = ln["repeated_batch_roi_cls_losses"]
        assert len(roi) == cs.OVERFIT_STEPS and roi[-1] < roi[0]
    assert lines[1]["reference"] == "cpu_float64"
    assert lines[1]["card_vs_cpu32"]["worst_grad_ratio"] == 0.0

    del lines[:]
    cli = cs.two_stage_cli_path(dev, "cpu", pp["checkpoint_dir"], pp["mAP"])
    name = "pp_forecast_n3dtf_two_stage"
    assert cli == {f"{name}_cli_train": {"k1": cs.TWO_STAGE_CLI_EPOCHS,
                                         "k2": 0},
                   f"{name}_cli_eval": {"k1": 1, "k2": 0}}
    (ln,) = lines
    assert ln["train_launches_per_step"] == [(1, 0)] * \
        cs.TWO_STAGE_CLI_EPOCHS
    assert ln["tta_exit"] != "0"
    assert os.path.exists(os.path.join(cs.ROOT, ln["metrics"]))


@pytest.fixture
def serving_phases_on_the_cpu(eval_phases_on_the_cpu, monkeypatch):
    """chip_smoke's serving and dense-middle phases (29-32) on the CPU, on
    top of the evaluation rehearsal: the small VoxelNet of
    tests/test_torch_bf16.py (middle channels 8/16/64/64, so that the
    bf16-pair stages exist) and tiny_variant(pp_forecast_n3dtf), K2 as a
    plain version counted by route, the stacked yardstick in fp32."""
    from futuredet_torch import config
    from futuredet_torch.ops import pallas_gather, sparse_conv
    from tests.test_torch_bf16 import serving_config
    unpatched = types.SimpleNamespace(get_config=get_config,
                                      tiny_variant=config.tiny_variant)
    small = {cs.NAME: config.tiny_variant(get_config(cs.NAME)),
             cs.VOX_NAME: serving_config(unpatched)}
    monkeypatch.setattr(config, "get_config", lambda name: small[name])

    def counting_k2(f, t, w, b=None):
        counting_k2.launches += 1
        counting_k2.launches_by_route[pallas_gather.k2_route(
            f.shape[1], w.shape[2], f.dtype)] += 1
        return pallas_gather.gather_conv_plain(f, t, w, b)
    monkeypatch.setattr(pallas_gather, "gather_conv", counting_k2)
    monkeypatch.setattr(sparse_conv, "gather_conv", counting_k2)
    pallas_gather.reset_launches()

    def library(f, t, w, b):
        return lambda: pallas_gather.gather_conv_plain(f, t, w, b)
    monkeypatch.setattr(cs, "k2_library_call", library)
    monkeypatch.setattr(cs, "TRAIN_CLUTTER", 1500)
    return eval_phases_on_the_cpu


def test_serving_phases_rehearse_on_the_cpu(serving_phases_on_the_cpu):
    lines = serving_phases_on_the_cpu
    dev = torch.device("cpu")
    out = cs.serving_path(dev, "cpu")
    vox, pp = cs.VOX_NAME, cs.NAME
    assert out["paths"] == {
        f"{vox}+a_bf16": {"k1": 1, "k2": 20, "k2_bf16": 20},
        f"{vox}+b_window_bf16": {"k1": 1, "k2": 20, "k2_bf16": 20},
        f"{vox}+c_bf16_packed": {"k1": 1, "k2": 20, "k2_bf16": 0},
        f"{pp}+pillars_bf16": {"k1": 1, "k2": 0, "k2_bf16": 0}}
    assert [ln["phase"] for ln in lines] == ["serving"] * 4 + [
        "k2_bf16_vs_plain"]
    for ln in lines[:4]:
        assert 0 <= ln["head_maps_rel_err_vs_fp32"] <= cs.SERVING_RTOL
        assert len(ln["ms_per_scene_turns"]) == 2
    # bf16 towers move the maps, bf16_packed's truncation a little
    assert lines[0]["head_maps_rel_err_vs_fp32"] > 1e-4
    assert 0 < lines[2]["head_maps_rel_err_vs_fp32"] < 1e-2
    convs = lines[-1]["convs"]
    assert len(convs) == 20 and all(c["route"] == "bf16" for c in convs)
    assert all(c["max_abs_err"] == 0.0 and c["bit_identical"]
               for c in convs)
    assert convs[0]["cin"] == 5 and convs[-1]["cin"] == 64
    assert all(c["plan"]["w"] in ("resident", "streamed")
               and c["plan"]["rows"] == ("2B" if c["cin"] % 8 else "16B")
               for c in convs)
    assert out["k2_bf16"]["bound_ms"] > 0

    del lines[:]
    dense = cs.dense_middle_path(dev, "cpu")
    assert dense == {f"{vox}+d_dense_from2": {"k1": 1, "k2": 10},
                     f"{vox}+d_dense_from2_bf16": {"k1": 1, "k2": 10},
                     f"{vox}+e_dense": {"k1": 1, "k2": 0}}
    assert [ln["phase"] for ln in lines] == ["dense_canvas"] + [
        "dense_middle"] * 4
    assert set(lines[0]["bytes"]) == {"canvas_in", "stage2_out",
                                      "stage3_out"}
    assert lines[1]["middle_max_abs_err"] <= lines[1]["middle_tol"]
    assert lines[2]["middle_max_abs_err"] > 0
    assert np.isfinite(lines[3]["train_loss"]) and lines[3]["train_k2"] == 0


@pytest.fixture
def bf16_train_phases_on_the_cpu(two_stage_phases_on_the_cpu, monkeypatch):
    """chip_smoke's bf16 training and data-parallel phases (33-34) on the
    CPU, on top of the two-stage rehearsal's small configs: K2 counted by
    route (as the serving rehearsal counts it)."""
    from futuredet_torch.ops import pallas_gather, sparse_conv

    def counting_k2(f, t, w, b=None):
        counting_k2.launches += 1
        counting_k2.launches_by_route[pallas_gather.k2_route(
            f.shape[1], w.shape[2], f.dtype)] += 1
        return pallas_gather.gather_conv_plain(f, t, w, b)
    monkeypatch.setattr(pallas_gather, "gather_conv", counting_k2)
    monkeypatch.setattr(sparse_conv, "gather_conv", counting_k2)
    pallas_gather.reset_launches()
    monkeypatch.setattr(cs, "OVERFIT_STEPS", 3)
    return two_stage_phases_on_the_cpu


def test_bf16_train_and_dp_phases_rehearse_on_the_cpu(
        bf16_train_phases_on_the_cpu, tmp_path):
    lines = bf16_train_phases_on_the_cpu
    dev = torch.device("cpu")
    out = cs.bf16_train_path(dev, "cpu")
    vox, pp = cs.VOX_NAME, cs.NAME
    assert out == {
        f"{vox}+a_bf16_train": {"k1": 0, "k2": 39, "k2_bf16": 20},
        f"{vox}+d_dense_bf16_train": {"k1": 0, "k2": 19, "k2_bf16": 0},
        f"{pp}+pillars_bf16_train": {"k1": 0, "k2": 0, "k2_bf16": 0},
        "pp_forecast_n3dtf_two_stage+two_stage_bf16_train":
            {"k1": 1, "k2": 0, "k2_bf16": 0}}
    assert [ln["phase"] for ln in lines] == ["bf16_train"] * 4
    a = lines[0]
    assert a["k2_dx_by_route"]["bf16"] == 0 and a["k2_dx"] == 19
    assert a["signal_quantities"] and a["card_fp32_breaks"]
    assert all(ln["card_fp32_breaks"] for ln in lines)
    assert all(len(ln["repeated_batch_losses"]) == 3 for ln in lines)
    assert set(lines[3]["train_step_split_ms"]) >= {"decode_nms",
                                                    "proposal_targets"}

    del lines[:]
    dp = cs.dp_path(dev, "cpu", str(tmp_path))
    assert dp == {f"{vox}_dp_train_cli": {"k1": 0, "k2": 78},
                  f"{vox}_dp_eval_cli": {"k1": 2, "k2": 40}}
    ln = lines[-1]
    assert ln["backend"] == "gloo"
    assert [tuple(g) for g in ln["process_groups"]] == [("gloo", 1, 0)] * 2
    assert ln["bit_identical"] and ln["plain_steps_bit_identical"]
    assert ln["batchnorms"] > 10
