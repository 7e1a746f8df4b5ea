"""The plain reference against the program on the CPU at the tiny
geometry: one state dict loads into both, and they agree."""
from __future__ import annotations

import pytest
import torch

from conftest import DATA, STREAMS, TRAIN


def _pair(config: str, training: bool, seed: int = 5):
    from benchmark import harness, weights
    from benchmark.reference import nets
    from benchmark.system import Program
    cfg = harness.load_json(DATA / f"{config}_tiny.json")
    e = cfg["experiment"]
    ref = nets.build(e)
    sd = weights.make_state_dict(ref, e, seed, torch.device("cpu"))
    ref.load_state_dict(sd)
    return cfg, e, ref, sd, Program(cfg, sd, torch.device("cpu"),
                                    training=training, total_steps=100)


@pytest.mark.parametrize("config,workload", STREAMS)
def test_reference_maps_equal_the_programs(config, workload):
    from benchmark import scenes, weights
    cfg, e, ref, sd, _ = _pair(config, False)
    mix = __import__("json").load(open(DATA / "sweep_stream_tiny.json"))
    pool = scenes.make_pool(e, mix, 11, torch.device("cpu"), False)
    weights.calibrate_(ref, sd, pool[0]["points"], pool[0]["points_valid"])
    from benchmark.system import Program
    prog = Program(cfg, sd, torch.device("cpu"))
    with torch.no_grad():
        for s in pool:
            got = prog.forward(s["points"], s["points_valid"])
            want = ref(s["points"][None], s["points_valid"][None])
            for g, w in zip(got, want):
                for k in w:
                    # sums in another order (27 products against one
                    # stacked one), through calibrated BatchNorms
                    torch.testing.assert_close(g[k], w[k], rtol=0,
                                               atol=1e-3 * max(
                                                   1.0, float(w[k].abs()
                                                              .max())))


def test_reference_step_equals_the_programs_first_step():
    from benchmark import scenes
    from benchmark.reference import train as ref_train
    config, _ = TRAIN
    cfg, e, ref, sd, prog = _pair(config, True)
    mix = __import__("json").load(open(DATA / "train_b1_tiny.json"))
    s = scenes.make_pool(e, mix, 12, torch.device("cpu"), True)[0]
    batch = {"points": s["points"][None], "points_valid":
             s["points_valid"][None],
             "targets_raw": {k: v[None] for k, v in s["gt"].items()}}
    got = prog.step(batch, 0)
    ref.train()
    opt = ref_train.make_optimizer(e, ref)
    want = ref_train.step(e, ref, opt, batch, 0, 100)
    assert float(got["loss"]) == pytest.approx(float(want["loss"]),
                                               rel=1e-5)
    assert float(got["grad_norm"]) == pytest.approx(
        float(want["grad_norm"]), rel=1e-4)
