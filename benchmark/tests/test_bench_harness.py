"""The harness end to end on the CPU, at the tiny geometry, on the
program's plain paths (K1 and K2 run their plain versions there)."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT, STREAMS, TRAIN, tiny_cell

KEYS = {"correct", "attempted", "failed", "metrics", "device"}


def _line(workload, cell):
    from benchmark import harness
    rec = harness.run_cell(cell)
    out = harness.result(cell, harness.spec(ROOT), rec)
    # the result line as run.py prints it, parsed back
    return rec, json.loads(json.dumps(out))


@pytest.mark.parametrize("config,workload", STREAMS)
def test_stream_cell_end_to_end(config, workload):
    # a window long enough for some scenes, so that a tail exists
    rec, out = _line(workload, tiny_cell(config, "sweep_stream", workload,
                                         seconds=2.0))
    assert KEYS <= set(out) and list(out)[-1] == "checks"
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] == rec["units"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {"scene_ms", "scene_p95_ms", "setup_s"}
    assert all(m["value"] > 0 for m in out["metrics"].values())
    assert set(out["checks"]) == {"maps_rel", "det_gap", "nms_gap"}
    assert rec["scenes_checked"] >= 1


def test_train_cell_end_to_end():
    config, workload = TRAIN
    rec, out = _line(workload, tiny_cell(config, "train_b1", workload))
    assert KEYS <= set(out)
    assert set(out["metrics"]) == {"train_step_ms", "setup_s"}
    assert set(out["checks"]) == {"loss_gap", "grad_gap", "grad_gap_median",
                                  "update_gap_median"}
    # the first step goes through the same arithmetic on both sides
    assert out["checks"]["loss_gap"]["value"] <= \
        out["checks"]["loss_gap"]["limit"]


def test_run_refuses_without_a_card(tmp_path):
    """No CUDA device: a non-zero exit and no result line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "forecast_n3dtf.sweep_stream", "--seed", str(2 ** 31 + 3),
         "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_spec_names_files_that_exist():
    """Every cell's configuration, traffic, limits and every metric's
    reader is found by its name."""
    from benchmark import harness
    bench = harness.spec(ROOT)
    for w in bench["workloads"]:
        cell = harness.make_cell(ROOT, w["name"], 1, 1.0, False, "cpu", 0.0)
        assert cell.mix["loop"] in ("stream", "train")
        for trace in (False, True):
            for m in harness.metrics_of(bench, w["name"], trace):
                assert callable(harness.reader(m["name"]))
    for c in bench["configs"]:
        cfg = harness.load_json(ROOT / c["file"])
        from benchmark.system import port_experiment
        assert cfg["experiment"] == port_experiment(cfg)
