"""The control fails every cell at its own size: the reference in the
program's place, in TF32 (the precision next below the configurations'
fp32 with TF32 off), on three seeds. Needs a card; the benchmark's own
runs never run it."""
from __future__ import annotations

import time

import pytest

from conftest import ROOT

CELLS = ["forecast_n3dtf.sweep_stream", "pp_forecast_n3dtf.sweep_stream",
         "forecast_n3dtf.train_b1"]
SEEDS = [3_000_000_101, 3_000_000_102, 3_000_000_103]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("seed", SEEDS)
def test_control_is_not_correct(card, workload, seed):
    from benchmark import harness
    from benchmark.control import Control
    cell = harness.make_cell(ROOT, workload, seed, 3.0, False, "cuda",
                             time.perf_counter())
    training = cell.mix["loop"] == "train"
    rec = harness.run_cell(cell, lambda sd: Control(cell, sd, training))
    assert rec["correct"] is False, rec["checks"]
