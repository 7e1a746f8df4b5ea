"""Fixtures of the benchmark's own tests: cells at the CPU tests' tiny
geometry (`data/`), built as `harness.make_cell` builds a cell."""
from __future__ import annotations

import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
DATA = Path(__file__).resolve().parent / "data"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

SEED = 2 ** 31 + 7


def tiny_cell(config: str, traffic: str, workload: str, seed: int = SEED,
              seconds: float = 0.3, trace: bool = False):
    from benchmark import harness
    cfg = harness.load_json(DATA / f"{config}_tiny.json")
    return harness.Cell(
        workload=workload, config=cfg, experiment=cfg["experiment"],
        mix=harness.load_json(DATA / f"{traffic}_tiny.json"),
        limits=harness.load_json(ROOT / "benchmark" / "limits"
                                 / f"{workload}.json"),
        peaks=cfg["peaks"], seed=seed, seconds=seconds, trace=trace,
        device=torch.device("cpu"), t0=time.perf_counter())


STREAMS = [("forecast_n3dtf", "forecast_n3dtf.sweep_stream"),
           ("pp_forecast_n3dtf", "pp_forecast_n3dtf.sweep_stream")]
TRAIN = ("forecast_n3dtf", "forecast_n3dtf.train_b1")


@pytest.fixture
def card():
    """Skips a test where no CUDA device is present (decided when the test
    runs, never when the module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")
