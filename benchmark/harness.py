"""One run of one cell: find the cell's files by name, check the card, run
its loop, read its metrics, decide `correct`, print the result line.

Everything a cell needs is found by the names in `BENCHMARK.json`:

  configs/<config>.json      the configuration as it runs (the port's
                             config name and its full settings, checked
                             against the port's at every run), its
                             precision and the card's peaks;
  traffic/<mix>.json         the traffic's parameters and the loop that
                             serves it (`loops/<loop>.py`);
  metrics/<a>/<b>.py         the reader of metric `a.b` (`setup_s` ->
                             metrics/setup_s.py): `read(run) -> number or
                             None`, None where it finds nothing to read;
  limits/<workload>.json     the limit of each number that `correct`
                             compares (`check.py`).
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List

import torch

HERE = Path(__file__).resolve().parent
BANNED = ("jax", "jaxlib", "flax", "futuredet_tpu")


@dataclasses.dataclass
class Cell:
    workload: str
    config: Dict
    experiment: Dict
    mix: Dict
    limits: Dict
    peaks: Dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t0: float
    program: Callable = None
    t_marks: float = None       # where the loop's set-up parts start


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def spec(root: Path) -> Dict:
    return load_json(root / "BENCHMARK.json")


def cell_entry(bench: Dict, workload: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")


def metrics_of(bench: Dict, workload: str, trace: bool) -> List[Dict]:
    """The cell's end-to-end metrics (trace 0) or per-layer ones (trace
    1): those that list the cell, or list no cells at all."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def reader(name: str):
    """metrics/<name with dots as slashes>.py, loaded by path."""
    path = HERE / "metrics" / (name.replace(".", "/") + ".py")
    spec_ = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(mod)
    return mod.read


def check_config(config: Dict, port_experiment: Dict) -> None:
    """The configuration file holds the configuration as it runs: every
    setting of the port's config of that name, unchanged."""
    if config["experiment"] != port_experiment:
        diff = [k for k in set(config["experiment"]) | set(port_experiment)
                if config["experiment"].get(k) != port_experiment.get(k)]
        raise SystemExit(f"configs/{config['name']}.json differs from the "
                         f"port's {config['port_config']!r} in {diff}")


def set_precision(config: Dict) -> None:
    p = config["precision"]
    if p["dtype"] != "float32":
        raise SystemExit(f"precision {p['dtype']!r}: the harness runs "
                         f"float32 configurations")
    torch.backends.cuda.matmul.allow_tf32 = p["tf32"]
    torch.backends.cudnn.allow_tf32 = p["tf32"]


def make_cell(root: Path, workload: str, seed: int, seconds: float,
              trace: bool, device, t0: float) -> Cell:
    bench = spec(root)
    w = cell_entry(bench, workload)
    config = load_json(HERE / "configs" / f"{w['config']}.json")
    return Cell(workload=workload, config=config,
                experiment=config["experiment"],
                mix=load_json(HERE / "traffic" / f"{w['traffic']}.json"),
                limits=load_json(HERE / "limits" / f"{workload}.json"),
                peaks=config["peaks"], seed=seed, seconds=seconds,
                trace=trace, device=torch.device(device), t0=t0)


def program_factory(cell: Cell) -> Callable:
    """The system under test for a state dict: the port's detector."""
    from .system import Program

    def build(sd):
        return Program(cell.config, sd, cell.device,
                       training=cell.mix["loop"] == "train",
                       total_steps=cell.mix.get("total_steps", 1))
    return build


def run_cell(cell: Cell, system_factory: Callable = None) -> Dict:
    """The loop's run record, with `correct` and each number beside its
    limit."""
    from .system import port_experiment
    check_config(cell.config, port_experiment(cell.config))
    set_precision(cell.config)
    cell.program = program_factory(cell)
    loop = importlib.import_module(f".loops.{cell.mix['loop']}",
                                   __package__)
    rec = loop.run(cell, system_factory)
    rec["loop"] = cell.mix["loop"]
    rec["checks"] = {k: [v, lim] for k, lim in cell.limits.items()
                     for v in [rec["numbers"][k]]}
    rec["correct"] = all(v <= lim for v, lim in rec["checks"].values())
    return rec


def banned_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def result(cell: Cell, bench: Dict, rec: Dict) -> Dict:
    metrics = {}
    for m in metrics_of(bench, cell.workload, cell.trace):
        v = reader(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = cell.device
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"),
              "count": 1,
              "memory_peak_bytes": rec["memory_peak_bytes"]}
    out = {"correct": rec["correct"], "attempted": rec["units"],
           "failed": 0, "metrics": metrics, "device": device}
    if cell.trace and "trace" in rec:
        device["busy_s"] = rec["trace"]["busy_s"]
        device["window_s"] = rec["trace"]["window_s"]
        out["breakdown"] = rec["trace"]["breakdown"]
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in rec["checks"].items()}
    return out


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def main(args, t0: float, root: Path, t_import: float) -> int:
    bench = spec(root)
    w = cell_entry(bench, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < w["chips"]:
        print(f"benchmark: {args.workload} needs {w['chips']} CUDA "
              f"device(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}", file=sys.stderr)
        return 2
    torch.zeros(1, device="cuda")
    t_cuda = time.perf_counter()
    cell = make_cell(root, args.workload, args.seed, args.seconds,
                     bool(args.trace), "cuda", t0)
    print(f"benchmark: {args.workload} seed {args.seed} on "
          f"{card_line()}", file=sys.stderr)
    cell.t_marks = time.perf_counter()
    rec = run_cell(cell)
    rec["setup_parts_s"] = {"import torch": t_import - t0,
                            "cuda context": t_cuda - t_import,
                            "spec, card": cell.t_marks - t_cuda,
                            **rec.get("setup_parts_s", {})}
    found = banned_modules()
    if found:
        print(f"benchmark: the run loaded {found}", file=sys.stderr)
        return 3
    out = result(cell, bench, rec)
    extra = {k: rec[k] for k in ("setup_parts_s", "scenes_checked",
                                 "cells_per_scene",
                                 "checked", "worst_detection",
                                 "first_steps")
             if k in rec}
    print(json.dumps({"run": extra, "stages_ms": rec.get("stages_ms")}),
          file=sys.stderr)
    print(json.dumps({"not compared": {k: v for k, v in rec["numbers"].items()
                                       if k not in rec["checks"]}}),
          file=sys.stderr)
    for k, (v, lim) in rec["checks"].items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
