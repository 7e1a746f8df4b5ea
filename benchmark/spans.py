"""The program's spans against the device: which layer launched each
kernel and copy, which synchronised the host, and where the device
waited for the host, by span.

The program marks its layers with spans (`futuredet_torch/utils/
profiling.py`: `forward` with `voxelize`, `reader`, `middle` and its
`middle.tables`, `z_crush`, `neck`, `head`; `decode` with `decode.nms`;
`train_step` with `train.targets`, `train.forward`, `train.loss`,
`train.backward` and under it `sparse.dx` and `sparse.dw`, `train.update`).
`measure(fn, ...)` runs two stretches of a cell's units (`fn(i)` serves
unit i: a scene with its decode and copies, or a step) with the
program's recorder on:

  (a) `UNITS_A` units with a CUDA event at each span's entry and exit and
      no profiler: each span's device ms, the time the device took from
      the span's entry to its exit, waiting included;
  (b) the first `UNITS_B` of them under `torch.profiler` (the device's
      activity, as `trace.profile` takes it), spans on the host clock
      only. Each kernel, copy and memset is joined to the CUDA API call
      (`cuda*` or `cu*`) that launched it by correlation id; each such call and
      each synchronising call (`SYNCS`) goes to the innermost span open
      on its thread at its host time, or, on a thread with none open
      (autograd's device thread outside `sparse.*`), to the innermost
      span open on any thread.

Per span name, a unit: `spans`, `device_ms` (a), `busy_ms`, the device
time of the kernels and copies launched inside the span or its children
(b), `idle_ms` = `device_ms` - `busy_ms`, the time the device waited for
the host inside the span (built as `*device_idle` is, so the profiler's
slowdown of the host does not enter it), and `launches` and `syncs`
inside it or its children; `roots`, the launches and syncs inside any
span; `outside`, those in none (the loop's own copies); `runtime`, each
CUDA call's count a unit; `kernels`, each device operation's count by
the path of spans it was launched in.

A program without the recorder gives no record (`measure` returns None).

Run on a card for a cell's record, the spans' cost on and off, and the
readings of the span metrics (`METRICS`):

    python3 benchmark/spans.py --workload forecast_n3dtf.sweep_stream \\
        --seed 2147483901 --out spans.jsonl
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
import timeit
from collections import Counter, defaultdict
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

UNITS_A, UNITS_B = 24, 8
# the per-layer metrics that read the record (`metrics/<a>/<b>.py`)
METRICS = ("infer.middle_tables_ms", "infer.middle_idle_ms",
           "infer.head_idle_ms", "infer.decode_idle_ms", "infer.syncs",
           "infer.launches", "train.dx_ms", "train.dw_ms",
           "train.backward_idle_ms", "train.syncs", "train.launches")
# the CUDA calls that wait for the device (a pageable copy, `.item()`,
# `nonzero` and `torch.unique` end in cudaStreamSynchronize)
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy", "cuStreamSynchronize",
         "cuCtxSynchronize", "cuEventSynchronize")


def _event(e) -> Dict:
    """A kineto event as a dict: name, on the device or not, start and end
    in ns, correlation id, and the thread of a host event."""
    annotation = (e.is_user_annotation() if hasattr(e, "is_user_annotation")
                  else False) or e.name().startswith("ProfilerStep")
    dev = e.device_type() != torch.autograd.DeviceType.CPU and not annotation
    return {"name": e.name(), "device": dev, "start": e.start_ns(),
            "end": e.end_ns(), "corr": e.correlation_id(),
            "tid": None if dev else e.device_resource_id()}


def _union_ms(ivs: List) -> float:
    tot, end = 0, None
    for a, b in sorted(ivs):
        if end is None or a > end:
            tot += b - a
            end = b
        elif b > end:
            tot += b - end
            end = b
    return tot / 1e6


def _int32(v: int) -> int:
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= 1 << 31 else v


def _threads(s: Dict) -> set:
    """The ids the profiler may give a call of the span's thread: the OS
    id, or the low 32 bits of the pthread id (a CUDA runtime call's)."""
    return {s["thread"], _int32(s["ident"])}


def _innermost(spans: List[Dict], calls: List[Dict]) -> List:
    """For each call (time order), the innermost span open at its start on
    its thread, else on any thread, else None; and how it was found."""
    marks = []
    for s in spans:
        marks += [(s["start_ns"], 0, s), (s["end_ns"], 2, s)]
    marks += [(c["start"], 1, c) for c in calls]
    marks.sort(key=lambda m: (m[0], m[1]))
    by_thread: Dict[int, List[Dict]] = defaultdict(list)
    open_: List[Dict] = []
    out = []
    for _, kind, x in marks:
        if kind == 0:
            for t in _threads(x):
                by_thread[t].append(x)
            open_.append(x)
        elif kind == 2:
            for t in _threads(x):
                by_thread[t].remove(x)
            open_.remove(x)
        elif by_thread.get(x["tid"]):
            out.append((x, by_thread[x["tid"]][-1], "thread"))
        else:
            out.append((x, open_[-1] if open_ else None,
                        "any" if open_ else "none"))
    return out


def join(spans: List[Dict], events: List[Dict], units: int) -> Dict:
    """(b)'s spans (`SpanRecord._asdict()`) and profiled events (`_event`)
    of `units` units -> launches, syncs and busy ms a unit by span name
    (each span's own and its children's), by the roots, outside them, and
    each device operation's count by span path."""
    by_id = {s["id"]: s for s in spans}

    def chain(s) -> List[str]:
        names = []
        while s is not None:
            names.append(s["name"])
            s = by_id.get(s["parent"])
        return names[::-1]

    launched = defaultdict(list)
    for e in events:
        if e["device"]:
            launched[e["corr"]].append(e)
    host = [e for e in events if not e["device"]
            and e["name"].startswith("cu")]
    calls = sorted((e for e in host
                    if e["corr"] in launched or e["name"] in SYNCS),
                   key=lambda e: e["start"])
    n = Counter()
    busy = defaultdict(list)
    kernels: Dict[str, Counter] = defaultdict(Counter)
    found = Counter()
    for call, s, how in _innermost(spans, calls):
        found[how] += 1
        path = chain(s) if s is not None else []
        scope = set(path) | {"<roots>" if path else "<outside>"}
        ops = launched.get(call["corr"], [])
        for name in scope:
            if ops:
                n[name, "launches"] += 1
                busy[name] += [(e["start"], e["end"]) for e in ops]
            if call["name"] in SYNCS:
                n[name, "syncs"] += 1
        for e in ops:
            kernels[e["name"]]["/".join(path)] += 1
    names = {k for k, _ in n} | set(busy)
    by_span = {k: {"launches": n[k, "launches"] / units,
                   "syncs": n[k, "syncs"] / units,
                   "busy_ms": _union_ms(busy[k]) / units} for k in names}
    return {"by_span": {k: v for k, v in by_span.items()
                        if not k.startswith("<")},
            "roots": by_span.get("<roots>", {"launches": 0.0, "syncs": 0.0,
                                              "busy_ms": 0.0}),
            "outside": by_span.get("<outside>", {"launches": 0.0,
                                                  "syncs": 0.0,
                                                  "busy_ms": 0.0}),
            "runtime": {k: v / units
                        for k, v in Counter(e["name"] for e in host).items()},
            "kernels": {k: dict(v) for k, v in kernels.items()},
            "found": dict(found)}


def combine(spans_a: List[Dict], units_a: int, joined: Dict) -> Dict:
    """(a)'s device ms by span name (the median unit's, as the stage
    metrics take theirs) joined with (b)'s busy ms: idle ms."""
    dev = defaultdict(lambda: defaultdict(float))
    count = Counter()
    for s in spans_a:
        count[s["name"]] += 1
        if s["device_ms"] is not None:
            dev[s["name"]][s["unit"]] += s["device_ms"]
    by_span = {}
    for name in sorted(set(count) | set(joined["by_span"])):
        b = joined["by_span"].get(name, {"launches": 0.0, "syncs": 0.0,
                                         "busy_ms": 0.0})
        d = (statistics.median(dev[name].values()) if name in dev
             else None)
        by_span[name] = dict(b, spans=count[name] / units_a, device_ms=d,
                             idle_ms=None if d is None
                             else d - b["busy_ms"])
    return dict(joined, by_span=by_span)


def reading(rec: Dict, loop: str, span: Optional[str], key: str
            ) -> Optional[float]:
    """A number of the run record's `spans` (`key` of span `span`, or of
    the roots where `span` is None); None where it has none."""
    s = rec.get("spans")
    if rec.get("loop") != loop or not s:
        return None
    if span is None:
        return s["roots"].get(key)
    return s["by_span"].get(span, {}).get(key)


def measure(fn: Callable[[int], None], units_a: int = UNITS_A,
            units_b: int = UNITS_B) -> Optional[Dict]:
    """Stretches (a) and (b) of `fn` on the card: the record `spans`, or
    None where the program has no span recorder."""
    try:
        from futuredet_torch.utils.profiling import Recorder, unit
    except ImportError:
        return None
    from torch.profiler import ProfilerActivity, schedule
    # the first pass makes the CUDA events that the second reuses
    for _ in range(2):
        with Recorder(cuda_events=True) as rec_a:
            for i in range(units_a):
                unit(i)
                fn(i)
    spans_a = [s._asdict() for s in rec_a.spans]

    got = {}

    def ready(p):
        got["events"] = [_event(e) for e in p.profiler.kineto_results.events()]

    rec_b = Recorder()
    with torch.profiler.profile(
            activities=[ProfilerActivity.CUDA],
            schedule=schedule(wait=0, warmup=1, active=units_b),
            on_trace_ready=ready) as prof:
        fn(0)
        torch.cuda.synchronize()
        prof.step()
        rec_b.start()
        for i in range(units_b):
            unit(i)
            fn(i)
            prof.step()
        torch.cuda.synchronize()
        spans_b = [s._asdict() for s in rec_b.stop()]
    joined = join(spans_b, got["events"], units_b)
    if not joined["found"]:          # the profiler saw no CUDA call
        return None
    out = combine(spans_a, units_a, joined)
    out["units"] = [units_a, units_b]
    return out


# --- a card run of one cell: the record, the cost, the readings ---------

def cell_unit(cell) -> Callable[[int], None]:
    """The cell's unit as its loop serves it, on the program built from
    the cell's weights and pool: a scene (pinned points to the card, the
    detector, the decode, Detections to the host) or a step (the batch
    to the card, `train_step`, loss and norm to the host)."""
    from benchmark import scenes, weights
    from benchmark.loops.stream import _host
    from benchmark.loops.train import _to
    from benchmark.reference import nets
    e, mix, dev = cell.experiment, cell.mix, cell.device
    training = mix["loop"] == "train"
    ref = nets.build_empty(e, dev)
    sd = weights.make_state_dict(ref, e, cell.seed, dev)
    pool = scenes.make_pool(e, mix, cell.seed, dev, training=training)
    if not training:
        weights.calibrate_(ref, sd, pool[0]["points"],
                           pool[0]["points_valid"])
    del ref
    system = cell.program(sd)
    if training:
        host = [{"points": s["points"][None].cpu().pin_memory(),
                 "points_valid": s["points_valid"][None].cpu().pin_memory(),
                 "targets_raw": {k: v[None].cpu().pin_memory()
                                 for k, v in s["gt"].items()}}
                for s in pool]

        def fn(i):
            losses = system.step(_to(host[i % len(host)], dev), i)
            torch.stack([losses["loss"], losses["grad_norm"]]).cpu()
        return fn
    host = [(s["points"].cpu().pin_memory(),
             s["points_valid"].cpu().pin_memory()) for s in pool]

    def fn(i):
        pts, valid = host[i % len(host)]
        preds = system.forward(pts.to(dev, non_blocking=True),
                               valid.to(dev, non_blocking=True))
        _host(system.decode(preds))
    return fn


def cost(fn: Callable[[int], None], units: int) -> Dict:
    """Host ms a unit of `units` units with spans off, on with host
    clocks alone and on with CUDA events, in turns; and the host ns a span
    costs off (a `with` block and a decorated call, each less the bare
    statement) and on (with and without its CUDA events)."""
    from futuredet_torch.utils.profiling import Recorder, span, spanned

    def stretch(mode: str) -> float:
        rec = Recorder(cuda_events=mode == "events")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if mode != "off":
            rec.start()
        for i in range(units):
            fn(i)
        torch.cuda.synchronize()
        t = time.perf_counter() - t0
        rec.stop()
        return 1e3 * t / units

    turns = {m: [] for m in ("off", "host", "events")}
    for m in ("off", "host", "events", "events", "host", "off"):
        turns[m].append(stretch(m))

    def on_ns(events: bool, n: int = 2_000) -> float:
        # the second pass reuses the first's CUDA events, as (a) does
        for _ in range(2):
            torch.cuda.synchronize()
            with Recorder(cuda_events=events):
                t0 = time.perf_counter_ns()
                for _ in range(n):
                    with span("x"):
                        pass
                torch.cuda.synchronize()
                t = time.perf_counter_ns() - t0
        return t / n

    def bare():
        pass
    wrapped = spanned("x")(bare)
    n = 200_000

    def ns(stmt) -> float:
        return 1e9 * min(timeit.repeat(stmt, number=n, repeat=5,
                                       globals={"span": span, "bare": bare,
                                                "wrapped": wrapped})) / n
    base_with, base_call = ns("pass"), ns("bare()")
    return {"turns_ms": turns,
            "off_ns_with": ns("with span('x'):\n    pass") - base_with,
            "off_ns_decorated": ns("wrapped()") - base_call,
            "on_ns_host": on_ns(False), "on_ns_events": on_ns(True)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--out", default=None,
                   help="append the record here, a JSON line")
    args = p.parse_args(argv)
    root = Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(root))
    from benchmark import harness
    from benchmark.system import K1_KERNELS, K2_KERNELS, port_experiment
    if not torch.cuda.is_available():
        print("spans: needs a CUDA device", file=sys.stderr)
        return 2
    cell = harness.make_cell(root, args.workload, args.seed, 0.0, True,
                             "cuda", time.perf_counter())
    harness.check_config(cell.config, port_experiment(cell.config))
    harness.set_precision(cell.config)
    cell.program = harness.program_factory(cell)
    fn = cell_unit(cell)
    for i in range(3):
        fn(i)
    rec = {"loop": cell.mix["loop"],
           "spans": measure(fn), "cost": cost(fn, UNITS_A)}
    readings = {name: harness.reader(name)(rec) for name in METRICS}
    s = rec["spans"]
    per_unit = sum(v["spans"] for v in s["by_span"].values())
    rec["cost"]["spans_a_unit"] = per_unit
    k_paths = {k: v for k, v in s["kernels"].items()
               if any(n in k for n in K1_KERNELS + K2_KERNELS)}
    line = {"workload": args.workload, "seed": args.seed,
            "card": harness.card_line(), "readings": readings,
            "cost": rec["cost"], "found": s["found"],
            "roots": s["roots"], "outside": s["outside"],
            "by_span": s["by_span"], "k1_k2_paths": k_paths,
            "syncs_seen": {k: v for k, v in s["runtime"].items()
                           if k in SYNCS},
            "runtime": s["runtime"]}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write(json.dumps(dict(line, kernels=s["kernels"])) + "\n")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
