"""What a traced run reads: CUDA events at the detector's module boundaries
(no sync inside a scene or step), and a short `torch.profiler` stretch of
the device's activity alone (device time by kernel, busy time, idle gaps
by the operation that ended them); profiling the host's operators too
slows a scene several times over and would read the idle share of the
profiler, not of the program.

The benchmark's own code, from its own files: it hooks the program's
modules from outside and reads the program's kernel names; it adds
nothing to the program.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import torch

class Marks:
    """Host-clock seconds of the set-up's parts: each call closes the part
    since the previous one (the first since `t0`)."""

    def __init__(self, t0: float):
        import time
        self.clock = time.perf_counter
        self.last = t0
        self.parts: Dict[str, float] = {}

    def __call__(self, name: str) -> None:
        now = self.clock()
        self.parts[name] = now - self.last
        self.last = now


class StageEvents:
    """CUDA events at the pre- and post-forward hooks of `modules` (name ->
    module) and at marks the loop sets itself (`mark`). Each unit of work
    (a scene or a step) is one dict of name -> event; `ms(a, b)` reads
    the device time between two marks of every unit, after a sync."""

    def __init__(self, modules: Dict[str, torch.nn.Module]):
        self.units: List[Dict[str, torch.cuda.Event]] = []
        self.hooks = []
        for name, m in modules.items():
            self.hooks.append(m.register_forward_pre_hook(
                lambda mod, args, n=name: self.mark(f"{n}.pre")))
            self.hooks.append(m.register_forward_hook(
                lambda mod, args, out, n=name: self.mark(f"{n}.post")))

    def begin(self) -> None:
        self.units.append({})

    def mark(self, name: str) -> None:
        if self.units and name not in self.units[-1]:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.units[-1][name] = ev

    def close(self) -> None:
        for h in self.hooks:
            h.remove()
        torch.cuda.synchronize()

    def ms(self, a: str, b: str) -> List[float]:
        return [u[a].elapsed_time(u[b]) for u in self.units
                if a in u and b in u]


def _ev(e) -> Dict:
    """A kineto event as a dict: name, on the device or not, start and end
    in us."""
    if hasattr(e, "start_ns"):
        start, end = e.start_ns() / 1e3, e.end_ns() / 1e3
    else:
        start = e.start_us()
        end = start + e.duration_us()
    # a range of the host (record_function, the profiler's steps) is also
    # drawn on the device's timeline: it is no device operation
    annotation = (e.is_user_annotation() if hasattr(e, "is_user_annotation")
                  else False) or e.name().startswith("ProfilerStep")
    dev = e.device_type() != torch.autograd.DeviceType.CPU and not annotation
    return {"name": e.name(), "device": dev, "start": start, "end": end}


def profile(fn: Callable[[int], None], units: int) -> Tuple[List[Dict],
                                                            float]:
    """Run fn(i) for i < units + 1 under `torch.profiler` (the first one
    as the profiler's warm-up) and return (its events, the seconds of the
    traced units on the host clock)."""
    import time
    from torch.profiler import ProfilerActivity, schedule
    got = {}

    def ready(p):
        got["events"] = [_ev(e) for e in p.profiler.kineto_results.events()]

    with torch.profiler.profile(
            activities=[ProfilerActivity.CUDA],
            schedule=schedule(wait=0, warmup=1, active=units),
            on_trace_ready=ready) as prof:
        fn(0)
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        for i in range(units):
            fn(i + 1)
            prof.step()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    return got["events"], window_s


def device_events(events: List[Dict]) -> List[Dict]:
    return sorted((e for e in events if e["device"] and e["end"] > e["start"]),
                  key=lambda e: e["start"])


def busy_intervals(dev: List[Dict]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for e in dev:
        if out and e["start"] <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e["end"])
        else:
            out.append([e["start"], e["end"]])
    return [tuple(iv) for iv in out]


def kernel_seconds(dev: List[Dict]) -> Dict[str, float]:
    tot: Dict[str, float] = defaultdict(float)
    for e in dev:
        tot[e["name"]] += (e["end"] - e["start"]) / 1e6
    return dict(tot)


def short_name(kernel: str) -> str:
    """A kernel's name without its return type, namespaces, template
    arguments and parameters."""
    name = kernel.replace("(anonymous namespace)::", "")
    name = name.split("(")[0].split("<")[0].strip()
    return name.split(" ")[-1].split("::")[-1] or kernel[:60]


def summary(events: List[Dict], window_s: float) -> Dict:
    """busy_s, window_s, seconds by device op, and the breakdown: the ten
    device ops that took most time, and the ten largest sums of idle gaps
    by the operation that ended each gap, that is what the host was
    launching while the device waited."""
    dev = device_events(events)
    ivs = busy_intervals(dev)
    busy = sum(b - a for a, b in ivs) / 1e6
    by_op = kernel_seconds(dev)
    first = {}
    for e in dev:
        first.setdefault(e["start"], e)
    sums: Dict[str, float] = defaultdict(float)
    for (_a0, a1), (b0, _b1) in zip(ivs, ivs[1:]):
        sums["before " + short_name(first[b0]["name"])] += (b0 - a1) / 1e6
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(sums.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy, "window_s": window_s, "by_op": by_op,
            "breakdown": {"device_ops": [[k, v] for k, v in top],
                          "idle_gaps": [[k, v] for k, v in idle]}}
