"""Arithmetic that the metric readers (`metrics/`) share: medians of stage
times, device seconds of a kernel family, FLOPs over a window."""
from __future__ import annotations

import re
import statistics
from typing import Dict, Iterable, Optional


def stage_ms(rec: Dict, loop: str, stage: str) -> Optional[float]:
    """The median device ms a unit of `stage` (CUDA events of the traced
    run), None where the run has none."""
    if rec.get("loop") != loop:
        return None
    ms = rec.get("stages_ms", {}).get(stage)
    return statistics.median(ms) if ms else None


def kernel_s(rec: Dict, names: Iterable[str]) -> float:
    """Device seconds of the traced stretch in kernels named `names`."""
    pat = re.compile(r"\b(" + "|".join(names) + r")\b")
    return sum(s for k, s in rec.get("trace", {}).get("by_op", {}).items()
               if pat.search(k))


def share(part: float, whole: float) -> Optional[float]:
    """100 * part / whole, None where either is 0 (nothing to read)."""
    return 100.0 * part / whole if part > 0 and whole > 0 else None


def window_flops(rec: Dict) -> float:
    """The reference's FLOP count of every unit of the window (the pool
    served in turn from `first_unit`)."""
    f = rec.get("flops_per_pool_scene")
    if not f:
        return 0.0
    return sum(f[(rec["first_unit"] + u) % len(f)]
               for u in range(rec["units"]))


def mfu(rec: Dict, loop: str) -> Optional[float]:
    if rec.get("loop") != loop:
        return None
    return share(window_flops(rec),
                 rec["window_s"] * rec["peaks"]["matmul_flops_per_s"])


def idle(rec: Dict, loop: str) -> Optional[float]:
    """The share of a unit's wall time (the untraced window's) in which no
    operation ran on the device (the profiled stretch's busy seconds a
    unit). The profiled stretch's own wall time is no base: the profiler
    slows the host's launches several times over."""
    t = rec.get("trace")
    if rec.get("loop") != loop or not t or not t["busy_s"]:
        return None
    busy = t["busy_s"] / t["units"]
    wall = rec["window_s"] / rec["units"]
    return 100.0 * (1.0 - busy / wall)


def peak_mib(rec: Dict, loop: str) -> Optional[float]:
    if rec.get("loop") != loop or not rec.get("memory_peak_bytes"):
        return None
    return rec["memory_peak_bytes"] / 2 ** 20
