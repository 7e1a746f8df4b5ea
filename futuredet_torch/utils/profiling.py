"""Tracing and profiling utilities.

Port of `futuredet_tpu/utils/profiling.py` (the reference's IterTimerHook
and max-memory log column, SURVEY.md §5): a `torch.profiler` trace of the
host and the card, written as a Chrome trace that TensorBoard's profiler
plugin and Perfetto read; the live bytes of each local card; and the
data/compute step timer.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a `torch.profiler` trace of the enclosed block (host ops,
    and the card's kernels where CUDA is available) into
    `logdir/trace.<pid>.pt.trace.json`, the counterpart of
    `jax.profiler.start_trace(logdir)`."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(logdir, f"trace.{os.getpid()}.pt.trace.json"))


def device_memory_stats() -> Dict[str, int]:
    """Live bytes per local card (the reference's max-GPU-memory log
    column, TextLoggerHook:24-31), under the JAX key `bytes_in_use`'s
    meaning: `allocated_bytes.all.current` of the caching allocator. Empty
    where no card is present, as the JAX function is on a device without
    memory statistics."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        if stats:
            out[f"cuda:{i}"] = stats.get("allocated_bytes.all.current", 0)
    return out


class StepTimer:
    """data/compute wall-time accumulator (ref IterTimerHook:6-24)."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self._t0: Optional[float] = None
        self._key: Optional[str] = None

    @contextlib.contextmanager
    def phase(self, key: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[key] = (self.totals.get(key, 0.0)
                                + time.perf_counter() - t0)

    def summary_and_reset(self) -> Dict[str, float]:
        out, self.totals = self.totals, {}
        return out
