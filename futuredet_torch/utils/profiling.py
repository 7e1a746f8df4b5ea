"""Tracing and profiling utilities.

Port of `futuredet_tpu/utils/profiling.py` (the reference's IterTimerHook
and max-memory log column, SURVEY.md §5): a `torch.profiler` trace of the
host and the card, written as a Chrome trace that TensorBoard's profiler
plugin and Perfetto read; the live bytes of each local card; and the
port's spans.

Spans name the port's layers on the host's timeline. `span(name)` (a
`with` block) and `spanned(name)` (a decorator) mark where a layer's
host code runs: the detectors' `forward` and its parts, `decode`,
`train_step` and its phases, the halves of the sparse backward. While
no `Recorder` is on, a span is one check of a module flag: no object is
made and no CUDA event taken. While one is on, each span records its
name, its parent (the span that was open when it opened: on its thread,
or, on a thread with none open, such as autograd's device thread, the
innermost span still open in the same unit), the unit (`unit(u)`, the
scene or step that the caller is running), its thread (the OS id, as the
profiler gives an operator, and `threading.get_ident()`, whose low 32
bits the profiler gives a CUDA runtime call), and its host start and end
in Unix-epoch ns, the clock of `torch.profiler`'s events, so that a
profiled launch falls inside the span that made it. A
`Recorder(cuda_events=True)` also records a CUDA event on the current
stream at each span's entry and exit, and reads the device ms between
them when it stops (the events are kept for reuse: making one costs as
much as recording it). Spans are kept in memory and handed over by
`Recorder.stop`. Spans change no result: they only read clocks.
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import json
import os
import threading
import time
from collections import defaultdict
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

import torch

# any recorder on: spans record. Read without the lock: a span that opens
# while a recorder starts or stops may or may not be recorded
_ON = False
_ACTIVE: Tuple["Recorder", ...] = ()
_LOCK = threading.Lock()
_OPEN: List["_Span"] = []       # open spans of every thread, oldest first
_UNIT = 0
_IDS = itertools.count(1)
# the host track of `trace` puts thread t's spans on row t + this, past
# every Linux thread id (pid_max <= 2**22)
SPAN_TID_OFFSET = 10_000_000


class SpanRecord(NamedTuple):
    id: int
    name: str
    parent: int            # the parent's id; 0 for a root
    unit: int
    thread: int            # OS thread id
    ident: int             # threading.get_ident()
    start_ns: int          # host clock, Unix-epoch ns
    end_ns: int
    device_ms: Optional[float]   # between its CUDA events; None without


def unit(u: int) -> None:
    """Spans opened from now on belong to unit `u` (a scene, a step)."""
    global _UNIT
    _UNIT = u


_OFF = contextlib.nullcontext()


class _Thread(threading.local):
    """A thread's open spans and its ids (the OS id costs a system
    call: read once)."""

    def __init__(self):
        self.stack: List["_Span"] = []
        self.ids = (threading.get_native_id(), threading.get_ident())


_THREAD = _Thread()
_EVENTS: List["torch.cuda.Event"] = []      # timing events free for reuse


def _event() -> "torch.cuda.Event":
    try:
        e = _EVENTS.pop()
    except IndexError:
        e = torch.cuda.Event(enable_timing=True)
    e.record()
    return e


class _Span:
    __slots__ = ("name", "id", "parent", "unit", "start", "events",
                 "recorders")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _THREAD.stack
        self.recorders = _ACTIVE
        with _LOCK:
            self.unit = _UNIT
            self.id = next(_IDS)
            if stack:
                self.parent = stack[-1].id
            else:
                self.parent = next((s.id for s in reversed(_OPEN)
                                    if s.unit == self.unit), 0)
            _OPEN.append(self)
        stack.append(self)
        self.events = None
        if any(r.cuda_events for r in self.recorders):
            self.events = (_event(),)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        if self.events is not None:
            self.events += (_event(),)
        _THREAD.stack.pop()
        rec = (self.id, self.name, self.parent, self.unit) + _THREAD.ids + \
            (self.start, end, self.events)
        with _LOCK:
            _OPEN.remove(self)
            for r in self.recorders:
                if r.on:
                    r._raw.append(rec)
        return False


def span(name: str):
    """A `with` block recorded as the span `name` while a Recorder is on."""
    if not _ON:
        return _OFF
    return _Span(name)


def spanned(name: str):
    """Decorator: each call of the function is the span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _ON:
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


class Recorder:
    """Records every span closed between `start` and `stop` (several may
    be on at once; each gets every span). `stop` returns the spans,
    oldest closed first, with their device ms when `cuda_events`."""

    def __init__(self, cuda_events: bool = False):
        if cuda_events and not torch.cuda.is_available():
            raise ValueError("cuda_events=True needs a CUDA device")
        self.cuda_events = cuda_events
        self.on = False
        self._raw: List[tuple] = []
        self.spans: List[SpanRecord] = []

    def start(self) -> "Recorder":
        global _ACTIVE, _ON
        with _LOCK:
            _ACTIVE = _ACTIVE + (self,)
            _ON = True
            self.on = True
        return self

    def stop(self) -> List[SpanRecord]:
        global _ACTIVE, _ON
        with _LOCK:
            _ACTIVE = tuple(r for r in _ACTIVE if r is not self)
            _ON = bool(_ACTIVE)
            self.on = False
            raw, self._raw = self._raw, []
        if self.cuda_events and raw:
            torch.cuda.synchronize()
        self.spans = [SpanRecord(*r[:8], None if r[8] is None
                                 else r[8][0].elapsed_time(r[8][1]))
                      for r in raw]
        for r in raw:
            if r[8] is not None:
                _EVENTS.extend(r[8])
        return self.spans

    def __enter__(self) -> "Recorder":
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False


def totals(spans: Iterable[SpanRecord]) -> Dict[str, float]:
    """Host seconds by span name."""
    out: Dict[str, float] = defaultdict(float)
    for s in spans:
        out[s.name] += (s.end_ns - s.start_ns) / 1e9
    return dict(out)


def _add_host_track(path: str, spans: List[SpanRecord]) -> None:
    """Append `spans` to the Chrome trace at `path` as one row per thread
    ("spans, thread <id>") of the tracing process."""
    with open(path) as f:
        doc = json.load(f)
    base = doc.get("baseTimeNanoseconds", 0)
    pid = os.getpid()
    events = doc.setdefault("traceEvents", [])
    for t in sorted({s.thread for s in spans}):
        events.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": SPAN_TID_OFFSET + t,
                       "args": {"name": f"spans, thread {t}"}})
    for s in spans:
        events.append({"ph": "X", "cat": "span", "name": s.name,
                       "pid": pid, "tid": SPAN_TID_OFFSET + s.thread,
                       "ts": (s.start_ns - base) / 1e3,
                       "dur": (s.end_ns - s.start_ns) / 1e3,
                       "args": {"unit": s.unit, "id": s.id,
                                "parent": s.parent}})
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a `torch.profiler` trace of the enclosed block (host ops,
    and the card's kernels where CUDA is available), with the port's
    spans as a host track, into `logdir/trace.<pid>.pt.trace.json`, the
    counterpart of `jax.profiler.start_trace(logdir)`."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    rec = Recorder()
    prof.start()
    rec.start()
    try:
        yield
    finally:
        spans = rec.stop()
        prof.stop()
        path = os.path.join(logdir, f"trace.{os.getpid()}.pt.trace.json")
        prof.export_chrome_trace(path)
        _add_host_track(path, spans)


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
