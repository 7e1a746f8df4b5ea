"""The span join (`spans.py`) on made-up profiler events, the span
metrics' readers, and, on a card, that every K1 and K2 launch of a
profiled stretch falls in its layer's span (the program's spans and the
profiler's events on one clock)."""
from __future__ import annotations

import pytest

from conftest import STREAMS, TRAIN, tiny_cell


def _span(i, name, parent, start, end, thread=1, unit=0, device_ms=None):
    # a pthread id whose low 32 bits read negative as a signed int
    return {"id": i, "name": name, "parent": parent, "unit": unit,
            "thread": 100 + thread, "ident": (7 << 32) + (1 << 31) + thread,
            "start_ns": start, "end_ns": end, "device_ms": device_ms}


def _call(name, t, corr, tid=1):
    # a CUDA runtime call's thread: the low 32 bits of the pthread id
    return {"name": name, "device": False, "start": t, "end": t + 1,
            "corr": corr, "tid": -(1 << 31) + tid}


def _op(name, a, b, corr):
    return {"name": name, "device": True, "start": a, "end": b,
            "corr": corr, "tid": None}


SPANS = [_span(1, "forward", 0, 0, 100), _span(2, "middle", 1, 10, 50),
         _span(3, "middle.tables", 2, 12, 20),
         _span(4, "decode", 0, 110, 150), _span(5, "decode.nms", 4, 120, 140),
         _span(6, "train.backward", 0, 200, 300),
         # autograd's device thread: a child of train.backward by its unit
         _span(7, "sparse.dx", 6, 210, 220, thread=2)]
EVENTS = [
    _call("cudaLaunchKernel", 15, 1), _op("table_kernel", 1000, 1010, 1),
    _call("cudaStreamSynchronize", 16, 90),
    _call("cudaLaunchKernel", 30, 2), _op("wide_kernel", 1010, 1040, 2),
    _call("cudaMemcpyAsync", 31, 3), _op("Memcpy HtoD", 1030, 1050, 3),
    _call("cudaLaunchKernel", 130, 4), _op("nms_pair_kernel", 2000, 2004, 4),
    # on the device thread, before any span opens there: the innermost
    # span open on any thread
    _call("cuLaunchKernel", 205, 5, tid=2), _op("dgrad", 3000, 3020, 5),
    _call("cudaLaunchKernel", 215, 6, tid=2), _op("wide_kernel", 3020, 3030,
                                                  6),
    _call("cudaStreamSynchronize", 216, 91, tid=2),
    # the loop's copy, in no span
    _call("cudaMemcpyAsync", 400, 7), _op("Memcpy DtoH", 4000, 4001, 7),
    _call("cudaStreamSynchronize", 401, 92),
    _call("cudaEventRecord", 402, 93),
]


def test_join_puts_each_launch_and_sync_in_its_innermost_span():
    from benchmark import spans
    got = spans.join(SPANS, EVENTS, units=2)
    by = got["by_span"]
    # every count and ms is a unit's: 2 units
    assert by["middle.tables"] == {"launches": 0.5, "syncs": 0.5,
                                   "busy_ms": pytest.approx(10e-6 / 2)}
    # middle holds its tables' launch and sync, and its own kernel and copy:
    # busy from 1000 to 1050
    assert by["middle"]["launches"] == 1.5 and by["middle"]["syncs"] == 0.5
    assert by["middle"]["busy_ms"] == pytest.approx(50e-6 / 2)
    assert by["forward"] == by["middle"]
    assert by["decode.nms"]["launches"] == 0.5
    assert by["train.backward"]["launches"] == 1.0
    assert by["train.backward"]["syncs"] == 0.5
    assert by["sparse.dx"] == {"launches": 0.5, "syncs": 0.5,
                               "busy_ms": pytest.approx(10e-6 / 2)}
    assert got["roots"]["launches"] == 3.0 and got["roots"]["syncs"] == 1.0
    assert got["outside"] == {"launches": 0.5, "syncs": 0.5,
                              "busy_ms": pytest.approx(1e-6 / 2)}
    assert got["kernels"]["wide_kernel"] == {
        "forward/middle": 1, "train.backward/sparse.dx": 1}
    assert got["kernels"]["dgrad"] == {"train.backward": 1}
    assert got["kernels"]["nms_pair_kernel"] == {"decode/decode.nms": 1}
    assert got["kernels"]["Memcpy DtoH"] == {"": 1}
    assert got["found"] == {"thread": 7, "any": 1, "none": 2}
    assert got["runtime"]["cudaEventRecord"] == 0.5
    # a call that carries the OS thread id finds its thread's span too
    os_id = [dict(c, tid=101) if c["start"] == 15 else c for c in EVENTS]
    assert spans.join(SPANS, os_id, 2)["found"] == got["found"]


def test_idle_is_the_events_ms_less_the_busy_ms():
    from benchmark import spans
    # three units; unit 1 has two middle spans, unit 2 one slow one
    a = [_span(1, "middle", 0, 0, 1, unit=0, device_ms=3.0),
         _span(2, "middle", 0, 2, 3, unit=1, device_ms=1.0),
         _span(3, "middle", 0, 3, 4, unit=1, device_ms=3.0),
         _span(4, "middle", 0, 5, 6, unit=2, device_ms=50.0),
         _span(5, "head", 0, 7, 8, unit=0, device_ms=1.0)]
    joined = {"by_span": {"middle": {"launches": 4.0, "syncs": 1.0,
                                     "busy_ms": 1.5}}}
    got = spans.combine(a, 3, joined)["by_span"]
    # the median unit's device ms: 3, 4, 50 -> 4
    assert got["middle"] == {"launches": 4.0, "syncs": 1.0, "busy_ms": 1.5,
                             "spans": 4 / 3, "device_ms": 4.0,
                             "idle_ms": 2.5}
    # a span that launched nothing: all of its device time is idle
    assert got["head"]["idle_ms"] == 1.0 and got["head"]["launches"] == 0.0


def _record(loop):
    by = {n: {"launches": 3.0, "syncs": 2.0, "busy_ms": 4.0, "spans": 1.0,
              "device_ms": 5.0, "idle_ms": 1.0}
          for n in ("middle", "middle.tables", "head", "decode",
                    "sparse.dx", "sparse.dw", "train.backward")}
    return {"loop": loop, "spans": {"by_span": by, "roots": {
        "launches": 30.0, "syncs": 7.0, "busy_ms": 9.0}}}


@pytest.mark.parametrize("name", ["infer.middle_tables_ms",
                                  "infer.middle_idle_ms", "infer.head_idle_ms",
                                  "infer.decode_idle_ms", "infer.syncs",
                                  "infer.launches", "train.dx_ms",
                                  "train.dw_ms", "train.backward_idle_ms",
                                  "train.syncs", "train.launches"])
def test_span_readers(name):
    from benchmark import harness, spans
    assert name in spans.METRICS
    read = harness.reader(name)
    loop = "stream" if name.startswith("infer.") else "train"
    # a record without spans (a program without the recorder): nothing
    assert read({"loop": loop}) is None
    assert read({"loop": loop, "spans": None}) is None
    assert read(_record("train" if loop == "stream" else "stream")) is None
    want = {"middle_tables_ms": 4.0, "dx_ms": 4.0, "dw_ms": 4.0,
            "syncs": 7.0, "launches": 30.0}.get(name.split(".")[1], 1.0)
    assert read(_record(loop)) == want


def test_measure_gives_nothing_without_the_recorder(monkeypatch):
    from benchmark import spans
    import futuredet_torch.utils.profiling as profiling
    monkeypatch.delattr(profiling, "Recorder")
    assert spans.measure(lambda i: None) is None


@pytest.mark.cuda
@pytest.mark.parametrize("config,workload", STREAMS + [TRAIN])
def test_k1_and_k2_launch_inside_their_spans(card, config, workload):
    """A tiny cell on the card: every K2 launch inside `middle` (a scene)
    or inside `train.forward` or `sparse.dx` (a step), every K1 launch
    inside `decode.nms`."""
    from benchmark import harness, spans
    from benchmark.system import K1_KERNELS, K2_KERNELS
    traffic = "train_b1" if workload == TRAIN[1] else "sweep_stream"
    cell = tiny_cell(config, traffic, workload)
    cell.device = card
    harness.set_precision(cell.config)
    cell.program = harness.program_factory(cell)
    fn = spans.cell_unit(cell)
    for i in range(2):
        fn(i)
    rec = spans.measure(fn, units_a=4, units_b=2)
    paths = {}
    for kernel, by_path in rec["kernels"].items():
        for fam, names in (("K1", K1_KERNELS), ("K2", K2_KERNELS)):
            if any(n in kernel for n in names):
                for path, count in by_path.items():
                    paths.setdefault(fam, {}).setdefault(path, 0)
                    paths[fam][path] += count
    k2 = paths.get("K2", {})
    if config == "pp_forecast_n3dtf":
        assert not k2
    elif traffic == "train_b1":
        assert k2 and all(p.startswith("train_step/train.forward/")
                          and p.endswith("/middle")
                          or p == "train_step/train.backward/sparse.dx"
                          for p in k2), k2
        assert any(p.endswith("sparse.dx") for p in k2), k2
    else:
        assert k2 and set(k2) == {"forward/middle"}, k2
    k1 = paths.get("K1", {})
    if traffic == "train_b1":
        assert not k1
    else:
        assert set(k1) == {"decode/decode.nms"}, k1
