"""futuredet_torch's spans (`utils/profiling.py`): nesting, parents and
units on one thread and across threads, nothing recorded while off, the
profiler's clock, the spans of a tiny VoxelNet and pillar forward, decode
and train step (the sparse backward's halves under `train.backward`),
outputs bit for bit the same with spans on and off, and the trainer's log
line read from its span totals."""
import dataclasses
import re
import sys
import threading

import pytest
import torch

from futuredet_torch.config import get_config, tiny_variant
from futuredet_torch.data.synthetic import make_batch
from futuredet_torch.eval.decode import decode_and_nms
from futuredet_torch.models.detector import build_detector
from futuredet_torch.train.step import make_optimizer, train_step
from futuredet_torch.train.trainer import train
from futuredet_torch.utils import profiling
from futuredet_torch.utils.profiling import Recorder, span, spanned, unit


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def parents(spans):
    ids = {s.id: s.name for s in spans}
    return {(s.name, ids.get(s.parent)) for s in spans}


def test_spans_nest_by_thread_and_by_unit():
    def worker():
        with span("c"):
            with span("d"):
                pass

    with Recorder() as rec:
        unit(3)
        with span("a"):
            with span("b"):
                pass
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=30)
        unit(4)
        with span("e"):
            pass
    assert not t.is_alive()
    s = {k: v[0] for k, v in by_name(rec.spans).items()}
    assert s["b"].parent == s["a"].id and s["a"].parent == 0
    # a thread with no span open: the innermost span open in its unit
    assert s["c"].parent == s["a"].id and s["d"].parent == s["c"].id
    assert s["c"].thread == t.native_id != s["a"].thread
    assert {k: v.unit for k, v in s.items()} == {"a": 3, "b": 3, "c": 3,
                                                 "d": 3, "e": 4}
    assert s["e"].parent == 0
    assert s["a"].start_ns <= s["b"].start_ns <= s["b"].end_ns <= \
        s["a"].end_ns
    assert all(v.device_ms is None for v in s.values())
    assert profiling._OPEN == []


def test_spans_of_many_threads_keep_their_parents():
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def worker(k):
            for _ in range(200):
                with span(f"outer{k}"):
                    with span(f"inner{k}"):
                        pass

        with Recorder() as rec:
            threads = [threading.Thread(target=worker, args=(k,))
                       for k in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert len(rec.spans) == 16 * 2 * 200
    ids = {s.id: s for s in rec.spans}
    assert len(ids) == len(rec.spans)
    for s in rec.spans:
        if s.name.startswith("inner"):
            p = ids[s.parent]
            assert p.name == "outer" + s.name[5:] and p.thread == s.thread
    assert profiling._OPEN == []


def test_nothing_is_recorded_while_off():
    assert not profiling._ON
    # off: one shared object, no span made
    assert span("x") is span("y")
    calls = []
    f = spanned("f")(lambda v: calls.append(v) or v)
    with span("before"):
        assert f(1) == 1
    rec = Recorder().start()
    with span("during"):
        assert f(2) == 2
    rec.stop()
    with span("after"):
        f(3)
    assert not profiling._ON and rec._raw == []
    assert calls == [1, 2, 3]
    assert [s.name for s in rec.spans] == ["f", "during"]


def test_a_span_encloses_the_profilers_event_of_its_work():
    """The spans' host clock is the profiler's: a span around a matmul
    holds the profiler's `aten::mm` event."""
    from torch.profiler import ProfilerActivity, profile
    a = torch.randn(128, 128)
    with profile(activities=[ProfilerActivity.CPU]) as prof, \
            Recorder() as rec:
        with span("mm"):
            torch.mm(a, a)
    mm = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "aten::mm"]
    assert len(mm) == 1 and len(rec.spans) == 1
    s = rec.spans[0]
    assert s.start_ns <= mm[0].start_ns() <= mm[0].end_ns() <= s.end_ns
    # and the clock is not perf_counter's: the same epoch as time.time_ns
    assert abs(mm[0].start_ns() - s.start_ns) < 10 ** 9


VOXELNET = {"forward", "voxelize", "middle", "middle.tables", "z_crush",
            "neck", "head", "decode", "decode.nms"}


@pytest.mark.parametrize("name,want", [
    ("forecast_n3dtf", VOXELNET),
    ("pp_forecast_n3dtf", {"forward", "reader", "neck", "head", "decode",
                           "decode.nms"})])
def test_a_scene_gives_its_layers_spans_and_the_same_bits(one_thread, name,
                                                           want):
    cfg = tiny_variant(get_config(name))
    model = build_detector(cfg, "cpu")
    b = make_batch(cfg, 1, seed=3, n_objects=6, n_clutter=300)

    def scene():
        with torch.no_grad():
            preds = model(b["points"], b["points_valid"])
            return preds, decode_and_nms(cfg, preds)

    off = scene()
    with Recorder() as rec:
        unit(5)
        on = scene()
    for p, q in zip(off[0], on[0]):
        assert p.keys() == q.keys()
        assert all(torch.equal(p[k], q[k]) for k in p)
    assert all(torch.equal(x, y) for x, y in zip(off[1], on[1]))
    assert {s.name for s in rec.spans} == want
    assert {s.unit for s in rec.spans} == {5}
    rel = parents(rec.spans)
    assert ("forward", None) in rel and ("decode", None) in rel
    assert ("decode.nms", "decode") in rel
    for layer in want - {"forward", "decode", "decode.nms", "middle.tables"}:
        assert (layer, "forward") in rel
    if "middle" in want:
        # the first stage's grid and table, three strided stages' sites,
        # tables and neighbour tables, the dense scatter
        assert len(by_name(rec.spans)["middle.tables"]) == 9
        assert {p for n, p in rel if n == "middle.tables"} == {"middle"}


def test_a_step_splits_the_sparse_backward_under_train_backward(one_thread):
    cfg = tiny_variant(get_config("forecast_n3dtf"))
    b = make_batch(cfg, 1, seed=4, n_objects=6, n_clutter=300)

    def step(recorder=None):
        model = build_detector(cfg, "cpu").train()
        opt = make_optimizer(cfg, model, 10)
        if recorder is None:
            out = train_step(model, opt, b, 0)
        else:
            with recorder:
                unit(0)
                out = train_step(model, opt, b, 0)
        return out, model

    (off, m_off), rec = step(), Recorder()
    on, m_on = step(rec)
    assert all(torch.equal(off[k], on[k]) for k in off)
    for (k, p), q in zip(m_off.state_dict().items(),
                         m_on.state_dict().values()):
        assert torch.equal(p, q), k
    n = by_name(rec.spans)
    # 20 sparse convs, each with a weight gradient; all but the first
    # (the voxel features take none) with an input gradient
    assert len(n["sparse.dw"]) == 20 and len(n["sparse.dx"]) == 19
    rel = parents(rec.spans)
    assert {p for c, p in rel if c.startswith("sparse.")} == \
        {"train.backward"}
    assert {c for c, p in rel if p == "train_step"} == {
        "train.targets", "train.forward", "train.loss", "train.backward",
        "train.update"}
    assert ("forward", "train.forward") in rel and \
        ("train_step", None) in rel


def test_the_trainers_log_line_reads_its_span_totals(one_thread):
    cfg = tiny_variant(get_config("pp_forecast_n3dtf"))
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, total_epochs=1,
                                                log_interval=2))
    batch = make_batch(cfg, 1, seed=1, n_objects=4, n_clutter=200)
    batch.pop("gt")
    lines = []
    with Recorder() as outer:
        train(cfg, iter([batch] * 4), steps_per_epoch=4, device="cpu",
              prefetch_depth=0, log_fn=lines.append)
    assert len(lines) == 2
    got = [re.fullmatch(r"step (\d)/4 loss \S+ data (\S+)s step (\S+)s "
                        r"\((\S+)s/it\)", line) for line in lines]
    assert all(got), lines
    spans = by_name(outer.spans)
    assert [s.unit for s in spans["step"]] == [0, 1, 2, 3]
    for i, m in enumerate(got):
        window = [s for s in outer.spans if s.unit in (2 * i, 2 * i + 1)]
        t = profiling.totals(window)
        assert m.group(2) == f"{t['data']:.2f}"
        assert m.group(3) == f"{t['step']:.2f}"
    assert {p for c, p in parents(outer.spans)
            if c == "train_step"} == {"step"}
    assert not profiling._ON
