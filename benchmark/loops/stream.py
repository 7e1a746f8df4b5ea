"""The closed sweep stream: one scene in flight, as an online stack takes
the freshest sweep whenever the detector is free.

Set-up makes the weights and the pool of pinned host scenes from the
seed, builds the program's detector and serves a few scenes. The
reference's part of it (its modules, and the forward that calibrates the
BatchNorms' statistics) is timed apart and left out of `setup_s`. The window
then serves the pool in turn for `--seconds`: each scene's pinned points
go to the card, through the detector and `decode_and_nms`, and its
Detections come back to the host; a scene's latency runs from the hand
over of its points to its Detections on the host. A traced run then
serves a stretch with CUDA events at the detector's module boundaries,
and a short stretch under `torch.profiler`.

After the window (and the traced stretches) the program is freed and the
reference recomputes a sample of the window's scenes, drawn from the
seed: their head maps and detections are what `correct` judges.
"""
from __future__ import annotations

import random
import time
from typing import Dict, List

import torch

from .. import bounds, check, scenes, trace, weights
from ..trace import Marks
from ..reference import nets
from ..reference.detect import candidates, nms_frame

WARM_SCENES = 3
# the set-up's parts that the reference spends, which `setup_s` leaves out
REFERENCE_PARTS = ("reference modules", "calibration (reference)")
HOOK_SCENES, PROFILE_SCENES = 24, 8


def _host(det) -> tuple:
    return tuple(t.cpu() for t in det)


def run(cell, system_factory=None) -> Dict:
    """One run of a stream cell. `system_factory(state_dict)` builds the
    system under test (default: the program)."""
    e, mix, dev = cell.experiment, cell.mix, cell.device
    marks = Marks(cell.t_marks or cell.t0)
    marks("config check, loop import")
    ref = nets.build_empty(e, dev)
    marks(REFERENCE_PARTS[0])
    sd = weights.make_state_dict(ref, e, cell.seed, dev)
    marks("weights")
    pool = scenes.make_pool(e, mix, cell.seed, dev, training=False)
    marks("pool")
    weights.calibrate_(ref, sd, pool[0]["points"], pool[0]["points_valid"])
    marks(REFERENCE_PARTS[1])
    cells_per_scene = [s["cells"] for s in pool]
    host = [(s["points"].cpu(), s["points_valid"].cpu()) for s in pool]
    if dev.type == "cuda":
        host = [(p.pin_memory(), v.pin_memory()) for p, v in host]
    del pool
    system = (system_factory or cell.program)(sd)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    marks("program")

    def serve(i: int, events=None):
        pts, valid = host[i % len(host)]
        if events is not None:
            events.begin()
            events.mark("start")
        pts = pts.to(dev, non_blocking=True)
        valid = valid.to(dev, non_blocking=True)
        if events is not None:
            events.mark("fed")
        preds = system.forward(pts, valid)
        if events is not None:
            events.mark("decode.pre")
        det = system.decode(preds)
        if events is not None:
            events.mark("decode.post")
        out = _host(det)
        if events is not None:
            events.mark("end")
        return preds, out

    for i in range(WARM_SCENES):
        serve(i)
    sync()
    marks("warm-up")

    # the window ------------------------------------------------------
    rng = random.Random(cell.seed)
    want = set(rng.sample(range(mix["check"]["sample_from"]),
                          mix["check"]["scenes"]))
    kept: List = []
    lat: List[float] = []
    t_start = time.perf_counter()
    setup_s = t_start - cell.t0 - sum(marks.parts[k] for k in REFERENCE_PARTS)
    n = 0
    while True:
        t0 = time.perf_counter()
        preds, out = serve(n)
        t1 = time.perf_counter()
        lat.append(t1 - t0)
        if n in want:
            kept.append((n % len(host), preds, out))
        n += 1
        if t1 - t_start >= cell.seconds:
            break
    window_s = t1 - t_start
    if len(kept) < len(want):          # a short window: its last scenes
        kept.append(((n - 1) % len(host), preds, out))
    run_rec = {"setup_s": setup_s, "window_s": window_s, "units": n,
               "first_unit": 0, "setup_parts_s": marks.parts,
               "latencies_s": lat, "peaks": cell.peaks,
               "cells_per_scene": cells_per_scene}

    if cell.trace:
        mods = system.children()
        ev = trace.StageEvents(mods)
        for i in range(HOOK_SCENES):
            serve(n + i, ev)
        ev.close()
        st = {"feed": [a + b for a, b in zip(ev.ms("start", "fed"),
                                             ev.ms("decode.post", "end"))],
              "decode_nms": ev.ms("decode.pre", "decode.post")}
        for name in mods:
            st[name] = ev.ms(f"{name}.pre", f"{name}.post")
        if "backbone" in mods:
            st["voxelize"] = ev.ms("fed", "backbone.pre")
        run_rec["stages_ms"] = st
        first = n + HOOK_SCENES
        prof_scenes = [(first + 1 + i) % len(host)
                       for i in range(PROFILE_SCENES)]
        events, traced_s = trace.profile(lambda i: serve(first + i),
                                         PROFILE_SCENES)
        run_rec["trace"] = trace.summary(events, traced_s)
        run_rec["trace"]["units"] = PROFILE_SCENES
    run_rec["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                    if dev.type == "cuda" else 0)
    del system
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the reference -----------------------------------------------------
    ref.load_state_dict(sd)
    ref.eval()
    numbers = {"maps_rel": 0.0, "det_gap": 0.0, "nms_gap": 0.0}
    with torch.no_grad():
        for idx, preds, out in kept:
            pts, valid = (t.to(dev) for t in host[idx])
            rp = ref(pts[None], valid[None])
            numbers["maps_rel"] = max(numbers["maps_rel"],
                                      check.maps_rel(preds, rp))
            got, worst = check.judge_scene(e, out, rp)
            run_rec.setdefault("checked", []).append({
                "pool_scene": idx, "detections": int(out[3].sum()),
                "top_score": float(out[1].max())})
            if got["det_gap"] > numbers["det_gap"]:
                run_rec["worst_detection"] = worst
            for k, v in got.items():
                numbers[k] = max(numbers[k], v)
        if cell.trace:
            run_rec.update(_yardstick(cell, ref, host, prof_scenes))
    run_rec["numbers"] = numbers
    run_rec["scenes_checked"] = len(kept)
    return run_rec


def _yardstick(cell, ref, host, prof_scenes) -> Dict:
    """The reference's count of each pool scene's FLOPs, and the K1 and K2
    bounds of the profiled scenes."""
    e, dev = cell.experiment, cell.device
    pts, valid = (t.to(dev) for t in host[0])
    dense = bounds.dense_flops(ref, pts, valid)
    flops, k2_bound, k1_bound = [], 0.0, 0.0
    convs = {}
    for i, (p, v) in enumerate(host):
        p, v = p.to(dev), v.to(dev)
        convs[i] = bounds.sparse_convs(ref, p, v)
        flops.append(dense + sum(2.0 * c["pairs"] * c["cin"] * c["cout"]
                                 for c in convs[i]))
    nms = e["test"]["nms"]
    for i in prof_scenes:
        k2_bound += sum(bounds.k2_bound_s(c, cell.peaks) for c in convs[i])
        p, v = (t.to(dev) for t in host[i])
        rp = ref(p[None], v[None])
        frames, oks = [], []
        for pd in rp:
            rb, _, top, order = candidates(e, pd)
            frames.append(nms_frame(rb[order]))
            oks.append(torch.isfinite(top))
        k1_bound += bounds.k1_bound_s(torch.stack(frames), torch.stack(oks),
                                      nms["iou_threshold"], cell.peaks)
    return {"flops_per_pool_scene": flops, "k2_bound_s": k2_bound,
            "k1_bound_s": k1_bound}
