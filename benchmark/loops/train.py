"""Training steps of B = 1 on one card, as the reference deployment trains
(bs 1 a GPU).

Set-up makes the weights and a pool of batches (pinned host tensors:
points and GT at the config's timesteps) from the seed, builds the
program's detector in train mode with `make_optimizer`, and drives that
same object through its first steps with the window's own call and
feed, each on another batch: those steps are the warm-up, and what they
give (each step's loss, AdamW's first moment after the first step, the
parameters after the third) is what `correct` judges. The window then
goes on stepping the same object, a batch from the pool a step: the
batch goes to the card, `train_step` runs, its losses come back to the
host. The reference's modules, built first for the weights' shapes, are
timed apart and left out of `setup_s`. A traced run adds a stretch with CUDA events at the detector's
module boundaries and a short `torch.profiler` stretch.

After that the program is freed and the reference takes the same first
steps from the same weights and batches.
"""
from __future__ import annotations

import time
from typing import Dict, List

import torch

from .. import bounds, check, scenes, trace, weights
from ..trace import Marks
from ..reference import nets
from ..reference import train as ref_train

HOOK_STEPS, PROFILE_STEPS = 8, 4
# the set-up's part that the reference spends, which `setup_s` leaves out
REFERENCE_PART = "reference modules"


def _to(batch: Dict, dev) -> Dict:
    return {"points": batch["points"].to(dev, non_blocking=True),
            "points_valid": batch["points_valid"].to(dev, non_blocking=True),
            "targets_raw": {k: v.to(dev, non_blocking=True)
                            for k, v in batch["targets_raw"].items()}}


def run(cell, system_factory=None) -> Dict:
    e, mix, dev = cell.experiment, cell.mix, cell.device
    total = mix["total_steps"]
    marks = Marks(cell.t_marks or cell.t0)
    marks("config check, loop import")
    ref = nets.build_empty(e, dev)
    marks(REFERENCE_PART)
    sd = weights.make_state_dict(ref, e, cell.seed, dev)
    marks("weights")
    pool = scenes.make_pool(e, mix, cell.seed, dev, training=True)
    marks("pool")
    cells_per_scene = [s["cells"] for s in pool]
    host = []
    for s in pool:
        b = {"points": s["points"][None], "points_valid":
             s["points_valid"][None],
             "targets_raw": {k: v[None] for k, v in s["gt"].items()}}
        b = {"points": b["points"].cpu(), "points_valid":
             b["points_valid"].cpu(),
             "targets_raw": {k: v.cpu() for k, v in b["targets_raw"].items()}}
        if dev.type == "cuda":
            b = {"points": b["points"].pin_memory(),
                 "points_valid": b["points_valid"].pin_memory(),
                 "targets_raw": {k: v.pin_memory()
                                 for k, v in b["targets_raw"].items()}}
        host.append(b)
    del pool
    system = (system_factory or cell.program)(sd)
    marks("program")

    def step(count: int, events=None) -> List[float]:
        if events is not None:
            events.begin()
            events.mark("start")
        losses = system.step(_to(host[count % len(host)], dev), count)
        out = [float(v) for v in torch.stack(
            [losses["loss"], losses["grad_norm"]]).cpu()]
        if events is not None:
            events.mark("end")
        return out

    # the first steps: warm-up, and what the reference follows
    n_check = mix["check"]["steps"]
    first = {"losses": []}
    for count in range(n_check):
        first["losses"].append(step(count)[0])
        if count == 0:
            b1 = system.optimizer.param_groups[0]["betas"][0]
            first["grads"] = {k: v.detach() / (1 - b1)
                              for k, v in system.first_moments().items()}
    marks("first steps")
    params = dict(system.model.named_parameters())
    first["updates"] = {k: (p.detach() - sd[k]).clone()
                        for k, p in params.items()}

    # the window ------------------------------------------------------
    t_start = time.perf_counter()
    setup_s = t_start - cell.t0 - marks.parts[REFERENCE_PART]
    count = n_check
    while True:
        step(count)
        count += 1
        t1 = time.perf_counter()
        if t1 - t_start >= cell.seconds:
            break
    run_rec = {"setup_s": setup_s, "window_s": t1 - t_start,
               "units": count - n_check, "first_unit": n_check,
               "setup_parts_s": marks.parts,
               "peaks": cell.peaks,
               "cells_per_scene": cells_per_scene}

    if cell.trace:
        mods = {"bbox_head": system.children()["bbox_head"]}
        ev = trace.StageEvents(mods)
        for i in range(HOOK_STEPS):
            step(count + i, ev)
        ev.close()
        run_rec["stages_ms"] = {
            "forward": ev.ms("start", "bbox_head.post"),
            "backward_update": ev.ms("bbox_head.post", "end")}
        count += HOOK_STEPS
        prof_scenes = [(count + 1 + i) % len(host)
                       for i in range(PROFILE_STEPS)]
        events, traced_s = trace.profile(lambda i: step(count + i),
                                         PROFILE_STEPS)
        run_rec["trace"] = trace.summary(events, traced_s)
        run_rec["trace"]["units"] = PROFILE_STEPS
    run_rec["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                    if dev.type == "cuda" else 0)
    del system, params
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the reference -----------------------------------------------------
    ref.load_state_dict(sd)
    ref.train()
    opt = ref_train.make_optimizer(e, ref)
    want = {"losses": []}
    for count in range(n_check):
        b = _to(host[count], dev)
        want["losses"].append(float(ref_train.step(e, ref, opt, b, count,
                                                   total)["loss"]))
        if count == 0:
            _, b1 = ref_train.one_cycle(e["train"]["optim"], 0, total)
            want["grads"] = {n: opt.state[p]["exp_avg"] / (1 - b1)
                             for n, p in ref.named_parameters()}
    want["updates"] = {n: p.detach() - sd[n]
                       for n, p in ref.named_parameters()}
    run_rec["numbers"] = check.train_numbers(first, want)
    run_rec["first_steps"] = check.train_detail(first, want)
    if cell.trace:
        run_rec.update(_yardstick(cell, ref, host, prof_scenes))
    return run_rec


def _yardstick(cell, ref, host, prof_scenes) -> Dict:
    """The reference's FLOP count of a step on each pool batch (forward,
    input gradients but for the first layer's, weight gradients), and the
    K2 bound of the profiled steps (forward and input gradients)."""
    dev = cell.device
    ref.train()
    b0 = host[0]
    with torch.no_grad():
        dense = bounds.dense_flops(ref, b0["points"][0].to(dev),
                                   b0["points_valid"][0].to(dev))
    flops, convs = [], {}
    for i, b in enumerate(host):
        convs[i] = bounds.sparse_convs(ref, b["points"][0].to(dev),
                                       b["points_valid"][0].to(dev))
        sparse = [2.0 * c["pairs"] * c["cin"] * c["cout"] for c in convs[i]]
        # the first layer takes no input gradient
        flops.append(3 * (dense + sum(sparse)) - (sparse[0] if sparse
                                                 else 0.0))
    k2 = 0.0
    for i in prof_scenes:
        k2 += sum(bounds.k2_bound_s(c, cell.peaks) for c in convs[i])
        k2 += sum(bounds.k2_bound_s(c, cell.peaks, backward=True)
                  for c in convs[i][1:])
    return {"flops_per_pool_scene": flops, "k2_bound_s": k2}
