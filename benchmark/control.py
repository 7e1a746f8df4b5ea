"""The control of `correct`, and the readings its limits are set from.

    python3 benchmark/control.py --workload <name> --seeds 1,2,3 \\
        --seconds <s> --side control|program

`--side control` puts the plain reference in the program's place,
computed in the precision next below the configuration's (TF32 for fp32
with TF32 off: every matmul and conv on the tensor cores' TF32 path), and
runs the cell as a run does: its window, its sample, its comparison with
the fp32 reference. Its numbers must come out over the limits: they give
each limit's upper reading. `--side program` runs the program the same
way on each seed, in one process: the lower readings. `--side
reference` puts the fp32 reference in the program's place: how far two
runs of the reference itself lie apart. One JSON line a seed. The
benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path
from typing import Dict

import torch

ROOT = Path(__file__).resolve().parent.parent


@contextlib.contextmanager
def tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def greedy_nms(experiment: Dict, preds):
    """Detections of the reference's maps by plain greedy rotated NMS: per
    head the top `pre_max` candidates, survivors in score order, at most
    `post_max` (the program's `decode_and_nms`, plainly)."""
    from benchmark.reference.detect import candidates, iou_bev, nms_frame
    t = experiment["test"]
    post = t["nms"]["post_max_size"]
    B, S, L, V = [], [], [], []
    for task, pd in enumerate(preds):
        rb, rs, top, order = candidates(experiment, pd)
        frame = nms_frame(rb[order])
        kills = iou_bev(frame, frame) > t["nms"]["iou_threshold"]
        alive = torch.isfinite(top)
        for i in range(len(order)):
            if alive[i]:
                alive[i + 1:] &= ~kills[i, i + 1:]
        sel = order[alive][:post]
        n = len(sel)
        boxes = torch.zeros(post, 9, device=rb.device)
        boxes[:n] = rb[sel]
        scores = torch.zeros(post, device=rb.device)
        scores[:n] = rs[sel]
        valid = torch.zeros(post, dtype=torch.bool, device=rb.device)
        valid[:n] = True
        B.append(boxes)
        S.append(scores)
        L.append(torch.full((post,), task, device=rb.device))
        V.append(valid)
    return tuple(torch.cat(x)[None] for x in (B, S, L, V))


class Control:
    """The reference in the program's place, under TF32 (or, with
    `lower=False`, in fp32: the reference against itself, whose readings
    are the rounding of its own nondeterministic sums)."""

    def __init__(self, cell, state_dict, training: bool, lower: bool = True):
        from benchmark.reference import nets
        from benchmark.reference import train as ref_train
        self.cell = cell
        self.precision = tf32 if lower else contextlib.nullcontext
        self.model = nets.build_empty(cell.experiment, cell.device)
        self.model.load_state_dict(state_dict)
        self.model.train(training)
        self.optimizer = (ref_train.make_optimizer(cell.experiment,
                                                   self.model)
                          if training else None)

    @torch.no_grad()
    def forward(self, points, valid):
        with self.precision():
            return self.model(points[None], valid[None])

    @torch.no_grad()
    def decode(self, preds):
        return greedy_nms(self.cell.experiment, preds)

    def step(self, batch, count):
        from benchmark.reference import train as ref_train
        with self.precision():
            return ref_train.step(self.cell.experiment, self.model,
                                  self.optimizer, batch, count,
                                  self.cell.mix["total_steps"])

    def first_moments(self):
        return {n: self.optimizer.state[p]["exp_avg"]
                for n, p in self.model.named_parameters()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--side", choices=("control", "program", "reference"),
                   default="control")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark import harness
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        cell = harness.make_cell(ROOT, args.workload, seed, args.seconds,
                                 False, "cuda", time.perf_counter())
        factory = None
        if args.side != "program":
            training = cell.mix["loop"] == "train"
            lower = args.side == "control"

            def factory(sd, cell=cell, training=training, lower=lower):
                return Control(cell, sd, training, lower)
        rec = harness.run_cell(cell, factory)
        print(json.dumps({"workload": args.workload, "side": args.side,
                          "seed": seed, "numbers": rec["numbers"],
                          "correct": rec["correct"],
                          "units": rec["units"]}), flush=True)
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
