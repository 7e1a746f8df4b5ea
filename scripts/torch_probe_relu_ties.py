#!/usr/bin/env python3
"""The ReLU decisions of chip_smoke.py's card-against-CPU train step
(phase 15) on one NVIDIA GPU: where the card's fp32 step takes the sign of
a ReLU input otherwise than the float64 CPU step, and what that does to
the gradient check.

    python3 scripts/torch_probe_relu_ties.py [--model NAME] [--runs N]

One float64 CPU step (phase 15's weights, BatchNorm biases raised by
BN_BIAS_SHIFT, scene and batch), then N card steps on the same inputs.
For each card step it prints the ReLU layers whose decisions differ from
the reference's at an element that carries gradient (count, and the
largest |x| / max |x| of the reference's input there), the largest
card-against-reference error of a ReLU input (of the layer's max), and
the worst gradient ratios (`chip_smoke.grad_ratios`) against the plain
reference. Last, the reference again with the last card step's decisions
replayed (`chip_smoke.ReluDecisions`, as phase 15 now holds the card),
and the last card step's ratios against it. The card's name and power
limit come first. TF32 off.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def step(cfg, device, dtype, relus=None, record=False):
    """One forward_backward of phase 15's model and batch: (the gradients
    in float64 on the host, each ReLU module's input and its output's
    gradient, on the host)."""
    from futuredet_torch.models.detector import build_detector
    from futuredet_torch.train.step import forward_backward
    xs, gs = {}, {}
    m = build_detector(cfg, device=device, seed=0).train()
    cs.shift_bn_biases(m)
    if relus is not None:
        (relus.record if record else relus.replay)(m)
    handles = []
    for name, mod in m.named_modules():
        if isinstance(mod, torch.nn.ReLU):
            def keep(mod, inp, out, name=name):
                xs[name] = inp[0].detach()
                out.register_hook(
                    lambda g, name=name: gs.__setitem__(name, g.detach()))
            handles.append(mod.register_forward_hook(keep))
    b = cs.train_batch(cfg, cs.TRAIN_SEED, device, cs.PILLAR_TRAIN_CLUTTER)
    if dtype == torch.float64:
        m = m.double()
        b = dict(b, points=b["points"].double())
    forward_backward(m, b)
    for h in handles:
        h.remove()
    if relus is not None:
        relus.remove()
    grads = {n: cs.grad_of(p).cpu() for n, p in m.named_parameters()}
    return (grads, {n: x.cpu().double() for n, x in xs.items()},
            {n: g.cpu() for n, g in gs.items()})


def worst(ratios, k=4):
    real = [(n, r) for n, r in ratios.items() if r is not None]
    return sorted(real, key=lambda kv: -kv[1])[:k]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default=cs.NAME)
    ap.add_argument("--runs", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_probe_relu_ties: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from futuredet_torch.config import get_config
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(json.dumps({"card": cs.card_line(), "model": args.model}),
          flush=True)
    cfg = get_config(args.model)
    cfg = cfg.replace(voxel=dataclasses.replace(cfg.voxel,
                                                max_points=cs.MAX_POINTS))
    t0 = time.perf_counter()
    want, x64, g64 = step(cfg, "cpu", torch.float64)
    ref_s = time.perf_counter() - t0
    dev = torch.device("cuda")
    for run in range(args.runs):
        relus = cs.ReluDecisions()
        grads, xc, _ = step(cfg, dev, torch.float32, relus, record=True)
        live, err = [], 0.0
        for name, a in x64.items():
            top = float(a.abs().max())
            err = max(err, float((xc[name] - a).abs().max()) / top)
            differ = ((a > 0) != (xc[name] > 0)) & (g64[name] != 0)
            if bool(differ.any()):
                live.append({"layer": name, "count": int(differ.sum()),
                             "margin": float(a.abs()[differ].max()) / top})
        ratios = cs.grad_ratios(grads, want)
        print(json.dumps({
            "run": run, "reference_s": round(ref_s, 3),
            "relu_flips_carrying_gradient": live,
            "relu_input_max_rel_err": err,
            "worst_grad_ratios": worst(ratios),
            "over_grad_fraction": {n: r for n, r in ratios.items()
                                   if r is not None
                                   and r > cs.GRAD_FRACTION}}), flush=True)
    replayed, _, _ = step(cfg, "cpu", torch.float64, relus)
    print(json.dumps({
        "replayed_reference_flips": relus.flips,
        "last_run_worst_grad_ratios_vs_replayed":
            worst(cs.grad_ratios(grads, replayed), 6),
        "replayed_vs_plain_reference_worst_grad_ratios":
            worst(cs.grad_ratios(replayed, want), 6)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
