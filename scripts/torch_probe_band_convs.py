#!/usr/bin/env python3
"""The banded convs of spatial sharding on one NVIDIA GPU: each conv of the
RPN, the head and z_crush at its whole-canvas shape and at the first band
of two (with its halo rows), padded by columns alone and as
`models/layers.py::Conv2d.rows` pads it, under torch's deterministic
algorithms as `chip_smoke.py` phase 39 runs them.

    python3 scripts/torch_probe_band_convs.py [--model NAME]

Records every conv's input shape in one forward of the full-width model
(seeded weights, phase 4's or phase 8's scene), then times each as a
forward and a forward + backward (CUDA events, mean of 3 after one
warm-up; TF32 off) with its peak extra device memory, whole and banded.
Prints one JSON line a model with the card's name and power limit, the
convs ordered by their forward + backward ms padded by columns alone.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def timed(fn, n=3):
    """(mean ms, peak extra MiB) of fn() on the card."""
    fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return (round(start.elapsed_time(end) / n, 4),
            round((torch.cuda.max_memory_allocated() - base) / 2**20, 1))


def probe(name: str, card: str) -> dict:
    from futuredet_torch.models.detector import build_detector
    from futuredet_torch.models.layers import Conv2d, band_halo

    job = "vox_eval" if name == cs.VOX_NAME else "pp_eval"
    cfg = cs.space_config(job)
    model = build_detector(cfg, device="cuda", seed=0)
    shapes = {}

    def record(m, args, n):
        shapes.setdefault(n, (m, tuple(args[0].shape)))

    hooks = [m.register_forward_pre_hook(
        lambda m, a, n=n: record(m, a, n))
        for n, m in model.named_modules()
        if isinstance(m, Conv2d) and n.split(".")[0] in (
            "neck", "bbox_head", "z_crush")]
    with torch.no_grad():
        model(*cs.space_inputs(job, cfg, torch.device("cuda")))
    for h in hooks:
        h.remove()
    rows = []
    for n, (m, shape) in shapes.items():
        B, C, H, W = shape
        k, s, p = m.kernel_size[0], m.stride[0], m.padding[0]
        if m.after_band_pad:            # the stem: the pad gave its rows
            k, s, p = k, s, 1
            H -= 2
        top, bot = band_halo(k, s, p)
        band = H // 2 + top + bot
        w = m.weight.detach()
        out = {"conv": n, "cin": C, "cout": w.shape[0], "k": k, "s": s,
               "rows_whole": H, "rows_band": band, "cols": W}
        pw = m.padding[1] if not m.after_band_pad else p
        # the band padded by columns alone, and as Conv2d.rows runs it
        # (a stride-1 conv keeps its row padding and crops its output)
        port = (p, pw) if s == 1 and top == bot == p else (0, pw)
        for tag, rows_in, pad in (("whole", H, (p, pw)),
                                  ("band_cols_pad", band, (0, pw)),
                                  ("band", band, port)):
            x = torch.randn(B, C, rows_in, W, device="cuda",
                            requires_grad=True)
            wr = w.clone().requires_grad_()

            def fwd():
                with torch.no_grad():
                    F.conv2d(x, wr, None, s, pad)

            def fwd_bwd():
                F.conv2d(x, wr, None, s, pad).sum().backward()
            out[f"{tag}_fwd_ms_mib"] = timed(fwd)
            out[f"{tag}_fwd_bwd_ms_mib"] = timed(fwd_bwd)
        rows.append(out)
    rows.sort(key=lambda r: -r["band_cols_pad_fwd_bwd_ms_mib"][0])
    return {"card": card, "model": name, "convs": len(rows),
            "whole_fwd_ms": round(sum(r["whole_fwd_ms_mib"][0]
                                      for r in rows), 3),
            "band_fwd_ms": round(sum(r["band_fwd_ms_mib"][0]
                                     for r in rows), 3),
            "whole_fwd_bwd_ms": round(sum(r["whole_fwd_bwd_ms_mib"][0]
                                          for r in rows), 3),
            "band_cols_pad_fwd_ms": round(sum(
                r["band_cols_pad_fwd_ms_mib"][0] for r in rows), 3),
            "band_cols_pad_fwd_bwd_ms": round(sum(
                r["band_cols_pad_fwd_bwd_ms_mib"][0] for r in rows), 3),
            "band_peak_mib": max(r["band_fwd_bwd_ms_mib"][1] for r in rows),
            "band_cols_pad_peak_mib": max(r["band_cols_pad_fwd_bwd_ms_mib"][1]
                                          for r in rows),
            "band_fwd_bwd_ms": round(sum(r["band_fwd_bwd_ms_mib"][0]
                                         for r in rows), 3),
            "top": rows[:8]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", action="append",
                    default=None, help="pp_forecast_n3dtf, forecast_n3dtf")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_probe_band_convs: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    card = cs.card_line()
    np.random.seed(0)
    for name in args.model or (cs.NAME, cs.VOX_NAME):
        print(json.dumps(probe(name, card)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
