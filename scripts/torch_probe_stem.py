#!/usr/bin/env python3
"""The VoxelNet RPN stem conv on one NVIDIA GPU: cuDNN's own algorithm
against the port's split form.

    python3 scripts/torch_probe_stem.py

Times (CUDA events, mean of 5 after one warm-up) and the peak extra device
memory of a 3x3 fp32 conv at 180x180 (TF32 off) for several channel
shapes, as one `nn.Conv2d` call, and the 256 -> 128 stem of
`forecast_n3dtf` also as `models/layers.py::SplitInputConv2d` (two
128-channel convs summed) and with cuDNN disabled. Prints one JSON line
with the card's name and power limit.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def timed(fn, n=5):
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
    return (start.elapsed_time(end) / n,
            (torch.cuda.max_memory_allocated() - base) / 2**20)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_probe_stem: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from futuredet_torch.models.layers import SplitInputConv2d

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    out = {"card": card, "torch": torch.__version__,
           "cudnn": torch.backends.cudnn.version()}
    with torch.no_grad():
        for cin, cout in ((256, 128), (256, 64), (384, 128), (256, 256),
                          (128, 128), (512, 64)):
            conv = torch.nn.Conv2d(cin, cout, 3, padding=1,
                                   bias=False).cuda()
            x = torch.randn(1, cin, 180, 180, device="cuda")
            out[f"conv2d_{cin}to{cout}_ms_mib"] = timed(lambda: conv(x))
        conv = torch.nn.Conv2d(256, 128, 3, bias=False).cuda()
        split = SplitInputConv2d(256, 128, 3, bias=False).cuda()
        split.load_state_dict(conv.state_dict())
        x = torch.randn(1, 256, 182, 182, device="cuda")
        ref = conv(x)
        out["stem_conv2d_ms_mib"] = timed(lambda: conv(x))
        out["stem_split_ms_mib"] = timed(lambda: split(x))
        out["stem_split_max_abs_diff"] = float((split(x) - ref).abs().max())
        with torch.backends.cudnn.flags(enabled=False):
            out["stem_no_cudnn_ms_mib"] = timed(lambda: conv(x))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
