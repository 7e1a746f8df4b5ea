#!/usr/bin/env python3
"""K2's bf16 family, a parent tree's kernel against this tree's, conv by
conv, in turns on one card.

    python3 scripts/torch_time_k2_bf16.py [--parent SRC] [--out PATH]

Builds this checkout's csrc/gather_conv_bf16_kernel.cu (ops/_build.py) and
the parent's K2 source SRC (default: build/parent/futuredet_torch/csrc/
gather_conv_kernel.cu, a parent tree unpacked there with `git archive`)
with the same nvcc flags into build/torch_kernels/. Records the 20 bf16
convs of chip_smoke.py phase 30's (a) scene (forecast_n3dtf with
compute_dtype and middle_sparse_dtype bfloat16, full width, seeded
weights, the uniform_blobs scene) as the main path gives them. For each
conv: both kernels against the plain version (within chip_smoke.K2_RTOL
of max(1, max|plain|)), the new one bit-identical on a relaunch, the
fp32 families of both trees on the same conv in fp32 (bit-identical
outputs: their code is the same), and the device time of one call of
each bf16 kernel in turns, parent, new, new, parent (chip_smoke.
time_device: 3 warm-ups, the median of 20 between CUDA events). Prints
one JSON line a conv (N, V, Cin, Cout, the bound, both times, the new
kernel's sub-path) and a total line, with the card's name and power
limit; the lines also go to PATH (default chiprun_out/k2_bf16_times.jsonl).
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402
from futuredet_torch.ops import _build, pallas_gather  # noqa: E402


def build_parent(src):
    """The parent's K2 library, built with this tree's nvcc flags."""
    flags = _build.NVCC_FLAGS
    digest = hashlib.sha256(open(src, "rb").read()).hexdigest()[:16]
    out = _build.BUILD_DIR / f"parent_gather_conv_{digest}.so"
    if not out.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(out.with_suffix(".log"), "w") as log:
            subprocess.run([_build._nvcc(), *flags, "-o", str(out), src],
                           check=True, stdout=log, stderr=subprocess.STDOUT)
    return ctypes.CDLL(str(out))


def launcher(fn):
    """fn(x, table, w, bias) -> (N, Cout) fp32 through a C entry with the
    K2 ABI, on the current stream."""
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(x, table, w, bias=None):
        V, cin = x.shape
        N, cout = table.shape[1], w.shape[2]
        out = torch.empty((N, cout), dtype=torch.float32, device=x.device)
        err = fn(x.data_ptr(), table.data_ptr(), w.data_ptr(),
                 0 if bias is None else bias.data_ptr(), out.data_ptr(),
                 V, N, cin, cout, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: cudaError {err}")
        return out
    return run


def record_convs():
    """The 20 bf16 convs of phase 30's (a) scene, as the main path gives
    them to K2."""
    from futuredet_torch.models.detector import build_detector
    from futuredet_torch.ops import sparse_conv as sc_mod
    tag, base_name, change = cs.SERVING[0]
    _, cfg = cs.knob_config(base_name, change, tag)
    pts, valid, _ = cs.head_mode_scene(cfg)
    model = build_detector(cfg, device="cuda", seed=0)
    kernel, seen = sc_mod.gather_conv, []

    def recorder(f, t, w, b=None):
        seen.append(tuple(None if a is None else a.clone()
                          for a in (f, t, w, b)))
        return kernel(f, t, w, b)

    sc_mod.gather_conv = recorder
    try:
        with torch.no_grad():
            model(torch.from_numpy(pts).cuda(),
                  torch.from_numpy(valid).cuda())
    finally:
        sc_mod.gather_conv = kernel
    torch.cuda.synchronize()
    return seen


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=os.path.join(
        HERE, "build", "parent", "futuredet_torch", "csrc",
        "gather_conv_kernel.cu"))
    ap.add_argument("--out", default=os.path.join(
        HERE, "chiprun_out", "k2_bf16_times.jsonl"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    parent_lib = build_parent(args.parent)
    parent_bf16 = launcher(parent_lib.futuredet_gather_conv_bf16)
    parent_fp32 = launcher(parent_lib.futuredet_gather_conv)
    new_bf16 = launcher(_build.load(
        "gather_conv_bf16_kernel.cu").futuredet_gather_conv_bf16)
    new_fp32 = launcher(_build.load(
        "gather_conv_kernel.cu").futuredet_gather_conv)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    convs = record_convs()
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    lines, ok_all = [], True
    for i, conv in enumerate(convs):
        x, table, w, bias = conv
        V, cin = x.shape
        N, cout = table.shape[1], w.shape[2]
        plain = pallas_gather.gather_conv_plain(x, table, w, bias)
        tol = cs.K2_RTOL * max(1.0, float(plain.abs().max()))
        got_new, again = new_bf16(*conv), new_bf16(*conv)
        got_parent = parent_bf16(*conv)
        xf, wf = x.float(), w.float()
        route = pallas_gather.k2_route(cin, cout)
        fp32_same = bool(torch.equal(parent_fp32(xf, table, wf, bias),
                                     new_fp32(xf, table, wf, bias)))
        torch.cuda.synchronize()
        err_new = float((got_new - plain).abs().max())
        err_parent = float((got_parent - plain).abs().max())
        ok = (err_new <= tol and err_parent <= tol and fp32_same
              and bool(torch.equal(got_new, again)))
        ok_all &= ok
        times = {"parent": [], "new": []}
        for who in ("parent", "new", "new", "parent"):
            fn = parent_bf16 if who == "parent" else new_bf16
            times[who].append(cs.time_device(lambda c=conv, f=fn: f(*c)))
        bound = cs.k2_bound(x, table, w, bias)
        line = {"conv": i, "N": N, "V": V, "cin": cin, "cout": cout,
                "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
                "present_pairs": bound["present_pairs"],
                "parent_ms": times["parent"], "new_ms": times["new"],
                "max_abs_err": err_new, "parent_max_abs_err": err_parent,
                "tol": tol, "ok": ok, "fp32_route": route,
                "fp32_bit_identical_to_parent": fp32_same,
                "plan": pallas_gather.k2_bf16_plan(cin, cout, N, sms)}
        lines.append(line)
        print(json.dumps(line), flush=True)
    total = {"total": True, "card": card, "convs": len(lines),
             "parent_ms": sum(float(np.mean(ln["parent_ms"]))
                              for ln in lines),
             "new_ms": sum(float(np.mean(ln["new_ms"])) for ln in lines),
             "bound_ms": sum(ln["bound_ms"] for ln in lines),
             "slower_than_parent": [
                 ln["conv"] for ln in lines
                 if max(ln["new_ms"]) > min(ln["parent_ms"])],
             "ok": ok_all, "warmup": cs.WARMUP, "reps": cs.REPS}
    print(json.dumps(total), flush=True)
    with open(args.out, "w") as f:
        for ln in lines + [total]:
            f.write(json.dumps(ln) + "\n")
    return 0 if ok_all else 1


if __name__ == "__main__":
    sys.exit(main())
