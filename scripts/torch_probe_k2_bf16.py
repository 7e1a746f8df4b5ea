#!/usr/bin/env python3
"""Design probes of K2's bf16 family on the card: variants of
csrc/gather_conv_bf16_kernel.cu against the tree's kernel, and a timeline
of one block's ring.

    python3 scripts/torch_probe_k2_bf16.py [--variants a,b,...] [--trace]

Each variant is the source with a few text edits (VARIANTS below), built
with the tree's nvcc flags into build/torch_kernels/probe_<name>.so. On
the 20 bf16 convs of chip_smoke.py phase 30's (a) scene (as
scripts/torch_time_k2_bf16.py records them), every variant and the tree's
kernel are held to the plain version (chip_smoke.K2_RTOL of max(1,
max|plain|), bit-identical on a relaunch) and timed in turns (tree, then
the variants, then back: chip_smoke.time_device each), and each is run
on the case of tests/test_torch_cuda.py where all 27 taps of every site
are present at stage-3 width (V = 5000, N = 128, Cin = Cout = 128), the
one where a running accumulator would drift most.

--trace builds the tree's kernel with %globaltimer stamps in block 0
(the copier's empty-wait and copy issue, the consumers' full-wait and
MMA) and prints, for conv 1, 11 and 16, the medians of: a chunk's copy
issue, the gap between chunks, the consumers' MMA, and the delay from the
last copy issued to the stage landing.

Prints one JSON line a conv, a total line and a line a check, with the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "scripts"))

import chip_smoke as cs  # noqa: E402
import torch_time_k2_bf16 as tt  # noqa: E402
from futuredet_torch.ops import _build, pallas_gather  # noqa: E402

SRC = _build.CSRC / "gather_conv_bf16_kernel.cu"

_PARTIAL = """          float part[L::AN / 2];
          wgmma_fence();
#pragma unroll
          for (int k = 0; k < kChunk / 16; ++k)
            Wgmma<L::AN>::mma(
                part, da + ((k * 32) >> 4),
                db + ((a * kChunk * L::RB + k * 16 * L::RB) >> 4), k > 0);
          wgmma_commit();
          wgmma_wait_all();
          fence_regs(part);
          if (a == L::ATOMS - 1) mbar_arrive(&empty[slot]);
#pragma unroll
          for (int i = 0; i < L::AN / 2; ++i) acc[a][i] += part[i];"""
_RUNNING = """          wgmma_fence();
#pragma unroll
          for (int k = 0; k < kChunk / 16; ++k)
            Wgmma<L::AN>::mma(
                acc[a], da + ((k * 32) >> 4),
                db + ((a * kChunk * L::RB + k * 16 * L::RB) >> 4), 1);
          wgmma_commit();
          wgmma_wait_all();
          fence_regs(acc[a]);
          if (a == L::ATOMS - 1) mbar_arrive(&empty[slot]);"""
_ROWS = """#pragma unroll
            for (int q = 0; q < GPT; ++q) {
              const bool ok = (unsigned)vq[q] < (unsigned)V;
              cp_async16(sa + a_off(row, j0 + q),
                         ok ? x + (size_t)vq[q] * cin + cq[q] : x, ok);
            }"""
_COALESCED = """            const int j = p & 7, g = c * 8 + j, t = g / gpt;
            const int ch = (g - t * gpt) * 8;
            const int* it = idx + min(t, kTaps - 1) * kProducers;
            int vv[BM / 16];
#pragma unroll
            for (int q = 0; q < BM / 16; ++q) {
              const int r = (p >> 3) + 16 * q;
              vv[q] = t < kTaps && n0 + r < N ? it[r] : -1;
            }
#pragma unroll
            for (int q = 0; q < BM / 16; ++q) {
              const int r = (p >> 3) + 16 * q;
              const bool ok = (unsigned)vv[q] < (unsigned)V;
              cp_async16(sa + a_off(r, j),
                         ok ? x + (size_t)vv[q] * cin + ch : x, ok);
            }"""

# name -> (what it tries, [(old, new), ...])
VARIANTS = {
    "running": ("one running wgmma accumulator over all chunks, no "
                "partial", [(_PARTIAL, _RUNNING)]),
    "stages3": ("a 3-stage ring",
                [("constexpr int kStages = 4; ", "constexpr int kStages = 3; ")]),
    "stages6": ("a 6-stage ring (resident W past ~100 KB no longer fits)",
                [("constexpr int kStages = 4; ", "constexpr int kStages = 6; ")]),
    "tile64": ("64-site tiles for every N",
               [("return (N + 127) / 128 >= sms ? 128 : 64;", "return 64;")]),
    "l1": ("gathers allocated in L1 (cp.async.ca)",
           [("cp.async.cg.shared.global [%0], [%1], 16, %2;",
             "cp.async.ca.shared.global [%0], [%1], 16, %2;")]),
    "coalesced": ("a row's 8 granules over 8 lanes (indices from shared "
                  "memory) instead of one copier a row",
                  [(_ROWS, _COALESCED)]),
}

_TRACE = [
    ("#include <string.h>\n",
     "#include <string.h>\n__device__ unsigned long long g_trace[4][1024];\n"
     "__device__ __forceinline__ unsigned long long gtime() {\n"
     "  unsigned long long t;\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
     "  return t;\n}\n"),
    ("    uint32_t parity = 1;             // the first round finds stages "
     "empty\n",
     "    uint32_t parity = 1;             // the first round finds stages "
     "empty\n    int pstep = 0;\n"),
    ("        mbar_wait(&empty[slot], parity);\n",
     "        mbar_wait(&empty[slot], parity);\n"
     "        if (blockIdx.x == 0 && p == 0 && pstep < 1024)\n"
     "          g_trace[0][pstep] = gtime();\n"),
    ("          mbar_arrive_cp_async(&full[slot]);\n",
     "          mbar_arrive_cp_async(&full[slot]);\n"
     "          if (blockIdx.x == 0 && p == 0 && pstep < 1024)\n"
     "            g_trace[1][pstep] = gtime();\n          ++pstep;\n"),
    ("    int slot = 0;\n    uint32_t parity = 0;\n",
     "    int slot = 0;\n    uint32_t parity = 0;\n    int cstep = 0;\n"),
    ("        mbar_wait(&full[slot], parity);\n",
     "        mbar_wait(&full[slot], parity);\n"
     "        if (blockIdx.x == 0 && tid == 0 && cstep < 1024)\n"
     "          g_trace[2][cstep] = gtime();\n"),
    ("        if (++slot == kStages) {\n          slot = 0;\n          "
     "parity ^= 1;\n        }\n      }\n      // d[4j",
     "        if (blockIdx.x == 0 && tid == 0 && cstep < 1024)\n"
     "          g_trace[3][cstep++] = gtime();\n"
     "        if (++slot == kStages) {\n          slot = 0;\n          "
     "parity ^= 1;\n        }\n      }\n      // d[4j"),
]
_TRACE_TAIL = """
extern "C" int probe_trace(void* dst, int clear) {
  static unsigned long long zero[4][1024];
  return clear ? (int)cudaMemcpyToSymbol(g_trace, zero, sizeof zero)
               : (int)cudaMemcpyFromSymbol(dst, g_trace, sizeof zero);
}
"""


def edited(edits, tail=""):
    text = SRC.read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise ValueError(f"edit does not apply once: {old[:60]!r}")
        text = text.replace(old, new)
    return text + tail


def build(named_sources):
    """{name: source text} -> {name: CDLL}, one nvcc each, all at once."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in named_sources.items():
        src = _build.BUILD_DIR / f"probe_{name}.cu"
        src.write_text(text)
        out = src.with_suffix(".so")
        log = open(src.with_suffix(".log"), "w")
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(src)],
            stdout=log, stderr=subprocess.STDOUT), out, log)
    libs = {}
    for name, (proc, out, log) in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"probe {name} did not build: {log.name}")
        log.close()
        libs[name] = ctypes.CDLL(str(out))
    return libs


def full_taps_case():
    rng = np.random.default_rng(0)
    V, N, cin, cout = 5000, 128, 128, 128
    x = torch.from_numpy(rng.normal(size=(V, cin)).astype(np.float32))
    tab = rng.integers(0, V, (27, N)).astype(np.int32)
    w = (rng.normal(size=(27, cin, cout)) / np.sqrt(27 * cin)).astype(
        np.float32)
    b = rng.normal(size=cout).astype(np.float32)
    return (x.bfloat16().cuda(), torch.from_numpy(tab).cuda(),
            torch.from_numpy(w).bfloat16().cuda(), torch.from_numpy(b).cuda())


def trace(lib, convs, card):
    fn = tt.launcher(lib.futuredet_gather_conv_bf16)
    lib.probe_trace.argtypes = [ctypes.c_void_p, ctypes.c_int]
    for i in (1, 11, 16):
        for _ in range(3):
            fn(*convs[i])
        torch.cuda.synchronize()
        buf = np.zeros((4, 1024), np.uint64)
        lib.probe_trace(None, 1)
        fn(*convs[i])
        torch.cuda.synchronize()
        lib.probe_trace(buf.ctypes.data, 0)
        n = int(min((buf[0] > 0).sum(), (buf[2] > 0).sum()))
        wait, issued, full, done = (buf[k][:n].astype(np.int64) / 1e3
                                    for k in range(4))
        print(json.dumps({
            "trace_conv": i, "card": card, "chunks_of_block_0": n,
            "copy_issue_us": float(np.median(issued - wait)),
            "chunk_gap_us": float(np.median(np.diff(full))),
            "mma_us": float(np.median(done - full)),
            "landing_after_issue_us": float(np.median(full - issued))}),
            flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--trace", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    names = [n for n in args.variants.split(",") if n]
    sources = {"tree": edited([])}
    sources.update({n: edited(VARIANTS[n][1]) for n in names})
    if args.trace:
        sources["trace"] = edited(_TRACE, _TRACE_TAIL)
    libs = build(sources)
    fns = {n: tt.launcher(libs[n].futuredet_gather_conv_bf16)
           for n in ["tree", *names]}
    convs = tt.record_convs()
    totals = dict.fromkeys(fns, 0.0)
    for i, conv in enumerate(convs):
        plain = pallas_gather.gather_conv_plain(*conv)
        tol = cs.K2_RTOL * max(1.0, float(plain.abs().max()))
        line = {"conv": i, "N": conv[1].shape[1], "cin": conv[0].shape[1],
                "cout": conv[2].shape[2]}
        live = []
        for n, fn in fns.items():
            try:
                got, again = fn(*conv), fn(*conv)
                torch.cuda.synchronize()
            except RuntimeError as e:   # e.g. shared memory over 227 KB
                line[f"{n}_refused"] = str(e)
                continue
            live.append(n)
            if not (float((got - plain).abs().max()) <= tol
                    and torch.equal(got, again)):
                line[f"{n}_wrong"] = float((got - plain).abs().max())
        times = {n: [] for n in live}
        for n in live + live[::-1]:
            times[n].append(cs.time_device(lambda c=conv, f=fns[n]: f(*c)))
        for n in live:
            line[n] = times[n]
            totals[n] += float(np.mean(times[n]))
        print(json.dumps(line), flush=True)
    print(json.dumps({"total_ms": totals, "card": card,
                      "variants": {n: VARIANTS[n][0] for n in names}}),
          flush=True)
    case = full_taps_case()
    plain = pallas_gather.gather_conv_plain(*case)
    tol = cs.K2_RTOL * max(1.0, float(plain.abs().max()))
    for n, fn in fns.items():
        got = fn(*case)
        torch.cuda.synchronize()
        print(json.dumps({"all_taps_case": n, "tol": tol,
                          "max_abs_err": float((got - plain).abs().max())}),
              flush=True)
    if args.trace:
        trace(libs["trace"], convs, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
