#!/usr/bin/env python3
"""The ceiling of the instruction that K2's wide family multiplies with, on
one NVIDIA GPU:

    python3 scripts/torch_probe_mma.py

Builds and runs a kernel of nothing but independent `mma.sync.m16n8k8` TF32
MMAs (8 chains a warp, 4 blocks of 8 warps per SM), timed with CUDA events,
and prints one JSON line: the card's `nvidia-smi` name and power limit and
the TFLOP/s reached. K2 (csrc/gather_conv_kernel.cu) issues three such MMAs
per fragment for 3xTF32.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import card_line  # noqa: E402

MMA_PEAK_CU = r"""
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>
__global__ void mma_loop(float* out, int iters) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i)
    a[i] = __float_as_uint(1.0f + threadIdx.x * 1e-3f + i);
  b[0] = a[0]; b[1] = a[1];
  float d[8][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
          : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
            "r"(b[1]));
  }
  float s = 0.f;
  for (int j = 0; j < 8; ++j)
    for (int q = 0; q < 4; ++q) s += d[j][q];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
int main() {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  const int blocks = 4 * sms, threads = 256, iters = 4096;
  float* out;
  cudaMalloc(&out, sizeof(float) * blocks * threads);
  mma_loop<<<blocks, threads>>>(out, 16);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  mma_loop<<<blocks, threads>>>(out, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, e0, e1);
  const double flop = 2.0 * 16 * 8 * 8 * 8 * (double)iters * blocks *
                      (threads / 32);
  printf("%.3f %s\n", flop / ms / 1e9,
         cudaGetErrorString(cudaGetLastError()));
  return 0;
}
"""


def mma_sync_tf32_tflops() -> float:
    """TFLOP/s of a kernel that issues only mma.sync m16n8k8 TF32."""
    from futuredet_torch.ops import _build
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _build.BUILD_DIR / "mma_peak.cu"
    exe = _build.BUILD_DIR / "mma_peak"
    src.write_text(MMA_PEAK_CU)
    subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-O3", "-o", str(exe), str(src)], check=True,
                   timeout=300)
    out = subprocess.run([str(exe)], capture_output=True, text=True,
                         check=True, timeout=300).stdout.split()
    if out[1:] != ["no", "error"]:
        raise RuntimeError(f"mma_peak: {' '.join(out)}")
    return float(out[0])


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_probe_mma: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    print(json.dumps({"card": card_line(),
                      "mma_sync_tf32_tflops": mma_sync_tf32_tflops()}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
