"""Sparse gather-conv: kernel K2 of the port, in CUDA.

Counterpart of `futuredet_tpu/ops/pallas_gather.py` (the Pallas `_kernel`
behind `subm_conv_window`); the module keeps that name so the pair is easy
to find, but the kernel here is CUDA C++ for Hopper,
`csrc/gather_conv_kernel.cu` (design and bound in its header). Both compute

    out[n] = bias + sum_k x[table[k, n]] @ W[k],   k = 0..26

where table[k, n] == V (the number of input rows) marks an absent
neighbour, which adds zero. The table serves submanifold convs (N = V) and
strided ones (N = output sites) alike, and so the backward too: a sparse
conv's input gradient is one more K2 launch, over the same table with
flipped, transposed weights or over the strided conv's inverse table
(`ops/sparse_conv.py::subm_conv_dx`), counted and checked as the forward.

`gather_conv` launches the kernel for CUDA tensors and runs
`gather_conv_plain`, the plain PyTorch version, for CPU tensors. The plain
version is the JAX package's `loop` form (`sparse_conv.py:636-640`): a zero
row appended, then per k one row gather and one matmul, summed.

The kernel has three families, picked by `k2_route(cin, cout, dtype)`.
For fp32 inputs: `narrow` (Cin <= 16, Cout <= 32: convs whose bound is
bytes; fp32 FMAs, W in shared memory, one or two sites per thread) and
`wide` (Cin a multiple of 4 otherwise: an implicit GEMM on the tensor
cores in 3xTF32, which keeps fp32 accuracy). For bf16 features and
weights, `bf16`: the JAX kernel's bf16 mode (`compute_dtype=bfloat16`,
the serving mode of `window_bf16` and `middle_sparse_dtype="bfloat16"`),
bf16 rows gathered and multiplied on the tensor cores, products summed
in fp32, an fp32 output. Its plain version gathers the bf16 rows and
multiplies them in fp32: a bf16 x bf16 product is exact in fp32, so the
two differ only in the order of the sums. The C side picks by the same
rule and refuses, through its return code, a shape that no family takes.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_SRC = "gather_conv_kernel.cu"
K_TAPS = 27
# output widths the kernel is instantiated for (csrc/gather_conv_kernel.cu)
COUTS = (8, 16, 32, 64, 128)
ROUTES = ("narrow", "wide", "bf16")


def k2_route(cin: int, cout: int, dtype: torch.dtype = torch.float32
             ) -> str:
    """The kernel family that takes a (Cin, Cout) conv of `dtype` inputs:
    for fp32 "narrow" (Cin <= 16 and Cout <= 32: fp32 FMAs) or "wide" (Cin
    a multiple of 4 otherwise: 3xTF32 tensor-core implicit GEMM), for bf16
    "bf16" (any Cin), by the rules of `route_of` / `bf16_takes` in
    csrc/gather_conv_kernel.cu. Raises ValueError for a shape none
    takes."""
    if dtype == torch.bfloat16:
        if cout in COUTS and cin >= 1:
            return "bf16"
        raise ValueError(f"K2's bf16 family takes Cout in {COUTS}; got "
                         f"Cin={cin}, Cout={cout}")
    if cout in COUTS:
        if 1 <= cin <= 16 and cout <= 32:
            return "narrow"
        if cin >= 4 and cin % 4 == 0:
            return "wide"
    raise ValueError(f"K2 takes Cout in {COUTS} with Cin <= 16 (Cout <= 32) "
                     f"or Cin a multiple of 4; got Cin={cin}, Cout={cout}")


def gather_conv_plain(features: torch.Tensor, table: torch.Tensor,
                      weights: torch.Tensor, bias: torch.Tensor = None
                      ) -> torch.Tensor:
    """features (V, Cin), table (K, N) in [0, V], weights (K, Cin, Cout),
    bias (Cout,) or None -> (N, Cout). bf16 features and weights: the bf16
    rows gathered, then multiplied and summed in fp32 (the JAX `loop` form
    with compute dtype bf16, `sparse_conv.py:621-643`), an fp32 output."""
    padded = torch.cat([features, features.new_zeros(1, features.shape[1])])
    wide = features.dtype == torch.bfloat16
    out = None
    for k in range(table.shape[0]):
        rows, w = padded.index_select(0, table[k]), weights[k]
        if wide:
            rows, w = rows.float(), w.float()
        acc = rows @ w
        out = acc if out is None else out + acc
    return out if bias is None else out + bias


def _check(features, table, weights, bias) -> None:
    # the kernel takes float32 or bfloat16; the plain version on the CPU
    # also float64 (gradient checks). bf16 inputs take an fp32 bias
    dtype = features.dtype
    if features.dim() != 2 or not (
            dtype in (torch.float32, torch.bfloat16)
            or (dtype == torch.float64 and features.device.type == "cpu")):
        raise ValueError("features must be a (V, Cin) float32 or bfloat16 "
                         "tensor")
    if table.dim() != 2 or table.shape[0] != K_TAPS \
            or table.dtype != torch.int32:
        raise ValueError(f"table must be a ({K_TAPS}, N) int32 tensor, got "
                         f"{tuple(table.shape)} {table.dtype}")
    if (weights.dim() != 3 or weights.shape[0] != K_TAPS
            or weights.shape[1] != features.shape[1]
            or weights.dtype != dtype):
        raise ValueError(f"weights must be ({K_TAPS}, Cin, Cout) of the "
                         f"features' type {dtype} with Cin = "
                         f"{features.shape[1]}, got "
                         f"{tuple(weights.shape)} {weights.dtype}")
    bias_dtype = torch.float32 if dtype == torch.bfloat16 else dtype
    if bias is not None and (bias.shape != (weights.shape[2],)
                             or bias.dtype != bias_dtype):
        raise ValueError(f"bias must be a (Cout,) {bias_dtype} tensor")
    devs = {t.device for t in (features, table, weights, bias)
            if t is not None}
    if len(devs) != 1:
        raise ValueError(f"inputs lie on different devices: {devs}")


def gather_conv(features: torch.Tensor, table: torch.Tensor,
                weights: torch.Tensor, bias: torch.Tensor = None
                ) -> torch.Tensor:
    """K2: features (V, Cin) f32 or bf16, table (27, N) int32, weights
    (27, Cin, Cout) of the features' type, bias (Cout,) f32 or None ->
    (N, Cout) f32.

    A CUDA tensor goes to the kernel (or raises); a CPU tensor goes to
    `gather_conv_plain`. `gather_conv.launches` counts kernel launches,
    `gather_conv.launches_by_route` each family's. The kernel treats any
    entry outside [0, V) as absent.
    """
    _check(features, table, weights, bias)
    if features.device.type == "cpu":
        return gather_conv_plain(features, table, weights, bias)
    if features.device.type != "cuda":
        raise ValueError(f"unsupported device {features.device}")
    V, cin = features.shape
    N, cout = table.shape[1], weights.shape[2]
    route = k2_route(cin, cout, features.dtype)   # raises if none takes it
    if not all(t.is_contiguous() for t in (features, table, weights, bias)
               if t is not None):
        raise ValueError("features, table, weights and bias must be "
                         "contiguous")
    if features.data_ptr() % 16 or weights.data_ptr() % 16:
        raise ValueError("features and weights must start 16-byte aligned "
                         "(the kernel reads them in 16-byte vectors)")
    out = torch.empty((N, cout), dtype=torch.float32, device=features.device)
    if N == 0:
        return out
    lib = _build.load(_SRC)
    fn = (lib.futuredet_gather_conv_bf16 if route == "bf16"
          else lib.futuredet_gather_conv)
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(features.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(features.data_ptr(), table.data_ptr(), weights.data_ptr(),
                 0 if bias is None else bias.data_ptr(), out.data_ptr(),
                 V, N, cin, cout, stream)
    if err != 0:
        raise RuntimeError(f"gather_conv_kernel launch failed: cudaError "
                           f"{err}")
    gather_conv.launches += 1
    gather_conv.launches_by_route[route] += 1
    return out


def reset_launches() -> None:
    """Set every launch count of K2 to 0."""
    gather_conv.launches = 0
    gather_conv.launches_by_route = dict.fromkeys(ROUTES, 0)


reset_launches()
