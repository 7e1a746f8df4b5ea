// Sparse gather-conv, kernel K2 of futuredet_torch, for Hopper (sm_90a).
//
//   out[n, :] = bias + sum_{k=0..26} x[table[k, n], :] @ W[k]
//
// x (V, Cin) f32, table (27, N) int32 (an entry outside [0, V) is an
// absent neighbour and adds zero; the port writes V there), W (27, Cin,
// Cout) f32, bias (Cout,) f32 or null, out (N, Cout) f32. One table form
// serves submanifold convs (N = V) and strided ones (N = output sites).
//
// Replaces futuredet_tpu/ops/pallas_gather.py::_kernel (the Pallas
// windowed gather behind subm_conv_window). That kernel selects rows with
// one-hot matmuls on the MXU inside a DMA'd window, because a TPU cannot
// gather rows cheaply; a GPU can, so this kernel gathers the rows it needs
// directly and keeps none of the window, packing or overflow machinery.
//
// Design. One block of 256 threads owns a tile of 64 output sites and all
// Cout columns; each thread keeps an RM x RN register tile of sums. The
// block walks k = 0..26 in order:
//   * it loads the tile's 64 entries of table[k] into shared memory and
//     skips k when none is present (most offsets are absent for lidar
//     sites: the skip is decided by __syncthreads_or, uniformly);
//   * per slice of 32 input channels it gathers the present rows into
//     shared memory (zeros for absent rows) and stages the matching
//     32 x Cout slice of W[k];
//   * every thread runs fp32 FMAs over the slice into its register tile.
// The bias is added last and each output is stored once. An output is
// owned by one thread and summed in a fixed order, so there are no atomics
// and the result is bit-identical from run to run.
//
// Bound on the H100 (3.35 TB/s, 67 TFLOP/s fp32 without tensor cores):
// bytes = V*Cin*4 + 27*N*4 (table) + 27*Cin*Cout*4 + N*Cout*4 read or
// written once; operations = 2 * present (k, n) pairs * Cin * Cout. Narrow
// stages (Cin <= 32) are bound by bytes, wide ones by operations; which
// one binds is computed per conv by chip_smoke.py. This simple kernel
// reads each input row up to 27 times (once per tile that needs it); at
// 160k x 16 f32 (10 MB) the rows stay in the 50 MB L2 and that traffic
// comes from L2, not device memory. Faster forms (mma/wgmma on a bf16 or
// 3xTF32 split, cp.async or TMA gathers, a persistent grid) are later
// work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTaps = 27;
constexpr int kTileN = 64;     // output sites per block
constexpr int kSlice = 32;     // input channels staged per pass
constexpr int kThreads = 256;

template <int COUT>
struct Layout {
  static constexpr int RN = COUT >= 128 ? 8 : (COUT >= 16 ? 4 : 2);
  static constexpr int TCOLS = COUT / RN;          // threads across columns
  static constexpr int TROWS = kThreads / TCOLS;   // threads across rows
  static constexpr int RM = kTileN / TROWS;        // rows per thread
  static_assert(RN * TCOLS == COUT, "columns");
  static_assert(TCOLS * TROWS == kThreads, "threads");
  static_assert(RM * TROWS == kTileN && RM >= 1, "rows");
};

template <int COUT>
__global__ void __launch_bounds__(kThreads)
gather_conv_kernel(const float* __restrict__ x,
                   const int32_t* __restrict__ table,
                   const float* __restrict__ w,
                   const float* __restrict__ bias,
                   float* __restrict__ out, int V, int N, int cin) {
  using L = Layout<COUT>;
  __shared__ int s_idx[kTileN];
  __shared__ float s_x[kTileN][kSlice + 1];   // +1: no bank conflicts
  __shared__ float s_w[kSlice][COUT];

  const int tid = threadIdx.x;
  const int tc = tid % L::TCOLS;   // columns tc + j * TCOLS
  const int tr = tid / L::TCOLS;   // rows tr + i * TROWS
  const int n0 = blockIdx.x * kTileN;

  float acc[L::RM][L::RN];
#pragma unroll
  for (int i = 0; i < L::RM; ++i)
#pragma unroll
    for (int j = 0; j < L::RN; ++j) acc[i][j] = 0.f;

  for (int k = 0; k < kTaps; ++k) {
    int present = 0;
    if (tid < kTileN) {
      const int n = n0 + tid;
      int v = n < N ? table[(size_t)k * N + n] : -1;
      if (v < 0 || v >= V) v = -1;
      s_idx[tid] = v;
      present = v >= 0;
    }
    if (!__syncthreads_or(present)) continue;

    for (int c0 = 0; c0 < cin; c0 += kSlice) {
      const int clen = min(kSlice, cin - c0);
      for (int e = tid; e < kTileN * kSlice; e += kThreads) {
        const int r = e / kSlice, c = e % kSlice;
        const int v = s_idx[r];
        s_x[r][c] = (v >= 0 && c < clen) ? x[(size_t)v * cin + c0 + c] : 0.f;
      }
      for (int e = tid; e < kSlice * COUT; e += kThreads) {
        const int c = e / COUT, j = e % COUT;
        s_w[c][j] = c < clen ? w[((size_t)k * cin + c0 + c) * COUT + j] : 0.f;
      }
      __syncthreads();
      for (int c = 0; c < clen; ++c) {
        float a[L::RM], b[L::RN];
#pragma unroll
        for (int i = 0; i < L::RM; ++i) a[i] = s_x[tr + i * L::TROWS][c];
#pragma unroll
        for (int j = 0; j < L::RN; ++j) b[j] = s_w[c][tc + j * L::TCOLS];
#pragma unroll
        for (int i = 0; i < L::RM; ++i)
#pragma unroll
          for (int j = 0; j < L::RN; ++j)
            acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < L::RM; ++i) {
    const int n = n0 + tr + i * L::TROWS;
    if (n >= N) continue;
#pragma unroll
    for (int j = 0; j < L::RN; ++j) {
      const int col = tc + j * L::TCOLS;
      out[(size_t)n * COUT + col] =
          bias != nullptr ? acc[i][j] + bias[col] : acc[i][j];
    }
  }
}

template <int COUT>
void launch(const float* x, const int32_t* table, const float* w,
            const float* bias, float* out, int V, int N, int cin,
            cudaStream_t stream) {
  const dim3 grid((N + kTileN - 1) / kTileN);
  gather_conv_kernel<COUT><<<grid, kThreads, 0, stream>>>(
      x, table, w, bias, out, V, N, cin);
}

}  // namespace

// C ABI for ctypes. Returns a cudaError_t: cudaErrorInvalidValue for a
// shape the kernel does not take, else the launch status.
extern "C" int futuredet_gather_conv(const float* x, const int32_t* table,
                                     const float* w, const float* bias,
                                     float* out, int V, int N, int cin,
                                     int cout, void* stream) {
  if (N < 0 || V < 0 || cin < 1) return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cout) {
    case 8: launch<8>(x, table, w, bias, out, V, N, cin, s); break;
    case 16: launch<16>(x, table, w, bias, out, V, N, cin, s); break;
    case 32: launch<32>(x, table, w, bias, out, V, N, cin, s); break;
    case 64: launch<64>(x, table, w, bias, out, V, N, cin, s); break;
    case 128: launch<128>(x, table, w, bias, out, V, N, cin, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
