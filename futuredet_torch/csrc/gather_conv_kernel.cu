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
// Two fp32 families, picked per call by Cin and Cout (route_of; the
// wrapper's futuredet_torch/ops/pallas_gather.py::k2_route names the same);
// each call is one launch. The bf16 family (bf16 x and W, the JAX
// kernel's serving mode) is gather_conv_bf16_kernel.cu.
//
// narrow (Cin <= 16, Cout <= 32: conv_input 5->16, stage-0 16->16, down1
// 16->32). Few operations per byte: a row is 20-64 B. All 27 taps of W
// (zero-padded to CINP = 8 or 16 rows) sit in shared memory, staged once
// per block before the only barrier. Each thread owns S output sites (2 at
// Cin 16, Cout <= 16, else 1) and their Cout sums in registers. A warp
// first reads its 27 table rows (coalesced: the table is n-contiguous) and
// keeps the taps some lane has (__any_sync); it then walks those taps in
// order, gathering each row with float4 loads (Cin = 8, 16) or scalar ones
// (Cin = 5), the next tap's row and the index after it already in flight,
// and runs FMAs against W[k] read as warp-wide float4 broadcasts. No
// barrier inside the tap loop.
//
// wide (Cin % 4 == 0 otherwise; on the main path Cin >= 32: stages 1-3,
// down2, down3). An implicit GEMM on the tensor cores: mma.sync m16n8k8
// TF32 with the 3xTF32 split (hi = rna(x), lo = rna(x - hi); lo*hi + hi*lo
// + hi*hi), which keeps fp32 accuracy where plain TF32 is ~3e-4 off, past
// K2's 1e-5 tolerance. A block owns BM = 64 or 128 output sites (128 where
// N still gives every SM two such tiles) and all Cout columns; each warp a 32 x min(Cout, 64) tile. At block start it
// loads the tile's 27 x BM index block into shared memory once and ORs
// per-warp ballots into the mask of taps some site of the tile has. It
// then walks (present tap, 32-channel chunk) steps through a ring of 2-3
// shared-memory stages: cp.async gathers the chunk's BM rows (16 B per
// copy, zero-fill for absent rows and channels past Cin) and the 32 x Cout
// slice of W[k] while the MMAs of the step before run. Each step's MMAs
// sum into a fresh partial that is added to the fp32 sums with round to
// nearest: the tensor core truncates as it accumulates, and one chain over
// all steps drifted past the 1e-5 tolerance. Absent rows inside a present
// tap are zeros multiplied, as in spconv's implicit GEMM. Rows are padded
// (A: 36 floats, B: Cout + 8 or + 16) so fragment reads hit 32 banks.
//
// All families add the bias once and store each output once, owned by one
// thread and summed in a fixed order: no atomics, and relaunches are
// bit-identical.
//
// Tests: tests/test_torch_cuda.py holds every family against the plain
// version on a card (python -m pytest --noconftest -m cuda
// tests/test_torch_cuda.py); tests/test_torch_gather_conv.py checks the
// route and the 3xTF32 arithmetic in numpy on the CPU.
//
// Bound on the H100 (3.35 TB/s; 67 TFLOP/s fp32 without tensor cores,
// 495 TFLOP/s dense TF32, so 165 for 3xTF32): bytes = V*Cin*4 +
// 27*N*4 (table) + 27*Cin*Cout*4 + N*Cout*4 read or written once;
// operations = 2 * present (k, n) pairs * Cin * Cout. chip_smoke.py
// computes both per conv, at the fp32 rate (bound_ms) and, for the wide
// family, at the 3xTF32 rate (tc_bound_ms). What holds each family back on
// the card is in PERF.md: the narrow one issues FMAs and
// shared-memory broadcasts, the wide one is bound by its gather and W
// stream more than by the tensor cores, which mma.sync drives at about
// two thirds of the TF32 peak.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTaps = 27;
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr int route_of(int cin, int cout) {
  // 1 narrow, 2 wide, 0 not taken
  return (cout != 8 && cout != 16 && cout != 32 && cout != 64 && cout != 128)
             ? 0
             : (cin >= 1 && cin <= 16 && cout <= 32) ? 1
             : (cin >= 4 && cin % 4 == 0) ? 2 : 0;
}

// ------------------------------------------------------------------ narrow

constexpr int kNarrowThreads = 256;

template <int CINP>
__device__ __forceinline__ void load_row(const float* __restrict__ x, int v,
                                         int cin, bool vec,
                                         float (&r)[CINP]) {
  if (v < 0) {
#pragma unroll
    for (int c = 0; c < CINP; ++c) r[c] = 0.f;
    return;
  }
  const float* p = x + (size_t)v * cin;
  if (vec) {
#pragma unroll
    for (int q = 0; q < CINP / 4; ++q) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(p) + q);
      r[4 * q] = f.x; r[4 * q + 1] = f.y; r[4 * q + 2] = f.z;
      r[4 * q + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int c = 0; c < CINP; ++c) r[c] = c < cin ? __ldg(p + c) : 0.f;
  }
}

// sites per thread: each W value read from shared memory serves S FMAs.
// Two sites per thread timed faster at Cin = 16, Cout <= 16 (the stage-0
// convs); elsewhere the extra registers cost more than they save
template <int CINP, int COUT>
constexpr int narrow_sites() { return CINP == 16 && COUT <= 16 ? 2 : 1; }

template <int CINP, int COUT, int S>
__global__ void __launch_bounds__(kNarrowThreads)
narrow_kernel(const float* __restrict__ x, const int32_t* __restrict__ table,
              const float* __restrict__ w, const float* __restrict__ bias,
              float* __restrict__ out, int V, int N, int cin, bool vec) {
  extern __shared__ __align__(16) float s_w[];   // [27][CINP][COUT]
  constexpr int C4 = COUT / 4;
  for (int e = threadIdx.x; e < kTaps * CINP * C4; e += kNarrowThreads) {
    const int j = e % C4, c = (e / C4) % CINP, k = e / (C4 * CINP);
    float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
    if (c < cin)
      f = __ldg(reinterpret_cast<const float4*>(
                    w + ((size_t)k * cin + c) * COUT) + j);
    reinterpret_cast<float4*>(s_w)[e] = f;
  }
  __syncthreads();   // the only barrier: none inside the tap loop

  // sites n0 + s * kNarrowThreads, s < S: table reads stay coalesced
  const int n0 = blockIdx.x * kNarrowThreads * S + threadIdx.x;
  auto index = [&](int k, int s) -> int {
    const int n = n0 + s * kNarrowThreads;
    if (n >= N || k >= kTaps) return -1;
    const int v = __ldg(table + (size_t)k * N + n);
    return (unsigned)v < (unsigned)V ? v : -1;
  };

  // the taps some lane of the warp has, from one pass of 27 coalesced
  // reads; the tap loop then visits only those (a vote and a branch per
  // tap inside the loop timed slower where almost no tap is skipped)
  unsigned taps = 0;
#pragma unroll
  for (int k = 0; k < kTaps; ++k) {
    bool any = false;
#pragma unroll
    for (int s = 0; s < S; ++s) any |= index(k, s) >= 0;
    taps |= (__any_sync(kFull, any) ? 1u : 0u) << k;
  }
  auto pop = [&]() -> int {   // the next tap of the warp, kTaps when done
    if (taps == 0) return kTaps;
    const int k = __ffs(taps) - 1;
    taps &= taps - 1;
    return k;
  };

  float acc[S][COUT];
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int j = 0; j < COUT; ++j) acc[s][j] = 0.f;

  int k0 = pop(), k1 = pop();
  int v1[S];
  float r0[S][CINP];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    load_row<CINP>(x, index(k0, s), cin, vec, r0[s]);
    v1[s] = index(k1, s);
  }
#pragma unroll 1
  while (k0 < kTaps) {
    const int k2 = pop();
    int v2[S];
    float r1[S][CINP];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      v2[s] = index(k2, s);                         // two taps ahead
      load_row<CINP>(x, v1[s], cin, vec, r1[s]);    // the next tap's row
    }
    {
      const float4* wk = reinterpret_cast<const float4*>(s_w) +
                         (size_t)k0 * CINP * C4;
#pragma unroll
      for (int c = 0; c < CINP; ++c) {
#pragma unroll
        for (int j = 0; j < C4; ++j) {
          const float4 f = wk[c * C4 + j];
#pragma unroll
          for (int s = 0; s < S; ++s) {
            acc[s][4 * j] = fmaf(r0[s][c], f.x, acc[s][4 * j]);
            acc[s][4 * j + 1] = fmaf(r0[s][c], f.y, acc[s][4 * j + 1]);
            acc[s][4 * j + 2] = fmaf(r0[s][c], f.z, acc[s][4 * j + 2]);
            acc[s][4 * j + 3] = fmaf(r0[s][c], f.w, acc[s][4 * j + 3]);
          }
        }
      }
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
#pragma unroll
      for (int c = 0; c < CINP; ++c) r0[s][c] = r1[s][c];
      v1[s] = v2[s];
    }
    k0 = k1;
    k1 = k2;
  }

#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int n = n0 + s * kNarrowThreads;
    if (n >= N) continue;
    float4* o = reinterpret_cast<float4*>(out + (size_t)n * COUT);
#pragma unroll
    for (int j = 0; j < C4; ++j) {
      float4 f = make_float4(acc[s][4 * j], acc[s][4 * j + 1],
                             acc[s][4 * j + 2], acc[s][4 * j + 3]);
      if (bias != nullptr) {
        f.x += __ldg(bias + 4 * j); f.y += __ldg(bias + 4 * j + 1);
        f.z += __ldg(bias + 4 * j + 2); f.w += __ldg(bias + 4 * j + 3);
      }
      o[j] = f;
    }
  }
}

template <int CINP, int COUT>
cudaError_t launch_narrow(const float* x, const int32_t* table,
                          const float* w, const float* bias, float* out,
                          int V, int N, int cin, cudaStream_t stream) {
  constexpr int S = narrow_sites<CINP, COUT>();
  const size_t smem = sizeof(float) * kTaps * CINP * COUT;
  // per launch: the attribute belongs to the current device
  const cudaError_t e = cudaFuncSetAttribute(
      narrow_kernel<CINP, COUT, S>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const bool vec = cin == CINP;   // rows 32 or 64 B: float4-aligned
  const dim3 grid((N + kNarrowThreads * S - 1) / (kNarrowThreads * S));
  narrow_kernel<CINP, COUT, S><<<grid, kNarrowThreads, smem, stream>>>(
      x, table, w, bias, out, V, N, cin, vec);
  return cudaGetLastError();
}

// -------------------------------------------------------------------- wide

constexpr int kChunk = 32;           // input channels per pipeline stage
constexpr int kAStride = kChunk + 4;   // 36 floats: 4g + t spans 32 banks

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  // src-size 0 writes 16 zero bytes and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// fp32 -> TF32 (10-bit mantissa), to nearest with ties away from zero: the
// bits of cvt.rna.tf32.f32 for finite x, in two integer operations, which
// timed faster than the conversion instruction over the wide convs
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// 3xTF32: x = hi + lo, both TF32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int BM, int COUT>
struct Wide {
  static constexpr int WN = COUT < 64 ? COUT : 64;   // warp tile 32 x WN
  static constexpr int WARPS_M = BM / 32;
  static constexpr int WARPS_N = COUT / WN;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int NT = WN / 8;                  // n8 tiles per warp
  // ring depth: 3 stages, 2 where Cout <= 32 (the smaller ring lets a
  // third block onto the SM, which timed faster on the stage-1 convs)
  static constexpr int STAGES = COUT <= 32 ? 2 : 3;
  // B row stride: == 8 or 24 mod 32, so 8t + g (or 24t + g) spans 32 banks
  static constexpr int BS = (COUT + 8) % 16 == 8 ? COUT + 8 : COUT + 16;
  static constexpr int A_FLOATS = BM * kAStride;
  static constexpr int B_FLOATS = kChunk * BS;
  static constexpr size_t SMEM =
      sizeof(int) * (kTaps * BM + 8) +
      sizeof(float) * STAGES * (A_FLOATS + B_FLOATS);
  static_assert(BM % 32 == 0 && COUT % WN == 0 && WN % 8 == 0, "tile");
  static_assert((kTaps * BM + 8) % 4 == 0 && BS % 4 == 0, "16 B rows");
};

template <int BM, int COUT>
__global__ void __launch_bounds__(Wide<BM, COUT>::THREADS)
wide_kernel(const float* __restrict__ x, const int32_t* __restrict__ table,
            const float* __restrict__ w, const float* __restrict__ bias,
            float* __restrict__ out, int V, int N, int cin) {
  using L = Wide<BM, COUT>;
  extern __shared__ __align__(16) int smem[];
  int* s_idx = smem;                          // [27][BM], -1 = absent
  unsigned* s_wmask = reinterpret_cast<unsigned*>(smem + kTaps * BM);
  float* s_a = reinterpret_cast<float*>(smem + kTaps * BM + 8);
  float* s_b = s_a + L::STAGES * L::A_FLOATS;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp % L::WARPS_M, wn = warp / L::WARPS_M;
  const int n0 = blockIdx.x * BM;

  // the tile's index block, once, and the mask of taps some site has
  unsigned present = 0;
  for (int e = tid; e < kTaps * BM; e += L::THREADS) {
    const int k = e / BM, n = n0 + e % BM;
    int v = n < N ? __ldg(table + (size_t)k * N + n) : -1;
    v = (unsigned)v < (unsigned)V ? v : -1;
    s_idx[e] = v;
    present |= (v >= 0 ? 1u : 0u) << k;
  }
  present = __reduce_or_sync(kFull, present);
  if (lane == 0) s_wmask[warp] = present;
  __syncthreads();
  unsigned mask = 0;
#pragma unroll
  for (int i = 0; i < L::THREADS / 32; ++i) mask |= s_wmask[i];

  const int nchunks = (cin + kChunk - 1) / kChunk;
  const int steps = __popc(mask) * nchunks;

  // producer cursor over (present tap, chunk), in order
  unsigned ld_mask = mask;
  int ld_k = mask ? __ffs(mask) - 1 : 0, ld_c = 0;
  auto issue = [&](int slot) {
    float* sa = s_a + slot * L::A_FLOATS;
    float* sb = s_b + slot * L::B_FLOATS;
    const int c0 = ld_c * kChunk;
    const int* ik = s_idx + ld_k * BM;
    for (int e = tid; e < BM * (kChunk / 4); e += L::THREADS) {
      const int r = e / (kChunk / 4), ch = c0 + (e % (kChunk / 4)) * 4;
      const int v = ik[r];
      const bool ok = v >= 0 && ch < cin;
      cp_async16(sa + r * kAStride + (ch - c0),
                 ok ? x + (size_t)v * cin + ch : x, ok);
    }
    for (int e = tid; e < kChunk * (COUT / 4); e += L::THREADS) {
      const int kk = e / (COUT / 4), j = (e % (COUT / 4)) * 4;
      const bool ok = c0 + kk < cin;
      cp_async16(sb + kk * L::BS + j,
                 ok ? w + ((size_t)ld_k * cin + c0 + kk) * COUT + j : w, ok);
    }
    if (++ld_c == nchunks) {
      ld_c = 0;
      ld_mask &= ld_mask - 1;
      ld_k = ld_mask ? __ffs(ld_mask) - 1 : 0;
    }
  };

  float acc[2][L::NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < L::NT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;

#pragma unroll
  for (int s = 0; s < L::STAGES - 1; ++s) {
    if (s < steps) issue(s);
    cp_async_commit();
  }
#pragma unroll 1
  for (int it = 0; it < steps; ++it) {
    cp_async_wait<L::STAGES - 2>();   // step it has landed (this thread)
    __syncthreads();                  // ... for every thread; it-1 done
    if (it + L::STAGES - 1 < steps)
      issue((it + L::STAGES - 1) % L::STAGES);
    cp_async_commit();

    const int slot = it % L::STAGES;
    const float* sa = s_a + slot * L::A_FLOATS + (wm * 32 + g) * kAStride + t;
    const float* sb = s_b + slot * L::B_FLOATS + t * L::BS + wn * L::WN + g;
    // the chunk's products go to a fresh partial sum, added to acc with
    // round to nearest: the tensor core truncates as it accumulates, and
    // one chain over all taps and chunks (up to 27 * 16 * 3 MMAs) drifted
    // past K2's 1e-5 tolerance; chains of 12 MMAs keep fp32 accuracy
    float part[2][L::NT][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < L::NT; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) part[mt][nt][q] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kChunk / 8; ++ks) {
      uint32_t bh[L::NT][2], bl[L::NT][2];
#pragma unroll
      for (int nt = 0; nt < L::NT; ++nt) {
        split_tf32(sb[ks * 8 * L::BS + nt * 8], bh[nt][0], bl[nt][0]);
        split_tf32(sb[(ks * 8 + 4) * L::BS + nt * 8], bh[nt][1], bl[nt][1]);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float* p = sa + mt * 16 * kAStride + ks * 8;
        uint32_t ah[4], al[4];
        split_tf32(p[0], ah[0], al[0]);                   // row g,   col t
        split_tf32(p[8 * kAStride], ah[1], al[1]);        // row g+8, col t
        split_tf32(p[4], ah[2], al[2]);                   // row g,   col t+4
        split_tf32(p[8 * kAStride + 4], ah[3], al[3]);    // row g+8, col t+4
#pragma unroll
        for (int nt = 0; nt < L::NT; ++nt) {
          mma_tf32(part[mt][nt], al, bh[nt]);
          mma_tf32(part[mt][nt], ah, bl[nt]);
          mma_tf32(part[mt][nt], ah, bh[nt]);
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < L::NT; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mt][nt][q] += part[mt][nt][q];
  }

  // epilogue: c0, c1 at (row g, cols 2t, 2t+1), c2, c3 at row g+8
#pragma unroll
  for (int nt = 0; nt < L::NT; ++nt) {
    const int col = wn * L::WN + nt * 8 + 2 * t;
    const float b0 = bias != nullptr ? __ldg(bias + col) : 0.f;
    const float b1 = bias != nullptr ? __ldg(bias + col + 1) : 0.f;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = n0 + wm * 32 + mt * 16 + g + 8 * h;
        if (n >= N) continue;
        float2 f = make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
        if (bias != nullptr) {
          f.x += b0;
          f.y += b1;
        }
        *reinterpret_cast<float2*>(out + (size_t)n * COUT + col) = f;
      }
  }
}

template <int BM, int COUT>
cudaError_t launch_wide(const float* x, const int32_t* table, const float* w,
                        const float* bias, float* out, int V, int N, int cin,
                        cudaStream_t stream) {
  using L = Wide<BM, COUT>;
  const cudaError_t e = cudaFuncSetAttribute(
      wide_kernel<BM, COUT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L::SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid((N + BM - 1) / BM);
  wide_kernel<BM, COUT><<<grid, L::THREADS, L::SMEM, stream>>>(
      x, table, w, bias, out, V, N, cin);
  return cudaGetLastError();
}

// the card's SM count, read once per device
cudaError_t sm_count(int* sms) {
  constexpr int kDevices = 64;
  static int counts[kDevices] = {};   // 0: not read yet
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kDevices && counts[dev] != 0) {
    *sms = counts[dev];
    return cudaSuccess;
  }
  e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && dev < kDevices) counts[dev] = *sms;
  return e;
}

// site tile of the wide family: 128 where that still gives every SM two
// tiles (on the H100 SXM's 132 SMs: stages 1-2 and down2, N >= 46k), 64
// below (stage 3 and down3, N = 31,651); chosen by timing both tiles
int wide_tile(int N, int sms) { return N >= 128 * 2 * sms ? 128 : 64; }

template <int BM>
cudaError_t dispatch_wide(const float* x, const int32_t* table,
                          const float* w, const float* bias, float* out,
                          int V, int N, int cin, int cout, cudaStream_t s) {
  switch (cout) {
    case 8: return launch_wide<BM, 8>(x, table, w, bias, out, V, N, cin, s);
    case 16: return launch_wide<BM, 16>(x, table, w, bias, out, V, N, cin, s);
    case 32: return launch_wide<BM, 32>(x, table, w, bias, out, V, N, cin, s);
    case 64: return launch_wide<BM, 64>(x, table, w, bias, out, V, N, cin, s);
    default: return launch_wide<BM, 128>(x, table, w, bias, out, V, N, cin, s);
  }
}

template <int CINP>
cudaError_t dispatch_narrow(const float* x, const int32_t* table,
                            const float* w, const float* bias, float* out,
                            int V, int N, int cin, int cout,
                            cudaStream_t s) {
  switch (cout) {
    case 8: return launch_narrow<CINP, 8>(x, table, w, bias, out, V, N, cin, s);
    case 16:
      return launch_narrow<CINP, 16>(x, table, w, bias, out, V, N, cin, s);
    default:
      return launch_narrow<CINP, 32>(x, table, w, bias, out, V, N, cin, s);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// C ABI for ctypes.

// Returns a cudaError_t: cudaErrorInvalidValue for a shape the kernel does
// not take, cudaErrorMisalignedAddress for x, W or out not 16-byte aligned,
// else the launch status.
extern "C" int futuredet_gather_conv(const float* x, const int32_t* table,
                                     const float* w, const float* bias,
                                     float* out, int V, int N, int cin,
                                     int cout, void* stream) {
  const int route = route_of(cin, cout);
  if (N < 0 || V < 0 || route == 0) return (int)cudaErrorInvalidValue;
  if (!aligned16(x) || !aligned16(w) || !aligned16(out))
    return (int)cudaErrorMisalignedAddress;
  if (N == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1)
    return (int)(cin <= 8 ? dispatch_narrow<8>(x, table, w, bias, out, V, N,
                                               cin, cout, s)
                          : dispatch_narrow<16>(x, table, w, bias, out, V, N,
                                                cin, cout, s));
  int sms = 0;
  const cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return (int)e;
  return (int)(wide_tile(N, sms) == 128
                   ? dispatch_wide<128>(x, table, w, bias, out, V, N, cin,
                                        cout, s)
                   : dispatch_wide<64>(x, table, w, bias, out, V, N, cin,
                                       cout, s));
}
