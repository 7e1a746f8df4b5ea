// Sparse gather-conv, kernel K2 of futuredet_torch, its bf16 family, for
// Hopper (sm_90a).
//
//   out[n, :] = bias + sum_{k=0..26} x[table[k, n], :] @ W[k]
//
// x (V, Cin) and W (27, Cin, Cout) bf16 (raw 16-bit words), table (27, N)
// int32 (an entry outside [0, V) is an absent neighbour and adds zero),
// bias (Cout,) fp32 or null, out (N, Cout) fp32; any Cin >= 1, Cout in
// {8, 16, 32, 64, 128}. The serving mode of the JAX kernel
// (futuredet_tpu/ops/pallas_gather.py::_kernel with compute_dtype
// bfloat16: middle_gather_algo="window_bf16", middle_sparse_dtype=
// "bfloat16"), which rounds x and W to bf16 and sums the products in fp32.
// A bf16 x bf16 product is exact in fp32, so this kernel and its plain
// version (ops/pallas_gather.py::gather_conv_plain: bf16 rows, fp32
// products and sums) differ only in the order of the sums. The fp32
// families are in gather_conv_kernel.cu.
//
// The implicit GEMM. Its reduction runs over (tap, channel) K-slots,
// flattened: each tap takes CP = Cin rounded up to 8 slots (the slots past
// Cin hold zeros), so slot s is tap s / CP, channel s % CP, and the 27 * CP
// slots are cut into chunks of 64 (kChunk; the last one zero-padded). A
// chunk is one stage of the ring and spans several taps where Cin < 64:
// eight at Cin <= 8 (conv_input, Cin = 5: 4 chunks where the mma.sync
// kernel before it took 27 barrier steps), four at Cin = 16, two at 32.
// A chunk is skipped where no site of the tile has any of its taps.
//
// The tile. A block owns BM = 128 output sites (64 where N / 128 would
// leave SMs without a tile) and all Cout columns, and walks site tiles
// (a persistent grid: as many blocks as fit on the SMs at once). Its warps
// are specialised:
// - BM / 64 consumer warpgroups, 64 rows each, run wgmma.mma_async
//   m64nNk16 bf16 -> fp32 with A and B read from shared memory through
//   descriptors (N = Cout; two n64 products at Cout = 128);
// - one copying warpgroup gathers A. Copier p owns one row of the tile
//   (two copiers a row at BM = 64). The tile's index block [27][rows]
//   arrives a tile ahead by 4-byte cp.async into a double buffer; at a
//   tile's start each copier takes its row's 27 entries out of shared
//   memory and the tap mask is ORed over the copiers (a named barrier).
//   Per chunk a copier copies its row's 16-byte granules of 8 K-slots with
//   cp.async (zero-fill for an absent neighbour) where Cin % 8 == 0, and
//   with 2-byte loads, packed and stored, otherwise (the rows are then not
//   16-byte aligned);
// - one warp writes each stage's word (its chunk, whether it ends the
//   tile) and, where W is streamed, loads the stage's W tile by TMA.
// The ring has 4 stages (kStages) of 64 K-slots: A (BM rows of 128 B) and,
// where W is streamed, its B tile. Each stage has a full mbarrier (every
// copier's cp.async.mbarrier.arrive.noinc, which fires once the thread's
// copies have landed; the stage-word warp's arrive, with the TMA bytes
// expected; where rows are stored by hand, every copier's arrive after a
// proxy fence) and an empty one (every consumer thread, after its wgmma
// group has retired). Consumers fence the async proxy after their wait, so
// that wgmma sees the cp.async writes. There is no __syncthreads after the
// role split.
//
// Layouts. A is K-major with the 128-byte swizzle: row r of the tile is
// 128 B of one chunk, granule j at (j ^ r % 8) * 16 (the gather writes
// that directly, 16 B a copy), SBO 1024 B; a k16 step adds 32 B to the
// descriptor's start. B is W's rows as they lie in device memory, Cout
// contiguous, so it is MN-major (the transpose bit): K-rows of Cout * 2
// bytes under the 32-, 64- or 128-byte swizzle at Cout = 16, 32, 64 (two
// 64-wide atoms at Cout = 128), no swizzle at Cout = 8: the layout TMA
// writes for a box of 64 rows. Every B tile holds a single atom along N
// for one wgmma, so only the stride between groups of 8 K-rows is read;
// the descriptor carries it in both LBO and SBO.
//
// W resident or streamed. Where the packed W (chunks x 64 x Cout x 2
// bytes) takes at most kResidentBytes (128 KB; on the main path every conv
// with Cin <= 32: 8-112 KB), all threads stage it once per block before
// the split, and consumers address chunk c of it. Otherwise (stage 2,
// down3, stage 3) each stage's 64 x Cout tile is loaded by TMA, boxes of a
// 2D tensor map over W's 27 * Cin rows (cuTensorMapEncodeTiled, found
// through cudaGetDriverEntryPoint: no link to the driver library; rows
// past the 27th tap read as zeros): a chunk's K-slots are 64 consecutive
// rows of W where Cin % 8 == 0. Else the copiers stream it by cp.async.
//
// The accumulation. Each chunk's 4 k16 products (per 64-column atom) go
// into a fresh fp32 partial (the first with scale-d 0), which is added to
// the tile's sums once its group has retired: one running wgmma
// accumulator over all chunks would leave every add to the tensor core,
// which truncates as it accumulates. The sums live in registers, Cout / 2
// floats a consumer thread, and the epilogue adds the bias and stores each
// output once, in a fixed order: no atomics, relaunches are bit-identical.
//
// What holds it back (PERF.md, PR 15): the copiers. Issuing a chunk's
// scattered 16-byte cp.async takes a copier warpgroup 0.6-1.0 us (it waits
// on the memory system, not on its instruction count), against the
// consumers' 0.22-0.48 us a chunk. Spreading each row's granules over 8
// lanes, twice the copier warps, a deeper ring, 64-site tiles and indices
// in registers measured no better. Not done: multicasting streamed W to a
// 2-block cluster, setmaxnreg (no instance spills without it).
//
// Bound on the H100 (3.35 TB/s, 989 TFLOP/s dense bf16): bytes = V*Cin*2
// + 27*N*4 (table) + 27*Cin*Cout*2 + N*Cout*4 read or written once;
// operations = 2 * present (k, n) pairs * Cin * Cout (chip_smoke.py
// k2_bound). Tests: tests/test_torch_cuda.py on a card,
// tests/test_torch_gather_conv.py (the K layout and the plan, in numpy),
// tests/test_torch_bf16.py (the plain version against the JAX one).
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kTaps = 27;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kChunk = 64;                 // K-slots a stage: 128 B rows
constexpr int kStages = 4;                 // ring depth
constexpr int kProducers = 128;            // one gathering warpgroup
constexpr int kResidentBytes = 131072;     // W resident up to this
constexpr int kSmemMax = 232448;           // one block's shared memory

__host__ __device__ constexpr int kslots(int cin) {   // K-slots a tap
  return (cin + 7) / 8 * 8;
}
__host__ __device__ constexpr int nchunks(int cin) {
  return (kTaps * kslots(cin) + kChunk - 1) / kChunk;
}
__host__ __device__ constexpr bool bf16_takes(int cin, int cout) {
  return cin >= 1 &&
         (cout == 8 || cout == 16 || cout == 32 || cout == 64 || cout == 128);
}
__host__ __device__ constexpr int b_chunk_bytes(int cout) {
  return kChunk * cout * 2;
}
__host__ __device__ constexpr bool w_resident(int cin, int cout) {
  return nchunks(cin) * b_chunk_bytes(cout) <= kResidentBytes;
}
// shared memory of one block: 1 KB of alignment slack, the A ring, W
// (resident) or the B ring, the index blocks [2][27][128], 2 x kStages
// mbarriers, the stage words and the tap masks [2][4]
__host__ __device__ constexpr int bf16_smem(int cin, int cout, int bm) {
  return 1024 + kStages * bm * 128 +
         (w_resident(cin, cout) ? nchunks(cin) : kStages) *
             b_chunk_bytes(cout) +
         2 * kTaps * kProducers * 4 + 2 * kStages * 8 + kStages * 4 + 8 * 4;
}
// site tile: 128 where N gives every SM one, else 64
int bf16_tile(int N, int sms) { return (N + 127) / 128 >= sms ? 128 : 64; }

template <int COUT>
struct Bf16 {
  static constexpr int AN = COUT < 64 ? COUT : 64;   // N of one wgmma
  static constexpr int ATOMS = COUT / AN;            // wgmmas a k16 step
  static constexpr int RB = AN * 2;                  // bytes of a B K-row
  static constexpr int BMASK = RB == 128 ? 7 : RB == 64 ? 3 : RB == 32 ? 1 : 0;
  // descriptor layout type: 0 none, 1 128 B, 2 64 B, 3 32 B swizzle
  static constexpr uint64_t SWZ =
      RB == 128 ? 1 : RB == 64 ? 2 : RB == 32 ? 3 : 0;
  static constexpr int B_CHUNK = b_chunk_bytes(COUT);
  static_assert(ATOMS * kChunk * RB == B_CHUNK, "B tile");
};

// ------------------------------------------------------------ PTX helpers

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  // src-size 0 writes 16 zero bytes and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n.reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(
          smem_addr(bar))
      : "memory");
}

// fires (one of the barrier's expected arrivals) once every cp.async this
// thread issued before it has landed
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// an arrival that also expects `bytes` of TMA copies on the barrier
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar,
                                                   uint32_t bytes) {
  asm volatile(
      "{\n.reg .b64 state;\n"
      "mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n}\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// one box of a 2D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_addr(bar))
      : "memory");
}

// generic-proxy writes to shared memory (cp.async, st.shared) before
// async-proxy reads (wgmma)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the copying warpgroup and the stage-word warp
__device__ __forceinline__ void producers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kProducers + 32) : "memory");
}

__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t swz) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(lbo >> 4) << 16 |
         (uint64_t)(sbo >> 4) << 32 | swz << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// the registers a wgmma wrote are read only after its group retired
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x N fp32, N / 2 a thread) = A (64 x 16, K-major) x B (16 x N,
// MN-major: the transpose bit), + D where `accumulate`
template <int N>
struct Wgmma;

template <>
struct Wgmma<8> {
  __device__ static void mma(float (&d)[4], uint64_t da, uint64_t db,
                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(da), "l"(db), "r"(accumulate)
        : "memory");
  }
};

template <>
struct Wgmma<16> {
  __device__ static void mma(float (&d)[8], uint64_t da, uint64_t db,
                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(accumulate)
        : "memory");
  }
};

template <>
struct Wgmma<32> {
  __device__ static void mma(float (&d)[16], uint64_t da, uint64_t db,
                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15}, %16, %17, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "l"(da), "l"(db), "r"(accumulate)
        : "memory");
  }
};

template <>
struct Wgmma<64> {
  __device__ static void mma(float (&d)[32], uint64_t da, uint64_t db,
                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(accumulate)
        : "memory");
  }
};

// ----------------------------------------------------------------- layouts

// byte offset of granule j (K-slots 8j..8j+7) of row r in an A stage
__device__ __forceinline__ uint32_t a_off(int r, int j) {
  return r * 128 + ((j ^ (r & 7)) << 4);
}

// byte offset of granule g (columns 8g..8g+7) of K-row kk in a B tile: the
// swizzle XORs address bits 4.. with bits 7.. (as TMA writes it)
template <int COUT>
__device__ __forceinline__ uint32_t b_off(int kk, int g) {
  using L = Bf16<COUT>;
  constexpr int G = L::RB / 16;   // granules in one atom's K-row
  const uint32_t lin = kk * L::RB + (g % G) * 16;
  return (g / G) * (kChunk * L::RB) + (lin ^ (((lin >> 7) & L::BMASK) << 4));
}

// granule g of B K-row kk of chunk c: W[tap][ch][8g..8g+7], zeros past Cin
// and past the 27th tap
template <int COUT>
__device__ __forceinline__ void stage_w(uint32_t tile, const uint16_t* w,
                                        int cin, int cp, int c, int kk,
                                        int g) {
  const int s = c * kChunk + kk, tap = s / cp, ch = s - tap * cp;
  const bool ok = tap < kTaps && ch < cin;
  cp_async16(tile + b_off<COUT>(kk, g),
             ok ? w + ((size_t)(tap * cin + ch) * COUT + g * 8) : w, ok);
}

// row n's 27 table entries into a column of an index block, as one
// cp.async group (zeros past N: readers check the row)
__device__ __forceinline__ void load_idx(uint32_t dst, const int32_t* table,
                                         int n, int N) {
  const bool ok = n < N;
#pragma unroll
  for (int k = 0; k < kTaps; ++k)
    cp_async4(dst + k * kProducers * 4, ok ? table + (size_t)k * N + n : table,
              ok);
  cp_async_commit();
}

// waits for this thread's cp.async groups but the `newer` newest
__device__ __forceinline__ void cp_async_wait_older(int newer) {
  switch (newer) {
    case 0: cp_async_wait_group<0>(); break;
    case 1: cp_async_wait_group<1>(); break;
    case 2: cp_async_wait_group<2>(); break;
    case 3: cp_async_wait_group<3>(); break;
    default: cp_async_wait_group<kStages>(); break;
  }
}

// ------------------------------------------------------------------ kernel

// threads of a block: BM / 64 consumer warpgroups, the copying warpgroup
// and the warp that publishes each stage's word
__host__ __device__ constexpr int bf16_threads(int bm) {
  return 128 * (bm / 64) + kProducers + 32;
}

template <int COUT, int BM, bool RES>
__global__ void __launch_bounds__(bf16_threads(BM), COUT <= 32 ? 2 : 1)
bf16_kernel(const uint16_t* __restrict__ x, const int32_t* __restrict__ table,
            const uint16_t* __restrict__ w, const float* __restrict__ bias,
            float* __restrict__ out, int V, int N, int cin,
            const __grid_constant__ CUtensorMap wmap) {
  using L = Bf16<COUT>;
  constexpr int NC = BM / 64;                 // consumer warpgroups
  constexpr int G = COUT / 8;                 // granules a B K-row
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int cp = kslots(cin), nch = nchunks(cin);
  const int gpt = cp / 8;                     // granules a tap
  const bool vec = cin % 8 == 0;              // 16-byte rows of 8 channels
  // streamed W by TMA where a chunk's K-slots are contiguous rows of W
  const bool tma = !RES && vec;
  const uint32_t s_a = smem_addr(base);
  uint8_t* b_ptr = base + kStages * BM * 128;
  const uint32_t s_b = smem_addr(b_ptr);
  int* s_idx = reinterpret_cast<int*>(b_ptr + (RES ? nch : kStages) *
                                                  L::B_CHUNK);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(s_idx + 2 * kTaps * kProducers);
  uint64_t* empty = full + kStages;
  int* s_info = reinterpret_cast<int*>(empty + kStages);   // chunk | last
  unsigned* s_mask = reinterpret_cast<unsigned*>(s_info + kStages);

  const int tid = threadIdx.x;
  const int ntiles = (N + BM - 1) / BM;
  const bool producer = tid >= NC * 128;
  const int p = tid - NC * 128;   // copier < kProducers <= stage-word warp
  if (tid == 0) {
    // full: every copier's cp.async arrival, the stage word's arrival, and
    // where rows are stored by hand, every copier's arrival after them
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], kProducers + 1 + (vec ? 0 : kProducers));
      mbar_init(&empty[s], NC * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the first tile's index block, in flight while W is staged
  if (producer && p < BM)
    load_idx(smem_addr(s_idx + p), table, blockIdx.x * BM + p, N);
  if (RES) {
    for (int e = tid; e < nch * kChunk * G; e += blockDim.x) {
      const int c = e / (kChunk * G), r = e - c * (kChunk * G);
      stage_w<COUT>(s_b + c * L::B_CHUNK, w, cin, cp, c, r / G, r % G);
    }
  }
  cp_async_wait_all();
  fence_proxy_async();
  __syncthreads();

  if (producer) {
    // The copiers signal their copies only through
    // cp.async.mbarrier.arrive; the stage word and W's TMA loads come from
    // a warp of their own.
    const int lane = tid & 31, pw = p >> 5;
    const bool copier = p < kProducers;
    // a copier's row of the tile and its granules of each chunk: all 8, or
    // four of them at BM = 64 (two copiers a row)
    constexpr int GPT = 8 * BM / kProducers;
    const int row = BM == 128 ? p & (kProducers - 1) : (p >> 1) & (BM - 1);
    const int j0 = BM == 128 ? 0 : (p & 1) * 4;
    int slot = 0, buf = 0, issued = 0;
    uint32_t parity = 1;             // the first round finds stages empty
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, buf ^= 1) {
      // the tile's index block [27][rows], double-buffered: the next
      // tile's copies must not overtake a slow reader of this one
      int* idx = s_idx + buf * kTaps * kProducers;
      const int n0 = tile * BM;
      if (p < BM) cp_async_wait_older(issued);   // this thread's column
      producers_sync();   // ... and every other copier's
      // the row's 27 entries, taken out of shared memory once a tile
      int nx[kTaps];
      unsigned m = 0;
#pragma unroll
      for (int k = 0; k < kTaps; ++k) {
        nx[k] = n0 + row < N ? idx[k * kProducers + row] : -1;
        m |= ((unsigned)nx[k] < (unsigned)V ? 1u : 0u) << k;
      }
      m = __reduce_or_sync(kFull, m);
      if (lane == 0 && copier) s_mask[buf * 4 + pw] = m;
      producers_sync();
      unsigned mask = s_mask[buf * 4] | s_mask[buf * 4 + 1] |
                      s_mask[buf * 4 + 2] | s_mask[buf * 4 + 3];
      if (mask == 0) mask = 1;   // one chunk of zeros: the bias alone
      const int next = tile + gridDim.x;
      if (p < BM && next < ntiles)
        load_idx(smem_addr(s_idx + (buf ^ 1) * kTaps * kProducers + p), table,
                 next * BM + p, N);
      issued = 0;
      auto present = [&](int c) {
        const int t0 = c * kChunk / cp;
        const int t1 = min(kTaps - 1, (c * kChunk + kChunk - 1) / cp);
        return ((mask >> t0) & ((2u << (t1 - t0)) - 1)) != 0;
      };
      int last = nch - 1;
      while (!present(last)) --last;
      for (int c = 0; c <= last; ++c) {
        if (!present(c)) continue;
        mbar_wait(&empty[slot], parity);
        if (!copier) {
          if (lane == 0) {
            s_info[slot] = c | (c == last ? 1 << 30 : 0);
            if (tma) {
              // W's rows 64c .. 64c + 63, one box a 64-column atom (zeros
              // past the 27th tap)
              mbar_arrive_expect(&full[slot], L::B_CHUNK);
#pragma unroll
              for (int a = 0; a < L::ATOMS; ++a)
                tma_load_2d(s_b + slot * L::B_CHUNK + a * kChunk * L::RB,
                            &wmap, a * L::AN, c * kChunk, &full[slot]);
            } else {
              mbar_arrive(&full[slot]);
            }
          }
        } else {
          const uint32_t sa = s_a + slot * BM * 128;
          // this thread's granules of the chunk: tap tq and channel cq of
          // each, stepped from the first (one division a chunk), then their
          // row indices, loaded together
          int tq[GPT], cq[GPT], vq[GPT];
          {
            const int g = c * 8 + j0;
            int t = g / gpt, gi = g - t * gpt;
#pragma unroll
            for (int q = 0; q < GPT; ++q) {
              tq[q] = t;
              cq[q] = gi * 8;
              const bool wrap = ++gi == gpt;
              gi = wrap ? 0 : gi;
              t += wrap;
            }
          }
#pragma unroll
          for (int q = 0; q < GPT; ++q) vq[q] = tq[q] < kTaps ? nx[tq[q]] : -1;
          if (vec) {
            // thread p copies its row's granules (p / 2's four at BM = 64)
#pragma unroll
            for (int q = 0; q < GPT; ++q) {
              const bool ok = (unsigned)vq[q] < (unsigned)V;
              cp_async16(sa + a_off(row, j0 + q),
                         ok ? x + (size_t)vq[q] * cin + cq[q] : x, ok);
            }
          } else {
            // rows of Cin * 2 bytes, not 16-byte aligned: 2-byte loads,
            // four granules' in flight at a time
#pragma unroll
            for (int h = 0; h < GPT; h += 4) {
              uint16_t e[4][8];
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                const bool ok = (unsigned)vq[h + q] < (unsigned)V;
                const uint16_t* src =
                    x + (size_t)(ok ? vq[h + q] : 0) * cin + cq[h + q];
#pragma unroll
                for (int i = 0; i < 8; ++i)
                  e[q][i] = ok && cq[h + q] + i < cin ? __ldg(src + i)
                                                      : (uint16_t)0;
              }
#pragma unroll
              for (int q = 0; q < 4; ++q)
                asm volatile(
                    "st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                        sa + a_off(row, j0 + h + q)),
                    "r"(e[q][0] | (uint32_t)e[q][1] << 16),
                    "r"(e[q][2] | (uint32_t)e[q][3] << 16),
                    "r"(e[q][4] | (uint32_t)e[q][5] << 16),
                    "r"(e[q][6] | (uint32_t)e[q][7] << 16)
                    : "memory");
            }
          }
          if (!RES && !tma) {
            const uint32_t sb = s_b + slot * L::B_CHUNK;
            for (int e = p; e < kChunk * G; e += kProducers)
              stage_w<COUT>(sb, w, cin, cp, c, e / G, e % G);
          }
          cp_async_commit();
          ++issued;
          // cp.async writes reach wgmma through the consumers' proxy fence
          // after their wait; stores by hand through this thread's own
          mbar_arrive_cp_async(&full[slot]);
          if (!vec) {
            fence_proxy_async();
            mbar_arrive(&full[slot]);
          }
        }
        if (++slot == kStages) {
          slot = 0;
          parity ^= 1;
        }
      }
    }
    cp_async_wait_all();
  } else {
    const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
    // A: K-major, 128-byte swizzle, 8-row groups 1024 B apart (LBO unused);
    // B: MN-major, one atom along N, 8-row groups 8 RB apart (in both
    // fields)
    const uint64_t da0 = smem_desc(s_a + wg * 64 * 128, 16, 1024, 1);
    const uint64_t db0 = smem_desc(s_b, 8 * L::RB, 8 * L::RB, L::SWZ);
    int slot = 0;
    uint32_t parity = 0;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      float acc[L::ATOMS][L::AN / 2];
#pragma unroll
      for (int a = 0; a < L::ATOMS; ++a)
#pragma unroll
        for (int i = 0; i < L::AN / 2; ++i) acc[a][i] = 0.f;
      bool last = false;
      while (!last) {
        mbar_wait(&full[slot], parity);
        fence_proxy_async();
        const int info = s_info[slot];
        last = (info >> 30) & 1;
        const int c = info & 0xffff;
        // descriptors: the bases' plus the 16-byte offset of the stage
        const uint64_t da = da0 + ((slot * BM * 128) >> 4);
        const uint64_t db = db0 + (((RES ? c : slot) * L::B_CHUNK) >> 4);
        // a fresh partial per atom and chunk, added once its group retired
#pragma unroll
        for (int a = 0; a < L::ATOMS; ++a) {
          float part[L::AN / 2];
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
          for (int i = 0; i < L::AN / 2; ++i) acc[a][i] += part[i];
        }
        if (++slot == kStages) {
          slot = 0;
          parity ^= 1;
        }
      }
      // d[4j + 2h + {0, 1}]: row 16 warp + lane / 4 + 8h, columns
      // 8j + 2 (lane % 4) + {0, 1} of the atom
      const int r0 = tile * BM + wg * 64 + warp * 16 + (lane >> 2);
#pragma unroll
      for (int a = 0; a < L::ATOMS; ++a)
#pragma unroll
        for (int j = 0; j < L::AN / 8; ++j) {
          const int col = a * 64 + j * 8 + 2 * (lane & 3);
          const float b0 = bias != nullptr ? __ldg(bias + col) : 0.f;
          const float b1 = bias != nullptr ? __ldg(bias + col + 1) : 0.f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int n = r0 + 8 * h;
            if (n >= N) continue;
            float2 f = make_float2(acc[a][4 * j + 2 * h],
                                   acc[a][4 * j + 2 * h + 1]);
            if (bias != nullptr) {
              f.x += b0;
              f.y += b1;
            }
            *reinterpret_cast<float2*>(out + (size_t)n * COUT + col) = f;
          }
        }
    }
  }
}

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

// W (27 * Cin rows of Cout bf16) as a 2D tensor map whose box is one B
// atom of a chunk: 64 rows of min(Cout, 64) columns, swizzled as b_off
// lays them out; rows past 27 * Cin read as zeros
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

cudaError_t encode_w_map(CUtensorMap* map, const uint16_t* w, int cin,
                         int cout) {
  static EncodeTiled encode = nullptr;   // the driver's, found once
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (e != cudaSuccess) return e;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return cudaErrorSymbolNotFound;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const int an = cout < 64 ? cout : 64;
  const cuuint64_t dims[2] = {(cuuint64_t)cout, (cuuint64_t)kTaps * cin};
  const cuuint64_t strides[1] = {(cuuint64_t)cout * 2};
  const cuuint32_t box[2] = {(cuuint32_t)an, (cuuint32_t)kChunk};
  const cuuint32_t unit[2] = {1, 1};
  const CUtensorMapSwizzle swz =
      an == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
      : an == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
      : an == 16 ? CU_TENSOR_MAP_SWIZZLE_32B
                 : CU_TENSOR_MAP_SWIZZLE_NONE;
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<uint16_t*>(w),
      dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int COUT, int BM, bool RES>
cudaError_t launch_bf16(const uint16_t* x, const int32_t* table,
                        const uint16_t* w, const float* bias, float* out,
                        int V, int N, int cin, int sms, cudaStream_t stream) {
  constexpr int threads = bf16_threads(BM);
  const auto kernel = bf16_kernel<COUT, BM, RES>;
  const int smem = bf16_smem(cin, COUT, BM);
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int tiles = (N + BM - 1) / BM;
  const int grid = tiles < per_sm * sms ? tiles : per_sm * sms;
  CUtensorMap wmap;
  memset(&wmap, 0, sizeof wmap);
  if (!RES && cin % 8 == 0) {
    e = encode_w_map(&wmap, w, cin, COUT);
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, threads, smem, stream>>>(x, table, w, bias, out, V, N, cin,
                                          wmap);
  return cudaGetLastError();
}

template <int COUT>
cudaError_t dispatch_bf16(const uint16_t* x, const int32_t* table,
                          const uint16_t* w, const float* bias, float* out,
                          int V, int N, int cin, int sms, cudaStream_t s) {
  const bool res = w_resident(cin, COUT);
  if (bf16_tile(N, sms) == 128)
    return res ? launch_bf16<COUT, 128, true>(x, table, w, bias, out, V, N,
                                               cin, sms, s)
               : launch_bf16<COUT, 128, false>(x, table, w, bias, out, V, N,
                                                cin, sms, s);
  return res ? launch_bf16<COUT, 64, true>(x, table, w, bias, out, V, N, cin,
                                           sms, s)
             : launch_bf16<COUT, 64, false>(x, table, w, bias, out, V, N, cin,
                                            sms, s);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// C ABI for ctypes.

// x (V, Cin) and W (27, Cin, Cout) bf16 (raw 16-bit words), bias fp32 or
// null, out (N, Cout) fp32. Returns a cudaError_t: cudaErrorInvalidValue
// for a shape the kernel does not take, cudaErrorMisalignedAddress for x,
// W or out not 16-byte aligned, else the launch status.
extern "C" int futuredet_gather_conv_bf16(const uint16_t* x,
                                          const int32_t* table,
                                          const uint16_t* w,
                                          const float* bias, float* out,
                                          int V, int N, int cin, int cout,
                                          void* stream) {
  if (N < 0 || V < 0 || !bf16_takes(cin, cout))
    return (int)cudaErrorInvalidValue;
  if (!aligned16(x) || !aligned16(w) || !aligned16(out))
    return (int)cudaErrorMisalignedAddress;
  if (N == 0) return (int)cudaSuccess;
  int sms = 0;
  const cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cout) {
    case 8:
      return (int)dispatch_bf16<8>(x, table, w, bias, out, V, N, cin, sms, s);
    case 16:
      return (int)dispatch_bf16<16>(x, table, w, bias, out, V, N, cin, sms, s);
    case 32:
      return (int)dispatch_bf16<32>(x, table, w, bias, out, V, N, cin, sms, s);
    case 64:
      return (int)dispatch_bf16<64>(x, table, w, bias, out, V, N, cin, sms, s);
    default:
      return (int)dispatch_bf16<128>(x, table, w, bias, out, V, N, cin, sms,
                                     s);
  }
}
