// Gather tables of the sparse middle, built on the card from site bitmaps
// with rank lookups.
//
// Replaces no TPU kernel. The JAX package builds its tables with XLA ops
// (futuredet_tpu/ops/sparse_conv.py: make_grid's sort, the searchsorted
// neighbour probes, downsample_coords' sort-dedupe); the port's plain
// builders (futuredet_torch/ops/sparse_conv.py, the CPU implementations of
// the same operators and the oracle of these kernels) are chains of small
// PyTorch ops, about 850 launches and 74 host syncs a VoxelNet scene on
// the card: pageable constants, boolean mask selections and torch.unique.
// That host work, not the device's, set the middle's time.
//
// One structure serves every table: the SITE MAP of a stage, an int2 per
// 32 cells of the batch-folded grid, {bits, prefix}: bit j of word w of
// sample b is cell b * 32 * words + 32 w + j (cell = (z * H + y) * X + x,
// words = ceil(Z * Y * X / 32) a sample), set where a site is, and prefix
// the number of sites in the words before it. A site's rank,
//   prefix[w] + popc(bits[w] & ((1 << j) - 1)),
// is its position in ascending batch-folded id, b * Z * Y * X + cell: the
// plain builders' sorted order, so every table is bit for bit theirs.
//
//   make_grid:  memset, set the N sites' bits (atomicOr), count and scan
//     the words (two launches), then every site writes itself at its rank
//     (a scatter, no sort): sorted coords, sample, id and the permutation.
//   neighbor, strided gather and strided inverse tables: one launch, a
//     thread per query site and its 27 taps, each tap a bounds test (dims
//     are kernel arguments) and one 8-byte load of the target map's entry;
//     the absent marker where the cell is outside or empty. Row k of the
//     (27, N) table is written coalesced.
//   downsample (spconv's generative rule): memset, each input site ORs
//     its up to 8 output cells into the output map, count and scan; the
//     host reads the total (the one sync, which sizes N_out); then one
//     thread per word writes its set bits in bit order, which is ascending
//     id order: sorted and unique without a sort.
//
// Bound: bytes, and little of them. At the published grid the stage-0 map
// is 41 x 1440 x 1440 / 32 words x 8 B = 21 MB (memset and scanned once a
// scene, ~15 us at 3.35 TB/s), stage 1 2.7 MB, stages 2-3 under 0.4 MB;
// the lookups read 27 entries per site from L2-resident maps. What the
// design removes is the host's part: launches per table 1 (5 for the
// grid, 6 for a downsample with its copy of the total), syncs 1 per
// downsample, none elsewhere.
//
// The C entries return a cudaError_t (0 on success). They allocate
// nothing: the wrapper passes every output and the scan's block sums.
// Sites must lie inside their grid, with a sample index below the batch
// size, and be distinct (the voxelizer's guarantee). A grid's site that
// breaks this fails a device-side assert, as the plain builder raises: its
// output rows would otherwise be left unwritten. No write leaves a buffer.

#include <cuda_runtime.h>

// the sites' precondition is checked in every build
#undef NDEBUG
#include <cassert>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kScanPerThread = 8;
constexpr int kScanWords = kThreads * kScanPerThread;  // words a scan block
constexpr int kTaps = 27;

// the three lookups of futuredet_sparse_table: query cell
// (scale * c + sign * offset_k + shift) / div
enum TableKind { kSubm = 0, kStrided = 1, kInverse = 2 };

struct Grid {
  int d, h, w;         // extents z, y, x
  long long words;     // 32-cell words a sample
  long long cells;     // d * h * w
};

Grid make_grid_of(int d, int h, int w) {
  Grid g;
  g.d = d;
  g.h = h;
  g.w = w;
  g.cells = static_cast<long long>(d) * h * w;
  g.words = (g.cells + 31) / 32;
  return g;
}

__device__ __forceinline__ bool inside(long long z, long long y, long long x,
                                       const Grid& g) {
  return z >= 0 && z < g.d && y >= 0 && y < g.h && x >= 0 && x < g.w;
}

__device__ __forceinline__ int cell_of(int z, int y, int x, const Grid& g) {
  return (z * g.h + y) * g.w + x;
}

__device__ __forceinline__ long long bit_of(long long b, int cell,
                                            const Grid& g) {
  return b * g.words * 32 + cell;
}

// the rank of `bit` among the map's set bits, or `absent` where it is clear
__device__ __forceinline__ int rank_of(const int2* __restrict__ map,
                                       long long bit, int absent) {
  const int2 e = __ldg(map + (bit >> 5));
  const unsigned word = static_cast<unsigned>(e.x);
  const unsigned j = static_cast<unsigned>(bit & 31);
  if (!((word >> j) & 1u)) return absent;
  return e.y + __popc(word & ((1u << j) - 1u));
}

// sets the bit; returns whether it was set before
__device__ __forceinline__ bool set_bit(int2* map, long long bit) {
  const unsigned m = 1u << static_cast<unsigned>(bit & 31);
  return atomicOr(reinterpret_cast<unsigned*>(map + (bit >> 5)), m) & m;
}

// exclusive scan of v over the block; *total gets the block's sum
__device__ __forceinline__ int block_exclusive_scan(int v, int* total) {
  __shared__ int warp_sums[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  int before = 0, sum = 0;
#pragma unroll
  for (int k = 0; k < kThreads / 32; ++k) {
    const int s = warp_sums[k];
    before += k < warp ? s : 0;
    sum += s;
  }
  __syncthreads();  // warp_sums is reused by the next call
  *total = sum;
  return before + incl - v;
}

template <typename C>
__device__ __forceinline__ bool site_bit(const C* __restrict__ coords,
                                         const long long* __restrict__ batch,
                                         long long i, const Grid& g,
                                         int batch_size, long long* bit,
                                         long long* b, int* cell) {
  const long long z = coords[3 * i], y = coords[3 * i + 1],
                  x = coords[3 * i + 2];
  *b = batch ? batch[i] : 0;
  if (!inside(z, y, x, g) || *b < 0 || *b >= batch_size) return false;
  *cell = cell_of(static_cast<int>(z), static_cast<int>(y),
                  static_cast<int>(x), g);
  *bit = bit_of(*b, *cell, g);
  return true;
}

template <typename C>
__global__ void __launch_bounds__(kThreads)
    site_mark_kernel(const C* __restrict__ coords,
                     const long long* __restrict__ batch, long long n, Grid g,
                     int batch_size, int2* __restrict__ map) {
  const long long i = blockIdx.x * static_cast<long long>(kThreads) +
                      threadIdx.x;
  if (i >= n) return;
  long long bit, b;
  int cell;
  const bool held = site_bit(coords, batch, i, g, batch_size, &bit, &b, &cell);
  assert(held && "make_grid: a site outside the grid or the batch");
  const bool twice = held && set_bit(map, bit);
  assert(!twice && "make_grid: two sites in one cell");
}

// each site writes itself at its rank: the sorted grid and the permutation
template <typename C>
__global__ void __launch_bounds__(kThreads)
    site_sort_kernel(const C* __restrict__ coords,
                     const long long* __restrict__ batch, long long n, Grid g,
                     int batch_size, const int2* __restrict__ map,
                     long long* __restrict__ out_coords,
                     long long* __restrict__ out_batch,
                     long long* __restrict__ out_ids,
                     long long* __restrict__ out_order) {
  const long long i = blockIdx.x * static_cast<long long>(kThreads) +
                      threadIdx.x;
  if (i >= n) return;
  long long bit, b;
  int cell;
  if (!site_bit(coords, batch, i, g, batch_size, &bit, &b, &cell)) return;
  const long long r = rank_of(map, bit, 0);
  out_ids[r] = b * g.cells + cell;
  out_coords[3 * r] = coords[3 * i];
  out_coords[3 * r + 1] = coords[3 * i + 1];
  out_coords[3 * r + 2] = coords[3 * i + 2];
  out_batch[r] = b;
  out_order[r] = i;
}

// the sites of each scan block's words
__global__ void __launch_bounds__(kThreads)
    sitemap_count_kernel(const int2* __restrict__ map, long long m,
                         int* __restrict__ block_sums) {
  const long long base = blockIdx.x * static_cast<long long>(kScanWords) +
                         threadIdx.x;
  int c = 0;
#pragma unroll
  for (int k = 0; k < kScanPerThread; ++k) {
    const long long w = base + k * kThreads;
    if (w < m) c += __popc(static_cast<unsigned>(map[w].x));
  }
  int sum;
  block_exclusive_scan(c, &sum);
  if (threadIdx.x == 0) block_sums[blockIdx.x] = sum;
}

// prefix of every word: the block's offset is the sum of the block sums
// before it (at most a few thousand, read from L2), then the block scans
// its words in rows of kThreads, coalesced
__global__ void __launch_bounds__(kThreads)
    sitemap_scan_kernel(int2* __restrict__ map, long long m,
                        const int* __restrict__ block_sums,
                        int* __restrict__ total) {
  int before = 0;
  for (unsigned k = threadIdx.x; k < blockIdx.x; k += kThreads)
    before += block_sums[k];
  int carry;
  block_exclusive_scan(before, &carry);
  const long long base = blockIdx.x * static_cast<long long>(kScanWords) +
                         threadIdx.x;
#pragma unroll
  for (int k = 0; k < kScanPerThread; ++k) {
    const long long w = base + k * kThreads;
    const int c = w < m ? __popc(static_cast<unsigned>(map[w].x)) : 0;
    int row;
    const int excl = block_exclusive_scan(c, &row);
    if (w < m) map[w].y = carry + excl;
    carry += row;
  }
  if (total != nullptr && blockIdx.x == gridDim.x - 1 && threadIdx.x == 0)
    *total = carry;
}

// spconv's generative rule: per axis p = c + pad reaches q = p / 2, and
// q - 1 where p is even
__global__ void __launch_bounds__(kThreads)
    downsample_mark_kernel(const long long* __restrict__ coords,
                           const long long* __restrict__ batch, long long n,
                           Grid out, int pz, int py, int px, int batch_size,
                           int2* __restrict__ map) {
  const long long i = blockIdx.x * static_cast<long long>(kThreads) +
                      threadIdx.x;
  if (i >= n) return;
  const long long b = batch[i];
  assert(b >= 0 && b < batch_size &&
         "downsample_coords: a site outside the batch");
  if (b < 0 || b >= batch_size) return;
  const int z = static_cast<int>(coords[3 * i]) + pz;
  const int y = static_cast<int>(coords[3 * i + 1]) + py;
  const int x = static_cast<int>(coords[3 * i + 2]) + px;
#pragma unroll
  for (int bz = 0; bz < 2; ++bz) {
    const int qz = (z >> 1) - bz;
    if ((bz && (z & 1)) || qz < 0 || qz >= out.d) continue;
#pragma unroll
    for (int by = 0; by < 2; ++by) {
      const int qy = (y >> 1) - by;
      if ((by && (y & 1)) || qy < 0 || qy >= out.h) continue;
#pragma unroll
      for (int bx = 0; bx < 2; ++bx) {
        const int qx = (x >> 1) - bx;
        if ((bx && (x & 1)) || qx < 0 || qx >= out.w) continue;
        set_bit(map, bit_of(b, cell_of(qz, qy, qx, out), out));
      }
    }
  }
}

// one thread a word: its set bits, in bit order, at their ranks
__global__ void __launch_bounds__(kThreads)
    downsample_compact_kernel(const int2* __restrict__ map, long long m,
                              Grid g, long long* __restrict__ coords,
                              long long* __restrict__ batch,
                              long long* __restrict__ ids) {
  const long long wi = blockIdx.x * static_cast<long long>(kThreads) +
                       threadIdx.x;
  if (wi >= m) return;
  const int2 e = map[wi];
  unsigned word = static_cast<unsigned>(e.x);
  if (!word) return;
  const long long b = wi / g.words;
  const int cell0 = static_cast<int>(wi - b * g.words) * 32;
  const int hw = g.h * g.w;
  long long r = e.y;
  while (word) {
    const int cell = cell0 + __ffs(word) - 1;
    word &= word - 1;
    ids[r] = b * g.cells + cell;
    coords[3 * r] = cell / hw;
    coords[3 * r + 1] = (cell / g.w) % g.h;
    coords[3 * r + 2] = cell % g.w;
    batch[r] = b;
    ++r;
  }
}

// table[k][i]: the rank in `map` (grid g) of query site i's tap k, the cell
// (kScale * c_i + kSign * offset_k + shift) / kDiv of the same sample, or
// `absent` where that is outside g, not a whole cell, or empty; offset_k =
// (dz, dy, dx) row-major, k = (dz + 1) * 9 + (dy + 1) * 3 + (dx + 1)
template <int kScale, int kSign, int kDiv>
__global__ void __launch_bounds__(kThreads)
    sparse_table_kernel(const long long* __restrict__ coords,
                        const long long* __restrict__ batch, long long n,
                        Grid g, int sz, int sy, int sx,
                        const int2* __restrict__ map, int batch_size,
                        int absent, int* __restrict__ table) {
  const long long i = blockIdx.x * static_cast<long long>(kThreads) +
                      threadIdx.x;
  if (i >= n) return;
  const long long b = batch[i];
  // a sample the map does not hold has no sites
  const bool held = b >= 0 && b < batch_size;
  const int cz = static_cast<int>(coords[3 * i]) * kScale + sz;
  const int cy = static_cast<int>(coords[3 * i + 1]) * kScale + sy;
  const int cx = static_cast<int>(coords[3 * i + 2]) * kScale + sx;
#pragma unroll
  for (int k = 0; k < kTaps; ++k) {
    int qz = cz + kSign * (k / 9 - 1);
    int qy = cy + kSign * ((k / 3) % 3 - 1);
    int qx = cx + kSign * (k % 3 - 1);
    int r = absent;
    if (held && (kDiv == 1 || !((qz | qy | qx) & 1))) {
      if (kDiv == 2) {
        qz >>= 1;
        qy >>= 1;
        qx >>= 1;
      }
      if (inside(qz, qy, qx, g)) r = rank_of(map, bit_of(b, cell_of(
                                                     qz, qy, qx, g), g),
                                             absent);
    }
    table[k * n + i] = r;
  }
}

unsigned blocks_for(long long n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

cudaError_t scan(int2* map, long long m, int* sums, int* total,
                 cudaStream_t s) {
  const unsigned blocks =
      static_cast<unsigned>((m + kScanWords - 1) / kScanWords);
  sitemap_count_kernel<<<blocks, kThreads, 0, s>>>(map, m, sums);
  sitemap_scan_kernel<<<blocks, kThreads, 0, s>>>(map, m, sums, total);
  return cudaGetLastError();
}

template <typename C>
cudaError_t site_grid(const C* coords, const long long* batch, long long n,
                      const Grid& g, int batch_size, int2* map, int* sums,
                      long long* out_coords, long long* out_batch,
                      long long* out_ids, long long* out_order,
                      cudaStream_t s) {
  const long long m = batch_size * g.words;
  cudaError_t err = cudaMemsetAsync(map, 0, m * sizeof(int2), s);
  if (err != cudaSuccess) return err;
  if (n > 0)
    site_mark_kernel<C><<<blocks_for(n), kThreads, 0, s>>>(
        coords, batch, n, g, batch_size, map);
  err = scan(map, m, sums, nullptr, s);
  if (err != cudaSuccess || n == 0) return err;
  site_sort_kernel<C><<<blocks_for(n), kThreads, 0, s>>>(
      coords, batch, n, g, batch_size, map, out_coords, out_batch, out_ids,
      out_order);
  return cudaGetLastError();
}

}  // namespace

// coords (n, 3) zyx of int32 (coord_bytes 4) or int64 (8), batch (n,)
// int64 or null (all sample 0) -> map (batch_size, words, 2) int32 and the
// sorted coords (n, 3), batch, ids and order (n,) int64. sums: one int32 a
// scan block.
extern "C" int futuredet_make_grid(const void* coords, int coord_bytes,
                                   const void* batch, long long n, int d,
                                   int h, int w, int batch_size, void* map,
                                   void* sums, void* out_coords,
                                   void* out_batch, void* out_ids,
                                   void* out_order, void* stream) {
  const Grid g = make_grid_of(d, h, w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* bt = static_cast<const long long*>(batch);
  int2* mp = static_cast<int2*>(map);
  int* sm = static_cast<int*>(sums);
  long long* oc = static_cast<long long*>(out_coords);
  long long* ob = static_cast<long long*>(out_batch);
  long long* oi = static_cast<long long*>(out_ids);
  long long* oo = static_cast<long long*>(out_order);
  if (coord_bytes == 4)
    return static_cast<int>(site_grid(static_cast<const int*>(coords), bt, n,
                                      g, batch_size, mp, sm, oc, ob, oi, oo,
                                      s));
  if (coord_bytes == 8)
    return static_cast<int>(site_grid(static_cast<const long long*>(coords),
                                      bt, n, g, batch_size, mp, sm, oc, ob,
                                      oi, oo, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// the output map of a kernel-3 stride-2 conv over sites (n, 3) / (n,)
// int64 with pads (pz, py, px): out map (batch_size, words, 2) int32 of
// the output grid (d, h, w), and total[0] = its sites
extern "C" int futuredet_downsample_mark(const void* coords,
                                         const void* batch, long long n,
                                         int d, int h, int w, int pz, int py,
                                         int px, int batch_size, void* map,
                                         void* sums, void* total,
                                         void* stream) {
  const Grid g = make_grid_of(d, h, w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int2* mp = static_cast<int2*>(map);
  const long long m = batch_size * g.words;
  const cudaError_t err = cudaMemsetAsync(mp, 0, m * sizeof(int2), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0)
    downsample_mark_kernel<<<blocks_for(n), kThreads, 0, s>>>(
        static_cast<const long long*>(coords),
        static_cast<const long long*>(batch), n, g, pz, py, px, batch_size,
        mp);
  return static_cast<int>(scan(mp, m, static_cast<int*>(sums),
                               static_cast<int*>(total), s));
}

// the output sites of that map, ascending: coords (N_out, 3), batch and
// ids (N_out,) int64
extern "C" int futuredet_downsample_compact(const void* map, int batch_size,
                                            int d, int h, int w,
                                            void* coords, void* batch,
                                            void* ids, void* stream) {
  const Grid g = make_grid_of(d, h, w);
  const long long m = batch_size * g.words;
  downsample_compact_kernel<<<blocks_for(m), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int2*>(map), m, g, static_cast<long long*>(coords),
      static_cast<long long*>(batch), static_cast<long long*>(ids));
  return static_cast<int>(cudaGetLastError());
}

// a (27, n) int32 table of the query sites coords (n, 3) / batch (n,)
// int64 into the target map (batch_size, words, 2) of grid (d, h, w),
// `absent` its site count:
// kind 0 submanifold (c + offset), 1 strided gather (2 c + offset + shift,
// shift = 1 - pad), 2 strided inverse ((c - offset + shift) / 2, shift =
// pad - 1)
extern "C" int futuredet_sparse_table(int kind, const void* coords,
                                      const void* batch, long long n, int d,
                                      int h, int w, int sz, int sy, int sx,
                                      const void* map, int batch_size,
                                      int absent, void* table,
                                      void* stream) {
  if (n <= 0) return 0;
  const Grid g = make_grid_of(d, h, w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* c = static_cast<const long long*>(coords);
  const long long* b = static_cast<const long long*>(batch);
  const int2* mp = static_cast<const int2*>(map);
  int* t = static_cast<int*>(table);
  switch (kind) {
    case kSubm:
      sparse_table_kernel<1, 1, 1><<<blocks_for(n), kThreads, 0, s>>>(
          c, b, n, g, sz, sy, sx, mp, batch_size, absent, t);
      break;
    case kStrided:
      sparse_table_kernel<2, 1, 1><<<blocks_for(n), kThreads, 0, s>>>(
          c, b, n, g, sz, sy, sx, mp, batch_size, absent, t);
      break;
    case kInverse:
      sparse_table_kernel<1, -1, 2><<<blocks_for(n), kThreads, 0, s>>>(
          c, b, n, g, sz, sy, sx, mp, batch_size, absent, t);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
