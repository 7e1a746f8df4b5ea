// Greedy rotated-BEV NMS survivor mask, batched over independent problems.
//
// Replaces kernel K1 of the JAX package, futuredet_tpu/ops/pallas_nms.py
// (_nms_kernel, entry nms_alive_mask), which walks the score-sorted boxes
// in order, computes IoU(i, all) on the fly and kills later boxes whose IoU
// with a live box i exceeds the threshold. That kernel's one-hot scalar
// extraction and (8, 128) SoA tiles are TPU devices; this one computes the
// same mask in two launches on one stream:
//
//   pass 1, pair tests (grid: upper-triangle 64 x 64 tiles x problem, 256
//     threads): a linear block index maps to (row block rb, column block
//     cb >= rb), so no block is launched left of the diagonal. The block
//     computes the frames of its 64 row (killer) and 64 column (victim)
//     boxes into shared memory: centre, half extents, cos, sin, area, the
//     four corners and the cull reach (below), with the plain version's
//     rounding (the same cosf/sinf on the same input, the same corner
//     sums). Each box's frame is thus computed by each of its row's tiles;
//     a separate frame launch timed slower at 7 x 1000, on the main path's
//     boxes and on a dense cluster. Each warp owns 8 rows: it runs the cull
//     over its 8 x 64 pairs, one ballot per 32, and queues the pairs that
//     need the full test in shared memory (__popc of the ballot gives each
//     lane its slot). Then its lanes take the queue in turn, so they stay
//     busy on the few full tests instead of idling behind one lane's row,
//     and set kill bits with a shared atomicOr. Row i's word cb of mask[p]
//     holds bit j for each tested victim j > i with IoU > thr.
//   pass 2, the greedy walk (one warp per problem): lane w holds word w
//     of the `removed` bitset in registers (K words a lane, col_blocks <=
//     32 K), seeded once with the invalid boxes. Per 64-row block, the
//     block's mask rows are staged by cp.async into a ring of 3 shared
//     buffers, two blocks ahead of the walk. The diagonal word is resolved
//     in registers: every lane takes rem = removed[rb], reads the 64
//     diagonal words (shared-memory broadcasts that do not depend on rem,
//     so they pipeline) and walks r = 0..63, rem |= diag[r] where bit r of
//     rem is clear; the loop has no barrier. The keep bits are what is left
//     clear; lane w then ORs word w of every kept row into its removed[w],
//     64 independent reads.
//
// The cull. For thr >= 0 an IoU of 0 kills nothing, and pass 1 skips a
// pair when the centre distance exceeds the sum of the two boxes' reaches,
//   reach = R + 2 eps + kCullRel * (|x| + |y| + R) + kCullAbs,
// R = sqrt(hx^2 + hy^2) the circumradius, eps = kClipEps. The test is
// d2 > (reach_k + reach_v)^2, true only for finite operands, and a box
// with a non-finite field gets an infinite reach: NaN and inf boxes always
// take the full test. Why a skipped pair has plain IoU exactly 0: the
// corners and clip boxes the plain version computes lie within R + sqrt(2)
// eps of their centre, up to rounding. With u = 2^-24 and S = |x_k| +
// |y_k| + |x_v| + |y_v| + R_k + R_v, fp32 rounding moves a rotated corner
// coordinate by at most ~10 u S (the corner sums, the centre differences
// and the rotation each round once per operation), and the slab quotients
// (h - p) / d round by at most 3 u relative, which moves either end of a
// clipped piece by at most 3 u |d| <= 6 u S along the edge. So an edge that
// stays farther than ~16 u S (~1e-6 S) from the clip box, in exact
// geometry, clips to an empty piece in fp32, every piece is 0 and so is the
// IoU. The reach grants kCullRel S = 1e-4 S, ~100x that, plus kCullAbs =
// 1e-4 m. On the main path centres lie within post_center_limit_range
// (+-61.2 m), so S <= 245 m + R_k + R_v and the margin stays under 3 cm
// beyond the circles; sizes up to exp of the head output (any finite size)
// only grow R and S with it. tests/test_torch_nms_cull.py holds a copy of
// the predicate against the plain IoU.
//
// The IoU is K1's formula op for op, as ops/rotated_iou.py writes it: the
// same _DIV_EPS and _CLIP_EPS, the same parallel-edge handling (1e30 for
// infinity), the victim's edges clipped to the killer shrunk by eps and the
// killer's edges clipped to the victim grown by eps, union = max(area_v +
// area_k - inter, 1e-8), kill iff inter / union > thr. Built with
// -fmad=false and precise cosf/sinf, and its min/max propagate NaN as
// torch.minimum/maximum/clamp do, so every kill bit equals the plain
// PyTorch version's, NaN and inf boxes included.
//
// What bounds it on this card. Pass 1: the full tests, ~450 fp32
// operations with 32 IEEE divisions each, for the pairs the cull keeps, and
// ~8 operations for each pair it skips; the 64 x 64 tiles x G problems give
// ~950 blocks of 256 threads at G = 7, N = 1000, close to the card's
// resident threads (128 and 512 threads a block timed no better). Pass 2:
// latency, not throughput: a chain of ceil(N/64) dependent 64-step
// register loops per problem, the G problems on G warps, with the next two
// blocks' rows in flight.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 64;            // boxes per mask word
constexpr int kPairThreads = 256;
constexpr int kWarps = kPairThreads / 32;
constexpr int kRowsPerWarp = kBlock / kWarps;
constexpr int kMaxColBlocks = 128;    // N <= 8192: K <= 4 words a lane
constexpr int kStages = 3;            // pass 2's ring of staged row blocks
constexpr float kDivEps = 1e-12f;
constexpr float kClipEps = 1e-5f;
constexpr float kBig = 1e30f;
constexpr float kCullRel = 1e-4f;
constexpr float kCullAbs = 1e-4f;

// fields of a box's frame
enum {
  fX, fY, fHX, fHY, fC, fS, fArea, fReach, fCX, fCY = fCX + 4,
  kFields = fCY + 4
};

typedef unsigned long long u64;

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// box b = [x, y, dx, dy, ang] -> its 16 frame fields
__device__ __forceinline__ void compute_frame(const float* b, float* f) {
  const float x = b[0], y = b[1], dx = b[2], dy = b[3], ang = b[4];
  const float hx = dx * 0.5f;
  const float hy = dy * 0.5f;
  const float c = cosf(ang);
  const float s = sinf(ang);
  f[fX] = x;
  f[fY] = y;
  f[fHX] = hx;
  f[fHY] = hy;
  f[fC] = c;
  f[fS] = s;
  f[fArea] = dx * dy;
  const float r = sqrtf(hx * hx + hy * hy);
  const float reach =
      r + 2.0f * kClipEps + kCullRel * (fabsf(x) + fabsf(y) + r) + kCullAbs;
  const float inf = __int_as_float(0x7f800000);
  f[fReach] = (isfinite(reach) && isfinite(ang)) ? reach : inf;
  // CCW corners (+,+), (-,+), (-,-), (+,-), in the order and rounding of
  // K1's _corners
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float lx = (k == 0 || k == 3) ? hx : -hx;
    const float ly = k < 2 ? hy : -hy;
    f[fCX + k] = x + c * lx - s * ly;
    f[fCY + k] = y + s * lx + c * ly;
  }
}

struct Frame {
  float x, y, hx, hy, c, s, area, cx[4], cy[4];
};

__device__ __forceinline__ Frame load_frame(const float (*f)[kBlock], int b) {
  Frame r;
  r.x = f[fX][b];
  r.y = f[fY][b];
  r.hx = f[fHX][b];
  r.hy = f[fHY][b];
  r.c = f[fC][b];
  r.s = f[fS][b];
  r.area = f[fArea][b];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    r.cx[k] = f[fCX + k][b];
    r.cy[k] = f[fCY + k][b];
  }
  return r;
}

__device__ __forceinline__ void slab(float p, float d, float h, float& lo,
                                     float& hi) {
  const bool par = fabsf(d) < kDivEps;
  const float safe = par ? kDivEps : d;
  const float t1 = (-h - p) / safe;
  const float t2 = (h - p) / safe;
  lo = min_nan(t1, t2);
  hi = max_nan(t1, t2);
  if (par) {
    const bool inside = fabsf(p) <= h;
    lo = inside ? -kBig : kBig;
    hi = inside ? kBig : -kBig;
  }
}

// p x q of the edge p->q clipped to |.| <= h in the frame (cx, cy, cc, cs)
__device__ __forceinline__ float edge_sum(float px, float py, float qx,
                                          float qy, float cx, float cy,
                                          float cc, float cs, float hx,
                                          float hy) {
  const float rpx = cc * (px - cx) + cs * (py - cy);
  const float rpy = -cs * (px - cx) + cc * (py - cy);
  const float rqx = cc * (qx - cx) + cs * (qy - cy);
  const float rqy = -cs * (qx - cx) + cc * (qy - cy);
  float lox, hix, loy, hiy;
  slab(rpx, rqx - rpx, hx, lox, hix);
  slab(rpy, rqy - rpy, hy, loy, hiy);
  const float t0 = max_nan(max_nan(lox, loy), 0.0f);
  const float t1 = min_nan(min_nan(hix, hiy), 1.0f);
  if (!(t1 > t0)) return 0.0f;
  const float ex = qx - px;
  const float ey = qy - py;
  const float x0 = px + t0 * ex;
  const float y0 = py + t0 * ey;
  const float x1 = px + t1 * ex;
  const float y1 = py + t1 * ey;
  return x0 * y1 - y0 * x1;
}

// the edges of polygon (px, py) clipped to the box `clip` with half extents
// (hx, hy)
__device__ __forceinline__ float clipped_sum(const float* px, const float* py,
                                             const Frame& clip, float hx,
                                             float hy) {
  float total = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int n = (k + 1) & 3;
    total = total + edge_sum(px[k], py[k], px[n], py[n], clip.x, clip.y,
                             clip.c, clip.s, hx, hy);
  }
  return total;
}

__device__ __forceinline__ float iou_killer_victim(const Frame& k,
                                                   const Frame& v) {
  // victim edges to the killer shrunk, killer edges to the victim grown
  const float sa = clipped_sum(v.cx, v.cy, k, k.hx - kClipEps,
                               k.hy - kClipEps);
  const float sb = clipped_sum(k.cx, k.cy, v, v.hx + kClipEps,
                               v.hy + kClipEps);
  const float inter = max_nan(0.5f * (sa + sb), 0.0f);
  const float uni = max_nan(v.area + k.area - inter, 1e-8f);
  return inter / uni;
}

__global__ void __launch_bounds__(kPairThreads)
nms_pair_kernel(const float* __restrict__ boxes, int n, int col_blocks,
                float thr, u64* __restrict__ mask) {
  __shared__ float tile[2][kFields][kBlock];  // row (killer), column boxes
  const float(*rowf)[kBlock] = tile[0];
  const float(*colf)[kBlock] = tile[1];
  __shared__ u64 bits[kBlock];
  __shared__ uint16_t queue[kWarps][kRowsPerWarp * kBlock];

  // linear tile index -> (rb, cb >= rb), row by row of the upper triangle
  int t = blockIdx.x;
  int rb = 0;
  while (t >= col_blocks - rb) {
    t -= col_blocks - rb;
    ++rb;
  }
  const int cb = rb + t;
  const int g = blockIdx.y;
  const int i0 = rb * kBlock;
  const int j0 = cb * kBlock;
  const int tid = threadIdx.x;
  // the 128 frames of the tile: a row block's frames are computed again by
  // each of its tiles, which times better than a separate launch
  const float* bg = boxes + static_cast<size_t>(g) * n * 5;
  for (int e = tid; e < 2 * kBlock; e += kPairThreads) {
    const int side = e < kBlock ? 0 : 1;
    const int box = e & (kBlock - 1);
    const int i = (side ? j0 : i0) + box;
    float f[kFields];
    if (i < n) {
      compute_frame(bg + static_cast<size_t>(i) * 5, f);
    } else {
#pragma unroll
      for (int k = 0; k < kFields; ++k) f[k] = 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kFields; ++k) tile[side][k][box] = f[k];
  }
  if (tid < kBlock) bits[tid] = 0ull;
  __syncthreads();

  // the cull over the warp's 8 x 64 pairs; survivors queue for the full test
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const unsigned below = (1u << lane) - 1u;
  const bool cull = thr >= 0.0f;
  uint16_t* todo = queue[warp];
  int count = 0;
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int rl = warp * kRowsPerWarp + rr;
    const int i = i0 + rl;
    const float kx = rowf[fX][rl];
    const float ky = rowf[fY][rl];
    const float kr = rowf[fReach][rl];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = h * 32 + lane;
      const int j = j0 + c;
      bool need = i < n && j < n && j > i;
      if (need && cull) {
        const float dx = colf[fX][c] - kx;
        const float dy = colf[fY][c] - ky;
        const float r = kr + colf[fReach][c];
        need = !(dx * dx + dy * dy > r * r);
      }
      const unsigned vote = __ballot_sync(0xffffffffu, need);
      if (need) todo[count + __popc(vote & below)] =
          static_cast<uint16_t>((rl << 6) | c);
      count += __popc(vote);
    }
  }
  __syncwarp();
  for (int e = lane; e < count; e += 32) {
    const int p = todo[e];
    const int rl = p >> 6;
    const int c = p & 63;
    const Frame k = load_frame(rowf, rl);
    const Frame v = load_frame(colf, c);
    if (iou_killer_victim(k, v) > thr) atomicOr(&bits[rl], 1ull << c);
  }
  __syncthreads();
  if (tid < kBlock && i0 + tid < n)
    mask[(static_cast<size_t>(g) * n + i0 + tid) * col_blocks + cb] =
        bits[tid];
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1));
}

// rows r0 .. r0 + nr - 1 of problem g's mask, whole rows (words left of the
// diagonal were never written and are not read): one contiguous run
__device__ __forceinline__ void stage_rows(const u64* mg, int n,
                                           int col_blocks, int blk, u64* dst,
                                           int lane) {
  const int r0 = blk * kBlock;
  const int cnt = min(kBlock, n - r0) * col_blocks;
  const u64* src = mg + static_cast<size_t>(r0) * col_blocks;
  for (int e = lane; e < cnt; e += 32) cp_async8(dst + e, src + e);
}

template <int K>
__global__ void __launch_bounds__(32)
nms_walk_kernel(const u64* __restrict__ mask, const uint8_t* __restrict__ valid,
                int n, int col_blocks, uint8_t* __restrict__ alive) {
  extern __shared__ u64 rows[];  // kStages buffers of kBlock x col_blocks
  const int g = blockIdx.x;
  const int lane = threadIdx.x;
  const u64* mg = mask + static_cast<size_t>(g) * n * col_blocks;
  const uint8_t* vg = valid + static_cast<size_t>(g) * n;
  uint8_t* ag = alive + static_cast<size_t>(g) * n;
  const int stride = kBlock * col_blocks;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < col_blocks)
      stage_rows(mg, n, col_blocks, s, rows + s * stride, lane);
    cp_async_commit();
  }
  // word lane + 32 k of the removed bitset, seeded with the invalid boxes
  // and the rows past n (they never survive and never kill): one ballot
  // pair per 64-row block, its word kept by lane blk % 32
  u64 removed[K];
#pragma unroll
  for (int k = 0; k < K; ++k) removed[k] = 0ull;
#pragma unroll 4
  for (int blk = 0; blk < col_blocks; ++blk) {
    const int i = blk * kBlock + lane;
    const bool v0 = i < n && vg[i];
    const bool v1 = i + 32 < n && vg[i + 32];
    const u64 word =
        ~(static_cast<u64>(__ballot_sync(0xffffffffu, v0)) |
          (static_cast<u64>(__ballot_sync(0xffffffffu, v1)) << 32));
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (lane + 32 * k == blk) removed[k] = word;
  }

  int slot = 0;
  for (int rb = 0; rb < col_blocks; ++rb) {
    const int ahead = rb + kStages - 1;
    if (ahead < col_blocks)
      stage_rows(mg, n, col_blocks, ahead, rows + (ahead % kStages) * stride,
                 lane);
    cp_async_commit();
    cp_async_wait_ring();
    __syncwarp();
    const u64* cur = rows + slot * stride;
    slot = slot + 1 == kStages ? 0 : slot + 1;

    u64 own = 0ull;
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (k == (rb >> 5)) own = removed[k];
    u64 rem = __shfl_sync(0xffffffffu, own, rb & 31);
    // the diagonal word, in registers, with no barrier: the 32 words of a
    // half are read before its chain of 32 dependent steps
    const u64* diag = cur + rb;
#pragma unroll
    for (int h = 0; h < kBlock; h += 32) {
      u64 d[32];
#pragma unroll
      for (int r = 0; r < 32; ++r) d[r] = diag[(h + r) * col_blocks];
#pragma unroll
      for (int r = 0; r < 32; ++r)
        if (!(rem & (1ull << (h + r)))) rem |= d[r];
    }
    const u64 keep = ~rem;
    const int r0 = rb * kBlock;
    if (r0 + lane < n)
      ag[r0 + lane] = static_cast<uint8_t>((keep >> lane) & 1ull);
    if (r0 + 32 + lane < n)
      ag[r0 + 32 + lane] = static_cast<uint8_t>((keep >> (lane + 32)) & 1ull);

    // the kept rows' words right of the diagonal, each lane its own: 64
    // independent reads
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int w = lane + 32 * k;
      if (w > rb && w < col_blocks) {
        u64 acc = 0ull;
#pragma unroll
        for (int r = 0; r < kBlock; ++r)
          if (keep & (1ull << r)) acc |= cur[r * col_blocks + w];
        removed[k] |= acc;
      }
    }
    __syncwarp();  // the buffer read here is restaged kStages - 1 steps on
  }
}

template <int K>
int launch_walk(const u64* mask, const uint8_t* valid, int g, int n,
                int col_blocks, uint8_t* alive, cudaStream_t s) {
  const size_t smem = sizeof(u64) * kStages * kBlock * col_blocks;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        nms_walk_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  nms_walk_kernel<K><<<g, 32, smem, s>>>(mask, valid, n, col_blocks, alive);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// boxes (G, N, 5) f32 [x, y, dx, dy, ang], score-sorted within each problem;
// valid (G, N) u8 (bool); mask scratch (G, N, ceil(N/64)) u64; alive
// (G, N) u8 (bool), written 0 or 1. N <= 8192: pass 2 stages 3 * 64 *
// ceil(N/64) words in shared memory (192 KB at the ceiling) and keeps
// ceil(N/64) / 32 <= 4 words a lane. Launches on `stream`; returns the
// first launch error (0 = none).
extern "C" int futuredet_rotate_nms_alive(const void* boxes, const void* valid,
                                          int g, int n, float thr,
                                          void* mask, void* alive,
                                          void* stream) {
  if (g <= 0 || n <= 0) return 0;
  const int col_blocks = (n + kBlock - 1) / kBlock;
  if (col_blocks > kMaxColBlocks)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid1(col_blocks * (col_blocks + 1) / 2, g);
  nms_pair_kernel<<<grid1, kPairThreads, 0, s>>>(
      static_cast<const float*>(boxes), n, col_blocks, thr,
      static_cast<u64*>(mask));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const u64* m = static_cast<const u64*>(mask);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  uint8_t* a = static_cast<uint8_t*>(alive);
  if (col_blocks <= 32) return launch_walk<1>(m, v, g, n, col_blocks, a, s);
  if (col_blocks <= 64) return launch_walk<2>(m, v, g, n, col_blocks, a, s);
  return launch_walk<4>(m, v, g, n, col_blocks, a, s);
}
