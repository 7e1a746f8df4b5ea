// Greedy rotated-BEV NMS survivor mask, batched over independent problems.
//
// Replaces kernel K1 of the JAX package, futuredet_tpu/ops/pallas_nms.py
// (_nms_kernel, entry nms_alive_mask), which walks the score-sorted boxes
// in order, computes IoU(i, all) on the fly and kills later boxes whose IoU
// with a live box i exceeds the threshold. That kernel's one-hot scalar
// extraction and (8, 128) SoA tiles are TPU devices; this one computes the
// same mask in two passes, the shape of the reference iou3d_nms kernel:
//
//   pass 1 (grid: 64-column block x 64-row block x problem, 64 threads):
//     the block stages its 64 column boxes in shared memory; thread i tests
//     its row box i (the killer) against every column j > i (the victim)
//     and sets bit j of the word mask[p][i][colblock]. Blocks left of the
//     diagonal hold no j > i and return at once.
//   pass 2 (one warp per problem): walks i = 0..N-1 keeping the `removed`
//   bitset in shared memory, seeded with the invalid boxes; a box that is
//   not removed survives and ORs its mask row into `removed`. Mask rows are
//   staged 64 at a time in shared memory, so the sequential walk reads no
//   device memory. No host round trip.
//
// The IoU is K1's formula op for op: the same _DIV_EPS and _CLIP_EPS, the
// same parallel-edge handling (1e30 for infinity), the victim's edges
// clipped to the killer shrunk by eps and the killer's edges clipped to the
// victim grown by eps, union = max(area_v + area_k - inter, 1e-8), kill iff
// inter / union > thr. Built with -fmad=false and precise cosf/sinf, so it
// rounds as the plain PyTorch version (futuredet_torch/ops/rotated_iou.py)
// does.
//
// Bound on the card: pass 1 makes ~G*N^2/2 pair tests of ~300 fp32
// operations each (about 1 GFLOP at G=7, N=1000: ~16 us at the 67 TFLOP/s
// fp32 vector peak); pass 2 is a sequential walk of N short steps per
// problem, latency-bound, with the G problems in parallel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 64;           // boxes per mask word
constexpr float kDivEps = 1e-12f;
constexpr float kClipEps = 1e-5f;
constexpr float kBig = 1e30f;

struct Box {
  float x, y, hx, hy, c, s, area;
};

__device__ __forceinline__ Box load_box(const float* b) {
  Box r;
  r.x = b[0];
  r.y = b[1];
  r.hx = b[2] * 0.5f;
  r.hy = b[3] * 0.5f;
  r.c = cosf(b[4]);
  r.s = sinf(b[4]);
  r.area = b[2] * b[3];
  return r;
}

__device__ __forceinline__ void slab(float p, float d, float h, float& lo,
                                     float& hi) {
  const bool par = fabsf(d) < kDivEps;
  const float safe = par ? kDivEps : d;
  const float t1 = (-h - p) / safe;
  const float t2 = (h - p) / safe;
  lo = fminf(t1, t2);
  hi = fmaxf(t1, t2);
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
  const float t0 = fmaxf(fmaxf(lox, loy), 0.0f);
  const float t1 = fminf(fminf(hix, hiy), 1.0f);
  if (!(t1 > t0)) return 0.0f;
  const float ex = qx - px;
  const float ey = qy - py;
  const float x0 = px + t0 * ex;
  const float y0 = py + t0 * ey;
  const float x1 = px + t1 * ex;
  const float y1 = py + t1 * ey;
  return x0 * y1 - y0 * x1;
}

// CCW corners, in the order and rounding of K1's _corners
__device__ __forceinline__ void corners(const Box& b, float* cx, float* cy) {
  const float sx[4] = {1.f, -1.f, -1.f, 1.f};
  const float sy[4] = {1.f, 1.f, -1.f, -1.f};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float lx = sx[k] > 0.f ? b.hx : -b.hx;
    const float ly = sy[k] > 0.f ? b.hy : -b.hy;
    cx[k] = b.x + b.c * lx - b.s * ly;
    cy[k] = b.y + b.s * lx + b.c * ly;
  }
}

__device__ __forceinline__ float clipped_sum(const float* px, const float* py,
                                             const Box& clip, float grow) {
  const float hx = clip.hx + grow;
  const float hy = clip.hy + grow;
  float total = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int n = (k + 1) & 3;
    total = total + edge_sum(px[k], py[k], px[n], py[n], clip.x, clip.y,
                             clip.c, clip.s, hx, hy);
  }
  return total;
}

__device__ __forceinline__ float iou_killer_victim(const Box& k,
                                                   const float* kx,
                                                   const float* ky,
                                                   const Box& v) {
  float vx[4], vy[4];
  corners(v, vx, vy);
  const float sa = clipped_sum(vx, vy, k, -kClipEps);  // victim edges
  const float sb = clipped_sum(kx, ky, v, kClipEps);   // killer edges
  const float inter = fmaxf(0.5f * (sa + sb), 0.0f);
  const float uni = fmaxf(v.area + k.area - inter, 1e-8f);
  return inter / uni;
}

__global__ void nms_mask_kernel(const float* __restrict__ boxes, int n,
                                int col_blocks, float thr,
                                unsigned long long* __restrict__ mask) {
  const int cb = blockIdx.x;
  const int rb = blockIdx.y;
  const int g = blockIdx.z;
  if (cb < rb) return;  // no victim j > i left of the diagonal
  __shared__ Box cols[kBlock];
  const float* bg = boxes + static_cast<size_t>(g) * n * 5;
  const int j0 = cb * kBlock;
  const int ncol = min(kBlock, n - j0);
  const int t = threadIdx.x;
  if (t < ncol) cols[t] = load_box(bg + static_cast<size_t>(j0 + t) * 5);
  __syncthreads();
  const int i = rb * kBlock + t;
  if (i >= n) return;
  const Box bi = load_box(bg + static_cast<size_t>(i) * 5);
  float kx[4], ky[4];
  corners(bi, kx, ky);
  unsigned long long bits = 0ull;
  for (int c = (cb == rb) ? t + 1 : 0; c < ncol; ++c) {
    if (iou_killer_victim(bi, kx, ky, cols[c]) > thr) bits |= 1ull << c;
  }
  mask[(static_cast<size_t>(g) * n + i) * col_blocks + cb] = bits;
}

__global__ void nms_scan_kernel(const unsigned long long* __restrict__ mask,
                                const uint8_t* __restrict__ valid, int n,
                                int col_blocks,
                                uint8_t* __restrict__ alive) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* removed = smem;               // col_blocks words
  unsigned long long* rows = smem + col_blocks;     // kBlock x col_blocks
  const int g = blockIdx.x;
  const int lane = threadIdx.x;
  const unsigned long long* mg = mask + static_cast<size_t>(g) * n * col_blocks;
  const uint8_t* vg = valid + static_cast<size_t>(g) * n;
  uint8_t* ag = alive + static_cast<size_t>(g) * n;

  // invalid boxes start out removed: they never survive and never kill
  for (int w = lane; w < col_blocks; w += 32) {
    unsigned long long word = 0ull;
    for (int b = 0; b < kBlock; ++b) {
      const int idx = w * kBlock + b;
      if (idx < n && !vg[idx]) word |= 1ull << b;
    }
    removed[w] = word;
  }
  __syncwarp();

  for (int r0 = 0; r0 < n; r0 += kBlock) {
    const int rb = r0 / kBlock;
    const int nr = min(kBlock, n - r0);
    // words left of the diagonal block were never written and are not read
    const int width = col_blocks - rb;
    for (int e = lane; e < nr * width; e += 32) {
      const int r = e / width;
      const int w = rb + e % width;
      rows[r * col_blocks + w] =
          mg[static_cast<size_t>(r0 + r) * col_blocks + w];
    }
    __syncwarp();
    for (int r = 0; r < nr; ++r) {
      const bool keep = !((removed[rb] >> r) & 1ull);
      __syncwarp();
      if (lane == 0) ag[r0 + r] = keep ? 1 : 0;
      if (keep) {
        for (int w = rb + lane; w < col_blocks; w += 32)
          removed[w] |= rows[r * col_blocks + w];
      }
      __syncwarp();
    }
  }
}

}  // namespace

// boxes (G, N, 5) f32 [x, y, dx, dy, ang], score-sorted within each problem;
// valid (G, N) u8; mask scratch (G, N, ceil(N/64)) u64; alive (G, N) u8.
// Pass 2 stages 65 * ceil(N/64) words in shared memory: the caller keeps
// that within 48 KB (N <= 6016). Launches on `stream`; returns the first
// launch error (0 = none).
extern "C" int futuredet_rotate_nms_alive(const void* boxes, const void* valid,
                                          int g, int n, float thr, void* mask,
                                          void* alive, void* stream) {
  if (g <= 0 || n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int col_blocks = (n + kBlock - 1) / kBlock;
  dim3 grid1(col_blocks, col_blocks, g);
  nms_mask_kernel<<<grid1, kBlock, 0, s>>>(
      static_cast<const float*>(boxes), n, col_blocks, thr,
      static_cast<unsigned long long*>(mask));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem =
      sizeof(unsigned long long) * static_cast<size_t>(col_blocks) *
      (kBlock + 1);
  nms_scan_kernel<<<g, 32, smem, s>>>(
      static_cast<const unsigned long long*>(mask),
      static_cast<const uint8_t*>(valid), n, col_blocks,
      static_cast<uint8_t*>(alive));
  return static_cast<int>(cudaGetLastError());
}
