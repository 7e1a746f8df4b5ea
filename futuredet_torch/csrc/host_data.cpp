// Host data path of the port: the nuScenes sweep loader, the hard
// voxelizer and a seeded point shuffle, plain C++ behind a C interface
// (loaded with ctypes by futuredet_torch/utils/native.py, built with g++ by
// ops/_build.py). No device code.
//
// The port's own copy of `fd_load_sweeps`, `fd_voxelize` and `fd_shuffle`
// of the JAX package's host library (csrc/futuredet_host.cpp), with the
// same outputs:
//
//   fd_load_sweeps   multi-threaded .bin decode + homogeneous transform +
//                    remove_close + time-lag column + concat; the threads
//                    run while the caller (ctypes.CDLL) holds no GIL
//   fd_voxelize      hard voxelization (FCFS capping, zyx coords), the
//                    semantics of the reference numba kernel
//                    (_points_to_voxel_reverse_kernel)
//   fd_shuffle       Fisher-Yates point shuffle (seeded mt19937_64)
//
// Where the JAX library counts a sweep it cannot read as empty, this one
// returns -(i + 1) for the first unreadable sweep i, and the binding
// raises.
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <random>
#include <thread>
#include <vector>

extern "C" {

// Read one nuScenes .bin (float32 rows of `file_feats`), apply an optional
// 4x4 row-major transform to xyz, drop points with |x|<radius && |y|<radius
// (before the transform, as the reference's remove_close), and write rows
// of keep_feats + 1 floats (the last the time lag) into `stage`, sized by
// the file's own point count. Returns the points written, or -1 on an IO
// error.
static int64_t load_one(const char* path, const double* tm, double time_lag,
                        double close_radius, std::vector<float>& stage,
                        int64_t max_out, int file_feats, int keep_feats) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  long bytes = ftell(f);
  fseek(f, 0, SEEK_SET);
  int64_t n = bytes / (sizeof(float) * file_feats);
  std::vector<float> buf(n * file_feats);
  size_t rd = fread(buf.data(), sizeof(float), n * file_feats, f);
  fclose(f);
  if ((int64_t)rd != n * file_feats) return -1;

  int out_feats = keep_feats + 1;
  if (max_out > n) max_out = n;
  stage.resize(max_out * out_feats);
  float* out = stage.data();
  int64_t w = 0;
  for (int64_t i = 0; i < n && w < max_out; ++i) {
    const float* p = &buf[i * file_feats];
    double x = p[0], y = p[1], z = p[2];
    if (std::fabs(x) < close_radius && std::fabs(y) < close_radius) continue;
    if (tm) {
      double nx = tm[0] * x + tm[1] * y + tm[2] * z + tm[3];
      double ny = tm[4] * x + tm[5] * y + tm[6] * z + tm[7];
      double nz = tm[8] * x + tm[9] * y + tm[10] * z + tm[11];
      x = nx; y = ny; z = nz;
    }
    float* o = &out[w * out_feats];
    o[0] = (float)x; o[1] = (float)y; o[2] = (float)z;
    for (int k = 3; k < keep_feats; ++k) o[k] = p[k];
    o[keep_feats] = (float)time_lag;
    ++w;
  }
  return w;
}

// paths: `n_sweeps` strings, the keyframe first; transforms: (n_sweeps, 16)
// row-major, rows with has_tm[i] == 0 unused; lags: (n_sweeps,).
// out: (max_points, keep_feats+1). Returns the points written, or -(i + 1)
// when sweep i cannot be read.
int64_t fd_load_sweeps(const char* const* paths, const uint8_t* has_tm,
                       const double* transforms, const double* lags,
                       int64_t n_sweeps, double close_radius,
                       float* out, int64_t max_points,
                       int file_feats, int keep_feats) {
  int out_feats = keep_feats + 1;
  // per-sweep staging buffers written in parallel, then compacted
  std::vector<std::vector<float>> stage(n_sweeps);
  std::vector<int64_t> counts(n_sweeps, 0);
  std::vector<std::thread> workers;
  int64_t hw = std::max<int64_t>(1, std::thread::hardware_concurrency());
  int n_threads = (int)std::min<int64_t>(n_sweeps, hw);
  for (int t = 0; t < n_threads; ++t) {
    workers.emplace_back([&, t]() {
      for (int64_t i = t; i < n_sweeps; i += n_threads) {
        // the keyframe (i == 0) keeps its close points: the reference's
        // loading.py applies remove_close to sweeps only
        double radius = (i == 0) ? 0.0 : close_radius;
        const double* tm = has_tm[i] ? &transforms[i * 16] : nullptr;
        counts[i] = load_one(paths[i], tm, lags[i], radius, stage[i],
                             max_points, file_feats, keep_feats);
      }
    });
  }
  for (auto& w : workers) w.join();
  for (int64_t i = 0; i < n_sweeps; ++i)
    if (counts[i] < 0) return -(i + 1);

  int64_t total = 0;
  for (int64_t i = 0; i < n_sweeps && total < max_points; ++i) {
    int64_t take = std::min(counts[i], max_points - total);
    std::memcpy(&out[total * out_feats], stage[i].data(),
                take * out_feats * sizeof(float));
    total += take;
  }
  return total;
}

// The reference numba voxelizer (_points_to_voxel_reverse_kernel,
// point_cloud_ops.py:8-55): points in order, a voxel's first point claims
// its id, at most max_points a voxel and max_voxels voxels.
int64_t fd_voxelize(const float* points, int64_t n_points, int n_feats,
                    const double* voxel_size, const double* coors_range,
                    int max_points, int64_t max_voxels,
                    float* voxels,        // (max_voxels, max_points, n_feats)
                    int32_t* coors,       // (max_voxels, 3) zyx
                    int32_t* num_points,  // (max_voxels,)
                    int32_t* coor_to_idx  // (gz*gy*gx,) scratch, -1 filled
                    ) {
  int grid[3];
  for (int j = 0; j < 3; ++j)
    grid[j] = (int)std::llround((coors_range[3 + j] - coors_range[j])
                                 / voxel_size[j]);
  int64_t voxel_num = 0;
  for (int64_t i = 0; i < n_points; ++i) {
    int c[3];
    bool failed = false;
    for (int j = 0; j < 3; ++j) {
      int v = (int)std::floor((points[i * n_feats + j] - coors_range[j])
                              / voxel_size[j]);
      if (v < 0 || v >= grid[j]) { failed = true; break; }
      c[2 - j] = v;
    }
    if (failed) continue;
    int64_t flat = ((int64_t)c[0] * grid[1] + c[1]) * grid[0] + c[2];
    int32_t idx = coor_to_idx[flat];
    if (idx == -1) {
      if (voxel_num >= max_voxels) continue;
      idx = (int32_t)voxel_num++;
      coor_to_idx[flat] = idx;
      coors[idx * 3 + 0] = c[0];
      coors[idx * 3 + 1] = c[1];
      coors[idx * 3 + 2] = c[2];
    }
    int32_t num = num_points[idx];
    if (num < max_points) {
      std::memcpy(&voxels[((int64_t)idx * max_points + num) * n_feats],
                  &points[i * n_feats], n_feats * sizeof(float));
      num_points[idx] = num + 1;
    }
  }
  return voxel_num;
}

void fd_shuffle(float* points, int64_t n, int n_feats, uint64_t seed) {
  std::mt19937_64 rng(seed);
  std::vector<float> tmp(n_feats);
  for (int64_t i = n - 1; i > 0; --i) {
    int64_t j = rng() % (i + 1);
    std::memcpy(tmp.data(), &points[i * n_feats], n_feats * sizeof(float));
    std::memcpy(&points[i * n_feats], &points[j * n_feats],
                n_feats * sizeof(float));
    std::memcpy(&points[j * n_feats], tmp.data(), n_feats * sizeof(float));
  }
}

}  // extern "C"
