// Greedy score-ordered matcher of the joint detection + forecasting
// metrics, host C++ behind a plain C interface (loaded with ctypes by
// futuredet_torch/utils/native.py, built with g++ by ops/_build.py).
//
// The port's own copy of `fd_accumulate2` of the JAX package's host
// library (csrc/futuredet_host.cpp); it is not a device kernel. It is the
// inner loop of eval/metrics.py::_accumulate (the nuScenes accumulate()),
// run ~40 times per class (thresholds x timesteps), and computes in fp32
// where the numpy version computes in fp64.
//
// Units (a multi-future group of members, or one prediction) come sorted by
// score. For each unit, its members are tried in order; a member matches the
// closest untaken GT of its sample at `match_timestep` unless that distance
// is >= dist_th or (when final_match_th >= 0) the final-timestep distance is
// >= final_match_th. The first success takes the GT.
//
// Outputs per unit: the tp flag, and for a TP the 8 error terms
// (trans, scale, orient, vel, attr, ade, fde, miss) in errs_out[u*8..].
// attr_err follows nuScenes attr_acc: NaN (the host cummean skips it) when
// the GT carries no attribute (id < 0), else exact-id mismatch.
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <limits>

extern "C" {

void fd_accumulate2(
    const int32_t* unit_offsets,  // (n_units+1,) into the member arrays
    int64_t n_units,
    const int32_t* mem_sample,    // (M,) sample id per member (-1 = no GTs)
    const float* mem_centers,     // (M, T, 2)
    const float* mem_size,        // (M, 3) w,l,h
    const float* mem_yaw,         // (M,)
    const float* mem_vel,         // (M, 2)
    const int32_t* mem_attr,      // (M,) attribute id (-1 = none)
    const int32_t* gt_offsets,    // (S+1,) GT rows grouped by sample id
    const float* gt_centers,      // (G, T, 2)
    const float* gt_size, const float* gt_yaw, const float* gt_vel,
    const int32_t* gt_attr,       // (G,) attribute id (-1 = none)
    int T, float dist_th, float final_match_th, int match_timestep,
    uint8_t association_oracle, float mr_thresh,
    uint8_t* tp_out,              // (n_units,)
    float* errs_out,              // (n_units, 8)
    uint8_t* taken                // (G,) zero-initialized by the caller
    ) {
  const float th2 = dist_th * dist_th;
  for (int64_t u = 0; u < n_units; ++u) {
    tp_out[u] = 0;
    for (int32_t m = unit_offsets[u]; m < unit_offsets[u + 1]; ++m) {
      int32_t s = mem_sample[m];
      if (s < 0) continue;
      int32_t g0 = gt_offsets[s], g1 = gt_offsets[s + 1];
      const float px = mem_centers[((int64_t)m * T + match_timestep) * 2];
      const float py = mem_centers[((int64_t)m * T + match_timestep) * 2 + 1];
      float best = 1e30f;
      int32_t bj = -1;
      for (int32_t j = g0; j < g1; ++j) {
        if (taken[j]) continue;
        float dx = gt_centers[((int64_t)j * T + match_timestep) * 2] - px;
        float dy = gt_centers[((int64_t)j * T + match_timestep) * 2 + 1] - py;
        float d2 = dx * dx + dy * dy;
        if (d2 < best) { best = d2; bj = j; }
      }
      if (bj < 0 || best >= th2) continue;
      // the matched prediction trajectory (oracle mode substitutes the GT's
      // own future, isolating detection quality — ref tools/dist_test.py:93)
      const float* pc = association_oracle
          ? &gt_centers[(int64_t)bj * T * 2]
          : &mem_centers[(int64_t)m * T * 2];
      const float* gc = &gt_centers[(int64_t)bj * T * 2];
      if (final_match_th >= 0.f) {
        float dx = pc[(T - 1) * 2] - gc[(T - 1) * 2];
        float dy = pc[(T - 1) * 2 + 1] - gc[(T - 1) * 2 + 1];
        if (dx * dx + dy * dy >= final_match_th * final_match_th) continue;
      }
      taken[bj] = 1;
      tp_out[u] = 1;
      float* e = &errs_out[u * 8];
      float ade = 0.f, d0 = 0.f, dF = 0.f;
      for (int t = 0; t < T; ++t) {
        float dx = pc[t * 2] - gc[t * 2];
        float dy = pc[t * 2 + 1] - gc[t * 2 + 1];
        float d = std::sqrt(dx * dx + dy * dy);
        ade += d;
        if (t == 0) d0 = d;
        if (t == T - 1) dF = d;
      }
      ade /= T;
      float inter = 1.f, volp = 1.f, volg = 1.f;
      for (int k = 0; k < 3; ++k) {
        inter *= std::min(mem_size[m * 3 + k], gt_size[bj * 3 + k]);
        volp *= mem_size[m * 3 + k];
        volg *= gt_size[bj * 3 + k];
      }
      float uni = volp + volg - inter;
      float dyaw = std::fmod((double)mem_yaw[m] - gt_yaw[bj] + M_PI,
                             2.0 * M_PI);
      if (dyaw < 0) dyaw += 2.0 * M_PI;
      dyaw = std::fabs(dyaw - M_PI);
      float dvx = mem_vel[m * 2] - gt_vel[bj * 2];
      float dvy = mem_vel[m * 2 + 1] - gt_vel[bj * 2 + 1];
      e[0] = d0;                                  // trans_err
      e[1] = 1.f - inter / std::max(uni, 1e-9f);  // scale_err
      e[2] = dyaw;                                // orient_err
      e[3] = std::sqrt(dvx * dvx + dvy * dvy);    // vel_err
      e[4] = gt_attr[bj] < 0
          ? std::numeric_limits<float>::quiet_NaN()
          : (mem_attr[m] == gt_attr[bj] ? 0.f : 1.f);  // attr_err
      e[5] = ade;                                 // avg_disp_err
      e[6] = dF;                                  // final_disp_err
      e[7] = dF > mr_thresh ? 1.f : 0.f;          // miss
      break;
    }
  }
}

}  // extern "C"
