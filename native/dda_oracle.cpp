// Algorithm-faithful CPU re-implementation of the reference's per-pixel
// 3D-DDA march (Amanatides–Woo: delta_t = fabs(1/dir), per-axis
// intersection_t, step the smallest-t axis — SURVEY.md §4.3, the hot loop
// of the reference's kernels/ray_caster_kernel.cl [K]). This is the
// "deeper oracle" tier of SURVEY.md §5: the OpenCL original cannot run
// here, so forward-pass parity against the reference ALGORITHM is
// checked against this native reimplementation, which mirrors
// vxtpu/render/dda.py + kernel_ref.py constant-for-constant (ENTRY_EPS,
// safe_inverse clamp, tie-break-to-lowest-axis).
//
// Built as a plain shared library, bound via ctypes (no pybind11 in this
// image): see vxtpu/native/oracle.py.

#include <cmath>
#include <cstdint>

namespace {

constexpr float kBig = 1.0e30f;       // utils.BIG / kernel BIG_T
constexpr float kEpsDir = 1.0e-12f;   // utils.EPS_DIR
constexpr float kEntryEps = 1.0e-4f;  // dda.ENTRY_EPS
constexpr float kDegenerate = 3.0e30f;  // dda_init t_next for |d|~0

inline float safe_inverse(float d) {
  float sign = d >= 0.0f ? 1.0f : -1.0f;
  float mag = std::fabs(d);
  if (mag < kEpsDir) mag = kEpsDir;
  float inv = sign / mag;
  if (inv > kBig) inv = kBig;
  if (inv < -kBig) inv = -kBig;
  return inv;
}

inline int argmin3_tie_low(const float t[3]) {
  // dda_step_mask: smallest t_next, ties to the LOWEST axis index.
  int a = 0;
  if (t[1] < t[a]) a = 1;
  if (t[2] < t[a]) a = 2;
  return a;
}

inline int argmax3_tie_low(const float t[3]) {
  // entry_face_mask: largest near-slab t, ties to the lowest axis.
  int a = 0;
  if (t[1] > t[a]) a = 1;
  if (t[2] > t[a]) a = 2;
  return a;
}

}  // namespace

extern "C" {

// March n rays through a row-major [X,Y,Z] occupancy grid.
//   occ:    uint8[X*Y*Z], nonzero = solid
//   o, d:   float[n*3] origins / directions (need not be normalized)
//   t_max:  float[n] per-ray end parameter (pass 1e30f for "none")
//   hit:    uint8[n] out
//   t_out:  float[n] out — crossing parameter of the hit voxel (kBig miss)
//   voxel:  int32[n*3] out — hit (or last visited) voxel coords
//   normal: float[n*3] out — outward face normal (0 on miss)
//   steps:  int32[n] out — DDA steps taken
void vx_march(const uint8_t* occ, int32_t X, int32_t Y, int32_t Z,
              const float* o, const float* d, const float* t_max, int64_t n,
              int32_t max_steps, uint8_t* hit, float* t_out, int32_t* voxel,
              float* normal, int32_t* steps_out) {
  const float dims[3] = {static_cast<float>(X), static_cast<float>(Y),
                         static_cast<float>(Z)};
  const int32_t idims[3] = {X, Y, Z};

  for (int64_t r = 0; r < n; ++r) {
    const float* o1 = o + 3 * r;
    const float* d1 = d + 3 * r;
    const float tmax1 = t_max[r];
    float inv[3], tnear[3];
    float t_enter = 0.0f, t_exit = kBig;
    for (int a = 0; a < 3; ++a) {
      inv[a] = safe_inverse(d1[a]);
      float t0 = (0.0f - o1[a]) * inv[a];
      float t1 = (dims[a] - o1[a]) * inv[a];
      tnear[a] = t0 < t1 ? t0 : t1;
      float tfar = t0 > t1 ? t0 : t1;
      if (tnear[a] > t_enter) t_enter = tnear[a];
      if (tfar < t_exit) t_exit = tfar;
    }
    const bool valid = t_enter <= t_exit;

    // dda_init at t_enter
    int32_t v[3], step[3];
    float t_next[3], t_delta[3];
    for (int a = 0; a < 3; ++a) {
      float p = o1[a] + (t_enter + kEntryEps) * d1[a];
      int32_t vi = static_cast<int32_t>(std::floor(p));
      if (vi < 0) vi = 0;
      if (vi > idims[a] - 1) vi = idims[a] - 1;
      v[a] = vi;
      step[a] = d1[a] >= 0.0f ? 1 : -1;
      float next_bound =
          d1[a] >= 0.0f ? static_cast<float>(vi) + 1.0f : static_cast<float>(vi);
      t_next[a] = (next_bound - o1[a]) * inv[a];
      if (std::fabs(d1[a]) < kEpsDir) t_next[a] = kDegenerate;
      t_delta[a] = std::fabs(inv[a]);
    }

    uint8_t h = 0;
    float th = kBig;
    float nrm[3] = {0.0f, 0.0f, 0.0f};
    int32_t steps = 0;
    bool done = !valid;

    // entry voxel may already be solid (kernel_ref first_hit)
    if (valid) {
      const int64_t idx =
          (static_cast<int64_t>(v[0]) * Y + v[1]) * Z + v[2];
      if (occ[idx] != 0 && t_enter <= tmax1) {
        h = 1;
        th = t_enter;
        const int ea = argmax3_tie_low(tnear);
        nrm[ea] = d1[ea] > 0.0f ? -1.0f : (d1[ea] < 0.0f ? 1.0f : 0.0f);
        done = true;
      }
    }

    const float t_end = t_exit < tmax1 ? t_exit : tmax1;
    while (!done && steps < max_steps) {
      const int a = argmin3_tie_low(t_next);
      const float t_cross = t_next[a];
      v[a] += step[a];
      t_next[a] += t_delta[a];
      ++steps;
      const bool inside = v[0] >= 0 && v[0] < X && v[1] >= 0 && v[1] < Y &&
                          v[2] >= 0 && v[2] < Z;
      const bool past_end = t_cross > t_end;
      if (inside && !past_end) {
        const int64_t idx =
            (static_cast<int64_t>(v[0]) * Y + v[1]) * Z + v[2];
        if (occ[idx] != 0) {
          h = 1;
          th = t_cross;
          nrm[0] = nrm[1] = nrm[2] = 0.0f;
          nrm[a] = static_cast<float>(-step[a]);
          done = true;
        }
      } else {
        done = true;
      }
    }

    hit[r] = h;
    t_out[r] = th;
    for (int a = 0; a < 3; ++a) {
      voxel[3 * r + a] = v[a];
      normal[3 * r + a] = h ? nrm[a] : 0.0f;
    }
    steps_out[r] = steps;
  }
}

}  // extern "C"
