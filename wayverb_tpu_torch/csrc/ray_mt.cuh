// Shared device code of the ray–triangle kernels (ray_mt_closest.cu,
// ray_mt_closest_culled.cu): the ray a thread owns, the staging of packed
// triangles through shared memory, and the Möller–Trumbore scan of the
// staged triangles with the running (closest t, triangle id) in registers.
//
// The arithmetic follows `_mt_tile` of
// wayverb_tpu_torch/raytracer/mt_kernels.py operation for operation: every
// product and sum rounds on its own (the build passes --fmad=false, and the
// sums run left to right), the division is IEEE, the constants are the same
// float32 values.  The scan visits the triangles in ascending id with a
// strictly-less update, so among equal t the lowest id wins, as the plain
// version's per-tile argmin (first of equal minima) followed by its
// strictly-less update across tiles gives it.

#pragma once

#include <cuda_runtime.h>

namespace wv {

constexpr int kMtTile = 1024;      // triangles per tile: TB of mt_kernels.py
constexpr float kMtBig = 3.4e38f;  // "no hit yet"
constexpr float kMtEpsilon = 1e-6f;
constexpr float kMtSlack = 1e-4f;  // barycentric edge slack
constexpr float kMtOnePlusSlack = static_cast<float>(1.0 + 1e-4);
constexpr float kMtBigDet = 1.2676506e30f;  // 2^100: SKIP_BIG_DET

struct MtRay {
  float ox, oy, oz, dx, dy, dz;
  int exclude;
};

// Ray r of (R, 3) origins and directions, or the zero ray beyond R: the
// reference pads a ragged last ray tile with zeros (a zero direction has
// det 0 on every triangle and misses).
__device__ inline MtRay mt_load_ray(const float* __restrict__ origin,
                                    const float* __restrict__ direction,
                                    const int* __restrict__ exclude, int r,
                                    int R) {
  MtRay ray = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0};
  if (r < R) {
    ray.ox = origin[3 * r];
    ray.oy = origin[3 * r + 1];
    ray.oz = origin[3 * r + 2];
    ray.dx = direction[3 * r];
    ray.dy = direction[3 * r + 1];
    ray.dz = direction[3 * r + 2];
    ray.exclude = exclude[r];
  }
  return ray;
}

// Copy triangles first .. first+n-1 of packed (9, Tpad) into shared memory
// as v0.xyz e1.x (a) | e1.yz e2.xy (b) | e2.z (c), so a scan step is two
// 16-byte broadcasts and one 4-byte one.  Each of the nine reads is
// coalesced across the block of kThreads threads.  The caller synchronises
// before (the previous triangles' readers) and after.
template <int kThreads>
__device__ inline void mt_stage(const float* __restrict__ packed, int Tpad,
                                int first, int n, float4* a, float4* b,
                                float* c) {
  for (int j = threadIdx.x; j < n; j += kThreads) {
    const float* p = packed + first + j;
    a[j] = make_float4(p[0], p[Tpad], p[2 * Tpad], p[3 * Tpad]);
    b[j] = make_float4(p[4 * Tpad], p[5 * Tpad], p[6 * Tpad], p[7 * Tpad]);
    c[j] = p[8 * Tpad];
  }
}

// Scan the staged triangles first .. first+n-1 (a, b, c as mt_stage lays
// them out) for `ray`, updating its running best.  Two warp-wide tests,
// taken before the IEEE reciprocal, skip a triangle that no lane of the warp
// can hit.  A hit has u >= -1e-4, v >= -1e-4 and u + v <= 1 + 1e-4, with
// u = du * (1 / det) and v = dv * (1 / det) each rounded twice (relative
// error below 2.4e-7); so its lane has
//
//   sdu >= -2e-4 * |det|,  sdu <= 1.0006 * |det|                  (test 1)
//   sdv >= -2e-4 * |det|,  sdu + sdv <= 1.0006 * |det|            (test 2)
//
// with sdu, sdv = du, dv times the sign of det: the margins exceed every
// rounding of the products and of the sum, as long as 1 / det is a normal
// float, and |det| >= 2^100 passes both tests.  A warp whose lanes all fail
// a test cannot change any lane's best, so it skips the rest of the pair;
// where a pair runs, its operations are `_mt_tile`'s, so the result has the
// same bits.  `_skip_tests_plain` (mt_kernels.py) is the tests' plain
// version.  The body must be reached by whole warps (every lane of a warp
// scans the same triangles).  `exclude_of()` gives the ray's excluded id; it
// is read only where a pair is computed in full, so a kernel may keep it out
// of the registers the unrolled loop needs (B3 keeps it in shared memory:
// held in a register, it made B3 spill under its 64-register cap).
// kUnroll: the loop's unrolling, each kernel's own (measured, PERF.md §6).
template <int kUnroll, typename ExcludeOf>
__device__ inline void mt_scan_tile(const MtRay& ray, ExcludeOf exclude_of,
                                    const float4* a, const float4* b,
                                    const float* c, int first, int n,
                                    float& best_t, int& best_id) {
#pragma unroll kUnroll
  for (int j = 0; j < n; ++j) {
    const float4 aj = a[j];
    const float4 bj = b[j];
    const float v0x = aj.x, v0y = aj.y, v0z = aj.z;
    const float e1x = aj.w, e1y = bj.x, e1z = bj.y;
    const float e2x = bj.z, e2y = bj.w, e2z = c[j];

    // pvec = d x e2
    const float px = ray.dy * e2z - ray.dz * e2y;
    const float py = ray.dz * e2x - ray.dx * e2z;
    const float pz = ray.dx * e2y - ray.dy * e2x;
    const float det = e1x * px + e1y * py + e1z * pz;
    const bool ok = fabsf(det) > kMtEpsilon;
    // tvec = o - v0
    const float tx = ray.ox - v0x, ty = ray.oy - v0y, tz = ray.oz - v0z;
    const float du = tx * px + ty * py + tz * pz;
    const float adet = fabsf(det);
    const float sdu = det < 0.0f ? -du : du;
    const bool big = adet >= kMtBigDet;
    const bool near_u = sdu >= -2e-4f * adet && sdu <= 1.0006f * adet;
    if (!__any_sync(0xffffffffu, ok && (big || near_u))) continue;
    // qvec = tvec x e1
    const float qx = ty * e1z - tz * e1y;
    const float qy = tz * e1x - tx * e1z;
    const float qz = tx * e1y - ty * e1x;
    const float dv = ray.dx * qx + ray.dy * qy + ray.dz * qz;
    const float sdv = det < 0.0f ? -dv : dv;
    if (!__any_sync(0xffffffffu,
                    ok && (big || (near_u && sdv >= -2e-4f * adet &&
                                   sdu + sdv <= 1.0006f * adet))))
      continue;
    const float inv_det = ok ? 1.0f / det : 0.0f;
    const float u = du * inv_det;
    const float v = dv * inv_det;
    const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;

    const int id = first + j;
    const bool hit = ok && u >= -kMtSlack && v >= -kMtSlack &&
                     u + v <= kMtOnePlusSlack && t > kMtEpsilon &&
                     id != exclude_of();
    if (hit && t < best_t) {
      best_t = t;
      best_id = id;
    }
  }
}

}  // namespace wv
