// Shared device code of the ray–triangle kernels (ray_mt_closest.cu,
// ray_mt_closest_culled.cu): the ray a thread owns, the staging of one tile
// of packed triangles through shared memory, and the Möller–Trumbore scan of
// that tile with the running (closest t, triangle id) in registers.
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

struct MtRay {
  float ox, oy, oz, dx, dy, dz;
  int exclude;
};

// One tile in shared memory, 36 KB: per triangle v0.xyz e1.x | e1.yz e2.xy |
// e2.z, so a scan step is two 16-byte broadcasts and one 4-byte one.
struct MtTileSmem {
  float4 a[kMtTile];
  float4 b[kMtTile];
  float c[kMtTile];
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

// Copy triangles base .. base+n-1 of packed (9, Tpad) into the tile.  Each
// of the nine reads is coalesced across the block.  The caller synchronises
// before (the previous tile's readers) and after.
template <int kThreads>
__device__ inline void mt_stage_tile(const float* __restrict__ packed,
                                     int Tpad, int base, int n,
                                     MtTileSmem& tile) {
  for (int j = threadIdx.x; j < n; j += kThreads) {
    const float* p = packed + base + j;
    tile.a[j] = make_float4(p[0], p[Tpad], p[2 * Tpad], p[3 * Tpad]);
    tile.b[j] = make_float4(p[4 * Tpad], p[5 * Tpad], p[6 * Tpad],
                            p[7 * Tpad]);
    tile.c[j] = p[8 * Tpad];
  }
}

// Scan triangles base .. base+n-1 for `ray`, updating its running best.
__device__ inline void mt_scan_tile(const MtRay& ray, const MtTileSmem& tile,
                                    int base, int n, float& best_t,
                                    int& best_id) {
#pragma unroll 4
  for (int j = 0; j < n; ++j) {
    const float4 a = tile.a[j];
    const float4 b = tile.b[j];
    const float v0x = a.x, v0y = a.y, v0z = a.z;
    const float e1x = a.w, e1y = b.x, e1z = b.y;
    const float e2x = b.z, e2y = b.w, e2z = tile.c[j];

    // pvec = d x e2
    const float px = ray.dy * e2z - ray.dz * e2y;
    const float py = ray.dz * e2x - ray.dx * e2z;
    const float pz = ray.dx * e2y - ray.dy * e2x;
    const float det = e1x * px + e1y * py + e1z * pz;
    const bool ok = fabsf(det) > kMtEpsilon;
    const float inv_det = ok ? 1.0f / det : 0.0f;
    // tvec = o - v0
    const float tx = ray.ox - v0x, ty = ray.oy - v0y, tz = ray.oz - v0z;
    const float u = (tx * px + ty * py + tz * pz) * inv_det;
    // qvec = tvec x e1
    const float qx = ty * e1z - tz * e1y;
    const float qy = tz * e1x - tx * e1z;
    const float qz = tx * e1y - ty * e1x;
    const float v = (ray.dx * qx + ray.dy * qy + ray.dz * qz) * inv_det;
    const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;

    const int id = base + j;
    const bool hit = ok && u >= -kMtSlack && v >= -kMtSlack &&
                     u + v <= kMtOnePlusSlack && t > kMtEpsilon &&
                     id != ray.exclude;
    if (hit && t < best_t) {
      best_t = t;
      best_id = id;
    }
  }
}

}  // namespace wv
