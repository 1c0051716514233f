// Closest ray–triangle hit behind a per-tile bounding-box gate, CUDA C++ for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_mt_kernel_culled` of
// wayverb_tpu/raytracer/mt_pallas.py (the same `_pallas_closest` call as the
// all-pairs kernel, taken when the triangles carry tile boxes).  It computes
// what the port's plain version `_closest_culled_plain`
// (wayverb_tpu_torch/raytracer/mt_kernels.py) computes.  The triangles are
// Morton-sorted, so each tile of 1024 is a spatial blob with an AABB in
// `boxes` (tiles, 8: lo xyz, hi xyz, 0, 0); the rays arrive sorted by octant
// and origin.  For each (tile of 512 consecutive rays, triangle tile), in
// ascending tile order:
//
//   safe   = d, or +-1e-20 where |d| < 1e-20;  rd = 1 / safe
//   t0, t1 = (lo - o) * rd, (hi - o) * rd per axis
//   tnear  = max over axes of min(t0, t1), from -3.4e38
//   tfar   = min over axes of max(t0, t1), from 3.4e38
//   possible = tnear <= tfar and tfar > 0 and tnear < best_t
//
// and the Möller–Trumbore scan of the tile (ray_mt.cuh, as in
// ray_mt_closest.cu) runs for ALL rays of the ray tile if `possible` holds
// for ANY of them.  The vote over exactly those 512 rays is part of the
// function: a hit found only through the barycentric slack can lie just
// outside its tile's box, so whether it is found depends on which rays share
// the gate.  min and max propagate NaN as torch.minimum/maximum do.  Kernel
// and plain version agree to the bit.
//
// One block owns one ray tile, one thread one ray: the vote is a
// __syncthreads_or, which is also the barrier between one tile's readers and
// the next tile's staging.  A ragged last ray tile is padded with zero rays,
// which vote like any other (as the reference's zero padding does).
//
// What bounds it on the card: float32 operations.  The least work is the
// slab tests, 24 operations of arithmetic per (ray, triangle tile); the scans
// the gate lets through add 46 (and about 14 compares and selects) per (ray,
// triangle) and depend on the data.

#include <cuda_runtime.h>

#include "ray_mt.cuh"

namespace {

constexpr int kRayTile = 512;  // RB of mt_kernels.py: the gate's ray tile

// min/max that return a NaN operand, as torch.minimum/maximum do (fminf and
// fmaxf drop it).
__device__ inline float nan_min(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ inline float nan_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

__device__ inline float slab_reciprocal(float d) {
  const float safe = fabsf(d) < 1e-20f ? (d >= 0.f ? 1e-20f : -1e-20f) : d;
  return 1.0f / safe;
}

__global__ void __launch_bounds__(kRayTile)
ray_mt_closest_culled_kernel(const float* __restrict__ origin,
                             const float* __restrict__ direction,
                             const int* __restrict__ exclude,
                             const float* __restrict__ packed,
                             const float* __restrict__ boxes,
                             float* __restrict__ t_out,
                             int* __restrict__ id_out, int R, int Tpad,
                             int num) {
  __shared__ wv::MtTileSmem tile;
  const int r = blockIdx.x * kRayTile + threadIdx.x;
  const wv::MtRay ray = wv::mt_load_ray(origin, direction, exclude, r, R);
  const float o[3] = {ray.ox, ray.oy, ray.oz};
  const float rd[3] = {slab_reciprocal(ray.dx), slab_reciprocal(ray.dy),
                       slab_reciprocal(ray.dz)};
  float best_t = wv::kMtBig;
  int best_id = 0;
  for (int base = 0; base < num; base += wv::kMtTile) {
    const float* box = boxes + 8 * (base / wv::kMtTile);
    float tnear = -wv::kMtBig, tfar = wv::kMtBig;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float t0 = (box[c] - o[c]) * rd[c];
      const float t1 = (box[3 + c] - o[c]) * rd[c];
      tnear = nan_max(tnear, nan_min(t0, t1));
      tfar = nan_min(tfar, nan_max(t0, t1));
    }
    const bool possible = tnear <= tfar && tfar > 0.0f && tnear < best_t;
    // the vote doubles as the barrier after the previous tile's scan
    if (!__syncthreads_or(possible)) continue;
    const int n = min(wv::kMtTile, num - base);
    wv::mt_stage_tile<kRayTile>(packed, Tpad, base, n, tile);
    __syncthreads();
    wv::mt_scan_tile(ray, tile, base, n, best_t, best_id);
  }
  if (r < R) {
    t_out[r] = best_t;
    id_out[r] = best_id;
  }
}

}  // namespace

extern "C" {

// Returns the CUDA error code of the launch (0 on success).  Launches on
// `stream` and does not synchronise; allocates nothing.
int wv_ray_mt_closest_culled_f32(const float* origin, const float* direction,
                                 const int* exclude, const float* packed,
                                 const float* boxes, float* t_out,
                                 int* id_out, int R, int Tpad, int num,
                                 void* stream) {
  const int blocks = (R + kRayTile - 1) / kRayTile;
  ray_mt_closest_culled_kernel<<<blocks, kRayTile, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      origin, direction, exclude, packed, boxes, t_out, id_out, R, Tpad, num);
  return static_cast<int>(cudaGetLastError());
}

const char* wv_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
