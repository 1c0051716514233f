// Closest ray–triangle hit over all triangles, CUDA C++ for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_mt_kernel` (+ `_mt_math`) of
// wayverb_tpu/raytracer/mt_pallas.py, reached through `_pallas_closest` from
// `mt_intersection` and `mt_line_of_sight`.  It computes what the port's
// plain version `_closest_plain`
// (wayverb_tpu_torch/raytracer/mt_kernels.py) computes: for each ray the
// smallest Möller–Trumbore t over the triangles of `packed` (9, Tpad) —
// rows v0 | e1 | e2, columns beyond `num` zero padding — with
//
//   hit = |det| > 1e-6 and u >= -1e-4 and v >= -1e-4 and u + v <= 1 + 1e-4
//         and t > 1e-6 and id < num and id != exclude[ray]
//
// and the id of that triangle, the lowest id among equal t.  A ray that hits
// nothing returns t = 3.4e38 and id 0.  Kernel and plain version agree to
// the bit (see ray_mt.cuh).
//
// The TPU kernel tiles (512 rays) x (1024 triangles) through VMEM and carries
// the running minimum across the sequential triangle axis of its grid.  Here
// one thread owns one ray and keeps the running best in registers; a block
// of 128 rays walks the triangle tiles in ascending order, each tile staged
// once through 36 KB of shared memory and read back as broadcasts.
//
// What bounds it on the card: float32 operations, 46 of arithmetic and about
// 14 compares and selects per (ray, triangle) pair, against 28 B per ray and
// 36 B per triangle of traffic.
// Blocks of 128 threads put 512 blocks on the card at 65,536 rays, several
// resident per SM.

#include <cuda_runtime.h>

#include "ray_mt.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
ray_mt_closest_kernel(const float* __restrict__ origin,
                      const float* __restrict__ direction,
                      const int* __restrict__ exclude,
                      const float* __restrict__ packed,
                      float* __restrict__ t_out, int* __restrict__ id_out,
                      int R, int Tpad, int num) {
  __shared__ wv::MtTileSmem tile;
  const int r = blockIdx.x * kThreads + threadIdx.x;
  const wv::MtRay ray = wv::mt_load_ray(origin, direction, exclude, r, R);
  float best_t = wv::kMtBig;
  int best_id = 0;
  for (int base = 0; base < num; base += wv::kMtTile) {
    const int n = min(wv::kMtTile, num - base);
    __syncthreads();  // the previous tile's readers are done
    wv::mt_stage_tile<kThreads>(packed, Tpad, base, n, tile);
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
int wv_ray_mt_closest_f32(const float* origin, const float* direction,
                          const int* exclude, const float* packed,
                          float* t_out, int* id_out, int R, int Tpad, int num,
                          void* stream) {
  const int blocks = (R + kThreads - 1) / kThreads;
  ray_mt_closest_kernel<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      origin, direction, exclude, packed, t_out, id_out, R, Tpad, num);
  return static_cast<int>(cudaGetLastError());
}

const char* wv_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
