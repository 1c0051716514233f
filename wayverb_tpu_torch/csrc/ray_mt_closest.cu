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
// the running minimum across the sequential triangle axis of its grid.
//
// What bounds it on the card: float32 operations, 46 of arithmetic per
// (ray, triangle) pair, against 28 B per ray and 36 B per triangle of
// traffic.  With --fmad=false nothing contracts, and a pair computed in full
// issues about 70 instructions (the 46, compares and selects, the IEEE
// reciprocal's sequence, three shared-memory loads), so issue, not the
// operations count, set the old kernel's time.
//
// Design.  One thread owns one ray.  `wv::mt_scan_tile` (ray_mt.cuh, shared
// with B4) skips, by two warp-wide tests before the reciprocal, the
// triangles that no ray of the warp can hit: on the rays a trace gives it,
// all but a few percent of (warp, triangle) pairs stop at the first or the
// second test.  What is left is a short dependent chain per pair that ends
// in a vote, which wants many warps in flight.  So a thread-block cluster of
// kCluster CTAs (`__cluster_dims__`) owns one block of kRays rays, every CTA
// all of them, and the triangle axis is split: CTA c scans the contiguous
// share [num·c / kCluster, num·(c+1) / kCluster) of the real triangles from
// "no hit yet", staging it through shared memory kStage triangles at a time.
// After the last triangle the kCluster partial (t, id) of a ray are merged
// once: CTA 0 reads them through distributed shared memory and takes their
// lexicographic minimum of (t, id).  Every partial starts from (3.4e38, 0)
// and updates on strictly less, and the shares are disjoint id ranges, so
// each partial is its share's lexicographic minimum over the hits, and the
// minimum of the partials is the whole scan's: the closest hit, the lowest id
// among equal t, in any order of the shares.  The rays' excludes wait in
// shared memory, read only where a pair is computed in full: held in a
// register, they made the unrolled loop spill under the 64-register cap.
//
// kRays, kCluster, kStage and the scan's unrolling are fixed when the kernel
// is compiled: the fastest of the shapes measured at 65,536 rays (PERF.md
// §6), one CTA of 32 warps an SM at 64 registers, and 65,536 rays make 64
// clusters of two, 128 CTAs, one wave on 132 SMs; larger CTAs stage each
// triangle for more rays, smaller ones or larger clusters needed more than
// one wave.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "ray_mt.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kRays = 1024;   // rays of a cluster: a thread each
constexpr int kCluster = 2;   // CTAs of a cluster: triangle shares
                              // (mt_kernels.B3_CLUSTER)
constexpr int kStage = 1024;  // triangles staged at a time
constexpr int kUnroll = 8;    // the scan loop's unrolling
// CTAs an SM at 64 registers a thread: the register file's 65,536 / 64
constexpr int kMinCtas = 65536 / 64 / kRays;

static_assert(kRays % 32 == 0, "whole warps scan");

__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(kRays, kMinCtas)
    ray_mt_closest_kernel(const float* __restrict__ origin,
                          const float* __restrict__ direction,
                          const int* __restrict__ exclude,
                          const float* __restrict__ packed,
                          float* __restrict__ t_out, int* __restrict__ id_out,
                          int R, int Tpad, int num) {
  __shared__ float4 stage_a[kStage];
  __shared__ float4 stage_b[kStage];
  __shared__ float stage_c[kStage];
  __shared__ float part_t[kRays];
  __shared__ int part_id[kRays];
  __shared__ int excluded[kRays];  // the rays' excludes, out of registers
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int r = (blockIdx.x / kCluster) * kRays + threadIdx.x;
  const wv::MtRay ray = wv::mt_load_ray(origin, direction, exclude, r, R);
  const int lo = static_cast<int>(static_cast<long long>(num) * rank /
                                  kCluster);
  const int hi = static_cast<int>(static_cast<long long>(num) * (rank + 1) /
                                  kCluster);
  excluded[threadIdx.x] = ray.exclude;
  float best_t = wv::kMtBig;
  int best_id = 0;
  for (int first = lo; first < hi; first += kStage) {
    const int n = min(kStage, hi - first);
    __syncthreads();  // the previous triangles' readers are done
    wv::mt_stage<kRays>(packed, Tpad, first, n, stage_a, stage_b, stage_c);
    __syncthreads();
    wv::mt_scan_tile<kUnroll>(
        ray, [&] { return excluded[threadIdx.x]; }, stage_a, stage_b,
        stage_c, first, n, best_t, best_id);
  }
  part_t[threadIdx.x] = best_t;
  part_id[threadIdx.x] = best_id;
  cluster.sync();
  if (rank == 0) {
    for (int q = 1; q < kCluster; ++q) {
      const float tq = *cluster.map_shared_rank(&part_t[threadIdx.x], q);
      const int iq = *cluster.map_shared_rank(&part_id[threadIdx.x], q);
      if (tq < best_t || (tq == best_t && iq < best_id)) {
        best_t = tq;
        best_id = iq;
      }
    }
    if (r < R) {
      t_out[r] = best_t;
      id_out[r] = best_id;
    }
  }
  // no CTA leaves while CTA 0 may still read its partials
  cluster.sync();
}

}  // namespace

extern "C" {

// Returns the CUDA error code of the launch (0 on success): one cluster of
// kCluster CTAs of kRays threads per kRays rays.  Launches on `stream` and
// does not synchronise; allocates nothing.
int wv_ray_mt_closest_f32(const float* origin, const float* direction,
                          const int* exclude, const float* packed,
                          float* t_out, int* id_out, int R, int Tpad, int num,
                          void* stream) {
  const int blocks = (R + kRays - 1) / kRays * kCluster;
  ray_mt_closest_kernel<<<blocks, kRays, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      origin, direction, exclude, packed, t_out, id_out, R, Tpad, num);
  return static_cast<int>(cudaGetLastError());
}

// What the card makes of the kernel: its registers a thread, local memory
// (spills) a thread, the CTAs resident on one SM, and the clusters resident
// on the whole card.  Returns the CUDA error code (0 on success).
int wv_ray_mt_closest_occupancy(int* registers, int* local_bytes,
                                int* ctas_per_sm, int* clusters) {
  cudaFuncAttributes attrs;
  cudaError_t e = cudaFuncGetAttributes(&attrs, ray_mt_closest_kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  *registers = attrs.numRegs;
  *local_bytes = static_cast<int>(attrs.localSizeBytes);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, ray_mt_closest_kernel, kRays, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(128 * kCluster);
  config.blockDim = dim3(kRays);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(
      clusters, ray_mt_closest_kernel, &config));
}

const char* wv_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
