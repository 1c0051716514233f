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
// and the Möller–Trumbore scan of the tile runs for ALL rays of the ray tile
// if `possible` holds for ANY of them.  The vote over exactly those 512 rays
// is part of the function: a hit found only through the barycentric slack
// can lie just outside its tile's box, so whether it is found depends on
// which rays share the gate.  min and max propagate NaN as
// torch.minimum/maximum do.  Kernel and plain version agree to the bit.
//
// What bounds it on the card: float32 operations, and the work depends on
// the data.  The slab tests are 24 operations per (ray, triangle tile); each
// (ray, triangle) pair the gate lets through adds the 46 of the Möller–
// Trumbore arithmetic, and about 24 more instructions that are not counted
// as operations: 14 compares and selects, the IEEE reciprocal's sequence,
// three shared-memory loads.  With --fmad=false nothing contracts, so a pair
// takes about 70 instructions where it is computed in full; the scan below
// computes in full only the pairs of warps where some lane may hit.
//
// Design.  A gate tile's triangle tiles are sequential (each vote reads the
// running best after all earlier tiles), and gate tiles do unequal work: one
// block per gate tile left the heaviest one alone on an SM, 128 blocks of 16
// warps on 132 SMs.  Here a thread-block cluster of kCluster = 8 CTAs
// (`__cluster_dims__`) owns one gate tile.  Every CTA of the cluster holds
// all 512 rays, one per thread.  For each triangle tile the gate lets
// through, CTA c stages and scans only triangles [c*128, (c+1)*128) of it,
// starting from the ray's merged best, and writes its partial (t, id) to its
// shared memory.  After a cluster barrier every CTA reads the 8 partials of
// its rays through distributed shared memory and takes their lexicographic
// minimum of (t, id).  The scan's result is the closest hit, the lowest id
// among equal t (each partial starts from the merged best and updates on
// strictly less, and the tile's ids exceed every earlier one), so this
// minimum is what the sequential scan of the whole tile gives, in any order
// of the shares.  Every CTA then holds the same merged best, computes the
// same vote for the next tile, and the cluster walks the triangle tiles in
// lockstep, deciding exactly as the sequential gate does.  The partials are
// double-buffered by the parity of the scanned tile, so one cluster barrier
// a scanned tile suffices; a last barrier keeps each CTA's shared memory
// alive until the others have read it.  The per-pair arithmetic and the
// warp-wide skip tests are `wv::mt_scan_tile`'s (ray_mt.cuh), which B3
// shares.  Measured (PERF.md §6): clusters of 8 beat 1, 2 and 4; two CTAs
// of 64 registers an SM.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "ray_mt.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kRayTile = 512;   // RB of mt_kernels.py: the gate's ray tile
constexpr int kCluster = 8;     // CTAs of the cluster that owns a gate tile
// a CTA's share of one tile in shared memory, in bytes
constexpr size_t kShareBytes =
    (wv::kMtTile / kCluster) * (2 * sizeof(float4) + sizeof(float));

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

// A CTA's share of one tile in dynamic shared memory, laid out as
// wv::mt_stage writes it, `share` triangles: v0.xyz e1.x | e1.yz e2.xy |
// e2.z.
struct Share {
  float4* a;
  float4* b;
  float* c;
};

__device__ inline Share share_layout(float4* smem, int share) {
  return {smem, smem + share, reinterpret_cast<float*>(smem + 2 * share)};
}

__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(kRayTile, 2)
    ray_mt_closest_culled_kernel(const float* __restrict__ origin,
                                 const float* __restrict__ direction,
                                 const int* __restrict__ exclude,
                                 const float* __restrict__ packed,
                                 const float* __restrict__ boxes,
                                 float* __restrict__ t_out,
                                 int* __restrict__ id_out, int R, int Tpad,
                                 int num) {
  extern __shared__ float4 smem[];
  __shared__ float part_t[2][kRayTile];
  __shared__ int part_id[2][kRayTile];
  cg::cluster_group cluster = cg::this_cluster();
  // kCluster, read from the cluster: with the constant folded in, the
  // kernel spilled 32 B a thread under the 64-register cap
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int share = wv::kMtTile / C;
  const Share tile = share_layout(smem, share);

  const int r = (blockIdx.x / C) * kRayTile + threadIdx.x;
  const wv::MtRay ray = wv::mt_load_ray(origin, direction, exclude, r, R);
  const float o[3] = {ray.ox, ray.oy, ray.oz};
  const float rd[3] = {slab_reciprocal(ray.dx), slab_reciprocal(ray.dy),
                       slab_reciprocal(ray.dz)};
  float best_t = wv::kMtBig;  // the merged best: equal in every CTA
  int best_id = 0;
  int parity = 0;
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
    // the vote doubles as the barrier after the previous share's scan
    if (!__syncthreads_or(possible)) continue;
    const int n = min(wv::kMtTile, num - base);
    const int lo = min(rank * share, n);
    const int hi = min(lo + share, n);
    wv::mt_stage<kRayTile>(packed, Tpad, base + lo, hi - lo, tile.a, tile.b,
                           tile.c);
    __syncthreads();
    float t = best_t;
    int id = best_id;
    wv::mt_scan_tile<8>(
        ray, [&] { return ray.exclude; }, tile.a, tile.b, tile.c, base + lo,
        hi - lo, t, id);
    part_t[parity][threadIdx.x] = t;
    part_id[parity][threadIdx.x] = id;
    cluster.sync();
    for (int q = 0; q < C; ++q) {
      const float tq = *cluster.map_shared_rank(&part_t[parity][threadIdx.x],
                                                q);
      const int iq = *cluster.map_shared_rank(&part_id[parity][threadIdx.x],
                                              q);
      if (tq < best_t || (tq == best_t && iq < best_id)) {
        best_t = tq;
        best_id = iq;
      }
    }
    parity ^= 1;
  }
  // no CTA leaves while another may still read its partials
  cluster.sync();
  if (rank == 0 && r < R) {
    t_out[r] = best_t;
    id_out[r] = best_id;
  }
}

}  // namespace

extern "C" {

// Returns the CUDA error code of the launch (0 on success): one cluster of
// kCluster CTAs of 512 threads per 512 rays.  Launches on `stream` and does
// not synchronise; allocates nothing.  A launch the card cannot take returns
// its error.
int wv_ray_mt_closest_culled_f32(const float* origin, const float* direction,
                                 const int* exclude, const float* packed,
                                 const float* boxes, float* t_out,
                                 int* id_out, int R, int Tpad, int num,
                                 void* stream) {
  const int blocks = (R + kRayTile - 1) / kRayTile * kCluster;
  ray_mt_closest_culled_kernel<<<blocks, kRayTile, kShareBytes,
                                 static_cast<cudaStream_t>(stream)>>>(
      origin, direction, exclude, packed, boxes, t_out, id_out, R, Tpad, num);
  return static_cast<int>(cudaGetLastError());
}

// What the card makes of the kernel: its registers a thread, local memory
// (spills) a thread, the CTAs resident on one SM, and the clusters resident
// on the whole card.  Returns the CUDA error code (0 on success).
int wv_ray_mt_closest_culled_occupancy(int* registers, int* local_bytes,
                                       int* ctas_per_sm, int* clusters) {
  cudaFuncAttributes attrs;
  cudaError_t e = cudaFuncGetAttributes(&attrs, ray_mt_closest_culled_kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  *registers = attrs.numRegs;
  *local_bytes = static_cast<int>(attrs.localSizeBytes);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, ray_mt_closest_culled_kernel, kRayTile, kShareBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(128 * kCluster);
  config.blockDim = dim3(kRayTile);
  config.dynamicSmemBytes = kShareBytes;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(
      clusters, ray_mt_closest_culled_kernel, &config));
}

const char* wv_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
