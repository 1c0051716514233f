// Dense weighted step of one x-shard of a decomposed general mesh, CUDA C++
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_wkernel_haloed` of
// wayverb_tpu/waveguide/stencil_pallas.py (called from
// `weighted_step_sharded`).  It computes what the port's plain version
// `_weighted_step_sharded_plain` (wayverb_tpu_torch/waveguide/
// stencil_kernels.py) computes on a shard of xl rows:
//
//   out[x] = lambda^2 * sum_d w_d(x) * cur[x + e_d] - bit12(x) * prev[x]
//
// as mesh_weighted_step.cu does, except that the -x neighbour of local row
// 0 is hlo[y, z] and the +x neighbour of row xl - 1 is hhi[y, z] (the
// neighbouring shards' edge rows, (1, Y, Z) each; zeros at the global grid
// ends).  A shard of one row reads both.
//
// The halo value enters the running sum as the d = 0 or d = 1 term, in the
// plain version's order (acc = 0; d = 0..5: acc += w_d * s_d; then
// lambda^2 * acc - is_int * prev), every product and sum rounded on its
// own: so the kernel equals the plain version to the bit, and with the
// neighbours' rows as halos the shards give B8's result on the unsplit
// grid to the bit.  The reference's plain version adds the halo terms after
// the sum; the TPU kernel puts them into the sum as here.
//
// `out` must not alias `cur` or a halo row; it may alias `prev`.
//
// What bounds it on the card: device memory.  Per node it must read cur,
// prev and the int32 code and write out (16 B/node), plus the two halo rows
// (8 B per (y, z)): 14.87 us for the columns hall's shard (86, 139, 259)
// at 3.35 TB/s.  The one-thread-a-node form it replaces (mesh_stencil.cuh's
// CTAs of 128 z x 2 y of one x row, 64-bit indices) ran 28.7 us there: at
// Z = 259 a third of its lanes were idle, cur came from L2 three times (its
// x neighbours a plane away, read by other CTAs), and every node decoded
// six weights and tested two halo branches.
//
// So (mesh_step_walk.cuh, the forward counterpart of B11's walk): a thread
// owns one node of the flattened (y, z) plane and walks kWalk x rows with
// cur at x - 1, x and x + 1 in registers, the halos as the walk's first and
// last values; warps of 32 consecutive nodes; 32-bit indices; a warp whose
// 32 nodes all have six weights of exactly 1 and the interior bit sums
// without decoding, decided from the codes it loads (75.8 % of the hall
// shard's warps).  The hazards and what the design does about each are in
// mesh_step_walk.cuh.
//
// The launch, tuned at the shard (PERF.md §6; H100 80GB HBM3, 700 W, bit-
// equal in every variant): with B11's launch (walks of 4 rows, CTAs of
// 256) this walk ran 22.1-22.6 us against 28.7-29.7 for the form it
// replaces in the same calls; walks of 8 22.7-22.9, of 3 21.6-21.9, of 2
// 21.6-22.1 (CTAs of 64-512 within 2 %), of 1 21.1-21.3.  The shard's rows come from L2 even when the four shards
// take turns (22.4 us), so the carried rows buy little.  Walks of 1 put X
// on the grid's y axis, refusing shards of more than 65,535 rows; walks of
// 2 in CTAs of 128, 16 an SM, 31 registers, 0 B local, are kept.

#include <cuda_runtime.h>

#include "mesh_step_walk.cuh"

namespace {

constexpr int kThreads = 128;   // nodes of a row a CTA
constexpr int kWalk = 2;        // x rows a thread walks
constexpr int kCtasPerSm = 16;  // 2,048 threads an SM: <= 32 registers

__global__ void __launch_bounds__(kThreads, kCtasPerSm)
mesh_weighted_step_haloed_kernel(const float* __restrict__ cur,
                                 const float* prev,
                                 const int* __restrict__ code,
                                 const float* __restrict__ hlo,
                                 const float* __restrict__ hhi, float* out,
                                 int X, int Y, int Z, wv::FastDiv fz) {
  wv::step_walk<kThreads, kWalk>(cur, prev, code, hlo, hhi, out, X, Y, Z,
                                 fz);
}

}  // namespace

extern "C" {

// Returns the CUDA error code of the launch (0 on success).  Launches on
// `stream` and does not synchronise; allocates nothing.  X * Y * Z < 2^31.
int wv_mesh_weighted_step_haloed_f32(const float* cur, const float* prev,
                                     const int* code, const float* hlo,
                                     const float* hhi, float* out, int X,
                                     int Y, int Z, void* stream) {
  mesh_weighted_step_haloed_kernel<<<
      wv::adjoint_grid<kThreads, kWalk>(X, Y, Z), kThreads, 0,
      static_cast<cudaStream_t>(stream)>>>(cur, prev, code, hlo, hhi, out, X,
                                           Y, Z, wv::make_fast_div(Z));
  return static_cast<int>(cudaGetLastError());
}

// What the card makes of the kernel on the current device, and its launch
// for a shard of `dims` (X, Y, Z): out = registers a thread, local memory
// (spills) a thread in bytes, CTAs resident on one SM, threads a CTA, CTAs
// a launch.  Returns the CUDA error code.
int wv_mesh_weighted_step_haloed_occupancy(const int* dims, int* out) {
  cudaFuncAttributes attrs;
  cudaError_t e =
      cudaFuncGetAttributes(&attrs, mesh_weighted_step_haloed_kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = attrs.numRegs;
  out[1] = static_cast<int>(attrs.localSizeBytes);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[2], mesh_weighted_step_haloed_kernel, kThreads, 0);
  out[3] = kThreads;
  const dim3 grid =
      wv::adjoint_grid<kThreads, kWalk>(dims[0], dims[1], dims[2]);
  out[4] = static_cast<int>(grid.x * grid.y * grid.z);
  return static_cast<int>(e);
}

const char* wv_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
