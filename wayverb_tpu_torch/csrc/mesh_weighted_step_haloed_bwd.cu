// Adjoint of the shard step in `cur` and the two halo rows, CUDA C++ for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_wkernel_bwd_haloed` of
// wayverb_tpu/waveguide/stencil_pallas.py (called from
// `_weighted_sharded_bwd`).  It computes what the port's plain version
// `_weighted_step_sharded_bwd_plain` (wayverb_tpu_torch/waveguide/
// stencil_kernels.py) computes on a shard of xl rows:
//
//   gcur[y] = lambda^2 * sum_dd w_opp(dd)(y + e_dd) * g[y + e_dd]
//   ghlo[y, z] = (lambda^2 * w_0(row 0)) * g[0, y, z]
//   ghhi[y, z] = (lambda^2 * w_1(row xl - 1)) * g[xl - 1, y, z]
//
// gcur is mesh_weighted_step_bwd.cu's sum on the shard, with g = 0 beyond
// it: the neighbour shard's own halo cotangent carries that part, and
// autograd routes it back through the exchange.  The cotangent of `prev`,
// -bit12 * g, is elementwise and stays plain tensor code, as in the TPU
// version.  Every product and sum rounds on its own, in the plain version's
// order, so kernel and plain agree to the bit.
//
// What bounds it on the card: device memory.  Per node it must read g and
// the int32 code and write gcur (12 B/node), plus the two halo rows (8 B per
// (y, z)): 11.18 us for the columns hall's shard (86, 139, 259) at 3.35
// TB/s.  The one-thread-a-node form it replaces (128 z x 2 y CTAs of one x
// row, 64-bit indices) ran 28.1 us there: it loaded six neighbours' codes
// and six neighbours' g a node, the x neighbours through L2, and a third of
// its CTAs held 3 live lanes of 128 (Z = 259).  Measured on an H100 80GB
// HBM3 at 700 W (PERF.md §6, on variants of this source): flat warps alone
// 22.0 us; a walk along x with g and the code of x - 1, x, x + 1 in
// registers 19.2, with a warp-uniform bare path decided from the codes it
// loads and 32 registers 18.2; a table of bare warps built from the code
// (no code loads in them) reached 14.4-14.8, but the sharded gradient's
// device time measured with it exceeded that without it, so it went.  Shuffles
// for the z neighbours, longer walks, a thread owning two y rows without
// the table (22.3) and larger CTAs all lost.
//
// So (mesh_adjoint.cuh): a thread owns one node of the flattened (y, z)
// plane and walks four x rows, in warps of 32 consecutive nodes and CTAs of
// 256, 8 an SM, 32 registers; a warp whose neighbours all weigh exactly 1
// sums g without decoding (71 % of the hall shard's warps): 18.3 us.  The
// hazards and what the design does about each are in mesh_adjoint.cuh.

#include <cuda_runtime.h>

#include "mesh_adjoint.cuh"

namespace {

constexpr int kThreads = 256;  // nodes of a row a CTA
constexpr int kWalk = 4;       // x rows a thread walks
constexpr int kCtasPerSm = 8;  // 2,048 threads an SM: <= 32 registers

__global__ void __launch_bounds__(kThreads, kCtasPerSm)
mesh_weighted_step_haloed_bwd_kernel(const float* __restrict__ g,
                                     const int* __restrict__ code,
                                     float* __restrict__ gcur,
                                     float* __restrict__ ghlo,
                                     float* __restrict__ ghhi, int X, int Y,
                                     int Z, wv::FastDiv fz) {
  wv::adjoint_walk<true, kThreads, kWalk>(g, code, gcur, ghlo, ghhi, X, Y, Z,
                                          fz);
}

}  // namespace

extern "C" {

// Returns the CUDA error code of the launch (0 on success).  Launches on
// `stream` and does not synchronise; allocates nothing.  X * Y * Z < 2^31.
int wv_mesh_weighted_step_haloed_bwd_f32(const float* g, const int* code,
                                         float* gcur, float* ghlo, float* ghhi,
                                         int X, int Y, int Z, void* stream) {
  mesh_weighted_step_haloed_bwd_kernel<<<
      wv::adjoint_grid<kThreads, kWalk>(X, Y, Z), kThreads, 0,
      static_cast<cudaStream_t>(stream)>>>(g, code, gcur, ghlo, ghhi, X, Y,
                                           Z, wv::make_fast_div(Z));
  return static_cast<int>(cudaGetLastError());
}

// What the card makes of the kernel on the current device, and its launch
// for a shard of `dims` (X, Y, Z): out = registers a thread, local memory
// (spills) a thread in bytes, CTAs resident on one SM, threads a CTA, CTAs
// a launch.  Returns the CUDA error code.
int wv_mesh_weighted_step_haloed_bwd_occupancy(const int* dims, int* out) {
  cudaFuncAttributes attrs;
  cudaError_t e =
      cudaFuncGetAttributes(&attrs, mesh_weighted_step_haloed_bwd_kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = attrs.numRegs;
  out[1] = static_cast<int>(attrs.localSizeBytes);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[2], mesh_weighted_step_haloed_bwd_kernel, kThreads, 0);
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
