// Adjoint of the dense weighted step in `cur`, CUDA C++ for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_wkernel_bwd` of
// wayverb_tpu/waveguide/stencil_pallas.py (called through `_wcall` from
// `_weighted_bwd`).  It computes what the transpose written out in
// `_weighted_bwd` and the port's plain version `_weighted_step_bwd_plain`
// (wayverb_tpu_torch/waveguide/stencil_kernels.py) compute:
//
//   gcur[y] = lambda^2 * sum_dd w_opp(dd)(y + e_dd) * g[y + e_dd]
//
// the transpose of the weighted neighbour sum: node y is neighbour opp(dd)
// of the node at y + e_dd, so the weight is decoded from the NEIGHBOUR's
// code.  Beyond the grid both the code and g are zero.  The cotangent of
// `prev`, -bit12 * g, is elementwise and stays plain tensor code, as in the
// TPU version.  Every product and sum rounds on its own, in the plain
// version's order, so kernel and plain agree to the bit.
//
// What bounds it on the card: device memory.  Per node it must read g and
// the int32 code and write gcur (12 B/node): 44.23 us for the columns hall
// (343, 139, 259) = 12,348,343 nodes at 3.35 TB/s.  The one-thread-a-node
// form it replaces (128 z x 2 y CTAs of one x row, 64-bit indices) ran
// 98.9-99.6 us there: it gathered six neighbours' codes and six neighbours'
// g a node, and at Z = 259 a third of its CTAs held 3 live lanes of 128.
//
// So it runs the shard adjoint's walk (mesh_adjoint.cuh, written for this
// file and mesh_weighted_step_haloed_bwd.cu) without halo outputs: a thread
// owns one node of the flattened (y, z) plane and walks x rows with g and
// the code of x - 1, x and x + 1 in registers, in warps of 32 consecutive
// nodes; a warp whose neighbours all weigh exactly 1 sums g without
// decoding, decided from the codes it loads (77 % of the hall's warps).
// Measured on an H100 80GB HBM3 at 700 W (PERF.md §6), at the hall on its
// own code, against 98.7-99.3 us for the form it replaces in the same
// calls: the shard adjoint's launch (walks of 4 rows, CTAs of 256)
// 65.7-66.0 us; walks of 2 rows 71.4, of 16 63.8-66.0; CTAs of 128 and
// 1,024 61.4-66.2.
// At this shape the fields (148 MB) stream from device memory at every
// launch, where the shard's stay in the 50 MB L2: a flat stream of g and
// the code to gcur takes 51.5 us, the walk with no code loads 42.4.  The
// fastest launch: walks of 8 rows (10 row loads for 8 rows, against 6 for
// 4) in CTAs of 512, 4 an SM, 32 registers, 0 B local: 60.8 us, 1.37x its
// bound.  The hazards and what the design does about each are in
// mesh_adjoint.cuh.

#include <cuda_runtime.h>

#include "mesh_adjoint.cuh"

namespace {

constexpr int kThreads = 512;  // nodes of a row a CTA
constexpr int kWalk = 8;       // x rows a thread walks
constexpr int kCtasPerSm = 4;  // 2,048 threads an SM: <= 32 registers

__global__ void __launch_bounds__(kThreads, kCtasPerSm)
mesh_weighted_step_bwd_kernel(const float* __restrict__ g,
                              const int* __restrict__ code,
                              float* __restrict__ gcur, int X, int Y, int Z,
                              wv::FastDiv fz) {
  wv::adjoint_walk<false, kThreads, kWalk>(g, code, gcur, nullptr, nullptr, X,
                                           Y, Z, fz);
}

}  // namespace

extern "C" {

// Returns the CUDA error code of the launch (0 on success).  Launches on
// `stream` and does not synchronise; allocates nothing.  X * Y * Z < 2^31.
int wv_mesh_weighted_step_bwd_f32(const float* g, const int* code, float* gcur,
                                  int X, int Y, int Z, void* stream) {
  mesh_weighted_step_bwd_kernel<<<wv::adjoint_grid<kThreads, kWalk>(X, Y, Z),
                                  kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      g, code, gcur, X, Y, Z, wv::make_fast_div(Z));
  return static_cast<int>(cudaGetLastError());
}

// What the card makes of the kernel on the current device, and its launch
// for a grid of `dims` (X, Y, Z): out = registers a thread, local memory
// (spills) a thread in bytes, CTAs resident on one SM, threads a CTA, CTAs
// a launch.  Returns the CUDA error code.
int wv_mesh_weighted_step_bwd_occupancy(const int* dims, int* out) {
  cudaFuncAttributes attrs;
  cudaError_t e = cudaFuncGetAttributes(&attrs, mesh_weighted_step_bwd_kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = attrs.numRegs;
  out[1] = static_cast<int>(attrs.localSizeBytes);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[2], mesh_weighted_step_bwd_kernel, kThreads, 0);
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
