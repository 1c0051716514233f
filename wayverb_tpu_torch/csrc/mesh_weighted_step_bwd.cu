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
// TPU version.
//
// The sum runs over dd = 0..5 in the plain version's order, every product
// and sum rounded on its own, so kernel and plain agree to the bit.
//
// What bounds it on the card: device memory.  Per node it reads g and the
// int32 code and writes gcur: 12 B/node, about 42 us at 11.8 M nodes and
// the H100's 3.35 TB/s.  The neighbours' codes and g values come mostly
// from L1/L2.  One thread per node; the TPU kernel's rolling windows for g
// and the code are not carried over.

#include <cuda_runtime.h>

#include "mesh_stencil.cuh"

namespace {

__global__ void __launch_bounds__(wv::kMeshBlockZ * wv::kMeshBlockY)
mesh_weighted_step_bwd_kernel(const float* __restrict__ g,
                              const int* __restrict__ code,
                              float* __restrict__ gcur, int X, int Y, int Z) {
  wv::MeshNode n;
  if (!wv::mesh_node(X, Y, Z, n)) return;
  float acc = 0.f;
#pragma unroll
  for (int dd = 0; dd < 6; ++dd) {
    const int opposite = dd ^ 1;
    float w = 0.f, gn = 0.f;
    if (n.nb[dd] >= 0) {
      w = wv::mesh_weight(code[n.nb[dd]], opposite);
      gn = g[n.nb[dd]];
    }
    acc = __fadd_rn(acc, __fmul_rn(w, gn));
  }
  gcur[n.i] = __fmul_rn(1.0f / 3.0f, acc);
}

}  // namespace

extern "C" {

// Returns the CUDA error code of the launch (0 on success).  Launches on
// `stream` and does not synchronise; allocates nothing.
int wv_mesh_weighted_step_bwd_f32(const float* g, const int* code, float* gcur,
                                  int X, int Y, int Z, void* stream) {
  mesh_weighted_step_bwd_kernel<<<wv::mesh_grid(X, Y, Z), wv::mesh_block(), 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      g, code, gcur, X, Y, Z);
  return static_cast<int>(cudaGetLastError());
}

const char* wv_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
