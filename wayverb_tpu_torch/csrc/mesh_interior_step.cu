// Masked interior step of the general waveguide mesh, CUDA C++ for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` of
// wayverb_tpu/waveguide/stencil_pallas.py (`interior_step_pallas`, reached
// through `interior_step_auto`).  It computes what `stencil.interior_step`
// and the port's plain version `_interior_step_plain`
// (wayverb_tpu_torch/waveguide/stencil_kernels.py) compute:
//
//   out = (lambda^2 * sum of the six face neighbours of cur - prev) * mask
//
// with zero beyond the grid.  The neighbour sum runs x-, x+, y-, y+, z-, z+
// as in the plain version, every operation rounded on its own, so kernel
// and plain agree to the bit.
//
// The TPU kernel streams x-slabs of eight planes with halo planes from the
// neighbouring slabs; here one thread computes one node.  `out` must not
// alias `cur`; it may alias `prev`.
//
// What bounds it on the card: device memory.  Per node it reads cur, prev
// and the float32 mask and writes out: 16 B/node.

#include <cuda_runtime.h>

#include "mesh_stencil.cuh"

namespace {

__global__ void __launch_bounds__(wv::kMeshBlockZ * wv::kMeshBlockY)
mesh_interior_step_kernel(const float* __restrict__ cur, const float* prev,
                          const float* __restrict__ mask, float* out, int X,
                          int Y, int Z) {
  wv::MeshNode n;
  if (!wv::mesh_node(X, Y, Z, n)) return;
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < 6; ++d)
    acc = __fadd_rn(acc, n.nb[d] >= 0 ? cur[n.nb[d]] : 0.f);
  out[n.i] = __fmul_rn(__fsub_rn(__fmul_rn(1.0f / 3.0f, acc), prev[n.i]),
                       mask[n.i]);
}

}  // namespace

extern "C" {

// Returns the CUDA error code of the launch (0 on success).  Launches on
// `stream` and does not synchronise; allocates nothing.
int wv_mesh_interior_step_f32(const float* cur, const float* prev,
                              const float* mask, float* out, int X, int Y,
                              int Z, void* stream) {
  mesh_interior_step_kernel<<<wv::mesh_grid(X, Y, Z), wv::mesh_block(), 0,
                              static_cast<cudaStream_t>(stream)>>>(
      cur, prev, mask, out, X, Y, Z);
  return static_cast<int>(cudaGetLastError());
}

const char* wv_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
