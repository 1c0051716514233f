// Dense weighted step of the general (arbitrary-geometry) waveguide mesh,
// CUDA C++ for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_wkernel` of
// wayverb_tpu/waveguide/stencil_pallas.py (called through `_wcall` from
// `weighted_step`).  It computes what that module's `weighted_step_jnp` and
// the port's plain version `_weighted_step_plain`
// (wayverb_tpu_torch/waveguide/stencil_kernels.py) compute:
//
//   out[x] = lambda^2 * sum_d w_d(x) * cur[x + e_d] - bit12(x) * prev[x]
//
// with w_d decoded from the packed per-node weight code (mesh_stencil.cuh)
// and zero beyond the grid.  One pass yields the interior update and every
// boundary node's weighted neighbour sum.
//
// The sum runs in the plain version's order (acc = 0; d = 0..5:
// acc += w_d * s_d; then lambda^2 * acc - is_int * prev), every product and
// sum rounded on its own, so kernel and plain agree to the bit.
//
// The TPU kernel's lagged x-slab window (slab / tail scratch) exists to
// stream VMEM tiles and is not carried over: one thread computes one node.
// `out` must not alias `cur` (six neighbours of cur are read); it may alias
// `prev`, whose element is read and written by the same thread.
//
// What bounds it on the card: device memory.  Per node it reads cur, prev
// and the int32 code and writes out: 16 B/node, about 56 us at 11.8 M nodes
// and the H100's 3.35 TB/s.  The arithmetic (6 multiplies, 6 adds, a
// multiply, a multiply and a subtract per node) is far below the float32
// rate.

#include <cuda_runtime.h>

#include "mesh_stencil.cuh"

namespace {

__global__ void __launch_bounds__(wv::kMeshBlockZ * wv::kMeshBlockY)
mesh_weighted_step_kernel(const float* __restrict__ cur, const float* prev,
                          const int* __restrict__ code, float* out, int X,
                          int Y, int Z) {
  wv::MeshNode n;
  if (!wv::mesh_node(X, Y, Z, n)) return;
  const int W = code[n.i];
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < 6; ++d) {
    const float s = n.nb[d] >= 0 ? cur[n.nb[d]] : 0.f;
    acc = __fadd_rn(acc, __fmul_rn(wv::mesh_weight(W, d), s));
  }
  const float is_int = (float)((W >> 12) & 1);
  out[n.i] = __fsub_rn(__fmul_rn(1.0f / 3.0f, acc),
                       __fmul_rn(is_int, prev[n.i]));
}

}  // namespace

extern "C" {

// Returns the CUDA error code of the launch (0 on success).  Launches on
// `stream` and does not synchronise; allocates nothing.
int wv_mesh_weighted_step_f32(const float* cur, const float* prev,
                              const int* code, float* out, int X, int Y, int Z,
                              void* stream) {
  mesh_weighted_step_kernel<<<wv::mesh_grid(X, Y, Z), wv::mesh_block(), 0,
                              static_cast<cudaStream_t>(stream)>>>(
      cur, prev, code, out, X, Y, Z);
  return static_cast<int>(cudaGetLastError());
}

const char* wv_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
