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
// autograd routes it back through the exchange.  The threads of rows 0 and
// xl - 1 also write the halo cotangents; in a shard of one row one thread
// writes both.  The cotangent of `prev`, -bit12 * g, is elementwise and
// stays plain tensor code, as in the TPU version.
//
// Every product and sum rounds on its own, in the plain version's order, so
// kernel and plain agree to the bit.
//
// What bounds it on the card: device memory.  Per node it reads g and the
// int32 code and writes gcur (12 B/node), plus the two halo rows written
// (8 B per (y, z)).  One thread per node.

#include <cuda_runtime.h>

#include "mesh_stencil.cuh"

namespace {

__global__ void __launch_bounds__(wv::kMeshBlockZ * wv::kMeshBlockY)
mesh_weighted_step_haloed_bwd_kernel(const float* __restrict__ g,
                                     const int* __restrict__ code,
                                     float* __restrict__ gcur,
                                     float* __restrict__ ghlo,
                                     float* __restrict__ ghhi, int X, int Y,
                                     int Z) {
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
  if (n.x == 0 || n.x == X - 1) {
    const long long row = (long long)n.y * Z + n.z;
    const int W = code[n.i];
    const float gi = g[n.i];
    if (n.x == 0) {
      ghlo[row] = __fmul_rn(__fmul_rn(1.0f / 3.0f, wv::mesh_weight(W, 0)), gi);
    }
    if (n.x == X - 1) {
      ghhi[row] = __fmul_rn(__fmul_rn(1.0f / 3.0f, wv::mesh_weight(W, 1)), gi);
    }
  }
}

}  // namespace

extern "C" {

// Returns the CUDA error code of the launch (0 on success).  Launches on
// `stream` and does not synchronise; allocates nothing.
int wv_mesh_weighted_step_haloed_bwd_f32(const float* g, const int* code,
                                         float* gcur, float* ghlo, float* ghhi,
                                         int X, int Y, int Z, void* stream) {
  mesh_weighted_step_haloed_bwd_kernel<<<wv::mesh_grid(X, Y, Z),
                                         wv::mesh_block(), 0,
                                         static_cast<cudaStream_t>(stream)>>>(
      g, code, gcur, ghlo, ghhi, X, Y, Z);
  return static_cast<int>(cudaGetLastError());
}

const char* wv_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
