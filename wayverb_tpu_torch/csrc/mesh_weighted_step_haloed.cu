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
// own: so with the neighbours' rows as halos the shards give B8's result on
// the unsplit grid to the bit.  The reference's plain version adds the halo
// terms after the sum; the TPU kernel puts them into the sum as here.
//
// `out` must not alias `cur` or a halo row; it may alias `prev`.
//
// What bounds it on the card: device memory.  Per node it reads cur, prev
// and the int32 code and writes out (16 B/node), plus the two halo rows
// (8 B per (y, z)).  One thread per node, as in mesh_weighted_step.cu.

#include <cuda_runtime.h>

#include "mesh_stencil.cuh"

namespace {

__global__ void __launch_bounds__(wv::kMeshBlockZ * wv::kMeshBlockY)
mesh_weighted_step_haloed_kernel(const float* __restrict__ cur,
                                 const float* prev,
                                 const int* __restrict__ code,
                                 const float* __restrict__ hlo,
                                 const float* __restrict__ hhi, float* out,
                                 int X, int Y, int Z) {
  wv::MeshNode n;
  if (!wv::mesh_node(X, Y, Z, n)) return;
  const long long row = (long long)n.y * Z + n.z;
  const int W = code[n.i];
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < 6; ++d) {
    float s;
    if (d == 0 && n.x == 0) {
      s = hlo[row];
    } else if (d == 1 && n.x == X - 1) {
      s = hhi[row];
    } else {
      s = n.nb[d] >= 0 ? cur[n.nb[d]] : 0.f;
    }
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
int wv_mesh_weighted_step_haloed_f32(const float* cur, const float* prev,
                                     const int* code, const float* hlo,
                                     const float* hhi, float* out, int X,
                                     int Y, int Z, void* stream) {
  mesh_weighted_step_haloed_kernel<<<wv::mesh_grid(X, Y, Z), wv::mesh_block(),
                                     0, static_cast<cudaStream_t>(stream)>>>(
      cur, prev, code, hlo, hhi, out, X, Y, Z);
  return static_cast<int>(cudaGetLastError());
}

const char* wv_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
