// Fused shoebox waveguide step, CUDA C++ for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_fwd_kernel` of
// wayverb_tpu/waveguide/box_fused.py.  It computes exactly what that
// module's reference `_jnp_forward` computes, and what the port's plain
// version `_fused_step_plain` (wayverb_tpu_torch/waveguide/box_fused.py)
// computes, for one leapfrog step of the shoebox field: injection, masked
// 7-point stencil, the six boundary-plane splices and the inner-plane
// extraction.  The per-node work lives in box_stencil.cuh, which the mega
// chunk kernel (box_mega_chunk.cu) shares.
//
// Every output element has exactly one writer, so the kernel needs no
// synchronisation.  The TPU kernel's XT=8 rolling window and scalar
// prefetch are not carried over: here one thread computes one node.
//
// What bounds it on the card: device memory.  Per node a step must read
// cur and prev and write next, 12 B/node in float32.  At 12.8 M nodes
// (224 x 224 x 256) that is about 154 MB per step, about 46 us at the
// H100's 3.35 TB/s.  threadIdx.x runs along z, the contiguous axis, so a
// warp's loads and stores coalesce; the six neighbour reads of cur are
// served mostly from L1/L2, because neighbouring threads and blocks read
// the same lines.  No shared-memory tiling yet: a simple, correct form
// first.

#include <cuda_runtime.h>

#include "box_stencil.cuh"

namespace {

constexpr int kBlockZ = 128;  // threads along z (contiguous axis)
constexpr int kBlockY = 2;    // threads along y

__global__ void __launch_bounds__(kBlockZ * kBlockY)
box_fused_step_kernel(const wv::StencilArgs a) {
  const int z = blockIdx.x * kBlockZ + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  const int x = blockIdx.z;
  if (z >= a.Z || y >= a.Y) return;
  wv::stencil_node(a, x, y, z);
}

}  // namespace

extern "C" {

// shape_geom: X, Y, Z, x_off, ilo0, ihi0, ilo1, ihi1, ilo2, ihi2.
// Returns the CUDA error code of the launch (0 on success).  Launches on
// `stream` and does not synchronise; allocates nothing.
int wv_box_fused_step_f32(const float* cur, const float* prev, float* next,
                          const float* hlo, const float* hhi,
                          const float* const* planes,
                          const long long* plane_strides,
                          float* const* inner, const int* shape_geom,
                          long long src, int mode, const float* inj_val,
                          void* stream) {
  wv::StencilArgs a;
  a.cur = cur;
  a.prev = prev;
  a.next = next;
  a.hlo = hlo;
  a.hhi = hhi;
  wv::stencil_set_geometry(a, shape_geom);
  // inner planes are contiguous in their natural shapes: (Y, Z) (X, Z) (X, Y)
  const long long inner_rows[6] = {a.Z, a.Z, a.Z, a.Z, a.Y, a.Y};
  for (int p = 0; p < 6; ++p) {
    a.plane[p] = planes[p];
    a.plane_stride[p] = plane_strides[p];
    a.inner[p] = inner[p];
    a.inner_stride[p] = inner_rows[p];
  }
  a.inj_val = inj_val;
  a.src = src;
  a.mode = mode;

  const dim3 block(kBlockZ, kBlockY, 1);
  const dim3 grid((a.Z + kBlockZ - 1) / kBlockZ, (a.Y + kBlockY - 1) / kBlockY,
                  a.X);
  box_fused_step_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

const char* wv_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
