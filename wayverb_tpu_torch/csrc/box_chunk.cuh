// What the two persistent chunk kernels of the shoebox waveguide share: the
// mega chunk (box_mega_chunk.cu, kernels B2 and B6) and its adjoint
// (box_mega_chunk_bwd.cu, kernel B7).  Each runs K sub-steps in one
// cooperative launch of a grid that is resident at once, a grid-striding
// plane pass and a one-thread-a-node field pass a sub-step between grid
// barriers; both hold their threads to 64 registers (1,024 a CTA, one CTA
// an SM), which is why values are recomputed rather than kept live.

#pragma once

#include <cuda_runtime.h>

namespace wv {

// threadIdx.x and blockIdx.x, read afresh at each use: a value derived from
// them and kept live from one pass to the other would cost a register the
// plane pass needs.
__device__ __forceinline__ int thread_x() {
  int v;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(v));
  return v;
}
__device__ __forceinline__ int block_x() {
  int v;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(v));
  return v;
}

// v[i] of a three-element parameter array, by selects: a dynamic index
// into the kernel's parameters could be copied to local memory.
__device__ __forceinline__ int pick3(const int (&v)[3], int i) {
  return i == 0 ? v[0] : (i == 1 ? v[1] : v[2]);
}

// The two in-plane axes of a plane normal to axis a, in stacking order.
__device__ __forceinline__ void other_axes(int a, int* a1, int* a2) {
  *a1 = a == 0 ? 1 : 0;
  *a2 = a == 2 ? 1 : 2;
}

// The bare leapfrog on N warp-wide z blocks from flat index i, every node
// strictly inside the box: B[j] <- (1/3) * (sum of the six neighbours of
// A in the order x-, x+, y-, y+, z-, z+) - B[j], in place.  All the loads
// go out before the stores: the pass is bound by loads in flight.  The
// forward leapfrog (B2) and the adjoint's (B7, where the older field holds
// -Q) are the same arithmetic.
template <int N>
__device__ __forceinline__ void bare_blocks(const float* A, float* B,
                                            long long i, long long yz, int Z) {
  float res[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const long long j = i + 32 * k;
    float acc = 0.f;
    acc += A[j - yz];
    acc += A[j + yz];
    acc += A[j - Z];
    acc += A[j + Z];
    acc += A[j - 1];
    acc += A[j + 1];
    res[k] = __fmul_rn(1.0f / 3.0f, acc) - B[j];
  }
#pragma unroll
  for (int k = 0; k < N; ++k) B[i + 32 * k] = res[k];
}

// The cooperative grid of `kernel` at `threads` a CTA: CTAs an SM (from
// the occupancy calculator) x SMs.
template <class Kernel>
cudaError_t cooperative_grid(Kernel kernel, int threads, int* ctas_per_sm,
                             int* ctas) {
  int device, sms;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, kernel,
                                                      threads, 0);
  if (e == cudaSuccess) *ctas = *ctas_per_sm * sms;
  return e;
}

// What the card makes of `kernel`: registers a thread, local memory
// (spills) a thread in bytes, CTAs resident on one SM, and the cooperative
// grid one chunk launches.  Returns the CUDA error code.
template <class Kernel>
int chunk_occupancy(Kernel kernel, int threads, int* registers,
                    int* local_bytes, int* ctas_per_sm, int* grid) {
  cudaFuncAttributes attrs;
  cudaError_t e = cudaFuncGetAttributes(&attrs, kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  *registers = attrs.numRegs;
  *local_bytes = static_cast<int>(attrs.localSizeBytes);
  return static_cast<int>(cooperative_grid(kernel, threads, ctas_per_sm,
                                           grid));
}

}  // namespace wv
