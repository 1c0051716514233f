// Device code of the general mesh's weighted step on an x-shard, by threads
// walking x: the forward counterpart of mesh_adjoint.cuh's adjoint_walk,
// for mesh_weighted_step_haloed.cu (B10).
//
//   out[x] = lambda^2 * sum_d w_d(x) * s_d - bit12(x) * prev[x]
//
// with s_d = cur[x + e_d], zero beyond the grid in y and z; s_0 of local
// row 0 is hlo[y, z] and s_1 of row X - 1 is hhi[y, z] (the neighbouring
// shards' edge rows, (1, Y, Z) each).  d = 0..5 <-> (-x, +x, -y, +y, -z,
// +z), w_d = bit(d) + bit(6 + d) of the node's own code (mesh_stencil.cuh).
//
// Layout.  A thread owns one node p = y * Z + z of the flattened (y, z)
// plane and walks kWalk consecutive x rows of it, keeping cur at x - 1, x
// and x + 1 in registers: per row it loads cur at x + 1, prev and the code
// at x (streamed), and cur at the four y and z neighbours (lines the warp
// and its neighbours load anyway).  The halos are the first and last values
// of the walk (row 0's x - 1, row X - 1's x + 1), not branches in the sum.
// A warp is 32 consecutive nodes of one x row: flat in (y, z), so no lanes
// idle but the last warp's of a plane.
//
// The bare path.  A warp whose 32 nodes each have code 0x3F in its twelve
// weight bits (all six weights exactly 1) and bit 12 set sums without
// decoding: out = lambda^2 * (((((0 + s_0) + s_1) + s_2) + s_3) + s_4) +
// s_5) - prev, the plain version's bits, since 1 * s == s in IEEE
// arithmetic.  The warp decides it from the codes it has loaded anyway
// (__all_sync), so the choice is uniform across the warp and follows the
// code of every launch; every other warp decodes each weight.
//
// Hazards:
//   - Bit-equality.  Both paths start from +0.f and add the six terms in
//     the plain order, each product and sum rounded on its own (__fmul_rn /
//     __fadd_rn, and the files build with --fmad=false); a term beyond the
//     grid is w * 0 and is still added.  Starting from +0 matters: all six
//     s = -0 give +0, as in the plain version.  A weight-0 neighbour still
//     multiplies (0 * inf = NaN as in the plain version); the bare path
//     never covers one.  Lanes past the plane's end read code 0, so their
//     warp is not bare.
//   - Indices are 32-bit: the wrapper refuses grids of 2^31 nodes or more.
//   - Aliasing: `out` may be `prev` (the time loop rotates two buffers).
//     Each element of prev is read, then written, by the one thread that
//     owns it, so neither pointer is __restrict__ and the walk loads prev
//     of all its rows before its first store.  cur, the code and the halos
//     never overlap out (the wrapper refuses out == cur or a halo) and are
//     only read: they are __restrict__, so their loads need not wait for a
//     store.
//
// Each kernel chooses its launch (PERF.md §6): kThreads nodes of a row a
// CTA, kWalk x rows a thread, on adjoint_grid's grid.

#pragma once

#include <cuda_runtime.h>

#include "mesh_adjoint.cuh"

namespace wv {

// The node's own code: all six weights exactly 1, and the subtract-previous
// term.
__device__ __forceinline__ bool bare_node(int code) {
  return (code & 0x1FFF) == 0x103F;
}

// The term of direction d: w_d of the node's code times s.
__device__ __forceinline__ float step_term(float acc, int code, int d,
                                           float s) {
  return __fadd_rn(acc, __fmul_rn(mesh_weight(code, d), s));
}

// One thread's node over its kWalk rows, in CTAs of kThreads.
template <int kThreads, int kWalk>
__device__ __forceinline__ void step_walk(
    const float* __restrict__ cur, const float* prev,
    const int* __restrict__ code, const float* __restrict__ hlo,
    const float* __restrict__ hhi, float* out, int X, int Y, int Z,
    FastDiv fz) {
  const int YZ = Y * Z;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  const bool live = p < YZ;
  const int y = fast_div(p, fz);
  const int z = p - y * Z;
  const int x0 = blockIdx.y * kWalk;
  int i = x0 * YZ + p;  // node (x, y, z)

  // prev of every row before the first store (out may be prev)
  float pv[kWalk];
#pragma unroll
  for (int t = 0; t < kWalk; ++t)
    pv[t] = live && x0 + t < X ? prev[i + t * YZ] : 0.f;

  // cur at x0 - 1 and x0
  float cm = 0.f, c0 = 0.f;
  if (live) {
    cm = x0 > 0 ? cur[i - YZ] : hlo[p];
    c0 = cur[i];
  }
#pragma unroll
  for (int t = 0; t < kWalk; ++t) {
    const int x = x0 + t;
    if (x >= X) break;  // uniform across the CTA
    float cp = 0.f, sym = 0.f, syp = 0.f, szm = 0.f, szp = 0.f;
    int w = 0;
    if (live) {
      cp = x + 1 < X ? cur[i + YZ] : hhi[p];
      w = code[i];
    }
    if (live && y > 0) sym = cur[i - Z];
    if (live && y < Y - 1) syp = cur[i + Z];
    if (live && z > 0) szm = cur[i - 1];
    if (live && z < Z - 1) szp = cur[i + 1];
    const bool bare = __all_sync(0xffffffffu, bare_node(w));
    float acc = 0.f;
    float res;
    if (bare) {
      acc = __fadd_rn(acc, cm);
      acc = __fadd_rn(acc, cp);
      acc = __fadd_rn(acc, sym);
      acc = __fadd_rn(acc, syp);
      acc = __fadd_rn(acc, szm);
      acc = __fadd_rn(acc, szp);
      res = __fsub_rn(__fmul_rn(1.0f / 3.0f, acc), pv[t]);
    } else {
      acc = step_term(acc, w, 0, cm);
      acc = step_term(acc, w, 1, cp);
      acc = step_term(acc, w, 2, sym);
      acc = step_term(acc, w, 3, syp);
      acc = step_term(acc, w, 4, szm);
      acc = step_term(acc, w, 5, szp);
      res = __fsub_rn(__fmul_rn(1.0f / 3.0f, acc),
                      __fmul_rn((float)((w >> 12) & 1), pv[t]));
    }
    if (live) out[i] = res;
    cm = c0;
    c0 = cp;
    i += YZ;
  }
}

}  // namespace wv
