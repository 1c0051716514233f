// Device code of the general mesh's adjoint in `cur`, by threads walking x:
// the shard adjoint mesh_weighted_step_haloed_bwd.cu calls it with halo
// outputs, the unsharded adjoint mesh_weighted_step_bwd.cu without.  The
// shard step's forward walk (mesh_step_walk.cuh) takes FastDiv and the
// launch (adjoint_grid) from here.
//
//   gcur[n] = lambda^2 * sum_dd w_opp(dd)(n + e_dd) * g[n + e_dd]
//
// with g and the code zero beyond the grid, dd = 0..5 <-> (-x, +x, -y, +y,
// -z, +z) and w_d = bit(d) + bit(6 + d) of the weight code (mesh_stencil.cuh).
//
// Layout.  A thread owns one node p = y * Z + z of the flattened (y, z)
// plane and walks kWalk consecutive x rows of it, keeping g and the code
// at x - 1, x and x + 1 in registers: per node and row it loads g and the
// code at x + 1 (streamed) and at the four y and z neighbours (lines the
// warp and its neighbours load anyway, from L1).  A warp is 32 consecutive
// nodes of one x row: flat in (y, z), so Z need not be a multiple of 32 and
// no lanes idle but the last warp's of a row.
//
// The bare path.  A warp whose 32 nodes each see six neighbours with weight
// code 0x3F in its twelve weight bits (all six weights exactly 1) sums g
// without decoding: gcur = lambda^2 * (((((0 + g_-x) + g_+x) + g_-y) +
// g_+y) + g_-z) + g_+z, the plain sum's bits, since 1 * g == g in IEEE
// arithmetic.  The warp decides it from the codes it has loaded anyway
// (__all_sync), so the choice is uniform across the warp and follows the
// code of every launch; every other warp decodes each weight.
//
// Hazards:
//   - Bit-equality.  Both paths start from +0.f and add in the plain order,
//     each product and sum rounded on its own (__fmul_rn / __fadd_rn, and
//     the files build with --fmad=false).  Starting from +0 matters: all
//     six g = -0 give +0, as in the plain version.  A weight-0 neighbour
//     still multiplies (0 * inf = NaN as in the plain version); the bare
//     path never covers one.  Off the grid g and the code read as 0, so the
//     term is +0 and the warp is not bare: rows 0 and X - 1, the y and z
//     faces and lanes past the row's end never take the bare path.
//   - Indices are 32-bit: the wrapper refuses grids of 2^31 nodes or more.
//   - Aliasing: the outputs are __restrict__ and never overlap the inputs
//     (the wrapper allocates them), so every load of a row may be issued
//     before its stores.
//   - Registers: 32 a thread at 2,048 threads an SM (each kernel's launch
//     bounds), no spills.  They are tight: the same walk with its loads
//     nested under one `if (live)` spilled 8 B and ran 19.5 us against
//     18.3 at the shard; 6 CTAs of 256 an SM (40 registers) ran 19.2.  The
//     occupancy tests hold 0 B local.
//
// Each kernel chooses its launch, measured at its own shape (PERF.md §6):
// kThreads nodes of a row a CTA, kWalk x rows a thread; the shard adjoint
// 256 and 4, the adjoint of the whole grid 512 and 8.

#pragma once

#include <cuda_runtime.h>

#include "mesh_stencil.cuh"

namespace wv {

// n / d for 0 <= n < 2^31 by a multiply (Granlund and Montgomery), the
// constants made on the host.
struct FastDiv {
  unsigned m;
  int s;
};

inline FastDiv make_fast_div(int d) {
  int s = 0;
  while ((1u << s) < static_cast<unsigned>(d)) ++s;
  const unsigned long long m =
      ((1ull << 32) * ((1ull << s) - static_cast<unsigned long long>(d))) /
          static_cast<unsigned long long>(d) +
      1;
  return {static_cast<unsigned>(m), s};
}

__device__ __forceinline__ int fast_div(int n, FastDiv f) {
  return static_cast<int>(
      (__umulhi(static_cast<unsigned>(n), f.m) + static_cast<unsigned>(n)) >>
      f.s);
}

// The launch: CTAs of kThreads nodes along a row, kWalk x rows each.
template <int kThreads, int kWalk>
inline dim3 adjoint_grid(int X, int Y, int Z) {
  return dim3((Y * Z + kThreads - 1) / kThreads, (X + kWalk - 1) / kWalk, 1);
}

// All six weights of a neighbour's code are exactly 1.
__device__ __forceinline__ bool all_weights_one(int code) {
  return (code & 0xFFF) == 0x3F;
}

// The term of one neighbour: w_opp(dd) of its code times its g.
__device__ __forceinline__ float adjoint_term(float acc, int code, int opp,
                                              float gn) {
  return __fadd_rn(acc, __fmul_rn(mesh_weight(code, opp), gn));
}

// One thread's node over its kWalk rows, in CTAs of kThreads.  kHalos: also
// write the halo cotangents lambda^2 * w_0 * g of row 0 into ghlo and
// lambda^2 * w_1 * g of row X - 1 into ghhi, (1, Y, Z) each.
template <bool kHalos, int kThreads, int kWalk>
__device__ __forceinline__ void adjoint_walk(
    const float* __restrict__ g, const int* __restrict__ code,
    float* __restrict__ gcur, float* __restrict__ ghlo,
    float* __restrict__ ghhi, int X, int Y, int Z, FastDiv fz) {
  const int YZ = Y * Z;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  const bool live = p < YZ;
  const int y = fast_div(p, fz);
  const int z = p - y * Z;
  const int x0 = blockIdx.y * kWalk;
  int i = x0 * YZ + p;  // node (x, y, z)

  // g and the code at x0 - 1 and x0
  float gm = 0.f, g0 = 0.f;
  int cm = 0, c0 = 0;
  if (live) {
    if (x0 > 0) {
      gm = g[i - YZ];
      cm = code[i - YZ];
    }
    g0 = g[i];
    c0 = code[i];
  }
#pragma unroll
  for (int t = 0; t < kWalk; ++t) {
    const int x = x0 + t;
    if (x >= X) break;  // uniform across the CTA
    float gp = 0.f, gym = 0.f, gyp = 0.f, gzm = 0.f, gzp = 0.f;
    int cp = 0, cym = 0, cyp = 0, czm = 0, czp = 0;
    if (live && x + 1 < X) {
      gp = g[i + YZ];
      cp = code[i + YZ];
    }
    if (live && y > 0) {
      gym = g[i - Z];
      cym = code[i - Z];
    }
    if (live && y < Y - 1) {
      gyp = g[i + Z];
      cyp = code[i + Z];
    }
    if (live && z > 0) {
      gzm = g[i - 1];
      czm = code[i - 1];
    }
    if (live && z < Z - 1) {
      gzp = g[i + 1];
      czp = code[i + 1];
    }
    const bool bare = __all_sync(
        0xffffffffu, all_weights_one(cm) && all_weights_one(cp) &&
                         all_weights_one(cym) && all_weights_one(cyp) &&
                         all_weights_one(czm) && all_weights_one(czp));
    float acc = 0.f;
    if (bare) {
      acc = __fadd_rn(acc, gm);
      acc = __fadd_rn(acc, gp);
      acc = __fadd_rn(acc, gym);
      acc = __fadd_rn(acc, gyp);
      acc = __fadd_rn(acc, gzm);
      acc = __fadd_rn(acc, gzp);
    } else {
      acc = adjoint_term(acc, cm, 1, gm);
      acc = adjoint_term(acc, cp, 0, gp);
      acc = adjoint_term(acc, cym, 3, gym);
      acc = adjoint_term(acc, cyp, 2, gyp);
      acc = adjoint_term(acc, czm, 5, gzm);
      acc = adjoint_term(acc, czp, 4, gzp);
    }
    if (live) {
      gcur[i] = __fmul_rn(1.0f / 3.0f, acc);
      if (kHalos) {  // a shard of one row writes both
        if (x == 0)
          ghlo[p] =
              __fmul_rn(__fmul_rn(1.0f / 3.0f, mesh_weight(c0, 0)), g0);
        if (x == X - 1)
          ghhi[p] =
              __fmul_rn(__fmul_rn(1.0f / 3.0f, mesh_weight(c0, 1)), g0);
      }
    }
    gm = g0;
    g0 = gp;
    cm = c0;
    c0 = cp;
    i += YZ;
  }
}

}  // namespace wv
