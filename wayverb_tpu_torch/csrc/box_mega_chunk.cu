// Mega chunk of the shoebox waveguide: K leapfrog sub-steps in one
// persistent cooperative launch, CUDA C++ for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_MegaKernel.kernel` of
// wayverb_tpu/waveguide/box_mega.py, with grad=False (B2) and, when the
// caller passes a residual block, with grad=True (B6).  It computes what the
// port's plain version `_mega_chunk_plain` (wayverb_tpu_torch/waveguide/
// box_mega.py) computes, to the bit.  Each sub-step t, on the current field
// A and the previous field B:
//
//   plane pass, the grid striding over the (6, Umax, Vmax) plane elements:
//     - one thread injects the source into A (1 set, 2 add) and writes the
//       receiver taps of the post-injection field into row t of the (K, k)
//       tap block;
//     - the injection mirrored onto the carried inner planes (a source on
//       an inner plane, an edge or a corner patches one, two or three of
//       them): the owning thread substitutes the patched value;
//     - the six DF2T boundary-plane updates with edge/corner coupling
//       (reference program.cpp:331-388 + filters.cpp), new <- f(PL, INS,
//       PRVP, state);
//     - each plane's sum, for the non-finite count: warp shuffles, a row of
//       shared memory a warp, one atomic add a plane a CTA;
//     - in grad mode, the element's four residuals into row t of the
//       (K, 4, 6, Umax, Vmax) block: PL, INS after the injection patch, PRVP
//       and the OLD first state slot, exactly the values this update read.
//       The other outputs do not depend on the mode.
//   grid barrier;
//   stencil pass: one thread counts the planes whose sum was not finite into
//     `bad` and clears the sums; every node gets B <- the masked 7-point
//     stencil of A minus B (in place over B), the splice of the new boundary
//     planes and the inner-plane extraction into INS (`wv::stencil_finish`,
//     the code the fused step B1 runs);
//   grid barrier; A and B swap.
//
// The stencil pass runs one thread a node: warps stride over the (x, y)
// rows, lanes along z.  A warp-wide z block whose 32 nodes are strictly
// inside the box on every axis (at the hall 75 % of them) runs the bare
// leapfrog, kGroup blocks at a time so that their loads are in flight
// together; the other blocks run `node`, which reads its splice's plane
// value before the sum so that the two loads overlap.  What bounds the pass
// is the latency of those loads, not their bytes: a warp has at most
// kGroup blocks of loads in flight.
//
// Launch: one cudaLaunchCooperativeKernel a chunk, of a grid that is
// resident at once (CTAs an SM from the occupancy calculator x SMs).  The
// ordering rules of a launch a pass become barrier points:
//   - plane p's coupling reads its neighbours' OLD first state slot, which
//     other threads rewrite: the state ping-pongs (read st_in, write st_out);
//   - the in-plane shifts read PL while the new planes are written: three
//     plane buffers rotate (new is written into the spare, then PRVP <- PL
//     and PL <- new);
//   - every thread derives the roles of a sub-step (A, B, the state's two
//     copies, the three plane buffers) from t alone;
//   - the injection and the taps are done by one thread, and a tap at the
//     source node takes the injected value;
//   - every value one thread writes and another reads (fields, planes,
//     state, sums) is read after a grid barrier, with plain loads: nothing
//     goes through the non-coherent path (no __ldg, no const __restrict__).
// After the last sub-step the grid moves the rotated plane buffers back to
// their slots of `pln` (each element read before it is written, by one
// thread).  Padding of the stacked (Umax, Vmax) planes is written as zero.
//
// What bounds a sub-step on the card: the two fields (2 x 49 MiB at 224 x
// 224 x 256) fit neither L2 (50 MB) nor shared memory, so every sub-step
// streams them, 12 B a node, plus the plane state.
//
// The file is compiled with --fmad=false: each product and sum rounds on
// its own, in the plain version's order, as torch's separate kernels do.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "box_chunk.cuh"
#include "box_stencil.cuh"

namespace cg = cooperative_groups;

namespace {

using wv::block_x;
using wv::other_axes;
using wv::pick3;
using wv::thread_x;

constexpr int kThreads = 1024; // threads a CTA
constexpr int kMinCtas = 1;    // CTAs an SM the launch bounds ask for
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 3;      // bare z blocks a warp loads at once

struct ChunkArgs {
  float* cur;
  float* prev;
  float* st;                  // (order, 6, Umax, Vmax) DF2T state
  float* st_spare;
  float* pln;                 // (3, 6, Umax, Vmax) PL, INS, PRVP
  float* pln_spare;           // (6, Umax, Vmax)
  const float* sig;           // (K,)
  const long long* tap_idx;   // (k,)
  float* taps;                // (K, k)
  float* bad;                 // (1,)
  float* sums;                // (6,) zero on entry and on return
  float* res;                 // (K, 4, 6, Umax, Vmax), or null
  const float* fb;            // (6, order + 1)
  const float* fa;
  long long src;              // flat index of the source node, or -1
  int mode;                   // 1 set, 2 add
  int k, K;
  int dims[3];
  int blo[3], bhi[3];         // boundary-plane coordinates per axis
  int Umax, Vmax, order;
  int ins_u[6], ins_v[6];     // source on inner plane p at (u, v), or -1
  float courant, courant_sq;
  wv::StencilArgs geo;        // the stencil's geometry (pointers unused)
};

// a0 / b0 of each face's filter, computed once a CTA (the same IEEE
// division the plane update would repeat for every element).
__shared__ float face_ratio[6];

// v[i] of a six-element parameter array, by selects (see wv::pick3).
__device__ __forceinline__ int pick6(const int (&v)[6], int i) {
  return i < 3 ? (i == 0 ? v[0] : (i == 1 ? v[1] : v[2]))
               : (i == 3 ? v[3] : (i == 4 ? v[4] : v[5]));
}

// One plane element's boundary update; returns the new pressure (0 in the
// padding).  Arithmetic in the order of box_mega.plane_step_one.
__device__ __forceinline__ float plane_update(
    const ChunkArgs& a, const float* pl, const float* ins, const float* prvp,
    float* out_p, const float* st_in, float* st_out, int t, float sig, int p,
    int u, int v) {
  const int uv = a.Umax * a.Vmax;
  const int stack = 6 * uv;
  const int idx = p * uv + u * a.Vmax + v;
  // in grad mode, row t of the residual block
  float* const res = a.res ? a.res + (long long)t * 4 * stack : nullptr;
  const int ax = p >> 1, side = p & 1;
  int a1, a2;
  other_axes(ax, &a1, &a2);
  const int U = pick3(a.dims, a1), V = pick3(a.dims, a2);
  if (u >= U || v >= V) {
    out_p[idx] = 0.f;
    for (int j = 0; j < a.order; ++j) st_out[j * stack + idx] = 0.f;
    if (res)
      for (int r = 0; r < 4; ++r) res[r * stack + idx] = 0.f;
    return 0.f;
  }
  const int blo1 = pick3(a.blo, a1), bhi1 = pick3(a.bhi, a1);
  const int blo2 = pick3(a.blo, a2), bhi2 = pick3(a.bhi, a2);
  const int stride = a.Vmax;
  const float s_um = u > 0 ? pl[idx - stride] : 0.f;
  const float s_up = u + 1 < U ? pl[idx + stride] : 0.f;
  const float s_vm = v > 0 ? pl[idx - 1] : 0.f;
  const float s_vp = v + 1 < V ? pl[idx + 1] : 0.f;
  const float w_um = u == blo1 ? 0.f : (u == bhi1 ? 2.f : 1.f);
  const float w_up = u == blo1 ? 2.f : (u == bhi1 ? 0.f : 1.f);
  const float w_vm = v == blo2 ? 0.f : (v == bhi2 ? 2.f : 1.f);
  const float w_vp = v == blo2 ? 2.f : (v == bhi2 ? 0.f : 1.f);

  float in = ins[idx];
  if (u == pick6(a.ins_u, p) && v == pick6(a.ins_v, p))
    in = a.mode == 1 ? sig : in + sig;
  // the 0/1/2 weights and the mask multiply as the plain version does
  // (__fmul_rn: 0 * inf is NaN, never folded into a select of 0)
  float csw = 2.f * in;
  csw = csw + __fmul_rn(w_um, s_um);
  csw = csw + __fmul_rn(w_up, s_up);
  csw = csw + __fmul_rn(w_vm, s_vm);
  csw = csw + __fmul_rn(w_vp, s_vp);
  csw = a.courant_sq * csw;

  const int nc = a.order + 1;
  const float b0 = a.fb[p * nc], a0 = a.fa[p * nc];
  const float m0 = st_in[idx];
  float fw = m0 / b0;
  float cw = face_ratio[p];
  // edge/corner coupling: a node on this plane's in-plane box edge also
  // belongs to the neighbouring plane q; add q's OLD first state slot at
  // the same global point g (g[ax] the plane's coordinate, g[a1] = u,
  // g[a2] = v).  As in the plain version every element adds the masked
  // term of all four neighbours, 0 * (line / b0q) off the edge, so a
  // non-finite line gives the same NaN; the line's point does not depend
  // on g[e].
  const int gax = side == 0 ? pick3(a.blo, ax) : pick3(a.bhi, ax);
  auto g = [&](int i) { return i == ax ? gax : (i == a1 ? u : v); };
  // kept rolled: unrolled, its loads and divisions spill (PERF.md §6)
#pragma unroll 1
  for (int ei = 0; ei < 2; ++ei) {
    const int e = ei == 0 ? a1 : a2;
    int qa0, qa1;
    other_axes(e, &qa0, &qa1);
    for (int s2 = 0; s2 < 2; ++s2) {
      const float mask =
          g(e) == (s2 == 0 ? pick3(a.blo, e) : pick3(a.bhi, e)) ? 1.f : 0.f;
      const int q = 2 * e + s2;
      const float line = st_in[q * uv + g(qa0) * a.Vmax + g(qa1)];
      fw = fw + __fmul_rn(mask, line / a.fb[q * nc]);
      cw = cw + __fmul_rn(mask, face_ratio[q]);
    }
  }
  cw = a.courant * cw;

  const float act = (u >= blo1 && u <= bhi1 && v >= blo2 && v <= bhi2)
                        ? 1.f : 0.f;
  const float prev = prvp[idx];
  if (res) {
    res[idx] = pl[idx];
    res[stack + idx] = in;
    res[2 * stack + idx] = prev;
    res[3 * stack + idx] = m0;
  }
  float x = csw + a.courant_sq * fw;
  x = x + (cw - 1.f) * prev;
  const float new_p = __fmul_rn(act, x) / (1.f + cw);

  const float delta = prev - new_p;
  const float filt_in = -((a0 * delta) / (b0 * a.courant) + m0 / b0);
  const float out = (filt_in * b0 + m0) / a0;
  for (int j = 0; j < a.order; ++j) {
    const float nxt = j + 1 < a.order ? st_in[(j + 1) * stack + idx] : 0.f;
    st_out[j * stack + idx] =
        (nxt + a.fb[p * nc + j + 1] * filt_in) - a.fa[p * nc + j + 1] * out;
  }
  out_p[idx] = new_p;
  return new_p;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// The plane pass of sub-step t: injection and taps by the grid's last
// thread, then the six plane updates, and each plane's sum added to sums
// (through `warp_sums`, kWarps x 6 floats of shared memory).
__device__ __forceinline__ void plane_pass(const ChunkArgs& a, int t,
                                           float* warp_sums,
                                           float* A, const float* PL,
                                           const float* INS,
                                           const float* PRVP, float* SP,
                                           const float* st_in,
                                           float* st_out) {
  const int gtid = block_x() * kThreads + thread_x();
  const int nthreads = gridDim.x * kThreads;
  const float sig = a.sig[t];
  if (gtid == nthreads - 1) {
    float inj = 0.f;
    if (a.src >= 0) {
      inj = a.mode == 1 ? sig : A[a.src] + sig;
      A[a.src] = inj;
    }
    float* row = a.taps + (long long)t * a.k;
    for (int j = 0; j < a.k; ++j) {
      const long long n = a.tap_idx[j];
      row[j] = n == a.src ? inj : A[n];
    }
  }
  const int uv = a.Umax * a.Vmax;
  // each warp sums its elements' values per plane into its row of
  // warp_sums; a warp's 32 elements are consecutive, so they span the
  // planes from its first lane's to its last lane's (one or two unless the
  // planes are tiny)
  const int lane = gtid & 31;
  float* const mine = warp_sums + (thread_x() >> 5) * 6;
  if (lane < 6) mine[lane] = 0.f;
  __syncwarp();
  for (int e0 = gtid - lane; e0 < 6 * uv; e0 += nthreads) {
    const int e = e0 + lane;
    const int p = e < 6 * uv ? e / uv : 5;
    float val = 0.f;
    if (e < 6 * uv) {
      const int r = e - p * uv;
      val = plane_update(a, PL, INS, PRVP, SP, st_in, st_out, t, sig, p,
                         r / a.Vmax, r % a.Vmax);
    }
    const int last = __shfl_sync(0xffffffffu, p, 31);
    for (int q = __shfl_sync(0xffffffffu, p, 0); q <= last; ++q) {
      const float sum = warp_sum(p == q ? val : 0.f);
      if (lane == 0) mine[q] += sum;
    }
  }
  __syncthreads();
  const int tid = thread_x();
  if (tid < 6) {
    float sum = 0.f;
    for (int w = 0; w < kWarps; ++w) sum += warp_sums[w * 6 + tid];
    atomicAdd(&a.sums[tid], sum);
  }
}

// The stencil value of node (x, y, z) from its six neighbours in cur and
// its prev, in the plain version's order, then the splice, the store into
// B and the extraction into INS.  The splice's plane value is read first,
// so its load overlaps the neighbours' instead of following the sum.
__device__ __forceinline__ void node(const ChunkArgs& a, const float* PL,
                                     float* INS, float* B, long long i, int x,
                                     int y, int z, float xm, float xp,
                                     float ym, float yp, float zm, float zp,
                                     float pv) {
  const wv::StencilArgs& g = a.geo;
  const int uv = a.Umax * a.Vmax, vmax = a.Vmax;
  int u, v;
  const int sp = wv::stencil_splice(g, x, y, z, &u, &v);
  const float spliced = sp >= 0 ? PL[sp * uv + u * vmax + v] : 0.f;
  const bool inside = x >= g.ilo0 && x <= g.ihi0 && y >= g.ilo1 &&
                      y <= g.ihi1 && z >= g.ilo2 && z <= g.ihi2;
  float res = 0.f;
  if (inside) {
    float acc = 0.f;
    acc += x > 0 ? xm : 0.f;
    acc += x < g.X - 1 ? xp : 0.f;
    acc += y > 0 ? ym : 0.f;
    acc += y < g.Y - 1 ? yp : 0.f;
    acc += z > 0 ? zm : 0.f;
    acc += z < g.Z - 1 ? zp : 0.f;
    res = __fmul_rn(1.0f / 3.0f, acc) - pv;
  }
  wv::stencil_finish(
      g, x, y, z, res, B + i, [&](int, int, int) { return spliced; },
      [&](int p, int u, int v) { return INS + (p * uv + u * vmax + v); });
}

// The stencil pass, one thread a node: warps stride over the (x, y) rows,
// lanes along z, each neighbour loaded.  Warp-wide z blocks whose nodes are
// all strictly inside the box on every axis (no splice, no extraction,
// every neighbour on the grid) take the bare leapfrog, kGroup blocks at a
// time where they can; any other block takes `node`.  Both compute the
// same value in the same order.
__device__ __forceinline__ void stencil_rows(const ChunkArgs& a,
                                             const float* A, float* B,
                                             const float* PL, float* INS) {
  const wv::StencilArgs& g = a.geo;
  const int X = g.X, Y = g.Y, Z = g.Z;
  const long long yz = (long long)Y * Z;
  const int lane = thread_x() & 31;
  const int nwarps = gridDim.x * kWarps;
  for (int r = block_x() * kWarps + (thread_x() >> 5); r < X * Y;
       r += nwarps) {
    const int x = r / Y, y = r - (r / Y) * Y;
    const bool xy_plain = x > g.ilo0 && x < g.ihi0 && y > g.ilo1 &&
                          y < g.ihi1;
    for (int z0 = 0; z0 < Z;) {
      const long long i = (long long)r * Z + z0 + lane;
      const bool plain = xy_plain && z0 > g.ilo2;
      if (plain && z0 + 32 * kGroup - 1 < g.ihi2) {
        wv::bare_blocks<kGroup>(A, B, i, yz, Z);
        z0 += 32 * kGroup;
        continue;
      }
      const int z = z0 + lane;
      if (plain && z0 + 31 < g.ihi2) {
        wv::bare_blocks<1>(A, B, i, yz, Z);
      } else if (z < Z) {
        const float xm = x > 0 ? A[i - yz] : 0.f;
        const float xp = x < X - 1 ? A[i + yz] : 0.f;
        const float ym = y > 0 ? A[i - Z] : 0.f;
        const float yp = y < Y - 1 ? A[i + Z] : 0.f;
        const float zm = z > 0 ? A[i - 1] : 0.f;
        const float zp = z < Z - 1 ? A[i + 1] : 0.f;
        node(a, PL, INS, B, i, x, y, z, xm, xp, ym, yp, zm, zp, B[i]);
      }
      z0 += 32;
    }
  }
}

// Plane buffer j of the three that rotate: PL, the spare, PRVP's slot.  At
// sub-step t, r = t % 3: PL is buffer r, the new planes go into buffer
// (r + 1) % 3 and PRVP is buffer (r + 2) % 3.
__device__ __forceinline__ float* plane_buf(const ChunkArgs& a, int j) {
  const int stack = 6 * a.Umax * a.Vmax;
  return j == 0 ? a.pln : (j == 1 ? a.pln_spare : a.pln + 2 * stack);
}

__global__ void __launch_bounds__(kThreads, kMinCtas)
mega_chunk_kernel(const ChunkArgs a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float warp_sums[kWarps * 6];
  if (thread_x() < 6) {
    const int nc = a.order + 1;
    face_ratio[thread_x()] = a.fa[thread_x() * nc] / a.fb[thread_x() * nc];
  }
  __syncthreads();
  const int stack = 6 * a.Umax * a.Vmax;
  float* const ins = a.pln + stack;

  for (int t = 0; t < a.K; ++t) {
    // the roles of this sub-step, from t alone: the fields and the state
    // alternate, the plane buffers rotate with period 3
    const bool odd = t & 1;
    float* const A = odd ? a.prev : a.cur;
    float* const B = odd ? a.cur : a.prev;
    const int r = t % 3;
    plane_pass(a, t, warp_sums, A, plane_buf(a, r), ins,
               plane_buf(a, (r + 2) % 3), plane_buf(a, (r + 1) % 3),
               odd ? a.st_spare : a.st, odd ? a.st : a.st_spare);
    grid.sync();  // the new planes, state, sums and the injection are out

    if (block_x() == 0 && thread_x() == 0) {
      // count the planes whose sum is not finite, and clear the sums for
      // the next sub-step's plane pass (which starts after the barrier)
      float b = 0.f;
      for (int p = 0; p < 6; ++p) {
        const float s = atomicExch(&a.sums[p], 0.f);
        if (!(fabsf(s) <= 3.402823466e38f)) b += 1.f;  // NaN or inf
      }
      a.bad[0] += b;
    }
    // PL is now the new planes
    stencil_rows(a, A, B, plane_buf(a, (r + 1) % 3), ins);
    grid.sync();  // every node of B and of INS is written
  }

  // K is even, so the fields and the state are back in cur/prev and st.
  // After K rotations PL is buffer K % 3 and PRVP buffer (K + 2) % 3: move
  // them back to their slots of pln (each element is read before it is
  // written, by one thread; the last barrier ordered the stencil pass's
  // reads of PL).
  const int r = a.K % 3;
  if (r != 0) {
    const float* PL = plane_buf(a, r);
    const float* PRVP = plane_buf(a, (r + 2) % 3);
    float* const base_prvp = a.pln + 2 * stack;
    const int gtid = block_x() * kThreads + thread_x();
    for (int e = gtid; e < stack; e += gridDim.x * kThreads) {
      const float pl = PL[e], prvp = PRVP[e];
      a.pln[e] = pl;
      base_prvp[e] = prvp;
    }
  }
}

}  // namespace

extern "C" {

// One chunk of K (even) sub-steps, in place:
//   cur, prev      (X, Y, Z) fields; on return they hold the chunk's last
//                  field and the one before, as the reference returns them;
//   st             (order, 6, Umax, Vmax) DF2T state, st_spare its twin;
//   pln            (3, 6, Umax, Vmax) carried planes PL, INS, PRVP;
//                  pln_spare (6, Umax, Vmax) the third rotating buffer;
//   sig            (K,) signal values; tap_idx (k,) flat node indices;
//   taps           (K, k) output; bad (1,) accumulates the non-finite count;
//   sums           (6,) scratch, zero on entry and on return;
//   res            (K, 4, 6, Umax, Vmax) residual block (grad mode), or null;
//   fb, fa         (6, order + 1) per-face filter coefficients;
//   geom           X, Y, Z, ilo0, ihi0, ilo1, ihi1, ilo2, ihi2, Umax, Vmax,
//                  order, K;
//   src, mode      source node (flat, or -1) and injection mode;
//   ins_uv         (u, v) of the source on each inner plane, or -1 (12 ints).
// One cooperative launch on `stream`; does not synchronise, allocates
// nothing.  Returns the CUDA error code (0 on success); a grid that cannot
// be resident at once is refused by the launch.
int wv_box_mega_chunk_f32(float* cur, float* prev, float* st, float* st_spare,
                          float* pln, float* pln_spare, const float* sig,
                          const long long* tap_idx, int k, float* taps,
                          float* bad, float* sums, float* res, const float* fb,
                          const float* fa, const int* geom, long long src,
                          int mode, const int* ins_uv, float courant,
                          float courant_sq, void* stream_ptr) {
  const int X = geom[0], Y = geom[1], Z = geom[2];
  const int Umax = geom[9], Vmax = geom[10], order = geom[11], K = geom[12];
  if (K < 2 || K % 2 != 0 || order < 1 || k < 1)
    return cudaErrorInvalidValue;
  // plane indices and the (x, y) row index are 32-bit
  const long long stack = 6LL * Umax * Vmax;
  if (stack * (order > 4 ? order : 4) > 0x7fffffffLL ||
      (long long)X * Y > 0x7fffffffLL)
    return cudaErrorInvalidValue;

  ChunkArgs a = {};  // the stencil geometry's pointers stay null
  a.cur = cur;
  a.prev = prev;
  a.st = st;
  a.st_spare = st_spare;
  a.pln = pln;
  a.pln_spare = pln_spare;
  a.sig = sig;
  a.tap_idx = tap_idx;
  a.taps = taps;
  a.bad = bad;
  a.sums = sums;
  a.res = res;
  a.fb = fb;
  a.fa = fa;
  a.src = src;
  a.mode = mode;
  a.k = k;
  a.K = K;
  a.dims[0] = X;
  a.dims[1] = Y;
  a.dims[2] = Z;
  for (int ax = 0; ax < 3; ++ax) {
    a.blo[ax] = geom[3 + 2 * ax] - 1;
    a.bhi[ax] = geom[4 + 2 * ax] + 1;
  }
  a.Umax = Umax;
  a.Vmax = Vmax;
  a.order = order;
  for (int p = 0; p < 6; ++p) {
    a.ins_u[p] = ins_uv[2 * p];
    a.ins_v[p] = ins_uv[2 * p + 1];
  }
  a.courant = courant;
  a.courant_sq = courant_sq;
  const int shape_geom[10] = {X, Y, Z, 0, geom[3], geom[4],
                              geom[5], geom[6], geom[7], geom[8]};
  wv::stencil_set_geometry(a.geo, shape_geom);

  int per_sm, ctas;
  cudaError_t e = wv::cooperative_grid(mega_chunk_kernel, kThreads, &per_sm,
                                       &ctas);
  if (e != cudaSuccess) return static_cast<int>(e);
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(mega_chunk_kernel), dim3(ctas),
      dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream_ptr));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// What the card makes of the kernel on the current device: its registers a
// thread, local memory (spills) a thread in bytes, CTAs resident on one SM,
// and the cooperative grid one chunk launches.  Returns the CUDA error code.
int wv_box_mega_chunk_occupancy(int* registers, int* local_bytes,
                                int* ctas_per_sm, int* grid) {
  return wv::chunk_occupancy(mega_chunk_kernel, kThreads, registers,
                             local_bytes, ctas_per_sm, grid);
}

const char* wv_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
