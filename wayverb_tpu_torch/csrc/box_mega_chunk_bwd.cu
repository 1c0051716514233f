// Adjoint of the mega chunk of the shoebox waveguide: K reverse sub-steps of
// the adjoint leapfrog in one persistent cooperative launch, CUDA C++ for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_MegaBwdKernel.kernel` of
// wayverb_tpu/waveguide/box_mega.py.  It computes what the port's plain
// version `_mega_chunk_bwd_plain` (wayverb_tpu_torch/waveguide/box_mega.py)
// computes.  The plain version carries P (cotangent of the newer field), Q
// (partial cotangent of the older field) and gst (cotangent of the DF2T
// state); with M the inside mask of the box, sub-step t = K-1 .. 0 does
//   Q  <- Q + lambda^2 * sum of M * P over the six face neighbours
//          + gpl at the plane coordinates + gin at the inner coordinates
//   Q[taps] += gtaps[t];  gsig[t] = Q[src];  a hard source zeroes Q[src]
//   (P, Q) <- (Q, -M * P + gprev at the plane coordinates)
// where (gpl, gin, gprev, gst) is the transpose of the six plane updates at
// (gpplus = P at the plane coordinates, gst).
//
// The two-field form.  Q after sub-step t is -M * P_t + gprev_t, the older
// field negated under the mask plus a plane-sized term.  So the kernel never
// stores it: sub-step t computes, for each node,
//   R[i] = (-M * P_{t+1}[i] + gprev_{t+1}) + lambda^2 * sum of M * P_t[nb]
//          + gpl + gin + taps                 (the explicit gcur at t = K-1)
// and writes it over P_{t+1}[i], which no other thread reads.  That is a
// leapfrog on two fields in place, as the forward is: at a node strictly
// inside the box, off the inner planes, with no tap and no source, it is
// (1/3) * acc - P_{t+1}[i], the forward's bare leapfrog to the bit
// (`wv::bare_blocks`, box_chunk.cuh), which about 75 % of the hall's warps
// run.  Only after the last sub-step is Q written out, into the spare field.
//
// Each sub-step t runs two passes between grid barriers:
//   plane pass, the grid striding over the (6, Umax, Vmax) plane elements:
//     gpplus from P_t under the splice precedence y < z < x (an x plane
//     beats a z plane beats a y plane), into row t of the gpplus stream;
//     gst as it enters, into row t of the gst' stream, shifted up a slot;
//     D, gprev and gst's slot 0 without the edge coupling (below);
//   node pass, one thread a node: first the nodes on the six boundary
//     planes, the grid striding over the plane elements (each node from the
//     first plane it lies on); then every other node, warps striding over
//     the (x, y) rows, lanes along z, as the forward's stencil pass: the
//     rows strictly inside the box in x and y, then the others, numbered
//     densely so that no warp draws more than its share of them.  Bare
//     warp-wide z blocks run in groups of kGroup; every other block runs
//     `node`, which reads Q implicitly (or gcur), adds the stencil's
//     transpose, then for each plane or inner plane the node lies on, in
//     plane order, gpl (gathered from D of the plane's four in-plane
//     neighbours) or gin; then the taps in tap order, duplicates included;
//     then gsig[t] = R[src] and a hard source's zero; and for each plane the
//     node lies on, the edge coupling into that element's gst slot 0.  A
//     row that holds a tap or the source runs `node` everywhere (flags set
//     at the launch's start).
//   At t = 0 every node also writes Q = -M * P_0 + gprev_0 into the spare.
//
// The transpose of the plane update.  The TPU kernel differentiates
// `plane_step_one` inside the kernel at zero primals (the update is linear in
// pressures and state); here the transpose is written out by hand.  Forward,
// for element e of plane p with coefficients b, a:
//   csw   = lambda^2 (2 in[e] + w_um[e] pl[e-U] + w_up[e] pl[e+U]
//                     + w_vm[e] pl[e-1] + w_vp[e] pl[e+1])
//   fw    = m0[e] / b0 + sum over planes q sharing the node of m0_q[e_q] / b0_q
//   cw    = lambda (a0 / b0 + sum over those q of a0_q / b0_q)
//   new_p = act (csw + lambda^2 fw + (cw - 1) prev[e]) / (1 + cw)
//   delta = prev[e] - new_p
//   filt  = -(a0 delta / (b0 lambda) + m0[e] / b0)
//   out   = (filt b0 + m0[e]) / a0
//   st'[j] = st[j + 1] + b[j + 1] filt - a[j + 1] out       (st[order] = 0)
// Transposed, with gp the cotangent of new_p and gs[j] of st'[j]:
//   gout   = -sum_j a[j + 1] gs[j]
//   gfilt  = sum_j b[j + 1] gs[j] + gout b0 / a0
//   gdelta = -gfilt a0 / (b0 lambda)
//   D      = act (gp - gdelta) / (1 + cw)
//   gprev[e] = gdelta + (cw - 1) D
//   gin[e]   = 2 lambda^2 D
//   gpl[e]   = lambda^2 (w_um[e+U] D[e+U] + w_up[e-U] D[e-U]
//                        + w_vm[e+1] D[e+1] + w_vp[e-1] D[e-1])
//   gst[0][e] = gout / a0 - gfilt / b0
//               + (lambda^2 / b0) (D[e] + sum over planes q sharing the node
//                                  of D_q[e_q])
//   gst[j + 1][e] = gs[j]
// The weights apply at the element that read the neighbour, and the edge
// coupling is symmetric: plane q at a shared node read this plane's m0 there,
// so its D comes back.  Both are gathers; each plane element maps to one
// node, whose thread does both.
//
// Launch: one cudaLaunchCooperativeKernel a chunk, of a grid that is
// resident at once (CTAs an SM from the occupancy calculator x SMs), as the
// forward chunk (box_mega_chunk.cu).  The ordering rules become barrier
// points:
//   - every thread derives the roles of a sub-step from t alone: P_t is
//     (gnext, gcur)[(K - 1 - t) % 2] and the older field the other one;
//     gprev is written into plane buffer t % 2 and read, one sub-step later,
//     from buffer (t + 1) % 2, so the plane pass of sub-step t never writes
//     what the node pass of t reads from the previous sub-step;
//   - D is written by the plane pass and read, across elements and planes,
//     by the node pass after the barrier;
//   - gst's slot 0 gets its local part in the plane pass and the coupling
//     in the node pass, from the one thread that owns the element's node;
//     the next plane pass streams it as it enters, after the barrier;
//   - the row flags and gsig's zeros are written before the first barrier;
//   - every value one thread writes and another reads (fields, D, gprev,
//     gst, flags) is read after a grid barrier, with plain loads: nothing
//     goes through the non-coherent path (no __ldg, no const __restrict__
//     on anything the kernel writes).
// The node pass needs no atomics: every output element has one writer.
//
// What bounds a sub-step on the card: the two fields (2 x 49 MiB at 224 x
// 224 x 256) fit neither L2 nor shared memory, so every sub-step streams
// them, 12 B a node as the forward, plus the plane streams (the state, its
// stream, gpplus, D and gprev: about 31 MB at the hall, order 6).  As in the
// forward, both passes are bound by loads in flight, not by bytes, and the
// node pass also by the instructions of `node`, which a quarter of the
// nodes run.  So every load of an element or a node is issued before its
// first store (the buffers are not __restrict__: a store holds back every
// later load), the boundary nodes' gathers run in a loop of their own, and
// rows strictly inside the box in x and y run a `node` with only the z
// tests (PERF.md, PR 12, has what each step bought).  Sums
// follow the plain version's order where it is cheap to; autograd's order
// differs in the plane transpose, so kernel and plain agree to rounding, not
// to the bit.  The file is compiled with --fmad=false, and products with a
// 0/1/2 weight or a 0/1 mask go through __fmul_rn, as the plain version
// multiplies them (0 * inf is NaN, never folded into a select).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "box_chunk.cuh"

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
constexpr int kSlots = 6;      // state slots a plane element loads at once

struct BwdArgs {
  float* gnext;               // (X, Y, Z) field buffer 0
  float* gcur;                // (X, Y, Z) field buffer 1
  float* spare;               // (X, Y, Z) takes Q after the last sub-step
  float* gst;                 // (order, 6, Umax, Vmax), updated in place
  float* gp_stream;           // (K, 6, Umax, Vmax) output
  float* gstin_stream;        // (K, order, 6, Umax, Vmax) output
  float* D;                   // (6, Umax, Vmax) scratch
  float* gprv;                // (2, 6, Umax, Vmax) scratch, by t % 2
  unsigned char* special;     // (X * Y) rows holding a tap or the source
  const float* fb;            // (6, order + 1) per-face filter numerator
  const float* fa;            // (6, order + 1) denominator
  const float* gtaps;         // (K, k) tap cotangents
  const long long* tap_idx;   // (k,) flat node indices
  float* gsig;                // (K,) signal cotangent
  long long src;              // flat index of the source node, or -1
  int k, mode, K;
  int dims[3];
  int blo[3], bhi[3];         // boundary-plane coordinates per axis
  int Umax, Vmax, order;
  float courant, courant_sq;
};

// b0, a0 and a0 / b0 of each face's filter, read once a CTA.
__shared__ float face_b0[6];
__shared__ float face_a0[6];
__shared__ float face_ratio[6];

__device__ __forceinline__ float w_minus(int i, int lo, int hi) {
  return i == lo ? 0.f : (i == hi ? 2.f : 1.f);   // weight of the i-1 read
}

__device__ __forceinline__ float w_plus(int i, int lo, int hi) {
  return i == lo ? 2.f : (i == hi ? 0.f : 1.f);   // weight of the i+1 read
}

// The plane pass of sub-step t on P (= P_t): everything of the plane
// transpose that one element computes from its own values.
__device__ __forceinline__ void plane_pass(const BwdArgs& a, int t,
                                           const float* P, float* gprv_out) {
  const int uv = a.Umax * a.Vmax;
  const int stack = 6 * uv;
  const int nc = a.order + 1;
  float* const gp_row = a.gp_stream + (long long)t * stack;
  float* const gstin_row = a.gstin_stream + (long long)t * a.order * stack;
  for (int e = block_x() * kThreads + thread_x(); e < stack;
       e += gridDim.x * kThreads) {
    const int p = e / uv;
    const int u = (e - p * uv) / a.Vmax;
    const int v = e - p * uv - u * a.Vmax;
    const int ax = p >> 1;
    int a1, a2;
    other_axes(ax, &a1, &a2);
    // the padding streams what enters and leaves zeros behind
    const bool pad = u >= pick3(a.dims, a1) || v >= pick3(a.dims, a2);
    const int gax = (p & 1) == 0 ? pick3(a.blo, ax) : pick3(a.bhi, ax);
    const int gx = ax == 0 ? gax : u;
    const int gy = ax == 1 ? gax : (ax == 0 ? u : v);
    const int gz = ax == 2 ? gax : v;

    // gpplus from the raw P under the splice precedence y < z < x
    const bool on_x = gx == a.blo[0] || gx == a.bhi[0];
    const bool on_z = gz == a.blo[2] || gz == a.bhi[2];
    const bool killed = (ax == 1 && (on_x || on_z)) || (ax == 2 && on_x);
    const float gp =
        pad || killed
            ? 0.f
            : P[((long long)gx * a.dims[1] + gy) * a.dims[2] + gz];

    // stream gst' as it enters, shift it up a slot, and take its two sums
    // (j descending), kSlots slots at a time: each group's loads go out
    // before its stores, which would hold them back (no __restrict__)
    float sum_a = 0.f, sum_b = 0.f;
    for (int top = a.order - 1; top >= 0; top -= kSlots) {
      float gs[kSlots], ca[kSlots], cb[kSlots];
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        const int j = top - k;
        gs[k] = j >= 0 ? a.gst[j * stack + e] : 0.f;
        ca[k] = j >= 0 ? a.fa[p * nc + j + 1] : 0.f;
        cb[k] = j >= 0 ? a.fb[p * nc + j + 1] : 0.f;
      }
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        const int j = top - k;
        if (j < 0) break;
        gstin_row[j * stack + e] = gs[k];
        sum_a += ca[k] * gs[k];
        sum_b += cb[k] * gs[k];
        if (j + 1 < a.order) a.gst[(j + 1) * stack + e] = pad ? 0.f : gs[k];
      }
    }
    gp_row[e] = gp;
    if (pad) {
      a.gst[e] = 0.f;
      a.D[e] = 0.f;
      gprv_out[e] = 0.f;
      continue;
    }
    const float b0 = face_b0[p], a0 = face_a0[p];
    const float gout = -sum_a;
    const float gfilt = sum_b + gout * b0 / a0;
    const float gdelta = -(gfilt * a0) / (b0 * a.courant);

    // the faces that share the element's node add their a0 / b0
    float cw = face_ratio[p];
    const int lo1 = pick3(a.blo, a1), hi1 = pick3(a.bhi, a1);
    const int lo2 = pick3(a.blo, a2), hi2 = pick3(a.bhi, a2);
    if (u == lo1) cw += face_ratio[2 * a1];
    if (u == hi1) cw += face_ratio[2 * a1 + 1];
    if (v == lo2) cw += face_ratio[2 * a2];
    if (v == hi2) cw += face_ratio[2 * a2 + 1];
    cw = a.courant * cw;
    const float act = (u >= lo1 && u <= hi1 && v >= lo2 && v <= hi2)
                          ? 1.f : 0.f;
    const float Dv = __fmul_rn(act, (gp - gdelta) / (1.f + cw));
    a.D[e] = Dv;
    gprv_out[e] = gdelta + (cw - 1.f) * Dv;
    a.gst[e] = gout / a0 - gfilt / b0;   // slot 0; the coupling follows
  }
}

// The boundary plane normal to axis ax that coordinate c lies on (2 ax or
// 2 ax + 1), or -1.
__device__ __forceinline__ int boundary_plane(const BwdArgs& a, int ax,
                                              int c) {
  return c == pick3(a.blo, ax) ? 2 * ax
                               : (c == pick3(a.bhi, ax) ? 2 * ax + 1 : -1);
}

// The in-plane index u * Vmax + v of node (x, y, z) in the planes normal to
// axis ax.
__device__ __forceinline__ int in_plane(const BwdArgs& a, int ax, int x,
                                        int y, int z) {
  return (ax == 0 ? y : x) * a.Vmax + (ax == 2 ? y : z);
}

// gpl at element e of plane p, at in-plane (u, v): what the four in-plane
// neighbours read of this element, lambda^2 D weighted as they weighted it.
__device__ __forceinline__ float gather_gpl(const BwdArgs& a, int p, int e,
                                            int u, int v) {
  int a1, a2;
  other_axes(p >> 1, &a1, &a2);
  const int lo1 = pick3(a.blo, a1), hi1 = pick3(a.bhi, a1);
  const int lo2 = pick3(a.blo, a2), hi2 = pick3(a.bhi, a2);
  const float* d = a.D + e;
  const float c2 = a.courant_sq;
  float s = 0.f;
  if (u + 1 < pick3(a.dims, a1))
    s += __fmul_rn(w_minus(u + 1, lo1, hi1), d[a.Vmax] * c2);
  if (u > 0) s += __fmul_rn(w_plus(u - 1, lo1, hi1), d[-a.Vmax] * c2);
  if (v + 1 < pick3(a.dims, a2))
    s += __fmul_rn(w_minus(v + 1, lo2, hi2), d[1] * c2);
  if (v > 0) s += __fmul_rn(w_plus(v - 1, lo2, hi2), d[-1] * c2);
  return s;
}

__device__ __forceinline__ bool in_box(const BwdArgs& a, int x, int y,
                                       int z) {
  return x > a.blo[0] && x < a.bhi[0] && y > a.blo[1] && y < a.bhi[1] &&
         z > a.blo[2] && z < a.bhi[2];
}

// The adjoint at node (x, y, z), flat index i: R written over the older
// field B.  A node lies on at most one boundary plane of each axis, or on
// its inner planes.  kBoundary false compiles the boundary planes' part out
// (the row walk leaves boundary nodes to `boundary_nodes`); kInnerRow, for
// a row strictly inside the box in x and y, leaves only the z tests: the
// pass issues this code for a quarter of the nodes, so its instructions
// count.  Every load comes before the first store: the buffers are not
// __restrict__, so a store would hold back every later load, and the pass
// is bound by the loads in flight.
template <bool kBoundary, bool kInnerRow>
__device__ __forceinline__ void node(const BwdArgs& a, int t, const float* A,
                                     float* B, const float* gprv_in,
                                     long long i, int x, int y, int z,
                                     bool special) {
  const long long yz = (long long)a.dims[1] * a.dims[2];
  const int Z = a.dims[2];
  const int uv = a.Umax * a.Vmax;
  const float c2 = a.courant_sq;
  // M * P over the six neighbours, x-, x+, y-, y+, z-, z+ (the box lies
  // inside the grid, so a neighbour inside the box is on it)
  auto inside = [&](int xx, int yy, int zz) {
    return kInnerRow ? zz > a.blo[2] && zz < a.bhi[2] : in_box(a, xx, yy, zz);
  };
  float acc = 0.f;
  acc += inside(x - 1, y, z) ? A[i - yz] : 0.f;
  acc += inside(x + 1, y, z) ? A[i + yz] : 0.f;
  acc += inside(x, y - 1, z) ? A[i - Z] : 0.f;
  acc += inside(x, y + 1, z) ? A[i + Z] : 0.f;
  acc += inside(x, y, z - 1) ? A[i - 1] : 0.f;
  acc += inside(x, y, z + 1) ? A[i + 1] : 0.f;
  const float older = B[i];
  // per axis: the boundary plane's gprev, its D and slot 0 of gst here, and
  // the term of plane 2 ax (lo) and 2 ax + 1 (hi): gpl on a boundary
  // plane, gin = 2 lambda^2 D on an inner plane
  int bp[3];
  bool has_lo[3], has_hi[3];
  float gpv[3], lo[3], hi[3], dself[3], gs0[3];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    gpv[ax] = dself[ax] = gs0[ax] = lo[ax] = hi[ax] = 0.f;
    bp[ax] = -1;
    has_lo[ax] = has_hi[ax] = false;
    if (kInnerRow && ax < 2) continue;   // strictly inside in x and y
    const int c = ax == 0 ? x : (ax == 1 ? y : z);
    const int u = ax == 0 ? y : x, v = ax == 2 ? y : z;
    const int e = in_plane(a, ax, x, y, z);
    bp[ax] = kBoundary ? boundary_plane(a, ax, c) : -1;
    const bool in_lo = c == pick3(a.blo, ax) + 1;
    const bool in_hi = c == pick3(a.bhi, ax) - 1;
    has_lo[ax] = bp[ax] == 2 * ax || in_lo;
    has_hi[ax] = bp[ax] == 2 * ax + 1 || in_hi;
    if (bp[ax] >= 0) {
      const int pe = bp[ax] * uv + e;
      gpv[ax] = gprv_in[pe];
      dself[ax] = a.D[pe];
      gs0[ax] = a.gst[pe];
      const float gpl = gather_gpl(a, bp[ax], pe, u, v);
      if (bp[ax] & 1) hi[ax] = gpl;
      else lo[ax] = gpl;
    }
    if (in_lo) lo[ax] = 2.f * (a.D[2 * ax * uv + e] * c2);
    if (in_hi) hi[ax] = 2.f * (a.D[(2 * ax + 1) * uv + e] * c2);
  }
  // Q (implicit, or the explicit gcur at t = K - 1), the stencil's
  // transpose, then the planes in plane order: the plain version's order
  float r = older;
  if (t != a.K - 1) {
    r = -(inside(x, y, z) ? older : 0.f);
#pragma unroll
    for (int ax = 0; ax < 3; ++ax)
      if (bp[ax] >= 0) r += gpv[ax];
  }
  r = r + __fmul_rn(c2, acc);
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    if (has_lo[ax]) r += lo[ax];
    if (has_hi[ax]) r += hi[ax];
  }
  if (special) {
    // the taps in tap order, duplicates included, then the source
    const float* gt = a.gtaps + (long long)t * a.k;
    for (int j = 0; j < a.k; ++j)
      if (a.tap_idx[j] == i) r += gt[j];
    if (i == a.src) {
      a.gsig[t] = r;
      if (a.mode == 1) r = 0.f;
    }
  }
  B[i] = r;
  // the edge coupling into slot 0 of each boundary element at this node:
  // every other plane through the node read its m0 here
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    if (bp[ax] < 0) continue;
    float d = dself[ax];
#pragma unroll
    for (int q = 0; q < 3; ++q)
      if (q != ax && bp[q] >= 0) d += dself[q];
    a.gst[bp[ax] * uv + in_plane(a, ax, x, y, z)] =
        gs0[ax] + c2 * d / face_b0[bp[ax]];
  }
}

__device__ __forceinline__ bool on_boundary_plane(const BwdArgs& a, int p,
                                                  int x, int y, int z) {
  const int ax = p >> 1;
  const int c = ax == 0 ? x : (ax == 1 ? y : z);
  return c == ((p & 1) ? pick3(a.bhi, ax) : pick3(a.blo, ax));
}

// The nodes on the six boundary planes (about 330,000 at the hall), each
// from the first plane it lies on, the grid striding over the plane
// elements: their gather of the plane transpose and the edge coupling
// spread over every thread instead of falling to the warps whose rows are
// boundary rows.
__device__ __forceinline__ void boundary_nodes(const BwdArgs& a, int t,
                                               const float* A, float* B,
                                               const float* gprv_in) {
  const int uv = a.Umax * a.Vmax;
  for (int e = block_x() * kThreads + thread_x(); e < 6 * uv;
       e += gridDim.x * kThreads) {
    const int p = e / uv;
    const int u = (e - p * uv) / a.Vmax;
    const int v = e - p * uv - u * a.Vmax;
    const int ax = p >> 1;
    int a1, a2;
    other_axes(ax, &a1, &a2);
    if (u >= pick3(a.dims, a1) || v >= pick3(a.dims, a2)) continue;
    const int gax = (p & 1) == 0 ? pick3(a.blo, ax) : pick3(a.bhi, ax);
    const int x = ax == 0 ? gax : u;
    const int y = ax == 1 ? gax : (ax == 0 ? u : v);
    const int z = ax == 2 ? gax : v;
    bool earlier = false;
    for (int q = 0; q < p; ++q) earlier |= on_boundary_plane(a, q, x, y, z);
    if (earlier) continue;
    const int r = x * a.dims[1] + y;
    node<true, false>(a, t, A, B, gprv_in, (long long)r * a.dims[2] + z, x,
                      y, z, a.special[r] != 0);
  }
}

// The z blocks of row (x, y), lanes along z; kInnerRow: the row is
// strictly inside the box in x and y.  Warp-wide z blocks strictly inside
// the box on every axis take the bare leapfrog, kGroup blocks at a time
// where they can, when `bare_row` (an inner row that holds no tap and no
// source, and t < K - 1, where the older field is the explicit gcur); any
// other block takes `node`, but for its boundary nodes.
template <bool kInnerRow>
__device__ __forceinline__ void row_blocks(const BwdArgs& a, int t,
                                           const float* A, float* B,
                                           const float* gprv_in, int x, int y,
                                           bool bare_row, bool special) {
  const int Z = a.dims[2];
  const long long yz = (long long)a.dims[1] * Z;
  const long long row = ((long long)x * a.dims[1] + y) * Z;
  const int lane = thread_x() & 31;
  const int lo2 = a.blo[2] + 1, hi2 = a.bhi[2] - 1;
  for (int z0 = 0; z0 < Z;) {
    const long long i = row + z0 + lane;
    const bool bare = bare_row && z0 > lo2;
    if (bare && z0 + 32 * kGroup - 1 < hi2) {
      wv::bare_blocks<kGroup>(A, B, i, yz, Z);
      z0 += 32 * kGroup;
      continue;
    }
    const int z = z0 + lane;
    if (bare && z0 + 31 < hi2)
      wv::bare_blocks<1>(A, B, i, yz, Z);
    else if (z < Z && z != a.blo[2] && z != a.bhi[2])
      node<false, kInnerRow>(a, t, A, B, gprv_in, i, x, y, z, special);
    z0 += 32;
  }
}

// The node pass of sub-step t: the boundary nodes, then the other rows,
// warps striding first over the rows strictly inside the box in x and y,
// then over the others (those at or outside the inner planes; a row on a
// boundary plane holds only boundary nodes and is skipped).  The second
// walk numbers its rows densely, so no warp draws more than its share of
// the rows that run `node` in every block.  Two walks, each with its row
// kind fixed at compile time, measured 12 µs a sub-step faster at the hall
// than one walk that picks the kind row by row (PERF.md, PR 12, run j).
__device__ __forceinline__ void node_pass(const BwdArgs& a, int t,
                                          const float* A, float* B,
                                          const float* gprv_in) {
  boundary_nodes(a, t, A, B, gprv_in);
  const int X = a.dims[0], Y = a.dims[1];
  const int warp = block_x() * kWarps + (thread_x() >> 5);
  const int nwarps = gridDim.x * kWarps;
  // rows strictly inside in x and y: x in [xl, xh], y in [yl, yh]
  const int xl = a.blo[0] + 2, xh = a.bhi[0] - 2;
  const int yl = a.blo[1] + 2, yh = a.bhi[1] - 2;
  const int nx = xh - xl + 1 > 0 ? xh - xl + 1 : 0;
  const int ny = yh - yl + 1 > 0 ? yh - yl + 1 : 0;
  const int inner_rows = nx * ny;
  for (int k = warp; k < inner_rows; k += nwarps) {
    const int x = xl + k / ny, y = yl + k % ny;
    const bool special = a.special[x * Y + y] != 0;
    row_blocks<true>(a, t, A, B, gprv_in, x, y, !special && t != a.K - 1,
                     special);
  }
  // the others, numbered on from the inner rows' last warp: every y for
  // x < xl, then y < yl or y > yh for x in [xl, xh], then every y above
  const int band = xl * Y, side = Y - ny;
  const int outer_rows = X * Y - inner_rows;
  for (int k = ((warp - inner_rows) % nwarps + nwarps) % nwarps;
       k < outer_rows; k += nwarps) {
    int x, y;
    if (k < band) {
      x = k / Y;
      y = k % Y;
    } else if (k < band + nx * side) {
      const int j = k - band;
      x = xl + j / side;
      y = j % side;
      if (y >= yl) y += ny;
    } else {
      const int j = k - band - nx * side;
      x = xl + nx + j / Y;
      y = j % Y;
    }
    if (x == a.blo[0] || x == a.bhi[0] || y == a.blo[1] || y == a.bhi[1])
      continue;   // a row of boundary nodes
    row_blocks<false>(a, t, A, B, gprv_in, x, y, false,
                      a.special[x * Y + y] != 0);
  }
}

// After the node pass of t = 0: the spare takes Q = -M * P_0 + gprev_0.
// A (P_0) is not written in this sub-step, so no barrier is needed.
__device__ __forceinline__ void write_q(const BwdArgs& a, const float* A,
                                        const float* gprv_0) {
  const int Y = a.dims[1], Z = a.dims[2];
  const int uv = a.Umax * a.Vmax;
  const int lane = thread_x() & 31;
  for (int r = block_x() * kWarps + (thread_x() >> 5); r < a.dims[0] * Y;
       r += gridDim.x * kWarps) {
    const int x = r / Y, y = r - (r / Y) * Y;
    for (int z = lane; z < Z; z += 32) {
      const long long i = (long long)r * Z + z;
      float q = -(in_box(a, x, y, z) ? A[i] : 0.f);
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) {
        const int p =
            boundary_plane(a, ax, ax == 0 ? x : (ax == 1 ? y : z));
        if (p >= 0) q += gprv_0[p * uv + in_plane(a, ax, x, y, z)];
      }
      a.spare[i] = q;
    }
  }
}

__global__ void __launch_bounds__(kThreads, kMinCtas)
mega_chunk_bwd_kernel(const BwdArgs a) {
  cg::grid_group grid = cg::this_grid();
  if (thread_x() < 6) {
    const int nc = a.order + 1;
    face_b0[thread_x()] = a.fb[thread_x() * nc];
    face_a0[thread_x()] = a.fa[thread_x() * nc];
    face_ratio[thread_x()] = face_a0[thread_x()] / face_b0[thread_x()];
  }
  __syncthreads();
  // the rows that hold a tap or the source, and gsig's zeros
  const int rows = a.dims[0] * a.dims[1];
  for (int r = block_x() * kThreads + thread_x(); r < rows;
       r += gridDim.x * kThreads)
    a.special[r] = 0;
  grid.sync();
  {
    const int g = block_x() * kThreads + thread_x();
    if (g < a.k) a.special[a.tap_idx[g] / a.dims[2]] = 1;
    if (g == 0 && a.src >= 0) a.special[a.src / a.dims[2]] = 1;
    if (g < a.K) a.gsig[g] = 0.f;
  }
  grid.sync();

  const int stack = 6 * a.Umax * a.Vmax;
  for (int t = a.K - 1; t >= 0; --t) {
    // the roles of this sub-step, from t alone
    const bool odd = (a.K - 1 - t) & 1;
    float* const A = odd ? a.gcur : a.gnext;     // P_t
    float* const B = odd ? a.gnext : a.gcur;     // the older field
    float* const gprv_out = a.gprv + (t & 1) * stack;
    plane_pass(a, t, A, gprv_out);
    grid.sync();  // D, gprev, gst's local part and the streams are out
    node_pass(a, t, A, B, a.gprv + ((t + 1) & 1) * stack);
    if (t == 0) write_q(a, A, gprv_out);
    grid.sync();  // every node of B and gst's coupling are written
  }
}

}  // namespace

extern "C" {

// One chunk of K (even) reverse sub-steps:
//   gnext, gcur    (X, Y, Z) cotangents of the chunk's returned cur and prev;
//                  on return gnext holds the cotangent of the chunk's input
//                  cur, and gcur scratch;
//   spare          (X, Y, Z) output: the cotangent of the chunk's input prev;
//   gst            (order, 6, Umax, Vmax) state cotangent, updated in place;
//   scratch        3 * 6 * Umax * Vmax floats (D, gprev twice), then X * Y
//                  bytes of row flags;
//   gtaps          (K, k) tap cotangents; tap_idx (k,) flat node indices;
//   gsig           (K,) output: the signal cotangent, in forward time;
//   gp_stream      (K, 6, Umax, Vmax) output: gpplus per sub-step;
//   gstin_stream   (K, order, 6, Umax, Vmax) output: gst' as it enters;
//   fb, fa         (6, order + 1) per-face filter coefficients;
//   geom           X, Y, Z, ilo0, ihi0, ilo1, ihi1, ilo2, ihi2, Umax, Vmax,
//                  order, K;
//   src, mode      source node (flat, or -1) and injection mode.
// One cooperative launch on `stream`; does not synchronise, allocates
// nothing.  Returns the CUDA error code (0 on success); a grid that cannot
// be resident at once is refused by the launch.
int wv_box_mega_chunk_bwd_f32(float* gnext, float* gcur, float* spare,
                              float* gst, float* scratch, const float* gtaps,
                              const long long* tap_idx, int k, float* gsig,
                              float* gp_stream, float* gstin_stream,
                              const float* fb, const float* fa,
                              const int* geom, long long src, int mode,
                              float courant, float courant_sq,
                              void* stream_ptr) {
  const int X = geom[0], Y = geom[1], Z = geom[2];
  const int Umax = geom[9], Vmax = geom[10], order = geom[11], K = geom[12];
  if (K < 2 || K % 2 != 0 || order < 1 || k < 1)
    return cudaErrorInvalidValue;
  // plane indices and the (x, y) row index are 32-bit
  const long long stack = 6LL * Umax * Vmax;
  if (stack * (order > 3 ? order : 3) > 0x7fffffffLL ||
      (long long)X * Y > 0x7fffffffLL)
    return cudaErrorInvalidValue;

  BwdArgs a = {};
  a.gnext = gnext;
  a.gcur = gcur;
  a.spare = spare;
  a.gst = gst;
  a.gp_stream = gp_stream;
  a.gstin_stream = gstin_stream;
  a.D = scratch;
  a.gprv = scratch + stack;
  a.special = reinterpret_cast<unsigned char*>(scratch + 3 * stack);
  a.fb = fb;
  a.fa = fa;
  a.gtaps = gtaps;
  a.tap_idx = tap_idx;
  a.gsig = gsig;
  a.src = mode > 0 ? src : -1;
  a.k = k;
  a.mode = mode;
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
  a.courant = courant;
  a.courant_sq = courant_sq;

  int per_sm, ctas;
  cudaError_t e = wv::cooperative_grid(mega_chunk_bwd_kernel, kThreads,
                                       &per_sm, &ctas);
  if (e != cudaSuccess) return static_cast<int>(e);
  // the set-up writes k flags and K zeros with one thread each
  if ((long long)ctas * kThreads < (k > K ? k : K)) return cudaErrorInvalidValue;
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(mega_chunk_bwd_kernel), dim3(ctas),
      dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream_ptr));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// Registers a thread, local bytes a thread, CTAs an SM and the cooperative
// grid of the adjoint chunk kernel on the current device.
int wv_box_mega_chunk_bwd_occupancy(int* registers, int* local_bytes,
                                    int* ctas_per_sm, int* grid) {
  return wv::chunk_occupancy(mega_chunk_bwd_kernel, kThreads, registers,
                             local_bytes, ctas_per_sm, grid);
}

const char* wv_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
