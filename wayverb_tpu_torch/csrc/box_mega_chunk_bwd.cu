// Adjoint of the mega chunk of the shoebox waveguide: K reverse sub-steps of
// the adjoint leapfrog in one call, CUDA C++ for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_MegaBwdKernel.kernel` of
// wayverb_tpu/waveguide/box_mega.py.  It computes what the port's plain
// version `_mega_chunk_bwd_plain` (wayverb_tpu_torch/waveguide/box_mega.py)
// computes.  Carrying P (cotangent of the newer field), Q (partial cotangent
// of the older field) and gst (cotangent of the DF2T state), sub-step
// t = K-1 .. 0 does, with M the inside mask of the box:
//
//   plane kernel 1, one thread per (plane, u, v) of (6, Umax, Vmax):
//     - gpplus = P at the element's node, zero where a later splice of the
//       forward step overwrites the plane (an x plane beats a z plane beats
//       a y plane); written to row t of the gpplus stream;
//     - gst as it enters, written to row t of the gst' stream;
//     - the transpose of the element's DF2T update (below): D, gin, gprev,
//       the state shift gst[j + 1] <- gst[j], and the element's own part of
//       gst[0];
//   plane kernel 2, one thread per (plane, u, v): the parts of the transpose
//     that cross elements, as gathers of D: gpl from the four in-plane
//     neighbours, and the edge coupling into gst[0] from the at most two
//     other planes that share the element's node;
//   node kernel, one thread per node:
//       Q  <- Q + lambda^2 * sum of M * P over the six face neighbours
//               + gpl at the plane coordinates + gin at the inner coordinates
//       P' <- -M * P + gprev at the plane coordinates   (into a spare field)
//     a node on a shared edge line or corner sums every plane it lies on;
//   point kernel, one thread: Q[taps] += gtaps[t]; gsig[t] = Q[src] after
//     every add into it; a hard source then zeroes Q[src].
//   Then (P, Q, spare) <- (Q, spare, P) by pointer.
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
// so its D comes back.  Both are gathers; nothing is scattered.
//
// Read-before-write hazards inside one launch are designed out: every
// buffer a launch writes is either written at the thread's own element only
// (gst, Q) or not read by that launch at all (D, gpl, gin, gprev, the spare
// field that takes P').  P' cannot go over P, whose neighbours the same
// launch reads; hence the third field and the rotation.  After K sub-steps
// the results lie in buffer K mod 3 (P) and (K + 1) mod 3 (Q) of (gnext,
// gcur, spare); the caller picks them, nothing is copied.
//
// The slab loops, staging buffers and lane tricks of the TPU kernel answer
// VMEM and Mosaic and are not carried over.  What bounds a sub-step on the
// card: the node kernel's 16 B/node of device traffic (P and Q read, Q and
// P' written) plus about 10 MB of plane streams.  Sums follow the plain
// version's order where it is cheap to; autograd's order differs in the
// plane transpose, so kernel and plain agree to rounding, not to the bit.

#include <cuda_runtime.h>

namespace {

constexpr int kPlaneBlock = 256;  // threads per plane-kernel block
constexpr int kBlockZ = 128;      // node-kernel threads along z
constexpr int kBlockY = 2;        // node-kernel threads along y

struct BwdArgs {
  const float* P;             // (X, Y, Z) cotangent of the newer field
  float* Q;                   // (X, Y, Z) partial cotangent of the older
  float* Pnew;                // (X, Y, Z) spare field, takes P'
  float* gst;                 // (order, 6, Umax, Vmax), updated in place
  float* gp_row;              // (6, Umax, Vmax) row t of the gpplus stream
  float* gstin_row;           // (order, 6, Umax, Vmax) row t of the gst' stream
  float* D;                   // (6, Umax, Vmax) scratch
  float* gpl;                 // (6, Umax, Vmax) scratch
  float* gin;                 // (6, Umax, Vmax) scratch
  float* gprv;                // (6, Umax, Vmax) scratch
  const float* fb;            // (6, order + 1) per-face filter numerator
  const float* fa;            // (6, order + 1) denominator
  const float* gtaps_row;     // (k,) row t of the tap cotangents
  const long long* tap_idx;   // (k,) flat node indices
  float* gsig;                // this sub-step's signal cotangent
  long long src;              // flat index of the source node, or -1
  int k, mode;
  int dims[3];
  int blo[3], bhi[3];         // boundary-plane coordinates per axis
  int Umax, Vmax, order;
  float courant, courant_sq;
};

__device__ __forceinline__ void other_axes(int a, int* a1, int* a2) {
  *a1 = a == 0 ? 1 : 0;
  *a2 = a == 2 ? 1 : 2;
}

__device__ __forceinline__ float w_minus(int i, int lo, int hi) {
  return i == lo ? 0.f : (i == hi ? 2.f : 1.f);   // weight of the i-1 read
}

__device__ __forceinline__ float w_plus(int i, int lo, int hi) {
  return i == lo ? 2.f : (i == hi ? 0.f : 1.f);   // weight of the i+1 read
}

__global__ void __launch_bounds__(kPlaneBlock) bwd_plane_local_kernel(const BwdArgs a) {
  const int p = blockIdx.y;
  const long long uv = (long long)a.Umax * a.Vmax;
  const long long e = (long long)blockIdx.x * kPlaneBlock + threadIdx.x;
  if (e >= uv) return;
  const int u = (int)(e / a.Vmax), v = (int)(e % a.Vmax);
  const long long stack = 6 * uv;
  const long long idx = p * uv + e;
  const int ax = p >> 1, side = p & 1;
  int a1, a2;
  other_axes(ax, &a1, &a2);
  const int U = a.dims[a1], V = a.dims[a2];
  if (u >= U || v >= V) {
    // padding: stream what enters, leave zeros behind
    a.gp_row[idx] = 0.f;
    for (int j = 0; j < a.order; ++j) {
      a.gstin_row[j * stack + idx] = a.gst[j * stack + idx];
      a.gst[j * stack + idx] = 0.f;
    }
    a.D[idx] = 0.f;
    a.gin[idx] = 0.f;
    a.gprv[idx] = 0.f;
    return;
  }
  int g[3];
  g[ax] = side == 0 ? a.blo[ax] : a.bhi[ax];
  g[a1] = u;
  g[a2] = v;

  // gpplus from the raw P under the splice precedence y < z < x
  const bool on_x = g[0] == a.blo[0] || g[0] == a.bhi[0];
  const bool on_z = g[2] == a.blo[2] || g[2] == a.bhi[2];
  const bool killed = (ax == 1 && (on_x || on_z)) || (ax == 2 && on_x);
  const float gp =
      killed ? 0.f
             : a.P[((long long)g[0] * a.dims[1] + g[1]) * a.dims[2] + g[2]];
  a.gp_row[idx] = gp;

  const int nc = a.order + 1;
  const float b0 = a.fb[p * nc], a0 = a.fa[p * nc];
  // stream gst' as it enters, shift it up a slot, and take its two sums
  float sum_a = 0.f, sum_b = 0.f;
  for (int j = a.order - 1; j >= 0; --j) {
    const float gs = a.gst[j * stack + idx];
    a.gstin_row[j * stack + idx] = gs;
    sum_a += a.fa[p * nc + j + 1] * gs;
    sum_b += a.fb[p * nc + j + 1] * gs;
    if (j + 1 < a.order) a.gst[(j + 1) * stack + idx] = gs;
  }
  const float gout = -sum_a;
  const float gfilt = sum_b + gout * b0 / a0;
  const float gdelta = -(gfilt * a0) / (b0 * a.courant);

  float cw = a0 / b0;
  for (int ei = 0; ei < 2; ++ei) {
    const int ea = ei == 0 ? a1 : a2;
    for (int s2 = 0; s2 < 2; ++s2) {
      if (g[ea] != (s2 == 0 ? a.blo[ea] : a.bhi[ea])) continue;
      const int q = 2 * ea + s2;
      cw += a.fa[q * nc] / a.fb[q * nc];
    }
  }
  cw = a.courant * cw;
  const float act = (u >= a.blo[a1] && u <= a.bhi[a1] && v >= a.blo[a2] &&
                     v <= a.bhi[a2]) ? 1.f : 0.f;
  const float Dv = act * (gp - gdelta) / (1.f + cw);
  a.D[idx] = Dv;
  a.gin[idx] = 2.f * a.courant_sq * Dv;
  a.gprv[idx] = gdelta + (cw - 1.f) * Dv;
  a.gst[idx] = gout / a0 - gfilt / b0;   // slot 0; the coupling part follows
}

__global__ void __launch_bounds__(kPlaneBlock) bwd_plane_gather_kernel(const BwdArgs a) {
  const int p = blockIdx.y;
  const long long uv = (long long)a.Umax * a.Vmax;
  const long long e = (long long)blockIdx.x * kPlaneBlock + threadIdx.x;
  if (e >= uv) return;
  const int u = (int)(e / a.Vmax), v = (int)(e % a.Vmax);
  const long long idx = p * uv + e;
  const int ax = p >> 1, side = p & 1;
  int a1, a2;
  other_axes(ax, &a1, &a2);
  const int U = a.dims[a1], V = a.dims[a2];
  if (u >= U || v >= V) {
    a.gpl[idx] = 0.f;
    return;
  }
  const int stride = a.Vmax;
  // pl[e] was read by e+U with w_um[e+U], by e-U with w_up[e-U], and alike in v
  float s = 0.f;
  if (u + 1 < U) s += w_minus(u + 1, a.blo[a1], a.bhi[a1]) * a.D[idx + stride];
  if (u > 0) s += w_plus(u - 1, a.blo[a1], a.bhi[a1]) * a.D[idx - stride];
  if (v + 1 < V) s += w_minus(v + 1, a.blo[a2], a.bhi[a2]) * a.D[idx + 1];
  if (v > 0) s += w_plus(v - 1, a.blo[a2], a.bhi[a2]) * a.D[idx - 1];
  a.gpl[idx] = a.courant_sq * s;

  // edge coupling: every other plane q through this node read m0 here
  int g[3];
  g[ax] = side == 0 ? a.blo[ax] : a.bhi[ax];
  g[a1] = u;
  g[a2] = v;
  float d = a.D[idx];
  for (int ei = 0; ei < 2; ++ei) {
    const int ea = ei == 0 ? a1 : a2;
    int qa0, qa1;
    other_axes(ea, &qa0, &qa1);
    for (int s2 = 0; s2 < 2; ++s2) {
      if (g[ea] != (s2 == 0 ? a.blo[ea] : a.bhi[ea])) continue;
      const int q = 2 * ea + s2;
      d += a.D[q * uv + (long long)g[qa0] * a.Vmax + g[qa1]];
    }
  }
  a.gst[idx] += a.courant_sq * d / a.fb[p * (a.order + 1)];
}

__device__ __forceinline__ float masked_p(const BwdArgs& a, int x, int y, int z) {
  if (x < a.blo[0] + 1 || x > a.bhi[0] - 1 || y < a.blo[1] + 1 ||
      y > a.bhi[1] - 1 || z < a.blo[2] + 1 || z > a.bhi[2] - 1)
    return 0.f;   // outside the box (the box lies inside the grid)
  return a.P[((long long)x * a.dims[1] + y) * a.dims[2] + z];
}

__global__ void __launch_bounds__(kBlockZ * kBlockY) bwd_node_kernel(const BwdArgs a) {
  const int z = blockIdx.x * kBlockZ + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  const int x = blockIdx.z;
  const int Y = a.dims[1], Z = a.dims[2];
  if (z >= Z || y >= Y) return;
  const long long i = ((long long)x * Y + y) * Z + z;

  float acc = 0.f;
  acc += masked_p(a, x - 1, y, z);
  acc += masked_p(a, x + 1, y, z);
  acc += masked_p(a, x, y - 1, z);
  acc += masked_p(a, x, y + 1, z);
  acc += masked_p(a, x, y, z - 1);
  acc += masked_p(a, x, y, z + 1);
  float q = a.Q[i] + __fmul_rn(a.courant_sq, acc);
  float pn = -masked_p(a, x, y, z);

  const int g[3] = {x, y, z};
  const long long uv = (long long)a.Umax * a.Vmax;
  for (int p = 0; p < 6; ++p) {
    const int ax = p >> 1, side = p & 1;
    const int plane_c = side == 0 ? a.blo[ax] : a.bhi[ax];
    const int inner_c = side == 0 ? a.blo[ax] + 1 : a.bhi[ax] - 1;
    if (g[ax] != plane_c && g[ax] != inner_c) continue;
    int a1, a2;
    other_axes(ax, &a1, &a2);
    const long long e = p * uv + (long long)g[a1] * a.Vmax + g[a2];
    if (g[ax] == plane_c) {
      q += a.gpl[e];
      pn += a.gprv[e];
    }
    if (g[ax] == inner_c) q += a.gin[e];
  }
  a.Q[i] = q;
  a.Pnew[i] = pn;
}

__global__ void bwd_point_kernel(const BwdArgs a) {
  // one thread: taps first, then the signal cotangent reads Q[src] after
  // every add into it, then a hard source cuts the flow through the field
  for (int j = 0; j < a.k; ++j) a.Q[a.tap_idx[j]] += a.gtaps_row[j];
  float gs = 0.f;
  if (a.src >= 0 && a.mode > 0) {
    gs = a.Q[a.src];
    if (a.mode == 1) a.Q[a.src] = 0.f;
  }
  a.gsig[0] = gs;
}

}  // namespace

extern "C" {

// One chunk of K (even) reverse sub-steps:
//   gnext, gcur    (X, Y, Z) cotangents of the chunk's returned cur and prev;
//   spare          (X, Y, Z) the third rotating field.  On return the
//                  cotangents of the chunk's input cur and prev lie in
//                  buffers K mod 3 and (K + 1) mod 3 of (gnext, gcur, spare);
//   gst            (order, 6, Umax, Vmax) state cotangent, updated in place;
//   scratch        (4, 6, Umax, Vmax): D, gpl, gin, gprev;
//   gtaps          (K, k) tap cotangents; tap_idx (k,) flat node indices;
//   gsig           (K,) output: the signal cotangent, in forward time;
//   gp_stream      (K, 6, Umax, Vmax) output: gpplus per sub-step;
//   gstin_stream   (K, order, 6, Umax, Vmax) output: gst' as it enters;
//   fb, fa         (6, order + 1) per-face filter coefficients;
//   geom           X, Y, Z, ilo0, ihi0, ilo1, ihi1, ilo2, ihi2, Umax, Vmax,
//                  order, K;
//   src, mode      source node (flat, or -1) and injection mode.
// Launches 4K kernels on `stream`, does not synchronise, allocates nothing.
// Returns the first CUDA error code (0 on success).
int wv_box_mega_chunk_bwd_f32(float* gnext, float* gcur, float* spare,
                              float* gst, float* scratch, const float* gtaps,
                              const long long* tap_idx, int k, float* gsig,
                              float* gp_stream, float* gstin_stream,
                              const float* fb, const float* fa,
                              const int* geom, long long src, int mode,
                              float courant, float courant_sq,
                              void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int X = geom[0], Y = geom[1], Z = geom[2];
  const int Umax = geom[9], Vmax = geom[10], order = geom[11], K = geom[12];
  if (K % 2 != 0 || order < 1 || k < 1) return cudaErrorInvalidValue;
  const long long uv = (long long)Umax * Vmax;
  const long long stack = 6 * uv;

  BwdArgs a;
  a.gst = gst;
  a.D = scratch;
  a.gpl = scratch + stack;
  a.gin = scratch + 2 * stack;
  a.gprv = scratch + 3 * stack;
  a.fb = fb;
  a.fa = fa;
  a.tap_idx = tap_idx;
  a.src = src;
  a.k = k;
  a.mode = mode;
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

  float* P = gnext;
  float* Q = gcur;
  float* S = spare;
  const dim3 pgrid((unsigned)((uv + kPlaneBlock - 1) / kPlaneBlock), 6, 1);
  const dim3 nblock(kBlockZ, kBlockY, 1);
  const dim3 ngrid((Z + kBlockZ - 1) / kBlockZ, (Y + kBlockY - 1) / kBlockY, X);
  cudaError_t err;
  for (int t = K - 1; t >= 0; --t) {
    a.P = P;
    a.Q = Q;
    a.Pnew = S;
    a.gp_row = gp_stream + (long long)t * stack;
    a.gstin_row = gstin_stream + (long long)t * order * stack;
    a.gtaps_row = gtaps + (long long)t * k;
    a.gsig = gsig + t;
    bwd_plane_local_kernel<<<pgrid, kPlaneBlock, 0, stream>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    bwd_plane_gather_kernel<<<pgrid, kPlaneBlock, 0, stream>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    bwd_node_kernel<<<ngrid, nblock, 0, stream>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    bwd_point_kernel<<<1, 1, 0, stream>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    // (P, Q, spare) <- (Q, spare, P)
    float* old_p = P;
    P = Q;
    Q = S;
    S = old_p;
  }
  return static_cast<int>(cudaGetLastError());
}

const char* wv_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
