// Mega chunk of the shoebox waveguide: K leapfrog sub-steps in one call,
// CUDA C++ for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_MegaKernel.kernel` of
// wayverb_tpu/waveguide/box_mega.py, with grad=False and, when the caller
// passes a residual block, with grad=True.  It computes what the port's
// plain version `_mega_chunk_plain` (wayverb_tpu_torch/waveguide/
// box_mega.py) computes.  Each sub-step t, on the current field A and the
// previous field B:
//
//   plane kernel, one thread per (plane, u, v) of (6, Umax, Vmax):
//     - one thread injects the source into A (1 set, 2 add) and writes the
//       receiver taps of the post-injection field into row t of the (K, k)
//       tap block;
//     - the injection mirrored onto the carried inner planes (a source on
//       an inner plane): the owning thread substitutes the patched value;
//     - the six DF2T boundary-plane updates with edge/corner coupling
//       (reference program.cpp:331-388 + filters.cpp), new <- f(PL, INS,
//       PRVP, state);
//     - each plane's sum, for the non-finite count;
//     - in grad mode, the element's four residuals into row t of the
//       (K, 4, 6, Umax, Vmax) block: PL, INS after the injection patch, PRVP
//       and the OLD first state slot, exactly the values this update read
//       (the coefficient gradients are taken from them afterwards).  The
//       other outputs do not depend on the mode.
//   stencil kernel, one thread per node: B <- the masked 7-point stencil
//     of A minus B (in place over B), the splices of the new boundary
//     planes and the inner-plane extraction into INS (box_stencil.cuh, the
//     same code as the fused step B1); one thread adds the number of
//     planes whose sum was not finite to `bad` and clears the sums.
//
// Then A and B swap by pointer.  The TPU kernel keeps both fields resident
// in VMEM for the whole chunk; on the H100 2 x 49 MiB at 224 x 224 x 256
// does not fit the 50 MB L2, so each sub-step streams the field through
// device memory like the fused step, and the chunk saves the host's eager
// plane-step launches (about 240 a step) rather than field traffic.  What
// bounds a sub-step: the stencil kernel's 12 B/node of device traffic.
//
// Read-before-write hazards inside one launch are designed out:
//   - plane p's coupling reads its neighbours' OLD first state slot, which
//     other blocks of the same launch rewrite: the state ping-pongs (read
//     st_in, write st_out, swap by pointer);
//   - the in-plane shifts read PL while the new planes are written: three
//     plane buffers rotate by pointer (new is written into the spare, then
//     PRVP <- PL and PL <- new), nothing is written in place;
//   - the injection and the taps are done by one thread, and a tap at the
//     source node takes the injected value, so no read depends on the order
//     of writes by other threads.
// Padding of the stacked (Umax, Vmax) planes is written as zero, so a
// shifted read never picks up garbage.
//
// The file is compiled with --fmad=false: each product and sum rounds on
// its own, in the plain version's order, as torch's separate kernels do.

#include <cuda_runtime.h>

#include "box_stencil.cuh"

namespace {

constexpr int kPlaneBlock = 256;  // threads per plane-kernel block
constexpr int kBlockZ = 128;      // stencil threads along z (contiguous axis)
constexpr int kBlockY = 2;        // stencil threads along y

struct PlaneArgs {
  float* field;               // A: the current field; the injection lands here
  const float* sig;           // this sub-step's signal value (device)
  long long src;              // flat index of the source node, or -1
  int mode;                   // 1 set, 2 add
  const long long* tap_idx;   // (k,) flat node indices, in receiver read order
  int k;
  float* tap_row;             // (k,) row t of the tap block
  const float* pl;            // (6, Umax, Vmax) boundary planes of A
  const float* ins;           // (6, Umax, Vmax) first-inside planes of A
  const float* prvp;          // (6, Umax, Vmax) boundary planes of B
  float* out_p;               // (6, Umax, Vmax) new boundary planes
  float* res;                 // (4, 6, Umax, Vmax) residual row t, or null
  const float* st_in;         // (order, 6, Umax, Vmax) DF2T state
  float* st_out;
  const float* fb;            // (6, order + 1) per-face filter numerator
  const float* fa;            // (6, order + 1) denominator
  float* sums;                // (6,) per-plane sums of the new planes
  int dims[3];
  int blo[3], bhi[3];         // boundary-plane coordinates per axis
  int Umax, Vmax, order;
  int ins_u[6], ins_v[6];     // source on inner plane p at (u, v), or -1
  float courant, courant_sq;
};

__device__ __forceinline__ void other_axes(int a, int* a1, int* a2) {
  *a1 = a == 0 ? 1 : 0;
  *a2 = a == 2 ? 1 : 2;
}

// One plane element's boundary update; returns the new pressure (0 in the
// padding).  Arithmetic in the order of box_mega.plane_step_one.
__device__ float plane_update(const PlaneArgs& a, int p, int u, int v) {
  const long long uv = (long long)a.Umax * a.Vmax;
  const long long stack = 6 * uv;
  const long long idx = p * uv + (long long)u * a.Vmax + v;
  const int ax = p >> 1, side = p & 1;
  int a1, a2;
  other_axes(ax, &a1, &a2);
  const int U = a.dims[a1], V = a.dims[a2];
  if (u >= U || v >= V) {
    a.out_p[idx] = 0.f;
    for (int j = 0; j < a.order; ++j) a.st_out[j * stack + idx] = 0.f;
    if (a.res)
      for (int r = 0; r < 4; ++r) a.res[r * stack + idx] = 0.f;
    return 0.f;
  }
  const int stride = a.Vmax;
  const float s_um = u > 0 ? a.pl[idx - stride] : 0.f;
  const float s_up = u + 1 < U ? a.pl[idx + stride] : 0.f;
  const float s_vm = v > 0 ? a.pl[idx - 1] : 0.f;
  const float s_vp = v + 1 < V ? a.pl[idx + 1] : 0.f;
  const float w_um = u == a.blo[a1] ? 0.f : (u == a.bhi[a1] ? 2.f : 1.f);
  const float w_up = u == a.blo[a1] ? 2.f : (u == a.bhi[a1] ? 0.f : 1.f);
  const float w_vm = v == a.blo[a2] ? 0.f : (v == a.bhi[a2] ? 2.f : 1.f);
  const float w_vp = v == a.blo[a2] ? 2.f : (v == a.bhi[a2] ? 0.f : 1.f);

  float in = a.ins[idx];
  if (u == a.ins_u[p] && v == a.ins_v[p])
    in = a.mode == 1 ? a.sig[0] : in + a.sig[0];
  float csw = 2.f * in;
  csw = csw + w_um * s_um;
  csw = csw + w_up * s_up;
  csw = csw + w_vm * s_vm;
  csw = csw + w_vp * s_vp;
  csw = a.courant_sq * csw;

  const int nc = a.order + 1;
  const float b0 = a.fb[p * nc], a0 = a.fa[p * nc];
  const float m0 = a.st_in[idx];
  float fw = m0 / b0;
  float cw = a0 / b0;
  // edge/corner coupling: a node on this plane's in-plane box edge also
  // belongs to the neighbouring plane q; add q's OLD first state slot at
  // the same global point
  int g[3];
  g[ax] = side == 0 ? a.blo[ax] : a.bhi[ax];
  g[a1] = u;
  g[a2] = v;
  for (int ei = 0; ei < 2; ++ei) {
    const int e = ei == 0 ? a1 : a2;
    int qa0, qa1;
    other_axes(e, &qa0, &qa1);
    for (int s2 = 0; s2 < 2; ++s2) {
      if (g[e] != (s2 == 0 ? a.blo[e] : a.bhi[e])) continue;
      const int q = 2 * e + s2;
      const float line = a.st_in[q * uv + (long long)g[qa0] * a.Vmax + g[qa1]];
      const float b0q = a.fb[q * nc], a0q = a.fa[q * nc];
      fw = fw + line / b0q;
      cw = cw + a0q / b0q;
    }
  }
  cw = a.courant * cw;

  const float act = (u >= a.blo[a1] && u <= a.bhi[a1] && v >= a.blo[a2] &&
                     v <= a.bhi[a2]) ? 1.f : 0.f;
  const float prev = a.prvp[idx];
  if (a.res) {
    a.res[idx] = a.pl[idx];
    a.res[stack + idx] = in;
    a.res[2 * stack + idx] = prev;
    a.res[3 * stack + idx] = m0;
  }
  float x = csw + a.courant_sq * fw;
  x = x + (cw - 1.f) * prev;
  const float new_p = (act * x) / (1.f + cw);

  const float delta = prev - new_p;
  const float filt_in = -((a0 * delta) / (b0 * a.courant) + m0 / b0);
  const float out = (filt_in * b0 + m0) / a0;
  for (int j = 0; j < a.order; ++j) {
    const float nxt = j + 1 < a.order ? a.st_in[(j + 1) * stack + idx] : 0.f;
    a.st_out[j * stack + idx] =
        (nxt + a.fb[p * nc + j + 1] * filt_in) - a.fa[p * nc + j + 1] * out;
  }
  a.out_p[idx] = new_p;
  return new_p;
}

__global__ void __launch_bounds__(kPlaneBlock) mega_plane_kernel(const PlaneArgs a) {
  const int p = blockIdx.y;
  const long long uv = (long long)a.Umax * a.Vmax;
  const long long e = (long long)blockIdx.x * kPlaneBlock + threadIdx.x;

  if (p == 0 && e == 0) {
    // injection into the current field, then the post-injection taps; one
    // thread does both, and no other thread of this launch reads the field
    float inj = 0.f;
    if (a.src >= 0) {
      inj = a.mode == 1 ? a.sig[0] : a.field[a.src] + a.sig[0];
      a.field[a.src] = inj;
    }
    for (int j = 0; j < a.k; ++j) {
      const long long n = a.tap_idx[j];
      a.tap_row[j] = n == a.src ? inj : a.field[n];
    }
  }

  float val = 0.f;
  if (e < uv) val = plane_update(a, p, (int)(e / a.Vmax), (int)(e % a.Vmax));

  // the plane's sum: warp shuffle, then one atomic add per block
  for (int off = 16; off > 0; off >>= 1)
    val += __shfl_down_sync(0xffffffffu, val, off);
  __shared__ float warp_sums[kPlaneBlock / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = val;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int w = 0; w < kPlaneBlock / 32; ++w) s += warp_sums[w];
    atomicAdd(&a.sums[p], s);
  }
}

__global__ void __launch_bounds__(kBlockZ * kBlockY)
mega_stencil_kernel(const wv::StencilArgs a, float* sums, float* bad) {
  if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 &&
      threadIdx.x == 0 && threadIdx.y == 0) {
    // the plane kernel of this sub-step has finished: count the planes
    // whose sum is not finite, and clear the sums for the next sub-step
    float b = 0.f;
    for (int p = 0; p < 6; ++p) {
      if (!(fabsf(sums[p]) <= 3.402823466e38f)) b += 1.f;  // NaN or inf
      sums[p] = 0.f;
    }
    bad[0] += b;
  }
  const int z = blockIdx.x * kBlockZ + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  const int x = blockIdx.z;
  if (z >= a.Z || y >= a.Y) return;
  wv::stencil_node(a, x, y, z);
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
// Launches 2K kernels on `stream`, does not synchronise, allocates nothing.
// Returns the first CUDA error code (0 on success).
int wv_box_mega_chunk_f32(float* cur, float* prev, float* st, float* st_spare,
                          float* pln, float* pln_spare, const float* sig,
                          const long long* tap_idx, int k, float* taps,
                          float* bad, float* sums, float* res, const float* fb,
                          const float* fa, const int* geom, long long src,
                          int mode, const int* ins_uv, float courant,
                          float courant_sq, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int X = geom[0], Y = geom[1], Z = geom[2];
  const int Umax = geom[9], Vmax = geom[10], order = geom[11], K = geom[12];
  if (K % 2 != 0 || order < 1 || k < 1) return cudaErrorInvalidValue;
  const long long uv = (long long)Umax * Vmax;
  const long long stack = 6 * uv;

  PlaneArgs pa;
  pa.src = src;
  pa.mode = mode;
  pa.tap_idx = tap_idx;
  pa.k = k;
  pa.fb = fb;
  pa.fa = fa;
  pa.sums = sums;
  pa.dims[0] = X;
  pa.dims[1] = Y;
  pa.dims[2] = Z;
  for (int ax = 0; ax < 3; ++ax) {
    pa.blo[ax] = geom[3 + 2 * ax] - 1;
    pa.bhi[ax] = geom[4 + 2 * ax] + 1;
  }
  pa.Umax = Umax;
  pa.Vmax = Vmax;
  pa.order = order;
  for (int p = 0; p < 6; ++p) {
    pa.ins_u[p] = ins_uv[2 * p];
    pa.ins_v[p] = ins_uv[2 * p + 1];
  }
  pa.courant = courant;
  pa.courant_sq = courant_sq;

  wv::StencilArgs sa;
  const int shape_geom[10] = {X, Y, Z, 0, geom[3], geom[4],
                              geom[5], geom[6], geom[7], geom[8]};
  wv::stencil_set_geometry(sa, shape_geom);
  sa.hlo = nullptr;
  sa.hhi = nullptr;
  sa.inj_val = nullptr;
  sa.src = -1;   // the plane kernel already injected into the field
  sa.mode = 0;

  float* base_pl = pln;
  float* ins = pln + stack;
  float* base_prvp = pln + 2 * stack;
  float* PL = base_pl;
  float* PRVP = base_prvp;
  float* SP = pln_spare;
  float* st_in = st;
  float* st_out = st_spare;

  const dim3 pgrid((unsigned)((uv + kPlaneBlock - 1) / kPlaneBlock), 6, 1);
  const dim3 sblock(kBlockZ, kBlockY, 1);
  const dim3 sgrid((Z + kBlockZ - 1) / kBlockZ, (Y + kBlockY - 1) / kBlockY, X);
  cudaError_t err;
  for (int t = 0; t < K; ++t) {
    float* A = (t % 2 == 0) ? cur : prev;
    float* B = (t % 2 == 0) ? prev : cur;
    pa.field = A;
    pa.sig = sig + t;
    pa.tap_row = taps + (long long)t * k;
    pa.res = res ? res + (long long)t * 4 * stack : nullptr;
    pa.pl = PL;
    pa.ins = ins;
    pa.prvp = PRVP;
    pa.out_p = SP;
    pa.st_in = st_in;
    pa.st_out = st_out;
    mega_plane_kernel<<<pgrid, kPlaneBlock, 0, stream>>>(pa);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

    // PRVP <- PL, PL <- new; the state's new copy becomes current
    float* old_prvp = PRVP;
    PRVP = PL;
    PL = SP;
    SP = old_prvp;
    float* tmp = st_in;
    st_in = st_out;
    st_out = tmp;

    sa.cur = A;
    sa.prev = B;
    sa.next = B;
    for (int p = 0; p < 6; ++p) {
      sa.plane[p] = PL + p * uv;
      sa.plane_stride[p] = Vmax;
      sa.inner[p] = ins + p * uv;
      sa.inner_stride[p] = Vmax;
    }
    mega_stencil_kernel<<<sgrid, sblock, 0, stream>>>(sa, sums, bad);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }

  // K is even, so the fields and the state are back in cur/prev and st.
  // The plane roles rotate with period 3: move PL and PRVP back to their
  // slots of pln, first the one whose slot is the free buffer.
  const size_t bytes = stack * sizeof(float);
  if (PL != base_pl) {
    if (SP == base_pl) {
      err = cudaMemcpyAsync(base_pl, PL, bytes, cudaMemcpyDeviceToDevice, stream);
      if (err == cudaSuccess && PRVP != base_prvp)
        err = cudaMemcpyAsync(base_prvp, PRVP, bytes, cudaMemcpyDeviceToDevice,
                              stream);
    } else {
      err = cudaMemcpyAsync(base_prvp, PRVP, bytes, cudaMemcpyDeviceToDevice,
                            stream);
      if (err == cudaSuccess)
        err = cudaMemcpyAsync(base_pl, PL, bytes, cudaMemcpyDeviceToDevice,
                              stream);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* wv_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
