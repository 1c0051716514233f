// One node of the shoebox leapfrog step: stencil, splices and inner-plane
// extraction.  The fused step (box_fused_step.cu, kernel B1) and the mega
// chunk (box_mega_chunk.cu, kernels B2 and B6) each compute the stencil
// value their own way and call `stencil_finish`, so the splice precedence
// and the extraction are written once.
//
// For the node (x, y, z) (x local; global x = x_off + x):
//   1. the point-source injection (mode 0 none, 1 set, 2 add): the source
//      node's own cur read and every neighbour read that lands on it see the
//      injected value; its prev read sees v_prev (set) or prev + v_prev (add);
//   2. next = lambda^2 * sum of the six face neighbours of cur - prev inside
//      the box, 0 outside it.  Off-grid neighbours in y and z are 0; at local
//      x = -1 and x = X the halo rows hlo / hhi are read (null = zeros);
//   3. the six boundary-plane splices, resolved per node with the reference's
//      store order (an x plane beats a z plane beats a y plane beats the
//      interior value).  Splices write the whole plane row, unmasked by the
//      box extents: the plane arrays carry their own zeros;
//   4. the extraction of the six inner planes (first inside layer of each
//      wall, the next step's boundary inputs) from the spliced result.
//
// Every output element has exactly one writer.  B1's `next` overlaps no
// input (its wrapper refuses an `out` that does); B2 writes next over prev
// in place, each node's prev read and next write by one thread.
//
// The arithmetic keeps the plain version's order (neighbour sum x-, x+,
// y-, y+, z-, z+, then the halo; an explicitly rounded multiply so the
// compiler cannot contract it into an FMA), so kernel and plain agree to
// the bit.

#pragma once

#include <cuda_runtime.h>

namespace wv {

struct StencilArgs {
  const float* hlo;       // (Y, Z) halo row at local x = -1, or null
  const float* hhi;       // (Y, Z) halo row at local x = X, or null
  const float* plane[6];  // xlo, xhi (Y, Z); ylo, yhi (X, Z); zlo, zhi (X, Y)
  long long plane_stride[6];  // row stride of each plane, in elements
  float* inner[6];        // same shapes as the planes
  long long inner_stride[6];  // row stride of each inner plane, in elements
  const float* inj_val;   // (2,): v_now, v_prev; read only with a source
  int mode;               // 1 set, 2 add
  int X, Y, Z;
  int x_off;              // global x of local row 0
  int ilo0, ihi0, ilo1, ihi1, ilo2, ihi2;  // first/last inside node per axis
  int xin_lo, xin_hi;     // local rows of the two inner x planes (clamped)
};

// Element (u, v) of boundary plane p.  The plane is picked by selects: a
// dynamic index into the kernel's parameters could be copied to local
// memory.
__device__ __forceinline__ float stencil_plane_at(const StencilArgs& a, int p,
                                                  int u, int v) {
  const float* base = a.plane[5];
  long long stride = a.plane_stride[5];
  for (int q = 4; q >= 0; --q)
    if (p == q) {
      base = a.plane[q];
      stride = a.plane_stride[q];
    }
  return base[(long long)u * stride + v];
}

// The splice that lands on node (x, y, z): the boundary plane p it reads,
// at (*u, *v), or -1.  Precedence y < z < x: an x plane beats a z plane
// beats a y plane (the last test that matches wins).
__device__ __forceinline__ int stencil_splice(const StencilArgs& a, int x,
                                              int y, int z, int* u, int* v) {
  const int gx = a.x_off + x;
  int p = -1;
  if (y == a.ilo1 - 1) p = 2;
  if (y == a.ihi1 + 1) p = 3;
  if (z == a.ilo2 - 1) p = 4;
  if (z == a.ihi2 + 1) p = 5;
  if (gx == a.ilo0 - 1) p = 0;
  if (gx == a.ihi0 + 1) p = 1;
  *u = p < 2 ? y : x;
  *v = p < 4 ? z : y;
  return p;
}

// Steps 3 and 4 for the node (x, y, z) whose stencil value is `res`: the
// splice (plane_at(p, u, v) reads boundary plane p), the store to *next_i,
// and the extraction (inner_at(p, u, v) points at inner plane p's element).
// Only the geometry of `a` is read.  kZOnly: the caller knows the node lies
// strictly between the inner planes in x and y (the clamped inner x rows
// included), so only the z tests can match.
template <bool kZOnly = false, class PlaneAt, class InnerAt>
__device__ __forceinline__ void stencil_finish(const StencilArgs& a, int x,
                                               int y, int z, float res,
                                               float* next_i, PlaneAt plane_at,
                                               InnerAt inner_at) {
  int u, v;
  int p;
  if (kZOnly) {
    p = z == a.ilo2 - 1 ? 4 : (z == a.ihi2 + 1 ? 5 : -1);
    u = x;
    v = y;
  } else {
    p = stencil_splice(a, x, y, z, &u, &v);
  }
  if (p >= 0) res = plane_at(p, u, v);
  *next_i = res;

  if (!kZOnly) {
    if (x == a.xin_lo) *inner_at(0, y, z) = res;
    if (x == a.xin_hi) *inner_at(1, y, z) = res;
    if (y == a.ilo1) *inner_at(2, x, z) = res;
    if (y == a.ihi1) *inner_at(3, x, z) = res;
  }
  if (z == a.ilo2) *inner_at(4, x, y) = res;
  if (z == a.ihi2) *inner_at(5, x, y) = res;
}

// Fill X..ihi2 and the clamped inner x rows from (X, Y, Z, x_off, ilo0,
// ihi0, ilo1, ihi1, ilo2, ihi2).
inline void stencil_set_geometry(StencilArgs& a, const int* shape_geom) {
  a.X = shape_geom[0];
  a.Y = shape_geom[1];
  a.Z = shape_geom[2];
  a.x_off = shape_geom[3];
  a.ilo0 = shape_geom[4];
  a.ihi0 = shape_geom[5];
  a.ilo1 = shape_geom[6];
  a.ihi1 = shape_geom[7];
  a.ilo2 = shape_geom[8];
  a.ihi2 = shape_geom[9];
  auto clamp_row = [&](int r) { return r < 0 ? 0 : (r > a.X - 1 ? a.X - 1 : r); };
  a.xin_lo = clamp_row(a.ilo0 - a.x_off);
  a.xin_hi = clamp_row(a.ihi0 - a.x_off);
}

}  // namespace wv
