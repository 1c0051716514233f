// Adjoint of the fused shoebox waveguide step, CUDA C++ for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_bwd_kernel` of
// wayverb_tpu/waveguide/box_fused.py.  It computes what the port's plain
// version `_fused_step_bwd_plain` (wayverb_tpu_torch/waveguide/box_fused.py)
// computes, to the bit.  The step is linear in (cur, prev, planes, halos);
// with g the cotangent of `next`, a_p the inner-plane cotangent p at a node
// on inner plane p (+0.f elsewhere) and the planes in the order x-lo, x-hi,
// y-lo, y-hi, z-lo, z-hi:
//
//   Gtot  = ((((((g + a0) + a1) + a2) + a3) + a4) + a5);
//   G     = inside the box ? Gtot : 0.f  (a select, never a mask product);
//   gcur  = lambda^2 * sum of G over the six face neighbours, from +0.f in
//           the order x-, x+, y-, y+, z-, z+, zero off the grid;
//   gprev = -G;
//   plane cotangents: Gtot at the plane's coordinate, zero where a later
//     splice of the forward step overwrites the plane (an x plane beats a z
//     plane beats a y plane), and zero for an x plane whose row lies
//     outside this shard;
//   halo cotangents: lambda^2 * G at the first and the last local row;
//   a hard-set (mode 1) source node gets gcur = gprev = 0.
//
// Where no plane matches, Gtot is g + 0.f: one add, which turns -0 into +0
// and leaves every other value alone.  A sum from +0.f is never -0, so the
// neighbour sums may add g where G is g + 0.f and give the same bits.
//
// What bounds it on the card: device memory, 12 B a node in float32 (g read,
// gcur and gprev written): 46.94 us at 224 x 224 x 256 at 3.35 TB/s.  The
// walk below with every warp bare and no y or z neighbour loads (a stream
// of one read and two writes a node) takes 65 us there: that is its floor.
//
// Layout, as the general mesh's adjoint (mesh_adjoint.cuh): a thread owns
// one node p = y * Z + z of the flattened (y, z) plane and walks kWalk
// consecutive x rows of it, keeping Gtot at x - 1, x and x + 1 in
// registers, so that a row loads g at x + 1 and at the four y and z
// neighbours, and builds each Gtot once for three rows.  A warp is 32
// consecutive nodes of one row.  Each warp takes one of four paths in each
// row, chosen by tests that are uniform across it:
//   - bare: all 32 nodes two or more inside every wall in y and z, the row
//     two or more inside in x and not row 0 or X - 1 of the shard, and the
//     warp not holding the hard source in this row.  The node and its six
//     neighbours are inside the box and on no inner plane: Gtot = g + 0.f,
//     gcur = lambda^2 * the sum of the six g, gprev = -Gtot, no plane
//     logic.  At the hall 69.7 % of the (warp, row) pairs;
//   - z only: y and x as for bare, but the warp's z range reaches an inner
//     z plane or beyond.  The x and y tests and a0-a3 drop out; each Gtot
//     takes a4 and a5 at its own (x, y), each G the z inside test, and the
//     node writes only the z-plane cotangents.  23.2 % at the hall;
//   - x only: a warp that would be bare, in a row that is not (near the x
//     walls, or row 0 or X - 1 of the shard).  Only the inner x planes can
//     match and every test is the row's: the x inside tests, the x-plane
//     cotangents, the halo rows and the x-plane zero emission.  2.6 %;
//   - general: everything else (the rows and columns near the y walls, the
//     z-only warps of the rows near the x walls, the source's warp): the
//     whole definition above, with the grid tests.  4.4 % at the hall.
// Each path builds the Gtot at x + 1 that the next row, whatever its path,
// reads from its registers: each rule is applied only where its assumptions
// hold, so the rolling values are exact.  A walk whose rows are all bare,
// or all z only, builds the Gtot of its kWalk + 2 rows first, so that all
// its streamed loads are in flight at once; the other walks go row by row
// in a loop that is not unrolled (unrolled, the four paths spill).
//
// The launch, measured on an H100 80GB HBM3 at 700 W (PERF.md §6), at the
// hall and at the sharded hall's (56, 224, 256) shard: walks of 2 rows in
// CTAs of 128, 16 an SM, 70.8 / 22.9 us; in CTAs of 256 71.7 / 23.2, of
// 512 77.7 / 24.7; walks of 1, 3, 4 and 8 slower (91.9 / 27.0 to 89.4 /
// 35.7), the longer ones spilling.  Warps packed so that the nodes near
// the z walls share their own warps (90 % bare) ran 81-125 us at the hall:
// their loads start off a 128 B line and the rim's scatter 16 B pieces.
//
// Hazards, and what the design does about each:
//   - Bit-equality.  Every product and sum rounds on its own (__fmul_rn,
//     __fadd_rn, and the file builds with --fmad=false) in the plain
//     version's order.  Signed zeros: Gtot takes every add of the plain
//     version that can change its bits (g + 0.f at least), so g = -0 gives
//     G = +0 and gprev = -0, as the plain version's six adds do.
//   - Indices are 32-bit: the wrapper refuses fields of 2^31 nodes or more.
//   - Aliasing: g, gcur and gprev are __restrict__ and the wrapper
//     allocates every output, so the loads of a row may be issued before
//     its stores.
//   - Each output element has one writer: each plane element belongs to
//     one node of the grid (an x plane outside the shard to row 0), each
//     halo element to one node of the first or last row.  Lanes past the
//     end of the (y, z) plane vote, then return.
//   - Registers: 32 a thread at 2,048 threads an SM (the launch bounds),
//     0 B local; the occupancy test holds it.  Walks of 3 or more, and of
//     2 without the x-only path, spilled 8-24 B at this bound.

#include <cuda_runtime.h>

#include "mesh_adjoint.cuh"

namespace {

constexpr int kThreads = 128;  // nodes of the (y, z) plane a CTA
constexpr int kWalk = 2;       // x rows a thread walks
constexpr int kCtasPerSm = 16;  // 2,048 threads an SM: <= 32 registers

enum Path { kBare, kZOnly, kXOnly, kGeneral };

struct BwdArgs {
  const float* gin[6];  // inner-plane cotangents, contiguous natural shapes
  float* gpl[6];        // plane cotangents: (Y, Z) x2, (X, Z) x2, (X, Y) x2
  float* ghlo;          // (Y, Z) cotangent of the halo row at local x = -1
  float* ghhi;          // (Y, Z) cotangent of the halo row at local x = X
  int X, Y, Z, YZ;
  int x_off;            // global x of local row 0
  int ilo0, ihi0, ilo1, ihi1, ilo2, ihi2;  // first/last inside node per axis
  int src_x, src_p;     // row and (y, z) node of a hard-set source, or -1
  wv::FastDiv fz;       // division by Z
};

__device__ __forceinline__ bool inside_box(const BwdArgs& a, int gx, int y,
                                           int z) {
  return gx >= a.ilo0 && gx <= a.ihi0 && y >= a.ilo1 && y <= a.ihi1 &&
         z >= a.ilo2 && z <= a.ihi2;
}

// Unmasked Gtot at the grid node (x, y, z) of flat index j, by the rule of
// kPath: bare where the node lies on no inner plane, z only where it lies
// on no inner x or y plane, general anywhere.
template <int kPath>
__device__ __forceinline__ float gtot(const BwdArgs& a,
                                      const float* __restrict__ g, int x,
                                      int y, int z, int j) {
  if (kPath != kGeneral) {
    float t = __fadd_rn(g[j], 0.f);
    // after g + 0.f the sum is never -0, so an add of +0.f changes nothing
    if (kPath == kZOnly && z == a.ilo2)
      t = __fadd_rn(t, a.gin[4][x * a.Y + y]);
    if (kPath == kZOnly && z == a.ihi2)
      t = __fadd_rn(t, a.gin[5][x * a.Y + y]);
    return t;
  }
  const int gx = a.x_off + x;
  float t = g[j];
  t = __fadd_rn(t, gx == a.ilo0 ? a.gin[0][y * a.Z + z] : 0.f);
  t = __fadd_rn(t, gx == a.ihi0 ? a.gin[1][y * a.Z + z] : 0.f);
  t = __fadd_rn(t, y == a.ilo1 ? a.gin[2][x * a.Z + z] : 0.f);
  t = __fadd_rn(t, y == a.ihi1 ? a.gin[3][x * a.Z + z] : 0.f);
  t = __fadd_rn(t, z == a.ilo2 ? a.gin[4][x * a.Y + y] : 0.f);
  t = __fadd_rn(t, z == a.ihi2 ? a.gin[5][x * a.Y + y] : 0.f);
  return t;
}

// Masked G at the neighbour (x, y, z) of flat index j by the general rule:
// zero off the grid and outside the box.
__device__ __forceinline__ float g_general(const BwdArgs& a,
                                           const float* __restrict__ g, int x,
                                           int y, int z, int j) {
  if (x < 0 || x >= a.X || y < 0 || y >= a.Y || z < 0 || z >= a.Z) return 0.f;
  return inside_box(a, a.x_off + x, y, z) ? gtot<kGeneral>(a, g, x, y, z, j)
                                          : 0.f;
}

// Row x of a bare warp, from Gtot at x - 1, x and x + 1.  The neighbour
// sum adds g where G is g + 0.f: the same bits, as the sum is never -0.
__device__ __forceinline__ void bare_row(const BwdArgs& a,
                                         const float* __restrict__ g,
                                         float* __restrict__ gcur,
                                         float* __restrict__ gprev, int i,
                                         float gm, float g0, float gp) {
  float acc = 0.f;
  acc = __fadd_rn(acc, gm);
  acc = __fadd_rn(acc, gp);
  acc = __fadd_rn(acc, g[i - a.Z]);
  acc = __fadd_rn(acc, g[i + a.Z]);
  acc = __fadd_rn(acc, g[i - 1]);
  acc = __fadd_rn(acc, g[i + 1]);
  gcur[i] = __fmul_rn(1.0f / 3.0f, acc);
  gprev[i] = -g0;
}

// Row x of a z-only warp, from Gtot at x - 1, x and x + 1.
__device__ __forceinline__ void z_only_row(const BwdArgs& a,
                                           const float* __restrict__ g,
                                           float* __restrict__ gcur,
                                           float* __restrict__ gprev, int x,
                                           int y, int z, int i, float gm,
                                           float g0, float gp) {
  const bool zin = z >= a.ilo2 && z <= a.ihi2;
  const bool zm = z > 0 && z - 1 >= a.ilo2 && z - 1 <= a.ihi2;
  const bool zp = z < a.Z - 1 && z + 1 >= a.ilo2 && z + 1 <= a.ihi2;
  const float gym = zin ? gtot<kZOnly>(a, g, x, y - 1, z, i - a.Z) : 0.f;
  const float gyp = zin ? gtot<kZOnly>(a, g, x, y + 1, z, i + a.Z) : 0.f;
  const float gzm = zm ? gtot<kZOnly>(a, g, x, y, z - 1, i - 1) : 0.f;
  const float gzp = zp ? gtot<kZOnly>(a, g, x, y, z + 1, i + 1) : 0.f;
  float acc = 0.f;
  acc = __fadd_rn(acc, zin ? gm : 0.f);
  acc = __fadd_rn(acc, zin ? gp : 0.f);
  acc = __fadd_rn(acc, gym);
  acc = __fadd_rn(acc, gyp);
  acc = __fadd_rn(acc, gzm);
  acc = __fadd_rn(acc, gzp);
  gcur[i] = __fmul_rn(1.0f / 3.0f, acc);
  gprev[i] = -(zin ? g0 : 0.f);
  // x and y lie strictly inside, so neither an x splice kills these
  if (z == a.ilo2 - 1) a.gpl[4][x * a.Y + y] = g0;
  if (z == a.ihi2 + 1) a.gpl[5][x * a.Y + y] = g0;
}

// A walk whose rows all take path kPath (bare or z only): Gtot at its
// kWalk + 2 rows first, so that every streamed load of the walk is in
// flight at once, then the rows.
template <int kPath>
__device__ __forceinline__ void whole_walk(const BwdArgs& a,
                                           const float* __restrict__ g,
                                           float* __restrict__ gcur,
                                           float* __restrict__ gprev, int x0,
                                           int y, int z, int i) {
  float gt[kWalk + 2];  // Gtot at rows x0 - 1 ... x0 + kWalk
#pragma unroll
  for (int t = 0; t < kWalk + 2; ++t)
    gt[t] = gtot<kPath>(a, g, x0 + t - 1, y, z, i + (t - 1) * a.YZ);
#pragma unroll
  for (int t = 0; t < kWalk; ++t) {
    const int j = i + t * a.YZ;
    if (kPath == kBare)
      bare_row(a, g, gcur, gprev, j, gt[t], gt[t + 1], gt[t + 2]);
    else
      z_only_row(a, g, gcur, gprev, x0 + t, y, z, j, gt[t], gt[t + 1],
                 gt[t + 2]);
  }
}

// Gtot at node p of the row at global x gx whose (y, z) lies two or more
// inside the y and z walls: only the inner x planes can match, and their
// tests are the row's, uniform across the warp.
__device__ __forceinline__ float gtot_x(const BwdArgs& a,
                                        const float* __restrict__ g, int gx,
                                        int p, int j) {
  float t = g[j];
  t = __fadd_rn(t, gx == a.ilo0 ? a.gin[0][p] : 0.f);
  t = __fadd_rn(t, gx == a.ihi0 ? a.gin[1][p] : 0.f);
  return __fadd_rn(t, 0.f);
}

// Row x, not two inside the x walls (or row 0 or X - 1), of a warp whose
// nodes all lie two or more inside the y and z walls: returns Gtot at
// x + 1 (0.f past the last row).
__device__ __forceinline__ float x_only_row(const BwdArgs& a,
                                            const float* __restrict__ g,
                                            float* __restrict__ gcur,
                                            float* __restrict__ gprev, int x,
                                            int p, int i, float gm,
                                            float g0) {
  const int gx = a.x_off + x;
  const bool in_m = x > 0 && gx - 1 >= a.ilo0 && gx - 1 <= a.ihi0;
  const bool in_0 = gx >= a.ilo0 && gx <= a.ihi0;
  const bool in_p = x + 1 < a.X && gx + 1 >= a.ilo0 && gx + 1 <= a.ihi0;
  const float gp = x + 1 < a.X ? gtot_x(a, g, gx + 1, p, i + a.YZ) : 0.f;
  float acc = 0.f;
  acc = __fadd_rn(acc, in_m ? gm : 0.f);
  acc = __fadd_rn(acc, in_p ? gp : 0.f);
  if (in_0) {  // else the four terms are +0.f, which change no sum
    acc = __fadd_rn(acc, gtot_x(a, g, gx, p - a.Z, i - a.Z));
    acc = __fadd_rn(acc, gtot_x(a, g, gx, p + a.Z, i + a.Z));
    acc = __fadd_rn(acc, gtot_x(a, g, gx, p - 1, i - 1));
    acc = __fadd_rn(acc, gtot_x(a, g, gx, p + 1, i + 1));
  }
  const float G = in_0 ? g0 : 0.f;
  gcur[i] = __fmul_rn(1.0f / 3.0f, acc);
  gprev[i] = -G;
  if (gx == a.ilo0 - 1) a.gpl[0][p] = g0;
  if (gx == a.ihi0 + 1) a.gpl[1][p] = g0;
  if (x == 0) {
    const int lo = a.ilo0 - 1 - a.x_off, hi = a.ihi0 + 1 - a.x_off;
    if (lo < 0 || lo >= a.X) a.gpl[0][p] = 0.f;
    if (hi < 0 || hi >= a.X) a.gpl[1][p] = 0.f;
    a.ghlo[p] = __fmul_rn(1.0f / 3.0f, G);
  }
  if (x == a.X - 1) a.ghhi[p] = __fmul_rn(1.0f / 3.0f, G);
  return gp;
}

// Row x of a general warp: returns Gtot at x + 1 (0.f past the last row).
__device__ __forceinline__ float general_row(const BwdArgs& a,
                                             const float* __restrict__ g,
                                             float* __restrict__ gcur,
                                             float* __restrict__ gprev, int x,
                                             int y, int z, int p, int i,
                                             float gm, float g0) {
  const int gx = a.x_off + x;
  const float gp =
      x + 1 < a.X ? gtot<kGeneral>(a, g, x + 1, y, z, i + a.YZ) : 0.f;
  float acc = 0.f;
  acc = __fadd_rn(acc, x > 0 && inside_box(a, gx - 1, y, z) ? gm : 0.f);
  acc = __fadd_rn(acc, x + 1 < a.X && inside_box(a, gx + 1, y, z) ? gp : 0.f);
  acc = __fadd_rn(acc, g_general(a, g, x, y - 1, z, i - a.Z));
  acc = __fadd_rn(acc, g_general(a, g, x, y + 1, z, i + a.Z));
  acc = __fadd_rn(acc, g_general(a, g, x, y, z - 1, i - 1));
  acc = __fadd_rn(acc, g_general(a, g, x, y, z + 1, i + 1));
  const float G = inside_box(a, gx, y, z) ? g0 : 0.f;
  const bool cut = x == a.src_x && p == a.src_p;
  gcur[i] = cut ? 0.f : __fmul_rn(1.0f / 3.0f, acc);
  gprev[i] = cut ? 0.f : -G;

  // boundary-plane cotangents under the forward's splice order y < z < x
  const int blo0 = a.ilo0 - 1, bhi0 = a.ihi0 + 1;
  const bool on_x = gx == blo0 || gx == bhi0;
  const bool on_z = z == a.ilo2 - 1 || z == a.ihi2 + 1;
  if (gx == blo0) a.gpl[0][p] = g0;
  if (gx == bhi0) a.gpl[1][p] = g0;
  if (y == a.ilo1 - 1) a.gpl[2][x * a.Z + z] = on_x || on_z ? 0.f : g0;
  if (y == a.ihi1 + 1) a.gpl[3][x * a.Z + z] = on_x || on_z ? 0.f : g0;
  if (z == a.ilo2 - 1) a.gpl[4][x * a.Y + y] = on_x ? 0.f : g0;
  if (z == a.ihi2 + 1) a.gpl[5][x * a.Y + y] = on_x ? 0.f : g0;
  if (x == 0) {
    // an x plane outside this shard has no owner row: emit zeros
    const int lo = blo0 - a.x_off, hi = bhi0 - a.x_off;
    if (lo < 0 || lo >= a.X) a.gpl[0][p] = 0.f;
    if (hi < 0 || hi >= a.X) a.gpl[1][p] = 0.f;
    a.ghlo[p] = __fmul_rn(1.0f / 3.0f, G);
  }
  if (x == a.X - 1) a.ghhi[p] = __fmul_rn(1.0f / 3.0f, G);
  return gp;
}

__global__ void __launch_bounds__(kThreads, kCtasPerSm)
box_fused_step_bwd_kernel(const BwdArgs a, const float* __restrict__ g,
                          float* __restrict__ gcur,
                          float* __restrict__ gprev) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  const bool live = p < a.YZ;
  const int y = wv::fast_div(p, a.fz);
  const int z = p - y * a.Z;
  // the warp's class in (y, z), the same in every row it walks
  const bool y_in = live && y >= a.ilo1 + 2 && y <= a.ihi1 - 2;
  const bool z_in = z >= a.ilo2 + 2 && z <= a.ihi2 - 2;
  const int yz_path = __all_sync(0xffffffffu, y_in && z_in) ? kBare
                      : __all_sync(0xffffffffu, y_in)       ? kZOnly
                                                            : kGeneral;
  if (!live) return;
  const bool src_warp = (a.src_p >> 5) == (p >> 5);
  auto path_of = [&](int x) -> int {
    const int gx = a.x_off + x;
    if ((src_warp && x == a.src_x) || yz_path == kGeneral) return kGeneral;
    const bool row_in =
        gx >= a.ilo0 + 2 && gx <= a.ihi0 - 2 && x > 0 && x < a.X - 1;
    return row_in ? yz_path : yz_path == kBare ? kXOnly : kGeneral;
  };

  const int x0 = blockIdx.y * kWalk;
  int i = x0 * a.YZ + p;  // node (x, y, z)
  // a walk whose rows are all bare, or all z only (rows two inside the x
  // walls are contiguous, so its first and last rows decide)
  if (yz_path != kGeneral && x0 + kWalk <= a.X &&
      path_of(x0) == yz_path && path_of(x0 + kWalk - 1) == yz_path &&
      !(src_warp && a.src_x >= x0 && a.src_x < x0 + kWalk)) {
    if (yz_path == kBare)
      whole_walk<kBare>(a, g, gcur, gprev, x0, y, z, i);
    else
      whole_walk<kZOnly>(a, g, gcur, gprev, x0, y, z, i);
    return;
  }
  // Gtot at x0 - 1 and x0, by the first row's rule
  float gm, g0;
  const int first = path_of(x0);
  if (first == kBare) {
    gm = gtot<kBare>(a, g, x0 - 1, y, z, i - a.YZ);
    g0 = gtot<kBare>(a, g, x0, y, z, i);
  } else if (first == kZOnly) {
    gm = gtot<kZOnly>(a, g, x0 - 1, y, z, i - a.YZ);
    g0 = gtot<kZOnly>(a, g, x0, y, z, i);
  } else if (first == kXOnly) {
    gm = x0 > 0 ? gtot_x(a, g, a.x_off + x0 - 1, p, i - a.YZ) : 0.f;
    g0 = gtot_x(a, g, a.x_off + x0, p, i);
  } else {
    gm = x0 > 0 ? gtot<kGeneral>(a, g, x0 - 1, y, z, i - a.YZ) : 0.f;
    g0 = gtot<kGeneral>(a, g, x0, y, z, i);
  }
#pragma unroll 1
  for (int t = 0; t < kWalk; ++t) {
    const int x = x0 + t;
    if (x >= a.X) break;  // uniform across the CTA
    const int path = path_of(x);
    float gp;
    if (path == kBare) {
      gp = gtot<kBare>(a, g, x + 1, y, z, i + a.YZ);
      bare_row(a, g, gcur, gprev, i, gm, g0, gp);
    } else if (path == kZOnly) {
      gp = gtot<kZOnly>(a, g, x + 1, y, z, i + a.YZ);
      z_only_row(a, g, gcur, gprev, x, y, z, i, gm, g0, gp);
    } else if (path == kXOnly) {
      gp = x_only_row(a, g, gcur, gprev, x, p, i, gm, g0);
    } else {
      gp = general_row(a, g, gcur, gprev, x, y, z, p, i, gm, g0);
    }
    gm = g0;
    g0 = gp;
    i += a.YZ;
  }
}

dim3 launch_grid(int X, int Y, int Z) {
  return wv::adjoint_grid<kThreads, kWalk>(X, Y, Z);
}

}  // namespace

extern "C" {

// shape_geom: X, Y, Z, x_off, ilo0, ihi0, ilo1, ihi1, ilo2, ihi2, with
// X * Y * Z < 2^31.  ginner, gplanes: six device pointers each, contiguous
// in their natural shapes.  src: local flat index of a hard-set source node
// or -1.  Returns the CUDA error code of the launch (0 on success).
// Launches on `stream` and does not synchronise; allocates nothing.
int wv_box_fused_step_bwd_f32(const float* g, const float* const* ginner,
                              float* gcur, float* gprev,
                              float* const* gplanes, float* ghlo, float* ghhi,
                              const int* shape_geom, long long src, int mode,
                              void* stream) {
  BwdArgs a;
  for (int p = 0; p < 6; ++p) {
    a.gin[p] = ginner[p];
    a.gpl[p] = gplanes[p];
  }
  a.ghlo = ghlo;
  a.ghhi = ghhi;
  a.X = shape_geom[0];
  a.Y = shape_geom[1];
  a.Z = shape_geom[2];
  a.YZ = a.Y * a.Z;
  a.x_off = shape_geom[3];
  a.ilo0 = shape_geom[4];
  a.ihi0 = shape_geom[5];
  a.ilo1 = shape_geom[6];
  a.ihi1 = shape_geom[7];
  a.ilo2 = shape_geom[8];
  a.ihi2 = shape_geom[9];
  a.src_x = a.src_p = -1;
  if (mode == 1 && src >= 0) {
    a.src_x = static_cast<int>(src / a.YZ);
    a.src_p = static_cast<int>(src % a.YZ);
  }
  a.fz = wv::make_fast_div(a.Z);
  box_fused_step_bwd_kernel<<<launch_grid(a.X, a.Y, a.Z), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      a, g, gcur, gprev);
  return static_cast<int>(cudaGetLastError());
}

// What the card makes of the kernel on the current device, and its launch
// for a field of `dims` (X, Y, Z): out = registers a thread, local memory
// (spills) a thread in bytes, CTAs resident on one SM, threads a CTA, CTAs
// a launch.  Returns the CUDA error code.
int wv_box_fused_step_bwd_occupancy(const int* dims, int* out) {
  cudaFuncAttributes attrs;
  cudaError_t e = cudaFuncGetAttributes(&attrs, box_fused_step_bwd_kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = attrs.numRegs;
  out[1] = static_cast<int>(attrs.localSizeBytes);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[2], box_fused_step_bwd_kernel, kThreads, 0);
  out[3] = kThreads;
  const dim3 grid = launch_grid(dims[0], dims[1], dims[2]);
  out[4] = static_cast<int>(grid.x * grid.y * grid.z);
  return static_cast<int>(e);
}

const char* wv_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
