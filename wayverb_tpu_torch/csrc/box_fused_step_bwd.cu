// Adjoint of the fused shoebox waveguide step, CUDA C++ for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_bwd_kernel` of
// wayverb_tpu/waveguide/box_fused.py.  It computes what the port's plain
// version `_fused_step_bwd_plain` (wayverb_tpu_torch/waveguide/box_fused.py)
// computes.  The step is linear in (cur, prev, planes, halos); with g the
// cotangent of `next`, ginner the six inner-plane cotangents and M the
// inside mask of the box:
//
//   Gtot = g + the inner-plane cotangents placed at the inner coordinates;
//   G    = M * Gtot;
//   gcur = lambda^2 * sum of G over the six face neighbours;
//   gprev = -G;
//   plane cotangents: Gtot (unmasked) at the plane's coordinate, zero where
//     a later splice of the forward step overwrites the plane (an x plane
//     beats a z plane beats a y plane), and zero for an x plane whose row
//     lies outside this shard;
//   halo cotangents: lambda^2 * G at the first and the last local row;
//   a hard-set (mode 1) source node gets gcur = gprev = 0.
//
// Gather form: the thread of node n rebuilds G at n and at its six
// neighbours from g and the inner-plane cotangents (a mask and at most
// three adds each), so there are no atomics and no second pass, and every
// output element has exactly one writer: each plane element belongs to one
// node of the grid, each halo element to one node of the first or last row.
// The TPU kernel's slab window, its staging of G and its masked row sums
// (one-hot selections, not reductions) are not carried over.
//
// What bounds it on the card: device memory, 12 B/node in float32 (g read,
// gcur and gprev written); the neighbour reads of g are served mostly from
// L1/L2.  Nodes deep inside the box (nearly all of them) take a short path
// with no plane logic, which gives the same bits.  The sums keep the plain version's order (x-, x+, y-, y+, z-, z+)
// and the file compiles with --fmad=false.

#include <cuda_runtime.h>

namespace {

constexpr int kBlockZ = 128;  // threads along z (contiguous axis)
constexpr int kBlockY = 2;    // threads along y

struct BwdArgs {
  const float* g;         // (X, Y, Z) cotangent of next
  const float* gin[6];    // inner-plane cotangents, contiguous natural shapes
  float* gcur;            // (X, Y, Z)
  float* gprev;           // (X, Y, Z)
  float* gpl[6];          // plane cotangents: (Y, Z) x2, (X, Z) x2, (X, Y) x2
  float* ghlo;            // (Y, Z) cotangent of the halo row at local x = -1
  float* ghhi;            // (Y, Z) cotangent of the halo row at local x = X
  long long src;          // local flat index of a hard-set source, or -1
  int X, Y, Z;
  int x_off;              // global x of local row 0
  int ilo0, ihi0, ilo1, ihi1, ilo2, ihi2;  // first/last inside node per axis
};

// Unmasked G at a node of the grid.
__device__ __forceinline__ float g_total(const BwdArgs& a, int x, int y, int z) {
  const int gx = a.x_off + x;
  float G = a.g[((long long)x * a.Y + y) * a.Z + z];
  if (gx == a.ilo0) G += a.gin[0][(long long)y * a.Z + z];
  if (gx == a.ihi0) G += a.gin[1][(long long)y * a.Z + z];
  if (y == a.ilo1) G += a.gin[2][(long long)x * a.Z + z];
  if (y == a.ihi1) G += a.gin[3][(long long)x * a.Z + z];
  if (z == a.ilo2) G += a.gin[4][(long long)x * a.Y + y];
  if (z == a.ihi2) G += a.gin[5][(long long)x * a.Y + y];
  return G;
}

__device__ __forceinline__ bool inside_box(const BwdArgs& a, int x, int y, int z) {
  const int gx = a.x_off + x;
  return gx >= a.ilo0 && gx <= a.ihi0 && y >= a.ilo1 && y <= a.ihi1 &&
         z >= a.ilo2 && z <= a.ihi2;
}

// Masked G; zero off the grid and outside the box.
__device__ __forceinline__ float g_masked(const BwdArgs& a, int x, int y, int z) {
  if (x < 0 || x >= a.X || y < 0 || y >= a.Y || z < 0 || z >= a.Z) return 0.f;
  return inside_box(a, x, y, z) ? g_total(a, x, y, z) : 0.f;
}

__global__ void __launch_bounds__(kBlockZ * kBlockY)
box_fused_step_bwd_kernel(const BwdArgs a) {
  const int z = blockIdx.x * kBlockZ + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  const int x = blockIdx.z;
  if (z >= a.Z || y >= a.Y) return;
  const long long yz = (long long)y * a.Z + z;
  const long long i = (long long)x * a.Y * a.Z + yz;
  const int gx = a.x_off + x;

  // two or more nodes inside every wall (and inside the shard): the node and
  // its six neighbours are inside the box and on no inner plane, so G is g
  // there, and the node owns no plane or halo element
  if (gx >= a.ilo0 + 2 && gx <= a.ihi0 - 2 && y >= a.ilo1 + 2 &&
      y <= a.ihi1 - 2 && z >= a.ilo2 + 2 && z <= a.ihi2 - 2 && x > 0 &&
      x < a.X - 1) {
    const long long yz_size = (long long)a.Y * a.Z;
    float acc = 0.f;
    acc += a.g[i - yz_size];
    acc += a.g[i + yz_size];
    acc += a.g[i - a.Z];
    acc += a.g[i + a.Z];
    acc += a.g[i - 1];
    acc += a.g[i + 1];
    const bool cut = i == a.src;
    a.gcur[i] = cut ? 0.f : __fmul_rn(1.0f / 3.0f, acc);
    a.gprev[i] = cut ? 0.f : -a.g[i];
    return;
  }

  const float Gt = g_total(a, x, y, z);
  const float Gm = inside_box(a, x, y, z) ? Gt : 0.f;

  float acc = 0.f;
  acc += g_masked(a, x - 1, y, z);
  acc += g_masked(a, x + 1, y, z);
  acc += g_masked(a, x, y - 1, z);
  acc += g_masked(a, x, y + 1, z);
  acc += g_masked(a, x, y, z - 1);
  acc += g_masked(a, x, y, z + 1);
  float gcur = __fmul_rn(1.0f / 3.0f, acc);
  float gprev = -Gm;
  if (i == a.src) {
    gcur = 0.f;
    gprev = 0.f;
  }
  a.gcur[i] = gcur;
  a.gprev[i] = gprev;

  // boundary-plane cotangents under the forward's splice order y < z < x
  const int blo0 = a.ilo0 - 1, bhi0 = a.ihi0 + 1;
  const int blo1 = a.ilo1 - 1, bhi1 = a.ihi1 + 1;
  const int blo2 = a.ilo2 - 1, bhi2 = a.ihi2 + 1;
  const bool on_x = gx == blo0 || gx == bhi0;
  const bool on_z = z == blo2 || z == bhi2;
  if (gx == blo0) a.gpl[0][yz] = Gt;
  if (gx == bhi0) a.gpl[1][yz] = Gt;
  if (y == blo1) a.gpl[2][(long long)x * a.Z + z] = (on_x || on_z) ? 0.f : Gt;
  if (y == bhi1) a.gpl[3][(long long)x * a.Z + z] = (on_x || on_z) ? 0.f : Gt;
  if (z == blo2) a.gpl[4][(long long)x * a.Y + y] = on_x ? 0.f : Gt;
  if (z == bhi2) a.gpl[5][(long long)x * a.Y + y] = on_x ? 0.f : Gt;

  if (x == 0) {
    // an x plane outside this shard has no owner row: emit zeros
    const int lo = blo0 - a.x_off, hi = bhi0 - a.x_off;
    if (lo < 0 || lo >= a.X) a.gpl[0][yz] = 0.f;
    if (hi < 0 || hi >= a.X) a.gpl[1][yz] = 0.f;
    a.ghlo[yz] = __fmul_rn(1.0f / 3.0f, Gm);
  }
  if (x == a.X - 1) a.ghhi[yz] = __fmul_rn(1.0f / 3.0f, Gm);
}

}  // namespace

extern "C" {

// shape_geom: X, Y, Z, x_off, ilo0, ihi0, ilo1, ihi1, ilo2, ihi2.
// ginner, gplanes: six device pointers each, contiguous in their natural
// shapes.  src: local flat index of a hard-set source node or -1.  Returns
// the CUDA error code of the launch (0 on success).  Launches on `stream`
// and does not synchronise; allocates nothing.
int wv_box_fused_step_bwd_f32(const float* g, const float* const* ginner,
                              float* gcur, float* gprev,
                              float* const* gplanes, float* ghlo, float* ghhi,
                              const int* shape_geom, long long src, int mode,
                              void* stream) {
  BwdArgs a;
  a.g = g;
  a.gcur = gcur;
  a.gprev = gprev;
  for (int p = 0; p < 6; ++p) {
    a.gin[p] = ginner[p];
    a.gpl[p] = gplanes[p];
  }
  a.ghlo = ghlo;
  a.ghhi = ghhi;
  a.src = mode == 1 ? src : -1;
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

  const dim3 block(kBlockZ, kBlockY, 1);
  const dim3 grid((a.Z + kBlockZ - 1) / kBlockZ, (a.Y + kBlockY - 1) / kBlockY,
                  a.X);
  box_fused_step_bwd_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

const char* wv_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
