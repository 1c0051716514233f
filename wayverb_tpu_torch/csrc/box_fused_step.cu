// Fused shoebox waveguide step, CUDA C++ for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_fwd_kernel` of
// wayverb_tpu/waveguide/box_fused.py.  It computes exactly what that
// module's reference `_jnp_forward` computes, and what the port's plain
// version `_fused_step_plain` (wayverb_tpu_torch/waveguide/box_fused.py)
// computes, to the bit, for one leapfrog step of the shoebox field:
// injection, masked 7-point stencil, the six boundary-plane splices and the
// inner-plane extraction.  The splice precedence and the extraction are
// `wv::stencil_finish` (box_stencil.cuh), shared with the mega chunk
// (box_mega_chunk.cu).
//
// What bounds it on the card: device memory.  A step must read cur and prev
// and write next, 12 B a node in float32: at 224 x 224 x 256 about 154 MB,
// 46.8 us at the H100's 3.35 TB/s.  One thread a node, in CTAs of 128 (z,
// the contiguous axis) x 2 (y) that cover one x row each, streams the
// field: a warp's loads and stores coalesce, and the six neighbour reads of
// cur come mostly from L1 and L2.  With nothing but the bare leapfrog in
// every node this form runs at 61.7 us at the hall, and a copy (next = cur
// - prev) at 58.2 us; what cost the rest was the general node's
// instructions: seven source compares, the inside test, the halo tests,
// the plane pick and six extraction tests in every node.
//
// So each warp (32 nodes along z) takes one of three paths, chosen by tests
// that are uniform across it:
//   - bare: all 32 nodes strictly between the inner planes in x, y and z
//     (the clamped inner x rows included, so never in row 0 or X - 1, where
//     the halo rows are added), and not at or beside the source: the six
//     neighbours and prev are loaded, then one rounded multiply, one
//     subtract, one store.  At the hall 71 % of the warps;
//   - z only: strictly inside in x and y, away from the source, but the
//     warp's z reaches an inner z plane or beyond: the same sum with the z
//     neighbours zero off the grid, the inside test in z alone, and
//     `stencil_finish<true>` (the z splices and extractions only);
//   - general: everything else (the boundary rows in x and y, the rows of a
//     shard that take the halos, the source and its neighbours): the inside
//     test, the halo rows added last, and the full `stencil_finish`; only
//     the warps at or beside the source compare their reads with it.
//
// An x-march over (y, z) tiles, the rows of cur and prev fed to shared
// memory by a `cp.async` or tensor-copy ring, was built and measured first:
// it ran 152-261 us at the hall in every shape tried (tiles of 2-32 y by
// 32-256 z, rings of 4 and 6 rows, a producer warp), bit-equal but slower
// than this form, because every CTA walks its rows one barrier at a time
// (PERF.md §6 has the measurements, on an H100 80GB HBM3 at 700 W).
//
// Hazards, and what the design does about each:
//   - Bit-equality.  The neighbour sum runs x-, x+, y-, y+, z-, z+ from
//     0.f, then the halo row at local x = 0 or X - 1 last, as the plain
//     version adds `halos` after its six shifted sums.  A neighbour outside
//     the grid adds 0.f, the plain version's padding.  The multiply is
//     `__fmul_rn` and the file builds with --fmad=false, so nothing is
//     contracted; an overflow to inf (1e38 inputs) rounds as the plain
//     version's does.  Outside the box the result is a select of 0.f, never
//     a 0/1 mask product (0 * inf would be NaN, and nvcc may fold a mask
//     product into a select).
//   - Injection.  Only a general warp can read the source: its reads of cur
//     at the source see v_now (set) or cur + v_now (add), its prev read
//     there v_prev or prev + v_prev.  A source outside the shard (src = -1)
//     injects nothing.
//   - Shapes.  Y and Z need not be multiples of the block: threads off the
//     grid return.  Any X >= 1: the inner x rows clamp into the shard
//     (stencil_set_geometry).
//   - Aliasing.  next is `__restrict__`, so the loads of a path may all be
//     issued before its stores: the wrapper refuses an `out` that overlaps
//     any input.
//
// The file is compiled with --fmad=false: each product and sum rounds on
// its own, in the plain version's order, as torch's separate kernels do.

#include <cuda_runtime.h>

#include "box_stencil.cuh"

namespace {

constexpr int kBlockZ = 128;  // threads along z (contiguous axis)
constexpr int kBlockY = 2;    // threads along y
constexpr int kThreads = kBlockZ * kBlockY;
// 8 CTAs an SM, 2,048 threads, the most an SM holds: at most 32 registers
// a thread.  At 34 registers (6 CTAs an SM) the hall's step took 86 us
// against 72-75 at 32 (an H100 80GB HBM3 at 700 W).
constexpr int kMinCtas = 8;

struct StepArgs {
  wv::StencilArgs s;  // geometry, halos, planes, inner planes, injection
  int sx, sy, sz;     // the source node (local), or sx = -1
};

// The general node (x, y, z) at flat index i.  kSrc: the warp lies at or
// beside the source, so its reads of cur and prev there see the injection.
template <bool kSrc, class PlaneAt, class InnerAt>
__device__ __forceinline__ void general_node(
    const StepArgs& a, const float* __restrict__ cur,
    const float* __restrict__ prev, float* __restrict__ next, int x, int y,
    int z, long long i, long long yz, long long yz_size, int gx,
    PlaneAt plane_at, InnerAt inner_at) {
  const wv::StencilArgs& g = a.s;
  float v_now = 0.f, v_prev = 0.f;
  long long src = -1;
  if (kSrc) {
    v_now = g.inj_val[0];
    v_prev = g.inj_val[1];
    src = a.sx * yz_size + (long long)a.sy * g.Z + a.sz;
  }
  auto cur_at = [&](long long j) {
    const float c = cur[j];
    if (!kSrc || j != src) return c;
    return g.mode == 1 ? v_now : c + v_now;
  };
  const bool inside = gx >= g.ilo0 && gx <= g.ihi0 && y >= g.ilo1 &&
                      y <= g.ihi1 && z >= g.ilo2 && z <= g.ihi2;
  float res = 0.f;
  if (inside) {
    float acc = 0.f;
    acc += x > 0 ? cur_at(i - yz_size) : 0.f;
    acc += x < g.X - 1 ? cur_at(i + yz_size) : 0.f;
    acc += y > 0 ? cur_at(i - g.Z) : 0.f;
    acc += y < g.Y - 1 ? cur_at(i + g.Z) : 0.f;
    acc += z > 0 ? cur_at(i - 1) : 0.f;
    acc += z < g.Z - 1 ? cur_at(i + 1) : 0.f;
    if (x == 0 && g.hlo) acc += g.hlo[yz];
    if (x == g.X - 1 && g.hhi) acc += g.hhi[yz];
    float p = prev[i];
    if (kSrc && i == src) p = g.mode == 1 ? v_prev : p + v_prev;
    res = __fmul_rn(1.0f / 3.0f, acc) - p;
  }
  wv::stencil_finish(g, x, y, z, res, next + i, plane_at, inner_at);
}

__global__ void __launch_bounds__(kThreads, kMinCtas)
box_fused_step_kernel(const StepArgs a, const float* __restrict__ cur,
                      const float* __restrict__ prev,
                      float* __restrict__ next) {
  const wv::StencilArgs& g = a.s;
  const int z = blockIdx.x * kBlockZ + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  const int x = blockIdx.z;
  if (z >= g.Z || y >= g.Y) return;
  const int wz0 = z & ~31;  // the warp's first z
  const long long yz_size = (long long)g.Y * g.Z;
  const long long yz = (long long)y * g.Z + z;
  const long long i = x * yz_size + yz;
  const int gx = g.x_off + x;
  const bool near_src = a.sx >= 0 && abs(x - a.sx) <= 1 &&
                        abs(y - a.sy) <= 1 && a.sz >= wz0 - 1 &&
                        a.sz <= wz0 + 32;
  // the warp strictly inside in x and y, away from the source.  Rows 0
  // and X - 1, which take the halos, are inside the box only as clamped
  // inner x rows, so they never pass
  const bool xy_in = y > g.ilo1 && y < g.ihi1 && gx >= g.ilo0 &&
                     gx <= g.ihi0 && x != g.xin_lo && x != g.xin_hi &&
                     !near_src;
  auto plane_at = [&](int q, int u, int v) {
    return wv::stencil_plane_at(g, q, u, v);
  };
  auto inner_at = [&](int q, int u, int v) {
    return g.inner[q] + (long long)u * g.inner_stride[q] + v;
  };

  if (xy_in && wz0 > g.ilo2 && wz0 + 31 < g.ihi2) {
    float acc = 0.f;
    acc += cur[i - yz_size];
    acc += cur[i + yz_size];
    acc += cur[i - g.Z];
    acc += cur[i + g.Z];
    acc += cur[i - 1];
    acc += cur[i + 1];
    next[i] = __fmul_rn(1.0f / 3.0f, acc) - prev[i];
    return;
  }

  if (xy_in) {
    float acc = 0.f;
    acc += cur[i - yz_size];
    acc += cur[i + yz_size];
    acc += cur[i - g.Z];
    acc += cur[i + g.Z];
    acc += z > 0 ? cur[i - 1] : 0.f;
    acc += z < g.Z - 1 ? cur[i + 1] : 0.f;
    const float p = prev[i];
    const float res =
        z >= g.ilo2 && z <= g.ihi2 ? __fmul_rn(1.0f / 3.0f, acc) - p : 0.f;
    wv::stencil_finish<true>(g, x, y, z, res, next + i, plane_at, inner_at);
    return;
  }

  if (near_src)
    general_node<true>(a, cur, prev, next, x, y, z, i, yz, yz_size, gx,
                       plane_at, inner_at);
  else
    general_node<false>(a, cur, prev, next, x, y, z, i, yz, yz_size, gx,
                        plane_at, inner_at);
}

dim3 launch_grid(int X, int Y, int Z) {
  return dim3((Z + kBlockZ - 1) / kBlockZ, (Y + kBlockY - 1) / kBlockY, X);
}

}  // namespace

extern "C" {

// shape_geom: X, Y, Z, x_off, ilo0, ihi0, ilo1, ihi1, ilo2, ihi2.
// Returns the CUDA error code of the launch (0 on success).  Launches on
// `stream` and does not synchronise; allocates nothing.  `next` must not
// overlap any input.
int wv_box_fused_step_f32(const float* cur, const float* prev, float* next,
                          const float* hlo, const float* hhi,
                          const float* const* planes,
                          const long long* plane_strides,
                          float* const* inner, const int* shape_geom,
                          long long src, int mode, const float* inj_val,
                          void* stream) {
  StepArgs a;
  wv::StencilArgs& s = a.s;
  s.hlo = hlo;
  s.hhi = hhi;
  wv::stencil_set_geometry(s, shape_geom);
  // inner planes are contiguous in their natural shapes: (Y, Z) (X, Z) (X, Y)
  const long long inner_rows[6] = {s.Z, s.Z, s.Z, s.Z, s.Y, s.Y};
  for (int p = 0; p < 6; ++p) {
    s.plane[p] = planes[p];
    s.plane_stride[p] = plane_strides[p];
    s.inner[p] = inner[p];
    s.inner_stride[p] = inner_rows[p];
  }
  s.inj_val = inj_val;
  s.mode = mode;
  a.sx = a.sy = a.sz = -1;
  if (src >= 0) {
    const long long yz_size = (long long)s.Y * s.Z;
    a.sx = static_cast<int>(src / yz_size);
    a.sy = static_cast<int>((src % yz_size) / s.Z);
    a.sz = static_cast<int>(src % s.Z);
  }
  box_fused_step_kernel<<<launch_grid(s.X, s.Y, s.Z),
                          dim3(kBlockZ, kBlockY, 1), 0,
                          static_cast<cudaStream_t>(stream)>>>(a, cur, prev,
                                                               next);
  return static_cast<int>(cudaGetLastError());
}

// What the card makes of the kernel on the current device, and its launch
// for a field of `dims` (X, Y, Z): out = registers a thread, local memory
// (spills) a thread in bytes, CTAs resident on one SM, threads a CTA, CTAs
// a step.  Returns the CUDA error code.
int wv_box_fused_step_occupancy(const int* dims, int* out) {
  cudaFuncAttributes attrs;
  cudaError_t e = cudaFuncGetAttributes(&attrs, box_fused_step_kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = attrs.numRegs;
  out[1] = static_cast<int>(attrs.localSizeBytes);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[2], box_fused_step_kernel, kThreads, 0);
  out[3] = kThreads;
  const dim3 grid = launch_grid(dims[0], dims[1], dims[2]);
  out[4] = static_cast<int>(grid.x * grid.y * grid.z);
  return static_cast<int>(e);
}

const char* wv_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
