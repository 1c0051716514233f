// K bare leapfrog sub-steps with both fields held on chip: the residency
// probe, CUDA C++ for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` (with `_substep`) of
// tools/bench/probe_vmem_resident.py.  Per node and sub-step:
//
//   dst = C2 * (((((x- + x+) + y-) + y+) + z-) + z+) - dst,   C2 = 1/3,
//
// the sum taken over src, zero beyond the grid; src and dst swap roles
// every sub-step.  Each operation rounds on its own (intrinsics, and
// nvcc --fmad=false), so the kernel equals the port's plain version
// `substep_plain` (wayverb_tpu_torch/tools/probe_resident.py) bit for bit.
// Unlike the TPU kernel it updates every x plane (not only the first
// X - X % 8) and runs exactly K sub-steps, odd K included.
//
// The TPU kernel DMAs both fields of the whole grid into VMEM, which one
// core holds up to 128 MiB.  On Hopper the nearest on-chip store is shared
// memory, at most 232,448 B a CTA; a CTA of a thread-block cluster can also
// read its cluster neighbours' shared memory (distributed shared memory).
// One launch runs all K sub-steps, in one of three forms that the wrapper's
// planner (`plan_tiles`) chooses by shape:
//
// * one cluster (resident, the grid fits a cluster of at most 16 CTAs):
//   CTA r of the cluster owns tile r of an x tiling (whole y and z).  It
//   copies its part of both fields into shared memory once, reads the
//   x planes beyond its tile from its neighbours' shared memory
//   (cluster.map_shared_rank), and syncs with cluster.sync() alone: no
//   cooperative grid, no face buffer.
// * a cooperative grid of clusters (resident): tile t of a (tx, ty, tz)
//   tiling, x fastest, clusters of `cluster` consecutive tiles along x.  x
//   faces inside a cluster come from the neighbour's shared memory; every
//   other face (y, z, and x between clusters) goes through a face buffer
//   in device memory, written while the face's nodes are computed (so the
//   next sub-step reads it) and read after the grid barrier (grid.sync()).
// * device memory (resident = 0): a persistent cooperative grid, the fields
//   in device memory (and L2 while they fit its 50 MB).  Sub-step 0 reads
//   the inputs and writes both outputs; the later ones update the outputs
//   in place.
//
// Layout.  Every form walks x: a thread owns one (y, z) column and carries
// src at x - 1 and x in registers, so a node reads src at x + 1, its four
// y and z neighbours and dst, and writes dst.  Resident, the columns of a
// tile go to the threads of its CTA in passes, z fastest, and the CTA has
// as many warps as make the passes even (the planner's `threads`).  A walk
// loads its x ends' neighbours (a cluster neighbour's shared memory or the
// face buffer) first; one of at most kUnrolled rows is unrolled.  A warp
// none of whose 32 columns reads a y or z face from device memory (the
// tile's inside, and the grid's walls, where the neighbour is zero) takes
// a path without the face branches, decided once a pass (__any_sync); the
// others load their face values for the whole walk first.  In device
// memory a thread owns one node of the flattened (y, z) plane and walks
// kStreamWalk x rows, warps of 32 consecutive nodes, grid-striding over
// (row block, plane block) items on as many CTAs as the wrapper gives
// (`streamed_ctas`: as few as take the items in as few rounds, since a
// small grid's barrier is cheaper), with a 32-bit node index below 2^31
// nodes and a 64-bit one from there.
//
// Barriers.  One a sub-step suffices, because src and dst swap: the
// barrier ending sub-step s orders every write of sub-step s's dst (the
// next src, read by neighbours through distributed shared memory or the
// face buffer) before any read of sub-step s + 1, and every read of
// sub-step s's src (a neighbour's remote loads included) before sub-step
// s + 1 writes that buffer.  Face buffers alternate by parity: the faces
// written in sub-step s (parity s + 1) are read in s + 1, and that parity
// is next written in s + 2, after the barrier that ends s + 1.  Remote
// shared-memory accesses are loads only, each consumed by the dst store
// before its thread reaches the barrier.  grid.sync() is a gpu-scope fence
// pair around the arrival, which orders the cluster's shared memory too,
// so the grid form needs no cluster barrier beside it (step 0: a cluster
// arrive/wait around grid.sync() added 0.55 us a barrier).  A CTA must not
// exit while a neighbour may still read its shared memory: the barrier
// after the last sub-step comes before the store-out.
//
// What bounds it (PERF.md §6).  Resident: the barrier a sub-step (step 0 on
// the H100 80GB HBM3 at 700 W: grid.sync() 1.15-1.16 us at 128-132 CTAs,
// cluster.sync() 0.68-0.75 us for clusters of 2-16) and the shared-memory
// traffic, 28 B a node a sub-step at 128 B a clock an SM.  Device memory:
// 12 B a node a sub-step through L2 or device memory.  Step 0 also found
// that a cooperative launch with a cluster dimension is accepted, and that
// at 1,024 threads and 229,376 B a CTA (and alike at the opt-in most,
// 232,448 B) only 15 clusters of 8 (120 CTAs), 30 of 4 (120) and 66 of 2
// (132) are resident at once, so a grid that needs 128 such CTAs runs in
// clusters of 2.
//
// Output: out_a holds the field that was `cur` after an even number of
// sub-steps, out_b the other.  After K sub-steps the newest field is out_b
// when K is odd and out_a when K is even; the wrapper names them.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;         // at most, resident (1 CTA an SM)
constexpr int kLanes = 32;
constexpr int kMaxCluster = 16;
constexpr int kUnrolled = 8;           // resident walks up to this unroll
constexpr int kStreamThreads = 256;    // device memory: nodes of a CTA
constexpr int kStreamWalk = 4;         // x rows a thread walks
constexpr float kC2 = 1.0f / 3.0f;

__device__ __forceinline__ float leapfrog(float xm, float xp, float ym,
                                          float yp, float zm, float zp,
                                          float d) {
  float acc = __fadd_rn(xm, xp);
  acc = __fadd_rn(acc, ym);
  acc = __fadd_rn(acc, yp);
  acc = __fadd_rn(acc, zm);
  acc = __fadd_rn(acc, zp);
  return __fsub_rn(__fmul_rn(kC2, acc), d);
}

struct Args {
  const float* cur_in;
  const float* prev_in;
  float* out_a;
  float* out_b;
  float* faces;
  int X, Y, Z;
  int tx, ty, tz;  // the tile
  int nx, ny, nz;  // tiles along each axis
  int cluster;     // CTAs of a cluster, consecutive along x
  int K;
  int face_max;    // floats of a face in the buffer
};

// Face f of a tile: 0/1 the x-lo/x-hi plane, indexed ly * ez + lz; 2/3 the
// y-lo/y-hi plane, lx * ez + lz; 4/5 the z-lo/z-hi plane, lx * ey + ly.
// Neighbouring tiles share the extents of a common face.  The face buffer
// holds 2 parities x tiles x 6 faces x face_max floats.

// A tile of the grid: its extents and its origin.
struct Tile {
  int ex, ey, ez, plane, x0, y0, z0;
};

// Where a tile's neighbours' values come from in a sub-step, as bits of
// `flags`.  Bit f (0..5): face f borders a tile of another cluster, whose
// face f ^ 1 is read from the face buffer's half at float offset `in`
// (this sub-step's parity), and this tile's face f is written to the half
// at `out` (the next parity) when kPublish is set (not in the last
// sub-step).  kNearXm / kNearXp: the x neighbour is in this cluster, and
// its src is read from its shared memory.
constexpr int kNearXm = 1 << 6, kNearXp = 1 << 7, kPublish = 1 << 8;

struct Links {
  int flags, in, out;
};

__device__ __forceinline__ int face_offset(const Args& a, int tile, int f) {
  return (tile * 6 + f) * a.face_max;
}

// The neighbour's face across face f of this tile, in the face buffer.
__device__ __forceinline__ const float* in_face(const Args& a,
                                                const Links& l, int f) {
  const int d = f < 2 ? 1 : f < 4 ? a.nx * a.nz : a.nx;
  const int tile = static_cast<int>(blockIdx.x) + ((f & 1) ? d : -d);
  return a.faces + l.in + face_offset(a, tile, f ^ 1);
}

__device__ __forceinline__ void out_face(const Args& a, const Links& l,
                                         int f, int idx, float v) {
  __stcg(a.faces + l.out + face_offset(a, blockIdx.x, f) + idx, v);
}

// One column (ly, lz) of the tile walked along x: dst = leapfrog(src).
// Both x ends' neighbours (a cluster neighbour's shared memory or the face
// buffer) are loaded before the walk.  kInside: no y or z neighbour of the
// warp's columns comes from the face buffer (so none of their y or z faces
// is published), which leaves only the walls' zeros as selects.  kRows > 0:
// the walk has at most kRows rows, unrolled, and the column's y and z face
// values through device memory are all loaded before it.
template <bool kInside, int kRows>
__device__ __forceinline__ void walk_column(
    const Args& a, float* src, float* __restrict__ dst, const Tile& t,
    const Links& l, int col) {
  const int ly = col / t.ez, lz = col - ly * t.ez;
  const int ex = t.ex, ey = t.ey, ez = t.ez, plane = t.plane, f = l.flags;
  cg::cluster_group cluster = cg::this_cluster();
  float xm = 0.f, xend = 0.f;
  if (f & kNearXm)
    xm = cluster.map_shared_rank(src, cluster.block_rank() - 1)
             [(a.tx - 1) * plane + col];
  else if (f & 1)
    xm = __ldcg(in_face(a, l, 0) + col);
  if (f & kNearXp)
    xend = cluster.map_shared_rank(src, cluster.block_rank() + 1)[col];
  else if (f & 2)
    xend = __ldcg(in_face(a, l, 1) + col);
  const bool bym = !kInside && ly == 0 && (f & 4);
  const bool byp = !kInside && ly == ey - 1 && (f & 8);
  const bool bzm = !kInside && lz == 0 && (f & 16);
  const bool bzp = !kInside && lz == ez - 1 && (f & 32);
  constexpr int kFaces = kRows > 0 && !kInside ? kRows : 1;
  float fy[kFaces] = {}, fz[kFaces] = {};  // y-lo else y-hi; z-lo else z-hi
  if constexpr (kFaces > 1) {
    const float* py = bym   ? in_face(a, l, 2) + lz
                      : byp ? in_face(a, l, 3) + lz
                            : nullptr;
    const float* pz = bzm   ? in_face(a, l, 4) + ly
                      : bzp ? in_face(a, l, 5) + ly
                            : nullptr;
#pragma unroll
    for (int r = 0; r < kFaces; ++r) {
      fy[r] = py && r < ex ? __ldcg(py + r * ez) : 0.f;
      fz[r] = pz && r < ex ? __ldcg(pz + r * ey) : 0.f;
    }
  }
  float xc = src[col];
  auto row = [&](int lx, float fyv, float fzv) {
    const int i = lx * plane + col;
    const float xp = lx + 1 < ex ? src[i + plane] : xend;
    float ym = 0.f, yp = 0.f, zm = 0.f, zp = 0.f;
    if (ly > 0)
      ym = src[i - ez];
    else if (bym)
      ym = kFaces > 1 ? fyv : __ldcg(in_face(a, l, 2) + lx * ez + lz);
    if (ly < ey - 1)
      yp = src[i + ez];
    else if (byp)
      yp = kFaces > 1 && !bym ? fyv
                              : __ldcg(in_face(a, l, 3) + lx * ez + lz);
    if (lz > 0)
      zm = src[i - 1];
    else if (bzm)
      zm = kFaces > 1 ? fzv : __ldcg(in_face(a, l, 4) + lx * ey + ly);
    if (lz < ez - 1)
      zp = src[i + 1];
    else if (bzp)
      zp = kFaces > 1 && !bzm ? fzv
                              : __ldcg(in_face(a, l, 5) + lx * ey + ly);
    const float v = leapfrog(xm, xp, ym, yp, zm, zp, dst[i]);
    dst[i] = v;
    if (f & kPublish) {
      if (lx == 0 && (f & 1)) out_face(a, l, 0, col, v);
      if (lx == ex - 1 && (f & 2)) out_face(a, l, 1, col, v);
      if (bym) out_face(a, l, 2, lx * ez + lz, v);
      if (byp) out_face(a, l, 3, lx * ez + lz, v);
      if (bzm) out_face(a, l, 4, lx * ey + ly, v);
      if (bzp) out_face(a, l, 5, lx * ey + ly, v);
    }
    xm = xc;
    xc = xp;
  };
  if constexpr (kRows > 0) {
#pragma unroll
    for (int lx = 0; lx < kRows; ++lx) {
      if (lx >= ex) break;
      row(lx, fy[kFaces > 1 ? lx : 0], fz[kFaces > 1 ? lx : 0]);
    }
  } else {
    for (int lx = 0; lx < ex; ++lx) row(lx, 0.f, 0.f);
  }
}

// Whether column `col` reads a y or z face from the face buffer.
__device__ __forceinline__ bool reads_faces(const Tile& t, int flags,
                                            int col) {
  const int ly = col / t.ez, lz = col - ly * t.ez;
  return (ly == 0 && (flags & 4)) || (ly == t.ey - 1 && (flags & 8)) ||
         (lz == 0 && (flags & 16)) || (lz == t.ez - 1 && (flags & 32));
}

// kGrid: a cooperative grid of clusters (grid.sync() and face buffers);
// otherwise one cluster (cluster.sync() alone).
template <bool kGrid>
__global__ void __launch_bounds__(kThreads, 1)
resident_kernel(const __grid_constant__ Args a) {
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int tile = blockIdx.x;
  const int ti = tile % a.nx, tk = (tile / a.nx) % a.nz,
            tj = tile / (a.nx * a.nz);
  const int rank = static_cast<int>(cluster.block_rank());  // ti % cluster
  Tile t;
  t.x0 = ti * a.tx;
  t.y0 = tj * a.ty;
  t.z0 = tk * a.tz;
  t.ex = min(a.tx, a.X - t.x0);
  t.ey = min(a.ty, a.Y - t.y0);
  t.ez = min(a.tz, a.Z - t.z0);
  t.plane = t.ey * t.ez;
  // the x neighbours in this cluster, read from their shared memory; with
  // a grid, the other faces that border a tile, through the face buffer
  const bool near_xm = ti > 0 && rank > 0;
  const bool near_xp = ti < a.nx - 1 && rank < a.cluster - 1;
  Links l;
  l.flags = (near_xm ? kNearXm : 0) | (near_xp ? kNearXp : 0);
  if constexpr (kGrid)
    l.flags |= (ti > 0 && !near_xm) | (ti < a.nx - 1 && !near_xp) << 1 |
               (tj > 0) << 2 | (tj < a.ny - 1) << 3 | (tk > 0) << 4 |
               (tk < a.nz - 1) << 5;
  const int parity_floats = a.nx * a.ny * a.nz * 6 * a.face_max;

  float* A = smem;                       // the field that was cur
  float* B = smem + a.tx * a.ty * a.tz;  // the field that was prev
  const int lane = threadIdx.x % kLanes;
  const int nthreads = blockDim.x;
  const int first = threadIdx.x - lane;  // the warp's first column a pass

  // load both fields; publish cur's faces for sub-step 0 (parity 0)
  l.out = 0;
  for (int base = first; base < t.plane; base += nthreads) {
    const int col = base + lane;
    if (col < t.plane) {
      const int ly = col / t.ez, lz = col - ly * t.ez;
      for (int lx = 0; lx < t.ex; ++lx) {
        const long long g =
            ((long long)(t.x0 + lx) * a.Y + (t.y0 + ly)) * a.Z + t.z0 + lz;
        const int i = lx * t.plane + col;
        const float c = a.cur_in[g];
        A[i] = c;
        B[i] = a.prev_in[g];
        if constexpr (kGrid) {
          const int f = l.flags;
          if (lx == 0 && (f & 1)) out_face(a, l, 0, col, c);
          if (lx == t.ex - 1 && (f & 2)) out_face(a, l, 1, col, c);
          if (ly == 0 && (f & 4)) out_face(a, l, 2, lx * t.ez + lz, c);
          if (ly == t.ey - 1 && (f & 8)) out_face(a, l, 3, lx * t.ez + lz, c);
          if (lz == 0 && (f & 16)) out_face(a, l, 4, lx * t.ey + ly, c);
          if (lz == t.ez - 1 && (f & 32))
            out_face(a, l, 5, lx * t.ey + ly, c);
        }
      }
    }
  }

  // The cluster barrier is .aligned: every lane of a warp executes it
  // together, so the warp reconverges first (a pass's idle lanes leave the
  // column loop early).
  auto barrier = [&]() {
    if constexpr (kGrid) {
      cg::this_grid().sync();
    } else {
      __syncwarp();
      cluster.sync();
    }
  };
  barrier();

  for (int s = 0; s < a.K; ++s) {
    float* src = (s & 1) ? B : A;
    float* dst = (s & 1) ? A : B;
    l.in = (s & 1) * parity_floats;
    l.out = parity_floats - l.in;
    l.flags = s + 1 < a.K ? l.flags | kPublish : l.flags & ~kPublish;
    for (int base = first; base < t.plane; base += nthreads) {
      const int col = base + lane;
      const bool live = col < t.plane;
      const bool faces = kGrid && live && reads_faces(t, l.flags, col);
      const bool inside = !__any_sync(0xffffffffu, faces);
      if (live) {
        if (t.ex <= kUnrolled) {
          if (inside)
            walk_column<true, kUnrolled>(a, src, dst, t, l, col);
          else
            walk_column<false, kUnrolled>(a, src, dst, t, l, col);
        } else {
          if (inside)
            walk_column<true, 0>(a, src, dst, t, l, col);
          else
            walk_column<false, 0>(a, src, dst, t, l, col);
        }
      }
    }
    barrier();  // dst complete everywhere; every read of src done
  }

  for (int base = first; base < t.plane; base += nthreads) {
    const int col = base + lane;
    if (col < t.plane) {
      const int ly = col / t.ez, lz = col - ly * t.ez;
      for (int lx = 0; lx < t.ex; ++lx) {
        const long long g =
            ((long long)(t.x0 + lx) * a.Y + (t.y0 + ly)) * a.Z + t.z0 + lz;
        const int i = lx * t.plane + col;
        a.out_a[g] = A[i];
        a.out_b[g] = B[i];
      }
    }
  }
}

// The device-memory kernel's node index: 32-bit below 2^31 nodes (6 CTAs an
// SM at 40 registers), 64-bit from 2^31 on (5 an SM: the wide index takes
// registers that would spill at 6).  The caller chooses; a 32-bit launch of
// 2^31 nodes or more is refused.
template <class Index>
struct Stream;
template <>
struct Stream<int> {
  static constexpr int kCtasPerSm = 6;
};
template <>
struct Stream<long long> {
  static constexpr int kCtasPerSm = 5;
};

// One item of a device-memory sub-step: node p of the (y, z) plane over x
// rows x0 .. x0 + kStreamWalk - 1, dst = leapfrog(src) - old.  `old` may be
// `dst` (the later sub-steps update in place), so the walk loads old of
// all its rows before its first store.  `copy`, in sub-step 0, receives src.
// The plane's indices are 32-bit (Y * Z < 2^31, which the wrapper checks).
template <class Index>
__device__ __forceinline__ void streamed_walk(
    const float* __restrict__ src, const float* old, float* dst, float* copy,
    int X, int Y, int Z, int p, int x0) {
  const int YZ = Y * Z;
  const bool live = p < YZ;
  const int y = p / Z, z = p - y * Z;
  Index i = static_cast<Index>(x0) * YZ + p;
  float pv[kStreamWalk];
#pragma unroll
  for (int t = 0; t < kStreamWalk; ++t)
    pv[t] = live && x0 + t < X ? old[i + static_cast<Index>(t) * YZ] : 0.f;
  float cm = 0.f, c0 = 0.f;
  if (live) {
    if (x0 > 0) cm = src[i - YZ];
    c0 = src[i];
  }
#pragma unroll
  for (int t = 0; t < kStreamWalk; ++t) {
    const int x = x0 + t;
    if (x >= X) break;  // uniform across the CTA
    float cp = 0.f, ym = 0.f, yp = 0.f, zm = 0.f, zp = 0.f;
    if (live && x + 1 < X) cp = src[i + YZ];
    if (live && y > 0) ym = src[i - Z];
    if (live && y < Y - 1) yp = src[i + Z];
    if (live && z > 0) zm = src[i - 1];
    if (live && z < Z - 1) zp = src[i + 1];
    const float v = leapfrog(cm, cp, ym, yp, zm, zp, pv[t]);
    if (live) {
      if (copy) copy[i] = c0;
      dst[i] = v;
    }
    cm = c0;
    c0 = cp;
    i += YZ;
  }
}

template <class Index>
__global__ void __launch_bounds__(kStreamThreads, Stream<Index>::kCtasPerSm)
streamed_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  const int blocks = (a.Y * a.Z + kStreamThreads - 1) / kStreamThreads;
  const int rows = (a.X + kStreamWalk - 1) / kStreamWalk;
  const int items = blocks * rows;
  for (int s = 0; s < a.K; ++s) {
    if (s > 0) grid.sync();  // every node of the last sub-step is written
    // sub-step 0: out_b = leapfrog(cur_in) - prev_in, out_a = cur_in
    const float* src = s == 0 ? a.cur_in : (s & 1) ? a.out_b : a.out_a;
    const float* old = s == 0 ? a.prev_in : (s & 1) ? a.out_a : a.out_b;
    float* dst = (s & 1) ? a.out_a : a.out_b;
    float* copy = s == 0 ? a.out_a : nullptr;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int row = item / blocks, block = item - row * blocks;
      streamed_walk<Index>(src, old, dst, copy, a.X, a.Y, a.Z,
                           block * kStreamThreads + threadIdx.x,
                           row * kStreamWalk);
    }
  }
}

// Step 0 of the design: what the runtime accepts and what a barrier costs.
// kind 0: grid.sync(); 1: cluster.sync(); 2: a cluster arrive, grid.sync()
// and the cluster wait.  The shared memory only sets the residency.
__global__ void __launch_bounds__(kThreads, 1)
barrier_kernel(int n, int kind) {
  if (kind == 1) {
    cg::cluster_group cluster = cg::this_cluster();
    for (int s = 0; s < n; ++s) cluster.sync();
    return;
  }
  cg::grid_group grid = cg::this_grid();
  for (int s = 0; s < n; ++s) {
    if (kind == 2)
      asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
    grid.sync();
    if (kind == 2)
      asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
  }
}

template <class Kernel>
cudaError_t allow(Kernel kernel, int smem) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

// A launch of `kernel` by cudaLaunchKernelEx: `ctas` CTAs of `threads`, in
// clusters of `cluster` along x (0: no cluster attribute), cooperative or
// not.
template <class Kernel, class... Params>
cudaError_t launch(Kernel kernel, int ctas, int threads, int smem,
                   int cluster, bool cooperative, cudaStream_t stream,
                   Params... params) {
  cudaLaunchAttribute attrs[2];
  int count = 0;
  if (cooperative) {
    attrs[count].id = cudaLaunchAttributeCooperative;
    attrs[count].val.cooperative = 1;
    ++count;
  }
  if (cluster > 0) {
    attrs[count].id = cudaLaunchAttributeClusterDimension;
    attrs[count].val.clusterDim.x = cluster;
    attrs[count].val.clusterDim.y = 1;
    attrs[count].val.clusterDim.z = 1;
    ++count;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(ctas);
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  config.attrs = attrs;
  config.numAttrs = count;
  cudaError_t e = cudaLaunchKernelEx(&config, kernel, params...);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// The clusters of `cluster` CTAs of `threads` and `smem` B resident at once.
template <class Kernel>
cudaError_t max_clusters(Kernel kernel, int cluster, int threads, int smem,
                         int* out) {
  cudaError_t e = allow(kernel, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(cluster * 64);
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = smem;
  config.attrs = &attr;
  config.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(out, kernel, &config);
}

}  // namespace

extern "C" {

// K sub-steps in one launch of `ctas` CTAs of `threads` threads.
// resident != 0: `ctas` = nx * ny * nz, tile t of the (tx, ty, tz) tiling
// (x fastest) in 2 * tx * ty * tz * 4 B of dynamic shared memory, in
// clusters of `cluster` CTAs along x (cluster divides nx, at most 16); a
// grid of one cluster launches plainly and syncs the cluster, a larger one
// launches cooperatively and uses `faces`, 2 * tiles * 6 * max(ty*tz,
// tx*tz, tx*ty) floats.  resident == 0: a cooperative grid of `ctas` CTAs
// of kStreamThreads threads, which stride over the items, with a 64-bit
// node index when `wide` is set (required from 2^31 nodes on); the tile
// arguments and `faces` are unused.  The caller chooses `ctas`; this entry
// launches what it is told.  Returns the CUDA error code of the launch (0
// on success): arguments it cannot run are refused as invalid, a grid that
// cannot be resident at once by the runtime.  Launches on `stream`, does
// not synchronise, allocates nothing.
int wv_probe_resident_f32(const float* cur, const float* prev, float* out_a,
                          float* out_b, float* faces, int X, int Y, int Z,
                          int tx, int ty, int tz, int cluster, int ctas,
                          int threads, int K, int resident, int wide,
                          void* stream) {
  Args a{cur, prev, out_a, out_b, faces, X, Y, Z, tx, ty, tz,
         1,   1,    1,     cluster, K, 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!resident) {
    const long long plane = static_cast<long long>(Y) * Z;
    if (ctas < 1 || threads != kStreamThreads || plane >= (1LL << 31) ||
        (!wide && plane * X >= (1LL << 31)))
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(
        wide ? launch(streamed_kernel<long long>, ctas, kStreamThreads, 0, 0,
                      true, s, a)
             : launch(streamed_kernel<int>, ctas, kStreamThreads, 0, 0, true,
                      s, a));
  }
  a.nx = (X + tx - 1) / tx;
  a.ny = (Y + ty - 1) / ty;
  a.nz = (Z + tz - 1) / tz;
  a.face_max = ty * tz;
  if (tx * tz > a.face_max) a.face_max = tx * tz;
  if (tx * ty > a.face_max) a.face_max = tx * ty;
  const int tiles = a.nx * a.ny * a.nz;
  if (ctas != tiles || cluster < 1 || cluster > kMaxCluster ||
      a.nx % cluster != 0 || threads < kLanes || threads > kThreads ||
      threads % kLanes != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = 2 * tx * ty * tz * static_cast<int>(sizeof(float));
  const bool grid = tiles > cluster;
  void (*kernel)(Args) = grid ? resident_kernel<true> : resident_kernel<false>;
  cudaError_t e = allow(kernel, smem);
  if (e == cudaSuccess)
    e = launch(kernel, tiles, threads, smem, cluster, grid, s, a);
  return static_cast<int>(e);
}

// What the card makes of a form: form 0 the device-memory kernel (3 with
// its 64-bit index), 1 the resident kernel on a cooperative grid, 2 on one
// cluster.  Registers a
// thread, local memory (spills) a thread in bytes, CTAs resident on one SM
// (at `threads` and `smem` B for the resident forms), and for those the
// clusters of `cluster` CTAs resident at once (0 for form 0).  Returns the
// CUDA error code.
int wv_probe_resident_occupancy(int form, int cluster, int threads, int smem,
                                int* registers, int* local_bytes,
                                int* ctas_per_sm, int* clusters) {
  cudaFuncAttributes attrs;
  cudaError_t e;
  if (form == 0 || form == 3) {
    void (*kernel)(Args) =
        form == 0 ? streamed_kernel<int> : streamed_kernel<long long>;
    e = cudaFuncGetAttributes(&attrs, kernel);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          ctas_per_sm, kernel, kStreamThreads, 0);
    *clusters = 0;
  } else {
    void (*kernel)(Args) =
        form == 1 ? resident_kernel<true> : resident_kernel<false>;
    e = allow(kernel, smem);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&attrs, kernel);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, kernel,
                                                        threads, smem);
    if (e == cudaSuccess)
      e = max_clusters(kernel, cluster, threads, smem, clusters);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  *registers = attrs.numRegs;
  *local_bytes = static_cast<int>(attrs.localSizeBytes);
  return 0;
}

// The SM count, the opt-in shared memory a block may use and the L2 size
// of `device`, into out[0..2].  Returns the CUDA error code.
int wv_probe_device_attrs(int device, int* out) {
  const cudaDeviceAttr attrs[3] = {cudaDevAttrMultiProcessorCount,
                                   cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                   cudaDevAttrL2CacheSize};
  for (int k = 0; k < 3; ++k) {
    cudaError_t e = cudaDeviceGetAttribute(out + k, attrs[k], device);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

// Step 0: `n` barriers of `kind` (barrier_kernel) in `ctas` CTAs of 1024
// threads and `smem` B of dynamic shared memory, in clusters of `cluster`
// CTAs (1: no cluster attribute), cooperative or not.  Returns the
// launch's CUDA error code.
int wv_probe_barrier(int n, int kind, int ctas, int cluster, int cooperative,
                     int smem, void* stream) {
  cudaError_t e = allow(barrier_kernel, smem);
  if (e == cudaSuccess)
    e = launch(barrier_kernel, ctas, kThreads, smem, cluster > 1 ? cluster : 0,
               cooperative != 0, static_cast<cudaStream_t>(stream), n, kind);
  return static_cast<int>(e);
}

const char* wv_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
