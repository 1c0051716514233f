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
// memory, at most 232,448 B a CTA, reachable only by its own CTA.  So the
// kernel is one cooperative launch (cudaLaunchCooperativeKernel) of CTAs
// that are all resident at once, one per SM, with a grid-wide barrier
// (cooperative_groups::this_grid().sync()) between sub-steps.  Two modes,
// one function:
//
// * resident: CTA t owns tile t of a (tx, ty, tz) tiling of the grid and
//   copies its part of both fields into dynamic shared memory once.  Each
//   sub-step it publishes the tile's faces of src that border another tile
//   to a face buffer in device memory (two copies, by sub-step parity, so
//   one grid barrier a sub-step suffices: a face written at sub-step s + 2
//   is read by nobody after the barrier of sub-step s + 1), syncs the grid,
//   and updates dst from shared memory inside the tile and from the
//   neighbours' faces at its edge.  After K sub-steps it copies both fields
//   back.  Device memory then carries 16 B a node a launch plus the faces.
// * device memory (resident = 0): the same persistent grid and barrier, the
//   fields read and written in device memory (served by L2 while both fit
//   its 50 MB).  The first sub-step reads the inputs and writes both
//   outputs; the later ones update the outputs in place.
//
// What bounds it on the card: resident, 7 float32 operations a node a
// sub-step, since the fields cross device memory once a launch; device
// memory, 12 B a node a sub-step.  Measured (PERF.md §6), the resident mode
// is paced by each CTA's own instruction latency (seven shared-memory reads
// a node, one CTA of 32 warps an SM) and the device-memory mode by L2 or
// device memory.  This first version is plain: one thread a node, z along
// the lanes of a warp, no TMA, no clusters, no register blocking.
//
// Output: out_a holds the field that was `cur` after an even number of
// sub-steps, out_b the other.  After K sub-steps the newest field is out_b
// when K is odd and out_a when K is even; the wrapper names them.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kLanes = 32;                 // threads of a warp, along z
constexpr int kWarps = kThreads / kLanes;  // each on its own (x, y) row
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

// Face f of a tile: 0/1 the x-lo/x-hi plane, indexed ly * ez + lz; 2/3 the
// y-lo/y-hi plane, lx * ez + lz; 4/5 the z-lo/z-hi plane, lx * ey + ly.
// Neighbouring tiles share the extents of a common face.
struct Tile {
  int nx, ny, nz, ti, tj, tk, x0, y0, z0, ex, ey, ez;
  long long face_max;
};

__device__ __forceinline__ float* face(float* faces, const Tile& t,
                                       int parity, int tile, int f) {
  const long long ntiles = (long long)t.nx * t.ny * t.nz;
  return faces + ((parity * ntiles + tile) * 6 + f) * t.face_max;
}

__device__ void publish_faces(const float* src, float* faces, const Tile& t,
                              int parity) {
  const int tile = blockIdx.x;
  const int plane = t.ey * t.ez;
  if (t.ti > 0) {
    float* fb = face(faces, t, parity, tile, 0);
    for (int i = threadIdx.x; i < plane; i += kThreads) __stcg(fb + i, src[i]);
  }
  if (t.ti < t.nx - 1) {
    float* fb = face(faces, t, parity, tile, 1);
    const float* s = src + (t.ex - 1) * plane;
    for (int i = threadIdx.x; i < plane; i += kThreads) __stcg(fb + i, s[i]);
  }
  for (int f = 2; f < 4; ++f) {
    if (f == 2 ? t.tj == 0 : t.tj == t.ny - 1) continue;
    float* fb = face(faces, t, parity, tile, f);
    const int ly = f == 2 ? 0 : t.ey - 1;
    for (int i = threadIdx.x; i < t.ex * t.ez; i += kThreads) {
      const int lx = i / t.ez, lz = i % t.ez;
      __stcg(fb + i, src[(lx * t.ey + ly) * t.ez + lz]);
    }
  }
  for (int f = 4; f < 6; ++f) {
    if (f == 4 ? t.tk == 0 : t.tk == t.nz - 1) continue;
    float* fb = face(faces, t, parity, tile, f);
    const int lz = f == 4 ? 0 : t.ez - 1;
    for (int r = threadIdx.x; r < t.ex * t.ey; r += kThreads)
      __stcg(fb + r, src[r * t.ez + lz]);
  }
}

__device__ void resident_run(const float* __restrict__ cur_in,
                             const float* __restrict__ prev_in, float* out_a,
                             float* out_b, float* faces, int X, int Y, int Z,
                             int tx, int ty, int tz, int K) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  Tile t;
  t.nx = (X + tx - 1) / tx;
  t.ny = (Y + ty - 1) / ty;
  t.nz = (Z + tz - 1) / tz;
  const int tile = blockIdx.x;
  t.ti = tile / (t.ny * t.nz);
  t.tj = (tile / t.nz) % t.ny;
  t.tk = tile % t.nz;
  t.x0 = t.ti * tx;
  t.y0 = t.tj * ty;
  t.z0 = t.tk * tz;
  t.ex = min(tx, X - t.x0);
  t.ey = min(ty, Y - t.y0);
  t.ez = min(tz, Z - t.z0);
  t.face_max = max(max(ty * tz, tx * tz), tx * ty);
  float* A = smem;                 // the field that was cur
  float* B = smem + tx * ty * tz;  // the field that was prev
  const int lane = threadIdx.x % kLanes, warp = threadIdx.x / kLanes;
  const int rows = t.ex * t.ey, plane = t.ey * t.ez;

  for (int r = warp; r < rows; r += kWarps) {
    const int lx = r / t.ey, ly = r % t.ey;
    const long long g =
        ((long long)(t.x0 + lx) * Y + (t.y0 + ly)) * Z + t.z0;
    for (int lz = lane; lz < t.ez; lz += kLanes) {
      A[r * t.ez + lz] = cur_in[g + lz];
      B[r * t.ez + lz] = prev_in[g + lz];
    }
  }

  const int ystep = t.nz, xstep = t.ny * t.nz;  // tile index strides
  for (int s = 0; s < K; ++s) {
    const float* src = (s & 1) ? B : A;
    float* dst = (s & 1) ? A : B;
    const int par = s & 1;
    __syncthreads();  // the last sub-step's dst (or the load) is complete
    publish_faces(src, faces, t, par);
    grid.sync();
    const float* fxm = t.ti > 0 ? face(faces, t, par, tile - xstep, 1) : nullptr;
    const float* fxp =
        t.ti < t.nx - 1 ? face(faces, t, par, tile + xstep, 0) : nullptr;
    const float* fym = t.tj > 0 ? face(faces, t, par, tile - ystep, 3) : nullptr;
    const float* fyp =
        t.tj < t.ny - 1 ? face(faces, t, par, tile + ystep, 2) : nullptr;
    const float* fzm = t.tk > 0 ? face(faces, t, par, tile - 1, 5) : nullptr;
    const float* fzp =
        t.tk < t.nz - 1 ? face(faces, t, par, tile + 1, 4) : nullptr;
    for (int r = warp; r < rows; r += kWarps) {
      const int lx = r / t.ey, ly = r % t.ey;
      for (int lz = lane; lz < t.ez; lz += kLanes) {
        const int i = r * t.ez + lz;
        const float xm = lx > 0 ? src[i - plane]
                         : fxm ? __ldcg(fxm + ly * t.ez + lz) : 0.f;
        const float xp = lx < t.ex - 1 ? src[i + plane]
                         : fxp ? __ldcg(fxp + ly * t.ez + lz) : 0.f;
        const float ym = ly > 0 ? src[i - t.ez]
                         : fym ? __ldcg(fym + lx * t.ez + lz) : 0.f;
        const float yp = ly < t.ey - 1 ? src[i + t.ez]
                         : fyp ? __ldcg(fyp + lx * t.ez + lz) : 0.f;
        const float zm = lz > 0 ? src[i - 1] : fzm ? __ldcg(fzm + r) : 0.f;
        const float zp = lz < t.ez - 1 ? src[i + 1]
                         : fzp ? __ldcg(fzp + r) : 0.f;
        dst[i] = leapfrog(xm, xp, ym, yp, zm, zp, dst[i]);
      }
    }
  }
  __syncthreads();

  for (int r = warp; r < rows; r += kWarps) {
    const int lx = r / t.ey, ly = r % t.ey;
    const long long g =
        ((long long)(t.x0 + lx) * Y + (t.y0 + ly)) * Z + t.z0;
    for (int lz = lane; lz < t.ez; lz += kLanes) {
      out_a[g + lz] = A[r * t.ez + lz];
      out_b[g + lz] = B[r * t.ez + lz];
    }
  }
}

// One sub-step over the whole grid in device memory: dst = leapfrog(src)
// with dst's old value `old` (a separate input on the first sub-step).
__device__ __forceinline__ void streamed_substep(const float* src,
                                                 const float* old, float* dst,
                                                 float* copy, int X, int Y,
                                                 int Z) {
  const long long yz = (long long)Y * Z;
  const int lane = threadIdx.x % kLanes;
  const long long rows = (long long)X * Y;
  const long long nwarps = (long long)gridDim.x * kWarps;
  for (long long r = (long long)blockIdx.x * kWarps + threadIdx.x / kLanes;
       r < rows; r += nwarps) {
    const int x = (int)(r / Y), y = (int)(r % Y);
    for (int z = lane; z < Z; z += kLanes) {
      const long long i = r * Z + z;
      const float xm = x > 0 ? src[i - yz] : 0.f;
      const float xp = x < X - 1 ? src[i + yz] : 0.f;
      const float ym = y > 0 ? src[i - Z] : 0.f;
      const float yp = y < Y - 1 ? src[i + Z] : 0.f;
      const float zm = z > 0 ? src[i - 1] : 0.f;
      const float zp = z < Z - 1 ? src[i + 1] : 0.f;
      const float v = leapfrog(xm, xp, ym, yp, zm, zp, old[i]);
      if (copy) copy[i] = src[i];
      dst[i] = v;
    }
  }
}

__device__ void streamed_run(const float* __restrict__ cur_in,
                             const float* __restrict__ prev_in, float* out_a,
                             float* out_b, int X, int Y, int Z, int K) {
  cg::grid_group grid = cg::this_grid();
  // sub-step 0: out_b = leapfrog(cur_in) - prev_in, out_a = cur_in
  streamed_substep(cur_in, prev_in, out_b, out_a, X, Y, Z);
  for (int s = 1; s < K; ++s) {
    grid.sync();  // every node of the last sub-step is written
    if (s & 1)
      streamed_substep(out_b, out_a, out_a, nullptr, X, Y, Z);
    else
      streamed_substep(out_a, out_b, out_b, nullptr, X, Y, Z);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
probe_resident_kernel(const float* __restrict__ cur_in,
                      const float* __restrict__ prev_in, float* out_a,
                      float* out_b, float* faces, int X, int Y, int Z, int tx,
                      int ty, int tz, int K, int resident) {
  if (resident)
    resident_run(cur_in, prev_in, out_a, out_b, faces, X, Y, Z, tx, ty, tz,
                 K);
  else
    streamed_run(cur_in, prev_in, out_a, out_b, X, Y, Z, K);
}

}  // namespace

extern "C" {

// One cooperative launch of `ctas` CTAs of 1024 threads running K
// sub-steps.  resident != 0: CTA t holds tile t of the (tx, ty, tz) tiling
// in 2 * tx * ty * tz * 4 B of dynamic shared memory, and `faces` holds
// 2 * ctas * 6 * max(ty*tz, tx*tz, tx*ty) floats; resident == 0: the tile
// arguments and `faces` are unused.  Returns the CUDA error code of the
// launch (0 on success); a grid that cannot be resident at once is refused
// (cudaErrorCooperativeLaunchTooLarge).  Launches on `stream`, does not
// synchronise and allocates nothing.
int wv_probe_resident_f32(const float* cur, const float* prev, float* out_a,
                          float* out_b, float* faces, int X, int Y, int Z,
                          int tx, int ty, int tz, int K, int resident,
                          int ctas, void* stream) {
  const size_t smem =
      resident ? 2ull * tx * ty * tz * sizeof(float) : 0ull;
  if (smem > 48 * 1024) {  // past 48 KB only by opting in, per device
    cudaError_t e = cudaFuncSetAttribute(
        probe_resident_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  void* args[] = {&cur, &prev, &out_a, &out_b, &faces, &X, &Y,
                  &Z,   &tx,   &ty,    &tz,    &K,     &resident};
  cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(probe_resident_kernel), dim3(ctas),
      dim3(kThreads), args, smem, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
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

const char* wv_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
