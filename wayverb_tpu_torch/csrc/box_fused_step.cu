// Fused shoebox waveguide step, CUDA C++ for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_fwd_kernel` of
// wayverb_tpu/waveguide/box_fused.py.  It computes exactly what that
// module's reference `_jnp_forward` computes, and what the port's plain
// version `_fused_step_plain` (wayverb_tpu_torch/waveguide/box_fused.py)
// computes, for one leapfrog step of the shoebox field:
//
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
// Every output element has exactly one writer, so the kernel needs no
// synchronisation.  The TPU kernel's XT=8 rolling window and scalar
// prefetch are not carried over: here one thread computes one node.
//
// What bounds it on the card: device memory.  Per node a step must read
// cur and prev and write next, 12 B/node in float32.  At 12.8 M nodes
// (224 x 224 x 256) that is about 154 MB per step, about 46 us at the
// H100's 3.35 TB/s.  threadIdx.x runs along z, the contiguous axis, so a
// warp's loads and stores coalesce; the six neighbour reads of cur are
// served mostly from L1/L2, because neighbouring threads and blocks read
// the same lines.  No shared-memory tiling yet: a simple, correct form
// first.
//
// The arithmetic keeps the plain version's order (neighbour sum x-, x+,
// y-, y+, z-, z+, then the halo; an explicitly rounded multiply so the
// compiler cannot contract it into an FMA), so the two agree to the bit.

#include <cuda_runtime.h>

namespace {

constexpr int kBlockZ = 128;  // threads along z (contiguous axis)
constexpr int kBlockY = 2;    // threads along y

struct Args {
  const float* cur;
  const float* prev;
  float* next;
  const float* hlo;       // (Y, Z) halo row at local x = -1, or null
  const float* hhi;       // (Y, Z) halo row at local x = X, or null
  const float* plane[6];  // xlo, xhi (Y, Z); ylo, yhi (X, Z); zlo, zhi (X, Y)
  long long plane_stride[6];  // row stride of each plane, in elements
  float* inner[6];        // contiguous, same shapes as the planes
  const float* inj_val;   // (2,): v_now, v_prev; read only when src >= 0
  long long src;          // local flat index of the source node, or -1
  int mode;               // 1 set, 2 add
  int X, Y, Z;
  int x_off;              // global x of local row 0
  int ilo0, ihi0, ilo1, ihi1, ilo2, ihi2;  // first/last inside node per axis
  int xin_lo, xin_hi;     // local rows of the two inner x planes (clamped)
};

__device__ __forceinline__ float plane_at(const Args& a, int p, int u, int v) {
  return a.plane[p][(long long)u * a.plane_stride[p] + v];
}

__global__ void __launch_bounds__(kBlockZ * kBlockY)
box_fused_step_kernel(const Args a) {
  const int z = blockIdx.x * kBlockZ + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  const int x = blockIdx.z;
  if (z >= a.Z || y >= a.Y) return;
  const long long yz_size = (long long)a.Y * a.Z;
  const long long yz = (long long)y * a.Z + z;
  const long long i = x * yz_size + yz;
  const int gx = a.x_off + x;

  float v_now = 0.f, v_prev = 0.f;
  if (a.src >= 0) {
    v_now = a.inj_val[0];
    v_prev = a.inj_val[1];
  }
  auto cur_at = [&](long long j) {
    const float c = a.cur[j];
    if (j != a.src) return c;
    return a.mode == 1 ? v_now : c + v_now;
  };

  const bool inside = gx >= a.ilo0 && gx <= a.ihi0 && y >= a.ilo1 &&
                      y <= a.ihi1 && z >= a.ilo2 && z <= a.ihi2;
  float res = 0.f;
  if (inside) {
    float acc = 0.f;
    acc += x > 0 ? cur_at(i - yz_size) : 0.f;
    acc += x < a.X - 1 ? cur_at(i + yz_size) : 0.f;
    acc += y > 0 ? cur_at(i - a.Z) : 0.f;
    acc += y < a.Y - 1 ? cur_at(i + a.Z) : 0.f;
    acc += z > 0 ? cur_at(i - 1) : 0.f;
    acc += z < a.Z - 1 ? cur_at(i + 1) : 0.f;
    if (x == 0 && a.hlo) acc += a.hlo[yz];
    if (x == a.X - 1 && a.hhi) acc += a.hhi[yz];
    float p = a.prev[i];
    if (i == a.src) p = a.mode == 1 ? v_prev : p + v_prev;
    res = __fmul_rn(1.0f / 3.0f, acc) - p;
  }

  // splice precedence: y < z < x (the last test that matches wins)
  if (y == a.ilo1 - 1) res = plane_at(a, 2, x, z);
  if (y == a.ihi1 + 1) res = plane_at(a, 3, x, z);
  if (z == a.ilo2 - 1) res = plane_at(a, 4, x, y);
  if (z == a.ihi2 + 1) res = plane_at(a, 5, x, y);
  if (gx == a.ilo0 - 1) res = plane_at(a, 0, y, z);
  if (gx == a.ihi0 + 1) res = plane_at(a, 1, y, z);
  a.next[i] = res;

  if (x == a.xin_lo) a.inner[0][yz] = res;
  if (x == a.xin_hi) a.inner[1][yz] = res;
  if (y == a.ilo1) a.inner[2][(long long)x * a.Z + z] = res;
  if (y == a.ihi1) a.inner[3][(long long)x * a.Z + z] = res;
  if (z == a.ilo2) a.inner[4][(long long)x * a.Y + y] = res;
  if (z == a.ihi2) a.inner[5][(long long)x * a.Y + y] = res;
}

}  // namespace

extern "C" {

// shape_geom: X, Y, Z, x_off, ilo0, ihi0, ilo1, ihi1, ilo2, ihi2.
// Returns the CUDA error code of the launch (0 on success).  Launches on
// `stream` and does not synchronise; allocates nothing.
int wv_box_fused_step_f32(const float* cur, const float* prev, float* next,
                          const float* hlo, const float* hhi,
                          const float* const* planes,
                          const long long* plane_strides,
                          float* const* inner, const int* shape_geom,
                          long long src, int mode, const float* inj_val,
                          void* stream) {
  Args a;
  a.cur = cur;
  a.prev = prev;
  a.next = next;
  a.hlo = hlo;
  a.hhi = hhi;
  for (int p = 0; p < 6; ++p) {
    a.plane[p] = planes[p];
    a.plane_stride[p] = plane_strides[p];
    a.inner[p] = inner[p];
  }
  a.inj_val = inj_val;
  a.src = src;
  a.mode = mode;
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

  const dim3 block(kBlockZ, kBlockY, 1);
  const dim3 grid((a.Z + kBlockZ - 1) / kBlockZ, (a.Y + kBlockY - 1) / kBlockY,
                  a.X);
  box_fused_step_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

const char* wv_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
