// Shared device code of the general-mesh stencil kernels
// (mesh_weighted_step.cu, mesh_interior_step.cu; the x-walks of
// mesh_adjoint.cuh and mesh_step_walk.cuh take mesh_weight from here).
//
// One thread computes one node of an (X, Y, Z) grid, z fastest: threadIdx.x
// runs along z, the contiguous axis, so a warp's loads and stores coalesce
// and the six neighbour reads are served mostly from L1/L2 (neighbouring
// threads and blocks read the same lines).  Off-grid neighbours read as 0.
//
// Direction order d = 0..5 <-> (-x, +x, -y, +y, -z, +z), the order of
// descriptor.DIRECTION_OFFSETS.  The packed per-node weight code holds bit d
// when neighbour d has weight >= 1, bit 6 + d when it has weight 2, and bit
// 12 on interior and reentrant nodes (the subtract-previous term).

#pragma once

#include <cuda_runtime.h>

namespace wv {

constexpr int kMeshBlockZ = 128;  // threads along z (contiguous axis)
constexpr int kMeshBlockY = 2;    // threads along y

struct MeshNode {
  int x, y, z;
  long long i;    // flat index
  long long nb[6];  // flat index of neighbour d, or -1 beyond the grid
};

// The node of this thread, or false when the thread lies beyond the grid.
__device__ __forceinline__ bool mesh_node(int X, int Y, int Z, MeshNode& n) {
  n.z = blockIdx.x * kMeshBlockZ + threadIdx.x;
  n.y = blockIdx.y * kMeshBlockY + threadIdx.y;
  n.x = blockIdx.z;
  if (n.z >= Z || n.y >= Y) return false;
  const long long yz_size = (long long)Y * Z;
  n.i = n.x * yz_size + (long long)n.y * Z + n.z;
  n.nb[0] = n.x > 0 ? n.i - yz_size : -1;
  n.nb[1] = n.x < X - 1 ? n.i + yz_size : -1;
  n.nb[2] = n.y > 0 ? n.i - Z : -1;
  n.nb[3] = n.y < Y - 1 ? n.i + Z : -1;
  n.nb[4] = n.z > 0 ? n.i - 1 : -1;
  n.nb[5] = n.z < Z - 1 ? n.i + 1 : -1;
  return true;
}

// w_d in {0, 1, 2}: bit(d) + bit(6 + d) of the weight code.
__device__ __forceinline__ float mesh_weight(int code, int d) {
  return (float)(((code >> d) & 1) + ((code >> (6 + d)) & 1));
}

inline dim3 mesh_grid(int X, int Y, int Z) {
  return dim3((Z + kMeshBlockZ - 1) / kMeshBlockZ,
              (Y + kMeshBlockY - 1) / kMeshBlockY, X);
}

inline dim3 mesh_block() { return dim3(kMeshBlockZ, kMeshBlockY, 1); }

}  // namespace wv
