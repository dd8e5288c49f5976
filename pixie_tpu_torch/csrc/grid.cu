// The grid stage for NVIDIA Hopper (sm_90a): momentum to velocity, gravity,
// damping and every grid BC of the substep, in one pass over the grid (B8).
//
// Replaces no TPU kernel: the JAX package's grid stage (pixie_tpu/sim/
// solver.py grid_update and the BCs' apply) is plain jnp, which XLA fuses.
// The port's plain version (sim/solver.py grid_momentum_to_velocity and
// apply_grid_bcs) runs eagerly: ~14 PyTorch kernels a substep over the whole
// grid, each reading and writing up to 21 MB at n_grid 120 (a torch.stack
// for dt*g, divisions, torch.where, the collider's product and sum).  Plain
// C interface, loaded with ctypes (pixie_tpu_torch/ops/grid.py); the
// launcher takes PyTorch's current stream, never synchronizes, allocates
// nothing and returns cudaGetLastError().
//
// What it computes, for each node, is what the plain version computes, term
// for term and rounded as it rounds: v = p / max(m, 1e-15) (an IEEE
// division); + dt*g per component where the host found dt*g non-zero; v = 0
// where m <= 1e-15; v *= damping where damping < 1; then the table's BCs in
// its order.  The node's position is float(i) * dx, as node_positions builds
// it, so no position array is read.  The table (at most kMaxBCs entries,
// passed by value) holds the BCs active at the substep's time, resolved on
// the host: a half-space collider (zeroing, slip, frictional, cut), a
// cuboid's velocity at its point at t, a cuboid's reset (zero the node) and
// the bounding box.  Products and sums use __fmul_rn / __fadd_rn, so nothing
// contracts to a multiply-add where the plain version rounds each op, and
// every sum over a node's three components (the collider's signed
// distance, the velocity's normal component, the squared norm) adds its
// terms as PyTorch's CUDA reduction over a last dimension of 3 adds them:
// (t0 + t2) + t1 (ATen/native/cuda/Reduce.cuh: two lanes, the first holding
// elements 0 and 2).  A longer list of BCs runs the kernel again on its
// output, table after table, in place.
//
// Bound, per node: the (p, m) row read (16 B) and the velocity written
// (12 B): 28 B, 48.4 MB at n_grid 120, 14.4 us at 3.35 TB/s.  The arithmetic
// is a division and a few dozen flops a node.  Design: one thread a node,
// 256 a block, one 16-byte load of the row and no intermediate in device
// memory; the block's velocity rows leave through shared memory as 16-byte
// coalesced stores.  Every branch on the table, on dt*g and on damping is
// uniform across the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBCs = 16;  // ops/grid.py TABLE_CAPACITY
constexpr int kValues = 10;  // floats of an entry: a[3], b[3], c[3], friction

// entry kinds, as ops/grid.py names them
enum Kind : int {
  kHalfspaceZero = 0,      // a point, b unit normal: v = 0 below the plane
  kHalfspaceSlip = 1,      // remove the normal component below the plane
  kHalfspaceFriction = 2,  // remove the inward component, scale by friction
  kHalfspaceCut = 3,       // zero v_y and scale by 0.3 inside the z slab, zero outside it
  kBoxSet = 4,             // a the point at t, b half size, c velocity: v = c inside
  kZeroAll = 5,            // a cuboid's reset: v = 0 everywhere
  kBoundingBox = 6,        // outward components zeroed within 3 cells of a face
};

struct Entry {
  int kind;
  float a[3], b[3], c[3];
  float friction;
};

struct Table {
  int count;
  Entry e[kMaxBCs];
};

struct Stage {
  int n_grid;
  int convert;  // src is the (G^3, 4) momentum grid; else the (G^3, 3) velocity
  float dx, inv_dx;
  int add_g;
  float dtg[3];
  int damp;
  float damping;
};

constexpr float kMassEps = 1e-15f;
constexpr float kLenEps = 1e-20f;

// x n0 + y n1 + z n2 summed as PyTorch's CUDA .sum(-1) sums it
__device__ __forceinline__ float sum3(float t0, float t1, float t2) {
  return __fadd_rn(__fadd_rn(t0, t2), t1);
}

__device__ __forceinline__ float dot3(float x, float y, float z, const float* n) {
  return sum3(__fmul_rn(x, n[0]), __fmul_rn(y, n[1]), __fmul_rn(z, n[2]));
}

__device__ __forceinline__ void halfspace(const Entry& e, const float* p, float* v) {
  if (!(dot3(__fsub_rn(p[0], e.a[0]), __fsub_rn(p[1], e.a[1]), __fsub_rn(p[2], e.a[2]), e.b)
        < 0.f))
    return;
  if (e.kind == kHalfspaceZero) {
    v[0] = v[1] = v[2] = 0.f;
  } else if (e.kind == kHalfspaceCut) {
    if (p[2] < 0.4f || p[2] > 0.53f) {
      v[0] = v[1] = v[2] = 0.f;
    } else {
      v[0] = __fmul_rn(v[0], 0.3f);
      v[1] = 0.f;
      v[2] = __fmul_rn(v[2], 0.3f);
    }
  } else {
    const float nc = dot3(v[0], v[1], v[2], e.b);
    // slip removes the whole normal component, friction the inward part
    const float s = (e.kind == kHalfspaceSlip || !(nc > 0.f)) ? nc : 0.f;
    float q[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) q[a] = __fsub_rn(v[a], __fmul_rn(s, e.b[a]));
    const float len =
        __fsqrt_rn(sum3(__fmul_rn(q[0], q[0]), __fmul_rn(q[1], q[1]), __fmul_rn(q[2], q[2])));
    if (nc < 0.f && len > kLenEps) {
      float scale = __fadd_rn(len, __fmul_rn(nc, e.friction));
      scale = scale < 0.f ? 0.f : scale;
      const float den = len < kLenEps ? kLenEps : len;
#pragma unroll
      for (int a = 0; a < 3; ++a) v[a] = __fdiv_rn(__fmul_rn(scale, q[a]), den);
    } else {
#pragma unroll
      for (int a = 0; a < 3; ++a) v[a] = q[a];
    }
  }
}

__device__ __forceinline__ void apply(const Entry& e, const float* p, int n_grid, float inv_dx,
                                      float* v) {
  switch (e.kind) {
    case kBoxSet:
      if (fabsf(__fsub_rn(p[0], e.a[0])) < e.b[0] && fabsf(__fsub_rn(p[1], e.a[1])) < e.b[1] &&
          fabsf(__fsub_rn(p[2], e.a[2])) < e.b[2]) {
        v[0] = e.c[0];
        v[1] = e.c[1];
        v[2] = e.c[2];
      }
      break;
    case kZeroAll:
      v[0] = v[1] = v[2] = 0.f;
      break;
    case kBoundingBox:
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const int idx = __float2int_rn(__fmul_rn(p[a], inv_dx));  // torch.round: half to even
        if (idx < 3 && v[a] < 0.f) v[a] = 0.f;
        if (idx >= n_grid - 3 && v[a] > 0.f) v[a] = 0.f;
      }
      break;
    default:
      halfspace(e, p, v);
  }
}

// count floats from src to dst, the block's threads on neighbouring
// addresses: 16 bytes a thread where both ends are 16-byte aligned
__device__ __forceinline__ void block_copy(float* dst, const float* src, int count) {
  int done = 0;
  if (((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) & 15) == 0) {
    const int n4 = count >> 2;
    for (int i = threadIdx.x; i < n4; i += kThreads)
      reinterpret_cast<float4*>(dst)[i] = reinterpret_cast<const float4*>(src)[i];
    done = n4 << 2;
  }
  for (int i = done + threadIdx.x; i < count; i += kThreads) dst[i] = src[i];
}

// dst may be src (a table after the first runs in place): each block reads
// its own nodes before it writes them
__global__ void __launch_bounds__(kThreads)
grid_stage_kernel(const float* src, float* dst, int n_nodes, const __grid_constant__ Stage s,
                  const __grid_constant__ Table t) {
  __shared__ __align__(16) float s_v[kThreads * 3];
  const int first = blockIdx.x * kThreads;  // < n_nodes: no overflow
  const int node = first + threadIdx.x;
  if (node < n_nodes) {
    float v[3];
    if (s.convert) {
      const float4 g = reinterpret_cast<const float4*>(src)[node];
      const float m = g.w < kMassEps ? kMassEps : g.w;
      v[0] = __fdiv_rn(g.x, m);
      v[1] = __fdiv_rn(g.y, m);
      v[2] = __fdiv_rn(g.z, m);
      if (s.add_g) {
#pragma unroll
        for (int a = 0; a < 3; ++a) v[a] = __fadd_rn(v[a], s.dtg[a]);
      }
      if (!(g.w > kMassEps)) v[0] = v[1] = v[2] = 0.f;
      if (s.damp) {
#pragma unroll
        for (int a = 0; a < 3; ++a) v[a] = __fmul_rn(v[a], s.damping);
      }
    } else {
#pragma unroll
      for (int a = 0; a < 3; ++a) v[a] = src[3 * node + a];
    }
    if (t.count > 0) {
      const int g2 = s.n_grid * s.n_grid;
      const int i = node / g2, j = (node - i * g2) / s.n_grid, k = node - i * g2 - j * s.n_grid;
      const float p[3] = {__fmul_rn(static_cast<float>(i), s.dx),
                          __fmul_rn(static_cast<float>(j), s.dx),
                          __fmul_rn(static_cast<float>(k), s.dx)};
      for (int e = 0; e < t.count; ++e) apply(t.e[e], p, s.n_grid, s.inv_dx, v);
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) s_v[3 * threadIdx.x + a] = v[a];
  }
  __syncthreads();
  block_copy(dst + 3 * static_cast<int64_t>(first), s_v, 3 * min(kThreads, n_nodes - first));
}

}  // namespace

extern "C" {

int pixie_grid_stage(const float* src, float* dst, int n_grid, int convert, float dx,
                     float inv_dx, int add_g, float dtg_x, float dtg_y, float dtg_z, int damp,
                     float damping, int count, const int32_t* kinds, const float* values,
                     void* stream) {
  if (count < 0 || count > kMaxBCs) return static_cast<int>(cudaErrorInvalidValue);
  const Stage s{n_grid, convert, dx, inv_dx, add_g, {dtg_x, dtg_y, dtg_z}, damp, damping};
  Table t{};
  t.count = count;
  for (int e = 0; e < count; ++e) {
    const float* v = values + kValues * e;
    t.e[e].kind = kinds[e];
    for (int a = 0; a < 3; ++a) {
      t.e[e].a[a] = v[a];
      t.e[e].b[a] = v[3 + a];
      t.e[e].c[a] = v[6 + a];
    }
    t.e[e].friction = v[9];
  }
  const int n_nodes = n_grid * n_grid * n_grid;
  if (n_nodes > 0) {
    const int blocks = (n_nodes + kThreads - 1) / kThreads;
    grid_stage_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        src, dst, n_nodes, s, t);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* pixie_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
