// MLS-MPM particle<->grid transfers for NVIDIA Hopper (sm_90a).
//
// Plain C interface, loaded from Python with ctypes
// (pixie_tpu_torch/ops/transfer.py).  Every launcher takes PyTorch's current
// stream, never synchronizes, allocates nothing and returns
// cudaGetLastError() so the wrapper can raise on a refused launch.
//
// The arithmetic follows pixie_tpu/sim/solver.py (p2g :60-128, g2p :171-220)
// term for term.  The B-spline stencil (spline_weights) is shared with
// the fused substep, and the per-node splat math (p2g_nodes) with the P2G
// ablation probe (probe_ablation.cu), through mpm.cuh.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mpm.cuh"

namespace {

constexpr int kThreads = 256;

using pixie::Spline;
using pixie::spline_weights;

// ---------------------------------------------------------------------------
// P2G.  Replaces pixie_tpu/ops/transfer.py:p2g_tiled_t (_p2g_kernel_t), and
// with it the AoS variant p2g_tiled (_p2g_kernel): the quadratic B-spline
// APIC splat of mass, m(v + C dpos) and -vol dt sigma grad(w) onto the 27
// nodes around each particle, into a zeroed (G^3, 4) grid; out-of-grid
// nodes are dropped (solver.py:112-118).
//
// Bound: the work is 108 float adds a particle into a 2 MB grid (n_grid
// 50) that stays in the 50 MB L2, so neither DRAM nor the arithmetic
// bounds it.  The one-thread-per-particle splat (mpm.cuh p2g_particle, the
// P1 probe's `full`) spent 95 % of its time in its 108 global atomics a
// particle (0.2143 of 0.2259 ms at 100k particles, NVIDIA H100 80GB HBM3,
// 700 W), and sorting the particles by cell made it 22 % slower: lanes of a
// warp then hit one address and the L2 serializes them.
//
// Design: cut the atomics, not the math.
//   1. p2g_keys_kernel gives each particle a bin key: its base cell in a
//      bin of kBin^3 base cells (base + 2, so the lowest base cell with an
//      in-grid node, -2, is bin coordinate 0), shifted left by hbits, and
//      in the low bits the cell within the bin above a multiplicative hash
//      of the particle index.  Inactive particles, and those whose stencil
//      reaches no in-grid node or whose position is not finite, get the
//      largest key and splat nothing.  The wrapper sorts the keys with
//      torch.sort, as JAX's resort sits outside its Pallas kernel; the
//      particle arrays are read through the permutation, never reordered.
//   2. p2g_binned_kernel: block b takes sorted positions [256 b, 256 b +
//      256), one particle a thread, so the lanes of a warp hold particles
//      of few cells, each cell's lanes adjacent.
//      Every lane computes its 27 nodes' values (mpm.cuh p2g_nodes, the
//      same math as the unbinned splat); each run of lanes that share a
//      base cell, and so all 27 nodes, sums them with 5 shuffles a value
//      (an inclusive segmented scan), and the run's last lane adds the sums
//      into the grid with one global atomic per (node, component), dropping
//      out-of-grid nodes.  The runs come from each lane's own base cell, so
//      the result does not depend on the order: the sort only makes runs
//      long.  At 6.4 particles a cell a warp spans ~6 cells, ~20 atomics a
//      particle; at 45 a cell ~4.
// The shared-memory tile of the first design did not pay on this card: a
// block adding its bin's particles into a tile of (kBin + 2)^3 nodes x 4
// floats and flushing it with one global atomic per nonzero value.  sm_90
// has no shared-memory float add: nvcc emits each as an ATOMS.CAST.SPIN
// compare-and-swap loop (cuobjdump -sass), where the global one is a single
// REDG.E.ADD.F32.  Device ms at 100k particles, each with its key kernel,
// torch.sort and memset, as chip_smoke.py timed them while they were kept
// (one run, NVIDIA H100 80GB HBM3, 700 W): a lane a
// particle into the tile 0.2416 / 0.2067 / 0.3087, runs into the tile
// 0.1389 / 0.1337 / 0.1236, runs into the grid (shipped) 0.1044 / 0.0994 /
// 0.0945, for the random state (6.4 a cell) / the same cell-sorted / P1's
// state (45 a cell), against the unbinned splat's 0.1569 / 0.1472 /
// 0.2258; torch.sort took 0.064 ms of each.  The tiles were then deleted.
// ---------------------------------------------------------------------------
constexpr int kBin = 4;                                  // base cells a bin side
constexpr int kCellBits = 6;                             // cells of a bin: kBin^3 = 64
constexpr uint32_t kHashMul = 2654435761u;               // Knuth's multiplicative hash
constexpr unsigned kFull = 0xffffffffu;

// keys: bin << hbits | low, low the cell within the bin above the top bits
// of a hash of the particle index
__global__ void p2g_keys_kernel(const float* __restrict__ x, const uint8_t* __restrict__ active,
                                int n, int n_grid, float inv_dx, int nb, int hbits,
                                int32_t* __restrict__ keys) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const int32_t none = (nb * nb * nb) << hbits;
  const float* xp = x + 3 * p;
  constexpr float kMax = 3.402823466e38f;  // |x| <= FLT_MAX: false for NaN and inf
  if (!active[p] || !(fabsf(xp[0]) <= kMax && fabsf(xp[1]) <= kMax && fabsf(xp[2]) <= kMax)) {
    keys[p] = none;
    return;
  }
  const Spline s = spline_weights(xp, inv_dx);  // the base cell p2g_nodes splats from
  int bin = 0, cell = 0;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    if (s.base[a] < -2 || s.base[a] > n_grid - 1) {  // no node of the stencil in the grid
      keys[p] = none;
      return;
    }
    bin = bin * nb + (s.base[a] + 2) / kBin;
    cell = cell * kBin + (s.base[a] + 2) % kBin;
  }
  const int hash_bits = hbits - kCellBits;
  uint32_t low = hash_bits > 0 ? (static_cast<uint32_t>(p) * kHashMul) >> (32 - hash_bits) : 0u;
  low |= static_cast<uint32_t>(cell) << hash_bits;
  keys[p] = (bin << hbits) | static_cast<int32_t>(low);
}

// flat index of the cell of base + 2, unique over the grid: the run label
__device__ __forceinline__ int base_cell(const float* xp, float inv_dx, int n_grid) {
  const Spline s = spline_weights(xp, inv_dx);
  const int side = n_grid + 2;
  return ((s.base[0] + 2) * side + (s.base[1] + 2)) * side + (s.base[2] + 2);
}

// Runs of equal labels among the warp's lanes (labels sorted, so equal ones
// are adjacent): the first lane of this lane's run, and whether it is the
// run's last lane.
struct Run {
  int first;
  bool last;
};

__device__ __forceinline__ Run lane_run(int label, int lane) {
  const int prev = __shfl_up_sync(kFull, label, 1);
  const int next = __shfl_down_sync(kFull, label, 1);
  const unsigned heads = __ballot_sync(kFull, lane == 0 || prev != label);
  return {31 - __clz(heads & (kFull >> (31 - lane))), lane == 31 || next != label};
}

// inclusive sum over the lanes of the run up to this one: the run's total
// at its last lane (5 shuffles)
__device__ __forceinline__ float run_sum(float v, int lane, int first) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(kFull, v, off);
    if (lane - off >= first) v += u;
  }
  return v;
}

__device__ __forceinline__ bool in_grid(int gi, int gj, int gk, int n_grid) {
  return gi >= 0 && gi < n_grid && gj >= 0 && gj < n_grid && gk >= 0 && gk < n_grid;
}

// sink of p2g_nodes<kP2GFull, true>: each node's four values summed over
// the lane's run, added into the grid by the run's last lane where the node
// is in the grid
struct RunSink {
  bool live;
  Run run;
  int lane, n_grid;
  float* grid;
  __device__ __forceinline__ void operator()(int gi, int gj, int gk, float mx, float my,
                                             float mz, float wm) const {
    const float s0 = run_sum(live ? mx : 0.0f, lane, run.first);
    const float s1 = run_sum(live ? my : 0.0f, lane, run.first);
    const float s2 = run_sum(live ? mz : 0.0f, lane, run.first);
    const float s3 = run_sum(live ? wm : 0.0f, lane, run.first);
    if (live && run.last && in_grid(gi, gj, gk, n_grid))
      pixie::atomic_add_node(grid, n_grid, gi, gj, gk, s0, s1, s2, s3);
  }
};

__global__ void __launch_bounds__(kThreads)
p2g_binned_kernel(const int32_t* __restrict__ keys, const int64_t* __restrict__ perm,
                  const float* __restrict__ x, const float* __restrict__ v,
                  const float* __restrict__ C, const float* __restrict__ stress,
                  const float* __restrict__ mass, const float* __restrict__ vol,
                  float* __restrict__ grid, int n, int n_grid, int nb, int hbits, float dx,
                  float inv_dx, float dt, float rpic_damping) {
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * kThreads + threadIdx.x;
  const int nbins = nb * nb * nb;
  const bool live = q < n && (keys[q] >> hbits) < nbins;
  if (!__any_sync(kFull, live)) return;
  const int p = live ? static_cast<int>(perm[q]) : 0;
  const Run run = lane_run(live ? base_cell(x + 3 * p, inv_dx, n_grid) : -1 - lane, lane);
  pixie::p2g_nodes<pixie::kP2GFull, true>(p, x, v, C, stress, mass, vol, n_grid, dx, inv_dx, dt,
                                          rpic_damping, RunSink{live, run, lane, n_grid, grid});
}

// ---------------------------------------------------------------------------
// G2P.  Replaces pixie_tpu/ops/transfer.py:g2p_tiled_t (_g2p_kernel_t), and
// with it the AoS variant g2p_tiled (_g2p_kernel): per particle the
// grid-velocity gather, APIC C (scaled by 4 inv_dx) and grad(v); fused with
// the glue of pixie_tpu/sim/solver.py:204-219 (advection,
// F_trial = (I + dt grad v) F, optional covariance transport), as the
// reference's own g2p kernel does (mpm_utils.py:412-463).
//
// Design: one thread per particle; 27 in-bounds-masked gathers of 3 floats
// from the (G^3, 3) velocity grid, results written in place for particles
// with selection == 0.
//
// Bound: per-particle memory traffic (x, v, C, F, F_trial: 30 floats in,
// 24 out) plus 81 gathered floats that hit L2 (the 1.5 MB velocity grid stays
// resident).  Neighbouring threads read neighbouring particles, so the
// particle streams coalesce poorly on the 3x3 rows only by a constant factor.
// Later work: cell-sorted particle order for gather locality.
// ---------------------------------------------------------------------------
__global__ void g2p_kernel(float* __restrict__ x,
                           float* __restrict__ v,
                           float* __restrict__ C,
                           const float* __restrict__ F,
                           float* __restrict__ F_trial,
                           float* __restrict__ cov,
                           const int32_t* __restrict__ selection,
                           const float* __restrict__ grid_v,
                           int n, int n_grid, float inv_dx, float dt,
                           int update_cov) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n || selection[p] != 0) return;

  const Spline s = spline_weights(x + 3 * p, inv_dx);

  float nv[3] = {0.f, 0.f, 0.f};
  float nc[9];
  float gv[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) { nc[k] = 0.f; gv[k] = 0.f; }

#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int gi = s.base[0] + i;
    if (gi < 0 || gi >= n_grid) continue;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int gj = s.base[1] + j;
      if (gj < 0 || gj >= n_grid) continue;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int gk = s.base[2] + k;
        if (gk < 0 || gk >= n_grid) continue;
        const float wx = s.w[0][i], wy = s.w[1][j], wz = s.w[2][k];
        const float weight = wx * wy * wz;
        const float dwt[3] = {s.dw[0][i] * wy * wz * inv_dx,
                              wx * s.dw[1][j] * wz * inv_dx,
                              wx * wy * s.dw[2][k] * inv_dx};
        const float dpos[3] = {static_cast<float>(i) - s.fx[0],
                               static_cast<float>(j) - s.fx[1],
                               static_cast<float>(k) - s.fx[2]};
        const float* node =
            grid_v + 3 * ((static_cast<int64_t>(gi) * n_grid + gj) * n_grid + gk);
        const float g[3] = {node[0], node[1], node[2]};
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          const float wg = weight * g[r];
          nv[r] += wg;
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            nc[3 * r + q] += wg * dpos[q];
            gv[3 * r + q] += g[r] * dwt[q];
          }
        }
      }
    }
  }

  const float c_scale = inv_dx * 4.0f;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    v[3 * p + r] = nv[r];
    x[3 * p + r] = x[3 * p + r] + dt * nv[r];
  }
#pragma unroll
  for (int k = 0; k < 9; ++k) C[9 * p + k] = nc[k] * c_scale;

  // F_trial = (I + dt grad_v) F
  float a[9];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int q = 0; q < 3; ++q)
      a[3 * r + q] = (r == q ? 1.0f : 0.0f) + gv[3 * r + q] * dt;
  const float* f = F + 9 * p;
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int q = 0; q < 3; ++q)
      F_trial[9 * p + 3 * r + q] =
          a[3 * r] * f[q] + a[3 * r + 1] * f[3 + q] + a[3 * r + 2] * f[6 + q];

  if (update_cov) {
    // cov += dt (grad_v cov + (grad_v cov)^T)  (update_cov, mpm_utils.py:316-335)
    float* c6 = cov + 6 * p;
    const float cm[9] = {c6[0], c6[1], c6[2], c6[1], c6[3], c6[4], c6[2], c6[4], c6[5]};
    float gc[9];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int q = 0; q < 3; ++q)
        gc[3 * r + q] = gv[3 * r] * cm[q] + gv[3 * r + 1] * cm[3 + q] +
                        gv[3 * r + 2] * cm[6 + q];
    c6[0] = cm[0] + dt * (gc[0] + gc[0]);
    c6[1] = cm[1] + dt * (gc[1] + gc[3]);
    c6[2] = cm[2] + dt * (gc[2] + gc[6]);
    c6[3] = cm[4] + dt * (gc[4] + gc[4]);
    c6[4] = cm[5] + dt * (gc[5] + gc[7]);
    c6[5] = cm[8] + dt * (gc[8] + gc[8]);
  }
}

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

extern "C" {

// bin keys (N,) int32 for p2g: nb bins a side, hbits low bits (the cell
// within the bin in their top 6)
int pixie_p2g_keys(const float* x, const uint8_t* active, int32_t* keys, int n, int n_grid,
                   float inv_dx, int nb, int hbits, void* stream) {
  if (n > 0) {
    p2g_keys_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        x, active, n, n_grid, inv_dx, nb, hbits, keys);
  }
  return static_cast<int>(cudaGetLastError());
}

// the splat, over the keys sorted ascending and their permutation (int64,
// as torch.sort returns it), into grid (G^3, 4) zeroed by the caller
int pixie_p2g(const int32_t* keys, const int64_t* perm, const float* x, const float* v,
              const float* C, const float* stress, const float* mass, const float* vol,
              float* grid, int n, int n_grid, int nb, int hbits, float dx, float inv_dx,
              float dt, float rpic_damping, void* stream) {
  if (n > 0) {
    p2g_binned_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        keys, perm, x, v, C, stress, mass, vol, grid, n, n_grid, nb, hbits, dx, inv_dx, dt,
        rpic_damping);
  }
  return static_cast<int>(cudaGetLastError());
}

int pixie_g2p(float* x, float* v, float* C, const float* F, float* F_trial,
              float* cov, const int32_t* selection, const float* grid_v, int n,
              int n_grid, float inv_dx, float dt, int update_cov, void* stream) {
  if (n > 0) {
    g2p_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        x, v, C, F, F_trial, cov, selection, grid_v, n, n_grid, inv_dx, dt,
        update_cov);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* pixie_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
