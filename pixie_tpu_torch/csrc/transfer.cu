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
  const pixie::Run run = pixie::lane_run(
      live ? pixie::cell_label(spline_weights(x + 3 * p, inv_dx), n_grid) : -1 - lane, lane);
  pixie::p2g_nodes<pixie::kP2GFull, true>(p, x, v, C, stress, mass, vol, n_grid, dx, inv_dx, dt,
                                          rpic_damping,
                                          pixie::RunSink{live, run, lane, n_grid, grid});
}

// ---------------------------------------------------------------------------
// G2P.  Replaces pixie_tpu/ops/transfer.py:g2p_tiled_t (_g2p_kernel_t), and
// with it the AoS variant g2p_tiled (_g2p_kernel): per particle the
// grid-velocity gather, APIC C (scaled by 4 inv_dx) and grad(v); fused with
// the glue of pixie_tpu/sim/solver.py:204-219 (advection,
// F_trial = (I + dt grad v) F, optional covariance transport), as the
// reference's own g2p kernel does (mpm_utils.py:412-463).  Particles with
// selection != 0 keep every field.
//
// Bound: per active particle 196 B of rows (x, F, cov in; x, v, C, F_trial,
// cov out) and 27 gathered nodes of the 1.5 MB velocity grid (n_grid 50),
// which stays in L2: ~6 us at 100k particles over the HBM rate.  The gather
// is what costs: 81 loads a particle.
//
// Design: lane q takes particle q, and the caller keeps its particles in a
// cell order (sim/solver.py permutes an unfused frame's state into P2G's
// order, as the fused frame does), the Hopper form of JAX's tile-sorted
// particle blocks.  The lanes of one cell then gather the same 27 nodes, so
// a warp's gather instruction touches the nodes of ~6 cells instead of up to
// 32 random ones.  Any order is exact; a random one is only slower.  The
// 12-, 24- and 36-byte rows of a warp's 32 consecutive particles are moved
// through a per-warp slice of shared memory, so each row array is read and
// written with lane-contiguous 4-byte accesses (a warp's 36-byte rows span 36
// sectors: written row by row, each of the 9 stores touches all of them).
// 128 threads a block: 782 blocks at 100k particles, ~6 a SM, where 256
// made about one uneven wave.  x(s+1) = x + dt v is rounded op by op, as the
// plain version rounds it, so the next substep's floor() sees the same
// position.
//
// Device ms at 100k particles, n_grid 50, phase 3's state in its given
// (random) order / sorted by cell / sorted, then 100 unfused substeps
// (mean runs of same-cell lanes 1.00 / 5.48 / 4.77), as chip_smoke.py timed
// the schedules while they were kept (one run, NVIDIA H100 80GB HBM3, 700 W):
// this kernel 0.0247 / 0.0198 / 0.0200; each lane reading and writing its
// own rows 0.0413 / 0.0280 / 0.0279; the block's box of nodes staged in
// shared memory where it fits (<= 1024 nodes), gathers from it 0.0276 /
// 0.0212 / 0.0213; lane q reading its particle through B1's sorted order of
// the same substep (rows where they lie) 0.0662 / 0.0332 / 0.0339.  The first
// kernel (256 threads, own rows, the caller's order) took 0.0593-0.0822 ms
// around the call.  The others were then deleted.
// ---------------------------------------------------------------------------
constexpr int kG2PThreads = 128;
constexpr int kG2PWarps = kG2PThreads / 32;
constexpr int kStage = 32 * 9;           // floats of a warp's staged rows

// rows [p0, p0 + count) of a (N, K) array, lane-contiguous, into the warp's
// stage; then row `lane` into val
template <int K>
__device__ __forceinline__ void load_rows(float* __restrict__ stage, const float* __restrict__ src,
                                          int p0, int count, int lane, float (&val)[K]) {
  const float* in = src + static_cast<int64_t>(p0) * K;
  __syncwarp();
  for (int e = lane; e < count * K; e += 32) stage[e] = in[e];
  __syncwarp();
#pragma unroll
  for (int k = 0; k < K; ++k) val[k] = stage[lane * K + k];
}

// val of every lane into the warp's stage, then rows [p0, p0 + count) of a
// (N, K) array written lane-contiguous, those of lanes not in `write` left
template <int K>
__device__ __forceinline__ void store_rows(float* __restrict__ stage, float* __restrict__ dst,
                                           int p0, int count, int lane, unsigned write,
                                           const float (&val)[K]) {
  float* out = dst + static_cast<int64_t>(p0) * K;
  __syncwarp();
#pragma unroll
  for (int k = 0; k < K; ++k) stage[lane * K + k] = val[k];
  __syncwarp();
  for (int e = lane; e < count * K; e += 32)
    if ((write >> (e / K)) & 1u) out[e] = stage[e];
}

// v, C (unscaled) and grad v of the 27 nodes around s, out-of-grid nodes
// skipped
__device__ __forceinline__ void gather_nodes(const Spline& s, int n_grid, float inv_dx,
                                             const float* __restrict__ grid_v, float (&nv)[3],
                                             float (&nc)[9], float (&gv)[9]) {
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
        const float gg[3] = {node[0], node[1], node[2]};
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          const float wg = weight * gg[r];
          nv[r] += wg;
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            nc[3 * r + q] += wg * dpos[q];
            gv[3 * r + q] += gg[r] * dwt[q];
          }
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kG2PThreads)
g2p_kernel(float* __restrict__ x, float* __restrict__ v, float* __restrict__ C,
           const float* __restrict__ F, float* __restrict__ F_trial, float* __restrict__ cov,
           const int32_t* __restrict__ selection, const float* __restrict__ grid_v, int n,
           int n_grid, float inv_dx, float dt, int update_cov) {
  __shared__ float s_stage[kG2PWarps * kStage];
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * kG2PThreads + threadIdx.x;
  const int p0 = p - lane;                       // the warp's first particle
  if (p0 >= n) return;
  const int count = min(32, n - p0);
  const bool live = p < n && selection[p] == 0;
  const unsigned write = __ballot_sync(kFull, live);
  float* stage = s_stage + (threadIdx.x >> 5) * kStage;

  float xp[3];
  load_rows<3>(stage, x, p0, count, lane, xp);
  const Spline s = spline_weights(xp, inv_dx);
  float nv[3] = {0.f, 0.f, 0.f}, nc[9], gv[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) nc[k] = gv[k] = 0.f;
  if (live) gather_nodes(s, n_grid, inv_dx, grid_v, nv, nc, gv);

  // advect, C, F_trial = (I + dt grad v) F, cov; the rows of lanes not live
  // are not written
  const float c_scale = inv_dx * 4.0f;
  float xn[3], cn[9], f[9], ft[9];
#pragma unroll
  for (int r = 0; r < 3; ++r) xn[r] = __fadd_rn(xp[r], __fmul_rn(dt, nv[r]));
#pragma unroll
  for (int k = 0; k < 9; ++k) cn[k] = nc[k] * c_scale;
  load_rows<9>(stage, F, p0, count, lane, f);
  float a[9];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) a[3 * r + c] = (r == c ? 1.0f : 0.0f) + gv[3 * r + c] * dt;
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      ft[3 * r + c] = a[3 * r] * f[c] + a[3 * r + 1] * f[3 + c] + a[3 * r + 2] * f[6 + c];
  store_rows<3>(stage, x, p0, count, lane, write, xn);
  store_rows<3>(stage, v, p0, count, lane, write, nv);
  store_rows<9>(stage, C, p0, count, lane, write, cn);
  store_rows<9>(stage, F_trial, p0, count, lane, write, ft);

  if (update_cov) {
    // cov += dt (grad_v cov + (grad_v cov)^T)  (update_cov, mpm_utils.py:316-335)
    float cm6[6], c6[6];
    load_rows<6>(stage, cov, p0, count, lane, cm6);
    const float cm[9] = {cm6[0], cm6[1], cm6[2], cm6[1], cm6[3], cm6[4], cm6[2], cm6[4], cm6[5]};
    float gc[9];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c)
        gc[3 * r + c] = gv[3 * r] * cm[c] + gv[3 * r + 1] * cm[3 + c] + gv[3 * r + 2] * cm[6 + c];
    c6[0] = cm[0] + dt * (gc[0] + gc[0]);
    c6[1] = cm[1] + dt * (gc[1] + gc[3]);
    c6[2] = cm[2] + dt * (gc[2] + gc[6]);
    c6[3] = cm[4] + dt * (gc[4] + gc[4]);
    c6[4] = cm[5] + dt * (gc[5] + gc[7]);
    c6[5] = cm[8] + dt * (gc[8] + gc[8]);
    store_rows<6>(stage, cov, p0, count, lane, write, c6);
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

int pixie_g2p(float* x, float* v, float* C, const float* F, float* F_trial, float* cov,
              const int32_t* selection, const float* grid_v, int n, int n_grid, float inv_dx,
              float dt, int update_cov, void* stream) {
  if (n > 0) {
    g2p_kernel<<<(n + kG2PThreads - 1) / kG2PThreads, kG2PThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(x, v, C, F, F_trial, cov, selection, grid_v,
                                                      n, n_grid, inv_dx, dt, update_cov);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* pixie_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
