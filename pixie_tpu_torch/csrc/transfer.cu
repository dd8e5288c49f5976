// MLS-MPM particle<->grid transfers for NVIDIA Hopper (sm_90a).
//
// Plain C interface, loaded from Python with ctypes
// (pixie_tpu_torch/ops/transfer.py).  Every launcher takes PyTorch's current
// stream, never synchronizes, allocates nothing and returns
// cudaGetLastError() so the wrapper can raise on a refused launch.
//
// The arithmetic follows pixie_tpu/sim/solver.py (p2g :60-128, g2p :171-220)
// term for term.  grid_pos = x * inv_dx is rounded on its own
// (__fmul_rn) before the "- 0.5": a fused multiply-add there would move
// floorf() across cell boundaries relative to jnp.floor.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Spline {
  int base[3];
  float fx[3];
  float w[3][3];   // w[axis][offset]
  float dw[3][3];
};

__device__ __forceinline__ Spline spline_weights(const float* xp, float inv_dx) {
  Spline s;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float gp = __fmul_rn(xp[a], inv_dx);
    const float b = floorf(gp - 0.5f);
    const float f = gp - b;
    s.base[a] = static_cast<int>(b);
    s.fx[a] = f;
    const float wa = 1.5f - f, wb = f - 1.0f, wc = f - 0.5f;
    s.w[a][0] = 0.5f * wa * wa;
    s.w[a][1] = 0.75f - wb * wb;
    s.w[a][2] = 0.5f * wc * wc;
    s.dw[a][0] = f - 1.5f;
    s.dw[a][1] = -2.0f * (f - 1.0f);
    s.dw[a][2] = f - 0.5f;
  }
  return s;
}

// ---------------------------------------------------------------------------
// P2G.  Replaces pixie_tpu/ops/transfer.py:p2g_tiled_t (_p2g_kernel_t), and
// with it the AoS variant p2g_tiled (_p2g_kernel): the quadratic B-spline
// APIC splat of mass, m(v + C dpos) and -vol dt sigma grad(w) onto the 27
// nodes around each particle.
//
// Design: one thread per particle, 27 nodes x 4 float atomicAdds into a
// zeroed (G^3, 4) grid; out-of-grid nodes are dropped (solver.py:112-118).
// The TPU kernel's tile-sorted layout, one-hot window factors and MXU
// contractions existed because the TPU serializes scatters; Hopper has
// native global atomics, so none of that is carried over.
//
// Bound: atomic throughput and contention.  At 100k particles this is
// 10.8 M global float atomics a substep into a grid of 2 MB (n_grid 50) that
// stays resident in the 50 MB L2, so DRAM bandwidth is not the limit; the
// L2 atomic units are, and more so where many particles share a cell.
// Later work: sort particles by cell and pre-reduce in shared memory before
// the global atomics.
// ---------------------------------------------------------------------------
__global__ void p2g_kernel(const float* __restrict__ x,
                           const float* __restrict__ v,
                           const float* __restrict__ C,
                           const float* __restrict__ stress,
                           const float* __restrict__ mass,
                           const float* __restrict__ vol,
                           const uint8_t* __restrict__ active,
                           float* __restrict__ grid,
                           int n, int n_grid, float dx, float inv_dx, float dt,
                           float rpic_damping) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n || !active[p]) return;

  const Spline s = spline_weights(x + 3 * p, inv_dx);

  // RPIC / PIC damping of C (solver.py:73-80)
  float c[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) c[k] = C[9 * p + k];
  if (rpic_damping < -0.001f) {
#pragma unroll
    for (int k = 0; k < 9; ++k) c[k] = 0.0f;
  } else if (rpic_damping != 0.0f) {
    float d[9];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        d[3 * i + j] = (1.0f - rpic_damping) * c[3 * i + j] +
                       rpic_damping / 2.0f * (c[3 * i + j] - c[3 * j + i]);
#pragma unroll
    for (int k = 0; k < 9; ++k) c[k] = d[k];
  }

  const float m = mass[p];
  const float nvol = -vol[p];
  float sc[9];  // -vol * stress * dt
#pragma unroll
  for (int k = 0; k < 9; ++k) sc[k] = nvol * stress[9 * p + k] * dt;
  const float vx = v[3 * p], vy = v[3 * p + 1], vz = v[3 * p + 2];

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
        const float g0 = s.dw[0][i] * wy * wz * inv_dx;
        const float g1 = wx * s.dw[1][j] * wz * inv_dx;
        const float g2 = wx * wy * s.dw[2][k] * inv_dx;
        const float d0 = (static_cast<float>(i) - s.fx[0]) * dx;
        const float d1 = (static_cast<float>(j) - s.fx[1]) * dx;
        const float d2 = (static_cast<float>(k) - s.fx[2]) * dx;
        const float ax = vx + (c[0] * d0 + c[1] * d1 + c[2] * d2);
        const float ay = vy + (c[3] * d0 + c[4] * d1 + c[5] * d2);
        const float az = vz + (c[6] * d0 + c[7] * d1 + c[8] * d2);
        const float mx = weight * (m * ax) + (sc[0] * g0 + sc[1] * g1 + sc[2] * g2);
        const float my = weight * (m * ay) + (sc[3] * g0 + sc[4] * g1 + sc[5] * g2);
        const float mz = weight * (m * az) + (sc[6] * g0 + sc[7] * g1 + sc[8] * g2);
        float* node = grid + 4 * ((static_cast<int64_t>(gi) * n_grid + gj) * n_grid + gk);
        atomicAdd(node + 0, mx);
        atomicAdd(node + 1, my);
        atomicAdd(node + 2, mz);
        atomicAdd(node + 3, weight * m);
      }
    }
  }
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

int pixie_p2g(const float* x, const float* v, const float* C, const float* stress,
              const float* mass, const float* vol, const uint8_t* active,
              float* grid, int n, int n_grid, float dx, float inv_dx, float dt,
              float rpic_damping, void* stream) {
  if (n > 0) {
    p2g_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        x, v, C, stress, mass, vol, active, grid, n, n_grid, dx, inv_dx, dt,
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
