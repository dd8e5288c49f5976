// Per-particle MLS-MPM device math shared by the transfer kernels
// (transfer.cu), the fused substep (fused_substep.cu), the constitutive pass
// (constitutive.cu) and the P2G ablation probe (probe_ablation.cu): the
// quadratic B-spline stencil, the P2G splat of one particle and the run sums
// of a warp's same-cell lanes, Warp's 3x3 SVD and the constitutive models.
//
// Every function is a term-for-term port of the package's PyTorch code, so
// the kernels compute what the plain versions compute:
//   spline_weights   ops/transfer.py:_spline_weights
//   splat_nodes,     ops/transfer.py:p2g_contributions (and the constant
//   p2g_nodes        weights of ops/probe_ablation.py's noweights)
//   p2g_binned_splat ops/transfer.py:p2g (B1's run-summed splat over the
//                    sorted bin keys; P1's full and noweights)
//   svd3             sim/svd3.py:svd3 (cyclic Jacobi on F^T F, sorting
//                    network, Gram-Schmidt with cross completion, Warp's
//                    sign convention; every threshold as written there)
//   return maps and  sim/constitutive.py (von Mises, snow with damage,
//   stresses         viscoplastic StVK, Drucker-Prager sand; FCR, StVK,
//                    Drucker-Prager and water Kirchhoff stresses)
//   constitutive_    sim/constitutive.py:compute_stress_from_F_trial, one
//   update           particle (B6's phase 3, and B7)
// 3x3 matrices are row-major float[9], as the (N, 3, 3) tensors store them.
// Every array index is a compile-time constant after unrolling, so the
// matrices live in registers.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace pixie {

// ---------------------------------------------------------------------------
// Quadratic B-spline stencil.  grid_pos = x * inv_dx is rounded on its own
// (__fmul_rn) before the "- 0.5": a fused multiply-add there would move
// floorf() across cell boundaries relative to the plain version.
// ---------------------------------------------------------------------------
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
// P2G of particle p: the APIC splat of mass, m (v + C dpos) and
// -vol dt sigma grad(w) onto the 27 nodes around it, with the RPIC / PIC
// damping of C; out-of-grid nodes are dropped (sim/solver.py:60-128).
// splat_nodes computes each in-grid node's contribution (with kAllNodes,
// every node's) from values in registers, p2g_nodes from particle p's
// arrays, and hands it to a sink, sink(gi, gj, gk, momentum x, y, z,
// mass): B1 and B6 sum it over a run of lanes first (RunSink).  The mode
// is the P1 probe's (probe_ablation.cu): kP2GFull is the splat itself;
// under kP2GNoWeights the per-node weight, weight gradient and APIC offset
// are the constant kAblate (offset kAblate dx, gradient kAblate inv_dx),
// the base cell still comes from x and every node still reaches the sink.
// kP2GNoAtomics and kP2GMinimal name the probe's other two variants, which
// change the sink (noatomics) or skip the node math (minimal).
// ---------------------------------------------------------------------------
enum P2GMode : int { kP2GFull = 0, kP2GNoWeights = 1, kP2GNoAtomics = 2, kP2GMinimal = 3 };
constexpr float kAblate = 0.1f;

// RPIC / PIC damping of C in place (solver.py:73-80)
__device__ __forceinline__ void damp_C(float (&c)[9], float rpic_damping) {
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
}

// the splat of one particle from registers: stencil s, velocity (vx, vy,
// vz), damped C c, mass m and sc = -vol dt stress; kAllNodes visits
// out-of-grid nodes too (the sink drops them), so that every lane of a warp
// calls the sink 27 times
template <int kMode, bool kAllNodes = false, class Sink>
__device__ __forceinline__ void splat_nodes(const Spline& s, float vx, float vy, float vz,
                                            const float (&c)[9], float m, const float (&sc)[9],
                                            int n_grid, float dx, float inv_dx, Sink&& sink) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int gi = s.base[0] + i;
    if (!kAllNodes && (gi < 0 || gi >= n_grid)) continue;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int gj = s.base[1] + j;
      if (!kAllNodes && (gj < 0 || gj >= n_grid)) continue;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int gk = s.base[2] + k;
        if (!kAllNodes && (gk < 0 || gk >= n_grid)) continue;
        float weight, g0, g1, g2, d0, d1, d2;
        if constexpr (kMode == kP2GNoWeights) {
          weight = kAblate;
          g0 = g1 = g2 = kAblate * inv_dx;
          d0 = d1 = d2 = kAblate * dx;
        } else {
          const float wx = s.w[0][i], wy = s.w[1][j], wz = s.w[2][k];
          weight = wx * wy * wz;
          g0 = s.dw[0][i] * wy * wz * inv_dx;
          g1 = wx * s.dw[1][j] * wz * inv_dx;
          g2 = wx * wy * s.dw[2][k] * inv_dx;
          d0 = (static_cast<float>(i) - s.fx[0]) * dx;
          d1 = (static_cast<float>(j) - s.fx[1]) * dx;
          d2 = (static_cast<float>(k) - s.fx[2]) * dx;
        }
        const float ax = vx + (c[0] * d0 + c[1] * d1 + c[2] * d2);
        const float ay = vy + (c[3] * d0 + c[4] * d1 + c[5] * d2);
        const float az = vz + (c[6] * d0 + c[7] * d1 + c[8] * d2);
        const float mx = weight * (m * ax) + (sc[0] * g0 + sc[1] * g1 + sc[2] * g2);
        const float my = weight * (m * ay) + (sc[3] * g0 + sc[4] * g1 + sc[5] * g2);
        const float mz = weight * (m * az) + (sc[6] * g0 + sc[7] * g1 + sc[8] * g2);
        sink(gi, gj, gk, mx, my, mz, weight * m);
      }
    }
  }
}

template <int kMode, bool kAllNodes = false, class Sink>
__device__ __forceinline__ void p2g_nodes(int p, const float* __restrict__ x,
                                          const float* __restrict__ v,
                                          const float* __restrict__ C,
                                          const float* __restrict__ stress,
                                          const float* __restrict__ mass,
                                          const float* __restrict__ vol, int n_grid, float dx,
                                          float inv_dx, float dt, float rpic_damping,
                                          Sink&& sink) {
  // kP2GNoWeights reads only s.base: the rest of the stencil is dead code
  const Spline s = spline_weights(x + 3 * p, inv_dx);
  float c[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) c[k] = C[9 * p + k];
  damp_C(c, rpic_damping);
  const float nvol = -vol[p];
  float sc[9];  // -vol * stress * dt
#pragma unroll
  for (int k = 0; k < 9; ++k) sc[k] = nvol * stress[9 * p + k] * dt;
  splat_nodes<kMode, kAllNodes>(s, v[3 * p], v[3 * p + 1], v[3 * p + 2], c, mass[p], sc, n_grid,
                                dx, inv_dx, sink);
}

// one float atomicAdd per component into the (G^3, 4) grid
__device__ __forceinline__ void atomic_add_node(float* __restrict__ grid, int n_grid, int gi,
                                                int gj, int gk, float mx, float my, float mz,
                                                float wm) {
  float* node = grid + 4 * ((static_cast<int64_t>(gi) * n_grid + gj) * n_grid + gk);
  atomicAdd(node + 0, mx);
  atomicAdd(node + 1, my);
  atomicAdd(node + 2, mz);
  atomicAdd(node + 3, wm);
}

// ---------------------------------------------------------------------------
// Run sums of a warp (B1's splat, and B6's): lanes that share a base cell
// share all 27 nodes, so each run of adjacent such lanes sums its values with
// shuffles and only its last lane adds them into the grid.  A run is formed
// from each lane's own cell, so the sum is exact in any order; an order that
// puts a cell's lanes side by side only makes the runs long.
// ---------------------------------------------------------------------------
constexpr unsigned kFullMask = 0xffffffffu;

// flat index of the cell of base + 2, unique over the bases whose stencil
// reaches the grid (-2 <= base <= n_grid - 1 on each axis): the run label
__device__ __forceinline__ int cell_label(const Spline& s, int n_grid) {
  const int side = n_grid + 2;
  return ((s.base[0] + 2) * side + (s.base[1] + 2)) * side + (s.base[2] + 2);
}

// whether the stencil of base cell s.base has a node in the grid
__device__ __forceinline__ bool stencil_in_grid(const Spline& s, int n_grid) {
  return s.base[0] >= -2 && s.base[0] <= n_grid - 1 && s.base[1] >= -2 &&
         s.base[1] <= n_grid - 1 && s.base[2] >= -2 && s.base[2] <= n_grid - 1;
}

// Runs of equal labels among adjacent lanes: the first lane of this lane's
// run, and whether it is the run's last lane.
struct Run {
  int first;
  bool last;
};

__device__ __forceinline__ Run lane_run(int label, int lane) {
  const int prev = __shfl_up_sync(kFullMask, label, 1);
  const int next = __shfl_down_sync(kFullMask, label, 1);
  const unsigned heads = __ballot_sync(kFullMask, lane == 0 || prev != label);
  return {31 - __clz(heads & (kFullMask >> (31 - lane))), lane == 31 || next != label};
}

// inclusive sum over the lanes of the run up to this one: the run's total
// at its last lane (5 shuffles)
__device__ __forceinline__ float run_sum(float v, int lane, int first) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(kFullMask, v, off);
    if (lane - off >= first) v += u;
  }
  return v;
}

__device__ __forceinline__ bool in_grid(int gi, int gj, int gk, int n_grid) {
  return gi >= 0 && gi < n_grid && gj >= 0 && gj < n_grid && gk >= 0 && gk < n_grid;
}

// sink of splat_nodes<kMode, true>: each node's four values summed over
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
      atomic_add_node(grid, n_grid, gi, gj, gk, s0, s1, s2, s3);
  }
};

// ---------------------------------------------------------------------------
// The binned splat of one lane (transfer.cu p2g_binned_kernel, and the P1
// probe's full and noweights): lane q of the launch takes sorted position q
// of the bin keys (transfer.cu p2g_keys_kernel, sorted by torch.sort); a
// lane is live if its key names a bin, and then splats particle perm[q].
// Each run of adjacent live lanes with one base cell sums its 27 nodes'
// values with shuffles, and the run's last lane adds the sums into the
// (G^3, 4) grid with one atomic per (in-grid node, component).  A warp with
// no live lane returns at once: its lanes call no shuffle.
// ---------------------------------------------------------------------------
__device__ __forceinline__ bool sorted_lane_live(const int32_t* __restrict__ keys, int q, int n,
                                                 int nbins, int hbits) {
  return q < n && (keys[q] >> hbits) < nbins;
}

// the run of lane q's particle p: its cell label where live, a label of its
// own where not
__device__ __forceinline__ Run sorted_lane_run(bool live, int p, const float* __restrict__ x,
                                               int lane, int n_grid, float inv_dx) {
  return lane_run(live ? cell_label(spline_weights(x + 3 * p, inv_dx), n_grid) : -1 - lane, lane);
}

template <int kMode>
__device__ __forceinline__ void p2g_binned_splat(
    const int32_t* __restrict__ keys, const int64_t* __restrict__ perm,
    const float* __restrict__ x, const float* __restrict__ v, const float* __restrict__ C,
    const float* __restrict__ stress, const float* __restrict__ mass,
    const float* __restrict__ vol, float* __restrict__ grid, int q, int n, int n_grid,
    int nbins, int hbits, float dx, float inv_dx, float dt, float rpic_damping) {
  const int lane = threadIdx.x & 31;
  const bool live = sorted_lane_live(keys, q, n, nbins, hbits);
  if (!__any_sync(kFullMask, live)) return;
  const int p = live ? static_cast<int>(perm[q]) : 0;
  const Run run = sorted_lane_run(live, p, x, lane, n_grid, inv_dx);
  p2g_nodes<kMode, true>(p, x, v, C, stress, mass, vol, n_grid, dx, inv_dx, dt, rpic_damping,
                         RunSink{live, run, lane, n_grid, grid});
}

// ---------------------------------------------------------------------------
// 3x3 helpers
// ---------------------------------------------------------------------------
__device__ __forceinline__ float det3(const float* m) {
  return m[0] * (m[4] * m[8] - m[5] * m[7]) - m[1] * (m[3] * m[8] - m[5] * m[6]) +
         m[2] * (m[3] * m[7] - m[4] * m[6]);
}

// out = a @ b^T
__device__ __forceinline__ void matmul_nt(const float* a, const float* b, float* out) {
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      out[3 * r + c] = a[3 * r] * b[3 * c] + a[3 * r + 1] * b[3 * c + 1] +
                       a[3 * r + 2] * b[3 * c + 2];
}

// out = U diag(s) V^T
__device__ __forceinline__ void diag_mm_nt(const float* u, const float* s, const float* v,
                                           float* out) {
  float us[9];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int k = 0; k < 3; ++k) us[3 * r + k] = u[3 * r + k] * s[k];
  matmul_nt(us, v, out);
}

__device__ __forceinline__ void cross3(const float* a, const float* b, float* out) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ __forceinline__ float norm3(const float* x) {
  return sqrtf(x[0] * x[0] + x[1] * x[1] + x[2] * x[2]);
}

__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

constexpr float kSvdEps = 1e-12f;

// x / max(|x|, 1e-12)
__device__ __forceinline__ void normalize3(const float* x, float* out) {
  const float n = fmaxf(norm3(x), kSvdEps);
#pragma unroll
  for (int a = 0; a < 3; ++a) out[a] = x[a] / n;
}

// ---------------------------------------------------------------------------
// svd3: f = U diag(sigma) V^T, U and V proper rotations, sigma descending,
// sigma[2] carrying sign(det f).
// ---------------------------------------------------------------------------

// stable symmetric Schur rotation (c, s) annihilating apq (svd3.py:43-54)
__device__ __forceinline__ void jacobi_rotation(float app, float aqq, float apq, float& c,
                                                float& s) {
  const bool trivial = fabsf(apq) < kSvdEps;
  const float safe_apq = trivial ? 1.0f : apq;
  const float tau = (aqq - app) / (2.0f * safe_apq);
  const float sgn = tau > 0.0f ? 1.0f : (tau < 0.0f ? -1.0f : tau);  // torch.sign
  float t = sgn / (fabsf(tau) + sqrtf(1.0f + tau * tau));
  if (tau == 0.0f) t = 1.0f;  // tau == 0 -> 45 degree rotation
  c = 1.0f / sqrtf(1.0f + t * t);
  s = t * c;
  if (trivial) {
    c = 1.0f;
    s = 0.0f;
  }
}

// (G^T S G, V G) for the Givens rotation G in the (P, Q) plane (svd3.py:57-73)
template <int P, int Q>
__device__ __forceinline__ void jacobi_step(float* S, float* V) {
  float c, sn;
  jacobi_rotation(S[3 * P + P], S[3 * Q + Q], S[3 * P + Q], c, sn);
#pragma unroll
  for (int r = 0; r < 3; ++r) {  // columns
    const float sp = S[3 * r + P], sq = S[3 * r + Q];
    S[3 * r + P] = c * sp - sn * sq;
    S[3 * r + Q] = sn * sp + c * sq;
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {  // rows
    const float rp = S[3 * P + k], rq = S[3 * Q + k];
    S[3 * P + k] = c * rp - sn * rq;
    S[3 * Q + k] = sn * rp + c * rq;
  }
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float vp = V[3 * r + P], vq = V[3 * r + Q];
    V[3 * r + P] = c * vp - sn * vq;
    V[3 * r + Q] = sn * vp + c * vq;
  }
}

// swap (wa, va) with (wb, vb) where wa < wb (svd3.py:111-115)
__device__ __forceinline__ void cswap(float& wa, float* va, float& wb, float* vb) {
  if (wa < wb) {
    const float tw = wa;
    wa = wb;
    wb = tw;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float t = va[a];
      va[a] = vb[a];
      vb[a] = t;
    }
  }
}

// Completes u0 with the unit vector of cross(u0, e_x), or of cross(u0, e_y)
// where the first is shorter than 1e-6.
__device__ __forceinline__ void cross_axis_alt(const float* u0, float* alt) {
  const float ex[3] = {1.0f, 0.0f, 0.0f}, ey[3] = {0.0f, 1.0f, 0.0f};
  cross3(u0, ex, alt);
  if (norm3(alt) < 1e-6f) cross3(u0, ey, alt);
}

__device__ __forceinline__ void svd3(const float* f, float* u, float* sigma, float* v) {
  // S = F^T F, V = I; 5 cyclic Jacobi sweeps (svd3.py:76-85)
  float S[9], V[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      S[3 * i + j] = f[i] * f[j] + f[3 + i] * f[3 + j] + f[6 + i] * f[6 + j];
      V[3 * i + j] = i == j ? 1.0f : 0.0f;
    }
#pragma unroll 1
  for (int sweep = 0; sweep < 5; ++sweep) {
    jacobi_step<0, 1>(S, V);
    jacobi_step<0, 2>(S, V);
    jacobi_step<1, 2>(S, V);
  }

  // sort eigenpairs descending
  float w0 = S[0], w1 = S[4], w2 = S[8];
  float v0[3] = {V[0], V[3], V[6]}, v1[3] = {V[1], V[4], V[7]}, v2[3] = {V[2], V[5], V[8]};
  cswap(w0, v0, w1, v1);
  cswap(w0, v0, w2, v2);
  cswap(w1, v1, w2, v2);

  // V as a proper rotation: Gram-Schmidt + cross completion (det V = +1)
  float t[3];
  normalize3(v0, t);
#pragma unroll
  for (int a = 0; a < 3; ++a) v0[a] = t[a];
  const float d01 = dot3(v1, v0);
#pragma unroll
  for (int a = 0; a < 3; ++a) v1[a] = v1[a] - d01 * v0[a];
  if (norm3(v1) < 1e-6f) {
    float alt[3];
    cross_axis_alt(v0, alt);
    normalize3(alt, v1);
  } else {
    normalize3(v1, t);
#pragma unroll
    for (int a = 0; a < 3; ++a) v1[a] = t[a];
  }
  cross3(v0, v1, v2);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    v[3 * a + 0] = v0[a];
    v[3 * a + 1] = v1[a];
    v[3 * a + 2] = v2[a];
  }

  const float s0 = sqrtf(fmaxf(w0, 0.0f)), s1 = sqrtf(fmaxf(w1, 0.0f)),
              s2 = sqrtf(fmaxf(w2, 0.0f));

  // U columns: normalize F v_i, orthogonal completion for tiny sigma
  float fv0[3], fv1[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    fv0[r] = f[3 * r] * v[0] + f[3 * r + 1] * v[3] + f[3 * r + 2] * v[6];
    fv1[r] = f[3 * r] * v[1] + f[3 * r + 1] * v[4] + f[3 * r + 2] * v[7];
  }
  float u0[3], u1[3], u2[3];
  normalize3(fv0, u0);
  const float d = dot3(fv1, u0);
#pragma unroll
  for (int a = 0; a < 3; ++a) fv1[a] = fv1[a] - d * u0[a];
  if (norm3(fv1) < 1e-6f * fmaxf(s0, 1e-6f)) {
    float alt[3];
    cross_axis_alt(u0, alt);
    normalize3(alt, u1);
  } else {
    normalize3(fv1, u1);
  }
  cross3(u0, u1, u2);  // det U = +1
  if (s0 < 1e-10f) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      u0[a] = a == 0 ? 1.0f : 0.0f;
      u1[a] = a == 1 ? 1.0f : 0.0f;
      u2[a] = a == 2 ? 1.0f : 0.0f;
    }
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    u[3 * a + 0] = u0[a];
    u[3 * a + 1] = u1[a];
    u[3 * a + 2] = u2[a];
  }

  // sigma[2] carries sign(det F) (Warp's convention)
  sigma[0] = s0;
  sigma[1] = s1;
  sigma[2] = s2 * (det3(f) < 0.0f ? -1.0f : 1.0f);
}

// ---------------------------------------------------------------------------
// Return mappings (sim/constitutive.py:58-149).  Each writes the returned F
// into f_new (F_trial where the particle stays elastic).
// ---------------------------------------------------------------------------

struct LogStrain {
  float eps[3];
  float eps_hat[3];
  float eps_hat_norm;  // |eps_hat| + 1e-6
  float cond_norm;     // |dev(tau)| of the Hencky Kirchhoff stress
};

// the deviatoric Hencky strain and stress that von Mises and snow share
__device__ __forceinline__ LogStrain von_mises_strain(const float* sig_old, float mu, float lam) {
  LogStrain r;
#pragma unroll
  for (int a = 0; a < 3; ++a) r.eps[a] = logf(fmaxf(sig_old[a], 0.01f));
  const float eps_sum = r.eps[0] + r.eps[1] + r.eps[2];
  const float temp = eps_sum / 3.0f;
  float tau[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) tau[a] = 2.0f * mu * r.eps[a] + lam * eps_sum;
  const float tau_mean = (tau[0] + tau[1] + tau[2]) / 3.0f;
  float cond[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    cond[a] = tau[a] - tau_mean;
    r.eps_hat[a] = r.eps[a] - temp;
  }
  r.cond_norm = norm3(cond);
  r.eps_hat_norm = norm3(r.eps_hat) + 1e-6f;
  return r;
}

// metal (von_mises_return_mapping, constitutive.py:58-80)
__device__ __forceinline__ void von_mises(const float* f_trial, const float* u,
                                          const float* sig_old, const float* v, float mu,
                                          float lam, float& ys, float hardening, float xi,
                                          float* f_new) {
  const LogStrain e = von_mises_strain(sig_old, mu, lam);
  const bool yielding = e.cond_norm > ys;
  const float delta_gamma = e.eps_hat_norm - ys / (2.0f * mu);
  if (!yielding) {
#pragma unroll
    for (int k = 0; k < 9; ++k) f_new[k] = f_trial[k];
    return;
  }
  const float ratio = delta_gamma / e.eps_hat_norm;
  float s[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) s[a] = expf(e.eps[a] - ratio * e.eps_hat[a]);
  diag_mm_nt(u, s, v, f_new);
  if (hardening == 1.0f) ys = ys + 2.0f * mu * xi * delta_gamma;
}

// snow (von_mises_return_mapping_with_damage, constitutive.py:83-109): a
// yield that softens the yield stress to <= 0 takes mu and lam to 0
__device__ __forceinline__ void snow(const float* f_trial, const float* u, const float* sig_old,
                                     const float* v, float& mu, float& lam, float& ys,
                                     float hardening, float xi, float softening, float* f_new) {
  const LogStrain e = von_mises_strain(sig_old, mu, lam);
  const bool yielding = e.cond_norm > ys && ys > 0.0f;  // fully damaged -> elastic
  if (!yielding) {
#pragma unroll
    for (int k = 0; k < 9; ++k) f_new[k] = f_trial[k];
    return;
  }
  const float delta_gamma = e.eps_hat_norm - ys / (2.0f * mu);
  const float ratio = delta_gamma / e.eps_hat_norm;
  float corr[3], s[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    corr[a] = ratio * e.eps_hat[a];
    s[a] = expf(e.eps[a] - corr[a]);
  }
  diag_mm_nt(u, s, v, f_new);
  const float ys_soft = ys - softening * norm3(corr);
  if (ys_soft <= 0.0f) {
    mu = 0.0f;
    lam = 0.0f;
  }
  ys = ys_soft;
  if (hardening == 1.0f) ys = ys + 2.0f * mu * xi * delta_gamma;
}

// viscoplastic StVK (viscoplasticity_return_mapping_stvk, constitutive.py:112-131)
__device__ __forceinline__ void viscoplastic(const float* f_trial, const float* u,
                                             const float* sig_old, const float* v, float mu,
                                             float ys, float plastic_viscosity, float dt,
                                             float* f_new) {
  constexpr float kSqrt23 = 0.816496580927726f;  // (2/3) ** 0.5
  float sig[3], eps[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    sig[a] = fmaxf(sig_old[a], 0.01f);
    eps[a] = logf(sig[a]);
  }
  const float trace_eps = eps[0] + eps[1] + eps[2];
  float s_trial[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) s_trial[a] = 2.0f * mu * (eps[a] - trace_eps / 3.0f);
  const float s_trial_norm = norm3(s_trial);
  const float y = s_trial_norm - kSqrt23 * ys;
  if (!(y > 0.0f)) {
#pragma unroll
    for (int k = 0; k < 9; ++k) f_new[k] = f_trial[k];
    return;
  }
  const float mu_hat = mu * ((sig[0] * sig[0] + sig[1] * sig[1] + sig[2] * sig[2]) / 3.0f);
  const float s_new_norm =
      s_trial_norm - y / (1.0f + plastic_viscosity / (2.0f * fmaxf(mu_hat, 1e-12f) * dt));
  const float scale = s_new_norm / fmaxf(s_trial_norm, 1e-12f);
  float s[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) s[a] = expf(scale * s_trial[a] / (2.0f * mu) + trace_eps / 3.0f);
  diag_mm_nt(u, s, v, f_new);
}

// Drucker-Prager sand (sand_return_mapping, constitutive.py:134-149):
// expansion projects to the rotation U V^T, compaction to the yield surface
__device__ __forceinline__ void sand(const float* f_trial, const float* u, const float* sig,
                                    const float* v, float mu, float lam, float alpha,
                                    float* f_new) {
  float eps[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) eps[a] = logf(fmaxf(fabsf(sig[a]), 1e-14f));
  const float tr = eps[0] + eps[1] + eps[2];
  float eps_hat[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) eps_hat[a] = eps[a] - tr / 3.0f;
  const float eps_hat_norm = norm3(eps_hat);
  const float delta_gamma =
      eps_hat_norm + (3.0f * lam + 2.0f * mu) / (2.0f * mu) * tr * alpha;
  if (delta_gamma <= 0.0f) {
#pragma unroll
    for (int k = 0; k < 9; ++k) f_new[k] = f_trial[k];
    return;
  }
  if (tr > 0.0f) {
    matmul_nt(u, v, f_new);
    return;
  }
  const float ratio = delta_gamma / fmaxf(eps_hat_norm, 1e-12f);
  float s[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) s[a] = expf(eps[a] - eps_hat[a] * ratio);
  diag_mm_nt(u, s, v, f_new);
}

// ---------------------------------------------------------------------------
// Kirchhoff stresses tau = P F^T (constitutive.py:24-53)
// ---------------------------------------------------------------------------

// fixed corotated: 2 mu (F - R) F^T + lam J (J - 1) I, R = U V^T
__device__ __forceinline__ void stress_fcr(const float* f, const float* u, const float* v,
                                           float J, float mu, float lam, float* out) {
  float r[9], fmr[9], p[9];
  matmul_nt(u, v, r);
#pragma unroll
  for (int k = 0; k < 9; ++k) fmr[k] = f[k] - r[k];
  matmul_nt(fmr, f, p);
  const float diag = lam * J * (J - 1.0f);
#pragma unroll
  for (int r_ = 0; r_ < 3; ++r_)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      out[3 * r_ + c] = 2.0f * mu * p[3 * r_ + c] + (r_ == c ? diag : 0.0f);
}

// StVK with Hencky strain: U diag(2 mu eps + lam tr eps) V^T F^T, sigma >= 0.01
__device__ __forceinline__ void stress_stvk(const float* f, const float* u, const float* sig,
                                            const float* v, float mu, float lam, float* out) {
  float eps[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) eps[a] = logf(fmaxf(sig[a], 0.01f));
  const float log_sum = eps[0] + eps[1] + eps[2];
  float tau[3], p[9];
#pragma unroll
  for (int a = 0; a < 3; ++a) tau[a] = 2.0f * mu * eps[a] + lam * log_sum;
  diag_mm_nt(u, tau, v, p);
  matmul_nt(p, f, out);
}

// Drucker-Prager: U diag((2 mu log sigma + lam tr log sigma) / sigma) V^T F^T
__device__ __forceinline__ void stress_drucker_prager(const float* f, const float* u,
                                                      const float* sig, const float* v,
                                                      float mu, float lam, float* out) {
  float ls[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) ls[a] = logf(sig[a]);
  const float log_sum = ls[0] + ls[1] + ls[2];
  float center[3], p[9];
#pragma unroll
  for (int a = 0; a < 3; ++a) center[a] = (2.0f * mu * ls[a] + lam * log_sum) / sig[a];
  diag_mm_nt(u, center, v, p);
  matmul_nt(p, f, out);
}

// weakly compressible water, gamma 1.1: J p I
__device__ __forceinline__ void stress_water(float J, float bulk, float* out) {
  const float pressure = -bulk * (powf(fmaxf(J, 1e-6f), -1.1f) - 1.0f);
#pragma unroll
  for (int k = 0; k < 9; ++k) out[k] = (k % 4 == 0) ? J * pressure : 0.0f;
}

// ---------------------------------------------------------------------------
// The constitutive pass of one particle (compute_stress_from_F_trial,
// constitutive.py): the return map of F_trial by material (von Mises for
// id 1, sand 2, viscoplastic 3, snow 5: svd3 of F_trial), then the
// Kirchhoff stress of the returned F (FCR for ids 0 and 5, StVK for 1 and
// 3, Drucker-Prager for 2, water for 6, zero for 4 and 7: det and svd3 of
// F), symmetrized.  A material whose bit is clear in active_materials takes
// no branch, as the plain version skips the materials absent from
// cfg.active_materials.  B6 (fused_substep.cu) runs it between its advect
// and its splat, B7 (constitutive.cu) on its own.
// ---------------------------------------------------------------------------
struct Plasticity {
  float dt, hardening, xi, alpha, plastic_viscosity, softening;
  int active_materials;  // bit m set: material id m is in cfg.active_materials
};

__device__ __forceinline__ bool has(int mask, int id) { return (mask >> id) & 1; }

// ft: F_trial; mu, lam, ys: the particle's, updated in place; bulk: the
// particle's bulk modulus, read by water alone; fn: the returned F; st: the
// symmetrized stress
__device__ __forceinline__ void constitutive_update(const float* ft, int mat, float& mu,
                                                    float& lam, float& ys,
                                                    const float* __restrict__ bulk,
                                                    const Plasticity& prm, float* fn,
                                                    float* st) {
  const int mask = prm.active_materials;
#pragma unroll
  for (int k = 0; k < 9; ++k) fn[k] = ft[k];
  if ((mat == 1 || mat == 2 || mat == 3 || mat == 5) && has(mask, mat)) {
    float u[9], sig[3], vv[9];
    svd3(ft, u, sig, vv);
    if (mat == 1) {
      von_mises(ft, u, sig, vv, mu, lam, ys, prm.hardening, prm.xi, fn);
    } else if (mat == 2) {
      sand(ft, u, sig, vv, mu, lam, prm.alpha, fn);
    } else if (mat == 3) {
      viscoplastic(ft, u, sig, vv, mu, ys, prm.plastic_viscosity, prm.dt, fn);
    } else {
      snow(ft, u, sig, vv, mu, lam, ys, prm.hardening, prm.xi, prm.softening, fn);
    }
  }

  float tau[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) tau[k] = 0.0f;
  const bool fcr = (mat == 0 || mat == 5) && (has(mask, 0) || has(mask, 5) || has(mask, 6));
  const bool stvk = (mat == 1 || mat == 3) && (has(mask, 1) || has(mask, 3));
  const bool dp = mat == 2 && has(mask, 2);
  const bool water = mat == 6 && has(mask, 6);
  if (fcr || stvk || dp) {
    float u[9], sig[3], vv[9];
    svd3(fn, u, sig, vv);
    if (fcr) {
      stress_fcr(fn, u, vv, det3(fn), mu, lam, tau);
    } else if (stvk) {
      stress_stvk(fn, u, sig, vv, mu, lam, tau);
    } else {
      stress_drucker_prager(fn, u, sig, vv, mu, lam, tau);
    }
  } else if (water) {
    stress_water(det3(fn), *bulk, tau);
  }
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) st[3 * r + c] = 0.5f * (tau[3 * r + c] + tau[3 * c + r]);
}

}  // namespace pixie
