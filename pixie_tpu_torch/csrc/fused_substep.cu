// The fused MLS-MPM substep for NVIDIA Hopper (sm_90a): G2P(s) -> advect ->
// constitutive pass -> P2G(s+1) in one launch.
//
// Replaces pixie_tpu/ops/fused_substep.py:266 fused_substep, whose Pallas
// body is _make_fused_kernel (:108-263).  Plain C interface, loaded with
// ctypes (pixie_tpu_torch/ops/fused_substep.py); the launcher takes
// PyTorch's current stream, never synchronizes, allocates nothing and
// returns cudaGetLastError().
//
// What it computes, for each particle with active[p] (selection == 0), as
// the plain version fused_substep_plain composes it from the package's
// PyTorch code (ops/transfer.py g2p_plain, sim/constitutive.py
// compute_stress_from_F_trial, ops/transfer.py p2g_plain):
//   1. gather v, APIC C (x 4 inv_dx) and grad v from grid_v (G,G,G,3) at x(s);
//   2. advect: x += dt v, F_trial = (I + dt grad v) F, and with update_cov
//      cov += dt (grad v cov + (grad v cov)^T);
//   3. the return map of F_trial for the particle's material (von Mises,
//      sand, viscoplastic, snow with damage: svd3 of F_trial), then the
//      Kirchhoff stress of the returned F (FCR for ids 0 and 5, StVK for 1
//      and 3, Drucker-Prager for 2, water for 6, zero for 4 and 7: det and
//      svd3 of F), symmetrized;
//   4. splat mass, m (v + C dpos) and -vol dt stress grad w at x(s+1) into
//      the zeroed grid_next (G,G,G,4), with the RPIC / PIC damping of C.
// x, v, C, F, F_trial, stress, mu, lam, yield_stress and cov are updated in
// place; inactive particles keep every field and splat nothing.  A material
// whose bit is clear in active_materials takes no branch, as the plain
// version skips the materials absent from cfg.active_materials.
//
// Design: one thread per particle, one straight-line program: the gather
// is g2p_kernel's (transfer.cu), the splat B1's run sums (mpm.cuh
// splat_nodes + RunSink), and between them the constitutive math of mpm.cuh
// runs in registers: the particle state is read once and written once per
// substep, where the two-kernel path round-trips it through device memory
// between ~2000 small PyTorch launches of the constitutive pass.
//
// Lane q takes particle q.  The fused frame (sim/solver.py) hands the
// kernel its particles sorted by cell: it permutes the state's arrays into
// the cell order of the frame's prologue P2G, re-sorts every RESORT_EVERY
// substeps and restores the caller's order after the frame, so the lanes of
// one cell sit side by side in a warp.  The splat sums each run of adjacent
// lanes whose base cell after advection is the same, and the run's last lane
// adds the sums into the grid: ~20 global atomics a particle at 6.4 a cell
// instead of 108.  Runs come from each lane's own cell, so any order is
// exact: a stale one only gives shorter runs.  A lane whose stencil reaches
// no node of the grid, or whose position is not finite, splats nothing, as
// the plain version drops those nodes.  The arrays are permuted, not read
// through the permutation: read through it (as B1 reads its particles), the
// ~300 B of state a particle came from scattered rows and the gather and
// constitutive pass took 0.2235 ms against 0.1183 in the arrays' own order,
// as much as the run sums saved (0.1567 -> 0.0541 ms for the splat; 100k
// particles, one chip_smoke.py run, NVIDIA H100 80GB HBM3, 700 W).
//
// Before the run sums B6 splatted with 108 float atomics a particle (the
// one-thread-per-particle splat that P1's `full` timed before P1 moved onto
// B1's schedule), 95 % of that splat's time by P1's ablation; in the given order that kernel took 0.2640-0.3668 ms against
// 0.1416-0.2303 for the run sums in a cell order (PERF.md), and it was
// then deleted.  Schedules (template flag): kRunSums, shipped; kNoSplat,
// phases 1-3 alone, which prices the gather and the constitutive math apart
// from the splat (chip_smoke.py times it; no path of the port calls it).
//
// Not carried over from the TPU kernel: its tile-sorted particle blocks, the
// (48, NB*128) row packing of the carried state, the one-hot window factors
// contracted on the MXU, and the clamp of each particle's base cell into the
// stored node window (_axis_offsets, :93-105).  They exist because the TPU
// serializes gathers and scatters; Hopper has native gathers and global
// atomics on a dense grid, so the kernel takes the grid as it is, and no
// particle is clamped.
//
// Bound, per active particle: about 100 B of state read (x, F, mu, lam,
// yield stress, mass, vol, material, bulk, the flag, cov with update_cov)
// and about 200 B written (x, v, C, F_trial, F, stress, mu, lam, yield
// stress, cov), plus the velocity grid read and the momentum grid written
// once: at 100k particles and n_grid 50, ~34 MB, ~10 us at 3.35 TB/s.  The
// arithmetic is 3.5k-6.6k flops a particle (two 27-node stencils, one svd3
// of F and, for ids 1, 2, 3 and 5, one of F_trial), ~9 us at 67 TFLOP/s, so
// the bytes bound it by a little.
//
// Rounding: x(s+1) = x + dt v is rounded op by op (no FMA) so the next
// splat's floor() sees the plain version's position; elsewhere nvcc
// contracts multiply-adds, so discrete branches (yield, sand tr > 0 and
// delta_gamma <= 0, the snow damage flag, svd3's degenerate cases) can fall
// differently for particles within rounding of their thresholds.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mpm.cuh"

namespace {

constexpr int kThreads = 128;
enum Schedule : int { kRunSums = 0, kNoSplat = 1 };

struct Params {
  int n, n_grid;
  float dx, inv_dx, dt;
  float hardening, xi, alpha, plastic_viscosity, softening, rpic_damping;
  int update_cov;
  int active_materials;  // bit m set: material id m is in cfg.active_materials
};

__device__ __forceinline__ bool has(int mask, int id) { return (mask >> id) & 1; }

template <int kSched>
__global__ void __launch_bounds__(kThreads)
fused_substep_kernel(float* __restrict__ x, float* __restrict__ v, float* __restrict__ C,
                     float* __restrict__ F, float* __restrict__ F_trial,
                     float* __restrict__ stress, float* __restrict__ mu_arr,
                     float* __restrict__ lam_arr, float* __restrict__ ys_arr,
                     float* __restrict__ cov, const float* __restrict__ mass,
                     const float* __restrict__ vol, const int32_t* __restrict__ material,
                     const float* __restrict__ bulk, const uint8_t* __restrict__ active,
                     const float* __restrict__ grid_v, float* __restrict__ grid_next,
                     Params prm) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const bool live = p < prm.n && active[p];
  if constexpr (kSched == kRunSums) {
    if (!__any_sync(pixie::kFullMask, live)) return;  // the whole warp: no run to form
  } else {
    if (!live) return;
  }
  const int n_grid = prm.n_grid;
  const float dt = prm.dt, inv_dx = prm.inv_dx, dx = prm.dx;
  // what the splat reads: x(s+1), v, the damped C, the mass and -vol dt stress
  float xp[3] = {0.f, 0.f, 0.f}, nv[3] = {0.f, 0.f, 0.f}, c[9], sc[9], m = 0.f;
#pragma unroll
  for (int k = 0; k < 9; ++k) c[k] = sc[k] = 0.f;

  if (live) {
    // ---- 1. G2P(s): v, C, grad v at x(s) (g2p_kernel) --------------------
    float nc[9], gv[9];
#pragma unroll
    for (int k = 0; k < 3; ++k) xp[k] = x[3 * p + k];
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      nc[k] = 0.f;
      gv[k] = 0.f;
    }
    {
      const pixie::Spline s = pixie::spline_weights(xp, inv_dx);
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
            const float dwt[3] = {s.dw[0][i] * wy * wz * inv_dx, wx * s.dw[1][j] * wz * inv_dx,
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
              for (int qq = 0; qq < 3; ++qq) {
                nc[3 * r + qq] += wg * dpos[qq];
                gv[3 * r + qq] += g[r] * dwt[qq];
              }
            }
          }
        }
      }
    }

    // ---- 2. advect(s) -------------------------------------------------------
    const float c_scale = inv_dx * 4.0f;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      xp[r] = __fadd_rn(xp[r], __fmul_rn(dt, nv[r]));  // as the plain x + dt * v
      x[3 * p + r] = xp[r];
      v[3 * p + r] = nv[r];
    }
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      nc[k] = nc[k] * c_scale;
      C[9 * p + k] = nc[k];
    }
    float ft[9];
    {
      float a[9], f[9];
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int qq = 0; qq < 3; ++qq)
          a[3 * r + qq] = (r == qq ? 1.0f : 0.0f) + gv[3 * r + qq] * dt;
#pragma unroll
      for (int k = 0; k < 9; ++k) f[k] = F[9 * p + k];
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int qq = 0; qq < 3; ++qq) {
          ft[3 * r + qq] = a[3 * r] * f[qq] + a[3 * r + 1] * f[3 + qq] + a[3 * r + 2] * f[6 + qq];
          F_trial[9 * p + 3 * r + qq] = ft[3 * r + qq];
        }
    }
    if (prm.update_cov) {
      // cov += dt (grad_v cov + (grad_v cov)^T)  (update_cov, mpm_utils.py:316-335)
      float* c6 = cov + 6 * p;
      const float cm[9] = {c6[0], c6[1], c6[2], c6[1], c6[3], c6[4], c6[2], c6[4], c6[5]};
      float gc[9];
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int qq = 0; qq < 3; ++qq)
          gc[3 * r + qq] =
              gv[3 * r] * cm[qq] + gv[3 * r + 1] * cm[3 + qq] + gv[3 * r + 2] * cm[6 + qq];
      c6[0] = cm[0] + dt * (gc[0] + gc[0]);
      c6[1] = cm[1] + dt * (gc[1] + gc[3]);
      c6[2] = cm[2] + dt * (gc[2] + gc[6]);
      c6[3] = cm[4] + dt * (gc[4] + gc[4]);
      c6[4] = cm[5] + dt * (gc[5] + gc[7]);
      c6[5] = cm[8] + dt * (gc[8] + gc[8]);
    }

    // ---- 3. stress(s+1): return map, then the Kirchhoff stress -----------
    const int mat = material[p];
    const int mask = prm.active_materials;
    float mu = mu_arr[p], lam = lam_arr[p], ys = ys_arr[p];
    float fn[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) fn[k] = ft[k];
    if ((mat == 1 || mat == 2 || mat == 3 || mat == 5) && has(mask, mat)) {
      float u[9], sig[3], vv[9];
      pixie::svd3(ft, u, sig, vv);
      if (mat == 1) {
        pixie::von_mises(ft, u, sig, vv, mu, lam, ys, prm.hardening, prm.xi, fn);
      } else if (mat == 2) {
        pixie::sand(ft, u, sig, vv, mu, lam, prm.alpha, fn);
      } else if (mat == 3) {
        pixie::viscoplastic(ft, u, sig, vv, mu, ys, prm.plastic_viscosity, dt, fn);
      } else {
        pixie::snow(ft, u, sig, vv, mu, lam, ys, prm.hardening, prm.xi, prm.softening, fn);
      }
    }

    float st[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) st[k] = 0.0f;
    const bool fcr = (mat == 0 || mat == 5) && (has(mask, 0) || has(mask, 5) || has(mask, 6));
    const bool stvk = (mat == 1 || mat == 3) && (has(mask, 1) || has(mask, 3));
    const bool dp = mat == 2 && has(mask, 2);
    const bool water = mat == 6 && has(mask, 6);
    if (fcr || stvk || dp) {
      float u[9], sig[3], vv[9];
      pixie::svd3(fn, u, sig, vv);
      if (fcr) {
        pixie::stress_fcr(fn, u, vv, pixie::det3(fn), mu, lam, st);
      } else if (stvk) {
        pixie::stress_stvk(fn, u, sig, vv, mu, lam, st);
      } else {
        pixie::stress_drucker_prager(fn, u, sig, vv, mu, lam, st);
      }
    } else if (water) {
      pixie::stress_water(pixie::det3(fn), bulk[p], st);
    }
    const float nvol = -vol[p];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int qq = 0; qq < 3; ++qq) {
        const float sym = 0.5f * (st[3 * r + qq] + st[3 * qq + r]);
        F[9 * p + 3 * r + qq] = fn[3 * r + qq];
        stress[9 * p + 3 * r + qq] = sym;
        sc[3 * r + qq] = nvol * sym * dt;  // -vol * stress * dt
      }
    mu_arr[p] = mu;
    lam_arr[p] = lam;
    ys_arr[p] = ys;
#pragma unroll
    for (int k = 0; k < 9; ++k) c[k] = nc[k];
    pixie::damp_C(c, prm.rpic_damping);
    m = mass[p];
  }
  if constexpr (kSched == kNoSplat) return;

  // ---- 4. P2G(s+1) at x(s+1) ---------------------------------------------
  const pixie::Spline s = pixie::spline_weights(xp, inv_dx);
  constexpr float kMax = 3.402823466e38f;  // |x| <= FLT_MAX: false for NaN and inf
  const bool splat = live && fabsf(xp[0]) <= kMax && fabsf(xp[1]) <= kMax &&
                     fabsf(xp[2]) <= kMax && pixie::stencil_in_grid(s, n_grid);
  const pixie::Run run = pixie::lane_run(splat ? pixie::cell_label(s, n_grid) : -1 - lane, lane);
  pixie::splat_nodes<pixie::kP2GFull, true>(s, nv[0], nv[1], nv[2], c, m, sc, n_grid, dx, inv_dx,
                                            pixie::RunSink{splat, run, lane, n_grid, grid_next});
}

}  // namespace

extern "C" {

// schedule 0 is the shipped kernel (run sums), 1 the substep without its
// splat
int pixie_fused_substep(int schedule, float* x, float* v, float* C, float* F, float* F_trial,
                        float* stress, float* mu, float* lam, float* yield_stress, float* cov,
                        const float* mass, const float* vol, const int32_t* material,
                        const float* bulk, const uint8_t* active, const float* grid_v, float* grid_next, int n, int n_grid, float dx,
                        float inv_dx, float dt, float hardening, float xi, float alpha,
                        float plastic_viscosity, float softening, float rpic_damping,
                        int update_cov, int active_materials, void* stream) {
  if (n > 0) {
    const Params prm{n,         n_grid, dx,    inv_dx,           dt,
                     hardening, xi,     alpha, plastic_viscosity, softening,
                     rpic_damping, update_cov, active_materials};
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int blocks = (n + kThreads - 1) / kThreads;
#define PIXIE_FUSED_LAUNCH(S)                                                                   \
  fused_substep_kernel<S><<<blocks, kThreads, 0, s>>>(x, v, C, F, F_trial, stress, mu, lam,     \
                                                      yield_stress, cov, mass, vol, material,  \
                                                      bulk, active, grid_v, grid_next, prm)
    switch (schedule) {
      case kRunSums: PIXIE_FUSED_LAUNCH(kRunSums); break;
      case kNoSplat: PIXIE_FUSED_LAUNCH(kNoSplat); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef PIXIE_FUSED_LAUNCH
  }
  return static_cast<int>(cudaGetLastError());
}

const char* pixie_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
