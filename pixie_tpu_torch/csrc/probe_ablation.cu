// The P2G ablation probe for NVIDIA Hopper (sm_90a): four variants of the
// shipped P2G (B1: transfer.cu's bin keys, torch.sort, and the run-summed
// binned splat), timed side by side to attribute its cost to the atomics,
// the weight math and the loads of the sorted schedule.
//
// Replaces scripts/probe_kernel_ablation.py:112, the pallas_call of
// kernel_variant (:47), which ablated the TPU's P2G body on its tile-sorted
// layout.  Plain C interface, loaded with ctypes
// (pixie_tpu_torch/ops/probe_ablation.py); the launcher takes PyTorch's
// current stream, never synchronizes, allocates nothing and returns
// cudaGetLastError().
//
// Every variant runs behind B1's key kernel and torch.sort (the wrapper
// calls them): lane q of a block of 256 takes sorted position q, so the
// lanes of a warp hold particles of few cells, each cell's lanes adjacent.
// The TPU's tile-sorted blocks, window factors and MXU contraction are not
// carried over: the Hopper P2G has none of them to ablate.
//
//   full       B1's splat itself (mpm.cuh p2g_binned_splat<kP2GFull>, the
//              code transfer.cu's p2g_binned_kernel runs): each run of
//              same-cell lanes sums its 27 nodes' values with 5 shuffles a
//              value, and its last lane adds them into the grid, one atomic
//              per (in-grid node, component).
//              Bound: neither bytes nor operations (see transfer.cu); the
//              sort is about two thirds of B1's device time at 100k
//              particles, and the run atomics most of the rest.
//   noweights  replaces the TPU's `nopairs` (probe_kernel_ablation.py:63-67,
//              window and pair factors replaced by constants, the scatter
//              kept): the same schedule, runs and run atomics, with the
//              per-node weight, weight gradient and APIC offset the constant
//              kAblate.  Removes the B-spline weight math.
//   noatomics  replaces the TPU's `nodot` (:87-89, factors kept, the
//              scattering contraction replaced by a broadcast add): keys,
//              sort, node math and the run sums' shuffles as in full; in
//              place of each run's atomics, the run's last lane adds its
//              run sums of the in-grid nodes in registers and stores the
//              four sums into out (N, 4) at its sorted position q; every
//              other row is 0.  Removes the atomics.
//   minimal    replaces the TPU's `minimal` (:60-61, acc += const): lane q
//              loads keys[q], perm[q] and particle perm[q]'s inputs, folds
//              them into one sum in a fixed order (x, v, C, stress, mass,
//              vol) and stores it into out (N,) at perm[q] (0 where the key
//              names no bin).  Removes all but the sorted schedule's loads,
//              one store and the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mpm.cuh"

namespace {

constexpr int kThreads = 256;

template <int kMode>
__global__ void __launch_bounds__(kThreads)
p2g_probe_kernel(const int32_t* __restrict__ keys, const int64_t* __restrict__ perm,
                 const float* __restrict__ x, const float* __restrict__ v,
                 const float* __restrict__ C, const float* __restrict__ stress,
                 const float* __restrict__ mass, const float* __restrict__ vol,
                 float* __restrict__ grid, float* __restrict__ out, int n, int n_grid, int nbins,
                 int hbits, float dx, float inv_dx, float dt, float rpic_damping) {
  const int q = blockIdx.x * kThreads + threadIdx.x;
  if constexpr (kMode == pixie::kP2GFull || kMode == pixie::kP2GNoWeights) {
    pixie::p2g_binned_splat<kMode>(keys, perm, x, v, C, stress, mass, vol, grid, q, n, n_grid,
                                   nbins, hbits, dx, inv_dx, dt, rpic_damping);
  } else if constexpr (kMode == pixie::kP2GNoAtomics) {
    const int lane = threadIdx.x & 31;
    const bool live = pixie::sorted_lane_live(keys, q, n, nbins, hbits);
    float4* out4 = reinterpret_cast<float4*>(out);
    if (!__any_sync(pixie::kFullMask, live)) {
      if (q < n) out4[q] = make_float4(0.f, 0.f, 0.f, 0.f);
      return;
    }
    const int p = live ? static_cast<int>(perm[q]) : 0;
    const pixie::Run run = pixie::sorted_lane_run(live, p, x, lane, n_grid, inv_dx);
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    pixie::p2g_nodes<pixie::kP2GFull, true>(
        p, x, v, C, stress, mass, vol, n_grid, dx, inv_dx, dt, rpic_damping,
        [&](int gi, int gj, int gk, float mx, float my, float mz, float wm) {
          const float s0 = pixie::run_sum(live ? mx : 0.0f, lane, run.first);
          const float s1 = pixie::run_sum(live ? my : 0.0f, lane, run.first);
          const float s2 = pixie::run_sum(live ? mz : 0.0f, lane, run.first);
          const float s3 = pixie::run_sum(live ? wm : 0.0f, lane, run.first);
          if (live && run.last && pixie::in_grid(gi, gj, gk, n_grid)) {
            acc[0] += s0;
            acc[1] += s1;
            acc[2] += s2;
            acc[3] += s3;
          }
        });
    if (q < n) out4[q] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else {  // kP2GMinimal
    if (q >= n) return;
    const int p = static_cast<int>(perm[q]);
    if (!pixie::sorted_lane_live(keys, q, n, nbins, hbits)) {
      out[p] = 0.f;
      return;
    }
    float acc = x[3 * p];
#pragma unroll
    for (int k = 1; k < 3; ++k) acc += x[3 * p + k];
#pragma unroll
    for (int k = 0; k < 3; ++k) acc += v[3 * p + k];
#pragma unroll
    for (int k = 0; k < 9; ++k) acc += C[9 * p + k];
#pragma unroll
    for (int k = 0; k < 9; ++k) acc += stress[9 * p + k];
    out[p] = (acc + mass[p]) + vol[p];
  }
}

}  // namespace

extern "C" {

// mode: 0 full, 1 noweights (both splat into grid (G^3, 4), zeroed by the
// caller), 2 noatomics (out (N, 4)), 3 minimal (out (N,)); keys sorted
// ascending and their permutation (int64, as torch.sort returns it), nb bins
// a side and hbits low bits as transfer.cu's pixie_p2g takes them
int pixie_p2g_probe(int mode, const int32_t* keys, const int64_t* perm, const float* x,
                    const float* v, const float* C, const float* stress, const float* mass,
                    const float* vol, float* grid, float* out, int n, int n_grid, int nb,
                    int hbits, float dx, float inv_dx, float dt, float rpic_damping,
                    void* stream) {
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int nbins = nb * nb * nb;
#define PIXIE_PROBE_LAUNCH(M)                                                                 \
  p2g_probe_kernel<M><<<blocks, kThreads, 0, s>>>(keys, perm, x, v, C, stress, mass, vol,     \
                                                  grid, out, n, n_grid, nbins, hbits, dx,     \
                                                  inv_dx, dt, rpic_damping)
    switch (mode) {
      case pixie::kP2GFull: PIXIE_PROBE_LAUNCH(pixie::kP2GFull); break;
      case pixie::kP2GNoWeights: PIXIE_PROBE_LAUNCH(pixie::kP2GNoWeights); break;
      case pixie::kP2GNoAtomics: PIXIE_PROBE_LAUNCH(pixie::kP2GNoAtomics); break;
      case pixie::kP2GMinimal: PIXIE_PROBE_LAUNCH(pixie::kP2GMinimal); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef PIXIE_PROBE_LAUNCH
  }
  return static_cast<int>(cudaGetLastError());
}

const char* pixie_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
