// The P2G ablation probe for NVIDIA Hopper (sm_90a): four variants of the
// shipped P2G splat (transfer.cu p2g_kernel), timed side by side to
// attribute its cost to weight math, atomics and load/launch overhead.
//
// Replaces scripts/probe_kernel_ablation.py:112, the pallas_call of
// kernel_variant (:47), which ablated the TPU's P2G body on its tile-sorted
// layout.  Plain C interface, loaded with ctypes
// (pixie_tpu_torch/ops/probe_ablation.py); the launcher takes PyTorch's
// current stream, never synchronizes, allocates nothing and returns
// cudaGetLastError().
//
// Each variant is one thread per particle on the port's AoS inputs (x, v,
// C, stress, mass, vol, active) and is mpm.cuh's p2g_particle<kMode>, so
// every one differs from the shipped kernel only by what its mode removes.
// The TPU's tile-sorted blocks, window factors and MXU contraction are not
// carried over: the Hopper splat has none of them to ablate.
//
//   full       the shipped B1 body (p2g_particle<kP2GFull>, as p2g_kernel).
//              Bound: the 108 float atomics a particle into the L2-resident
//              grid, and their contention where particles share a cell.
//   noweights  replaces the TPU's `nopairs` (probe_kernel_ablation.py:63-67,
//              window and pair factors replaced by constants, the scatter
//              kept): weight, weight gradient and APIC offset are constants,
//              the base cell comes from x and the same 108 atomics go to the
//              same 27 nodes.  Removes the B-spline weight math.
//   noatomics  replaces the TPU's `nodot` (:87-89, factors kept, the
//              scattering contraction replaced by a broadcast add): every
//              node's contribution as in full, summed in registers, one
//              16-byte store a particle into out (N, 4).  Removes the atomics.
//   minimal    replaces the TPU's `minimal` (:60-61, acc += const): loads
//              the particle's inputs as full does, folds them into one sum
//              and stores it into out (N,).  Removes all but the loads, one
//              store and the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mpm.cuh"

namespace {

constexpr int kThreads = 256;

template <int kMode>
__global__ void p2g_probe_kernel(const float* __restrict__ x, const float* __restrict__ v,
                                 const float* __restrict__ C,
                                 const float* __restrict__ stress,
                                 const float* __restrict__ mass,
                                 const float* __restrict__ vol,
                                 const uint8_t* __restrict__ active,
                                 float* __restrict__ grid, float* __restrict__ out, int n,
                                 int n_grid, float dx, float inv_dx, float dt,
                                 float rpic_damping) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  pixie::p2g_particle<kMode>(p, x, v, C, stress, mass, vol, active, grid, out, n_grid, dx,
                             inv_dx, dt, rpic_damping);
}

}  // namespace

extern "C" {

// mode: 0 full, 1 noweights (both splat into grid (G^3, 4), zeroed by the
// caller), 2 noatomics (out (N, 4)), 3 minimal (out (N,)).
int pixie_p2g_probe(int mode, const float* x, const float* v, const float* C,
                    const float* stress, const float* mass, const float* vol,
                    const uint8_t* active, float* grid, float* out, int n, int n_grid, float dx,
                    float inv_dx, float dt, float rpic_damping, void* stream) {
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PIXIE_PROBE_LAUNCH(M)                                                               \
  p2g_probe_kernel<M><<<blocks, kThreads, 0, s>>>(x, v, C, stress, mass, vol, active, grid, \
                                                  out, n, n_grid, dx, inv_dx, dt,           \
                                                  rpic_damping)
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
