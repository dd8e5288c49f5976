// The constitutive pass for NVIDIA Hopper (sm_90a): the return map of each
// particle's F_trial and the Kirchhoff stress of the result, in one launch.
//
// Replaces no TPU kernel: the JAX package's pass (pixie_tpu/sim/
// constitutive.py compute_stress_from_F_trial) is plain JAX, which XLA fuses
// into a few kernels.  The port's plain version (sim/constitutive.py) runs
// eagerly: ~2,070 small PyTorch launches a substep (batched 3x3 products,
// elementwise ops, torch.where), which kept the unfused substep at ~25 ms of
// device time and the host busy dispatching them.  Plain C interface, loaded
// with ctypes (pixie_tpu_torch/ops/constitutive.py); the launcher takes
// PyTorch's current stream, never synchronizes, allocates nothing and
// returns cudaGetLastError().
//
// What it computes, for each particle with selection == 0, is what
// compute_stress_from_F_trial computes (mpm.cuh constitutive_update, the
// function B6's phase 3 calls too): the return map of F_trial by material
// (von Mises, sand, viscoplastic, snow with damage, skipped for a material
// whose bit is clear in active_materials), det and svd3 of the returned F,
// the FCR, StVK, Drucker-Prager or water stress (zero for ids 4 and 7),
// symmetrized.  It writes F, stress, mu, lam and yield_stress into new
// arrays; a particle with selection != 0 gets its old values copied, as the
// plain version's torch.where keeps them.  The inputs are not written.
//
// Bound, per active particle: F_trial, mu, lam, yield stress, material and
// selection read (56 B; bulk too for water), F, stress, mu, lam and yield
// stress written (84 B): ~70 MB at 500k particles, ~21 us at 3.35 TB/s.
// The arithmetic is one svd3 of F (1292 flops) and a stress (~150), and for
// ids 1, 2, 3 and 5 a second svd3 (of F_trial) and a return map (120): for
// config 5's sand, snow and plasticine ~2.9k flops a particle, ~21 us at
// 67 TFLOP/s, counted without the cost of logf, expf, sqrtf and the
// divisions, which run on the special function units.  So the arithmetic
// bounds it, just.
//
// Design: one thread per particle, 128 a block (as B6), the whole pass in
// registers: both svd3s' temporaries, the returned F and the stress never
// leave the thread.  The branch a thread takes is chosen by its material id
// alone.  The unfused frame keeps its state in P2G's cell order (re-sorted
// every RESORT_EVERY substeps) and the fused frame's prologue in the
// caller's order; config 5's materials fill separate boxes and a ball, so in
// either order most warps hold one material and run one branch.
//
// The (N, 3, 3) arrays are 36-byte rows: the block's F_trial rows are
// copied into shared memory with 16-byte coalesced loads and its F and
// stress rows leave through shared memory with 16-byte coalesced stores
// (4-byte ones where an array is not 16-byte aligned).  Device time (median
// of 30 behind a sleep kernel, the better of two turns; one chip_smoke.py
// run, NVIDIA H100 80GB HBM3, 700 W): config 5's 500k particles in their
// material blocks 0.1081 ms (the plain pass 31.6 ms); the slice's 100k
// particles with six materials interleaved, so that every warp diverges,
// 0.0333 ms.  Loading and storing each thread's own rows, 9 strided 4-byte
// accesses a matrix, took 0.1294 and 0.0340 ms.  ptxas: 54 registers,
// 9216 B of shared memory, no spill.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mpm.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRow = 9;  // floats of one particle's 3x3 matrix

// count floats from src to dst, the block's threads on neighbouring
// addresses: 16 bytes a thread where both ends are 16-byte aligned
__device__ __forceinline__ void block_copy(float* __restrict__ dst,
                                           const float* __restrict__ src, int count) {
  int done = 0;
  if (((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) & 15) == 0) {
    const int n4 = count >> 2;
    for (int i = threadIdx.x; i < n4; i += kThreads)
      reinterpret_cast<float4*>(dst)[i] = reinterpret_cast<const float4*>(src)[i];
    done = n4 << 2;
  }
  for (int i = done + threadIdx.x; i < count; i += kThreads) dst[i] = src[i];
}

__global__ void __launch_bounds__(kThreads)
constitutive_kernel(const float* __restrict__ F_trial, const float* __restrict__ F,
                    const float* __restrict__ stress, const float* __restrict__ mu_in,
                    const float* __restrict__ lam_in, const float* __restrict__ ys_in,
                    const int32_t* __restrict__ material, const float* __restrict__ bulk,
                    const int32_t* __restrict__ selection, float* __restrict__ F_out,
                    float* __restrict__ stress_out, float* __restrict__ mu_out,
                    float* __restrict__ lam_out, float* __restrict__ ys_out, int n,
                    pixie::Plasticity prm) {
  const int first = blockIdx.x * kThreads;  // < n: no overflow
  const int p = first + threadIdx.x;
  const bool in = p < n;
  const int64_t row = static_cast<int64_t>(p) * kRow;
  const int64_t first_row = static_cast<int64_t>(first) * kRow;
  float ft[kRow], fn[kRow], st[kRow];
  // the block's rows of F_trial in, then of F and stress out
  __shared__ __align__(16) float s_f[kThreads * kRow];
  __shared__ __align__(16) float s_st[kThreads * kRow];
  const int rows = min(kThreads, n - first);
  block_copy(s_f, F_trial + first_row, rows * kRow);
  __syncthreads();
  if (in) {
#pragma unroll
    for (int k = 0; k < kRow; ++k) ft[k] = s_f[kRow * threadIdx.x + k];
  }
  __syncthreads();  // s_f takes the returned F below
  if (in) {
    if (selection[p] == 0) {
      float mu = mu_in[p], lam = lam_in[p], ys = ys_in[p];
      pixie::constitutive_update(ft, material[p], mu, lam, ys, bulk + p, prm, fn, st);
      mu_out[p] = mu;
      lam_out[p] = lam;
      ys_out[p] = ys;
    } else {
#pragma unroll
      for (int k = 0; k < kRow; ++k) {
        fn[k] = F[row + k];
        st[k] = stress[row + k];
      }
      mu_out[p] = mu_in[p];
      lam_out[p] = lam_in[p];
      ys_out[p] = ys_in[p];
    }
#pragma unroll
    for (int k = 0; k < kRow; ++k) {
      s_f[kRow * threadIdx.x + k] = fn[k];
      s_st[kRow * threadIdx.x + k] = st[k];
    }
  }
  __syncthreads();
  block_copy(F_out + first_row, s_f, rows * kRow);
  block_copy(stress_out + first_row, s_st, rows * kRow);
}

}  // namespace

extern "C" {

int pixie_constitutive(const float* F_trial, const float* F, const float* stress,
                       const float* mu, const float* lam, const float* yield_stress,
                       const int32_t* material, const float* bulk, const int32_t* selection,
                       float* F_out, float* stress_out, float* mu_out, float* lam_out,
                       float* ys_out, int n, float dt, float hardening, float xi, float alpha,
                       float plastic_viscosity, float softening, int active_materials,
                       void* stream) {
  if (n > 0) {
    const pixie::Plasticity prm{dt, hardening, xi, alpha, plastic_viscosity, softening,
                                active_materials};
    const int blocks = (n + kThreads - 1) / kThreads;
    constitutive_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        F_trial, F, stress, mu, lam, yield_stress, material, bulk, selection, F_out,
        stress_out, mu_out, lam_out, ys_out, n, prm);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* pixie_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
