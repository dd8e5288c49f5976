// take_along_axis on a 2-D float32 table for NVIDIA Hopper (sm_90a):
//   axis 0: out[i, j] = table[idx[i, j], j]
//   axis 1: out[i, j] = table[i, idx[i, j]]
// with table, idx and out all (T, L), idx int32, as np.take_along_axis.
//
// Replaces scripts/probe_vmem_gather.py:30 kernel_axis0 and :36
// kernel_axis1, the Pallas probe of Mosaic's in-VMEM dynamic gather (called
// at :48).  Plain C interface, loaded with ctypes
// (pixie_tpu_torch/ops/gather.py); each launcher takes PyTorch's current
// stream, never synchronizes, allocates nothing and returns
// cudaGetLastError().  Indices are promised in bounds
// (mode="promise_in_bounds" in the probe): nothing here checks them.
//
// The TPU probe holds the whole table in VMEM.  Hopper has no such store
// for 4 MiB; what it has is a 50 MB L2 and 227 KB of shared memory a block,
// so each axis is shaped for the one it can use:
//
//   axis 0  one thread an output element, neighbouring threads on
//           neighbouring columns j, so the loads of idx and the stores of
//           out coalesce; the table reads go to idx-chosen rows and hit L2,
//           where the (8192, 128) table of the probe stays resident.
//           Bound: L2 sector traffic.  Each gathered 4-byte value costs a
//           32-byte sector, so the kernel moves ~8x the useful bytes
//           through L2, against a bound of 3 x 4 MiB over the HBM rate.
//   axis 1  a block stages kRowFloats / L whole rows (512 bytes a row at
//           L = 128) in shared memory with coalesced loads, then gathers
//           within each row from shared memory.  Bound: bytes (the table,
//           idx and out each cross HBM once); the shared-memory gather has
//           bank conflicts where random indices of a warp share a bank.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowFloats = 2048;  // rows a block stages: 8 KB of shared memory at L <= 2048

// rows a block stages for axis 1 at row length L; its shared memory is
// rows * L * 4 bytes, at most 48 KB (the wrapper takes L <= 12288)
inline int axis1_rows(int L) { return L >= kRowFloats ? 1 : kRowFloats / L; }

__global__ void take_axis0_kernel(const float* __restrict__ table,
                                  const int32_t* __restrict__ idx, float* __restrict__ out,
                                  int64_t total, int L) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int j = static_cast<int>(e % L);
  out[e] = table[static_cast<int64_t>(idx[e]) * L + j];
}

__global__ void take_axis1_kernel(const float* __restrict__ table,
                                  const int32_t* __restrict__ idx, float* __restrict__ out,
                                  int T, int L, int rows_per_block) {
  extern __shared__ float rows[];
  const int row0 = blockIdx.x * rows_per_block;
  const int count = min(rows_per_block, T - row0) * L;
  const int64_t base = static_cast<int64_t>(row0) * L;
  for (int e = threadIdx.x; e < count; e += blockDim.x) rows[e] = table[base + e];
  __syncthreads();
  for (int e = threadIdx.x; e < count; e += blockDim.x)
    out[base + e] = rows[(e / L) * L + idx[base + e]];
}

}  // namespace

extern "C" {

int pixie_take_along_axis(const float* table, const int32_t* idx, float* out, int T, int L,
                          int axis, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t total = static_cast<int64_t>(T) * L;
  if (total > 0) {
    if (axis == 0) {
      const int64_t blocks = (total + kThreads - 1) / kThreads;
      take_axis0_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(table, idx, out,
                                                                           total, L);
    } else if (axis == 1) {
      const int rows = axis1_rows(L);
      const int blocks = (T + rows - 1) / rows;
      take_axis1_kernel<<<blocks, kThreads, static_cast<size_t>(rows) * L * sizeof(float), s>>>(
          table, idx, out, T, L, rows);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

const char* pixie_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
