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
// so each axis is shaped for the one it can use.  Both move 16 bytes a
// thread and access where L % 4 == 0 and every array starts 16-byte aligned
// (the vector path); any other L takes the scalar path of the same kernel,
// the same schedule one float at a time.  No element's index is divided:
// a thread's rows and columns come from its thread and block indices.
//
//   axis 0  a block of 32 x 8 threads covers 128 columns of 8 rows; a
//           thread loads its row's indices of its 4 columns (one 16-byte
//           load), starts the 4 table loads through the read-only path,
//           and stores the 4 values with one 16-byte store.  Bound: L2
//           sector requests.  Every gathered 4-byte value comes from an
//           idx-chosen row, so it costs a 32-byte L2 sector of its own (the
//           (8192, 128) table of the probe stays in L2): 1M scattered
//           sectors a call, against a bound of 3 x 4 MiB over the HBM rate.
//           At 8192 x 128 every schedule tried took the same time, 0.0137-
//           0.0144 ms (1, 2, 4 or 8 rows a thread, the table read through
//           the read-only path or L2 only; torch.gather 0.0145;
//           chip_smoke.py, one run, NVIDIA H100 80GB HBM3, 700 W), as the
//           earlier one element a thread (0.0140 in two earlier runs): ~75 G
//           scattered sectors a second is the card's rate for them, so the
//           simplest, one row a thread, is kept.
//   axis 1  a block stages kRowFloats / L whole rows (at least one; 512
//           bytes a row at L = 128) in shared memory with 16-byte loads,
//           then each thread gathers 4 columns of a row from shared memory
//           (one 16-byte load of idx, four shared reads, one 16-byte store).
//           Bound: bytes (the table, idx and out each cross once); random
//           indices of a warp meet in a shared-memory bank ~3.5 times a
//           read, which costs cycles of the SM, not bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowFloats = 2048;  // floats a block of axis 1 stages: 8 KB at L <= 2048

// rows a block stages for axis 1 at row length L; its shared memory is
// rows * L * 4 bytes, at most 48 KB (the wrapper takes L <= 12288)
inline int axis1_rows(int L) { return L >= kRowFloats ? 1 : kRowFloats / L; }

// block (32, 8): threadIdx.x a group of 4 columns (4 adjacent, or 4 spaced
// 32 apart on the scalar path), threadIdx.y a row; the grid's y covers the
// rows, looping where T needs more than 65535 x 8
__global__ void __launch_bounds__(kThreads)
take_axis0_kernel(const float* __restrict__ table, const int32_t* __restrict__ idx,
                  float* __restrict__ out, int T, int L, bool vec) {
  const int c0 = blockIdx.x * 128 + (vec ? 4 * threadIdx.x : threadIdx.x);
  const int dc = vec ? 1 : 32;  // column step between a thread's 4 columns
  for (int r = blockIdx.y * 8 + threadIdx.y; r < T; r += gridDim.y * 8) {
    const int64_t row = static_cast<int64_t>(r) * L;
    int k[4];
    if (vec) {
      const int4 v = c0 < L ? __ldg(reinterpret_cast<const int4*>(idx + row + c0))
                            : make_int4(-1, -1, -1, -1);
      k[0] = v.x;
      k[1] = v.y;
      k[2] = v.z;
      k[3] = v.w;
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) k[c] = c0 + c * dc < L ? __ldg(idx + row + c0 + c * dc) : -1;
    }
    float g[4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
      g[c] = k[c] >= 0 ? __ldg(table + static_cast<int64_t>(k[c]) * L + c0 + c * dc) : 0.0f;
    float* o = out + row + c0;
    if (vec) {
      if (c0 < L) *reinterpret_cast<float4*>(o) = make_float4(g[0], g[1], g[2], g[3]);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (c0 + c * dc < L) o[c * dc] = g[c];
    }
  }
}

// block b stages rows [b R, b R + R) (R = rows_per_block); thread t takes
// column group t % W of row t / W of each pass, W = min(groups a row,
// kThreads) (computed once by the launcher: per_row), rows_pass = kThreads / W
__global__ void __launch_bounds__(kThreads)
take_axis1_kernel(const float* __restrict__ table, const int32_t* __restrict__ idx,
                  float* __restrict__ out, int T, int L, int rows_per_block, int per_row,
                  bool vec) {
  extern __shared__ float4 smem[];
  float* rows = reinterpret_cast<float*>(smem);
  const int row0 = blockIdx.x * rows_per_block;
  const int nrows = min(rows_per_block, T - row0);
  const int64_t base = static_cast<int64_t>(row0) * L;
  const int n = nrows * L;
  if (vec) {
    const float4* src = reinterpret_cast<const float4*>(table + base);
    for (int e = threadIdx.x; e < n / 4; e += kThreads) smem[e] = __ldg(src + e);
  } else {
    for (int e = threadIdx.x; e < n; e += kThreads) rows[e] = __ldg(table + base + e);
  }
  __syncthreads();
  const int groups = vec ? L / 4 : L;     // column groups a row: 4 columns or 1
  const int rows_pass = kThreads / per_row;
  const int r_t = threadIdx.x / per_row, g_t = threadIdx.x % per_row;
  if (r_t >= rows_pass) return;
  for (int r = r_t; r < nrows; r += rows_pass) {
    const float* row = rows + r * L;
    const int64_t at = base + static_cast<int64_t>(r) * L;
    for (int g = g_t; g < groups; g += per_row) {
      if (vec) {
        const int4 k = __ldg(reinterpret_cast<const int4*>(idx + at) + g);
        reinterpret_cast<float4*>(out + at)[g] = make_float4(row[k.x], row[k.y], row[k.z], row[k.w]);
      } else {
        out[at + g] = row[__ldg(idx + at + g)];
      }
    }
  }
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

extern "C" {

int pixie_take_along_axis(const float* table, const int32_t* idx, float* out, int T, int L,
                          int axis, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (static_cast<int64_t>(T) * L > 0) {
    const bool vec = L % 4 == 0 && aligned16(table) && aligned16(idx) && aligned16(out);
    if (axis == 0) {
      const dim3 grid((L + 127) / 128, static_cast<unsigned>(T < 8 * 65535 ? (T + 7) / 8 : 65535));
      take_axis0_kernel<<<grid, dim3(32, 8), 0, s>>>(table, idx, out, T, L, vec);
    } else if (axis == 1) {
      const int rows = axis1_rows(L);
      const int groups = vec ? L / 4 : L;
      const int per_row = groups < kThreads ? groups : kThreads;
      take_axis1_kernel<<<(T + rows - 1) / rows, kThreads,
                          static_cast<size_t>(rows) * L * sizeof(float), s>>>(
          table, idx, out, T, L, rows, per_row, vec);
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
