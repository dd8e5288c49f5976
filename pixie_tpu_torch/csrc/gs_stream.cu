// Front-to-back Gaussian-splat tile blend for NVIDIA Hopper (sm_90a).
//
// Replaces pixie_tpu/ops/gs_stream.py:blend_stream (its forward kernel
// _fwd_kernel): per 16x16 pixel tile, composite the tile's depth-sorted
// splat list front to back and write color + bg * T and the final
// transmittance T.  Plain C interface, loaded with ctypes
// (pixie_tpu_torch/ops/gs_stream.py); the launcher takes PyTorch's current
// stream, never synchronizes, allocates nothing and returns
// cudaGetLastError().
//
// Inputs (built by pixie_tpu_torch/recon/rasterizer.py:rasterize_tiled):
//   feat    (N, 9)  per gaussian [mx, my, conic c0 c1 c2, r g b, opacity]
//   idx     (M,)    gaussian index of each (tile, depth)-sorted entry
//   starts  (T,)    first entry of tile t in idx
//   counts  (T,)    entries blended for tile t (already capped at tile_cap)
//
// Design: the reference rasterizer's shape (forward.cu renderCUDA), one
// block of 256 threads per tile, one thread per pixel.  The block walks its
// tile's entries in batches of 256: each thread gathers one splat's 9 floats
// (through idx) into shared memory, the block syncs, and every thread
// composites the batch in order in registers.  All threads read the same
// shared splat at once, a broadcast without bank conflicts.
//
// Bound: one expf and ~15 flops per (pixel, splat) pair plus the gathered
// loads, at most tile_cap (512) splats x 256 pixels per tile; at 800x800
// and ~100k splats that is ~1e8 pairs a frame.  The 9-float gathers are
// random rows of a 3.6 MB table that stays in L2.
//
// The TPU kernel forms the exclusive transmittance of a 128-splat chunk as
// a matmul of log(1 - alpha) with a triangular matrix, which puts the scan
// on the MXU.  Here each thread owns one pixel, so the transmittance is a
// running product in a register: cheaper than any matrix form, and exact
// where the log-domain form rounds.
//
// Semantics mirrored from _fwd_kernel / _chunk_geometry (gs_stream.py:69-125):
//   alpha = min(0.99, op * exp(min(power, 0))), power > 0 clamped (not
//   skipped); alpha < 1/255 contributes nothing; pixel centres at +0.5; no
//   early stop when T gets small.  power and alpha are rounded op by op
//   (__fmul_rn / __fadd_rn / __fsub_rn) in the order the plain PyTorch
//   version evaluates them, so no FMA contraction can move an alpha across
//   the 1/255 cut relative to it.
//
// Entries whose position or gaussian index lies outside idx / feat are
// skipped rather than read.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;  // threads per block = pixels per tile
constexpr int kFeat = 9;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;

__global__ void __launch_bounds__(kPix)
blend_kernel(const float* __restrict__ feat, const int32_t* __restrict__ idx,
             const int32_t* __restrict__ starts, const int32_t* __restrict__ counts,
             int n_feat, int n_idx, int tx_n, int width, float bg,
             float* __restrict__ img, float* __restrict__ trans_out) {
  __shared__ float s[kFeat][kPix];
  const int t = blockIdx.x;
  const int i = threadIdx.x;
  const int x = (t % tx_n) * kTile + (i % kTile);
  const int y = (t / tx_n) * kTile + (i / kTile);
  const float px = static_cast<float>(x) + 0.5f;
  const float py = static_cast<float>(y) + 0.5f;

  const int start = starts[t];
  const int count = (start < 0 || start > n_idx) ? 0 : max(0, min(counts[t], n_idx - start));
  float T = 1.0f, cr = 0.0f, cg = 0.0f, cb = 0.0f;

  for (int base = 0; base < count; base += kPix) {
    const int m = min(kPix, count - base);
    __syncthreads();  // the previous batch has been consumed
    if (i < m) {
      const int g = idx[start + base + i];
      const bool ok = g >= 0 && g < n_feat;
      const float* row = feat + static_cast<int64_t>(kFeat) * (ok ? g : 0);
#pragma unroll
      for (int k = 0; k < kFeat; ++k) s[k][i] = ok ? row[k] : 0.0f;  // op 0: transparent
    }
    __syncthreads();
    for (int j = 0; j < m; ++j) {
      const float dx = __fsub_rn(px, s[0][j]);
      const float dy = __fsub_rn(py, s[1][j]);
      // power = -0.5 * (c0 dx dx + c2 dy dy) - c1 dx dy
      const float q = __fadd_rn(__fmul_rn(__fmul_rn(s[2][j], dx), dx),
                                __fmul_rn(__fmul_rn(s[4][j], dy), dy));
      const float power = __fsub_rn(__fmul_rn(-0.5f, q),
                                    __fmul_rn(__fmul_rn(s[3][j], dx), dy));
      const float alpha = fminf(__fmul_rn(s[8][j], expf(fminf(power, 0.0f))), kAlphaMax);
      if (!(alpha >= kAlphaMin)) continue;  // as the JAX mask: NaN drops too
      const float w = alpha * T;
      cr += w * s[5][j];
      cg += w * s[6][j];
      cb += w * s[7][j];
      T *= 1.0f - alpha;
    }
  }

  const int64_t p = static_cast<int64_t>(y) * width + x;
  img[3 * p + 0] = cr + bg * T;
  img[3 * p + 1] = cg + bg * T;
  img[3 * p + 2] = cb + bg * T;
  trans_out[p] = T;
}

}  // namespace

extern "C" {

int pixie_gs_blend(const float* feat, const int32_t* idx, const int32_t* starts,
                   const int32_t* counts, int n_feat, int n_idx, int n_tiles, int tx_n,
                   float bg, float* img, float* trans, void* stream) {
  if (n_tiles > 0) {
    blend_kernel<<<n_tiles, kPix, 0, static_cast<cudaStream_t>(stream)>>>(
        feat, idx, starts, counts, n_feat, n_idx, tx_n, tx_n * kTile, bg, img, trans);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* pixie_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
