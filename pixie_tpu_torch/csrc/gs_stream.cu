// Front-to-back Gaussian-splat tile blend and its gradient for NVIDIA
// Hopper (sm_90a).
//
// blend_kernel replaces pixie_tpu/ops/gs_stream.py:blend_stream (its
// forward kernel _fwd_kernel): per 16x16 pixel tile, composite the tile's
// depth-sorted splat list front to back and write color + bg * T and the
// final transmittance T.  blend_backward_kernel replaces its VJP
// (_stream_bwd / _bwd_kernel); its own note is further down.  Plain C
// interface, loaded with ctypes (pixie_tpu_torch/ops/gs_stream.py); the
// launchers take PyTorch's current stream, never synchronize, allocate
// nothing and return cudaGetLastError().
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

// ---------------------------------------------------------------------------
// Backward: d feat (N, 9) for the cotangents d img (H, W, 3) and d trans
// (H, W), summed over every tile entry and pixel a gaussian touched.
//
// Per pixel, with w_j = alpha_j T_j, v_j = c_j . dC and dT the cotangent of
// T_final (bg * sum_c dC_c + d trans):
//   d alpha_j = T_j v_j - (sum_{k>j} w_k v_k + dT T_final) / (1 - alpha_j)
// then, as _bwd_kernel (gs_stream.py:176-189): d alpha is kept only where
// 0 < alpha < 0.99 (strict at the clamp), d power = d alpha * op * e where
// power < 0, and the 9 terms d mx, d my, d c0..c2, d rgb = dC w, d op =
// d alpha * e.
//
// Design: one block of 256 threads per tile, one thread per pixel, as the
// forward.  The usual CUDA backward (the reference's backward.cu) walks
// back to front and recovers T_j by dividing T_final by (1 - alpha); that
// needs its early stop at T < 1e-4, which these semantics do not have: T
// underflows to 0 in float32 after ~20 splats at alpha 0.99 and can then no
// longer be divided back.  So the block walks its entries front to back
// twice.  Pass 1 recomputes T_final and the total S = sum_k w_k v_k; pass 2
// recomputes T_j as the same running product as the forward and forms the
// suffix sum as S minus a running prefix.  S and the prefix are summed in
// double over the same float products in the same order, so the suffix is
// exact where the float form would cancel, and exactly 0 once T has
// underflowed.  power and alpha are rounded op by op as in blend_kernel, so
// every "alpha >= 1/255" gate falls as it did in the forward.
//
// Accumulation: a gaussian sits in up to 36 tiles and 256 pixels a tile.
// For each entry the 9 per-pixel terms are summed across each warp with
// shuffles (skipped when no lane of the warp touches the splat), the 8 warp
// sums land in shared memory, and after each batch of 128 entries the block
// sums them and adds each into d feat with one float atomicAdd per
// (entry, term).
// The atomics make the sums depend on block order: hold the kernel to its
// plain version at a tolerance, not bit for bit.
//
// Bound: two forward walks plus ~40 flops and up to 45 shuffles per (pixel
// warp, splat); at 800x800, ~100k splats and tile_cap 1024 that is ~3e8
// pairs.  The atomics, one per (tile entry, term), go to a 3.6 MB table that
// stays in L2.
// ---------------------------------------------------------------------------

constexpr int kBwdBatch = 128;          // entries per shared-memory batch
constexpr int kWarps = kPix / 32;

struct SplatGeom {
  float dx, dy, power, e, alpha;
};

// power, e and alpha exactly as blend_kernel rounds them
__device__ __forceinline__ SplatGeom splat_geom(float (*s)[kBwdBatch], int j,
                                                float px, float py) {
  SplatGeom r;
  r.dx = __fsub_rn(px, s[0][j]);
  r.dy = __fsub_rn(py, s[1][j]);
  const float q = __fadd_rn(__fmul_rn(__fmul_rn(s[2][j], r.dx), r.dx),
                            __fmul_rn(__fmul_rn(s[4][j], r.dy), r.dy));
  r.power = __fsub_rn(__fmul_rn(-0.5f, q), __fmul_rn(__fmul_rn(s[3][j], r.dx), r.dy));
  r.e = expf(fminf(r.power, 0.0f));
  r.alpha = fminf(__fmul_rn(s[8][j], r.e), kAlphaMax);
  return r;
}

// c_j . dC, rounded op by op so that both passes get the same float
__device__ __forceinline__ float color_dot(float (*s)[kBwdBatch], int j, float dr,
                                           float dg, float db) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dr, s[5][j]), __fmul_rn(dg, s[6][j])),
                   __fmul_rn(db, s[7][j]));
}

// gather entries [base, base + m) of the tile into shared memory; rows of
// an invalid index read as zeros (opacity 0: transparent), index -1
__device__ __forceinline__ void load_batch(float (*s)[kBwdBatch], int* sg,
                                           const float* __restrict__ feat,
                                           const int32_t* __restrict__ idx, int n_feat,
                                           int first, int m, int i) {
  __syncthreads();  // the previous batch has been consumed
  if (i < m) {
    const int g = idx[first + i];
    const bool ok = g >= 0 && g < n_feat;
    const float* row = feat + static_cast<int64_t>(kFeat) * (ok ? g : 0);
#pragma unroll
    for (int k = 0; k < kFeat; ++k) s[k][i] = ok ? row[k] : 0.0f;
    sg[i] = ok ? g : -1;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kPix)
blend_backward_kernel(const float* __restrict__ feat, const int32_t* __restrict__ idx,
                      const int32_t* __restrict__ starts, const int32_t* __restrict__ counts,
                      int n_feat, int n_idx, int tx_n, int width, float bg,
                      const float* __restrict__ d_img, const float* __restrict__ d_trans,
                      float* __restrict__ d_feat) {
  __shared__ float s[kFeat][kBwdBatch];
  __shared__ int sg[kBwdBatch];
  __shared__ float part[kWarps][kBwdBatch][kFeat];
  const int t = blockIdx.x;
  const int i = threadIdx.x;
  const int lane = i & 31, warp = i >> 5;
  const int x = (t % tx_n) * kTile + (i % kTile);
  const int y = (t / tx_n) * kTile + (i / kTile);
  const float px = static_cast<float>(x) + 0.5f;
  const float py = static_cast<float>(y) + 0.5f;
  const int64_t p = static_cast<int64_t>(y) * width + x;
  const float dr = d_img[3 * p + 0], dg = d_img[3 * p + 1], db = d_img[3 * p + 2];
  const float dT = bg * (dr + dg + db) + d_trans[p];

  const int start = starts[t];
  const int count = (start < 0 || start > n_idx) ? 0 : max(0, min(counts[t], n_idx - start));

  // pass 1: T_final and S = sum_k w_k v_k
  float T = 1.0f;
  double S = 0.0;
  for (int base = 0; base < count; base += kBwdBatch) {
    const int m = min(kBwdBatch, count - base);
    load_batch(s, sg, feat, idx, n_feat, start + base, m, i);
    for (int j = 0; j < m; ++j) {
      const SplatGeom gm = splat_geom(s, j, px, py);
      if (!(gm.alpha >= kAlphaMin)) continue;
      const float w = gm.alpha * T;
      S += static_cast<double>(w) * static_cast<double>(color_dot(s, j, dr, dg, db));
      T *= 1.0f - gm.alpha;
    }
  }
  const float dTT = dT * T;

  // pass 2: per-entry gradients
  T = 1.0f;
  double prefix = 0.0;
  for (int base = 0; base < count; base += kBwdBatch) {
    const int m = min(kBwdBatch, count - base);
    load_batch(s, sg, feat, idx, n_feat, start + base, m, i);
    for (int j = 0; j < m; ++j) {
      const SplatGeom gm = splat_geom(s, j, px, py);
      const bool hit = gm.alpha >= kAlphaMin;  // as the forward: NaN drops too
      float term[kFeat];
#pragma unroll
      for (int k = 0; k < kFeat; ++k) term[k] = 0.0f;
      if (hit) {
        const float w = gm.alpha * T;
        const float v = color_dot(s, j, dr, dg, db);
        prefix += static_cast<double>(w) * static_cast<double>(v);
        const float suffix = static_cast<float>(S - prefix);
        const float d_alpha = T * v - (suffix + dTT) / (1.0f - gm.alpha);
        const float d_ae = gm.alpha < kAlphaMax ? d_alpha : 0.0f;
        const float d_pow = gm.power < 0.0f ? d_ae * s[8][j] * gm.e : 0.0f;
        const float c0 = s[2][j], c1 = s[3][j], c2 = s[4][j];
        term[0] = d_pow * (c0 * gm.dx + c1 * gm.dy);
        term[1] = d_pow * (c2 * gm.dy + c1 * gm.dx);
        term[2] = d_pow * (-0.5f * gm.dx * gm.dx);
        term[3] = d_pow * (-gm.dx * gm.dy);
        term[4] = d_pow * (-0.5f * gm.dy * gm.dy);
        term[5] = dr * w;
        term[6] = dg * w;
        term[7] = db * w;
        term[8] = d_ae * gm.e;
        T *= 1.0f - gm.alpha;
      }
      if (__any_sync(0xffffffffu, hit)) {
#pragma unroll
        for (int k = 0; k < kFeat; ++k) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            term[k] += __shfl_xor_sync(0xffffffffu, term[k], off);
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int k = 0; k < kFeat; ++k) part[warp][j][k] = term[k];
      }
    }
    __syncthreads();
    for (int q = i; q < m * kFeat; q += kPix) {
      const int j = q / kFeat, k = q % kFeat;
      float sum = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += part[w][j][k];
      if (sg[j] >= 0 && sum != 0.0f) atomicAdd(d_feat + static_cast<int64_t>(kFeat) * sg[j] + k, sum);
    }
  }
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

int pixie_gs_blend_backward(const float* feat, const int32_t* idx, const int32_t* starts,
                            const int32_t* counts, int n_feat, int n_idx, int n_tiles,
                            int tx_n, float bg, const float* d_img, const float* d_trans,
                            float* d_feat, void* stream) {
  if (n_tiles > 0) {
    blend_backward_kernel<<<n_tiles, kPix, 0, static_cast<cudaStream_t>(stream)>>>(
        feat, idx, starts, counts, n_feat, n_idx, tx_n, tx_n * kTile, bg, d_img, d_trans,
        d_feat);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* pixie_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
