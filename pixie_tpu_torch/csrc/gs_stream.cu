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
//   skipped), both clamps passing NaN as jnp.minimum does, so a NaN opacity
//   or conic fails the gate; alpha < 1/255 contributes nothing; pixel
//   centres at +0.5; no early stop when T gets small.  power and alpha are rounded op by op
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
constexpr unsigned kFull = 0xffffffffu;

// min(a, hi) that passes NaN through, as torch.clamp(max=) and jnp.minimum
// do (fminf would return hi)
__device__ __forceinline__ float clamp_max(float a, float hi) { return a > hi ? hi : a; }

// kState: also sum the colour in double into state (H*W, 4) doubles, each
// pixel's colour before the background and its final T, which the backward
// reads instead of walking twice
template <bool kState>
__global__ void __launch_bounds__(kPix)
blend_kernel(const float* __restrict__ feat, const int32_t* __restrict__ idx,
             const int32_t* __restrict__ starts, const int32_t* __restrict__ counts,
             int n_feat, int n_idx, int tx_n, int width, float bg,
             float* __restrict__ img, float* __restrict__ trans_out,
             double* __restrict__ state) {
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
  double sr = 0.0, sg = 0.0, sb = 0.0;  // kState

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
      const float alpha = clamp_max(__fmul_rn(s[8][j], expf(clamp_max(power, 0.0f))), kAlphaMax);
      if (!(alpha >= kAlphaMin)) continue;  // as the JAX mask: NaN drops too
      const float w = alpha * T;
      if constexpr (kState) {  // exact products, one rounding a sum, as the backward repeats
        sr += static_cast<double>(w) * static_cast<double>(s[5][j]);
        sg += static_cast<double>(w) * static_cast<double>(s[6][j]);
        sb += static_cast<double>(w) * static_cast<double>(s[7][j]);
      } else {
        cr += w * s[5][j];
        cg += w * s[6][j];
        cb += w * s[7][j];
      }
      T *= 1.0f - alpha;
    }
  }

  const int64_t p = static_cast<int64_t>(y) * width + x;
  if constexpr (kState) {
    cr = static_cast<float>(sr);
    cg = static_cast<float>(sg);
    cb = static_cast<float>(sb);
    double* st = state + 4 * p;
    st[0] = sr;
    st[1] = sg;
    st[2] = sb;
    st[3] = T;
  }
  img[3 * p + 0] = cr + bg * T;
  img[3 * p + 1] = cg + bg * T;
  img[3 * p + 2] = cb + bg * T;
  trans_out[p] = T;
}

// ---------------------------------------------------------------------------
// Backward: d feat (N, 9) for the cotangents d img (H, W, 3) and d trans
// (H, W), summed over every tile entry and pixel a gaussian touched.
// Replaces pixie_tpu/ops/gs_stream.py:_stream_bwd (_bwd_kernel).
//
// Per pixel, with w_j = alpha_j T_j, v_j = c_j . dC and dT the cotangent of
// T_final (bg * sum_c dC_c + d trans):
//   d alpha_j = T_j v_j - (sum_{k>j} w_k v_k + dT T_final) / (1 - alpha_j)
// then, as _bwd_kernel (gs_stream.py:176-189): d alpha is kept only where
// 0 < alpha < 0.99 (strict at the clamp), d power = d alpha * op * e where
// power < 0, and the 9 terms d mx, d my, d c0..c2, d rgb = dC w, d op =
// d alpha * e.
//
// Shape: one block of 256 threads per tile, one thread per pixel, as the
// forward.  The usual CUDA backward (the reference's backward.cu) walks
// back to front and recovers T_j by dividing T_final by (1 - alpha); that
// needs its early stop at T < 1e-4, which these semantics do not have: T
// underflows to 0 in float32 after ~20 splats at alpha 0.99 and can then no
// longer be divided back.  So the block walks its entries front to back,
// recomputing T_j as the same running product as the forward, and forms
// the suffix sum_{k>j} w_k v_k as a total minus a running prefix.  power
// and alpha are rounded op by op as in blend_kernel, so every
// "alpha >= 1/255" gate falls as it did in the forward.
//
// Bound: ~16 flops a (pixel, entry) pair and ~40 more a hit, over ~1.4e8
// pairs at 800x800, ~100k splats and tile_cap 1024.
//
// Design, from an ablation that chip_smoke.py printed while the previous
// schedule was kept (NVIDIA H100 80GB HBM3, 700 W).  That schedule took
// 1.588 ms: a first walk (pass 1) for T_final and the total S, summed in
// double, then per (warp, entry) that a lane hits a butterfly of 5
// __shfl_xor_sync for each of the 9 terms (45) and 8 per-warp partials per
// entry in 37 KB of shared memory, and no early exit.  Without its
// reduction it took 1.069 ms, without pass 1 1.123 ms.  Two steps, each
// aimed at one of the two:
//   1. the reduction: a reduce-scatter, four halving exchanges (5, 3, 2 and
//      1 shuffles) that leave each pair of lanes one of the 9 terms summed
//      over 16 lanes, and a last exchange: 12 shuffles for the 45.  The 9
//      lanes that hold a sum add it into the batch's (128, 9) sums in
//      shared memory with float atomics (compare-and-swap loops on sm_90;
//      4.6 KB for 37 KB, no block-wide sum of partials); after each batch
//      of 128 entries the block adds each nonzero sum into d feat with one
//      float atomicAdd per (entry, term).  With it (the `pass1` ablation)
//      the kernel took 1.286 ms, of which the reduction 0.184 and pass 1
//      0.500.
//   2. pass 1: the forward (blend_kernel<true>, in training) keeps each
//      pixel's colour before the background, summed in double, and its
//      T_final (state, 32 B a pixel), and pass 2 forms the suffix as
//      sum_c dC_c (colour_c - prefix_c), prefix_c the same double sums of
//      the same exact products w c_c in the same order: as exact as pass
//      1's double S - prefix, and exactly 0 after a pixel's last hit.  The
//      forward pays for the double sums and the state's writes; chip_smoke.py
//      times it beside the plain forward.  (The colour in float, 16 B a
//      pixel, held the tolerance with a 2x margin on the smoke scene, 4.9e-6
//      of a column for 1e-5: too little.)  tests/test_torch_train.py holds
//      this algebra to the plain version and to JAX's gradients on the CPU,
//      T underflow included.
// And an exact early exit: once a lane's T is 0, every later w, T_j,
// suffix and dT T_final of it is exactly 0, so the lane adds nothing; a
// warp whose lanes all have T == 0 skips its batches, and the block stops
// loading batches once all its warps have (__syncthreads_or).  Unlike the
// reference's T < 1e-4 stop this changes no result.
// The atomics make the sums depend on block and warp order: hold the kernel
// to its plain version at a tolerance, not bit for bit.
//
// Ablation modes (template flags; chip_smoke.py times them, no path of the
// port calls them): kBwdNoReduce, each thread sums its terms over all
// entries in registers and stores them once into out (pixels, 9), which
// prices the per-entry reduction; kBwdPass1, S (in double) and T_final from
// a first walk instead of the forward's state, which prices the state.
// ---------------------------------------------------------------------------

constexpr int kBwdBatch = 128;          // entries per shared-memory batch
constexpr int kBwdNoReduce = 2, kBwdPass1 = 4;

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
  r.e = expf(clamp_max(r.power, 0.0f));
  r.alpha = clamp_max(__fmul_rn(s[8][j], r.e), kAlphaMax);
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

// One halving exchange of a reduce-scatter: the lanes whose `upper` bit is
// set keep the upper half of the 2H (padded) values and send the lower, the
// others the reverse; each keeps its half plus its partner's.
template <int kIn, int kH>
__device__ __forceinline__ void halve(const float (&in)[kIn], float (&out)[kH], bool upper,
                                      int offset) {
#pragma unroll
  for (int i = 0; i < kH; ++i) {
    const float lo = in[i], hi = i + kH < kIn ? in[i + kH] : 0.0f;
    out[i] = (upper ? hi : lo) + __shfl_xor_sync(kFull, upper ? lo : hi, offset);
  }
}

// Sum of 9 values over the warp's 32 lanes, 12 shuffles: returns the sum of
// term k = 5 b4 + 3 b3 + 2 b2 + b1 (b the bits of the lane), which every
// lane holds and lanes with b0 == 0 own; k is -1 where that index is padding.
__device__ __forceinline__ float reduce_scatter9(const float (&v)[kFeat], int lane, int& k) {
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4, b1 = lane & 2;
  float a[5], c[3], e[2], r[1];
  halve(v, a, b4, 16);   // 9 (+1 pad) -> 5
  halve(a, c, b3, 8);    // 5 (+1) -> 3
  halve(c, e, b2, 4);    // 3 (+1) -> 2
  halve(e, r, b1, 2);    // 2 -> 1
  const float sum = r[0] + __shfl_xor_sync(kFull, r[0], 1);
  const int ic = (b2 ? 2 : 0) + (b1 ? 1 : 0);   // index into c
  const int ia = (b3 ? 3 : 0) + ic;             // into a
  const int iv = (b4 ? 5 : 0) + ia;             // into v
  k = (ic < 3 && ia < 5 && iv < kFeat && !(lane & 1)) ? iv : -1;
  return sum;
}

template <int kMode>
__global__ void __launch_bounds__(kPix)
blend_backward_kernel(const float* __restrict__ feat, const int32_t* __restrict__ idx,
                      const int32_t* __restrict__ starts, const int32_t* __restrict__ counts,
                      int n_feat, int n_idx, int tx_n, int width, float bg,
                      const float* __restrict__ d_img, const float* __restrict__ d_trans,
                      const double* __restrict__ state, float* __restrict__ d_feat,
                      float* __restrict__ out) {
  constexpr bool kNoReduce = kMode & kBwdNoReduce;
  constexpr bool kPass1 = kMode & kBwdPass1;
  __shared__ float s[kFeat][kBwdBatch];
  __shared__ int sg[kBwdBatch];
  __shared__ float red[kBwdBatch * kFeat];  // the batch's per-entry sums
  const int t = blockIdx.x;
  const int i = threadIdx.x;
  const int lane = i & 31;
  const int x = (t % tx_n) * kTile + (i % kTile);
  const int y = (t / tx_n) * kTile + (i / kTile);
  const float px = static_cast<float>(x) + 0.5f;
  const float py = static_cast<float>(y) + 0.5f;
  const int64_t p = static_cast<int64_t>(y) * width + x;
  const float dr = d_img[3 * p + 0], dg = d_img[3 * p + 1], db = d_img[3 * p + 2];
  const float dT = bg * (dr + dg + db) + d_trans[p];

  const int start = starts[t];
  const int count = (start < 0 || start > n_idx) ? 0 : max(0, min(counts[t], n_idx - start));
  for (int q = i; q < kBwdBatch * kFeat; q += kPix) red[q] = 0.0f;

  // T_final and S = sum_k w_k v_k: from the forward's state or (kPass1)
  // from a first walk
  float T = 1.0f;
  double S = 0.0;
  double fr = 0.0, fg = 0.0, fb = 0.0;  // the forward's colour sums
  if constexpr (!kPass1) {
    fr = state[4 * p + 0];
    fg = state[4 * p + 1];
    fb = state[4 * p + 2];
    T = static_cast<float>(state[4 * p + 3]);
  } else {
    for (int base = 0; base < count; base += kBwdBatch) {
      if (!__syncthreads_or(T != 0.0f)) break;  // every pixel opaque: S is final
      const int m = min(kBwdBatch, count - base);
      load_batch(s, sg, feat, idx, n_feat, start + base, m, i);
      if (__all_sync(kFull, T == 0.0f)) continue;
      for (int j = 0; j < m; ++j) {
        const SplatGeom gm = splat_geom(s, j, px, py);
        if (!(gm.alpha >= kAlphaMin)) continue;
        const float w = gm.alpha * T;
        S += static_cast<double>(w) * static_cast<double>(color_dot(s, j, dr, dg, db));
        T *= 1.0f - gm.alpha;
      }
    }
  }
  const float dTT = dT * T;

  // pass 2: per-entry gradients
  T = 1.0f;
  double prefix = 0.0;
  double pr = 0.0, pg = 0.0, pb = 0.0;  // the forward's colour sums, repeated
  float total[kFeat];  // kNoReduce
#pragma unroll
  for (int k = 0; k < kFeat; ++k) total[k] = 0.0f;
  for (int base = 0; base < count; base += kBwdBatch) {
    if (!__syncthreads_or(T != 0.0f)) break;  // no pixel adds anything more
    const int m = min(kBwdBatch, count - base);
    load_batch(s, sg, feat, idx, n_feat, start + base, m, i);
    if (__any_sync(kFull, T != 0.0f)) {
      for (int j = 0; j < m; ++j) {
        const SplatGeom gm = splat_geom(s, j, px, py);
        // as the forward: NaN drops too; T == 0 adds exactly 0
        const bool hit = gm.alpha >= kAlphaMin && T != 0.0f;
        float term[kFeat];
#pragma unroll
        for (int k = 0; k < kFeat; ++k) term[k] = 0.0f;
        if (hit) {
          const float w = gm.alpha * T;
          const float v = color_dot(s, j, dr, dg, db);
          float suffix;  // sum over the later entries of w_k v_k
          if constexpr (!kPass1) {
            pr += static_cast<double>(w) * static_cast<double>(s[5][j]);
            pg += static_cast<double>(w) * static_cast<double>(s[6][j]);
            pb += static_cast<double>(w) * static_cast<double>(s[7][j]);
            suffix = static_cast<float>(static_cast<double>(dr) * (fr - pr) +
                                        static_cast<double>(dg) * (fg - pg) +
                                        static_cast<double>(db) * (fb - pb));
          } else {
            prefix += static_cast<double>(w) * static_cast<double>(v);
            suffix = static_cast<float>(S - prefix);
          }
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
        if constexpr (kNoReduce) {
#pragma unroll
          for (int k = 0; k < kFeat; ++k) total[k] += term[k];
        } else if (__any_sync(kFull, hit)) {
          int k;
          const float sum = reduce_scatter9(term, lane, k);
          if (k >= 0 && sum != 0.0f) atomicAdd(red + j * kFeat + k, sum);
        }
      }
    }
    if constexpr (!kNoReduce) {
      __syncthreads();
      for (int q = i; q < m * kFeat; q += kPix) {
        const int j = q / kFeat, k = q % kFeat;
        const float sum = red[q];
        red[q] = 0.0f;
        if (sg[j] >= 0 && sum != 0.0f)
          atomicAdd(d_feat + static_cast<int64_t>(kFeat) * sg[j] + k, sum);
      }
    }
  }
  if constexpr (kNoReduce) {
#pragma unroll
    for (int k = 0; k < kFeat; ++k) out[kFeat * p + k] = total[k];
  }
}

}  // namespace

extern "C" {

// state (H*W, 4) double, or null: each pixel's colour before the background
// (summed in double) and its final T, which the backward reads instead of
// walking twice
int pixie_gs_blend(const float* feat, const int32_t* idx, const int32_t* starts,
                   const int32_t* counts, int n_feat, int n_idx, int n_tiles, int tx_n,
                   float bg, float* img, float* trans, double* state, void* stream) {
  if (n_tiles > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (state != nullptr)
      blend_kernel<true><<<n_tiles, kPix, 0, s>>>(feat, idx, starts, counts, n_feat, n_idx, tx_n,
                                                  tx_n * kTile, bg, img, trans, state);
    else
      blend_kernel<false><<<n_tiles, kPix, 0, s>>>(feat, idx, starts, counts, n_feat, n_idx,
                                                   tx_n, tx_n * kTile, bg, img, trans, state);
  }
  return static_cast<int>(cudaGetLastError());
}

// mode 0 is the shipped backward, into d_feat (N, 9) zeroed by the caller,
// reading state (H*W, 4) that the forward kept; the ablation modes: 2
// noreduce (per-pixel sums into out (H*W, 9) instead), 4 pass1 (S and
// T_final from a first walk, not from state)
int pixie_gs_blend_backward(int mode, const float* feat, const int32_t* idx,
                            const int32_t* starts, const int32_t* counts, int n_feat, int n_idx,
                            int n_tiles, int tx_n, float bg, const float* d_img,
                            const float* d_trans, const double* state, float* d_feat, float* out,
                            void* stream) {
  if (n_tiles > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PIXIE_BWD_LAUNCH(M)                                                                  \
  blend_backward_kernel<M><<<n_tiles, kPix, 0, s>>>(feat, idx, starts, counts, n_feat, n_idx, \
                                                    tx_n, tx_n * kTile, bg, d_img, d_trans,  \
                                                    state, d_feat, out)
    switch (mode) {
      case 0: PIXIE_BWD_LAUNCH(0); break;
      case kBwdNoReduce: PIXIE_BWD_LAUNCH(kBwdNoReduce); break;
      case kBwdPass1: PIXIE_BWD_LAUNCH(kBwdPass1); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef PIXIE_BWD_LAUNCH
  }
  return static_cast<int>(cudaGetLastError());
}

const char* pixie_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
