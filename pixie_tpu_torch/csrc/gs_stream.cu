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
// thread per pixel, here two blocks a tile, each on 8 of its 16 rows
// (kSplit, kPartRows).  At 800x800 only ~800 of 2500 tiles hold entries, all
// in one wave of blocks, so the busiest SM sets the time: half tiles share
// the work out more evenly (quarter tiles did no better).  A block walks its tile's
// entries in batches of one entry a thread, each thread staging one into
// shared memory, and every thread composites the batch in order in
// registers.  Three things keep a thread's work per (pixel, entry) pair
// small, and a fourth its latency hidden:
//   1. packed staging: an entry's gate inputs are one float4 (mx, my,
//      -c0/2, -c1) and one float2 (-c2/2, opacity), so a pair costs two
//      shared loads, not nine, and the colour (as doubles, where the state
//      is kept) is read only on a hit.  Scaling the conic by -1/2 and -1 is
//      exact in float (bar subnormals), so power is the bits the plain
//      order of operations gives;
//   2. per-warp entry lists: the staging thread also bounds the pixels its
//      entry can pass the alpha >= 1/255 gate at (blend_box, below), and each
//      warp, an 8 x 4 block of pixels, ballots the batch's boxes against its
//      rectangle, 32 entries a ballot, then walks only the entries whose box
//      meets it, in order.  A skipped entry fails the gate at every pixel of
//      the warp, where the plain version adds nothing, so the lists change
//      no result;
//   3. an exact early exit: once a pixel's T is 0, every later w and T is 0
//      and adds exactly 0 (for finite colours); a warp whose T are all 0
//      skips its batches, and the block stops once every warp has
//      (__syncthreads_or);
//   4. the list is walked two entries at a time: both gates (independent of
//      T) in flight, then the two blends in order.
// All threads read the same shared entry at once, a broadcast without bank
// conflicts.
//
// Bound: one expf and ~16 flops per (pixel, entry) pair for the gate, at
// most tile_cap entries x 256 pixels per tile (~1.4e8 pairs a training step
// at 800x800, ~100k splats, tile_cap 1024); the lists cut the pairs a thread
// evaluates, not the bound's count.  The gathered rows (36 B) come from a
// 3.6 MB table that stays in L2.
//
// The schedule before this one (one block of 256 threads a tile, each entry
// staged as 9 scalar floats, no lists, no early exit) took 0.4761-0.5531 ms
// against this kernel's 0.2814-0.3415 at tile_cap 1024 keeping the state,
// with img, T and state bit for bit the same (PERF.md); it was then
// deleted.  The mode `nolists` (1, no per-warp lists, one gate at a time)
// is the tests' bitwise reference that the lists drop no hit.
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
//   centres at +0.5.  power and alpha are rounded op by op
//   (__fmul_rn / __fadd_rn / __fsub_rn) in the order the plain PyTorch
//   version evaluates them, so no FMA contraction can move an alpha across
//   the 1/255 cut relative to it.
//
// Entries whose position or gaussian index lies outside idx / feat are
// skipped rather than read.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// ---------------------------------------------------------------------------
// The pixels an entry can pass the gate at.  The gate passes only where
//   op * exp(power) >= 1/255, i.e. q = -2 power <= 2 L, L = ln(op 255),
// with power rounded in float.  For a positive definite conic Q = [[c0, c1],
// [c1, c2]] the exact q of (dx, dy) is d^T Q d, and its float value differs
// from it by at most a relative eta <= 32 u k, u = 2^-24 and
// k = (1 + |r|) / (1 - |r|), r = c1 / sqrt(c0 c2), the ratio of the sum of
// the terms' magnitudes to q (the six roundings of power and the two of dx,
// dy, with a factor of two to spare).  So the gate passes only inside the
// ellipse d^T Q d <= 2 L' with L' = (L + 2e-4 + 1e-6 L) / (1 - eta) (2e-4
// for the float logf, expf and the product's roundings), whose box has half
// widths sqrt(2 L' c2 / det) and sqrt(2 L' c0 / det), det = c0 c2 - c1^2;
// they are widened by 1e-4 of themselves and 1e-3 pixel for the float
// rounding of the box itself.  Where Q is not safely positive definite
// (r^2 >= 0.998, a non-positive or non-finite c0, c2, c1), the box is the
// whole plane; where op < 1/255 or is NaN, op exp(power) <= op fails the gate
// everywhere and the box is empty.  gs_stream.py:blend_box_plain is the
// same computation in PyTorch; tests/test_torch_render.py holds it to the
// plain gate.
// ---------------------------------------------------------------------------
constexpr float kInf = __builtin_huge_valf();

__device__ __forceinline__ float4 blend_box(float mx, float my, float c0, float c1, float c2,
                                            float op) {
  if (!(op >= kAlphaMin)) return make_float4(kInf, -kInf, kInf, -kInf);  // never passes
  const float r2 = (c1 * c1) / (c0 * c2);
  const bool pd = c0 > 0.0f && c2 > 0.0f && c0 < kInf && c2 < kInf && fabsf(c1) < kInf &&
                  r2 < 0.998f;
  float hx = kInf, hy = kInf;
  if (pd) {
    const float r = sqrtf(r2);
    const float eta = 32.0f * 5.9604645e-8f * (1.0f + r) / (1.0f - r);
    const float lg = logf(op) - logf(kAlphaMin);
    const float l2 = 2.0f * (lg + 2e-4f + 1e-6f * lg) / (1.0f - eta);
    const float det = c0 * c2 - c1 * c1;
    hx = sqrtf(l2 * c2 / det) * 1.0001f + 1e-3f;
    hy = sqrtf(l2 * c0 / det) * 1.0001f + 1e-3f;
    if (!(hx >= 0.0f) || !(hy >= 0.0f)) hx = hy = kInf;  // NaN: no bound
  }
  if (hx == kInf || hy == kInf) return make_float4(-kInf, kInf, -kInf, kInf);
  return make_float4(mx - hx, mx + hx, my - hy, my + hy);
}

// kBlendNoLists: the tests' bitwise reference that the lists drop no hit
enum BlendMode : int { kBlendShipped = 0, kBlendNoLists = 1 };

// blend_kernel: kSplit blocks a tile, each on kPartRows of its rows, kThreadsB
// threads (a warp an 8 x 4 block of pixels)
constexpr int kSplit = 2, kPartRows = kTile / kSplit, kThreadsB = kTile * kPartRows;

template <bool kState, int kMode>
__global__ void __launch_bounds__(kThreadsB)
blend_kernel(const float* __restrict__ feat, const int32_t* __restrict__ idx,
             const int32_t* __restrict__ starts, const int32_t* __restrict__ counts,
             int n_feat, int n_idx, int tx_n, int width, float bg,
             float* __restrict__ img, float* __restrict__ trans_out,
             double* __restrict__ state) {
  constexpr bool kLists = kMode == kBlendShipped;
  using Colour = std::conditional_t<kState, double, float>;
  __shared__ float4 s_geo[kThreadsB];   // mx, my, -c0/2, -c1
  __shared__ float2 s_geo2[kThreadsB];  // -c2/2, op
  __shared__ float4 s_box[kThreadsB];   // x0, x1, y0, y1 (kLists)
  __shared__ Colour s_col[3][kThreadsB];
  // block b takes rows kPartRows (b % kSplit) .. + kPartRows - 1 of tile b / kSplit
  const int part = blockIdx.x % kSplit;
  const int t = blockIdx.x / kSplit;
  const int i = threadIdx.x;
  const int lane = i & 31, warp = i >> 5;
  // a warp takes an 8 x 4 block of the tile's pixels (the lists' rectangle)
  const int x0 = (t % tx_n) * kTile + (warp & 1) * 8;
  const int y0 = (t / tx_n) * kTile + part * kPartRows + (warp >> 1) * 4;
  const int x = x0 + (lane & 7);
  const int y = y0 + (lane >> 3);
  const float px = static_cast<float>(x) + 0.5f;
  const float py = static_cast<float>(y) + 0.5f;
  const float wx0 = static_cast<float>(x0) + 0.5f, wx1 = wx0 + 7.0f;
  const float wy0 = static_cast<float>(y0) + 0.5f, wy1 = wy0 + 3.0f;

  const int start = starts[t];
  const int count = (start < 0 || start > n_idx) ? 0 : max(0, min(counts[t], n_idx - start));
  float T = 1.0f;
  Colour cr = 0, cg = 0, cb = 0;

  // the pair (this pixel, staged entry j): alpha, or 0 where the gate fails
  auto gate = [&](int j) {
    const float4 a = s_geo[j];
    const float2 b = s_geo2[j];
    const float dx = __fsub_rn(px, a.x);
    const float dy = __fsub_rn(py, a.y);
    // -0.5 (c0 dx dx + c2 dy dy) - c1 dx dy, scaled terms: the same bits
    const float power = __fadd_rn(__fadd_rn(__fmul_rn(__fmul_rn(a.z, dx), dx),
                                            __fmul_rn(__fmul_rn(b.x, dy), dy)),
                                  __fmul_rn(__fmul_rn(a.w, dx), dy));
    const float alpha = clamp_max(__fmul_rn(b.y, expf(clamp_max(power, 0.0f))), kAlphaMax);
    return alpha >= kAlphaMin ? alpha : 0.0f;  // as the JAX mask: NaN drops too
  };
  auto blend = [&](int j, float alpha) {
    const float w = alpha * T;
    if constexpr (kState) {  // exact products, one rounding a sum, as the backward repeats
      const double wd = static_cast<double>(w);
      cr += wd * s_col[0][j];
      cg += wd * s_col[1][j];
      cb += wd * s_col[2][j];
    } else {
      cr += w * s_col[0][j];
      cg += w * s_col[1][j];
      cb += w * s_col[2][j];
    }
    T *= 1.0f - alpha;
  };

  for (int base = 0; base < count; base += kThreadsB) {
    if (!__syncthreads_or(T != 0.0f)) break;  // every pixel opaque: nothing more to add
    const int m = min(kThreadsB, count - base);
    if (i < m) {
      const int g = idx[start + base + i];
      const bool ok = g >= 0 && g < n_feat;
      const float* row = feat + static_cast<int64_t>(kFeat) * (ok ? g : 0);
      float f[kFeat];
#pragma unroll
      for (int k = 0; k < kFeat; ++k) f[k] = ok ? row[k] : 0.0f;  // op 0: transparent
      s_geo[i] = make_float4(f[0], f[1], -0.5f * f[2], -f[3]);
      s_geo2[i] = make_float2(-0.5f * f[4], f[8]);
      s_col[0][i] = f[5];
      s_col[1][i] = f[6];
      s_col[2][i] = f[7];
      if constexpr (kLists) s_box[i] = blend_box(f[0], f[1], f[2], f[3], f[4], f[8]);
    }
    __syncthreads();
    if (__all_sync(kFull, T == 0.0f)) continue;  // this warp adds nothing more
    if constexpr (kLists) {
      for (int c = 0; c < m; c += 32) {
        const int jl = c + lane;
        bool meets = false;
        if (jl < m) {
          const float4 bx = s_box[jl];
          meets = bx.x <= wx1 && bx.y >= wx0 && bx.z <= wy1 && bx.w >= wy0;
        }
        // two gates in flight, then the two blends in order
        for (unsigned list = __ballot_sync(kFull, meets); list != 0u;) {
          const int j0 = c + __ffs(list) - 1;
          list &= list - 1u;
          if (list != 0u) {
            const int j1 = c + __ffs(list) - 1;
            list &= list - 1u;
            const float a0 = gate(j0), a1 = gate(j1);
            if (a0 != 0.0f) blend(j0, a0);
            if (a1 != 0.0f) blend(j1, a1);
          } else {
            const float a0 = gate(j0);
            if (a0 != 0.0f) blend(j0, a0);
          }
        }
      }
    } else {
      for (int j = 0; j < m; ++j) {
        const float alpha = gate(j);
        if (alpha != 0.0f) blend(j, alpha);
      }
    }
  }

  const int64_t p = static_cast<int64_t>(y) * width + x;
  float fr, fg, fb;
  if constexpr (kState) {
    fr = static_cast<float>(cr);
    fg = static_cast<float>(cg);
    fb = static_cast<float>(cb);
    double* st = state + 4 * p;
    st[0] = cr;
    st[1] = cg;
    st[2] = cb;
    st[3] = T;
  } else {
    fr = cr;
    fg = cg;
    fb = cb;
  }
  img[3 * p + 0] = fr + bg * T;
  img[3 * p + 1] = fg + bg * T;
  img[3 * p + 2] = fb + bg * T;
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
// the suffix sum_{k>j} w_k v_k from the forward's colour sums minus a
// running prefix (step 2 below).  power
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
// aimed at one of the two (the ablations that priced them are deleted):
//   1. the reduction: a reduce-scatter, four halving exchanges (5, 3, 2 and
//      1 shuffles) that leave each pair of lanes one of the 9 terms summed
//      over 16 lanes, and a last exchange: 12 shuffles for the 45.  The 9
//      lanes that hold a sum add it into the batch's (128, 9) sums in
//      shared memory with float atomics (compare-and-swap loops on sm_90;
//      4.6 KB for 37 KB, no block-wide sum of partials); after each batch
//      of 128 entries the block adds each nonzero sum into d feat with one
//      float atomicAdd per (entry, term).  With it, and still pass 1, the
//      kernel took 1.286 ms, of which the reduction 0.184 and pass 1
//      0.500.
//   2. pass 1: the forward (blend_kernel<true>, in training) keeps each
//      pixel's colour before the background, summed in double, and its
//      T_final (state, 32 B a pixel), and the one walk forms the suffix as
//      sum_c dC_c (colour_c - prefix_c), prefix_c the same double sums of
//      the same exact products w c_c in the same order: as exact as pass
//      1's double S - prefix was, and exactly 0 after a pixel's last hit.
//      The forward pays for the double sums and the state's writes; chip_smoke.py
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
// ---------------------------------------------------------------------------

constexpr int kBwdBatch = 128;          // entries per shared-memory batch

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

// c_j . dC, rounded op by op
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

__global__ void __launch_bounds__(kPix)
blend_backward_kernel(const float* __restrict__ feat, const int32_t* __restrict__ idx,
                      const int32_t* __restrict__ starts, const int32_t* __restrict__ counts,
                      int n_feat, int n_idx, int tx_n, int width, float bg,
                      const float* __restrict__ d_img, const float* __restrict__ d_trans,
                      const double* __restrict__ state, float* __restrict__ d_feat) {
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

  // the forward's colour sums and T_final
  const double fr = state[4 * p + 0], fg = state[4 * p + 1], fb = state[4 * p + 2];
  const float dTT = dT * static_cast<float>(state[4 * p + 3]);

  float T = 1.0f;
  double pr = 0.0, pg = 0.0, pb = 0.0;  // the forward's colour sums, repeated
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
          pr += static_cast<double>(w) * static_cast<double>(s[5][j]);
          pg += static_cast<double>(w) * static_cast<double>(s[6][j]);
          pb += static_cast<double>(w) * static_cast<double>(s[7][j]);
          // sum over the later entries of w_k v_k
          const float suffix = static_cast<float>(static_cast<double>(dr) * (fr - pr) +
                                                  static_cast<double>(dg) * (fg - pg) +
                                                  static_cast<double>(db) * (fb - pb));
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
        if (__any_sync(kFull, hit)) {
          int k;
          const float sum = reduce_scatter9(term, lane, k);
          if (k >= 0 && sum != 0.0f) atomicAdd(red + j * kFeat + k, sum);
        }
      }
    }
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

struct BlendArgs {
  const float* feat;
  const int32_t *idx, *starts, *counts;
  int n_feat, n_idx, tx_n;
  float bg;
  float *img, *trans;
  double* state;
};

template <bool kState>
bool launch_blend(int mode, int n_tiles, const BlendArgs& a, cudaStream_t s) {
  const int width = a.tx_n * kTile;
#define PIXIE_BLEND_ARGS                                                                   \
  a.feat, a.idx, a.starts, a.counts, a.n_feat, a.n_idx, a.tx_n, width, a.bg, a.img, \
      a.trans, a.state
  switch (mode) {
    case kBlendShipped:
      blend_kernel<kState, kBlendShipped><<<kSplit * n_tiles, kThreadsB, 0, s>>>(PIXIE_BLEND_ARGS);
      return true;
    case kBlendNoLists:
      blend_kernel<kState, kBlendNoLists><<<kSplit * n_tiles, kThreadsB, 0, s>>>(PIXIE_BLEND_ARGS);
      return true;
    default:
      return false;
  }
#undef PIXIE_BLEND_ARGS
}

}  // namespace

extern "C" {

// mode 0 is the shipped blend, 1 nolists (the tests' reference for the
// lists).  state (H*W, 4) double, or null: each pixel's colour before the
// background (summed in double) and its final T, which the backward reads
int pixie_gs_blend(int mode, const float* feat, const int32_t* idx, const int32_t* starts,
                   const int32_t* counts, int n_feat, int n_idx, int n_tiles, int tx_n,
                   float bg, float* img, float* trans, double* state, void* stream) {
  if (n_tiles > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const BlendArgs a{feat, idx, starts, counts, n_feat, n_idx, tx_n, bg, img, trans, state};
    const bool ok = state != nullptr ? launch_blend<true>(mode, n_tiles, a, s)
                                     : launch_blend<false>(mode, n_tiles, a, s);
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// d_feat (N, 9) zeroed by the caller; state (H*W, 4) as the forward kept it
int pixie_gs_blend_backward(const float* feat, const int32_t* idx, const int32_t* starts,
                            const int32_t* counts, int n_feat, int n_idx, int n_tiles, int tx_n,
                            float bg, const float* d_img, const float* d_trans,
                            const double* state, float* d_feat, void* stream) {
  if (n_tiles > 0)
    blend_backward_kernel<<<n_tiles, kPix, 0, static_cast<cudaStream_t>(stream)>>>(
        feat, idx, starts, counts, n_feat, n_idx, tx_n, tx_n * kTile, bg, d_img, d_trans, state,
        d_feat);
  return static_cast<int>(cudaGetLastError());
}

const char* pixie_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
