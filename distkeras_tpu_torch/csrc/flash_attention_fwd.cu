// Flash-attention forward for Hopper (sm_90a), CUDA C++: the "simt" variant,
// which serves f32 inputs and 16-bit inputs whose head dim the sm90 variant
// (flash_attention_fwd_sm90.cu) does not take (not a multiple of 8, or above
// 256).  Despite the variant's name its products run on the TF32 tensor
// cores.
//
// Replaces distkeras_tpu/ops/flash_attention.py :: _flash_kernel (the
// Pallas TPU kernel launched by _flash_forward through pl.pallas_call) in
// both of its forms.  The inference form (lse == nullptr) writes only the
// output.  The training form (save_residuals=True, the custom_vjp's _fwd)
// also writes the f32 per-row logsumexp of the scaled scores,
//     lse[b, h, p] = safe_m + log(l)   (safe_m = 0 for an all-masked row,
//                                       l == 0 taken as 1),
// in natural-log units and a (B, H, S) layout: the statistic the backward
// kernels (flash_attention_bwd.cu) recompute p = exp(s - lse) from.  The
// TPU kernel's 128-lane broadcast of it is TPU layout and is not carried
// over.
//
// What it computes.  For every (batch, head, q row p):
//     out[p] = softmax(q[p] . k^T * scale + mask) . v
// with the mask causal (keys after p hidden) and, optionally, a sliding
// window that keeps keys in (p - window, p].  Inputs are the JAX package's
// BSHD layout: q and out (B, S, H, D), k and v (B, S, Hkv, D); query head h
// reads kv head h / (H / Hkv) (grouped-query attention) instead of a
// repeated copy of k and v.  The online softmax runs in f32 as the TPU
// kernel's does: m, l and the output accumulators are f32, the row maximum
// is replaced by 0 while a row is still all -inf ("safe"), l == 0 becomes
// 1 at the end, and the probabilities p stay f32.  The output is written in
// q's dtype.
//
// What bounds it on the H100.  Per live (q, k) pair it does two products of
// 2 * D flops (s = q . k^T and o += p . v) and one exponential, against
// O(S * D) bytes per head: it is bound by arithmetic.  The products run on
// the TF32 tensor cores (495 TFLOP/s dense) through mma.sync.m16n8k8 with
// f32 accumulators.  One TF32 product keeps ~11 bits of each operand, too
// few for the forward's 2e-5 tolerance, so every f32 operand x is split in
// registers into hi = cvt.rna.tf32(x) and lo = x - hi (the MMA reads lo
// truncated to TF32), and a . b is lo_a . hi_b + hi_a . lo_b + hi_a . hi_b
// (lo . lo, ~2^-22 of the product, is dropped).  For f32 inputs q is scaled
// in f32 before the split (the TPU kernel's q * scale), so s takes 3 passes
// and p . v 3.  bf16 and f16 values are exact in TF32: q . k^T of 16-bit
// inputs takes 1 pass and is scaled in f32 afterwards (a scaled 16-bit q
// would no longer be exact), and p (f32, never rounded) times a 16-bit v 2.
// chip_smoke.py prints that split-TF32 bound beside each time.
//
// What the design does about it.  The TPU kernel carries m, l and the
// output in VMEM scratch across a sequential inner grid axis; H100 blocks
// run in no order, so each block owns its output tile and loops itself.
// - One block of 8 warps per (batch*head, 64-row q tile): four groups of 16
//   rows (the MMA's m16), each served by a pair of warps that take one half
//   of every key tile.  The q rows stay in shared memory (f32 at the
//   64-column width scaled and split into hi and lo once, so that no key
//   tile converts them again).  Per live key tile a warp computes its s
//   tile in a fresh MMA accumulator, summed over the whole head dim in
//   order, so s is computed once per key and row (no output chunk
//   recomputes it up to D 256).  It turns s into p in registers with its
//   own online softmax (the row max over the four lanes that share a row;
//   exp2 with log2(e) folded in), and multiplies p by its keys' v rows: an
//   accumulator's layout (row g, columns 2t and 2t + 1 of lane 4g + t) is
//   an A operand's (columns t and t + 4) with the step's 8 keys permuted,
//   so p enters p . v from registers when v's rows are read in the same
//   permuted order (2t, 2t + 1): no round trip of p through shared memory.
//   Each 8-column step of p . v sums the tile in a fresh accumulator, then
//   acc = acc * corr + tile in f32: the MMA truncates its own sums, and the
//   running output kept inside it for all S / 64 tiles would drift toward
//   the tolerance.  Each lane keeps l as the sum of its
//   own columns; the four lanes of a row add theirs at the end.
// - At the end the pair joins its two (m, l, acc) through shared memory in
//   a fixed order (the second warp's scaled into the first's), so there
//   are no atomics and two runs on the same inputs give the same bits.
// - Staging is double-buffered through cp.async: the next key tile's k and
//   v land while the current one is multiplied.  16-byte copies where every
//   row starts on a 16-byte boundary (D * sizeof(T) a multiple of 16 and
//   aligned tensors), plain loads otherwise, so every head dim is taken
//   (16-bit D 36, for one).  16-bit inputs are staged raw and converted as
//   fragments are read.  Rows are padded by 16 bytes (a row stride of 4 mod
//   8 words), so the v reads with p in registers hit 32 distinct banks.
// - Key tiles of 64 (32 at the 128- and 256-column widths taken whole, where
//   the q rows and two buffers of 64 keys would leave no room for a second
//   block an SM, or would not fit at all; the occupancy of two blocks, 16
//   warps an SM, is worth more than the longer tiles).  Whole tiles outside
//   the TPU's _live_kq (the causal future, or behind the window) are never
//   staged, so a windowed forward is O(S * window); a warp whose half-tile
//   is hidden from all its rows skips it, and a half-tile wholly visible to
//   its rows skips the per-element mask.  Ragged S is masked: rows and
//   keys >= S are staged as zeros, masked, and not written.
// - Templated on the head dim padded up to 32, 64, 128 or 256 (padded
//   columns are zero in shared memory, their MMA steps are skipped, and
//   they are never stored) and on the dtype (f32, bf16, f16).  The output
//   accumulator takes D / 2 registers a thread (128 at D 256, one block an
//   SM there; two elsewhere where shared memory allows).
// - Head dims above 256 (kWide): the tiles are one 128-column chunk wide
//   (64 keys) and each block owns one chunk of the output (blockIdx.z,
//   ceil(D / 128) chunks, looping when there are more than a grid's 65535).
//   Per key tile the block streams the q and k chunks through the double
//   buffer in order, summing s over them (every chunk's block computes the
//   same s), and with the last one stages v's chunk that the block owns.
//   So s is recomputed once per output chunk; chunk 0 writes the lse.
//
// The fragment, MMA and staging helpers are shared with the backward in
// simt_mma.cuh.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "simt_mma.cuh"

namespace {

constexpr int kWhole = 256;  // the widest head dim taken in one tile
constexpr int kChunk = 128;  // tile width above D = kWhole

// keys of the streamed tile, half to each warp of a pair: 32 at the 128-
// and 256-column widths taken whole, where the resident q rows and two
// buffers of 64 keys would leave no room for a second block an SM (128) or
// would not fit (256, f32); 64 in the wide chunks, which restage q per key
// tile
template <int DP, bool kWide>
__host__ __device__ constexpr int tile_keys() {
  return DP >= 128 && !kWide ? 32 : 64;
}

// f32 q rows kept split at the 64-column width: hi in place of q and lo
// beside it, both scaled, so that each key tile's s reads its q fragments
// without converting them (at the 32-column width the extra loads cost
// more than the conversions)
template <typename T, int DP, bool kWide>
__host__ __device__ constexpr bool presplit_q() {
  return std::is_same<T, float>::value && !kWide && DP == 64;
}

template <typename T, int DP, bool kWide>
__host__ __device__ constexpr size_t staging_bytes() {
  // q rows (double-buffered chunks when wide, hi and lo when presplit),
  // k and v tiles x 2
  return sizeof(T) * row_stride<T, DP>() *
         ((kWide || presplit_q<T, DP, kWide>() ? 2 : 1) * kRows +
          2 * 2 * tile_keys<DP, kWide>());
}

// the pair's join: the second warp's accumulators, m and l per lane
template <int DP>
__host__ __device__ constexpr size_t join_bytes() {
  return sizeof(float) * kGroups * (DP / 2 + 4) * 32;
}

template <typename T, int DP, bool kWide>
__host__ __device__ constexpr size_t smem_bytes() {
  return staging_bytes<T, DP, kWide>() > join_bytes<DP>()
             ? staging_bytes<T, DP, kWide>()
             : join_bytes<DP>();
}

// blocks per SM that the register budget is cut for (__launch_bounds__):
// two where two blocks' shared memory fits (at most 128 registers a
// thread), except at the 256-column width, whose output accumulators alone
// take 128
template <typename T, int DP, bool kWide>
__host__ __device__ constexpr int min_blocks() {
  return DP < kWhole && 2 * smem_bytes<T, DP, kWide>() <= kSmemPerSm ? 2 : 1;
}

// the maximum and the sum over the four lanes that hold one row
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

// s += (q . scale) . k^T over the 8-column steps below w, for a warp's 16
// q rows (a) and the tile's 8 NT keys (b).  f32: q scaled in f32, then
// both operands split (three passes), q's halves read from a and a_lo when
// kPre; 16-bit: both exact in TF32, one pass (the caller scales s)
template <bool kF32, bool kPre, int NT, int ND, typename T>
__device__ __forceinline__ void scores(float (&s)[NT][4], const T* a,
                                       const float* a_lo, const T* b, int w,
                                       int g, int t, float scale) {
  constexpr int SD = row_stride<T, ND * 8>();
#pragma unroll
  for (int ks = 0; ks < ND; ++ks) {
    if (8 * ks >= w) break;
    const int c = 8 * ks + 2 * t;
    Frag<4> fa;
    if (kPre) {
      const float2 th = load_pair(a + g * SD + c);
      const float2 bh = load_pair(a + (g + 8) * SD + c);
      const float2 tl = load_pair(a_lo + g * SD + c);
      const float2 bl = load_pair(a_lo + (g + 8) * SD + c);
      const float hi[4] = {th.x, bh.x, th.y, bh.y};
      const float lo[4] = {tl.x, bl.x, tl.y, bl.y};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        fa.hi[j] = __float_as_uint(hi[j]);
        fa.lo[j] = __float_as_uint(lo[j]);
      }
    } else if (kF32) {
      const float2 top = load_pair(a + g * SD + c);
      const float2 bottom = load_pair(a + (g + 8) * SD + c);
      const float x[4] = {top.x * scale, bottom.x * scale, top.y * scale,
                          bottom.y * scale};
      fa = tf32_frag<true>(x);
    } else {
      fa = load_a<false>(a, SD, g, c);
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
      mma_split<kF32, kF32>(s[n], fa, load_b_rows<kF32>(b, SD, 8 * n + g, c));
  }
}

// acc = acc * corr + p . tile for a warp's 16 x (8 NT) probabilities p (rows
// g and g + 8 rescaled by corr[0] and corr[1]) and the tile's 8 NT rows,
// over the ND 8-column steps below w.  Each output step sums the tile in a
// fresh accumulator, added to the rescaled acc in f32
template <bool kSplitB, int NT, int ND, typename T>
__device__ __forceinline__ void pv_product(float (&acc)[ND][4],
                                           const float (&p)[NT][4],
                                           const T* tile, int w, int t,
                                           int g, const float (&corr)[2]) {
  constexpr int SD = row_stride<T, ND * 8>();
  Frag<4> fp[NT];
#pragma unroll
  for (int n = 0; n < NT; ++n) fp[n] = acc_as_a(p[n]);
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    if (8 * nd >= w) break;
    float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int n = 0; n < NT; ++n)
      mma_split<true, kSplitB>(
          part, fp[n], load_b_cols<kSplitB>(tile, SD, 8 * n + 2 * t,
                                            8 * nd + g));
#pragma unroll
    for (int e = 0; e < 4; ++e)
      acc[nd][e] = fmaf(acc[nd][e], corr[e >> 1], part[e]);
  }
}

// DP: the tiles' width, the head dim D padded up to 32, 64, 128 or 256, or
// with kWide (D > kWhole) the chunk width kChunk.  vec: 16-byte staging
template <typename T, int DP, bool kWide>
__global__ void __launch_bounds__(kThreads, min_blocks<T, DP, kWide>())
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int S, int H, int Hkv, int D,
                     float scale, int causal, int window, int vec) {
  static_assert(!kWide || DP == kChunk, "wide tiles are one chunk wide");
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int SD = row_stride<T, DP>();
  constexpr int BK = tile_keys<DP, kWide>();
  constexpr int NT = BK / 8 / kPairs;  // the warp's 8-key tiles of s
  constexpr int ND = DP / 8;           // 8-column steps of the head dim
  constexpr bool kPre = presplit_q<T, DP, kWide>();
  constexpr int kQBufs = kWide || kPre ? 2 : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);  // [kQBufs][kRows][SD]
  T* Ks = Qs + kQBufs * kRows * SD;        // [2][BK][SD]
  T* Vs = Ks + 2 * BK * SD;                // [2][BK][SD]

  // batch*head fastest, heaviest causal q tiles first, so the short ones
  // fill the tail
  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = qt * kRows;
  const int tid = threadIdx.x, lane = tid & 31;
  // the warp's 16 rows (rg) and its half of every key tile (hf)
  const int rg = (tid >> 5) % kGroups, hf = (tid >> 5) / kGroups;
  const int koff = hf * (BK / kPairs);
  const int g = lane >> 2, t = lane & 3;
  const int n_dc = kWide ? (D + DP - 1) / DP : 1;

  const size_t q_stride = (size_t)H * D;
  const size_t kv_stride = (size_t)Hkv * D;
  const T* qb = q + ((size_t)b * S * H + h) * D;
  T* ob = o + ((size_t)b * S * H + h) * D;
  const T* kb = k + ((size_t)b * S * Hkv + hk) * D;
  const T* vb = v + ((size_t)b * S * Hkv + hk) * D;

  // the warp's first row, and the rows of this lane's accumulator
  // elements: g and g + 8 of the warp's
  const int r0 = q0 + rg * 16;
  const int rA = r0 + g, rB = rA + 8;

  // live key tiles (the TPU kernel's _live_kq): causal stops at the tile
  // holding this q tile's last row; a window starts at the tile holding
  // the first key the tile's first row can see
  const int q_last = min(q0 + kRows, S) - 1;
  int kt_end = (S + BK - 1) / BK;
  int kt_begin = 0;
  if (causal) {
    kt_end = min(kt_end, q_last / BK + 1);
    if (window > 0 && q0 - window + 1 > 0) kt_begin = (q0 - window + 1) / BK;
  }
  const int n_items = max(kt_end - kt_begin, 0) * n_dc;

  for (int zc = kWide ? (int)blockIdx.z : 0; zc < n_dc; zc += gridDim.z) {
    // the output columns this block owns
    const int dv0 = zc * DP, wv = min(DP, D - dv0);
    // step i: key tile kt_begin + i / n_dc, head-dim chunk i % n_dc of q
    // and k (in order), with the last chunk the block's own chunk of v,
    // into buffer i % 2
    auto stage_step = [&](int i) {
      const int buf = i & 1, ci = i % n_dc;
      const int d0 = ci * DP, w = min(DP, D - d0);
      const int k0 = (kt_begin + i / n_dc) * BK;
      if (kWide)
        stage<T, kRows, DP>(Qs + buf * kRows * SD, qb + d0, q_stride, q0, S,
                            w, vec, tid);
      stage<T, BK, DP>(Ks + buf * BK * SD, kb + d0, kv_stride, k0, S, w, vec,
                       tid);
      if (ci == n_dc - 1)
        stage<T, BK, DP>(Vs + buf * BK * SD, vb + dv0, kv_stride, k0, S, wv,
                         vec, tid);
      cp_commit();
    };
    if (!kWide)  // resident q rows: in the first step's group
      stage<T, kRows, DP>(Qs, qb, q_stride, q0, S, D, vec, tid);
    if (n_items > 0) stage_step(0);
    if (kPre) {  // q * scale split in place: hi, and lo in the second buffer
      cp_wait<0>();
      __syncthreads();
      float* Qlo = reinterpret_cast<float*>(Qs) + kRows * SD;
      for (int j = tid; j < kRows * SD; j += kThreads) {
        const float x = to_f32(Qs[j]) * scale;
        const float hi[1] = {x};
        const Frag<1> f = tf32_frag<true>(hi);
        Qs[j] = from_f32<T>(__uint_as_float(f.hi[0]));
        Qlo[j] = __uint_as_float(f.lo[0]);
      }
    }

    // the warp's online softmax over its halves of the key tiles: the
    // running max m and sum l (of this lane's own columns) of rows g and
    // g + 8, and the output accumulators
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    float acc[ND][4];
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    float s[NT][4];

#pragma unroll 1
    for (int i = 0; i < n_items; ++i) {
      const int buf = i & 1, ci = i % n_dc;
      if (i + 1 < n_items) {
        stage_step(i + 1);
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncthreads();
      // the warp's keys; a half-tile hidden from every row of the warp adds
      // nothing (in the causal future, behind the window, or past S)
      const int k0 = (kt_begin + i / n_dc) * BK + koff;
      const bool dead =
          k0 >= S || r0 >= S ||
          (causal && (k0 > r0 + 15 ||
                      (window > 0 && k0 + BK / kPairs - 1 <= r0 - window)));
      if (!dead) {
        const T* Qw = Qs + (kWide ? buf : 0) * kRows * SD + rg * 16 * SD;
        const T* Kt = Ks + (buf * BK + koff) * SD;
        if (ci == 0) {
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
        }
        // s += q . k^T over this chunk's columns
        scores<kF32, kPre, NT, ND>(
            s, Qw, reinterpret_cast<const float*>(Qs) + (kRows + rg * 16) * SD,
            Kt, min(DP, D - ci * DP), g, t, scale);
        if (ci == n_dc - 1) {
          // scaled scores, masked where the half-tile is not wholly visible
          // to the warp's rows
          const bool whole = visible(r0, k0, BK / kPairs, S, causal, window);
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              if (!kF32) s[n][e] *= scale;
              const int key = k0 + 8 * n + 2 * t + (e & 1);
              if (!whole && hidden(e >= 2 ? rB : rA, key, S, causal, window))
                s[n][e] = -INFINITY;
            }
          // the online softmax of rows g (r = 0) and g + 8 (r = 1): p in
          // place of s, f32
          float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
            mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
          }
          float corr[2], safe[2];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float new_m = fmaxf(m[r], quad_max(mx[r]));
            safe[r] = new_m == -INFINITY ? 0.f : new_m;
            corr[r] = exp2f((m[r] - safe[r]) * kLog2e);
            m[r] = new_m;
          }
          float sum[2] = {0.f, 0.f};
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              s[n][e] = exp2f((s[n][e] - safe[e >> 1]) * kLog2e);
              sum[e >> 1] += s[n][e];
            }
#pragma unroll
          for (int r = 0; r < 2; ++r) l[r] = fmaf(l[r], corr[r], sum[r]);
          // acc = acc * corr + p . v over the block's output columns
          pv_product<kF32, NT, ND>(acc, s, Vs + (buf * BK + koff) * SD, wv, t,
                                   g, corr);
        }
      }
      __syncthreads();  // every warp is done with buffer i % 2
    }

    // the pair's join, in the order of hf: the second warp's m, l and
    // accumulators through the staging buffers' shared memory (every copy
    // has landed and every warp is past the last step's barrier), scaled
    // into the first warp's
    float* red = reinterpret_cast<float*>(smem_raw) +
                 (size_t)rg * (ND * 4 + 4) * 32;  // [ND * 4 + 4][32]
    cp_wait<0>();
    __syncthreads();
    if (hf == 1) {
#pragma unroll
      for (int nd = 0; nd < ND; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e) red[(nd * 4 + e) * 32 + lane] = acc[nd][e];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        red[(ND * 4 + r) * 32 + lane] = m[r];
        red[(ND * 4 + 2 + r) * 32 + lane] = l[r];
      }
    }
    __syncthreads();
    if (hf == 0) {
      float c0[2], c1[2], safe_m[2], denom[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m1 = red[(ND * 4 + r) * 32 + lane];
        const float l1 = red[(ND * 4 + 2 + r) * 32 + lane];
        const float mm = fmaxf(m[r], m1);
        safe_m[r] = mm == -INFINITY ? 0.f : mm;
        c0[r] = exp2f((m[r] - safe_m[r]) * kLog2e);
        c1[r] = exp2f((m1 - safe_m[r]) * kLog2e);
        // the row's sum over its four lanes, l == 0 taken as 1
        const float lr = quad_sum(fmaf(l[r], c0[r], l1 * c1[r]));
        denom[r] = lr == 0.f ? 1.f : lr;
      }
#pragma unroll
      for (int nd = 0; nd < ND; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int row = r ? rB : rA;
          const int col = 8 * nd + 2 * t + (e & 1);
          const float x = fmaf(acc[nd][e], c0[r],
                               red[(nd * 4 + e) * 32 + lane] * c1[r]);
          if (row < S && col < wv)
            ob[(size_t)row * q_stride + dv0 + col] = from_f32<T>(x / denom[r]);
        }
      if (lse != nullptr && zc == 0 && t == 0) {
        if (rA < S) lse[(size_t)bh * S + rA] = safe_m[0] + logf(denom[0]);
        if (rB < S) lse[(size_t)bh * S + rB] = safe_m[1] + logf(denom[1]);
      }
    }
    __syncthreads();  // the join's shared memory is free again
  }
}

// 16-byte staging: q, k and v start on a 16-byte boundary and so does every
// row (D * sizeof(T) a multiple of 16)
template <typename T>
int vec_ok(const void* q, const void* k, const void* v, int D) {
  const void* ptrs[] = {q, k, v};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return 0;
  return (D * sizeof(T)) % 16 == 0;
}

template <typename T, int DP, bool kWide = false>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int S, int H, int Hkv, int D,
                   float scale, int causal, int window, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, DP, kWide>();
  const cudaError_t e = allow_smem(flash_fwd_kernel<T, DP, kWide>, smem);
  if (e != cudaSuccess) return e;
  const int chunks = kWide ? (D + DP - 1) / DP : 1;
  const dim3 grid(B * H, (S + kRows - 1) / kRows,
                  chunks < 65535 ? chunks : 65535);
  flash_fwd_kernel<T, DP, kWide><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, S, H, Hkv, D, scale,
      causal, window, vec_ok<T>(q, k, v, D));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dim(const void* q, const void* k, const void* v, void* o,
                         float* lse, int B, int S, int H, int Hkv, int D,
                         float scale, int causal, int window,
                         cudaStream_t stream) {
  if (D <= 0) return cudaErrorInvalidValue;
  if (D <= 32)
    return launch<T, 32>(q, k, v, o, lse, B, S, H, Hkv, D, scale, causal, window, stream);
  if (D <= 64)
    return launch<T, 64>(q, k, v, o, lse, B, S, H, Hkv, D, scale, causal, window, stream);
  if (D <= 128)
    return launch<T, 128>(q, k, v, o, lse, B, S, H, Hkv, D, scale, causal, window, stream);
  if (D <= kWhole)
    return launch<T, kWhole>(q, k, v, o, lse, B, S, H, Hkv, D, scale, causal, window, stream);
  return launch<T, kChunk, true>(q, k, v, o, lse, B, S, H, Hkv, D, scale,
                                 causal, window, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  D >= 1 (above 256 in
// ceil(D / 128) chunks).  window <= 0 means no window.  lse: null for the
// inference form, else a (B, H, S) f32 buffer that the training form fills.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, void* lse, int B, int S, int H,
                                   int Hkv, int D, int dtype, float scale,
                                   int causal, int window, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 ||
      (S + kRows - 1) / kRows > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 0)
    return (int)dispatch_dim<float>(q, k, v, o, l, B, S, H, Hkv, D, scale,
                                    causal, window, st);
  if (dtype == 1)
    return (int)dispatch_dim<__nv_bfloat16>(q, k, v, o, l, B, S, H, Hkv, D,
                                            scale, causal, window, st);
  if (dtype == 2)
    return (int)dispatch_dim<__half>(q, k, v, o, l, B, S, H, Hkv, D, scale,
                                     causal, window, st);
  return (int)cudaErrorInvalidValue;
}
