// Flash-attention backward for Hopper (sm_90a), CUDA C++: the dq kernel and
// the dk/dv kernel of the "simt" variant, which serves f32 inputs and 16-bit
// inputs whose head dim the sm90 variant does not take (above 128, or not a
// multiple of 8).
//
// Replaces distkeras_tpu/ops/flash_attention.py :: _dq_kernel (:182,
// pl.pallas_call :275) and _dkv_kernel (:221, pl.pallas_call :294), the
// Pallas TPU kernels launched by _flash_backward from the custom_vjp's _bwd.
// Both recompute the probabilities from the forward's saved per-row
// logsumexp instead of reading an (S, S) tensor, so nothing of size S * S is
// ever stored.
//
// What they compute.  With s = q . k^T (masked), p = exp(s * scale - lse),
// Delta = rowsum(dO o O) over O as stored, dp = dO . v^T and
// ds = p o (dp - Delta) * scale:
//     dq = ds . k              (one per query head)
//     dk = ds^T . q,  dv = p^T . dO
// where dk and dv of kv head hk sum over the G = H / Hkv query heads that
// read it (grouped-query attention).  The TPU path repeats k and v to H
// heads and sums the per-head dk/dv through the repeat's transpose; here the
// dk/dv block loops over the G heads itself and sums in f32 registers, then
// rounds once: no atomics, so two runs on the same inputs give the same
// bits.  Every sum is f32, as in the TPU kernels; inputs are the BSHD layout
// (q, O, dO, dq: (B, S, H, D); k, v, dk, dv: (B, S, Hkv, D)); lse and Delta
// are f32 (B, H, S).  The dq kernel writes Delta, the dk/dv kernel (launched
// after it on the same stream) reads it.
//
// What bounds them on the H100.  Per live (q, k) pair the dq kernel does
// three products of 2 * D flops (s, dp, dq) and the dk/dv kernel four (s,
// dp, dv, dk), against O(S * D) bytes per head: both are bound by
// arithmetic.  The products run on the TF32 tensor cores (495 TFLOP/s
// dense), through mma.sync.m16n8k8 with f32 accumulators.  One TF32 product
// keeps ~11 bits of each operand, too few for the f32 tolerance, so every
// f32 operand x is split in registers into hi = cvt.rna.tf32(x) and
// lo = x - hi (the MMA reads lo truncated to TF32), and a . b is
// lo_a . hi_b + hi_a . lo_b + hi_a . hi_b (lo . lo, ~2^-22 of the product,
// is dropped): an error of the order of f32's own.  bf16 and f16 values are
// exact in TF32 and take no lo.  So per live pair: f32 inputs 3 passes of
// 14 * D flops (42 * D: dq 18 * D, dk/dv 24 * D); 16-bit inputs 1 pass for
// s and dp and 2 for the products with p or ds (20 * D: dq 8 * D, dk/dv
// 12 * D).  chip_smoke.py prints that split-TF32 bound beside each time.
//
// What the design does about it.  The TPU kernels carry dq (and dk, dv) in
// VMEM scratch across a sequential inner grid axis; H100 blocks run in no
// order, so each block owns its output tile and loops itself.
// - dq kernel: one block of 8 warps per (batch*head, 64-row q tile).  The
//   rows are four groups of 16 (the MMA's m16), each served by a pair of
//   warps that take one half of every key tile (64 keys, 32 at the
//   128-column tile width).  The q and dO rows stay in shared memory; per
//   live key tile a warp computes its s and dp tiles in MMA accumulators,
//   turns them into p and ds in registers, and multiplies ds by its keys.
//   An accumulator's layout (row g, columns 2t and 2t + 1 of lane 4g + t)
//   is an A operand's (columns t and t + 4) with the step's 8 keys
//   permuted, so ds enters the next product from registers when the key
//   tile's rows are read in the same permuted order.  Each 8-column step of
//   that product sums the tile in a fresh accumulator, added to the running
//   sum with an f32 add: the MMA's own accumulation truncates, and a sum
//   kept in it for all S / 64 tiles drifts toward the f32 tolerance (ulps
//   lost in one direction, tile after tile).  At the end the
//   pair adds its two sums (in a fixed order) through shared memory.  The
//   block first computes Delta of its rows, as _dq_kernel does from its
//   resident blocks.
// - dk/dv kernel: one block of 8 warps per (batch*kv head, 64-key tile):
//   four groups of 16 keys, each pair of warps taking one half of every q
//   tile, looping over the G query heads and their live q tiles.  The roles
//   swap: a warp computes s^T and dp^T (keys by q rows), p^T and ds^T in
//   registers, and accumulates dv += p^T . dO and dk += ds^T . q.  The q
//   tile's lse and Delta are staged beside q and dO.
// - Staging is double-buffered through cp.async: the next tile (k and v for
//   dq; q, dO, lse, Delta for dk/dv) lands while the current one is
//   multiplied.  16-byte copies where every row starts on a 16-byte
//   boundary (D * sizeof(T) a multiple of 16 and aligned tensors), plain
//   loads otherwise, so every head dim is taken.  16-bit inputs are staged
//   raw and converted as fragments are read.  Rows are padded by 16 bytes
//   (a row stride of 4 mod 8 words), so the products with a register
//   operand read 32 distinct banks (rows 2t and 2t + 1, column g); the
//   products over the head dim read each lane's two values of a row in one
//   load (see load_a).
// - Whole tiles outside the TPU's _live_kq (the causal future, or behind the
//   window) are skipped in both kernels, so a windowed backward is
//   O(S * window); a tile wholly visible to a warp skips the per-element
//   mask.  Ragged S is masked: rows and keys >= S are staged as zeros,
//   contribute nothing and are not written.
// - Templated on the head dim padded up to 32, 64 or 128 (padded columns
//   are zero in shared memory, their MMA steps are skipped and they are
//   never stored) and on the dtype (f32, bf16, f16).  Two blocks share an
//   SM where their shared memory fits (__launch_bounds__ then holds a
//   thread to 128 registers); the dk/dv kernel at the 128-column width,
//   whose dk and dv accumulators alone take 128, runs one.
// - Head dims above 128 (kWide): the dk and dv accumulators take D f32
//   registers per thread, so the tiles are one 128-column chunk wide and
//   each block owns one chunk of its output (dq, or dk and dv; blockIdx.z,
//   ceil(D / 128) chunks, looping when there are more than a grid's 65535).
//   Per key tile (dq) or q tile (dk/dv) the block streams every chunk of
//   the four operands through the double buffer, the chunk it owns last,
//   summing s and dp over them, then multiplies by the chunk it owns, still
//   in the buffer.  So s and dp are recomputed once per chunk, the rows
//   that the narrow kernels keep resident are restaged per tile, and small
//   B * Hkv still gets ceil(D / 128) times the blocks.  Delta is a rowsum
//   over all of D read from device memory; chunk 0 writes it.
//
// The fragment, MMA and staging helpers are shared with the forward in
// simt_mma.cuh.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "simt_mma.cuh"

namespace {

constexpr int kChunk = 128;  // tile width above D = 128

// rows of the streamed tile: fewer at the 128-column width, where the dk
// and dv accumulators take 128 registers
template <int DP>
__host__ __device__ constexpr int tile_rows() {
  return DP >= 128 ? 32 : 64;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// is every key of [k0, k0 + 16) visible to every row of [q0, q0 + n)?
__device__ __forceinline__ bool visible_keys(int k0, int q0, int n, int S,
                                             int causal, int window) {
  if (k0 + 16 > S || q0 + n > S) return false;
  if (!causal) return true;
  return k0 + 15 <= q0 && (window <= 0 || k0 > q0 + n - 1 - window);
}

__device__ __forceinline__ void add_to(float (&acc)[4], const float (&x)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += x[e];
}

// s += a1 . b1^T and dp += a2 . b2^T over the 8-column steps below w, for
// a warp's 16 rows (a1, a2) and the tile's 8 NT rows (b1, b2)
template <bool kSplit, int NT, int ND, typename T>
__device__ __forceinline__ void head_dim_products(
    float (&s)[NT][4], float (&dp)[NT][4], const T* a1, const T* a2,
    const T* b1, const T* b2, int w, int g, int t) {
  constexpr int SD = row_stride<T, ND * 8>();
#pragma unroll
  for (int ks = 0; ks < ND; ++ks) {
    if (8 * ks >= w) break;
    const int c = 8 * ks + 2 * t;
    const Frag<4> f1 = load_a<kSplit>(a1, SD, g, c);
    const Frag<4> f2 = load_a<kSplit>(a2, SD, g, c);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      mma_split<kSplit, kSplit>(s[n], f1,
                                load_b_rows<kSplit>(b1, SD, 8 * n + g, c));
      mma_split<kSplit, kSplit>(dp[n], f2,
                                load_b_rows<kSplit>(b2, SD, 8 * n + g, c));
    }
  }
}

// acc += x . tile for a warp's 16 x (8 NT) accumulator tile x and the
// tile's 8 NT rows, over the ND 8-column steps below w.  Each output step
// sums the tile in a fresh accumulator that is then added to acc with an
// f32 add: the MMA's own accumulation truncates, so summing a long
// sequence of tiles inside it would drift by up to an ulp per step
template <bool kSplitB, int NT, int ND, typename T>
__device__ __forceinline__ void tile_product(float (&acc)[ND][4],
                                             const float (&x)[NT][4],
                                             const T* tile, int w, int t,
                                             int g) {
  constexpr int SD = row_stride<T, ND * 8>();
  Frag<4> fx[NT];
#pragma unroll
  for (int n = 0; n < NT; ++n) fx[n] = acc_as_a(x[n]);
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    if (8 * nd >= w) break;
    float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int n = 0; n < NT; ++n)
      mma_split<true, kSplitB>(
          part, fx[n], load_b_cols<kSplitB>(tile, SD, 8 * n + 2 * t,
                                            8 * nd + g));
    add_to(acc[nd], part);
  }
}

// the head-dim chunk that step ci (of n_dc per tile) visits: the others in
// order, the block's own chunk zc last, so that it is still staged when the
// output product reads it
__device__ __forceinline__ int chunk_of(int ci, int zc, int n_dc) {
  return ci == n_dc - 1 ? zc : (ci < zc ? ci : ci + 1);
}

template <typename T, int DP, bool kWide>
__host__ __device__ constexpr size_t dq_smem_bytes() {
  // q and dO rows (double-buffered chunks when wide), k and v tiles x 2
  return sizeof(T) * row_stride<T, DP>() *
         ((kWide ? 2 : 1) * 2 * kRows + 2 * 2 * tile_rows<DP>());
}

template <typename T, int DP, bool kWide>
__host__ __device__ constexpr size_t dkv_smem_bytes() {
  // k and v rows (double-buffered chunks when wide), q and dO tiles x 2,
  // then lse and Delta of the q tiles x 2
  return sizeof(T) * row_stride<T, DP>() *
             ((kWide ? 2 : 1) * 2 * kRows + 2 * 2 * tile_rows<DP>()) +
         sizeof(float) * 2 * 2 * tile_rows<DP>();
}

// blocks per SM that the register budget is cut for (__launch_bounds__):
// two where two blocks' shared memory fits (at most 128 registers a
// thread), except the dk/dv kernel at the 128-column width, whose 128
// accumulator registers would spill
template <typename T, int DP, bool kWide>
__host__ __device__ constexpr int dq_min_blocks() {
  return 2 * dq_smem_bytes<T, DP, kWide>() <= kSmemPerSm ? 2 : 1;
}
template <int DP>
__host__ __device__ constexpr int dkv_min_blocks() {
  return DP >= 128 ? 1 : 2;
}

// the accumulators of the kPairs warps that share 16 rows, summed into the
// first one's (hf == 0) in the order of hf, through the shared memory of the
// staging buffers (every copy has landed and every warp is past the last
// step's barrier); the shared memory is free again on return
template <int ND>
__device__ __forceinline__ void sum_pairs(float (&acc)[ND][4],
                                          unsigned char* smem, int rg,
                                          int hf, int lane) {
  float* red = reinterpret_cast<float*>(smem);  // [kGroups][ND * 4][32]
  cp_wait<0>();
  __syncthreads();
  for (int j = 1; j < kPairs; ++j) {
    if (hf == j)
#pragma unroll
      for (int nd = 0; nd < ND; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          red[((rg * ND + nd) * 4 + e) * 32 + lane] = acc[nd][e];
    __syncthreads();
    if (hf == 0)
#pragma unroll
      for (int nd = 0; nd < ND; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[nd][e] += red[((rg * ND + nd) * 4 + e) * 32 + lane];
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// the kernels
// ---------------------------------------------------------------------------

// DP: the tiles' width, the head dim D padded up to 32, 64 or 128, or with
// kWide (D > kChunk) the chunk width kChunk.  vec: 16-byte staging
template <typename T, int DP, bool kWide>
__global__ void __launch_bounds__(kThreads, dq_min_blocks<T, DP, kWide>())
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ o,
                        const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        float* __restrict__ delta, T* __restrict__ dq, int S,
                        int H, int Hkv, int D, float scale, int causal,
                        int window, int vec) {
  static_assert(!kWide || DP == kChunk, "wide tiles are one chunk wide");
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int SD = row_stride<T, DP>();
  constexpr int BK = tile_rows<DP>();
  constexpr int NT = BK / 8 / kPairs;  // the warp's 8-key tiles of s, dp
  constexpr int ND = DP / 8;       // 8-column steps of the head dim
  constexpr int kQBufs = kWide ? 2 : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);  // [kQBufs][kRows][SD]
  T* dOs = Qs + kQBufs * kRows * SD;       // [kQBufs][kRows][SD]
  T* Ks = dOs + kQBufs * kRows * SD;       // [2][BK][SD]
  T* Vs = Ks + 2 * BK * SD;                // [2][BK][SD]

  // batch*head fastest, heaviest causal q tiles first
  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = qt * kRows;
  const int tid = threadIdx.x, lane = tid & 31;
  // the warp's 16 rows (rg) and its part of every key tile (hf)
  const int rg = (tid >> 5) % kGroups, hf = (tid >> 5) / kGroups;
  const int koff = hf * (BK / kPairs);
  const int g = lane >> 2, t = lane & 3;
  const int n_dc = kWide ? (D + DP - 1) / DP : 1;
  const float scale_log2 = scale * kLog2e;

  const size_t q_stride = (size_t)H * D;
  const size_t kv_stride = (size_t)Hkv * D;
  const size_t q_off = ((size_t)b * S * H + h) * D;
  const size_t kv_off = ((size_t)b * S * Hkv + hk) * D;
  const T* qb = q + q_off;
  const T* ob = o + q_off;
  const T* dob = dout + q_off;
  T* dqb = dq + q_off;
  const T* kb = k + kv_off;
  const T* vb = v + kv_off;

  // the rows of this lane's accumulator elements: g and g + 8 of the warp's
  const int rA = q0 + rg * 16 + g, rB = rA + 8;

  // Delta = rowsum(dO o O) of the warp's rows from O as stored (written for
  // the dk/dv kernel by chunk 0), and their lse, both in the log2 domain
  // (each lane sums its columns lane, lane + 32, ... in order, all 16 rows
  // at once, then the warp adds the lanes' sums)
  float part[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) part[r] = 0.f;
  const int rows = max(min(16, S - (q0 + rg * 16)), 0);
  for (int d = lane; d < D; d += 32)
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const size_t at = (size_t)(q0 + rg * 16 + r) * q_stride + d;
      if (r < rows)
        part[r] = fmaf(to_f32(dob[at]), to_f32(ob[at]), part[r]);
    }
  float lseA = 0.f, lseB = 0.f, deltaA = 0.f, deltaB = 0.f;
  const bool write_delta = (!kWide || blockIdx.z == 0) && hf == 0;
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const float sum = warp_sum(part[r]);
    if (r < rows && lane == 0 && write_delta)
      delta[(size_t)bh * S + q0 + rg * 16 + r] = sum;
    if (r == g) deltaA = sum;
    if (r == g + 8) deltaB = sum;
  }
  if (rA < S) lseA = lse[(size_t)bh * S + rA] * kLog2e;
  if (rB < S) lseB = lse[(size_t)bh * S + rB] * kLog2e;

  // live k tiles (_live_kq), as in the forward
  const int q_last = min(q0 + kRows, S) - 1;
  int kt_end = (S + BK - 1) / BK;
  int kt_begin = 0;
  if (causal) {
    kt_end = min(kt_end, q_last / BK + 1);
    if (window > 0 && q0 - window + 1 > 0) kt_begin = (q0 - window + 1) / BK;
  }
  const int n_items = max(kt_end - kt_begin, 0) * n_dc;

  for (int zc = kWide ? (int)blockIdx.z : 0; zc < n_dc; zc += gridDim.z) {
    // step i: key tile kt_begin + i / n_dc, head-dim chunk i % n_dc (in
    // chunk_of's order), into buffer i % 2
    auto stage_step = [&](int i) {
      const int buf = i & 1;
      const int d0 = chunk_of(i % n_dc, zc, n_dc) * DP;
      const int w = min(DP, D - d0);
      const int k0 = (kt_begin + i / n_dc) * BK;
      if (kWide) {
        stage<T, kRows, DP>(Qs + buf * kRows * SD, qb + d0, q_stride, q0, S,
                            w, vec, tid);
        stage<T, kRows, DP>(dOs + buf * kRows * SD, dob + d0, q_stride, q0,
                            S, w, vec, tid);
      }
      stage<T, BK, DP>(Ks + buf * BK * SD, kb + d0, kv_stride, k0, S, w, vec,
                       tid);
      stage<T, BK, DP>(Vs + buf * BK * SD, vb + d0, kv_stride, k0, S, w, vec,
                       tid);
      cp_commit();
    };
    if (!kWide) {  // resident q and dO rows: in the first step's group
      stage<T, kRows, DP>(Qs, qb, q_stride, q0, S, D, vec, tid);
      stage<T, kRows, DP>(dOs, dob, q_stride, q0, S, D, vec, tid);
    }
    if (n_items > 0) stage_step(0);

    float acc[ND][4];
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    float s[NT][4], dp[NT][4];

#pragma unroll 1
    for (int i = 0; i < n_items; ++i) {
      const int buf = i & 1;
      if (i + 1 < n_items) {
        stage_step(i + 1);
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncthreads();
      const int ci = i % n_dc;
      const int w = min(DP, D - chunk_of(ci, zc, n_dc) * DP);
      const T* Qw = Qs + (kWide ? buf : 0) * kRows * SD + rg * 16 * SD;
      const T* dOw = dOs + (kWide ? buf : 0) * kRows * SD + rg * 16 * SD;
      const T* Kt = Ks + (buf * BK + koff) * SD;  // the warp's keys
      const T* Vt = Vs + (buf * BK + koff) * SD;
      if (ci == 0) {
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
      }
      // s += q . k^T and dp += dO . v^T over this chunk's columns
      head_dim_products<kF32, NT, ND>(s, dp, Qw, dOw, Kt, Vt, w, g, t);
      if (ci == n_dc - 1) {
        // p and ds of the tile, in place of s; the per-element mask only
        // where the tile is not wholly visible to the warp's rows
        const int k0 = (kt_begin + i / n_dc) * BK + koff;
        const int r0 = q0 + rg * 16;
        auto to_ds = [&](auto masked) {
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const bool lower = e >= 2;
              const int key = k0 + 8 * n + 2 * t + (e & 1);
              float pr = exp2f(
                  fmaf(s[n][e], scale_log2, -(lower ? lseB : lseA)));
              if (decltype(masked)::value &&
                  hidden(lower ? rB : rA, key, S, causal, window))
                pr = 0.f;
              s[n][e] = pr * (dp[n][e] - (lower ? deltaB : deltaA)) * scale;
            }
        };
        if (visible(r0, k0, BK / kPairs, S, causal, window))
          to_ds(std::false_type());
        else
          to_ds(std::true_type());
        // acc += ds . k over the chunk this block owns (the buffer's)
        tile_product<kF32, NT, ND>(acc, s, Kt, w, t, g);
      }
      __syncthreads();  // every warp is done with buffer i % 2
    }
    sum_pairs<ND>(acc, smem_raw, rg, hf, lane);

    const int d0 = zc * DP, w = min(DP, D - d0);
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e >= 2 ? rB : rA;
        const int col = 8 * nd + 2 * t + (e & 1);
        if (hf == 0 && row < S && col < w)
          dqb[(size_t)row * q_stride + d0 + col] = from_f32<T>(acc[nd][e]);
      }
  }
}

template <typename T, int DP, bool kWide>
__global__ void __launch_bounds__(kThreads, dkv_min_blocks<DP>())
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, int S, int H, int Hkv, int D,
                         float scale, int causal, int window, int vec) {
  static_assert(!kWide || DP == kChunk, "wide tiles are one chunk wide");
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int SD = row_stride<T, DP>();
  constexpr int BQ = tile_rows<DP>();
  constexpr int NT = BQ / 8 / kPairs;  // the warp's 8-row tiles of s^T
  constexpr int ND = DP / 8;       // 8-column steps of the head dim
  constexpr int kKBufs = kWide ? 2 : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);  // [kKBufs][kRows][SD]
  T* Vs = Ks + kKBufs * kRows * SD;        // [kKBufs][kRows][SD]
  T* Qs = Vs + kKBufs * kRows * SD;        // [2][BQ][SD]
  T* dOs = Qs + 2 * BQ * SD;               // [2][BQ][SD]
  float* Ls = reinterpret_cast<float*>(dOs + 2 * BQ * SD);  // [2][BQ]
  float* Ds = Ls + 2 * BQ;                                   // [2][BQ]

  // batch*kv head fastest; under causal masking the earliest key tiles see
  // the most q tiles, so the heaviest blocks come first
  const int bhk = blockIdx.x;
  const int b = bhk / Hkv, hk = bhk % Hkv;
  const int G = H / Hkv;
  const int k0 = blockIdx.y * kRows;
  const int tid = threadIdx.x, lane = tid & 31;
  // the warp's 16 keys (rg) and its part of every q tile (hf)
  const int rg = (tid >> 5) % kGroups, hf = (tid >> 5) / kGroups;
  const int qoff = hf * (BQ / kPairs);
  const int g = lane >> 2, t = lane & 3;
  const int n_dc = kWide ? (D + DP - 1) / DP : 1;
  const float scale_log2 = scale * kLog2e;

  const size_t q_stride = (size_t)H * D;
  const size_t kv_stride = (size_t)Hkv * D;
  const size_t kv_off = ((size_t)b * S * Hkv + hk) * D;
  const T* kb = k + kv_off;
  const T* vb = v + kv_off;
  T* dkb = dk + kv_off;
  T* dvb = dv + kv_off;

  // the keys of this lane's accumulator elements: g and g + 8 of the warp's
  const int keyA = k0 + rg * 16 + g, keyB = keyA + 8;

  // live q tiles (_live_kq seen from the key side): causal starts at the
  // tile holding this block's first key; a window ends at the tile holding
  // the last row that can still see this block's last key
  const int nqt = (S + BQ - 1) / BQ;
  int qt_begin = 0, qt_end = nqt;
  if (causal) {
    qt_begin = k0 / BQ;
    if (window > 0)
      qt_end = min(nqt, (k0 + kRows - 2 + window) / BQ + 1);
  }
  const int n_q = max(qt_end - qt_begin, 0);
  const int n_items = G * n_q * n_dc;

  for (int zc = kWide ? (int)blockIdx.z : 0; zc < n_dc; zc += gridDim.z) {
    // step i: query head hk * G + i / (n_q * n_dc), q tile qt_begin +
    // (i / n_dc) % n_q, head-dim chunk i % n_dc (in chunk_of's order), into
    // buffer i % 2
    auto stage_step = [&](int i) {
      const int buf = i & 1;
      const int d0 = chunk_of(i % n_dc, zc, n_dc) * DP;
      const int w = min(DP, D - d0);
      const int q0 = (qt_begin + (i / n_dc) % n_q) * BQ;
      const int h = hk * G + i / (n_dc * n_q);
      const size_t bh = (size_t)b * H + h;
      const size_t q_off = ((size_t)b * S * H + h) * D + d0;
      if (kWide) {
        stage<T, kRows, DP>(Ks + buf * kRows * SD, kb + d0, kv_stride, k0, S,
                            w, vec, tid);
        stage<T, kRows, DP>(Vs + buf * kRows * SD, vb + d0, kv_stride, k0, S,
                            w, vec, tid);
      }
      stage<T, BQ, DP>(Qs + buf * BQ * SD, q + q_off, q_stride, q0, S, w, vec,
                       tid);
      stage<T, BQ, DP>(dOs + buf * BQ * SD, dout + q_off, q_stride, q0, S, w,
                       vec, tid);
      for (int r = tid; r < BQ; r += kThreads) {
        const int p = q0 + r;
        const size_t at = bh * S + (p < S ? p : 0);
        cp_async4(Ls + buf * BQ + r, lse + at, p < S ? 4 : 0);
        cp_async4(Ds + buf * BQ + r, delta + at, p < S ? 4 : 0);
      }
      cp_commit();
    };
    if (!kWide) {  // resident k and v rows: in the first step's group
      stage<T, kRows, DP>(Ks, kb, kv_stride, k0, S, D, vec, tid);
      stage<T, kRows, DP>(Vs, vb, kv_stride, k0, S, D, vec, tid);
    }
    if (n_items > 0) stage_step(0);

    float dk_acc[ND][4], dv_acc[ND][4];
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;
    float s[NT][4], dp[NT][4];

#pragma unroll 1
    for (int i = 0; i < n_items; ++i) {
      const int buf = i & 1;
      if (i + 1 < n_items) {
        stage_step(i + 1);
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncthreads();
      const int ci = i % n_dc;
      const int w = min(DP, D - chunk_of(ci, zc, n_dc) * DP);
      const T* Kw = Ks + (kWide ? buf : 0) * kRows * SD + rg * 16 * SD;
      const T* Vw = Vs + (kWide ? buf : 0) * kRows * SD + rg * 16 * SD;
      const T* Qt = Qs + (buf * BQ + qoff) * SD;  // the warp's q rows
      const T* dOt = dOs + (buf * BQ + qoff) * SD;
      if (ci == 0) {
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
      }
      // s^T += k . q^T and dp^T += v . dO^T over this chunk's columns
      head_dim_products<kF32, NT, ND>(s, dp, Kw, Vw, Qt, dOt, w, g, t);
      if (ci == n_dc - 1) {
        // p^T in place of s, ds^T in place of dp; the per-element mask only
        // where the tile is not wholly visible to the warp's keys
        const int q0 = (qt_begin + (i / n_dc) % n_q) * BQ + qoff;
        const float* Lt = Ls + buf * BQ + qoff;
        const float* Dt = Ds + buf * BQ + qoff;
        auto to_p_ds = [&](auto masked) {
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            const float2 l2 =
                *reinterpret_cast<const float2*>(Lt + 8 * n + 2 * t);
            const float2 d2 =
                *reinterpret_cast<const float2*>(Dt + 8 * n + 2 * t);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int row = q0 + 8 * n + 2 * t + (e & 1);
              float pr = exp2f(fmaf(s[n][e], scale_log2,
                                    -((e & 1) ? l2.y : l2.x) * kLog2e));
              if (decltype(masked)::value &&
                  hidden(row, e >= 2 ? keyB : keyA, S, causal, window))
                pr = 0.f;
              s[n][e] = pr;
              dp[n][e] = pr * (dp[n][e] - ((e & 1) ? d2.y : d2.x)) * scale;
            }
          }
        };
        if (visible_keys(k0 + rg * 16, q0, BQ / kPairs, S, causal, window))
          to_p_ds(std::false_type());
        else
          to_p_ds(std::true_type());
        // dv += p^T . dO, then dk += ds^T . q, over the chunk this block
        // owns
        tile_product<kF32, NT, ND>(dv_acc, s, dOt, w, t, g);
        tile_product<kF32, NT, ND>(dk_acc, dp, Qt, w, t, g);
      }
      __syncthreads();  // every warp is done with buffer i % 2
    }
    sum_pairs<ND>(dk_acc, smem_raw, rg, hf, lane);
    sum_pairs<ND>(dv_acc, smem_raw, rg, hf, lane);

    const int d0 = zc * DP, w = min(DP, D - d0);
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = e >= 2 ? keyB : keyA;
        const int col = 8 * nd + 2 * t + (e & 1);
        if (hf == 0 && key < S && col < w) {
          dkb[(size_t)key * kv_stride + d0 + col] = from_f32<T>(dk_acc[nd][e]);
          dvb[(size_t)key * kv_stride + d0 + col] = from_f32<T>(dv_acc[nd][e]);
        }
      }
  }
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  int B, S, H, Hkv, D;
  float scale;
  int causal, window;
  cudaStream_t stream;
};

// 16-byte staging: every operand starts on a 16-byte boundary and so does
// every row (D * sizeof(T) a multiple of 16)
template <typename T>
int vec_ok(const Args& a) {
  const void* ptrs[] = {a.q, a.k, a.v, a.o, a.dout};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return 0;
  return (a.D * sizeof(T)) % 16 == 0;
}

template <bool kWide>
dim3 grid_of(int x, int S, int D) {
  const int chunks = kWide ? (D + kChunk - 1) / kChunk : 1;
  return dim3(x, (S + kRows - 1) / kRows, chunks < 65535 ? chunks : 65535);
}

template <typename T, int DP, bool kWide = false>
cudaError_t launch_dq(const Args& a) {
  constexpr size_t smem = dq_smem_bytes<T, DP, kWide>();
  const cudaError_t e = allow_smem(flash_bwd_dq_kernel<T, DP, kWide>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid = grid_of<kWide>(a.B * a.H, a.S, a.D);
  flash_bwd_dq_kernel<T, DP, kWide><<<grid, kThreads, smem, a.stream>>>(
          static_cast<const T*>(a.q), static_cast<const T*>(a.k),
          static_cast<const T*>(a.v), static_cast<const T*>(a.o),
          static_cast<const T*>(a.dout), a.lse, a.delta,
          static_cast<T*>(a.dq), a.S, a.H, a.Hkv, a.D, a.scale, a.causal,
          a.window, vec_ok<T>(a));
  return cudaGetLastError();
}

template <typename T, int DP, bool kWide = false>
cudaError_t launch_dkv(const Args& a) {
  constexpr size_t smem = dkv_smem_bytes<T, DP, kWide>();
  const cudaError_t e = allow_smem(flash_bwd_dkv_kernel<T, DP, kWide>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid = grid_of<kWide>(a.B * a.Hkv, a.S, a.D);
  flash_bwd_dkv_kernel<T, DP, kWide><<<grid, kThreads, smem, a.stream>>>(
          static_cast<const T*>(a.q), static_cast<const T*>(a.k),
          static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
          a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.S, a.H,
          a.Hkv, a.D, a.scale, a.causal, a.window, vec_ok<T>(a));
  return cudaGetLastError();
}

// which: 0 = the dq kernel, 1 = the dk/dv kernel
template <typename T>
cudaError_t dispatch_dim(int which, const Args& a) {
  if (a.D <= 0) return cudaErrorInvalidValue;
  if (a.D <= 32) return which ? launch_dkv<T, 32>(a) : launch_dq<T, 32>(a);
  if (a.D <= 64) return which ? launch_dkv<T, 64>(a) : launch_dq<T, 64>(a);
  if (a.D <= kChunk)
    return which ? launch_dkv<T, kChunk>(a) : launch_dq<T, kChunk>(a);
  return which ? launch_dkv<T, kChunk, true>(a)
               : launch_dq<T, kChunk, true>(a);
}

int dispatch(int which, int dtype, const Args& a) {
  if (a.B <= 0 || a.S <= 0 || a.H <= 0 || a.Hkv <= 0 || a.H % a.Hkv != 0 ||
      (a.S + kRows - 1) / kRows > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)dispatch_dim<float>(which, a);
  if (dtype == 1) return (int)dispatch_dim<__nv_bfloat16>(which, a);
  if (dtype == 2) return (int)dispatch_dim<__half>(which, a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  D >= 1 (above 128 in
// ceil(D / 128) chunks).  window <= 0 means no window.  lse (from the
// forward's training form) and delta are f32 (B, H, S); the dq kernel
// writes delta, the dk/dv kernel reads it, so the dq kernel runs first on
// the same stream.  Each returns the cudaError_t of its launch (0 on
// success).
extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* o,
                                      const void* dout, const void* lse,
                                      void* delta, void* dq, int B, int S,
                                      int H, int Hkv, int D, int dtype,
                                      float scale, int causal, int window,
                                      void* stream) {
  const Args a{q, k, v, o, dout, static_cast<const float*>(lse),
               static_cast<float*>(delta), dq, nullptr, nullptr, B, S, H,
               Hkv, D, scale, causal, window,
               static_cast<cudaStream_t>(stream)};
  return dispatch(0, dtype, a);
}

extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dk, void* dv, int B, int S,
                                       int H, int Hkv, int D, int dtype,
                                       float scale, int causal, int window,
                                       void* stream) {
  const Args a{q, k, v, nullptr, dout, static_cast<const float*>(lse),
               const_cast<float*>(static_cast<const float*>(delta)), nullptr,
               dk, dv, B, S, H, Hkv, D, scale, causal, window,
               static_cast<cudaStream_t>(stream)};
  return dispatch(1, dtype, a);
}
