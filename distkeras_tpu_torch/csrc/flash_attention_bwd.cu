// Flash-attention backward for Hopper (sm_90a), CUDA C++: the dq kernel and
// the dk/dv kernel.
//
// Replaces distkeras_tpu/ops/flash_attention.py :: _dq_kernel and
// _dkv_kernel (the Pallas TPU kernels launched by _flash_backward through
// pl.pallas_call, from the custom_vjp's _bwd).  Both recompute the
// probabilities from the forward's saved per-row logsumexp instead of
// reading an (S, S) tensor, so nothing of size S * S is ever stored.
//
// What they compute.  With s = q . k^T * scale (masked to -inf),
// p = exp(s - lse), Delta = rowsum(dO o O) over O as stored (in q's dtype),
// dp = dO . v^T and ds = p o (dp - Delta) * scale:
//     dq = ds . k              (one per query head)
//     dk = ds^T . q,  dv = p^T . dO
// where dk and dv of kv head hk sum over the G = H / Hkv query heads that
// read it (grouped-query attention).  The TPU path repeats k and v to H
// heads (ops/attention.py's jnp.repeat) and sums the per-head dk/dv
// through the repeat's transpose; here the dk/dv block loops over the G
// heads itself and sums in f32 registers, then rounds once: no atomics, so
// the result is deterministic.  All arithmetic is f32, as in the TPU
// kernels; inputs are the BSHD layout (q, O, dO, dq: (B, S, H, D); k, v,
// dk, dv: (B, S, Hkv, D)); lse and Delta are f32 (B, H, S).
//
// What bounds them on the H100.  The schedule does 14*D flops per live
// (q, k) pair (dq: q.k, dO.v, ds.k; dk/dv: q.k, dO.v, p^T.dO, ds^T.q)
// against O(S * D) bytes per head, so at the slice's shapes (D = 32,
// S = 2048) both are bound by arithmetic.  Like the forward, this first
// version runs in f32 on the CUDA cores (67 TFLOP/s peak), with operands
// in shared memory, so the f32 FMA issue rate and shared-memory reads are
// its limits; tensor cores (wgmma), TMA and bf16 operands are for later.
//
// What the design does about it.  The TPU kernels carry dq (and dk, dv)
// in VMEM scratch across a sequential inner grid axis; H100 blocks run in
// no order, so each block owns its output tile and loops itself.
// - dq kernel: one block of 8 warps per (batch*head, 64-row q tile),
//   looping over 32-key tiles.  q and dO rows are staged in f32 shared
//   memory (read as broadcast float4); k and v tiles are staged with rows
//   padded by one float, so lane j reading key j hits a distinct bank.  Lane
//   j computes s and dp of key j for the warp's 8 rows; ds goes through
//   shared memory and each lane accumulates D/32 columns of dq.  The block
//   computes Delta of its rows first, as _dq_kernel does from its resident
//   blocks, and writes it out for the dk/dv kernel (launched after it on
//   the same stream), which then never reads O.
// - dk/dv kernel: one block of 8 warps per (batch*kv head, 64-key tile),
//   looping over the G query heads and their 32-row q tiles.  The roles
//   swap: each warp owns 8 keys, lane i computes s and dp of q row i, p and
//   ds go through shared memory, and each lane accumulates D/32 columns of
//   dk and dv for the warp's keys.
// - Whole tiles outside the TPU's _live_kq (the causal future, or behind
//   the window) are skipped in both kernels, so a windowed backward is
//   O(S * window).  Ragged S is masked (keys and rows >= S contribute
//   nothing and are not written).
// - Templated on the head dim padded up to 32, 64, 128 or 256 (padded
//   columns are zero in shared memory and never stored) and on the dtype
//   (f32, bf16, f16).
// - Head dims above 256 (the TPU kernels take any head dim) are tiled,
//   since whole-D f32 tiles would not fit in the 227 KB a block may have:
//   with kWide the tiles are 256 columns wide and each block owns one
//   256-column chunk of its output (dq, or dk and dv; blockIdx.z, ceil(D /
//   256) chunks).  It builds s and dp by a loop over the D chunks, staging
//   the operands chunk by chunk through the tiles (in the order of one
//   pass over D, so every chunk's block computes the same f32 s and dp),
//   then restages the chunk it owns of the operand it multiplies (k for
//   dq; q and dO for dk/dv) and writes only its own chunk.  Delta is a
//   rowsum over all of D read from device memory, as before; chunk 0
//   writes it.  So s and dp are recomputed once per chunk.  D <= 256 takes
//   the kWide = false instantiations, in which the chunk loop runs once
//   and the block's resident tiles are staged once, as before.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 256;  // tile width above D = 256
constexpr unsigned kFull = 0xffffffffu;

// dq kernel: 64 q rows per block (8 per warp), 32 keys per tile (one per lane)
constexpr int kDqBlockQ = 64;
constexpr int kDqBlockK = 32;
constexpr int kDqRows = kDqBlockQ / kWarps;
// dk/dv kernel: 64 keys per block (8 per warp), 32 q rows per tile (one
// per lane)
constexpr int kDkvBlockK = 64;
constexpr int kDkvBlockQ = 32;
constexpr int kDkvKeys = kDkvBlockK / kWarps;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// the mask of the forward: ragged edge, causal future, behind the window
__device__ __forceinline__ bool hidden(int p, int kp, int S, int causal,
                                       int window) {
  bool hide = kp >= S || p >= S;
  if (causal) hide = hide || kp > p || (window > 0 && kp <= p - window);
  return hide;
}

template <int DP>
constexpr size_t dq_smem_bytes() {
  // q and dO tiles, padded k and v tiles, ds
  return sizeof(float) * (2 * kDqBlockQ * DP + 2 * kDqBlockK * (DP + 1) +
                          kDqBlockQ * kDqBlockK);
}

template <int DP>
constexpr size_t dkv_smem_bytes() {
  // k and v tiles, padded q and dO tiles, p and ds
  return sizeof(float) * (2 * kDkvBlockK * DP + 2 * kDkvBlockQ * (DP + 1) +
                          2 * kDkvBlockK * kDkvBlockQ);
}

// DP: the tiles' width, the head dim D padded up to a multiple of 32 or,
// with kWide (D > kChunk), the chunk width kChunk
template <typename T, int DP, bool kWide>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ o,
                        const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        float* __restrict__ delta, T* __restrict__ dq, int S,
                        int H, int Hkv, int D, float scale, int causal,
                        int window) {
  static_assert(DP % 32 == 0, "a lane owns DP / 32 output columns");
  static_assert(!kWide || DP == kChunk, "wide tiles are one chunk wide");
  constexpr int DC = DP / 32;
  constexpr int R = kDqRows;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                          // [kDqBlockQ][DP]
  float* dOs = Qs + kDqBlockQ * DP;          // [kDqBlockQ][DP]
  float* Ks = dOs + kDqBlockQ * DP;          // [kDqBlockK][DP + 1]
  float* Vs = Ks + kDqBlockK * (DP + 1);     // [kDqBlockK][DP + 1]
  float* DSs = Vs + kDqBlockK * (DP + 1);    // [kDqBlockQ][kDqBlockK]

  // batch*head fastest, heaviest causal q tiles first
  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = qt * kDqBlockQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // the dq chunk of this block, and the number of D chunks (1 and 1
  // unless kWide)
  const int zc = kWide ? (int)blockIdx.z : 0;
  const int n_dc = kWide ? (D + DP - 1) / DP : 1;

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

  // stage the q and dO columns [d0, d0 + DP)
  auto stage_q = [&](int d0) {
    for (int i = tid; i < kDqBlockQ * DP; i += kThreads) {
      const int r = i / DP, d = i % DP, p = q0 + r;
      const bool in = p < S && d0 + d < D;
      Qs[i] = in ? to_f32(qb[(size_t)p * q_stride + d0 + d]) : 0.f;
      dOs[i] = in ? to_f32(dob[(size_t)p * q_stride + d0 + d]) : 0.f;
    }
  };
  // stage the k (and v) columns [d0, d0 + DP) of the key tile at k0
  auto stage_kv = [&](int k0, int d0, bool with_v) {
    for (int i = tid; i < kDqBlockK * DP; i += kThreads) {
      const int r = i / DP, d = i % DP, kp = k0 + r;
      const bool in = kp < S && d0 + d < D;
      Ks[r * (DP + 1) + d] =
          in ? to_f32(kb[(size_t)kp * kv_stride + d0 + d]) : 0.f;
      if (with_v)
        Vs[r * (DP + 1) + d] =
            in ? to_f32(vb[(size_t)kp * kv_stride + d0 + d]) : 0.f;
    }
  };
  if (!kWide) stage_q(0);

  // per-row statistics of the warp's rows: lse, and Delta = rowsum(dO o O)
  // from O as stored, which this block also writes for the dk/dv kernel
  const int row0 = q0 + warp * R;
  float lse_r[R], delta_r[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int p = row0 + r;
    float part = 0.f;
    if (p < S)
      for (int d = lane; d < D; d += 32)
        part = fmaf(to_f32(dob[(size_t)p * q_stride + d]),
                    to_f32(ob[(size_t)p * q_stride + d]), part);
    delta_r[r] = warp_sum(part);
    lse_r[r] = p < S ? lse[(size_t)bh * S + p] : 0.f;
    if (p < S && lane == 0 && zc == 0) delta[(size_t)bh * S + p] = delta_r[r];
  }

  float acc[R][DC];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.f;

  // live k tiles (_live_kq), as in the forward
  const int q_last = min(q0 + kDqBlockQ, S) - 1;
  int kt_end = (S + kDqBlockK - 1) / kDqBlockK;
  if (causal) kt_end = min(kt_end, q_last / kDqBlockK + 1);
  int kt_begin = 0;
  if (window > 0 && q0 - window + 1 > 0)
    kt_begin = (q0 - window + 1) / kDqBlockK;

  const float* qw = Qs + warp * R * DP;
  const float* dow = dOs + warp * R * DP;
  float* dsw = DSs + warp * R * kDqBlockK;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kDqBlockK;
    // lane j: s[r] = q[row r] . k[k0 + j], dp[r] = dO[row r] . v[k0 + j],
    // summed over the D chunks in order (one chunk unless kWide)
    float s[R], dp[R];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = dp[r] = 0.f;
    for (int dc = 0; dc < n_dc; ++dc) {
      __syncthreads();  // q/dO staged, and every warp is done with the last tile
      if (kWide) stage_q(dc * DP);
      stage_kv(k0, dc * DP, true);
      __syncthreads();

      const float* kr = Ks + lane * (DP + 1);
      const float* vr = Vs + lane * (DP + 1);
#pragma unroll 2
      for (int d = 0; d < DP; d += 4) {
        const float k0v = kr[d], k1v = kr[d + 1], k2v = kr[d + 2],
                    k3v = kr[d + 3];
        const float v0v = vr[d], v1v = vr[d + 1], v2v = vr[d + 2],
                    v3v = vr[d + 3];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 qv = *reinterpret_cast<const float4*>(qw + r * DP + d);
          const float4 gv = *reinterpret_cast<const float4*>(dow + r * DP + d);
          s[r] = fmaf(qv.x, k0v, s[r]);
          s[r] = fmaf(qv.y, k1v, s[r]);
          s[r] = fmaf(qv.z, k2v, s[r]);
          s[r] = fmaf(qv.w, k3v, s[r]);
          dp[r] = fmaf(gv.x, v0v, dp[r]);
          dp[r] = fmaf(gv.y, v1v, dp[r]);
          dp[r] = fmaf(gv.z, v2v, dp[r]);
          dp[r] = fmaf(gv.w, v3v, dp[r]);
        }
      }
    }

    const int kp = k0 + lane;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float pr = hidden(row0 + r, kp, S, causal, window)
                           ? 0.f
                           : expf(s[r] * scale - lse_r[r]);
      dsw[r * kDqBlockK + lane] = pr * (dp[r] - delta_r[r]) * scale;
    }
    __syncwarp();
    if (kWide && zc != n_dc - 1) {  // the tile holds another chunk of k
      __syncthreads();
      stage_kv(k0, zc * DP, false);
      __syncthreads();
    }

    // acc[r][c] += sum_j ds[r][j] * k[j][c * 32 + lane]
#pragma unroll 2
    for (int j = 0; j < kDqBlockK; j += 4) {
      float kk[4][DC];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int c = 0; c < DC; ++c)
          kk[jj][c] = Ks[(j + jj) * (DP + 1) + c * 32 + lane];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 d4 =
            *reinterpret_cast<const float4*>(dsw + r * kDqBlockK + j);
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          acc[r][c] = fmaf(d4.x, kk[0][c], acc[r][c]);
          acc[r][c] = fmaf(d4.y, kk[1][c], acc[r][c]);
          acc[r][c] = fmaf(d4.z, kk[2][c], acc[r][c]);
          acc[r][c] = fmaf(d4.w, kk[3][c], acc[r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int p = row0 + r;
    if (p >= S) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = zc * DP + c * 32 + lane;
      if (col < D) dqb[(size_t)p * q_stride + col] = from_f32<T>(acc[r][c]);
    }
  }
}

template <typename T, int DP, bool kWide>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, int S, int H, int Hkv, int D,
                         float scale, int causal, int window) {
  static_assert(DP % 32 == 0, "a lane owns DP / 32 output columns");
  static_assert(!kWide || DP == kChunk, "wide tiles are one chunk wide");
  constexpr int DC = DP / 32;
  constexpr int KR = kDkvKeys;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                            // [kDkvBlockK][DP]
  float* Vs = Ks + kDkvBlockK * DP;            // [kDkvBlockK][DP]
  float* Qs = Vs + kDkvBlockK * DP;            // [kDkvBlockQ][DP + 1]
  float* dOs = Qs + kDkvBlockQ * (DP + 1);     // [kDkvBlockQ][DP + 1]
  float* Ps = dOs + kDkvBlockQ * (DP + 1);     // [kDkvBlockK][kDkvBlockQ]
  float* DSs = Ps + kDkvBlockK * kDkvBlockQ;   // [kDkvBlockK][kDkvBlockQ]

  // batch*kv head fastest; under causal masking the earliest key tiles see
  // the most q tiles, so the heaviest blocks come first
  const int bhk = blockIdx.x;
  const int b = bhk / Hkv, hk = bhk % Hkv;
  const int G = H / Hkv;
  const int k0 = blockIdx.y * kDkvBlockK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // the dk/dv chunk of this block, and the number of D chunks (1 and 1
  // unless kWide)
  const int zc = kWide ? (int)blockIdx.z : 0;
  const int n_dc = kWide ? (D + DP - 1) / DP : 1;

  const size_t q_stride = (size_t)H * D;
  const size_t kv_stride = (size_t)Hkv * D;
  const size_t kv_off = ((size_t)b * S * Hkv + hk) * D;
  const T* kb = k + kv_off;
  const T* vb = v + kv_off;

  // stage the k and v columns [d0, d0 + DP) of this block's keys
  auto stage_kv = [&](int d0) {
    for (int i = tid; i < kDkvBlockK * DP; i += kThreads) {
      const int r = i / DP, d = i % DP, kp = k0 + r;
      const bool in = kp < S && d0 + d < D;
      Ks[i] = in ? to_f32(kb[(size_t)kp * kv_stride + d0 + d]) : 0.f;
      Vs[i] = in ? to_f32(vb[(size_t)kp * kv_stride + d0 + d]) : 0.f;
    }
  };
  if (!kWide) stage_kv(0);

  float dk_acc[KR][DC], dv_acc[KR][DC];
#pragma unroll
  for (int kk = 0; kk < KR; ++kk)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk_acc[kk][c] = dv_acc[kk][c] = 0.f;

  // live q tiles (_live_kq seen from the key side): causal starts at the
  // tile holding this block's first key; a window ends at the tile holding
  // the last row that can still see this block's last key
  const int nqt = (S + kDkvBlockQ - 1) / kDkvBlockQ;
  const int qt_begin = causal ? k0 / kDkvBlockQ : 0;
  int qt_end = nqt;
  if (window > 0)
    qt_end = min(nqt, (k0 + kDkvBlockK - 2 + window) / kDkvBlockQ + 1);

  const int key0 = k0 + warp * KR;  // this warp's first key
  const float* kw = Ks + warp * KR * DP;
  const float* vw = Vs + warp * KR * DP;
  float* pw = Ps + warp * KR * kDkvBlockQ;
  float* dsw = DSs + warp * KR * kDkvBlockQ;

  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const size_t bh = (size_t)b * H + h;
    const size_t q_off = ((size_t)b * S * H + h) * D;
    const T* qb = q + q_off;
    const T* dob = dout + q_off;
    // stage the q and dO columns [d0, d0 + DP) of the q tile at q0
    auto stage_q = [&](int q0, int d0) {
      for (int i = tid; i < kDkvBlockQ * DP; i += kThreads) {
        const int r = i / DP, d = i % DP, p = q0 + r;
        const bool in = p < S && d0 + d < D;
        Qs[r * (DP + 1) + d] =
            in ? to_f32(qb[(size_t)p * q_stride + d0 + d]) : 0.f;
        dOs[r * (DP + 1) + d] =
            in ? to_f32(dob[(size_t)p * q_stride + d0 + d]) : 0.f;
      }
    };
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * kDkvBlockQ;
      // lane i: s[kk] = q[q0 + i] . k[key0 + kk], dp[kk] = dO[q0 + i] . v[..],
      // summed over the D chunks in order (one chunk unless kWide)
      const int p = q0 + lane;
      const float lse_p = p < S ? lse[bh * S + p] : 0.f;
      const float delta_p = p < S ? delta[bh * S + p] : 0.f;
      float s[KR], dp[KR];
#pragma unroll
      for (int kk = 0; kk < KR; ++kk) s[kk] = dp[kk] = 0.f;
      for (int dc = 0; dc < n_dc; ++dc) {
        __syncthreads();  // k/v staged, and every warp is done with the last tile
        if (kWide) stage_kv(dc * DP);
        stage_q(q0, dc * DP);
        __syncthreads();

        const float* qr = Qs + lane * (DP + 1);
        const float* gr = dOs + lane * (DP + 1);
#pragma unroll 2
        for (int d = 0; d < DP; d += 4) {
          const float q0v = qr[d], q1v = qr[d + 1], q2v = qr[d + 2],
                      q3v = qr[d + 3];
          const float g0v = gr[d], g1v = gr[d + 1], g2v = gr[d + 2],
                      g3v = gr[d + 3];
#pragma unroll
          for (int kk = 0; kk < KR; ++kk) {
            const float4 k4 = *reinterpret_cast<const float4*>(kw + kk * DP + d);
            const float4 v4 = *reinterpret_cast<const float4*>(vw + kk * DP + d);
            s[kk] = fmaf(q0v, k4.x, s[kk]);
            s[kk] = fmaf(q1v, k4.y, s[kk]);
            s[kk] = fmaf(q2v, k4.z, s[kk]);
            s[kk] = fmaf(q3v, k4.w, s[kk]);
            dp[kk] = fmaf(g0v, v4.x, dp[kk]);
            dp[kk] = fmaf(g1v, v4.y, dp[kk]);
            dp[kk] = fmaf(g2v, v4.z, dp[kk]);
            dp[kk] = fmaf(g3v, v4.w, dp[kk]);
          }
        }
      }
#pragma unroll
      for (int kk = 0; kk < KR; ++kk) {
        const float pr = hidden(p, key0 + kk, S, causal, window)
                             ? 0.f
                             : expf(s[kk] * scale - lse_p);
        pw[kk * kDkvBlockQ + lane] = pr;
        dsw[kk * kDkvBlockQ + lane] = pr * (dp[kk] - delta_p) * scale;
      }
      __syncwarp();
      if (kWide && zc != n_dc - 1) {  // the tiles hold another chunk of q, dO
        __syncthreads();
        stage_q(q0, zc * DP);
        __syncthreads();
      }

      // dv[kk][c] += sum_i p[kk][i] * dO[i][c * 32 + lane]
#pragma unroll 2
      for (int i = 0; i < kDkvBlockQ; i += 4) {
        float gg[4][DC];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int c = 0; c < DC; ++c)
            gg[ii][c] = dOs[(i + ii) * (DP + 1) + c * 32 + lane];
#pragma unroll
        for (int kk = 0; kk < KR; ++kk) {
          const float4 p4 =
              *reinterpret_cast<const float4*>(pw + kk * kDkvBlockQ + i);
#pragma unroll
          for (int c = 0; c < DC; ++c) {
            dv_acc[kk][c] = fmaf(p4.x, gg[0][c], dv_acc[kk][c]);
            dv_acc[kk][c] = fmaf(p4.y, gg[1][c], dv_acc[kk][c]);
            dv_acc[kk][c] = fmaf(p4.z, gg[2][c], dv_acc[kk][c]);
            dv_acc[kk][c] = fmaf(p4.w, gg[3][c], dv_acc[kk][c]);
          }
        }
      }
      // dk[kk][c] += sum_i ds[kk][i] * q[i][c * 32 + lane]
#pragma unroll 2
      for (int i = 0; i < kDkvBlockQ; i += 4) {
        float qq[4][DC];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int c = 0; c < DC; ++c)
            qq[ii][c] = Qs[(i + ii) * (DP + 1) + c * 32 + lane];
#pragma unroll
        for (int kk = 0; kk < KR; ++kk) {
          const float4 d4 =
              *reinterpret_cast<const float4*>(dsw + kk * kDkvBlockQ + i);
#pragma unroll
          for (int c = 0; c < DC; ++c) {
            dk_acc[kk][c] = fmaf(d4.x, qq[0][c], dk_acc[kk][c]);
            dk_acc[kk][c] = fmaf(d4.y, qq[1][c], dk_acc[kk][c]);
            dk_acc[kk][c] = fmaf(d4.z, qq[2][c], dk_acc[kk][c]);
            dk_acc[kk][c] = fmaf(d4.w, qq[3][c], dk_acc[kk][c]);
          }
        }
      }
    }
  }

  T* dkb = dk + kv_off;
  T* dvb = dv + kv_off;
#pragma unroll
  for (int kk = 0; kk < KR; ++kk) {
    const int kp = key0 + kk;
    if (kp >= S) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = zc * DP + c * 32 + lane;
      if (col < D) {
        dkb[(size_t)kp * kv_stride + col] = from_f32<T>(dk_acc[kk][c]);
        dvb[(size_t)kp * kv_stride + col] = from_f32<T>(dv_acc[kk][c]);
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

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int DP, bool kWide = false>
cudaError_t launch_dq(const Args& a) {
  constexpr size_t smem = dq_smem_bytes<DP>();
  const cudaError_t e = allow_smem(flash_bwd_dq_kernel<T, DP, kWide>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(a.B * a.H, (a.S + kDqBlockQ - 1) / kDqBlockQ,
                  kWide ? (a.D + DP - 1) / DP : 1);
  flash_bwd_dq_kernel<T, DP, kWide><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.o),
      static_cast<const T*>(a.dout), a.lse, a.delta, static_cast<T*>(a.dq),
      a.S, a.H, a.Hkv, a.D, a.scale, a.causal, a.window);
  return cudaGetLastError();
}

template <typename T, int DP, bool kWide = false>
cudaError_t launch_dkv(const Args& a) {
  constexpr size_t smem = dkv_smem_bytes<DP>();
  const cudaError_t e = allow_smem(flash_bwd_dkv_kernel<T, DP, kWide>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(a.B * a.Hkv, (a.S + kDkvBlockK - 1) / kDkvBlockK,
                  kWide ? (a.D + DP - 1) / DP : 1);
  flash_bwd_dkv_kernel<T, DP, kWide><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.S, a.H, a.Hkv,
      a.D, a.scale, a.causal, a.window);
  return cudaGetLastError();
}

// which: 0 = the dq kernel, 1 = the dk/dv kernel
template <typename T>
cudaError_t dispatch_dim(int which, const Args& a) {
  if (a.D <= 0) return cudaErrorInvalidValue;
  if (a.D <= 32) return which ? launch_dkv<T, 32>(a) : launch_dq<T, 32>(a);
  if (a.D <= 64) return which ? launch_dkv<T, 64>(a) : launch_dq<T, 64>(a);
  if (a.D <= 128) return which ? launch_dkv<T, 128>(a) : launch_dq<T, 128>(a);
  if (a.D <= 256) return which ? launch_dkv<T, 256>(a) : launch_dq<T, 256>(a);
  if ((a.D + kChunk - 1) / kChunk > 65535) return cudaErrorInvalidValue;
  return which ? launch_dkv<T, kChunk, true>(a) : launch_dq<T, kChunk, true>(a);
}

int dispatch(int which, int dtype, const Args& a) {
  if (a.B <= 0 || a.S <= 0 || a.H <= 0 || a.Hkv <= 0 || a.H % a.Hkv != 0 ||
      (a.S + kDqBlockQ - 1) / kDqBlockQ > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)dispatch_dim<float>(which, a);
  if (dtype == 1) return (int)dispatch_dim<__nv_bfloat16>(which, a);
  if (dtype == 2) return (int)dispatch_dim<__half>(which, a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  D >= 1 (above 256 in
// ceil(D / 256) chunks, at most 65535).
// window <= 0 means no window.  lse (from the forward's training form) and
// delta are f32 (B, H, S); the dq kernel writes delta, the dk/dv kernel
// reads it, so the dq kernel runs first on the same stream.
// Each returns the cudaError_t of its launch (0 on success).
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
