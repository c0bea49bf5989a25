// Flash-attention forward for Hopper (sm_90a), CUDA C++.
//
// Replaces distkeras_tpu/ops/flash_attention.py :: _flash_kernel (the
// Pallas TPU kernel launched by _flash_forward through pl.pallas_call) in
// both of its forms.  The inference form (lse == nullptr) writes only the
// output.  The training form (save_residuals=True, the custom_vjp's _fwd)
// also writes the f32 per-row logsumexp of the scaled scores,
//     lse[b, h, p] = safe_m + log(l)   (safe_m = 0 for an all-masked row,
//                                       l == 0 taken as 1),
// in a (B, H, S) layout: the statistic the backward kernels
// (flash_attention_bwd.cu) recompute p = exp(s - lse) from.  The TPU
// kernel's 128-lane broadcast of it is TPU layout and is not carried over.
// The training form adds one branch and one f32 store per row at the end;
// the inference form skips both.
//
// What it computes.  For every (batch, head, q row p):
//     out[p] = softmax(q[p] . k^T * scale + mask) . v
// with the mask causal (keys after p hidden) and, optionally, a sliding
// window that keeps keys in (p - window, p].  Inputs are the JAX package's
// BSHD layout: q and out (B, S, H, D), k and v (B, S, Hkv, D); query head h
// reads kv head h / (H / Hkv) (grouped-query attention) instead of a
// repeated copy of k and v.  The online-softmax recurrence runs in f32 as
// the TPU kernel's does: q, k and v are upcast, m, l and acc are f32, the
// row maximum is replaced by 0 while a row is still all -inf ("safe"), and
// l == 0 becomes 1 at the end.  The output is written in q's dtype.
//
// What bounds it on the H100.  The work is 4*D flops per live (q, k) pair
// against 2*D loaded elements per key tile shared by 64 q rows, so at the
// shapes of the serving slice (D = 32, S = 2048) it is bound by arithmetic,
// not by HBM bytes.  This first version does its arithmetic in f32 on the
// CUDA cores (67 TFLOP/s peak), not on the tensor cores (989 TFLOP/s bf16),
// and reads its operands from shared memory, so shared-memory bandwidth
// and the f32 FMA rate are its limits.
//
// What the design does about it.  One thread block of 8 warps owns one
// (batch*head, 64-row q tile) pair; a loop over 32-key tiles inside the
// block takes the place of the TPU's sequential inner grid axis.  The q
// tile is staged once, pre-scaled, in shared memory; each k/v tile is
// staged in f32 (k rows padded by one float, so lane j reading key j hits
// a distinct bank).  Each warp owns 8 q rows: lane j computes the scores
// of key j for all 8 rows (q read as broadcast float4), the row max and
// sum are warp shuffles, and the probabilities go through shared memory
// so that the P.V product reads them as broadcast float4 while each lane
// accumulates its own DP/32 output columns (DP: D padded, below).  Whole k tiles in the causal
// future or entirely behind the window are never visited (the TPU's
// _live_kq), which makes windowed attention O(S * window).  Ragged S is
// masked in the kernel.  The kernel is templated on the head dim padded up
// to 32, 64, 128 or 256 (columns past D are zero in shared memory and
// never written) and on the dtype (f32, bf16, f16).
//
// Head dims above 256 (the TPU kernel takes any head dim) are tiled: with
// kWide the tiles are 256 columns wide and hold one 256-column chunk of
// q, k and v at a time, since whole-D f32 tiles would not fit in the
// 227 KB a block may have.  Each block then owns one 256-column chunk of
// the output (blockIdx.z, ceil(D / 256) chunks): for every key tile it
// builds the scores by a loop over the D chunks, staging q and k chunk by
// chunk through the tiles (in the order of one pass over D, so every
// chunk's block computes the same f32 scores), stages only its own chunk
// of v, and writes only its own chunk of the output; chunk 0 writes the
// lse.  So the scores are recomputed once per chunk.  D <= 256 takes the
// kWide = false instantiation, in which the chunk loop runs once and q is
// staged once per block, as before.
// The wrapper (ops/flash_attention.py :: _forward_variant) sends it f32
// inputs, and 16-bit inputs whose head dim is not a multiple of 8 or is
// above 256; other 16-bit inputs go to the tensor-core kernel,
// flash_attention_fwd_sm90.cu.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlockQ = 64;                    // q rows per thread block
constexpr int kBlockK = 32;                    // keys per tile: one per lane
constexpr int kWarps = 8;
constexpr int kRowsPerWarp = kBlockQ / kWarps;  // 8
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 256;                    // tile width above D = 256
constexpr unsigned kFull = 0xffffffffu;

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

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

template <int DP>
constexpr size_t smem_bytes() {
  // q tile, padded k tile, v tile, probabilities
  return sizeof(float) * (kBlockQ * DP + kBlockK * (DP + 1) + kBlockK * DP +
                          kBlockQ * kBlockK);
}

// DP: the tiles' width, the head dim D padded up to a multiple of 32 or,
// with kWide (D > kChunk), the chunk width kChunk
template <typename T, int DP, bool kWide>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int S, int H, int Hkv, int D,
                     float scale, int causal, int window) {
  static_assert(DP % 32 == 0, "a lane owns DP / 32 output columns");
  static_assert(!kWide || DP == kChunk, "wide tiles are one chunk wide");
  constexpr int DC = DP / 32;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                      // [kBlockQ][DP], pre-scaled
  float* Ks = Qs + kBlockQ * DP;         // [kBlockK][DP + 1]
  float* Vs = Ks + kBlockK * (DP + 1);   // [kBlockK][DP]
  float* Ps = Vs + kBlockK * DP;         // [kBlockQ][kBlockK]

  // block order runs over (batch*head) fastest, heaviest causal q tiles
  // first, so the short ones fill the tail
  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = qt * kBlockQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // the output chunk of this block, and the number of D chunks (1 and 1
  // unless kWide)
  const int zc = kWide ? (int)blockIdx.z : 0;
  const int n_dc = kWide ? (D + DP - 1) / DP : 1;

  const size_t q_stride = (size_t)H * D;  // elements from one position to the next
  const size_t kv_stride = (size_t)Hkv * D;
  const T* qb = q + ((size_t)b * S * H + h) * D;
  const T* kb = k + ((size_t)b * S * Hkv + hk) * D;
  const T* vb = v + ((size_t)b * S * Hkv + hk) * D;
  T* ob = o + ((size_t)b * S * H + h) * D;

  // stage the q columns [d0, d0 + DP), pre-scaled
  auto stage_q = [&](int d0) {
    for (int i = tid; i < kBlockQ * DP; i += kThreads) {
      const int r = i / DP, d = i % DP, p = q0 + r;
      Qs[i] = p < S && d0 + d < D
                  ? to_f32(qb[(size_t)p * q_stride + d0 + d]) * scale
                  : 0.f;
    }
  };
  if (!kWide) stage_q(0);

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DC];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.f;
  }

  // live k tiles (the TPU kernel's _live_kq): causal stops at the tile
  // holding this q tile's last row; a window starts at the tile holding
  // the first key the tile's first row can see
  const int q_last = min(q0 + kBlockQ, S) - 1;
  int kt_end = (S + kBlockK - 1) / kBlockK;
  if (causal) kt_end = min(kt_end, q_last / kBlockK + 1);
  int kt_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_begin = (q0 - window + 1) / kBlockK;

  const int row0 = q0 + warp * kRowsPerWarp;  // this warp's first q row
  const float* qw = Qs + warp * kRowsPerWarp * DP;
  float* pw = Ps + warp * kRowsPerWarp * kBlockK;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBlockK;
    // scores: lane j holds s[r] = q[row0 + r] . k[k0 + j], summed over the
    // D chunks in order (one chunk unless kWide)
    float s[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.f;
    for (int dc = 0; dc < n_dc; ++dc) {
      const int d0 = dc * DP;
      __syncthreads();  // q staged, and every warp is done with the last tile
      if (kWide) stage_q(d0);
      for (int i = tid; i < kBlockK * DP; i += kThreads) {
        const int r = i / DP, d = i % DP, kp = k0 + r;
        const bool in = kp < S && d0 + d < D;
        Ks[r * (DP + 1) + d] =
            in ? to_f32(kb[(size_t)kp * kv_stride + d0 + d]) : 0.f;
        if (dc == zc)  // this block's own chunk of v
          Vs[r * DP + d] = in ? to_f32(vb[(size_t)kp * kv_stride + d0 + d])
                              : 0.f;
      }
      __syncthreads();

      const float* kr = Ks + lane * (DP + 1);
#pragma unroll 4
      for (int d = 0; d < DP; d += 4) {
        const float k0v = kr[d], k1v = kr[d + 1], k2v = kr[d + 2],
                    k3v = kr[d + 3];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const float4 qv = *reinterpret_cast<const float4*>(qw + r * DP + d);
          s[r] = fmaf(qv.x, k0v, s[r]);
          s[r] = fmaf(qv.y, k1v, s[r]);
          s[r] = fmaf(qv.z, k2v, s[r]);
          s[r] = fmaf(qv.w, k3v, s[r]);
        }
      }
    }

    const int kp = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int p = row0 + r;
      bool hide = kp >= S;  // ragged edge
      if (causal) hide = hide || kp > p || (window > 0 && kp <= p - window);
      if (hide) s[r] = -INFINITY;
    }

    // online softmax, f32, with the TPU kernel's empty-row guard
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float new_m = fmaxf(m[r], warp_max(s[r]));
      const float safe = new_m == -INFINITY ? 0.f : new_m;
      const float pr = expf(s[r] - safe);
      const float corr = expf(m[r] - safe);
      l[r] = l[r] * corr + warp_sum(pr);
      m[r] = new_m;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[r][c] *= corr;
      pw[r * kBlockK + lane] = pr;
    }
    __syncwarp();

    // acc[r][c] += sum_j p[r][j] * v[j][c * 32 + lane]
#pragma unroll 2
    for (int j = 0; j < kBlockK; j += 4) {
      float vv[4][DC];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int c = 0; c < DC; ++c)
          vv[jj][c] = Vs[(j + jj) * DP + c * 32 + lane];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 p4 = *reinterpret_cast<const float4*>(pw + r * kBlockK + j);
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          acc[r][c] = fmaf(p4.x, vv[0][c], acc[r][c]);
          acc[r][c] = fmaf(p4.y, vv[1][c], acc[r][c]);
          acc[r][c] = fmaf(p4.z, vv[2][c], acc[r][c]);
          acc[r][c] = fmaf(p4.w, vv[3][c], acc[r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int p = row0 + r;
    if (p >= S) continue;
    const float denom = l[r] == 0.f ? 1.f : l[r];
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = zc * DP + c * 32 + lane;
      if (col < D) ob[(size_t)p * q_stride + col] = from_f32<T>(acc[r][c] / denom);
    }
    if (lse != nullptr && lane == 0 && zc == 0) {
      const float safe_m = m[r] == -INFINITY ? 0.f : m[r];
      lse[(size_t)bh * S + p] = safe_m + logf(denom);
    }
  }
}

template <typename T, int DP, bool kWide = false>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int S, int H, int Hkv, int D,
                   float scale, int causal, int window, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DP>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T, DP, kWide>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(B * H, (S + kBlockQ - 1) / kBlockQ,
                  kWide ? (D + DP - 1) / DP : 1);
  flash_fwd_kernel<T, DP, kWide><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, S, H, Hkv, D, scale,
      causal, window);
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
  if (D <= 256)
    return launch<T, 256>(q, k, v, o, lse, B, S, H, Hkv, D, scale, causal, window, stream);
  if ((D + kChunk - 1) / kChunk > 65535) return cudaErrorInvalidValue;
  return launch<T, kChunk, true>(q, k, v, o, lse, B, S, H, Hkv, D, scale,
                                 causal, window, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  D >= 1 (above 256 in
// ceil(D / 256) chunks, at most 65535).
// window <= 0 means no window.  lse: null for the inference form, else a
// (B, H, S) f32 buffer that the training form fills.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, void* lse, int B, int S, int H,
                                   int Hkv, int D, int dtype, float scale,
                                   int causal, int window, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 ||
      (S + kBlockQ - 1) / kBlockQ > 65535)
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
