// Fused softmax cross-entropy, forward and backward, for Hopper (sm_90a),
// CUDA C++.
//
// Replaces the two Pallas TPU kernels behind the custom_vjp of
// distkeras_tpu/ops/fused_ce.py :: fused_softmax_cross_entropy:
//   - fused_ce_fwd_kernel: _fwd_kernel (launched by _fwd_call through
//     pl.pallas_call), the forward;
//   - fused_ce_bwd_kernel: _bwd_kernel (launched by _ce_bwd), the backward.
//
// What they compute.  logits (T, V) in f32, bf16 or f16, labels (T,) int32.
//   forward:   lse[r]  = safe_m + log(l)
//              loss[r] = lse[r] - (0 <= label[r] < V ? logits[r, label[r]] : 0)
//     with m and l the row's running max and sum of exp(x - m) in f32, as the
//     TPU kernel's online recurrence keeps them, safe_m = 0 where m = -inf and
//     l == 0 taken as 1.  An out-of-range label picks nothing (loss = lse), as
//     the TPU kernel's one-hot sum does: never a fault.
//   backward:  dlogits[r, c] = ct[r] * (exp(logits[r, c] - lse[r]) - [c == label[r]])
//     in f32, rounded once to the logits dtype.
// The TPU kernels' 128-lane broadcasts of the per-row statistics are TPU
// layout and are not carried over: loss, lse and ct are (T,) f32 arrays.
//
// What bounds them on the H100.  Memory traffic.  Each element costs one exp
// and a few flops, and each logit is read once (forward) or read once and its
// gradient written once (backward): at the parallel LM's T 16384 x V 32768
// in f32 that is 2.15 GB (0.64 ms at 3.35 TB/s) and 4.29 GB (1.28 ms).  The
// exps, ~0.7 G of them, take under 0.2 ms on the SFUs.  A row is 128 KB, and
// the rows in flight on 132 SMs exceed the 50 MB L2, so a second pass over a
// row would read HBM again: the forward makes one pass.
//
// What the design does about it.  One warp owns one row (8 rows per block of
// 256 threads); T blocks / 8 fill the card many times over at the LM's
// shapes.  Lanes stride the row with 16-byte loads (4 floats or 8 halves),
// kUnroll of them in flight per lane before any is used, with the
// evict-first cache hint, since no logit is read twice by the same kernel.
// The forward keeps a per-lane (m, l) pair, folds each 16-byte vector into
// it with one rescale (one exp per element plus one per vector), and merges
// the 32 pairs with warp shuffles; lane 0 then reads the label's logit
// directly and writes loss and lse.  The backward is a streaming map with
// the same loads and 16-byte evict-first stores.  A vocab that is not a
// multiple of the vector width (1000, GPT-2's 50257) leaves rows that start
// off a 16-byte boundary: each row takes a scalar prologue up to its first
// boundary and a scalar tail, and the backward takes a scalar path for a row
// whose input and output are misaligned relative to each other.  Row offsets
// are 64-bit (T x V passes 2^31 at the JAX sweep's 65536 x 32768).  The
// arithmetic is f32 with the accurate expf, so the kernels agree with their
// plain PyTorch versions to f32 summation order (forward) and to the last
// rounding (backward).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // rows per block: one warp per row
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;  // 16-byte loads in flight per lane
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

// elements of T before the first 16-byte boundary at or after p
template <typename T>
__device__ __forceinline__ int misaligned_head(const T* p) {
  return (int)(((16u - ((uintptr_t)p & 15u)) & 15u) / sizeof(T));
}

template <typename T, int N>
__device__ __forceinline__ void unpack(const uint4& raw, float (&x)[N]) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int j = 0; j < N; ++j) x[j] = to_f32(e[j]);
}

// fold n values into one lane's running (m, l): one rescale per call, with
// the TPU kernel's guard (shift by 0 while the max is still -inf)
template <int N>
__device__ __forceinline__ void fold(const float (&x)[N], float& m, float& l) {
  float cm = x[0];
#pragma unroll
  for (int j = 1; j < N; ++j) cm = fmaxf(cm, x[j]);
  const float nm = fmaxf(m, cm);
  const float safe = nm == -INFINITY ? 0.f : nm;
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < N; ++j) s += expf(x[j] - safe);
  l = l * expf(m - safe) + s;
  m = nm;
}

__device__ __forceinline__ void fold1(float x, float& m, float& l) {
  const float one[1] = {x};
  fold(one, m, l);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fused_ce_fwd_kernel(const T* __restrict__ logits,
                        const int* __restrict__ labels,
                        float* __restrict__ loss, float* __restrict__ lse,
                        int rows, int V) {
  constexpr int N = 16 / sizeof(T);
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= rows) return;  // whole warps only
  const T* row = logits + (size_t)r * V;

  const int pre = min(misaligned_head(row), V);
  const int nvec = (V - pre) / N;
  const uint4* vrow = reinterpret_cast<const uint4*>(row + pre);
  float m = -INFINITY, l = 0.f;  // the identity of the merge below
  for (int c = lane; c < pre; c += 32) fold1(to_f32(row[c]), m, l);
  int i = lane;
  for (; i + (kUnroll - 1) * 32 < nvec; i += kUnroll * 32) {
    uint4 raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) raw[u] = __ldcs(vrow + i + u * 32);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float x[N];
      unpack<T>(raw[u], x);
      fold(x, m, l);
    }
  }
  for (; i < nvec; i += 32) {
    float x[N];
    unpack<T>(__ldcs(vrow + i), x);
    fold(x, m, l);
  }
  for (int c = pre + nvec * N + lane; c < V; c += 32)
    fold1(to_f32(row[c]), m, l);

  // merge the 32 lanes' (m, l) pairs; every lane ends with the row's pair
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(kFull, m, off);
    const float l2 = __shfl_xor_sync(kFull, l, off);
    const float nm = fmaxf(m, m2);
    const float safe = nm == -INFINITY ? 0.f : nm;
    l = l * expf(m - safe) + l2 * expf(m2 - safe);
    m = nm;
  }
  if (lane == 0) {
    const float safe_m = m == -INFINITY ? 0.f : m;
    const float out = safe_m + logf(l == 0.f ? 1.f : l);
    const int lab = labels[r];
    const float picked = (lab >= 0 && lab < V) ? to_f32(row[lab]) : 0.f;
    loss[r] = out - picked;
    lse[r] = out;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fused_ce_bwd_kernel(const T* __restrict__ logits,
                        const int* __restrict__ labels,
                        const float* __restrict__ lse,
                        const float* __restrict__ ct, T* __restrict__ dlogits,
                        int rows, int V) {
  constexpr int N = 16 / sizeof(T);
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= rows) return;
  const T* row = logits + (size_t)r * V;
  T* drow = dlogits + (size_t)r * V;
  const float g = ct[r], z = lse[r];
  const int lab = labels[r];

  // input and output rows off by a non-multiple of 16 bytes from each other
  // cannot share vector offsets: such a row runs scalar from end to end
  const bool paired = (((uintptr_t)row ^ (uintptr_t)drow) & 15u) == 0;
  const int pre = paired ? min(misaligned_head(row), V) : V;
  const int nvec = (V - pre) / N;
  for (int c = lane; c < pre; c += 32)
    drow[c] = from_f32<T>(g * (expf(to_f32(row[c]) - z) - (c == lab ? 1.f : 0.f)));

  const uint4* vin = reinterpret_cast<const uint4*>(row + pre);
  uint4* vout = reinterpret_cast<uint4*>(drow + pre);
  for (int i0 = lane; i0 < nvec; i0 += kUnroll * 32) {
    uint4 raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * 32;
      if (i < nvec) raw[u] = __ldcs(vin + i);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * 32;
      if (i >= nvec) break;
      float x[N];
      unpack<T>(raw[u], x);
      alignas(16) T o[N];
      const int c0 = pre + i * N;
#pragma unroll
      for (int j = 0; j < N; ++j)
        o[j] = from_f32<T>(g * (expf(x[j] - z) - (c0 + j == lab ? 1.f : 0.f)));
      __stcs(vout + i, *reinterpret_cast<const uint4*>(o));
    }
  }
  for (int c = pre + nvec * N + lane; c < V; c += 32)
    drow[c] = from_f32<T>(g * (expf(to_f32(row[c]) - z) - (c == lab ? 1.f : 0.f)));
}

bool bad_shape(int rows, int V) { return rows <= 0 || V <= 0; }

dim3 grid_of(int rows) { return dim3((rows + kWarps - 1) / kWarps); }

template <typename T>
cudaError_t launch_fwd(const void* logits, const void* labels, void* loss,
                       void* lse, int rows, int V, cudaStream_t stream) {
  fused_ce_fwd_kernel<T><<<grid_of(rows), kThreads, 0, stream>>>(
      static_cast<const T*>(logits), static_cast<const int*>(labels),
      static_cast<float*>(loss), static_cast<float*>(lse), rows, V);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* logits, const void* labels, const void* lse,
                       const void* ct, void* dlogits, int rows, int V,
                       cudaStream_t stream) {
  fused_ce_bwd_kernel<T><<<grid_of(rows), kThreads, 0, stream>>>(
      static_cast<const T*>(logits), static_cast<const int*>(labels),
      static_cast<const float*>(lse), static_cast<const float*>(ct),
      static_cast<T*>(dlogits), rows, V);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  logits (T, V) contiguous
// in that dtype, labels (T,) int32, loss and lse (T,) f32.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int fused_ce_fwd(const void* logits, const void* labels, void* loss,
                            void* lse, int T, int V, int dtype, void* stream) {
  if (bad_shape(T, V)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_fwd<float>(logits, labels, loss, lse, T, V, st);
  if (dtype == 1)
    return (int)launch_fwd<__nv_bfloat16>(logits, labels, loss, lse, T, V, st);
  if (dtype == 2)
    return (int)launch_fwd<__half>(logits, labels, loss, lse, T, V, st);
  return (int)cudaErrorInvalidValue;
}

// As above, plus lse and ct (T,) f32; dlogits (T, V) in the logits dtype.
extern "C" int fused_ce_bwd(const void* logits, const void* labels,
                            const void* lse, const void* ct, void* dlogits,
                            int T, int V, int dtype, void* stream) {
  if (bad_shape(T, V)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_bwd<float>(logits, labels, lse, ct, dlogits, T, V, st);
  if (dtype == 1)
    return (int)launch_bwd<__nv_bfloat16>(logits, labels, lse, ct, dlogits, T,
                                          V, st);
  if (dtype == 2)
    return (int)launch_bwd<__half>(logits, labels, lse, ct, dlogits, T, V, st);
  return (int)cudaErrorInvalidValue;
}
