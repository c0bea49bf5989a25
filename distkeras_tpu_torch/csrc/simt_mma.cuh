// Pieces shared by the port's "simt" flash-attention kernels,
// flash_attention_fwd.cu and flash_attention_bwd.cu, which despite the
// variant's name run their products on the TF32 tensor cores through
// mma.sync.m16n8k8 with f32 accumulators:
// - the block shape both use: 64 resident rows in four groups of 16 (the
//   MMA's m16), each group served by a pair of warps;
// - the mask of the forward (ragged edge, causal future, behind the window);
// - f32 operands split into TF32 hi + lo, the MMA step, and the fragment
//   loads from shared memory (the permuted k order of an accumulator read
//   back as an A operand);
// - cp.async staging of row tiles into shared memory, 16 bytes per copy
//   where every row starts on a 16-byte boundary, plain loads otherwise.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// A block owns 64 resident rows (q rows for the forward and dq, keys for
// dk/dv) in four groups of 16, the MMA's m16.  Each group is served by a
// pair of warps that split every streamed tile (keys for the forward and
// dq, q rows for dk/dv) between them and join their accumulators once at
// the end: twice the warps of one warp per group, on the same shared
// memory.
constexpr int kGroups = 4;
constexpr int kPairs = 2;
constexpr int kThreads = kGroups * kPairs * 32;
constexpr int kRows = kGroups * 16;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;
constexpr size_t kSmemPerSm = 227 * 1024;

// the row stride of a shared-memory tile in elements: 16 bytes of padding
template <typename T, int DP>
__host__ __device__ constexpr int row_stride() {
  return DP + 16 / (int)sizeof(T);
}

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

// the mask of the forward: ragged edge, causal future, behind the window
__device__ __forceinline__ bool hidden(int p, int kp, int S, int causal,
                                       int window) {
  bool hide = kp >= S || p >= S;
  if (causal) hide = hide || kp > p || (window > 0 && kp <= p - window);
  return hide;
}

// is every key of [k0, k0 + n) visible to every row of [r0, r0 + 16)?
__device__ __forceinline__ bool visible(int r0, int k0, int n, int S,
                                        int causal, int window) {
  if (k0 + n > S || r0 + 16 > S) return false;
  if (!causal) return true;
  return k0 + n - 1 <= r0 && (window <= 0 || k0 > r0 + 15 - window);
}

// ---------------------------------------------------------------------------
// TF32 tensor-core products with f32 operands split into hi + lo
// ---------------------------------------------------------------------------

// N values of an MMA fragment as TF32 bit patterns: hi, and for an f32
// operand (kSplit) lo = x - hi, which the MMA truncates to TF32
template <int N>
struct Frag {
  uint32_t hi[N], lo[N];
};

template <bool kSplit, int N>
__device__ __forceinline__ Frag<N> tf32_frag(const float (&x)[N]) {
  Frag<N> f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (kSplit) {
      asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(f.hi[i]) : "f"(x[i]));
      f.lo[i] = __float_as_uint(x[i] - __uint_as_float(f.hi[i]));
    } else {  // a bf16 or f16 value: exact in TF32
      f.hi[i] = __float_as_uint(x[i]);
      f.lo[i] = 0u;
    }
  }
  return f;
}

// d += a . b for one m16n8k8 step (A 16 x 8 row-major, B 8 x 8, f32
// accumulators)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a . b with the split operands: the small terms first, then hi . hi
template <bool kSplitA, bool kSplitB>
__device__ __forceinline__ void mma_split(float (&d)[4], const Frag<4>& a,
                                          const Frag<2>& b) {
  if (kSplitA) mma_tf32(d, a.lo, b.hi);
  if (kSplitB) mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

// two adjacent elements (c even) of a shared tile as f32, in one load
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load_pair(const __half* p) {
  return __half22float2(*reinterpret_cast<const __half2*>(p));
}

// The products over the head dim (q . k^T, dO . v^T and their transposes)
// read the 8 columns of a k step in a permuted order, k = t <-> column
// 2t and k = t + 4 <-> column 2t + 1 (the same for A and B, so the sum is
// unchanged), so that each lane's two values of a row are adjacent: one
// 8-byte (f32) or 4-byte (16-bit) load.  c = 8 * step + 2t.

// the A fragment of rows g and g + 8, columns c and c + 1 of a row-major
// shared tile
template <bool kSplit, typename T>
__device__ __forceinline__ Frag<4> load_a(const T* tile, int stride, int g,
                                          int c) {
  const float2 top = load_pair(tile + g * stride + c);
  const float2 bottom = load_pair(tile + (g + 8) * stride + c);
  const float x[4] = {top.x, bottom.x, top.y, bottom.y};
  return tf32_frag<kSplit>(x);
}

// the B fragment of an s-type product (x . tile^T): row g, columns c and
// c + 1 of the tile
template <bool kSplit, typename T>
__device__ __forceinline__ Frag<2> load_b_rows(const T* tile, int stride,
                                               int g, int c) {
  const float2 pair = load_pair(tile + g * stride + c);
  const float x[2] = {pair.x, pair.y};
  return tf32_frag<kSplit>(x);
}

// the B fragment of a product with a register operand (acc . tile): rows
// r and r + 1 (the permuted k order of the accumulator layout), column c
template <bool kSplit, typename T>
__device__ __forceinline__ Frag<2> load_b_cols(const T* tile, int stride,
                                               int r, int c) {
  const float x[2] = {to_f32(tile[r * stride + c]),
                      to_f32(tile[(r + 1) * stride + c])};
  return tf32_frag<kSplit>(x);
}

// an accumulator tile (row g, columns 2t, 2t + 1; row g + 8, the same) as
// the A operand of the next product, with the step's k order permuted
// (k = t <-> column 2t, k = t + 4 <-> column 2t + 1), split into hi + lo
__device__ __forceinline__ Frag<4> acc_as_a(const float (&c)[4]) {
  const float x[4] = {c[0], c[2], c[1], c[3]};
  return tf32_frag<true>(x);
}

// ---------------------------------------------------------------------------
// staging
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [r0, r0 + R) and columns [0, DP) of a (S, ld) row-major view into a
// shared tile of row stride row_stride<T, DP>(): the columns below w and
// rows below S copied, the rest zero.  vec: 16-byte cp.async copies (every
// row starts on a 16-byte boundary and w is a multiple of 16 bytes), else
// plain loads and stores
template <typename T, int R, int DP>
__device__ __forceinline__ void stage(T* dst, const T* src, size_t ld, int r0,
                                      int S, int w, bool vec, int tid) {
  constexpr int SD = row_stride<T, DP>();
  if (vec) {
    constexpr int V = 16 / (int)sizeof(T);
    constexpr int per_row = DP / V;
    for (int i = tid; i < R * per_row; i += kThreads) {
      const int r = i / per_row, c = (i % per_row) * V;
      const bool in = r0 + r < S && c < w;
      cp_async16(dst + r * SD + c, in ? src + (size_t)(r0 + r) * ld + c : src,
                 in ? 16 : 0);
    }
  } else {
    for (int i = tid; i < R * DP; i += kThreads) {
      const int r = i / DP, c = i % DP;
      dst[r * SD + c] = r0 + r < S && c < w ? src[(size_t)(r0 + r) * ld + c]
                                            : from_f32<T>(0.f);
    }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace
