// Pieces shared by the port's Hopper (sm_90a) tensor-core kernels,
// flash_attention_fwd_sm90.cu and flash_attention_bwd_sm90.cu: the PTX
// wrappers for mbarriers, TMA and wgmma, the wgmma shared-memory matrix
// descriptor, the m64nNk16 wgmma instructions with f32 accumulators, the
// per-type operations (a pair of f32 values split into 16-bit hi and lo),
// and the rank-4 TMA tensor maps over BSHD tensors.
//
// cuTensorMapEncodeTiled is reached through cudaGetDriverEntryPoint(ByVersion),
// so a library that includes this links against the CUDA runtime only (no
// -lcuda).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

// makes the barriers' initialisation visible to the TMA unit
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// waits for the phase with this parity to complete; a wait that has not
// completed after ~2^34 cycles (~9 s) traps, so that a fault in the
// transaction counts ends the launch with an error instead of hanging it
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long start = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1ll << 34)) asm volatile("trap;\n");
  }
}

// one TMA box of a rank-4 tensor map into shared memory, completing on bar
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving reads or reuses of registers that an
// in-flight wgmma writes or reads across the commit/wait
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle mode (1: 128 B, 2: 64 B)
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, int row_bytes) {
  const uint64_t mode = row_bytes == 128 ? 1 : 2;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (mode << 62);
}

// The wgmma instructions the kernels issue, m64nNk16 with f32 accumulators:
// wgmma_ss_<type>(d, desc_a, desc_b, accumulate) with both operands in
// shared memory, K-major (a product over the head dim, N = a tile's rows),
// and wgmma_rs_<type>(d, a, desc_b) with A in registers and B MN-major (the
// transpose bit: a product over a tile's rows, N = the padded head dim).
// Operand lists are spelled out because PTX takes every accumulator
// register by name.
#define WG_N0 "%0, %1, %2, %3, %4, %5, %6, %7"
#define WG_N1 "%8, %9, %10, %11, %12, %13, %14, %15"
#define WG_N2 "%16, %17, %18, %19, %20, %21, %22, %23"
#define WG_N3 "%24, %25, %26, %27, %28, %29, %30, %31"
#define WG_N4 "%32, %33, %34, %35, %36, %37, %38, %39"
#define WG_N5 "%40, %41, %42, %43, %44, %45, %46, %47"
#define WG_N6 "%48, %49, %50, %51, %52, %53, %54, %55"
#define WG_N7 "%56, %57, %58, %59, %60, %61, %62, %63"
#define WG_N8 "%64, %65, %66, %67, %68, %69, %70, %71"
#define WG_N9 "%72, %73, %74, %75, %76, %77, %78, %79"
#define WG_N10 "%80, %81, %82, %83, %84, %85, %86, %87"
#define WG_N11 "%88, %89, %90, %91, %92, %93, %94, %95"
#define WG_N12 "%96, %97, %98, %99, %100, %101, %102, %103"
#define WG_N13 "%104, %105, %106, %107, %108, %109, %110, %111"
#define WG_N14 "%112, %113, %114, %115, %116, %117, %118, %119"
#define WG_N15 "%120, %121, %122, %123, %124, %125, %126, %127"
#define WG_D16 WG_N0 ", " WG_N1
#define WG_D32 WG_D16 ", " WG_N2 ", " WG_N3
#define WG_D64 WG_D32 ", " WG_N4 ", " WG_N5 ", " WG_N6 ", " WG_N7
#define WG_D128 \
  WG_D64 ", " WG_N8 ", " WG_N9 ", " WG_N10 ", " WG_N11 ", " WG_N12 ", " \
      WG_N13 ", " WG_N14 ", " WG_N15

#define WG_F8(i)                                                         \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_F16(i) WG_F8(i), WG_F8(i + 8)
#define WG_F32(i) WG_F16(i), WG_F16(i + 16)
#define WG_F64(i) WG_F32(i), WG_F32(i + 32)
#define WG_F128(i) WG_F64(i), WG_F64(i + 64)

// NR accumulators per thread for N = 2 * NR columns; DA, DB, SC: the
// operand numbers of the two descriptors and the accumulate flag
#define WG_SS(TY, NR, N, DA, DB, SC)                                        \
  __device__ __forceinline__ void wgmma_ss_##TY(                           \
      float(&d)[NR], uint64_t desc_a, uint64_t desc_b, int accumulate) {  \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #SC ", 0;\n"         \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." #TY     \
                 "." #TY " {" WG_D##NR "}, %" #DA ", %" #DB                \
                 ", p, 1, 1, 0, 0;\n}\n"                                    \
                 : WG_F##NR(0)                                              \
                 : "l"(desc_a), "l"(desc_b), "r"(accumulate));              \
  }
// A0-A3: the operand numbers of the four A registers; DB, SC as above
#define WG_RS(TY, NR, N, A0, A1, A2, A3, DB, SC)                            \
  __device__ __forceinline__ void wgmma_rs_##TY(                           \
      float(&d)[NR], const uint32_t(&a)[4], uint64_t desc_b) {             \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #SC ", 0;\n"         \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." #TY     \
                 "." #TY " {" WG_D##NR "}, {%" #A0 ", %" #A1 ", %" #A2     \
                 ", %" #A3 "}, %" #DB ", p, 1, 1, 1;\n}\n"                 \
                 : WG_F##NR(0)                                              \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]),              \
                   "l"(desc_b), "r"(1));                                    \
  }

WG_SS(bf16, 32, 64, 32, 33, 34)
WG_SS(bf16, 64, 128, 64, 65, 66)
WG_SS(f16, 32, 64, 32, 33, 34)
WG_SS(f16, 64, 128, 64, 65, 66)
WG_RS(bf16, 16, 32, 16, 17, 18, 19, 20, 21)
WG_RS(bf16, 32, 64, 32, 33, 34, 35, 36, 37)
WG_RS(bf16, 64, 128, 64, 65, 66, 67, 68, 69)
WG_RS(bf16, 128, 256, 128, 129, 130, 131, 132, 133)
WG_RS(f16, 16, 32, 16, 17, 18, 19, 20, 21)
WG_RS(f16, 32, 64, 32, 33, 34, 35, 36, 37)
WG_RS(f16, 64, 128, 64, 65, 66, 67, 68, 69)
WG_RS(f16, 128, 256, 128, 129, 130, 131, 132, 133)

// per input type: the wgmmas; a pair of floats rounded to a packed 16-bit
// pair (lower column in the low half, as the A fragment wants it), split
// into hi and lo, or stored; and a packed pair read back as floats
template <typename T>
struct Ops;
template <>
struct Ops<__nv_bfloat16> {
  template <int NR>
  static __device__ __forceinline__ void ss(float (&d)[NR], uint64_t a,
                                            uint64_t b, int acc) {
    wgmma_ss_bf16(d, a, b, acc);
  }
  template <int NR>
  static __device__ __forceinline__ void rs(float (&d)[NR],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    wgmma_rs_bf16(d, a, b);
  }
  // hi = rn(x, y), lo = rn(x - hi.x, y - hi.y)
  static __device__ __forceinline__ void split(float x, float y, uint32_t& hi,
                                               uint32_t& lo) {
    __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    __nv_bfloat162 l =
        __floats2bfloat162_rn(x - __low2float(h), y - __high2float(h));
    hi = *reinterpret_cast<uint32_t*>(&h);
    lo = *reinterpret_cast<uint32_t*>(&l);
  }
  static __device__ __forceinline__ void store2(__nv_bfloat16* p, float x,
                                                float y) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
  }
  static __device__ __forceinline__ float2 load2(uint32_t w) {
    return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w));
  }
};
template <>
struct Ops<__half> {
  template <int NR>
  static __device__ __forceinline__ void ss(float (&d)[NR], uint64_t a,
                                            uint64_t b, int acc) {
    wgmma_ss_f16(d, a, b, acc);
  }
  template <int NR>
  static __device__ __forceinline__ void rs(float (&d)[NR],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    wgmma_rs_f16(d, a, b);
  }
  static __device__ __forceinline__ void split(float x, float y, uint32_t& hi,
                                               uint32_t& lo) {
    __half2 h = __floats2half2_rn(x, y);
    __half2 l = __floats2half2_rn(x - __low2float(h), y - __high2float(h));
    hi = *reinterpret_cast<uint32_t*>(&h);
    lo = *reinterpret_cast<uint32_t*>(&l);
  }
  static __device__ __forceinline__ void store2(__half* p, float x, float y) {
    *reinterpret_cast<__half2*>(p) = __floats2half2_rn(x, y);
  }
  static __device__ __forceinline__ float2 load2(uint32_t w) {
    return __half22float2(*reinterpret_cast<__half2*>(&w));
  }
};

// ---------------------------------------------------------------------------
// host side: tensor maps
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A rank-4 map over a (B, S, heads, D) 16-bit tensor, dims innermost
// first; a box is `chunk` head-dim elements (32 or 64: a 64- or 128-byte
// swizzled row) of one head, `rows` positions of one batch.  Returns 0, or
// a negative code: -1 when cuTensorMapEncodeTiled is not found, -CUresult
// when it refuses the map.
int make_map(CUtensorMap* map, const void* ptr, int dtype, int B, int S,
             int heads, int D, int chunk, int rows) {
  const EncodeTiledFn encode = encode_fn();
  if (encode == nullptr) return -1;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)S * heads * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)chunk, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map,
      dtype == 1 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
      4, const_cast<void*>(ptr), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      chunk * 2 == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                       : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -(int)r;
}

}  // namespace
