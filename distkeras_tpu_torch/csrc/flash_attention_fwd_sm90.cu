// Flash-attention forward for Hopper (sm_90a) on the tensor cores: wgmma
// products on TMA-fed K/V tiles, for bf16 and f16 inputs.
//
// Replaces distkeras_tpu/ops/flash_attention.py :: _flash_kernel (:78, the
// Pallas TPU kernel launched by _flash_forward through pl.pallas_call at
// :159) in both of its forms, for 16-bit inputs whose head dim is a
// multiple of 8; f32 inputs, and any other head dim, take the SIMT kernel
// of flash_attention_fwd.cu (the wrapper's _forward_variant rule).  The C
// interface is that kernel's: the inference form (lse == nullptr) writes
// only the output; the training form also writes the f32 (B, H, S)
//     lse[b, h, p] = safe_m + log(l)   (safe_m = 0 for an all-masked row,
//                                       l == 0 taken as 1)
// that the backward kernels read as p = exp(s - lse).
//
// What it computes.  For every (batch, head, q row p):
//     out[p] = softmax(q[p] . k^T * scale + mask) . v
// causal (keys after p hidden) with an optional sliding window keeping
// keys in (p - window, p], on the BSHD layout: q and out (B, S, H, D), k and
// v (B, S, Hkv, D); query head h reads kv head h / (H / Hkv).  Ragged S is
// masked in the kernel.  The arithmetic keeps the TPU kernel's function to
// within one output rounding:
//   - S = q . k^T from the 16-bit operands with f32 accumulation (the
//     products of two 16-bit values are exact in f32); the scale is applied
//     to S in f32 afterwards, since scaling a 16-bit q would round it;
//   - the online softmax runs in f32 with the TPU kernel's guards (the row
//     maximum replaced by 0 while a row is all -inf, l == 0 taken as 1),
//     on scores scaled by c = scale * log2(e), so that each probability is
//     one exp2: p = exp2(s * c - m), m the running max of s * c (scaling
//     before the max and the masks keeps any sign of scale right);
//   - the TPU kernel keeps P in f32 for P.V.  A tensor-core P.V takes 16-bit
//     operands, and P rounded once to bf16 misses the reference by 16x-92x
//     its one-ulp tolerance, so P is split, hi = rn(P) and lo = rn(P - hi),
//     and O accumulates hi.V + lo.V in f32: P to 16 (bf16) or 22 (f16)
//     significant bits, inside the tolerance;
//   - lse = safe_m * ln(2) + log(l), in the natural log the backward reads.
//
// What bounds it on the H100 (SXM, 132 SMs, 1.98 GHz at most).  Per live
// (q, k) pair the function needs one exponential and 4 * D tensor-core
// flops; bytes are q, k, v and out once (at B 8, S 2048, H 8, Hkv 2, D 32:
// 21 MB, 6.3 us at 3.35 TB/s), never the limit.  The MUFU unit gives 16
// ex2 per clock per SM: 132 * 16 * 1.98e9 = 4.18e12 exponentials/s, against
// 989e12 / (4 * D) pairs/s on the tensor cores.  So at D = 32 the
// exponentials bound it (2.4e-13 s a pair against 1.3e-13); at D = 64 the
// two terms meet (2.4e-13 against 2.6e-13, 3.9e-13 with the hi/lo split's
// second P.V); from D = 128 the tensor cores do.  At the LM shape (causal,
// 134 M live pairs) the exponential term is 0.032 ms.
//
// What the design does about it.  One CTA of one warpgroup (128 threads)
// owns one (batch*head, 64-row q tile): one wgmma m64 tile.  Q is loaded
// once by TMA; K and V tiles of kBK keys stream through a 2-stage shared
// memory ring filled by TMA (thread 0 issues tile i+1 while tile i
// computes) and completed on mbarriers with expect-tx.  Tensor maps are
// rank 4 over the BSHD tensors, dims (D, H or Hkv, S, B), box (64-element
// chunk or D padded to 32, 1, rows, 1) under a 128- (or 64-) byte swizzle,
// so TMA's zero fill covers the padded head dim and the ragged S edge and a
// head's box never reads its neighbour's columns.  S = Q.K^T is a
// shared-memory wgmma (both operands K-major); the softmax runs on the f32
// accumulator registers, one exponential per live pair, row max over the 4
// threads that share a row (the row sum is kept per thread and reduced once
// at the end); masks are computed only on tiles that straddle the diagonal,
// the window edge or the ragged end; tiles in the causal future or wholly
// behind the window are never visited (the TPU's _live_kq).  P goes from
// the S accumulators straight into wgmma A-operand registers (the
// accumulator and A fragment layouts agree row for row), as hi and lo, and
// O += P.V is two register-A wgmmas per 16 keys against V in shared memory
// as an MN-major B operand (the transpose bit: V is D-contiguous), with no
// transposing copy.  The epilogue divides by l in f32 and stores the
// output dtype.  Blocks run heaviest causal q tile first.
//
// cuTensorMapEncodeTiled is reached through cudaGetDriverEntryPoint(ByVersion),
// so the library links against the CUDA runtime only (no -lcuda).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;    // q rows per CTA: one wgmma m64 tile
constexpr int kThreads = 128;  // one warpgroup
constexpr int kStages = 2;     // K/V ring depth
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Tiles for a head dim padded to DP (32, 64, 128 or 256).
template <int DP>
struct Cfg {
  static constexpr int kBK = DP <= 64 ? 128 : 64;   // keys per K/V tile
  static constexpr int kChunk = DP < 64 ? DP : 64;  // elements per smem row
  static constexpr int kChunks = DP / kChunk;
  static constexpr int kRowBytes = kChunk * 2;      // = the swizzle span
  static constexpr int kQBytes = kBlockQ * DP * 2;
  static constexpr int kTileBytes = kBK * DP * 2;   // one K or one V tile
  // 1024 bytes of slack to align the swizzled buffers
  static constexpr int kSmem = 1024 + kQBytes + kStages * 2 * kTileBytes;
};

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

// The wgmma instructions this kernel issues, m64nNk16 with f32 accumulators:
// wgmma_ss_<type>(d, desc_a, desc_b, accumulate) with both operands in
// shared memory, K-major (S = Q.K^T, N = the key tile), and
// wgmma_rs_<type>(d, a, desc_b) with A in registers and B MN-major (the
// transpose bit; O += P.V, N = the padded head dim).  Operand lists are
// spelled out because PTX takes every accumulator register by name.
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

// per input type: the wgmmas, and a pair of floats rounded to a packed
// 16-bit pair (lower column in the low half, as the A fragment wants it)
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
};

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

// Register layouts (per warp w of the warpgroup, lane = 4 * g + t): the
// m64nN f32 accumulator holds, for each 8-column group j, rows
// 16w + g and 16w + g + 8 at columns 8j + 2t and 8j + 2t + 1, in registers
// 4j + {0, 1} (row 16w + g) and 4j + {2, 3} (row 16w + g + 8).  The k16 A
// fragment of a register-A wgmma holds, in its four 32-bit registers, the
// pairs (row g, k 2t), (row g + 8, k 2t), (row g, k 2t + 8), (row g + 8,
// k 2t + 8): so S registers 8kk .. 8kk + 7, packed two by two, are the A
// fragment of keys 16kk .. 16kk + 15.
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          T* __restrict__ o, float* __restrict__ lse, int S,
                          int H, int Hkv, int D, float scale, int causal,
                          int window) {
  using C = Cfg<DP>;
  constexpr int BK = C::kBK;
  constexpr int NS = BK / 2;   // S accumulators per thread
  constexpr int NO = DP / 2;   // O accumulators per thread
  constexpr int KQ = DP / 16;  // k16 steps of Q.K^T
  constexpr int KP = BK / 16;  // k16 steps of P.V
  constexpr uint32_t kQChunkBytes = kBlockQ * C::kRowBytes;
  constexpr uint32_t kKVChunkBytes = BK * C::kRowBytes;

  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + kStages];  // Q, then the ring

  // swizzled tiles sit on 1024-byte boundaries (the 128-byte swizzle's
  // period): Q, then per stage K and V, each as [chunk][rows][kChunk]
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sKV = sQ + C::kQBytes;
  auto sK = [&](int st) { return sKV + st * 2 * C::kTileBytes; };
  auto sV = [&](int st) { return sKV + st * 2 * C::kTileBytes + C::kTileBytes; };
  const uint32_t bar_q = smem_u32(&bars[0]);
  auto bar_kv = [&](int st) { return smem_u32(&bars[1 + st]); };

  // heaviest causal q tile first, (batch*head) fastest
  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = qt * kBlockQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bool windowed = causal && window > 0;

  // the live key tiles (the TPU kernel's _live_kq)
  const int q_last = min(q0 + kBlockQ, S) - 1;
  int kt_end = (S + BK - 1) / BK;
  if (causal) kt_end = min(kt_end, q_last / BK + 1);
  int kt_begin = 0;
  if (windowed && q0 - window + 1 > 0) kt_begin = (q0 - window + 1) / BK;
  const int n_tiles = kt_end - kt_begin;

  auto load_kv = [&](int kt, int st) {
    mbar_expect_tx(bar_kv(st), 2 * C::kTileBytes);
#pragma unroll
    for (int c = 0; c < C::kChunks; ++c) {
      tma_load_4d(sK(st) + c * kKVChunkBytes, &tk, bar_kv(st), c * C::kChunk,
                  hk, kt * BK, b);
      tma_load_4d(sV(st) + c * kKVChunkBytes, &tv, bar_kv(st), c * C::kChunk,
                  hk, kt * BK, b);
    }
  };

  if (tid == 0) {
    mbar_init(bar_q, 1);
#pragma unroll
    for (int st = 0; st < kStages; ++st) mbar_init(bar_kv(st), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_q, C::kQBytes);
#pragma unroll
    for (int c = 0; c < C::kChunks; ++c)
      tma_load_4d(sQ + c * kQChunkBytes, &tq, bar_q, c * C::kChunk, h, q0, b);
    if (n_tiles > 0) load_kv(kt_begin, 0);
  }

  // this thread's two rows, and the softmax state of each
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = q0 + warp * 16 + g;  // and row0 + 8
  const float c2 = scale * kLog2e;
  float m[2] = {-INFINITY, -INFINITY};  // running max, log2 units
  float l[2] = {0.f, 0.f};              // this thread's share of the row sum
  float oacc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) oacc[i] = 0.f;

  mbar_wait(bar_q, 0);

  for (int i = 0; i < n_tiles; ++i) {
    const int kt = kt_begin + i, st = i % kStages;
    // stage (i+1) % 2 was freed by the barrier that closed iteration i - 1
    if (tid == 0 && i + 1 < n_tiles) load_kv(kt + 1, (i + 1) % kStages);
    mbar_wait(bar_kv(st), (i / kStages) & 1);

    // S = Q . K^T over the padded head dim, 16 columns a step; a step
    // inside a swizzled row advances the start address by 32 bytes
    float s[NS];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) {
      const uint32_t chunk = (kk * 16) / C::kChunk;
      const uint32_t off = ((kk * 16) % C::kChunk) * 2;
      const uint64_t da = make_desc(sQ + chunk * kQChunkBytes + off, 16,
                                    8 * C::kRowBytes, C::kRowBytes);
      const uint64_t db = make_desc(sK(st) + chunk * kKVChunkBytes + off, 16,
                                    8 * C::kRowBytes, C::kRowBytes);
      Ops<T>::ss(s, da, db, kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(s);
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j] *= c2;  // scaled, in log2 units

    // masks, only on tiles that straddle the diagonal, the window's edge
    // or the ragged end (TMA filled keys past S with zeros)
    const int k0 = kt * BK;
    const bool straddles =
        k0 + BK > S ||
        (causal && (k0 + BK - 1 > q0 ||
                    (windowed && k0 <= q0 + kBlockQ - 1 - window)));
    if (straddles) {
#pragma unroll
      for (int j = 0; j < NS / 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = row0 + (e >> 1) * 8;
          const int col = k0 + j * 8 + 2 * t4 + (e & 1);
          const bool hide =
              col >= S ||
              (causal && (col > row || (windowed && col <= row - window)));
          if (hide) s[j * 4 + e] = -INFINITY;
        }
    }

    // online softmax: tile row max over the quad of threads sharing a row
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NS / 4; ++j) {
      mt[0] = fmaxf(mt[0], fmaxf(s[4 * j], s[4 * j + 1]));
      mt[1] = fmaxf(mt[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    float mc[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
      const float new_m = fmaxf(m[r], mt[r]);
      const float safe = new_m == -INFINITY ? 0.f : new_m;
      mc[r] = safe;
      const float corr = ex2(m[r] - safe);
      m[r] = new_m;
      l[r] *= corr;
#pragma unroll
      for (int j = 0; j < NO / 4; ++j) {
        oacc[4 * j + 2 * r] *= corr;
        oacc[4 * j + 2 * r + 1] *= corr;
      }
    }
    // one exponential per pair; then P into A fragments as hi and lo
    uint32_t phi[KP][4], plo[KP][4];
#pragma unroll
    for (int kk = 0; kk < KP; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int idx = 8 * kk + 2 * q;
        const int r = q & 1;  // registers 2, 3 and 6, 7 are row g + 8
        const float p0 = ex2(s[idx] - mc[r]);
        const float p1 = ex2(s[idx + 1] - mc[r]);
        l[r] += p0 + p1;
        Ops<T>::split(p0, p1, phi[kk][q], plo[kk][q]);
      }

    // O += P_hi . V + P_lo . V, 16 keys a step (16 rows of the V tile)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KP; ++kk) {
      const uint64_t dv = make_desc(sV(st) + kk * 16 * C::kRowBytes,
                                    kKVChunkBytes, 8 * C::kRowBytes,
                                    C::kRowBytes);
      Ops<T>::rs(oacc, phi[kk], dv);
      Ops<T>::rs(oacc, plo[kk], dv);
    }
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(oacc);
    reg_fence(phi);
    reg_fence(plo);
    __syncthreads();  // every warp is done with stage st
  }

  // epilogue: the row sums over the quad, O / l in f32, the output dtype
  const size_t q_stride = (size_t)H * D;
  T* ob = o + ((size_t)b * S * H + h) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = row0 + 8 * r;
    if (row >= S) continue;
    const float denom = l[r] == 0.f ? 1.f : l[r];
#pragma unroll
    for (int j = 0; j < NO / 4; ++j) {
      const int col = j * 8 + 2 * t4;
      if (col < D)
        Ops<T>::store2(ob + (size_t)row * q_stride + col,
                       oacc[4 * j + 2 * r] / denom,
                       oacc[4 * j + 2 * r + 1] / denom);
    }
    if (lse != nullptr && t4 == 0) {
      const float safe_m = m[r] == -INFINITY ? 0.f : m[r];
      lse[(size_t)bh * S + row] = safe_m * kLn2 + logf(denom);
    }
  }
}

// ---------------------------------------------------------------------------
// host side: tensor maps and the launch
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
// first; a box is `chunk` head-dim elements of one head, `rows` positions
// of one batch.  Returns 0, or a negative code: -1 when
// cuTensorMapEncodeTiled is not found, -CUresult when it refuses the map.
template <int DP>
int make_map(CUtensorMap* map, const void* ptr, int dtype, int B, int S,
             int heads, int D, int rows) {
  using C = Cfg<DP>;
  const EncodeTiledFn encode = encode_fn();
  if (encode == nullptr) return -1;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)S * heads * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)C::kChunk, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map,
      dtype == 1 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
      4, const_cast<void*>(ptr), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      C::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                          : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -(int)r;
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int S, int H, int Hkv, int D, int dtype, float scale,
           int causal, int window, cudaStream_t stream) {
  using C = Cfg<DP>;
  CUtensorMap tq, tk, tv;
  int rc = make_map<DP>(&tq, q, dtype, B, S, H, D, kBlockQ);
  if (rc == 0) rc = make_map<DP>(&tk, k, dtype, B, S, Hkv, D, C::kBK);
  if (rc == 0) rc = make_map<DP>(&tv, v, dtype, B, S, Hkv, D, C::kBK);
  if (rc != 0) return rc;
  // set on every launch: the attribute belongs to the current device
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_sm90_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::kSmem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(B * H, (S + kBlockQ - 1) / kBlockQ);
  flash_fwd_sm90_kernel<T, DP><<<grid, kThreads, C::kSmem, stream>>>(
      tq, tk, tv, static_cast<T*>(o), lse, S, H, Hkv, D, scale, causal,
      window);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_dim(const void* q, const void* k, const void* v, void* o,
                 float* lse, int B, int S, int H, int Hkv, int D, int dtype,
                 float scale, int causal, int window, cudaStream_t stream) {
  if (D <= 32)
    return launch<T, 32>(q, k, v, o, lse, B, S, H, Hkv, D, dtype, scale,
                         causal, window, stream);
  if (D <= 64)
    return launch<T, 64>(q, k, v, o, lse, B, S, H, Hkv, D, dtype, scale,
                         causal, window, stream);
  if (D <= 128)
    return launch<T, 128>(q, k, v, o, lse, B, S, H, Hkv, D, dtype, scale,
                          causal, window, stream);
  return launch<T, 256>(q, k, v, o, lse, B, S, H, Hkv, D, dtype, scale,
                        causal, window, stream);
}

}  // namespace

// dtype: 1 = bfloat16, 2 = float16.  D a multiple of 8 (TMA's 16-byte
// stride rule), 8 <= D <= 256; q, k, v 16-byte aligned.  window <= 0 means
// no window.  lse: null for the inference form, else a (B, H, S) f32
// buffer that the training form fills.  Returns 0 on success, a
// cudaError_t of the launch, or a negative code if the TMA tensor maps
// could not be made (-1: cuTensorMapEncodeTiled not found; -CUresult: the
// map refused).
extern "C" int flash_attention_fwd_sm90(const void* q, const void* k,
                                        const void* v, void* o, void* lse,
                                        int B, int S, int H, int Hkv, int D,
                                        int dtype, float scale, int causal,
                                        int window, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || D < 8 ||
      D > 256 || D % 8 != 0 || (S + kBlockQ - 1) / kBlockQ > 65535 ||
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 1)
    return dispatch_dim<__nv_bfloat16>(q, k, v, o, l, B, S, H, Hkv, D, dtype,
                                       scale, causal, window, st);
  if (dtype == 2)
    return dispatch_dim<__half>(q, k, v, o, l, B, S, H, Hkv, D, dtype, scale,
                                causal, window, st);
  return (int)cudaErrorInvalidValue;
}
