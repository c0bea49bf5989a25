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
// The PTX wrappers, the wgmma instructions and the tensor maps are in
// sm90_common.cuh, shared with the backward's flash_attention_bwd_sm90.cu.

#include "sm90_common.cuh"

#include <math.h>

namespace {

constexpr int kBlockQ = 64;    // q rows per CTA: one wgmma m64 tile
constexpr int kThreads = 128;  // one warpgroup
constexpr int kStages = 2;     // K/V ring depth

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
    mbar_init_fence();
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
// host side: the launch
// ---------------------------------------------------------------------------

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int S, int H, int Hkv, int D, int dtype, float scale,
           int causal, int window, cudaStream_t stream) {
  using C = Cfg<DP>;
  CUtensorMap tq, tk, tv;
  int rc = make_map(&tq, q, dtype, B, S, H, D, C::kChunk, kBlockQ);
  if (rc == 0) rc = make_map(&tk, k, dtype, B, S, Hkv, D, C::kChunk, C::kBK);
  if (rc == 0) rc = make_map(&tv, v, dtype, B, S, Hkv, D, C::kChunk, C::kBK);
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
