// Flash-attention backward for Hopper (sm_90a) on the tensor cores: the dq
// kernel and the dk/dv kernel, wgmma products on TMA-fed tiles, for bf16
// and f16 inputs.
//
// Replaces distkeras_tpu/ops/flash_attention.py :: _dq_kernel (:182,
// pallas_call :275) and _dkv_kernel (:221, pallas_call :294), the Pallas TPU
// kernels launched by _flash_backward from the custom_vjp's _bwd, for
// 16-bit inputs whose head dim is a multiple of 8 and at most 128; f32
// inputs, and any other head dim, take the SIMT kernels of
// flash_attention_bwd.cu (the wrapper's _backward_variant rule).  The C
// interface is theirs.
//
// What they compute.  Both recompute the probabilities from the forward's
// saved per-row logsumexp, so nothing of size S * S is stored.  With
// s = q . k^T * scale (masked), p = exp(s - lse), Delta = rowsum(dO o O)
// over O as stored, dp = dO . v^T and ds = p o (dp - Delta) * scale:
//     dq = ds . k              (one per query head)
//     dk = ds^T . q,  dv = p^T . dO
// where dk and dv of kv head hk sum over the G = H / Hkv query heads that
// read it, in f32, rounded once.  Layouts as the SIMT kernels: q, O, dO,
// dq (B, S, H, D); k, v, dk, dv (B, S, Hkv, D); lse and Delta f32 (B, H, S).
// The arithmetic keeps the TPU kernels' function to within their
// tolerance:
//   - s and dp are wgmma products of the 16-bit operands with f32
//     accumulation (products of two 16-bit values are exact in f32); the
//     scale is applied to s in f32 afterwards, folded with log2(e) so that
//     p = exp2(s * c - lse * log2(e)), c = scale * log2(e), one exponential
//     per pair;
//   - p and ds are f32, as in the TPU kernels.  Each of the three products
//     they enter (p^T . dO, ds . k, ds^T . q) takes 16-bit operands on the
//     tensor cores, and rounding p or ds once to 16 bits misses the TPU
//     kernels' result by 4.4-17x (bf16) and up to 2.0x (f16) the tolerance
//     chip_smoke.py holds them to (tests/test_torch_flash_bwd_sm90.py models
//     it), so each is split, hi = rn(x) and lo = rn(x - hi), and issued as
//     two wgmmas: x to 16 (bf16) or 22 (f16) significant bits.
//
// What bounds them on the H100 (SXM, 132 SMs, 1.98 GHz at most).  Per live
// (q, k) pair each kernel takes one exponential (p is recomputed in both)
// and 4 * D tensor-core flops per product: dq three (q.k, dO.v, ds.k, the
// second doubled by the split: 16 * D), dk/dv four (q.k, dO.v, and p^T.dO
// and ds^T.q doubled: 24 * D).  MUFU gives 16 ex2 per clock per SM
// (4.18e12/s); at D = 32 the exponentials bound both (0.032 ms each at the
// LM shape, 134 M live pairs); at D = 64 the tensor-core term of the
// function (6 * D and 8 * D flops a pair) meets them.  Bytes (q, k, v, O,
// dO, the gradients, lse and Delta once) are never the limit.
//
// What the design does about it.  One CTA of one warpgroup (128 threads)
// per 64-row output tile: a wgmma m64 tile.
// - dq: per (batch*head, 64-row q tile), heaviest causal tile first.  Q and
//   dO are loaded once by TMA; while they land, the threads compute Delta of
//   their rows from O and dO as stored (16-byte loads, a sum over the 4
//   threads of a row) and write it out for the dk/dv kernel, which runs
//   after this one on the same stream.  K and V tiles of 64 keys stream
//   through a 2-stage ring filled by TMA.  Per tile: S = Q.K^T and
//   dP = dO.V^T are shared-memory wgmmas (both operands K-major); p and ds
//   are computed on the accumulator registers; dQ += dS.K is a register-A
//   wgmma with dS straight from the accumulators (the accumulator and A
//   fragment layouts agree row for row) against K as an MN-major B operand
//   (the transpose bit: K is D-contiguous), as hi and lo.
// - dk/dv: per (batch*kv head, 64-key tile), heaviest causal tile first.  K
//   and V are loaded once; Q and dO tiles of 64 rows stream through the
//   ring over the G query heads and their live q tiles (the ring's parity
//   runs on across heads).  The products run transposed, so that each is a
//   form the dq kernel issues too: S^T = K.Q^T and dP^T = V.dO^T
//   (shared-memory, K-major), P^T and dS^T on the accumulator registers,
//   dV += P^T.dO and dK += dS^T.Q register-A with dO and Q as MN-major B
//   operands.  lse and Delta index columns here: each tile's 64 of each are
//   staged in shared memory by the 128 threads, one value each, a tile
//   ahead.  Nothing is atomic: the sums over heads stay in registers and
//   the result is deterministic.
// - Both: tiles outside the TPU's _live_kq (the causal future, or behind
//   the window) are never visited; masks are computed only on tiles that
//   straddle the diagonal, the window's edge or the ragged end.  Rank-4
//   tensor maps (D, heads, S, B) zero-fill the padded head dim and rows
//   past S.  This first version waits on each wgmma group.
//
// The PTX wrappers, the wgmma instructions and the tensor maps are in
// sm90_common.cuh, shared with the forward's flash_attention_fwd_sm90.cu.

#include "sm90_common.cuh"

#include <math.h>

namespace {

constexpr int kBlock = 64;     // rows of every tile: one wgmma m64 tile
constexpr int kThreads = 128;  // one warpgroup
constexpr int kStages = 2;     // ring depth
constexpr int kMaxHeadDim = 128;

// Tiles of 64 rows for a head dim padded to DP (32, 64 or 128), each as
// [chunk][64 rows][kChunk] under a 64- (DP 32) or 128-byte swizzle.
template <int DP>
struct Cfg {
  static constexpr int kChunk = DP < 64 ? DP : 64;  // elements per smem row
  static constexpr int kChunks = DP / kChunk;
  static constexpr int kRowBytes = kChunk * 2;      // = the swizzle span
  static constexpr int kChunkBytes = kBlock * kRowBytes;
  static constexpr int kTileBytes = kBlock * DP * 2;
  // two resident tiles, two streamed tiles per stage, and 1024 bytes of
  // slack to align the swizzled buffers
  static constexpr int kSmem = 1024 + (2 + 2 * kStages) * kTileBytes;
};

// one 64-row tile of a BSHD tensor (head `head`, rows from `row0`)
template <int DP>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int head, int row0,
                                          int b) {
  using C = Cfg<DP>;
#pragma unroll
  for (int c = 0; c < C::kChunks; ++c)
    tma_load_4d(dst + c * C::kChunkBytes, map, bar, c * C::kChunk, head, row0,
                b);
}

// descriptor of a tile as a K-major operand (its rows along M or N, the
// head dim along K) at k16 step kk; a step inside a swizzled row advances
// the start address by 32 bytes
template <int DP>
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int kk) {
  using C = Cfg<DP>;
  const uint32_t chunk = (kk * 16) / C::kChunk;
  const uint32_t off = ((kk * 16) % C::kChunk) * 2;
  return make_desc(tile + chunk * C::kChunkBytes + off, 16, 8 * C::kRowBytes,
                   C::kRowBytes);
}

// descriptor of a tile as an MN-major B operand (its rows along K, the head
// dim along N) at k16 step kk: rows 16kk .. 16kk + 15
template <int DP>
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int kk) {
  using C = Cfg<DP>;
  return make_desc(tile + kk * 16 * C::kRowBytes, C::kChunkBytes,
                   8 * C::kRowBytes, C::kRowBytes);
}

// Register layouts (per warp w of the warpgroup, lane = 4 * g + t): the
// m64nN f32 accumulator holds, for each 8-column group j, rows 16w + g and
// 16w + g + 8 at columns 8j + 2t and 8j + 2t + 1, in registers 4j + {0, 1}
// (row 16w + g) and 4j + {2, 3} (row 16w + g + 8).  The k16 A fragment of a
// register-A wgmma holds, in its four 32-bit registers, the pairs (row g,
// k 2t), (row g + 8, k 2t), (row g, k 2t + 8), (row g + 8, k 2t + 8): so
// accumulator registers 8kk .. 8kk + 7, packed two by two, are the A
// fragment of columns 16kk .. 16kk + 15.  Register pair 8kk + 2u (u = 0..3)
// is row 16w + g + 8 * (u & 1), columns 16kk + 8 * (u >> 1) + 2t + {0, 1}.

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const __grid_constant__ CUtensorMap tdo,
                             const T* __restrict__ o,
                             const T* __restrict__ dout,
                             const float* __restrict__ lse,
                             float* __restrict__ delta, T* __restrict__ dq,
                             int S, int H, int Hkv, int D, float scale,
                             int causal, int window) {
  using C = Cfg<DP>;
  constexpr int NS = kBlock / 2;  // S and dP accumulators per thread
  constexpr int NQ = DP / 2;      // dQ accumulators per thread
  constexpr int KD = DP / 16;     // k16 steps over the head dim
  constexpr int KK = kBlock / 16; // k16 steps over a key tile

  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + kStages];  // Q/dO, then the ring

  // Q, dO, then per stage K and V, on 1024-byte boundaries
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sDO = sQ + C::kTileBytes;
  auto sK = [&](int st) { return sQ + (2 + 2 * st) * C::kTileBytes; };
  auto sV = [&](int st) { return sQ + (3 + 2 * st) * C::kTileBytes; };
  const uint32_t bar_q = smem_u32(&bars[0]);
  auto bar_kv = [&](int st) { return smem_u32(&bars[1 + st]); };

  // heaviest causal q tile first, (batch*head) fastest
  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = qt * kBlock;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bool windowed = causal && window > 0;

  // the live key tiles (the TPU kernel's _live_kq)
  const int q_last = min(q0 + kBlock, S) - 1;
  int kt_end = (S + kBlock - 1) / kBlock;
  if (causal) kt_end = min(kt_end, q_last / kBlock + 1);
  int kt_begin = 0;
  if (windowed && q0 - window + 1 > 0) kt_begin = (q0 - window + 1) / kBlock;
  const int n_tiles = kt_end - kt_begin;

  auto load_kv = [&](int kt, int st) {
    mbar_expect_tx(bar_kv(st), 2 * C::kTileBytes);
    load_tile<DP>(sK(st), &tk, bar_kv(st), hk, kt * kBlock, b);
    load_tile<DP>(sV(st), &tv, bar_kv(st), hk, kt * kBlock, b);
  };

  if (tid == 0) {
    mbar_init(bar_q, 1);
#pragma unroll
    for (int st = 0; st < kStages; ++st) mbar_init(bar_kv(st), 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_q, 2 * C::kTileBytes);
    load_tile<DP>(sQ, &tq, bar_q, h, q0, b);
    load_tile<DP>(sDO, &tdo, bar_q, h, q0, b);
    if (n_tiles > 0) load_kv(kt_begin, 0);
  }

  // this thread's two rows: lse in log2 units, and Delta = rowsum(dO o O)
  // from O and dO as stored (each of the row's 4 threads reads 8-element
  // pieces, then the 4 sum), written out for the dk/dv kernel
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = q0 + warp * 16 + g;  // and row0 + 8
  const size_t q_stride = (size_t)H * D;
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    float acc = 0.f;
    if (row < S) {
      const size_t off = ((size_t)b * S + row) * q_stride + (size_t)h * D;
      for (int c = 8 * t4; c < D; c += 32) {
        const uint4 ov = *reinterpret_cast<const uint4*>(o + off + c);
        const uint4 gv = *reinterpret_cast<const uint4*>(dout + off + c);
        const uint32_t ow[4] = {ov.x, ov.y, ov.z, ov.w};
        const uint32_t gw[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 of = Ops<T>::load2(ow[e]);
          const float2 gf = Ops<T>::load2(gw[e]);
          acc = fmaf(gf.x, of.x, acc);
          acc = fmaf(gf.y, of.y, acc);
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    dlt[r] = acc;
    lse2[r] = row < S ? lse[(size_t)bh * S + row] * kLog2e : 0.f;
    if (row < S && t4 == 0) delta[(size_t)bh * S + row] = acc;
  }

  const float c2 = scale * kLog2e;
  float dqa[NQ];
#pragma unroll
  for (int i = 0; i < NQ; ++i) dqa[i] = 0.f;

  mbar_wait(bar_q, 0);

  for (int i = 0; i < n_tiles; ++i) {
    const int kt = kt_begin + i, st = i % kStages;
    // stage (i+1) % 2 was freed by the barrier that closed iteration i - 1
    if (tid == 0 && i + 1 < n_tiles) load_kv(kt + 1, (i + 1) % kStages);
    mbar_wait(bar_kv(st), (i / kStages) & 1);

    // S = Q . K^T and dP = dO . V^T over the padded head dim
    float s[NS], dp[NS];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
      Ops<T>::ss(s, desc_kmajor<DP>(sQ, kk), desc_kmajor<DP>(sK(st), kk),
                 kk > 0);
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
      Ops<T>::ss(dp, desc_kmajor<DP>(sDO, kk), desc_kmajor<DP>(sV(st), kk),
                 kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(s);
    reg_fence(dp);

    // p = exp2(s * c - lse * log2 e), masked only on tiles that straddle
    // the diagonal, the window's edge or the ragged end; ds = p o (dp -
    // Delta) * scale; ds into A fragments as hi and lo
    const int k0 = kt * kBlock;
    const bool straddles =
        k0 + kBlock > S ||
        (causal && (k0 + kBlock - 1 > q0 ||
                    (windowed && k0 <= q0 + kBlock - 1 - window)));
    uint32_t dhi[KK][4], dlo[KK][4];
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int idx = 8 * kk + 2 * u;
        const int r = u & 1;
        float ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float p = ex2(fmaf(s[idx + e], c2, -lse2[r]));
          if (straddles) {
            const int row = row0 + 8 * r;
            const int col = k0 + 16 * kk + 8 * (u >> 1) + 2 * t4 + e;
            if (col >= S ||
                (causal && (col > row || (windowed && col <= row - window))))
              p = 0.f;
          }
          ds[e] = p * (dp[idx + e] - dlt[r]) * scale;
        }
        Ops<T>::split(ds[0], ds[1], dhi[kk][u], dlo[kk][u]);
      }

    // dQ += dS_hi . K + dS_lo . K, 16 keys a step
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      const uint64_t kdesc = desc_mnmajor<DP>(sK(st), kk);
      Ops<T>::rs(dqa, dhi[kk], kdesc);
      Ops<T>::rs(dqa, dlo[kk], kdesc);
    }
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(dqa);
    reg_fence(dhi);
    reg_fence(dlo);
    __syncthreads();  // every warp is done with stage st
  }

  T* dqb = dq + (size_t)h * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < NQ / 4; ++j) {
      const int col = j * 8 + 2 * t4;
      if (col < D)
        Ops<T>::store2(dqb + ((size_t)b * S + row) * q_stride + col,
                       dqa[4 * j + 2 * r], dqa[4 * j + 2 * r + 1]);
    }
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tdo,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              T* __restrict__ dk, T* __restrict__ dv, int S,
                              int H, int Hkv, int D, float scale, int causal,
                              int window) {
  using C = Cfg<DP>;
  constexpr int NS = kBlock / 2;  // S^T and dP^T accumulators per thread
  constexpr int NK = DP / 2;      // dK and dV accumulators per thread
  constexpr int KD = DP / 16;     // k16 steps over the head dim
  constexpr int KK = kBlock / 16; // k16 steps over a q tile

  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + kStages];  // K/V, then the ring
  // per stage, lse * log2(e) and Delta of the tile's 64 q rows
  __shared__ __align__(16) float stats[kStages][2][kBlock];

  // K, V, then per stage Q and dO, on 1024-byte boundaries
  const uint32_t sK = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sV = sK + C::kTileBytes;
  auto sQ = [&](int st) { return sK + (2 + 2 * st) * C::kTileBytes; };
  auto sDO = [&](int st) { return sK + (3 + 2 * st) * C::kTileBytes; };
  const uint32_t bar_k = smem_u32(&bars[0]);
  auto bar_q = [&](int st) { return smem_u32(&bars[1 + st]); };

  // batch*kv head fastest; under causal masking the earliest key tiles see
  // the most q tiles, so the heaviest blocks come first
  const int bhk = blockIdx.x;
  const int b = bhk / Hkv, hk = bhk % Hkv;
  const int G = H / Hkv;
  const int k0 = blockIdx.y * kBlock;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bool windowed = causal && window > 0;

  // live q tiles (_live_kq seen from the key side): causal starts at the
  // tile holding this block's first key; a window ends at the tile holding
  // the last row that can still see this block's last key
  const int nqt = (S + kBlock - 1) / kBlock;
  const int qt_begin = causal ? k0 / kBlock : 0;
  int qt_end = nqt;
  if (windowed) qt_end = min(nqt, (k0 + kBlock - 2 + window) / kBlock + 1);
  const int nq = qt_end - qt_begin;
  const int n_tiles = G * nq;  // over the G query heads, q tiles fastest

  // tile i: query head h and first row q0
  auto tile_head = [&](int i) { return hk * G + i / nq; };
  auto tile_q0 = [&](int i) { return (qt_begin + i % nq) * kBlock; };
  auto load_q = [&](int i, int st) {
    mbar_expect_tx(bar_q(st), 2 * C::kTileBytes);
    load_tile<DP>(sQ(st), &tq, bar_q(st), tile_head(i), tile_q0(i), b);
    load_tile<DP>(sDO(st), &tdo, bar_q(st), tile_head(i), tile_q0(i), b);
  };
  // thread tid stages lse (tid < 64) or Delta (tid >= 64) of one q row
  const int s_which = tid / kBlock, s_col = tid % kBlock;
  auto stat = [&](int i) {
    const int q = tile_q0(i) + s_col;
    if (q >= S) return 0.f;
    const size_t at = ((size_t)b * H + tile_head(i)) * S + q;
    return s_which ? delta[at] : lse[at] * kLog2e;
  };

  if (tid == 0) {
    mbar_init(bar_k, 1);
#pragma unroll
    for (int st = 0; st < kStages; ++st) mbar_init(bar_q(st), 1);
    mbar_init_fence();
  }
  stats[0][s_which][s_col] = stat(0);
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_k, 2 * C::kTileBytes);
    load_tile<DP>(sK, &tk, bar_k, hk, k0, b);
    load_tile<DP>(sV, &tv, bar_k, hk, k0, b);
    load_q(0, 0);
  }

  const int g = lane >> 2, t4 = lane & 3;
  const int key0 = k0 + warp * 16 + g;  // this thread's keys: key0, key0 + 8
  const float c2 = scale * kLog2e;
  float dka[NK], dva[NK];
#pragma unroll
  for (int i = 0; i < NK; ++i) dka[i] = dva[i] = 0.f;

  mbar_wait(bar_k, 0);

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % kStages;
    const int q0 = tile_q0(i);
    // stage (i+1) % 2 was freed by the barrier that closed iteration i - 1;
    // the next tile's lse or Delta is read now and stored at the end
    if (tid == 0 && i + 1 < n_tiles) load_q(i + 1, (i + 1) % kStages);
    const float next_stat = i + 1 < n_tiles ? stat(i + 1) : 0.f;
    mbar_wait(bar_q(st), (i / kStages) & 1);

    // S^T = K . Q^T and dP^T = V . dO^T over the padded head dim
    float s[NS], dp[NS];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
      Ops<T>::ss(s, desc_kmajor<DP>(sK, kk), desc_kmajor<DP>(sQ(st), kk),
                 kk > 0);
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
      Ops<T>::ss(dp, desc_kmajor<DP>(sV, kk), desc_kmajor<DP>(sDO(st), kk),
                 kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(s);
    reg_fence(dp);

    // p and ds per (key row, q column), as in the dq kernel with the masks
    // flipped: key j sees q row i when i >= j (and j > i - window)
    const bool straddles =
        q0 + kBlock > S ||
        (causal && (k0 + kBlock - 1 > q0 ||
                    (windowed && k0 <= q0 + kBlock - 1 - window)));
    uint32_t phi[KK][4], plo[KK][4], dhi[KK][4], dlo[KK][4];
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int idx = 8 * kk + 2 * u;
        const int r = u & 1;
        const int lc = 16 * kk + 8 * (u >> 1) + 2 * t4;  // local column
        const float2 l2 = *reinterpret_cast<const float2*>(&stats[st][0][lc]);
        const float2 d2 = *reinterpret_cast<const float2*>(&stats[st][1][lc]);
        const float lsec[2] = {l2.x, l2.y}, dltc[2] = {d2.x, d2.y};
        float p[2], ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          p[e] = ex2(fmaf(s[idx + e], c2, -lsec[e]));
          if (straddles) {
            const int key = key0 + 8 * r;
            const int col = q0 + lc + e;
            if (col >= S ||
                (causal && (key > col || (windowed && key <= col - window))))
              p[e] = 0.f;
          }
          ds[e] = p[e] * (dp[idx + e] - dltc[e]) * scale;
        }
        Ops<T>::split(p[0], p[1], phi[kk][u], plo[kk][u]);
        Ops<T>::split(ds[0], ds[1], dhi[kk][u], dlo[kk][u]);
      }

    // dV += P^T_hi . dO + P^T_lo . dO and dK += dS^T_hi . Q + dS^T_lo . Q,
    // 16 q rows a step
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      const uint64_t dodesc = desc_mnmajor<DP>(sDO(st), kk);
      Ops<T>::rs(dva, phi[kk], dodesc);
      Ops<T>::rs(dva, plo[kk], dodesc);
    }
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      const uint64_t qdesc = desc_mnmajor<DP>(sQ(st), kk);
      Ops<T>::rs(dka, dhi[kk], qdesc);
      Ops<T>::rs(dka, dlo[kk], qdesc);
    }
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(dva);
    reg_fence(dka);
    reg_fence(phi);
    reg_fence(plo);
    reg_fence(dhi);
    reg_fence(dlo);
    // stats[(i+1) % 2] was last read in iteration i - 1
    if (i + 1 < n_tiles) stats[(i + 1) % kStages][s_which][s_col] = next_stat;
    __syncthreads();  // every warp is done with stage st
  }

  const size_t kv_stride = (size_t)Hkv * D;
  T* dkb = dk + (size_t)hk * D;
  T* dvb = dv + (size_t)hk * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= S) continue;
    const size_t off = ((size_t)b * S + key) * kv_stride;
#pragma unroll
    for (int j = 0; j < NK / 4; ++j) {
      const int col = j * 8 + 2 * t4;
      if (col < D) {
        Ops<T>::store2(dkb + off + col, dka[4 * j + 2 * r],
                       dka[4 * j + 2 * r + 1]);
        Ops<T>::store2(dvb + off + col, dva[4 * j + 2 * r],
                       dva[4 * j + 2 * r + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side: tensor maps and the launches
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  int B, S, H, Hkv, D, dtype;
  float scale;
  int causal, window;
  cudaStream_t stream;
};

// which: 0 = the dq kernel, 1 = the dk/dv kernel
template <typename T, int DP>
int launch(int which, const Args& a) {
  using C = Cfg<DP>;
  CUtensorMap tq, tk, tv, tdo;
  int rc = make_map(&tq, a.q, a.dtype, a.B, a.S, a.H, a.D, C::kChunk, kBlock);
  if (rc == 0)
    rc = make_map(&tk, a.k, a.dtype, a.B, a.S, a.Hkv, a.D, C::kChunk, kBlock);
  if (rc == 0)
    rc = make_map(&tv, a.v, a.dtype, a.B, a.S, a.Hkv, a.D, C::kChunk, kBlock);
  if (rc == 0)
    rc = make_map(&tdo, a.dout, a.dtype, a.B, a.S, a.H, a.D, C::kChunk,
                  kBlock);
  if (rc != 0) return rc;
  const int tiles = (a.S + kBlock - 1) / kBlock;
  // the attribute is set on every launch: it belongs to the current device
  if (which == 0) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dq_sm90_kernel<T, DP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (e != cudaSuccess) return (int)e;
    flash_bwd_dq_sm90_kernel<T, DP>
        <<<dim3(a.B * a.H, tiles), kThreads, C::kSmem, a.stream>>>(
            tq, tk, tv, tdo, static_cast<const T*>(a.o),
            static_cast<const T*>(a.dout), a.lse, a.delta,
            static_cast<T*>(a.dq), a.S, a.H, a.Hkv, a.D, a.scale, a.causal,
            a.window);
  } else {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dkv_sm90_kernel<T, DP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (e != cudaSuccess) return (int)e;
    flash_bwd_dkv_sm90_kernel<T, DP>
        <<<dim3(a.B * a.Hkv, tiles), kThreads, C::kSmem, a.stream>>>(
            tq, tk, tv, tdo, a.lse, a.delta, static_cast<T*>(a.dk),
            static_cast<T*>(a.dv), a.S, a.H, a.Hkv, a.D, a.scale, a.causal,
            a.window);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_dim(int which, const Args& a) {
  if (a.D <= 32) return launch<T, 32>(which, a);
  if (a.D <= 64) return launch<T, 64>(which, a);
  return launch<T, 128>(which, a);
}

int dispatch(int which, const Args& a) {
  const uintptr_t ptrs =
      reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
      reinterpret_cast<uintptr_t>(a.v) | reinterpret_cast<uintptr_t>(a.o) |
      reinterpret_cast<uintptr_t>(a.dout);
  if (a.B <= 0 || a.S <= 0 || a.H <= 0 || a.Hkv <= 0 || a.H % a.Hkv != 0 ||
      a.D < 8 || a.D > kMaxHeadDim || a.D % 8 != 0 ||
      (a.S + kBlock - 1) / kBlock > 65535 || ptrs % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (a.dtype == 1) return dispatch_dim<__nv_bfloat16>(which, a);
  if (a.dtype == 2) return dispatch_dim<__half>(which, a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 1 = bfloat16, 2 = float16.  D a multiple of 8 (TMA's 16-byte
// stride rule), 8 <= D <= 128; q, k, v, o and dout 16-byte aligned.
// window <= 0 means no window.  lse (from the forward's training form) and
// delta are f32 (B, H, S); the dq kernel writes delta, the dk/dv kernel
// reads it, so the dq kernel runs first on the same stream.  Each returns 0
// on success, a cudaError_t of the launch, or a negative code if the TMA
// tensor maps could not be made (-1: cuTensorMapEncodeTiled not found;
// -CUresult: the map refused).
extern "C" int flash_attention_bwd_dq_sm90(const void* q, const void* k,
                                           const void* v, const void* o,
                                           const void* dout, const void* lse,
                                           void* delta, void* dq, int B,
                                           int S, int H, int Hkv, int D,
                                           int dtype, float scale, int causal,
                                           int window, void* stream) {
  const Args a{q, k, v, o, dout, static_cast<const float*>(lse),
               static_cast<float*>(delta), dq, nullptr, nullptr, B, S, H,
               Hkv, D, dtype, scale, causal, window,
               static_cast<cudaStream_t>(stream)};
  return dispatch(0, a);
}

extern "C" int flash_attention_bwd_dkv_sm90(const void* q, const void* k,
                                            const void* v, const void* dout,
                                            const void* lse,
                                            const void* delta, void* dk,
                                            void* dv, int B, int S, int H,
                                            int Hkv, int D, int dtype,
                                            float scale, int causal,
                                            int window, void* stream) {
  const Args a{q, k, v, nullptr, dout, static_cast<const float*>(lse),
               const_cast<float*>(static_cast<const float*>(delta)), nullptr,
               dk, dv, B, S, H, Hkv, D, dtype, scale, causal, window,
               static_cast<cudaStream_t>(stream)};
  return dispatch(1, a);
}
