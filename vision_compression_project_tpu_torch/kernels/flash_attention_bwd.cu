// Blockwise flash attention backward for Hopper (sm_90a), plain CUDA C++.
//
// Replaces the backward of the JAX package's custom_vjp around K1,
// vision_compression_project_tpu/ops/attention.py::_flash_core.core_bwd (XLA:
// the weights recomputed in f32, 256 query rows at a time). For
//   O = softmax(scale * Q K^T + mask) V
// and the output gradient dO it computes dQ, dK and dV with the same masks
// as the forward (kernels/flash_attention.cu): key k < min(kv_len[b], Sk),
// optional causal k <= q, GQA through kv head h / (H / Hkv). It starts from
// the forward's row log-sum-exp, lse = log sum_valid exp(scale * s), so the
// weights are P = exp(scale * s - lse) with no running max; a row with no
// valid key has lse = +inf, so its P, and its gradients, are 0, as its
// forward output is. The gradients come back in the input type.
//
// Bound on this card: 10 * D operations per query-key pair that the masks
// leave (S = Q K^T and dP = dO V^T, dV += P^T dO, dK += dS^T Q, dQ += dS K)
// at the tensor cores' bf16 rate, or the bytes (q, k, v, o, dO read once,
// dq, dk, dv written once) at the memory's rate, whichever is longer. Long
// sequences (ocr_real's global encoder and decoder, the pipeline's
// microbatch) are bound by the operations; the 256-token windows and
// prod_train's calls by the bytes.
//
// Three launches (FlashAttention-2's backward, with dQ split off):
//
// * pass 0: Delta = rowsum(dO * O) in f32 into the caller's scratch; dS = P
//   (dP - Delta) needs it for every query row. A row is a few lanes of a
//   warp reading 16 bytes each. The bf16 route pads each (batch, head) to
//   Sp rows, Sq rounded up to 128, and writes lse log2(e) beside Delta: rows
//   past Sq get Delta 0 and lse +inf, so their P and dS are 0 without a
//   mask, and every tile's 64 rows are one aligned bulk copy.
// * pass 1 (dK, dV): a work item is 128 keys of one (batch, kv head); it
//   loops over the H / Hkv query heads that share them and over 64-row
//   query tiles, from the tile that holds the item's diagonal (causal) to
//   Sq. dK and dV accumulate in f32 registers and are written once, dK times
//   scale: GQA is folded inside the item, with no per-head copies or
//   atomics. An item at or past kv_len writes zeros and does nothing else.
// * pass 2 (dQ): a work item is 128 query rows of one (batch, head); it
//   loops over 64-key tiles up to its key end, min(kv_len, diagonal); dQ
//   accumulates in f32 registers and is written once.
//
// dQ stays a pass of its own to keep every gradient deterministic: each
// output element is summed by one thread in one fixed order, so the same
// inputs give bit-identical dq, dk and dv on every run. The price is Q K^T
// and dO V^T computed in both passes (14 * D operations per pair against
// 10 * D with dQ added by atomics from pass 1).
//
// Two routes, chosen by dtype:
//
// * bf16 (the training path): warp-specialised, persistent blocks of three
//   warpgroups, one block per SM, each taking work items in rounds that
//   alternate in direction (causal grids list the longest items first:
//   pass 1's first key blocks, pass 2's last query blocks; otherwise the
//   items of one (batch, head) sit side by side and share their operands in
//   L2). The producer warpgroup gives up registers (setmaxnreg.dec to 40)
//   and one of its threads issues every load: TMA copies of a 4-D tensor
//   map (D, S, H, B) over each strided input, 64 rows x 32 columns a box in
//   64-byte swizzle (the layout wgmma reads; rows past S arrive as zeros),
//   and bulk copies of lse and Delta rows, completing on mbarriers. Two
//   consumer warpgroups (setmaxnreg.inc to 232) own 64 keys (pass 1) or 64
//   query rows (pass 2) each and do every product with wgmma m64nNk16, bf16
//   in, f32 accumulators in registers. An item's fixed operands (K and V in
//   pass 1, Q and dO in pass 2) arrive in one of two pairs of slots, so that
//   the next item's are loaded while this one runs; the streamed ones (Q and dO tiles
//   with their lse and Delta rows in pass 1, K and V tiles in pass 2) pass
//   through a ring of 3 slots, each with a full and an empty barrier, both
//   consumer warpgroups reading the same tile.
//   Pass 1: S^T = K Q^T and dP^T = V dO^T (keys as M, Q and dO as K-major
//   B); P^T = 2^(S^T scale log2(e) - lse log2(e)) and dS^T = P^T (dP^T -
//   Delta) stay in registers and enter dV += P^T dO and dK += dS^T Q as
//   wgmma RS A operands: the accumulator's layout is the A fragment's, as
//   FlashAttention-3 does for P V; dO and Q are MN-major B (transpose bit).
//   Pass 2: S = Q K^T and dP = dO V^T, dQ += dS K (RS, K MN-major). The
//   last product of a tile runs on while the next tile's S and dP are
//   issued (pass 1 at D <= 96; pass 2 always). P and dS enter their
//   products as single bf16 terms; every product accumulates in f32. Only a
//   tile that straddles kv_len or the diagonal is masked element by
//   element; a warpgroup skips a tile that holds none of its pairs.
// * f32 (the f32 checks only): scalar kernels, one thread per key (pass 1,
//   K and V in dynamic shared memory, opted in above 48 KB at D = 96 and
//   128; dK and dV in registers) or per query row (pass 2). At D = 96 and 128
//   a thread's rows outgrow the registers and spill to local memory (the
//   -Xptxas -v report says how much); only f32 checks take this route. f32
//   tensor-core math (TF32) would not hold the f32 limit.
//
// Layouts: q, o and dO (B, H, Sq, D), k and v (B, Hkv, Sk, D), dq, dk and dv
// likewise, each given by element strides for batch, head and sequence with
// the last dimension contiguous; the bf16 route needs the input strides to be
// multiples of 8 and the bases 16-byte aligned (TMA, and pass 0's 16-byte
// loads), and every output stride even. lse is contiguous (B, H, Sq) f32.
// The tensor maps are encoded on the host for each call with the driver's
// cuTensorMapEncodeTiled, found through the runtime (no -lcuda), and passed
// as __grid_constant__ kernel parameters. The Hopper helpers (mbarriers, TMA,
// wgmma, the tensor-map encoder) are hopper.cuh's, shared with the forward.

#include <algorithm>
#include <cmath>

#include "hopper.cuh"

namespace {

// ----------------------------------------------------------- pass 0: Delta

constexpr int DELTA_THREADS = 256;

// Lanes a row takes in pass 0: its 16-byte pieces, rounded up to a power of two.
template <typename T, int D>
__host__ __device__ constexpr int delta_lanes() {
  return D * static_cast<int>(sizeof(T)) / 16 <= 4    ? 4
         : D * static_cast<int>(sizeof(T)) / 16 <= 8  ? 8
         : D * static_cast<int>(sizeof(T)) / 16 <= 16 ? 16
                                                      : 32;
}

__device__ __forceinline__ float dot16(uint4 a, uint4 b, float) {
  return __uint_as_float(a.x) * __uint_as_float(b.x) + __uint_as_float(a.y) * __uint_as_float(b.y) +
         __uint_as_float(a.z) * __uint_as_float(b.z) + __uint_as_float(a.w) * __uint_as_float(b.w);
}

__device__ __forceinline__ float dot16(uint4 a, uint4 b, bf16) {
  const auto* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const auto* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(x[i]), v = __bfloat1622float2(y[i]);
    acc += u.x * v.x + u.y * v.y;
  }
  return acc;
}

// Row r of (B, H, Sp), Sp >= Sq: Delta = rowsum(dO * O), 0 past Sq. With
// lse2, also lse * log2(e) there, +inf past Sq (the bf16 route's padded
// rows, whose P is then 0). A row is LANES lanes of a warp, each reading
// 16-byte pieces of O and dO (aligned: flash_layout_ok).
template <typename T, int D>
__global__ void __launch_bounds__(DELTA_THREADS) delta_kernel(
    const T* __restrict__ o, const T* __restrict__ g, const float* __restrict__ lse, float* __restrict__ delta,
    float* __restrict__ lse2, int H, int Sq, int Sp, long long rows, Strides os, Strides gs) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  constexpr int PIECES = D / VEC;
  constexpr int LANES = delta_lanes<T, D>();
  static_assert(PIECES <= LANES && LANES <= 32, "a row is at most a warp");
  const long long r = (static_cast<long long>(blockIdx.x) * DELTA_THREADS + threadIdx.x) / LANES;
  const int part = threadIdx.x % LANES;
  const bool row_ok = r < rows;
  const int s = row_ok ? static_cast<int>(r % Sp) : Sq;
  const long long bh = r / Sp;
  float acc = 0.f;
  if (s < Sq && part < PIECES) {
    const int h = static_cast<int>(bh % H);
    const int b = static_cast<int>(bh / H);
    const uint4 ov = *reinterpret_cast<const uint4*>(o + b * os.b + h * os.h + s * os.s + part * VEC);
    const uint4 gv = *reinterpret_cast<const uint4*>(g + b * gs.b + h * gs.h + s * gs.s + part * VEC);
    acc = dot16(ov, gv, T());
  }
#pragma unroll
  for (int w = LANES / 2; w > 0; w >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, w);
  if (row_ok && part == 0) {
    delta[r] = acc;
    if (lse2) lse2[r] = s < Sq ? lse[bh * Sq + s] * LOG2E : INFINITY;
  }
}

// ---------------------------------------------------------------- f32 route

constexpr int SC_BK = 64;  // pass 1: keys per block, one thread per key
constexpr int SC_BQ = 16;  // pass 1: query rows staged at a time
constexpr int SC_BM = 64;  // pass 2: query rows per block, one thread per row
constexpr int SC_BN = 32;  // pass 2: keys staged at a time

// Pass 1's shared memory (dynamic): K and V tiles of SC_BK rows of D + 1
// floats (+ 1: a thread's own row, no bank conflicts), Q and dO tiles of
// SC_BQ rows of D, then SC_BQ lse and SC_BQ Delta.
template <int D>
constexpr int dkdv_scalar_smem_bytes() {
  return static_cast<int>(sizeof(float)) * (2 * SC_BK * (D + 1) + 2 * SC_BQ * D + 2 * SC_BQ);
}

template <int D>
__global__ void __launch_bounds__(SC_BK) dkdv_scalar_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ g, const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ kv_len, float* __restrict__ dk, float* __restrict__ dv,
    int H, int Hkv, int Sq, int Sk, float scale, int causal,
    Strides qs, Strides ks, Strides vs, Strides gs, Strides dks, Strides dvs) {
  extern __shared__ __align__(16) float sc_smem[];
  float(*ksm)[D + 1] = reinterpret_cast<float(*)[D + 1]>(sc_smem);
  float(*vsm)[D + 1] = reinterpret_cast<float(*)[D + 1]>(sc_smem + SC_BK * (D + 1));
  float(*qsm)[D] = reinterpret_cast<float(*)[D]>(sc_smem + 2 * SC_BK * (D + 1));
  float(*gsm)[D] = reinterpret_cast<float(*)[D]>(sc_smem + 2 * SC_BK * (D + 1) + SC_BQ * D);
  float* lsm = sc_smem + 2 * SC_BK * (D + 1) + 2 * SC_BQ * D;
  float* dsm = lsm + SC_BQ;

  const int b = blockIdx.x / Hkv;
  const int hk = blockIdx.x % Hkv;
  const int group = H / Hkv;
  const int k0 = blockIdx.y * SC_BK;
  const int key = k0 + threadIdx.x;
  const int len = kv_len ? max(0, min(kv_len[b], Sk)) : Sk;

  const float* kp = k + b * ks.b + hk * ks.h;
  const float* vp = v + b * vs.b + hk * vs.h;
  for (int i = threadIdx.x; i < SC_BK * D; i += SC_BK) {
    const int r = i / D, c = i % D;
    const bool ok = k0 + r < Sk;
    ksm[r][c] = ok ? kp[(k0 + r) * ks.s + c] : 0.f;
    vsm[r][c] = ok ? vp[(k0 + r) * vs.s + c] : 0.f;
  }

  float dka[D], dva[D];
#pragma unroll
  for (int d = 0; d < D; ++d) dka[d] = dva[d] = 0.f;
  const bool live = key < len;

  if (k0 < len) {
    const int qstart = causal ? k0 : 0;
    for (int j = 0; j < group; ++j) {
      const int hq = hk * group + j;
      const float* qp = q + b * qs.b + hq * qs.h;
      const float* gp = g + b * gs.b + hq * gs.h;
      const long long base = (static_cast<long long>(b) * H + hq) * Sq;
      for (int r0 = qstart; r0 < Sq; r0 += SC_BQ) {
        __syncthreads();  // the previous rows are no longer read (and K/V are in)
        for (int i = threadIdx.x; i < SC_BQ * D; i += SC_BK) {
          const int r = i / D, c = i % D;
          const bool ok = r0 + r < Sq;
          qsm[r][c] = ok ? qp[(r0 + r) * qs.s + c] : 0.f;
          gsm[r][c] = ok ? gp[(r0 + r) * gs.s + c] : 0.f;
        }
        if (threadIdx.x < SC_BQ) {
          const int row = r0 + threadIdx.x;
          lsm[threadIdx.x] = row < Sq ? lse[base + row] : INFINITY;
          dsm[threadIdx.x] = row < Sq ? delta[base + row] : 0.f;
        }
        __syncthreads();
        if (!live) continue;
        for (int r = 0; r < SC_BQ; ++r) {
          const int row = r0 + r;
          if (row >= Sq || (causal && key > row)) continue;
          float s = 0.f, dp = 0.f;
#pragma unroll
          for (int d = 0; d < D; ++d) {
            s += ksm[threadIdx.x][d] * qsm[r][d];
            dp += vsm[threadIdx.x][d] * gsm[r][d];
          }
          const float p = expf(s * scale - lsm[r]);
          const float ds = p * (dp - dsm[r]);
#pragma unroll
          for (int d = 0; d < D; ++d) {
            dva[d] += p * gsm[r][d];
            dka[d] += ds * qsm[r][d];
          }
        }
      }
    }
  }

  if (key < Sk) {
    float* dkr = dk + b * dks.b + hk * dks.h + key * dks.s;
    float* dvr = dv + b * dvs.b + hk * dvs.h + key * dvs.s;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      dkr[d] = dka[d] * scale;
      dvr[d] = dva[d];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(SC_BM) dq_scalar_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ g, const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ kv_len, float* __restrict__ dq,
    int H, int Hkv, int Sq, int Sk, float scale, int causal,
    Strides qs, Strides ks, Strides vs, Strides gs, Strides dqs) {
  __shared__ float ksm[SC_BN][D];
  __shared__ float vsm[SC_BN][D];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * SC_BM;
  const int row = q0 + threadIdx.x;
  const int hk = h / (H / Hkv);
  const int len = kv_len ? max(0, min(kv_len[b], Sk)) : Sk;
  const int kend = causal ? min(len, q0 + SC_BM) : len;

  const float* kp = k + b * ks.b + hk * ks.h;
  const float* vp = v + b * vs.b + hk * vs.h;
  const bool live = row < Sq;
  const long long idx = (static_cast<long long>(b) * H + h) * Sq + row;
  const float lse_r = live ? lse[idx] : INFINITY;
  const float delta_r = live ? delta[idx] : 0.f;
  float qr[D], gr[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = live ? q[b * qs.b + h * qs.h + row * qs.s + d] : 0.f;
    gr[d] = live ? g[b * gs.b + h * gs.h + row * gs.s + d] : 0.f;
    acc[d] = 0.f;
  }

  for (int t0 = 0; t0 < kend; t0 += SC_BN) {
    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < SC_BN * D; i += SC_BM) {
      const int r = i / D, c = i % D;
      const bool in = t0 + r < kend;
      ksm[r][c] = in ? kp[(t0 + r) * ks.s + c] : 0.f;
      vsm[r][c] = in ? vp[(t0 + r) * vs.s + c] : 0.f;
    }
    __syncthreads();
    const int tn = min(SC_BN, kend - t0);
    for (int j = 0; j < tn; ++j) {
      if (causal && t0 + j > row) break;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        s += qr[d] * ksm[j][d];
        dp += gr[d] * vsm[j][d];
      }
      const float ds = expf(s * scale - lse_r) * (dp - delta_r);
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] += ds * ksm[j][d];
    }
  }

  if (live) {
    float* out = dq + b * dqs.b + h * dqs.h + row * dqs.s;
#pragma unroll
    for (int d = 0; d < D; ++d) out[d] = acc[d] * scale;
  }
}

// -------------------------------------------------------------- bf16 route

constexpr int KB = 128;               // pass 1: keys per work item
constexpr int BQ = 64;                // pass 1: query rows per tile
constexpr int QB = 128;               // pass 2: query rows per work item
constexpr int KT = 64;                // pass 2: keys per tile
constexpr int KV_STAGES = 2;          // pairs of slots for the fixed operands
constexpr int STAGES = 3;             // slots of the ring of streamed tiles (227 KB hold 3 at D = 128)

// The bf16 route's rows of lse and Delta per (batch, head): Sq rounded up
// to a whole pass-2 block.
__host__ __device__ constexpr int padded_rows(int Sq) { return (Sq + QB - 1) / QB * QB; }

template <int D>
struct DkdvSmem {  // byte offsets from a 1024-aligned base
  static constexpr int KV = 2 * tile_bytes<KB, D>();            // one K and V pair
  static constexpr int K = 0;                                   // KV_STAGES x (K, V), each KB x D
  static constexpr int Q = K + KV_STAGES * KV;                  // STAGES x BQ x D
  static constexpr int G = Q + STAGES * tile_bytes<BQ, D>();
  static constexpr int LSE = G + STAGES * tile_bytes<BQ, D>();  // STAGES x BQ f32
  static constexpr int DELTA = LSE + STAGES * BQ * 4;
  static constexpr int BAR = DELTA + STAGES * BQ * 4;           // kv_full, kv_empty, full, empty
  static constexpr int BYTES = BAR + 16 * (KV_STAGES + STAGES) + 1024;  // + the alignment of the base
};

template <int D>
struct DqSmem {
  static constexpr int QG = 2 * tile_bytes<QB, D>();            // one Q and dO pair
  static constexpr int Q = 0;                                   // KV_STAGES x (Q, dO), each QB x D
  static constexpr int K = Q + KV_STAGES * QG;                  // STAGES x KT x D
  static constexpr int V = K + STAGES * tile_bytes<KT, D>();
  static constexpr int BAR = V + STAGES * tile_bytes<KT, D>();  // qg_full, qg_empty, full, empty
  static constexpr int BYTES = BAR + 16 * (KV_STAGES + STAGES) + 1024;
};

// Pass 1's work item w of nbh x nkb (batch, kv head) x key block. Causal:
// key block w / nbh, the first (the longest) first. Otherwise w / nkb's
// key blocks side by side, so that blocks running at once share its Q and
// dO in L2.
struct DkdvItem {
  int b, hk, k0, len, qb0, nqb;
  __device__ __forceinline__ DkdvItem(int w, int nbh, int nkb, int Hkv, int Sq, int Sk, int causal,
                                      const int* kv_len) {
    const int bh = causal ? w % nbh : w / nkb;
    b = bh / Hkv;
    hk = bh % Hkv;
    k0 = (causal ? w / nbh : w % nkb) * KB;
    len = kv_len ? max(0, min(kv_len[b], Sk)) : Sk;
    qb0 = causal ? k0 / BQ : 0;  // the first query tile that sees a key of this block
    nqb = k0 < len ? max(0, (Sq + BQ - 1) / BQ - qb0) : 0;
  }
};

// Pass 1: persistent blocks, one per SM, each taking one work item a round
// (snake); the producer loads the next item's K and V into the other pair
// of slots while the consumers finish the current one.
template <int D>
__global__ void __launch_bounds__(THREADS, 1) dkdv_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tg,
    const float* __restrict__ lse2, const float* __restrict__ delta, const int* __restrict__ kv_len,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int B, int H, int Hkv, int Sq, int Sp, int Sk, float scale,
    float scale_log2, int causal, Strides dks, Strides dvs) {
  using L = DkdvSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const unsigned char* sm = smem_raw + (base - smem_u32(smem_raw));  // base as a pointer
  const uint32_t kv_full = base + L::BAR;
  const uint32_t kv_empty = kv_full + 8 * KV_STAGES;
  const uint32_t full = kv_empty + 8 * KV_STAGES;
  const uint32_t empty = full + 8 * STAGES;

  const int group = H / Hkv;
  const int nbh = B * Hkv;
  const int nkb = (Sk + KB - 1) / KB;
  const int nwork = nbh * nkb;

  if (threadIdx.x == 0) {
    for (int s = 0; s < KV_STAGES; ++s) {
      mbar_init(kv_full + 8 * s, 1);
      mbar_init(kv_empty + 8 * s, CONSUMER_WARPS);
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMER_WARPS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {  // the producer
    regs_dec<PRODUCER_REGS>();
    if (threadIdx.x != CONSUMERS) return;
    Ring kv, ring;
    for (int r = 0, w = snake(0); w < nwork; w = snake(++r)) {
      const DkdvItem it(w, nbh, nkb, Hkv, Sq, Sk, causal, kv_len);
      if (it.nqb == 0) continue;
      mbar_wait(kv_empty + 8 * kv.slot, kv.phase ^ 1);
      const uint32_t kvb = base + L::K + kv.slot * L::KV;
      mbar_expect_tx(kv_full + 8 * kv.slot, L::KV);
      load_tile<KB, D>(&tk, kvb, kv_full + 8 * kv.slot, it.k0, it.hk, it.b);
      load_tile<KB, D>(&tv, kvb + tile_bytes<KB, D>(), kv_full + 8 * kv.slot, it.k0, it.hk, it.b);
      kv.next<KV_STAGES>();
      // The tiles: each query head of the group, from query tile qb0 to Sq.
      for (int hq = it.hk * group; hq < (it.hk + 1) * group; ++hq) {
        const long long rows = (static_cast<long long>(it.b) * H + hq) * Sp;  // the head's padded rows
        for (int r0 = it.qb0 * BQ; r0 < Sq; r0 += BQ) {
          mbar_wait(empty + 8 * ring.slot, ring.phase ^ 1);
          const uint32_t bar = full + 8 * ring.slot;
          mbar_expect_tx(bar, 2 * tile_bytes<BQ, D>() + 2 * BQ * 4);
          load_tile<BQ, D>(&tq, base + L::Q + ring.slot * tile_bytes<BQ, D>(), bar, r0, hq, it.b);
          load_tile<BQ, D>(&tg, base + L::G + ring.slot * tile_bytes<BQ, D>(), bar, r0, hq, it.b);
          bulk_copy(base + L::LSE + ring.slot * BQ * 4, lse2 + rows + r0, BQ * 4, bar);
          bulk_copy(base + L::DELTA + ring.slot * BQ * 4, delta + rows + r0, BQ * 4, bar);
          ring.next<STAGES>();
        }
      }
    }
    return;
  }

  // Two consumer warpgroups, 64 keys each.
  regs_inc<CONSUMER_REGS>();
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int col0 = (lane & 3) * 2;  // this thread's columns in each 8-wide block: col0, col0 + 1
  Ring kv, ring;
  for (int r = 0, w = snake(0); w < nwork; w = snake(++r)) {
    const DkdvItem it(w, nbh, nkb, Hkv, Sq, Sk, causal, kv_len);
    const int kw = it.k0 + wg * 64;                   // the warpgroup's first key
    const int key0 = kw + warp * 16 + (lane >> 2);    // this thread's keys: key0, key0 + 8
    float dka[D / 2], dva[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;

    if (it.nqb > 0) {
      const uint32_t kb = base + L::K + kv.slot * L::KV;
      const uint32_t vb = kb + tile_bytes<KB, D>();
      mbar_wait(kv_full + 8 * kv.slot, kv.phase);
      const bool live = kw < it.len;
      // At D <= 96 a tile's dK and dV products run on while the next tile's
      // S^T and dP^T are issued, as in pass 2; at D = 128 the registers hold
      // only one tile's fragments, and each tile waits for its own.
      constexpr bool OVERLAP = D <= 96;
      uint32_t pa[BQ / 16][4] = {}, da[BQ / 16][4] = {};  // P^T and dS^T as bf16 A fragments
      int pending = -1;
      for (int head = 0; head < group; ++head) {
        for (int r0 = it.qb0 * BQ; r0 < Sq; r0 += BQ) {
          mbar_wait(full + 8 * ring.slot, ring.phase);
          if (live && !(causal && kw > r0 + BQ - 1)) {
            const uint32_t qt = base + L::Q + ring.slot * tile_bytes<BQ, D>();
            const uint32_t gt = base + L::G + ring.slot * tile_bytes<BQ, D>();
            const uint64_t qd = make_desc(qt, 16, 512);
            const uint64_t gd = make_desc(gt, 16, 512);

            // S^T = K Q^T and dP^T = V dO^T: 64 keys x BQ queries.
            float s[BQ / 2], dp[BQ / 2];
            const uint64_t kd = opaque(make_desc(kb + wg * 64 * 64, 16, 512));
            const uint64_t vd = opaque(make_desc(vb + wg * 64 * 64, 16, 512));
            wgmma_fence();
            wgmma_ss_init(s, kd, qd);
#pragma unroll
            for (int kk = 1; kk < D / 16; ++kk) wgmma_ss(s, kd + k_step<KB>(kk), qd + k_step<BQ>(kk));
            wgmma_ss_init(dp, vd, gd);
#pragma unroll
            for (int kk = 1; kk < D / 16; ++kk) wgmma_ss(dp, vd + k_step<KB>(kk), gd + k_step<BQ>(kk));
            wgmma_commit();
            wgmma_wait_all();
            keep(s);
            keep(dp);
            keep(pa);  // the previous tile's product has read them
            keep(da);
            if (pending >= 0) release(empty, pending, lane);

            // P^T = 2^(scale log2(e) s - lse log2(e)), dS^T = P^T (dP^T - Delta);
            // keys past kv_len and (causal) keys right of the row are masked,
            // in a tile that straddles either. Rows past Sq have lse = +inf.
            const float* lse_t = reinterpret_cast<const float*>(sm + L::LSE) + ring.slot * BQ + col0;
            const float* delta_t = reinterpret_cast<const float*>(sm + L::DELTA) + ring.slot * BQ + col0;
            const bool edge = kw + 64 > it.len || (causal && kw + 63 > r0);
#pragma unroll
            for (int j = 0; j < BQ / 8; ++j) {
              const float2 l2 = *reinterpret_cast<const float2*>(lse_t + 8 * j);
              const float2 d2 = *reinterpret_cast<const float2*>(delta_t + 8 * j);
              float p[4], ds[4];
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int c = e & 1;
                p[e] = fast_exp2(fmaf(s[4 * j + e], scale_log2, -(c ? l2.y : l2.x)));
                if (edge) {
                  const int key = key0 + (e >> 1) * 8;
                  if (key >= it.len || (causal && key > r0 + 8 * j + col0 + c)) p[e] = 0.f;
                }
                ds[e] = p[e] * (dp[4 * j + e] - (c ? d2.y : d2.x));
              }
              put_a(pa, j, p);
              put_a(da, j, ds);
            }

            // dV += P^T dO and dK += dS^T Q, 16 queries a step (dO and Q MN-major).
            const uint64_t gm = make_desc(gt, BQ * 64, 512);
            const uint64_t qm = make_desc(qt, BQ * 64, 512);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < BQ / 16; ++kk) {
              wgmma_rs(dva, pa[kk], gm + kk * 64);
              wgmma_rs(dka, da[kk], qm + kk * 64);
            }
            wgmma_commit();
            if constexpr (OVERLAP) {
              pending = ring.slot;
            } else {
              wgmma_wait_all();
              keep(dva);
              keep(dka);
              keep(pa);
              keep(da);
              release(empty, ring.slot, lane);
            }
          } else {
            if (pending >= 0) {  // released before a later tile can need its slot
              wgmma_wait_all();
              keep(dva);
              keep(dka);
              keep(pa);
              keep(da);
              release(empty, pending, lane);
              pending = -1;
            }
            release(empty, ring.slot, lane);
          }
          ring.next<STAGES>();
        }
      }
      wgmma_wait_all();
      keep(dva);
      keep(dka);
      keep(pa);
      keep(da);
      if (pending >= 0) release(empty, pending, lane);
      release(kv_empty, kv.slot, lane);
      kv.next<KV_STAGES>();
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = key0 + 8 * i;
      if (key >= Sk) continue;
      bf16* pk = dk + it.b * dks.b + it.hk * dks.h + key * dks.s + col0;
      bf16* pv = dv + it.b * dvs.b + it.hk * dvs.h + key * dvs.s + col0;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(pk + 8 * j) = pack_bf16(dka[4 * j + 2 * i] * scale, dka[4 * j + 2 * i + 1] * scale);
        *reinterpret_cast<uint32_t*>(pv + 8 * j) = pack_bf16(dva[4 * j + 2 * i], dva[4 * j + 2 * i + 1]);
      }
    }
  }
}

// Pass 2's work item: QB query rows of one (batch, head).
using DqItem = QueryItem<QB>;

// Pass 2: persistent as pass 1, Q and dO in the double-buffered slots.
template <int D>
__global__ void __launch_bounds__(THREADS, 1) dq_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tg,
    const float* __restrict__ lse2, const float* __restrict__ delta, const int* __restrict__ kv_len,
    bf16* __restrict__ dq, int B, int H, int Hkv, int Sq, int Sp, int Sk, float scale, float scale_log2, int causal,
    Strides dqs) {
  using L = DqSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t qg_full = base + L::BAR;
  const uint32_t qg_empty = qg_full + 8 * KV_STAGES;
  const uint32_t full = qg_empty + 8 * KV_STAGES;
  const uint32_t empty = full + 8 * STAGES;

  const int group = H / Hkv;
  const int nbh = B * H;
  const int nqb = (Sq + QB - 1) / QB;
  const int nwork = nbh * nqb;

  if (threadIdx.x == 0) {
    for (int s = 0; s < KV_STAGES; ++s) {
      mbar_init(qg_full + 8 * s, 1);
      mbar_init(qg_empty + 8 * s, CONSUMER_WARPS);
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMER_WARPS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {  // the producer
    regs_dec<PRODUCER_REGS>();
    if (threadIdx.x != CONSUMERS) return;
    Ring qg, ring;
    for (int r = 0, w = snake(0); w < nwork; w = snake(++r)) {
      const DqItem it(w, nbh, nqb, H, Sk, causal, kv_len);
      const int ntiles = (it.kend + KT - 1) / KT;
      if (ntiles == 0) continue;
      const int hk = it.h / group;
      mbar_wait(qg_empty + 8 * qg.slot, qg.phase ^ 1);
      const uint32_t qgb = base + L::Q + qg.slot * L::QG;
      mbar_expect_tx(qg_full + 8 * qg.slot, L::QG);
      load_tile<QB, D>(&tq, qgb, qg_full + 8 * qg.slot, it.q0, it.h, it.b);
      load_tile<QB, D>(&tg, qgb + tile_bytes<QB, D>(), qg_full + 8 * qg.slot, it.q0, it.h, it.b);
      qg.next<KV_STAGES>();
      for (int t = 0; t < ntiles; ++t) {
        mbar_wait(empty + 8 * ring.slot, ring.phase ^ 1);
        const uint32_t bar = full + 8 * ring.slot;
        mbar_expect_tx(bar, 2 * tile_bytes<KT, D>());
        load_tile<KT, D>(&tk, base + L::K + ring.slot * tile_bytes<KT, D>(), bar, t * KT, hk, it.b);
        load_tile<KT, D>(&tv, base + L::V + ring.slot * tile_bytes<KT, D>(), bar, t * KT, hk, it.b);
        ring.next<STAGES>();
      }
    }
    return;
  }

  // Two consumer warpgroups, 64 query rows each.
  regs_inc<CONSUMER_REGS>();
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int col0 = (lane & 3) * 2;
  Ring qg, ring;
  for (int r = 0, w = snake(0); w < nwork; w = snake(++r)) {
    const DqItem it(w, nbh, nqb, H, Sk, causal, kv_len);
    const int ntiles = (it.kend + KT - 1) / KT;
    const int qw = it.q0 + wg * 64;                      // the warpgroup's first row
    const int row0 = qw + warp * 16 + (lane >> 2);       // this thread's rows: row0, row0 + 8
    const int wkend = causal ? min(it.len, qw + 64) : it.len;  // the warpgroup's key end
    float dqa[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dqa[i] = 0.f;

    if (ntiles > 0) {
      float l2[2], dl[2];  // rows past Sq: lse = +inf, P = 2^-inf = 0
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const long long idx = (static_cast<long long>(it.b) * H + it.h) * Sp + row0 + 8 * i;
        l2[i] = lse2[idx];
        dl[i] = delta[idx];
      }
      const uint32_t qb = base + L::Q + qg.slot * L::QG;
      const uint32_t gb = qb + tile_bytes<QB, D>();
      mbar_wait(qg_full + 8 * qg.slot, qg.phase);
      // A tile's dQ product runs on while the next tile's S and dP are
      // issued; its slot (`pending`) is released once the next wait shows
      // it done, and its dS fragments stay untouched until then.
      uint32_t da[KT / 16][4] = {};  // dS as bf16 A fragments
      int pending = -1;
      for (int t = 0; t < ntiles; ++t) {
        const int t0 = t * KT;
        mbar_wait(full + 8 * ring.slot, ring.phase);
        if (t0 < wkend && qw < Sq) {
          const uint32_t kt = base + L::K + ring.slot * tile_bytes<KT, D>();
          const uint32_t vt = base + L::V + ring.slot * tile_bytes<KT, D>();
          const uint64_t kd = make_desc(kt, 16, 512);
          const uint64_t vd = make_desc(vt, 16, 512);

          // S = Q K^T and dP = dO V^T: 64 rows x KT keys.
          float s[KT / 2], dp[KT / 2];
          const uint64_t qd = opaque(make_desc(qb + wg * 64 * 64, 16, 512));
          const uint64_t gd = opaque(make_desc(gb + wg * 64 * 64, 16, 512));
          wgmma_fence();
          wgmma_ss_init(s, qd, kd);
#pragma unroll
          for (int kk = 1; kk < D / 16; ++kk) wgmma_ss(s, qd + k_step<QB>(kk), kd + k_step<KT>(kk));
          wgmma_ss_init(dp, gd, vd);
#pragma unroll
          for (int kk = 1; kk < D / 16; ++kk) wgmma_ss(dp, gd + k_step<QB>(kk), vd + k_step<KT>(kk));
          wgmma_commit();
          wgmma_wait_all();
          keep(s);
          keep(dp);
          keep(da);  // the previous tile's product has read them
          if (pending >= 0) release(empty, pending, lane);

          const bool edge = t0 + KT > it.len || (causal && t0 + KT - 1 > qw);
#pragma unroll
          for (int j = 0; j < KT / 8; ++j) {
            float ds[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = e >> 1;
              float p = fast_exp2(fmaf(s[4 * j + e], scale_log2, -l2[i]));
              if (edge) {
                const int key = t0 + 8 * j + col0 + (e & 1);
                if (key >= it.len || (causal && key > row0 + 8 * i)) p = 0.f;
              }
              ds[e] = p * (dp[4 * j + e] - dl[i]);
            }
            put_a(da, j, ds);
          }

          // dQ += dS K, 16 keys a step (K MN-major).
          const uint64_t km = make_desc(kt, KT * 64, 512);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < KT / 16; ++kk) wgmma_rs(dqa, da[kk], km + kk * 64);
          wgmma_commit();
          pending = ring.slot;
        } else {
          if (pending >= 0) {  // released before a later tile can need its slot
            wgmma_wait_all();
            keep(dqa);
            keep(da);
            release(empty, pending, lane);
            pending = -1;
          }
          release(empty, ring.slot, lane);
        }
        ring.next<STAGES>();
      }
      wgmma_wait_all();
      keep(dqa);
      keep(da);
      if (pending >= 0) release(empty, pending, lane);
      release(qg_empty, qg.slot, lane);
      qg.next<KV_STAGES>();
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      if (row >= Sq) continue;
      bf16* p = dq + it.b * dqs.b + it.h * dqs.h + row * dqs.s + col0;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(p + 8 * j) = pack_bf16(dqa[4 * j + 2 * i] * scale, dqa[4 * j + 2 * i + 1] * scale);
      }
    }
  }
}

struct Args {
  const void *q, *k, *v, *o, *g;
  const float* lse;
  const int* kv_len;
  void *dq, *dk, *dv;
  float* delta;
  int B, H, Hkv, Sq, Sk, causal;
  float scale;
  Strides qs, ks, vs, os, gs, dqs, dks, dvs;
  int device;
  cudaStream_t stream;
};

template <typename T, int D>
cudaError_t launch_delta(const Args& a, int Sp, float* lse2) {
  const long long rows = static_cast<long long>(a.B) * a.H * Sp;
  constexpr int per_block = DELTA_THREADS / delta_lanes<T, D>();
  const unsigned blocks = static_cast<unsigned>((rows + per_block - 1) / per_block);
  delta_kernel<T, D><<<blocks, DELTA_THREADS, 0, a.stream>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.g), a.lse, a.delta, lse2, a.H, a.Sq, Sp, rows, a.os, a.gs);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_scalar(const Args& a) {
  cudaError_t err = launch_delta<float, D>(a, a.Sq, nullptr);
  if (err != cudaSuccess) return err;
  const auto* q = static_cast<const float*>(a.q);
  const auto* k = static_cast<const float*>(a.k);
  const auto* v = static_cast<const float*>(a.v);
  const auto* g = static_cast<const float*>(a.g);
  constexpr int smem = dkdv_scalar_smem_bytes<D>();
  static_assert(smem <= 227 * 1024, "more shared memory than a Hopper block can have");
  static std::atomic<unsigned long long> opted{0};
  err = allow_smem(dkdv_scalar_kernel<D>, opted, a.device, smem);
  if (err != cudaSuccess) return err;
  dkdv_scalar_kernel<D><<<dim3(a.B * a.Hkv, (a.Sk + SC_BK - 1) / SC_BK), SC_BK, smem, a.stream>>>(
      q, k, v, g, a.lse, a.delta, a.kv_len, static_cast<float*>(a.dk), static_cast<float*>(a.dv),
      a.H, a.Hkv, a.Sq, a.Sk, a.scale, a.causal, a.qs, a.ks, a.vs, a.gs, a.dks, a.dvs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq_scalar_kernel<D><<<dim3((a.Sq + SC_BM - 1) / SC_BM, a.H, a.B), SC_BM, 0, a.stream>>>(
      q, k, v, g, a.lse, a.delta, a.kv_len, static_cast<float*>(a.dq),
      a.H, a.Hkv, a.Sq, a.Sk, a.scale, a.causal, a.qs, a.ks, a.vs, a.gs, a.dqs);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_tc(const Args& a) {
  CUtensorMap tq, tk, tv, tg;
  cudaError_t err;
  if ((err = encode_rows(&tq, a.q, a.B, a.H, a.Sq, D, a.qs)) != cudaSuccess ||
      (err = encode_rows(&tk, a.k, a.B, a.Hkv, a.Sk, D, a.ks)) != cudaSuccess ||
      (err = encode_rows(&tv, a.v, a.B, a.Hkv, a.Sk, D, a.vs)) != cudaSuccess ||
      (err = encode_rows(&tg, a.g, a.B, a.H, a.Sq, D, a.gs)) != cudaSuccess) {
    return err;
  }
  // Delta and lse * log2(e), each (B, H, Sp) in the scratch: every query
  // tile and block lies inside its head's padded rows, 256-byte aligned.
  const int Sp = padded_rows(a.Sq);
  float* lse2 = a.delta + static_cast<long long>(a.B) * a.H * Sp;
  err = launch_delta<bf16, D>(a, Sp, lse2);
  if (err != cudaSuccess) return err;

  constexpr int smem1 = DkdvSmem<D>::BYTES;
  static_assert(smem1 <= 227 * 1024, "more shared memory than a Hopper block can have");
  static std::atomic<unsigned long long> opted1{0};
  err = allow_smem(dkdv_kernel<D>, opted1, a.device, smem1);
  if (err != cudaSuccess) return err;
  const long long work1 = static_cast<long long>(a.B) * a.Hkv * ((a.Sk + KB - 1) / KB);
  dkdv_kernel<D><<<static_cast<unsigned>(std::min<long long>(work1, sm_count())), THREADS, smem1, a.stream>>>(
      tq, tk, tv, tg, lse2, a.delta, a.kv_len, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.B, a.H, a.Hkv,
      a.Sq, Sp, a.Sk, a.scale, a.scale * LOG2E, a.causal, a.dks, a.dvs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr int smem2 = DqSmem<D>::BYTES;
  static_assert(smem2 <= 227 * 1024, "more shared memory than a Hopper block can have");
  static std::atomic<unsigned long long> opted2{0};
  err = allow_smem(dq_kernel<D>, opted2, a.device, smem2);
  if (err != cudaSuccess) return err;
  const long long work2 = static_cast<long long>(a.B) * a.H * ((a.Sq + QB - 1) / QB);
  dq_kernel<D><<<static_cast<unsigned>(std::min<long long>(work2, sm_count())), THREADS, smem2, a.stream>>>(
      tq, tk, tv, tg, lse2, a.delta, a.kv_len, static_cast<bf16*>(a.dq), a.B, a.H, a.Hkv, a.Sq, Sp, a.Sk, a.scale,
      a.scale * LOG2E, a.causal, a.dqs);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One backward (three kernel launches on `stream`). p holds 45 integers: the
// device addresses q, k, v, o, dO, lse, kv_len (0 for "every key valid"),
// dq, dk, dv and delta (f32 scratch of 2 * B * H * Sp, Sp = Sq rounded up
// to a multiple of 128; the f32 route uses the first B * H * Sq); B, H,
// Hkv, Sq, Sk, D, causal, dtype (0 = float32, scalar route; 1 = bfloat16,
// tensor cores); the element strides (batch, head, sequence) of q, k, v, o,
// dO, dq, dk and dv; the CUDA device and the stream. Every tensor is of the
// dtype except lse ((B, H, Sq) contiguous f32), delta and kv_len ((B,)
// int32). Nothing is
// allocated here. The current device is switched for the launches and
// restored. Returns the first cudaError_t of the launches (0 on success).
int vcp_flash_attention_bwd(const long long* p, float scale) {
  Args a;
  a.q = reinterpret_cast<const void*>(p[0]);
  a.k = reinterpret_cast<const void*>(p[1]);
  a.v = reinterpret_cast<const void*>(p[2]);
  a.o = reinterpret_cast<const void*>(p[3]);
  a.g = reinterpret_cast<const void*>(p[4]);
  a.lse = reinterpret_cast<const float*>(p[5]);
  a.kv_len = reinterpret_cast<const int*>(p[6]);
  a.dq = reinterpret_cast<void*>(p[7]);
  a.dk = reinterpret_cast<void*>(p[8]);
  a.dv = reinterpret_cast<void*>(p[9]);
  a.delta = reinterpret_cast<float*>(p[10]);
  a.B = static_cast<int>(p[11]);
  a.H = static_cast<int>(p[12]);
  a.Hkv = static_cast<int>(p[13]);
  a.Sq = static_cast<int>(p[14]);
  a.Sk = static_cast<int>(p[15]);
  const int D = static_cast<int>(p[16]);
  a.causal = static_cast<int>(p[17]);
  const int dtype = static_cast<int>(p[18]);
  Strides* st[] = {&a.qs, &a.ks, &a.vs, &a.os, &a.gs, &a.dqs, &a.dks, &a.dvs};
  for (int i = 0; i < 8; ++i) *st[i] = Strides{p[19 + 3 * i], p[20 + 3 * i], p[21 + 3 * i]};
  const int device = static_cast<int>(p[43]);
  a.device = device;
  a.stream = reinterpret_cast<cudaStream_t>(p[44]);
  a.scale = scale;
  if (a.B <= 0 || a.H <= 0 || a.Hkv <= 0 || a.H % a.Hkv != 0 || a.Sq <= 0 || a.Sk <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int prev = device;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaErrorInvalidValue;
  if (dtype == 0) {
    switch (D) {
      case 32: err = launch_scalar<32>(a); break;
      case 64: err = launch_scalar<64>(a); break;
      case 96: err = launch_scalar<96>(a); break;
      case 128: err = launch_scalar<128>(a); break;
    }
  } else if (dtype == 1) {
    switch (D) {
      case 32: err = launch_tc<32>(a); break;
      case 64: err = launch_tc<64>(a); break;
      case 96: err = launch_tc<96>(a); break;
      case 128: err = launch_tc<128>(a); break;
    }
  }
  if (prev != device) cudaSetDevice(prev);
  return static_cast<int>(err);
}

const char* vcp_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
