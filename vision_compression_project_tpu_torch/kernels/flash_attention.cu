// Blockwise flash attention forward for Hopper (sm_90a), plain CUDA C++.
//
// Replaces the Pallas TPU kernel
// vision_compression_project_tpu/ops/attention.py::_flash_kernel (launched by
// _flash_forward). It computes, per (batch, head),
//   O = softmax(scale * Q K^T + mask) V
// with an online softmax: running max, sum and accumulator in f32, the scale
// applied to f32 scores, key mask k < min(kv_len[b], Sk), optional causal mask
// k <= q, GQA through kv head h / (H / Hkv), masked scores dropped (the
// reference's -1e30) and output acc / max(l, 1e-30) in the input type. A row
// whose key range is empty (kv_len == 0) gives 0, as the Pallas loop over zero
// blocks does. Ragged Sq and Sk are masked here: no caller pads.
//
// Two routes, chosen by dtype:
//
// * bf16 (the main path): warp-specialised persistent blocks of three
//   warpgroups, at most one block per SM, walking work items of QB = 128
//   query rows of one (batch, head) in rounds that alternate in direction
//   (hopper.cuh's snake and QueryItem: causal items longest first; otherwise
//   a (batch, head)'s items side by side, the heads of a GQA group next to
//   each other, so their K and V tiles come again from L2). The producer
//   warpgroup gives up registers (setmaxnreg.dec to 40) and one of its
//   threads issues every load: the item's Q tile once, into one of two
//   slots (the next item's Q arrives while this one runs), then its K and V
//   tiles of KT = 64 keys into a ring of STAGES slots, each a TMA copy of a
//   4-D tensor map (D, S, H, B) over the strided input, 64 rows x 32
//   columns a box in 64-byte swizzle, completing on mbarriers; rows past S
//   arrive as zeros. Two consumer warpgroups (setmaxnreg.inc to 232) own 64
//   query rows each and read the same K and V tiles:
//   S = Q K^T by wgmma m64n64k16 with both operands in shared memory (SS);
//   the online softmax in registers, in log2 units (scale * log2(e) folded
//   into one FMA before ex2), the row max reduced over the quad of lanes
//   that shares a row; P packed from the S accumulators (their layout is the
//   A fragment's) into two bf16 terms, hi = bf16(P) and lo = bf16(P - hi),
//   each a wgmma RS product into the same f32 O accumulator with V as the
//   MN-major B operand (m64nDk16). P keeps about 16 bits: bf16(P) alone
//   keeps 8 and put outputs of rows with few keys a bf16 ulp (1.6e-2 at
//   |o| in [2, 4)) off the reference, whose P V is f32. The split costs
//   half as much again tensor-core work per tile (6 * D operations a
//   query-key pair instead of 4 * D).
//   Overlap: tile t's S product is issued, then tile t - 1's P V, and the
//   softmax of tile t runs while P V still runs; O is rescaled once P V is
//   done. So a warpgroup holds one S tile, one P tile (hi and lo) and O in
//   registers (at D = 128: 32 + 32 + 64 floats a thread), and the two
//   warpgroups' products interleave on the SM's tensor cores.
//   A warpgroup masks element by element only a tile that straddles
//   kv_len, Sk or its diagonal, and skips (releases unread) the tiles past
//   its own key end (causal: the block's last tile for the first 64 rows;
//   every tile for rows that start past Sq). O leaves as bf16 pairs from
//   the accumulators, rows past Sq not written; lse rows are plain stores.
//   The grid is min(items, SMs): a call with fewer items than SMs gets one
//   block an item. Tried on the card and dropped (PERF.md §6): the next
//   tile's S issued before this tile's softmax (two S tiles in registers:
//   the compiler then serialises every product for want of registers),
//   128-key tiles (faster at D = 32 only), and the two warpgroups taking
//   turns to issue their products (within 7% either way, 1% net).
// * f32 (the f32 checks only): the scalar kernel. One thread owns one query
//   row and keeps q and the accumulator in registers; f32 tensor-core math
//   (TF32) would not hold the f32 limit. It is not on the bf16 path. At
//   D = 96 and 128 its key tile is 32 rows (static shared memory stays under
//   48 KB), and q plus the accumulator (2 * D floats a thread) may spill to
//   local memory: nvcc's -Xptxas -v report says how much.
//
// Head dims: 32 and 64 (ocr_real, ocr_bpe, the embedder), 96 (prod's global
// vision stage) and 128 (prod's decoder). A bf16 block takes 49-193 KB of
// shared memory (two Q slots of 128 rows, STAGES K and V tiles), opted in
// with cudaFuncSetAttribute before its first launch on a device.
//
// Bound on this card: in bf16 the long calls (ocr_real's global encoder and
// decoder, the training step's, the pipeline microbatch) are bound by the
// tensor cores (4 * D operations per query-key pair that the masks leave),
// the 256-token windows and the short serving calls by the bytes of q, k, v
// and o. The design keeps the tensor cores fed from TMA without per-thread
// address work, shares every K and V tile between 128 query rows, and hides
// the softmax under the previous tile's P V.
//
// Layouts: q (B, H, Sq, D), k and v (B, Hkv, Sk, D), each given by element
// strides for batch, head and sequence with the last dimension contiguous;
// the bf16 route needs those strides to be multiples of 8 and the bases
// 16-byte aligned (TMA). Keys past kv_len inside a loaded tile are read and
// enter P V with weight 0, so they must be finite, as every caller's are. o
// is written as a contiguous (B, Sq, H, D) tensor, the layout the output
// projection reads.
//
// Given an lse address (the forward of a gradient), both routes also write
// the row log-sum-exp, lse = log sum_valid exp(scale * s) in natural-log
// units, as a contiguous (B, H, Sq) f32 tensor, +inf for a row with no valid
// key; the backward (flash_attention_bwd.cu) recomputes the weights from it.
// Serving passes 0 and writes nothing more. The tensor maps are encoded on
// the host for each call (hopper.cuh's encode_rows) and passed as
// __grid_constant__ kernel parameters, so a CUDA graph keeps them.

#include <algorithm>
#include <cmath>

#include "hopper.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LN2 = 0.6931471805599453f;

// ---------------------------------------------------------------- f32 route

constexpr int SC_BM = 64;     // query rows per block (one thread per row)
constexpr int SC_CHUNK = 16;  // keys scored at a time in registers

template <int D>
__global__ void __launch_bounds__(SC_BM) flash_fwd_scalar_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const int* __restrict__ kv_len, float* __restrict__ o, float* __restrict__ lse,
    int H, int Hkv, int Sq, int Sk, float scale, int causal, Strides qs, Strides ks, Strides vs) {
  // Keys staged per tile: the K and V tiles (SC_BN x D f32 each) stay within
  // the 48 KB of static shared memory.
  constexpr int SC_BN = D <= 64 ? 64 : 32;
  __shared__ __align__(16) float ksm[SC_BN][D];
  __shared__ __align__(16) float vsm[SC_BN][D];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * SC_BM;
  const int row = q0 + threadIdx.x;
  const int hk = h / (H / Hkv);

  // Keys at or past kend are masked for every row of this block: past the
  // valid length, or (causal) right of the block's last row.
  const int len = kv_len ? max(0, min(kv_len[b], Sk)) : Sk;
  const int kend = causal ? min(len, q0 + SC_BM) : len;

  const float* qp = q + b * qs.b + h * qs.h;
  const float* kp = k + b * ks.b + hk * ks.h;
  const float* vp = v + b * vs.b + hk * vs.h;

  const bool live = row < Sq;
  float qr[D];
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = live ? qp[row * qs.s + d] * scale : 0.f;
    acc[d] = 0.f;
  }
  float m = NEG_INF;
  float l = 0.f;

  for (int t0 = 0; t0 < kend; t0 += SC_BN) {
    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < SC_BN * D; i += SC_BM) {
      const int r = i / D;
      const int c = i % D;
      const int kr = t0 + r;
      const bool in = kr < kend;
      ksm[r][c] = in ? kp[kr * ks.s + c] : 0.f;
      vsm[r][c] = in ? vp[kr * vs.s + c] : 0.f;
    }
    __syncthreads();

    const int tn = min(SC_BN, kend - t0);
    for (int j0 = 0; j0 < tn; j0 += SC_CHUNK) {
      float s[SC_CHUNK];
      bool ok[SC_CHUNK];
      float cmax = NEG_INF;
#pragma unroll
      for (int j = 0; j < SC_CHUNK; ++j) {
        const int key = t0 + j0 + j;
        ok[j] = (j0 + j < tn) && (!causal || key <= row);
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) dot += qr[d] * ksm[j0 + j][d];
        s[j] = ok[j] ? dot : NEG_INF;
        cmax = fmaxf(cmax, s[j]);
      }
      const float m_new = fmaxf(m, cmax);
      const float corr = expf(m - m_new);
      l *= corr;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= corr;
#pragma unroll
      for (int j = 0; j < SC_CHUNK; ++j) {
        const float p = ok[j] ? expf(s[j] - m_new) : 0.f;
        l += p;
#pragma unroll
        for (int d = 0; d < D; ++d) acc[d] += p * vsm[j0 + j][d];
      }
      m = m_new;
    }
  }

  if (live) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    float* op = o + ((static_cast<long long>(b) * Sq + row) * H + h) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) op[d] = acc[d] * inv;
    if (lse) lse[(static_cast<long long>(b) * H + h) * Sq + row] = l > 0.f ? m + logf(l) : INFINITY;
  }
}

// -------------------------------------------------------------- bf16 route

constexpr int QB = 128;     // query rows per work item, 64 per consumer warpgroup
constexpr int KT = 64;      // keys per K and V tile
constexpr int Q_STAGES = 2; // Q slots: this item's and the next one's
constexpr int STAGES = 4;   // K and V slots of the ring (227 KB hold 4 at D = 128)

template <int D>
struct FwdSmem {  // byte offsets from a 1024-aligned base
  static constexpr int Q = 0;                                   // Q_STAGES x QB x D
  static constexpr int K = Q + Q_STAGES * tile_bytes<QB, D>();  // STAGES x KT x D
  static constexpr int V = K + STAGES * tile_bytes<KT, D>();
  static constexpr int BAR = V + STAGES * tile_bytes<KT, D>();  // q_full, q_empty, full, empty
  static constexpr int BYTES = BAR + 16 * (Q_STAGES + STAGES) + 1024;  // + the alignment of the base
};

using FwdItem = QueryItem<QB>;

// put_a of the weights v in two bf16 terms: hi = bf16(v) into `hi`, and
// lo = bf16(v - hi) into `lo`.
template <int S>
__device__ __forceinline__ void put_a_split(uint32_t (&hi)[S][4], uint32_t (&lo)[S][4], int j, const float (&v)[4]) {
  put_a(hi, j, v);
  const uint32_t a = hi[j >> 1][(j & 1) * 2], b = hi[j >> 1][(j & 1) * 2 + 1];
  const float rest[4] = {v[0] - __uint_as_float(a << 16), v[1] - __uint_as_float(a & 0xffff0000u),
                         v[2] - __uint_as_float(b << 16), v[3] - __uint_as_float(b & 0xffff0000u)};
  put_a(lo, j, rest);
}

// O += P V for one KT-key tile: P as hi and lo A fragments, V the MN-major
// B operand of the tile at vt.
template <int N>
__device__ __forceinline__ void pv_product(float (&acc)[N], const uint32_t (&ph)[KT / 16][4],
                                           const uint32_t (&pl)[KT / 16][4], uint32_t vt) {
  const uint64_t vm = make_desc(vt, KT * 64, 512);
#pragma unroll
  for (int kk = 0; kk < KT / 16; ++kk) {
    wgmma_rs(acc, ph[kk], vm + kk * 64);
    wgmma_rs(acc, pl[kk], vm + kk * 64);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1) flash_fwd_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const int* __restrict__ kv_len, bf16* __restrict__ o,
    float* __restrict__ lse, int B, int H, int Hkv, int Sq, int Sk, float scale_log2, int causal) {
  using L = FwdSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_full = base + L::BAR;
  const uint32_t q_empty = q_full + 8 * Q_STAGES;
  const uint32_t full = q_empty + 8 * Q_STAGES;
  const uint32_t empty = full + 8 * STAGES;

  const int group = H / Hkv;
  const int nbh = B * H;
  const int nqb = (Sq + QB - 1) / QB;
  const int nwork = nbh * nqb;

  if (threadIdx.x == 0) {
    for (int s = 0; s < Q_STAGES; ++s) {
      mbar_init(q_full + 8 * s, 1);
      mbar_init(q_empty + 8 * s, CONSUMER_WARPS);
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
    Ring qs, ring;
    for (int r = 0, w = snake(0); w < nwork; w = snake(++r)) {
      const FwdItem it(w, nbh, nqb, H, Sk, causal, kv_len);
      const int ntiles = (it.kend + KT - 1) / KT;
      if (ntiles == 0) continue;
      const int hk = it.h / group;
      mbar_wait(q_empty + 8 * qs.slot, qs.phase ^ 1);
      mbar_expect_tx(q_full + 8 * qs.slot, tile_bytes<QB, D>());
      load_tile<QB, D>(&tq, base + L::Q + qs.slot * tile_bytes<QB, D>(), q_full + 8 * qs.slot, it.q0, it.h, it.b);
      qs.next<Q_STAGES>();
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
  const int col0 = (lane & 3) * 2;  // this thread's columns in each 8-wide block: col0, col0 + 1
  Ring qs, ring;
  for (int r = 0, w = snake(0); w < nwork; w = snake(++r)) {
    const FwdItem it(w, nbh, nqb, H, Sk, causal, kv_len);
    const int ntiles = (it.kend + KT - 1) / KT;
    const int qw = it.q0 + wg * 64;                   // the warpgroup's first row
    const int row0 = qw + warp * 16 + (lane >> 2);    // this thread's rows: row0, row0 + 8
    // The warpgroup's key end and tiles: none for rows that start past Sq.
    const int wkend = qw >= Sq ? 0 : causal ? min(it.len, qw + 64) : it.len;
    const int wtiles = (wkend + KT - 1) / KT;
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};  // running max of this thread's two rows, scaled, log2 units
    float l[2] = {0.f, 0.f};              // this thread's part of the running sums

    if (ntiles > 0) {
      const uint32_t qb = base + L::Q + qs.slot * tile_bytes<QB, D>();
      mbar_wait(q_full + 8 * qs.slot, qs.phase);
      uint32_t ph[KT / 16][4], pl[KT / 16][4];  // P of the last tile: hi and lo A fragments

      // S = Q K^T of tile t into s (64 rows x KT keys) is issued and
      // committed; then the softmax of s: the keys past kv_len or Sk and
      // (causal) right of the row masked, in a tile that straddles either
      // for some row of the warpgroup; online softmax, rows row0 (e = 0, 1)
      // and row0 + 8 (e = 2, 3). The scale (> 0) is applied in f32:
      // max(scale * s) = scale * max(s), and p = 2^(s * scale * log2(e) - m)
      // is one FMA into the exponent. corr: what O and l are scaled by.
      auto issue_s = [&](float (&s)[KT / 2], int slot) {
        const uint64_t qd = opaque(make_desc(qb + wg * 64 * 64, 16, 512));
        const uint64_t kd = make_desc(base + L::K + slot * tile_bytes<KT, D>(), 16, 512);
        wgmma_fence();
        wgmma_ss_init(s, qd, kd);
#pragma unroll
        for (int kk = 1; kk < D / 16; ++kk) wgmma_ss(s, qd + k_step<QB>(kk), kd + k_step<KT>(kk));
        wgmma_commit();
      };
      auto softmax = [&](float (&s)[KT / 2], float (&corr)[2], int t) {
        const int t0 = t * KT;
        if (t0 + KT > it.len || (causal && t0 + KT - 1 > qw)) {
#pragma unroll
          for (int j = 0; j < KT / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int key = t0 + 8 * j + col0 + (e & 1);
              if (key >= it.len || (causal && key > row0 + (e >> 1) * 8)) s[4 * j + e] = -INFINITY;
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float mx = -INFINITY;
#pragma unroll
          for (int j = 0; j < KT / 8; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m[i], mx * scale_log2);
          const float top = m_new == -INFINITY ? 0.f : m_new;  // a row with no key yet
          corr[i] = fast_exp2(m[i] - top);
          m[i] = m_new;
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < KT / 8; ++j) {
            s[4 * j + 2 * i] = fast_exp2(fmaf(s[4 * j + 2 * i], scale_log2, -top));
            s[4 * j + 2 * i + 1] = fast_exp2(fmaf(s[4 * j + 2 * i + 1], scale_log2, -top));
            sum += s[4 * j + 2 * i] + s[4 * j + 2 * i + 1];
          }
          l[i] = l[i] * corr[i] + sum;
        }
      };
      auto pack_p = [&](const float (&s)[KT / 2]) {
#pragma unroll
        for (int j = 0; j < KT / 8; ++j) {
          const float p[4] = {s[4 * j], s[4 * j + 1], s[4 * j + 2], s[4 * j + 3]};
          put_a_split(ph, pl, j, p);
        }
      };

      // The first tile alone, then every later one with the previous
      // tile's P V issued behind its S: the softmax runs while P V does.
      // Each step starts and ends with no product in flight, so that the
      // compiler keeps the products asynchronous.
      int t = 0;
      if (wtiles > 0) {
        mbar_wait(full + 8 * ring.slot, ring.phase);
        float s[KT / 2], corr[2];
        issue_s(s, ring.slot);
        wgmma_wait<0>();
        keep(s);
        softmax(s, corr, 0);
        pack_p(s);
        int pending = ring.slot;  // the slot whose P V is still to run
        ring.next<STAGES>();
        for (t = 1; t < wtiles; ++t) {
          mbar_wait(full + 8 * ring.slot, ring.phase);
          issue_s(s, ring.slot);
          pv_product(acc, ph, pl, base + L::V + pending * tile_bytes<KT, D>());
          wgmma_commit();
          wgmma_wait<1>();
          keep(s);
          softmax(s, corr, t);
          wgmma_wait<0>();  // the previous P V: its slot is free, O and P may change
          keep(acc);
          keep(ph);
          keep(pl);
          release(empty, pending, lane);
#pragma unroll
          for (int j = 0; j < D / 8; ++j) {
            acc[4 * j] *= corr[0];
            acc[4 * j + 1] *= corr[0];
            acc[4 * j + 2] *= corr[1];
            acc[4 * j + 3] *= corr[1];
          }
          pack_p(s);
          pending = ring.slot;
          ring.next<STAGES>();
        }
        wgmma_fence();  // the last tile's P V
        pv_product(acc, ph, pl, base + L::V + pending * tile_bytes<KT, D>());
        wgmma_commit();
        wgmma_wait<0>();
        keep(acc);
        keep(ph);
        keep(pl);
        release(empty, pending, lane);
      }
      for (; t < ntiles; ++t) {  // past this warpgroup's key end: released unread
        mbar_wait(full + 8 * ring.slot, ring.phase);
        release(empty, ring.slot, lane);
        ring.next<STAGES>();
      }
      release(q_empty, qs.slot, lane);
      qs.next<Q_STAGES>();
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float sum = l[i];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const int row = row0 + 8 * i;
      if (row >= Sq) continue;
      const float inv = 1.f / fmaxf(sum, 1e-30f);
      bf16* op = o + ((static_cast<long long>(it.b) * Sq + row) * H + it.h) * D + col0;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(op + 8 * j) = pack_bf16(acc[4 * j + 2 * i] * inv, acc[4 * j + 2 * i + 1] * inv);
      }
      // m is in log2 units: lse = (m + log2(sum)) ln 2.
      if (lse && (lane & 3) == 0) {
        lse[(static_cast<long long>(it.b) * H + it.h) * Sq + row] = sum > 0.f ? (m[i] + log2f(sum)) * LN2 : INFINITY;
      }
    }
  }
}

template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v, const int* kv_len, void* o, float* lse,
                      int B, int H, int Hkv, int Sq, int Sk, float scale, int causal,
                      Strides qs, Strides ks, Strides vs, int device, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  cudaError_t err;
  if ((err = encode_rows(&tq, q, B, H, Sq, D, qs)) != cudaSuccess ||
      (err = encode_rows(&tk, k, B, Hkv, Sk, D, ks)) != cudaSuccess ||
      (err = encode_rows(&tv, v, B, Hkv, Sk, D, vs)) != cudaSuccess) {
    return err;
  }
  constexpr int smem = FwdSmem<D>::BYTES;
  static_assert(smem <= 227 * 1024, "more shared memory than a Hopper block can have");
  static std::atomic<unsigned long long> opted{0};
  err = allow_smem(flash_fwd_kernel<D>, opted, device, smem);
  if (err != cudaSuccess) return err;
  const long long work = static_cast<long long>(B) * H * ((Sq + QB - 1) / QB);
  flash_fwd_kernel<D><<<static_cast<unsigned>(std::min<long long>(work, sm_count())), THREADS, smem, stream>>>(
      tq, tk, tv, kv_len, static_cast<bf16*>(o), lse, B, H, Hkv, Sq, Sk, scale * LOG2E, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_scalar(const void* q, const void* k, const void* v, const int* kv_len, void* o, float* lse,
                          int B, int H, int Hkv, int Sq, int Sk, float scale, int causal,
                          Strides qs, Strides ks, Strides vs, cudaStream_t stream) {
  const dim3 grid((Sq + SC_BM - 1) / SC_BM, H, B);
  flash_fwd_scalar_kernel<D><<<grid, SC_BM, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v), kv_len,
      static_cast<float*>(o), lse, H, Hkv, Sq, Sk, scale, causal, qs, ks, vs);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One launch. p holds 25 integers (packed so that a caller pays one argument
// conversion, not 25): q, k, v, kv_len, o (device addresses; kv_len 0 for
// "every key valid"), B, H, Hkv, Sq, Sk, D, causal, dtype, the element
// strides (batch, head, sequence) of q, of k and of v, the CUDA device, the
// stream, and lse (the device address of a contiguous (B, H, Sq) f32 tensor
// for the row log-sum-exp, or 0 for "do not write"). q: (B, H, Sq, D), k and v: (B, Hkv, Sk, D), each with its last
// dimension contiguous; for bf16 the strides are multiples of 8 and the bases
// 16-byte aligned (TMA). kv_len: (B,) int32. o: a contiguous (B, Sq, H, D) tensor.
// dtype: 0 = float32 (scalar route), 1 = bfloat16 (tensor cores). D: 32, 64, 96
// or 128; anything else returns cudaErrorInvalidValue. The kernel
// runs on `stream` of `device` (the current device is switched for the launch
// and restored). Returns the cudaError_t of the launch (0 on success).
int vcp_flash_attention_fwd(const long long* p, float scale) {
  const void* q = reinterpret_cast<const void*>(p[0]);
  const void* k = reinterpret_cast<const void*>(p[1]);
  const void* v = reinterpret_cast<const void*>(p[2]);
  const int* kv_len = reinterpret_cast<const int*>(p[3]);
  void* o = reinterpret_cast<void*>(p[4]);
  const int B = static_cast<int>(p[5]), H = static_cast<int>(p[6]), Hkv = static_cast<int>(p[7]);
  const int Sq = static_cast<int>(p[8]), Sk = static_cast<int>(p[9]), D = static_cast<int>(p[10]);
  const int causal = static_cast<int>(p[11]), dtype = static_cast<int>(p[12]);
  const Strides qs{p[13], p[14], p[15]}, ks{p[16], p[17], p[18]}, vs{p[19], p[20], p[21]};
  const int device = static_cast<int>(p[22]);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(p[23]);
  float* lse = reinterpret_cast<float*>(p[24]);
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || Sq <= 0 || Sk <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int prev = device;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (dtype * 1000 + D) {  // dtype 0 = f32 (scalar), 1 = bf16 (tensor cores)
    case 32: err = launch_scalar<32>(q, k, v, kv_len, o, lse, B, H, Hkv, Sq, Sk, scale, causal, qs, ks, vs, s); break;
    case 64: err = launch_scalar<64>(q, k, v, kv_len, o, lse, B, H, Hkv, Sq, Sk, scale, causal, qs, ks, vs, s); break;
    case 96: err = launch_scalar<96>(q, k, v, kv_len, o, lse, B, H, Hkv, Sq, Sk, scale, causal, qs, ks, vs, s); break;
    case 128: err = launch_scalar<128>(q, k, v, kv_len, o, lse, B, H, Hkv, Sq, Sk, scale, causal, qs, ks, vs, s); break;
    case 1032: err = launch_tc<32>(q, k, v, kv_len, o, lse, B, H, Hkv, Sq, Sk, scale, causal, qs, ks, vs, device, s); break;
    case 1064: err = launch_tc<64>(q, k, v, kv_len, o, lse, B, H, Hkv, Sq, Sk, scale, causal, qs, ks, vs, device, s); break;
    case 1096: err = launch_tc<96>(q, k, v, kv_len, o, lse, B, H, Hkv, Sq, Sk, scale, causal, qs, ks, vs, device, s); break;
    case 1128: err = launch_tc<128>(q, k, v, kv_len, o, lse, B, H, Hkv, Sq, Sk, scale, causal, qs, ks, vs, device, s); break;
    default: err = cudaErrorInvalidValue;
  }
  if (prev != device) cudaSetDevice(prev);
  return static_cast<int>(err);
}

const char* vcp_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
