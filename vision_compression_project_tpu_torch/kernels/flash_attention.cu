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
// * bf16 (the main path): tensor cores. A block of WARPS warps owns 16 * WARPS
//   query rows, 16 per warp; Q is staged once in shared memory and held in
//   registers as mma fragments (ldmatrix). K and V tiles of 64 keys x D stay
//   bf16 in shared memory, two tiles in flight through 16-byte cp.async (rows
//   past the key end zero-filled, one barrier per tile), and feed mma.sync
//   m16n8k16 bf16 -> f32 through ldmatrix (.trans for V). S = Q K^T
//   accumulates in f32 and is scaled in f32; row max and sum are kept in f32
//   and reduced over the quad of lanes that shares a row. P enters the P V product as two bf16 terms, hi = bf16(P) and
//   lo = bf16(P - hi), each multiplied into the same f32 accumulators: P keeps
//   about 16 bits, where bf16(P) alone keeps 8 and put outputs of rows with
//   few keys a bf16 ulp (1.6e-2 at |o| in [2, 4)) off the reference, whose
//   P V is f32. The split costs a third more tensor-core work per tile.
//   The key loop ends at the block's key end (causal and kv_len), and only a
//   tile that straddles the diagonal or kv_len is masked element by element.
//   The grid is (B * H, q-blocks) with the q-block taken in reverse, so the
//   heaviest causal blocks start first; the host takes 4, 2 or 1 warps per
//   block, the most that still gives at least one block per SM.
// * f32 (the f32 checks only): the scalar kernel. One thread owns one query
//   row and keeps q and the accumulator in registers; f32 tensor-core math
//   (TF32) would not hold the f32 limit. It is not on the bf16 path. At
//   D = 96 and 128 its key tile is 32 rows (static shared memory stays under
//   48 KB), and q plus the accumulator (2 * D floats a thread) may spill to
//   local memory: nvcc's -Xptxas -v report says how much.
//
// Head dims: 32 and 64 (ocr_real, ocr_bpe, the embedder), 96 (prod's global
// vision stage) and 128 (prod's decoder). At 96 and 128 a bf16 block needs
// 56-87 KB of shared memory, above the 48 KB a launch gets by default; the
// host opts each such kernel in with cudaFuncSetAttribute before its first
// launch on a device (Hopper allows 227 KB a block).
//
// Bound on this card: in bf16 the ocr_real encoder's global calls and the
// decoder prefill are bound by the tensor cores (4 * D operations per
// query-key pair), the 256-token windows and the ocr_bpe answer's calls by the
// bytes of q, k, v and o. Every call is small (at most 6.4 GFLOP or 25 MB), so
// grid fill, latency and instruction issue set its time well above either
// bound; the design answers with small per-warp tiles, a grid sized to the
// SMs, no pad copies and no masking work outside the edge tiles.
//
// Layouts: q (B, H, Sq, D), k and v (B, Hkv, Sk, D), each given by element
// strides for batch, head and sequence with the last dimension contiguous;
// the bf16 route needs those strides to be multiples of 8 and the bases
// 16-byte aligned (cp.async). o is written as a contiguous (B, Sq, H, D)
// tensor, the layout the output projection reads.
//
// Given an lse address (the forward of a gradient), both routes also write
// the row log-sum-exp, lse = log sum_valid exp(scale * s) in natural-log
// units, as a contiguous (B, H, Sq) f32 tensor, +inf for a row with no valid
// key; the backward (flash_attention_bwd.cu) recomputes the weights from it.
// Serving passes 0 and writes nothing more.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cmath>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Strides {
  long long b, h, s;
};

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

constexpr int TC_BN = 64;  // keys per shared-memory tile
constexpr int STAGES = 2;  // tiles in flight
constexpr int PAD = 8;     // bf16 per smem row (16 bytes): ldmatrix's 8 rows hit 8 distinct bank groups

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with valid == false nothing is read and the
// destination is zero-filled.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 -> one register of two bf16, the lower index in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// pack_bf16 of what bf16 rounding left of the pair: x - float(bf16(x)).
__device__ __forceinline__ uint32_t pack_bf16_rest(float lo, float hi, uint32_t packed) {
  const float lo_hi = __uint_as_float(packed << 16);
  const float hi_hi = __uint_as_float(packed & 0xffff0000u);
  return pack_bf16(lo - lo_hi, hi - hi_hi);
}

// 2^x with the SFU (ex2.approx, ~2 ulp); 2^-inf = 0.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Fragment layouts (PTX ISA, mma.m16n8k16): lane = 4 * g + t. A holds rows g
// and g + 8, columns 2t, 2t + 1 and 2t + 8, 2t + 9; B holds k rows 2t, 2t + 1
// and 2t + 8, 2t + 9 of column g; C holds rows g and g + 8, columns 2t, 2t + 1.
//
// Shared memory (dynamic): Q (BM rows), then STAGES K tiles, then STAGES V
// tiles, each row D + PAD bf16. Tile t lives in slot t % STAGES; cp.async
// group t carries tile t (group 0 also Q), so waiting for all but the newest
// STAGES - 2 groups means tile t arrived.
template <int D, int WARPS>
constexpr int tc_smem_bytes() {
  return (16 * WARPS + 2 * STAGES * TC_BN) * (D + PAD) * static_cast<int>(sizeof(bf16));
}

template <int D, int WARPS>
__global__ void __launch_bounds__(WARPS * 32) flash_fwd_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const int* __restrict__ kv_len, bf16* __restrict__ o, float* __restrict__ lse,
    int H, int Hkv, int Sq, int Sk, float scale_log2, int causal, Strides qs, Strides ks, Strides vs) {
  constexpr int BM = 16 * WARPS;
  constexpr int BN = TC_BN;
  constexpr int LD = D + PAD;  // smem row stride, elements
  constexpr int CH = D / 8;    // 16-byte chunks per row
  constexpr int NT = WARPS * 32;
  constexpr int NB = BN / 8;   // 8-key score blocks per tile
  constexpr int ND = D / 8;    // 8-wide output blocks
  constexpr int KD = D / 16;   // 16-deep steps over D
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qsm = reinterpret_cast<bf16*>(smem_raw);
  bf16* ksm = qsm + BM * LD;
  bf16* vsm = ksm + STAGES * BN * LD;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;  // heaviest causal blocks first
  const int hk = h / (H / Hkv);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  const int len = kv_len ? max(0, min(kv_len[b], Sk)) : Sk;
  const int kend = causal ? min(len, q0 + BM) : len;
  const int ntiles = (kend + BN - 1) / BN;

  const bf16* qp = q + b * qs.b + h * qs.h;
  const bf16* kp = k + b * ks.b + hk * ks.h;
  const bf16* vp = v + b * vs.b + hk * vs.h;

  for (int i = threadIdx.x; i < BM * CH; i += NT) {
    const int r = i / CH, c = (i % CH) * 8;
    const bool ok = q0 + r < Sq;
    cp_async16(smem_u32(&qsm[r * LD + c]), ok ? qp + (q0 + r) * qs.s + c : qp, ok);
  }
  auto load_kv = [&](int tile) {
    bf16* kt = ksm + (tile % STAGES) * BN * LD;
    bf16* vt = vsm + (tile % STAGES) * BN * LD;
    for (int i = threadIdx.x; i < BN * CH; i += NT) {
      const int r = i / CH, c = (i % CH) * 8;
      const int key = tile * BN + r;
      const bool ok = key < kend;
      cp_async16(smem_u32(&kt[r * LD + c]), ok ? kp + key * ks.s + c : kp, ok);
      cp_async16(smem_u32(&vt[r * LD + c]), ok ? vp + key * vs.s + c : vp, ok);
    }
  };
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < ntiles) load_kv(t);
    cp_async_commit();
  }

  uint32_t qf[KD][4];
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of this lane's two rows, scaled, log2 units
  float l[2] = {0.f, 0.f};              // this lane's part of the running sums
  const int row0 = q0 + warp * 16 + (lane >> 2);  // this lane's rows: row0, row0 + 8

  for (int tile = 0; tile < ntiles; ++tile) {
    cp_async_wait<STAGES - 2>();  // this tile (and Q) arrived for this thread ...
    __syncthreads();              // ... and every thread's; the slot read last is free
    if (tile + STAGES - 1 < ntiles) load_kv(tile + STAGES - 1);
    cp_async_commit();
    if (tile == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        ldmatrix_x4(qf[kk], smem_u32(&qsm[(warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8]));
      }
    }
    const bf16* kt = ksm + (tile % STAGES) * BN * LD;
    const bf16* vt = vsm + (tile % STAGES) * BN * LD;

    // S = Q K^T: one ldmatrix.x4 gives the B fragments of two 8-key blocks.
    float s[NB][4];
#pragma unroll
    for (int n = 0; n < NB; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int n2 = 0; n2 < NB / 2; ++n2) {
        uint32_t kf[4];
        const int key = n2 * 16 + (lane & 7) + ((lane >> 4) << 3);
        const int col = kk * 16 + ((lane >> 3) & 1) * 8;
        ldmatrix_x4(kf, smem_u32(&kt[key * LD + col]));
        mma_bf16(s[2 * n2], qf[kk], kf[0], kf[1]);
        mma_bf16(s[2 * n2 + 1], qf[kk], kf[2], kf[3]);
      }
    }

    // Mask only a tile that straddles the key length or the diagonal.
    const int t0 = tile * BN;
    if (t0 + BN > len || (causal && t0 + BN - 1 > q0)) {
#pragma unroll
      for (int n = 0; n < NB; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = t0 + n * 8 + (lane & 3) * 2 + (e & 1);
          if (key >= len || (causal && key > row0 + (e >> 1) * 8)) s[n][e] = -INFINITY;
        }
      }
    }

    // Online softmax, rows row0 (e = 0, 1) and row0 + 8 (e = 2, 3). The
    // scale (> 0) is applied in f32: max(scale * s) = scale * max(s), and
    // p = 2^(s * scale * log2(e) - m) is one FMA into the exponent.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < NB; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * i], s[n][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx * scale_log2);
      const float base = m_new == -INFINITY ? 0.f : m_new;  // a row with no key yet
      const float corr = fast_exp2(m[i] - base);
      m[i] = m_new;
      l[i] *= corr;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        acc[n][2 * i] *= corr;
        acc[n][2 * i + 1] *= corr;
      }
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        s[n][2 * i] = fast_exp2(fmaf(s[n][2 * i], scale_log2, -base));
        s[n][2 * i + 1] = fast_exp2(fmaf(s[n][2 * i + 1], scale_log2, -base));
        sum += s[n][2 * i] + s[n][2 * i + 1];
      }
      l[i] += sum;
    }

    // O += P V: P's C fragments of two 8-key blocks are one A fragment (hi,
    // then lo); one ldmatrix.x4.trans gives the B fragments of two 8-wide
    // output blocks.
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t ph[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const uint32_t pl[4] = {pack_bf16_rest(s[2 * kk][0], s[2 * kk][1], ph[0]),
                              pack_bf16_rest(s[2 * kk][2], s[2 * kk][3], ph[1]),
                              pack_bf16_rest(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2]),
                              pack_bf16_rest(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3])};
      uint32_t vf[ND / 2][4];
#pragma unroll
      for (int n2 = 0; n2 < ND / 2; ++n2) {
        const int key = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int col = n2 * 16 + (lane >> 4) * 8;
        ldmatrix_x4_trans(vf[n2], smem_u32(&vt[key * LD + col]));
        mma_bf16(acc[2 * n2], ph, vf[n2][0], vf[n2][1]);
        mma_bf16(acc[2 * n2 + 1], ph, vf[n2][2], vf[n2][3]);
      }
#pragma unroll
      for (int n2 = 0; n2 < ND / 2; ++n2) {
        mma_bf16(acc[2 * n2], pl, vf[n2][0], vf[n2][1]);
        mma_bf16(acc[2 * n2 + 1], pl, vf[n2][2], vf[n2][3]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float sum = l[i];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float inv = 1.f / fmaxf(sum, 1e-30f);
    const int row = row0 + i * 8;
    if (row < Sq) {
      bf16* op = o + ((static_cast<long long>(b) * Sq + row) * H + h) * D + (lane & 3) * 2;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        *reinterpret_cast<uint32_t*>(op + n * 8) = pack_bf16(acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
      }
      // m is in log2 units: lse = (m + log2(sum)) ln 2.
      if (lse && (lane & 3) == 0) {
        lse[(static_cast<long long>(b) * H + h) * Sq + row] = sum > 0.f ? (m[i] + log2f(sum)) * LN2 : INFINITY;
      }
    }
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int device = 0;
    if (cudaGetDevice(&device) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess) {
      sms = 132;
    }
  }
  return sms;
}

// Above 48 KB of dynamic shared memory a kernel must be opted in, once per
// device (the attribute is per function and per device context). `device`
// is the current device at the call. Races between threads only repeat the
// same call.
template <int D, int WARPS>
cudaError_t allow_smem(int device, int bytes) {
  static std::atomic<unsigned long long> done{0};  // bit i: opted in on device i
  if (bytes <= 48 * 1024) return cudaSuccess;
  const unsigned long long bit = device >= 0 && device < 64 ? 1ull << device : 0ull;
  if (bit && (done.load() & bit)) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(flash_fwd_tc_kernel<D, WARPS>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

template <int D, int WARPS>
cudaError_t launch_tc(const void* q, const void* k, const void* v, const int* kv_len, void* o, float* lse,
                      int B, int H, int Hkv, int Sq, int Sk, float scale, int causal,
                      Strides qs, Strides ks, Strides vs, int device, cudaStream_t stream) {
  constexpr int BM = 16 * WARPS;
  constexpr int smem = tc_smem_bytes<D, WARPS>();
  static_assert(smem <= 227 * 1024, "more shared memory than a Hopper block can have");
  const cudaError_t err = allow_smem<D, WARPS>(device, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Sq + BM - 1) / BM);
  flash_fwd_tc_kernel<D, WARPS><<<grid, WARPS * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), kv_len,
      static_cast<bf16*>(o), lse, H, Hkv, Sq, Sk, scale * LOG2E, causal, qs, ks, vs);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_tc_d(const void* q, const void* k, const void* v, const int* kv_len, void* o, float* lse,
                        int B, int H, int Hkv, int Sq, int Sk, float scale, int causal,
                        Strides qs, Strides ks, Strides vs, int device, cudaStream_t stream) {
  // Most rows per block that still gives every SM a block. The K/V tiles
  // dominate a block's shared memory (256 of its 272-320 rows), so fewer
  // warps save little of it: at D = 128 a 4-warp block takes 87 KB and two
  // fit an SM, a 1-warp block 74 KB and three fit. The rule therefore
  // counts blocks, not shared memory, at every D.
  const long long heads = static_cast<long long>(B) * H;
  const long long sms = sm_count();
  if (heads * ((Sq + 63) / 64) >= sms) {
    return launch_tc<D, 4>(q, k, v, kv_len, o, lse, B, H, Hkv, Sq, Sk, scale, causal, qs, ks, vs, device, stream);
  }
  if (heads * ((Sq + 31) / 32) >= sms) {
    return launch_tc<D, 2>(q, k, v, kv_len, o, lse, B, H, Hkv, Sq, Sk, scale, causal, qs, ks, vs, device, stream);
  }
  return launch_tc<D, 1>(q, k, v, kv_len, o, lse, B, H, Hkv, Sq, Sk, scale, causal, qs, ks, vs, device, stream);
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
// 16-byte aligned. kv_len: (B,) int32. o: a contiguous (B, Sq, H, D) tensor.
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
    case 1032: err = launch_tc_d<32>(q, k, v, kv_len, o, lse, B, H, Hkv, Sq, Sk, scale, causal, qs, ks, vs, device, s); break;
    case 1064: err = launch_tc_d<64>(q, k, v, kv_len, o, lse, B, H, Hkv, Sq, Sk, scale, causal, qs, ks, vs, device, s); break;
    case 1096: err = launch_tc_d<96>(q, k, v, kv_len, o, lse, B, H, Hkv, Sq, Sk, scale, causal, qs, ks, vs, device, s); break;
    case 1128: err = launch_tc_d<128>(q, k, v, kv_len, o, lse, B, H, Hkv, Sq, Sk, scale, causal, qs, ks, vs, device, s); break;
    default: err = cudaErrorInvalidValue;
  }
  if (prev != device) cudaSetDevice(prev);
  return static_cast<int>(err);
}

const char* vcp_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
