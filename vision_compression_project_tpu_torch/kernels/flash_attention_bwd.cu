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
// Three launches (FlashAttention-2's backward, with dQ split off):
//
// * pass 0: Delta = rowsum(dO * O) in f32, (B, H, Sq), into the caller's
//   scratch. dS = P * (dP - Delta) needs it for every query row.
// * pass 1 (dK, dV): a block owns 64 keys of one (batch, kv head) and loops
//   over the H / Hkv query heads that share them and over 64-row query tiles,
//   from the key block's diagonal (causal) to Sq. dK and dV accumulate in f32
//   registers and are written once: GQA is folded inside the block, with no
//   per-head copies, f32 (B, H, Sk, D) buffers or atomics. A key block at or
//   past kv_len writes zeros and does nothing else.
// * pass 2 (dQ): a block owns 16 * WARPS query rows of one (batch, head) and
//   loops over 64-key tiles up to the block's key end, as the forward does;
//   dQ accumulates in f32 registers and is written once.
//
// Splitting dQ from dK/dV keeps every gradient deterministic: each output
// element is summed by one thread in a fixed order, so the same inputs give
// bit-identical dq, dk and dv on every run. The price is Q K^T and dO V^T
// computed in both passes (14 * D operations per query-key pair against
// 10 * D with dQ added by atomics).
//
// Two routes, chosen by dtype:
//
// * bf16 (the training path): tensor cores, mma.sync m16n8k16 bf16 -> f32.
//   Tiles are staged in shared memory through 16-byte cp.async, two in
//   flight, rows of D + 8 bf16 so that ldmatrix's 8 rows hit 8 distinct bank
//   groups. A warp owns 16 rows (keys in pass 1, queries in pass 2). At D <=
//   64 it keeps their two operands (K and V, or Q and dO) as mma A fragments
//   in registers; they arrive through the second stage's slots before the
//   pipeline starts, so the block needs only two tile pairs of shared memory.
//   At D = 96 and 128 the f32 accumulators alone take D (pass 1: dK and dV)
//   or D / 2 (pass 2: dQ) registers a lane, and the fragments would take D /
//   2 more: past the 255 a thread has. There the two operands stay in shared
//   memory slots of their own and each k-step reads its A fragment with
//   ldmatrix (one more ldmatrix.x4 per 16-deep step, against spilling the
//   accumulators to local memory every tile), and pass 1 takes 32 query rows
//   a tile instead of 64, which halves the S^T and dP^T tiles it holds.
//   Pass 1 computes S^T = K Q^T and dP^T = V dO^T (queries as the mma's n),
//   turns S^T into P^T with one FMA and ex2 per element (lse in log2 units),
//   dS^T = P^T (dP^T - Delta), and feeds their C fragments straight back as
//   A fragments into dV += P^T dO and dK += dS^T Q (ldmatrix .trans for dO
//   and Q). Pass 2 computes S = Q K^T and dP = dO V^T, and dQ += dS K
//   (.trans for K). P and dS enter their products as single bf16 terms;
//   every product accumulates in f32. Only a tile that straddles kv_len or
//   the diagonal is masked element by element.
// * f32 (the f32 checks only): scalar kernels, one thread per key (pass 1,
//   K and V in dynamic shared memory, opted in above 48 KB at D = 96 and
//   128; dK and dV in registers) or per query row (pass 2). At D = 96 and 128
//   a thread's rows outgrow the registers and spill to local memory (the
//   -Xptxas -v report says how much); only f32 checks take this route. f32
//   tensor-core math (TF32) would not hold the f32 limit.
//
// Bound on this card: at the training shapes the backward is bound by the
// tensor cores (10 * D operations per query-key pair that the masks leave);
// the bytes (q, k, v, o, dO read once, dq, dk, dv written once) are a tenth
// of that time or less. The design recomputes instead of storing P, reads
// each K/V tile once per key block and each Q/dO tile once per query block,
// and skips the tiles above the diagonal.
//
// Layouts: q, o and dO (B, H, Sq, D), k and v (B, Hkv, Sk, D), dq, dk and dv
// likewise, each given by element strides for batch, head and sequence with
// the last dimension contiguous; the bf16 route needs the input strides to be
// multiples of 8 and the bases 16-byte aligned (cp.async), and every output
// stride even. lse and Delta are contiguous (B, H, Sq) f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cmath>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;
constexpr float LOG2E = 1.4426950408889634f;

struct Strides {
  long long b, h, s;
};

// ----------------------------------------------------------- pass 0: Delta

constexpr int DELTA_WARPS = 8;  // rows per block, one warp per row

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T, int D>
__global__ void __launch_bounds__(DELTA_WARPS * 32) delta_kernel(
    const T* __restrict__ o, const T* __restrict__ g, float* __restrict__ delta,
    int H, int Sq, long long rows, Strides os, Strides gs) {
  const long long r = static_cast<long long>(blockIdx.x) * DELTA_WARPS + (threadIdx.x >> 5);
  if (r >= rows) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  const int s = static_cast<int>(r % Sq);
  const long long bh = r / Sq;
  const int h = static_cast<int>(bh % H);
  const int b = static_cast<int>(bh / H);
  const T* op = o + b * os.b + h * os.h + s * os.s;
  const T* gp = g + b * gs.b + h * gs.h + s * gs.s;
  float acc = 0.f;
#pragma unroll
  for (int d = lane; d < D; d += 32) acc += to_f32(op[d]) * to_f32(gp[d]);
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, w);
  if (lane == 0) delta[r] = acc;
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

constexpr int TILE = 64;   // keys per pass-1 block and per pass-2 tile; query rows per pass-1 tile
constexpr int STAGES = 2;  // tiles in flight
constexpr int PAD = 8;     // bf16 per smem row (16 bytes)
constexpr int KV_WARPS = TILE / 16;

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

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

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

// 2^x with the SFU (ex2.approx, ~2 ulp); 2^-inf = 0.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The C fragments of the 8-wide blocks 2 * kk and 2 * kk + 1 as the A
// fragment of a 16-deep product (PTX ISA, mma.m16n8k16: lane = 4 * g + t; A
// holds rows g, g + 8 and columns 2t, 2t + 1, 2t + 8, 2t + 9; C rows g, g + 8
// and columns 2t, 2t + 1).
template <int N>
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c)[N][4], int kk) {
  a[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// One 16-deep step kk of mma_abt, with A's fragment af for that step.
template <int NB, int LD>
__device__ __forceinline__ void mma_abt_step(float (&acc)[NB][4], const uint32_t (&af)[4], const bf16* t, int kk,
                                             int lane) {
#pragma unroll
  for (int n2 = 0; n2 < NB / 2; ++n2) {
    uint32_t f[4];
    const int row = n2 * 16 + (lane & 7) + ((lane >> 4) << 3);
    const int col = kk * 16 + ((lane >> 3) & 1) * 8;
    ldmatrix_x4(f, smem_u32(&t[row * LD + col]));
    mma_bf16(acc[2 * n2], af, f[0], f[1]);
    mma_bf16(acc[2 * n2 + 1], af, f[2], f[3]);
  }
}

// acc (16 rows x 8 * NB columns) += A (16 rows x D, fragments a) times the
// transpose of the 8 * NB rows x D smem tile t: one ldmatrix.x4 gives the B
// fragments of two 8-row blocks of t.
template <int NB, int KD, int LD>
__device__ __forceinline__ void mma_abt(float (&acc)[NB][4], const uint32_t (&a)[KD][4], const bf16* t, int lane) {
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) mma_abt_step<NB, LD>(acc, a[kk], t, kk, lane);
}

// acc (16 rows x D) += A (16 rows x 16, fragment a) times rows 16 * kk ..
// 16 * kk + 15 of the smem tile t (x D): ldmatrix.x4.trans gives the B
// fragments of two 8-wide column blocks.
template <int ND, int LD>
__device__ __forceinline__ void mma_ab(float (&acc)[ND][4], const uint32_t (&a)[4], const bf16* t, int kk,
                                       int lane) {
#pragma unroll
  for (int n2 = 0; n2 < ND / 2; ++n2) {
    uint32_t f[4];
    const int row = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    const int col = n2 * 16 + (lane >> 4) * 8;
    ldmatrix_x4_trans(f, smem_u32(&t[row * LD + col]));
    mma_bf16(acc[2 * n2], a, f[0], f[1]);
    mma_bf16(acc[2 * n2 + 1], a, f[2], f[3]);
  }
}

// Writes rows row0 and row0 + 8 (< S) of a warp's 16 x D f32 accumulator,
// times mul, as bf16 into out (row stride rs).
template <int ND>
__device__ __forceinline__ void store_rows(bf16* out, long long rs, const float (&acc)[ND][4], float mul,
                                           int row0, int S, int lane) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + i * 8;
    if (row >= S) continue;
    bf16* p = out + row * rs + (lane & 3) * 2;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<uint32_t*>(p + n * 8) = pack_bf16(acc[n][2 * i] * mul, acc[n][2 * i + 1] * mul);
    }
  }
}

// The A fragment (16 rows x 16, rows of LD bf16) of an smem tile's rows 0-15
// at columns 16 * kk .. 16 * kk + 15.
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&af)[4], const bf16* a, int kk, int lane) {
  ldmatrix_x4(af, smem_u32(&a[(lane & 15) * LD + kk * 16 + (lane >> 4) * 8]));
}

// mma_abt with A read from shared memory: acc (16 rows x 8 * NB) += rows
// 0-15 of the smem tile a (x D) times the transpose of the 8 * NB rows of t.
template <int NB, int KD, int LD>
__device__ __forceinline__ void mma_abt_smem(float (&acc)[NB][4], const bf16* a, const bf16* t, int lane) {
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    uint32_t af[4];
    load_a<LD>(af, a, kk, lane);
    mma_abt_step<NB, LD>(acc, af, t, kk, lane);
  }
}

// Where each pass keeps the two operands its warps multiply in every tile
// (registers at D <= 64, shared memory at D = 96 and 128; see the top of the
// file), and pass 1's query rows per tile (32 at D >= 96, else TILE).
template <int D>
__host__ __device__ constexpr bool operands_in_smem() {
  return D >= 96;
}

template <int D>
__host__ __device__ constexpr int dkdv_rows() {
  return operands_in_smem<D>() ? 32 : TILE;
}

// Pass 1. Shared memory (dynamic): STAGES Q tiles, STAGES dO tiles (BQ rows
// of D + PAD bf16 each), at D >= 96 the block's K and V (TILE rows each),
// then STAGES x BQ lse (log2 units) and STAGES x BQ Delta. At D <= 64 (BQ =
// TILE) the block's K and V arrive first in the second Q and dO slots, and
// every warp takes its 16 rows into registers before tile 1 is loaded there.
// Tile t (query head hk * group + t / nqb, query block qb0 + t % nqb) lives
// in slot t % STAGES.
template <int D>
constexpr int dkdv_smem_bytes() {
  return (STAGES * 2 * dkdv_rows<D>() + (operands_in_smem<D>() ? 2 * TILE : 0)) * (D + PAD) *
             static_cast<int>(sizeof(bf16)) +
         STAGES * 2 * dkdv_rows<D>() * static_cast<int>(sizeof(float));
}

template <int D>
__global__ void __launch_bounds__(KV_WARPS * 32) dkdv_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ g, const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ kv_len, bf16* __restrict__ dk, bf16* __restrict__ dv,
    int H, int Hkv, int Sq, int Sk, float scale, float scale_log2, int causal,
    Strides qs, Strides ks, Strides vs, Strides gs, Strides dks, Strides dvs) {
  constexpr bool KV_SMEM = operands_in_smem<D>();
  constexpr int BQ = dkdv_rows<D>();  // query rows per tile
  constexpr int LD = D + PAD;
  constexpr int CH = D / 8;     // 16-byte chunks per row
  constexpr int NT = KV_WARPS * 32;
  constexpr int NB = BQ / 8;    // 8-query blocks per tile
  constexpr int ND = D / 8;     // 8-wide output blocks
  constexpr int KD = D / 16;    // 16-deep steps over D
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qsm = reinterpret_cast<bf16*>(smem_raw);
  bf16* gsm = qsm + STAGES * BQ * LD;
  bf16* ksm = KV_SMEM ? gsm + STAGES * BQ * LD : qsm + TILE * LD;
  bf16* vsm = KV_SMEM ? ksm + TILE * LD : gsm + TILE * LD;
  float* lsm = reinterpret_cast<float*>(qsm + (STAGES * 2 * BQ + (KV_SMEM ? 2 * TILE : 0)) * LD);
  float* dsm = lsm + STAGES * BQ;

  const int b = blockIdx.x / Hkv;
  const int hk = blockIdx.x % Hkv;
  const int group = H / Hkv;
  const int k0 = blockIdx.y * TILE;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int len = kv_len ? max(0, min(kv_len[b], Sk)) : Sk;
  const int qb0 = causal ? k0 / BQ : 0;  // the first query block that sees a key of this block
  const int nqb = k0 < len ? max(0, (Sq + BQ - 1) / BQ - qb0) : 0;
  const int ntiles = group * nqb;
  const int key0 = k0 + warp * 16 + (lane >> 2);  // this lane's keys: key0, key0 + 8

  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
  }

  if (ntiles > 0) {
    const bf16* kp = k + b * ks.b + hk * ks.h;
    const bf16* vp = v + b * vs.b + hk * vs.h;
    for (int i = threadIdx.x; i < TILE * CH; i += NT) {
      const int r = i / CH, c = (i % CH) * 8;
      const bool ok = k0 + r < Sk;
      cp_async16(smem_u32(&ksm[r * LD + c]), ok ? kp + (k0 + r) * ks.s + c : kp, ok);
      cp_async16(smem_u32(&vsm[r * LD + c]), ok ? vp + (k0 + r) * vs.s + c : vp, ok);
    }
    auto load_tile = [&](int t) {
      const int hq = hk * group + t / nqb;
      const int r0 = (qb0 + t % nqb) * BQ;
      const int slot = t % STAGES;
      const bf16* qp = q + b * qs.b + hq * qs.h;
      const bf16* gp = g + b * gs.b + hq * gs.h;
      bf16* qt = qsm + slot * BQ * LD;
      bf16* gt = gsm + slot * BQ * LD;
      for (int i = threadIdx.x; i < BQ * CH; i += NT) {
        const int r = i / CH, c = (i % CH) * 8;
        const bool ok = r0 + r < Sq;
        cp_async16(smem_u32(&qt[r * LD + c]), ok ? qp + (r0 + r) * qs.s + c : qp, ok);
        cp_async16(smem_u32(&gt[r * LD + c]), ok ? gp + (r0 + r) * gs.s + c : gp, ok);
      }
      const long long base = (static_cast<long long>(b) * H + hq) * Sq + r0;
      for (int i = threadIdx.x; i < BQ; i += NT) {
        const bool ok = r0 + i < Sq;  // rows past Sq: P = 2^-inf = 0
        lsm[slot * BQ + i] = ok ? lse[base + i] * LOG2E : INFINITY;
        dsm[slot * BQ + i] = ok ? delta[base + i] : 0.f;
      }
    };
    load_tile(0);
    cp_async_commit();

    const bf16* kw = ksm + warp * 16 * LD;  // this warp's 16 keys
    const bf16* vw = vsm + warp * 16 * LD;
    uint32_t kf[KD][4], vf[KD][4];  // D <= 64: the same rows as A fragments
    for (int t = 0; t < ntiles; ++t) {
      cp_async_wait_all();  // tile t (and at t = 0 K and V) arrived for this thread ...
      __syncthreads();      // ... and every thread's; the slot read last is free
      if constexpr (!KV_SMEM) {
        if (t == 0) {
#pragma unroll
          for (int kk = 0; kk < KD; ++kk) {
            load_a<LD>(kf[kk], kw, kk, lane);
            load_a<LD>(vf[kk], vw, kk, lane);
          }
          __syncthreads();  // every warp holds its K and V: the second slots are free
        }
      }
      if (t + 1 < ntiles) load_tile(t + 1);
      cp_async_commit();

      const int slot = t % STAGES;
      const bf16* qt = qsm + slot * BQ * LD;
      const bf16* gt = gsm + slot * BQ * LD;
      const float* l2 = lsm + slot * BQ;
      const float* dl = dsm + slot * BQ;
      const int r0 = (qb0 + t % nqb) * BQ;

      // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x BQ queries.
      float s[NB][4], dp[NB][4];
#pragma unroll
      for (int n = 0; n < NB; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
      }
      if constexpr (KV_SMEM) {
        mma_abt_smem<NB, KD, LD>(s, kw, qt, lane);
        mma_abt_smem<NB, KD, LD>(dp, vw, gt, lane);
      } else {
        mma_abt<NB, KD, LD>(s, kf, qt, lane);
        mma_abt<NB, KD, LD>(dp, vf, gt, lane);
      }

      // P^T = 2^(scale log2(e) s - lse log2(e)) and dS^T = P^T (dP^T - Delta);
      // keys past kv_len and (causal) keys right of the query are masked,
      // in a tile that straddles either.
      const bool edge = k0 + TILE > len || (causal && k0 + TILE - 1 > r0);
#pragma unroll
      for (int n = 0; n < NB; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = n * 8 + (lane & 3) * 2 + (e & 1);
          float p = fast_exp2(fmaf(s[n][e], scale_log2, -l2[col]));
          if (edge) {
            const int key = key0 + (e >> 1) * 8;
            if (key >= len || (causal && key > r0 + col)) p = 0.f;
          }
          s[n][e] = p;
          dp[n][e] = p * (dp[n][e] - dl[col]);
        }
      }

      // dV += P^T dO and dK += dS^T Q, 16 queries at a time.
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        uint32_t pa[4], da[4];
        c_to_a(pa, s, kk);
        c_to_a(da, dp, kk);
        mma_ab<ND, LD>(dva, pa, gt, kk, lane);
        mma_ab<ND, LD>(dka, da, qt, kk, lane);
      }
    }
    cp_async_wait_all();
  }

  store_rows(dk + b * dks.b + hk * dks.h, dks.s, dka, scale, key0, Sk, lane);
  store_rows(dv + b * dvs.b + hk * dvs.h, dvs.s, dva, 1.f, key0, Sk, lane);
}

// Pass 2. Shared memory (dynamic): STAGES K tiles, then STAGES V tiles,
// each TILE rows of D + PAD bf16, then at D >= 96 the block's Q and dO rows
// (16 * WARPS <= TILE each). At D <= 64 those arrive first in the second K
// and V slots, and every warp takes its rows into registers.
template <int D, int WARPS>
constexpr int dq_smem_bytes() {
  return (STAGES * 2 * TILE + (operands_in_smem<D>() ? 2 * 16 * WARPS : 0)) * (D + PAD) *
         static_cast<int>(sizeof(bf16));
}

template <int D, int WARPS>
__global__ void __launch_bounds__(WARPS * 32) dq_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ g, const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ kv_len, bf16* __restrict__ dq,
    int H, int Hkv, int Sq, int Sk, float scale, float scale_log2, int causal,
    Strides qs, Strides ks, Strides vs, Strides gs, Strides dqs) {
  constexpr bool QG_SMEM = operands_in_smem<D>();
  constexpr int BM = 16 * WARPS;
  static_assert(BM <= TILE, "Q and dO are staged in a K/V slot");
  constexpr int LD = D + PAD;
  constexpr int CH = D / 8;
  constexpr int NT = WARPS * 32;
  constexpr int NB = TILE / 8;  // 8-key blocks per tile
  constexpr int ND = D / 8;
  constexpr int KD = D / 16;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ksm = reinterpret_cast<bf16*>(smem_raw);
  bf16* vsm = ksm + STAGES * TILE * LD;
  bf16* qsm = QG_SMEM ? vsm + STAGES * TILE * LD : ksm + TILE * LD;
  bf16* gsm = QG_SMEM ? qsm + BM * LD : vsm + TILE * LD;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;  // heaviest causal blocks first
  const int hk = h / (H / Hkv);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int len = kv_len ? max(0, min(kv_len[b], Sk)) : Sk;
  const int kend = causal ? min(len, q0 + BM) : len;
  const int ntiles = (kend + TILE - 1) / TILE;
  const int row0 = q0 + warp * 16 + (lane >> 2);  // this lane's rows: row0, row0 + 8

  float dqa[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) dqa[n][0] = dqa[n][1] = dqa[n][2] = dqa[n][3] = 0.f;

  if (ntiles > 0) {
    const bf16* qp = q + b * qs.b + h * qs.h;
    const bf16* gp = g + b * gs.b + h * gs.h;
    const bf16* kp = k + b * ks.b + hk * ks.h;
    const bf16* vp = v + b * vs.b + hk * vs.h;
    for (int i = threadIdx.x; i < BM * CH; i += NT) {
      const int r = i / CH, c = (i % CH) * 8;
      const bool ok = q0 + r < Sq;
      cp_async16(smem_u32(&qsm[r * LD + c]), ok ? qp + (q0 + r) * qs.s + c : qp, ok);
      cp_async16(smem_u32(&gsm[r * LD + c]), ok ? gp + (q0 + r) * gs.s + c : gp, ok);
    }
    auto load_kv = [&](int tile) {
      bf16* kt = ksm + (tile % STAGES) * TILE * LD;
      bf16* vt = vsm + (tile % STAGES) * TILE * LD;
      for (int i = threadIdx.x; i < TILE * CH; i += NT) {
        const int r = i / CH, c = (i % CH) * 8;
        const int key = tile * TILE + r;
        const bool ok = key < kend;
        cp_async16(smem_u32(&kt[r * LD + c]), ok ? kp + key * ks.s + c : kp, ok);
        cp_async16(smem_u32(&vt[r * LD + c]), ok ? vp + key * vs.s + c : vp, ok);
      }
    };
    load_kv(0);
    cp_async_commit();

    float lse2[2], dl[2];  // rows past Sq: P = 2^-inf = 0
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + i * 8;
      const long long idx = (static_cast<long long>(b) * H + h) * Sq + row;
      lse2[i] = row < Sq ? lse[idx] * LOG2E : INFINITY;
      dl[i] = row < Sq ? delta[idx] : 0.f;
    }

    const bf16* qw = qsm + warp * 16 * LD;  // this warp's 16 rows
    const bf16* gw = gsm + warp * 16 * LD;
    uint32_t qf[KD][4], gf[KD][4];  // D <= 64: the same rows as A fragments
    for (int tile = 0; tile < ntiles; ++tile) {
      cp_async_wait_all();
      __syncthreads();
      if constexpr (!QG_SMEM) {
        if (tile == 0) {
#pragma unroll
          for (int kk = 0; kk < KD; ++kk) {
            load_a<LD>(qf[kk], qw, kk, lane);
            load_a<LD>(gf[kk], gw, kk, lane);
          }
          __syncthreads();
        }
      }
      if (tile + 1 < ntiles) load_kv(tile + 1);
      cp_async_commit();
      const bf16* kt = ksm + (tile % STAGES) * TILE * LD;
      const bf16* vt = vsm + (tile % STAGES) * TILE * LD;

      // S = Q K^T and dP = dO V^T: this warp's 16 rows x TILE keys.
      float s[NB][4], dp[NB][4];
#pragma unroll
      for (int n = 0; n < NB; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
      }
      if constexpr (QG_SMEM) {
        mma_abt_smem<NB, KD, LD>(s, qw, kt, lane);
        mma_abt_smem<NB, KD, LD>(dp, gw, vt, lane);
      } else {
        mma_abt<NB, KD, LD>(s, qf, kt, lane);
        mma_abt<NB, KD, LD>(dp, gf, vt, lane);
      }

      const int t0 = tile * TILE;
      const bool edge = t0 + TILE > len || (causal && t0 + TILE - 1 > q0);
#pragma unroll
      for (int n = 0; n < NB; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          float p = fast_exp2(fmaf(s[n][e], scale_log2, -lse2[i]));
          if (edge) {
            const int key = t0 + n * 8 + (lane & 3) * 2 + (e & 1);
            if (key >= len || (causal && key > row0 + i * 8)) p = 0.f;
          }
          dp[n][e] = p * (dp[n][e] - dl[i]);
        }
      }

      // dQ += dS K, 16 keys at a time.
#pragma unroll
      for (int kk = 0; kk < TILE / 16; ++kk) {
        uint32_t da[4];
        c_to_a(da, dp, kk);
        mma_ab<ND, LD>(dqa, da, kt, kk, lane);
      }
    }
    cp_async_wait_all();
  }

  store_rows(dq + b * dqs.b + h * dqs.h, dqs.s, dqa, scale, row0, Sq, lane);
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

// Above 48 KB of dynamic shared memory a kernel must be opted in, once per
// device (the attribute is per function and per device context); `done`
// holds one bit per device for one kernel. Races between threads only
// repeat the same call.
template <typename Kernel>
cudaError_t allow_smem(Kernel* kernel, std::atomic<unsigned long long>& done, int device, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  const unsigned long long bit = device >= 0 && device < 64 ? 1ull << device : 0ull;
  if (bit && (done.load() & bit)) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

template <typename T, int D>
cudaError_t launch_delta(const Args& a) {
  const long long rows = static_cast<long long>(a.B) * a.H * a.Sq;
  const unsigned blocks = static_cast<unsigned>((rows + DELTA_WARPS - 1) / DELTA_WARPS);
  delta_kernel<T, D><<<blocks, DELTA_WARPS * 32, 0, a.stream>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.g), a.delta, a.H, a.Sq, rows, a.os, a.gs);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_scalar(const Args& a) {
  cudaError_t err = launch_delta<float, D>(a);
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

template <int D, int WARPS>
cudaError_t launch_dq_tc(const Args& a, const bf16* q, const bf16* k, const bf16* v, const bf16* g) {
  constexpr int BM = 16 * WARPS;
  constexpr int smem = dq_smem_bytes<D, WARPS>();
  static_assert(smem <= 227 * 1024, "more shared memory than a Hopper block can have");
  static std::atomic<unsigned long long> opted{0};
  const cudaError_t err = allow_smem(dq_tc_kernel<D, WARPS>, opted, a.device, smem);
  if (err != cudaSuccess) return err;
  dq_tc_kernel<D, WARPS><<<dim3(a.B * a.H, (a.Sq + BM - 1) / BM), WARPS * 32, smem, a.stream>>>(
      q, k, v, g, a.lse, a.delta, a.kv_len, static_cast<bf16*>(a.dq), a.H, a.Hkv, a.Sq, a.Sk, a.scale,
      a.scale * LOG2E, a.causal, a.qs, a.ks, a.vs, a.gs, a.dqs);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_tc(const Args& a) {
  cudaError_t err = launch_delta<bf16, D>(a);
  if (err != cudaSuccess) return err;
  const auto* q = static_cast<const bf16*>(a.q);
  const auto* k = static_cast<const bf16*>(a.k);
  const auto* v = static_cast<const bf16*>(a.v);
  const auto* g = static_cast<const bf16*>(a.g);
  constexpr int smem = dkdv_smem_bytes<D>();
  static_assert(smem <= 227 * 1024, "more shared memory than a Hopper block can have");
  static std::atomic<unsigned long long> opted{0};
  err = allow_smem(dkdv_tc_kernel<D>, opted, a.device, smem);
  if (err != cudaSuccess) return err;
  dkdv_tc_kernel<D><<<dim3(a.B * a.Hkv, (a.Sk + TILE - 1) / TILE), KV_WARPS * 32, smem, a.stream>>>(
      q, k, v, g, a.lse, a.delta, a.kv_len, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv),
      a.H, a.Hkv, a.Sq, a.Sk, a.scale, a.scale * LOG2E, a.causal, a.qs, a.ks, a.vs, a.gs, a.dks, a.dvs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // Most rows per block that still gives every SM a block, as the forward.
  const long long heads = static_cast<long long>(a.B) * a.H;
  const long long sms = sm_count();
  if (heads * ((a.Sq + 63) / 64) >= sms) return launch_dq_tc<D, 4>(a, q, k, v, g);
  if (heads * ((a.Sq + 31) / 32) >= sms) return launch_dq_tc<D, 2>(a, q, k, v, g);
  return launch_dq_tc<D, 1>(a, q, k, v, g);
}

}  // namespace

extern "C" {

// One backward (three kernel launches on `stream`). p holds 45 integers: the
// device addresses q, k, v, o, dO, lse, kv_len (0 for "every key valid"),
// dq, dk, dv and delta (f32 scratch of B * H * Sq); B, H, Hkv, Sq, Sk, D,
// causal, dtype (0 = float32, scalar route; 1 = bfloat16, tensor cores); the
// element strides (batch, head, sequence) of q, k, v, o, dO, dq, dk and dv;
// the CUDA device and the stream. Every tensor is of the dtype except lse
// and delta ((B, H, Sq) contiguous f32) and kv_len ((B,) int32). Nothing is
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
