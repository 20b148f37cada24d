// Blockwise flash attention forward for Hopper (sm_90a), plain CUDA C++.
//
// Replaces the Pallas TPU kernel
// vision_compression_project_tpu/ops/attention.py::_flash_kernel (launched by
// _flash_forward). It computes, per (batch, head),
//   O = softmax(scale * Q K^T + mask) V
// with an online softmax: running max, sum and accumulator in f32, q scaled in
// f32 before the dot product, key mask k < kv_len[b], optional causal mask
// k <= q, GQA through kv head h / (H / Hkv), masked scores at -1e30 and output
// acc / max(l, 1e-30) in the input type. A row whose key range is empty
// (kv_len == 0) gives 0, as the Pallas loop over zero blocks does.
//
// Bound on this card: at the shapes of the page-extraction path (S = 256 to
// 1152, D = 32 or 64) the operations (4*S*S*D per head) outweigh the bytes
// (4*S*D elements per head), so the tensor cores bound it. This first version
// does not use them: one thread owns one query row and keeps q and the
// accumulator in registers, a block of BM rows stages BN keys and values at a
// time in shared memory as f32, and every thread reads the same key element at
// once (a shared-memory broadcast). It is scalar f32 FMA work; wgmma tiles and
// TMA staging are the way to the tensor-core bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;     // query rows per block (one thread per row)
constexpr int BN = 64;     // keys staged in shared memory per tile
constexpr int CHUNK = 16;  // keys scored at a time in registers
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T, int D>
__global__ void __launch_bounds__(BM) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ kv_len, T* __restrict__ o,
    int H, int Hkv, int Sq, int Sk, float scale, int causal) {
  __shared__ __align__(16) float ks[BN][D];
  __shared__ __align__(16) float vs[BN][D];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * BM;
  const int row = q0 + threadIdx.x;
  const int hk = h / (H / Hkv);

  // Keys at or past kend are masked for every row of this block: past the
  // valid length, or (causal) right of the block's last row.
  const int len = max(0, min(kv_len[b], Sk));
  const int kend = causal ? min(len, q0 + BM) : len;

  const T* qp = q + (static_cast<size_t>(b) * H + h) * Sq * D;
  const T* kp = k + (static_cast<size_t>(b) * Hkv + hk) * Sk * D;
  const T* vp = v + (static_cast<size_t>(b) * Hkv + hk) * Sk * D;
  T* op = o + (static_cast<size_t>(b) * H + h) * Sq * D;

  const bool live = row < Sq;
  float qr[D];
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = live ? to_f32(qp[static_cast<size_t>(row) * D + d]) * scale : 0.f;
    acc[d] = 0.f;
  }
  float m = NEG_INF;
  float l = 0.f;

  for (int t0 = 0; t0 < kend; t0 += BN) {
    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < BN * D; i += BM) {
      const int r = i / D;
      const int c = i % D;
      const int kr = t0 + r;
      const bool in = kr < kend;
      ks[r][c] = in ? to_f32(kp[static_cast<size_t>(kr) * D + c]) : 0.f;
      vs[r][c] = in ? to_f32(vp[static_cast<size_t>(kr) * D + c]) : 0.f;
    }
    __syncthreads();

    const int tn = min(BN, kend - t0);
    for (int j0 = 0; j0 < tn; j0 += CHUNK) {
      float s[CHUNK];
      bool ok[CHUNK];
      float cmax = NEG_INF;
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) {
        const int key = t0 + j0 + j;
        ok[j] = (j0 + j < tn) && (!causal || key <= row);
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) dot += qr[d] * ks[j0 + j][d];
        s[j] = ok[j] ? dot : NEG_INF;
        cmax = fmaxf(cmax, s[j]);
      }
      const float m_new = fmaxf(m, cmax);
      const float corr = expf(m - m_new);
      l *= corr;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= corr;
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) {
        const float p = ok[j] ? expf(s[j] - m_new) : 0.f;
        l += p;
#pragma unroll
        for (int d = 0; d < D; ++d) acc[d] += p * vs[j0 + j][d];
      }
      m = m_new;
    }
  }

  if (live) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int d = 0; d < D; ++d) store(&op[static_cast<size_t>(row) * D + d], acc[d] * inv);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const int* kv_len, void* o,
                   int B, int H, int Hkv, int Sq, int Sk, int D, float scale, int causal,
                   cudaStream_t stream) {
  const dim3 grid((Sq + BM - 1) / BM, H, B);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(o);
  if (D == 32) {
    flash_fwd_kernel<T, 32><<<grid, BM, 0, stream>>>(qt, kt, vt, kv_len, ot, H, Hkv, Sq, Sk, scale, causal);
  } else if (D == 64) {
    flash_fwd_kernel<T, 64><<<grid, BM, 0, stream>>>(qt, kt, vt, kv_len, ot, H, Hkv, Sq, Sk, scale, causal);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, o: (B, H, Sq, D); k, v: (B, Hkv, Sk, D); kv_len: (B,) int32; all
// contiguous on the device. dtype: 0 = float32, 1 = bfloat16. Returns the
// cudaError_t of the launch (0 on success); the kernel runs on `stream`.
int vcp_flash_attention_fwd(const void* q, const void* k, const void* v, const int* kv_len, void* o,
                            int B, int H, int Hkv, int Sq, int Sk, int D, float scale, int causal,
                            int dtype, void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || Sq <= 0 || Sk <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float>(q, k, v, kv_len, o, B, H, Hkv, Sq, Sk, D, scale, causal, s);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(q, k, v, kv_len, o, B, H, Hkv, Sq, Sk, D, scale, causal, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* vcp_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
