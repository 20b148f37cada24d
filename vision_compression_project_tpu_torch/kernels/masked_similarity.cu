// Masked similarity scoring for Hopper (sm_90a), plain CUDA C++.
//
// Replaces the Pallas TPU kernel
// vision_compression_project_tpu/ops/topk.py::_score_kernel (launched by
// masked_similarity). It computes
//   out[b, n] = <queries[b], emb[n]>   where mask[n] > 0,
//   out[b, n] = -1e30                  elsewhere,
// with both operands upcast to f32 and the sum in f32. emb is (N, D) in f32 or
// bf16, queries (B, D) f32, mask (N,) f32, out (B, N) f32; B <= 8, D % 4 == 0.
//
// Bound on this card: a masked matrix-vector product (B = 1 on the retrieval
// path) does 2*B*D operations per D-element row it reads, far under the ~20
// operations per byte where f32 arithmetic would bound it, so it is bound by
// the bytes of emb. The design only has to stream emb once at full rate: the
// B query rows are staged once per block in shared memory as f32, one warp
// owns one row at a time (grid-stride over rows), each lane loads 4 elements
// of the row per step (16 bytes for f32, 8 for bf16) so that a warp reads
// 512 contiguous bytes at once, the dot products accumulate with f32 FMAs in
// registers and are reduced with warp shuffles, and lane 0 writes the masked
// score. Every row is read whatever its mask, as the Pallas kernel does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_B = 8;
constexpr int BLOCKS_PER_SM = 8;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  __nv_bfloat162 lo, hi;
  memcpy(&lo, &raw.x, sizeof(lo));
  memcpy(&hi, &raw.y, sizeof(hi));
  const float2 a = __bfloat1622float2(lo);
  const float2 b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

template <typename T, int NB>
__global__ void __launch_bounds__(THREADS) masked_similarity_kernel(
    const T* __restrict__ emb, const float* __restrict__ queries, const float* __restrict__ mask,
    float* __restrict__ out, int n, int d) {
  extern __shared__ __align__(16) float qs[];  // NB * d query values
  for (int i = threadIdx.x; i < NB * d; i += THREADS) qs[i] = queries[i];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * WARPS;
  // The row loop is uniform across a warp, so every shuffle has all lanes.
  for (int row = blockIdx.x * WARPS + (threadIdx.x >> 5); row < n; row += stride) {
    const T* e = emb + static_cast<size_t>(row) * d;
    float acc[NB];
#pragma unroll
    for (int b = 0; b < NB; ++b) acc[b] = 0.f;
#pragma unroll 4
    for (int c = lane * 4; c < d; c += 128) {
      const float4 x = load4(e + c);
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const float4 y = *reinterpret_cast<const float4*>(qs + b * d + c);
        acc[b] = fmaf(x.x, y.x, acc[b]);
        acc[b] = fmaf(x.y, y.y, acc[b]);
        acc[b] = fmaf(x.z, y.z, acc[b]);
        acc[b] = fmaf(x.w, y.w, acc[b]);
      }
    }
#pragma unroll
    for (int b = 0; b < NB; ++b) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc[b] += __shfl_xor_sync(0xffffffffu, acc[b], off);
    }
    if (lane == 0) {
      const bool keep = mask[row] > 0.f;
#pragma unroll
      for (int b = 0; b < NB; ++b) out[static_cast<size_t>(b) * n + row] = keep ? acc[b] : NEG_INF;
    }
  }
}

template <typename T, int NB>
cudaError_t launch_b(const void* emb, const float* q, const float* mask, float* out, int n, int d,
                     int grid, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(NB) * d * sizeof(float);
  masked_similarity_kernel<T, NB><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(emb), q, mask, out, n, d);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* emb, const float* q, const float* mask, float* out, int n, int d,
                   int b, int grid, cudaStream_t stream) {
  switch (b) {
    case 1: return launch_b<T, 1>(emb, q, mask, out, n, d, grid, stream);
    case 2: return launch_b<T, 2>(emb, q, mask, out, n, d, grid, stream);
    case 3: return launch_b<T, 3>(emb, q, mask, out, n, d, grid, stream);
    case 4: return launch_b<T, 4>(emb, q, mask, out, n, d, grid, stream);
    case 5: return launch_b<T, 5>(emb, q, mask, out, n, d, grid, stream);
    case 6: return launch_b<T, 6>(emb, q, mask, out, n, d, grid, stream);
    case 7: return launch_b<T, 7>(emb, q, mask, out, n, d, grid, stream);
    case 8: return launch_b<T, 8>(emb, q, mask, out, n, d, grid, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// emb: (N, D) rows, dtype 0 = float32, 1 = bfloat16; queries: (B, D) f32;
// mask: (N,) f32; out: (B, N) f32; all contiguous on the device, emb and
// queries 16-byte aligned. 1 <= B <= 8, D % 4 == 0, B * D * 4 <= 48 KiB.
// Returns the cudaError_t of the launch (0 on success); the kernel runs on
// `stream`.
int vcp_masked_similarity(const void* emb, const void* queries, const void* mask, void* out,
                          int n, int d, int b, int dtype, void* stream) {
  if (n <= 0 || d <= 0 || d % 4 != 0 || b < 1 || b > MAX_B ||
      static_cast<size_t>(b) * d * sizeof(float) > 48 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows_blocks = (n + WARPS - 1) / WARPS;
  const int grid = rows_blocks < sms * BLOCKS_PER_SM ? rows_blocks : sms * BLOCKS_PER_SM;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* q = static_cast<const float*>(queries);
  const float* m = static_cast<const float*>(mask);
  float* o = static_cast<float*>(out);
  if (dtype == 0) {
    err = launch<float>(emb, q, m, o, n, d, b, grid, s);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(emb, q, m, o, n, d, b, grid, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* vcp_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
