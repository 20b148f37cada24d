// LFM2's gated short convolution between its two projections
// (models/layers.py::ShortConv) for Hopper (sm_90a), plain CUDA C++: one
// kernel forward, one pass backward.
//
// Replaces no Pallas kernel: the JAX package has no short-conv block (LFM2's
// decoder is the port's own). The plain version is ShortConv._gated, _filter
// and _out after in_proj and before out_proj, with autograd's backward of
// them: some 15 passes over (T, dim) tensors a forward (B * x' on strided
// chunks, F.pad, each tap a strided slice cast to f32 and multiplied, C cast
// to f32, the cast back) and more a backward. This file computes the same
// numbers bit for bit, in the plain version's order. With h = in_proj(x) =
// [B | C | x'] (B, S, 3 dim) in the compute dtype T (bf16 or f32) and the
// taps w (dim, K) in f32, for each channel:
//
//   forward   P(t) = T(B(t) x'(t)), 0 before position 0 of the row;
//             y(t) = P(t-K+1) w_0, then + P(t-K+2) w_1, ..., + P(t) w_{K-1},
//             every product and sum rounded to f32 (__fmul_rn / __fadd_rn:
//             no FMA contraction);
//             out(t) = T(y(t) f32(C(t))).
//   backward  from dOut (B, S, dim) in T, y recomputed from h:
//             dC(t) = T(dOut(t) y(t)); dY(t) = dOut(t) f32(C(t)) in f32;
//             dP(t) = T(dY(t) w_{K-1}), then + T(dY(t+1) w_{K-2}), ...,
//             + T(dY(t+K-1) w_0), each sum rounded to T (+0 past the row's
//             end): the order in which autograd's InputBuffer adds the K
//             slices' gradients of the padded product, the last tap's
//             first (tests/test_torch_short_conv.py pins it);
//             dB(t) = T(dP(t) x'(t)), dx'(t) = T(dP(t) B(t)), written with
//             dC as one (B, S, 3 dim) gradient of h, so nothing concatenates;
//             dw_j = sum over every position of dY(t) P(t-K+1+j): each
//             thread's run in f32, its block's runs and then the blocks'
//             partials in f64, in a fixed order and with no atomics, so the
//             same inputs give the same bits.
//
// Bound on this card: bytes. A forward reads h and writes out, 4 T values a
// position and channel; a backward reads h and dOut and writes the gradient
// of h, 7. In a remat'd training step (forward, recompute, backward) that is
// 15 x T x dim x 2 bytes in bf16: 1.506 GB a layer at LFM2's cell (T =
// 24,512, dim 2,048), 0.45 ms at 3.35 TB/s. The arithmetic is a few
// instructions a byte. Each thread takes 16 bytes of channels (8 bf16 or 4
// f32; one element where dim or a pointer does not allow whole vectors) and
// walks a run of RUN positions of one row, so each B and x' is loaded once
// and kept in registers for the K taps that use it (the forward keeps P; the
// backward keeps the raw B and x', which dB and dx' need K - 1 positions
// later, and works P out again); a run re-reads only the K - 1 positions
// before it (and, backward, after it), which its neighbour has just brought
// into L2. A warp's 32 threads read 512 contiguous bytes a load. The
// backward carries dP's K - 1 open sums and the taps' gradient besides, so
// it reads the taps from shared memory: with them in registers too it
// spilled at two blocks an SM and read 49% of its bound on an H100.
//
// Blocks are LANES x RUNS threads: LANES channel vectors side by side, RUNS
// runs. Launches never allocate: the wrapper (kernels/__init__.py) passes the
// output, the gradient and the f64 partials of the taps' gradient, one row
// of dim x K per block row of the grid.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int RUN = 32;    // positions a thread walks (kernels.SHORT_CONV_RUN)
constexpr int LANES = 32;  // channel vectors of a block, one a lane
constexpr int RUNS = 8;    // runs of a block, one a warp (kernels.SHORT_CONV_RUNS_PER_BLOCK)
constexpr int THREADS = LANES * RUNS;
constexpr int TAP_THREADS = 256;

using bf16 = __nv_bfloat16;

// N values of T as one load or store (16 bytes where N * sizeof(T) is 16).
template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// x rounded to T (nearest, ties to even), as a float. bf16 by the packed
// conversion, which runs at full rate (adamw.cu's rnd).
template <typename T>
__device__ __forceinline__ float rnd(float x) {
  if constexpr (std::is_same_v<T, bf16>) {
    unsigned int packed;
    asm("cvt.rn.bf16x2.f32 %0, %1, %1;" : "=r"(packed) : "f"(x));
    return __uint_as_float(packed & 0xffff0000u);
  } else {
    return x;
  }
}

// A float that rnd<T> has rounded, as a T: its upper half for bf16.
template <typename T>
__device__ __forceinline__ T exact(float x) {
  if constexpr (std::is_same_v<T, bf16>) {
    return __ushort_as_bfloat16(static_cast<unsigned short>(__float_as_uint(x) >> 16));
  } else {
    return x;
  }
}

template <typename T, int N>
__device__ __forceinline__ Pack<T, N> load(const T* p) {
  return *reinterpret_cast<const Pack<T, N>*>(p);
}

template <typename T, int N>
__device__ __forceinline__ void unpack(const Pack<T, N>& pk, float (&out)[N]) {
#pragma unroll
  for (int n = 0; n < N; ++n) out[n] = to_f32(pk.v[n]);
}

// Values already rounded to T, stored.
template <typename T, int N>
__device__ __forceinline__ void store(T* p, const float (&in)[N]) {
  Pack<T, N> pk;
#pragma unroll
  for (int n = 0; n < N; ++n) pk.v[n] = exact<T>(in[n]);
  *reinterpret_cast<Pack<T, N>*>(p) = pk;
}

template <typename T, int N>
__device__ __forceinline__ void gate(const Pack<T, N>& b, const Pack<T, N>& x, float (&p)[N]) {
#pragma unroll
  for (int n = 0; n < N; ++n) p[n] = rnd<T>(__fmul_rn(to_f32(b.v[n]), to_f32(x.v[n])));
}

// y of channel n: the taps over P at t-K+1 .. t-1 (win) and t (p).
template <int N, int K>
__device__ __forceinline__ float filter(const float (&win)[K - 1][N], const float (&p)[N], const float (&w)[N][K],
                                        int n) {
  float y = __fmul_rn(win[0][n], w[n][0]);
#pragma unroll
  for (int j = 1; j < K - 1; ++j) y = __fadd_rn(y, __fmul_rn(win[j][n], w[n][j]));
  return __fadd_rn(y, __fmul_rn(p[n], w[n][K - 1]));
}

// The thread's place: channels c0 .. c0 + N - 1, positions t0 .. t1 - 1 of
// the row that starts at position `row` of the (B * S) positions.
struct Place {
  int c0, t0, t1;
  long long row;
};

__device__ __forceinline__ bool place_of(int seq, int dim, int runs_per_row, int runs, int n, Place& pl) {
  const int vec = blockIdx.x * LANES + threadIdx.x;
  const int run = blockIdx.y * RUNS + threadIdx.y;
  if (vec * n >= dim || run >= runs) return false;
  pl.c0 = vec * n;
  pl.t0 = (run % runs_per_row) * RUN;
  pl.t1 = min(pl.t0 + RUN, seq);
  pl.row = static_cast<long long>(run / runs_per_row) * seq;
  return true;
}

template <int N, int K>
__device__ __forceinline__ void load_taps(const float* taps, int c0, float (&w)[N][K]) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int j = 0; j < K; ++j) w[n][j] = taps[(c0 + n) * K + j];
  }
}

template <typename T, int N, int K>
__global__ void __launch_bounds__(THREADS) short_conv_fwd(const T* __restrict__ h, const float* __restrict__ taps,
                                                          T* __restrict__ out, int seq, int dim, int runs_per_row,
                                                          int runs) {
  Place pl;
  if (!place_of(seq, dim, runs_per_row, runs, N, pl)) return;
  const long long stride = 3LL * dim;
  float w[N][K];
  load_taps<N, K>(taps, pl.c0, w);
  float win[K - 1][N];  // P at t - K + 1 .. t - 1
#pragma unroll
  for (int i = 0; i < K - 1; ++i) {
    const int t = pl.t0 - (K - 1) + i;
    if (t >= 0) {
      const T* at = h + (pl.row + t) * stride + pl.c0;
      gate<T, N>(load<T, N>(at), load<T, N>(at + 2 * dim), win[i]);
    } else {
#pragma unroll
      for (int n = 0; n < N; ++n) win[i][n] = 0.f;
    }
  }
  for (int t = pl.t0; t < pl.t1; ++t) {
    const T* at = h + (pl.row + t) * stride + pl.c0;
    const Pack<T, N> b = load<T, N>(at), c = load<T, N>(at + dim), x = load<T, N>(at + 2 * dim);
    float p[N], cf[N], o[N];
    gate<T, N>(b, x, p);
    unpack<T, N>(c, cf);
#pragma unroll
    for (int n = 0; n < N; ++n) o[n] = rnd<T>(__fmul_rn(filter<N, K>(win, p, w, n), cf[n]));
    store<T, N>(out + (pl.row + t) * dim + pl.c0, o);
#pragma unroll
    for (int i = 0; i < K - 2; ++i) {
#pragma unroll
      for (int n = 0; n < N; ++n) win[i][n] = win[i + 1][n];
    }
#pragma unroll
    for (int n = 0; n < N; ++n) win[K - 2][n] = p[n];
  }
}

// The block's taps in shared memory for the backward, tap j of channel
// n of lane x at (n * K + j) * LANES + x: a warp reads one word a lane, with
// no bank conflict, and the registers stay for the sums the walk carries.
template <int N, int K>
__device__ __forceinline__ void stage_taps(const float* __restrict__ taps, int dim, float* sw) {
  const int first = blockIdx.x * LANES * N;  // the block's first channel
  for (int i = threadIdx.y * LANES + threadIdx.x; i < LANES * N * K; i += THREADS) {
    const int ch = i / K;
    if (first + ch < dim) sw[((ch % N) * K + i % K) * LANES + ch / N] = taps[static_cast<long long>(first) * K + i];
  }
}

// The backward's walk: positions o from t0 to t1 + K - 2. Each o < S gives
// dC(o) (stored for o < t1) and dY(o), whose contributions T(dY(o) w_j) go
// to dP at o - K + 1 + j: into the sums so far for j < K - 1, as the first
// term of dP(o) for j = K - 1. dP(o - K + 1) is then whole, and dB and dx'
// there are stored. P at o - K + 1 .. o is worked out again from the raw B
// and x' kept for dB and dx', which costs K products and no registers. acc
// gathers the taps' gradient over the run's own positions.
template <typename T, int N, int K>
__device__ __forceinline__ void bwd_run(const T* __restrict__ h, const T* __restrict__ dout, T* __restrict__ dh,
                                        const float* sw, int seq, int dim, const Place& pl, float (&acc)[N][K]) {
  const long long stride = 3LL * dim;
  const float* tap = sw + threadIdx.x;  // tap j of channel n: tap[(n * K + j) * LANES]
  Pack<T, N> rb[K - 1], rx[K - 1];  // raw B and x' at o - K + 1 .. o - 1, 0 before the row
  float pend[K - 1][N];              // dP there, so far
#pragma unroll
  for (int i = 0; i < K - 1; ++i) {
    const int t = pl.t0 - (K - 1) + i;
    if (t >= 0) {
      const T* at = h + (pl.row + t) * stride + pl.c0;
      rb[i] = load<T, N>(at);
      rx[i] = load<T, N>(at + 2 * dim);
    } else {
#pragma unroll
      for (int n = 0; n < N; ++n) {
        rb[i].v[n] = exact<T>(0.f);
        rx[i].v[n] = exact<T>(0.f);
      }
    }
#pragma unroll
    for (int n = 0; n < N; ++n) pend[i][n] = 0.f;
  }
  for (int o = pl.t0; o < pl.t1 + K - 1; ++o) {
    Pack<T, N> b, x;
    float fresh[N];  // T(dY(o) w_{K-1}), dP(o)'s first term
    if (o < seq) {
      const T* at = h + (pl.row + o) * stride + pl.c0;
      b = load<T, N>(at);
      x = load<T, N>(at + 2 * dim);
      const Pack<T, N> c = load<T, N>(at + dim), g = load<T, N>(dout + (pl.row + o) * dim + pl.c0);
      const bool own = o < pl.t1;
      float dc[N];
#pragma unroll
      for (int n = 0; n < N; ++n) {
        float pw[K];  // P at o - K + 1 .. o
#pragma unroll
        for (int i = 0; i < K - 1; ++i) pw[i] = rnd<T>(__fmul_rn(to_f32(rb[i].v[n]), to_f32(rx[i].v[n])));
        pw[K - 1] = rnd<T>(__fmul_rn(to_f32(b.v[n]), to_f32(x.v[n])));
        float y = __fmul_rn(pw[0], tap[n * K * LANES]);
#pragma unroll
        for (int j = 1; j < K; ++j) y = __fadd_rn(y, __fmul_rn(pw[j], tap[(n * K + j) * LANES]));
        const float gf = to_f32(g.v[n]);
        dc[n] = rnd<T>(__fmul_rn(gf, y));
        const float dy = __fmul_rn(gf, to_f32(c.v[n]));
#pragma unroll
        for (int i = 0; i < K - 1; ++i) {
          pend[i][n] = rnd<T>(__fadd_rn(pend[i][n], rnd<T>(__fmul_rn(dy, tap[(n * K + i) * LANES]))));
        }
        fresh[n] = rnd<T>(__fmul_rn(dy, tap[(n * K + K - 1) * LANES]));
        if (own) {
#pragma unroll
          for (int j = 0; j < K; ++j) acc[n][j] = fmaf(dy, pw[j], acc[n][j]);
        }
      }
      if (own) store<T, N>(dh + (pl.row + o) * stride + dim + pl.c0, dc);
    } else {
      // Past the row's end autograd adds zeros.
#pragma unroll
      for (int n = 0; n < N; ++n) {
        b.v[n] = exact<T>(0.f);
        x.v[n] = exact<T>(0.f);
#pragma unroll
        for (int i = 0; i < K - 1; ++i) pend[i][n] = rnd<T>(__fadd_rn(pend[i][n], 0.f));
        fresh[n] = 0.f;
      }
    }
    const int t = o - (K - 1);
    if (t >= pl.t0) {
      float db[N], dx[N];
#pragma unroll
      for (int n = 0; n < N; ++n) {
        db[n] = rnd<T>(__fmul_rn(pend[0][n], to_f32(rx[0].v[n])));
        dx[n] = rnd<T>(__fmul_rn(pend[0][n], to_f32(rb[0].v[n])));
      }
      T* at = dh + (pl.row + t) * stride + pl.c0;
      store<T, N>(at, db);
      store<T, N>(at + 2 * dim, dx);
    }
#pragma unroll
    for (int i = 0; i < K - 2; ++i) {
      rb[i] = rb[i + 1];
      rx[i] = rx[i + 1];
#pragma unroll
      for (int n = 0; n < N; ++n) pend[i][n] = pend[i + 1][n];
    }
    rb[K - 2] = b;
    rx[K - 2] = x;
#pragma unroll
    for (int n = 0; n < N; ++n) pend[K - 2][n] = fresh[n];
  }
}

// The gradient of h, and the block's partial of the taps' gradient: its RUNS
// runs' sums added in f64 in run order, one f64 a (channel, tap) in row
// blockIdx.y of `partials` (dim x K a row).
template <typename T, int N, int K>
__global__ void __launch_bounds__(THREADS, 2) short_conv_bwd(const T* __restrict__ h, const float* __restrict__ taps,
                                                             const T* __restrict__ dout, T* __restrict__ dh,
                                                             double* __restrict__ partials, int seq, int dim,
                                                             int runs_per_row, int runs) {
  __shared__ float sums[RUNS][LANES * N * K];
  __shared__ float sw[LANES * N * K];
  stage_taps<N, K>(taps, dim, sw);
  __syncthreads();
  float acc[N][K];
#pragma unroll
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int j = 0; j < K; ++j) acc[n][j] = 0.f;
  }
  Place pl;
  if (place_of(seq, dim, runs_per_row, runs, N, pl)) bwd_run<T, N, K>(h, dout, dh, sw, seq, dim, pl, acc);
#pragma unroll
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int j = 0; j < K; ++j) sums[threadIdx.y][(threadIdx.x * N + n) * K + j] = acc[n][j];
  }
  __syncthreads();
  // Entry i of the block's LANES * N * K is channel blockIdx.x * LANES * N + i / K, tap i % K.
  const long long base =
      static_cast<long long>(blockIdx.y) * dim * K + static_cast<long long>(blockIdx.x) * LANES * N * K;
  for (int i = threadIdx.y * LANES + threadIdx.x; i < LANES * N * K; i += THREADS) {
    if (static_cast<int>(blockIdx.x) * LANES * N + i / K < dim) {
      double s = 0.0;
#pragma unroll
      for (int r = 0; r < RUNS; ++r) s += static_cast<double>(sums[r][i]);
      partials[base + i] = s;
    }
  }
}

// dw: each (channel, tap)'s `groups` partials added in f64 in order.
__global__ void __launch_bounds__(TAP_THREADS) short_conv_taps(const double* __restrict__ partials,
                                                                float* __restrict__ dtaps, int groups, int n) {
  const int i = blockIdx.x * TAP_THREADS + threadIdx.x;
  if (i >= n) return;
  double s = 0.0;
  for (int g = 0; g < groups; ++g) s += partials[static_cast<long long>(g) * n + i];
  dtaps[i] = static_cast<float>(s);
}

struct Shape {
  int seq, dim, runs_per_row, runs;
};

template <int N>
dim3 grid_of(const Shape& s) {
  return dim3((s.dim / N + LANES - 1) / LANES, (s.runs + RUNS - 1) / RUNS);
}

template <typename T, int N, int K>
cudaError_t launch_fwd(const void* h, const void* taps, void* out, const Shape& s, cudaStream_t stream) {
  if (s.runs == 0) return cudaSuccess;
  short_conv_fwd<T, N, K><<<grid_of<N>(s), dim3(LANES, RUNS), 0, stream>>>(
      static_cast<const T*>(h), static_cast<const float*>(taps), static_cast<T*>(out), s.seq, s.dim,
      s.runs_per_row, s.runs);
  return cudaGetLastError();
}

template <typename T, int N, int K>
cudaError_t launch_bwd(const void* h, const void* taps, const void* dout, void* dh, void* dtaps, void* partials,
                       const Shape& s, cudaStream_t stream) {
  const dim3 grid = grid_of<N>(s);
  const int groups = s.runs == 0 ? 0 : static_cast<int>(grid.y);
  if (groups > 0) {
    short_conv_bwd<T, N, K><<<grid, dim3(LANES, RUNS), 0, stream>>>(
        static_cast<const T*>(h), static_cast<const float*>(taps), static_cast<const T*>(dout), static_cast<T*>(dh),
        static_cast<double*>(partials), s.seq, s.dim, s.runs_per_row, s.runs);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int n = s.dim * K;
  short_conv_taps<<<(n + TAP_THREADS - 1) / TAP_THREADS, TAP_THREADS, 0, stream>>>(
      static_cast<const double*>(partials), static_cast<float*>(dtaps), groups, n);
  return cudaGetLastError();
}

// The instantiation of a call: dtype 0 f32, 1 bf16; vec 1 for 16-byte
// vectors of channels, 0 for one element; k 2..4 taps.
template <template <typename, int, int> class Op, typename... Args>
cudaError_t dispatch(int dtype, int vec, int k, Args... args) {
#define VCP_SHORT_CONV_TAPS(T, N)                        \
  switch (k) {                                           \
    case 2: return Op<T, N, 2>::run(args...);            \
    case 3: return Op<T, N, 3>::run(args...);            \
    case 4: return Op<T, N, 4>::run(args...);            \
    default: return cudaErrorInvalidValue;               \
  }
  if (dtype == 1) {
    if (vec) { VCP_SHORT_CONV_TAPS(bf16, 8) } else { VCP_SHORT_CONV_TAPS(bf16, 1) }
  } else if (dtype == 0) {
    if (vec) { VCP_SHORT_CONV_TAPS(float, 4) } else { VCP_SHORT_CONV_TAPS(float, 1) }
  }
#undef VCP_SHORT_CONV_TAPS
  return cudaErrorInvalidValue;
}

template <typename T, int N, int K>
struct Fwd {
  static cudaError_t run(const void* h, const void* taps, void* out, Shape s, cudaStream_t stream) {
    return launch_fwd<T, N, K>(h, taps, out, s, stream);
  }
};

template <typename T, int N, int K>
struct Bwd {
  static cudaError_t run(const void* h, const void* taps, const void* dout, void* dh, void* dtaps, void* partials,
                         Shape s, cudaStream_t stream) {
    return launch_bwd<T, N, K>(h, taps, dout, dh, dtaps, partials, s, stream);
  }
};

bool shape_of(int batch, int seq, int dim, Shape* s) {
  if (batch < 0 || seq < 0 || dim < 1) return false;
  s->seq = seq;
  s->dim = dim;
  s->runs_per_row = (seq + RUN - 1) / RUN;
  const long long runs = static_cast<long long>(batch) * s->runs_per_row;
  if ((runs + RUNS - 1) / RUNS > 65535) return false;  // the grid's y dimension
  s->runs = static_cast<int>(runs);
  return true;
}

// Runs `launch` with `device` current, switching back after.
template <typename F>
cudaError_t on_device(int device, F launch) {
  int prev = device;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  err = launch();
  if (prev != device) cudaSetDevice(prev);
  return err;
}

}  // namespace

extern "C" {

// out (batch, seq, dim) = the gated short conv of h (batch, seq, 3 dim) with
// taps (dim, k) f32, all contiguous; dtype 0 f32, 1 bf16 (h and out); vec 1
// where dim fills whole 16-byte vectors and every pointer is 16-byte
// aligned. One launch on `stream` of `device` where there is a position.
// Returns the cudaError_t (0 on success).
int vcp_short_conv_fwd(const void* h, const void* taps, void* out, int batch, int seq, int dim, int k, int dtype,
                       int vec, int device, void* stream) {
  Shape s;
  if (!shape_of(batch, seq, dim, &s)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(on_device(device, [&]() { return dispatch<Fwd>(dtype, vec, k, h, taps, out, s, st); }));
}

// dh (batch, seq, 3 dim) in h's dtype and dtaps (dim, k) f32 from h, taps
// and dout (batch, seq, dim) as the forward took them; partials: f64 scratch
// of ceil(batch * ceil(seq / RUN) / RUNS) x dim x k. The backward's launch
// where there is a position, then the taps' sum. Returns the first
// cudaError_t (0 on success).
int vcp_short_conv_bwd(const void* h, const void* taps, const void* dout, void* dh, void* dtaps, void* partials,
                       int batch, int seq, int dim, int k, int dtype, int vec, int device, void* stream) {
  Shape s;
  if (!shape_of(batch, seq, dim, &s)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(on_device(
      device, [&]() { return dispatch<Bwd>(dtype, vec, k, h, taps, dout, dh, dtaps, partials, s, st); }));
}

const char* vcp_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
