// AdamW for Hopper (sm_90a), plain CUDA C++: optax's
// chain(clip_by_global_norm(max_norm), adamw(b1, b2, eps, weight_decay)) over
// every parameter leaf of a training step, in place.
//
// Replaces no Pallas kernel: the JAX package leaves the optimizer to XLA. The
// plain version is train/train_step.py::AdamW._plain_update (the clip's norm
// of each leaf, then 18 `_foreach` passes over the leaf lists of each dtype);
// this file computes the same numbers bit for bit from the same sums of
// squares. Each leaf is f32 or bf16, and its arithmetic is done in f32 with a
// rounding to the leaf's dtype after every operation, constants first rounded
// to that dtype on the host: what the plain version does to a bf16 leaf, one
// `_foreach` operation at a time. The intrinsics (__fmul_rn, __fadd_rn,
// __fdiv_rn, __fsqrt_rn) keep nvcc from contracting a product and a sum into
// one FMA, which would round once where the plain version rounds twice.
//
// Bound on this card: bytes, but not by much. The fused minimum per element
// is to read g for the norm, then read p, g, mu and nu and write p, mu and
// nu: 16 bytes for a bf16 leaf, 32 for an f32 one (the plain version moves
// about 85 for bf16: each `_foreach` pass reads and writes whole lists), so
// 10.36 ms at prod_train's 1.61B bf16 and 0.28B f32 elements. The
// arithmetic is some 100 instructions a bf16 element (four IEEE quotients,
// an IEEE square root, 18 roundings to bf16), about 6 a byte against the 9
// or so the card executes for each byte it moves: the update streams each
// array once at full rate and keeps every intermediate in registers, and
// what it computes has to stay cheap enough to hide under the loads. On an
// H100 (700 W) the update read 11.0-11.2 ms from a CUDA graph at
// prod_train's leaves, against 10.4-10.6 ms for the same loads and stores
// with the arithmetic taken out; at lower clocks after sustained load it
// read 14.2 ms, where the arithmetic shows.
//
//  - sums of squares (when the clip is on): adamw_sumsq_partial, persistent
//    blocks over CHUNK-element chunks of every gradient, 16-byte loads, one
//    f32 partial sum per chunk; adamw_sumsq_finish, one block per leaf,
//    sums the leaf's partials in a fixed order into sq[leaf]. No atomics:
//    the same gradients give the same bits.
//  - the update: adamw_update, persistent blocks over the same chunks. Each
//    block first works out the global norm from sq, the same way in every
//    block: each leaf's sum rounded to its dtype, summed in f32 in leaf order,
//    then the square root, so whether the clip applies is decided on the card
//    and nothing goes to the host. Then it streams p, g, mu and nu with
//    16-byte loads (8 bf16 or 4 f32 a load; the ragged tail of a leaf, and a
//    leaf whose pointers are not 16-byte aligned, element by element) and
//    writes p, mu and nu. The gradient is read and never written. Each
//    thread loads its next slot's 16 bytes of each array before it
//    computes the current slot, across chunks and leaves, so that a warp
//    has loads in flight while it computes (2-5% faster than loading each
//    slot when it is computed).
//
// Each launch takes every leaf of the update in one table, its kernel
// argument (pointers, sizes, kinds and each leaf's first chunk): up to
// MAX_LEAVES leaves, which fill the 32,764 bytes of kernel arguments that
// CUDA 12.1 and later take on sm_70 and later (`__grid_constant__`, read in
// place). So an update is three launches, or one without the clip; the
// wrapper (kernels/__init__.py) refuses more leaves. A block finds its
// chunk's leaf by a binary search of the table's chunk starts. Element
// offsets are 64-bit; chunk indices 32-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = 8192;       // elements of a chunk (kernels.ADAMW_CHUNK)
constexpr int MAX_LEAVES = 700;   // leaves of an update (kernels.ADAMW_MAX_LEAVES)
constexpr int KIND_BF16 = 1;      // Table::kind bits
constexpr int KIND_ALIGNED = 2;   // every pointer of the leaf 16-byte aligned

struct Table {
  int n_leaves;
  int chunk_start[MAX_LEAVES + 1];  // the leaves' first chunks; chunk_start[n_leaves] = the update's chunks
  long long numel[MAX_LEAVES];
  unsigned char kind[MAX_LEAVES];
  const void* g[MAX_LEAVES];
  void* p[MAX_LEAVES];
  void* mu[MAX_LEAVES];
  void* nu[MAX_LEAVES];
};

// The constants of one dtype, each rounded to it on the host.
struct Consts {
  float b1, omb1, b2, omb2, bc1, bc2, eps, wd, neg_lr, max_norm;
};

struct SumsqArgs {
  Table t;
  float* partials;  // one per chunk
  float* sq;        // one per leaf
};

struct UpdateArgs {
  Table t;
  Consts c[2];      // [0] f32 leaves, [1] bf16 leaves
  const float* sq;  // the leaves' sums of squares, or null without the clip
  float max_norm;   // the clip's threshold in f32, which the norm is compared with
  int has_wd;
};

// CUDA's limit on a kernel's arguments from 12.1 on (sm_70 and later).
constexpr size_t MAX_ARG_BYTES = 32764;
static_assert(sizeof(UpdateArgs) <= MAX_ARG_BYTES, "the update's table must fit the kernel arguments");
static_assert(sizeof(SumsqArgs) <= MAX_ARG_BYTES, "the sums' table must fit the kernel arguments");

__device__ __forceinline__ int leaf_of(const Table& t, int chunk) {
  // The last leaf whose first chunk is at or before `chunk` (empty leaves
  // share their successor's start and are passed over).
  int lo = 0, hi = t.n_leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.chunk_start[mid] <= chunk) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// The block's sum of one value a thread, in a fixed order: a shuffle tree in
// each warp, then the warps' sums in order. Valid in thread 0; `scratch`
// holds WARPS floats. Ends with a barrier, so scratch can be reused.
__device__ __forceinline__ float block_sum(float x, float* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = x;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += scratch[w];
  }
  __syncthreads();
  return s;
}

// x rounded to the nearest bf16 (ties to even) if BF16, as a float. The
// packed conversion (cvt.rn.bf16x2.f32, x into the upper half, whose bits
// are then the float's) runs at full rate; the single one that
// __float2bfloat16_rn compiles to (F2F) at a quarter of it, and with 18
// roundings an element it was the update's largest cost.
template <bool BF16>
__device__ __forceinline__ float rnd(float x) {
  if constexpr (BF16) {
    unsigned int packed;
    asm("cvt.rn.bf16x2.f32 %0, %1, %1;" : "=r"(packed) : "f"(x));
    return __uint_as_float(packed & 0xffff0000u);
  } else {
    return x;
  }
}

template <bool BF16>
__device__ __forceinline__ float load1(const void* base, long long i) {
  if constexpr (BF16) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(base)[i]);
  } else {
    return static_cast<const float*>(base)[i];
  }
}

template <bool BF16>
__device__ __forceinline__ void store1(void* base, long long i, float x) {
  if constexpr (BF16) {
    static_cast<__nv_bfloat16*>(base)[i] = __float2bfloat16_rn(x);
  } else {
    static_cast<float*>(base)[i] = x;
  }
}

// 16 bytes at a byte offset (16-byte aligned), as loaded.
__device__ __forceinline__ uint4 load16(const void* base, long long byte) {
  return *reinterpret_cast<const uint4*>(static_cast<const char*>(base) + byte);
}

// 16 loaded bytes as floats: 8 bf16 or 4 f32.
template <bool BF16>
__device__ __forceinline__ void unpack(uint4 raw, float* out) {
  const unsigned int w[4] = {raw.x, raw.y, raw.z, raw.w};
  if constexpr (BF16) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      __nv_bfloat162 pair;
      memcpy(&pair, &w[k], sizeof(pair));
      const float2 f = __bfloat1622float2(pair);
      out[2 * k] = f.x;
      out[2 * k + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) out[k] = __uint_as_float(w[k]);
  }
}

template <bool BF16>
__device__ __forceinline__ void store_vec(void* base, long long i, const float* in) {
  if constexpr (BF16) {
    unsigned int w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const __nv_bfloat162 pair = __floats2bfloat162_rn(in[2 * k], in[2 * k + 1]);
      memcpy(&w[k], &pair, sizeof(pair));
    }
    *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(base) + i) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    *reinterpret_cast<float4*>(static_cast<float*>(base) + i) = make_float4(in[0], in[1], in[2], in[3]);
  }
}

template <bool BF16>
__device__ float chunk_sumsq(const void* g, long long begin, long long end, bool aligned) {
  constexpr int VEC = BF16 ? 8 : 4;
  float acc = 0.f;
  if (aligned) {
    for (long long e = begin + static_cast<long long>(threadIdx.x) * VEC; e < end; e += THREADS * VEC) {
      if (e + VEC <= end) {
        float x[VEC];
        unpack<BF16>(load16(g, e * (BF16 ? 2 : 4)), x);
#pragma unroll
        for (int k = 0; k < VEC; ++k) acc = fmaf(x[k], x[k], acc);
      } else {
        for (long long i = e; i < end; ++i) {
          const float x = load1<BF16>(g, i);
          acc = fmaf(x, x, acc);
        }
      }
    }
  } else {
    for (long long i = begin + threadIdx.x; i < end; i += THREADS) {
      const float x = load1<BF16>(g, i);
      acc = fmaf(x, x, acc);
    }
  }
  return acc;
}

__global__ void __launch_bounds__(THREADS) adamw_sumsq_partial(const __grid_constant__ SumsqArgs a) {
  __shared__ float scratch[WARPS];
  const Table& t = a.t;
  const int chunks = t.chunk_start[t.n_leaves];
  for (int c = blockIdx.x; c < chunks; c += gridDim.x) {
    const int leaf = leaf_of(t, c);
    const long long begin = static_cast<long long>(c - t.chunk_start[leaf]) * CHUNK;
    const long long end = begin + CHUNK < t.numel[leaf] ? begin + CHUNK : t.numel[leaf];
    const bool aligned = t.kind[leaf] & KIND_ALIGNED;
    const float acc = (t.kind[leaf] & KIND_BF16) ? chunk_sumsq<true>(t.g[leaf], begin, end, aligned)
                                                 : chunk_sumsq<false>(t.g[leaf], begin, end, aligned);
    const float s = block_sum(acc, scratch);
    if (threadIdx.x == 0) a.partials[c] = s;
  }
}

__global__ void __launch_bounds__(THREADS) adamw_sumsq_finish(const __grid_constant__ SumsqArgs a) {
  __shared__ float scratch[WARPS];
  const Table& t = a.t;
  const int leaf = blockIdx.x;
  float acc = 0.f;
  for (int c = t.chunk_start[leaf] + threadIdx.x; c < t.chunk_start[leaf + 1]; c += THREADS) acc += a.partials[c];
  const float s = block_sum(acc, scratch);
  if (threadIdx.x == 0) a.sq[leaf] = s;
}

// One element of optax's clip-and-AdamW in the plain version's order, every
// result rounded to the leaf's dtype (rnd is the identity for f32).
template <bool BF16>
__device__ __forceinline__ void adam(float& p, float g, float& m, float& v, const Consts& c, bool clip,
                                     float norm, bool has_wd) {
  if (clip) {
    g = rnd<BF16>(__fdiv_rn(g, norm));
    g = rnd<BF16>(__fmul_rn(g, c.max_norm));
  }
  m = rnd<BF16>(__fadd_rn(rnd<BF16>(__fmul_rn(m, c.b1)), rnd<BF16>(__fmul_rn(g, c.omb1))));
  v = rnd<BF16>(__fadd_rn(rnd<BF16>(__fmul_rn(v, c.b2)), rnd<BF16>(__fmul_rn(rnd<BF16>(__fmul_rn(g, g)), c.omb2))));
  const float d = rnd<BF16>(__fadd_rn(rnd<BF16>(__fsqrt_rn(rnd<BF16>(__fdiv_rn(v, c.bc2)))), c.eps));
  float s = rnd<BF16>(__fdiv_rn(rnd<BF16>(__fdiv_rn(m, c.bc1)), d));
  if (has_wd) s = rnd<BF16>(__fadd_rn(s, rnd<BF16>(__fmul_rn(p, c.wd))));
  p = rnd<BF16>(__fadd_rn(p, rnd<BF16>(__fmul_rn(s, c.neg_lr))));
}

// One thread's place in the update's stream: the 16-byte vector slot at
// element e of a leaf (8 bf16 or 4 f32 elements, fewer at a leaf's ragged
// end), inside chunk `chunk`, whose elements end at `end`.
struct Slot {
  int chunk;  // -1 once the block's chunks are done
  int leaf;
  long long e;
  long long end;
};

__device__ __forceinline__ int vec_of(const Table& t, int leaf) { return (t.kind[leaf] & KIND_BF16) ? 8 : 4; }

// The thread's first slot in chunk c or, where it has none there (a short
// last chunk of a leaf), in the block's next chunks.
__device__ __forceinline__ void first_slot(const Table& t, int c, int chunks, Slot& s) {
  for (; c < chunks; c += gridDim.x) {
    const int leaf = leaf_of(t, c);
    const long long begin = static_cast<long long>(c - t.chunk_start[leaf]) * CHUNK;
    const long long e = begin + static_cast<long long>(threadIdx.x) * vec_of(t, leaf);
    const long long end = begin + CHUNK < t.numel[leaf] ? begin + CHUNK : t.numel[leaf];
    if (e < end) {
      s = Slot{c, leaf, e, end};
      return;
    }
  }
  s.chunk = -1;
}

__device__ __forceinline__ void next_slot(const Table& t, int chunks, Slot& s) {
  s.e += static_cast<long long>(THREADS) * vec_of(t, s.leaf);
  if (s.e >= s.end) first_slot(t, s.chunk + gridDim.x, chunks, s);
}

// Whether the slot is read and written as whole 16-byte vectors.
__device__ __forceinline__ bool whole(const Table& t, const Slot& s) {
  return (t.kind[s.leaf] & KIND_ALIGNED) && s.e + vec_of(t, s.leaf) <= s.end;
}

// The 16 bytes of p, g, mu and nu at a whole slot, as loaded.
struct Raw {
  uint4 p, g, mu, nu;
};

__device__ __forceinline__ void load_raw(const Table& t, const Slot& s, Raw& r) {
  const long long byte = s.e * ((t.kind[s.leaf] & KIND_BF16) ? 2 : 4);
  r.p = load16(t.p[s.leaf], byte);
  r.g = load16(t.g[s.leaf], byte);
  r.mu = load16(t.mu[s.leaf], byte);
  r.nu = load16(t.nu[s.leaf], byte);
}

// A whole slot: its loaded bytes through adam(), the results stored.
template <bool BF16>
__device__ __forceinline__ void update_whole(const Table& t, const Slot& s, const Raw& r, const Consts& c, bool clip,
                                             float norm_t, bool has_wd) {
  constexpr int VEC = BF16 ? 8 : 4;
  float xp[VEC], xg[VEC], xm[VEC], xv[VEC];
  unpack<BF16>(r.p, xp);
  unpack<BF16>(r.g, xg);
  unpack<BF16>(r.mu, xm);
  unpack<BF16>(r.nu, xv);
#pragma unroll
  for (int k = 0; k < VEC; ++k) adam<BF16>(xp[k], xg[k], xm[k], xv[k], c, clip, norm_t, has_wd);
  store_vec<BF16>(t.p[s.leaf], s.e, xp);
  store_vec<BF16>(t.mu[s.leaf], s.e, xm);
  store_vec<BF16>(t.nu[s.leaf], s.e, xv);
}

// A slot at a leaf's ragged end, or of a leaf not 16-byte aligned: element
// by element.
template <bool BF16>
__device__ void update_elements(const Table& t, const Slot& s, const Consts& c, bool clip, float norm_t,
                                bool has_wd) {
  const long long stop = s.e + (BF16 ? 8 : 4) < s.end ? s.e + (BF16 ? 8 : 4) : s.end;
  for (long long i = s.e; i < stop; ++i) {
    float xp = load1<BF16>(t.p[s.leaf], i), xm = load1<BF16>(t.mu[s.leaf], i), xv = load1<BF16>(t.nu[s.leaf], i);
    adam<BF16>(xp, load1<BF16>(t.g[s.leaf], i), xm, xv, c, clip, norm_t, has_wd);
    store1<BF16>(t.p[s.leaf], i, xp);
    store1<BF16>(t.mu[s.leaf], i, xm);
    store1<BF16>(t.nu[s.leaf], i, xv);
  }
}

__global__ void __launch_bounds__(THREADS) adamw_update(const __grid_constant__ UpdateArgs a) {
  __shared__ float vals[THREADS];
  __shared__ float norm_s;
  const Table& t = a.t;
  bool clip = false;
  float norm = 0.f;
  if (a.sq != nullptr) {
    // The global norm, as the plain version sums it: each leaf's sum of
    // squares rounded to the leaf's dtype, added in f32 in leaf order.
    float acc = 0.f;
    for (int base = 0; base < t.n_leaves; base += THREADS) {
      const int i = base + threadIdx.x;
      if (i < t.n_leaves) {
        const float s = a.sq[i];
        vals[threadIdx.x] = (t.kind[i] & KIND_BF16) ? rnd<true>(s) : s;
      }
      __syncthreads();
      if (threadIdx.x == 0) {
        const int n = t.n_leaves - base < THREADS ? t.n_leaves - base : THREADS;
        for (int j = 0; j < n; ++j) acc = __fadd_rn(acc, vals[j]);
      }
      __syncthreads();
    }
    if (threadIdx.x == 0) norm_s = __fsqrt_rn(acc);
    __syncthreads();
    norm = norm_s;
    clip = norm >= a.max_norm;
  }
  // The norm as the plain version divides by it: in each leaf's dtype.
  const float norm_f32 = norm, norm_bf16 = rnd<true>(norm);
  const bool has_wd = a.has_wd;
  const int chunks = t.chunk_start[t.n_leaves];
  // Each thread walks its slots of the block's chunks (blockIdx.x, then
  // every gridDim.x-th), loading the next whole slot's 16 bytes of p, g, mu
  // and nu before it computes the current one, so that a warp's loads are
  // in flight while it computes.
  Slot cur;
  first_slot(t, blockIdx.x, chunks, cur);
  Raw raw_cur, raw_next;
  if (cur.chunk >= 0 && whole(t, cur)) load_raw(t, cur, raw_cur);
  while (cur.chunk >= 0) {
    Slot next = cur;
    next_slot(t, chunks, next);
    if (next.chunk >= 0 && whole(t, next)) load_raw(t, next, raw_next);
    const bool bf16 = t.kind[cur.leaf] & KIND_BF16;
    if (whole(t, cur)) {
      if (bf16) {
        update_whole<true>(t, cur, raw_cur, a.c[1], clip, norm_bf16, has_wd);
      } else {
        update_whole<false>(t, cur, raw_cur, a.c[0], clip, norm_f32, has_wd);
      }
    } else if (bf16) {
      update_elements<true>(t, cur, a.c[1], clip, norm_bf16, has_wd);
    } else {
      update_elements<false>(t, cur, a.c[0], clip, norm_f32, has_wd);
    }
    cur = next;
    raw_cur = raw_next;
  }
}

// The table from the wrapper's int64 words: chunk_start (n + 1), numel (n),
// kind (n), then the device addresses g, p, mu, nu (n each).
bool read_table(const long long* w, int n, Table* t) {
  if (n < 1 || n > MAX_LEAVES) return false;
  memset(t, 0, sizeof(*t));
  t->n_leaves = n;
  for (int i = 0; i <= n; ++i) {
    if (w[i] < 0 || w[i] > INT32_MAX || (i > 0 && w[i] < w[i - 1])) return false;
    t->chunk_start[i] = static_cast<int>(w[i]);
  }
  w += n + 1;
  for (int i = 0; i < n; ++i) {
    const long long want = (w[i] + CHUNK - 1) / CHUNK;
    if (w[i] < 0 || t->chunk_start[i + 1] - t->chunk_start[i] != want) return false;
    t->numel[i] = w[i];
  }
  w += n;
  for (int i = 0; i < n; ++i) t->kind[i] = static_cast<unsigned char>(w[i]);
  w += n;
  for (int i = 0; i < n; ++i) t->g[i] = reinterpret_cast<const void*>(w[i]);
  w += n;
  for (int i = 0; i < n; ++i) t->p[i] = reinterpret_cast<void*>(w[i]);
  w += n;
  for (int i = 0; i < n; ++i) t->mu[i] = reinterpret_cast<void*>(w[i]);
  w += n;
  for (int i = 0; i < n; ++i) t->nu[i] = reinterpret_cast<void*>(w[i]);
  return true;
}

// Resident blocks of a kernel (`which`: 0 the partial sums, 1 the update)
// on all of one device's SMs, found once a device.
template <typename K>
cudaError_t persistent_grid(K kernel, int which, int device, int* grid) {
  static int cached[2][64];  // 0 until found
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (cached[which][device] == 0) {
    int sms = 0, per_sm = 0;
    cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0);
    if (err != cudaSuccess) return err;
    cached[which][device] = sms * (per_sm > 0 ? per_sm : 1);
  }
  *grid = cached[which][device];
  return cudaSuccess;
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

// The sums of squares of every gradient of the update: table as read_table
// reads it (n leaves, 1 <= n <= MAX_LEAVES); partials: one f32 per chunk; sq:
// one f32 per leaf. Launches on `stream` of `device` the partial sums (where
// a leaf has elements), then the leaves' sums, and counts each launch made
// into *launched. Returns the first cudaError_t (0 on success).
int vcp_adamw_sumsq(const long long* table, int n, void* partials, void* sq, int device, void* stream,
                    int* launched) {
  *launched = 0;
  SumsqArgs a;
  if (!read_table(table, n, &a.t)) return static_cast<int>(cudaErrorInvalidValue);
  a.partials = static_cast<float*>(partials);
  a.sq = static_cast<float*>(sq);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(on_device(device, [&]() {
    const int chunks = a.t.chunk_start[n];
    if (chunks > 0) {
      int grid = 0;
      cudaError_t err = persistent_grid(adamw_sumsq_partial, 0, device, &grid);
      if (err != cudaSuccess) return err;
      adamw_sumsq_partial<<<chunks < grid ? chunks : grid, THREADS, 0, s>>>(a);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
      ++*launched;
    }
    adamw_sumsq_finish<<<n, THREADS, 0, s>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err == cudaSuccess) ++*launched;
    return err;
  }));
}

// Every leaf of the update in place: consts the 10 constants for f32 leaves
// then the 10 for bf16 ones, in Consts' order, each rounded to its dtype; sq
// the leaves' sums of squares, or null for no clip; max_norm the clip's
// threshold in f32. One launch on `stream` of `device` where a leaf has
// elements, counted into *launched. Returns its cudaError_t (0 on success).
int vcp_adamw_update(const long long* table, int n, const float* consts, const void* sq, float max_norm,
                     int has_wd, int device, void* stream, int* launched) {
  *launched = 0;
  UpdateArgs a;
  if (!read_table(table, n, &a.t)) return static_cast<int>(cudaErrorInvalidValue);
  memcpy(a.c, consts, sizeof(a.c));
  a.sq = static_cast<const float*>(sq);
  a.max_norm = max_norm;
  a.has_wd = has_wd;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(on_device(device, [&]() {
    const int chunks = a.t.chunk_start[n];
    if (chunks == 0) return cudaSuccess;
    int grid = 0;
    cudaError_t err = persistent_grid(adamw_update, 1, device, &grid);
    if (err != cudaSuccess) return err;
    adamw_update<<<chunks < grid ? chunks : grid, THREADS, 0, s>>>(a);
    err = cudaGetLastError();
    if (err == cudaSuccess) *launched = 1;
    return err;
  }));
}

const char* vcp_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
