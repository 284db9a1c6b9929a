// Kernels 14 and 15: graph-PDMM's two passes over the (2E, W) edge-dual
// arena (slot t holds the directed dual z_{src[t]|nbr[t]}; node i owns the
// contiguous slots indptr[i]:indptr[i+1]).  They replace, in
// src/repro/kernels/neighbor_reduce.py,
//
//   neighbor_reduce_pallas   s[i] = sum over node i's slots t, in slot
//                            order, of (sgn[t] >= 0 ? z[t] : -z[t])
//                            (n rows; a node without a slot gets zeros)
//   edge_flip_pallas         out[t] = z[rev[t]] - (sgn[t] * 2c) x[nbr[t]],
//                            or z[t] where mask[t] == 0 (2E rows)
//
// Inputs are f32 or bf16, the arithmetic f32, one rounding to the dtype at
// the end.  The TPU's neighbor_reduce walks the slots on a sequential grid
// with the node's output block resident in VMEM across its segment, and (in
// bf16) rounds to the output dtype at every accumulation; here a node's
// whole segment is walked inside one block and rounds once, as the
// reference's "xla" branch and the plain version do.
//
// What bounds them on an H100: bytes.  One add (reduce) or two flops
// (flip) per element against 4-8 bytes read: the least time is the edge
// duals read once and the output written once (the reduce), or z, the
// gathered x rows and the output once each (the flip).  The design:
//
//   * one block per (output row, column chunk) work item; a chunk is
//     kThreads 16-byte vectors (4 f32 or 8 bf16 a thread; scalar loads when
//     W is not a multiple of them), so neighbouring threads touch
//     neighbouring addresses and every load is 16 bytes;
//   * neighbor_reduce: the thread keeps its columns' sums in registers
//     while it walks node i's slot range (from indptr, built once per
//     topology on the device by the wrapper), starting from the first slot,
//     and writes the output row once.  The order of the additions is the
//     slot order, the plain version's, so the two agree bitwise;
//   * edge_flip: both gathers (z[rev[t]] and x[nbr[t]]) read their row
//     directly; the result goes to a new buffer (rev is a permutation, so
//     an in-place flip would read rows that were already written).
//
// Row offsets are 64-bit: complete(64) at 2^20 lanes is 4.2e9 elements.
// No atomics anywhere, so results repeat exactly.
#include "common.cuh"

#include <stdint.h>

namespace {

constexpr int kThreads = 128;

template <typename T>
struct Vec {
  static constexpr int N = 16 / sizeof(T);
};

__device__ __forceinline__ void load_vec(const float* p, size_t i, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p + i);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, size_t i, float* v) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p + i);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}
__device__ __forceinline__ void store_vec(float* p, size_t i, const float* v) {
  *reinterpret_cast<float4*>(p + i) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, size_t i, const float* v) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
  *reinterpret_cast<uint4*>(p + i) = raw;
}

// The columns one thread covers in a chunk: N consecutive ones from a
// 16-byte boundary (kVec), else N columns kThreads apart.
template <typename T, bool kVec>
struct Cols {
  static constexpr int N = Vec<T>::N;
  long long base;
  __device__ Cols(long long chunk_start) {
    base = kVec ? chunk_start + (long long)threadIdx.x * N : chunk_start + threadIdx.x;
  }
  __device__ __forceinline__ long long col(int k) const {
    return kVec ? base + k : base + (long long)k * kThreads;
  }
  // load the thread's columns of a row (zeros past W in the scalar path)
  __device__ __forceinline__ void load(const T* row, long long W, float* v) const {
    if (kVec) {
      load_vec(row, base, v);
    } else {
#pragma unroll
      for (int k = 0; k < N; ++k) v[k] = col(k) < W ? load_f32(row, col(k)) : 0.0f;
    }
  }
  __device__ __forceinline__ void store(T* row, long long W, const float* v) const {
    if (kVec) {
      store_vec(row, base, v);
    } else {
#pragma unroll
      for (int k = 0; k < N; ++k)
        if (col(k) < W) store_f32(row, col(k), v[k]);
    }
  }
  __device__ __forceinline__ bool live(long long W) const { return base < W; }
};

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
neighbor_reduce_kernel(const T* __restrict__ z, const int* __restrict__ indptr,
                       const int* __restrict__ sgn, long long n, long long W, long long chunks,
                       long long chunk, T* __restrict__ out) {
  constexpr int N = Vec<T>::N;
  const long long items = n * chunks;
  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    const long long node = item / chunks;
    const Cols<T, kVec> cols((item % chunks) * chunk);
    if (!cols.live(W)) continue;
    const long long lo = indptr[node], hi = indptr[node + 1];
    float acc[N], v[N];
#pragma unroll
    for (int k = 0; k < N; ++k) acc[k] = 0.0f;
    for (long long t = lo; t < hi; ++t) {
      cols.load(z + (size_t)t * W, W, v);
      const bool pos = sgn[t] >= 0;
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const float s = pos ? v[k] : -v[k];
        acc[k] = t == lo ? s : __fadd_rn(acc[k], s);
      }
    }
    cols.store(out + (size_t)node * W, W, acc);
  }
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
edge_flip_kernel(const T* __restrict__ z, const T* __restrict__ x, const int* __restrict__ rev,
                 const int* __restrict__ nbr, const int* __restrict__ sgn,
                 const int* __restrict__ mask, float c2, long long slots, long long W,
                 long long chunks, long long chunk, T* __restrict__ out) {
  constexpr int N = Vec<T>::N;
  const long long items = slots * chunks;
  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    const long long t = item / chunks;
    const Cols<T, kVec> cols((item % chunks) * chunk);
    if (!cols.live(W)) continue;
    float v[N];
    if (mask != nullptr && mask[t] == 0) {
      // keep z[t]: a bf16 or f32 value survives the round trip through f32
      cols.load(z + (size_t)t * W, W, v);
      cols.store(out + (size_t)t * W, W, v);
      continue;
    }
    float xv[N];
    cols.load(z + (size_t)rev[t] * W, W, v);
    cols.load(x + (size_t)nbr[t] * W, W, xv);
    const float s = sgn[t] >= 0 ? c2 : -c2;
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = __fsub_rn(v[k], __fmul_rn(s, xv[k]));
    cols.store(out + (size_t)t * W, W, v);
  }
}

// (chunks, columns per chunk) and the grid for rows x W
inline void plan(long long rows, long long W, int n_vec, long long* chunks, long long* chunk,
                 unsigned* blocks) {
  *chunk = (long long)kThreads * n_vec;
  *chunks = (W + *chunk - 1) / *chunk;
  if (*chunks < 1) *chunks = 1;
  long long items = rows * *chunks;
  const long long cap = (1LL << 31) - 1;
  *blocks = (unsigned)(items < 1 ? 1 : (items > cap ? cap : items));
}

template <typename T>
void reduce_typed(const void* z, const int* indptr, const int* sgn, long long n, long long W,
                  void* out, cudaStream_t stream) {
  long long chunks, chunk;
  unsigned blocks;
  plan(n, W, Vec<T>::N, &chunks, &chunk, &blocks);
  if (W % Vec<T>::N == 0) {
    neighbor_reduce_kernel<T, true><<<blocks, kThreads, 0, stream>>>(
        (const T*)z, indptr, sgn, n, W, chunks, chunk, (T*)out);
  } else {
    neighbor_reduce_kernel<T, false><<<blocks, kThreads, 0, stream>>>(
        (const T*)z, indptr, sgn, n, W, chunks, chunk, (T*)out);
  }
}

template <typename T>
void flip_typed(const void* z, const void* x, const int* rev, const int* nbr, const int* sgn,
                const int* mask, float c2, long long slots, long long W, void* out,
                cudaStream_t stream) {
  long long chunks, chunk;
  unsigned blocks;
  plan(slots, W, Vec<T>::N, &chunks, &chunk, &blocks);
  if (W % Vec<T>::N == 0) {
    edge_flip_kernel<T, true><<<blocks, kThreads, 0, stream>>>(
        (const T*)z, (const T*)x, rev, nbr, sgn, mask, c2, slots, W, chunks, chunk, (T*)out);
  } else {
    edge_flip_kernel<T, false><<<blocks, kThreads, 0, stream>>>(
        (const T*)z, (const T*)x, rev, nbr, sgn, mask, c2, slots, W, chunks, chunk, (T*)out);
  }
}

}  // namespace

// z (slots, W); indptr (n + 1,) int32, non-decreasing, indptr[n] <= slots;
// sgn (slots,) int32; out (n, W).
extern "C" int launch_neighbor_reduce(const void* z, const void* indptr, const void* sgn,
                                      long long n, long long W, int dtype, void* out,
                                      int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n == 0 || W == 0) return (int)cudaGetLastError();
  if (dtype == kF32) {
    reduce_typed<float>(z, (const int*)indptr, (const int*)sgn, n, W, out, (cudaStream_t)stream);
  } else if (dtype == kBF16) {
    reduce_typed<__nv_bfloat16>(z, (const int*)indptr, (const int*)sgn, n, W, out,
                                (cudaStream_t)stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// z (slots, W); x (rows, W) with every nbr[t] < rows; rev a permutation of
// the slots; rev, nbr, sgn (slots,) int32; mask (slots,) int32 or null;
// out (slots, W), not z.
extern "C" int launch_edge_flip(const void* z, const void* x, const void* rev, const void* nbr,
                                const void* sgn, const void* mask, float c2, long long slots,
                                long long W, int dtype, void* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (slots == 0 || W == 0) return (int)cudaGetLastError();
  if (dtype == kF32) {
    flip_typed<float>(z, x, (const int*)rev, (const int*)nbr, (const int*)sgn,
                      (const int*)mask, c2, slots, W, out, (cudaStream_t)stream);
  } else if (dtype == kBF16) {
    flip_typed<__nv_bfloat16>(z, x, (const int*)rev, (const int*)nbr, (const int*)sgn,
                              (const int*)mask, c2, slots, W, out, (cudaStream_t)stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
