// Helpers shared by the attention kernels' CUDA-core routes: kernel 16b's
// (csrc/flash_attention_bwd.cu, namespace cc) and 16j's and 16bj's
// (csrc/flash_attention_jvp.cu).  Which keys a query sees, f32 tile
// products and row loads out of shared memory for blocks of kThreads
// threads, the carving of dynamic shared memory into 128-byte aligned
// tiles; and, for every route that splits a kv head's query heads across
// the blocks of its key grid, the pass that adds their partials in order.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace attn {

constexpr int kThreads = 256;  // every CUDA-core attention block

// Whether the key at kpos is visible to the query at qpos: inside the Sk
// keys, not after the query (causal), within the window (window > 0).
__device__ __forceinline__ bool visible(int qpos, int kpos, int Sk, int causal, int window) {
  bool ok = kpos < Sk;
  if (causal) ok = ok && kpos <= qpos;
  if (window > 0) ok = ok && kpos > qpos - window;
  return ok;
}

// C (M x N, row-major, ldc) = / += A (M x K) B (K x N), f32.  A(m, k) is
// A[m * lda + k], or A[k * lda + m] when A_COL; B(k, n) is B[k * ldb + n],
// or B[n * ldb + k] when B_COL.  Each output is one thread's sum over k in
// order (the same thread for a given element in every call of one M x N,
// so a second accumulating call needs no barrier after the first).
template <bool ACC, bool A_COL, bool B_COL>
__device__ void mm(float* C, int ldc, const float* A, int lda, const float* B, int ldb, int M,
                   int N, int K) {
  for (int e = threadIdx.x; e < M * N; e += kThreads) {
    const int m = e / N, n = e % N;
    float s = 0.0f;
    for (int k = 0; k < K; ++k) {
      const float a = A_COL ? A[k * lda + m] : A[m * lda + k];
      const float b = B_COL ? B[n * ldb + k] : B[k * ldb + n];
      s = fmaf(a, b, s);
    }
    C[m * ldc + n] = ACC ? C[m * ldc + n] + s : s;
  }
}

// Rows [r0, r0 + R) of one head of a (B, S, heads, dim) tensor into shared
// memory (ld columns a row; D >= dim columns written, those past dim and
// rows past S zero).
template <typename T>
__device__ void load_rows(float* dst, int ld, const T* src, long long row_stride, int r0, int R,
                          int S, int dim, int D) {
  for (int i = threadIdx.x; i < R * D; i += kThreads) {
    const int r = i / D, c = i % D;
    dst[r * ld + c] = (r0 + r < S && c < dim) ? load_f32(src, (size_t)((r0 + r) * row_stride + c))
                                              : 0.0f;
  }
}

__host__ __device__ constexpr size_t carved(size_t n) {
  return (n * sizeof(float) + 127) & ~(size_t)127;
}

__device__ __forceinline__ float* carve(uint8_t*& p, size_t n) {
  float* out = reinterpret_cast<float*>(p);
  p += carved(n);
  return out;
}

// dk = scale sum_z part_k[z], dv = sum_z part_v[z], the splits added in
// order (only when a key grid ran with more than one split): part holds
// (splits, B, Sk, Hkv, hd) and then (splits, B, Sk, Hkv, vd) f32.
template <typename T>
__global__ void __launch_bounds__(kThreads)
reduce_splits(const float* __restrict__ part, T* __restrict__ dk, T* __restrict__ dv,
              long long nk, long long nv, int splits, float scale) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < nk + nv; i += stride) {
    if (i < nk) {
      float s = part[i];
      for (int z = 1; z < splits; ++z) s += part[z * nk + i];
      store_f32(dk, (size_t)i, s * scale);
    } else {
      const long long j = i - nk;
      const float* pv = part + splits * nk;
      float s = pv[j];
      for (int z = 1; z < splits; ++z) s += pv[z * nv + j];
      store_f32(dv, (size_t)j, s);
    }
  }
}

// Launch reduce_splits on ``stream`` (a few waves of the card at most).
template <typename T>
cudaError_t launch_reduce_splits(const float* part, T* dk, T* dv, long long nk, long long nv,
                                 int splits, float scale, cudaStream_t stream) {
  const long long blocks = min((nk + nv + kThreads - 1) / kThreads, 132LL * 16);
  reduce_splits<T><<<(unsigned)blocks, kThreads, 0, stream>>>(part, dk, dv, nk, nv, splits,
                                                             scale);
  return cudaGetLastError();
}

}  // namespace attn
