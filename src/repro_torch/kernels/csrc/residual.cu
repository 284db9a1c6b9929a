// Kernel 13: the fixed-point residual norms of early termination.  It
// replaces, in src/repro/kernels/residual.py,
//
//   residual_norm_pallas   per row i of the (m, W) state x and its previous
//                          round's snapshot x_prev, in f32:
//                          dx2_i = ||x_i - x_prev_i||^2
//                          x2_i  = ||x_i||^2
//
// Inputs are f32 or bf16 (both of one dtype), the outputs f32.  A width that
// is not a multiple of 128 gives what its zero-padded width gives: padding
// adds 0 to both sums, so the kernel simply stops at W.
//
// What bounds it on an H100: bytes.  Five flops per element against 8 (f32)
// or 4 (bf16) bytes of the two inputs, so the least time is both inputs
// read once at 3.35 TB/s.  The TPU kernel keeps two per-lane accumulator
// rows resident across a sequential grid over the row's width blocks; here
// blocks run in parallel and in no order, so it is the two-pass, fixed-order
// reduction of screen.cu:
//
//   1. block b covers one contiguous chunk of one row (the wrapper sizes the
//      chunks, as ``screen.chunking`` does, so that about eight blocks per
//      SM are in flight: one chunk per row at (500, 512), 128 at (8, 2^20)).
//      Each thread walks its part of the chunk with 16-byte loads (4 f32 or
//      8 bf16; scalar loads when W is not a multiple of them) and keeps two
//      f32 sums; the block reduces them by warp shuffles and then over its
//      warps in warp order;
//   2. with more than one chunk per row, one warp per row adds the row's
//      chunk partials, lane by lane in chunk order and then by shuffles.
//
// No atomics: the order of every sum is fixed by the shapes, so a result is
// the same from run to run.  It is not torch.sum's order, so the sums agree
// with the plain version to a rounding tolerance.  A NaN or Inf entry gives
// the row NaN or Inf sums, as the plain version does.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T>
struct Vec {
  static constexpr int N = 16 / sizeof(T);
};

// N consecutive values from 16-byte aligned p + i, as f32
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

__device__ __forceinline__ void accumulate(float x, float p, float& dx2, float& x2) {
  const float d = __fsub_rn(x, p);
  dx2 = __fadd_rn(dx2, __fmul_rn(d, d));
  x2 = __fadd_rn(x2, __fmul_rn(x, x));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// one block per (row, chunk): b = row * chunks + c.  With kFinal (one chunk
// per row) the block writes the row's sums; else its chunk's partials.
template <typename T, bool kVec, bool kFinal>
__global__ void __launch_bounds__(kThreads)
residual_kernel(const T* __restrict__ x, const T* __restrict__ xp, long long W,
                long long chunks, long long chunk, float* __restrict__ dx2_out,
                float* __restrict__ x2_out) {
  const long long b = blockIdx.x;
  const long long row = b / chunks;
  const long long start = (b % chunks) * chunk;
  const long long end = min(W, start + chunk);
  const T* xr = x + (size_t)row * W;
  const T* pr = xp + (size_t)row * W;
  float dx2 = 0.0f, x2 = 0.0f;
  if (kVec) {
    constexpr int N = Vec<T>::N;
    float xv[N], pv[N];
    for (long long j = start + (long long)threadIdx.x * N; j < end; j += (long long)kThreads * N) {
      load_vec(xr, j, xv);
      load_vec(pr, j, pv);
#pragma unroll
      for (int k = 0; k < N; ++k) accumulate(xv[k], pv[k], dx2, x2);
    }
  } else {
    for (long long j = start + threadIdx.x; j < end; j += kThreads) {
      accumulate(load_f32(xr, j), load_f32(pr, j), dx2, x2);
    }
  }
  dx2 = warp_sum(dx2);
  x2 = warp_sum(x2);
  __shared__ float s_dx2[kWarps], s_x2[kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    s_dx2[warp] = dx2;
    s_x2[warp] = x2;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float a = s_dx2[0], c = s_x2[0];
#pragma unroll
    for (int k = 1; k < kWarps; ++k) {
      a = __fadd_rn(a, s_dx2[k]);
      c = __fadd_rn(c, s_x2[k]);
    }
    const long long o = kFinal ? row : b;
    dx2_out[o] = a;
    x2_out[o] = c;
  }
}

// one warp per row: the row's chunk partials in chunk order
__global__ void __launch_bounds__(kThreads)
residual_finish_kernel(const float* __restrict__ dx2_part, const float* __restrict__ x2_part,
                       long long m, long long chunks, float* __restrict__ dx2_out,
                       float* __restrict__ x2_out) {
  const long long row = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= m) return;  // the whole warp leaves together
  const int lane = threadIdx.x % 32;
  float a = 0.0f, c = 0.0f;
  for (long long k = lane; k < chunks; k += 32) {
    a = __fadd_rn(a, dx2_part[row * chunks + k]);
    c = __fadd_rn(c, x2_part[row * chunks + k]);
  }
  a = warp_sum(a);
  c = warp_sum(c);
  if (lane == 0) {
    dx2_out[row] = a;
    x2_out[row] = c;
  }
}

template <typename T>
void residual_typed(const void* x, const void* xp, long long m, long long W, long long chunks,
                    long long chunk, float* dx2_part, float* x2_part, float* dx2_out,
                    float* x2_out, cudaStream_t stream) {
  const unsigned blocks = (unsigned)(m * chunks);
  const bool vec = W % Vec<T>::N == 0 && chunk % Vec<T>::N == 0;
  const T* a = (const T*)x;
  const T* p = (const T*)xp;
  if (chunks == 1) {
    if (vec) {
      residual_kernel<T, true, true><<<blocks, kThreads, 0, stream>>>(a, p, W, 1, chunk, dx2_out,
                                                                       x2_out);
    } else {
      residual_kernel<T, false, true><<<blocks, kThreads, 0, stream>>>(a, p, W, 1, chunk,
                                                                        dx2_out, x2_out);
    }
    return;
  }
  if (vec) {
    residual_kernel<T, true, false><<<blocks, kThreads, 0, stream>>>(a, p, W, chunks, chunk,
                                                                      dx2_part, x2_part);
  } else {
    residual_kernel<T, false, false><<<blocks, kThreads, 0, stream>>>(a, p, W, chunks, chunk,
                                                                       dx2_part, x2_part);
  }
  residual_finish_kernel<<<(unsigned)((m + kWarps - 1) / kWarps), kThreads, 0, stream>>>(
      dx2_part, x2_part, m, chunks, dx2_out, x2_out);
}

}  // namespace

// chunks * chunk >= W; with chunks > 1, dx2_part and x2_part hold m * chunks
// f32 values of scratch each.
extern "C" int launch_residual_norm(const void* x, const void* x_prev, long long m, long long W,
                                    int dtype, long long chunks, long long chunk,
                                    void* dx2_part, void* x2_part, void* dx2_out, void* x2_out,
                                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (chunks < 1 || chunk < 1 || chunks * chunk < W) return (int)cudaErrorInvalidValue;
  if (m == 0) return (int)cudaGetLastError();
  if (dtype == kF32) {
    residual_typed<float>(x, x_prev, m, W, chunks, chunk, (float*)dx2_part, (float*)x2_part,
                          (float*)dx2_out, (float*)x2_out, (cudaStream_t)stream);
  } else if (dtype == kBF16) {
    residual_typed<__nv_bfloat16>(x, x_prev, m, W, chunks, chunk, (float*)dx2_part,
                                  (float*)x2_part, (float*)dx2_out, (float*)x2_out,
                                  (cudaStream_t)stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
