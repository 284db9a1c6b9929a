// Kernel 12: the bounded-staleness admission mix.  It replaces, in
// src/repro/kernels/stale_mix.py,
//
//   stale_mix_pallas   per client row i of the (m, W) arenas:
//                      base_i  = fresh_i ? u_i : cache_i
//                      mixed_i = base_i + w_i (buf_i - base_i)  if w_i > 0
//                              = base_i (bitwise)               otherwise
//                      buf'_i  = store_i ? u_i : buf_i
//
// with cache the (m, W) u_hat cache or SCAFFOLD's (W,) server row, fresh and
// store (m,) bools and w (m,) f32 admission weights.  Inputs are f32 or bf16.
// The mix is f32 with every operation rounded on its own (__fsub_rn,
// __fmul_rn, __fadd_rn: never contracted into an FMA), then rounded to nearest
// even into bf16 where the arena is bf16: bitwise the plain version.  The
// w > 0 guard returns the base value's bits untouched, so a NaN or Inf
// buffered row cannot leak into a row with w = 0 (0 * Inf is NaN) and no
// -0.0 + 0.0 flips a sign; the reference's max_staleness = 0 collapse to the
// synchronous masked round rests on it.
//
// What bounds it on an H100: bytes.  Three reads (u, buf, cache) and two
// writes per element, no reduction, so the least time is those bytes at
// 3.35 TB/s.  The TPU kernel broadcasts the three per-client scalars to
// (m, 128) rows so each grid step reads them as VMEM blocks; here a thread
// reads them from its row (cached), and the design is the plain one: a
// grid-stride loop over 16-byte vectors (4 f32 or 8 bf16; W is a multiple of
// them in the arena, so a vector never straddles two rows), scalar elements
// when W is not.
#include "common.cuh"

#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float v, float& out) { out = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16& out) {
  out = __float2bfloat16_rn(v);
}

template <typename T>
__device__ __forceinline__ T mix_one(T base, T b, float w) {
  if (!(w > 0.0f)) return base;
  const float bf = to_f32(base);
  T out;
  from_f32(__fadd_rn(bf, __fmul_rn(w, __fsub_rn(to_f32(b), bf))), out);
  return out;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
stale_mix_vec_kernel(const T* __restrict__ u, const T* __restrict__ cache, int cache_per_row,
                     const T* __restrict__ buf, const uint8_t* __restrict__ fresh,
                     const uint8_t* __restrict__ store, const float* __restrict__ w,
                     size_t n_vec, long long W, T* __restrict__ mixed,
                     T* __restrict__ buf_out) {
  constexpr int N = 16 / sizeof(T);
  for (size_t v = (size_t)blockIdx.x * blockDim.x + threadIdx.x; v < n_vec;
       v += (size_t)gridDim.x * blockDim.x) {
    const size_t t = v * N;
    const size_t row = t / (size_t)W;
    const size_t ci = cache_per_row ? t : t % (size_t)W;
    const uint4 ur = *reinterpret_cast<const uint4*>(u + t);
    const uint4 br = *reinterpret_cast<const uint4*>(buf + t);
    const uint4 base = fresh[row] ? ur : *reinterpret_cast<const uint4*>(cache + ci);
    *reinterpret_cast<uint4*>(buf_out + t) = store[row] ? ur : br;
    const float wk = w[row];
    if (!(wk > 0.0f)) {
      *reinterpret_cast<uint4*>(mixed + t) = base;  // the base's bits, untouched
      continue;
    }
    alignas(16) T be[N], bb[N], out[N];
    *reinterpret_cast<uint4*>(be) = base;
    *reinterpret_cast<uint4*>(bb) = br;
#pragma unroll
    for (int k = 0; k < N; ++k) out[k] = mix_one(be[k], bb[k], wk);
    *reinterpret_cast<uint4*>(mixed + t) = *reinterpret_cast<const uint4*>(out);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
stale_mix_scalar_kernel(const T* __restrict__ u, const T* __restrict__ cache, int cache_per_row,
                        const T* __restrict__ buf, const uint8_t* __restrict__ fresh,
                        const uint8_t* __restrict__ store, const float* __restrict__ w,
                        size_t n, long long W, T* __restrict__ mixed, T* __restrict__ buf_out) {
  for (size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x; t < n;
       t += (size_t)gridDim.x * blockDim.x) {
    const size_t row = t / (size_t)W;
    const T uv = u[t], bv = buf[t];
    const T base = fresh[row] ? uv : cache[cache_per_row ? t : t % (size_t)W];
    mixed[t] = mix_one(base, bv, w[row]);
    buf_out[t] = store[row] ? uv : bv;
  }
}

template <typename T>
void stale_mix_typed(const void* u, const void* cache, int cache_per_row, const void* buf,
                     const void* fresh, const void* store, const void* w, long long m,
                     long long W, void* mixed, void* buf_out, cudaStream_t stream) {
  constexpr int N = 16 / sizeof(T);
  const size_t n = (size_t)m * W;
  if (W % N == 0) {
    stale_mix_vec_kernel<T><<<elementwise_blocks(n / N, kThreads), kThreads, 0, stream>>>(
        (const T*)u, (const T*)cache, cache_per_row, (const T*)buf, (const uint8_t*)fresh,
        (const uint8_t*)store, (const float*)w, n / N, W, (T*)mixed, (T*)buf_out);
  } else {
    stale_mix_scalar_kernel<T><<<elementwise_blocks(n, kThreads), kThreads, 0, stream>>>(
        (const T*)u, (const T*)cache, cache_per_row, (const T*)buf, (const uint8_t*)fresh,
        (const uint8_t*)store, (const float*)w, n, W, (T*)mixed, (T*)buf_out);
  }
}

}  // namespace

// fresh and store are m bytes (torch.bool); w is m f32.
extern "C" int launch_stale_mix(const void* u, const void* cache, int cache_per_row,
                                const void* buf, const void* fresh, const void* store,
                                const void* w, long long m, long long W, int dtype, void* mixed,
                                void* buf_out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (m == 0 || W == 0) return (int)cudaGetLastError();
  if (dtype == kF32) {
    stale_mix_typed<float>(u, cache, cache_per_row, buf, fresh, store, w, m, W, mixed, buf_out,
                           (cudaStream_t)stream);
  } else if (dtype == kBF16) {
    stale_mix_typed<__nv_bfloat16>(u, cache, cache_per_row, buf, fresh, store, w, m, W, mixed,
                                   buf_out, (cudaStream_t)stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
