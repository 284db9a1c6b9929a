// One-pass elementwise kernels over the (m, W) client arena, each with the
// (W,) server row broadcast inside the kernel (never materialised at
// (m, W)).  They replace, in src/repro/kernels/round_tail.py:
//
//   round_tail_pallas         lam_is = rho (x_s - x_ref) - lam_s
//                             u      = x_ref - lam_is / rho
//                             (lam_is written only when asked)
//   dual_from_uplink_pallas   lam'   = rho (u - x_s')
//   scaffold_cv_pallas        c_i'   = (c_i - c) + alpha_i (x_s - x_K)
//                             (SCAFFOLD's eq. (30); c and x_s are (W,)
//                             rows, alpha per client or scalar)
//   ef21_rowmax_pallas        r[i, j] = max_l |u - u_hat| over the 128
//                             lanes l of row j of client i, f32
//   ef21_apply_pallas         u_hat' = u_hat + clip(rint((u - u_hat) / s),
//                             -lo, lo) s, s = scales[i, j] per 128-lane row
//
// What bounds them on an H100: bytes.  Each does a handful of flops per
// element against 8-20 bytes of traffic, so the least time is the arena's
// reads and writes over the 3.35 TB/s of device memory; at the paper's sizes
// (about 1 MiB per buffer) a launch costs more than that.  The design is the
// plain one: one thread per element, a grid-stride loop, loads in the
// arena's dtype, f32 math with the _rn intrinsics (bitwise the reference's
// f32 operation order), one store per output.  The TPU's (rows, 128) tiles
// and BlockSpec grids do not carry over; the server row is indexed as
// t % W.  The division lam_is / rho stays a division, as in the reference;
// SCAFFOLD's alpha = 1/(K eta) arrives precomputed and is multiplied, as the
// reference multiplies it.
//
// The two EF21 kernels (the fused delta-quantised uplink) are bounded by
// bytes too: the reduction reads u and u_hat once and writes one f32 per
// 128 values; the apply pass reads u, u_hat and the scales and writes
// u_hat'.  ef21_rowmax gives each (client, 128-lane row) to one warp: 32
// lanes x 4 values, one 16-byte (f32) or 8-byte (bf16) load per lane, a
// shuffle reduction.  Its max propagates a NaN, as jnp.max and torch.amax
// do (fmaxf would drop it).  ef21_apply is one elementwise pass with the
// scale indexed by t / 128 (rows never straddle a client: W % 128 == 0);
// the quotient is __fdiv_rn (not a multiply by a reciprocal), rounded by
// rintf (half to even, as jnp.round and torch.round; roundf would round
// half away from zero), and the clip lets a NaN through as jnp.clip does.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T, bool kLamIs>
__global__ void __launch_bounds__(kThreads)
round_tail_kernel(const T* __restrict__ xr, const T* __restrict__ lam,
                  const T* __restrict__ xs, float rho, size_t n, int W,
                  T* __restrict__ lam_is_out, T* __restrict__ up_out) {
  for (size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x; t < n;
       t += (size_t)gridDim.x * blockDim.x) {
    const float x = load_f32(xr, t);
    const float l = load_f32(lam, t);
    const float s = load_f32(xs, t % W);
    const float li = __fsub_rn(__fmul_rn(rho, __fsub_rn(s, x)), l);
    if (kLamIs) store_f32(lam_is_out, t, li);
    store_f32(up_out, t, __fsub_rn(x, __fdiv_rn(li, rho)));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dual_from_uplink_kernel(const T* __restrict__ u, const T* __restrict__ xs, float rho,
                        size_t n, int W, T* __restrict__ out) {
  for (size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x; t < n;
       t += (size_t)gridDim.x * blockDim.x) {
    store_f32(out, t, __fmul_rn(rho, __fsub_rn(load_f32(u, t), load_f32(xs, t % W))));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
scaffold_cv_kernel(const T* __restrict__ ci, const T* __restrict__ xk,
                   const T* __restrict__ c, const T* __restrict__ xs,
                   const float* __restrict__ alpha_arr, float alpha, size_t n, int W,
                   T* __restrict__ out) {
  for (size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x; t < n;
       t += (size_t)gridDim.x * blockDim.x) {
    const size_t j = t % W;
    const float a = alpha_arr != nullptr ? alpha_arr[t / W] : alpha;
    const float cv = __fsub_rn(load_f32(ci, t), load_f32(c, j));
    store_f32(out, t, __fadd_rn(cv, __fmul_rn(a, __fsub_rn(load_f32(xs, j), load_f32(xk, t)))));
  }
}

// NaN-propagating max (fmaxf returns the other operand for a NaN)
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// four consecutive values from 16-byte (f32) or 8-byte (bf16) aligned p + i
__device__ __forceinline__ float4 load4(const float* p, size_t i) {
  return *reinterpret_cast<const float4*>(p + i);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p, size_t i) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p + i);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

constexpr int kLanes = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
ef21_rowmax_kernel(const T* __restrict__ u, const T* __restrict__ uh, size_t n_rows,
                   float* __restrict__ out) {
  const size_t row = (size_t)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  if (row >= n_rows) return;  // the whole warp leaves together
  const int lane = threadIdx.x % 32;
  const size_t i = row * kLanes + 4 * lane;
  const float4 a = load4(u, i), b = load4(uh, i);
  float v = max_nan(max_nan(fabsf(__fsub_rn(a.x, b.x)), fabsf(__fsub_rn(a.y, b.y))),
                    max_nan(fabsf(__fsub_rn(a.z, b.z)), fabsf(__fsub_rn(a.w, b.w))));
  for (int off = 16; off > 0; off >>= 1) v = max_nan(v, __shfl_xor_sync(0xffffffffu, v, off));
  if (lane == 0) out[row] = v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ef21_apply_kernel(const T* __restrict__ u, const T* __restrict__ uh,
                  const float* __restrict__ scales, float lo, size_t n,
                  T* __restrict__ out) {
  for (size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x; t < n;
       t += (size_t)gridDim.x * blockDim.x) {
    const float s = scales[t / kLanes];
    const float h = load_f32(uh, t);
    float q = rintf(__fdiv_rn(__fsub_rn(load_f32(u, t), h), s));
    q = q < -lo ? -lo : (q > lo ? lo : q);  // a NaN passes, as jnp.clip
    store_f32(out, t, __fadd_rn(h, __fmul_rn(q, s)));
  }
}

template <typename T>
void round_tail_typed(const void* xr, const void* lam, const void* xs, float rho,
                      size_t n, int W, void* lam_is_out, void* up_out,
                      cudaStream_t stream) {
  const unsigned blocks = elementwise_blocks(n, kThreads);
  if (lam_is_out != nullptr) {
    round_tail_kernel<T, true><<<blocks, kThreads, 0, stream>>>(
        (const T*)xr, (const T*)lam, (const T*)xs, rho, n, W, (T*)lam_is_out, (T*)up_out);
  } else {
    round_tail_kernel<T, false><<<blocks, kThreads, 0, stream>>>(
        (const T*)xr, (const T*)lam, (const T*)xs, rho, n, W, nullptr, (T*)up_out);
  }
}

}  // namespace

extern "C" int launch_round_tail(const void* xr, const void* lam, const void* xs, float rho,
                                 long long m, int W, int dtype, void* lam_is_out,
                                 void* up_out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)m * W;
  if (n == 0) return (int)cudaGetLastError();
  if (dtype == kF32) {
    round_tail_typed<float>(xr, lam, xs, rho, n, W, lam_is_out, up_out, (cudaStream_t)stream);
  } else if (dtype == kBF16) {
    round_tail_typed<__nv_bfloat16>(xr, lam, xs, rho, n, W, lam_is_out, up_out,
                                    (cudaStream_t)stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int launch_dual_from_uplink(const void* u, const void* xs, float rho, long long m,
                                       int W, int dtype, void* out, int device,
                                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)m * W;
  if (n == 0) return (int)cudaGetLastError();
  const unsigned blocks = elementwise_blocks(n, kThreads);
  if (dtype == kF32) {
    dual_from_uplink_kernel<float><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)u, (const float*)xs, rho, n, W, (float*)out);
  } else if (dtype == kBF16) {
    dual_from_uplink_kernel<__nv_bfloat16><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)u, (const __nv_bfloat16*)xs, rho, n, W, (__nv_bfloat16*)out);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int launch_scaffold_cv(const void* ci, const void* xk, const void* c, const void* xs,
                                  const void* alpha_arr, float alpha, long long m, int W,
                                  int dtype, void* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)m * W;
  if (n == 0) return (int)cudaGetLastError();
  const unsigned blocks = elementwise_blocks(n, kThreads);
  if (dtype == kF32) {
    scaffold_cv_kernel<float><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)ci, (const float*)xk, (const float*)c, (const float*)xs,
        (const float*)alpha_arr, alpha, n, W, (float*)out);
  } else if (dtype == kBF16) {
    scaffold_cv_kernel<__nv_bfloat16><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)ci, (const __nv_bfloat16*)xk, (const __nv_bfloat16*)c,
        (const __nv_bfloat16*)xs, (const float*)alpha_arr, alpha, n, W, (__nv_bfloat16*)out);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int launch_ef21_rowmax(const void* u, const void* uh, long long m, int W, int dtype,
                                  void* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t n_rows = (size_t)m * (W / kLanes);
  if (n_rows == 0) return (int)cudaGetLastError();
  const unsigned blocks = (unsigned)((n_rows + kThreads / 32 - 1) / (kThreads / 32));
  if (dtype == kF32) {
    ef21_rowmax_kernel<float><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)u, (const float*)uh, n_rows, (float*)out);
  } else if (dtype == kBF16) {
    ef21_rowmax_kernel<__nv_bfloat16><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)u, (const __nv_bfloat16*)uh, n_rows, (float*)out);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int launch_ef21_apply(const void* u, const void* uh, const void* scales, float lo,
                                 long long m, int W, int dtype, void* out, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)m * W;
  if (n == 0) return (int)cudaGetLastError();
  const unsigned blocks = elementwise_blocks(n, kThreads);
  if (dtype == kF32) {
    ef21_apply_kernel<float><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)u, (const float*)uh, (const float*)scales, lo, n, (float*)out);
  } else if (dtype == kBF16) {
    ef21_apply_kernel<__nv_bfloat16><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)u, (const __nv_bfloat16*)uh, (const float*)scales, lo, n,
        (__nv_bfloat16*)out);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
