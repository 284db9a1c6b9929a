// The paper's eq. (20) client step over one parameter leaf of any shape:
//     x' = x - step * (g + rho * (x - xs) + lam)          (lam optional)
//
// Replaces src/repro/kernels/fused_update.py::fused_update_pallas.  It is
// the step of every per-leaf (pytree) round: GPDMM/AGPDMM (step =
// 1/(1/eta + rho)), SCAFFOLD (rho = 0, lam = c - c_i), FedAvg (rho = 0, no
// lam) and Inexact FedSplit (xs = z, rho = 1/gamma, no lam, also on the
// (m, W) arena buffers).
//
// What bounds it on an H100: bytes.  Per element it reads x, g, xs and
// lam and writes x' (16-20 B in f32) for 5 flops, so the least time is the
// leaf's traffic over the 3.35 TB/s of device memory; at the paper's leaf
// (500 x 500 f32, about 5 MB) that is 1.5 us, less than a launch costs.
//
// Design.  The TPU kernel pads the flattened leaf to (rows, 128) tiles and
// walks them with a BlockSpec grid; here the leaf is one flat range.  Each
// thread takes 16-byte groups (4 f32 or 8 bf16 values) with vector loads
// and stores, grid-striding over the groups; the last numel % group
// elements run as a scalar tail, so a leaf of any size (m,), (m, 7),
// (m, 500) is covered without padding.  The math is f32 with the _rn
// intrinsics of common.cuh::eq20, bitwise the reference's operation order.
//
// Operands: x, g, lam, out have the leaf's numel n (lam may be null); xs
// has n elements or xs_n = n / m, the server leaf without the client dim,
// broadcast in the kernel as t % xs_n; step is an (m,) f32 array indexed by
// t / (n / m) or, when null, the scalar `step`.  All 16-byte aligned.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// 16 bytes of T as floats, and back (bf16 rounded to nearest even)
template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, size_t i, float* v) {
    const float4 a = *reinterpret_cast<const float4*>(p + i);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  }
  __device__ __forceinline__ static void store(float* p, size_t i, const float* v) {
    *reinterpret_cast<float4*>(p + i) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, size_t i, float* v) {
    const uint4 a = *reinterpret_cast<const uint4*>(p + i);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      v[2 * j] = f.x;
      v[2 * j + 1] = f.y;
    }
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p, size_t i, const float* v) {
    uint4 a;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&a);
#pragma unroll
    for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    *reinterpret_cast<uint4*>(p + i) = a;
  }
};

template <typename T, bool kLam>
__global__ void __launch_bounds__(kThreads)
fused_update_kernel(const T* __restrict__ x, const T* __restrict__ g,
                    const T* __restrict__ xs, const T* __restrict__ lam,
                    const float* __restrict__ step_arr, float step, float rho, size_t n,
                    size_t xs_n, size_t per_client, T* __restrict__ out) {
  constexpr int V = Vec16<T>::N;
  const size_t groups = n / V;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  const size_t first = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  // a group of xs is one vector load unless the broadcast wraps inside it
  const bool xs_vec = xs_n == n || xs_n % V == 0;

  for (size_t q = first; q < groups; q += stride) {
    const size_t t0 = q * V;
    float xv[V], gv[V], sv[V], lv[V], ov[V];
    Vec16<T>::load(x, t0, xv);
    Vec16<T>::load(g, t0, gv);
    if (kLam) Vec16<T>::load(lam, t0, lv);
    if (xs_vec) {
      Vec16<T>::load(xs, t0 % xs_n, sv);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) sv[j] = load_f32(xs, (t0 + j) % xs_n);
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float st = step_arr != nullptr ? step_arr[(t0 + j) / per_client] : step;
      ov[j] = eq20(xv[j], gv[j], sv[j], kLam ? lv[j] : 0.0f, kLam, st, rho);
    }
    Vec16<T>::store(out, t0, ov);
  }

  // the ragged tail: numel % V elements, one per thread
  for (size_t t = groups * V + first; t < n; t += stride) {
    const float st = step_arr != nullptr ? step_arr[t / per_client] : step;
    const float l = kLam ? load_f32(lam, t) : 0.0f;
    store_f32(out, t, eq20(load_f32(x, t), load_f32(g, t), load_f32(xs, t % xs_n), l, kLam,
                           st, rho));
  }
}

template <typename T>
void fused_update_typed(const void* x, const void* g, const void* xs, const void* lam,
                        const float* step_arr, float step, float rho, size_t n, size_t xs_n,
                        size_t per_client, void* out, cudaStream_t stream) {
  const size_t groups = n / Vec16<T>::N;
  const unsigned blocks = elementwise_blocks(groups > 0 ? groups : 1, kThreads);
  if (lam != nullptr) {
    fused_update_kernel<T, true><<<blocks, kThreads, 0, stream>>>(
        (const T*)x, (const T*)g, (const T*)xs, (const T*)lam, step_arr, step, rho, n, xs_n,
        per_client, (T*)out);
  } else {
    fused_update_kernel<T, false><<<blocks, kThreads, 0, stream>>>(
        (const T*)x, (const T*)g, (const T*)xs, nullptr, step_arr, step, rho, n, xs_n,
        per_client, (T*)out);
  }
}

}  // namespace

extern "C" int launch_fused_update(const void* x, const void* g, const void* xs,
                                   const void* lam, const void* step_arr, float step,
                                   float rho, long long n, long long xs_n, long long m,
                                   int dtype, void* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return (int)cudaGetLastError();
  if (xs_n <= 0 || n % xs_n != 0 || m <= 0 || n % m != 0) return (int)cudaErrorInvalidValue;
  const size_t per_client = (size_t)(n / m);
  if (dtype == kF32) {
    fused_update_typed<float>(x, g, xs, lam, (const float*)step_arr, step, rho, (size_t)n,
                              (size_t)xs_n, per_client, out, (cudaStream_t)stream);
  } else if (dtype == kBF16) {
    fused_update_typed<__nv_bfloat16>(x, g, xs, lam, (const float*)step_arr, step, rho,
                                      (size_t)n, (size_t)xs_n, per_client, out,
                                      (cudaStream_t)stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
