// The whole K-step eq. (20) client loop for affine gradient oracles, one
// thread block per client.
//
// Replaces src/repro/kernels/inner_loop.py::inner_loop_affine_pallas.  Per
// client i, with g = H_i x - (c_i + off_i):
//     x <- x - step_i * (g + rho * (x - x_s) + lam_i)        (K times)
// and writes x_K and x_bar = (sum_k x_k) * (1/K).
//
// What bounds it on an H100: the H stack.  One client's W x W f32 block is
// 1 MiB at W = 512, more than the 227 KB of shared memory a block can hold,
// and the whole (m, W, W) stack (524 MB at m = 500) is ten times the 50 MB
// L2.  So this design keeps only the client's rows on chip -- x, the x sum,
// c + off, x_s, lam and g: 6 rows, 12 KB at W = 512 -- and re-reads H from
// device memory on every step: K reads of H in all (2.6 GB at K = 5), where
// the least the work needs is one.  The matvec is 2 W^2 flop per step, far
// below the f32 rate, so the kernel is bound by bytes.
//
// Per step, each warp takes rows j of H (j = warp, warp + nwarps, ...),
// reads a row as coalesced float4 loads, multiplies with x from shared
// memory, reduces the 32 partial sums with shuffles and writes g[j]; after a
// barrier the block applies eq. (20) to its row and a second barrier closes
// the step.  The matvec sums in another order than the reference's einsum,
// so it agrees to rounding (the tests use rtol = atol = 1e-4); the eq. (20)
// update itself is bitwise the reference's f32 arithmetic.
//
// Operands: x0, c, lam, off, x_K, x_bar are (m, W) f32 rows; H is
// (m, W, W) f32; x_s is (W,); step is an (m,) f32 array or, when null, the
// scalar `step`.  lam and off may be null.  W % 128 == 0 (arena layout).
#include "common.cuh"

namespace {

constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads)
inner_loop_affine_kernel(const float* __restrict__ x0, const float* __restrict__ H,
                         const float* __restrict__ c, const float* __restrict__ xs,
                         const float* __restrict__ lam, const float* __restrict__ off,
                         const float* __restrict__ step_arr, float step, float rho,
                         float inv_k, int K, int W, float* __restrict__ x_out,
                         float* __restrict__ xbar_out) {
  extern __shared__ __align__(16) float smem[];
  float* x = smem;
  float* xsum = x + W;
  float* cc = xsum + W;
  float* s_xs = cc + W;
  float* s_lam = s_xs + W;
  float* g = s_lam + W;

  const int i = blockIdx.x;
  const size_t row = (size_t)i * W;
  const float* Hi = H + (size_t)i * W * W;
  const float st = step_arr != nullptr ? step_arr[i] : step;
  const bool has_lam = lam != nullptr;

  for (int e = threadIdx.x; e < W; e += blockDim.x) {
    x[e] = x0[row + e];
    xsum[e] = 0.0f;
    float cv = c[row + e];
    if (off != nullptr) cv = __fadd_rn(cv, off[row + e]);
    cc[e] = cv;
    s_xs[e] = xs[e];
    s_lam[e] = has_lam ? lam[row + e] : 0.0f;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int w4 = W >> 2;
  const float4* xv = reinterpret_cast<const float4*>(x);

  for (int k = 0; k < K; ++k) {
    // g_j = sum_e H[j, e] x[e] - (c + off)_j
    for (int j = warp; j < W; j += nwarps) {
      const float4* hrow = reinterpret_cast<const float4*>(Hi + (size_t)j * W);
      float acc = 0.0f;
      for (int q = lane; q < w4; q += 32) {
        const float4 h = __ldg(hrow + q);
        const float4 xx = xv[q];
        acc = fmaf(h.x, xx.x, acc);
        acc = fmaf(h.y, xx.y, acc);
        acc = fmaf(h.z, xx.z, acc);
        acc = fmaf(h.w, xx.w, acc);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (lane == 0) g[j] = __fsub_rn(acc, cc[j]);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < W; e += blockDim.x) {
      const float xn = eq20(x[e], g[e], s_xs[e], s_lam[e], has_lam, st, rho);
      x[e] = xn;
      xsum[e] = __fadd_rn(xsum[e], xn);
    }
    __syncthreads();
  }

  for (int e = threadIdx.x; e < W; e += blockDim.x) {
    x_out[row + e] = x[e];
    xbar_out[row + e] = __fmul_rn(xsum[e], inv_k);
  }
}

}  // namespace

extern "C" int launch_inner_loop_affine(const void* x0, const void* H, const void* c,
                                        const void* xs, const void* lam, const void* off,
                                        const void* step_arr, float step, float rho,
                                        float inv_k, int K, int m, int W, void* x_out,
                                        void* xbar_out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = 6 * (size_t)W * sizeof(float);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(inner_loop_affine_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (m > 0) {
    inner_loop_affine_kernel<<<m, kThreads, smem, (cudaStream_t)stream>>>(
        (const float*)x0, (const float*)H, (const float*)c, (const float*)xs,
        (const float*)lam, (const float*)off, (const float*)step_arr, step, rho, inv_k, K,
        W, (float*)x_out, (float*)xbar_out);
  }
  return (int)cudaGetLastError();
}
