// Shared helpers for the port's Hopper kernels (sm_90a).
//
// Every kernel here is launched through a plain C function
//   int launch_<name>(..., int device, void* stream)
// loaded with ctypes (kernels/_build.py).  The launcher enqueues on the
// caller's stream (PyTorch's current stream), never synchronises, allocates
// nothing, and returns cudaGetLastError() so the Python wrapper can raise on
// a refused launch.
//
// Floating-point contract: the elementwise arithmetic uses the _rn
// intrinsics, which nvcc never contracts into an FMA, so each operation is
// rounded on its own exactly as PyTorch's eager ops (and the reference's
// f32 XLA ops) round it.  Inputs are f32 or bf16; math is f32; a bf16
// output is rounded to nearest even.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stddef.h>

enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float load_f32(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f32(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// x - step * (g + rho * (x - xs) + lam), in the reference's order
// (src/repro/kernels/fused_update.py::eq20).
__device__ __forceinline__ float eq20(float x, float g, float xs, float lam,
                                      bool has_lam, float step, float rho) {
  float acc = __fadd_rn(g, __fmul_rn(rho, __fsub_rn(x, xs)));
  if (has_lam) acc = __fadd_rn(acc, lam);
  return __fsub_rn(x, __fmul_rn(step, acc));
}

// Grid for a one-pass elementwise kernel over n elements: enough blocks to
// cover n once, capped at a few waves of the card; the kernels grid-stride.
static inline unsigned elementwise_blocks(size_t n, int threads) {
  size_t blocks = (n + threads - 1) / threads;
  const size_t cap = 132 * 32;
  if (blocks > cap) blocks = cap;
  return blocks == 0 ? 1u : (unsigned)blocks;
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
