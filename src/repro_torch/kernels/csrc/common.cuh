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
#include <stdint.h>

enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float load_f32(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f32(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// A row operand whose dtype is given at run time (DType code), as f32.
__device__ __forceinline__ float load_any(const void* p, int dtype, size_t i) {
  return dtype == kBF16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
                        : static_cast<const float*>(p)[i];
}

// mbarriers in shared memory, for TMA and bulk copies.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Spin until the phase of parity ``parity`` of ``bar`` has completed, with
// acquire at cluster scope when ``cluster`` (the phase's bytes came from
// other blocks of the cluster).  A phase that never completes (a fault in
// the pipeline) traps after about ten seconds, so the launch fails with an
// error instead of hanging.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity, bool cluster = false) {
  const uint32_t addr = smem_u32(bar);
  const long long start = clock64();
  uint32_t done;
  do {
    if (cluster)
      asm volatile(
          "{\n.reg .pred p;\n"
          "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(addr), "r"(parity)
          : "memory");
    else
      asm volatile(
          "{\n.reg .pred p;\n"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(addr), "r"(parity)
          : "memory");
    if (!done && clock64() - start > (1LL << 34)) __trap();
  } while (!done);
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
