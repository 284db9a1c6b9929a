// The RG-LRU's linear recurrence, a kernel of the port's own: the reference
// runs it as plain JAX (src/repro/kernels/ops.py:683 lru_scan, a chunked
// associative scan), not as a Pallas kernel.
//
//   lru_scan   a, b (B, S, D) f32, h0 (B, D) f32 ->
//              y (B, S, D) f32 with y_t = h_t = a_t h_{t-1} + b_t, and
//              h_last (B, D) f32 = h_{S-1} (h0 when S = 0).
//
// One thread a (batch row, channel), walking the sequence in order: each
// step is one product and one sum, each rounded on its own (__fmul_rn,
// __fadd_rn, never contracted into an FMA), so y equals the plain
// sequential recurrence (kernels/ref.py lru_ref) bit for bit.
//
// What bounds it: bytes.  2 S D B floats read and S D B written, one
// multiply-add each; at recurrentgemma-9b's prefill (4, 1024, 4096) that
// is 201 MB, 60 us at the card's memory rate.  The recurrence is serial in
// t, so the time is the latency of the loads unless many are in flight: a
// thread loads the next U steps of a and b into registers while it works
// through the current U, and consecutive threads own consecutive channels,
// so each step's loads and stores are coalesced across a warp.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kU = 32;  // steps a thread has in flight

__global__ void __launch_bounds__(kThreads)
lru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                const float* __restrict__ h0, float* __restrict__ y,
                float* __restrict__ h_last, int S, int D) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const int row = blockIdx.y;
  if (d >= D) return;
  const size_t base = (size_t)row * S * D + d;
  float h = h0[(size_t)row * D + d];
  float ca[kU], cb[kU];
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const bool in = u < S;
    ca[u] = in ? a[base + (size_t)u * D] : 0.0f;
    cb[u] = in ? b[base + (size_t)u * D] : 0.0f;
  }
  for (int t0 = 0; t0 < S; t0 += kU) {
    // the next group's loads, issued before this group's dependent steps
    float na[kU], nb[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int t = t0 + kU + u;
      const bool in = t < S;
      na[u] = in ? a[base + (size_t)t * D] : 0.0f;
      nb[u] = in ? b[base + (size_t)t * D] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (t0 + u < S) {  // registers stay registers: every index is a constant
        h = __fadd_rn(__fmul_rn(ca[u], h), cb[u]);
        y[base + (size_t)(t0 + u) * D] = h;
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      ca[u] = na[u];
      cb[u] = nb[u];
    }
  }
  h_last[(size_t)row * D + d] = h;
}

}  // namespace

// a, b, y (B, S, D), h0, h_last (B, D), all f32 and contiguous.  Returns a
// CUDA error code (0 on success).
extern "C" int launch_lru_scan(const void* a, const void* b, const void* h0, void* y,
                               void* h_last, int B, int S, int D, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B < 0 || S < 0 || D < 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || D == 0) return (int)cudaGetLastError();
  dim3 grid((unsigned)((D + kThreads - 1) / kThreads), (unsigned)B);
  lru_scan_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, (const float*)h0, (float*)y, (float*)h_last, S, D);
  return (int)cudaGetLastError();
}
