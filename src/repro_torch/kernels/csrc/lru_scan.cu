// The RG-LRU's linear recurrence and its backward, kernels of the port's
// own: the reference runs the recurrence as plain JAX (src/repro/kernels/
// ops.py:683 lru_scan, a chunked associative scan) and differentiates it
// with jax.grad, not as a Pallas kernel.
//
//   lru_scan       a, b (B, S, D) f32, h0 (B, D) f32 ->
//                  y (B, S, D) f32 with y_t = h_t = a_t h_{t-1} + b_t, and
//                  h_last (B, D) f32 = h_{S-1} (h0 when S = 0).
//   lru_scan_bwd   a, y (B, S, D) f32 (y the forward's states), h0, dh_last
//                  (B, D) f32 and dy (B, S, D) f32 ->
//                  g_{S-1} = dy_{S-1} + dh_last, g_t = dy_t + a_{t+1} g_{t+1},
//                  da_t = g_t h_{t-1} (h_{-1} = h0), db_t = g_t,
//                  dh0 = a_0 g_0 (dh_last when S = 0).
//
// One thread a (batch row, channel), walking the sequence in order (the
// backward in reverse): each step is one product and one sum, each rounded
// on its own (__fmul_rn, __fadd_rn, never contracted into an FMA), so y
// equals the plain sequential recurrence (kernels/ref.py lru_ref) bit for
// bit, and da, db, dh0 equal autograd of it (whose backward multiplies and
// adds in these two-operand steps, each rounded) bit for bit.
//
// What bounds both: bytes.  The forward reads 2 S D B floats and writes
// S D B, one multiply-add each; at recurrentgemma-9b's prefill (4, 1024,
// 4096) that is 201 MB, 60 us at the card's memory rate.  The backward
// reads a, y, dy and writes da, db: 5 S D B floats, 335 MB there, 100 us.
// The recurrence is serial in t, so the time is the latency of the loads
// unless many are in flight: a thread loads the next U steps into
// registers while it works through the current U, and consecutive threads
// own consecutive channels, so each step's loads and stores are coalesced
// across a warp.
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

constexpr int kUB = 16;  // the backward's steps in flight (three loads a step)

// Group j of the backward's walk, steps j U .. j U + U - 1: a_t, h_{t-1}
// (h0 for t = 0) and dy_t; zeros past either end.
__device__ __forceinline__ void load_group(const float* __restrict__ a,
                                           const float* __restrict__ y,
                                           const float* __restrict__ dy, size_t base, int D,
                                           int S, int j, float h_init, float (&ga)[kUB],
                                           float (&gh)[kUB], float (&gd)[kUB]) {
#pragma unroll
  for (int u = 0; u < kUB; ++u) {
    const int t = j * kUB + u;
    const bool in = j >= 0 && t < S;
    ga[u] = in ? a[base + (size_t)t * D] : 0.0f;
    gd[u] = in ? dy[base + (size_t)t * D] : 0.0f;
    gh[u] = !in ? 0.0f : t == 0 ? h_init : y[base + (size_t)(t - 1) * D];
  }
}

__global__ void __launch_bounds__(kThreads)
lru_scan_bwd_kernel(const float* __restrict__ a, const float* __restrict__ y,
                    const float* __restrict__ h0, const float* __restrict__ dy,
                    const float* __restrict__ dh_last, float* __restrict__ da,
                    float* __restrict__ db, float* __restrict__ dh0, int S, int D) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const int row = blockIdx.y;
  if (d >= D) return;
  const size_t base = (size_t)row * S * D + d;
  const float h_init = h0[(size_t)row * D + d];
  // the carry into step t: a_{t+1} g_{t+1}, dh_last into the last step
  float c = dh_last[(size_t)row * D + d];
  const int groups = (S + kUB - 1) / kUB;
  float ca[kUB], ch[kUB], cd[kUB];
  load_group(a, y, dy, base, D, S, groups - 1, h_init, ca, ch, cd);
  for (int j = groups - 1; j >= 0; --j) {
    // the group before's loads, issued before this group's dependent steps
    float na[kUB], nh[kUB], nd[kUB];
    load_group(a, y, dy, base, D, S, j - 1, h_init, na, nh, nd);
#pragma unroll
    for (int u = kUB - 1; u >= 0; --u) {
      const int t = j * kUB + u;
      if (t < S) {  // registers stay registers: every index is a constant
        const float g = __fadd_rn(cd[u], c);
        da[base + (size_t)t * D] = __fmul_rn(g, ch[u]);
        db[base + (size_t)t * D] = g;
        c = __fmul_rn(g, ca[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUB; ++u) {
      ca[u] = na[u];
      ch[u] = nh[u];
      cd[u] = nd[u];
    }
  }
  dh0[(size_t)row * D + d] = c;
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

// a, y, dy, da, db (B, S, D), h0, dh_last, dh0 (B, D), all f32 and
// contiguous.  Returns a CUDA error code (0 on success).
extern "C" int launch_lru_scan_bwd(const void* a, const void* y, const void* h0,
                                   const void* dy, const void* dh_last, void* da, void* db,
                                   void* dh0, int B, int S, int D, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B < 0 || S < 0 || D < 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || D == 0) return (int)cudaGetLastError();
  dim3 grid((unsigned)((D + kThreads - 1) / kThreads), (unsigned)B);
  lru_scan_bwd_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)y, (const float*)h0, (const float*)dy,
      (const float*)dh_last, (float*)da, (float*)db, (float*)dh0, S, D);
  return (int)cudaGetLastError();
}
