// The RG-LRU's linear recurrence, its backward and the tangents of both
// (forward mode), kernels of the port's own: the reference runs the
// recurrence as plain JAX (src/repro/kernels/ops.py:683 lru_scan, a chunked
// associative scan) and differentiates it with jax.grad, not as a Pallas
// kernel.
//
//   lru_scan       a, b (B, S, D) f32, h0 (B, D) f32 ->
//                  y (B, S, D) f32 with y_t = h_t = a_t h_{t-1} + b_t, and
//                  h_last (B, D) f32 = h_{S-1} (h0 when S = 0).
//   lru_scan_bwd   a, y (B, S, D) f32 (y the forward's states), h0, dh_last
//                  (B, D) f32 and dy (B, S, D) f32 ->
//                  g_{S-1} = dy_{S-1} + dh_last, g_t = dy_t + a_{t+1} g_{t+1},
//                  da_t = g_t h_{t-1} (h_{-1} = h0), db_t = g_t,
//                  dh0 = a_0 g_0 (dh_last when S = 0).
//   lru_scan_jvp   a, y (B, S, D), h0 (B, D) and the tangents a', b' (B, S,
//                  D), h0' (B, D), all f32 ->
//                  y'_t = (h'_{t-1} a_t + a'_t h_{t-1}) + b'_t (h_{-1} = h0,
//                  h'_{-1} = h0'), h_last' = y'_{S-1} (h0' when S = 0).
//   lru_scan_bwd_jvp  lru_scan_bwd's operands a, y, h0, dy, dh_last and their
//                  tangents a', y', h0', dy', dh_last', all f32 -> the
//                  tangents of its outputs: walking back with the primal
//                  carry c beside the tangent's c' (c = dh_last, c' =
//                  dh_last' into the last step), g = dy_t + c, g' = dy'_t +
//                  c', da'_t = h'_{t-1} g + g' h_{t-1}, db'_t = g', c = g a_t,
//                  c' = a'_t g + g' a_t; dh0' = the last c'.
//
// One thread a (batch row, channel), walking the sequence in order (the
// backward in reverse): each step is one product and one sum, each rounded
// on its own (__fmul_rn, __fadd_rn, never contracted into an FMA), so y
// equals the plain sequential recurrence (kernels/ref.py lru_ref) bit for
// bit, and da, db, dh0 equal autograd of it (whose backward multiplies and
// adds in these two-operand steps, each rounded) bit for bit.
//
// The tangent kernels replace no TPU kernel either: the reference takes
// jax.jvp of the plain scan and of its jax.grad (src/repro/core/
// autotune.py:140-159, the curvature probe of --eta auto).  Their products
// and sums are rounded in the order of torch's forward-mode formulas for
// mul (other' self + self' other) and add, so y', h_last' equal
// torch.func.jvp of kernels/ref.py lru_ref and da', db', dh0' that of
// lru_bwd_ref bit for bit (kernels/ref.py lru_jvp_ref, lru_bwd_jvp_ref
// write the order out).  lru_scan_jvp reads a, y, a', b' and writes y': 5 S
// D B floats, bytes-bound as the forward; lru_scan_bwd_jvp reads a, y, dy
// and their tangents and writes da', db': 8 S D B floats.
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


constexpr int kUJ = 16;  // the forward tangent's steps in flight (four loads a step)

__global__ void __launch_bounds__(kThreads)
lru_scan_jvp_kernel(const float* __restrict__ a, const float* __restrict__ y,
                    const float* __restrict__ h0, const float* __restrict__ at,
                    const float* __restrict__ bt, const float* __restrict__ h0t,
                    float* __restrict__ yt, float* __restrict__ h_last_t, int S, int D) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const int row = blockIdx.y;
  if (d >= D) return;
  const size_t base = (size_t)row * S * D + d;
  const float h_init = h0[(size_t)row * D + d];
  float ht = h0t[(size_t)row * D + d];
  // step t's a_t, h_{t-1}, a'_t, b'_t; zeros past the end
  float ca[kUJ], ch[kUJ], cat[kUJ], cbt[kUJ];
#pragma unroll
  for (int u = 0; u < kUJ; ++u) {
    const bool in = u < S;
    ca[u] = in ? a[base + (size_t)u * D] : 0.0f;
    ch[u] = !in ? 0.0f : u == 0 ? h_init : y[base + (size_t)(u - 1) * D];
    cat[u] = in ? at[base + (size_t)u * D] : 0.0f;
    cbt[u] = in ? bt[base + (size_t)u * D] : 0.0f;
  }
  for (int t0 = 0; t0 < S; t0 += kUJ) {
    float na[kUJ], nh[kUJ], nat[kUJ], nbt[kUJ];
#pragma unroll
    for (int u = 0; u < kUJ; ++u) {
      const int t = t0 + kUJ + u;
      const bool in = t < S;
      na[u] = in ? a[base + (size_t)t * D] : 0.0f;
      nh[u] = in ? y[base + (size_t)(t - 1) * D] : 0.0f;
      nat[u] = in ? at[base + (size_t)t * D] : 0.0f;
      nbt[u] = in ? bt[base + (size_t)t * D] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kUJ; ++u) {
      if (t0 + u < S) {
        ht = __fadd_rn(__fadd_rn(__fmul_rn(ht, ca[u]), __fmul_rn(cat[u], ch[u])), cbt[u]);
        yt[base + (size_t)(t0 + u) * D] = ht;
      }
    }
#pragma unroll
    for (int u = 0; u < kUJ; ++u) {
      ca[u] = na[u];
      ch[u] = nh[u];
      cat[u] = nat[u];
      cbt[u] = nbt[u];
    }
  }
  h_last_t[(size_t)row * D + d] = ht;
}

constexpr int kUBJ = 8;  // the backward tangent's steps in flight (six loads a step)

// Group j of the backward tangent's walk: a_t, a'_t, h_{t-1}, h'_{t-1} (h0,
// h0' for t = 0), dy_t and dy'_t; zeros past either end.
struct JvpGroup {
  float a[kUBJ], at[kUBJ], h[kUBJ], ht[kUBJ], dy[kUBJ], dyt[kUBJ];
};

__device__ __forceinline__ void load_jvp_group(
    const float* __restrict__ a, const float* __restrict__ y, const float* __restrict__ dy,
    const float* __restrict__ at, const float* __restrict__ yt, const float* __restrict__ dyt,
    size_t base, int D, int S, int j, float h_init, float ht_init, JvpGroup& g) {
#pragma unroll
  for (int u = 0; u < kUBJ; ++u) {
    const int t = j * kUBJ + u;
    const bool in = j >= 0 && t < S;
    const size_t i = base + (size_t)t * D, ip = base + (size_t)(t - 1) * D;
    g.a[u] = in ? a[i] : 0.0f;
    g.at[u] = in ? at[i] : 0.0f;
    g.dy[u] = in ? dy[i] : 0.0f;
    g.dyt[u] = in ? dyt[i] : 0.0f;
    g.h[u] = !in ? 0.0f : t == 0 ? h_init : y[ip];
    g.ht[u] = !in ? 0.0f : t == 0 ? ht_init : yt[ip];
  }
}

__global__ void __launch_bounds__(kThreads)
lru_scan_bwd_jvp_kernel(const float* __restrict__ a, const float* __restrict__ y,
                        const float* __restrict__ h0, const float* __restrict__ dy,
                        const float* __restrict__ dh_last, const float* __restrict__ at,
                        const float* __restrict__ yt, const float* __restrict__ h0t,
                        const float* __restrict__ dyt, const float* __restrict__ dh_last_t,
                        float* __restrict__ da_t, float* __restrict__ db_t,
                        float* __restrict__ dh0_t, int S, int D) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const int row = blockIdx.y;
  if (d >= D) return;
  const size_t base = (size_t)row * S * D + d;
  const float h_init = h0[(size_t)row * D + d], ht_init = h0t[(size_t)row * D + d];
  float c = dh_last[(size_t)row * D + d], ct = dh_last_t[(size_t)row * D + d];
  const int groups = (S + kUBJ - 1) / kUBJ;
  JvpGroup cur, nxt;
  load_jvp_group(a, y, dy, at, yt, dyt, base, D, S, groups - 1, h_init, ht_init, cur);
  for (int j = groups - 1; j >= 0; --j) {
    load_jvp_group(a, y, dy, at, yt, dyt, base, D, S, j - 1, h_init, ht_init, nxt);
#pragma unroll
    for (int u = kUBJ - 1; u >= 0; --u) {
      const int t = j * kUBJ + u;
      if (t < S) {
        const float g = __fadd_rn(cur.dy[u], c);
        const float gt = __fadd_rn(cur.dyt[u], ct);
        da_t[base + (size_t)t * D] = __fadd_rn(__fmul_rn(cur.ht[u], g), __fmul_rn(gt, cur.h[u]));
        db_t[base + (size_t)t * D] = gt;
        ct = __fadd_rn(__fmul_rn(cur.at[u], g), __fmul_rn(gt, cur.a[u]));
        c = __fmul_rn(g, cur.a[u]);
      }
    }
    cur = nxt;
  }
  dh0_t[(size_t)row * D + d] = ct;
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

// a, y, at, bt, yt (B, S, D), h0, h0t, h_last_t (B, D), all f32 and
// contiguous.  Returns a CUDA error code (0 on success).
extern "C" int launch_lru_scan_jvp(const void* a, const void* y, const void* h0, const void* at,
                                   const void* bt, const void* h0t, void* yt, void* h_last_t,
                                   int B, int S, int D, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B < 0 || S < 0 || D < 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || D == 0) return (int)cudaGetLastError();
  dim3 grid((unsigned)((D + kThreads - 1) / kThreads), (unsigned)B);
  lru_scan_jvp_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)y, (const float*)h0, (const float*)at, (const float*)bt,
      (const float*)h0t, (float*)yt, (float*)h_last_t, S, D);
  return (int)cudaGetLastError();
}

// a, y, dy, at, yt, dyt, da_t, db_t (B, S, D), h0, dh_last, h0t, dh_last_t,
// dh0_t (B, D), all f32 and contiguous.  Returns a CUDA error code.
extern "C" int launch_lru_scan_bwd_jvp(const void* a, const void* y, const void* h0,
                                       const void* dy, const void* dh_last, const void* at,
                                       const void* yt, const void* h0t, const void* dyt,
                                       const void* dh_last_t, void* da_t, void* db_t,
                                       void* dh0_t, int B, int S, int D, int device,
                                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B < 0 || S < 0 || D < 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || D == 0) return (int)cudaGetLastError();
  dim3 grid((unsigned)((D + kThreads - 1) / kThreads), (unsigned)B);
  lru_scan_bwd_jvp_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)y, (const float*)h0, (const float*)dy,
      (const float*)dh_last, (const float*)at, (const float*)yt, (const float*)h0t,
      (const float*)dyt, (const float*)dh_last_t, (float*)da_t, (float*)db_t, (float*)dh0_t,
      S, D);
  return (int)cudaGetLastError();
}
