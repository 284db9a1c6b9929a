// Kernel 17: the RWKV-6 recurrence with a data-dependent decay, in chunks.
// It replaces, in src/repro/kernels/wkv6.py,
//
//   wkv6_pallas   r, k, w (B, S, H, K); v (B, S, H, V); u (H, K);
//                 s0 (B, H, K, V) -> y (B, S, H, V) in r's dtype and the
//                 final state (B, H, K, V) in f32, where
//                 S_t = diag(w_t) S_{t-1} + k_t v_t^T and
//                 y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T).
//
// Per chunk of C = 64 steps (the last chunk may be shorter: chunking changes
// only the rounding, and the reference, which asserts S % min(64, S) == 0,
// takes a subset of these lengths), with lw = log max(w, 1e-38), la = cumsum
// lw and la_prev = la - lw inside the chunk (wkv6.py:36-55):
//
//   y_t = (r_t exp(la_prev_t)) S
//       + sum_{tau < t} [sum_k r_tk k_tau,k exp(min(la_prev_tk - la_tau,k, 0))] v_tau
//       + (sum_k r_tk u_k k_tk) v_t
//   S  <- exp(la_C) S + (k exp(la_C - la))^T v
//
// The clamp inside the exp keeps a decay near 0 (log w -> -87) from
// overflowing: the two factors exp(la_prev) exp(-la) may each overflow, their
// product for tau < t never exceeds 1.
//
// r, k and v are f32 or bf16 (one dtype); w, u and s0 are f32, as the model
// path hands them over (models/rwkv6.py).  K, V <= 64.
//
// What bounds it on an H100: the C x C x K pairwise decay, one exp per term,
// and the chunk products, all in f32: 3.2 GFLOP at (4, 1024, 32, 64) against
// 105 MB moved, so the f32 rate bound lies above the byte bound, both of
// one order (tens of microseconds).
//
// Design.  The state carries from chunk to chunk, and Hopper blocks run in
// no set order, so one block per (b, h) walks the chunks in order and keeps
// the (K, V) f32 state in shared memory (the Pallas kernel's VMEM scratch).
// Per chunk, 256 threads: load r, k, v and lw; 64 threads run the cumsum of
// one column each; then the decayed r and k, the strictly lower-triangular
// (C, C) intra-chunk weights and the bonus; then y; then the state.  Every
// (C, 64) tile in shared memory has a row stride of 65 floats, so a warp
// walking a column or a row meets 32 distinct banks.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kC = 64;    // chunk length
constexpr int kD = 64;    // largest K and V
constexpr int kLd = kD + 1;
constexpr int kTile = kC * kLd;  // one (64, 64) tile with padded rows
constexpr int kTiles = 9;        // r k v la lap rdec kdec att S

size_t smem_bytes() { return sizeof(float) * ((size_t)kTiles * kTile + 3 * kD); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
            const float* __restrict__ w, const float* __restrict__ u,
            const float* __restrict__ s0, T* __restrict__ y, float* __restrict__ s_out, int S,
            int H, int K, int V) {
  extern __shared__ float smem[];
  float* rs = smem;
  float* ks = rs + kTile;
  float* vs = ks + kTile;
  float* la = vs + kTile;
  float* lap = la + kTile;
  float* rdec = lap + kTile;
  float* kdec = rdec + kTile;
  float* att = kdec + kTile;
  float* st = att + kTile;           // the state, (K, V)
  float* us = st + kTile;            // u row of this head, (K,)
  float* bonus = us + kD;            // (C,)
  float* la_end = bonus + kD;        // (K,)

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const long long kstride = (long long)H * K;  // between time steps of r, k, w
  const long long vstride = (long long)H * V;
  const size_t rk0 = (size_t)b * S * kstride + (size_t)h * K;
  const size_t v0 = (size_t)b * S * vstride + (size_t)h * V;

  for (int i = tid; i < K * V; i += kThreads) st[(i / V) * kLd + i % V] = s0[(size_t)bh * K * V + i];
  for (int i = tid; i < K; i += kThreads) us[i] = u[(size_t)h * K + i];

  for (int c0 = 0; c0 < S; c0 += kC) {
    const int C = min(kC, S - c0);
    __syncthreads();  // the previous chunk's state update is done
    for (int i = tid; i < C * K; i += kThreads) {
      const int t = i / K, kk = i % K;
      const size_t g = rk0 + (size_t)(c0 + t) * kstride + kk;
      rs[t * kLd + kk] = load_f32(r, g);
      ks[t * kLd + kk] = load_f32(k, g);
      la[t * kLd + kk] = logf(fmaxf(w[g], 1e-38f));  // lw for now
    }
    for (int i = tid; i < C * V; i += kThreads) {
      const int t = i / V, vv = i % V;
      vs[t * kLd + vv] = load_f32(v, v0 + (size_t)(c0 + t) * vstride + vv);
    }
    __syncthreads();

    // la = cumsum lw along the chunk, la_prev = la - lw
    if (tid < K) {
      float run = 0.0f;
      for (int t = 0; t < C; ++t) {
        const float lw = la[t * kLd + tid];
        run = run + lw;
        la[t * kLd + tid] = run;
        lap[t * kLd + tid] = run - lw;
      }
      la_end[tid] = run;
    }
    __syncthreads();

    // decayed r (inter-chunk term) and k (state update); the bonus
    for (int i = tid; i < C * K; i += kThreads) {
      const int t = i / K, kk = i % K;
      const int o = t * kLd + kk;
      rdec[o] = rs[o] * expf(lap[o]);
      kdec[o] = ks[o] * expf(la_end[kk] - la[o]);
    }
    if (tid < C) {
      float bsum = 0.0f;
      for (int kk = 0; kk < K; ++kk)
        bsum = fmaf(rs[tid * kLd + kk] * us[kk], ks[tid * kLd + kk], bsum);
      bonus[tid] = bsum;
    }
    // strictly lower-triangular intra-chunk weights att[t][tau], tau < t
    for (int i = tid; i < C * C; i += kThreads) {
      const int t = i / C, tau = i % C;
      float a = 0.0f;
      if (tau < t) {
        const float* rr = rs + t * kLd;
        const float* kr = ks + tau * kLd;
        const float* pr = lap + t * kLd;
        const float* lr = la + tau * kLd;
        for (int kk = 0; kk < K; ++kk)
          a = fmaf(rr[kk] * kr[kk], expf(fminf(pr[kk] - lr[kk], 0.0f)), a);
      }
      att[t * kLd + tau] = a;
    }
    __syncthreads();

    // y = inter + intra + bonus v
    for (int i = tid; i < C * V; i += kThreads) {
      const int t = i / V, vv = i % V;
      float inter = 0.0f;
      for (int kk = 0; kk < K; ++kk) inter = fmaf(rdec[t * kLd + kk], st[kk * kLd + vv], inter);
      float intra = 0.0f;
      for (int tau = 0; tau < t; ++tau) intra = fmaf(att[t * kLd + tau], vs[tau * kLd + vv], intra);
      const float out = (inter + intra) + bonus[t] * vs[t * kLd + vv];
      store_f32(y, v0 + (size_t)(c0 + t) * vstride + vv, out);
    }
    __syncthreads();

    // S <- exp(la_C) S + kdec^T v
    for (int i = tid; i < K * V; i += kThreads) {
      const int kk = i / V, vv = i % V;
      float acc = 0.0f;
      for (int t = 0; t < C; ++t) acc = fmaf(kdec[t * kLd + kk], vs[t * kLd + vv], acc);
      st[kk * kLd + vv] = expf(la_end[kk]) * st[kk * kLd + vv] + acc;
    }
  }
  __syncthreads();
  for (int i = tid; i < K * V; i += kThreads) s_out[(size_t)bh * K * V + i] = st[(i / V) * kLd + i % V];
}

template <typename T>
int wkv6_typed(const void* r, const void* k, const void* v, const float* w, const float* u,
               const float* s0, void* y, float* s_out, int B, int S, int H, int K, int V,
               cudaStream_t stream) {
  const size_t smem = smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(wkv6_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  wkv6_kernel<T><<<(unsigned)(B * H), kThreads, smem, stream>>>(
      (const T*)r, (const T*)k, (const T*)v, w, u, s0, (T*)y, s_out, S, H, K, V);
  return (int)cudaGetLastError();
}

}  // namespace

// r, k, v of ``dtype``; w, u, s0 and s_out f32.  Returns a CUDA error code.
extern "C" int launch_wkv6(const void* r, const void* k, const void* v, const void* w,
                           const void* u, const void* s0, void* y, void* s_out, int B, int S,
                           int H, int K, int V, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (K < 1 || K > kD || V < 1 || V > kD || S < 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0) return (int)cudaGetLastError();
  if (dtype == kF32)
    return wkv6_typed<float>(r, k, v, (const float*)w, (const float*)u, (const float*)s0, y,
                             (float*)s_out, B, S, H, K, V, (cudaStream_t)stream);
  if (dtype == kBF16)
    return wkv6_typed<__nv_bfloat16>(r, k, v, (const float*)w, (const float*)u,
                                     (const float*)s0, y, (float*)s_out, B, S, H, K, V,
                                     (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}
