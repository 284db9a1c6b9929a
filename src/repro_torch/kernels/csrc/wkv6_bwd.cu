// Kernel 17b: the backward of kernel 17, the RWKV-6 recurrence
//
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T,   y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T).
//
// The reference has no backward kernel: its launcher differentiates the
// "xla" branch (src/repro/kernels/ops.py _wkv6_chunked_xla).  Given the
// forward's operands, the states it passed between chunks (``states``, the
// state entering chunk c at slot c > 0; s0 enters chunk 0) and its final
// state, and the gradients dy (B, S, H, V) and ds_final (B, H, K, V) (null:
// zero), it returns dr, dk (B, S, H, K) and dv (B, S, H, V) in r's dtype,
// dw (B, S, H, K) f32 with respect to the kernel's w input, du f32 for each
// row of u, and ds0 (B, H, K, V) f32.
//
// Per chunk of C = 64 steps with lw = log max(w, 1e-38), la = cumsum lw and
// la_prev = la - lw (the forward's chunk form), entering state S0, leaving
// state S_C and dS_C the gradient at S_C:
//
//   g_t = dy_t . v_t,  b_t = r_t . u . k_t
//   datt[t, tau] = dy_t . v_tau (tau < t),  E[t, tau, k] = exp(min(la_prev_tk - la_tau,k, 0))
//   att[t, tau]  = sum_k r_tk k_tau,k E[t, tau, k]
//   dv_tau = sum_{t > tau} att[t, tau] dy_t + b_tau dy_tau + (dS_C^T (k_tau exp(la_C - la_tau)))
//   dr_t   = exp(la_prev_t) (S0 dy_t) + sum_{tau < t} datt[t, tau] k_tau E + g_t u k_t
//   dk_tau = sum_{t > tau} datt[t, tau] r_t E + g_tau u r_tau + exp(la_C - la_tau) (dS_C v_tau)
//   du    += sum_t g_t r_t k_t
//   dS0    = exp(la_C) dS_C + sum_t (r_t exp(la_prev_t)) dy_t^T
//
// and dla, the gradient at la, gathers r_t times the first two terms of
// dr_t (at la_prev_t), minus k_tau times the first and last terms of dk_tau
// (at la_tau), and sum_v dS_C S_C (at la_C); dlw is its reverse cumsum less
// the la_prev part, and dw = dlw / w where w >= 1e-38 (else 0), as autograd
// of log(clamp(w, 1e-38)) gives.
//
// Three grids a call, on the caller's stream, every sum in a fixed order
// (no float atomics), so a run repeats bitwise:
//
//   1. carry: one block per (b, h), walking the chunks backwards with dS in
//      registers (16 of the (K, V) entries a thread); it writes dS_C of
//      every chunk into ``dstates`` and ds0 at the end.
//   2. chunk: one block per (chunk, b * H + h), everything above for one
//      chunk from its S0, S_C and dS_C, in f32 shared memory (rows of 65
//      floats, so that a warp reading down a column hits 32 banks); its du
//      contribution goes to ``du_part`` (b * H + h, chunk, K).
//   3. du: one thread per (row of u, h, k), summing du_part over the batch
//      rows that share that row of u and over the chunks, in order.
//
// u has one row per group of ``u_div`` consecutive batch rows (u_div = B for
// a shared u; 1 row of u each client under the rounds' vmap, where the
// client dim is folded into the batch).
//
// A simple kernel: every exp of the chunk's pairs is taken three times
// (att, dr and dk) and the products run as scalar f32 loops; its time is
// recorded beside the bound.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kC = 64;          // chunk length
constexpr int kD = 64;          // largest K and V
constexpr int kLd = 65;         // row stride of a tile in shared memory
constexpr int kTile = kC * kLd;

// la = cumsum lw down column x (in step order, as the forward), la_prev =
// la - lw.  col holds lw on entry and la on exit.
__device__ __forceinline__ void cumsum_col(float* col, float* lap, int x) {
  float run = 0.0f;
  for (int t = 0; t < kC; ++t) {
    const float lw = col[t * kLd + x];
    run = run + lw;
    col[t * kLd + x] = run;
    lap[t * kLd + x] = run - lw;
  }
}

// Rows [c0, c0 + C) of one head of a (B, S, H, n) tensor into a (64, 65)
// tile as f32 (rows past C and columns past n: ``fill``).
template <typename T>
__device__ void load_tile(float* dst, const T* src, size_t base, long long stride, int C, int n,
                          float fill) {
  for (int i = threadIdx.x; i < kC * kD; i += kThreads) {
    const int t = i / kD, x = i % kD;
    dst[t * kLd + x] = (t < C && x < n) ? load_f32(src, base + (size_t)t * stride + x) : fill;
  }
}

// lw = log max(w, 1e-38) of the chunk (1 past its end: lw 0).
__device__ void load_lw(float* dst, const float* w, size_t base, long long stride, int C, int K) {
  for (int i = threadIdx.x; i < kC * kD; i += kThreads) {
    const int t = i / kD, x = i % kD;
    dst[t * kLd + x] = (t < C && x < K) ? logf(fmaxf(w[base + (size_t)t * stride + x], 1e-38f))
                                        : 0.0f;
  }
}

// 1. the state gradient carried backwards over the chunks.
template <typename T>
__global__ void __launch_bounds__(kThreads)
carry_kernel(const T* __restrict__ r, const float* __restrict__ w, const T* __restrict__ dy,
             const float* __restrict__ ds_final, float* __restrict__ dstates,
             float* __restrict__ ds0, int S, int H, int K, int V, int nc) {
  extern __shared__ float smem[];
  float* ra = smem;           // r, then r exp(la_prev)
  float* la = ra + kTile;     // lw, then la
  float* lp = la + kTile;     // la_prev
  float* dys = lp + kTile;    // dy
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const long long ks = (long long)H * K, vs = (long long)H * V;
  constexpr int kPer = kD * kD / kThreads;  // 16 entries a thread: (x, y) = e / 64, e % 64
  float ds[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int e = threadIdx.x + j * kThreads, x = e / kD, y = e % kD;
    ds[j] = (ds_final != nullptr && x < K && y < V)
                ? ds_final[(size_t)bh * K * V + (size_t)x * V + y]
                : 0.0f;
  }
  for (int c = nc - 1; c >= 0; --c) {
    const int c0 = c * kC, C = min(kC, S - c0);
    // dS_C of this chunk, before it is carried through the chunk
    float* dst = dstates + ((size_t)bh * nc + c) * K * V;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int e = threadIdx.x + j * kThreads, x = e / kD, y = e % kD;
      if (x < K && y < V) dst[(size_t)x * V + y] = ds[j];
    }
    __syncthreads();  // the previous chunk's tiles are consumed
    const size_t rk0 = ((size_t)b * S + c0) * ks + (size_t)h * K;
    const size_t v0 = ((size_t)b * S + c0) * vs + (size_t)h * V;
    load_tile(ra, r, rk0, ks, C, K, 0.0f);
    load_lw(la, w, rk0, ks, C, K);
    load_tile(dys, dy, v0, vs, C, V, 0.0f);
    __syncthreads();
    if (threadIdx.x < kD) cumsum_col(la, lp, threadIdx.x);
    __syncthreads();
    for (int i = threadIdx.x; i < kC * kD; i += kThreads) {
      const int t = i / kD, x = i % kD;
      ra[t * kLd + x] *= expf(lp[t * kLd + x]);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int e = threadIdx.x + j * kThreads, x = e / kD, y = e % kD;
      float acc = expf(la[(kC - 1) * kLd + x]) * ds[j];
      for (int t = 0; t < kC; ++t) acc = fmaf(ra[t * kLd + x], dys[t * kLd + y], acc);
      ds[j] = acc;
    }
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int e = threadIdx.x + j * kThreads, x = e / kD, y = e % kD;
    if (x < K && y < V) ds0[(size_t)bh * K * V + (size_t)x * V + y] = ds[j];
  }
}

// 2. one chunk's gradients.
template <typename T>
__global__ void __launch_bounds__(kThreads)
chunk_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
             const float* __restrict__ w, const float* __restrict__ u,
             const float* __restrict__ s_init, const float* __restrict__ s_out,
             const float* __restrict__ states, const T* __restrict__ dy,
             const float* __restrict__ dstates, T* __restrict__ dr, T* __restrict__ dk,
             T* __restrict__ dv, float* __restrict__ dw, float* __restrict__ du_part, int S,
             int H, int K, int V, int nc, int u_div) {
  extern __shared__ float smem[];
  float* rs = smem;              // r             (t, k)
  float* kk = rs + kTile;        // k             (t, k)
  float* vv = kk + kTile;        // v             (t, v)
  float* dys = vv + kTile;       // dy            (t, v)
  float* la = dys + kTile;       // lw, then la   (t, k)
  float* lp = la + kTile;        // la_prev       (t, k)
  float* s0 = lp + kTile;        // S0 (k, v), then dla at la (t, k)
  float* dsc = s0 + kTile;       // dS_C          (k, v)
  float* att = dsc + kTile;      // att (t, tau), then dla at la_prev (t, k)
  float* datt = att + kTile;     // datt          (t, tau)
  float* ec = datt + kTile;      // k_tau exp(la_C - la_tau)   (tau, k)
  float* us = ec + kTile;        // u of this row and head
  float* gs = us + kD;           // g_t
  float* bs = gs + kD;           // b_t
  float* dlc = bs + kD;          // dla at la_C

  const int c = blockIdx.x, bh = blockIdx.y, b = bh / H, h = bh % H;
  const int c0 = c * kC, C = min(kC, S - c0);
  const long long ks = (long long)H * K, vs = (long long)H * V;
  const size_t rk0 = ((size_t)b * S + c0) * ks + (size_t)h * K;
  const size_t v0 = ((size_t)b * S + c0) * vs + (size_t)h * V;
  const float* S0 = c > 0 ? states + ((size_t)bh * nc + c) * K * V : s_init + (size_t)bh * K * V;
  const float* SC = c + 1 < nc ? states + ((size_t)bh * nc + c + 1) * K * V
                               : s_out + (size_t)bh * K * V;
  const float* dSC = dstates + ((size_t)bh * nc + c) * K * V;
  const int tid = threadIdx.x;

  load_tile(rs, r, rk0, ks, C, K, 0.0f);
  load_tile(kk, k, rk0, ks, C, K, 0.0f);
  load_tile(vv, v, v0, vs, C, V, 0.0f);
  load_tile(dys, dy, v0, vs, C, V, 0.0f);
  load_lw(la, w, rk0, ks, C, K);
  for (int i = tid; i < kD * kD; i += kThreads) {
    const int x = i / kD, y = i % kD;
    const bool in = x < K && y < V;
    s0[x * kLd + y] = in ? S0[(size_t)x * V + y] : 0.0f;
    dsc[x * kLd + y] = in ? dSC[(size_t)x * V + y] : 0.0f;
  }
  if (tid < kD) us[tid] = tid < K ? u[((size_t)(b / u_div) * H + h) * K + tid] : 0.0f;
  __syncthreads();
  if (tid < kD) {
    cumsum_col(la, lp, tid);
  } else if (tid < 2 * kD) {  // dla at la_C: sum_v dS_C S_C, row x of the state
    const int x = tid - kD;
    float s = 0.0f;
    if (x < K)
      for (int y = 0; y < V; ++y) s = fmaf(dsc[x * kLd + y], SC[(size_t)x * V + y], s);
    dlc[x] = s;
  }
  __syncthreads();
  if (tid < kC) {  // g_t and b_t
    const int t = tid;
    float g = 0.0f, bb = 0.0f;
    for (int y = 0; y < kD; ++y) g = fmaf(dys[t * kLd + y], vv[t * kLd + y], g);
    for (int x = 0; x < kD; ++x) bb = fmaf(rs[t * kLd + x] * us[x], kk[t * kLd + x], bb);
    gs[t] = g;
    bs[t] = bb;
  }
  for (int i = tid; i < kC * kD; i += kThreads) {
    const int t = i / kD, x = i % kD;
    ec[t * kLd + x] = kk[t * kLd + x] * expf(la[(kC - 1) * kLd + x] - la[t * kLd + x]);
  }
  // att and datt, (t, tau) a thread at a time, lanes along tau
  for (int i = tid; i < kC * kC; i += kThreads) {
    const int t = i / kC, tau = i % kC;
    float a = 0.0f, da = 0.0f;
    if (tau < t) {
      for (int x = 0; x < kD; ++x)
        a = fmaf(rs[t * kLd + x] * kk[tau * kLd + x],
                 expf(fminf(lp[t * kLd + x] - la[tau * kLd + x], 0.0f)), a);
      for (int y = 0; y < kD; ++y) da = fmaf(dys[t * kLd + y], vv[tau * kLd + y], da);
    }
    att[t * kLd + tau] = a;
    datt[t * kLd + tau] = da;
  }
  __syncthreads();

  // dv, (tau, v) a thread, lanes along v
  for (int i = tid; i < kC * kD; i += kThreads) {
    const int tau = i / kD, y = i % kD;
    float acc = bs[tau] * dys[tau * kLd + y];
    for (int t = tau + 1; t < kC; ++t) acc = fmaf(att[t * kLd + tau], dys[t * kLd + y], acc);
    for (int x = 0; x < kD; ++x) acc = fmaf(dsc[x * kLd + y], ec[tau * kLd + x], acc);
    if (tau < C && y < V) store_f32(dv, v0 + (size_t)tau * vs + y, acc);
  }
  __syncthreads();  // att is consumed: it takes dla at la_prev below

  // dr and dla at la_prev, (t, k) a thread, lanes along k
  for (int i = tid; i < kC * kD; i += kThreads) {
    const int t = i / kD, x = i % kD;
    float inter = 0.0f;
    for (int y = 0; y < kD; ++y) inter = fmaf(s0[x * kLd + y], dys[t * kLd + y], inter);
    inter *= expf(lp[t * kLd + x]);
    float intra = 0.0f;
    for (int tau = 0; tau < t; ++tau)
      intra = fmaf(datt[t * kLd + tau] * kk[tau * kLd + x],
                   expf(fminf(lp[t * kLd + x] - la[tau * kLd + x], 0.0f)), intra);
    const float rv = inter + intra + gs[t] * us[x] * kk[t * kLd + x];
    att[t * kLd + x] = rs[t * kLd + x] * (inter + intra);
    if (t < C && x < K) store_f32(dr, rk0 + (size_t)t * ks + x, rv);
  }
  __syncthreads();  // s0 is consumed: it takes dla at la below

  // dk and dla at la, (tau, k) a thread, lanes along k
  for (int i = tid; i < kC * kD; i += kThreads) {
    const int tau = i / kD, x = i % kD;
    float intra = 0.0f;
    for (int t = tau + 1; t < kC; ++t)
      intra = fmaf(datt[t * kLd + tau] * rs[t * kLd + x],
                   expf(fminf(lp[t * kLd + x] - la[tau * kLd + x], 0.0f)), intra);
    float carry = 0.0f;
    for (int y = 0; y < kD; ++y) carry = fmaf(dsc[x * kLd + y], vv[tau * kLd + y], carry);
    carry *= expf(la[(kC - 1) * kLd + x] - la[tau * kLd + x]);
    const float kv = intra + gs[tau] * us[x] * rs[tau * kLd + x] + carry;
    s0[tau * kLd + x] = -kk[tau * kLd + x] * (intra + carry);
    if (tau < C && x < K) store_f32(dk, rk0 + (size_t)tau * ks + x, kv);
  }
  __syncthreads();

  if (tid < kD) {
    const int x = tid;
    // du: sum_t g_t r_t k_t
    float d_u = 0.0f;
    for (int t = 0; t < kC; ++t) d_u = fmaf(gs[t] * rs[t * kLd + x], kk[t * kLd + x], d_u);
    if (x < K) du_part[((size_t)bh * nc + c) * K + x] = d_u;
    // dlw_s = sum_{t >= s} (dla_t + dla_prev_t) - dla_prev_s, with dla_C at the last row
    float run = dlc[x];
    for (int s = kC - 1; s >= 0; --s) {
      const float dlp = att[s * kLd + x];
      run += s0[s * kLd + x] + dlp;
      if (s < C && x < K) {
        const float ws = w[rk0 + (size_t)s * ks + x];
        dw[rk0 + (size_t)s * ks + x] = ws >= 1e-38f ? (run - dlp) / ws : 0.0f;
      }
    }
  }
}

// 3. du per row of u: the batch rows of its group, then the chunks, in order.
__global__ void du_kernel(const float* __restrict__ du_part, float* __restrict__ du, int H,
                          int K, int nc, int u_div, int n_u) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_u * H * K) return;
  const int x = i % K, h = (i / K) % H, ur = i / (K * H);
  float s = 0.0f;
  for (int b = ur * u_div; b < (ur + 1) * u_div; ++b)
    for (int c = 0; c < nc; ++c) s += du_part[(((size_t)b * H + h) * nc + c) * K + x];
  du[i] = s;
}

size_t carry_smem() { return sizeof(float) * 4 * kTile; }
size_t chunk_smem() { return sizeof(float) * (11 * (size_t)kTile + 4 * kD); }

template <typename T>
int launch_typed(const void* r, const void* k, const void* v, const float* w, const float* u,
                 const float* s0, const float* s_out, const float* states, const void* dy,
                 const float* ds_final, void* dr, void* dk, void* dv, float* dw, float* du,
                 float* ds0, float* dstates, float* du_part, int B, int S, int H, int K, int V,
                 int u_div, cudaStream_t stream) {
  const int nc = (S + kC - 1) / kC, BH = B * H, n_u = B / u_div;
  cudaError_t err = cudaFuncSetAttribute(carry_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)carry_smem());
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)chunk_smem());
  if (err != cudaSuccess) return (int)err;
  carry_kernel<T><<<BH, kThreads, carry_smem(), stream>>>((const T*)r, w, (const T*)dy,
                                                          ds_final, dstates, ds0, S, H, K, V, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (nc > 0) {
    chunk_kernel<T><<<dim3((unsigned)nc, (unsigned)BH), kThreads, chunk_smem(), stream>>>(
        (const T*)r, (const T*)k, (const T*)v, w, u, s0, s_out, states, (const T*)dy, dstates,
        (T*)dr, (T*)dk, (T*)dv, dw, du_part, S, H, K, V, nc, u_div);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int n = n_u * H * K;
  du_kernel<<<(n + 255) / 256, 256, 0, stream>>>(du_part, du, H, K, nc, u_div, n_u);
  return (int)cudaGetLastError();
}

}  // namespace

// r, k, dy, dr, dk (B, S, H, K) / v, dv (B, S, H, V) of ``dtype``; w, dw
// (B, S, H, K), u (B / u_div, H, K), du the same, s0, s_out, ds_final, ds0
// (B, H, K, V) and ``states`` (the forward's scratch) f32, all contiguous;
// ds_final may be null (zero).  Scratch: ``dstates`` B H nc K V floats and
// ``du_part`` B H nc K floats (nc = ceil(S / 64)).  Returns a CUDA error
// code.
extern "C" int launch_wkv6_bwd(const void* r, const void* k, const void* v, const void* w,
                               const void* u, const void* s0, const void* s_out,
                               const void* states, const void* dy, const void* ds_final,
                               void* dr, void* dk, void* dv, void* dw, void* du, void* ds0,
                               void* dstates, void* du_part, int B, int S, int H, int K, int V,
                               int u_div, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (K < 1 || K > kD || V < 1 || V > kD || S < 0 || u_div < 1 || B % u_div != 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == kF32)
    return launch_typed<float>(r, k, v, (const float*)w, (const float*)u, (const float*)s0,
                               (const float*)s_out, (const float*)states, dy,
                               (const float*)ds_final, dr, dk, dv, (float*)dw, (float*)du,
                               (float*)ds0, (float*)dstates, (float*)du_part, B, S, H, K, V,
                               u_div, st);
  if (dtype == kBF16)
    return launch_typed<__nv_bfloat16>(r, k, v, (const float*)w, (const float*)u,
                                       (const float*)s0, (const float*)s_out,
                                       (const float*)states, dy, (const float*)ds_final, dr, dk,
                                       dv, (float*)dw, (float*)du, (float*)ds0, (float*)dstates,
                                       (float*)du_part, B, S, H, K, V, u_div, st);
  return (int)cudaErrorInvalidValue;
}
