// Kernels 17j and 17bj: the tangents (forward mode) of kernels 17 and 17b,
// the RWKV-6 recurrence
//
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T,   y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T).
//
// The reference has no kernel for either: its curvature probe (--eta auto)
// takes jax.jvp of jax.grad through the "xla" branch
// (src/repro/kernels/ops.py _wkv6_chunked_xla).  ' marks a tangent.
//
// Per chunk of C = 64 steps with lw = log max(w, 1e-38), la = cumsum lw,
// la_prev = la - lw (the forward's chunk form and rounding), lw' = w' / w
// where w >= 1e-38 (0 elsewhere, the clamp's), la' = cumsum lw',
// la'_prev = la' - lw', the pairwise decay E[t, tau, k] = exp(min(la_prev_tk
// - la_tau,k, 0)) and its tangent E' = E (la'_prev_tk - la'_tau,k) where the
// clamp passes:
//
// 17j, wkv6_jvp: (y', S_final') from the primals, the forward's states
// entering each chunk (wkv6(..., keep_states=True)) and r', k', v', w', u',
// s0':
//
//   y'_t = ((r'_t + r_t la'_prev_t) e^{la_prev_t}) S + (r_t e^{la_prev_t}) S'
//        + sum_{tau<t} (att'[t, tau] v_tau + att[t, tau] v'_tau) + b'_t v_t + b_t v'_t
//   att' = sum_k (r' k + r k' + r k (la'_prev_t - la'_tau)) E,  b' = r' u k + r u' k + r u k'
//   S'  <- e^{la_C} (S' + la'_C S) + sum_tau [(k'_tau + k_tau (la'_C - la'_tau)) e^{la_C - la_tau}]^T v_tau
//                                           + (k_tau e^{la_C - la_tau})^T v'_tau
//
// 17bj, wkv6_bwd_jvp: (dr', dk', dv', dw', du', ds0') of kernel 17b's
// outputs, from the primals, their tangents, dy, dy', ds_final and
// ds_final' (null: zero).  It forms the tangents of the states itself (the
// forward's states are non-differentiable, so no tangent of them arrives):
// with g_t = dy_t . v_t, datt[t, tau] = dy_t . v_tau, S and S' entering the
// chunk, S_C, S_C' leaving it, dS, dS' the gradient at S_C and its tangent,
// ec_tau = e^{la_C - la_tau},
//
//   X_t   = e^{la_prev_t} (S dy_t) + sum_{tau<t} datt[t, tau] k_tau E      dr = X + g u k
//   Y_tau = ec_tau (dS v_tau) + sum_{t>tau} datt[t, tau] r_t E             dk = Y + g u r
//   dv_tau = sum_{t>=tau} att[t, tau] dy_t (b at t = tau) + dS^T (k_tau ec_tau)
//   dla_prev = r X, dla = -k Y (+ sum_v dS S_C at la_C), dlw_s = sum_{t>=s} (dla_t
//   + dla_prev_t) - dla_prev_s, dw = dlw / w;  du = sum_t g_t r_t k_t
//   dS_in = e^{la_C} dS + sum_t (r_t e^{la_prev_t})^T dy_t
//
// and the tangent of each line (dw' = (dlw' - dlw w' / w) / w).  The plain
// versions, ref.wkv6_jvp_ref and ref.wkv6_bwd_jvp_ref, are this text line for
// line.
//
// Design.  Every kernel here runs one block per (chunk, b * H + h), all
// chunks at once, with the chunk form's direct pairwise decays (one exp per
// (t, tau, k), clamped at 0 as the reference's): every decay is <= 1, so no
// pivot is needed for range, and the states at the chunk's two ends carry
// everything that crosses it.  Only the (K, V) states pass from chunk to
// chunk, through f32 scratch and one flag per chunk in a zeroed int32 buffer;
// blocks draw their chunk from an atomic ticket in chunk-major order (reverse
// chunk-major for the backward's pass), so the block a block waits on has
// always started (the decoupled look-back of kernels 17 and 17b).
//
//   17j: one launch of wkv6_jvp_kernel<T, true>.  A block loads its chunk and
//        the tangents, takes la, la_prev and their tangents down each column,
//        att and att' for every pair (tau <= t, the bonus on the diagonal),
//        the chunk's own part of S'_C, then waits for S' entering the chunk,
//        publishes S'_C for the next, and forms y'.  The primal S entering the
//        chunk is read from the forward's states.
//   17bj: four launches, counted as one call: (a) wkv6_jvp_kernel<T, false>,
//        17j's state pass alone, which writes S' at every chunk entry and the
//        final S'; (b) wkv6_dstate_kernel, the reverse walk that carries the
//        pair (dS, dS') from chunk to chunk; (c) wkv6_bwd_jvp_kernel, every
//        output, with every state it reads ready-made (no flags): the pair
//        sums of dr, dr', dk, dk' in registers, one thread a (row, column)
//        item; (d) du_kernel, du' per row of u in a fixed order.  Splitting
//        (b) from (c) keeps (c) at fourteen (64, 64) f32 tiles, 224 KB of
//        shared memory; carrying the pair inside (c) as 17b does would need
//        two state tiles more than an H100 block holds.
//
// f32 on the CUDA cores, no atomics on floats: every sum runs in a fixed
// order, so a run repeats bitwise.  K, V <= 64; r, k, v, dy and their
// tangents f32 or bf16 (one dtype); w, u, s0, ds_final and their tangents
// f32; u' has u's rows (u_div batch rows a row).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kC = 64;           // chunk length
constexpr int kD = 64;           // largest K and V
constexpr int kTile = kC * kD;   // one (64, 64) f32 tile, rows of 64 floats
constexpr int kGroups = kThreads / kD;  // item loops: thread (I, x) takes rows I + 4 j, column x
constexpr int kItems = kC / kGroups;    // 16 items a thread

// Spin until *flag is set by another block.  A flag that never comes (a
// fault) traps after about ten seconds instead of hanging.
__device__ __forceinline__ void wait_flag(const int* flag) {
  const long long start = clock64();
  while (*reinterpret_cast<const volatile int*>(flag) == 0) {
    if (clock64() - start > (1LL << 34)) __trap();
  }
  __threadfence();
}

// A (64, 64) tile of a (B, S, H, n) operand at rows base.. (stride between
// steps), as f32; rows past C and columns past n are 0.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, size_t base, long long stride,
                                          int C, int n) {
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const int t = i / kD, x = i % kD;
    dst[i] = t < C && x < n ? load_f32(src, base + (size_t)t * stride + x) : 0.0f;
  }
}

// lw = log max(w, 1e-38) and lw' = w' / w where w >= 1e-38 (else 0); rows
// past C and columns past K take w = 1 (both 0).
__device__ __forceinline__ void load_log_decay(float* lw, float* lwt, const float* w,
                                               const float* wt, size_t base, long long stride,
                                               int C, int K) {
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const int t = i / kD, x = i % kD;
    float a = 0.0f, b = 0.0f;
    if (t < C && x < K) {
      const size_t g = base + (size_t)t * stride + x;
      const float wv = w[g];
      a = logf(fmaxf(wv, 1e-38f));
      b = wv >= 1e-38f ? wt[g] / wv : 0.0f;
    }
    lw[i] = a;
    lwt[i] = b;
  }
}

// la = cumsum lw down column x, in place, in step order (torch.cumsum's and
// kernel 17's rounding), and, where lap is given, la_prev = la - lw.
__device__ __forceinline__ void cumsum_column(float* col, float* lap, int x) {
  float run = 0.0f;
#pragma unroll 4
  for (int t = 0; t < kC; ++t) {
    const float lw = col[t * kD + x];
    run = run + lw;
    col[t * kD + x] = run;
    if (lap != nullptr) lap[t * kD + x] = run - lw;
  }
}

// The pairwise decay of (t, tau) at column x and its tangent, from la_prev_t
// (lp, lpt) and la_tau (la, lat): E = exp(min(lp - la, 0)), E' = E (lpt -
// lat) where the clamp passes.
__device__ __forceinline__ void pair_decay(float lp, float lpt, float la, float lat, float& e,
                                           float& et) {
  const float d = lp - la;
  e = __expf(fminf(d, 0.0f));
  et = d <= 0.0f ? (lpt - lat) * e : 0.0f;
}

// The (K, V) f32 state at src (null: zero) for this thread's items, rows
// kk = I + 4 j, column x, through L2 (another block may have written it).
__device__ __forceinline__ void load_state_items(float (&s)[kItems], const float* src, int I, int x,
                                                 int K, int V) {
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int kk = I + kGroups * j;
    s[j] = src != nullptr && kk < K && x < V ? __ldcg(src + (size_t)kk * V + x) : 0.0f;
  }
}

// A (K, V) f32 state at src (null: zero) into a (64, 64) tile, zero-padded.
__device__ __forceinline__ void load_state_tile(float* dst, const float* src, int K, int V) {
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const int kk = i / kD, x = i % kD;
    dst[i] = src != nullptr && kk < K && x < V ? __ldcg(src + (size_t)kk * V + x) : 0.0f;
  }
}

// b_t = r_t . u . k_t and its tangent for row t (one thread a row), the
// columns skewed by the lane as att's are.
__device__ __forceinline__ void bonus_row(float* bs, float* bts, const float* rs, const float* rts,
                                          const float* ks, const float* kts, const float* us,
                                          const float* uts, int t) {
  const int lane = threadIdx.x & 31;
  float a = 0.0f, at = 0.0f;
  for (int q = 0; q < kD; ++q) {
    const int y = (q + lane) % kD;
    const float rv = rs[t * kD + y], kv = ks[t * kD + y], uv = us[y];
    a = fmaf(rv * uv, kv, a);
    at = fmaf(rts[t * kD + y] * uv, kv, fmaf(rv * uts[y], kv, fmaf(rv * uv, kts[t * kD + y], at)));
  }
  bs[t] = a;
  bts[t] = at;
}

// att[t, tau] = sum_k r_t k_tau E and att' (r' k E + r k' E + r k E') for
// every pair tau < t, b and b' on the diagonal, 0 elsewhere: lanes take
// consecutive tau of one row t, their columns skewed so that the lanes' rows
// of k hit distinct banks.
__device__ __forceinline__ void att_pairs(float* att, float* att_t, const float* rs,
                                          const float* rts, const float* ks, const float* kts,
                                          const float* lp, const float* lpt, const float* la,
                                          const float* lat, const float* bs, const float* bts,
                                          int C) {
  const int lane = threadIdx.x & 31;
#pragma unroll 1
  for (int j = 0; j < kTile / kThreads; ++j) {
    const int i = threadIdx.x + j * kThreads, t = i / kD, tau = i % kD;
    float a = 0.0f, at = 0.0f;
    if (tau < t && t < C) {
#pragma unroll 4
      for (int q = 0; q < kD; ++q) {
        const int y = (q + lane) % kD;
        const float rv = rs[t * kD + y], kv = ks[tau * kD + y];
        float e, et;
        pair_decay(lp[t * kD + y], lpt[t * kD + y], la[tau * kD + y], lat[tau * kD + y], e, et);
        const float rk = rv * kv;
        a = fmaf(rk, e, a);
        at = fmaf(rts[t * kD + y] * kv + rv * kts[tau * kD + y], e, fmaf(rk, et, at));
      }
    } else if (tau == t && t < C) {
      a = bs[t];
      at = bts[t];
    }
    att[i] = a;
    att_t[i] = at;
  }
}

// k decayed to the chunk's end, k e^{la_C - la}, and its tangent (k' + k
// (la'_C - la')) e^{la_C - la}, in place (la_C: the tile's last row).
__device__ __forceinline__ void k_to_chunk_end(float* ks, float* kts, const float* la,
                                               const float* lat) {
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const int xx = i % kD;
    const float e = __expf(la[(kC - 1) * kD + xx] - la[i]);
    const float kv = ks[i];
    ks[i] = kv * e;
    kts[i] = (kts[i] + kv * (lat[(kC - 1) * kD + xx] - lat[i])) * e;
  }
}

// ---------------------------------------------------------------------------
// 17j, and with kOut false its state pass alone (17bj's launch (a))
// ---------------------------------------------------------------------------

template <bool kOut>
size_t jvp_smem_bytes() {
  return sizeof(float) * ((size_t)(kOut ? 12 : 6) * kTile + 4 * kD) + 16;
}

template <typename T, bool kOut>
__global__ void __launch_bounds__(kThreads, 1)
wkv6_jvp_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                const float* __restrict__ w, const float* __restrict__ u,
                const float* __restrict__ s_init, const float* __restrict__ states,
                const T* __restrict__ rt, const T* __restrict__ kt, const T* __restrict__ vt,
                const float* __restrict__ wt, const float* __restrict__ ut,
                const float* __restrict__ s_init_t, T* __restrict__ yt, float* __restrict__ s_out_t,
                float* tstates, int* sync, int S, int H, int K, int V, int nc, int BH,
                int u_div) {
  extern __shared__ float smem[];
  float* la = smem;             // lw, then la                                    (t, k)
  float* lat = la + kTile;      // lw', then la'
  float* ks = lat + kTile;      // k, then k e^{la_C - la}, then S                (t, k)
  float* kts = ks + kTile;      // k', then (k' + k (la'_C - la')) e^{la_C - la}, then S'
  float* vs = kts + kTile;      // v                                              (t, v)
  float* vts = vs + kTile;      // v'
  float* rs = vts + kTile;      // r, then r e^{la_prev}                  (kOut)  (t, k)
  float* rts = rs + kTile;      // r', then (r' + r la'_prev) e^{la_prev}
  float* lp = rts + kTile;      // la_prev
  float* lpt = lp + kTile;      // la'_prev
  float* att = lpt + kTile;     // att[t, tau], b_t at tau = t                    (t, tau)
  float* att_t = att + kTile;   // att', b'_t
  float* us = (kOut ? att_t + kTile : vts + kTile);  // u of this row and head
  float* uts = us + kD;         // u'
  float* bs = uts + kD;         // b_t = r_t . u . k_t
  float* bts = bs + kD;         // b'_t
  int* ticket = reinterpret_cast<int*>(bts + kD);

  const int tid = threadIdx.x;
  if (tid == 0) *ticket = atomicAdd(sync, 1);
  __syncthreads();
  const int c = *ticket / BH, bh = *ticket % BH;  // chunk-major: chunk c - 1 has started
  const int b = bh / H, h = bh % H;
  const int c0 = c * kC;
  const int C = min(kC, S - c0);
  const long long kstride = (long long)H * K, vstride = (long long)H * V;
  const size_t rk0 = ((size_t)b * S + c0) * kstride + (size_t)h * K;
  const size_t v0 = ((size_t)b * S + c0) * vstride + (size_t)h * V;
  const size_t KV = (size_t)K * V;
  const int I = tid / kD, x = tid % kD;

  // 1. the chunk, its tangents, la and la' (and la_prev, la'_prev)
  load_tile(ks, k, rk0, kstride, C, K);
  load_tile(kts, kt, rk0, kstride, C, K);
  load_tile(vs, v, v0, vstride, C, V);
  load_tile(vts, vt, v0, vstride, C, V);
  load_log_decay(la, lat, w, wt, rk0, kstride, C, K);
  if (kOut) {
    load_tile(rs, r, rk0, kstride, C, K);
    load_tile(rts, rt, rk0, kstride, C, K);
    if (tid < kD) {
      const size_t ui = ((size_t)(b / u_div) * H + h) * K + tid;
      us[tid] = tid < K ? u[ui] : 0.0f;
      uts[tid] = tid < K ? ut[ui] : 0.0f;
    }
  }
  __syncthreads();
  if (tid < kD) cumsum_column(la, kOut ? lp : nullptr, tid);
  else if (tid < 2 * kD) cumsum_column(lat, kOut ? lpt : nullptr, tid - kD);
  else if (kOut && tid < 3 * kD) bonus_row(bs, bts, rs, rts, ks, kts, us, uts, tid - 2 * kD);
  __syncthreads();

  // 2. att and att' of every pair (t, tau), the bonus and its tangent on the
  // diagonal
  if (kOut) {
    att_pairs(att, att_t, rs, rts, ks, kts, lp, lpt, la, lat, bs, bts, C);
    __syncthreads();
  }

  // 3. k decayed to the chunk's end and its tangent, in place
  k_to_chunk_end(ks, kts, la, lat);
  __syncthreads();

  // 4. the chunk's own part of S'_C, items (row kk = I + 4 j, column x):
  // sum_tau k'd_tau,kk v_tau,x + kd_tau,kk v'_tau,x
  float wacc[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) wacc[j] = 0.0f;
#pragma unroll 1
  for (int tau = 0; tau < C; ++tau) {
    const float vv = vs[tau * kD + x], vtv = vts[tau * kD + x];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int kk = I + kGroups * j;
      wacc[j] = fmaf(kts[tau * kD + kk], vv, fmaf(ks[tau * kD + kk], vtv, wacc[j]));
    }
  }

  // 5. S entering the chunk (the forward's), S' (the chunk before's, or s0'),
  // and S'_C for the next chunk (the last chunk writes the final S')
  float sp[kItems], spt[kItems];
  load_state_items(sp, c > 0 ? states + ((size_t)bh * nc + c) * KV : s_init + (size_t)bh * KV, I,
                   x, K, V);
  if (c > 0) {
    if (tid == 0) wait_flag(sync + 1 + (size_t)bh * nc + c);
    __syncthreads();
  }
  load_state_items(spt, c > 0 ? tstates + ((size_t)bh * nc + c) * KV : s_init_t + (size_t)bh * KV,
                   I, x, K, V);
  {
    float* dst = c + 1 < nc ? tstates + ((size_t)bh * nc + c + 1) * KV : s_out_t + (size_t)bh * KV;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int kk = I + kGroups * j;
      if (kk < K && x < V) {
        const float ec = expf(la[(kC - 1) * kD + kk]);
        dst[(size_t)kk * V + x] = fmaf(ec, fmaf(lat[(kC - 1) * kD + kk], sp[j], spt[j]), wacc[j]);
      }
    }
    if (c + 1 < nc) {
      __threadfence();
      __syncthreads();
      if (tid == 0) atomicExch(sync + 1 + (size_t)bh * nc + c + 1, 1);
    }
  }
  if (!kOut) return;

  // 6. S and S' into the k tiles; r decayed from the chunk's start and its
  // tangent, in place
  __syncthreads();  // every read of the decayed k is done
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int kk = I + kGroups * j;
    ks[kk * kD + x] = sp[j];
    kts[kk * kD + x] = spt[j];
  }
  for (int i = tid; i < kTile; i += kThreads) {
    const float e = __expf(lp[i]), rv = rs[i];
    rs[i] = rv * e;
    rts[i] = (rts[i] + rv * lpt[i]) * e;
  }
  __syncthreads();

  // 7. y', items (row t = I + 4 j, column x)
#pragma unroll 1
  for (int j = 0; j < kItems; ++j) {
    const int t = I + kGroups * j;
    if (t >= C) break;
    float acc = 0.0f;
#pragma unroll 4
    for (int kk = 0; kk < kD; ++kk)
      acc = fmaf(rts[t * kD + kk], ks[kk * kD + x], fmaf(rs[t * kD + kk], kts[kk * kD + x], acc));
    for (int tau = 0; tau <= t; ++tau)
      acc = fmaf(att_t[t * kD + tau], vs[tau * kD + x], fmaf(att[t * kD + tau], vts[tau * kD + x], acc));
    if (x < V) store_f32(yt, v0 + (size_t)t * vstride + x, acc);
  }
}

// ---------------------------------------------------------------------------
// 17bj (b): the state gradient and its tangent, chunk to chunk in reverse
// ---------------------------------------------------------------------------

size_t dstate_smem_bytes() { return sizeof(float) * ((size_t)6 * kTile + 2 * kD) + 16; }

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
wkv6_dstate_kernel(const T* __restrict__ r, const float* __restrict__ w, const T* __restrict__ dy,
                   const float* __restrict__ ds_final, const T* __restrict__ rt,
                   const float* __restrict__ wt, const T* __restrict__ dyt,
                   const float* __restrict__ ds_final_t, float* __restrict__ ds0t,
                   float* dstates, float* dstates_t, int* sync, int S, int H, int K, int V,
                   int nc, int BH) {
  extern __shared__ float smem[];
  float* rs = smem;             // r, then r e^{la_prev}                          (t, k)
  float* rts = rs + kTile;      // r', then (r' + r la'_prev) e^{la_prev}
  float* dys = rts + kTile;     // dy                                             (t, v)
  float* dyts = dys + kTile;    // dy'
  float* la = dyts + kTile;     // lw                                             (t, k)
  float* lat = la + kTile;      // lw'
  float* lac = lat + kTile;     // la_C
  float* latc = lac + kD;       // la'_C
  int* ticket = reinterpret_cast<int*>(latc + kD);

  const int tid = threadIdx.x;
  if (tid == 0) *ticket = atomicAdd(sync, 1);
  __syncthreads();
  const int c = nc - 1 - *ticket / BH, bh = *ticket % BH;  // reverse: chunk c + 1 has started
  const int b = bh / H, h = bh % H;
  const int c0 = c * kC;
  const int C = min(kC, S - c0);
  const long long kstride = (long long)H * K, vstride = (long long)H * V;
  const size_t rk0 = ((size_t)b * S + c0) * kstride + (size_t)h * K;
  const size_t v0 = ((size_t)b * S + c0) * vstride + (size_t)h * V;
  const size_t KV = (size_t)K * V;
  const int I = tid / kD, x = tid % kD;

  load_tile(rs, r, rk0, kstride, C, K);
  load_tile(rts, rt, rk0, kstride, C, K);
  load_tile(dys, dy, v0, vstride, C, V);
  load_tile(dyts, dyt, v0, vstride, C, V);
  load_log_decay(la, lat, w, wt, rk0, kstride, C, K);
  __syncthreads();
  if (tid < kD) {  // column tid: la, la_prev and their tangents, r decayed in place
    float run = 0.0f, runt = 0.0f;
    for (int t = 0; t < kC; ++t) {
      const int i = t * kD + tid;
      const float lw = la[i], lwt = lat[i];
      run = run + lw;
      runt = runt + lwt;
      const float lpv = run - lw, lptv = runt - lwt;
      const float e = __expf(lpv), rv = rs[i];
      rs[i] = rv * e;
      rts[i] = (rts[i] + rv * lptv) * e;
    }
    lac[tid] = run;
    latc[tid] = runt;
  }
  __syncthreads();

  // the chunk's own part of the state gradient entering it, items (row kk =
  // I + 4 j, column x): sum_t rd_t,kk dy_t,x and its tangent
  float xa[kItems], xt[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) xa[j] = xt[j] = 0.0f;
#pragma unroll 1
  for (int t = 0; t < C; ++t) {
    const float d = dys[t * kD + x], dt = dyts[t * kD + x];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int kk = I + kGroups * j;
      const float rd = rs[t * kD + kk];
      xa[j] = fmaf(rd, d, xa[j]);
      xt[j] = fmaf(rts[t * kD + kk], d, fmaf(rd, dt, xt[j]));
    }
  }
  if (c + 1 < nc) {
    if (tid == 0) wait_flag(sync + 1 + (size_t)bh * nc + c + 1);
    __syncthreads();
  }
  float g[kItems], gt[kItems];
  load_state_items(g, c + 1 < nc ? dstates + ((size_t)bh * nc + c + 1) * KV
                                 : (ds_final != nullptr ? ds_final + (size_t)bh * KV : nullptr),
                   I, x, K, V);
  load_state_items(gt, c + 1 < nc ? dstates_t + ((size_t)bh * nc + c + 1) * KV
                                  : (ds_final_t != nullptr ? ds_final_t + (size_t)bh * KV : nullptr),
                   I, x, K, V);
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int kk = I + kGroups * j;
    if (kk >= K || x >= V) continue;
    const float ec = expf(lac[kk]);
    const float dtan = fmaf(ec, fmaf(latc[kk], g[j], gt[j]), xt[j]);
    if (c > 0) {
      dstates[((size_t)bh * nc + c) * KV + (size_t)kk * V + x] = fmaf(ec, g[j], xa[j]);
      dstates_t[((size_t)bh * nc + c) * KV + (size_t)kk * V + x] = dtan;
    } else {
      ds0t[(size_t)bh * KV + (size_t)kk * V + x] = dtan;
    }
  }
  if (c > 0) {  // the block's stores, then one release by thread 0
    __syncthreads();
    if (tid == 0) {
      __threadfence();
      atomicExch(sync + 1 + (size_t)bh * nc + c, 1);
    }
  }
}

// ---------------------------------------------------------------------------
// 17bj (c): every output of a chunk, from the states at its two ends
// ---------------------------------------------------------------------------

size_t bwd_smem_bytes() { return sizeof(float) * ((size_t)14 * kTile + 8 * kD) + 16; }

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
wkv6_bwd_jvp_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                    const float* __restrict__ w, const float* __restrict__ u,
                    const float* __restrict__ s_init, const float* __restrict__ s_out,
                    const float* __restrict__ states, const T* __restrict__ dy,
                    const float* __restrict__ ds_final, const T* __restrict__ rt,
                    const T* __restrict__ kt, const T* __restrict__ vt,
                    const float* __restrict__ wt, const float* __restrict__ ut,
                    const float* __restrict__ s_init_t, const T* __restrict__ dyt,
                    const float* __restrict__ ds_final_t, const float* __restrict__ tstates,
                    const float* __restrict__ s_out_t, const float* __restrict__ dstates,
                    const float* __restrict__ dstates_t, T* __restrict__ drt,
                    T* __restrict__ dkt, T* __restrict__ dvt, float* __restrict__ dwt,
                    float* __restrict__ du_part, int S, int H, int K, int V, int nc, int BH,
                    int u_div) {
  extern __shared__ float smem[];
  float* rs = smem;             // r, then dS, then dla + dla_prev               (t, k)
  float* rts = rs + kTile;      // r', then dS', then dla' + dla'_prev
  float* ks = rts + kTile;      // k, then k ec, then S
  float* kts = ks + kTile;      // k', then k' ec + k ec', then S'
  float* vs = kts + kTile;      // v                                             (t, v)
  float* vts = vs + kTile;      // v'
  float* dys = vts + kTile;     // dy
  float* dyts = dys + kTile;    // dy'
  float* la = dyts + kTile;     // la                                            (t, k)
  float* lat = la + kTile;      // la'
  float* lp = lat + kTile;      // la_prev
  float* lpt = lp + kTile;      // la'_prev
  float* pa = lpt + kTile;      // datt, then att, then dla_prev                 (t, tau)
  float* pat = pa + kTile;      // datt', then att', then dla'_prev
  float* us = pat + kTile;      // u, u', g, g', b, b', la_C's gradient and its tangent
  float* uts = us + kD;
  float* gs = uts + kD;
  float* gts = gs + kD;
  float* bs = gts + kD;
  float* bts = bs + kD;
  float* dlc = bts + kD;
  float* dlct = dlc + kD;

  const int tid = threadIdx.x, lane = tid & 31;
  const int c = blockIdx.x / BH, bh = blockIdx.x % BH;
  const int b = bh / H, h = bh % H;
  const int c0 = c * kC;
  const int C = min(kC, S - c0);
  const long long kstride = (long long)H * K, vstride = (long long)H * V;
  const size_t rk0 = ((size_t)b * S + c0) * kstride + (size_t)h * K;
  const size_t v0 = ((size_t)b * S + c0) * vstride + (size_t)h * V;
  const size_t KV = (size_t)K * V;
  const int I = tid / kD, x = tid % kD;

  // 1. the chunk and its tangents; la, la_prev and theirs; g, g', b, b'
  load_tile(rs, r, rk0, kstride, C, K);
  load_tile(rts, rt, rk0, kstride, C, K);
  load_tile(ks, k, rk0, kstride, C, K);
  load_tile(kts, kt, rk0, kstride, C, K);
  load_tile(vs, v, v0, vstride, C, V);
  load_tile(vts, vt, v0, vstride, C, V);
  load_tile(dys, dy, v0, vstride, C, V);
  load_tile(dyts, dyt, v0, vstride, C, V);
  load_log_decay(la, lat, w, wt, rk0, kstride, C, K);
  if (tid < kD) {
    const size_t ui = ((size_t)(b / u_div) * H + h) * K + tid;
    us[tid] = tid < K ? u[ui] : 0.0f;
    uts[tid] = tid < K ? ut[ui] : 0.0f;
  }
  __syncthreads();
  if (tid < kD) {
    cumsum_column(la, lp, tid);
  } else if (tid < 2 * kD) {
    cumsum_column(lat, lpt, tid - kD);
  } else if (tid < 3 * kD) {  // g_t = dy_t . v_t and its tangent
    const int t = tid - 2 * kD;
    float a = 0.0f, at = 0.0f;
    for (int q = 0; q < kD; ++q) {
      const int y = (q + lane) % kD;
      const float d = dys[t * kD + y], vv = vs[t * kD + y];
      a = fmaf(d, vv, a);
      at = fmaf(dyts[t * kD + y], vv, fmaf(d, vts[t * kD + y], at));
    }
    gs[t] = a;
    gts[t] = at;
  } else {
    bonus_row(bs, bts, rs, rts, ks, kts, us, uts, tid - 3 * kD);
  }
  __syncthreads();

  // 2. datt and datt' of every pair tau < t (lanes: consecutive tau, skewed
  // columns)
#pragma unroll 1
  for (int j = 0; j < kTile / kThreads; ++j) {
    const int i = tid + j * kThreads, t = i / kD, tau = i % kD;
    float a = 0.0f, at = 0.0f;
    if (tau < t && t < C) {
#pragma unroll 4
      for (int q = 0; q < kD; ++q) {
        const int y = (q + lane) % kD;
        const float d = dys[t * kD + y], vv = vs[tau * kD + y];
        a = fmaf(d, vv, a);
        at = fmaf(dyts[t * kD + y], vv, fmaf(d, vts[tau * kD + y], at));
      }
    }
    pa[i] = a;
    pat[i] = at;
  }
  __syncthreads();

  // 3. the pair sums of dr and dk and their tangents, items (row I + 4 j,
  // column x): for dr the row is t (tau < t), for dk it is tau (t > tau)
  float xr[kItems], xrt[kItems], yk[kItems], ykt[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int t = I + kGroups * j;
    float a = 0.0f, at = 0.0f;
    if (t < C) {
      const float lpv = lp[t * kD + x], lptv = lpt[t * kD + x];
      for (int tau = 0; tau < t; ++tau) {
        float e, et;
        pair_decay(lpv, lptv, la[tau * kD + x], lat[tau * kD + x], e, et);
        const float d = pa[t * kD + tau], dt = pat[t * kD + tau];
        const float kv = ks[tau * kD + x];
        a = fmaf(d * kv, e, a);
        at = fmaf(dt * kv + d * kts[tau * kD + x], e, fmaf(d * kv, et, at));
      }
    }
    xr[j] = a;
    xrt[j] = at;
  }
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int tau = I + kGroups * j;
    float a = 0.0f, at = 0.0f;
    if (tau < C) {
      const float lav = la[tau * kD + x], latv = lat[tau * kD + x];
      for (int t = tau + 1; t < C; ++t) {
        float e, et;
        pair_decay(lp[t * kD + x], lpt[t * kD + x], lav, latv, e, et);
        const float d = pa[t * kD + tau], dt = pat[t * kD + tau];
        const float rv = rs[t * kD + x];
        a = fmaf(d * rv, e, a);
        at = fmaf(dt * rv + d * rts[t * kD + x], e, fmaf(d * rv, et, at));
      }
    }
    yk[j] = a;
    ykt[j] = at;
  }
  __syncthreads();  // every read of datt is done

  // 4. att and att' of every pair, b and b' on the diagonal (17j's step 2)
  att_pairs(pa, pat, rs, rts, ks, kts, lp, lpt, la, lat, bs, bts, C);
  __syncthreads();  // every read of r and k is done

  // 5. dS, dS' into the r tiles; k decayed to the chunk's end and its tangent
  // in place; la_C's gradient and its tangent
  const float* dsrc = c + 1 < nc ? dstates + ((size_t)bh * nc + c + 1) * KV
                                 : (ds_final != nullptr ? ds_final + (size_t)bh * KV : nullptr);
  const float* dsrc_t = c + 1 < nc ? dstates_t + ((size_t)bh * nc + c + 1) * KV
                                   : (ds_final_t != nullptr ? ds_final_t + (size_t)bh * KV : nullptr);
  load_state_tile(rs, dsrc, K, V);
  load_state_tile(rts, dsrc_t, K, V);
  k_to_chunk_end(ks, kts, la, lat);
  __syncthreads();
  if (tid < kD) {  // row tid of the states: sum_v dS S_C, sum_v dS' S_C + dS S_C'
    const float* sc = c + 1 < nc ? states + ((size_t)bh * nc + c + 1) * KV : s_out + (size_t)bh * KV;
    const float* sct = c + 1 < nc ? tstates + ((size_t)bh * nc + c + 1) * KV
                                  : s_out_t + (size_t)bh * KV;
    float a = 0.0f, at = 0.0f;
    if (tid < K) {
      for (int q = 0; q < V; ++q) {
        const float sv = __ldcg(sc + (size_t)tid * V + q), d = rs[tid * kD + q];
        a = fmaf(d, sv, a);
        at = fmaf(rts[tid * kD + q], sv, fmaf(d, __ldcg(sct + (size_t)tid * V + q), at));
      }
    }
    dlc[tid] = a;
    dlct[tid] = at;
  }

  // 6. dv', items (row tau = I + 4 j, column x): the pairs t >= tau and
  // dS^T (k ec) with their tangents
#pragma unroll 1
  for (int j = 0; j < kItems; ++j) {
    const int tau = I + kGroups * j;
    if (tau >= C) break;
    float acc = 0.0f;
    for (int t = tau; t < C; ++t)
      acc = fmaf(pat[t * kD + tau], dys[t * kD + x], fmaf(pa[t * kD + tau], dyts[t * kD + x], acc));
#pragma unroll 4
    for (int kk = 0; kk < kD; ++kk)
      acc = fmaf(rts[kk * kD + x], ks[tau * kD + kk], fmaf(rs[kk * kD + x], kts[tau * kD + kk], acc));
    if (x < V) store_f32(dvt, v0 + (size_t)tau * vstride + x, acc);
  }
  // ... and Y = ec (dS v) + pairs, items (row tau, column x = k), columns of
  // the states skewed by lane
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int tau = I + kGroups * j;
    float bm = 0.0f, bmt = 0.0f;
#pragma unroll 4
    for (int q = 0; q < kD; ++q) {
      const int y = (q + lane) % kD;
      const float d = rs[x * kD + y], vv = vs[tau * kD + y];
      bm = fmaf(d, vv, bm);
      bmt = fmaf(rts[x * kD + y], vv, fmaf(d, vts[tau * kD + y], bmt));
    }
    const float ec = __expf(la[(kC - 1) * kD + x] - la[tau * kD + x]);
    const float lt = lat[(kC - 1) * kD + x] - lat[tau * kD + x];
    ykt[j] = fmaf(ec, fmaf(lt, bm, bmt), ykt[j]);
    yk[j] = fmaf(ec, bm, yk[j]);
  }
  __syncthreads();  // every read of dS, k ec and att is done

  // 7. S and S' entering the chunk into the k tiles; X = e^{la_prev} (S dy) +
  // pairs and its tangent, items (row t, column x = k)
  load_state_tile(ks, c > 0 ? states + ((size_t)bh * nc + c) * KV : s_init + (size_t)bh * KV, K, V);
  load_state_tile(kts, c > 0 ? tstates + ((size_t)bh * nc + c) * KV : s_init_t + (size_t)bh * KV,
                  K, V);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int t = I + kGroups * j;
    float a = 0.0f, at = 0.0f;
#pragma unroll 4
    for (int q = 0; q < kD; ++q) {
      const int y = (q + lane) % kD;
      const float s = ks[x * kD + y], d = dys[t * kD + y];
      a = fmaf(s, d, a);
      at = fmaf(kts[x * kD + y], d, fmaf(s, dyts[t * kD + y], at));
    }
    const float lpv = lp[t * kD + x];
    const float e = __expf(lpv);
    xrt[j] = fmaf(e, fmaf(lpt[t * kD + x], a, at), xrt[j]);
    xr[j] = fmaf(e, a, xr[j]);
  }

  // 8. dr', dk'; the gradients at la_prev and la and their tangents into the
  // pair and r tiles for step 9; du's share
  float dus = 0.0f;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int t = I + kGroups * j;
    float p1 = 0.0f, p2 = 0.0f, p3 = 0.0f, p4 = 0.0f;
    if (t < C && x < K) {
      const size_t gi = rk0 + (size_t)t * kstride + x;
      const float rv = load_f32(r, gi), rtv = load_f32(rt, gi);
      const float kv = load_f32(k, gi), ktv = load_f32(kt, gi);
      const float uv = us[x], utv = uts[x], g = gs[t], gt = gts[t];
      store_f32(drt, gi, xrt[j] + gt * uv * kv + g * utv * kv + g * uv * ktv);
      store_f32(dkt, gi, ykt[j] + gt * uv * rv + g * utv * rv + g * uv * rtv);
      const float dlp = rv * xr[j], dlpt = rtv * xr[j] + rv * xrt[j];
      const float dla = -kv * yk[j], dlat = -(ktv * yk[j] + kv * ykt[j]);
      p1 = dla + dlp;
      p2 = dlp;
      p3 = dlat + dlpt;
      p4 = dlpt;
      dus += gt * rv * kv + g * rtv * kv + g * rv * ktv;
    }
    rs[t * kD + x] = p1;
    pa[t * kD + x] = p2;
    rts[t * kD + x] = p3;
    pat[t * kD + x] = p4;
  }
  float* dup = lp;  // la_prev is consumed: (I, x) du shares
  __syncthreads();
  dup[I * kD + x] = dus;
  __syncthreads();

  // 9. dw' down each column: dlw_s = sum_{t >= s} (dla_t + dla_prev_t) -
  // dla_prev_s with la_C's gradient on the last row, and its tangent; du's
  // share of the chunk in a fixed order
  if (tid < kD) {
    float run = dlc[tid], runt = dlct[tid];
    for (int s = kC - 1; s >= 0; --s) {
      run += rs[s * kD + tid];
      runt += rts[s * kD + tid];
      if (s < C && tid < K) {
        const size_t gi = rk0 + (size_t)s * kstride + tid;
        const float wv = w[gi];
        const float dlw = run - pa[s * kD + tid], dlwt = runt - pat[s * kD + tid];
        dwt[gi] = wv >= 1e-38f ? (dlwt - dlw * (wt[gi] / wv)) / wv : 0.0f;
      }
    }
    if (tid < K) {
      float d = 0.0f;
      for (int g = 0; g < kGroups; ++g) d += dup[g * kD + tid];
      du_part[((size_t)bh * nc + c) * K + tid] = d;
    }
  }
}

// du' per row of u: the batch rows of its group, then the chunks, in order.
__global__ void du_kernel(const float* __restrict__ du_part, float* __restrict__ du, int H, int K,
                          int nc, int u_div, int n_u) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_u * H * K) return;
  const int x = i % K, h = (i / K) % H, ur = i / (K * H);
  float s = 0.0f;
  for (int b = ur * u_div; b < (ur + 1) * u_div; ++b)
    for (int c = 0; c < nc; ++c) s += du_part[(((size_t)b * H + h) * nc + c) * K + x];
  du[i] = s;
}

template <typename T, bool kOut>
cudaError_t launch_jvp_pass(const void* r, const void* k, const void* v, const float* w,
                            const float* u, const float* s0, const float* states, const void* rt,
                            const void* kt, const void* vt, const float* wt, const float* ut,
                            const float* s0t, void* yt, float* s_out_t, float* tstates, int* sync,
                            int B, int S, int H, int K, int V, int u_div, cudaStream_t stream) {
  const int nc = (S + kC - 1) / kC, BH = B * H;
  const size_t smem = jvp_smem_bytes<kOut>();
  cudaError_t err = cudaFuncSetAttribute(wkv6_jvp_kernel<T, kOut>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  wkv6_jvp_kernel<T, kOut><<<(unsigned)((size_t)BH * nc), kThreads, smem, stream>>>(
      (const T*)r, (const T*)k, (const T*)v, w, u, s0, states, (const T*)rt, (const T*)kt,
      (const T*)vt, wt, ut, s0t, (T*)yt, s_out_t, tstates, sync, S, H, K, V, nc, BH, u_div);
  return cudaGetLastError();
}

template <typename T>
int jvp_typed(const void* r, const void* k, const void* v, const float* w, const float* u,
              const float* s0, const float* states, const void* rt, const void* kt,
              const void* vt, const float* wt, const float* ut, const float* s0t, void* yt,
              float* s_out_t, float* tstates, int* sync, int B, int S, int H, int K, int V,
              int u_div, cudaStream_t stream) {
  if (S == 0)  // no steps: the state's tangent passes through
    return (int)cudaMemcpyAsync(s_out_t, s0t, sizeof(float) * (size_t)B * H * K * V,
                                cudaMemcpyDeviceToDevice, stream);
  return (int)launch_jvp_pass<T, true>(r, k, v, w, u, s0, states, rt, kt, vt, wt, ut, s0t, yt,
                                       s_out_t, tstates, sync, B, S, H, K, V, u_div, stream);
}

template <typename T>
int bwd_jvp_typed(const void* r, const void* k, const void* v, const float* w, const float* u,
                  const float* s0, const float* s_out, const float* states, const void* dy,
                  const float* ds_final, const void* rt, const void* kt, const void* vt,
                  const float* wt, const float* ut, const float* s0t, const void* dyt,
                  const float* ds_final_t, void* drt, void* dkt, void* dvt, float* dwt,
                  float* dut, float* ds0t, float* tstates, float* s_out_t, float* dstates,
                  float* dstates_t, float* du_part, int* sync, int B, int S, int H, int K, int V,
                  int u_div, cudaStream_t stream) {
  const int nc = (S + kC - 1) / kC, BH = B * H, n_u = B / u_div;
  cudaError_t err;
  if (nc == 0) {  // no steps: ds0' is ds_final', du' is 0
    const size_t bytes = sizeof(float) * (size_t)BH * K * V;
    err = ds_final_t != nullptr
              ? cudaMemcpyAsync(ds0t, ds_final_t, bytes, cudaMemcpyDeviceToDevice, stream)
              : cudaMemsetAsync(ds0t, 0, bytes, stream);
    if (err == cudaSuccess)
      err = cudaMemsetAsync(dut, 0, sizeof(float) * (size_t)n_u * H * K, stream);
    return (int)err;
  }
  // (a) S' at every chunk entry and the final S'
  err = launch_jvp_pass<T, false>(r, k, v, w, u, s0, states, rt, kt, vt, wt, ut, s0t, nullptr,
                                  s_out_t, tstates, sync, B, S, H, K, V, u_div, stream);
  if (err != cudaSuccess) return (int)err;
  // (b) the pair (dS, dS') in reverse
  size_t smem = dstate_smem_bytes();
  err = cudaFuncSetAttribute(wkv6_dstate_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  wkv6_dstate_kernel<T><<<(unsigned)((size_t)BH * nc), kThreads, smem, stream>>>(
      (const T*)r, w, (const T*)dy, ds_final, (const T*)rt, wt, (const T*)dyt, ds_final_t, ds0t,
      dstates, dstates_t, sync + 1 + (size_t)BH * nc, S, H, K, V, nc, BH);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // (c) the outputs
  smem = bwd_smem_bytes();
  err = cudaFuncSetAttribute(wkv6_bwd_jvp_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  wkv6_bwd_jvp_kernel<T><<<(unsigned)((size_t)BH * nc), kThreads, smem, stream>>>(
      (const T*)r, (const T*)k, (const T*)v, w, u, s0, s_out, states, (const T*)dy, ds_final,
      (const T*)rt, (const T*)kt, (const T*)vt, wt, ut, s0t, (const T*)dyt, ds_final_t, tstates,
      s_out_t, dstates, dstates_t, (T*)drt, (T*)dkt, (T*)dvt, dwt, du_part, S, H, K, V, nc, BH,
      u_div);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // (d) du'
  const int n = n_u * H * K;
  du_kernel<<<(n + 255) / 256, 256, 0, stream>>>(du_part, dut, H, K, nc, u_div, n_u);
  return (int)cudaGetLastError();
}

}  // namespace

// 17j.  r, k, rt, kt (B, S, H, K) / v, vt, yt (B, S, H, V) of ``dtype``; w,
// wt (B, S, H, K), u, ut (B / u_div, H, K), s0, s0t, s_out_t (B, H, K, V) and
// ``states`` (kernel 17's scratch: the state entering each chunk c > 0) f32,
// all contiguous.  Scratch: ``tstates`` B H nc K V floats, ``sync`` int32 of
// 1 + B H nc, zeroed (nc = ceil(S / 64)).  Returns a CUDA error code.
extern "C" int launch_wkv6_jvp(const void* r, const void* k, const void* v, const void* w,
                               const void* u, const void* s0, const void* states, const void* rt,
                               const void* kt, const void* vt, const void* wt, const void* ut,
                               const void* s0t, void* yt, void* s_out_t, void* tstates,
                               void* sync, int B, int S, int H, int K, int V, int u_div,
                               int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (K < 1 || K > kD || V < 1 || V > kD || S < 0 || u_div < 1 || B % u_div != 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const float *wf = (const float*)w, *uf = (const float*)u, *s0f = (const float*)s0;
  const float *sf = (const float*)states, *wtf = (const float*)wt, *utf = (const float*)ut;
  const float* s0tf = (const float*)s0t;
  if (dtype == kF32)
    return jvp_typed<float>(r, k, v, wf, uf, s0f, sf, rt, kt, vt, wtf, utf, s0tf, yt,
                            (float*)s_out_t, (float*)tstates, (int*)sync, B, S, H, K, V, u_div, st);
  if (dtype == kBF16)
    return jvp_typed<__nv_bfloat16>(r, k, v, wf, uf, s0f, sf, rt, kt, vt, wtf, utf, s0tf, yt,
                                    (float*)s_out_t, (float*)tstates, (int*)sync, B, S, H, K, V,
                                    u_div, st);
  return (int)cudaErrorInvalidValue;
}

// 17bj.  As kernel 17b's operands (r, k, v, dy of ``dtype``; w, u, s0,
// s_out, ``states`` and ds_final f32, ds_final may be null) with their
// tangents beside them (ds_final_t may be null: zero); outputs drt, dkt, dvt
// of ``dtype``, dwt, dut (u's shape) and ds0t f32.  Scratch: ``tstates``,
// ``dstates`` and ``dstates_t`` B H nc K V floats, ``s_out_t`` B H K V,
// ``du_part`` B H nc K, ``sync`` int32 of 2 (1 + B H nc), zeroed.  Returns a
// CUDA error code.
extern "C" int launch_wkv6_bwd_jvp(const void* r, const void* k, const void* v, const void* w,
                                   const void* u, const void* s0, const void* s_out,
                                   const void* states, const void* dy, const void* ds_final,
                                   const void* rt, const void* kt, const void* vt, const void* wt,
                                   const void* ut, const void* s0t, const void* dyt,
                                   const void* ds_final_t, void* drt, void* dkt, void* dvt,
                                   void* dwt, void* dut, void* ds0t, void* tstates, void* s_out_t,
                                   void* dstates, void* dstates_t, void* du_part, void* sync,
                                   int B, int S, int H, int K, int V, int u_div, int dtype,
                                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (K < 1 || K > kD || V < 1 || V > kD || S < 0 || u_div < 1 || B % u_div != 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const float *wf = (const float*)w, *uf = (const float*)u, *s0f = (const float*)s0;
  const float *sof = (const float*)s_out, *sf = (const float*)states;
  const float *dsf = (const float*)ds_final, *wtf = (const float*)wt, *utf = (const float*)ut;
  const float *s0tf = (const float*)s0t, *dstf = (const float*)ds_final_t;
  if (dtype == kF32)
    return bwd_jvp_typed<float>(r, k, v, wf, uf, s0f, sof, sf, dy, dsf, rt, kt, vt, wtf, utf,
                                s0tf, dyt, dstf, drt, dkt, dvt, (float*)dwt, (float*)dut,
                                (float*)ds0t, (float*)tstates, (float*)s_out_t, (float*)dstates,
                                (float*)dstates_t, (float*)du_part, (int*)sync, B, S, H, K, V,
                                u_div, st);
  if (dtype == kBF16)
    return bwd_jvp_typed<__nv_bfloat16>(r, k, v, wf, uf, s0f, sof, sf, dy, dsf, rt, kt, vt, wtf,
                                        utf, s0tf, dyt, dstf, drt, dkt, dvt, (float*)dwt,
                                        (float*)dut, (float*)ds0t, (float*)tstates,
                                        (float*)s_out_t, (float*)dstates, (float*)dstates_t,
                                        (float*)du_part, (int*)sync, B, S, H, K, V, u_div, st);
  return (int)cudaErrorInvalidValue;
}
