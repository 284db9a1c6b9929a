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
// What bounds it on an H100: the chunk products and the pairwise decays, in
// f32 on the CUDA cores (the bound counts 3 C^2 K / 2 multiply-adds with an
// exp, 2 C^2 V / 2 and four of C K V a chunk): 7.0 GFLOP at (4, 1024, 32,
// 64), 104 us at the f32 rate.
//
// Design: one block per (chunk, b * H + h), all chunks at once, walking in
// reverse; only the (K, V) state gradient runs in chunk order.  Blocks take
// their chunk from an atomic ticket in reverse chunk-major order, so the
// block of chunk c + 1, which a block of chunk c waits on, has always
// started (the decoupled look-back of single-pass scans, as kernel 17's
// forward order).  Inside the chunk, sub-chunks of 16 steps with pivots
// lb_I = la after step 16 I - 1 (lb_0 = 0, lb_4 = la_C) split every pair
// across sub-chunks as exp(la_prev_t - lb_I) exp(lb_I - la_tau), both
// factors <= 1 (la falls along a chunk; the first is clamped at 0 as the
// pairwise exp is), so that the off-diagonal part of every sum becomes a
// product with a (K, V) state at a pivot:
//
//   S_{I+1} = exp(lb_{I+1} - lb_I) S_I + sum_{tau in I} (k_tau exp(lb_{I+1} - la_tau)) v_tau^T,
//       S_0 = S0: the forward's state at each pivot, and for t in sub-chunk I
//       dr_t = exp(min(la_prev_t - lb_I, 0)) (S_I dy_t) + (pairs inside I) + g_t u k_t;
//   P_I = exp(lb_{I+1} - lb_I) P_{I+1} + sum_{t in I} (r_t exp(min(la_prev_t - lb_I, 0))) dy_t^T,
//       P_4 = dS_C: the state gradient at each pivot, and for tau in I
//       dk_tau = exp(lb_{I+1} - la_tau) (P_{I+1} v_tau) + (pairs inside I) + g u r,
//       dv_tau = P_{I+1}^T (k_tau exp(lb_{I+1} - la_tau)) + (pairs inside I) + b dy,
//       and dS0 = P_0 (published as exp(la_C) dS_C + P_0 with P_4 = 0).
//
// A block
//
//   1. loads its chunk (16-byte loads, r, k, v and dy kept in their own
//      dtype in shared memory), takes the cumsum of lw down each column in
//      step order, g_t and b_t, and datt and att for the pairs inside each
//      sub-chunk (tau < t, 120 a sub-chunk).  These are split once more at
//      the sub-chunk's middle m = 16 I + 7: a pair across it weighs
//      exp(min(la_prev_t - la_m, 0)) exp(la_m - la_tau), so its att is the
//      product of a scaled r row and a scaled k row, and only the 56 pairs
//      inside the two 8 x 8 diagonal blocks take an exp for each k;
//   2. the pairs' own sums, dr's over tau and dk's over t, one thread a
//      (sub-chunk, column) taking each diagonal-block exp once for both and
//      the pairs across the middle from the scaled rows, handed to the
//      threads that own those elements in the products (through the state
//      tiles, then global memory that only the owner reads back: dw's rows
//      and a scratch tile).  In all 144 exps a (sub-chunk, column), 37k a
//      chunk, against 393k in the first design, where every pairwise exp of
//      the chunk was taken three times;
//   3. the decays to the pivots, exp(lb_{I+1} - la) and exp(min(la_prev -
//      lb_I, 0)), in place of la and la_prev;
//   4. the forward's S_I two at a time into two state tiles, and dr from
//      them; dr and la_prev's gradient are final here;
//   5. its own contribution to dS0, P_0 with P_4 = 0;
//   6. waits for chunk c + 1's dS_C (the last chunk reads ds_final),
//      publishes exp(la_C) dS_C + that contribution for chunk c - 1 (chunk 0
//      writes ds0), then forms P_1 .. P_4 from dS_C and the contributions
//      it kept, two at a time, and from them dk, dv and la's gradient;
//   7. dw down each column (the reverse cumsum), and its du share.
//
// Every product is a register-tiled f32 loop (2 x 4 outputs a thread over
// 32 rows, or a 4 x 4 block of a state, fed by 16-byte reads of shared
// memory); the state tiles are stored with their 16-byte quads XOR-swizzled
// by row, so that both a row walk and a column walk of a state are free of
// bank conflicts.  f32 on the CUDA cores, no TF32.  Shared memory: r, k, v,
// dy (8 KB each in bf16), la/la_prev and their decays, and two state tiles
// (16 KB each), 108 KB with bf16 operands: two blocks an SM.
//
// Trials on an H100 at rwkv6-1.6b's shape (4, 1024, 32, 64) bf16, ms: the
// pairs' own sums by the (row, 4 columns) owners, an exp each for dr and for
// dk, 0.66-0.72 against 0.56 for one thread a (sub-chunk, column), in
// separate runs; each of the rest a pair in one process: datt formed beside
// the cumsum 0.564 against 0.538 with att; unrolling the product loops 8
// deep 0.70 against 0.54 (spills: the kernel runs at its 128-register cap,
// so the halves' loops stay rolled); the pairs' sums and S_C loaded ahead
// of use 0.506 against 0.526; the split at the sub-chunk's middle 0.498
// against 0.507; four partial sums a dot product in step 1, 0.494 against
// 0.493.  Clock stamps with one block an SM put most of a block's time in
// the products of steps 4 and 6 and in the loads of step 1.
//
// du (the u_div rows of u each sum their batch rows' chunks in order) is a
// second, small grid.  No float atomics: every sum runs in a fixed order,
// so a run repeats bitwise.  The states passed between chunks go through
// f32 scratch that the wrapper allocates (B H ceil(S / 64) K V floats),
// with one flag per chunk and the ticket counter in a zeroed int32 buffer.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kC = 64;          // chunk length
constexpr int kD = 64;          // largest K and V
constexpr int kSub = 16;        // sub-chunk length
constexpr int kHalf = kSub / 2; // the diagonal blocks' split
constexpr int kNSub = kC / kSub;
constexpr int kTile = kC * kD;  // one (64, 64) tile, rows of 64 values
constexpr int kPairs = kNSub * kSub * kSub;  // (I, t, tau) of the diagonal blocks

template <typename T>
size_t smem_bytes() {
  return 4 * kTile * sizeof(T) + 4 * kTile * sizeof(float) +
         sizeof(float) * (kD * (1 + (kNSub + 1) + kNSub + 1 + 1 + 1 + 1) + 2 * kPairs) + 16;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}
__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}
__device__ __forceinline__ float at(float4 a, int i) {
  return i == 0 ? a.x : (i == 1 ? a.y : (i == 2 ? a.z : a.w));
}
template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.0f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.0f);
}

// Four consecutive outputs of a row, p[i] .. p[i + 3], the first n of them
// valid: one 8-byte (bf16) or 16-byte (f32) store when all four are and the
// rows are whole vectors.
__device__ __forceinline__ void store4(float* p, size_t i, const float (&v)[4], int n, bool vec) {
  if (vec && n >= 4) {
    *reinterpret_cast<float4*>(p + i) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < n) p[i + j] = v[j];
  }
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, size_t i, const float (&v)[4], int n,
                                       bool vec) {
  if (vec && n >= 4) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]), b = __floats2bfloat162_rn(v[2], v[3]);
    *reinterpret_cast<uint2*>(p + i) = make_uint2(*reinterpret_cast<const uint32_t*>(&a),
                                                  *reinterpret_cast<const uint32_t*>(&b));
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < n) p[i + j] = __float2bfloat16_rn(v[j]);
  }
}

__device__ __forceinline__ void load4(float (&v)[4], const float* p, size_t i, int n, bool vec) {
  if (vec && n >= 4) {
    const float4 q = *reinterpret_cast<const float4*>(p + i);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = j < n ? p[i + j] : 0.0f;
  }
}

// Element (k, v) of a state tile: row k, its 16-byte quads XOR-swizzled by
// k / 4, so that 16 lanes reading quad q of rows 4 x + j (a column walk) or
// quad x of one row (a row walk) hit 16 distinct quads.
__device__ __forceinline__ int sw(int k, int v) {
  return k * kD + ((((v >> 2) ^ (k >> 2)) & 15) << 2) + (v & 3);
}

// la = cumsum lw down column x, in place, in step order (the sequential
// kernel's and torch.cumsum's rounding), and la_prev = la - lw.
__device__ __forceinline__ void cumsum_column(float* col, float* lap, int x) {
  float run = 0.0f;
#pragma unroll 1
  for (int t0 = 0; t0 < kC; t0 += 16) {
    float buf[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) buf[j] = col[(t0 + j) * kD + x];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      run = run + buf[j];
      col[(t0 + j) * kD + x] = run;
      lap[(t0 + j) * kD + x] = run - buf[j];
    }
  }
}

// Spin until *flag is set (by the block of the chunk after).  A flag that
// never comes (a fault) traps after about ten seconds instead of hanging.
__device__ __forceinline__ void wait_flag(const int* flag) {
  const long long start = clock64();
  while (*reinterpret_cast<const volatile int*>(flag) == 0) {
    if (clock64() - start > (1LL << 34)) __trap();
  }
  __threadfence();
}

// This thread's 4 x 4 block (rows 4 kg.., columns 4 vg..) of a (K, V) f32
// state in global memory, through L2 (another block may have written it).
__device__ __forceinline__ void load_state(float (&s)[4][4], const float* src, int kg, int vg,
                                           int K, int V, bool vec) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = 4 * kg + i, v = 4 * vg;
    if (src == nullptr || k >= K) {
      s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.0f;
    } else if (vec) {
      const float4 q = v < V ? __ldcg(reinterpret_cast<const float4*>(src + (size_t)k * V + v))
                             : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      s[i][0] = q.x;
      s[i][1] = q.y;
      s[i][2] = q.z;
      s[i][3] = q.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = v + j < V ? __ldcg(src + (size_t)k * V + v + j) : 0.0f;
    }
  }
}

__device__ __forceinline__ void store_state(float* buf, const float (&s)[4][4], int kg, int vg) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(buf + sw(4 * kg + i, 4 * vg)) =
        make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
}

// s = diag(e) s + sum_{t in [t0, t0 + 16)} (a_t * d_t)^T b_t: a rank-16
// update of this thread's 4 x 4 block, a from a T tile scaled by an f32
// decay tile d (rows 4 kg..), b from a T tile (columns 4 vg..).
template <typename T>
__device__ __forceinline__ void rank16(float (&s)[4][4], const float* e, const T* a,
                                       const float* d, const T* b, int t0, int kg, int vg) {
  const float4 g = ld4(e + 4 * kg);
  const float gv[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] *= gv[i];
#pragma unroll 4
  for (int t = t0; t < t0 + kSub; ++t) {
    const float4 av = mul4(ld4(a + t * kD + 4 * kg), ld4(d + t * kD + 4 * kg));
    const float4 bv = ld4(b + t * kD + 4 * vg);
    const float ai[4] = {av.x, av.y, av.z, av.w}, bj[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(ai[i], bj[j], s[i][j]);
  }
}

// out[rr][j] = sum_x A[t0 + rr][x] state[4 c + j][x] (rows t0, t0 + 1 of a T
// tile against rows of a state: a column walk of the state).
template <typename T>
__device__ __forceinline__ void rows_by_state_rows(float (&out)[2][4], const T* A,
                                                   const float* st, int t0, int c) {
#pragma unroll 4
  for (int q = 0; q < kD / 4; ++q) {
    const float4 a0 = ld4(A + t0 * kD + 4 * q), a1 = ld4(A + (t0 + 1) * kD + 4 * q);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 b = ld4(st + sw(4 * c + j, 4 * q));
      out[0][j] = dot4(a0, b, out[0][j]);
      out[1][j] = dot4(a1, b, out[1][j]);
    }
  }
}

// out[rr][j] = sum_k (A * D)[t0 + rr][k] state[k][4 c + j] (a row walk).
template <typename T>
__device__ __forceinline__ void rows_by_state_cols(float (&out)[2][4], const T* A, const float* D,
                                                   const float* st, int t0, int c) {
#pragma unroll 2
  for (int q = 0; q < kD / 4; ++q) {
    const float4 a0 = mul4(ld4(A + t0 * kD + 4 * q), ld4(D + t0 * kD + 4 * q));
    const float4 a1 = mul4(ld4(A + (t0 + 1) * kD + 4 * q), ld4(D + (t0 + 1) * kD + 4 * q));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 b = ld4(st + sw(4 * q + kk, 4 * c));
      const float x0 = at(a0, kk), x1 = at(a1, kk);
      out[0][0] = fmaf(x0, b.x, out[0][0]);
      out[0][1] = fmaf(x0, b.y, out[0][1]);
      out[0][2] = fmaf(x0, b.z, out[0][2]);
      out[0][3] = fmaf(x0, b.w, out[0][3]);
      out[1][0] = fmaf(x1, b.x, out[1][0]);
      out[1][1] = fmaf(x1, b.y, out[1][1]);
      out[1][2] = fmaf(x1, b.z, out[1][2]);
      out[1][3] = fmaf(x1, b.w, out[1][3]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
wkv6_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                const float* __restrict__ w, const float* __restrict__ u,
                const float* __restrict__ s_init, const float* __restrict__ s_out,
                const float* __restrict__ states, const T* __restrict__ dy,
                const float* __restrict__ ds_final, T* __restrict__ dr, T* __restrict__ dk,
                T* __restrict__ dv, float* __restrict__ dw, float* __restrict__ ds0,
                float* dstates, float* __restrict__ du_part, float* __restrict__ dk_part,
                int* sync, int S, int H, int K,
                int V, int nc, int BH, int vec, int u_div) {
  extern __shared__ float4 smem4[];
  T* rs = reinterpret_cast<T*>(smem4);  // r            (t, k)
  T* ks = rs + kTile;                    // k            (t, k)
  T* vs = ks + kTile;                    // v            (t, v)
  T* dys = vs + kTile;                   // dy           (t, v)
  float* la = reinterpret_cast<float*>(dys + kTile);  // lw, la, then exp(lb_{I+1} - la)
  float* lp = la + kTile;       // la_prev, then exp(min(la_prev - lb_I, 0))      (t, k)
  float* bufA = lp + kTile;     // a state (swizzled), then la's gradient         (t, k)
  float* bufB = bufA + kTile;   // a state (swizzled)
  float* us = bufB + kTile;     // u of this row and head
  float* lb = us + kD;          // (I, k): pivots lb_0 = 0, lb_I = la_{16 I - 1}, lb_4 = la_C
  float* eg = lb + (kNSub + 1) * kD;  // (I, k): exp(lb_{I+1} - lb_I)
  float* ec = eg + kNSub * kD;  // exp(la_C)
  float* gs = ec + kD;          // g_t
  float* bs = gs + kD;          // b_t
  float* dlc = bs + kD;         // la_C's gradient
  float* att = dlc + kD;        // (I, t, tau) of the diagonal blocks, b_t at tau = t
  float* datt = att + kPairs;   // (I, t, tau)
  int* ticket = reinterpret_cast<int*>(datt + kPairs);

  const int tid = threadIdx.x, lane = tid & 31;
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
  // the product loops' thread layouts: rows 2 ty.. and columns 4 tx.. of a
  // (t, k) or (t, v) half of the chunk; rows 4 kg.. and columns 4 vg.. of a
  // (K, V) state
  const int ty = tid / 16, tx = tid % 16, kg = ty, vg = tx;

  // 1. the chunk's operands; rows past C and columns past K, V are 0 (w 1);
  // the state entering the chunk, for step 4
  float st[4][4];
  load_state(st, c > 0 ? states + ((size_t)bh * nc + c) * KV : s_init + (size_t)bh * KV, kg, vg,
             K, V, vec);
  if (tid < kD) us[tid] = tid < K ? u[((size_t)(b / u_div) * H + h) * K + tid] : 0.0f;
  if (vec) {  // K and V rows are whole 16-byte vectors
    constexpr int E = 16 / sizeof(T);
    constexpr int N = kTile / E / kThreads;
    uint4 rv[N], kv[N], vv[N], yv[N];
    float4 wv[kTile / 4 / kThreads];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int i = (tid + j * kThreads) * E, t = i / kD, x = i % kD;
      const uint4 z = make_uint4(0, 0, 0, 0);
      const bool okk = t < C && x < K, okv = t < C && x < V;
      rv[j] = okk ? __ldg(reinterpret_cast<const uint4*>(r + rk0 + t * kstride + x)) : z;
      kv[j] = okk ? __ldg(reinterpret_cast<const uint4*>(k + rk0 + t * kstride + x)) : z;
      vv[j] = okv ? __ldg(reinterpret_cast<const uint4*>(v + v0 + t * vstride + x)) : z;
      yv[j] = okv ? __ldg(reinterpret_cast<const uint4*>(dy + v0 + t * vstride + x)) : z;
    }
#pragma unroll
    for (int j = 0; j < kTile / 4 / kThreads; ++j) {
      const int i = (tid + j * kThreads) * 4, t = i / kD, x = i % kD;
      wv[j] = t < C && x < K ? __ldg(reinterpret_cast<const float4*>(w + rk0 + t * kstride + x))
                             : make_float4(1.0f, 1.0f, 1.0f, 1.0f);
    }
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int i = (tid + j * kThreads) * E;
      *reinterpret_cast<uint4*>(rs + i) = rv[j];
      *reinterpret_cast<uint4*>(ks + i) = kv[j];
      *reinterpret_cast<uint4*>(vs + i) = vv[j];
      *reinterpret_cast<uint4*>(dys + i) = yv[j];
    }
#pragma unroll
    for (int j = 0; j < kTile / 4 / kThreads; ++j) {
      const int i = (tid + j * kThreads) * 4;
      *reinterpret_cast<float4*>(la + i) =
          make_float4(logf(fmaxf(wv[j].x, 1e-38f)), logf(fmaxf(wv[j].y, 1e-38f)),
                      logf(fmaxf(wv[j].z, 1e-38f)), logf(fmaxf(wv[j].w, 1e-38f)));
    }
  } else {
#pragma unroll 4
    for (int i = tid; i < kTile; i += kThreads) {
      const int t = i / kD, x = i % kD;
      const bool okk = t < C && x < K, okv = t < C && x < V;
      const size_t g_rk = rk0 + (size_t)t * kstride + x, g_v = v0 + (size_t)t * vstride + x;
      rs[i] = okk ? r[g_rk] : zero<T>();
      ks[i] = okk ? k[g_rk] : zero<T>();
      la[i] = okk ? logf(fmaxf(w[g_rk], 1e-38f)) : 0.0f;
      vs[i] = okv ? v[g_v] : zero<T>();
      dys[i] = okv ? dy[g_v] : zero<T>();
    }
  }
  __syncthreads();

  if (tid < kD) {  // column tid: la, la_prev, the pivots and their exps
    cumsum_column(la, lp, tid);
    lb[tid] = 0.0f;
    for (int I = 1; I < kNSub; ++I) lb[I * kD + tid] = la[(I * kSub - 1) * kD + tid];
    lb[kNSub * kD + tid] = la[(kC - 1) * kD + tid];
    for (int I = 0; I < kNSub; ++I)
      eg[I * kD + tid] = expf(lb[(I + 1) * kD + tid] - lb[I * kD + tid]);
    ec[tid] = expf(lb[kNSub * kD + tid]);
  } else if (tid < kD + kC) {  // meanwhile g_t = dy_t . v_t and b_t = r_t . u . k_t
    const int t = tid - kD;
    float g = 0.0f, bsum = 0.0f;
    for (int q = 0; q < kD / 4; ++q) {
      const int x = 4 * ((q + lane) % (kD / 4));  // skewed: the lanes' rows differ
      g = dot4(ld4(dys + t * kD + x), ld4(vs + t * kD + x), g);
      bsum = dot4(mul4(ld4(rs + t * kD + x), ld4(us + x)), ld4(ks + t * kD + x), bsum);
    }
    gs[t] = g;
    bs[t] = bsum;
    att[(t / kSub) * kSub * kSub + (t % kSub) * (kSub + 1)] = bsum;
  }
  __syncthreads();

  // the pairs inside each sub-chunk (tau < t) split at its middle, m = 16 I
  // + 7: a pair across it (tau <= m < t) weighs exp(min(la_prev_t - la_m,
  // 0)) exp(la_m - la_tau), both factors <= 1, so its att is a product of
  // scaled rows; only the two 8 x 8 blocks at the diagonal take direct
  // exps.  First the scaled rows, k_tau exp(la_m - la_tau) above the middle
  // and r_t exp(min(la_prev_t - la_m, 0)) below it, one thread a (sub-chunk,
  // column), into the first state tile (free until step 4)
  {
    const int I = tid / kD, x = tid % kD, t0 = I * kSub;
    const float lam = la[(t0 + kHalf - 1) * kD + x];
#pragma unroll
    for (int j = 0; j < kHalf; ++j) {
      const int a = (t0 + j) * kD + x, b = (t0 + kHalf + j) * kD + x;
      bufA[a] = load_f32(ks, (size_t)a) * __expf(lam - la[a]);
      bufA[b] = load_f32(rs, (size_t)b) * __expf(fminf(lp[b] - lam, 0.0f));
    }
  }
  __syncthreads();

  // att and datt of every pair, 64 threads a sub-chunk: thread j takes the
  // pair across the middle (t = 8 + j / 8, tau = j % 8), for j < 56 a pair
  // inside an 8 x 8 diagonal block (direct exps), and datt of pairs j and
  // j + 64
  {
    const int I = tid / kD, j = tid % kD, t0 = I * kSub;
    float* aI = att + I * kSub * kSub;
    float* dI = datt + I * kSub * kSub;
    {  // across the middle
      const int tl = kHalf + j / kHalf, cc = j % kHalf;
      float a = 0.0f;
#pragma unroll 4
      for (int q = 0; q < kD / 4; ++q) {
        const int x = 4 * ((q + lane) % (kD / 4));
        a = dot4(ld4(bufA + (t0 + tl) * kD + x), ld4(bufA + (t0 + cc) * kD + x), a);
      }
      aI[tl * kSub + cc] = a;
    }
    if (j < kHalf * (kHalf - 1)) {  // inside a diagonal block: pair (tl, cc) of half h
      const int h = j / (kHalf * (kHalf - 1) / 2);
      int cc = j % (kHalf * (kHalf - 1) / 2), tl = 1;
      while (cc >= tl) cc -= tl++;
      const int t = t0 + kHalf * h + tl, tau = t0 + kHalf * h + cc;
      float a = 0.0f;
#pragma unroll 2
      for (int q = 0; q < kD / 4; ++q) {
        const int x = 4 * ((q + lane) % (kD / 4));
        const float4 rr = ld4(rs + t * kD + x), pp = ld4(lp + t * kD + x);
        const float4 kk = ld4(ks + tau * kD + x), ll = ld4(la + tau * kD + x);
        a += rr.x * kk.x * __expf(fminf(pp.x - ll.x, 0.0f));
        a += rr.y * kk.y * __expf(fminf(pp.y - ll.y, 0.0f));
        a += rr.z * kk.z * __expf(fminf(pp.z - ll.z, 0.0f));
        a += rr.w * kk.w * __expf(fminf(pp.w - ll.w, 0.0f));
      }
      aI[(t - t0) * kSub + (tau - t0)] = a;
    }
    for (int q2 = j; q2 < kSub * (kSub - 1) / 2; q2 += kD) {  // datt, pair (tl, cc)
      int cc = q2, tl = 1;
      while (cc >= tl) cc -= tl++;
      float d = 0.0f;
      for (int q = 0; q < kD / 4; ++q) {
        const int x = 4 * ((q + lane) % (kD / 4));
        d = dot4(ld4(dys + (t0 + tl) * kD + x), ld4(vs + (t0 + cc) * kD + x), d);
      }
      dI[tl * kSub + cc] = d;
    }
  }
  __syncthreads();

  // 2. the pairs' own sums, dr's over tau < t and dk's over t > tau, one
  // thread a (sub-chunk, column): each 8 x 8 diagonal block's exps once for
  // both, the pairs across the middle from the scaled rows (the decays
  // recomputed, not read back), each sum in row order within its part
  {
    const int I = tid / kD, x = tid % kD, t0 = I * kSub;
    const float* dI = datt + I * kSub * kSub;
    const float lam = la[(t0 + kHalf - 1) * kD + x];
    float drs[kSub], dks[kSub], kh[kHalf], fk[kHalf];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float lac[kHalf], kc[kHalf], lpc[kHalf], rc[kHalf];
#pragma unroll
      for (int i = 0; i < kHalf; ++i) {
        const int e = (t0 + kHalf * h + i) * kD + x;
        lac[i] = la[e];
        lpc[i] = lp[e];
        kc[i] = load_f32(ks, (size_t)e);
        rc[i] = load_f32(rs, (size_t)e);
        drs[kHalf * h + i] = dks[kHalf * h + i] = 0.0f;
      }
#pragma unroll
      for (int tl = 1; tl < kHalf; ++tl) {  // the diagonal block of half h
#pragma unroll
        for (int cc = 0; cc < tl; ++cc) {
          const float d = dI[(kHalf * h + tl) * kSub + kHalf * h + cc];
          const float e = __expf(fminf(lpc[tl] - lac[cc], 0.0f));
          drs[kHalf * h + tl] += d * kc[cc] * e;
          dks[kHalf * h + cc] += d * rc[tl] * e;
        }
      }
      if (h == 0) {  // the scaled k of the upper half, for the pairs across the middle
#pragma unroll
        for (int i = 0; i < kHalf; ++i) {
          fk[i] = __expf(lam - lac[i]);
          kh[i] = kc[i] * fk[i];
        }
      } else {       // and the pairs across it, with the scaled r of the lower half
#pragma unroll
        for (int i = 0; i < kHalf; ++i) {
          const float fr = __expf(fminf(lpc[i] - lam, 0.0f));
          const float rh = rc[i] * fr;
          float sr = 0.0f;
#pragma unroll
          for (int cc = 0; cc < kHalf; ++cc) {
            const float d = dI[(kHalf + i) * kSub + cc];
            sr = fmaf(d, kh[cc], sr);
            dks[cc] = fmaf(d * rh, fk[cc], dks[cc]);
          }
          drs[kHalf + i] = fmaf(fr, sr, drs[kHalf + i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kSub; ++i) {
      bufA[(t0 + i) * kD + x] = drs[i];
      bufB[(t0 + i) * kD + x] = dks[i];
    }
  }
  __syncthreads();
  // ... and to the thread that owns them in the products (rows 32 p + 2 ty
  // + rr, columns 4 tx .., p the two halves), through global memory that
  // only that thread reads back: dr's into dw's rows until step 4, dk's
  // into a (64, 64) scratch tile until step 6
  float* dkd = dk_part + ((size_t)bh * nc + c) * kTile;
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int t = 32 * p + 2 * ty + rr, i = t * kD + 4 * tx;
      const float4 a = ld4(bufA + i);
      const float av[4] = {a.x, a.y, a.z, a.w};
      if (t < C) store4(dw, rk0 + (size_t)t * kstride + 4 * tx, av, K - 4 * tx, vec);
      *reinterpret_cast<float4*>(dkd + i) = ld4(bufB + i);
    }
  __syncthreads();  // la and la_prev are consumed

  // 3. the decays to the pivots, in place: la -> exp(lb_{I+1} - la) (k's,
  // <= 1), la_prev -> exp(min(la_prev - lb_I, 0)) (r's)
#pragma unroll
  for (int j = 0; j < kTile / 4 / kThreads; ++j) {
    const int i = (tid + j * kThreads) * 4, t = i / kD, x = i % kD, I = t / kSub;
    const float4 ll = ld4(la + i), pp = ld4(lp + i);
    const float4 b0 = ld4(lb + I * kD + x), b1 = ld4(lb + (I + 1) * kD + x);
    *reinterpret_cast<float4*>(la + i) =
        make_float4(__expf(b1.x - ll.x), __expf(b1.y - ll.y), __expf(b1.z - ll.z),
                    __expf(b1.w - ll.w));
    *reinterpret_cast<float4*>(lp + i) =
        make_float4(__expf(fminf(pp.x - b0.x, 0.0f)), __expf(fminf(pp.y - b0.y, 0.0f)),
                    __expf(fminf(pp.z - b0.z, 0.0f)), __expf(fminf(pp.w - b0.w, 0.0f)));
  }
  const float* ek = la;  // exp(lb_{I+1} - la)
  const float* er = lp;  // exp(min(la_prev - lb_I, 0))
  __syncthreads();

  // 4. the forward's state at each pivot, two at a time, and dr from them;
  // la_prev's gradient goes to dw's rows until step 7 reads it back.  The
  // halves' loops stay rolled (here and in step 6): the kernel's code is
  // kept small enough for the instruction cache.
#pragma unroll 1
  for (int p = 0; p < 2; ++p) {
    if (p == 1) {
      __syncthreads();  // the first half's states are consumed
      rank16(st, eg + kD, ks, ek, vs, kSub, kg, vg);
    }
    store_state(bufA, st, kg, vg);                              // S_{2p}
    rank16(st, eg + 2 * p * kD, ks, ek, vs, 2 * p * kSub, kg, vg);
    store_state(bufB, st, kg, vg);                              // S_{2p+1}
    __syncthreads();
    const int t0 = 32 * p + 2 * ty, I = t0 / kSub;
    float dd2[2][4];  // the pairs' sums, loaded ahead of the product
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
      if (t0 + rr < C) load4(dd2[rr], dw, rk0 + (size_t)(t0 + rr) * kstride + 4 * tx, K - 4 * tx, vec);
    float out[2][4] = {};
    rows_by_state_rows(out, dys, (I & 1) ? bufB : bufA, t0, tx);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int t = t0 + rr;
      const float4 e4 = ld4(er + t * kD + 4 * tx), r4 = ld4(rs + t * kD + 4 * tx);
      const float4 k4 = ld4(ks + t * kD + 4 * tx), u4 = ld4(us + 4 * tx);
      if (t >= C) continue;
      const size_t g = rk0 + (size_t)t * kstride + 4 * tx;
      const float* dd = dd2[rr];
      float o[4], q[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float x = fmaf(out[rr][j], at(e4, j), dd[j]);
        o[j] = x + gs[t] * at(u4, j) * at(k4, j);
        q[j] = at(r4, j) * x;
      }
      store4(dr, g, o, K - 4 * tx, vec);
      store4(dw, g, q, K - 4 * tx, vec);
    }
  }
  __syncthreads();  // the second half's states are consumed

  // 5. this chunk's own share of dS0, P_0 with P_4 = 0, by the recurrence
  // W_I = exp(lb_{I+1} - lb_I) W_{I+1} + sum_{t in I} (r_t er_t) dy_t^T:
  // W_3 and W_2 go to the state tiles, W_1 to la_prev's tile once its decays
  // are read (P_I = W_I + exp(la_C - lb_I) dS_C once dS_C is known), W_0 is
  // published
  float xw[4][4] = {}, w1[4][4];
#pragma unroll 1
  for (int I = kNSub - 1; I >= 0; --I) {
    rank16(xw, eg + I * kD, rs, er, dys, I * kSub, kg, vg);
    if (I >= 2) {
      store_state(I == 3 ? bufA : bufB, xw, kg, vg);
    } else if (I == 1) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) w1[i][j] = xw[i][j];
    }
  }
  __syncthreads();  // every read of er is done
  store_state(lp, w1, kg, vg);
  float sc[4][4];  // S_C, the forward's state after the chunk, for la_C's gradient
  load_state(sc, c + 1 < nc ? states + ((size_t)bh * nc + c + 1) * KV : s_out + (size_t)bh * KV,
             kg, vg, K, V, vec);

  // 6. the state gradient at the chunk's end, and the one at its start for
  // the chunk before
  if (c + 1 < nc) {
    if (tid == 0) wait_flag(sync + 1 + (size_t)bh * nc + c + 1);
    __syncthreads();
  }
  float pg[4][4];
  load_state(pg, c + 1 < nc ? dstates + ((size_t)bh * nc + c + 1) * KV
                            : (ds_final != nullptr ? ds_final + (size_t)bh * KV : nullptr),
             kg, vg, K, V, vec);
  {
    float* dst = c > 0 ? dstates + ((size_t)bh * nc + c) * KV : ds0 + (size_t)bh * KV;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kk = 4 * kg + i, vv = 4 * vg + j;
        if (kk < K && vv < V) dst[(size_t)kk * V + vv] = fmaf(ec[kk], pg[i][j], xw[i][j]);
      }
  }
  if (c > 0) {  // the block's stores, then one release by thread 0 (a grid sync's pattern)
    __syncthreads();
    if (tid == 0) {
      __threadfence();
      atomicExch(sync + 1 + (size_t)bh * nc + c, 1);
    }
  }
  // la_C's gradient: sum_v dS_C S_C, a row of the state a group of 16
  // lanes; the exps from each pivot to the chunk's end
  float c1[4], c2[4], c3[4];
  {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kk = 4 * kg + i;
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) sum = fmaf(pg[i][j], sc[i][j], sum);
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (vg == 0) dlc[kk] = sum;
      c3[i] = eg[3 * kD + kk];
      c2[i] = eg[2 * kD + kk] * c3[i];
      c1[i] = eg[kD + kk] * c2[i];
    }
  }

  // P_1 .. P_4, two at a time: rows of sub-chunk J read P_{J+1} (P_1 in
  // la_prev's tile, P_2 in the second state tile; then P_3 in the first,
  // P_4 = dS_C in la_prev's)
#pragma unroll 1
  for (int p = 0; p < 2; ++p) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = sw(4 * kg + i, 4 * vg);
      float4* lo = reinterpret_cast<float4*>((p == 0 ? lp : bufA) + e);
      float4* hi = reinterpret_cast<float4*>((p == 0 ? bufB : lp) + e);
      const float4 w = *lo;
      const float c_lo = p == 0 ? c1[i] : c3[i];
      *lo = make_float4(fmaf(c_lo, pg[i][0], w.x), fmaf(c_lo, pg[i][1], w.y),
                        fmaf(c_lo, pg[i][2], w.z), fmaf(c_lo, pg[i][3], w.w));
      if (p == 0) {
        const float4 w2 = *hi;
        *hi = make_float4(fmaf(c2[i], pg[i][0], w2.x), fmaf(c2[i], pg[i][1], w2.y),
                          fmaf(c2[i], pg[i][2], w2.z), fmaf(c2[i], pg[i][3], w2.w));
      } else {
        *hi = make_float4(pg[i][0], pg[i][1], pg[i][2], pg[i][3]);
      }
    }
    __syncthreads();
    const int t0 = 32 * p + 2 * ty, J = t0 / kSub;
    const float* P = p == 0 ? (J == 0 ? lp : bufB) : (J == 2 ? bufA : lp);
    const float4 dd2[2] = {ld4(dkd + t0 * kD + 4 * tx), ld4(dkd + (t0 + 1) * kD + 4 * tx)};
    float dko[2][4] = {}, dvo[2][4] = {};
    rows_by_state_rows(dko, vs, P, t0, tx);
    rows_by_state_cols(dvo, ks, ek, P, t0, tx);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int t = t0 + rr, tl = t % kSub;
      const float* aJ = att + J * kSub * kSub;
      float4 dvd = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int cc = tl; cc < kSub; ++cc) {  // sum_{t2 >= t} att[t2, t] dy_t2 (b_t at t2 = t)
        const float a = aJ[cc * kSub + tl];
        const float4 y4 = ld4(dys + (J * kSub + cc) * kD + 4 * tx);
        dvd.x = fmaf(a, y4.x, dvd.x);
        dvd.y = fmaf(a, y4.y, dvd.y);
        dvd.z = fmaf(a, y4.z, dvd.z);
        dvd.w = fmaf(a, y4.w, dvd.w);
      }
      const float4 e4 = ld4(ek + t * kD + 4 * tx), r4 = ld4(rs + t * kD + 4 * tx);
      const float4 k4 = ld4(ks + t * kD + 4 * tx), u4 = ld4(us + 4 * tx);
      const float4 dd = dd2[rr];  // dk's pair sums; la's gradient takes their place
      float y[4], o[4], ov[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        y[j] = fmaf(dko[rr][j], at(e4, j), at(dd, j));
        o[j] = y[j] + gs[t] * at(u4, j) * at(r4, j);
        ov[j] = dvo[rr][j] + at(dvd, j);
      }
      if (t < C) {
        store4(dk, rk0 + (size_t)t * kstride + 4 * tx, o, K - 4 * tx, vec);
        store4(dv, v0 + (size_t)t * vstride + 4 * tx, ov, V - 4 * tx, vec);
      }
      *reinterpret_cast<float4*>(dkd + t * kD + 4 * tx) =
          make_float4(-k4.x * y[0], -k4.y * y[1], -k4.z * y[2], -k4.w * y[3]);
    }
    __syncthreads();  // this half's states are consumed
  }

  // 7. dlw_s = sum_{t >= s} (dla_t + dla_prev_t) - dla_prev_s, with la_C's
  // gradient at the last row; dw = dlw / w.  Four threads a column, one a
  // sub-chunk: the sub-chunks' sums first, then each its 16 rows, every
  // sum in a fixed order.  And du's share: sum_t g_t r_t k_t by sub-chunks.
  {
    const int I = tid / kD, x = tid % kD;
    float* part = lb;  // the pivots are consumed: (I, x) sub-chunk sums
    float dla[kSub], dlp[kSub], ws[kSub];
    const bool col = x < K;
#pragma unroll
    for (int j = 0; j < kSub; ++j) {
      const int s = I * kSub + j;
      const size_t g = rk0 + (size_t)s * kstride + x;
      const bool in = s < C && col;
      dla[j] = dkd[s * kD + x];
      dlp[j] = in ? dw[g] : 0.0f;
      ws[j] = in ? w[g] : 1.0f;
    }
    float tsum = 0.0f, d_u = 0.0f;
#pragma unroll
    for (int j = kSub - 1; j >= 0; --j) tsum += dla[j] + dlp[j];
#pragma unroll
    for (int j = 0; j < kSub; ++j) {
      const int t = I * kSub + j;
      d_u = fmaf(gs[t] * load_f32(rs, (size_t)(t * kD + x)), load_f32(ks, (size_t)(t * kD + x)),
                 d_u);
    }
    part[I * kD + x] = tsum;
    if (col) du_part[(((size_t)bh * nc + c) * kNSub + I) * K + x] = d_u;
    __syncthreads();
    float run = dlc[x];
    for (int J = kNSub - 1; J > I; --J) run += part[J * kD + x];
#pragma unroll
    for (int j = kSub - 1; j >= 0; --j) {
      const int s = I * kSub + j;
      run += dla[j] + dlp[j];
      if (s < C && col)
        dw[rk0 + (size_t)s * kstride + x] = ws[j] >= 1e-38f ? (run - dlp[j]) / ws[j] : 0.0f;
    }
  }
}

// du per row of u: the batch rows of its group, then the chunks and their
// sub-chunks, in order.
__global__ void du_kernel(const float* __restrict__ du_part, float* __restrict__ du, int H,
                          int K, int nc, int u_div, int n_u) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_u * H * K) return;
  const int x = i % K, h = (i / K) % H, ur = i / (K * H);
  float s = 0.0f;
  for (int b = ur * u_div; b < (ur + 1) * u_div; ++b)
    for (int c = 0; c < nc * kNSub; ++c)
      s += du_part[(((size_t)b * H + h) * nc * kNSub + c) * K + x];
  du[i] = s;
}

template <typename T>
int launch_typed(const void* r, const void* k, const void* v, const float* w, const float* u,
                 const float* s0, const float* s_out, const float* states, const void* dy,
                 const float* ds_final, void* dr, void* dk, void* dv, float* dw, float* du,
                 float* ds0, float* dstates, float* du_part, float* dk_part, int* sync, int B,
                 int S, int H,
                 int K, int V, int u_div, cudaStream_t stream) {
  const int nc = (S + kC - 1) / kC, BH = B * H, n_u = B / u_div;
  cudaError_t err;
  if (nc == 0) {  // no steps: ds0 is ds_final, du is 0
    const size_t bytes = sizeof(float) * (size_t)BH * K * V;
    err = ds_final != nullptr
              ? cudaMemcpyAsync(ds0, ds_final, bytes, cudaMemcpyDeviceToDevice, stream)
              : cudaMemsetAsync(ds0, 0, bytes, stream);
    if (err == cudaSuccess)
      err = cudaMemsetAsync(du, 0, sizeof(float) * (size_t)n_u * H * K, stream);
    return (int)err;
  }
  const int vec = (K * sizeof(T)) % 16 == 0 && (V * sizeof(T)) % 16 == 0;
  const size_t smem = smem_bytes<T>();
  err = cudaFuncSetAttribute(wkv6_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess)  // two blocks an SM: all of the unified memory as shared memory
    err = cudaFuncSetAttribute(wkv6_bwd_kernel<T>, cudaFuncAttributePreferredSharedMemoryCarveout,
                               100);
  if (err != cudaSuccess) return (int)err;
  wkv6_bwd_kernel<T><<<(unsigned)((size_t)BH * nc), kThreads, smem, stream>>>(
      (const T*)r, (const T*)k, (const T*)v, w, u, s0, s_out, states, (const T*)dy, ds_final,
      (T*)dr, (T*)dk, (T*)dv, dw, ds0, dstates, du_part, dk_part, sync, S, H, K, V, nc, BH, vec,
      u_div);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = n_u * H * K;
  du_kernel<<<(n + 255) / 256, 256, 0, stream>>>(du_part, du, H, K, nc, u_div, n_u);
  return (int)cudaGetLastError();
}

}  // namespace

// r, k, dy, dr, dk (B, S, H, K) / v, dv (B, S, H, V) of ``dtype``; w, dw
// (B, S, H, K), u (B / u_div, H, K), du the same, s0, s_out, ds_final, ds0
// (B, H, K, V) and ``states`` (the forward's scratch) f32, all contiguous;
// ds_final may be null (zero).  Scratch: ``dstates`` B H nc K V floats,
// ``du_part`` B H nc 4 K floats, ``dk_part`` B H nc 64 64 floats (nc =
// ceil(S / 64)) and ``sync`` int32 of 1 + B H nc, zeroed.  Returns a CUDA
// error code.
extern "C" int launch_wkv6_bwd(const void* r, const void* k, const void* v, const void* w,
                               const void* u, const void* s0, const void* s_out,
                               const void* states, const void* dy, const void* ds_final,
                               void* dr, void* dk, void* dv, void* dw, void* du, void* ds0,
                               void* dstates, void* du_part, void* dk_part, void* sync, int B,
                               int S, int H,
                               int K, int V, int u_div, int dtype, int device, void* stream) {
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
                               (float*)ds0, (float*)dstates, (float*)du_part, (float*)dk_part,
                               (int*)sync, B, S, H, K, V, u_div, st);
  if (dtype == kBF16)
    return launch_typed<__nv_bfloat16>(r, k, v, (const float*)w, (const float*)u,
                                       (const float*)s0, (const float*)s_out,
                                       (const float*)states, dy, (const float*)ds_final, dr, dk,
                                       dv, (float*)dw, (float*)du, (float*)ds0, (float*)dstates,
                                       (float*)du_part, (float*)dk_part, (int*)sync, B, S, H, K, V,
                                       u_div, st);
  return (int)cudaErrorInvalidValue;
}
