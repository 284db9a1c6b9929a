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
// r, k and v are f32 or bf16 (one dtype); w, u and s0 are f32, as the model
// path hands them over (models/rwkv6.py).  K, V <= 64.  w is a decay in
// (0, 1] (the model's exp(-exp(.))), so la falls along a chunk.
//
// What bounds it on an H100: the chunk products and the pairwise decays,
// all in f32 on the CUDA cores: 3.2 GFLOP at (4, 1024, 32, 64), 48 us at
// the f32 rate, against 105 MB moved (31 us).  Only the state carries from
// chunk to chunk; one block per (b, h) walking its 16 chunks in order (128
// blocks, one wave of 8 warps per SM, 129k exps a chunk) leaves the card
// idle and latency-bound.
//
// Design: one block per (chunk, b * H + h), all chunks at once; only the
// (K, V) state update runs in chunk order.  A block
//
//   1. loads its chunk (16-byte loads, all in flight together), takes the
//      cumsum of lw down each column in step order (the sequential
//      kernel's and torch.cumsum's rounding) and the pivots lb_I below;
//   2. computes everything that does not need the state entering the
//      chunk: the pairwise weights near the diagonal, and the chunk's own
//      contribution W_I to the state at each sub-chunk pivot
//      (W_0 = 0, W_{I+1} = exp(lb_{I+1} - lb_I) W_I
//                + sum over steps 16 I - 1 .. 16 I + 14 of (k exp(lb_{I+1} - la))^T v,
//      with the last group running to the chunk's end, lb_4 = la_C, so that
//      W_4 = (k exp(la_C - la))^T v);
//   3. waits for the block of the chunk before it to publish the state
//      entering this chunk, S, and publishes exp(la_C) S + W_4 for the
//      next (the last chunk writes the final state).  Blocks take their
//      chunk from an atomic ticket in chunk-major order, so the block a
//      block waits on has always started: no chunk can wait on one that
//      never runs (the decoupled look-back of single-pass scans);
//   4. with S_I = exp(lb_I) S + W_I, computes its outputs by sub-chunks of
//      16 rows.  Sub-chunk I (rows 16 I .. 16 I + 15) reads the state after
//      step 16 I - 2 of the chunk, pivot lb_I = la there (lb_0 = 0):
//        y_t = (r_t exp(min(la_prev_t - lb_I, 0))) S_I
//            + sum_{tau = 16 I - 1}^{t - 1} [sum_k r_tk k_tau,k exp(min(la_prev_tk - la_tau,k, 0))] v_tau
//            + bonus_t v_t.
//      This is the same sum: for tau <= 16 I - 2 the weight exp(la_prev_t -
//      la_tau) splits as exp(la_prev_t - lb_I) exp(lb_I - la_tau), both
//      factors <= 1, so nothing overflows and a factor that underflows
//      bounds a product that is smaller still.  The pivot sits one step
//      before the sub-chunk so that every pair (t, t - 1), whose argument
//      la_prev_t - la_{t-1} is 0 up to one rounding of la, takes the direct
//      clamped exp as the reference does; the split arguments then add up
//      to the reference's exactly.  Only the 16 x 17 blocks at the diagonal
//      take one exp per (t, tau, k) (33.8k a chunk, not 129k); everything
//      else is (64 x 16) by (16 x 64) products and one (64 x 80) by
//      (80 x 64) product, 4 x 4 register tiles per thread fed by float4
//      reads of shared memory.
//
// The states passed between chunks go through f32 scratch that the wrapper
// allocates (B H ceil(S / 64) K V floats, 33.5 MB at the serve shape,
// written and read once, mostly in L2), with one flag per chunk and the
// ticket counter in a zeroed int32 buffer.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kC = 64;          // chunk length
constexpr int kD = 64;          // largest K and V
constexpr int kSub = 16;        // sub-chunk length of the outputs
constexpr int kNSub = kC / kSub;
constexpr int kTile = kC * kD;  // one (64, 64) f32 tile, rows of 64 floats
constexpr int kTiles = 6;       // r, k, v, la, la_prev, S
constexpr int kAttLd = kSub + 1;  // the diagonal block's columns: tau = 16 I - 1 + c

size_t smem_bytes() {
  return sizeof(float) * ((size_t)kTiles * kTile + kNSub * kSub * kAttLd + kD +
                          (kNSub + 1) * kD + kNSub * kD + (kNSub + 1) * kD) + 16;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// 16 bytes of T as f32 into shared memory (4 floats or 8 bf16).
__device__ __forceinline__ void put16(float* dst, const uint4& v, float) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(&v);
}
__device__ __forceinline__ void put16(float* dst, const uint4& v, __nv_bfloat16) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
  const float2 a = __bfloat1622float2(p[0]), b = __bfloat1622float2(p[1]);
  const float2 c = __bfloat1622float2(p[2]), d = __bfloat1622float2(p[3]);
  *reinterpret_cast<float4*>(dst) = make_float4(a.x, a.y, b.x, b.y);
  *reinterpret_cast<float4*>(dst + 4) = make_float4(c.x, c.y, d.x, d.y);
}

// la = cumsum lw down column x of a (64, 64) tile, in place, in step order
// (the sequential kernel's and torch.cumsum's rounding), and la_prev = la -
// lw.  The loads of each 16 steps are issued together, so only the adds
// wait on one another.
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

// Spin until *flag is set (by the block of the chunk before).  A flag that
// never comes (a fault) traps after about ten seconds instead of hanging.
__device__ __forceinline__ void wait_flag(const int* flag) {
  const long long start = clock64();
  while (*reinterpret_cast<const volatile int*>(flag) == 0) {
    if (clock64() - start > (1LL << 34)) __trap();
  }
  __threadfence();
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
            const float* __restrict__ w, const float* __restrict__ u,
            const float* __restrict__ s_init, T* __restrict__ y, float* __restrict__ s_out,
            float* states, int* sync, int S, int H, int K, int V, int nc, int BH, int vec,
            int u_div) {
  extern __shared__ float smem[];
  float* rs = smem;             // r, then r exp(min(la_prev - lb_I, 0))         (t, k)
  float* ks = rs + kTile;       // k, then k exp(lb_{G+1} - la), then S_3        (t, k)
  float* vs = ks + kTile;       // v                                           (t, v)
  float* la = vs + kTile;       // lw, then la, then S_1                       (t, k)
  float* lp = la + kTile;       // la_prev, then S_2                           (t, k)
  float* s0 = lp + kTile;       // S, the state entering the chunk             (k, v)
  float* att = s0 + kTile;      // (I, t, c): weights of tau = 16 I - 1 + c, bonus at tau = t
  float* us = att + kNSub * kSub * kAttLd;  // u of this head
  float* lb = us + kD;          // (I, k): pivots lb_0 = 0, lb_I = la_{16 I - 2}, lb_4 = la_C
  float* g = lb + (kNSub + 1) * kD;  // (I, k): exp(lb_{I+1} - lb_I)
  float* eb = g + kNSub * kD;   // (I, k): exp(lb_I)
  int* ticket = reinterpret_cast<int*>(eb + (kNSub + 1) * kD);

  const int tid = threadIdx.x, lane = tid & 31;
  if (tid == 0) *ticket = atomicAdd(sync, 1);
  __syncthreads();
  const int c = *ticket / BH, bh = *ticket % BH;  // chunk-major: chunk c - 1 has started
  const int b = bh / H, h = bh % H;
  const int c0 = c * kC;
  const int C = min(kC, S - c0);
  const long long kstride = (long long)H * K, vstride = (long long)H * V;
  const size_t rk0 = ((size_t)b * S + c0) * kstride + (size_t)h * K;
  const size_t v0 = ((size_t)b * S + c0) * vstride + (size_t)h * V;

  // 1. the chunk's operands; rows past C and columns past K, V are 0 (w 1)
  if (vec) {  // K and V rows are whole 16-byte vectors
    constexpr int E = 16 / sizeof(T);
    constexpr int N = kTile / E / kThreads;
    uint4 rv[N], kv[N], vv[N];
    float4 wv[kTile / 4 / kThreads];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int i = (tid + j * kThreads) * E, t = i / kD, x = i % kD;
      const uint4 z = make_uint4(0, 0, 0, 0);
      const bool okk = t < C && x < K, okv = t < C && x < V;
      rv[j] = okk ? __ldg(reinterpret_cast<const uint4*>(r + rk0 + t * kstride + x)) : z;
      kv[j] = okk ? __ldg(reinterpret_cast<const uint4*>(k + rk0 + t * kstride + x)) : z;
      vv[j] = okv ? __ldg(reinterpret_cast<const uint4*>(v + v0 + t * vstride + x)) : z;
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
      put16(rs + i, rv[j], T());
      put16(ks + i, kv[j], T());
      put16(vs + i, vv[j], T());
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
      const bool okk = t < C && x < K;
      const size_t g_rk = rk0 + (size_t)t * kstride + x;
      rs[i] = okk ? load_f32(r, g_rk) : 0.0f;
      ks[i] = okk ? load_f32(k, g_rk) : 0.0f;
      la[i] = okk ? logf(fmaxf(w[g_rk], 1e-38f)) : 0.0f;
      vs[i] = (t < C && x < V) ? load_f32(v, v0 + (size_t)t * vstride + x) : 0.0f;
    }
  }
  for (int i = tid; i < kNSub * kSub * kAttLd; i += kThreads) att[i] = 0.0f;
  if (tid < kD) us[tid] = tid < K ? u[((size_t)(b / u_div) * H + h) * K + tid] : 0.0f;
  __syncthreads();

  if (tid < kD) {  // column tid: la, la_prev, the pivots and their exps
    cumsum_column(la, lp, tid);
    lb[tid] = 0.0f;
    for (int I = 1; I < kNSub; ++I) lb[I * kD + tid] = la[(I * kSub - 2) * kD + tid];
    lb[kNSub * kD + tid] = la[(kC - 1) * kD + tid];
    for (int I = 0; I <= kNSub; ++I) eb[I * kD + tid] = expf(lb[I * kD + tid]);
    for (int I = 0; I < kNSub; ++I)
      g[I * kD + tid] = expf(lb[(I + 1) * kD + tid] - lb[I * kD + tid]);
  } else if (tid < kD + kC) {  // meanwhile the bonus (r_t . u . k_t), at tau = t
    const int t = tid - kD;
    float bsum = 0.0f;
    for (int q = 0; q < kD; ++q) {
      const int x = (q + lane) % kD;
      bsum = fmaf(rs[t * kD + x] * us[x], ks[t * kD + x], bsum);
    }
    att[t * kAttLd + t % kSub + 1] = bsum;
  }
  __syncthreads();

  // 2. the pairwise weights near the diagonal: row t = 16 I + tl, keys
  // tau = 16 I - 1 + c for c <= tl (c >= 1 in sub-chunk 0), three a thread
  // (198 threads)
  {
    constexpr int kCells = 3;
    int item = tid, I = 0, tl = 0, c_lo = 1;
    for (I = 0; I < kNSub; ++I) {
      for (tl = 0; tl < kSub; ++tl) {
        c_lo = I == 0 ? 1 : 0;
        const int n = (tl - c_lo + kCells) / kCells;  // groups of cells in this row
        if (item < n) break;
        item -= n;
      }
      if (tl < kSub) break;
    }
    if (I < kNSub) {
      const int t = I * kSub + tl;
      const int cb = c_lo + kCells * item;  // first column of this thread's group
      int tau[kCells];
#pragma unroll
      for (int e = 0; e < kCells; ++e) tau[e] = cb + e <= tl ? I * kSub - 1 + cb + e : t;
      float a[kCells] = {};
#pragma unroll 2
      for (int q = 0; q < kD / 4; ++q) {
        const int x = 4 * ((q + lane) % (kD / 4));  // skewed: the lanes' rows differ
        const float4 rr = ld4(rs + t * kD + x), pp = ld4(lp + t * kD + x);
#pragma unroll
        for (int e = 0; e < kCells; ++e) {
          const float4 kk = ld4(ks + tau[e] * kD + x), ll = ld4(la + tau[e] * kD + x);
          a[e] += rr.x * kk.x * __expf(fminf(pp.x - ll.x, 0.0f));
          a[e] += rr.y * kk.y * __expf(fminf(pp.y - ll.y, 0.0f));
          a[e] += rr.z * kk.z * __expf(fminf(pp.z - ll.z, 0.0f));
          a[e] += rr.w * kk.w * __expf(fminf(pp.w - ll.w, 0.0f));
        }
      }
      float* arow = att + (I * kSub + tl) * kAttLd;
#pragma unroll
      for (int e = 0; e < kCells; ++e)
        if (cb + e <= tl) arow[cb + e] = a[e];
    }
  }
  __syncthreads();

  // decay r towards its sub-chunk's pivot (clamped at 0 as the pairwise exp
  // is), k towards the pivot after its group G (steps 16 G - 1 .. 16 G + 14,
  // the last group to the chunk's end); four consecutive columns at a time
#pragma unroll
  for (int j = 0; j < kTile / 4 / kThreads; ++j) {
    const int i = (tid + j * kThreads) * 4, t = i / kD, x = i % kD;
    const int I = t / kSub, G = min((t + 1) / kSub, kNSub - 1);
    float4 rr = ld4(rs + i), kk = ld4(ks + i);
    const float4 pp = ld4(lp + i), ll = ld4(la + i);
    const float4 b0 = ld4(lb + I * kD + x), b1 = ld4(lb + (G + 1) * kD + x);
    rr.x *= __expf(fminf(pp.x - b0.x, 0.0f));
    rr.y *= __expf(fminf(pp.y - b0.y, 0.0f));
    rr.z *= __expf(fminf(pp.z - b0.z, 0.0f));
    rr.w *= __expf(fminf(pp.w - b0.w, 0.0f));
    kk.x *= __expf(b1.x - ll.x);
    kk.y *= __expf(b1.y - ll.y);
    kk.z *= __expf(b1.z - ll.z);
    kk.w *= __expf(b1.w - ll.w);
    *reinterpret_cast<float4*>(rs + i) = rr;
    *reinterpret_cast<float4*>(ks + i) = kk;
  }
  __syncthreads();

  // the chunk's own state at the pivots: W_1 -> la, W_2 -> lp, W_3 -> k
  // (after W_4, which reads the last group of k, is done), W_4 in registers
  const int kg = tid / 16, vg = tid % 16;
  float acc[4][4] = {};
  float w3[4][4];
#pragma unroll
  for (int G = 0; G < kNSub; ++G) {
    if (G > 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] *= g[G * kD + 4 * kg + i];
    }
    const int lo = G == 0 ? 0 : G * kSub - 1, hi = G == kNSub - 1 ? kC : (G + 1) * kSub - 1;
    for (int tau = lo; tau < hi; ++tau) {
      const float4 a = ld4(ks + tau * kD + 4 * kg);
      const float4 bb = ld4(vs + tau * kD + 4 * vg);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (G < 2) {
      float* dst = G == 0 ? la : lp;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<float4*>(dst + (4 * kg + i) * kD + 4 * vg) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    } else if (G == 2) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) w3[i][j] = acc[i][j];
    }
  }
  __syncthreads();  // every read of k is done
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(ks + (4 * kg + i) * kD + 4 * vg) =
        make_float4(w3[i][0], w3[i][1], w3[i][2], w3[i][3]);

  // 3. the state entering the chunk, and the one after it for the next chunk
  if (c > 0) {
    if (tid == 0) wait_flag(sync + 1 + (size_t)bh * nc + c);
    __syncthreads();
  }
  const float* src = c > 0 ? states + ((size_t)bh * nc + c) * K * V : s_init + (size_t)bh * K * V;
  float* dst = c + 1 < nc ? states + ((size_t)bh * nc + c + 1) * K * V : s_out + (size_t)bh * K * V;
  float sin[4][4];
  if (vec) {  // V a multiple of 4: one float4 a row, all four in flight
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kk = 4 * kg + i, vv = 4 * vg;
      const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      const float4 q = kk < K && vv < V
                           ? __ldcg(reinterpret_cast<const float4*>(src + (size_t)kk * V + vv)) : z;
      sin[i][0] = q.x;
      sin[i][1] = q.y;
      sin[i][2] = q.z;
      sin[i][3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kk = 4 * kg + i, vv = 4 * vg + j;
        sin[i][j] = kk < K && vv < V ? __ldcg(src + (size_t)kk * V + vv) : 0.0f;
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kk = 4 * kg + i, vv = 4 * vg + j;
      if (kk < K && vv < V)
        dst[(size_t)kk * V + vv] = fmaf(eb[kNSub * kD + kk], sin[i][j], acc[i][j]);
    }
  if (c + 1 < nc) {
    __threadfence();
    __syncthreads();
    if (tid == 0) atomicExch(sync + 1 + (size_t)bh * nc + c + 1, 1);
  }
  // S_I = exp(lb_I) S + W_I, S_0 = S: the thread's own 4 x 4 of each
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = (4 * kg + i) * kD + 4 * vg;
    *reinterpret_cast<float4*>(s0 + row) = make_float4(sin[i][0], sin[i][1], sin[i][2], sin[i][3]);
#pragma unroll
    for (int I = 1; I < kNSub; ++I) {
      float* t = (I == 1 ? la : (I == 2 ? lp : ks)) + row;
      const float e = eb[I * kD + 4 * kg + i];
      const float4 wv = ld4(t);
      *reinterpret_cast<float4*>(t) =
          make_float4(fmaf(e, sin[i][0], wv.x), fmaf(e, sin[i][1], wv.y),
                      fmaf(e, sin[i][2], wv.z), fmaf(e, sin[i][3], wv.w));
    }
  }
  __syncthreads();

  // 4. y: thread (ty, tx) owns rows 4 ty.. (all in sub-chunk ty / 4) and columns 4 tx..
  const int ty = tid / 16, tx = tid % 16;
  const int I = ty / (kSub / 4);
  const float* SI = I == 0 ? s0 : (I == 1 ? la : (I == 2 ? lp : ks));
  float ya[4][4] = {};
  for (int q = 0; q < kD / 4; ++q) {
    float av[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 a = ld4(rs + (4 * ty + i) * kD + 4 * q);
      av[i][0] = a.x;
      av[i][1] = a.y;
      av[i][2] = a.z;
      av[i][3] = a.w;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float4 bb = ld4(SI + (4 * q + e) * kD + 4 * tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ya[i][0] = fmaf(av[i][e], bb.x, ya[i][0]);
        ya[i][1] = fmaf(av[i][e], bb.y, ya[i][1]);
        ya[i][2] = fmaf(av[i][e], bb.z, ya[i][2]);
        ya[i][3] = fmaf(av[i][e], bb.w, ya[i][3]);
      }
    }
  }
  const int tl0 = (4 * ty) % kSub;
  const float* ablk = att + I * kSub * kAttLd;
  // columns up to the last row's bonus; the weights past each row's own are 0
  for (int cc = I == 0 ? 1 : 0; cc <= tl0 + 4; ++cc) {
    const float4 bb = ld4(vs + (I * kSub - 1 + cc) * kD + 4 * tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = ablk[(tl0 + i) * kAttLd + cc];
      ya[i][0] = fmaf(a, bb.x, ya[i][0]);
      ya[i][1] = fmaf(a, bb.y, ya[i][1]);
      ya[i][2] = fmaf(a, bb.z, ya[i][2]);
      ya[i][3] = fmaf(a, bb.w, ya[i][3]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = 4 * ty + i;
    if (t >= C) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int vv = 4 * tx + j;
      if (vv < V) store_f32(y, v0 + (size_t)t * vstride + vv, ya[i][j]);
    }
  }
}

template <typename T>
int wkv6_typed(const void* r, const void* k, const void* v, const float* w, const float* u,
               const float* s0, void* y, float* s_out, float* states, int* sync, int B, int S,
               int H, int K, int V, int u_div, cudaStream_t stream) {
  const int nc = (S + kC - 1) / kC;
  const int BH = B * H;
  if (nc == 0)  // no steps: the state passes through
    return (int)cudaMemcpyAsync(s_out, s0, sizeof(float) * (size_t)BH * K * V,
                                cudaMemcpyDeviceToDevice, stream);
  const int vec = (K * sizeof(T)) % 16 == 0 && (V * sizeof(T)) % 16 == 0;
  const size_t smem = smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(wkv6_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)  // two blocks an SM: all of the unified memory as shared memory
    err = cudaFuncSetAttribute(wkv6_kernel<T>, cudaFuncAttributePreferredSharedMemoryCarveout,
                               100);
  if (err != cudaSuccess) return (int)err;
  wkv6_kernel<T><<<(unsigned)((size_t)BH * nc), kThreads, smem, stream>>>(
      (const T*)r, (const T*)k, (const T*)v, w, u, s0, (T*)y, s_out, states, sync, S, H, K, V,
      nc, BH, vec, u_div);
  return (int)cudaGetLastError();
}

}  // namespace

// r, k, v of ``dtype``; w, u, s0 and s_out f32; u (B / u_div, H, K): batch
// row b reads row b / u_div (u_div = B: one u shared by every row);
// ``states`` f32 scratch of B H nc K V floats (nc = ceil(S / 64)), which the
// backward (wkv6_bwd.cu) reads; ``sync`` int32 of 1 + B H nc, zeroed.
// Returns a CUDA error code.
extern "C" int launch_wkv6(const void* r, const void* k, const void* v, const void* w,
                           const void* u, const void* s0, void* y, void* s_out, void* states,
                           void* sync, int B, int S, int H, int K, int V, int u_div, int dtype,
                           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (K < 1 || K > kD || V < 1 || V > kD || S < 0 || u_div < 1 || B % u_div != 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0) return (int)cudaGetLastError();
  if (dtype == kF32)
    return wkv6_typed<float>(r, k, v, (const float*)w, (const float*)u, (const float*)s0, y,
                             (float*)s_out, (float*)states, (int*)sync, B, S, H, K, V, u_div,
                             (cudaStream_t)stream);
  if (dtype == kBF16)
    return wkv6_typed<__nv_bfloat16>(r, k, v, (const float*)w, (const float*)u,
                                     (const float*)s0, y, (float*)s_out, (float*)states,
                                     (int*)sync, B, S, H, K, V, u_div, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}
