// Kernels over the (m, W) client arena, each with the (W,) server row
// broadcast inside the kernel (never materialised at (m, W)).  They
// replace, in src/repro/kernels/round_tail.py:
//
//   round_tail_pallas         lam_is = rho (x_s - x_ref) - lam_s
//                             u      = x_ref - lam_is / rho
//                             (lam_is written only when asked; with the
//                             client mean of u in the same pass when asked)
//   dual_from_uplink_pallas   lam'   = rho (u - x_s') (with lam's f32 column
//                             sum in the same pass when asked), after the
//                             client-mean pass x_s' = mean_i u_i: the
//                             server step, two passes over the arena
//   scaffold_cv_pallas        c_i'   = (c_i - c) + alpha_i (x_s - x_K)
//                             (SCAFFOLD's eq. (30); c and x_s are (W,)
//                             rows, alpha per client or scalar)
//
// (its two EF21 kernels, ef21_rowmax_pallas and ef21_apply_pallas, are
// csrc/ef21.cu's)
//
// What bounds them on an H100: bytes.  Each does a handful of flops per
// element against 8-20 bytes of traffic, so the least time is the arena's
// reads and writes over the 3.35 TB/s of device memory; at the paper's sizes
// (about 1 MiB per buffer) a launch costs more than that.  The round tail,
// the client mean and the dual are the column walks described below.
// SCAFFOLD's kernel keeps the plain design: one thread per element, a
// grid-stride loop, loads in the arena's dtype, f32 math with the _rn
// intrinsics (bitwise the reference's f32 operation order), one store per
// output, the server row indexed as t % W.  The TPU's (rows, 128) tiles and
// BlockSpec grids do not carry over.  The division lam_is / rho stays a
// division, as in the reference; SCAFFOLD's alpha = 1/(K eta) arrives
// precomputed and is multiplied, as the reference multiplies it.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// ---------------------------------------------------------------------------
// The server step: kernels 2 and 3 as column walks over the (m, W) arena.
//
// Every pass below has one shape.  A lane owns a 16-byte group of V
// columns (4 f32 or 8 bf16; V = 1 when W is not a multiple of that), a warp
// 32 groups.  A block's 8 warps are rw x cw: cw column groups of 32, each
// walked by rw warps over the slice's rows r0 + q, r0 + q + rw, ... in
// order (rw = 8 on a tall arena, 1 on lm_flat's 8 rows, so that a warp has
// rows to keep loads in flight).  The grid is (CT, S): blockIdx.x a tile of
// cw * 32 * V columns, blockIdx.y one of S slices of ``rows`` consecutive
// rows.  Each lane has kUnroll rows' loads in flight before their
// arithmetic.  The server row x_s sits in the lane's registers for the
// whole walk, so an element costs no index arithmetic beyond a pointer
// step.  A pass that reduces keeps f32 column sums of what each lane reads
// (or stores), and the block adds each column's rw warp sums in warp order
// into the slice's partial.
//
// With S = 1 that partial is the column's sum.  Otherwise each slice's
// block writes its partial row to an (S, W) f32 workspace, fences, and
// takes a ticket from its tile's counter (an integer atomic, the only one);
// the block that draws the last ticket adds the tile's S partials in slice
// order (P = 256 / tile columns fixed contiguous runs of slices when the
// tile is narrower than the block, each summed in order, then the runs in
// order), writes the result and sets the counter
// back to 0 for the next launch.  Every sum is taken in an order fixed by
// (m, W, S), and the wrapper picks S from (m, W) and the SM count alone,
// so a result is the same bits from run to run.
//
//   kMean (pass 1)   x_s'[j] = (sum_i u[i, j]) / m, rounded to the dtype
//   kTail            lam_is = rho (x_s - x_ref) - lam_s and the uplink
//                    u = x_ref - lam_is / rho (eq. 23/24); reducing, also
//                    pass 1 over u as stored (kernel 2's mean epilogue)
//   kDual (pass 2)   lam' = rho (u - x_s'); reducing, also the f32 column
//                    sum of lam' as stored (rounded to the dtype), whose
//                    norm is lam_sum_norm
//
// The elementwise arithmetic is the _rn intrinsics in the reference's
// order, so lam_is and lam' are bitwise the plain versions; the uplink's
// lam_is / rho is a division, as in the reference.
//
// What bounds it on an H100: bytes.  Pass 1 reads the arena once; pass 2
// reads it and writes lam'.  At (10^6, 1,024) f32 that is 4.1 + 8.2 GB,
// 3.67 ms at 3.35 TB/s, where the first design made four passes (the mean,
// the dual, the column sum).  S is sized for 4 blocks of 256 threads an SM
// (the launch bounds hold a thread to 64 registers) and at least 4 rows a
// warp where the pass reduces (1 where it does not): at (10^6, 1,024) f32
// the grid is 8 x 66, one wave, 1,894 rows a warp; at lm_flat (8, 2^20)
// 1,024 tiles of 8 warps, one a column group of 8 rows, with S = 1.
// ---------------------------------------------------------------------------

constexpr int kWalkWarps = kThreads / 32;

enum WalkOp : int { kMean = 0, kTail = 1, kDual = 2 };

// 16 bytes of T as V values: f32 x 4 in a float4, bf16 x 8 in a uint4; the
// V = 1 fallback (W not a multiple of the vector) moves one value.
template <typename T, int V>
struct Vec;

template <>
struct Vec<float, 4> {
  using Raw = float4;
  static __device__ __forceinline__ Raw load(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ void unpack(const Raw& r, float (&v)[4]) {
    v[0] = r.x;
    v[1] = r.y;
    v[2] = r.z;
    v[3] = r.w;
  }
  // store v, and leave in v what was stored
  static __device__ __forceinline__ void store(float* p, float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec<__nv_bfloat16, 8> {
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
  static __device__ __forceinline__ void unpack(const Raw& r, float (&v)[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float (&v)[8]) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      h[k] = __halves2bfloat162(__float2bfloat16_rn(v[2 * k]),
                                __float2bfloat16_rn(v[2 * k + 1]));
      const float2 f = __bfloat1622float2(h[k]);
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
    *reinterpret_cast<uint4*>(p) = raw;
  }
};

template <typename T>
struct Vec<T, 1> {
  using Raw = T;
  static __device__ __forceinline__ Raw load(const T* p) { return *p; }
  static __device__ __forceinline__ void unpack(const Raw& r, float (&v)[1]) {
    v[0] = load_f32(&r, 0);
  }
  static __device__ __forceinline__ void store(T* p, float (&v)[1]) {
    T q;
    store_f32(&q, 0, v[0]);
    *p = q;
    v[0] = load_f32(&q, 0);
  }
};

struct WalkArgs {
  const void* a;       // u (kMean, kDual) or x_ref (kTail)
  const void* b;       // lam_s (kTail)
  const void* xs;      // the server row (kTail, kDual)
  void* lam_is;        // kTail, optional
  void* out;           // the uplink (kTail) or lam' (kDual)
  void* row;           // the reduced row: x_s' (dtype) or lam's column sum (f32)
  float* partials;     // (S, W) f32 when S > 1
  unsigned* tickets;   // a counter a column tile, 0 between launches
  float rho;
  long long m, rows;   // rows: a slice's
  int W, G, S;         // width, column groups (W / V), slices
  int rw;              // warps a column group (8, 4, 2 or 1); 8 / rw groups a block
};

// one row of a lane's columns: ``val`` gets the value the pass reduces (u
// as read for kMean, the uplink or lam' as stored)
template <typename T, int V, int OP, bool kLamIs>
__device__ __forceinline__ void walk_row(const WalkArgs& a, size_t off,
                                         const typename Vec<T, V>::Raw& ra,
                                         const typename Vec<T, V>::Raw& rb,
                                         const float (&s)[V], float (&val)[V]) {
  using VT = Vec<T, V>;
  VT::unpack(ra, val);
  if (OP == kTail) {
    float l[V], li[V];
    VT::unpack(rb, l);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      li[k] = __fsub_rn(__fmul_rn(a.rho, __fsub_rn(s[k], val[k])), l[k]);
      val[k] = __fsub_rn(val[k], __fdiv_rn(li[k], a.rho));
    }
    if (kLamIs) VT::store(static_cast<T*>(a.lam_is) + off, li);
    VT::store(static_cast<T*>(a.out) + off, val);
  } else if (OP == kDual) {
#pragma unroll
    for (int k = 0; k < V; ++k) val[k] = __fmul_rn(a.rho, __fsub_rn(val[k], s[k]));
    VT::store(static_cast<T*>(a.out) + off, val);
  }
}

// the reduced row's entry for column ``col`` from its f32 sum
template <typename T, int OP>
__device__ __forceinline__ void finish(const WalkArgs& a, int col, float sum) {
  if (OP == kDual) {
    static_cast<float*>(a.row)[col] = sum;
  } else {
    store_f32(static_cast<T*>(a.row), col, __fdiv_rn(sum, (float)a.m));
  }
}

template <typename T, int V, int OP, bool kLamIs, bool kReduce>
__global__ void __launch_bounds__(kThreads, 4)
column_walk_kernel(const WalkArgs a) {
  using VT = Vec<T, V>;
  constexpr int kUnroll = OP == kTail ? 2 : 4;  // rows' loads in flight a lane
  constexpr int kCols = 32 * V;                 // columns a warp
  __shared__ float red[kWalkWarps][kCols];
  __shared__ bool last;

  // warp = cwi * rw + rwi: rw warps walk a column group's rows, cw groups
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int rw = a.rw, cw = kWalkWarps / a.rw;
  const int rwi = warp % rw, cwi = warp / rw;
  const long long g = ((long long)blockIdx.x * cw + cwi) * 32 + lane;
  const size_t c0 = (size_t)g * V;
  const long long r0 = (long long)blockIdx.y * a.rows;
  const long long r1 = min(a.m, r0 + a.rows);

  float s[V], acc[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    acc[k] = 0.f;
    s[k] = 0.f;
  }
  if (g < a.G) {
    if (OP != kMean) VT::unpack(VT::load(static_cast<const T*>(a.xs) + c0), s);
    const T* pa = static_cast<const T*>(a.a);
    const T* pb = static_cast<const T*>(a.b);
    // this warp's rows of the slice: r0 + rwi, r0 + rwi + rw, ... < r1
    const long long first = r0 + rwi;
    const int n = first < r1 ? (int)((r1 - first + rw - 1) / rw) : 0;
    const size_t step = (size_t)rw * a.W;
    size_t off = (size_t)first * a.W + c0;
    int i = 0;
    for (; i + kUnroll <= n; i += kUnroll, off += kUnroll * step) {
      typename VT::Raw ra[kUnroll], rb[kUnroll];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        ra[j] = VT::load(pa + off + j * step);
        rb[j] = OP == kTail ? VT::load(pb + off + j * step) : ra[j];
      }
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        float val[V];
        walk_row<T, V, OP, kLamIs>(a, off + j * step, ra[j], rb[j], s, val);
        if (kReduce) {
#pragma unroll
          for (int k = 0; k < V; ++k) acc[k] = __fadd_rn(acc[k], val[k]);
        }
      }
    }
    for (; i < n; ++i, off += step) {
      const typename VT::Raw ra = VT::load(pa + off);
      const typename VT::Raw rb = OP == kTail ? VT::load(pb + off) : ra;
      float val[V];
      walk_row<T, V, OP, kLamIs>(a, off, ra, rb, s, val);
      if (kReduce) {
#pragma unroll
        for (int k = 0; k < V; ++k) acc[k] = __fadd_rn(acc[k], val[k]);
      }
    }
  }
  if (!kReduce) return;

  // the slice's partial of each of the tile's cw * kCols columns: the sums
  // of the rw warps that walked it, in warp order
#pragma unroll
  for (int k = 0; k < V; ++k) red[warp][lane * V + k] = acc[k];
  __syncthreads();
  const int t = threadIdx.x;
  const int tile = cw * kCols;  // a power of two
  const int col0 = blockIdx.x * tile;
  for (int c = t; c < tile && col0 + c < a.W; c += kThreads) {
    const int q0 = (c / kCols) * rw, cc = c % kCols;
    float part = red[q0][cc];
    for (int q = 1; q < rw; ++q) part = __fadd_rn(part, red[q0 + q][cc]);
    if (a.S == 1) finish<T, OP>(a, col0 + c, part);
    else a.partials[(size_t)blockIdx.y * a.W + col0 + c] = part;
  }
  if (a.S == 1) return;
  __threadfence();
  __syncthreads();
  if (t == 0) last = atomicAdd(&a.tickets[blockIdx.x], 1u) == (unsigned)(a.S - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();

  // the last slice's block: each column's S partials in slice order, in P
  // contiguous runs (P threads a column when the tile is narrower than the
  // block), each summed in order, then the runs in order
  const int P = tile < kThreads ? kThreads / tile : 1;
  const int run = t / (kThreads / P) % P;
  const int s0 = run * a.S / P, s1 = (run + 1) * a.S / P;
  float* flat = &red[0][0];  // P * tile <= 8 kCols floats when P > 1
  __syncthreads();           // every warp is done with red
  for (int c = t % (kThreads / P); c < tile && col0 + c < a.W; c += kThreads / P) {
    float sum = 0.f;
    if (s1 > s0) {
      const float* p = a.partials + col0 + c;
      sum = __ldcg(p + (size_t)s0 * a.W);
      int sl = s0 + 1;
      for (; sl + 8 <= s1; sl += 8) {
        float v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = __ldcg(p + (size_t)(sl + j) * a.W);
#pragma unroll
        for (int j = 0; j < 8; ++j) sum = __fadd_rn(sum, v[j]);
      }
      for (; sl < s1; ++sl) sum = __fadd_rn(sum, __ldcg(p + (size_t)sl * a.W));
    }
    if (P == 1) finish<T, OP>(a, col0 + c, sum);
    else flat[run * tile + c] = sum;
  }
  if (P > 1) {
    __syncthreads();
    if (t < tile && col0 + t < a.W) {
      float total = flat[t];
      for (int q = 1; q < P; ++q) {
        if ((q + 1) * a.S / P > q * a.S / P) total = __fadd_rn(total, flat[q * tile + t]);
      }
      finish<T, OP>(a, col0 + t, total);
    }
  }
  if (t == 0) a.tickets[blockIdx.x] = 0u;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
scaffold_cv_kernel(const T* __restrict__ ci, const T* __restrict__ xk,
                   const T* __restrict__ c, const T* __restrict__ xs,
                   const float* __restrict__ alpha_arr, float alpha, size_t n, int W,
                   T* __restrict__ out) {
  for (size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x; t < n;
       t += (size_t)gridDim.x * blockDim.x) {
    const size_t j = t % W;
    const float a = alpha_arr != nullptr ? alpha_arr[t / W] : alpha;
    const float cv = __fsub_rn(load_f32(ci, t), load_f32(c, j));
    store_f32(out, t, __fadd_rn(cv, __fmul_rn(a, __fsub_rn(load_f32(xs, j), load_f32(xk, t)))));
  }
}

// the V of a width: 16 bytes of T when W is a multiple of it, else 1
template <typename T>
constexpr int vec_of() {
  return 16 / (int)sizeof(T);
}

template <typename T, int V, int OP>
cudaError_t walk_launch(WalkArgs a, bool lam_is, cudaStream_t stream) {
  a.G = a.W / V;
  const int cw = kWalkWarps / a.rw;
  const dim3 grid((unsigned)(((a.G + 31) / 32 + cw - 1) / cw), (unsigned)a.S);
  const bool reduce = a.row != nullptr;
  if constexpr (OP == kTail) {
    if (lam_is && reduce) column_walk_kernel<T, V, OP, true, true><<<grid, kThreads, 0, stream>>>(a);
    else if (lam_is) column_walk_kernel<T, V, OP, true, false><<<grid, kThreads, 0, stream>>>(a);
    else if (reduce) column_walk_kernel<T, V, OP, false, true><<<grid, kThreads, 0, stream>>>(a);
    else column_walk_kernel<T, V, OP, false, false><<<grid, kThreads, 0, stream>>>(a);
  } else {
    column_walk_kernel<T, V, OP, false, true><<<grid, kThreads, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

template <int OP>
int walk(WalkArgs a, int dtype, bool lam_is, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (a.W <= 0 || a.S <= 0 || a.rows <= 0 || a.rows > 0x7fffffffLL ||
      (a.rw != 1 && a.rw != 2 && a.rw != 4 && a.rw != 8) ||
      (OP != kTail && a.row == nullptr) ||
      (a.row != nullptr && a.S > 1 && (a.partials == nullptr || a.tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == kF32) {
    return (int)(a.W % vec_of<float>() == 0 ? walk_launch<float, 4, OP>(a, lam_is, st)
                                           : walk_launch<float, 1, OP>(a, lam_is, st));
  }
  if (dtype == kBF16) {
    return (int)(a.W % vec_of<__nv_bfloat16>() == 0
                     ? walk_launch<__nv_bfloat16, 8, OP>(a, lam_is, st)
                     : walk_launch<__nv_bfloat16, 1, OP>(a, lam_is, st));
  }
  return (int)cudaErrorInvalidValue;
}

WalkArgs walk_args(long long m, int W, long long rows, int S, int rw, void* row,
                   void* partials, void* tickets) {
  WalkArgs a{};
  a.m = m;
  a.W = W;
  a.rows = rows;
  a.S = S;
  a.rw = rw;
  a.row = row;
  a.partials = static_cast<float*>(partials);
  a.tickets = static_cast<unsigned*>(tickets);
  return a;
}

}  // namespace

// Kernel 2, eq. (23/24) and the uplink; with ``mean_out`` also the client
// mean of the uplink (pass 1 folded in: ``partials`` (S, W) f32 and
// ``tickets`` when S > 1).
extern "C" int launch_round_tail(const void* xr, const void* lam, const void* xs, float rho,
                                 long long m, int W, int dtype, void* lam_is_out,
                                 void* up_out, void* mean_out, void* partials, void* tickets,
                                 long long rows, int S, int rw, int device, void* stream) {
  WalkArgs a = walk_args(m, W, rows, S, rw, mean_out, partials, tickets);
  a.a = xr;
  a.b = lam;
  a.xs = xs;
  a.lam_is = lam_is_out;
  a.out = up_out;
  a.rho = rho;
  return walk<kTail>(a, dtype, lam_is_out != nullptr, device, stream);
}

// Pass 1 of the server step: x_s' = mean_i u_i, rounded to the dtype.
extern "C" int launch_client_mean(const void* u, long long m, int W, int dtype, void* mean_out,
                                  void* partials, void* tickets, long long rows, int S, int rw,
                                  int device, void* stream) {
  WalkArgs a = walk_args(m, W, rows, S, rw, mean_out, partials, tickets);
  a.a = u;
  return walk<kMean>(a, dtype, false, device, stream);
}

// Kernel 3, pass 2 of the server step: lam' = rho (u - x_s') and lam's f32
// column sum ``colsum_out``.
extern "C" int launch_dual_from_uplink(const void* u, const void* xs, float rho, long long m,
                                       int W, int dtype, void* out, void* colsum_out,
                                       void* partials, void* tickets, long long rows, int S,
                                       int rw, int device, void* stream) {
  WalkArgs a = walk_args(m, W, rows, S, rw, colsum_out, partials, tickets);
  a.a = u;
  a.xs = xs;
  a.out = out;
  a.rho = rho;
  return walk<kDual>(a, dtype, false, device, stream);
}

extern "C" int launch_scaffold_cv(const void* ci, const void* xk, const void* c, const void* xs,
                                  const void* alpha_arr, float alpha, long long m, int W,
                                  int dtype, void* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)m * W;
  if (n == 0) return (int)cudaGetLastError();
  const unsigned blocks = elementwise_blocks(n, kThreads);
  if (dtype == kF32) {
    scaffold_cv_kernel<float><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)ci, (const float*)xk, (const float*)c, (const float*)xs,
        (const float*)alpha_arr, alpha, n, W, (float*)out);
  } else if (dtype == kBF16) {
    scaffold_cv_kernel<__nv_bfloat16><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)ci, (const __nv_bfloat16*)xk, (const __nv_bfloat16*)c,
        (const __nv_bfloat16*)xs, (const float*)alpha_arr, alpha, n, W, (__nv_bfloat16*)out);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
