// The EF21 uplink over the (m, W) client arena: the integrated server view
//     u_hat' = u_hat + clip(rint((u - u_hat) / s), -lo, lo) s,
//     s = max(max |u - u_hat| over the client's leaf / lo, 1e-12)
// with one scale s per (client, leaf) and lo = 2^(bits-1) - 1.  It replaces,
// in src/repro/kernels/round_tail.py,
//
//   ef21_rowmax_pallas   r[i, j] = max_l |u - u_hat| over the 128 lanes l of
//                        row j of client i, f32
//   ef21_apply_pallas    the quantise-apply pass given a scale per row
//
// and the plain per-leaf scale reduction that the reference's
// ops.ef21_update runs between them (src/repro/kernels/ops.py:529-572).
//
// What bounds it on an H100: bytes.  A few flops an element against one read
// of u and u_hat and one write of u_hat': 3 m W sizeof(T) bytes, 0.92 us for
// the least-squares arena (500 x 512 f32), below a launch.  So the design's
// aims are one launch and no plain tensor op between launches (each costs
// the host 10-57 us), and a single read of each input where it fits on chip.
//
// Design.  A segment is one leaf of one client: rows [r0, r0 + rows) of the
// client's 128-lane rows (the arena pads every leaf to whole rows).  The
// work is cut into spans of 16-byte chunks (4 f32 or 8 bf16 values), each
// span the work of one group of G threads (a warp, or a block of 256), each
// thread holding up to NC chunks of u and of u_hat in registers (raw, 8 NC
// registers).  Three modes, one kernel template:
//   kFused  (the resident route) a group holds a whole segment: it loads it
//           once, takes its max-abs with a warp (and block) reduction, forms
//           the scale and writes u_hat' from its registers.  One launch, one
//           read of each input.  A warp while the longest leaf is at most
//           32 x 8 chunks (8 f32 rows), a block up to 256 x 8 (64 f32 rows).
//   kMax    pass 1 of the wide route: a span's max-abs into the (m, L) f32
//           table; a segment of one span stores it, a longer one combines
//           its spans with atomicMax on the bits of |d| (which order
//           non-negative floats as integers, and put a NaN above +Inf), on a
//           table the launcher zeroed with cudaMemsetAsync.  A max is exact
//           in any order, so the table's bits do not depend on the order.
//   kApply  pass 2 of the wide route: each span forms its segment's scale
//           from the table and writes u_hat'.  The spans are walked in the
//           reverse of pass 1's order, so that what pass 1 read last is
//           still in the 50 MB L2 when pass 2 starts.
// ef21_rowmax is kMax with every row its own segment (no table: nleaf = 0),
// ef21_apply is kApply with the table holding the per-row scales themselves
// (`given`).
//
// A block finds its span's leaf by a binary search over the leaves' first
// spans, in a table passed by value as one __grid_constant__ parameter: two
// tables, 8 leaves and as many as the parameter limit allows, so the common
// launch carries 144 bytes.  No copy to the device, no allocation.
//
// Arithmetic, bit for bit the plain composition ref.ef21_apply_ref(u, u_hat,
// ref.ef21_row_scales_ref(ref.ef21_rowmax_ref(u, u_hat), ...)): loads in the
// arena's dtype, f32 math with the _rn intrinsics; |d| reduced with a
// NaN-propagating max (torch.amax keeps a NaN, fmaxf would drop it); the
// scale a true division by lo (__fdiv_rn: the plain version divides by a
// tensor, never a multiply by a reciprocal), then clamped at 1e-12f with a
// NaN let through as torch.clamp does; the quotient __fdiv_rn, rounded by
// rintf (half to even, as torch.round), clipped to +-lo with a NaN let
// through; u_hat + q s with __fmul_rn and __fadd_rn; a bf16 result rounded to
// nearest even.  A NaN or an Inf in a leaf makes its scale NaN or Inf and
// every value of that (client, leaf) NaN; the other segments keep their bits.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 128;
constexpr int kMaxChunks = 8;   // 16-byte chunks of each input a thread holds (kFused)
constexpr int kWideChunks = 4;  // the wide route's spans: 256 threads x 4 chunks
constexpr int kSmallLeaves = 8;
#if CUDART_VERSION >= 12010
constexpr size_t kParamLimit = 32764;
#else
constexpr size_t kParamLimit = 4096;
#endif
constexpr int kHeader = 72;  // bytes of Params before its two arrays
constexpr int kMaxLeaves = (int)((kParamLimit - kHeader) / 8) - 1;

enum Mode : int { kMax = 0, kApply = 1, kFused = 2 };

template <int CAP>
struct Params {
  const void* u;
  const void* uh;
  void* out;     // kApply, kFused
  float* table;  // (m, L) f32: kMax's maxima, kApply's maxima or (given) scales
  long long m;
  int W;         // values a client row
  int L;         // table columns: the leaves, or the rows when nleaf == 0
  int spans;     // spans a client
  int nleaf;     // 0: every 128-lane row is its own segment
  float lo;
  int given;     // kApply: the table holds the scales themselves
  int reverse;   // walk the spans last to first
  int pad_;
  int chunk0[CAP + 1];  // leaf k: chunks [chunk0[k], chunk0[k + 1]) of a client row
  int span0[CAP + 1];   // leaf k: spans [span0[k], span0[k + 1]) of a client
};

static_assert(sizeof(Params<1>) == kHeader + 16, "parameter layout");
static_assert(sizeof(Params<kMaxLeaves>) <= kParamLimit, "leaf table above the parameter limit");

// 16 bytes of T: V values, unpacked to f32 and packed back (bf16 rounded to
// nearest even)
template <typename T>
struct Chunk;

template <>
struct Chunk<float> {
  static constexpr int V = 4;
  __device__ __forceinline__ static void unpack(const uint4& r, float* v) {
    v[0] = __uint_as_float(r.x);
    v[1] = __uint_as_float(r.y);
    v[2] = __uint_as_float(r.z);
    v[3] = __uint_as_float(r.w);
  }
  __device__ __forceinline__ static uint4 pack(const float* v) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                      __float_as_uint(v[3]));
  }
};

template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int V = 8;
  __device__ __forceinline__ static void unpack(const uint4& r, float* v) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
      v[2 * j] = f.x;
      v[2 * j + 1] = f.y;
    }
  }
  __device__ __forceinline__ static uint4 pack(const float* v) {
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
      w[j] = *reinterpret_cast<const uint32_t*>(&h);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// NaN-propagating max (fmaxf returns the other operand for a NaN)
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// the per-(client, leaf) scale from its max-abs, as the plain version forms it
__device__ __forceinline__ float leaf_scale(float mx, float lo) {
  const float s = __fdiv_rn(mx, lo);
  return s != s ? s : fmaxf(s, 1e-12f);
}

// the max over a group of G threads, in every thread of it
template <int G>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = max_nan(v, __shfl_xor_sync(0xffffffffu, v, off));
  if constexpr (G == kThreads) {
    __shared__ float part[kWarps];
    if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = v;
    __syncthreads();
    v = part[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) v = max_nan(v, part[w]);
  }
  return v;
}

template <typename T, int G, int NC, int MODE, int CAP>
__global__ void __launch_bounds__(kThreads)
ef21_kernel(const __grid_constant__ Params<CAP> p) {
  using C = Chunk<T>;
  constexpr int V = C::V;
  constexpr int CPR = kLanes / V;  // chunks a 128-lane row
  const long long n_groups = p.m * p.spans;
  long long gid = G == 32 ? (long long)blockIdx.x * kWarps + threadIdx.x / 32
                          : (long long)blockIdx.x;
  if (gid >= n_groups) return;  // a whole warp (G = 32); never a block's part
  if (p.reverse) gid = n_groups - 1 - gid;
  const int t = G == 32 ? (int)(threadIdx.x % 32) : (int)threadIdx.x;
  const long long i = gid / p.spans;
  const int j = (int)(gid - i * p.spans);

  // the span's leaf k and its chunks [c0, c1) of the client row; `whole`:
  // the span is its leaf's only one
  int k, c0, c1;
  bool whole;
  if (p.nleaf == 0) {
    k = j;
    c0 = j * CPR;
    c1 = c0 + CPR;
    whole = true;
  } else {
    int lo = 0, hi = p.nleaf - 1;  // the last leaf whose first span is <= j
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (p.span0[mid] <= j) lo = mid;
      else hi = mid - 1;
    }
    k = lo;
    c0 = p.chunk0[k] + (j - p.span0[k]) * (G * NC);
    c1 = min(p.chunk0[k + 1], c0 + G * NC);
    whole = p.span0[k + 1] - p.span0[k] == 1;
  }
  float* cell = p.table + i * p.L + k;

  float tab = 0.0f;
  if constexpr (MODE == kApply) tab = *cell;
  const uint4* u = reinterpret_cast<const uint4*>(static_cast<const T*>(p.u) + i * p.W);
  const uint4* uh = reinterpret_cast<const uint4*>(static_cast<const T*>(p.uh) + i * p.W);
  uint4 ru[NC], rh[NC];
#pragma unroll
  for (int q = 0; q < NC; ++q) {
    const int c = c0 + t + q * G;
    if (c < c1) {
      ru[q] = __ldg(u + c);
      rh[q] = __ldg(uh + c);
    }
  }

  float s;
  if constexpr (MODE == kApply) {
    s = p.given ? tab : leaf_scale(tab, p.lo);
  } else {
    float v = 0.0f;
#pragma unroll
    for (int q = 0; q < NC; ++q) {
      if (c0 + t + q * G < c1) {
        float a[V], h[V];
        C::unpack(ru[q], a);
        C::unpack(rh[q], h);
#pragma unroll
        for (int e = 0; e < V; ++e) v = max_nan(v, fabsf(__fsub_rn(a[e], h[e])));
      }
    }
    v = group_max<G>(v);
    if constexpr (MODE == kMax) {
      if (t == 0) {
        if (whole) *cell = v;
        else atomicMax(reinterpret_cast<unsigned*>(cell), __float_as_uint(v));
      }
      return;
    }
    s = leaf_scale(v, p.lo);
  }

  const float lo = p.lo;
  uint4* out = reinterpret_cast<uint4*>(static_cast<T*>(p.out) + i * p.W);
#pragma unroll
  for (int q = 0; q < NC; ++q) {
    const int c = c0 + t + q * G;
    if (c < c1) {
      float a[V], h[V], r[V];
      C::unpack(ru[q], a);
      C::unpack(rh[q], h);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        float qv = rintf(__fdiv_rn(__fsub_rn(a[e], h[e]), s));
        qv = qv < -lo ? -lo : (qv > lo ? lo : qv);  // a NaN passes, as torch.clamp
        r[e] = __fadd_rn(h[e], __fmul_rn(qv, s));
      }
      out[c] = C::pack(r);
    }
  }
}

template <typename T, int G, int NC, int MODE, int CAP>
cudaError_t launch(const Params<CAP>& p, cudaStream_t stream) {
  const long long n_groups = p.m * p.spans;
  const long long blocks = G == 32 ? (n_groups + kWarps - 1) / kWarps : n_groups;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  ef21_kernel<T, G, NC, MODE, CAP><<<(unsigned)blocks, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int MODE, int CAP>
cudaError_t by_shape(const Params<CAP>& p, int threads, int chunks, cudaStream_t st) {
  if constexpr (MODE == kFused) {
    if (threads == 32) {
      switch (chunks) {
        case 1: return launch<T, 32, 1, MODE, CAP>(p, st);
        case 2: return launch<T, 32, 2, MODE, CAP>(p, st);
        case 4: return launch<T, 32, 4, MODE, CAP>(p, st);
        case 8: return launch<T, 32, 8, MODE, CAP>(p, st);
      }
    } else if (threads == kThreads) {
      switch (chunks) {
        case 1: return launch<T, kThreads, 1, MODE, CAP>(p, st);
        case 2: return launch<T, kThreads, 2, MODE, CAP>(p, st);
        case 4: return launch<T, kThreads, 4, MODE, CAP>(p, st);
        case 8: return launch<T, kThreads, 8, MODE, CAP>(p, st);
      }
    }
  } else {
    if (threads == 32 && chunks == 1) return launch<T, 32, 1, MODE, CAP>(p, st);
    if (threads == kThreads && chunks == kWideChunks)
      return launch<T, kThreads, kWideChunks, MODE, CAP>(p, st);
  }
  return cudaErrorInvalidValue;
}

template <int MODE, int CAP>
cudaError_t by_dtype(const Params<CAP>& p, int dtype, int threads, int chunks,
                     cudaStream_t st) {
  if (dtype == kF32) return by_shape<float, MODE, CAP>(p, threads, chunks, st);
  if (dtype == kBF16) return by_shape<__nv_bfloat16, MODE, CAP>(p, threads, chunks, st);
  return cudaErrorInvalidValue;
}

// Copy the host's leaf table into the parameters, refusing one that does not
// tile the row as the mode's spans need (each leaf its one span for kFused,
// ceil(chunks / span) spans otherwise); zero the table where spans combine.
template <int CAP>
cudaError_t run(Params<CAP>& p, const int* chunk0, const int* span0, int dtype, int mode,
                int threads, int chunks, cudaStream_t st) {
  const int V = dtype == kBF16 ? 8 : 4;
  const int cap = threads * chunks;
  bool atomics = false;
  for (int k = 0; k <= p.nleaf; ++k) {
    p.chunk0[k] = chunk0[k];
    p.span0[k] = span0[k];
    if (k == 0) continue;
    const int len = chunk0[k] - chunk0[k - 1], n = span0[k] - span0[k - 1];
    if (len < 0 || n != (mode == kFused ? 1 : (len + cap - 1) / cap) || len > n * cap)
      return cudaErrorInvalidValue;
    atomics |= n > 1;
  }
  if (p.nleaf > 0 && (chunk0[0] != 0 || span0[0] != 0 || (long long)chunk0[p.nleaf] * V != p.W ||
                      span0[p.nleaf] != p.spans))
    return cudaErrorInvalidValue;
  if (p.nleaf == 0 && kLanes / V > cap) return cudaErrorInvalidValue;
  if (mode == kMax && atomics) {
    const cudaError_t err =
        cudaMemsetAsync(p.table, 0, (size_t)p.m * p.L * sizeof(float), st);
    if (err != cudaSuccess) return err;
  }
  if (mode == kMax) return by_dtype<kMax, CAP>(p, dtype, threads, chunks, st);
  if (mode == kApply) return by_dtype<kApply, CAP>(p, dtype, threads, chunks, st);
  return by_dtype<kFused, CAP>(p, dtype, threads, chunks, st);
}

template <int CAP>
void fill(Params<CAP>& p, const void* u, const void* uh, void* out, void* table, float lo,
          int given, long long m, int W, int L, int spans, int nleaf, int reverse) {
  p.u = u;
  p.uh = uh;
  p.out = out;
  p.table = static_cast<float*>(table);
  p.m = m;
  p.W = W;
  p.L = L;
  p.spans = spans;
  p.nleaf = nleaf;
  p.lo = lo;
  p.given = given;
  p.reverse = reverse;
  p.pad_ = 0;
}

}  // namespace

// The most leaves one launch takes (the parameter limit of the toolkit the
// library was built with).
extern "C" int ef21_max_leaves() { return kMaxLeaves; }

// One pass of the EF21 uplink (mode 0 kMax, 1 kApply, 2 kFused) over the
// (m, W) arena u, uh of `dtype`: groups of `threads` (32 or 256) threads,
// `chunks` 16-byte chunks of each input a thread, `spans` spans a client.
// `nleaf` leaves with their first chunks `chunk0[0..nleaf]` and first spans
// `span0[0..nleaf]` (host arrays), or nleaf = 0: every 128-lane row its own
// segment.  `table` (m, L) f32.  Returns cudaGetLastError() or the refusal.
extern "C" int launch_ef21(const void* u, const void* uh, void* out, void* table, float lo,
                           int given, long long m, int W, int dtype, int mode, int threads,
                           int chunks, const int* chunk0, const int* span0, int nleaf,
                           int spans, int L, int reverse, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (m <= 0 || W <= 0 || W % kLanes || spans <= 0 || L <= 0 ||
      (mode != kFused && table == nullptr) ||
      nleaf < 0 || nleaf > kMaxLeaves || (nleaf > 0 && (chunk0 == nullptr || span0 == nullptr)) ||
      mode < kMax || mode > kFused || (mode != kMax && out == nullptr) ||
      (nleaf == 0 && (spans != W / kLanes || L != spans)) || (nleaf > 0 && L != nleaf) ||
      chunks < 1 || chunks > kMaxChunks)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  static const int none[1] = {0};
  if (nleaf <= kSmallLeaves) {
    Params<kSmallLeaves> p;
    fill(p, u, uh, out, table, lo, given, m, W, L, spans, nleaf, reverse);
    return (int)run(p, nleaf ? chunk0 : none, nleaf ? span0 : none, dtype, mode, threads,
                    chunks, st);
  }
  Params<kMaxLeaves> p;
  fill(p, u, uh, out, table, lo, given, m, W, L, spans, nleaf, reverse);
  return (int)run(p, chunk0, span0, dtype, mode, threads, chunks, st);
}
