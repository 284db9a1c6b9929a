// The paper's eq. (20) client step over a list of segments, one launch:
//     x' = x - step * (g + rho * (x - xs) + lam)          (lam optional)
// and, in the same pass, the running sum of the client iterates that
// GPDMM's x_bar = mean_k x^k needs (acc optional, updated in place).
//
// Replaces two TPU kernels:
//   src/repro/kernels/fused_update.py::fused_update_pallas     (one leaf)
//   src/repro/kernels/round_tail.py::fused_update_arena_pallas (the arena,
//                                                   server row broadcast)
// A segment is one leaf of a step (the server leaf broadcast or full) or
// the whole (m, W) arena.  It is the step of every per-leaf (pytree) round:
// GPDMM/AGPDMM (step = 1/(1/eta + rho)), SCAFFOLD (rho = 0, lam = c - c_i),
// FedAvg (rho = 0, no lam) and Inexact FedSplit (xs = z, rho = 1/gamma); and
// of the softmax arena and the constant-degree graph phases.
//
// What bounds it on an H100: bytes.  Per element it reads x, g, lam and (in
// the `add`/`last` modes) acc, reads the server value once per client (the
// broadcast), and writes x' and acc, for about 7 flops: at lm_flat (8 x 2^20
// f32) 201 MB, 60 us at 3.35 TB/s.  At the paper's sizes (1-5 MB) a launch
// costs more than its bytes, so the design's first aim is launches: one per
// step for a whole tree of one dtype (the TPU kernel, and the port before,
// took one per leaf and step, plus a separate pass x_bar += x' per leaf).
//
// Design.
//  * The host packs the segments into a table passed by value as one
//    __grid_constant__ kernel parameter (no copy to the device, no
//    allocation): each segment's pointers, its element count n, the period
//    of the server broadcast xs_n, its elements per client, and its share
//    of the grid.  A block finds its segment by a binary search over the
//    segments' first blocks, then strides over the segment's 16-byte groups
//    with the segment's blocks: one thread a group up to a cap of 64 blocks
//    an SM, the shares scaled down above it (the host's plan; more blocks
//    balance six segments of unequal size better than one wave striding).
//    Two table sizes: 8 segments (the usual case: on an H100 a launch of
//    the large table costs 0.2 us more on the device and 3-4 us more on
//    the host, chip_ab.py) and as many as the parameter limit allows
//    (32,764 bytes from CUDA 12.1, else 4 KB); the host splits a longer
//    list into as few launches as that allows.
//  * 16-byte vector loads and stores (4 f32 or 8 bf16 values a thread);
//    a segment's last n % V elements run as a scalar tail.  The server
//    index t % xs_n and the client index t / per_client are computed once a
//    group and stepped per element, in 32-bit arithmetic when every segment
//    of the launch has fewer than 2^31 elements.  A server operand that is x
//    itself (rho = 0 callers pass xs = x) is not read again.
//  * The f32 math is common.cuh::eq20 (the _rn intrinsics), bitwise the
//    reference's operation order.  The acc modes give the bits of the plain
//    passes they replace (xsum = 0; xsum = xsum + x' per step; xsum * s):
//      first  acc = 0 + x'            (__fadd_rn, so -0.0 becomes +0.0)
//      add    acc = acc + x'
//      last   acc = (acc + x') * s    (the sum rounded to acc's dtype first;
//                                      s = 1/K rounded to it on the host)
//    with `first` and `last` together when K = 1; x' enters the sum as it
//    is stored (rounded to bf16 for a bf16 leaf).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSmallSegs = 8;
// the most segments whose table (a 32-byte header, 80 bytes a segment)
// fits the kernel parameter limit
#if CUDART_VERSION >= 12010
constexpr size_t kParamLimit = 32764;
#else
constexpr size_t kParamLimit = 4096;
#endif
constexpr int kMaxSegs = (int)((kParamLimit - 32) / 80);
constexpr int kDescWords = 10;  // int64 words a segment in the host's descriptor
enum AccFlags : int { kAccFirst = 1, kAccLast = 2 };

struct Seg {
  const void* x;
  const void* g;
  const void* xs;
  const void* lam;  // may be null
  void* out;
  void* acc;        // may be null: no running sum
  long long n, xs_n, per_client;
  int block0, blocks;
};

template <int CAP>
struct Table {
  const float* step_arr;  // (m,) per-client steps, or null: `step`
  float step, rho, acc_scale;
  int acc_flags, nseg;
  Seg seg[CAP];
};

static_assert(sizeof(Seg) == 80 && sizeof(Table<1>) == 32 + 80, "segment table layout");
static_assert(sizeof(Table<kMaxSegs>) <= kParamLimit, "segment table above the parameter limit");

// 16 bytes of T as floats, and back (bf16 rounded to nearest even)
template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, size_t i, float* v) {
    const float4 a = *reinterpret_cast<const float4*>(p + i);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  }
  __device__ __forceinline__ static void store(float* p, size_t i, const float* v) {
    *reinterpret_cast<float4*>(p + i) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, size_t i, float* v) {
    const uint4 a = *reinterpret_cast<const uint4*>(p + i);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      v[2 * j] = f.x;
      v[2 * j + 1] = f.y;
    }
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p, size_t i, const float* v) {
    uint4 a;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&a);
#pragma unroll
    for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    *reinterpret_cast<uint4*>(p + i) = a;
  }
};

// v as a T would store it, back in f32
__device__ __forceinline__ float stored(float v, const float*) { return v; }
__device__ __forceinline__ float stored(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T, typename Idx, int CAP>
__global__ void __launch_bounds__(kThreads)
eq20_segments_kernel(const __grid_constant__ Table<CAP> tab) {
  constexpr int V = Vec16<T>::N;
  // the block's segment: the last one whose first block is <= blockIdx.x
  const int b = blockIdx.x;
  int lo = 0, hi = tab.nseg - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (tab.seg[mid].block0 <= b) lo = mid; else hi = mid - 1;
  }
  const Seg& s = tab.seg[lo];
  const T* __restrict__ x = static_cast<const T*>(s.x);
  const T* __restrict__ g = static_cast<const T*>(s.g);
  const T* __restrict__ xs = static_cast<const T*>(s.xs);
  const T* __restrict__ lam = static_cast<const T*>(s.lam);
  T* __restrict__ out = static_cast<T*>(s.out);
  T* __restrict__ acc = static_cast<T*>(s.acc);
  const Idx n = (Idx)s.n, xs_n = (Idx)s.xs_n, pc = (Idx)s.per_client;
  const bool has_lam = lam != nullptr, has_acc = acc != nullptr;
  const bool first = tab.acc_flags & kAccFirst, last = tab.acc_flags & kAccLast;
  const bool xs_is_x = s.xs == s.x && xs_n == n;
  const bool xs_vec = xs_n == n || xs_n % V == 0;
  const float* __restrict__ step_arr = tab.step_arr;
  const float rho = tab.rho, scale = tab.acc_scale;

  // one element: x' into o (as stored), the running sum into a
  auto one = [&](float xv, float gv, float sv, float lv, float av, float st, float& o,
                 float& a) {
    o = stored(eq20(xv, gv, sv, lv, has_lam, st, rho), x);
    a = __fadd_rn(first ? 0.0f : av, o);
    if (last) a = __fmul_rn(stored(a, x), scale);
  };

  const Idx groups = (n + V - 1) / V;
  const Idx stride = (Idx)s.blocks * kThreads;
  for (Idx q = (Idx)(b - s.block0) * kThreads + threadIdx.x; q < groups; q += stride) {
    const Idx t0 = q * V;
    // the group's server index and client, stepped per element below
    Idx si = xs_n == n ? t0 : t0 % xs_n;
    Idx c = 0, r = 0;
    if (step_arr != nullptr) {
      c = t0 / pc;
      r = t0 - c * pc;
    }
    // (a lane past the segment's end reads no step: c would pass m - 1)
    float st[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      st[j] = tab.step;
      if (step_arr != nullptr && t0 + j < n) {
        st[j] = step_arr[c];
        if (++r == pc) { r = 0; ++c; }
      }
    }
    if (t0 + V <= n) {
      float xv[V], gv[V], sv[V], lv[V], av[V], ov[V];
      Vec16<T>::load(x, t0, xv);
      Vec16<T>::load(g, t0, gv);
      if (has_lam) {
        Vec16<T>::load(lam, t0, lv);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) lv[j] = 0.0f;
      }
      if (has_acc && !first) {
        Vec16<T>::load(acc, t0, av);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) av[j] = 0.0f;
      }
      if (xs_is_x) {
#pragma unroll
        for (int j = 0; j < V; ++j) sv[j] = xv[j];
      } else if (xs_vec) {
        Vec16<T>::load(xs, si, sv);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          sv[j] = load_f32(xs, si);
          if (++si == xs_n) si = 0;
        }
      }
#pragma unroll
      for (int j = 0; j < V; ++j) {
        one(xv[j], gv[j], sv[j], lv[j], av[j], st[j], ov[j], av[j]);
      }
      Vec16<T>::store(out, t0, ov);
      if (has_acc) Vec16<T>::store(acc, t0, av);
    } else {
      // the segment's ragged tail: n - t0 < V elements, scalar
      for (int j = 0; t0 + j < n; ++j) {
        const Idx t = t0 + j;
        float o, a;
        one(load_f32(x, t), load_f32(g, t), xs_is_x ? load_f32(x, t) : load_f32(xs, si),
            has_lam ? load_f32(lam, t) : 0.0f,
            has_acc && !first ? load_f32(acc, t) : 0.0f, st[j], o, a);
        store_f32(out, t, o);
        if (has_acc) store_f32(acc, t, a);
        if (++si == xs_n) si = 0;
      }
    }
  }
}

template <typename T, typename Idx, int CAP>
cudaError_t launch_table(const long long* desc, int nseg, const float* step_arr, float step,
                         float rho, float acc_scale, int acc_flags, cudaStream_t stream) {
  Table<CAP> tab;
  tab.step_arr = step_arr;
  tab.step = step;
  tab.rho = rho;
  tab.acc_scale = acc_scale;
  tab.acc_flags = acc_flags;
  tab.nseg = nseg;
  int blocks = 0;
  for (int i = 0; i < nseg; ++i) {
    const long long* d = desc + (size_t)kDescWords * i;
    Seg& s = tab.seg[i];
    s.x = (const void*)d[0];
    s.g = (const void*)d[1];
    s.xs = (const void*)d[2];
    s.lam = (const void*)d[3];
    s.out = (void*)d[4];
    s.acc = (void*)d[5];
    s.n = d[6];
    s.xs_n = d[7];
    s.per_client = d[8];
    s.block0 = blocks;
    s.blocks = (int)d[9];
    blocks += s.blocks;
  }
  eq20_segments_kernel<T, Idx, CAP><<<blocks, kThreads, 0, stream>>>(tab);
  return cudaGetLastError();
}

template <typename T, typename Idx>
cudaError_t launch_typed(const long long* desc, int nseg, const float* step_arr, float step,
                         float rho, float acc_scale, int acc_flags, cudaStream_t stream) {
  if (nseg <= kSmallSegs)
    return launch_table<T, Idx, kSmallSegs>(desc, nseg, step_arr, step, rho, acc_scale,
                                            acc_flags, stream);
  return launch_table<T, Idx, kMaxSegs>(desc, nseg, step_arr, step, rho, acc_scale, acc_flags,
                                        stream);
}

template <typename T>
cudaError_t launch_dtype(const long long* desc, int nseg, bool small, const float* step_arr,
                         float step, float rho, float acc_scale, int acc_flags,
                         cudaStream_t stream) {
  if (small)
    return launch_typed<T, uint32_t>(desc, nseg, step_arr, step, rho, acc_scale, acc_flags,
                                     stream);
  return launch_typed<T, size_t>(desc, nseg, step_arr, step, rho, acc_scale, acc_flags,
                                 stream);
}

}  // namespace

// The most segments one launch takes (the host splits a longer list).
extern "C" int eq20_max_segments() { return kMaxSegs; }

// desc: nseg rows of kDescWords int64 -- x, g, xs, lam (0: none), out,
// acc (0: none), n, xs_n, per_client, blocks.  Every pointer 16-byte
// aligned; n a multiple of xs_n and of per_client; all of dtype `dtype`.
extern "C" int launch_eq20_segments(const void* desc, int nseg, const void* step_arr,
                                    float step, float rho, float acc_scale, int acc_flags,
                                    int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nseg < 1 || nseg > kMaxSegs || (acc_flags & ~(kAccFirst | kAccLast)) != 0)
    return (int)cudaErrorInvalidValue;
  const long long* d = static_cast<const long long*>(desc);
  bool small = true;
  for (int i = 0; i < nseg; ++i) {
    const long long* r = d + (size_t)kDescWords * i;
    const long long n = r[6], xs_n = r[7], pc = r[8], blocks = r[9];
    if (n <= 0 || xs_n <= 0 || pc <= 0 || n % xs_n != 0 || n % pc != 0 || blocks < 1 ||
        blocks > (1LL << 20))
      return (int)cudaErrorInvalidValue;
    small = small && n < (1LL << 31);
  }
  const float* sa = static_cast<const float*>(step_arr);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    err = launch_dtype<float>(d, nseg, small, sa, step, rho, acc_scale, acc_flags, st);
  } else if (dtype == kBF16) {
    err = launch_dtype<__nv_bfloat16>(d, nseg, small, sa, step, rho, acc_scale, acc_flags, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}
