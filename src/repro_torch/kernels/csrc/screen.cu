// Kernel 11: uplink screening.  It replaces, in src/repro/kernels/screen.py,
//
//   screen_uplink_pallas   per client row i of the (m, W) uplink u:
//                          finite_i = every entry of u_i is finite
//                          sq_i     = sum over the finite entries of
//                                     (u_i - ref)^2, f32
//
// with ref the (W,) server row or an (m, W) per-row reference.  Inputs are
// f32 or bf16, the arithmetic f32.  A width that is not a multiple of 128
// screens like its zero-padded width: padding adds 0 to sq and is finite, so
// the kernel simply stops at W.
//
// Two entry points share the per-row pass:
//
//   launch_screen_uplink  (finite, sq): the pass, then with more than one
//                         chunk a row a second launch that adds the chunks
//   launch_screen_keep    the round's keep mask, the rule of
//                         core/faults.py::_keep_from in the same launch:
//                         keep_i = finite_i and sq_i <= mult max(med, 1e-12)
//                         with med jnp.nanmedian of sq over the finite rows
//                         (mult = 0: keep = finite, no median)
//
// What bounds it on an H100: bytes.  Three flops per element against 4-8
// bytes of u (plus ref), so the least time is the uplink (and a per-row ref)
// read once at 3.35 TB/s.  The TPU kernel keeps per-lane accumulators
// resident across a sequential grid over the row's width blocks; here blocks
// run in parallel and in no order, so the design is a reduction in
// fixed-order steps:
//
//   1. block b covers one contiguous chunk of one row (the wrapper sizes
//      chunks so that about eight blocks per SM are in flight: at (500, 512)
//      one block per row, at (8, 2^20) 128 blocks per row).  Each thread
//      walks its chunk with 16-byte loads (4 f32 or 8 bf16; scalar loads when
//      W is not a multiple of them), keeps an f32 sum and a finite flag, and
//      the block reduces them by warp shuffles and then over its warps in
//      warp order;
//   2. with more than one chunk per row, one warp per row sums the row's
//      chunk partials, lane by lane in chunk order and then by shuffles
//      (screen_uplink: a second launch; screen_keep: the block that ends
//      last, picked by an integer ticket, in the same order).
//
// No float atomics: the order of every sum is fixed by the shapes, so a
// result is the same from run to run.  It is not torch.sum's order, so sq
// agrees with the plain version to a rounding tolerance and finite exactly;
// screen_keep's sq is bitwise screen_uplink's.
//
// The median (screen_keep).  sq is >= 0, +Inf or NaN, so the values that
// are not NaN order as their uint32 bits.  jnp.nanmedian interpolates
// between the order statistics lo and hi of the rows' values (q = 0.5
// (count - 1), lo = floor q, hi = ceil q): both are found by a radix select
// over the bits, four passes of 8-bit digits, each an integer histogram
// (integer atomics: counts, so the result does not depend on their order)
// and a block scan that finds the digit holding the wanted rank.  Up to
// kSelectRows rows (32 KiB of keys) the block that ends the per-row pass
// last holds every key in shared memory and selects there: one launch
// (without the rule that block writes keep = finite, at any m).  With the
// rule above kSelectRows rows (a masked screened round over a population
// of 10^5-10^6) the first launch is screen_uplink's per-row pass, and a
// second launch, cooperative so that all its blocks are resident, builds
// each pass's histogram across the card into a zeroed workspace, meets at a
// grid barrier between passes, and writes the mask; the block that leaves
// last zeroes the workspace again.  The interpolation and the bound are the
// plain version's f32 operations in its order, so the mask is bitwise
// _keep_from's given the same sq.
#include "common.cuh"

#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr long long kSelectRows = 8192;  // keys in the last block's shared memory
constexpr int kSelThreads = 512;         // the cooperative select's blocks
constexpr unsigned kInvalid = 0xffffffffu;  // not a key: a non-finite row or a NaN sq
constexpr int kBins = 256;
// the workspace (a zeroed int32 buffer of kWsInts): [0] the ticket or the
// grid barrier, [1] the select's exit ticket, [kHist, kHist + 4 * 2 * kBins)
// its histograms, pass by pass and rank by rank
constexpr int kHist = 64;
constexpr int kWsInts = kHist + 4 * 2 * kBins;

template <typename T>
struct Vec {
  static constexpr int N = 16 / sizeof(T);
};

// N consecutive values from 16-byte aligned p + i, as f32
__device__ __forceinline__ void load_vec(const float* p, size_t i, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p + i);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, size_t i, float* v) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p + i);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}

__device__ __forceinline__ void screen_one(float u, float r, float& sq, int& fin) {
  if (isfinite(u)) {
    const float d = __fsub_rn(u, r);
    sq = __fadd_rn(sq, __fmul_rn(d, d));
  } else {
    fin = 0;
  }
}

// The per-row pass of block b = row * chunks + c over [start, end) of its
// row: (sq, finite) of the chunk, valid in thread 0.
template <typename T, bool kVec>
__device__ __forceinline__ void chunk_pass(const T* __restrict__ u, const T* __restrict__ ref,
                                           int ref_per_row, long long W, long long row,
                                           long long start, long long end, float& sq_out,
                                           int& fin_out) {
  __shared__ float s_sq[kWarps];
  __shared__ int s_fin[kWarps];
  const T* ur = u + (size_t)row * W;
  const T* rr = ref + (ref_per_row ? (size_t)row * W : 0);
  float sq = 0.0f;
  int fin = 1;
  if (kVec) {
    constexpr int N = Vec<T>::N;
    float uv[N], rv[N];
    for (long long j = start + (long long)threadIdx.x * N; j < end; j += (long long)kThreads * N) {
      load_vec(ur, j, uv);
      load_vec(rr, j, rv);
#pragma unroll
      for (int k = 0; k < N; ++k) screen_one(uv[k], rv[k], sq, fin);
    }
  } else {
    for (long long j = start + threadIdx.x; j < end; j += kThreads) {
      screen_one(load_f32(ur, j), load_f32(rr, j), sq, fin);
    }
  }
  for (int off = 16; off > 0; off >>= 1) sq = __fadd_rn(sq, __shfl_xor_sync(0xffffffffu, sq, off));
  fin = __all_sync(0xffffffffu, fin);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    s_sq[warp] = sq;
    s_fin[warp] = fin;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = s_sq[0];
    int f = s_fin[0];
#pragma unroll
    for (int k = 1; k < kWarps; ++k) {
      t = __fadd_rn(t, s_sq[k]);
      f &= s_fin[k];
    }
    sq_out = t;
    fin_out = f;
  }
}

// A row's chunk partials in chunk order, by one warp: lane by lane over the
// chunks, then shuffles; valid in every lane.  kL2 reads them through L2
// (written by other blocks of the same launch).
template <bool kL2>
__device__ __forceinline__ void chunk_sum(const float* sq_part, const int* fin_part,
                                          long long row, long long chunks, float& sq_out,
                                          int& fin_out) {
  const int lane = threadIdx.x % 32;
  float sq = 0.0f;
  int fin = 1;
  for (long long c = lane; c < chunks; c += 32) {
    const size_t i = (size_t)(row * chunks + c);
    sq = __fadd_rn(sq, kL2 ? __ldcg(sq_part + i) : sq_part[i]);
    fin &= kL2 ? __ldcg(fin_part + i) : fin_part[i];
  }
  for (int off = 16; off > 0; off >>= 1) sq = __fadd_rn(sq, __shfl_xor_sync(0xffffffffu, sq, off));
  sq_out = sq;
  fin_out = __all_sync(0xffffffffu, fin);
}

// one block per (row, chunk): b = row * chunks + c
template <typename T, bool kVec, bool kFinal>
__global__ void __launch_bounds__(kThreads)
screen_kernel(const T* __restrict__ u, const T* __restrict__ ref, int ref_per_row,
              long long W, long long chunks, long long chunk, float* __restrict__ sq_out,
              int* __restrict__ fin_part, uint8_t* __restrict__ fin_out) {
  const long long b = blockIdx.x;
  const long long row = b / chunks;
  const long long start = (b % chunks) * chunk;
  float t;
  int f;
  chunk_pass<T, kVec>(u, ref, ref_per_row, W, row, start, min(W, start + chunk), t, f);
  if (threadIdx.x == 0) {
    if (kFinal) {
      sq_out[row] = t;
      fin_out[row] = (uint8_t)(f != 0);
    } else {
      sq_out[b] = t;
      fin_part[b] = f;
    }
  }
}

// one warp per row: the row's chunk partials in chunk order
__global__ void __launch_bounds__(kThreads)
screen_finish_kernel(const float* __restrict__ sq_part, const int* __restrict__ fin_part,
                     long long m, long long chunks, float* __restrict__ sq_out,
                     uint8_t* __restrict__ fin_out) {
  const long long row = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= m) return;  // the whole warp leaves together
  float sq;
  int fin;
  chunk_sum<false>(sq_part, fin_part, row, chunks, sq, fin);
  if (threadIdx.x % 32 == 0) {
    sq_out[row] = sq;
    fin_out[row] = (uint8_t)(fin != 0);
  }
}

template <typename T>
void screen_typed(const void* u, const void* ref, int ref_per_row, long long m, long long W,
                  long long chunks, long long chunk, void* sq_part, void* fin_part,
                  void* sq_out, void* fin_out, cudaStream_t stream) {
  const unsigned blocks = (unsigned)(m * chunks);
  const bool vec = W % Vec<T>::N == 0 && chunk % Vec<T>::N == 0;
  const T* up = (const T*)u;
  const T* rp = (const T*)ref;
  if (chunks == 1) {
    if (vec) {
      screen_kernel<T, true, true><<<blocks, kThreads, 0, stream>>>(
          up, rp, ref_per_row, W, 1, chunk, (float*)sq_out, nullptr, (uint8_t*)fin_out);
    } else {
      screen_kernel<T, false, true><<<blocks, kThreads, 0, stream>>>(
          up, rp, ref_per_row, W, 1, chunk, (float*)sq_out, nullptr, (uint8_t*)fin_out);
    }
    return;
  }
  if (vec) {
    screen_kernel<T, true, false><<<blocks, kThreads, 0, stream>>>(
        up, rp, ref_per_row, W, chunks, chunk, (float*)sq_part, (int*)fin_part, nullptr);
  } else {
    screen_kernel<T, false, false><<<blocks, kThreads, 0, stream>>>(
        up, rp, ref_per_row, W, chunks, chunk, (float*)sq_part, (int*)fin_part, nullptr);
  }
  screen_finish_kernel<<<(unsigned)((m + kWarps - 1) / kWarps), kThreads, 0, stream>>>(
      (const float*)sq_part, (const int*)fin_part, m, chunks, (float*)sq_out,
      (uint8_t*)fin_out);
}

// ---------------------------------------------------------------------------
// screen_keep: the median's radix select and the mask
// ---------------------------------------------------------------------------

// a row's key: sq's bits where the row is finite and sq is not NaN
__device__ __forceinline__ unsigned key_of(float sq, int fin) {
  return (fin && !isnan(sq)) ? __float_as_uint(sq) : kInvalid;
}

// The radix select's state, in shared memory: for the ranks lo (r = 0) and
// hi (r = 1), the bits decided so far and the rank still wanted among the
// keys that share them; the count of keys.
struct Select {
  unsigned prefix[2];
  unsigned k[2];
  unsigned count;
};

// Add the keys of [i0, n) in steps of ``stride`` to the histograms h of
// pass ``p`` (digit (key >> 8 (3 - p)) & 255): pass 0 one histogram of
// every key, later passes one a rank, of the keys that share its prefix.
template <class KeyAt>
__device__ __forceinline__ void hist_pass(KeyAt key_at, long long n, long long i0,
                                          long long stride, int p, const Select& s,
                                          unsigned (*h)[kBins]) {
  const int shift = 8 * (3 - p);
  for (long long i = i0; i < n; i += stride) {
    const unsigned key = key_at(i);
    if (key == kInvalid) continue;
    const unsigned d = (key >> shift) & (kBins - 1);
    if (p == 0) {
      atomicAdd(&h[0][d], 1u);
    } else {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if ((key >> (shift + 8)) == (s.prefix[r] >> (shift + 8))) atomicAdd(&h[r][d], 1u);
      }
    }
  }
}

// Threads 0..255: in histogram hr, the digit whose bin holds rank s.k[r];
// set it into s.prefix[r] at pass p's shift and take the bins below it off
// s.k[r].  The caller syncs before (hr complete) and after.
__device__ __forceinline__ void pick(const unsigned* hr, int r, int p, Select& s,
                                     unsigned* warp_tot) {
  const int t = threadIdx.x;
  const int lane = t % 32, warp = t / 32;
  const unsigned k = s.k[r];  // read before the sync: the picking thread rewrites it
  unsigned v = 0, incl = 0;
  if (t < kBins) {
    v = hr[t];
    incl = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned x = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += x;
    }
    if (lane == 31) warp_tot[warp] = incl;
  }
  __syncthreads();
  if (t < kBins) {
    unsigned before = incl - v;
    for (int w = 0; w < warp; ++w) before += warp_tot[w];
    if (v > 0 && before <= k && k < before + v) {
      s.prefix[r] |= (unsigned)t << (8 * (3 - p));
      s.k[r] = k - before;
    }
  }
}

// Threads 0..255: the count of keys (the total of pass 0's histogram h0)
// and the ranks lo and hi of jnp.nanmedian's interpolation, as
// faults.nanmedian computes them in f32.
__device__ __forceinline__ void set_ranks(const unsigned* h0, Select& s, unsigned* warp_tot) {
  const int t = threadIdx.x;
  unsigned v = t < kBins ? h0[t] : 0;
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if (t < kBins && t % 32 == 0) warp_tot[t / 32] = v;
  __syncthreads();
  if (t == 0) {
    unsigned count = 0;
    for (int w = 0; w < kBins / 32; ++w) count += warp_tot[w];
    s.count = count;
    s.prefix[0] = s.prefix[1] = 0u;
    if (count > 0) {
      const float cf = (float)count;
      const float q = __fmul_rn(0.5f, __fsub_rn(cf, 1.0f));
      const float top = __fsub_rn(cf, 1.0f);
      s.k[0] = (unsigned)fmaxf(fminf(floorf(q), top), 0.0f);
      s.k[1] = (unsigned)fmaxf(fminf(ceilf(q), top), 0.0f);
    }
  }
  __syncthreads();
}

// The bound of the outlier rule from the two order statistics:
// mult * clamp(med, min=1e-12) with med = x_lo lw + x_hi hw in f32, NaN
// when no key (clamp lets NaN through, and sq <= NaN is false).
__device__ __forceinline__ float keep_bound(const Select& s, float mult, float* med_out) {
  float med = __int_as_float(0x7fc00000);
  if (s.count > 0) {
    const float cf = (float)s.count;
    const float q = __fmul_rn(0.5f, __fsub_rn(cf, 1.0f));
    const float hw = __fsub_rn(q, floorf(q));
    const float lw = __fsub_rn(1.0f, hw);
    med = __fadd_rn(__fmul_rn(__uint_as_float(s.prefix[0]), lw),
                    __fmul_rn(__uint_as_float(s.prefix[1]), hw));
  }
  if (med_out != nullptr) *med_out = med;
  const float lo = 1e-12f;
  return __fmul_rn(mult, isnan(med) ? med : (med < lo ? lo : med));
}

struct KeepArgs {
  const void* u;
  const void* ref;
  int ref_per_row;
  long long m, W, chunks, chunk;
  float mult;
  int rule;            // the outlier rule is on (screen_mult > 0)
  float* sq_part;      // m * chunks f32 when chunks > 1
  int* fin_part;       // m * chunks int32 when chunks > 1
  float* sq;           // (m,) f32
  uint8_t* fin;        // (m,) bool
  uint8_t* keep;       // (m,) bool
  float* med;          // () f32, optional: the median (with the rule)
  unsigned* ws;        // kWsInts int32, zero between launches
};

// Every block writes its row's or its chunk's pass and takes a ticket; the
// block that takes the last one finishes the rows and writes the mask
// (keep = finite without the rule; with it, the median selected from the
// keys in shared memory, m <= kSelectRows).
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
screen_keep_kernel(const KeepArgs a) {
  extern __shared__ unsigned keys[];  // m keys with the rule
  __shared__ unsigned h[2][kBins];
  __shared__ unsigned warp_tot[kWarps];
  __shared__ Select s;
  __shared__ bool last;
  const long long b = blockIdx.x;
  const long long row = b / a.chunks;
  const long long start = (b % a.chunks) * a.chunk;
  float t;
  int f;
  chunk_pass<T, kVec>(static_cast<const T*>(a.u), static_cast<const T*>(a.ref), a.ref_per_row,
                      a.W, row, start, min(a.W, start + a.chunk), t, f);
  if (threadIdx.x == 0) {
    if (a.chunks == 1) {
      a.sq[row] = t;
      a.fin[row] = (uint8_t)(f != 0);
    } else {
      a.sq_part[b] = t;
      a.fin_part[b] = f;
    }
    __threadfence();
    last = atomicAdd(&a.ws[0], 1u) == (unsigned)(a.m * a.chunks - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();

  // the last block: each row's sq and finite, and its key
  const bool select = a.rule != 0;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (a.chunks > 1) {
    for (long long r = warp; r < a.m; r += kWarps) {
      float sq;
      int fin;
      chunk_sum<true>(a.sq_part, a.fin_part, r, a.chunks, sq, fin);
      if (lane == 0) {
        a.sq[r] = sq;
        a.fin[r] = (uint8_t)(fin != 0);
        if (select) keys[r] = key_of(sq, fin);
        else a.keep[r] = (uint8_t)(fin != 0);
      }
    }
  } else {
    for (long long r = threadIdx.x; r < a.m; r += kThreads) {
      const int fin = __ldcg(a.fin + r);
      if (select) keys[r] = key_of(__ldcg(a.sq + r), fin);
      else a.keep[r] = (uint8_t)(fin != 0);
    }
  }
  if (threadIdx.x == 0) a.ws[0] = 0u;  // the ticket, for the next launch
  if (!select) return;
  __syncthreads();

  // four passes of the radix select over the keys in shared memory
  auto key_at = [&](long long i) { return keys[i]; };
  for (int p = 0; p < 4; ++p) {
    for (int i = threadIdx.x; i < 2 * kBins; i += kThreads) (&h[0][0])[i] = 0u;
    __syncthreads();
    hist_pass(key_at, a.m, threadIdx.x, kThreads, p, s, h);
    __syncthreads();
    if (p == 0) {
      set_ranks(h[0], s, warp_tot);
      if (s.count == 0) break;
      pick(h[0], 0, 0, s, warp_tot);
      __syncthreads();
      pick(h[0], 1, 0, s, warp_tot);
    } else {
      pick(h[0], 0, p, s, warp_tot);
      __syncthreads();
      pick(h[1], 1, p, s, warp_tot);
    }
    __syncthreads();
  }
  const float bound = keep_bound(s, a.mult, nullptr);
  if (threadIdx.x == 0 && a.med != nullptr) keep_bound(s, a.mult, a.med);
  for (long long r = threadIdx.x; r < a.m; r += kThreads) {
    const unsigned key = keys[r];
    a.keep[r] = (uint8_t)(key != kInvalid && __uint_as_float(key) <= bound);
  }
}

// Above kSelectRows rows: the select across the card, one launch with every
// block resident (cooperative).  Blocks meet at a barrier on ws[0] between
// the passes; each adds its block's histograms into the pass's own in ws,
// then every block reads the totals and picks the same digits.
__device__ __forceinline__ void grid_barrier(unsigned* bar, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(bar, 1u);
    while (*reinterpret_cast<volatile unsigned*>(bar) < target) __nanosleep(64);
    __threadfence();
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kSelThreads)
screen_select_kernel(const KeepArgs a) {
  __shared__ unsigned h[2][kBins];
  __shared__ unsigned tot[2][kBins];
  __shared__ unsigned warp_tot[kSelThreads / 32];
  __shared__ Select s;
  __shared__ bool last;
  unsigned* hist = a.ws + kHist;
  const unsigned G = gridDim.x;
  const long long i0 = (long long)blockIdx.x * kSelThreads + threadIdx.x;
  const long long stride = (long long)G * kSelThreads;
  auto key_at = [&](long long i) { return key_of(__ldcg(a.sq + i), __ldcg(a.fin + i)); };
  for (int p = 0; p < 4; ++p) {
    for (int i = threadIdx.x; i < 2 * kBins; i += kSelThreads) (&h[0][0])[i] = 0u;
    __syncthreads();
    hist_pass(key_at, a.m, i0, stride, p, s, h);
    __syncthreads();
    unsigned* hp = hist + p * 2 * kBins;
    for (int i = threadIdx.x; i < 2 * kBins; i += kSelThreads) {
      const unsigned v = (&h[0][0])[i];
      if (v) atomicAdd(hp + i, v);
    }
    grid_barrier(a.ws, (unsigned)(p + 1) * G);
    for (int i = threadIdx.x; i < 2 * kBins; i += kSelThreads) (&tot[0][0])[i] = __ldcg(hp + i);
    __syncthreads();
    if (p == 0) {
      set_ranks(tot[0], s, warp_tot);
      if (s.count == 0) break;
      pick(tot[0], 0, 0, s, warp_tot);
      __syncthreads();
      pick(tot[0], 1, 0, s, warp_tot);
    } else {
      pick(tot[0], 0, p, s, warp_tot);
      __syncthreads();
      pick(tot[1], 1, p, s, warp_tot);
    }
    __syncthreads();
  }
  const float bound = keep_bound(s, a.mult, nullptr);
  if (blockIdx.x == 0 && threadIdx.x == 0 && a.med != nullptr) keep_bound(s, a.mult, a.med);
  for (long long r = i0; r < a.m; r += stride) {
    a.keep[r] = (uint8_t)(key_at(r) != kInvalid && __ldcg(a.sq + r) <= bound);
  }
  // the block that leaves last zeroes the workspace for the next launch
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(&a.ws[1], 1u) == G - 1;
  }
  __syncthreads();
  if (!last) return;
  for (int i = threadIdx.x; i < kWsInts; i += kSelThreads) a.ws[i] = 0u;
}

// Stage 0 of the keep mask: with the rule over more than kSelectRows rows
// the per-row pass alone (screen_uplink's launches, the select follows),
// else the one launch that ends in the mask.
template <typename T>
cudaError_t keep_typed(const KeepArgs& a, cudaStream_t stream) {
  if (a.rule && a.m > kSelectRows) {
    screen_typed<T>(a.u, a.ref, a.ref_per_row, a.m, a.W, a.chunks, a.chunk, a.sq_part,
                    a.fin_part, a.sq, a.fin, stream);
    return cudaGetLastError();
  }
  const unsigned blocks = (unsigned)(a.m * a.chunks);
  const bool vec = a.W % Vec<T>::N == 0 && a.chunk % Vec<T>::N == 0;
  const size_t smem = a.rule ? (size_t)a.m * sizeof(unsigned) : 0;
  if (vec) screen_keep_kernel<T, true><<<blocks, kThreads, smem, stream>>>(a);
  else screen_keep_kernel<T, false><<<blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// chunks * chunk >= W; with chunks > 1, sq_part and fin_part hold m * chunks
// f32 and int32 values of scratch.  fin_out is m bytes (torch.bool).
extern "C" int launch_screen_uplink(const void* u, const void* ref, int ref_per_row,
                                    long long m, long long W, int dtype, long long chunks,
                                    long long chunk, void* sq_part, void* fin_part,
                                    void* sq_out, void* fin_out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (chunks < 1 || chunk < 1 || chunks * chunk < W) return (int)cudaErrorInvalidValue;
  if (m == 0) return (int)cudaGetLastError();
  if (dtype == kF32) {
    screen_typed<float>(u, ref, ref_per_row, m, W, chunks, chunk, sq_part, fin_part, sq_out,
                        fin_out, (cudaStream_t)stream);
  } else if (dtype == kBF16) {
    screen_typed<__nv_bfloat16>(u, ref, ref_per_row, m, W, chunks, chunk, sq_part, fin_part,
                                sq_out, fin_out, (cudaStream_t)stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The keep mask in the stage ``stage`` of its launches: stage 0 the mask in
// one launch, or with the rule over more than kSelectRows rows the per-row
// pass alone; stage 1 (those rows only) the cooperative select over the sq
// and finite that stage 0 wrote, and the mask.  ``rule`` turns the outlier
// rule on (screen_mult > 0; ``mult`` is it in f32).  ``ws`` is kWsInts
// zeroed int32 values, zero again when the launch ends; ``med_out``
// (optional, for checks) one f32, the median.
extern "C" int launch_screen_keep(const void* u, const void* ref, int ref_per_row, long long m,
                                  long long W, int dtype, long long chunks, long long chunk,
                                  float mult, int rule, void* sq_part, void* fin_part, void* sq_out,
                                  void* fin_out, void* keep_out, void* med_out, void* ws,
                                  int stage, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (chunks < 1 || chunk < 1 || chunks * chunk < W || ws == nullptr || sq_out == nullptr ||
      fin_out == nullptr || keep_out == nullptr ||
      (chunks > 1 && (sq_part == nullptr || fin_part == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (m == 0) return (int)cudaGetLastError();
  KeepArgs a{};
  a.u = u;
  a.ref = ref;
  a.ref_per_row = ref_per_row;
  a.m = m;
  a.W = W;
  a.chunks = chunks;
  a.chunk = chunk;
  a.mult = mult;
  a.rule = rule;
  a.sq_part = static_cast<float*>(sq_part);
  a.fin_part = static_cast<int*>(fin_part);
  a.sq = static_cast<float*>(sq_out);
  a.fin = static_cast<uint8_t*>(fin_out);
  a.keep = static_cast<uint8_t*>(keep_out);
  a.med = static_cast<float*>(med_out);
  a.ws = static_cast<unsigned*>(ws);
  const cudaStream_t st = (cudaStream_t)stream;
  if (stage == 1) {
    if (!rule || m <= kSelectRows) return (int)cudaErrorInvalidValue;
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, screen_select_kernel,
                                                        kSelThreads, 0);
    if (err != cudaSuccess) return (int)err;
    long long blocks = (m + kSelThreads - 1) / kSelThreads;
    const long long resident = (long long)sms * (per_sm < 1 ? 1 : per_sm);
    if (blocks > resident) blocks = resident;
    void* args[] = {&a};
    return (int)cudaLaunchCooperativeKernel((const void*)screen_select_kernel,
                                            dim3((unsigned)blocks), dim3(kSelThreads), args, 0,
                                            st);
  }
  if (stage != 0) return (int)cudaErrorInvalidValue;
  if (dtype == kF32) return (int)keep_typed<float>(a, st);
  if (dtype == kBF16) return (int)keep_typed<__nv_bfloat16>(a, st);
  return (int)cudaErrorInvalidValue;
}
