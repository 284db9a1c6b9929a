// Kernel 16b: the backward of kernel 16 (causal GQA attention, optionally
// over a sliding window).  The reference has no backward kernel: its
// launcher differentiates the "xla" branch (src/repro/kernels/ops.py
// _flash_xla).  Given q (B, Sq, H, hd), k and v (B, Sk, Hkv, hd), the
// forward's output o (B, Sq, H, hd) and its per-row logsumexp lse (B, H,
// Sq) f32, and the incoming gradient do (B, Sq, H, hd), it returns
//
//   P   = exp(q k^T scale - lse)          (0 where a key is not visible)
//   D_i = sum_d do_id o_id
//   dv  = P^T do,   dS = P (do v^T - D),   dq = dS k scale,   dk = dS^T q scale
//
// with dk and dv summed over the H / Hkv query heads of each kv head.
// The scores are recomputed block by block from q, k and lse; nothing of
// size Sq x Sk is stored.
//
// Two grids a call, on the caller's stream, and no float atomics, so that
// every sum runs in a fixed order and a run repeats bitwise:
//
//   1. dq: one block per (tile of 64 query rows, b * H + h).  It forms D for
//      its rows (and writes it to scratch), then walks the key tiles its
//      rows can see, accumulating dq in shared memory.
//   2. dk, dv: one block per (tile of 32 keys, b * Hkv + hk).  It walks the
//      query heads of its group and, for each, the query tiles that can see
//      its keys, accumulating dk and dv in shared memory.
//
// Products: bf16 operands with hd a multiple of 16 run on the tensor cores
// (WMMA m16n16k16, bf16 in, f32 accumulators in shared memory; P and dS are
// rounded to bf16 before their products, as the forward rounds p before
// p v); f32 operands, and bf16 with another hd, run as f32 products on the
// CUDA cores.  Elementwise work (the masks, exp, dS) is f32.
//
// What bounds it on an H100: operations.  Per (query, visible key) pair and
// head, 4 products of length hd (S, dP, dq and the dk/dv pair share one
// recomputed S in each grid: 2 in the dq grid, 3 in the dk/dv grid), so
// about 2.5x the forward's work.
#include "common.cuh"

#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBR = 64;   // query rows per tile
constexpr int kBC = 32;   // keys per tile
constexpr int kMaxD = 128;

// Shared-memory element type of the products' operands: bf16 on the tensor
// cores, f32 on the CUDA cores.
template <bool TC> struct Op { typedef float type; };
template <> struct Op<true> { typedef __nv_bfloat16 type; };

__device__ __forceinline__ void from_f(float& d, float x) { d = x; }
__device__ __forceinline__ void from_f(__nv_bfloat16& d, float x) { d = __float2bfloat16_rn(x); }

// C (M x N, row-major, ldc) = / += A (M x K) B (K x N) on the CUDA cores,
// f32.  A(m, k) is A[m * lda + k], or A[k * lda + m] when A_COL; B(k, n) is
// B[k * ldb + n], or B[n * ldb + k] when B_COL.  Each output is one thread's
// sum over k in order.
template <bool ACC, bool A_COL, bool B_COL>
__device__ void mm_cc(float* C, int ldc, const float* A, int lda, const float* B, int ldb, int M,
                      int N, int K) {
  for (int e = threadIdx.x; e < M * N; e += kThreads) {
    const int m = e / N, n = e % N;
    float s = 0.0f;
    for (int k = 0; k < K; ++k) {
      const float a = A_COL ? A[k * lda + m] : A[m * lda + k];
      const float b = B_COL ? B[n * ldb + k] : B[k * ldb + n];
      s = fmaf(a, b, s);
    }
    C[m * ldc + n] = ACC ? C[m * ldc + n] + s : s;
  }
}

// The same on the tensor cores: each warp takes 16 x 16 output tiles in
// turn, M, N and K multiples of 16, bf16 operands, f32 C in shared memory.
template <bool ACC, bool A_COL, bool B_COL>
__device__ void mm_tc(float* C, int ldc, const __nv_bfloat16* A, int lda, const __nv_bfloat16* B,
                      int ldb, int M, int N, int K) {
  using namespace nvcuda;
  typedef typename std::conditional<A_COL, wmma::col_major, wmma::row_major>::type LA;
  typedef typename std::conditional<B_COL, wmma::col_major, wmma::row_major>::type LB;
  const int warp = threadIdx.x >> 5;
  const int tn = N / 16, tiles = (M / 16) * tn;
  for (int t = warp; t < tiles; t += kWarps) {
    const int m0 = (t / tn) * 16, n0 = (t % tn) * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
    if (ACC) wmma::load_matrix_sync(c, C + m0 * ldc + n0, ldc, wmma::mem_row_major);
    else wmma::fill_fragment(c, 0.0f);
    for (int k0 = 0; k0 < K; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, LA> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, LB> b;
      wmma::load_matrix_sync(a, A_COL ? A + k0 * lda + m0 : A + m0 * lda + k0, lda);
      wmma::load_matrix_sync(b, B_COL ? B + n0 * ldb + k0 : B + k0 * ldb + n0, ldb);
      wmma::mma_sync(c, a, b, c);
    }
    wmma::store_matrix_sync(C + m0 * ldc + n0, c, ldc, wmma::mem_row_major);
  }
}

template <bool TC, bool ACC, bool A_COL, bool B_COL, typename E>
__device__ __forceinline__ void mm(float* C, int ldc, const E* A, int lda, const E* B, int ldb,
                                   int M, int N, int K) {
  if constexpr (TC) mm_tc<ACC, A_COL, B_COL>(C, ldc, A, lda, B, ldb, M, N, K);
  else mm_cc<ACC, A_COL, B_COL>(C, ldc, A, lda, B, ldb, M, N, K);
}

// Rows [r0, r0 + R) of one head of a (B, S, heads, hd) tensor into shared
// memory (ld columns a row, columns past hd and rows past S zero).
template <typename T, typename E>
__device__ void load_rows(E* dst, int ld, const T* src, long long row_stride, int r0, int R,
                          int S, int hd, int D) {
  for (int i = threadIdx.x; i < R * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const float x = (r0 + r < S && d < hd) ? load_f32(src, (size_t)((r0 + r) * row_stride + d))
                                           : 0.0f;
    from_f(dst[r * ld + d], x);
  }
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int Sk, int causal, int window) {
  bool ok = kpos < Sk;
  if (causal) ok = ok && kpos <= qpos;
  if (window > 0) ok = ok && kpos > qpos - window;
  return ok;
}

// p and dS of one (query tile, key tile) pair, from the scores S and
// dP = do v^T in f32 shared memory, into the operands of the next products
// (E: bf16 on the tensor cores, f32 on the CUDA cores).
template <typename E>
__device__ void softmax_grad(const float* Ss, const float* dPs, E* Pe, E* dSe, int ldsc,
                             int lde, const float* lse, const float* Dv, int q0, int k0, int Sq,
                             int Sk, int q_offset, int causal, int window, float scale) {
  for (int e = threadIdx.x; e < kBR * kBC; e += kThreads) {
    const int r = e / kBC, c = e % kBC;
    const int qi = q0 + r;
    const bool ok = qi < Sq && visible(q_offset + qi, k0 + c, Sk, causal, window);
    const float p = ok ? expf(Ss[r * ldsc + c] * scale - lse[r]) : 0.0f;
    const float ds = ok ? p * (dPs[r * ldsc + c] - Dv[r]) : 0.0f;
    from_f(Pe[r * lde + c], p);
    from_f(dSe[r * lde + c], ds);
  }
}

struct Dims {
  int B, Sq, Sk, H, Hkv, hd, D, q_offset, causal, window;
  float scale;
};

__host__ __device__ constexpr int pad_ld(int D, bool tc) { return tc ? D + 8 : D + 1; }

// Shared memory of either grid, in E units and floats, laid out by carve().
template <bool TC>
__host__ __device__ size_t smem_bytes(int D) {
  typedef typename Op<TC>::type E;
  const int ld = pad_ld(D, TC), ldsc = kBC + 4, lde = TC ? kBC + 8 : kBC + 1;
  const size_t e = (size_t)(2 * kBR + 2 * kBC) * ld + 2 * (size_t)kBR * lde;
  const size_t f = 2 * (size_t)kBR * ldsc + (size_t)kBR * (D + 4) + 2 * (size_t)kBC * (D + 4) +
                   2 * kBR;
  return 128 * 16 + e * sizeof(E) + f * sizeof(float);
}

template <typename P>
__device__ __forceinline__ P* carve(uint8_t*& p, size_t n) {
  P* out = reinterpret_cast<P*>(p);
  p += (n * sizeof(P) + 127) & ~(size_t)127;  // each buffer 128-byte aligned (WMMA wants 32)
  return out;
}

// 1. dq (and D).  Block (query tile, b * H + h).
template <typename T, bool TC>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ o, const float* __restrict__ lse, const T* __restrict__ dout,
          T* __restrict__ dq, float* __restrict__ Dglob, Dims d) {
  typedef typename Op<TC>::type E;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* p = smem_raw + ((128 - ((uintptr_t)smem_raw & 127)) & 127);
  const int D = d.D, ld = pad_ld(D, TC), ldsc = kBC + 4, lde = TC ? kBC + 8 : kBC + 1;
  E* Qs = carve<E>(p, (size_t)kBR * ld);
  E* dOs = carve<E>(p, (size_t)kBR * ld);
  E* Ks = carve<E>(p, (size_t)kBC * ld);
  E* Vs = carve<E>(p, (size_t)kBC * ld);
  E* Pe = carve<E>(p, (size_t)kBR * lde);
  E* dSe = carve<E>(p, (size_t)kBR * lde);
  float* Ss = carve<float>(p, (size_t)kBR * ldsc);
  float* dPs = carve<float>(p, (size_t)kBR * ldsc);
  float* dQs = carve<float>(p, (size_t)kBR * (D + 4));
  float* lses = carve<float>(p, kBR);
  float* Dvs = carve<float>(p, kBR);

  const int q0 = blockIdx.x * kBR;
  const int bh = blockIdx.y, b = bh / d.H, h = bh % d.H;
  const int hk = h / (d.H / d.Hkv);
  const long long qs = (long long)d.H * d.hd, ks = (long long)d.Hkv * d.hd;
  const T* qb = q + (long long)b * d.Sq * qs + (long long)h * d.hd;
  const T* ob = o + (long long)b * d.Sq * qs + (long long)h * d.hd;
  const T* dob = dout + (long long)b * d.Sq * qs + (long long)h * d.hd;
  const T* kb = k + (long long)b * d.Sk * ks + (long long)hk * d.hd;
  const T* vb = v + (long long)b * d.Sk * ks + (long long)hk * d.hd;

  load_rows(Qs, ld, qb, qs, q0, kBR, d.Sq, d.hd, D);
  load_rows(dOs, ld, dob, qs, q0, kBR, d.Sq, d.hd, D);
  for (int i = threadIdx.x; i < kBR * (D + 4); i += kThreads) dQs[i] = 0.0f;
  // D_i = do_i . o_i: one warp a row, lanes over columns, a fixed tree
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < kBR; r += kWarps) {
    const int qi = q0 + r;
    float s = 0.0f;
    if (qi < d.Sq)
      for (int c = lane; c < d.hd; c += 32)
        s = fmaf(load_f32(dob, (size_t)(qi * qs + c)), load_f32(ob, (size_t)(qi * qs + c)), s);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) {
      Dvs[r] = s;
      lses[r] = qi < d.Sq ? lse[(long long)bh * d.Sq + qi] : 0.0f;
      if (qi < d.Sq) Dglob[(long long)bh * d.Sq + qi] = s;
    }
  }

  const int qpos_lo = d.q_offset + q0;
  const int qpos_hi = d.q_offset + min(q0 + kBR, d.Sq) - 1;
  const int k_end = d.causal ? min(d.Sk, qpos_hi + 1) : d.Sk;
  int k_begin = d.window > 0 ? max(0, qpos_lo - d.window + 1) : 0;
  k_begin = (k_begin / kBC) * kBC;
  for (int k0 = k_begin; k0 < k_end; k0 += kBC) {
    __syncthreads();  // the previous tile's Ks, Vs, Pe, dSe are consumed
    load_rows(Ks, ld, kb, ks, k0, kBC, d.Sk, d.hd, D);
    load_rows(Vs, ld, vb, ks, k0, kBC, d.Sk, d.hd, D);
    __syncthreads();
    mm<TC, false, false, true>(Ss, ldsc, Qs, ld, Ks, ld, kBR, kBC, D);    // S = q k^T
    mm<TC, false, false, true>(dPs, ldsc, dOs, ld, Vs, ld, kBR, kBC, D);  // dP = do v^T
    __syncthreads();
    softmax_grad(Ss, dPs, Pe, dSe, ldsc, lde, lses, Dvs, q0, k0, d.Sq, d.Sk, d.q_offset, d.causal,
                 d.window, d.scale);
    __syncthreads();
    mm<TC, true, false, false>(dQs, D + 4, dSe, lde, Ks, ld, kBR, D, kBC);  // dq += dS k
  }
  __syncthreads();
  T* dqb = dq + (long long)b * d.Sq * qs + (long long)h * d.hd;
  for (int i = threadIdx.x; i < kBR * d.hd; i += kThreads) {
    const int r = i / d.hd, c = i % d.hd;
    if (q0 + r < d.Sq) store_f32(dqb, (size_t)((q0 + r) * qs + c), dQs[r * (D + 4) + c] * d.scale);
  }
}

// 2. dk and dv.  Block (key tile, b * Hkv + hk).
template <typename T, bool TC>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const float* __restrict__ lse, const T* __restrict__ dout,
            const float* __restrict__ Dglob, T* __restrict__ dk, T* __restrict__ dv, Dims d) {
  typedef typename Op<TC>::type E;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* p = smem_raw + ((128 - ((uintptr_t)smem_raw & 127)) & 127);
  const int D = d.D, ld = pad_ld(D, TC), ldsc = kBC + 4, lde = TC ? kBC + 8 : kBC + 1;
  E* Qs = carve<E>(p, (size_t)kBR * ld);
  E* dOs = carve<E>(p, (size_t)kBR * ld);
  E* Ks = carve<E>(p, (size_t)kBC * ld);
  E* Vs = carve<E>(p, (size_t)kBC * ld);
  E* Pe = carve<E>(p, (size_t)kBR * lde);
  E* dSe = carve<E>(p, (size_t)kBR * lde);
  float* Ss = carve<float>(p, (size_t)kBR * ldsc);
  float* dPs = carve<float>(p, (size_t)kBR * ldsc);
  float* dKs = carve<float>(p, (size_t)kBC * (D + 4));
  float* dVs = carve<float>(p, (size_t)kBC * (D + 4));
  float* lses = carve<float>(p, kBR);
  float* Dvs = carve<float>(p, kBR);

  const int k0 = blockIdx.x * kBC;
  const int bhk = blockIdx.y, b = bhk / d.Hkv, hk = bhk % d.Hkv;
  const int G = d.H / d.Hkv;
  const long long qs = (long long)d.H * d.hd, ks = (long long)d.Hkv * d.hd;
  const T* kb = k + (long long)b * d.Sk * ks + (long long)hk * d.hd;
  const T* vb = v + (long long)b * d.Sk * ks + (long long)hk * d.hd;
  load_rows(Ks, ld, kb, ks, k0, kBC, d.Sk, d.hd, D);
  load_rows(Vs, ld, vb, ks, k0, kBC, d.Sk, d.hd, D);
  for (int i = threadIdx.x; i < kBC * (D + 4); i += kThreads) dKs[i] = dVs[i] = 0.0f;

  // the query rows that can see a key of this tile
  const int k_last = min(k0 + kBC, d.Sk) - 1;
  int i_begin = d.causal ? max(0, k0 - d.q_offset) : 0;
  i_begin = (i_begin / kBR) * kBR;
  const int i_end = d.window > 0 ? min(d.Sq, k_last + d.window - d.q_offset) : d.Sq;
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const int bh = b * d.H + h;
    const T* qb = q + (long long)b * d.Sq * qs + (long long)h * d.hd;
    const T* dob = dout + (long long)b * d.Sq * qs + (long long)h * d.hd;
    for (int q0 = i_begin; q0 < i_end; q0 += kBR) {
      __syncthreads();  // the previous tile's Qs, dOs, Pe, dSe are consumed
      load_rows(Qs, ld, qb, qs, q0, kBR, d.Sq, d.hd, D);
      load_rows(dOs, ld, dob, qs, q0, kBR, d.Sq, d.hd, D);
      for (int r = threadIdx.x; r < kBR; r += kThreads) {
        const bool in = q0 + r < d.Sq;
        lses[r] = in ? lse[(long long)bh * d.Sq + q0 + r] : 0.0f;
        Dvs[r] = in ? Dglob[(long long)bh * d.Sq + q0 + r] : 0.0f;
      }
      __syncthreads();
      mm<TC, false, false, true>(Ss, ldsc, Qs, ld, Ks, ld, kBR, kBC, D);
      mm<TC, false, false, true>(dPs, ldsc, dOs, ld, Vs, ld, kBR, kBC, D);
      __syncthreads();
      softmax_grad(Ss, dPs, Pe, dSe, ldsc, lde, lses, Dvs, q0, k0, d.Sq, d.Sk, d.q_offset,
                   d.causal, d.window, d.scale);
      __syncthreads();
      mm<TC, true, true, false>(dVs, D + 4, Pe, lde, dOs, ld, kBC, D, kBR);  // dv += P^T do
      mm<TC, true, true, false>(dKs, D + 4, dSe, lde, Qs, ld, kBC, D, kBR);  // dk += dS^T q
    }
  }
  __syncthreads();
  T* dkb = dk + (long long)b * d.Sk * ks + (long long)hk * d.hd;
  T* dvb = dv + (long long)b * d.Sk * ks + (long long)hk * d.hd;
  for (int i = threadIdx.x; i < kBC * d.hd; i += kThreads) {
    const int r = i / d.hd, c = i % d.hd;
    if (k0 + r < d.Sk) {
      store_f32(dkb, (size_t)((k0 + r) * ks + c), dKs[r * (D + 4) + c] * d.scale);
      store_f32(dvb, (size_t)((k0 + r) * ks + c), dVs[r * (D + 4) + c]);
    }
  }
}

template <typename T, bool TC>
int launch_typed(const void* q, const void* k, const void* v, const void* o, const float* lse,
                 const void* dout, void* dq, void* dk, void* dv, float* Dscratch, Dims d,
                 cudaStream_t stream) {
  const size_t smem = smem_bytes<TC>(d.D);
  cudaError_t err = cudaFuncSetAttribute(dq_kernel<T, TC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dkdv_kernel<T, TC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 g1((unsigned)((d.Sq + kBR - 1) / kBR), (unsigned)(d.B * d.H));
  dq_kernel<T, TC><<<g1, kThreads, smem, stream>>>((const T*)q, (const T*)k, (const T*)v,
                                                   (const T*)o, lse, (const T*)dout, (T*)dq,
                                                   Dscratch, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (d.Sk > 0) {
    dim3 g2((unsigned)((d.Sk + kBC - 1) / kBC), (unsigned)(d.B * d.Hkv));
    dkdv_kernel<T, TC><<<g2, kThreads, smem, stream>>>((const T*)q, (const T*)k, (const T*)v, lse,
                                                       (const T*)dout, Dscratch, (T*)dk, (T*)dv,
                                                       d);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// q, o, dout, dq (B, Sq, H, hd) and k, v, dk, dv (B, Sk, Hkv, hd) of one
// dtype (f32 or bf16), contiguous; lse (B, H, Sq) f32 from the forward;
// ``Dscratch`` f32 scratch of B H Sq floats.  tensor_cores != 0: bf16 with
// hd a multiple of 16.  window <= 0: no window.  Returns a CUDA error code.
extern "C" int launch_flash_attention_bwd(const void* q, const void* k, const void* v,
                                          const void* o, const void* lse, const void* dout,
                                          void* dq, void* dk, void* dv, void* Dscratch, int B,
                                          int Sq, int Sk, int H, int Hkv, int hd, int q_offset,
                                          int causal, int window, int dtype, int tensor_cores,
                                          float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (hd < 1 || hd > kMaxD || Hkv < 1 || H % Hkv != 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0 || H == 0) return (int)cudaGetLastError();
  Dims d{B, Sq, Sk, H, Hkv, hd, (hd + 15) / 16 * 16, q_offset, causal, window, scale};
  cudaStream_t st = (cudaStream_t)stream;
  const float* l = (const float*)lse;
  float* Ds = (float*)Dscratch;
  if (tensor_cores) {
    if (dtype != kBF16 || hd % 16 != 0) return (int)cudaErrorInvalidValue;
    return launch_typed<__nv_bfloat16, true>(q, k, v, o, l, dout, dq, dk, dv, Ds, d, st);
  }
  if (dtype == kF32)
    return launch_typed<float, false>(q, k, v, o, l, dout, dq, dk, dv, Ds, d, st);
  if (dtype == kBF16)
    return launch_typed<__nv_bfloat16, false>(q, k, v, o, l, dout, dq, dk, dv, Ds, d, st);
  return (int)cudaErrorInvalidValue;
}
