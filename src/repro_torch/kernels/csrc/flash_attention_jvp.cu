// Kernels 16j and 16bj: the tangents (forward mode) of kernel 16 (causal GQA
// attention, optionally over a sliding window) and of its backward 16b.
// They replace no Pallas kernel: the reference takes jax.jvp of jax.grad
// through its "xla" branch (src/repro/kernels/ops.py _flash_xla) for the
// curvature probe of --eta auto (src/repro/core/autotune.py:140-159, a
// power iteration of Hessian-vector products vmap(jvp(grad(loss)))).
//
// With P = exp(s q k^T - lse) over the visible keys (0 elsewhere), s =
// 1 / sqrt(hd), and the scores' tangent S' = s (q' k^T + q k'^T):
//
// 16j  flash_attention_jvp: q, k, v, lse and the tangents q', k', v' ->
//        lse' = sum_j P_j S'_j,   o' = sum_j P_j (S'_j v_j + v'_j) - lse' o,
//      o = sum_j P_j v_j formed here in f32 (not the forward's rounded o);
//      one sweep over the keys, lse being known: no online max.
// 16bj flash_attention_bwd_jvp: 16b's operands q, k, v, o, lse, do and the
//      tangents q', k', v', o', do' -> the tangents of 16b's dq, dk, dv:
//        P'  = P (S' - lse'),            dP' = do' v^T + do v'^T
//        D   = rowsum(do o),             D'  = rowsum(do' o + do o')
//        dS  = P (do v^T - D),           dS' = P' (dP - D) + P (dP' - D')
//        dq' = s (dS' k + dS k'),  dk' = s (dS'^T q + dS^T q'),
//        dv' = P'^T do + P^T do'
//      with dk', dv' summed over each kv head's query heads.  lse' is
//      formed here (its own sweep over the keys), never read: the forward's
//      Function marks lse non-differentiable, so no tangent of lse reaches
//      16b's Function, and reading one would use zero without a word.
//      Two grids, as 16b's, no atomics: a row grid (query tile, b H + h)
//      forms lse', D, D' for its rows (into the wrapper's scratch) and dq';
//      then a key grid (key tile, b Hkv + hk) walks the kv head's query
//      heads and the query tiles that see its keys and forms dk', dv'.
//
// What bounds them on an H100: operations.  Per (query, visible key) pair
// and head, 16j takes 3 products of length hd (S, and S' as two) and 3 of
// length vd (P S' v, P v', P v); 16bj's function takes S, S' (3 of hd), dP,
// dP' (3 of vd), dq', dk' (4 of hd) and dv' (2 of vd): 7 hd + 5 vd, 12 at
// hd = vd, 6 times the forward's 2.  At the training round's folded shape
// (8, 128, 16, 128) that is 3.3 GFLOP for 16bj, 3.4 us at the bf16
// tensor-core rate; these CUDA-core kernels run far from it.
//
// The design is the simple one: CUDA cores, f32 products out of shared
// memory (bf16 operands widened; f32 stays f32, not TF32), tiles of BR
// query rows (32 up to hd, vd = 128, 16 beyond) and KC keys (32; 16 in the
// key grid and 16bj's row grid beyond 128: shared memory), each output
// element one thread's sum over its tile in order, so two runs agree
// bitwise.  16bj's row grid forms S and S' in its lse' sweep and again in
// its dq' sweep, and the key grid forms S, S', dP and dP' once more: 13 hd
// + 8 vd products a pair against the function's 7 hd + 5 vd (the bound
// counts the function's).
// A row that sees no key gets tangents 0 (P = 0 there), as 16b gives it
// gradient 0.
#include <stdint.h>

#include "attention_tiles.cuh"  // visible(), tile products, row loads, carving

namespace {

using attn::carve;
using attn::carved;
using attn::kThreads;
using attn::load_rows;
using attn::mm;
using attn::visible;

constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 256;  // hd and vd, as kernel 16 takes them

struct Dims {
  int B, Sq, Sk, H, Hkv, hd, vd, q_offset, causal, window;
  float scale;
};

__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  return raw + ((128 - ((uintptr_t)raw & 127)) & 127);
}

// The operand pointers of one (b, head) pair: row strides H hd (q), H vd
// (o, do), Hkv hd (k), Hkv vd (v).
struct Heads {
  long long qs, os, ks, vs;
  __device__ Heads(const Dims& d)
      : qs((long long)d.H * d.hd), os((long long)d.H * d.vd), ks((long long)d.Hkv * d.hd),
        vs((long long)d.Hkv * d.vd) {}
  __device__ long long q(const Dims& d, int b, int h) const {
    return (long long)b * d.Sq * qs + (long long)h * d.hd;
  }
  __device__ long long o(const Dims& d, int b, int h) const {
    return (long long)b * d.Sq * os + (long long)h * d.vd;
  }
  __device__ long long k(const Dims& d, int b, int hk) const {
    return (long long)b * d.Sk * ks + (long long)hk * d.hd;
  }
  __device__ long long v(const Dims& d, int b, int hk) const {
    return (long long)b * d.Sk * vs + (long long)hk * d.vd;
  }
};

// The key tiles a query tile [q0, q0 + BR) can see: [begin, end), begin a
// multiple of KC.
template <int KC>
__device__ __forceinline__ void key_range(const Dims& d, int q0, int BR, int& begin, int& end) {
  const int qpos_lo = d.q_offset + q0;
  const int qpos_hi = d.q_offset + min(q0 + BR, d.Sq) - 1;
  end = d.causal ? min(d.Sk, qpos_hi + 1) : d.Sk;
  begin = d.window > 0 ? max(0, qpos_lo - d.window + 1) : 0;
  begin = (begin / KC) * KC;
}

// ---------------------------------------------------------------------------
// 16j: the tangent of the forward.  Block (query tile of BR rows, b H + h).
// ---------------------------------------------------------------------------
template <int BR, int KC>
size_t fwd_smem(int hd, int vd) {
  const int ldq = hd + 1, ldv = vd + 1, ldsc = KC + 4, lde = KC + 1;
  return 128 + 2 * carved((size_t)BR * ldq) + 2 * carved((size_t)KC * ldq) +
         2 * carved((size_t)KC * ldv) + 2 * carved((size_t)BR * ldsc) +
         2 * carved((size_t)BR * lde) + 2 * carved(BR) + 2 * carved((size_t)BR * (vd + 4));
}

template <typename T, int BR, int KC>
__global__ void __launch_bounds__(kThreads)
fwd_jvp_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const float* __restrict__ lse, const T* __restrict__ qt, const T* __restrict__ kt,
               const T* __restrict__ vt, T* __restrict__ ot, float* __restrict__ lse_t, Dims d) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* p = aligned_smem(smem_raw);
  const int ldq = d.hd + 1, ldv = d.vd + 1, ldsc = KC + 4, lde = KC + 1, ldo = d.vd + 4;
  float* Qs = carve(p, (size_t)BR * ldq);
  float* Qts = carve(p, (size_t)BR * ldq);
  float* Ks = carve(p, (size_t)KC * ldq);
  float* Kts = carve(p, (size_t)KC * ldq);
  float* Vs = carve(p, (size_t)KC * ldv);
  float* Vts = carve(p, (size_t)KC * ldv);
  float* Ss = carve(p, (size_t)BR * ldsc);
  float* Sts = carve(p, (size_t)BR * ldsc);
  float* Pe = carve(p, (size_t)BR * lde);
  float* Ee = carve(p, (size_t)BR * lde);  // P S' s
  float* lses = carve(p, BR);
  float* lsets = carve(p, BR);
  float* Oacc = carve(p, (size_t)BR * ldo);   // sum P v
  float* Otacc = carve(p, (size_t)BR * ldo);  // sum P S' s v + P v'

  const int q0 = blockIdx.x * BR;
  const int bh = blockIdx.y, b = bh / d.H, h = bh % d.H;
  const int hk = h / (d.H / d.Hkv);
  const Heads hs(d);
  const long long qo = hs.q(d, b, h), ko = hs.k(d, b, hk), vo = hs.v(d, b, hk);
  load_rows(Qs, ldq, q + qo, hs.qs, q0, BR, d.Sq, d.hd, d.hd);
  load_rows(Qts, ldq, qt + qo, hs.qs, q0, BR, d.Sq, d.hd, d.hd);
  for (int i = threadIdx.x; i < BR * ldo; i += kThreads) Oacc[i] = Otacc[i] = 0.0f;
  for (int r = threadIdx.x; r < BR; r += kThreads) {
    lses[r] = q0 + r < d.Sq ? lse[(long long)bh * d.Sq + q0 + r] : 0.0f;
    lsets[r] = 0.0f;
  }
  int k_begin, k_end;
  key_range<KC>(d, q0, BR, k_begin, k_end);
  for (int k0 = k_begin; k0 < k_end; k0 += KC) {
    __syncthreads();  // the previous tile's operands and P, E are consumed
    load_rows(Ks, ldq, k + ko, hs.ks, k0, KC, d.Sk, d.hd, d.hd);
    load_rows(Kts, ldq, kt + ko, hs.ks, k0, KC, d.Sk, d.hd, d.hd);
    load_rows(Vs, ldv, v + vo, hs.vs, k0, KC, d.Sk, d.vd, d.vd);
    load_rows(Vts, ldv, vt + vo, hs.vs, k0, KC, d.Sk, d.vd, d.vd);
    __syncthreads();
    mm<false, false, true>(Ss, ldsc, Qs, ldq, Ks, ldq, BR, KC, d.hd);    // q k^T
    mm<false, false, true>(Sts, ldsc, Qts, ldq, Ks, ldq, BR, KC, d.hd);  // q' k^T
    mm<true, false, true>(Sts, ldsc, Qs, ldq, Kts, ldq, BR, KC, d.hd);   //  + q k'^T
    __syncthreads();
    for (int e = threadIdx.x; e < BR * KC; e += kThreads) {
      const int r = e / KC, c = e % KC;
      const int qi = q0 + r;
      const bool ok = qi < d.Sq && visible(d.q_offset + qi, k0 + c, d.Sk, d.causal, d.window);
      const float pr = ok ? expf(Ss[r * ldsc + c] * d.scale - lses[r]) : 0.0f;
      Pe[r * lde + c] = pr;
      Ee[r * lde + c] = pr * (Sts[r * ldsc + c] * d.scale);
    }
    __syncthreads();
    for (int r = threadIdx.x; r < BR; r += kThreads) {
      float s = lsets[r];
      for (int c = 0; c < KC; ++c) s += Ee[r * lde + c];
      lsets[r] = s;
    }
    mm<true, false, false>(Oacc, ldo, Pe, lde, Vs, ldv, BR, d.vd, KC);    // P v
    mm<true, false, false>(Otacc, ldo, Ee, lde, Vs, ldv, BR, d.vd, KC);   // P S' s v
    mm<true, false, false>(Otacc, ldo, Pe, lde, Vts, ldv, BR, d.vd, KC);  //  + P v'
  }
  __syncthreads();
  const long long oo = hs.o(d, b, h);
  for (int i = threadIdx.x; i < BR * d.vd; i += kThreads) {
    const int r = i / d.vd, c = i % d.vd;
    if (q0 + r < d.Sq)
      store_f32(ot + oo, (size_t)((q0 + r) * hs.os + c),
                Otacc[r * ldo + c] - lsets[r] * Oacc[r * ldo + c]);
  }
  for (int r = threadIdx.x; r < BR; r += kThreads)
    if (q0 + r < d.Sq) lse_t[(long long)bh * d.Sq + q0 + r] = lsets[r];
}

// ---------------------------------------------------------------------------
// 16bj, the row grid: lse', D, D' (into scratch) and dq'.  Block (query tile
// of BR rows, b H + h).
// ---------------------------------------------------------------------------
template <int BR, int KC>
size_t rows_smem(int hd, int vd) {
  const int ldq = hd + 1, ldv = vd + 1, ldsc = KC + 4, lde = KC + 1;
  return 128 + 2 * carved((size_t)BR * ldq) + 2 * carved((size_t)BR * ldv) +
         2 * carved((size_t)KC * ldq) + 2 * carved((size_t)KC * ldv) +
         4 * carved((size_t)BR * ldsc) + 4 * carved((size_t)BR * lde) + 4 * carved(BR) +
         carved((size_t)BR * (hd + 4));
}

// P, P', dS, dS' of one (query tile, key tile) pair from the raw products in
// shared memory (Ss = q k^T, Sts = q' k^T + q k'^T, dPs = do v^T, dPts = do'
// v^T + do v'^T) and the rows' lse, lse', D, D'.
template <int BR, int KC>
__device__ void tangent_tiles(const float* Ss, const float* Sts, const float* dPs,
                              const float* dPts, float* Pe, float* Pte, float* dSe, float* dSte,
                              int ldsc, int lde, const float* lses, const float* lsets,
                              const float* Ds, const float* Dts, int q0, int k0, const Dims& d) {
  for (int e = threadIdx.x; e < BR * KC; e += kThreads) {
    const int r = e / KC, c = e % KC;
    const int qi = q0 + r;
    const bool ok = qi < d.Sq && visible(d.q_offset + qi, k0 + c, d.Sk, d.causal, d.window);
    float pr = 0.0f, pt = 0.0f, ds = 0.0f, dst = 0.0f;
    if (ok) {
      pr = expf(Ss[r * ldsc + c] * d.scale - lses[r]);
      pt = pr * (Sts[r * ldsc + c] * d.scale - lsets[r]);
      const float dpd = dPs[r * ldsc + c] - Ds[r];
      ds = pr * dpd;
      dst = pt * dpd + pr * (dPts[r * ldsc + c] - Dts[r]);
    }
    Pe[r * lde + c] = pr;
    Pte[r * lde + c] = pt;
    dSe[r * lde + c] = ds;
    dSte[r * lde + c] = dst;
  }
}

template <typename T, int BR, int KC>
__global__ void __launch_bounds__(kThreads)
rows_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ o, const float* __restrict__ lse, const T* __restrict__ dout,
            const T* __restrict__ qt, const T* __restrict__ kt, const T* __restrict__ vt,
            const T* __restrict__ ot, const T* __restrict__ dout_t, T* __restrict__ dq_t,
            float* __restrict__ rows_out, Dims d) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* p = aligned_smem(smem_raw);
  const int ldq = d.hd + 1, ldv = d.vd + 1, ldsc = KC + 4, lde = KC + 1, ldg = d.hd + 4;
  float* Qs = carve(p, (size_t)BR * ldq);
  float* Qts = carve(p, (size_t)BR * ldq);
  float* dOs = carve(p, (size_t)BR * ldv);
  float* dOts = carve(p, (size_t)BR * ldv);
  float* Ks = carve(p, (size_t)KC * ldq);
  float* Kts = carve(p, (size_t)KC * ldq);
  float* Vs = carve(p, (size_t)KC * ldv);
  float* Vts = carve(p, (size_t)KC * ldv);
  float* Ss = carve(p, (size_t)BR * ldsc);
  float* Sts = carve(p, (size_t)BR * ldsc);
  float* dPs = carve(p, (size_t)BR * ldsc);
  float* dPts = carve(p, (size_t)BR * ldsc);
  float* Pe = carve(p, (size_t)BR * lde);
  float* Pte = carve(p, (size_t)BR * lde);
  float* dSe = carve(p, (size_t)BR * lde);
  float* dSte = carve(p, (size_t)BR * lde);
  float* lses = carve(p, BR);
  float* lsets = carve(p, BR);
  float* Ds = carve(p, BR);
  float* Dts = carve(p, BR);
  float* dQt = carve(p, (size_t)BR * ldg);

  const int q0 = blockIdx.x * BR;
  const int bh = blockIdx.y, b = bh / d.H, h = bh % d.H;
  const int hk = h / (d.H / d.Hkv);
  const Heads hs(d);
  const long long qo = hs.q(d, b, h), oo = hs.o(d, b, h);
  const long long ko = hs.k(d, b, hk), vo = hs.v(d, b, hk);
  load_rows(Qs, ldq, q + qo, hs.qs, q0, BR, d.Sq, d.hd, d.hd);
  load_rows(Qts, ldq, qt + qo, hs.qs, q0, BR, d.Sq, d.hd, d.hd);
  load_rows(dOs, ldv, dout + oo, hs.os, q0, BR, d.Sq, d.vd, d.vd);
  load_rows(dOts, ldv, dout_t + oo, hs.os, q0, BR, d.Sq, d.vd, d.vd);
  for (int i = threadIdx.x; i < BR * ldg; i += kThreads) dQt[i] = 0.0f;
  // D = do . o and D' = do' . o + do . o': one warp a row, lanes over
  // columns, a fixed tree
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < BR; r += kWarps) {
    const int qi = q0 + r;
    float s = 0.0f, st = 0.0f;
    if (qi < d.Sq)
      for (int c = lane; c < d.vd; c += 32) {
        const size_t i = (size_t)(qi * hs.os + c);
        const float ov = load_f32(o + oo, i), dov = load_f32(dout + oo, i);
        s = fmaf(dov, ov, s);
        st = fmaf(load_f32(dout_t + oo, i), ov, st);
        st = fmaf(dov, load_f32(ot + oo, i), st);
      }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, off);
      st += __shfl_xor_sync(0xffffffffu, st, off);
    }
    if (lane == 0) {
      Ds[r] = s;
      Dts[r] = st;
      lses[r] = qi < d.Sq ? lse[(long long)bh * d.Sq + qi] : 0.0f;
      lsets[r] = 0.0f;
    }
  }
  int k_begin, k_end;
  key_range<KC>(d, q0, BR, k_begin, k_end);
  // sweep 1: lse' = sum P S' s
  for (int k0 = k_begin; k0 < k_end; k0 += KC) {
    __syncthreads();
    load_rows(Ks, ldq, k + ko, hs.ks, k0, KC, d.Sk, d.hd, d.hd);
    load_rows(Kts, ldq, kt + ko, hs.ks, k0, KC, d.Sk, d.hd, d.hd);
    __syncthreads();
    mm<false, false, true>(Ss, ldsc, Qs, ldq, Ks, ldq, BR, KC, d.hd);
    mm<false, false, true>(Sts, ldsc, Qts, ldq, Ks, ldq, BR, KC, d.hd);
    mm<true, false, true>(Sts, ldsc, Qs, ldq, Kts, ldq, BR, KC, d.hd);
    __syncthreads();
    for (int e = threadIdx.x; e < BR * KC; e += kThreads) {
      const int r = e / KC, c = e % KC;
      const int qi = q0 + r;
      const bool ok = qi < d.Sq && visible(d.q_offset + qi, k0 + c, d.Sk, d.causal, d.window);
      Pe[r * lde + c] =
          ok ? expf(Ss[r * ldsc + c] * d.scale - lses[r]) * (Sts[r * ldsc + c] * d.scale) : 0.0f;
    }
    __syncthreads();
    for (int r = threadIdx.x; r < BR; r += kThreads) {
      float s = lsets[r];
      for (int c = 0; c < KC; ++c) s += Pe[r * lde + c];
      lsets[r] = s;
    }
  }
  // sweep 2: dq' += dS' k + dS k'
  for (int k0 = k_begin; k0 < k_end; k0 += KC) {
    __syncthreads();
    load_rows(Ks, ldq, k + ko, hs.ks, k0, KC, d.Sk, d.hd, d.hd);
    load_rows(Kts, ldq, kt + ko, hs.ks, k0, KC, d.Sk, d.hd, d.hd);
    load_rows(Vs, ldv, v + vo, hs.vs, k0, KC, d.Sk, d.vd, d.vd);
    load_rows(Vts, ldv, vt + vo, hs.vs, k0, KC, d.Sk, d.vd, d.vd);
    __syncthreads();
    mm<false, false, true>(Ss, ldsc, Qs, ldq, Ks, ldq, BR, KC, d.hd);
    mm<false, false, true>(Sts, ldsc, Qts, ldq, Ks, ldq, BR, KC, d.hd);
    mm<true, false, true>(Sts, ldsc, Qs, ldq, Kts, ldq, BR, KC, d.hd);
    mm<false, false, true>(dPs, ldsc, dOs, ldv, Vs, ldv, BR, KC, d.vd);
    mm<false, false, true>(dPts, ldsc, dOts, ldv, Vs, ldv, BR, KC, d.vd);
    mm<true, false, true>(dPts, ldsc, dOs, ldv, Vts, ldv, BR, KC, d.vd);
    __syncthreads();
    tangent_tiles<BR, KC>(Ss, Sts, dPs, dPts, Pe, Pte, dSe, dSte, ldsc, lde, lses, lsets, Ds,
                          Dts, q0, k0, d);
    __syncthreads();
    mm<true, false, false>(dQt, ldg, dSte, lde, Ks, ldq, BR, d.hd, KC);  // dS' k
    mm<true, false, false>(dQt, ldg, dSe, lde, Kts, ldq, BR, d.hd, KC);  //  + dS k'
  }
  __syncthreads();
  for (int i = threadIdx.x; i < BR * d.hd; i += kThreads) {
    const int r = i / d.hd, c = i % d.hd;
    if (q0 + r < d.Sq)
      store_f32(dq_t + qo, (size_t)((q0 + r) * hs.qs + c), dQt[r * ldg + c] * d.scale);
  }
  // the rows' lse', D, D' for the key grid: three (B H Sq) planes
  const long long plane = (long long)d.B * d.H * d.Sq;
  for (int r = threadIdx.x; r < BR; r += kThreads) {
    if (q0 + r < d.Sq) {
      const long long i = (long long)bh * d.Sq + q0 + r;
      rows_out[i] = lsets[r];
      rows_out[plane + i] = Ds[r];
      rows_out[2 * plane + i] = Dts[r];
    }
  }
}

// ---------------------------------------------------------------------------
// 16bj, the key grid: dk', dv'.  Block (key tile of KC keys, b Hkv + hk),
// walking the kv head's G query heads and their query tiles of BR rows that
// see its keys.
// ---------------------------------------------------------------------------
template <int BR, int KC>
size_t keys_smem(int hd, int vd) {
  const int ldq = hd + 1, ldv = vd + 1, ldsc = KC + 4, lde = KC + 1;
  return 128 + 2 * carved((size_t)BR * ldq) + 2 * carved((size_t)BR * ldv) +
         2 * carved((size_t)KC * ldq) + 2 * carved((size_t)KC * ldv) +
         4 * carved((size_t)BR * ldsc) + 4 * carved((size_t)BR * lde) + 4 * carved(BR) +
         carved((size_t)KC * (hd + 4)) + carved((size_t)KC * (vd + 4));
}

template <typename T, int BR, int KC>
__global__ void __launch_bounds__(kThreads)
keys_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const float* __restrict__ lse, const T* __restrict__ dout, const T* __restrict__ qt,
            const T* __restrict__ kt, const T* __restrict__ vt, const T* __restrict__ dout_t,
            const float* __restrict__ rows_in, T* __restrict__ dk_t, T* __restrict__ dv_t,
            Dims d) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* p = aligned_smem(smem_raw);
  const int ldq = d.hd + 1, ldv = d.vd + 1, ldsc = KC + 4, lde = KC + 1;
  const int ldk = d.hd + 4, ldw = d.vd + 4;
  float* Qs = carve(p, (size_t)BR * ldq);
  float* Qts = carve(p, (size_t)BR * ldq);
  float* dOs = carve(p, (size_t)BR * ldv);
  float* dOts = carve(p, (size_t)BR * ldv);
  float* Ks = carve(p, (size_t)KC * ldq);
  float* Kts = carve(p, (size_t)KC * ldq);
  float* Vs = carve(p, (size_t)KC * ldv);
  float* Vts = carve(p, (size_t)KC * ldv);
  float* Ss = carve(p, (size_t)BR * ldsc);
  float* Sts = carve(p, (size_t)BR * ldsc);
  float* dPs = carve(p, (size_t)BR * ldsc);
  float* dPts = carve(p, (size_t)BR * ldsc);
  float* Pe = carve(p, (size_t)BR * lde);
  float* Pte = carve(p, (size_t)BR * lde);
  float* dSe = carve(p, (size_t)BR * lde);
  float* dSte = carve(p, (size_t)BR * lde);
  float* lses = carve(p, BR);
  float* lsets = carve(p, BR);
  float* Ds = carve(p, BR);
  float* Dts = carve(p, BR);
  float* dKt = carve(p, (size_t)KC * ldk);
  float* dVt = carve(p, (size_t)KC * ldw);

  const int k0 = blockIdx.x * KC;
  const int bhk = blockIdx.y, b = bhk / d.Hkv, hk = bhk % d.Hkv;
  const int G = d.H / d.Hkv;
  const Heads hs(d);
  const long long ko = hs.k(d, b, hk), vo = hs.v(d, b, hk);
  load_rows(Ks, ldq, k + ko, hs.ks, k0, KC, d.Sk, d.hd, d.hd);
  load_rows(Kts, ldq, kt + ko, hs.ks, k0, KC, d.Sk, d.hd, d.hd);
  load_rows(Vs, ldv, v + vo, hs.vs, k0, KC, d.Sk, d.vd, d.vd);
  load_rows(Vts, ldv, vt + vo, hs.vs, k0, KC, d.Sk, d.vd, d.vd);
  for (int i = threadIdx.x; i < KC * ldk; i += kThreads) dKt[i] = 0.0f;
  for (int i = threadIdx.x; i < KC * ldw; i += kThreads) dVt[i] = 0.0f;

  const long long plane = (long long)d.B * d.H * d.Sq;
  const int k_last = min(k0 + KC, d.Sk) - 1;
  int i_begin = d.causal ? max(0, k0 - d.q_offset) : 0;
  i_begin = (i_begin / BR) * BR;
  const int i_end = d.window > 0 ? min(d.Sq, k_last + d.window - d.q_offset) : d.Sq;
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const int bh = b * d.H + h;
    const long long qo = hs.q(d, b, h), oo = hs.o(d, b, h);
    for (int q0 = i_begin; q0 < i_end; q0 += BR) {
      __syncthreads();  // the previous tile's operands and tiles are consumed
      load_rows(Qs, ldq, q + qo, hs.qs, q0, BR, d.Sq, d.hd, d.hd);
      load_rows(Qts, ldq, qt + qo, hs.qs, q0, BR, d.Sq, d.hd, d.hd);
      load_rows(dOs, ldv, dout + oo, hs.os, q0, BR, d.Sq, d.vd, d.vd);
      load_rows(dOts, ldv, dout_t + oo, hs.os, q0, BR, d.Sq, d.vd, d.vd);
      for (int r = threadIdx.x; r < BR; r += kThreads) {
        const bool in = q0 + r < d.Sq;
        const long long i = (long long)bh * d.Sq + q0 + r;
        lses[r] = in ? lse[i] : 0.0f;
        lsets[r] = in ? rows_in[i] : 0.0f;
        Ds[r] = in ? rows_in[plane + i] : 0.0f;
        Dts[r] = in ? rows_in[2 * plane + i] : 0.0f;
      }
      __syncthreads();
      mm<false, false, true>(Ss, ldsc, Qs, ldq, Ks, ldq, BR, KC, d.hd);
      mm<false, false, true>(Sts, ldsc, Qts, ldq, Ks, ldq, BR, KC, d.hd);
      mm<true, false, true>(Sts, ldsc, Qs, ldq, Kts, ldq, BR, KC, d.hd);
      mm<false, false, true>(dPs, ldsc, dOs, ldv, Vs, ldv, BR, KC, d.vd);
      mm<false, false, true>(dPts, ldsc, dOts, ldv, Vs, ldv, BR, KC, d.vd);
      mm<true, false, true>(dPts, ldsc, dOs, ldv, Vts, ldv, BR, KC, d.vd);
      __syncthreads();
      tangent_tiles<BR, KC>(Ss, Sts, dPs, dPts, Pe, Pte, dSe, dSte, ldsc, lde, lses, lsets, Ds,
                            Dts, q0, k0, d);
      __syncthreads();
      mm<true, true, false>(dVt, ldw, Pte, lde, dOs, ldv, KC, d.vd, BR);   // P'^T do
      mm<true, true, false>(dVt, ldw, Pe, lde, dOts, ldv, KC, d.vd, BR);   //  + P^T do'
      mm<true, true, false>(dKt, ldk, dSte, lde, Qs, ldq, KC, d.hd, BR);   // dS'^T q
      mm<true, true, false>(dKt, ldk, dSe, lde, Qts, ldq, KC, d.hd, BR);   //  + dS^T q'
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < KC * d.hd; i += kThreads) {
    const int r = i / d.hd, c = i % d.hd;
    if (k0 + r < d.Sk)
      store_f32(dk_t + ko, (size_t)((k0 + r) * hs.ks + c), dKt[r * ldk + c] * d.scale);
  }
  for (int i = threadIdx.x; i < KC * d.vd; i += kThreads) {
    const int r = i / d.vd, c = i % d.vd;
    if (k0 + r < d.Sk) store_f32(dv_t + vo, (size_t)((k0 + r) * hs.vs + c), dVt[r * ldw + c]);
  }
}

template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Query tiles of 32 rows up to hd, vd = 128, of 16 beyond (shared memory).
template <typename T>
int launch_fwd(const void* q, const void* k, const void* v, const float* lse, const void* qt,
               const void* kt, const void* vt, void* ot, float* lse_t, const Dims& d,
               cudaStream_t st) {
  const bool wide = d.hd > 128 || d.vd > 128;
  auto run = [&](auto kern, int BR, size_t smem) -> int {
    cudaError_t err = allow_smem(kern, smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((unsigned)((d.Sq + BR - 1) / BR), (unsigned)(d.B * d.H));
    kern<<<grid, kThreads, smem, st>>>((const T*)q, (const T*)k, (const T*)v, lse,
                                       (const T*)qt, (const T*)kt, (const T*)vt, (T*)ot, lse_t,
                                       d);
    return (int)cudaGetLastError();
  };
  if (wide) return run(fwd_jvp_kernel<T, 16, 32>, 16, fwd_smem<16, 32>(d.hd, d.vd));
  return run(fwd_jvp_kernel<T, 32, 32>, 32, fwd_smem<32, 32>(d.hd, d.vd));
}

template <typename T, int BR, int KC_ROWS, int KC_KEYS>
int launch_bwd_tiles(const void* q, const void* k, const void* v, const void* o,
                     const float* lse, const void* dout, const void* qt, const void* kt,
                     const void* vt, const void* ot, const void* dout_t, void* dq_t, void* dk_t,
                     void* dv_t, float* rows, const Dims& d, cudaStream_t st) {
  const size_t s1 = rows_smem<BR, KC_ROWS>(d.hd, d.vd), s2 = keys_smem<BR, KC_KEYS>(d.hd, d.vd);
  cudaError_t err = allow_smem(rows_kernel<T, BR, KC_ROWS>, s1);
  if (err == cudaSuccess) err = allow_smem(keys_kernel<T, BR, KC_KEYS>, s2);
  if (err != cudaSuccess) return (int)err;
  dim3 g1((unsigned)((d.Sq + BR - 1) / BR), (unsigned)(d.B * d.H));
  rows_kernel<T, BR, KC_ROWS><<<g1, kThreads, s1, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)o, lse, (const T*)dout, (const T*)qt,
      (const T*)kt, (const T*)vt, (const T*)ot, (const T*)dout_t, (T*)dq_t, rows, d);
  err = cudaGetLastError();
  if (err != cudaSuccess || d.Sk == 0) return (int)err;
  dim3 g2((unsigned)((d.Sk + KC_KEYS - 1) / KC_KEYS), (unsigned)(d.B * d.Hkv));
  keys_kernel<T, BR, KC_KEYS><<<g2, kThreads, s2, st>>>(
      (const T*)q, (const T*)k, (const T*)v, lse, (const T*)dout, (const T*)qt, (const T*)kt,
      (const T*)vt, (const T*)dout_t, rows, (T*)dk_t, (T*)dv_t, d);
  return (int)cudaGetLastError();
}

// Up to hd, vd = 128: 32 query rows and 32 keys; beyond: 16 rows, 16 keys
// (the row grid's and the key grid's shared memory at 256 stay under 227 KB).
template <typename T>
int launch_bwd(const void* q, const void* k, const void* v, const void* o, const float* lse,
               const void* dout, const void* qt, const void* kt, const void* vt, const void* ot,
               const void* dout_t, void* dq_t, void* dk_t, void* dv_t, float* rows,
               const Dims& d, cudaStream_t st) {
  if (d.hd > 128 || d.vd > 128)
    return launch_bwd_tiles<T, 16, 16, 16>(q, k, v, o, lse, dout, qt, kt, vt, ot, dout_t, dq_t,
                                           dk_t, dv_t, rows, d, st);
  return launch_bwd_tiles<T, 32, 32, 32>(q, k, v, o, lse, dout, qt, kt, vt, ot, dout_t, dq_t,
                                         dk_t, dv_t, rows, d, st);
}

bool dims_ok(int hd, int vd, int H, int Hkv) {
  return hd >= 1 && hd <= kMaxD && vd >= 1 && vd <= kMaxD && Hkv >= 1 && H % Hkv == 0;
}

}  // namespace

// 16j.  q, qt (B, Sq, H, hd), k, kt (B, Sk, Hkv, hd), v, vt (B, Sk, Hkv, vd)
// and ot (B, Sq, H, vd) of one dtype (f32 or bf16), contiguous; lse, lse_t
// (B, H, Sq) f32.  window <= 0: no window.  Returns a CUDA error code.
extern "C" int launch_flash_attention_jvp(const void* q, const void* k, const void* v,
                                          const void* lse, const void* qt, const void* kt,
                                          const void* vt, void* ot, void* lse_t, int B, int Sq,
                                          int Sk, int H, int Hkv, int hd, int vd, int q_offset,
                                          int causal, int window, int dtype, float scale,
                                          int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!dims_ok(hd, vd, H, Hkv)) return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0 || H == 0) return (int)cudaGetLastError();
  const Dims d{B, Sq, Sk, H, Hkv, hd, vd, q_offset, causal, window, scale};
  cudaStream_t st = (cudaStream_t)stream;
  const float* l = (const float*)lse;
  float* lt = (float*)lse_t;
  if (dtype == kF32) return launch_fwd<float>(q, k, v, l, qt, kt, vt, ot, lt, d, st);
  if (dtype == kBF16) return launch_fwd<__nv_bfloat16>(q, k, v, l, qt, kt, vt, ot, lt, d, st);
  return (int)cudaErrorInvalidValue;
}

// 16bj.  q, qt, dq_t (B, Sq, H, hd), o, ot, dout, dout_t (B, Sq, H, vd), k,
// kt, dk_t (B, Sk, Hkv, hd), v, vt, dv_t (B, Sk, Hkv, vd) of one dtype (f32
// or bf16), contiguous; lse (B, H, Sq) f32; ``scratch`` f32 of 3 B H Sq
// floats (the rows' lse', D, D').  window <= 0: no window.  Returns a CUDA
// error code.
extern "C" int launch_flash_attention_bwd_jvp(
    const void* q, const void* k, const void* v, const void* o, const void* lse,
    const void* dout, const void* qt, const void* kt, const void* vt, const void* ot,
    const void* dout_t, void* dq_t, void* dk_t, void* dv_t, void* scratch, int B, int Sq, int Sk,
    int H, int Hkv, int hd, int vd, int q_offset, int causal, int window, int dtype, float scale,
    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!dims_ok(hd, vd, H, Hkv)) return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0 || H == 0) return (int)cudaGetLastError();
  const Dims d{B, Sq, Sk, H, Hkv, hd, vd, q_offset, causal, window, scale};
  cudaStream_t st = (cudaStream_t)stream;
  const float* l = (const float*)lse;
  float* rows = (float*)scratch;
  if (dtype == kF32)
    return launch_bwd<float>(q, k, v, o, l, dout, qt, kt, vt, ot, dout_t, dq_t, dk_t, dv_t, rows,
                             d, st);
  if (dtype == kBF16)
    return launch_bwd<__nv_bfloat16>(q, k, v, o, l, dout, qt, kt, vt, ot, dout_t, dq_t, dk_t,
                                     dv_t, rows, d, st);
  return (int)cudaErrorInvalidValue;
}
