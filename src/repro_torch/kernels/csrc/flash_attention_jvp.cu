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
//      then a key grid (key tile, b Hkv + hk, and on the tensor cores a
//      share of the query heads) walks the kv head's query heads and the
//      query tiles that see its keys and forms dk', dv'.
//
// What bounds them on an H100: operations.  Per (query, visible key) pair
// and head, 16j takes 3 products of length hd (S, and S' as two) and 3 of
// length vd (P S' v, P v', P v); 16bj's function takes S, S' (3 of hd), dP,
// dP' (3 of vd), dq', dk' (4 of hd) and dv' (2 of vd): 7 hd + 5 vd, 12 at
// hd = vd, 6 times the forward's 2.  At the training round's folded shape
// (8, 128, 16, 128) that is 3.3 GFLOP for 16bj, 3.4 us at the bf16
// tensor-core rate.
//
// Two routes, chosen by the wrapper from the dtype and the head dims
// (kernels/flash_attention.py jvp_route):
//
// * Warp tensor cores (namespace jm; bf16 with hd and vd multiples of 16,
//   every bf16 arch): mma.sync m16n8k16, bf16 operands, f32 accumulators,
//   operands from shared memory through ldmatrix (rows padded by 16 bytes),
//   the streamed tiles by cp.async in two stages where shared memory holds
//   them (one at hd = vd = 256 in 16bj's grids); the helpers are 16b's
//   (csrc/warp_mma.cuh).  Every score tile stays in registers; a warp owns
//   16 rows (or keys).
//   16j: blocks of 64 query rows, 32-key steps; S, S' on the tensor cores,
//     P = exp(S s - lse) and E = P S' s in registers, lse' their quad's row
//     sums in a fixed order; o and o'acc from P and E carried as two bf16
//     parts each, hi + lo (rounded once each, they move o' = o'acc - lse' o,
//     two terms that cancel, four times as far in the CPU model of
//     tests/test_torch_kernel_designs.py, too near the 2^-7 o' is held to);
//     with vd > 128 warp pairs split vd's columns
//     (o and o' of 16 rows at vd = 256 take 256 registers a thread).
//     3 hd + 6 vd products a pair (6 hd + 6 vd at vd > 128).
//   16bj row grid: blocks of 64 rows, 32-key steps.  At hd <= 128 one sweep:
//     with E = P S' s, P' = P (S' s - lse') gives dS' = F - lse' dS, F = E
//     (dP - D) + P (dP' - D'), so a warp sums X = F k + dS k' and Y = dS k
//     beside lse' and ends with dq' = s (X - lse' Y) (X and Y take hd
//     registers a thread); beyond, two sweeps, the first for lse' (S, S'
//     alone), the second forming dS' itself.  dS and F (dS') rounded to
//     bf16 before their products.  6 hd + 3 vd products a pair in one
//     sweep, 8 hd + 3 vd in two.
//   16bj key grid: blocks of 64 keys and a share of the kv head's query
//     heads (the wrapper splits them when the grid is small, dkdv_splits,
//     and attn::reduce_splits adds the f32 partials in split order), 32-row
//     query steps; warps 0-3 form dv' (S^T, S'^T, P^T, P'^T), warps 4-7 dk'
//     (also dP^T, dP'^T, dS^T, dS'^T), as 16b's warp route splits dv and
//     dk; P, P', dS, dS' rounded to bf16.  8 hd + 5 vd products a pair.
//   So 16bj runs 14 hd + 8 vd products a pair (16 hd + 8 vd beyond 128)
//   against the function's 7 hd + 5 vd: S and S' are formed in both grids
//   and by both roles of the key grid.
//
// * CUDA cores (f32, f32 products: not TF32, so the f32 path holds 1e-4;
//   and bf16 at head dims off a multiple of 16): tiles of BR query rows (32
//   up to hd, vd = 128, 16 beyond) and KC keys (32; 16 in the key grid and
//   16bj's row grid beyond 128: shared memory), each output element one
//   thread's sum over its tile in order.  16bj's row grid forms S and S' in
//   its lse' sweep and again in its dq' sweep, and the key grid forms S,
//   S', dP and dP' once more: 13 hd + 8 vd products a pair.
//
// Every sum runs in a fixed order (no atomics), so two runs agree bitwise.
// A row that sees no key gets tangents 0 (P = 0 there), as 16b gives it
// gradient 0.
#include <stdint.h>

#include "attention_tiles.cuh"  // visible(), CUDA-core tiles, carving, reduce_splits
#include "warp_mma.cuh"         // mma.sync tiles shared with 16b

namespace {

using attn::carve;
using attn::carved;
using attn::kThreads;
using attn::load_rows;
using attn::mm;
using attn::visible;

constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 256;  // hd and vd, as kernel 16 takes them
enum Route : int { kRouteCudaCores = 0, kRouteMma = 1 };

struct Dims {
  int B, Sq, Sk, H, Hkv, hd, vd, q_offset, causal, window;
  int splits;  // the tensor-core key grid's share of each kv head's query heads
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


// ---------------------------------------------------------------------------
// warp tensor-core route (bf16, hd and vd multiples of 16)
// ---------------------------------------------------------------------------
namespace jm {

using warp_mma::bf16;
using warp_mma::cp_commit;
using warp_mma::cp_wait;
using warp_mma::kPad;
using warp_mma::load_tile_async;
using warp_mma::nn_16xN;
using warp_mma::nt_16xN;
using warp_mma::to_a;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kRows = 64;   // query rows a 16j block and a row-grid block, 16 a warp
constexpr int kKeys = 64;   // keys a key-grid block, 16 a warp of either role
constexpr int kStep = 32;   // keys a 16j and a row-grid step; query rows a key-grid step
constexpr int kRowThreads = 128;  // the row grid's 4 warps
constexpr int kKeyThreads = 256;  // the key grid's 8: 4 for dv', 4 for dk'
constexpr int kWarpCols = 128;  // columns of a warp's accumulators (16j's share of vd; the
                                // row grid's X and Y in one sweep)
constexpr size_t kSmemMax = 232448;  // dynamic shared memory an H100 block may take
static_assert(kStep == 32, "the row and key grids' score tiles are 16 x 32: two k-steps");

// Shared-memory bytes of R rows of a pair of hd-wide and a pair of vd-wide
// bf16 tiles (k, k', v, v' or q, q', do, do'), rows padded by kPad.
size_t pair_bytes(const Dims& d, int R) {
  return (size_t)R * 2 * ((d.hd + kPad) + (d.vd + kPad)) * sizeof(bf16);
}

// Two stages of the streamed tiles where they fit beside the resident ones,
// else one (hd = vd = 256 in the row and key grids).
int stages(size_t fixed, size_t stage) { return 128 + fixed + 2 * stage <= kSmemMax ? 2 : 1; }

__device__ __forceinline__ void zero(float (*c)[4], int n) {
#pragma unroll
  for (int i = 0; i < n; ++i) c[i][0] = c[i][1] = c[i][2] = c[i][3] = 0.0f;
}

// A fragments of a D-layout tile of 2 KS n-tiles carried as two bf16 parts
// (16j's P and E): part 0 the rounded x, part 1 the rounding's remainder x -
// bf16(x) (exact in f32), rounded; hi + lo keeps 16 of x's 24 bits.
template <int KS>
__device__ __forceinline__ void to_a_part(uint32_t (*a)[4], const float (*x)[4], int part) {
  float y[2 * KS][4];
#pragma unroll
  for (int i = 0; i < 2 * KS; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      y[i][e] = part == 0 ? x[i][e] : x[i][e] - __bfloat162float(__float2bfloat16_rn(x[i][e]));
  to_a<KS>(a, y);
}

// The quad's four partial row sums (lanes 4g .. 4g + 3), added in a fixed
// order; every lane of the quad gets the same bits.
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// 16j.  Block (tile of 64 query rows, b H + h), NT = 128 threads, or 256
// when vd > 128: warp w owns rows 16 (w % 4) .. + 15 and share w / 4 of
// vd's columns (o and o' of 16 rows at vd = 256 would take 256 registers a
// thread).  q and q' stay in shared memory; k, k', v, v' tiles of 32 keys
// come through ``nst`` stages of cp.async.  Each step: S = q k^T and S' =
// q' k^T + q k'^T in registers (a warp pair forms its rows' both), P =
// exp(S s - lse), E = P S' s, lse' += row sums of E (each lane's in order,
// the quad's added at the end), then o += P v and o'acc += E v + P v' with
// P and E each as a bf16 hi + lo pair; at the end o' = o'acc - lse' o.
template <int NT>
__global__ void __launch_bounds__(NT, 1)
fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
           const float* __restrict__ lse, const bf16* __restrict__ qt, const bf16* __restrict__ kt,
           const bf16* __restrict__ vt, bf16* __restrict__ ot, float* __restrict__ lse_t, Dims d,
           int nst) {
  extern __shared__ uint8_t smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(aligned_smem(smem_raw));
  const int ldq = d.hd + kPad, ldv = d.vd + kPad;
  bf16* Qts = Qs + kRows * ldq;
  bf16* S0 = Qts + kRows * ldq;  // stage s at S0 + s stage: k, k', v, v'
  const int stage = kStep * (2 * ldq + 2 * ldv);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int rw = warp & 3, share = warp >> 2;
  const int cols0 = NT > 128 ? (d.vd + 31) / 32 * 16 : d.vd;  // share 0's columns
  const int c0 = share ? cols0 : 0, ncols = share ? d.vd - cols0 : cols0;
  const int q0 = blockIdx.x * kRows;
  const int bh = blockIdx.y, b = bh / d.H, h = bh % d.H;
  const int hk = h / (d.H / d.Hkv);
  const Heads hs(d);
  const long long qo = hs.q(d, b, h), ko = hs.k(d, b, hk), vo = hs.v(d, b, hk);
  load_tile_async<NT>(Qs, ldq, q + qo, hs.qs, q0, kRows, d.Sq, d.hd);  // committed with tile 0
  load_tile_async<NT>(Qts, ldq, qt + qo, hs.qs, q0, kRows, d.Sq, d.hd);
  int k_begin, k_end;
  key_range<kStep>(d, q0, kRows, k_begin, k_end);
  const int ntiles = k_end > k_begin ? (k_end - k_begin + kStep - 1) / kStep : 0;
  auto issue = [&](int j) {
    bf16* Ks = S0 + (j % nst) * stage;
    const int k0 = k_begin + j * kStep;
    load_tile_async<NT>(Ks, ldq, k + ko, hs.ks, k0, kStep, d.Sk, d.hd);
    load_tile_async<NT>(Ks + kStep * ldq, ldq, kt + ko, hs.ks, k0, kStep, d.Sk, d.hd);
    load_tile_async<NT>(Ks + 2 * kStep * ldq, ldv, v + vo, hs.vs, k0, kStep, d.Sk, d.vd);
    load_tile_async<NT>(Ks + 2 * kStep * ldq + kStep * ldv, ldv, vt + vo, hs.vs, k0, kStep,
                        d.Sk, d.vd);
    cp_commit();
  };

  const float scale_log2 = d.scale * kLog2e;
  const int r_lo = q0 + 16 * rw;  // this warp's first row
  const int pos_lo = d.q_offset + r_lo, pos_hi = d.q_offset + min(r_lo + 15, d.Sq - 1);
  float lrow[2], lt[2] = {0.0f, 0.0f};
  for (int half = 0; half < 2; ++half) {
    const int qi = r_lo + g + 8 * half;
    lrow[half] = qi < d.Sq ? lse[(long long)bh * d.Sq + qi] * kLog2e : 0.0f;
  }
  float o[kWarpCols / 8][4], oacc[kWarpCols / 8][4];  // sum P v; sum E v + P v'
  zero(o, kWarpCols / 8);
  zero(oacc, kWarpCols / 8);
  if (ntiles == 0) {
    cp_commit();
    cp_wait<0>();
  } else if (nst == 2) {
    issue(0);
  }
  for (int j = 0; j < ntiles; ++j) {
    if (nst == 1) {
      issue(j);
      cp_wait<0>();
    } else if (j + 1 < ntiles) {
      issue(j + 1);  // into the stage tile j - 1 used, which every warp has left
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();  // tile j's copies (and q, q' at j = 0) visible to every warp
    const int kt0 = k_begin + j * kStep;
    const bf16* Ks = S0 + (j % nst) * stage;
    const bf16* Kts = Ks + kStep * ldq;
    const bf16* Vs = Kts + kStep * ldq;
    const bf16* Vts = Vs + kStep * ldv;
    bool active = r_lo < d.Sq;
    if (d.causal) active = active && kt0 <= pos_hi;
    if (d.window > 0) active = active && kt0 + kStep - 1 > pos_lo - d.window;
    if (active) {
      float sc[kStep / 8][4], st[kStep / 8][4];
      zero(sc, kStep / 8);
      zero(st, kStep / 8);
      nt_16xN<kStep>(sc, Qs + 16 * rw * ldq, ldq, Ks, ldq, d.hd);   // S = q k^T
      nt_16xN<kStep>(st, Qts + 16 * rw * ldq, ldq, Ks, ldq, d.hd);  // S' = q' k^T
      nt_16xN<kStep>(st, Qs + 16 * rw * ldq, ldq, Kts, ldq, d.hd);  //    + q k'^T
#pragma unroll
      for (int i = 0; i < kStep / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int half = e >> 1, qi = r_lo + g + 8 * half;
          const int key = kt0 + 8 * i + 2 * t + (e & 1);
          const bool ok = qi < d.Sq && visible(d.q_offset + qi, key, d.Sk, d.causal, d.window);
          const float p = ok ? exp2f(sc[i][e] * scale_log2 - lrow[half]) : 0.0f;
          const float pe = p * (st[i][e] * d.scale);  // E = P S' s
          lt[half] += pe;
          sc[i][e] = p;
          st[i][e] = pe;
        }
      uint32_t a[kStep / 16][4];
#pragma unroll
      for (int part = 0; part < 2; ++part) {  // P's bf16 hi, then its lo
        to_a_part<kStep / 16>(a, sc, part);
        nn_16xN<kStep / 16, kWarpCols>(o, a, Vs + c0, ldv, ncols);      // o += P v
        nn_16xN<kStep / 16, kWarpCols>(oacc, a, Vts + c0, ldv, ncols);  // o'acc += P v'
      }
#pragma unroll
      for (int part = 0; part < 2; ++part) {  // E's
        to_a_part<kStep / 16>(a, st, part);
        nn_16xN<kStep / 16, kWarpCols>(oacc, a, Vs + c0, ldv, ncols);   //        + E v
      }
    }
    __syncthreads();  // every warp is done with stage j % nst before tile j + 2 lands there
  }
  for (int half = 0; half < 2; ++half) lt[half] = quad_sum(lt[half]);
  bf16* otb = ot + hs.o(d, b, h) + c0;
#pragma unroll
  for (int i = 0; i < kWarpCols / 8; ++i) {
    const int c = 8 * i + 2 * t;
    if (c >= ncols) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int qi = r_lo + g + 8 * half;
      if (qi < d.Sq)
        *reinterpret_cast<__nv_bfloat162*>(otb + qi * hs.os + c) = __floats2bfloat162_rn(
            oacc[i][2 * half] - lt[half] * o[i][2 * half],
            oacc[i][2 * half + 1] - lt[half] * o[i][2 * half + 1]);
    }
  }
  if (share == 0 && t == 0)
    for (int half = 0; half < 2; ++half) {
      const int qi = r_lo + g + 8 * half;
      if (qi < d.Sq) lse_t[(long long)bh * d.Sq + qi] = lt[half];
    }
}

// 16bj, the row grid: lse', D, D' (into scratch) and dq'.  Block (tile of 64
// query rows, b H + h), 4 warps of 16 rows; q, q', do, do' stay in shared
// memory, k, k', v, v' tiles of 32 keys come through ``nst`` stages.  Each
// step forms S, S' (q k^T, q' k^T + q k'^T), P = exp(S s - lse), dP = do
// v^T and dP' = do' v^T + do v'^T on the tensor cores, dS = P (dP - D).
// ONE (hd <= 128): one sweep.  With E = P S' s, P' = P (S' s - lse') gives
// dS' = F - lse' dS, F = E (dP - D) + P (dP' - D'); the warp accumulates
// X = sum F k + dS k' and Y = sum dS k beside lse' = sum E, and dq' = s (X -
// lse' Y) at the end (X and Y of 16 rows take hd registers a thread).
// Otherwise two sweeps: the first forms lse' (S, S' alone), the second dS'
// itself (E = P', F = dS') into X = sum dS' k + dS k'.  dS and F (or dS')
// are rounded to bf16 before their products.
template <bool ONE>
__global__ void __launch_bounds__(kRowThreads, 1)
rows_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
            const bf16* __restrict__ o, const float* __restrict__ lse,
            const bf16* __restrict__ dout, const bf16* __restrict__ qt,
            const bf16* __restrict__ kt, const bf16* __restrict__ vt,
            const bf16* __restrict__ ot, const bf16* __restrict__ dout_t, bf16* __restrict__ dq_t,
            float* __restrict__ rows_out, Dims d, int nst) {
  constexpr int MAXN = ONE ? kWarpCols : 256;  // X's columns: hd
  constexpr int NT = kRowThreads;
  extern __shared__ uint8_t smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(aligned_smem(smem_raw));
  const int ldq = d.hd + kPad, ldv = d.vd + kPad;
  bf16* Qts = Qs + kRows * ldq;
  bf16* dOs = Qts + kRows * ldq;
  bf16* dOts = dOs + kRows * ldv;
  float* Drow = reinterpret_cast<float*>(dOts + kRows * ldv);
  float* Dtrow = Drow + kRows;
  bf16* S0 = reinterpret_cast<bf16*>(Dtrow + kRows);  // stage s: k, k', v, v'
  const int stage = kStep * (2 * ldq + 2 * ldv);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kRows;
  const int bh = blockIdx.y, b = bh / d.H, h = bh % d.H;
  const int hk = h / (d.H / d.Hkv);
  const Heads hs(d);
  const long long qo = hs.q(d, b, h), oo = hs.o(d, b, h);
  const long long ko = hs.k(d, b, hk), vo = hs.v(d, b, hk);
  load_tile_async<NT>(Qs, ldq, q + qo, hs.qs, q0, kRows, d.Sq, d.hd);  // committed with tile 0
  load_tile_async<NT>(Qts, ldq, qt + qo, hs.qs, q0, kRows, d.Sq, d.hd);
  load_tile_async<NT>(dOs, ldv, dout + oo, hs.os, q0, kRows, d.Sq, d.vd);
  load_tile_async<NT>(dOts, ldv, dout_t + oo, hs.os, q0, kRows, d.Sq, d.vd);
  // D = do . o and D' = do' . o + do . o': one warp a row, lanes over
  // columns, a fixed tree
  for (int r = warp; r < kRows; r += NT / 32) {
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
      Drow[r] = s;
      Dtrow[r] = st;
    }
  }
  __syncthreads();
  const int r_lo = q0 + 16 * warp;  // this warp's first row
  float lrow[2], Dr[2], Dtr[2], lt[2] = {0.0f, 0.0f};
  for (int half = 0; half < 2; ++half) {
    const int r = 16 * warp + g + 8 * half, qi = q0 + r;
    lrow[half] = qi < d.Sq ? lse[(long long)bh * d.Sq + qi] * kLog2e : 0.0f;
    Dr[half] = Drow[r];
    Dtr[half] = Dtrow[r];
  }

  int k_begin, k_end;
  key_range<kStep>(d, q0, kRows, k_begin, k_end);
  const int ntiles = k_end > k_begin ? (k_end - k_begin + kStep - 1) / kStep : 0;
  const int total = ONE ? ntiles : 2 * ntiles;  // two sweeps: j < ntiles forms lse' alone
  auto issue = [&](int j) {
    bf16* Ks = S0 + (j % nst) * stage;
    const int k0 = k_begin + (j % ntiles) * kStep;
    load_tile_async<NT>(Ks, ldq, k + ko, hs.ks, k0, kStep, d.Sk, d.hd);
    load_tile_async<NT>(Ks + kStep * ldq, ldq, kt + ko, hs.ks, k0, kStep, d.Sk, d.hd);
    if (ONE || j >= ntiles) {
      load_tile_async<NT>(Ks + 2 * kStep * ldq, ldv, v + vo, hs.vs, k0, kStep, d.Sk, d.vd);
      load_tile_async<NT>(Ks + 2 * kStep * ldq + kStep * ldv, ldv, vt + vo, hs.vs, k0, kStep,
                          d.Sk, d.vd);
    }
    cp_commit();
  };

  const float scale_log2 = d.scale * kLog2e;
  const int pos_lo = d.q_offset + r_lo, pos_hi = d.q_offset + min(r_lo + 15, d.Sq - 1);
  float X[MAXN / 8][4], Y[ONE ? MAXN / 8 : 1][4];
  zero(X, MAXN / 8);
  zero(Y, ONE ? MAXN / 8 : 1);
  if (total == 0) {
    cp_commit();
    cp_wait<0>();
  } else if (nst == 2) {
    issue(0);
  }
  for (int j = 0; j < total; ++j) {
    if (nst == 1) {
      issue(j);
      cp_wait<0>();
    } else if (j + 1 < total) {
      issue(j + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    if (!ONE && j == ntiles)
      for (int half = 0; half < 2; ++half) lt[half] = quad_sum(lt[half]);  // lse' known
    const bool full = ONE || j >= ntiles;
    const int kt0 = k_begin + (j % ntiles) * kStep;
    const bf16* Ks = S0 + (j % nst) * stage;
    const bf16* Kts = Ks + kStep * ldq;
    const bf16* Vs = Kts + kStep * ldq;
    const bf16* Vts = Vs + kStep * ldv;
    bool active = r_lo < d.Sq;
    if (d.causal) active = active && kt0 <= pos_hi;
    if (d.window > 0) active = active && kt0 + kStep - 1 > pos_lo - d.window;
    if (active) {
      float sc[4][4], st[4][4];
      zero(sc, 4);
      zero(st, 4);
      nt_16xN<32>(sc, Qs + 16 * warp * ldq, ldq, Ks, ldq, d.hd);   // S = q k^T
      nt_16xN<32>(st, Qts + 16 * warp * ldq, ldq, Ks, ldq, d.hd);  // S' = q' k^T
      nt_16xN<32>(st, Qs + 16 * warp * ldq, ldq, Kts, ldq, d.hd);  //    + q k'^T
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int half = e >> 1, qi = r_lo + g + 8 * half;
          const int key = kt0 + 8 * i + 2 * t + (e & 1);
          const bool ok = qi < d.Sq && visible(d.q_offset + qi, key, d.Sk, d.causal, d.window);
          const float p = ok ? exp2f(sc[i][e] * scale_log2 - lrow[half]) : 0.0f;
          const float s1 = st[i][e] * d.scale;
          if (ONE || !full) lt[half] += p * s1;  // lse' = sum P S' s
          sc[i][e] = p;
          st[i][e] = ONE ? p * s1 : p * (s1 - lt[half]);  // E (one sweep) or P'
        }
      if (full) {
        float dp[4][4];
        zero(dp, 4);
        nt_16xN<32>(dp, dOs + 16 * warp * ldv, ldv, Vs, ldv, d.vd);  // dP = do v^T
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = dp[i][e] - Dr[e >> 1];
            dp[i][e] = sc[i][e] * x;  // dS
            st[i][e] *= x;
          }
        uint32_t dsa[2][4], fa[2][4];
        to_a<2>(dsa, dp);
        zero(dp, 4);
        nt_16xN<32>(dp, dOts + 16 * warp * ldv, ldv, Vs, ldv, d.vd);  // dP' = do' v^T
        nt_16xN<32>(dp, dOs + 16 * warp * ldv, ldv, Vts, ldv, d.vd);  //     + do v'^T
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[i][e] += sc[i][e] * (dp[i][e] - Dtr[e >> 1]);  // F, dS'
        to_a<2>(fa, st);
        nn_16xN<2, MAXN>(X, fa, Ks, ldq, d.hd);    // X += F k (dS' k)
        nn_16xN<2, MAXN>(X, dsa, Kts, ldq, d.hd);  //    + dS k'
        if constexpr (ONE) nn_16xN<2, MAXN>(Y, dsa, Ks, ldq, d.hd);  // Y += dS k
      }
    }
    __syncthreads();
  }
  if constexpr (ONE)
    for (int half = 0; half < 2; ++half) lt[half] = quad_sum(lt[half]);
  bf16* dqb = dq_t + qo;
#pragma unroll
  for (int i = 0; i < MAXN / 8; ++i) {
    const int c = 8 * i + 2 * t;
    if (c >= d.hd) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int qi = r_lo + g + 8 * half;
      if (qi >= d.Sq) continue;
      float x0 = X[i][2 * half], x1 = X[i][2 * half + 1];
      if constexpr (ONE) {
        x0 -= lt[half] * Y[i][2 * half];
        x1 -= lt[half] * Y[i][2 * half + 1];
      }
      *reinterpret_cast<__nv_bfloat162*>(dqb + qi * hs.qs + c) =
          __floats2bfloat162_rn(x0 * d.scale, x1 * d.scale);
    }
  }
  // the rows' lse', D, D' for the key grid: three (B H Sq) planes
  const long long plane = (long long)d.B * d.H * d.Sq;
  if (t == 0)
    for (int half = 0; half < 2; ++half) {
      const int qi = r_lo + g + 8 * half;
      if (qi < d.Sq) {
        const long long i = (long long)bh * d.Sq + qi;
        rows_out[i] = lt[half];
        rows_out[plane + i] = Dr[half];
        rows_out[2 * plane + i] = Dtr[half];
      }
    }
}

// 16bj, the key grid: dk', dv'.  Block (tile of 64 keys, b Hkv + hk, split
// z: its share of the kv head's query heads, ``dkdv_splits``); k, k', v, v'
// stay in shared memory, and the query tiles of 32 rows of the share's
// heads that see the block's keys come through ``nst`` stages with their
// lse, lse', D, D' rows.  Warps 0-3 form dv' for 16 keys each, warps 4-7
// dk' for the same keys (as 16b's warp route splits dv and dk): the
// transposed S^T = k q^T, S'^T = k q'^T + k' q^T, P^T and P'^T = P^T (S'^T
// s - lse'); dv' += P'^T do + P^T do'; the dk' warps also dP^T = v do^T,
// dP'^T = v do'^T + v' do^T, dS^T and dS'^T = P'^T (dP^T - D) + P^T (dP'^T
// - D'), dk' += dS'^T q + dS^T q'; each A operand rounded to bf16.  One
// split writes dk' (scaled) and dv'; more write f32 partials, which
// attn::reduce_splits adds in split order.
__global__ void __launch_bounds__(kKeyThreads, 1)
keys_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
            const float* __restrict__ lse, const bf16* __restrict__ dout,
            const bf16* __restrict__ qt, const bf16* __restrict__ kt,
            const bf16* __restrict__ vt, const bf16* __restrict__ dout_t,
            const float* __restrict__ rows_in, bf16* __restrict__ dk_t, bf16* __restrict__ dv_t,
            float* __restrict__ part, Dims d, int nst) {
  constexpr int NT = kKeyThreads;
  extern __shared__ uint8_t smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(aligned_smem(smem_raw));
  const int ldq = d.hd + kPad, ldv = d.vd + kPad;
  bf16* Kts = Ks + kKeys * ldq;
  bf16* Vs = Kts + kKeys * ldq;
  bf16* Vts = Vs + kKeys * ldv;
  uint8_t* S0 = reinterpret_cast<uint8_t*>(Vts + kKeys * ldv);  // stage s: q, q', do, do', rows
  const size_t stage =
      (size_t)kStep * (2 * ldq + 2 * ldv) * sizeof(bf16) + 4 * kStep * sizeof(float);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const bool dk_role = warp >= 4;
  const int kw = warp & 3;
  const int k0 = blockIdx.x * kKeys;
  const int bhk = blockIdx.y, b = bhk / d.Hkv, hk = bhk % d.Hkv;
  const int G = d.H / d.Hkv, gps = (G + d.splits - 1) / d.splits;
  const int g_lo = blockIdx.z * gps, g_hi = min(G, g_lo + gps);
  const Heads hs(d);
  const long long ko = hs.k(d, b, hk), vo = hs.v(d, b, hk);
  load_tile_async<NT>(Ks, ldq, k + ko, hs.ks, k0, kKeys, d.Sk, d.hd);  // committed with tile 0
  load_tile_async<NT>(Kts, ldq, kt + ko, hs.ks, k0, kKeys, d.Sk, d.hd);
  load_tile_async<NT>(Vs, ldv, v + vo, hs.vs, k0, kKeys, d.Sk, d.vd);
  load_tile_async<NT>(Vts, ldv, vt + vo, hs.vs, k0, kKeys, d.Sk, d.vd);

  const int kw0 = k0 + 16 * kw;  // this warp's first key
  const int k_last = min(k0 + kKeys, d.Sk) - 1;
  int i_begin = d.causal ? max(0, k0 - d.q_offset) : 0;
  i_begin = (i_begin / kStep) * kStep;
  const int i_end = d.window > 0 ? min(d.Sq, k_last + d.window - d.q_offset) : d.Sq;
  const int nt = i_end > i_begin ? (i_end - i_begin + kStep - 1) / kStep : 0;
  const int total = g_hi > g_lo ? (g_hi - g_lo) * nt : 0;
  const long long plane = (long long)d.B * d.H * d.Sq;

  auto issue = [&](int j) {  // tile j: query head hk G + g_lo + j / nt, rows from q0
    const int h = hk * G + g_lo + j / nt, q0 = i_begin + (j % nt) * kStep;
    bf16* Qd = reinterpret_cast<bf16*>(S0 + (j % nst) * stage);
    const long long qo = hs.q(d, b, h), oo = hs.o(d, b, h);
    load_tile_async<NT>(Qd, ldq, q + qo, hs.qs, q0, kStep, d.Sq, d.hd);
    load_tile_async<NT>(Qd + kStep * ldq, ldq, qt + qo, hs.qs, q0, kStep, d.Sq, d.hd);
    load_tile_async<NT>(Qd + 2 * kStep * ldq, ldv, dout + oo, hs.os, q0, kStep, d.Sq, d.vd);
    load_tile_async<NT>(Qd + 2 * kStep * ldq + kStep * ldv, ldv, dout_t + oo, hs.os, q0, kStep,
                        d.Sq, d.vd);
    float* rows = reinterpret_cast<float*>(Qd + 2 * kStep * (ldq + ldv));
    const long long bh = (long long)b * d.H + h;
    for (int r = tid; r < kStep; r += NT) {
      const bool in = q0 + r < d.Sq;
      const long long i = bh * d.Sq + q0 + r;
      rows[r] = in ? lse[i] * kLog2e : 0.0f;
      rows[kStep + r] = in ? rows_in[i] : 0.0f;              // lse'
      rows[2 * kStep + r] = in ? rows_in[plane + i] : 0.0f;  // D
      rows[3 * kStep + r] = in ? rows_in[2 * plane + i] : 0.0f;  // D'
    }
    cp_commit();
  };

  const float scale_log2 = d.scale * kLog2e;
  const int ncols = dk_role ? d.hd : d.vd;
  float acc[32][4];
  zero(acc, 32);
  if (total == 0) {
    cp_commit();
    cp_wait<0>();
  } else if (nst == 2) {
    issue(0);
  }
  for (int j = 0; j < total; ++j) {
    if (nst == 1) {
      issue(j);
      cp_wait<0>();
    } else if (j + 1 < total) {
      issue(j + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();  // tile j's copies and rows (and k, k', v, v' at j = 0) visible
    const int q0 = i_begin + (j % nt) * kStep;
    const bf16* Qs = reinterpret_cast<const bf16*>(S0 + (j % nst) * stage);
    const bf16* Qts = Qs + kStep * ldq;
    const bf16* dOs = Qts + kStep * ldq;
    const bf16* dOts = dOs + kStep * ldv;
    const float* rowl = reinterpret_cast<const float*>(dOts + kStep * ldv);
    const float* rowlt = rowl + kStep;
    const float* rowd = rowlt + kStep;
    const float* rowdt = rowd + kStep;
    const int qp0 = d.q_offset + q0;
    bool active = kw0 < d.Sk;
    if (d.causal) active = active && qp0 + kStep - 1 >= kw0;
    if (d.window > 0) active = active && kw0 + 15 > qp0 - d.window;
    if (active) {
      float sc[4][4], st[4][4];
      zero(sc, 4);
      zero(st, 4);
      nt_16xN<32>(sc, Ks + 16 * kw * ldq, ldq, Qs, ldq, d.hd);   // S^T = k q^T
      nt_16xN<32>(st, Ks + 16 * kw * ldq, ldq, Qts, ldq, d.hd);  // S'^T = k q'^T
      nt_16xN<32>(st, Kts + 16 * kw * ldq, ldq, Qs, ldq, d.hd);  //      + k' q^T
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kw0 + g + 8 * (e >> 1), c = 8 * i + 2 * t + (e & 1), qi = q0 + c;
          const bool ok = qi < d.Sq && visible(d.q_offset + qi, key, d.Sk, d.causal, d.window);
          const float p = ok ? exp2f(sc[i][e] * scale_log2 - rowl[c]) : 0.0f;
          sc[i][e] = p;                                    // P^T
          st[i][e] = p * (st[i][e] * d.scale - rowlt[c]);  // P'^T
        }
      if (dk_role) {
        float dp[4][4];
        zero(dp, 4);
        nt_16xN<32>(dp, Vs + 16 * kw * ldv, ldv, dOs, ldv, d.vd);  // dP^T = v do^T
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = dp[i][e] - rowd[8 * i + 2 * t + (e & 1)];
            dp[i][e] = sc[i][e] * x;  // dS^T
            st[i][e] *= x;
          }
        uint32_t dsa[2][4], da[2][4];
        to_a<2>(dsa, dp);
        zero(dp, 4);
        nt_16xN<32>(dp, Vs + 16 * kw * ldv, ldv, dOts, ldv, d.vd);  // dP'^T = v do'^T
        nt_16xN<32>(dp, Vts + 16 * kw * ldv, ldv, dOs, ldv, d.vd);  //       + v' do^T
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            st[i][e] += sc[i][e] * (dp[i][e] - rowdt[8 * i + 2 * t + (e & 1)]);  // dS'^T
        to_a<2>(da, st);
        nn_16xN<2, 256>(acc, da, Qs, ldq, d.hd);    // dk' += dS'^T q
        nn_16xN<2, 256>(acc, dsa, Qts, ldq, d.hd);  //     + dS^T q'
      } else {
        uint32_t pa[2][4], pta[2][4];
        to_a<2>(pa, sc);
        to_a<2>(pta, st);
        nn_16xN<2, 256>(acc, pta, dOs, ldv, d.vd);  // dv' += P'^T do
        nn_16xN<2, 256>(acc, pa, dOts, ldv, d.vd);  //     + P^T do'
      }
    }
    __syncthreads();  // every warp is done with stage j % nst before tile j + 2 lands there
  }
  const float mult = dk_role ? d.scale : 1.0f;
  const int dim = dk_role ? d.hd : d.vd;
  const long long stride = dk_role ? hs.ks : hs.vs;
  const long long col0 = (long long)hk * dim;
  const long long nk = (long long)d.B * d.Sk * hs.ks, nv = (long long)d.B * d.Sk * hs.vs;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int c = 8 * i + 2 * t;
    if (c >= ncols) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int key = kw0 + g + 8 * half;
      if (key >= d.Sk) continue;
      const long long at = ((long long)b * d.Sk + key) * stride + col0 + c;
      if (d.splits == 1) {
        bf16* out = dk_role ? dk_t : dv_t;
        *reinterpret_cast<__nv_bfloat162*>(out + at) = __floats2bfloat162_rn(
            acc[i][2 * half] * mult, acc[i][2 * half + 1] * mult);
      } else {
        float* pz = dk_role ? part + blockIdx.z * nk : part + d.splits * nk + blockIdx.z * nv;
        pz[at] = acc[i][2 * half];
        pz[at + 1] = acc[i][2 * half + 1];
      }
    }
  }
}

int launch_fwd(const void* q, const void* k, const void* v, const float* lse, const void* qt,
               const void* kt, const void* vt, void* ot, float* lse_t, const Dims& d,
               cudaStream_t st) {
  const size_t fixed = (size_t)kRows * 2 * (d.hd + kPad) * sizeof(bf16);
  const size_t stage = pair_bytes(d, kStep);
  const int nst = stages(fixed, stage);
  const size_t smem = 128 + fixed + nst * stage;
  auto kern = d.vd > kWarpCols ? fwd_kernel<256> : fwd_kernel<128>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((d.Sq + kRows - 1) / kRows), (unsigned)(d.B * d.H));
  kern<<<grid, d.vd > kWarpCols ? 256 : 128, smem, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, lse, (const bf16*)qt, (const bf16*)kt,
      (const bf16*)vt, (bf16*)ot, lse_t, d, nst);
  return (int)cudaGetLastError();
}


int launch_bwd(const void* q, const void* k, const void* v, const void* o, const float* lse,
               const void* dout, const void* qt, const void* kt, const void* vt, const void* ot,
               const void* dout_t, void* dq_t, void* dk_t, void* dv_t, float* rows, float* part,
               const Dims& d, cudaStream_t st) {
  const size_t f1 = pair_bytes(d, kRows) + 2 * kRows * sizeof(float), s1 = pair_bytes(d, kStep);
  const size_t f2 = pair_bytes(d, kKeys), s2 = pair_bytes(d, kStep) + 4 * kStep * sizeof(float);
  const int n1 = stages(f1, s1), n2 = stages(f2, s2);
  const size_t m1 = 128 + f1 + n1 * s1, m2 = 128 + f2 + n2 * s2;
  auto rows_k = d.hd <= kWarpCols ? rows_kernel<true> : rows_kernel<false>;
  cudaError_t err = allow_smem(rows_k, m1);
  if (err == cudaSuccess) err = allow_smem(keys_kernel, m2);
  if (err != cudaSuccess) return (int)err;
  dim3 g1((unsigned)((d.Sq + kRows - 1) / kRows), (unsigned)(d.B * d.H));
  rows_k<<<g1, kRowThreads, m1, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)o, lse, (const bf16*)dout,
      (const bf16*)qt, (const bf16*)kt, (const bf16*)vt, (const bf16*)ot, (const bf16*)dout_t,
      (bf16*)dq_t, rows, d, n1);
  err = cudaGetLastError();
  if (err != cudaSuccess || d.Sk == 0) return (int)err;
  dim3 g2((unsigned)((d.Sk + kKeys - 1) / kKeys), (unsigned)(d.B * d.Hkv), (unsigned)d.splits);
  keys_kernel<<<g2, kKeyThreads, m2, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, lse, (const bf16*)dout, (const bf16*)qt,
      (const bf16*)kt, (const bf16*)vt, (const bf16*)dout_t, rows, (bf16*)dk_t, (bf16*)dv_t, part,
      d, n2);
  err = cudaGetLastError();
  if (err != cudaSuccess || d.splits == 1) return (int)err;
  const long long nk = (long long)d.B * d.Sk * d.Hkv * d.hd;
  const long long nv = (long long)d.B * d.Sk * d.Hkv * d.vd;
  return (int)attn::launch_reduce_splits<bf16>(part, (bf16*)dk_t, (bf16*)dv_t, nk, nv, d.splits,
                                               d.scale, st);
}

}  // namespace jm

}  // namespace

// 16j.  q, qt (B, Sq, H, hd), k, kt (B, Sk, Hkv, hd), v, vt (B, Sk, Hkv, vd)
// and ot (B, Sq, H, vd) of one dtype (f32 or bf16), contiguous; lse, lse_t
// (B, H, Sq) f32.  window <= 0: no window.  Returns a CUDA error code.
extern "C" int launch_flash_attention_jvp(const void* q, const void* k, const void* v,
                                          const void* lse, const void* qt, const void* kt,
                                          const void* vt, void* ot, void* lse_t, int B, int Sq,
                                          int Sk, int H, int Hkv, int hd, int vd, int q_offset,
                                          int causal, int window, int dtype, int route,
                                          float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!dims_ok(hd, vd, H, Hkv)) return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0 || H == 0) return (int)cudaGetLastError();
  const Dims d{B, Sq, Sk, H, Hkv, hd, vd, q_offset, causal, window, 1, scale};
  cudaStream_t st = (cudaStream_t)stream;
  const float* l = (const float*)lse;
  float* lt = (float*)lse_t;
  if (route == kRouteMma) {
    if (dtype != kBF16 || hd % 16 != 0 || vd % 16 != 0) return (int)cudaErrorInvalidValue;
    return jm::launch_fwd(q, k, v, l, qt, kt, vt, ot, lt, d, st);
  }
  if (route != kRouteCudaCores) return (int)cudaErrorInvalidValue;
  if (dtype == kF32) return launch_fwd<float>(q, k, v, l, qt, kt, vt, ot, lt, d, st);
  if (dtype == kBF16) return launch_fwd<__nv_bfloat16>(q, k, v, l, qt, kt, vt, ot, lt, d, st);
  return (int)cudaErrorInvalidValue;
}

// 16bj.  q, qt, dq_t (B, Sq, H, hd), o, ot, dout, dout_t (B, Sq, H, vd), k,
// kt, dk_t (B, Sk, Hkv, hd), v, vt, dv_t (B, Sk, Hkv, vd) of one dtype (f32
// or bf16), contiguous; lse (B, H, Sq) f32; ``scratch`` f32 of 3 B H Sq
// floats (the rows' lse', D, D'), then, when ``splits`` > 1 (the tensor-core
// route only), splits B Sk Hkv (hd + vd) for the key grid's partials.
// window <= 0: no window.  Returns a CUDA error code.
extern "C" int launch_flash_attention_bwd_jvp(
    const void* q, const void* k, const void* v, const void* o, const void* lse,
    const void* dout, const void* qt, const void* kt, const void* vt, const void* ot,
    const void* dout_t, void* dq_t, void* dk_t, void* dv_t, void* scratch, int B, int Sq, int Sk,
    int H, int Hkv, int hd, int vd, int splits, int q_offset, int causal, int window, int dtype,
    int route, float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!dims_ok(hd, vd, H, Hkv) || splits < 1 || splits > H / Hkv)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0 || H == 0) return (int)cudaGetLastError();
  const Dims d{B, Sq, Sk, H, Hkv, hd, vd, q_offset, causal, window, splits, scale};
  cudaStream_t st = (cudaStream_t)stream;
  const float* l = (const float*)lse;
  float* rows = (float*)scratch;
  if (route == kRouteMma) {
    if (dtype != kBF16 || hd % 16 != 0 || vd % 16 != 0) return (int)cudaErrorInvalidValue;
    return jm::launch_bwd(q, k, v, o, l, dout, qt, kt, vt, ot, dout_t, dq_t, dk_t, dv_t, rows,
                          rows + 3LL * B * H * Sq, d, st);
  }
  if (route != kRouteCudaCores || splits != 1) return (int)cudaErrorInvalidValue;
  if (dtype == kF32)
    return launch_bwd<float>(q, k, v, o, l, dout, qt, kt, vt, ot, dout_t, dq_t, dk_t, dv_t, rows,
                             d, st);
  if (dtype == kBF16)
    return launch_bwd<__nv_bfloat16>(q, k, v, o, l, dout, qt, kt, vt, ot, dout_t, dq_t, dk_t,
                                     dv_t, rows, d, st);
  return (int)cudaErrorInvalidValue;
}
