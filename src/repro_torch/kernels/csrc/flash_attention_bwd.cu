// Kernel 16b: the backward of kernel 16 (causal GQA attention, optionally
// over a sliding window).  The reference has no backward kernel: its
// launcher differentiates the "xla" branch (src/repro/kernels/ops.py
// _flash_xla).  Given q (B, Sq, H, hd), k (B, Sk, Hkv, hd), v (B, Sk, Hkv,
// vd), the forward's output o (B, Sq, H, vd) and its per-row logsumexp lse
// (B, H, Sq) f32, and the incoming gradient do (B, Sq, H, vd), it returns
//
//   P   = exp(q k^T scale - lse)          (0 where a key is not visible)
//   D_i = sum_d do_id o_id
//   dv  = P^T do,   dS = P (do v^T - D),   dq = dS k scale,   dk = dS^T q scale
//
// with dk and dv summed over the H / Hkv query heads of each kv head.
// The scores are recomputed tile by tile from q, k and lse; nothing of size
// Sq x Sk is stored.  No float atomics: every sum runs in a fixed order, so
// a run repeats bitwise.
//
// What bounds it on an H100: operations.  Per (query, visible key) pair and
// head the function needs 5 products (S, dk, dq of length hd; dP, dv of
// length vd), 2.5 times the forward's 2 at hd = vd; at olmo-1b's prefill
// shape (4, 1024, 16, 128) bf16 that is 43 GFLOP, 43 us at the bf16
// tensor-core rate.  Only the tensor cores come near it.
//
// Three routes, chosen by the wrapper from the dtype and the head dims:
//
// * Tensor cores (bf16, hd = vd a multiple of 16 up to 128): two grids.
//
//   1. dq: one block per (b * H + h, tile of 128 query rows), heaviest
//      first, two warpgroups of 64 rows.  The block first forms D = do . o
//      for its rows (16-byte loads, two threads a row) and lse in log2
//      units, and writes both to scratch rows padded to a multiple of 64
//      for the dk/dv grid (pad rows: D = 0, lse = 1e30, so that P = 0
//      there).  q and do stay resident, k and v tiles of 64 keys come
//      through a ring of three stages (TMA boxes in the 128-byte swizzle,
//      each stage behind a full and an empty mbarrier); S = q k^T and dP =
//      do v^T (m64n64k16, both operands K-major in shared memory), dS
//      rounded to bf16 into A fragments, dq += dS k (m64nNk16, k MN-major).
//      The split keeps dq free of atomics.
//   2. dk, dv: one block per (b * Hkv + hk, tile of 128 keys), the
//      heaviest causal tiles (the first keys) launched first; two
//      warpgroups of 64 keys each.  The block's k and v tiles stay in
//      shared memory; q and do tiles of 64 query rows, with their lse and D
//      rows, stream through a ring of three stages (TMA and bulk copies),
//      for each of the G = H / Hkv query heads of the kv head and each
//      query tile that can see the block's keys.  Each warpgroup computes
//      the transposed scores S^T = k q^T and dP^T = v do^T with wgmma
//      m64n64k16, forms P^T = exp2(S^T scale log2 e - lse) and dS^T = P^T
//      (dP^T - D) on its f32 accumulators in registers, rounds both to bf16
//      straight into the A fragments of the next products (as the forward
//      rounds p), and accumulates dv += P^T do and dk += dS^T q with wgmma
//      m64nNk16, A from registers, B MN-major in shared memory (N = 64 for
//      hd <= 64, else 128).  No score tile passes through shared memory
//      (FlashAttention-2/3's transposed layout).
//
//   Thread 0 of each block issues the loads; there is no producer warp, so
//   the 256 threads may hold 255 registers each: the dk/dv grid keeps dk
//   and dv (64 x 128 f32 a warpgroup, 64 registers each a thread) plus S^T
//   and dP^T (32 each) in registers (231 registers at hd 128, no spills).
//   The design runs 7 products against the function's 5 (S and dP are
//   recomputed in the dq grid), 1.4x the bound's work.  Tiles past Sq or Sk
//   are zero-filled by TMA and masked; a query tile wholly masked for a
//   warpgroup's keys (or a key tile for a warpgroup's rows) is skipped, and
//   the mask is applied only on tiles that cross an edge.
//
//   Trials on an H100 (olmo-1b's prefill shape (4, 1024, 16, 128) and the
//   training round's (8, 128, 16, 128), bf16, ms, each pair in one
//   process): rings of three stages, 0.2198 at prefill, against two in the
//   dk/dv grid 0.2229 or in the dq grid 0.2221, level at the training shape
//   (0.0283); dq key tiles of 128 (two stages, m64n128 score products)
//   0.2113 against 0.2208 at prefill but 0.0296 against 0.0282 at the
//   training shape, whose 128 keys the causal mask halves, so 64 stays;
//   waiting on the score product alone and forming P while dP's product
//   runs (two commit groups) 0.2206 against 0.2207, no gain.  A separate
//   pass forming D took 17.5 us of 0.227 ms; the dq grid forms it now.
//   Refilling a stage from the last warp done with it (a shared counter)
//   rather than thread 0 waiting on the empty barrier: 0.2162 against
//   0.2186, 0.0284 against 0.0287, 1%, so it is not taken.  The
//   warpgroups taking turns on the tensor cores (named barriers; a turn
//   issues the tile before's dv, dk or dq with this tile's score products,
//   FlashAttention-3's ping-pong): 0.2858 against 0.2166 and 0.0339
//   against 0.0287, slower (250 registers in the dk/dv grid).  cuDNN's SDPA
//   backward takes 0.179 ms at prefill and 0.0326 at the training shape;
//   the work left to cut is the dq grid's recomputed S and dP (7 products
//   to the function's 5).
//
// * Warp tensor cores (bf16, hd and vd multiples of 16 up to 256 that the
//   wgmma route does not take: hd != vd or above 128; MLA's 192 / 128,
//   recurrentgemma's 256, stablelm's 160): the same two grids on
//   mma.sync m16n8k16 (bf16 in, f32 accumulators), operands from shared
//   memory through ldmatrix (rows padded by 16 bytes: no bank conflict), P
//   and dS rounded to bf16 into A fragments in registers as on wgmma (the
//   tile helpers in csrc/warp_mma.cuh, shared with 16j and 16bj).
//   1. dq: a block of 128 query rows, eight warps of 16, stepping over the
//      visible keys 64 at a time (S, dP, dq += dS k).
//   2. dk, dv: a block of 64 keys; warps 0-3 form dv for 16 keys each,
//      warps 4-7 dk for the same keys (both recompute S^T): dk and dv for
//      16 keys at hd = vd = 256 are 128 f32 registers a thread each, which
//      one thread cannot hold together.  The q and do tiles come through
//      two stages of cp.async, the next in flight during this one's
//      products.  Few kv heads split the query heads across blocks as on
//      the CUDA cores (3.).
//   dq's k and v tiles load between barriers (two stages would not fit
//   beside 128 rows of q and do at hd = vd = 256), and dq recomputes S and
//   dP: simple first (PERF.md has its times against cuDNN's).
//
// * CUDA cores (f32, or bf16 at head dims off a multiple of 16): up to
//   three grids, f32 products out of shared memory, tiles of BR query rows
//   (64 up to hd, vd = 128, 32 beyond: shared memory) and 32 keys.
//   1. dq: one block per (tile of BR query rows, b * H + h); it forms D for
//      its rows (and writes it to scratch), then walks the key tiles its
//      rows can see, accumulating dq in shared memory.
//   2. dk, dv: one block per (tile of 32 keys, b * Hkv + hk, split),
//      walking its split's query heads of the kv head's group and the
//      query tiles that can see its keys.  With few kv heads the (key
//      tile, b * Hkv) grid is small (8 blocks for recurrentgemma's one kv
//      head at the training round's (8, 128)), so the wrapper splits the
//      group's query heads across blocks (``splits``, chosen from the SM
//      count): each split writes f32 partials, and
//   3. reduce_splits (csrc/attention_tiles.cuh) adds them in split order,
//      no atomics.
//   The f32 route keeps f32 products (not TF32), so it holds the 1e-4 f32
//   comparisons; bf16 operands are widened to f32, so P and dS are not
//   rounded to bf16 as on the tensor cores.  This route is simple and slow
//   (one f32 multiply-add per two shared-memory loads, no register tiles).
#include "common.cuh"

#include <stdint.h>

#include "attention_tiles.cuh"  // visible(), the CUDA-core route's tile helpers
#include "hopper.cuh"  // TMA, mbarrier and wgmma helpers shared with kernel 16
#include "warp_mma.cuh"  // mma.sync tiles shared with 16j and 16bj

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxD = 256;     // hd and vd, as kernel 16 takes them
constexpr int kTcMaxD = 128;   // the wgmma route: hd = vd <= 128
enum Route : int { kRouteCudaCores = 0, kRouteWgmma = 1, kRouteMma = 2 };

using attn::visible;

struct Dims {
  int B, Sq, Sk, H, Hkv, hd, vd, q_offset, causal, window, splits;
  float scale;
};

// ---------------------------------------------------------------------------
// tensor-core route
// ---------------------------------------------------------------------------
namespace tc {

using namespace hopper;

constexpr int kThreads = 256;   // two warpgroups; thread 0 also issues the loads
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;      // depth of the dk/dv grid's q/do ring
constexpr int kRowsPad = 64;    // scratch rows are padded to a multiple of this
constexpr float kPadLse = 1e30f;
// dk/dv grid
constexpr int kKeys = 128;      // keys per block, 64 a warpgroup
constexpr int kQRows = 64;      // query rows per streamed tile
// dq grid
constexpr int kRows = 128;      // query rows per block, 64 a warpgroup
constexpr int kKTile = 64;      // keys per streamed tile
constexpr int kKStages = 3;     // depth of the dq grid's k/v ring

__host__ __device__ constexpr int box_bytes(int hdb, int rows) { return hdb * rows * kRowBytes; }

size_t dkdv_smem(int hdb) {
  return 1024 + 2 * box_bytes(hdb, kKeys) + kStages * 2 * box_bytes(hdb, kQRows) +
         kStages * 2 * kQRows * sizeof(float) + (2 * kStages + 1) * sizeof(uint64_t);
}
size_t dq_smem(int hdb) {
  return 1024 + 2 * box_bytes(hdb, kRows) + kKStages * 2 * box_bytes(hdb, kKTile) +
         2 * kRows * sizeof(float) + (2 * kKStages + 1) * sizeof(uint64_t);
}

// Accumulator layout of wgmma m64nN (f32), thread t of a warpgroup, warp
// w = t / 32, lane l: register 4 i + e holds row 16 w + l / 4 + 8 (e / 2)
// and column 8 i + 2 (l % 4) + e % 2.  The A fragment of m64k16 from
// registers holds the same rows and, for k-step j, the columns of n8
// blocks 2 j and 2 j + 1: so a score tile's registers 8 j .. 8 j + 7,
// packed in pairs, are the A operand of the j-th step of the next product.

// 1. dk and dv.  Block (b * Hkv + hk, tile of 128 keys).
template <int HDB>
__global__ void __launch_bounds__(kThreads, 1)
dkdv_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
            const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
            const float* __restrict__ lse2, const float* __restrict__ Dv,
            __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int Sq, int Sq_pad,
            int Sk, int H, int Hkv, int hd, int q_offset, int causal, int window, float scale,
            float scale_log2) {
  constexpr int NV = 64 * HDB;  // columns of dk and dv
  constexpr int OREG = NV / 2;  // f32 registers a thread holds of each
  constexpr int KB = box_bytes(HDB, kKeys), QB = box_bytes(HDB, kQRows);
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);  // 1024-aligned: the swizzle atom
  uint8_t* ks = smem;
  uint8_t* vs = ks + KB;
  uint8_t* qs = vs + KB;                      // stage s: qs + 2 s QB (q), + QB (do)
  float* rowv = reinterpret_cast<float*>(qs + kStages * 2 * QB);  // stage s: lse, then D
  uint64_t* full = reinterpret_cast<uint64_t*>(rowv + kStages * 2 * kQRows);
  uint64_t* empty = full + kStages;
  uint64_t* kvbar = empty + kStages;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bhk = blockIdx.x, b = bhk / Hkv, hk = bhk % Hkv;
  const int G = H / Hkv;
  const int kt0 = blockIdx.y * kKeys;  // the first key tiles see the most queries
  const int k_last = min(kt0 + kKeys, Sk) - 1;
  int i_begin = causal ? max(0, kt0 - q_offset) : 0;
  i_begin = (i_begin / kQRows) * kQRows;
  const int i_end = window > 0 ? min(Sq, k_last + window - q_offset) : Sq;
  const int nt = i_end > i_begin ? (i_end - i_begin + kQRows - 1) / kQRows : 0;
  const int total = G * nt;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWarps);
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto issue = [&](int j) {  // tile j: query head hk G + j / nt, rows i_begin + 64 (j % nt)
    const int s = j % kStages, h = hk * G + j / nt, q0 = i_begin + (j % nt) * kQRows;
    uint8_t* qd = qs + s * 2 * QB;
    mbar_expect_tx(&full[s], 2 * QB + 2 * kQRows * sizeof(float));
    for (int c = 0; c < HDB; ++c) {
      tma_load_3d(qd + c * kQRows * kRowBytes, &tq, &full[s], h * hd + 64 * c, q0, b);
      tma_load_3d(qd + QB + c * kQRows * kRowBytes, &tdo, &full[s], h * hd + 64 * c, q0, b);
    }
    const size_t row = ((size_t)b * H + h) * Sq_pad + q0;
    bulk_load(rowv + s * 2 * kQRows, lse2 + row, kQRows * sizeof(float), &full[s]);
    bulk_load(rowv + s * 2 * kQRows + kQRows, Dv + row, kQRows * sizeof(float), &full[s]);
  };
  if (tid == 0) {
    mbar_expect_tx(kvbar, 2 * KB);
    for (int c = 0; c < HDB; ++c)
      for (int hh = 0; hh < kKeys / 64; ++hh) {
        const int off = c * kKeys * kRowBytes + hh * 64 * kRowBytes;
        tma_load_3d(ks + off, &tk, kvbar, hk * hd + 64 * c, kt0 + 64 * hh, b);
        tma_load_3d(vs + off, &tv, kvbar, hk * hd + 64 * c, kt0 + 64 * hh, b);
      }
    for (int j = 0; j < min(kStages, total); ++j) issue(j);
  }
  __syncwarp();

  // warpgroup wg owns keys kw0 .. kw0 + 63
  const int wg = warp >> 2;
  const int row_a = 16 * (warp & 3) + (lane >> 2);  // and row_a + 8
  const int quad = lane & 3;
  const int kw0 = kt0 + 64 * wg;
  const int key_a = kw0 + row_a, key_b = key_a + 8;
  float dka[OREG], dva[OREG];
#pragma unroll
  for (int i = 0; i < OREG; ++i) dka[i] = dva[i] = 0.0f;
  const uint32_t k_addr = smem_u32(ks) + wg * 64 * kRowBytes;
  const uint32_t v_addr = smem_u32(vs) + wg * 64 * kRowBytes;
  const int ksteps = hd / 16;

  mbar_wait(kvbar, 0);
  for (int j = 0; j < total; ++j) {
    const int s = j % kStages, q0 = i_begin + (j % nt) * kQRows;
    const int qp0 = q_offset + q0;  // position of the tile's first query
    mbar_wait(&full[s], (j / kStages) & 1);
    bool active = kw0 < Sk;
    if (causal) active = active && qp0 + kQRows - 1 >= kw0;
    if (window > 0) active = active && kw0 + 63 > qp0 - window;
    if (active) {
      const uint32_t q_addr = smem_u32(qs + s * 2 * QB), do_addr = q_addr + QB;
      const float* ls = rowv + s * 2 * kQRows;
      const float* dd = ls + kQRows;
      float st[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) st[i] = dp[i] = 0.0f;
      fence_regs<32>(st);
      fence_regs<32>(dp);
      wg_fence();
      for (int kk = 0; kk < ksteps; ++kk) {  // S^T = k q^T
        const uint32_t off = (kk & 3) * 32;
        wgmma_ss_n64(st, gmma_desc(k_addr + (kk >> 2) * kKeys * kRowBytes + off, 16, 1024),
                     gmma_desc(q_addr + (kk >> 2) * kQRows * kRowBytes + off, 16, 1024), kk > 0);
      }
      for (int kk = 0; kk < ksteps; ++kk) {  // dP^T = v do^T
        const uint32_t off = (kk & 3) * 32;
        wgmma_ss_n64(dp, gmma_desc(v_addr + (kk >> 2) * kKeys * kRowBytes + off, 16, 1024),
                     gmma_desc(do_addr + (kk >> 2) * kQRows * kRowBytes + off, 16, 1024), kk > 0);
      }
      wg_commit();
      wg_wait_all();
      fence_regs<32>(st);
      fence_regs<32>(dp);

      const bool need_mask = kw0 + 63 >= Sk || q0 + kQRows > Sq ||
                             (causal && kw0 + 63 > qp0) ||
                             (window > 0 && qp0 + kQRows - 1 - window >= kw0);
      uint32_t pf[kQRows / 16][4], sf[kQRows / 16][4];
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        const int col = 8 * (e >> 2) + 2 * quad;  // and col + 1: this pair's queries
        const int key = (e & 2) ? key_b : key_a;
        float p0 = exp2f(st[e] * scale_log2 - ls[col]);
        float p1 = exp2f(st[e + 1] * scale_log2 - ls[col + 1]);
        if (need_mask) {
          p0 = (q0 + col < Sq && visible(qp0 + col, key, Sk, causal, window)) ? p0 : 0.0f;
          p1 = (q0 + col + 1 < Sq && visible(qp0 + col + 1, key, Sk, causal, window)) ? p1 : 0.0f;
        }
        const float d0 = p0 * (dp[e] - dd[col]), d1 = p1 * (dp[e + 1] - dd[col + 1]);
        pf[e >> 3][(e & 7) >> 1] = pack_bf16(p0, p1);
        sf[e >> 3][(e & 7) >> 1] = pack_bf16(d0, d1);
      }
      fence_regs<OREG>(dva);
      fence_regs<OREG>(dka);
#pragma unroll
      for (int kk = 0; kk < kQRows / 16; ++kk) {
        fence_regs<4>(pf[kk]);
        fence_regs<4>(sf[kk]);
      }
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kQRows / 16; ++kk) {  // dv += P^T do, dk += dS^T q
        wgmma_rs<HDB>(dva, pf[kk], gmma_desc(do_addr + kk * 16 * kRowBytes,
                                             kQRows * kRowBytes, 1024));
        wgmma_rs<HDB>(dka, sf[kk], gmma_desc(q_addr + kk * 16 * kRowBytes,
                                             kQRows * kRowBytes, 1024));
      }
      wg_commit();
      wg_wait_all();
      fence_regs<OREG>(dva);
      fence_regs<OREG>(dka);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with the stage
    if (tid == 0 && j + kStages < total) {
      mbar_wait(&empty[s], (j / kStages) & 1);
      issue(j + kStages);
    }
    __syncwarp();
  }

  const long long row_stride = (long long)Hkv * hd;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = half ? key_b : key_a;
    if (key >= Sk) continue;
    const long long base = ((long long)b * Sk + key) * row_stride + (long long)hk * hd;
#pragma unroll
    for (int i = 0; i < NV / 8; ++i) {
      const int c = 8 * i + 2 * quad;
      if (c < hd) {
        *reinterpret_cast<__nv_bfloat162*>(dk + base + c) = __floats2bfloat162_rn(
            dka[4 * i + 2 * half] * scale, dka[4 * i + 2 * half + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + base + c) =
            __floats2bfloat162_rn(dva[4 * i + 2 * half], dva[4 * i + 2 * half + 1]);
      }
    }
  }
}

// 2. dq.  Block (b * H + h, tile of 128 query rows).
template <int HDB>
__global__ void __launch_bounds__(kThreads, 1)
dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
          const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
          const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
          const float* __restrict__ lse, float* __restrict__ lse2, float* __restrict__ Dv,
          __nv_bfloat16* __restrict__ dq, int Sq, int Sq_pad, int Sk, int H, int Hkv, int hd,
          int q_offset, int causal, int window, float scale, float scale_log2) {
  constexpr int NQ = 64 * HDB;  // columns of dq
  constexpr int QREG = NQ / 2;
  constexpr int RB = box_bytes(HDB, kRows), KB = box_bytes(HDB, kKTile);
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  uint8_t* qs = smem;
  uint8_t* dos = qs + RB;
  uint8_t* kvs = dos + RB;  // stage s: kvs + 2 s KB (k), + KB (v)
  float* rowl = reinterpret_cast<float*>(kvs + kKStages * 2 * KB);  // the block's lse rows
  float* rowd = rowl + kRows;                                         // and D rows
  uint64_t* full = reinterpret_cast<uint64_t*>(rowd + kRows);
  uint64_t* empty = full + kKStages;
  uint64_t* qbar = empty + kKStages;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // heaviest causal tiles first

  // the key range the block's rows can see
  const int qpos_lo = q_offset + q0;
  const int qpos_hi = q_offset + min(q0 + kRows, Sq) - 1;
  const int k_end = causal ? min(Sk, qpos_hi + 1) : Sk;
  int k_begin = window > 0 ? max(0, qpos_lo - window + 1) : 0;
  k_begin = (k_begin / kKTile) * kKTile;
  const int ntiles = k_end > k_begin ? (k_end - k_begin + kKTile - 1) / kKTile : 0;

  if (tid == 0) {
    for (int s = 0; s < kKStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWarps);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto issue = [&](int j) {
    const int s = j % kKStages, kt = k_begin + j * kKTile;
    uint8_t* kd = kvs + s * 2 * KB;
    mbar_expect_tx(&full[s], 2 * KB);
    for (int c = 0; c < HDB; ++c) {
      tma_load_3d(kd + c * kKTile * kRowBytes, &tk, &full[s], hk * hd + 64 * c, kt, b);
      tma_load_3d(kd + KB + c * kKTile * kRowBytes, &tv, &full[s], hk * hd + 64 * c, kt, b);
    }
  };
  if (tid == 0) {
    mbar_expect_tx(qbar, 2 * RB);
    for (int c = 0; c < HDB; ++c)
      for (int hh = 0; hh < kRows / 64; ++hh) {
        const int off = c * kRows * kRowBytes + hh * 64 * kRowBytes;
        tma_load_3d(qs + off, &tq, qbar, h * hd + 64 * c, q0 + 64 * hh, b);
        tma_load_3d(dos + off, &tdo, qbar, h * hd + 64 * c, q0 + 64 * hh, b);
      }
    for (int j = 0; j < min(kKStages, ntiles); ++j) issue(j);
  }
  __syncwarp();

  // D = do . o (two threads a row, 16-byte loads, a fixed order) and lse in
  // log2 units for the block's rows, also into the scratch rows the dk/dv
  // grid reads (rows past Sq: D = 0, lse = 1e30, so that P = 0 there)
  {
    const int r = tid >> 1, half = tid & 1, qi = q0 + r;
    float s = 0.0f;
    if (qi < Sq) {
      const size_t base = (((size_t)b * Sq + qi) * H + h) * hd;
#pragma unroll 4
      for (int c = 8 * half; c < hd; c += 16) {
        const uint4 ov = *reinterpret_cast<const uint4*>(o + base + c);
        const uint4 dv = *reinterpret_cast<const uint4*>(dout + base + c);
        const __nv_bfloat162* op = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* dp = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 x = __bfloat1622float2(dp[e]), y = __bfloat1622float2(op[e]);
          s = fmaf(x.x, y.x, s);
          s = fmaf(x.y, y.y, s);
        }
      }
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    if (half == 0) {
      const float d = qi < Sq ? s : 0.0f;
      const float l = qi < Sq ? lse[(size_t)bh * Sq + qi] * kLog2e : kPadLse;
      rowd[r] = d;
      rowl[r] = l;
      if (qi < Sq_pad) {
        Dv[(size_t)bh * Sq_pad + qi] = d;
        lse2[(size_t)bh * Sq_pad + qi] = l;
      }
    }
  }
  __syncthreads();

  // warpgroup wg owns query rows 64 wg .. 64 wg + 63 of the tile
  const int wg = warp >> 2;
  const int row_a = 16 * (warp & 3) + (lane >> 2);  // and row_a + 8
  const int quad = lane & 3;
  const int qa = q0 + 64 * wg + row_a, qb = qa + 8;
  const int pos_a = q_offset + qa, pos_b = pos_a + 8;
  const float lse_a = rowl[64 * wg + row_a], lse_b = rowl[64 * wg + row_a + 8];
  const float d_a = rowd[64 * wg + row_a], d_b = rowd[64 * wg + row_a + 8];
  const int wq_lo = q_offset + q0 + 64 * wg;
  const int wq_hi = min(wq_lo + 63, q_offset + Sq - 1);
  float dqa[QREG];
#pragma unroll
  for (int i = 0; i < QREG; ++i) dqa[i] = 0.0f;
  const uint32_t q_addr = smem_u32(qs) + wg * 64 * kRowBytes;
  const uint32_t do_addr = smem_u32(dos) + wg * 64 * kRowBytes;
  const int ksteps = hd / 16;

  mbar_wait(qbar, 0);
  for (int j = 0; j < ntiles; ++j) {
    const int s = j % kKStages, kt = k_begin + j * kKTile;
    mbar_wait(&full[s], (j / kKStages) & 1);
    bool active = wq_lo <= wq_hi;
    if (causal) active = active && kt <= wq_hi;
    if (window > 0) active = active && kt + kKTile - 1 > wq_lo - window;
    if (active) {
      const uint32_t k_addr = smem_u32(kvs + s * 2 * KB), v_addr = k_addr + KB;
      float sc[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.0f;
      fence_regs<32>(sc);
      fence_regs<32>(dp);
      wg_fence();
      for (int kk = 0; kk < ksteps; ++kk) {  // S = q k^T
        const uint32_t off = (kk & 3) * 32;
        wgmma_ss_n64(sc, gmma_desc(q_addr + (kk >> 2) * kRows * kRowBytes + off, 16, 1024),
                     gmma_desc(k_addr + (kk >> 2) * kKTile * kRowBytes + off, 16, 1024), kk > 0);
      }
      for (int kk = 0; kk < ksteps; ++kk) {  // dP = do v^T
        const uint32_t off = (kk & 3) * 32;
        wgmma_ss_n64(dp, gmma_desc(do_addr + (kk >> 2) * kRows * kRowBytes + off, 16, 1024),
                     gmma_desc(v_addr + (kk >> 2) * kKTile * kRowBytes + off, 16, 1024), kk > 0);
      }
      wg_commit();
      wg_wait_all();
      fence_regs<32>(sc);
      fence_regs<32>(dp);

      const bool need_mask = kt + kKTile > Sk || (causal && kt + kKTile - 1 > wq_lo) ||
                             (window > 0 && kt <= wq_hi - window);
      uint32_t sf[kKTile / 16][4];
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        const int col = kt + 8 * (e >> 2) + 2 * quad;  // and col + 1: this pair's keys
        const bool rb = (e & 2) != 0;
        const float l = rb ? lse_b : lse_a, d = rb ? d_b : d_a;
        const int pos = rb ? pos_b : pos_a;
        float p0 = exp2f(sc[e] * scale_log2 - l), p1 = exp2f(sc[e + 1] * scale_log2 - l);
        if (need_mask) {
          p0 = visible(pos, col, Sk, causal, window) ? p0 : 0.0f;
          p1 = visible(pos, col + 1, Sk, causal, window) ? p1 : 0.0f;
        }
        sf[e >> 3][(e & 7) >> 1] = pack_bf16(p0 * (dp[e] - d), p1 * (dp[e + 1] - d));
      }
      fence_regs<QREG>(dqa);
#pragma unroll
      for (int kk = 0; kk < kKTile / 16; ++kk) fence_regs<4>(sf[kk]);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kKTile / 16; ++kk)  // dq += dS k
        wgmma_rs<HDB>(dqa, sf[kk], gmma_desc(k_addr + kk * 16 * kRowBytes,
                                             kKTile * kRowBytes, 1024));
      wg_commit();
      wg_wait_all();
      fence_regs<QREG>(dqa);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    if (tid == 0 && j + kKStages < ntiles) {
      mbar_wait(&empty[s], (j / kKStages) & 1);
      issue(j + kKStages);
    }
    __syncwarp();
  }

  const long long row_stride = (long long)H * hd;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = half ? qb : qa;
    if (qi >= Sq) continue;
    __nv_bfloat16* row = dq + ((long long)b * Sq + qi) * row_stride + (long long)h * hd;
#pragma unroll
    for (int i = 0; i < NQ / 8; ++i) {
      const int c = 8 * i + 2 * quad;
      if (c < hd)
        *reinterpret_cast<__nv_bfloat162*>(row + c) = __floats2bfloat162_rn(
            dqa[4 * i + 2 * half] * scale, dqa[4 * i + 2 * half + 1] * scale);
    }
  }
}

template <int HDB>
int launch(const void* q, const void* k, const void* v, const void* o, const float* lse,
           const void* dout, void* dq, void* dk, void* dv, float* scratch, const Dims& d,
           cudaStream_t stream) {
  const int Sq_pad = (d.Sq + kRowsPad - 1) / kRowsPad * kRowsPad;
  const long long rows = (long long)d.B * d.H * Sq_pad;
  float* lse2 = scratch;
  float* Dv = scratch + rows;
  CUtensorMap mq, mdo, mk, mv;
  int rc = make_map(&mq, q, d.B, d.Sq, d.H * d.hd, 64);
  if (rc == 0) rc = make_map(&mdo, dout, d.B, d.Sq, d.H * d.hd, 64);
  if (rc == 0) rc = make_map(&mk, k, d.B, d.Sk, d.Hkv * d.hd, 64);
  if (rc == 0) rc = make_map(&mv, v, d.B, d.Sk, d.Hkv * d.hd, 64);
  if (rc != 0) return rc;
  cudaError_t err = cudaFuncSetAttribute(dkdv_kernel<HDB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)dkdv_smem(HDB));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dq_kernel<HDB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)dq_smem(HDB));
  if (err != cudaSuccess) return (int)err;
  const float scale_log2 = d.scale * kLog2e;
  dim3 g1((unsigned)(d.B * d.H), (unsigned)((d.Sq + kRows - 1) / kRows));
  dq_kernel<HDB><<<g1, kThreads, dq_smem(HDB), stream>>>(
      mq, mdo, mk, mv, (const __nv_bfloat16*)o, (const __nv_bfloat16*)dout, lse, lse2, Dv,
      (__nv_bfloat16*)dq, d.Sq, Sq_pad, d.Sk, d.H, d.Hkv, d.hd, d.q_offset, d.causal, d.window,
      d.scale, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess || d.Sk == 0) return (int)err;
  dim3 g2((unsigned)(d.B * d.Hkv), (unsigned)((d.Sk + kKeys - 1) / kKeys));
  dkdv_kernel<HDB><<<g2, kThreads, dkdv_smem(HDB), stream>>>(
      mq, mdo, mk, mv, lse2, Dv, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, d.Sq, Sq_pad, d.Sk,
      d.H, d.Hkv, d.hd, d.q_offset, d.causal, d.window, d.scale, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------------------
// CUDA-core route
// ---------------------------------------------------------------------------
namespace cc {

using attn::carve;
using attn::carved;
using attn::kThreads;
using attn::load_rows;
using attn::mm;

constexpr int kWarps = kThreads / 32;
constexpr int kBC = 32;   // keys per tile

// p and dS of one (query tile, key tile) pair, from the scores S and
// dP = do v^T in shared memory.
template <int BR>
__device__ void softmax_grad(const float* Ss, const float* dPs, float* Pe, float* dSe, int ldsc,
                             int lde, const float* lse, const float* Dv, int q0, int k0, int Sq,
                             int Sk, int q_offset, int causal, int window, float scale) {
  for (int e = threadIdx.x; e < BR * kBC; e += kThreads) {
    const int r = e / kBC, c = e % kBC;
    const int qi = q0 + r;
    const bool ok = qi < Sq && visible(q_offset + qi, k0 + c, Sk, causal, window);
    const float p = ok ? expf(Ss[r * ldsc + c] * scale - lse[r]) : 0.0f;
    Pe[r * lde + c] = p;
    dSe[r * lde + c] = ok ? p * (dPs[r * ldsc + c] - Dv[r]) : 0.0f;
  }
}

// Shared memory of each grid, laid out by its carve() calls: the operand
// tiles (q, do of BR rows; k, v of kBC), the score tiles, the grid's
// accumulators and the rows' lse and D.  Dq = hd and Dv = vd rounded up to
// 16.  At Dq = Dv = 256 and BR = 32, the dk/dv grid's 216,320 bytes.
size_t tiles_smem(int Dq, int Dv, int BR) {
  const int ldsc = kBC + 4, lde = kBC + 1;
  return 128 + carved((size_t)BR * (Dq + 1)) + carved((size_t)BR * (Dv + 1)) +
         carved((size_t)kBC * (Dq + 1)) + carved((size_t)kBC * (Dv + 1)) +
         2 * carved((size_t)BR * lde) + 2 * carved((size_t)BR * ldsc) + 2 * carved(BR);
}
size_t dq_smem(int Dq, int Dv, int BR) {
  return tiles_smem(Dq, Dv, BR) + carved((size_t)BR * (Dq + 4));
}
size_t dkdv_smem(int Dq, int Dv, int BR) {
  return tiles_smem(Dq, Dv, BR) + carved((size_t)kBC * (Dq + 4)) + carved((size_t)kBC * (Dv + 4));
}

// 1. dq (and D).  Block (query tile of BR rows, b * H + h).
template <typename T, int BR>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ o, const float* __restrict__ lse, const T* __restrict__ dout,
          T* __restrict__ dq, float* __restrict__ Dglob, Dims d, int Dq, int Dv) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* p = smem_raw + ((128 - ((uintptr_t)smem_raw & 127)) & 127);
  const int ldq = Dq + 1, ldv = Dv + 1, ldsc = kBC + 4, lde = kBC + 1;
  float* Qs = carve(p, (size_t)BR * ldq);
  float* dOs = carve(p, (size_t)BR * ldv);
  float* Ks = carve(p, (size_t)kBC * ldq);
  float* Vs = carve(p, (size_t)kBC * ldv);
  float* Pe = carve(p, (size_t)BR * lde);
  float* dSe = carve(p, (size_t)BR * lde);
  float* Ss = carve(p, (size_t)BR * ldsc);
  float* dPs = carve(p, (size_t)BR * ldsc);
  float* lses = carve(p, BR);
  float* Dvs = carve(p, BR);
  float* dQs = carve(p, (size_t)BR * (Dq + 4));

  const int q0 = blockIdx.x * BR;
  const int bh = blockIdx.y, b = bh / d.H, h = bh % d.H;
  const int hk = h / (d.H / d.Hkv);
  // row strides: q and dq H hd, o and do H vd, k Hkv hd, v Hkv vd
  const long long qs = (long long)d.H * d.hd, os = (long long)d.H * d.vd;
  const long long ks = (long long)d.Hkv * d.hd, vs = (long long)d.Hkv * d.vd;
  const T* qb = q + (long long)b * d.Sq * qs + (long long)h * d.hd;
  const T* ob = o + (long long)b * d.Sq * os + (long long)h * d.vd;
  const T* dob = dout + (long long)b * d.Sq * os + (long long)h * d.vd;
  const T* kb = k + (long long)b * d.Sk * ks + (long long)hk * d.hd;
  const T* vb = v + (long long)b * d.Sk * vs + (long long)hk * d.vd;

  load_rows(Qs, ldq, qb, qs, q0, BR, d.Sq, d.hd, Dq);
  load_rows(dOs, ldv, dob, os, q0, BR, d.Sq, d.vd, Dv);
  for (int i = threadIdx.x; i < BR * (Dq + 4); i += kThreads) dQs[i] = 0.0f;
  // D_i = do_i . o_i: one warp a row, lanes over columns, a fixed tree
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < BR; r += kWarps) {
    const int qi = q0 + r;
    float s = 0.0f;
    if (qi < d.Sq)
      for (int c = lane; c < d.vd; c += 32)
        s = fmaf(load_f32(dob, (size_t)(qi * os + c)), load_f32(ob, (size_t)(qi * os + c)), s);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) {
      Dvs[r] = s;
      lses[r] = qi < d.Sq ? lse[(long long)bh * d.Sq + qi] : 0.0f;
      if (qi < d.Sq) Dglob[(long long)bh * d.Sq + qi] = s;
    }
  }

  const int qpos_lo = d.q_offset + q0;
  const int qpos_hi = d.q_offset + min(q0 + BR, d.Sq) - 1;
  const int k_end = d.causal ? min(d.Sk, qpos_hi + 1) : d.Sk;
  int k_begin = d.window > 0 ? max(0, qpos_lo - d.window + 1) : 0;
  k_begin = (k_begin / kBC) * kBC;
  for (int k0 = k_begin; k0 < k_end; k0 += kBC) {
    __syncthreads();  // the previous tile's Ks, Vs, Pe, dSe are consumed
    load_rows(Ks, ldq, kb, ks, k0, kBC, d.Sk, d.hd, Dq);
    load_rows(Vs, ldv, vb, vs, k0, kBC, d.Sk, d.vd, Dv);
    __syncthreads();
    mm<false, false, true>(Ss, ldsc, Qs, ldq, Ks, ldq, BR, kBC, Dq);    // S = q k^T
    mm<false, false, true>(dPs, ldsc, dOs, ldv, Vs, ldv, BR, kBC, Dv);  // dP = do v^T
    __syncthreads();
    softmax_grad<BR>(Ss, dPs, Pe, dSe, ldsc, lde, lses, Dvs, q0, k0, d.Sq, d.Sk, d.q_offset,
                     d.causal, d.window, d.scale);
    __syncthreads();
    mm<true, false, false>(dQs, Dq + 4, dSe, lde, Ks, ldq, BR, Dq, kBC);  // dq += dS k
  }
  __syncthreads();
  T* dqb = dq + (long long)b * d.Sq * qs + (long long)h * d.hd;
  for (int i = threadIdx.x; i < BR * d.hd; i += kThreads) {
    const int r = i / d.hd, c = i % d.hd;
    if (q0 + r < d.Sq)
      store_f32(dqb, (size_t)((q0 + r) * qs + c), dQs[r * (Dq + 4) + c] * d.scale);
  }
}

// 2. dk and dv.  Block (key tile, b * Hkv + hk, split z): the query heads
// z gps .. z gps + gps - 1 of the kv head's G, gps = ceil(G / splits).
// One split writes dk (scaled) and dv; more write f32 partials, (splits,
// B, Sk, Hkv, hd) and then (splits, B, Sk, Hkv, vd), which reduce_splits
// adds in split order.
template <typename T, int BR>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const float* __restrict__ lse, const T* __restrict__ dout,
            const float* __restrict__ Dglob, T* __restrict__ dk, T* __restrict__ dv,
            float* __restrict__ part, Dims d, int Dq, int Dv) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* p = smem_raw + ((128 - ((uintptr_t)smem_raw & 127)) & 127);
  const int ldq = Dq + 1, ldv = Dv + 1, ldsc = kBC + 4, lde = kBC + 1;
  float* Qs = carve(p, (size_t)BR * ldq);
  float* dOs = carve(p, (size_t)BR * ldv);
  float* Ks = carve(p, (size_t)kBC * ldq);
  float* Vs = carve(p, (size_t)kBC * ldv);
  float* Pe = carve(p, (size_t)BR * lde);
  float* dSe = carve(p, (size_t)BR * lde);
  float* Ss = carve(p, (size_t)BR * ldsc);
  float* dPs = carve(p, (size_t)BR * ldsc);
  float* lses = carve(p, BR);
  float* Dvs = carve(p, BR);
  float* dKs = carve(p, (size_t)kBC * (Dq + 4));
  float* dVs = carve(p, (size_t)kBC * (Dv + 4));

  const int k0 = blockIdx.x * kBC;
  const int bhk = blockIdx.y, b = bhk / d.Hkv, hk = bhk % d.Hkv;
  const int G = d.H / d.Hkv, gps = (G + d.splits - 1) / d.splits;
  const int g_lo = blockIdx.z * gps, g_hi = min(G, g_lo + gps);
  const long long qs = (long long)d.H * d.hd, os = (long long)d.H * d.vd;
  const long long ks = (long long)d.Hkv * d.hd, vs = (long long)d.Hkv * d.vd;
  const T* kb = k + (long long)b * d.Sk * ks + (long long)hk * d.hd;
  const T* vb = v + (long long)b * d.Sk * vs + (long long)hk * d.vd;
  load_rows(Ks, ldq, kb, ks, k0, kBC, d.Sk, d.hd, Dq);
  load_rows(Vs, ldv, vb, vs, k0, kBC, d.Sk, d.vd, Dv);
  for (int i = threadIdx.x; i < kBC * (Dq + 4); i += kThreads) dKs[i] = 0.0f;
  for (int i = threadIdx.x; i < kBC * (Dv + 4); i += kThreads) dVs[i] = 0.0f;

  // the query rows that can see a key of this tile
  const int k_last = min(k0 + kBC, d.Sk) - 1;
  int i_begin = d.causal ? max(0, k0 - d.q_offset) : 0;
  i_begin = (i_begin / BR) * BR;
  const int i_end = d.window > 0 ? min(d.Sq, k_last + d.window - d.q_offset) : d.Sq;
  for (int g = g_lo; g < g_hi; ++g) {
    const int h = hk * G + g;
    const int bh = b * d.H + h;
    const T* qb = q + (long long)b * d.Sq * qs + (long long)h * d.hd;
    const T* dob = dout + (long long)b * d.Sq * os + (long long)h * d.vd;
    for (int q0 = i_begin; q0 < i_end; q0 += BR) {
      __syncthreads();  // the previous tile's Qs, dOs, Pe, dSe are consumed
      load_rows(Qs, ldq, qb, qs, q0, BR, d.Sq, d.hd, Dq);
      load_rows(dOs, ldv, dob, os, q0, BR, d.Sq, d.vd, Dv);
      for (int r = threadIdx.x; r < BR; r += kThreads) {
        const bool in = q0 + r < d.Sq;
        lses[r] = in ? lse[(long long)bh * d.Sq + q0 + r] : 0.0f;
        Dvs[r] = in ? Dglob[(long long)bh * d.Sq + q0 + r] : 0.0f;
      }
      __syncthreads();
      mm<false, false, true>(Ss, ldsc, Qs, ldq, Ks, ldq, BR, kBC, Dq);
      mm<false, false, true>(dPs, ldsc, dOs, ldv, Vs, ldv, BR, kBC, Dv);
      __syncthreads();
      softmax_grad<BR>(Ss, dPs, Pe, dSe, ldsc, lde, lses, Dvs, q0, k0, d.Sq, d.Sk, d.q_offset,
                       d.causal, d.window, d.scale);
      __syncthreads();
      mm<true, true, false>(dVs, Dv + 4, Pe, lde, dOs, ldv, kBC, Dv, BR);  // dv += P^T do
      mm<true, true, false>(dKs, Dq + 4, dSe, lde, Qs, ldq, kBC, Dq, BR);  // dk += dS^T q
    }
  }
  __syncthreads();
  if (d.splits == 1) {
    T* dkb = dk + (long long)b * d.Sk * ks + (long long)hk * d.hd;
    T* dvb = dv + (long long)b * d.Sk * vs + (long long)hk * d.vd;
    for (int i = threadIdx.x; i < kBC * d.hd; i += kThreads) {
      const int r = i / d.hd, c = i % d.hd;
      if (k0 + r < d.Sk)
        store_f32(dkb, (size_t)((k0 + r) * ks + c), dKs[r * (Dq + 4) + c] * d.scale);
    }
    for (int i = threadIdx.x; i < kBC * d.vd; i += kThreads) {
      const int r = i / d.vd, c = i % d.vd;
      if (k0 + r < d.Sk) store_f32(dvb, (size_t)((k0 + r) * vs + c), dVs[r * (Dv + 4) + c]);
    }
    return;
  }
  const long long nk = (long long)d.B * d.Sk * ks, nv = (long long)d.B * d.Sk * vs;
  float* pk = part + blockIdx.z * nk + (long long)b * d.Sk * ks + (long long)hk * d.hd;
  float* pv = part + d.splits * nk + blockIdx.z * nv + (long long)b * d.Sk * vs +
              (long long)hk * d.vd;
  for (int i = threadIdx.x; i < kBC * d.hd; i += kThreads) {
    const int r = i / d.hd, c = i % d.hd;
    if (k0 + r < d.Sk) pk[(k0 + r) * ks + c] = dKs[r * (Dq + 4) + c];
  }
  for (int i = threadIdx.x; i < kBC * d.vd; i += kThreads) {
    const int r = i / d.vd, c = i % d.vd;
    if (k0 + r < d.Sk) pv[(k0 + r) * vs + c] = dVs[r * (Dv + 4) + c];
  }
}

template <typename T, int BR>
int launch_rows(const void* q, const void* k, const void* v, const void* o, const float* lse,
                const void* dout, void* dq, void* dk, void* dv, float* Dscratch, float* part,
                const Dims& d, int Dq, int Dv, cudaStream_t stream) {
  const size_t s1 = dq_smem(Dq, Dv, BR), s2 = dkdv_smem(Dq, Dv, BR);
  cudaError_t err = cudaFuncSetAttribute(dq_kernel<T, BR>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dkdv_kernel<T, BR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)s2);
  if (err != cudaSuccess) return (int)err;
  dim3 g1((unsigned)((d.Sq + BR - 1) / BR), (unsigned)(d.B * d.H));
  dq_kernel<T, BR><<<g1, kThreads, s1, stream>>>((const T*)q, (const T*)k, (const T*)v,
                                                 (const T*)o, lse, (const T*)dout, (T*)dq,
                                                 Dscratch, d, Dq, Dv);
  err = cudaGetLastError();
  if (err != cudaSuccess || d.Sk == 0) return (int)err;
  dim3 g2((unsigned)((d.Sk + kBC - 1) / kBC), (unsigned)(d.B * d.Hkv), (unsigned)d.splits);
  dkdv_kernel<T, BR><<<g2, kThreads, s2, stream>>>((const T*)q, (const T*)k, (const T*)v, lse,
                                                   (const T*)dout, Dscratch, (T*)dk, (T*)dv,
                                                   part, d, Dq, Dv);
  err = cudaGetLastError();
  if (err != cudaSuccess || d.splits == 1) return (int)err;
  const long long nk = (long long)d.B * d.Sk * d.Hkv * d.hd;
  const long long nv = (long long)d.B * d.Sk * d.Hkv * d.vd;
  return (int)attn::launch_reduce_splits<T>(part, (T*)dk, (T*)dv, nk, nv, d.splits, d.scale,
                                            stream);
}

// Query tiles of 64 rows up to hd, vd = 128, of 32 beyond (shared memory).
template <typename T>
int launch(const void* q, const void* k, const void* v, const void* o, const float* lse,
           const void* dout, void* dq, void* dk, void* dv, float* Dscratch, float* part,
           const Dims& d, cudaStream_t stream) {
  const int Dq = (d.hd + 15) / 16 * 16, Dv = (d.vd + 15) / 16 * 16;
  if (Dq <= 128 && Dv <= 128)
    return launch_rows<T, 64>(q, k, v, o, lse, dout, dq, dk, dv, Dscratch, part, d, Dq, Dv,
                              stream);
  return launch_rows<T, 32>(q, k, v, o, lse, dout, dq, dk, dv, Dscratch, part, d, Dq, Dv, stream);
}

}  // namespace cc

// ---------------------------------------------------------------------------
// warp tensor-core route: bf16 at head dims the wgmma route does not take
// ---------------------------------------------------------------------------
namespace wm {

constexpr int kRows = 128;  // query rows a dq block, 16 a warp
constexpr int kKeys = 64;   // keys a dk/dv block, 16 a warp of either kind
constexpr int kStep = 64;   // keys a dq step; query rows a dk/dv step
constexpr int kThreads = 256;

using warp_mma::bf16;
using warp_mma::cp_commit;
using warp_mma::cp_wait;
using warp_mma::kPad;
using warp_mma::load_tile;
using warp_mma::load_tile_async;
using warp_mma::nn_16xN;
using warp_mma::nt_16xN;
using warp_mma::to_a;

// dq: q and do (kRows rows), k and v (kStep), lse and D of kRows; dk/dv: k
// and v (kKeys rows), two stages of q and do (kStep) with their lse and D.
size_t dq_smem(const Dims& d) {
  return 128 + (size_t)2 * (kRows + kStep) * (d.hd + d.vd + 2 * kPad) +
         2 * kRows * sizeof(float);
}
size_t dkdv_smem(const Dims& d) {
  return 128 + (size_t)2 * (kKeys + 2 * kStep) * (d.hd + d.vd + 2 * kPad) +
         4 * kStep * sizeof(float);
}

// 1. dq (and D).  Block (tile of 128 query rows, b * H + h); warp w owns rows
// 16 w .. 16 w + 15 and steps over the visible keys 64 at a time: S = q k^T
// and dP = do v^T on the tensor cores, P = exp(S scale - lse), dS = P (dP -
// D) rounded to bf16 in registers, dq += dS k.
__global__ void __launch_bounds__(kThreads, 1)
dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
          const bf16* __restrict__ o, const float* __restrict__ lse,
          const bf16* __restrict__ dout, bf16* __restrict__ dq, float* __restrict__ Dglob,
          Dims d, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw + ((128 - ((uintptr_t)smem_raw & 127)) & 127));
  const int ldq = d.hd + kPad, ldv = d.vd + kPad;
  bf16* dOs = Qs + kRows * ldq;
  bf16* Ks = dOs + kRows * ldv;
  bf16* Vs = Ks + kStep * ldq;
  float* rowl = reinterpret_cast<float*>(Vs + kStep * ldv);
  float* rowd = rowl + kRows;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kRows;
  const int bh = blockIdx.y, b = bh / d.H, h = bh % d.H;
  const int hk = h / (d.H / d.Hkv);
  const long long qs = (long long)d.H * d.hd, os = (long long)d.H * d.vd;
  const long long ks = (long long)d.Hkv * d.hd, vs = (long long)d.Hkv * d.vd;
  const bf16* qb = q + (long long)b * d.Sq * qs + (long long)h * d.hd;
  const bf16* ob = o + (long long)b * d.Sq * os + (long long)h * d.vd;
  const bf16* dob = dout + (long long)b * d.Sq * os + (long long)h * d.vd;
  const bf16* kb = k + (long long)b * d.Sk * ks + (long long)hk * d.hd;
  const bf16* vb = v + (long long)b * d.Sk * vs + (long long)hk * d.vd;

  load_tile<kThreads>(Qs, ldq, qb, qs, q0, kRows, d.Sq, d.hd);
  load_tile<kThreads>(dOs, ldv, dob, os, q0, kRows, d.Sq, d.vd);
  // D_i = do_i . o_i: one warp a row, lanes over columns, a fixed tree; lse
  // in log2 units
  for (int r = warp; r < kRows; r += kThreads / 32) {
    const int qi = q0 + r;
    float s = 0.0f;
    if (qi < d.Sq)
      for (int c = lane; c < d.vd; c += 32)
        s = fmaf(__bfloat162float(dob[qi * os + c]), __bfloat162float(ob[qi * os + c]), s);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) {
      rowd[r] = s;
      rowl[r] = qi < d.Sq ? lse[(long long)bh * d.Sq + qi] * kLog2e : 0.0f;
      if (qi < d.Sq) Dglob[(long long)bh * d.Sq + qi] = s;
    }
  }

  const int r_lo = q0 + 16 * warp;  // this warp's first row
  const int pos_lo = d.q_offset + r_lo;
  const int pos_hi = d.q_offset + min(r_lo + 15, d.Sq - 1);
  const int qpos_hi = d.q_offset + min(q0 + kRows, d.Sq) - 1;
  const int k_end = d.causal ? min(d.Sk, qpos_hi + 1) : d.Sk;
  int k_begin = d.window > 0 ? max(0, d.q_offset + q0 - d.window + 1) : 0;
  k_begin = (k_begin / kStep) * kStep;
  float acc[32][4];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
  for (int kt = k_begin; kt < k_end; kt += kStep) {
    __syncthreads();  // the last step's k and v are consumed (and D, lse written)
    load_tile<kThreads>(Ks, ldq, kb, ks, kt, kStep, d.Sk, d.hd);
    load_tile<kThreads>(Vs, ldv, vb, vs, kt, kStep, d.Sk, d.vd);
    __syncthreads();
    bool active = r_lo < d.Sq;
    if (d.causal) active = active && kt <= pos_hi;
    if (d.window > 0) active = active && kt + kStep - 1 > pos_lo - d.window;
    if (!active) continue;
    float sc[8][4], dp[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      sc[i][0] = sc[i][1] = sc[i][2] = sc[i][3] = dp[i][0] = dp[i][1] = dp[i][2] = dp[i][3] = 0.0f;
    nt_16xN<64>(sc, Qs + 16 * warp * ldq, ldq, Ks, ldq, d.hd);   // S = q k^T
    nt_16xN<64>(dp, dOs + 16 * warp * ldv, ldv, Vs, ldv, d.vd);  // dP = do v^T
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 16 * warp + g + 8 * (e >> 1), qi = q0 + r;
        const int key = kt + 8 * i + 2 * t + (e & 1);
        const float p = exp2f(sc[i][e] * scale_log2 - rowl[r]);
        const bool ok = qi < d.Sq && visible(d.q_offset + qi, key, d.Sk, d.causal, d.window);
        sc[i][e] = ok ? p * (dp[i][e] - rowd[r]) : 0.0f;  // dS
      }
    uint32_t af[4][4];
    to_a(af, sc);
    nn_16xN(acc, af, Ks, ldq, d.hd);  // dq += dS k
  }
  bf16* dqb = dq + (long long)b * d.Sq * qs + (long long)h * d.hd;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int c = 8 * i + 2 * t;
    if (c >= d.hd) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int qi = r_lo + g + 8 * half;
      if (qi < d.Sq)
        *reinterpret_cast<__nv_bfloat162*>(dqb + qi * qs + c) = __floats2bfloat162_rn(
            acc[i][2 * half] * d.scale, acc[i][2 * half + 1] * d.scale);
    }
  }
}

// 2. dk and dv.  Block (tile of 64 keys, b * Hkv + hk, split z: its share of
// the kv head's query heads, as on the CUDA-core route).  Warps 0-3 own 16
// keys each for dv (S^T = k q^T, P^T, dv += P^T do), warps 4-7 the same keys
// for dk (S^T and dP^T = v do^T, dS^T = P^T (dP^T - D), dk += dS^T q): dv
// and dk of 16 keys at vd = hd = 256 take 128 f32 registers a thread each,
// so no warp holds both.  The q and do tiles (with their lse and D rows)
// come through two stages, the next tile's cp.async in flight during this
// one's products.  One split writes dk (scaled) and dv; more write f32
// partials that attn::reduce_splits adds in split order.
__global__ void __launch_bounds__(kThreads, 1)
dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
            const float* __restrict__ lse, const bf16* __restrict__ dout,
            const float* __restrict__ Dglob, bf16* __restrict__ dk, bf16* __restrict__ dv,
            float* __restrict__ part, Dims d, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw + ((128 - ((uintptr_t)smem_raw & 127)) & 127));
  const int ldq = d.hd + kPad, ldv = d.vd + kPad;
  bf16* Vs = Ks + kKeys * ldq;
  bf16* Q0 = Vs + kKeys * ldv;  // stage s: q at Q0 + s (qstage), do after it
  const int qstage = kStep * (ldq + ldv);
  float* rows = reinterpret_cast<float*>(Q0 + 2 * qstage);  // stage s: lse, then D

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const bool dk_role = warp >= 4;
  const int kw = warp & 3;
  const int k0 = blockIdx.x * kKeys;
  const int bhk = blockIdx.y, b = bhk / d.Hkv, hk = bhk % d.Hkv;
  const int G = d.H / d.Hkv, gps = (G + d.splits - 1) / d.splits;
  const int g_lo = blockIdx.z * gps, g_hi = min(G, g_lo + gps);
  const long long qs = (long long)d.H * d.hd, os = (long long)d.H * d.vd;
  const long long ks = (long long)d.Hkv * d.hd, vs = (long long)d.Hkv * d.vd;
  load_tile<kThreads>(Ks, ldq, k + (long long)b * d.Sk * ks + (long long)hk * d.hd, ks, k0,
                      kKeys, d.Sk, d.hd);
  load_tile<kThreads>(Vs, ldv, v + (long long)b * d.Sk * vs + (long long)hk * d.vd, vs, k0,
                      kKeys, d.Sk, d.vd);

  const int kw0 = k0 + 16 * kw;  // this warp's first key
  const int k_last = min(k0 + kKeys, d.Sk) - 1;
  int i_begin = d.causal ? max(0, k0 - d.q_offset) : 0;
  i_begin = (i_begin / kStep) * kStep;
  const int i_end = d.window > 0 ? min(d.Sq, k_last + d.window - d.q_offset) : d.Sq;
  const int nt = i_end > i_begin ? (i_end - i_begin + kStep - 1) / kStep : 0;
  const int total = g_hi > g_lo ? (g_hi - g_lo) * nt : 0;
  const int ncols = dk_role ? d.hd : d.vd;

  auto issue = [&](int j) {  // tile j: query head hk G + g_lo + j / nt, rows from q0
    const int st = j & 1, h = hk * G + g_lo + j / nt, q0 = i_begin + (j % nt) * kStep;
    bf16* Qd = Q0 + st * qstage;
    load_tile_async<kThreads>(Qd, ldq, q + (long long)b * d.Sq * qs + (long long)h * d.hd, qs,
                              q0, kStep, d.Sq, d.hd);
    load_tile_async<kThreads>(Qd + kStep * ldq, ldv,
                              dout + (long long)b * d.Sq * os + (long long)h * d.vd, os, q0,
                              kStep, d.Sq, d.vd);
    const long long bh = (long long)b * d.H + h;
    for (int r = tid; r < kStep; r += kThreads) {
      const bool in = q0 + r < d.Sq;
      rows[st * 2 * kStep + r] = in ? lse[bh * d.Sq + q0 + r] * kLog2e : 0.0f;
      rows[st * 2 * kStep + kStep + r] = in ? Dglob[bh * d.Sq + q0 + r] : 0.0f;
    }
    cp_commit();
  };

  float acc[32][4];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
  if (total > 0) issue(0);
  for (int j = 0; j < total; ++j) {
    if (j + 1 < total) {
      issue(j + 1);  // into the stage tile j - 1 used, which every warp has left
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();  // tile j's copies (and k, v at j = 0) visible to every warp
    const int st = j & 1, q0 = i_begin + (j % nt) * kStep;
    const bf16* Qs = Q0 + st * qstage;
    const bf16* dOs = Qs + kStep * ldq;
    const float* rowl = rows + st * 2 * kStep;
    const float* rowd = rowl + kStep;
    const int qp0 = d.q_offset + q0;
    bool active = kw0 < d.Sk;
    if (d.causal) active = active && qp0 + kStep - 1 >= kw0;
    if (d.window > 0) active = active && kw0 + 15 > qp0 - d.window;
    if (active) {
      float sc[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i) sc[i][0] = sc[i][1] = sc[i][2] = sc[i][3] = 0.0f;
      nt_16xN<64>(sc, Ks + 16 * kw * ldq, ldq, Qs, ldq, d.hd);  // S^T = k q^T
      uint32_t af[4][4];
      if (dk_role) {
        float dp[8][4];
#pragma unroll
        for (int i = 0; i < 8; ++i) dp[i][0] = dp[i][1] = dp[i][2] = dp[i][3] = 0.0f;
        nt_16xN<64>(dp, Vs + 16 * kw * ldv, ldv, dOs, ldv, d.vd);  // dP^T = v do^T
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = kw0 + g + 8 * (e >> 1), c = 8 * i + 2 * t + (e & 1), qi = q0 + c;
            const float p = exp2f(sc[i][e] * scale_log2 - rowl[c]);
            const bool ok = qi < d.Sq && visible(d.q_offset + qi, key, d.Sk, d.causal, d.window);
            sc[i][e] = ok ? p * (dp[i][e] - rowd[c]) : 0.0f;  // dS^T
          }
        to_a(af, sc);
        nn_16xN(acc, af, Qs, ldq, d.hd);  // dk += dS^T q
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = kw0 + g + 8 * (e >> 1), c = 8 * i + 2 * t + (e & 1), qi = q0 + c;
            const float p = exp2f(sc[i][e] * scale_log2 - rowl[c]);
            const bool ok = qi < d.Sq && visible(d.q_offset + qi, key, d.Sk, d.causal, d.window);
            sc[i][e] = ok ? p : 0.0f;  // P^T
          }
        to_a(af, sc);
        nn_16xN(acc, af, dOs, ldv, d.vd);  // dv += P^T do
      }
    }
    __syncthreads();  // every warp is done with stage j & 1 before tile j + 2 lands there
  }
  const float mult = dk_role ? d.scale : 1.0f;
  const int dim = dk_role ? d.hd : d.vd;
  const long long stride = dk_role ? ks : vs;
  const long long col0 = (long long)hk * dim;
  const long long nk = (long long)d.B * d.Sk * ks, nv = (long long)d.B * d.Sk * vs;
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
        bf16* out = dk_role ? dk : dv;
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

int launch(const void* q, const void* k, const void* v, const void* o, const float* lse,
           const void* dout, void* dq, void* dk, void* dv, float* Dscratch, float* part,
           const Dims& d, cudaStream_t stream) {
  const size_t s1 = dq_smem(d), s2 = dkdv_smem(d);
  cudaError_t err = cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)s1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)s2);
  if (err != cudaSuccess) return (int)err;
  const float scale_log2 = d.scale * kLog2e;
  dim3 g1((unsigned)((d.Sq + kRows - 1) / kRows), (unsigned)(d.B * d.H));
  dq_kernel<<<g1, kThreads, s1, stream>>>((const bf16*)q, (const bf16*)k, (const bf16*)v,
                                          (const bf16*)o, lse, (const bf16*)dout, (bf16*)dq,
                                          Dscratch, d, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess || d.Sk == 0) return (int)err;
  dim3 g2((unsigned)((d.Sk + kKeys - 1) / kKeys), (unsigned)(d.B * d.Hkv), (unsigned)d.splits);
  dkdv_kernel<<<g2, kThreads, s2, stream>>>((const bf16*)q, (const bf16*)k, (const bf16*)v, lse,
                                            (const bf16*)dout, Dscratch, (bf16*)dk, (bf16*)dv,
                                            part, d, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess || d.splits == 1) return (int)err;
  const long long nk = (long long)d.B * d.Sk * d.Hkv * d.hd;
  const long long nv = (long long)d.B * d.Sk * d.Hkv * d.vd;
  return (int)attn::launch_reduce_splits<bf16>(part, (bf16*)dk, (bf16*)dv, nk, nv, d.splits,
                                               d.scale, stream);
}

}  // namespace wm

}  // namespace

// q, dq (B, Sq, H, hd), o, dout (B, Sq, H, vd), k, dk (B, Sk, Hkv, hd) and
// v, dv (B, Sk, Hkv, vd) of one dtype (f32 or bf16), contiguous; lse (B, H,
// Sq) f32 from the forward; ``scratch`` f32 of 2 B H ceil(Sq / 64) 64 floats
// (the tensor-core route's lse and D rows; the CUDA-core route uses B H Sq
// of them for D), then, when ``splits`` > 1, splits B Sk Hkv (hd + vd) for
// the dk/dv grid's partials (CUDA-core and warp tensor-core routes).
// route: 0 CUDA cores; 1 wgmma (bf16 with hd = vd a multiple of 16 up to 128,
// 16-byte aligned rows, splits = 1); 2 warp tensor cores (bf16 with hd and vd
// multiples of 16).  window <= 0: no window.  Returns a CUDA error code.
extern "C" int launch_flash_attention_bwd(const void* q, const void* k, const void* v,
                                          const void* o, const void* lse, const void* dout,
                                          void* dq, void* dk, void* dv, void* scratch, int B,
                                          int Sq, int Sk, int H, int Hkv, int hd, int vd,
                                          int splits, int q_offset, int causal, int window,
                                          int dtype, int route, float scale, int device,
                                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (hd < 1 || hd > kMaxD || vd < 1 || vd > kMaxD || Hkv < 1 || H % Hkv != 0 || splits < 1 ||
      splits > H / Hkv)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0 || H == 0) return (int)cudaGetLastError();
  const Dims d{B, Sq, Sk, H, Hkv, hd, vd, q_offset, causal, window, splits, scale};
  cudaStream_t st = (cudaStream_t)stream;
  const float* l = (const float*)lse;
  float* sc = (float*)scratch;
  if (route == kRouteWgmma) {
    if (dtype != kBF16 || hd % 16 != 0 || vd != hd || hd > kTcMaxD || splits != 1)
      return (int)cudaErrorInvalidValue;
    if (hd <= 64) return tc::launch<1>(q, k, v, o, l, dout, dq, dk, dv, sc, d, st);
    return tc::launch<2>(q, k, v, o, l, dout, dq, dk, dv, sc, d, st);
  }
  const long long pad = (long long)B * H * ((Sq + tc::kRowsPad - 1) / tc::kRowsPad) * tc::kRowsPad;
  float* part = sc + 2 * pad;
  if (route == kRouteMma) {
    if (dtype != kBF16 || hd % 16 != 0 || vd % 16 != 0) return (int)cudaErrorInvalidValue;
    return wm::launch(q, k, v, o, l, dout, dq, dk, dv, sc, part, d, st);
  }
  if (route != kRouteCudaCores) return (int)cudaErrorInvalidValue;
  if (dtype == kF32) return cc::launch<float>(q, k, v, o, l, dout, dq, dk, dv, sc, part, d, st);
  if (dtype == kBF16)
    return cc::launch<__nv_bfloat16>(q, k, v, o, l, dout, dq, dk, dv, sc, part, d, st);
  return (int)cudaErrorInvalidValue;
}
