// Kernel 16: causal GQA attention with an online softmax, optionally over a
// sliding window.  It replaces, in src/repro/kernels/flash_attention.py,
//
//   flash_attention_pallas   q (B, Sq, H, hd); k (B, Sk, Hkv, hd);
//                            v (B, Sk, Hkv, vd) -> o (B, Sq, H, vd) in q's
//                            dtype.  Query i sits at position q_offset + i,
//                            key j at j; a key is valid when j <= q_pos
//                            (causal) and j > q_pos - window (window).
//                            Scores q.k / sqrt(hd), masked to -1e30; running
//                            max m, sum l and accumulator acc in f32;
//                            o = acc / max(l, 1e-30).
//
// Query head h reads kv head h / (H / Hkv); grouped keys are never
// materialised.  Any Sq and Sk: a ragged last tile is masked.  Key tiles
// that are wholly masked for a group of rows are skipped (the Pallas kernel
// visits them, but their weight is wiped by the first valid tile, so the
// result agrees up to rounding; a row with no valid key at all keeps 0).
//
// What bounds it on an H100: operations.  About 2 Sq Sk hd multiply-adds
// per head for the scores and as many for p v, half of that under the
// causal mask, against 2 Sq hd + 2 Sk hd values moved.  At olmo-1b's
// prefill shape (4, 1024, 16, 128) bf16 that is 17.2 GFLOP of valid
// (query, key) pairs against 67 MB: 17 us at the bf16 tensor-core rate,
// 20 us at the memory rate.  Only the tensor cores come near it, so the
// products have to run there, fed from shared memory without the threads
// spending instructions on the loads.
//
// Two routes, chosen by the wrapper from the dtype and the head dims:
//
// * Tensor cores (bf16, hd and vd multiples of 16 up to 256).  One block per
//   (b * H + h, tile of 128 query rows), the heaviest causal tiles launched
//   first; two warpgroups of 64 rows, 256 threads.  One thread (the first
//   of the second warpgroup) brings q once and the key and value tiles into
//   a ring of two stages in shared memory with TMA (a 3-D tensor map over
//   (heads * dim, positions, batch): one head's row is HDB (q, k) or VDB
//   (v) boxes of 64 columns, 128 bytes each, consecutive positions
//   H*dim*2 bytes apart), each stage behind a pair of mbarriers (full: the
//   bytes arrived; empty: all eight warps are done with it), so the next
//   tile loads while the current one is multiplied.  The boxes land in the
//   128-byte swizzle that wgmma reads without bank conflicts.  Each
//   warpgroup computes S = q k^T with wgmma m64nBKk16 (q and k both K-major
//   in shared memory; the product reduces over hd in steps of 16, so the
//   columns of a box past hd never enter S), runs the online softmax on its
//   f32 accumulators in registers (exp2 with the scale folded into log2
//   e), rounds p to bf16 straight into the A fragments of the next product
//   (l is summed from the unrounded p, as FlashAttention-2/3 do), and
//   accumulates o += p v with wgmma m64nNk16, A from registers, v MN-major,
//   N = 64 VDB.  Columns of a v box past vd (the next head's, or zero past
//   the tensor) feed only output columns that are never stored.  Rows and
//   keys past Sq and Sk are zero-filled by TMA and masked.
//
//   Key tiles (BK) of 128 keys while HDB and VDB are at most 2 (hd, vd <=
//   128), of 64 beyond: at hd = vd = 256 two stages of 128-key tiles and q
//   would take 320 KB of shared memory (the SM has 227 KB; with 64 keys,
//   193 KB), and o's accumulator is then 128 registers a thread beside S's
//   and p's.  No producer warp: the SM gives a block registers for whole
//   warpgroups, so 288 threads are charged as 384 and held to 168
//   registers a thread, which spilled vd = 256's accumulators (1.3 KB a
//   thread) and ran several times slower on the card; 256 threads may take
//   255 (the widest instantiation uses about 200).  The loading thread refills a stage
//   once all eight warps have left it, so the two warpgroups run a tile
//   apart at most.
//
//   128 keys a tile rather than 64 halves the barrier round trips, row
//   maxima and rescales per product and gives the score product the wider
//   m64n128k16, which reads q and k from shared memory at 96 of the SM's
//   128 bytes a clock where m64n64k16 needs all 128; on the card it was the
//   faster of the two.  Taking q's fragments from registers, or issuing the
//   next tile's scores before this tile's softmax (FlashAttention-3's
//   overlap), were slower in trials on the card: ptxas then inserts
//   warpgroup waits around the register operands.
//
// * CUDA cores (f32, or bf16 with an hd or vd the tensor-core route does not
//   take; both up to 256).  One block per (query tile of 64 rows, b * H +
//   h), 256 threads, f32 products out of shared memory: thread t owns row
//   t / 4 of the tile and, of that row, keys j = 4 i + t % 4 of the score
//   tile and output columns 4 i + t % 4 (32 of them up to vd = 128, 64
//   beyond).  The f32 route keeps f32 products (not TF32), so it holds the
//   1e-4 f32 comparisons.
#include "common.cuh"

#include <stdint.h>

#include "hopper.cuh"  // TMA, mbarrier and wgmma helpers shared with kernel 16b

namespace {

constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// tensor-core route
// ---------------------------------------------------------------------------
namespace tc {

using namespace hopper;

constexpr int kBQ = 128;              // query rows per block (two warpgroups)
constexpr int kStages = 2;            // depth of the key/value ring
constexpr int kConsumers = 256;       // two warpgroups
constexpr int kThreads = kConsumers;  // no producer warp: one consumer thread loads
constexpr int kIssuer = 128;          // that thread: the first of the second warpgroup

// BK, the keys of a tile (the N of the score product): 128 while q and k
// take at most two boxes and v at most two, else 64 (shared memory and
// registers; see the route's notes above).
__host__ __device__ constexpr int key_tile(int hdb, int vdb) {
  return hdb <= 2 && vdb <= 2 ? 128 : 64;
}
__host__ __device__ constexpr int q_bytes(int hdb) { return hdb * kBQ * kRowBytes; }
__host__ __device__ constexpr int tile_bytes(int boxes, int bk) { return boxes * bk * kRowBytes; }
size_t smem_bytes(int hdb, int vdb) {
  const int bk = key_tile(hdb, vdb);
  return 1024 /* alignment slack */ + q_bytes(hdb) +
         kStages * (tile_bytes(hdb, bk) + tile_bytes(vdb, bk)) +
         (2 * kStages + 1) * sizeof(uint64_t);
}

// HDB: 64-column boxes of a q or k row (ceil(hd / 64), 1-4); VDB: of a v
// row (ceil(vd / 64), 1-4).
//
// Accumulator layout of wgmma m64nN (f32), thread t of a warpgroup, warp
// w = t / 32, lane l: register 4 i + e holds row 16 w + l / 4 + 8 (e / 2)
// and column 8 i + 2 (l % 4) + e % 2.  The A fragment of m64k16 from
// registers holds the same rows and, for k-step j, the columns of n8
// blocks 2 j and 2 j + 1: so p's registers 8 j .. 8 j + 7, packed in pairs,
// are the A operand of the j-th step of p v.
template <int HDB, int VDB>
__global__ void __launch_bounds__(kThreads, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                float* __restrict__ lse, int Sq, int Sk, int H, int Hkv, int hd, int vd,
                int q_offset, int causal, int window, float scale_log2) {
  constexpr int kBK = key_tile(HDB, VDB);
  constexpr int K_BYTES = tile_bytes(HDB, kBK);
  constexpr int V_BYTES = tile_bytes(VDB, kBK);
  constexpr int NV = 64 * VDB;        // output columns of p v
  constexpr int SREG = kBK / 2;       // f32 score registers a thread holds
  constexpr int OREG = NV / 2;        // f32 output registers a thread holds
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);  // 1024-aligned: the swizzle atom
  uint8_t* qs = smem;
  uint8_t* ks = qs + q_bytes(HDB);
  uint8_t* vs = ks + kStages * K_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(vs + kStages * V_BYTES);
  uint64_t* empty = full + kStages;
  uint64_t* qbar = empty + kStages;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heaviest causal tiles first

  // the key range the block's rows can see
  const int qpos_lo = q_offset + q0;
  const int qpos_hi = q_offset + min(q0 + kBQ, Sq) - 1;
  const int k_end = causal ? min(Sk, qpos_hi + 1) : Sk;
  int k_begin = window > 0 ? max(0, qpos_lo - window + 1) : 0;
  k_begin = (k_begin / kBK) * kBK;
  const int ntiles = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // one thread loads q, then each key and value tile through the ring: the
  // first kStages tiles now, tile j + kStages once every warp is done with
  // tile j (below)
  auto load_tile = [&](int j) {
    const int s = j % kStages;
    mbar_expect_tx(&full[s], K_BYTES + V_BYTES);
    const int kt = k_begin + j * kBK;
    for (int c = 0; c < HDB; ++c)
      tma_load_3d(ks + s * K_BYTES + c * kBK * kRowBytes, &tk, &full[s], hk * hd + 64 * c, kt,
                  b);
    for (int c = 0; c < VDB; ++c)
      tma_load_3d(vs + s * V_BYTES + c * kBK * kRowBytes, &tv, &full[s], hk * vd + 64 * c, kt,
                  b);
  };
  if (tid == kIssuer) {
    mbar_expect_tx(qbar, q_bytes(HDB));
    for (int c = 0; c < HDB; ++c)
      tma_load_3d(qs + c * kBQ * kRowBytes, &tq, qbar, h * hd + 64 * c, q0, b);
    for (int j = 0; j < kStages && j < ntiles; ++j) load_tile(j);
  }

  // warpgroup wg owns query rows 64 wg .. 64 wg + 63 of the tile
  const int wg = warp >> 2;
  const int row_a = 16 * (warp & 3) + (lane >> 2);  // and row_a + 8
  const int quad = lane & 3;
  const int last_pos = q_offset + Sq - 1;
  const int wq_lo = q_offset + q0 + 64 * wg;
  const int wq_hi = min(wq_lo + 63, last_pos);
  const int pos_a = wq_lo + row_a, pos_b = pos_a + 8;

  float m_a = kNeg, m_b = kNeg, l_a = 0.0f, l_b = 0.0f;
  float oacc[OREG];
#pragma unroll
  for (int i = 0; i < OREG; ++i) oacc[i] = 0.0f;
  const uint32_t q_addr = smem_u32(qs) + wg * 64 * kRowBytes;
  const int ksteps = hd / 16;

  mbar_wait(qbar, 0);
  for (int j = 0; j < ntiles; ++j) {
    const int s = j % kStages;
    const int kt = k_begin + j * kBK;
    mbar_wait(&full[s], (j / kStages) & 1);
    bool active = wq_lo <= last_pos;
    if (causal) active = active && kt <= wq_hi;
    if (window > 0) active = active && kt + kBK - 1 > wq_lo - window;
    if (active) {
      const uint32_t k_addr = smem_u32(ks + s * K_BYTES);
      const uint32_t v_addr = smem_u32(vs + s * V_BYTES);
      float sacc[SREG];
#pragma unroll
      for (int i = 0; i < SREG; ++i) sacc[i] = 0.0f;
      fence_regs<SREG>(sacc);
      wg_fence();
      for (int kk = 0; kk < ksteps; ++kk) {
        const uint32_t off = (kk & 3) * 32;  // 16 columns of the 128-byte row
        const uint64_t da = gmma_desc(q_addr + (kk >> 2) * kBQ * kRowBytes + off, 16, 1024);
        const uint64_t db = gmma_desc(k_addr + (kk >> 2) * kBK * kRowBytes + off, 16, 1024);
        wgmma_ss<kBK>(sacc, da, db, kk > 0);
      }
      wg_commit();
      wg_wait_all();
      fence_regs<SREG>(sacc);

      // scores in log2 units, masked where a key is not visible
      const bool need_mask = kt + kBK > Sk || (causal && kt + kBK - 1 > wq_lo) ||
                             (window > 0 && kt <= wq_hi - window);
      float mx_a = kNeg, mx_b = kNeg;
#pragma unroll
      for (int e = 0; e < SREG; ++e) {
        float x = sacc[e] * scale_log2;
        if (need_mask) {
          const int col = kt + 8 * (e >> 2) + 2 * quad + (e & 1);
          const int pos = (e & 2) ? pos_b : pos_a;
          bool valid = col < Sk;
          if (causal) valid = valid && col <= pos;
          if (window > 0) valid = valid && col > pos - window;
          x = valid ? x : kNeg;
        }
        sacc[e] = x;
        if (e & 2) mx_b = fmaxf(mx_b, x);
        else mx_a = fmaxf(mx_a, x);
      }
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      const float al_a = exp2f(m_a - mn_a), al_b = exp2f(m_b - mn_b);
      m_a = mn_a;
      m_b = mn_b;
      float ps_a = 0.0f, ps_b = 0.0f;
      uint32_t pf[kBK / 16][4];
#pragma unroll
      for (int e = 0; e < SREG; e += 2) {
        const float mn = (e & 2) ? mn_b : mn_a;
        const float p0 = exp2f(sacc[e] - mn), p1 = exp2f(sacc[e + 1] - mn);
        if (e & 2) ps_b += p0 + p1;
        else ps_a += p0 + p1;
        pf[e >> 3][(e & 7) >> 1] = pack_bf16(p0, p1);
      }
      l_a = l_a * al_a + ps_a;  // per-thread partial sums; the row's four lanes add at the end
      l_b = l_b * al_b + ps_b;
#pragma unroll
      for (int i = 0; i < OREG; ++i) oacc[i] *= (i & 2) ? al_b : al_a;

      fence_regs<OREG>(oacc);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) fence_regs<4>(pf[kk]);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_rs<VDB>(oacc, pf[kk], gmma_desc(v_addr + kk * 16 * kRowBytes, kBK * kRowBytes, 1024));
      wg_commit();
      wg_wait_all();
      fence_regs<OREG>(oacc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with the stage
    if (tid == kIssuer && j + kStages < ntiles) {
      mbar_wait(&empty[s], (j / kStages) & 1);  // every warp is done with tile j
      load_tile(j + kStages);
    }
    __syncwarp();
  }

  l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
  const float inv_a = 1.0f / fmaxf(l_a, 1e-30f), inv_b = 1.0f / fmaxf(l_b, 1e-30f);
  const int qa = q0 + 64 * wg + row_a;
  const long long row_stride = (long long)H * vd;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = qa + 8 * half;
    if (qi >= Sq) continue;
    const float inv = half ? inv_b : inv_a;
    if (lse != nullptr && quad == 0)  // the row's logsumexp, in natural units
      lse[(long long)bh * Sq + qi] = ((half ? m_b : m_a) + log2f(half ? l_b : l_a)) / kLog2e;
    __nv_bfloat16* orow = o + ((long long)b * Sq + qi) * row_stride + (long long)h * vd;
#pragma unroll
    for (int i = 0; i < NV / 8; ++i) {
      const int c = 8 * i + 2 * quad;
      if (c < vd) {
        const __nv_bfloat162 v2 = __floats2bfloat162_rn(oacc[4 * i + 2 * half] * inv,
                                                        oacc[4 * i + 2 * half + 1] * inv);
        *reinterpret_cast<__nv_bfloat162*>(orow + c) = v2;
      }
    }
  }
}

template <int HDB, int VDB>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int Sq,
           int Sk, int H, int Hkv, int hd, int vd, int q_offset, int causal, int window,
           float scale, cudaStream_t stream) {
  constexpr int kBK = key_tile(HDB, VDB);
  CUtensorMap mq, mk, mv;
  int rc = make_map(&mq, q, B, Sq, H * hd, kBQ);
  if (rc == 0) rc = make_map(&mk, k, B, Sk, Hkv * hd, kBK);
  if (rc == 0) rc = make_map(&mv, v, B, Sk, Hkv * vd, kBK);
  if (rc != 0) return rc;
  const size_t smem = smem_bytes(HDB, VDB);
  cudaError_t err = cudaFuncSetAttribute(flash_tc_kernel<HDB, VDB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)(B * H), (unsigned)((Sq + kBQ - 1) / kBQ));
  flash_tc_kernel<HDB, VDB><<<grid, kThreads, smem, stream>>>(
      mq, mk, mv, (__nv_bfloat16*)o, lse, Sq, Sk, H, Hkv, hd, vd, q_offset, causal, window,
      scale * kLog2e);
  return (int)cudaGetLastError();
}

// The instantiation for q/k rows of HDB boxes, v rows of ceil(vd / 64).
template <int HDB>
int launch_vd(const void* q, const void* k, const void* v, void* o, float* lse, int B, int Sq,
              int Sk, int H, int Hkv, int hd, int vd, int q_offset, int causal, int window,
              float scale, cudaStream_t stream) {
  switch ((vd + 63) / 64) {
    case 1: return launch<HDB, 1>(q, k, v, o, lse, B, Sq, Sk, H, Hkv, hd, vd, q_offset, causal, window, scale, stream);
    case 2: return launch<HDB, 2>(q, k, v, o, lse, B, Sq, Sk, H, Hkv, hd, vd, q_offset, causal, window, scale, stream);
    case 3: return launch<HDB, 3>(q, k, v, o, lse, B, Sq, Sk, H, Hkv, hd, vd, q_offset, causal, window, scale, stream);
    case 4: return launch<HDB, 4>(q, k, v, o, lse, B, Sq, Sk, H, Hkv, hd, vd, q_offset, causal, window, scale, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace tc

// ---------------------------------------------------------------------------
// CUDA-core route
// ---------------------------------------------------------------------------
namespace cc {

constexpr int kThreads = 256;
constexpr int kBQ = 64;         // query rows per block
constexpr int kBK = 64;         // keys per tile
constexpr int kMaxD = 256;      // largest head dim (q/k and v)
constexpr int kKeys = kBK / 4;    // score columns a thread owns

size_t smem_bytes(int hd, int vd) {
  return sizeof(float) * ((size_t)kBQ * (hd + 1) + (size_t)kBK * (hd + 1) + (size_t)kBK * vd +
                          (size_t)kBQ * (kBK + 1));
}

// q and k rows are padded to hd + 1 floats in shared memory and the p tile
// to 65, so that the warp's eight rows and four key groups fall on distinct
// banks; the four threads of a row are neighbouring lanes of one warp and
// combine their row maximum and sum by shuffles.
// COLS: output columns a thread owns (vd <= 4 COLS).
template <typename T, int COLS>
__global__ void __launch_bounds__(kThreads)
flash_cc_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                T* __restrict__ o, float* __restrict__ lse, int Sq, int Sk, int H, int Hkv, int hd,
                int vd, int q_offset, int causal, int window, float scale) {
  extern __shared__ float smem[];
  const int ldq = hd + 1, ldp = kBK + 1;
  float* qs = smem;                        // (kBQ, hd + 1)
  float* ks = qs + kBQ * ldq;              // (kBK, hd + 1)
  float* vs = ks + kBK * ldq;              // (kBK, vd)
  float* ps = vs + kBK * vd;               // (kBQ, kBK + 1)

  const int tid = threadIdx.x;
  const int row = tid >> 2, lane4 = tid & 3;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.x * kBQ;
  const long long q_stride = (long long)H * hd;       // between query positions
  const long long kv_stride = (long long)Hkv * hd;    // between key positions
  const long long v_stride = (long long)Hkv * vd;
  const T* qb = q + ((long long)b * Sq) * q_stride + (long long)h * hd;
  const T* kb = k + ((long long)b * Sk) * kv_stride + (long long)hk * hd;
  const T* vb = v + ((long long)b * Sk) * v_stride + (long long)hk * vd;

  for (int i = tid; i < kBQ * hd; i += kThreads) {
    const int r = i / hd, d = i % hd;
    qs[r * ldq + d] = (q0 + r < Sq) ? load_f32(qb, (size_t)((q0 + r) * q_stride + d)) : 0.0f;
  }

  // the key range this tile of rows can see
  const int qpos_lo = q_offset + q0;
  const int qpos_hi = q_offset + min(q0 + kBQ, Sq) - 1;
  int k_end = Sk;
  if (causal) k_end = min(Sk, qpos_hi + 1);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, qpos_lo - window + 1);
  k_begin = (k_begin / kBK) * kBK;

  const int my_q = q0 + row;
  const int my_pos = q_offset + my_q;
  float m_run = kNeg, l_run = 0.0f;
  float acc[COLS];
#pragma unroll
  for (int i = 0; i < COLS; ++i) acc[i] = 0.0f;

  for (int kt = k_begin; kt < k_end; kt += kBK) {
    __syncthreads();  // the previous tile's ks, vs and ps are consumed
    for (int i = tid; i < kBK * hd; i += kThreads) {
      const int j = i / hd, d = i % hd;
      ks[j * ldq + d] = (kt + j < Sk) ? load_f32(kb, (size_t)((kt + j) * kv_stride + d)) : 0.0f;
    }
    for (int i = tid; i < kBK * vd; i += kThreads) {
      const int j = i / vd, d = i % vd;
      vs[j * vd + d] = (kt + j < Sk) ? load_f32(vb, (size_t)((kt + j) * v_stride + d)) : 0.0f;
    }
    __syncthreads();

    // scores of this thread's keys 4 i + lane4
    float s[kKeys];
#pragma unroll
    for (int i = 0; i < kKeys; ++i) s[i] = 0.0f;
    const float* qr = qs + row * ldq;
    for (int d = 0; d < hd; ++d) {
      const float qv = qr[d];
#pragma unroll
      for (int i = 0; i < kKeys; ++i) s[i] = fmaf(qv, ks[(4 * i + lane4) * ldq + d], s[i]);
    }
    float tile_max = kNeg;
#pragma unroll
    for (int i = 0; i < kKeys; ++i) {
      const int kpos = kt + 4 * i + lane4;
      bool valid = kpos < Sk;
      if (causal) valid = valid && kpos <= my_pos;
      if (window > 0) valid = valid && kpos > my_pos - window;
      s[i] = valid ? s[i] * scale : kNeg;
      tile_max = fmaxf(tile_max, s[i]);
    }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
    const float m_new = fmaxf(m_run, tile_max);
    float psum = 0.0f;
#pragma unroll
    for (int i = 0; i < kKeys; ++i) {
      const float p = expf(s[i] - m_new);
      psum += p;
      ps[row * ldp + 4 * i + lane4] = p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    const float alpha = expf(m_run - m_new);
    l_run = l_run * alpha + psum;
    m_run = m_new;
    __syncwarp();  // the row's p values come from the four lanes of this warp

    const float* pr = ps + row * ldp;
#pragma unroll
    for (int i = 0; i < COLS; ++i) acc[i] *= alpha;
    for (int j = 0; j < kBK; ++j) {
      const float p = pr[j];
      const float* vr = vs + j * vd;
#pragma unroll
      for (int i = 0; i < COLS; ++i) {
        const int c = 4 * i + lane4;
        if (c < vd) acc[i] = fmaf(p, vr[c], acc[i]);
      }
    }
  }

  if (my_q < Sq) {
    const float inv = 1.0f / fmaxf(l_run, 1e-30f);
    if (lse != nullptr && lane4 == 0) lse[(long long)bh * Sq + my_q] = m_run + logf(l_run);
    T* orow = o + ((long long)b * Sq + my_q) * ((long long)H * vd) + (long long)h * vd;
#pragma unroll
    for (int i = 0; i < COLS; ++i) {
      const int c = 4 * i + lane4;
      if (c < vd) store_f32(orow, (size_t)c, acc[i] * inv);
    }
  }
}

template <typename T, int COLS>
int launch_cols(const void* q, const void* k, const void* v, void* o, float* lse, int B, int Sq,
                int Sk, int H, int Hkv, int hd, int vd, int q_offset, int causal, int window,
                float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(hd, vd);
  cudaError_t err = cudaFuncSetAttribute(flash_cc_kernel<T, COLS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((Sq + kBQ - 1) / kBQ), (unsigned)(B * H));
  flash_cc_kernel<T, COLS><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, Sq, Sk, H, Hkv, hd, vd, q_offset, causal,
      window, scale);
  return (int)cudaGetLastError();
}

// 32 output columns a thread up to vd = 128, 64 beyond.
template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int Sq,
           int Sk, int H, int Hkv, int hd, int vd, int q_offset, int causal, int window,
           float scale, cudaStream_t stream) {
  if (vd <= 128)
    return launch_cols<T, 32>(q, k, v, o, lse, B, Sq, Sk, H, Hkv, hd, vd, q_offset, causal,
                              window, scale, stream);
  return launch_cols<T, 64>(q, k, v, o, lse, B, Sq, Sk, H, Hkv, hd, vd, q_offset, causal, window,
                            scale, stream);
}

}  // namespace cc

}  // namespace

// window <= 0: no window.  tensor_cores != 0 takes the wgmma route (bf16,
// hd and vd multiples of 16 up to 256, 16-byte aligned rows); 0 the CUDA-core
// route (f32 or bf16, hd and vd up to 256).  ``lse``, when not null, receives each
// query row's logsumexp of the scaled, masked scores, (B, H, Sq) f32, for
// the backward kernel (flash_attention_bwd.cu).  Returns a CUDA error code
// (0 on success).
extern "C" int launch_flash_attention(const void* q, const void* k, const void* v, void* o,
                                      void* lse_out, int B, int Sq, int Sk, int H, int Hkv,
                                      int hd, int vd,
                                      int q_offset, int causal, int window, int dtype,
                                      int tensor_cores, float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (hd < 1 || hd > cc::kMaxD || vd < 1 || vd > cc::kMaxD || Hkv < 1 || H % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0 || H == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  float* lse = (float*)lse_out;
  if (tensor_cores) {
    if (dtype != kBF16 || hd % 16 != 0 || vd % 16 != 0) return (int)cudaErrorInvalidValue;
    switch ((hd + 63) / 64) {
      case 1: return tc::launch_vd<1>(q, k, v, o, lse, B, Sq, Sk, H, Hkv, hd, vd, q_offset, causal, window, scale, st);
      case 2: return tc::launch_vd<2>(q, k, v, o, lse, B, Sq, Sk, H, Hkv, hd, vd, q_offset, causal, window, scale, st);
      case 3: return tc::launch_vd<3>(q, k, v, o, lse, B, Sq, Sk, H, Hkv, hd, vd, q_offset, causal, window, scale, st);
      case 4: return tc::launch_vd<4>(q, k, v, o, lse, B, Sq, Sk, H, Hkv, hd, vd, q_offset, causal, window, scale, st);
    }
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == kF32)
    return cc::launch<float>(q, k, v, o, lse, B, Sq, Sk, H, Hkv, hd, vd, q_offset, causal, window,
                             scale, st);
  if (dtype == kBF16)
    return cc::launch<__nv_bfloat16>(q, k, v, o, lse, B, Sq, Sk, H, Hkv, hd, vd, q_offset, causal,
                                     window, scale, st);
  return (int)cudaErrorInvalidValue;
}
