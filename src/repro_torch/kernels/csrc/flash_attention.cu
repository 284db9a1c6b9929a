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
// materialised.  Inputs are all f32 or all bf16, hd = vd <= 128, any Sq and
// Sk (a ragged last tile is masked).
//
// What bounds it on an H100: operations.  About 2 Sq Sk hd multiply-adds per
// head for the scores and as many for p v, half of that under the causal
// mask, against 2 Sq hd + 2 Sk hd values moved.  At the prefill shape
// (4, 1024, 16, 128) that is 17 GFLOP of valid (query, key) pairs against
// 67 MB.  This first
// version runs the products on the CUDA cores in f32, not on the tensor
// cores (wgmma, TMA and a tiled bf16 pipeline are later work), so it sits
// far above the bf16 tensor-core bound.
//
// Design.  One block per (query tile of 64 rows, b * H + h), 256 threads.
// The block holds its q tile in shared memory as f32 and walks the key tiles
// (64 keys) from the window's first tile up to the causal limit; tiles that
// are wholly masked for every row of the block are skipped (the Pallas
// kernel visits them, but their weight is wiped by the first valid tile, so
// the result agrees up to rounding).  Thread t owns row t / 4 of the tile
// and, of that row, keys j = 4 i + t % 4 of the score tile and output columns
// 4 i + t % 4: the four threads of a row are neighbouring lanes of one warp
// and combine their row maximum and sum by shuffles.  q and k rows are padded
// to hd + 1 floats in shared memory and the p tile to 65, so that the warp's
// eight rows and four key groups fall on distinct banks.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;         // query rows per block
constexpr int kBK = 64;         // keys per tile
constexpr int kMaxD = 128;      // largest head dim
constexpr int kCols = kMaxD / 4;  // output columns a thread owns
constexpr int kKeys = kBK / 4;    // score columns a thread owns
constexpr float kNeg = -1e30f;

size_t smem_bytes(int hd, int vd) {
  return sizeof(float) * ((size_t)kBQ * (hd + 1) + (size_t)kBK * (hd + 1) + (size_t)kBK * vd +
                          (size_t)kBQ * (kBK + 1));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ o, int Sq, int Sk, int H, int Hkv, int hd, int vd, int q_offset,
             int causal, int window, float scale) {
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
  float acc[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) acc[i] = 0.0f;

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
    for (int i = 0; i < kCols; ++i) acc[i] *= alpha;
    for (int j = 0; j < kBK; ++j) {
      const float p = pr[j];
      const float* vr = vs + j * vd;
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        const int c = 4 * i + lane4;
        if (c < vd) acc[i] = fmaf(p, vr[c], acc[i]);
      }
    }
  }

  if (my_q < Sq) {
    const float inv = 1.0f / fmaxf(l_run, 1e-30f);
    T* orow = o + ((long long)b * Sq + my_q) * ((long long)H * vd) + (long long)h * vd;
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      const int c = 4 * i + lane4;
      if (c < vd) store_f32(orow, (size_t)c, acc[i] * inv);
    }
  }
}

template <typename T>
int flash_typed(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk,
                int H, int Hkv, int hd, int vd, int q_offset, int causal, int window,
                float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(hd, vd);
  cudaError_t err = cudaFuncSetAttribute(flash_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((Sq + kBQ - 1) / kBQ), (unsigned)(B * H));
  flash_kernel<T><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, Sq, Sk, H, Hkv, hd, vd, q_offset, causal,
      window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// window <= 0: no window.  Returns a CUDA error code (0 on success).
extern "C" int launch_flash_attention(const void* q, const void* k, const void* v, void* o,
                                      int B, int Sq, int Sk, int H, int Hkv, int hd, int vd,
                                      int q_offset, int causal, int window, int dtype,
                                      float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (hd < 1 || hd > kMaxD || vd < 1 || vd > kMaxD || Hkv < 1 || H % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0 || H == 0) return (int)cudaGetLastError();
  if (dtype == kF32)
    return flash_typed<float>(q, k, v, o, B, Sq, Sk, H, Hkv, hd, vd, q_offset, causal, window,
                              scale, (cudaStream_t)stream);
  if (dtype == kBF16)
    return flash_typed<__nv_bfloat16>(q, k, v, o, B, Sq, Sk, H, Hkv, hd, vd, q_offset, causal,
                                      window, scale, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}
