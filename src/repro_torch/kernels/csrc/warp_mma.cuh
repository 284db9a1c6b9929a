// Warp tensor-core tiles shared by the attention kernels' mma.sync routes:
// kernel 16b's (csrc/flash_attention_bwd.cu, namespace wm) and 16j's and
// 16bj's (csrc/flash_attention_jvp.cu, namespace jm).  mma.sync m16n8k16
// with bf16 operands and f32 accumulators, ldmatrix from shared-memory rows
// padded by kPad bf16 (16 bytes: row starts land in different banks), tile
// loads of 16 bytes a thread, plain or by cp.async, for blocks of NT
// threads; and the conversion of a D-layout f32 tile into bf16 A
// fragments, where a kernel rounds P or dS before its next product.
#pragma once

#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"  // pack_bf16

namespace warp_mma {

using bf16 = __nv_bfloat16;

constexpr int kPad = 8;  // bf16 of padding a shared-memory row: ldmatrix rows 16 B apart

// D (16 x 8, f32) += A (16 x 16, bf16 row) B (16 x 8, bf16 col).  Fragments
// (lane l, g = l / 4, t = l % 4): a0 (row g, cols 2t, 2t+1), a1 (row g + 8),
// a2 (row g, cols + 8), a3 (row g + 8, cols + 8); b0 (rows 2t, 2t+1, col g),
// b1 (rows + 8); d0, d1 (row g, cols 2t, 2t+1), d2, d3 (row g + 8).
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// Four 8 x 8 bf16 matrices from shared memory, lane l giving the address of
// row l % 8 of matrix l / 8; register j holds matrix j's (row l / 4, cols
// 2 (l % 4), + 1), or with .trans its (rows 2 (l % 4), + 1, col l / 4).
__device__ __forceinline__ void ldsm4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm4t(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// Rows [r0, r0 + R) of one head of a (B, S, heads, dim) bf16 tensor into
// shared memory (ld elements a row), 16 bytes a thread of the block's NT,
// rows past S zero.
template <int NT>
__device__ __forceinline__ void load_tile(bf16* dst, int ld, const bf16* src,
                                          long long row_stride, int r0, int R, int S, int dim) {
  const int chunks = dim / 8;
  for (int i = threadIdx.x; i < R * chunks; i += NT) {
    const int r = i / chunks, c = (i % chunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < S) val = *reinterpret_cast<const uint4*>(src + (r0 + r) * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

// The same rows copied asynchronously (cp.async, 16 bytes a thread; a row
// past S is zero-filled, its source not read), for the caller to commit and
// wait on.
template <int NT>
__device__ __forceinline__ void load_tile_async(bf16* dst, int ld, const bf16* src,
                                                long long row_stride, int r0, int R, int S,
                                                int dim) {
  const int chunks = dim / 8;
  for (int i = threadIdx.x; i < R * chunks; i += NT) {
    const int r = i / chunks, c = (i % chunks) * 8;
    const bool in = r0 + r < S;
    const bf16* from = src + (in ? (r0 + r) * row_stride + c : 0);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 ::"r"(smem_u32(dst + r * ld + c)), "l"(from), "r"(in ? 16 : 0));
  }
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// C (16 x N) += A (16 rows at a) B^T (N rows at b), both rows of K
// contiguous bf16 in shared memory; C as N / 8 n-tiles of the mma's D
// layout.  N a multiple of 16 up to 64.
template <int N>
__device__ __forceinline__ void nt_16xN(float (*c)[4], const bf16* a, int lda, const bf16* b,
                                        int ldb, int K) {
  static_assert(N % 16 == 0 && N <= 64, "16 to 64 columns");
  const int lane = threadIdx.x & 31, r8 = lane & 7, j = lane >> 3;
  const uint32_t a_addr = smem_u32(a + (r8 + 8 * (j & 1)) * lda + 8 * (j >> 1));
  const uint32_t b_addr = smem_u32(b + (r8 + 8 * (j >> 1)) * ldb + 8 * (j & 1));
  for (int k = 0; k < K; k += 16) {
    uint32_t af[4];
    ldsm4(af, a_addr + 2 * k);
#pragma unroll
    for (int n = 0; n < N / 16; ++n) {  // n-tiles 2n, 2n + 1: rows 16n .. 16n + 15 of b
      uint32_t bf[4];
      ldsm4(bf, b_addr + 2 * (16 * n * ldb + k));
      mma_bf16(c[2 * n], af, bf[0], bf[1]);
      mma_bf16(c[2 * n + 1], af, bf[2], bf[3]);
    }
  }
}

// C (16 x N) += A (16 x 16 KS, KS k-steps of A fragments in registers) B
// (16 KS x N, row-major in shared memory), N a multiple of 16 up to MAXN
// (C holds MAXN / 8 n-tiles).
template <int KS = 4, int MAXN = 256>
__device__ __forceinline__ void nn_16xN(float (*c)[4], const uint32_t (*a)[4], const bf16* b,
                                        int ldb, int N) {
  const int lane = threadIdx.x & 31, r8 = lane & 7, j = lane >> 3;
  const uint32_t b_addr = smem_u32(b + (r8 + 8 * (j & 1)) * ldb + 8 * (j >> 1));
#pragma unroll
  for (int s = 0; s < KS; ++s) {
#pragma unroll
    for (int n = 0; n < MAXN / 16; ++n) {  // n-tiles 2n, 2n + 1: columns 16n .. 16n + 15
      if (16 * n < N) {
        uint32_t bf[4];
        ldsm4t(bf, b_addr + 2 * (16 * s * ldb + 16 * n));
        mma_bf16(c[2 * n], a[s], bf[0], bf[1]);
        mma_bf16(c[2 * n + 1], a[s], bf[2], bf[3]);
      }
    }
  }
}

// A (16 x 16 KS) fragments of a D-layout tile of 2 KS n-tiles, rounded to
// bf16.
template <int KS = 4>
__device__ __forceinline__ void to_a(uint32_t (*a)[4], const float (*x)[4]) {
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    a[s][0] = hopper::pack_bf16(x[2 * s][0], x[2 * s][1]);
    a[s][1] = hopper::pack_bf16(x[2 * s][2], x[2 * s][3]);
    a[s][2] = hopper::pack_bf16(x[2 * s + 1][0], x[2 * s + 1][1]);
    a[s][3] = hopper::pack_bf16(x[2 * s + 1][2], x[2 * s + 1][3]);
  }
}

}  // namespace warp_mma
