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
// What bounds it on an H100: bytes.  Three flops per element against 4-8
// bytes of u (plus ref), so the least time is the uplink (and a per-row ref)
// read once at 3.35 TB/s.  The TPU kernel keeps per-lane accumulators
// resident across a sequential grid over the row's width blocks; here blocks
// run in parallel and in no order, so the design is a reduction in two
// fixed-order passes:
//
//   1. block b covers one contiguous chunk of one row (the wrapper sizes
//      chunks so that about eight blocks per SM are in flight: at (500, 512)
//      one block per row, at (8, 2^20) 128 blocks per row).  Each thread
//      walks its chunk with 16-byte loads (4 f32 or 8 bf16; scalar loads when
//      W is not a multiple of them), keeps an f32 sum and a finite flag, and
//      the block reduces them by warp shuffles and then over its warps in
//      warp order;
//   2. with more than one chunk per row, one warp per row sums the row's
//      chunk partials, lane by lane in chunk order and then by shuffles.
//
// No atomics: the order of every sum is fixed by the shapes, so a result is
// the same from run to run.  It is not torch.sum's order, so sq agrees with
// the plain version to a rounding tolerance and finite exactly.
#include "common.cuh"

#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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

// one block per (row, chunk): b = row * chunks + c
template <typename T, bool kVec, bool kFinal>
__global__ void __launch_bounds__(kThreads)
screen_kernel(const T* __restrict__ u, const T* __restrict__ ref, int ref_per_row,
              long long W, long long chunks, long long chunk, float* __restrict__ sq_out,
              int* __restrict__ fin_part, uint8_t* __restrict__ fin_out) {
  const long long b = blockIdx.x;
  const long long row = b / chunks;
  const long long start = (b % chunks) * chunk;
  const long long end = min(W, start + chunk);
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
  __shared__ float s_sq[kWarps];
  __shared__ int s_fin[kWarps];
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
  const int lane = threadIdx.x % 32;
  float sq = 0.0f;
  int fin = 1;
  for (long long c = lane; c < chunks; c += 32) {
    sq = __fadd_rn(sq, sq_part[row * chunks + c]);
    fin &= fin_part[row * chunks + c];
  }
  for (int off = 16; off > 0; off >>= 1) sq = __fadd_rn(sq, __shfl_xor_sync(0xffffffffu, sq, off));
  fin = __all_sync(0xffffffffu, fin);
  if (lane == 0) {
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
