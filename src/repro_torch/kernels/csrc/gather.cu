// The cohort engine's row movement over the (m, W) population arena.  They
// replace, in src/repro/kernels/gather.py:
//
//   row_gather_pallas    out[t] = arr[idx[t]]               (mc rows)
//   row_scatter_pallas   out[i] = mask[i] ? rows[pos[i]] : dst[i]
//                                                            (m rows)
//
// The scatter is phrased, as on the TPU, as a gather over the population
// through the inverse position table pos[idx[t]] = t (built on the device
// by ops.row_scatter): every population row is written exactly once, so the
// result is a new buffer and the caller's state is left as it was (the
// reference's functional contract).  An in-place scatter of only the mc
// cohort rows would move (2 mc) W values instead of (2 m + mc) W; that is a
// later optimisation.
//
// What bounds them on an H100: bytes (a copy; no arithmetic).  The gather
// moves 2 mc W values, the scatter (2 m + mc) W.  The design: one block per
// output row, each thread copying 16-byte vectors (float4, or 8 bf16);
// W % 128 == 0 in the arena, so every row starts on a 16-byte boundary and
// is a whole number of vectors.  The kernels copy bytes and do not look at
// the dtype.  Row offsets are computed in 64 bits: m W exceeds 2^31 at the
// population sizes the cohort engine exists for (300k x 7,936).  The row
// ids are not checked here: cohort_indices draws them in range and
// distinct by construction, and the CPU's plain version (index_select)
// checks them.
#include "common.cuh"

namespace {

constexpr int kCopyThreads = 128;

template <typename Idx>
__global__ void __launch_bounds__(kCopyThreads)
row_gather_kernel(const uint4* __restrict__ src, const Idx* __restrict__ idx,
                  size_t row_vec, uint4* __restrict__ out) {
  const size_t t = blockIdx.x;
  const uint4* from = src + (size_t)idx[t] * row_vec;
  uint4* to = out + t * row_vec;
  for (size_t j = threadIdx.x; j < row_vec; j += kCopyThreads) to[j] = from[j];
}

__global__ void __launch_bounds__(kCopyThreads)
row_scatter_kernel(const uint4* __restrict__ dst, const int* __restrict__ pos,
                   const int* __restrict__ mask, const uint4* __restrict__ rows,
                   size_t row_vec, uint4* __restrict__ out) {
  const size_t i = blockIdx.x;
  const uint4* from = mask[i] != 0 ? rows + (size_t)pos[i] * row_vec : dst + i * row_vec;
  uint4* to = out + i * row_vec;
  for (size_t j = threadIdx.x; j < row_vec; j += kCopyThreads) to[j] = from[j];
}

}  // namespace

extern "C" int launch_row_gather(const void* arr, const void* idx, int idx_is_64,
                                 long long mc, long long row_bytes, void* out, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (row_bytes % 16 != 0) return (int)cudaErrorInvalidValue;
  if (mc == 0 || row_bytes == 0) return (int)cudaGetLastError();
  const size_t row_vec = (size_t)row_bytes / 16;
  if (idx_is_64) {
    row_gather_kernel<long long><<<(unsigned)mc, kCopyThreads, 0, (cudaStream_t)stream>>>(
        (const uint4*)arr, (const long long*)idx, row_vec, (uint4*)out);
  } else {
    row_gather_kernel<int><<<(unsigned)mc, kCopyThreads, 0, (cudaStream_t)stream>>>(
        (const uint4*)arr, (const int*)idx, row_vec, (uint4*)out);
  }
  return (int)cudaGetLastError();
}

extern "C" int launch_row_scatter(const void* dst, const void* pos, const void* mask,
                                  const void* rows, long long m, long long row_bytes, void* out,
                                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (row_bytes % 16 != 0) return (int)cudaErrorInvalidValue;
  if (m == 0 || row_bytes == 0) return (int)cudaGetLastError();
  row_scatter_kernel<<<(unsigned)m, kCopyThreads, 0, (cudaStream_t)stream>>>(
      (const uint4*)dst, (const int*)pos, (const int*)mask, (const uint4*)rows,
      (size_t)row_bytes / 16, (uint4*)out);
  return (int)cudaGetLastError();
}
