// The cohort engine's row movement over the population buffers.  They
// replace, in src/repro/kernels/gather.py:
//
//   row_gather_pallas    out[t] = arr[idx[t]]                (mc rows)
//   row_scatter_pallas   out[i] = mask[i] ? rows[pos[i]] : dst[i]
//
// Both take a table of up to kMaxBufs buffers -- a round's lam, x_c, u_hat
// or c_i, each (m, W_b) of its own dtype and width -- and move the mc
// cohort rows of every buffer in one launch:
//
//   launch_row_gather    cohort_b[t] = pop_b[idx[t]]
//   launch_row_scatter   pop_b[idx[t]] = cohort_b[t]        (in place)
//
// The TPU kernel phrases the scatter as a gather over the whole population
// through the inverse position table pos[idx[t]] = t, so every population
// row is written once into a new buffer (no aliasing contract).  Here the
// scatter writes the mc cohort rows of the population buffer in place and
// touches no other row: 2 mc W values where the TPU's phrasing moves
// (2 m + mc) W, with no pos/mask tables to build.  The reference's own XLA
// path does the same when the round state is donated; the caller that must
// keep its buffer (ops.row_scatter, a functional round) copies it first.
//
// What bounds them on an H100: bytes (a copy; no arithmetic), 2 mc
// sum_b row_bytes_b plus the ids.  The design fills the card at every row
// size: a block copies one chunk of one row (kChunkVecs 16-byte vectors,
// 16 KiB), so a 4 MiB row (the reference benchmark's lm_flat) spreads over
// 256 blocks and a cohort of 4 rows of two buffers over 2,048 -- about one
// full wave of 16 blocks on each of the 132 SMs.  Each thread issues its
// kUnroll independent 16-byte loads before its stores, neighbouring threads
// on neighbouring vectors.  A block finds its buffer by a walk over the
// table's first blocks (at most kMaxBufs) and its row and chunk by one
// division.  The table goes by value as one __grid_constant__ parameter:
// no copy to the device, no allocation.
//
// Rows are whole 16-byte vectors (W % 128 == 0 in the arena; the wrapper
// checks row_bytes % 16), and the kernels copy bytes without looking at the
// dtype, so results are bitwise the plain index_select / index_copy_.  Row
// offsets are 64-bit: m W passes 2^31 at the populations the cohort engine
// exists for (10^6 x 1,024).  The ids are not checked here: cohort_indices
// draws them in range and distinct, and the CPU's plain versions
// (index_select, index_copy_) check the range.  The cohort rows must not
// overlap the population buffers.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 8;
constexpr long long kChunkVecs = (long long)kThreads * kUnroll;
constexpr int kMaxBufs = 8;
constexpr int kDescWords = 3;  // int64 words a buffer in the host's descriptor

struct Buf {
  uint4* pop;          // (m, row_vec) population rows
  uint4* cohort;       // (mc, row_vec) cohort rows
  long long row_vec;   // 16-byte vectors a row
  long long chunks;    // blocks a row
  long long block0;    // the buffer's first block
};

struct Table {
  const void* idx;  // (mc,) int32 or int64 row ids
  int nbuf;
  Buf buf[kMaxBufs];
};

static_assert(sizeof(Buf) == 40, "buffer table layout");

template <typename Idx, bool kScatter>
__global__ void __launch_bounds__(kThreads)
row_copy_kernel(const __grid_constant__ Table tab) {
  const long long b = blockIdx.x;
  int s = 0;
  while (s + 1 < tab.nbuf && tab.buf[s + 1].block0 <= b) ++s;
  const Buf& buf = tab.buf[s];
  const long long rel = b - buf.block0;
  const long long t = rel / buf.chunks;
  const long long c = rel - t * buf.chunks;
  const long long p = (long long)static_cast<const Idx*>(tab.idx)[t];
  const long long rv = buf.row_vec;
  const uint4* __restrict__ from = kScatter ? buf.cohort + t * rv : buf.pop + p * rv;
  uint4* __restrict__ to = kScatter ? buf.pop + p * rv : buf.cohort + t * rv;
  const long long j0 = c * kChunkVecs + threadIdx.x;
  uint4 v[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long j = j0 + (long long)u * kThreads;
    if (j < rv) v[u] = __ldg(from + j);
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long j = j0 + (long long)u * kThreads;
    if (j < rv) to[j] = v[u];
  }
}

template <bool kScatter>
int launch_rows(const void* desc, int nbuf, const void* idx, int idx_is_64, long long mc,
                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nbuf < 1 || nbuf > kMaxBufs || mc < 1) return (int)cudaErrorInvalidValue;
  const long long* d = static_cast<const long long*>(desc);
  Table tab;
  tab.idx = idx;
  tab.nbuf = nbuf;
  long long blocks = 0;
  for (int i = 0; i < nbuf; ++i) {
    const long long* r = d + (size_t)kDescWords * i;
    const long long row_bytes = r[2];
    if (row_bytes <= 0 || row_bytes % 16 != 0 || r[0] % 16 != 0 || r[1] % 16 != 0)
      return (int)cudaErrorInvalidValue;
    Buf& bf = tab.buf[i];
    bf.pop = reinterpret_cast<uint4*>(r[0]);
    bf.cohort = reinterpret_cast<uint4*>(r[1]);
    bf.row_vec = row_bytes / 16;
    bf.chunks = (bf.row_vec + kChunkVecs - 1) / kChunkVecs;
    bf.block0 = blocks;
    blocks += mc * bf.chunks;
  }
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (idx_is_64)
    row_copy_kernel<long long, kScatter><<<(unsigned)blocks, kThreads, 0, st>>>(tab);
  else
    row_copy_kernel<int, kScatter><<<(unsigned)blocks, kThreads, 0, st>>>(tab);
  return (int)cudaGetLastError();
}

}  // namespace

// desc: nbuf rows of kDescWords int64 -- the population buffer's address,
// the cohort buffer's address, the bytes of a row (a multiple of 16); every
// address 16-byte aligned.  idx: mc row ids, int64 if idx_is_64 else int32.
extern "C" int launch_row_gather(const void* desc, int nbuf, const void* idx, int idx_is_64,
                                 long long mc, int device, void* stream) {
  return launch_rows<false>(desc, nbuf, idx, idx_is_64, mc, device, stream);
}

extern "C" int launch_row_scatter(const void* desc, int nbuf, const void* idx, int idx_is_64,
                                  long long mc, int device, void* stream) {
  return launch_rows<true>(desc, nbuf, idx, idx_is_64, mc, device, stream);
}
