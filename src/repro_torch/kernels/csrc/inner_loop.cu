// The whole K-step eq. (20) client loop for affine gradient oracles.
//
// Replaces src/repro/kernels/inner_loop.py:100 (inner_loop_affine_pallas).
// Per client i, with g = H_i x - (c_i + off_i):
//     x <- x - step_i * (g + rho * (x - x_s) + lam_i)        (K times)
// and writes x_K and x_bar = (sum_k x_k) * (1/K).
//
// What bounds it on an H100: H's bytes, read once.  The matvec is 2 W^2
// flop a step, far below the f32 rate, and the rows are W values; the
// (m, W, W) f32 stack is all that matters -- 524 MB at m = 500, W = 512,
// ten times the 50 MB L2, so 0.158 ms at 3.35 TB/s if it is read once.
// One client's H is 1 MiB at W = 512, more than the 227 KB of shared
// memory one block may hold, which is what the two routes are about:
//
// * Resident route (W <= 640): a thread-block cluster of C blocks of 512
//   threads per client.  Block r of the cluster owns the W / C contiguous
//   rows [r W / C, (r + 1) W / C) of H_i, its "slab", and each warp holds
//   its rows of the slab in registers for all K steps -- RPW rows, every
//   lane W / 32 columns of each, at most 64 floats a thread -- so H is read
//   from device memory once per launch.  C is the fewest blocks (a power
//   of two, at most 16) that keep that fragment within 64 floats, so it is
//   fixed by W (the table in `resident` below, inner_loop.py's
//   cluster_size): 1 at W = 128, 2 at 256, 8 at 384 and 512 (64 rows a
//   block, 4 a warp), 16 at 640.  Per step, each warp multiplies
//   its rows with x (the whole x, from shared memory); its shuffle tree
//   leaves each row's sum on a group of 32 / RPW lanes, which apply eq. (20)
//   to it (the update is elementwise) and keep the row's x and x sum in
//   registers; the block's new rows go into its other copy of x, and after
//   a block barrier one thread a peer sends them to that peer's copy as one
//   bulk copy (cp.async.bulk shared::cta -> shared::cluster), counted on the
//   peer's mbarrier for that copy, on which the next step waits.  The copies
//   alternate, so no step waits on a cluster-wide barrier.  (A cluster
//   barrier a step, or one 4-byte remote store a row and a peer each counted
//   on the peer's mbarrier, made the exchange, not the matvec, the cost of a
//   step in trials.)
//   The clusters are persistent: the grid is as many clusters as the card
//   runs at once (cudaOccupancyMaxActiveClusters, one block an SM), and
//   each walks clients i, i + ncl, ....  While it runs a client's K steps
//   out of registers, the next client's slab, x0 row and c, off and lam
//   rows arrive in a staging area in shared memory as bulk copies
//   (cp.async.bulk onto one mbarrier), so loads and steps overlap.
//   Budget at (m, W, K) = (500, 512, 5): H once is 524 MB, 0.158 ms; 15
//   clusters of 8 each stage 1 MiB a client, 4.7 us at the full rate,
//   against the register copy of the slab (128 KB from shared memory, about
//   0.6 us, not overlapped with the next load) and K steps of 64 FMAs a
//   thread, a shuffle tree, a block barrier and the exchange each: bound by
//   the bytes, plus the copy.  Shared memory a block: 138,016 bytes at
//   W = 512 (the staging slab of 128 KB and two copies of x).
// * Streaming route (W >= 768, where no C <= 16 keeps the fragment within
//   64 floats): one block per client keeps only the client's rows on chip --
//   x, the x sum, c + off, x_s, lam and g, 6 rows, 24 KB at W = 1024 -- and
//   re-reads H from device memory on every step: K reads of H in all.
//
// Both routes take each row of H on one warp: float4 partial sums over
// columns lane, lane + 32, ... (in 4-column groups), then a shuffle tree --
// the same f32 operations in the same order, so they give the same g bit for
// bit.  The matvec sums in another order than the reference's einsum, so it
// agrees to rounding (rtol = atol = 1e-4); the eq. (20) update is bitwise
// the reference's f32 arithmetic (common.cuh eq20).
//
// Operands: x0, c, lam, off, x_K, x_bar are (m, W) rows; H is (m, W, W);
// x_s is (W,); step is an (m,) f32 array or, when null, the scalar `step`.
// lam and off may be null.  H and c are f32; x0 (and so x_K, x_bar) is f32
// or bf16, and x_s, lam and off each f32 or bf16 (DType codes): every
// operand is upcast on load, the K steps run in f32, and the outputs are
// rounded once at the end to x0's dtype, as the Pallas kernel does.
// W % 128 == 0 (arena layout).
#include "common.cuh"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

// ---------------------------------------------------------------------------
// g_j = sum_e H[j, e] x[e] on one warp (both routes)
// ---------------------------------------------------------------------------
__device__ __forceinline__ float warp_sum(float acc) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  return acc;
}

__device__ __forceinline__ float dot4(const float4 h, const float4 x, float acc) {
  acc = fmaf(h.x, x.x, acc);
  acc = fmaf(h.y, x.y, acc);
  acc = fmaf(h.z, x.z, acc);
  return fmaf(h.w, x.w, acc);
}

// ---------------------------------------------------------------------------
// streaming route: one block per client, H from device memory every step
// ---------------------------------------------------------------------------
constexpr int kThreads = 512;

template <typename T>
__global__ void __launch_bounds__(kThreads)
inner_loop_stream_kernel(const T* __restrict__ x0, const float* __restrict__ H,
                         const float* __restrict__ c, const void* xs, const void* lam,
                         const void* off, int xs_dt, int lam_dt, int off_dt,
                         const float* __restrict__ step_arr, float step, float rho,
                         float inv_k, int K, int W, T* __restrict__ x_out,
                         T* __restrict__ xbar_out) {
  extern __shared__ __align__(16) float smem[];
  float* x = smem;
  float* xsum = x + W;
  float* cc = xsum + W;
  float* s_xs = cc + W;
  float* s_lam = s_xs + W;
  float* g = s_lam + W;

  const int i = blockIdx.x;
  const size_t row = (size_t)i * W;
  const float* Hi = H + (size_t)i * W * W;
  const float st = step_arr != nullptr ? step_arr[i] : step;
  const bool has_lam = lam != nullptr;

  for (int e = threadIdx.x; e < W; e += blockDim.x) {
    x[e] = load_f32(x0, row + e);
    xsum[e] = 0.0f;
    float cv = c[row + e];
    if (off != nullptr) cv = __fadd_rn(cv, load_any(off, off_dt, row + e));
    cc[e] = cv;
    s_xs[e] = load_any(xs, xs_dt, e);
    s_lam[e] = has_lam ? load_any(lam, lam_dt, row + e) : 0.0f;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int w4 = W >> 2;
  const float4* xv = reinterpret_cast<const float4*>(x);

  for (int k = 0; k < K; ++k) {
    for (int j = warp; j < W; j += nwarps) {
      const float4* hrow = reinterpret_cast<const float4*>(Hi + (size_t)j * W);
      float acc = 0.0f;
      for (int q = lane; q < w4; q += 32) acc = dot4(__ldg(hrow + q), xv[q], acc);
      acc = warp_sum(acc);
      if (lane == 0) g[j] = __fsub_rn(acc, cc[j]);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < W; e += blockDim.x) {
      const float xn = eq20(x[e], g[e], s_xs[e], s_lam[e], has_lam, st, rho);
      x[e] = xn;
      xsum[e] = __fadd_rn(xsum[e], xn);
    }
    __syncthreads();
  }

  for (int e = threadIdx.x; e < W; e += blockDim.x) {
    store_f32(x_out, row + e, x[e]);
    store_f32(xbar_out, row + e, __fmul_rn(xsum[e], inv_k));
  }
}

// ---------------------------------------------------------------------------
// resident route: one cluster of C blocks per client, H_i's slabs in registers
// ---------------------------------------------------------------------------
constexpr int kResThreads = 512;
constexpr int kResWarps = kResThreads / 32;
constexpr int kHeadBytes = 32;  // mbarriers: the staging area's, and one per copy of x
constexpr int kCopies = 4;      // bulk copies a slab is staged in

// Bytes of dynamic shared memory a block: the mbarriers; the staging area
// for the next client (its slab of rows x W, its x0 row and its c, off and
// lam rows); two copies of x.
// inner_loop.py's resident_smem_bytes is the same sum.
size_t resident_smem(int W, int rows) {
  return kHeadBytes + sizeof(float) * ((size_t)rows * W + 3 * (size_t)W + 3 * (size_t)rows);
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The address of `p` in the shared memory of the cluster's block `rank`.
__device__ __forceinline__ uint32_t peer_addr(const void* p, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(smem_u32(p)), "r"(rank));
  return out;
}

// Copy `bytes` of this block's shared memory at `src` to a peer's at `dst`,
// counted on the peer's mbarrier `bar` (`dst` and `bar` cluster addresses).
__device__ __forceinline__ void copy_to_peer(uint32_t dst, const void* src, uint32_t bytes,
                                             uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      ::"r"(dst), "r"(smem_u32(src)), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ uint32_t dt_bytes(int dtype) { return dtype == kBF16 ? 2u : 4u; }

// Client i's slab (rows r0 .. r0 + rows of H_i), x0 row and c, off and lam
// rows into the staging area, completing on `bar`; one thread issues it.
template <typename T>
__device__ void stage_client(float* stage, uint64_t* bar, int i, int r0, int rows, int W,
                             const T* x0, const float* H, const float* c, const void* off,
                             const void* lam, int off_dt, int lam_dt) {
  const size_t row = (size_t)i * W + r0;
  const uint32_t slab = (uint32_t)(sizeof(float) * rows * W);
  const uint32_t xbytes = (uint32_t)(sizeof(T) * W);
  const uint32_t cbytes = (uint32_t)(sizeof(float) * rows);
  const uint32_t obytes = off != nullptr ? dt_bytes(off_dt) * rows : 0u;
  const uint32_t lbytes = lam != nullptr ? dt_bytes(lam_dt) * rows : 0u;
  mbar_expect_tx(bar, slab + xbytes + cbytes + obytes + lbytes);
  const char* h = reinterpret_cast<const char*>(H + row * W);
  char* dst = reinterpret_cast<char*>(stage);
  for (int q = 0; q < kCopies; ++q)
    bulk_load(dst + q * (slab / kCopies), h + q * (slab / kCopies), slab / kCopies, bar);
  float* rest = stage + (size_t)rows * W;
  bulk_load(rest, x0 + (size_t)i * W, xbytes, bar);
  bulk_load(rest + W, c + row, cbytes, bar);
  if (obytes) bulk_load(rest + W + rows, static_cast<const char*>(off) + dt_bytes(off_dt) * row,
                        obytes, bar);
  if (lbytes) bulk_load(rest + W + 2 * rows,
                        static_cast<const char*>(lam) + dt_bytes(lam_dt) * row, lbytes, bar);
}

__host__ __device__ constexpr int pow2_at_least(int n) {
  return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2);
}
__host__ __device__ constexpr int log2_of(int n) { return n <= 1 ? 0 : 1 + log2_of(n / 2); }

// NQ = W / 128 float4 columns a lane holds of each row; RPW rows a warp
// owns (rows j = warp + 16 t, t < RPW, those below `rows`).
template <typename T, int NQ, int RPW>
__global__ void __launch_bounds__(kResThreads, 1)
inner_loop_resident_kernel(const T* __restrict__ x0, const float* __restrict__ H,
                           const float* __restrict__ c, const void* xs, const void* lam,
                           const void* off, int xs_dt, int lam_dt, int off_dt,
                           const float* __restrict__ step_arr, float step, float rho,
                           float inv_k, int K, int m, int rows, T* __restrict__ x_out,
                           T* __restrict__ xbar_out) {
  constexpr int W = NQ * 128;
  // A warp's row sums: its RPW rows padded to R2 = 2^L, whose shuffle tree
  // halves the rows a lane holds at each of the first L levels (lanes whose
  // bit 4 - s is set keep the upper half), so that lane l ends with the sum
  // of row t = l >> (5 - L), the same group of G = 32 / R2 lanes for each row.
  constexpr int R2 = pow2_at_least(RPW);
  constexpr int L = log2_of(R2);
  constexpr int G = 32 / R2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw);  // the staging area's
  uint64_t* xbar = bar + 1;  // xbar[b]: copy b of x has arrived whole
  float* stage = reinterpret_cast<float*>(smem_raw + kHeadBytes);
  float* xbuf = stage + (size_t)rows * W + W + 3 * rows;  // two copies of x

  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int ncl = gridDim.x / C;
  const int r0 = rank * rows;  // this block's first row of H_i and element of x
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const bool has_lam = lam != nullptr;
  const T* sx0 = reinterpret_cast<const T*>(stage + (size_t)rows * W);
  const float* sc = stage + (size_t)rows * W + W;
  // the row whose sum this lane ends with, and its place in the row's group
  const int t_mine = lane >> (5 - L);
  const int g = lane & (G - 1);
  const int j_mine = warp + kResWarps * t_mine;
  const bool mine = t_mine < RPW && j_mine < rows;

  if (tid == 0) {
    for (int b = 0; b < 3; ++b) mbar_init(bar + b, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  int i = blockIdx.x / C;  // clients i, i + ncl, ...: the grid is as many clusters as fit
  if (tid == 0)
    stage_client(stage, bar, i, r0, rows, W, x0, H, c, off, lam, off_dt, lam_dt);
  const float xs_j = mine ? load_any(xs, xs_dt, r0 + j_mine) : 0.0f;
  float st_next = step_arr != nullptr ? step_arr[i] : step;
  // every block of the cluster has started: its shared memory may be written
  cluster.sync();

  // x^k of a client lives in copy (base + k) & 1, and base moves on by K - 1
  // a client, so that the exchanges (x^1 .. x^{K-1} of every client; x^K
  // stays in registers) alternate between the two copies and their
  // mbarriers for the whole launch: a block sends into a copy only after it
  // has waited for the other one, so no exchange's bytes reach an mbarrier
  // before its previous phase has completed.
  int base = 0;
  uint32_t xphase = 0;  // bit b: the parity of xbar[b]'s next phase
  float4 hreg[RPW][NQ];
  for (int n = 0; i < m; i += ncl, ++n) {
    mbar_wait(bar, n & 1);
#pragma unroll
    for (int t = 0; t < RPW; ++t) {
      const int j = warp + kResWarps * t;
      const float4* hrow = reinterpret_cast<const float4*>(stage + (size_t)j * W);
#pragma unroll
      for (int q = 0; q < NQ; ++q)
        hreg[t][q] = j < rows ? hrow[lane + 32 * q] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    float* x_0 = xbuf + (base & 1) * W;
    for (int e = tid; e < W; e += kResThreads) x_0[e] = load_f32(sx0, e);
    float xj = 0.0f, cc_j = 0.0f, lam_j = 0.0f;  // this lane's row: x, c + off, lam
    if (mine) {
      xj = load_f32(sx0, r0 + j_mine);
      cc_j = sc[j_mine];
      if (off != nullptr) cc_j = __fadd_rn(cc_j, load_any(sc + rows, off_dt, j_mine));
      if (has_lam) lam_j = load_any(sc + 2 * rows, lam_dt, j_mine);
    }
    const float st = st_next;
    const int next = i + ncl;
    if (step_arr != nullptr && next < m) st_next = step_arr[next];
    __syncthreads();  // the staging area is read: the next client's copies may land
    if (tid == 0 && next < m)
      stage_client(stage, bar, next, r0, rows, W, x0, H, c, off, lam, off_dt, lam_dt);

    float xsum = 0.0f;
    for (int k = 0; k < K; ++k) {
      const int cur = (base + k) & 1;
      if (k > 0 && C > 1) {  // x^k from every other block
        mbar_wait(xbar + cur, (xphase >> cur) & 1, /*cluster=*/true);
        xphase ^= 1u << cur;
      }
      const float* xc = xbuf + cur * W;
      float4 xr[NQ];  // this lane's columns of x, the same for every row
#pragma unroll
      for (int q = 0; q < NQ; ++q) xr[q] = reinterpret_cast<const float4*>(xc)[lane + 32 * q];
      float acc[R2];
#pragma unroll
      for (int t = 0; t < R2; ++t) {
        acc[t] = 0.0f;
        if (t < RPW) {
#pragma unroll
          for (int q = 0; q < NQ; ++q) acc[t] = dot4(hreg[t][q], xr[q], acc[t]);
        }
      }
      // the shuffle tree: each level adds the partner lane's partial of the
      // same row, as a tree over all R2 rows would (the same sums bit for bit)
#pragma unroll
      for (int s = 0; s < L; ++s) {
        const int half = R2 >> (s + 1);
        const bool upper = (lane >> (4 - s)) & 1;
#pragma unroll
        for (int u = 0; u < half; ++u) {
          const float keep = upper ? acc[u + half] : acc[u];
          const float give = upper ? acc[u] : acc[u + half];
          acc[u] = keep + __shfl_xor_sync(0xffffffffu, give, 16 >> s);
        }
      }
#pragma unroll
      for (int o = 16 >> L; o > 0; o >>= 1) acc[0] += __shfl_xor_sync(0xffffffffu, acc[0], o);
      // eq. (20) on this lane's row, the new value into this block's other
      // copy of x (x^{k+1}; the last step's x stays in registers), and then
      // the block's rows of it, one bulk copy to each peer
      const int nxt = cur ^ 1;
      float* xn = xbuf + nxt * W;
      if (k + 1 < K && tid == 0 && C > 1)
        mbar_expect_tx(xbar + nxt, sizeof(float) * (W - rows));
      if (mine) {
        const float v = eq20(xj, __fsub_rn(acc[0], cc_j), xs_j, lam_j, has_lam, st, rho);
        xj = v;
        xsum = __fadd_rn(xsum, v);
        if (g == 0) xn[r0 + j_mine] = v;
      }
      if (k + 1 < K) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for the copies
        __syncthreads();
        if (tid < C - 1) {
          const int p = tid < rank ? tid : tid + 1;
          copy_to_peer(peer_addr(xn + r0, p), xn + r0, sizeof(float) * rows,
                       peer_addr(xbar + nxt, p));
        }
      }
    }
    base += K - 1;

    if (mine && g == 0) {
      const size_t e = (size_t)i * W + r0 + j_mine;
      store_f32(x_out, e, xj);
      store_f32(xbar_out, e, __fmul_rn(xsum, inv_k));
    }
    __syncthreads();  // every warp is done with this client's copy of x
  }
  // The last exchange's bulk copies read this block's shared memory, and only
  // their receivers wait for them: once every block has passed this barrier,
  // each has waited for all the copies into it, so none is still reading.
  cluster.sync();
}

struct Args {
  const void *x0, *H, *c, *xs, *lam, *off, *step_arr;
  float step, rho, inv_k;
  int K, m, W, xs_dt, lam_dt, off_dt;
  void *x_out, *xbar_out;
};

template <typename T>
int launch_stream(const Args& a, cudaStream_t stream) {
  const size_t smem = 6 * (size_t)a.W * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(inner_loop_stream_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  inner_loop_stream_kernel<T><<<a.m, kThreads, smem, stream>>>(
      (const T*)a.x0, (const float*)a.H, (const float*)a.c, a.xs, a.lam, a.off, a.xs_dt,
      a.lam_dt, a.off_dt, (const float*)a.step_arr, a.step, a.rho, a.inv_k, a.K, a.W,
      (T*)a.x_out, (T*)a.xbar_out);
  return (int)cudaGetLastError();
}

// Launch the resident route with clusters of `cluster` blocks, as many
// clusters as the card runs at once (at most m), or, with `max_clusters`
// set, only report that number.
template <typename T, int NQ, int RPW>
int launch_resident(const Args& a, int cluster, cudaStream_t stream, int* max_clusters) {
  const int rows = a.W / cluster;
  const size_t smem = resident_smem(a.W, rows);
  auto kern = inner_loop_resident_kernel<T, NQ, RPW>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && cluster > 8)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)cluster);
  cfg.blockDim = dim3(kResThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  static int fit_by_device[64] = {};  // the query costs host time: once per device
  int device = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  int fit = device < 64 ? fit_by_device[device] : 0;
  if (fit == 0) {
    err = cudaOccupancyMaxActiveClusters(&fit, (const void*)kern, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (device < 64) fit_by_device[device] = fit;
  }
  if (max_clusters != nullptr) {
    *max_clusters = fit;
    return 0;
  }
  if (fit < 1) return (int)cudaErrorInvalidConfiguration;
  cfg.gridDim = dim3((unsigned)((a.m < fit ? a.m : fit) * cluster));
  err = cudaLaunchKernelEx(&cfg, kern, (const T*)a.x0, (const float*)a.H, (const float*)a.c,
                           a.xs, a.lam, a.off, a.xs_dt, a.lam_dt, a.off_dt,
                           (const float*)a.step_arr, a.step, a.rho, a.inv_k, a.K, a.m, rows,
                           (T*)a.x_out, (T*)a.xbar_out);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The resident route's instantiations, one a width: NQ = W / 128, the
// cluster C (inner_loop.py's cluster_size: the fewest blocks that keep RPW x
// NQ float4 of the slab within 64 floats a thread) and RPW = ceil(W / C / 16)
// rows a warp.  W / C is a multiple of 8, so every staged row slice is a
// whole number of 16 bytes.
template <typename T>
int resident(const Args& a, cudaStream_t stream, int* max_clusters) {
  switch (a.W) {
    case 128: return launch_resident<T, 1, 8>(a, 1, stream, max_clusters);
    case 256: return launch_resident<T, 2, 8>(a, 2, stream, max_clusters);
    case 384: return launch_resident<T, 3, 3>(a, 8, stream, max_clusters);
    case 512: return launch_resident<T, 4, 4>(a, 8, stream, max_clusters);
    case 640: return launch_resident<T, 5, 3>(a, 16, stream, max_clusters);
    default: return (int)cudaErrorInvalidValue;
  }
}

// resident_route: 1 for the resident route (the widths `resident` takes),
// 0 for the streaming route (any width).
int dispatch(int dtype, const Args& a, int resident_route, cudaStream_t stream,
             int* max_clusters) {
  const bool dt_ok = (dtype == kF32 || dtype == kBF16) && a.xs_dt >= kF32 &&
                     a.xs_dt <= kBF16 && a.lam_dt >= kF32 && a.lam_dt <= kBF16 &&
                     a.off_dt >= kF32 && a.off_dt <= kBF16;
  if (!dt_ok || a.W <= 0 || a.W % 128 != 0 || a.K < 1 || a.m < 0)
    return (int)cudaErrorInvalidValue;
  if (!resident_route) {
    if (max_clusters != nullptr) return (int)cudaErrorInvalidValue;
    if (a.m == 0) return (int)cudaGetLastError();
    return dtype == kF32 ? launch_stream<float>(a, stream)
                         : launch_stream<__nv_bfloat16>(a, stream);
  }
  if (a.m == 0 && max_clusters == nullptr) return (int)cudaGetLastError();
  return dtype == kF32 ? resident<float>(a, stream, max_clusters)
                       : resident<__nv_bfloat16>(a, stream, max_clusters);
}

}  // namespace

// dtype: x0's (and the outputs') DType; xs_dt, lam_dt, off_dt: those of x_s,
// lam and off.  resident_route: 1 for the resident route, 0 for the
// streaming route.  Returns a CUDA error code (0 on success).
extern "C" int launch_inner_loop_affine(const void* x0, const void* H, const void* c,
                                        const void* xs, const void* lam, const void* off,
                                        const void* step_arr, float step, float rho,
                                        float inv_k, int K, int m, int W, int dtype, int xs_dt,
                                        int lam_dt, int off_dt, int resident_route, void* x_out,
                                        void* xbar_out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Args a{x0, H, c, xs, lam, off, step_arr, step, rho, inv_k, K, m, W,
               xs_dt, lam_dt, off_dt, x_out, xbar_out};
  return dispatch(dtype, a, resident_route, (cudaStream_t)stream, nullptr);
}

// How many clusters of the resident route at width W (its C blocks of
// kResThreads threads and resident_smem bytes each) the card runs at once
// (cudaOccupancyMaxActiveClusters), into *out.  Returns a CUDA error code.
extern "C" int inner_loop_resident_clusters(int W, int dtype, int device, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Args a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 0.0f, 0.0f, 1.0f,
               1, 1, W, kF32, kF32, kF32, nullptr, nullptr};
  return dispatch(dtype, a, 1, nullptr, out);
}
