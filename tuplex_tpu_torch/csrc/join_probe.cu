// Join probe: for each of B probe rows of nw packed key words, the lower
// bound of the row in the u sorted unique build rows (lexicographic over
// the words, each compared as an unsigned 64-bit integer), clipped to
// [0, u - 1], and whether the build row there equals it.
//
// Replaces the device probe of the reference package's join,
// tuplex_tpu/exec/joinexec.py:629 _build_probe_fn (plain jnp, not Pallas:
// a direct-rank [chunk, u, nw] compare on the TPU's vector unit when
// u * nw <= 2**15, else a log-step search whose row gathers run on the
// TPU's scalar core). It computes the same function and is checked against
// the plain torch version, ops/join.py:lower_bound_plain. One-word keys
// take torch.searchsorted instead (ops/join.py:join_probe).
//
// Words are the key signature's bytes packed big-endian
// (runtime/columns.py:pack_sig_words), so unsigned word order is the
// signature's byte order; the kernel reads them as uint64, where torch
// would compare int64 as signed.
//
// Bound: the bytes it must move, each probe row's words read once, the
// build table read once and 9 bytes written per row (an int64 position and
// a bool): for B = 1,000,000, nw = 2 and u = 9,300 about 25 MB, 7.5 us at
// 3.35 TB/s. The search itself is log2(u) + 1 steps of nw word compares a
// row, a few hundred operations: far below what would bound it.
//
// Design (simple first):
//   * One thread per probe row, a grid-stride loop over the rows. The
//     search is the textbook lower_bound; the compare walks the words until
//     one differs.
//   * Where the build table fits a block's shared memory (u * nw * 8 bytes
//     up to the opt-in limit, 227 KB on an H100: 9,300 keys of two words
//     take 149 KB), each block copies it in once and searches it there;
//     the grid is then as many blocks as can be resident, so the table is
//     copied about once per resident block. Such a block has 1024 threads:
//     a large table leaves room for one block per SM, and the search is a
//     chain of dependent shared-memory loads whose latency only more warps
//     hide (with 256 threads, 9,300 keys took 0.085 ms on an H100, 11x its
//     bound; PERF.md).
//   * Otherwise the search reads the table from device memory through the
//     read-only path (__ldg); its first steps hit the same few rows in
//     every thread and stay in L1/L2.
//   * The probe row's words are read with __ldg at each compare; they stay
//     in L1 across the row's search.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;         // device-memory table
constexpr int kSharedThreads = 1024;  // one block per SM holds the table

template <bool kShared>
__device__ __forceinline__ uint64_t table_word(const uint64_t* tab,
                                               long long i) {
  if constexpr (kShared) {
    return tab[i];
  } else {
    return __ldg(tab + i);
  }
}

// -1, 0 or 1 as build row `row` is below, equal to or above the probe.
template <bool kShared>
__device__ __forceinline__ int compare_row(const uint64_t* tab, long long row,
                                           const uint64_t* probe, int nw) {
  const long long base = row * nw;
  for (int k = 0; k < nw; ++k) {
    const uint64_t a = table_word<kShared>(tab, base + k);
    const uint64_t b = __ldg(probe + k);
    if (a != b) return a < b ? -1 : 1;
  }
  return 0;
}

template <bool kShared>
__device__ __forceinline__ void probe_row(const uint64_t* tab, long long u,
                                          int nw, const uint64_t* words,
                                          long long r, long long* pos_out,
                                          bool* matched_out) {
  const uint64_t* probe = words + r * nw;
  long long lo = 0, hi = u;
  while (lo < hi) {
    const long long mid = lo + ((hi - lo) >> 1);
    if (compare_row<kShared>(tab, mid, probe, nw) < 0) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const bool matched = lo < u && compare_row<kShared>(tab, lo, probe, nw) == 0;
  pos_out[r] = lo < u ? lo : u - 1;
  matched_out[r] = matched;
}

__global__ void __launch_bounds__(kSharedThreads) probe_shared_kernel(
    const uint64_t* __restrict__ words, const uint64_t* __restrict__ build,
    long long b, long long u, int nw, long long* __restrict__ pos_out,
    bool* __restrict__ matched_out) {
  extern __shared__ uint64_t tab[];
  const long long total = u * nw;
  for (long long i = threadIdx.x; i < total; i += blockDim.x) {
    tab[i] = __ldg(build + i);
  }
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long r = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       r < b; r += stride) {
    probe_row<true>(tab, u, nw, words, r, pos_out, matched_out);
  }
}

__global__ void __launch_bounds__(kThreads) probe_global_kernel(
    const uint64_t* __restrict__ words, const uint64_t* __restrict__ build,
    long long b, long long u, int nw, long long* __restrict__ pos_out,
    bool* __restrict__ matched_out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long r = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       r < b; r += stride) {
    probe_row<false>(build, u, nw, words, r, pos_out, matched_out);
  }
}

}  // namespace

// words: [b, nw] and build: [u, nw] uint64 (contiguous, build sorted and
// unique), pos_out: [b] int64, matched_out: [b] bool, all on the current
// device; u >= 1, nw >= 1. Returns 0 or the cudaError of the launch.
extern "C" int tpx_join_probe(const void* words, const void* build,
                              long long b, long long u, int nw,
                              void* pos_out, void* matched_out,
                              void* stream) {
  if (b <= 0) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int n_sm = 0, smem_max = 0;
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  const size_t table_bytes = static_cast<size_t>(u) * nw * sizeof(uint64_t);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto w = static_cast<const uint64_t*>(words);
  auto t = static_cast<const uint64_t*>(build);
  auto p = static_cast<long long*>(pos_out);
  auto m = static_cast<bool*>(matched_out);
  if (table_bytes <= static_cast<size_t>(smem_max)) {
    err = cudaFuncSetAttribute(probe_shared_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(table_bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, probe_shared_kernel, kSharedThreads, table_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    long long grid = static_cast<long long>(per_sm > 0 ? per_sm : 1) * n_sm;
    const long long rows_blocks = (b + kSharedThreads - 1) / kSharedThreads;
    if (grid > rows_blocks) grid = rows_blocks;
    probe_shared_kernel<<<static_cast<unsigned>(grid), kSharedThreads,
                          table_bytes, s>>>(w, t, b, u, nw, p, m);
  } else {
    long long grid = (b + kThreads - 1) / kThreads;
    if (grid > 0x7fffffffLL) grid = 0x7fffffffLL;
    probe_global_kernel<<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
        w, t, b, u, nw, p, m);
  }
  return static_cast<int>(cudaGetLastError());
}
