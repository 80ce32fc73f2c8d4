// Join probe: for each of B probe rows of nw packed key words, the lower
// bound of the row in the u sorted unique build rows (lexicographic over
// the words, each compared as an unsigned 64-bit integer), clipped to
// [0, u - 1], and whether the build row there equals it.
//
// Replaces the device probe of the reference package's join,
// tuplex_tpu/exec/joinexec.py:629 _build_probe_fn (plain jnp, not Pallas:
// a direct-rank [chunk, u, nw] compare on the TPU's vector unit when
// u * nw <= 2**15 (_lower_bound_direct_one :653), else a log-step search
// whose row gathers run on the TPU's scalar core (lower_bound_search
// :682)). It computes the same function and is checked against the plain
// torch versions, ops/join.py:lower_bound_plain and
// lower_bound_index_plain (the latter follows this kernel's steps).
//
// Words are the key signature's bytes packed big-endian
// (runtime/columns.py:pack_sig_words), so unsigned word order is the
// signature's byte order; the kernel reads them as uint64, where torch
// would compare int64 as signed.
//
// Bound: the bytes it must move, each probe row's words read once, the
// build table read once and 9 bytes written per row (an int64 position and
// a bool): for B = 1,000,000, nw = 2 and u = 9,300 about 25 MB, 7.5 us at
// 3.35 TB/s. The search is a few dozen operations a row, far below what
// would bound it; what costs is that each of its steps is a dependent load.
//
// Design. A whole-row binary search costs log2(u) + 1 dependent steps a
// row, each a load at an address that differs per lane; with the whole
// table in shared memory one 1024-thread block fits an SM, and a table
// too large for it is searched step by step in device memory. Here:
//   * The search runs on the first words alone, over an index built once
//     per build side (ops/join.py ProbeIndex): fences (every first word,
//     or every 2**group_shift-th where they would not fit) and a radix
//     table over the bits after the prefix all first words share, where
//     radix[x] counts the fences whose bits there are below x. A probe's
//     bits name its bucket of fences in one 4-byte load; a lower_bound
//     over the bucket's few fences finishes the search, or names the
//     group of first words that holds the answer.
//   * The radix table and the fences (up to 227 KB) are copied into
//     shared memory once per block by cp.async (16 bytes a thread).
//   * A group of first words is read from L2 by the warp together: 8
//     lanes read one group of 8 (a 64-byte line) and count by ballot, so
//     a load instruction touches 4 lines, not one line a lane.
//   * A probe's words are loaded into registers once (the kernel is a
//     template on nw for 1-4; wider keys keep the first word and read the
//     rest when it ties). Indices are 32-bit.
//   * The later words are read only when the first word ties: one build
//     row from L2 settles the row; inside a run of equal first words
//     (long string keys with a common 8-byte prefix) the rows are searched
//     by galloping from the run's start, not scanned.
// What holds it: with all first words in shared memory it runs within 2x
// of its bound on 1,000,000 probes into 9,300 keys; with groups in L2
// (200,000 keys) the 64-byte group each probe reads from L2, and for
// wider keys the tie rows, keep it at 3.5-4.4x (PERF.md).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// The probe row's words; for NW = 0 (more than four words) only the first
// word is held and the rest are read from `row` when needed.
template <int NW>
struct Key {
  uint64_t w[NW > 0 ? NW : 1];
  const uint64_t* row;
  int nw;

  __device__ __forceinline__ void load(const uint64_t* words, long long r,
                                       int nw_rt) {
    nw = NW > 0 ? NW : nw_rt;
    row = words + r * nw;
#pragma unroll
    for (int k = 0; k < (NW > 0 ? NW : 1); ++k) w[k] = __ldg(row + k);
  }

  __device__ __forceinline__ uint64_t word(int k) const {
    if (NW > 0) return w[k];
    return k == 0 ? w[0] : __ldg(row + k);
  }
};

// -1, 0 or 1 as the build row `b` (nw words) is below, equal to or above
// the key, comparing words from `from` on.
template <int NW>
__device__ __forceinline__ int compare_row(const uint64_t* b,
                                           const Key<NW>& key, int from) {
  if constexpr (NW > 0) {
    // all loads first, so they are in flight together
    uint64_t a[NW > 0 ? NW : 1];
#pragma unroll
    for (int k = 0; k < NW; ++k) a[k] = k < from ? 0 : __ldg(b + k);
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      if (k >= from && a[k] != key.w[k]) return a[k] < key.w[k] ? -1 : 1;
    }
    return 0;
  } else {
    for (int k = from; k < key.nw; ++k) {
      const uint64_t a = __ldg(b + k);
      const uint64_t p = key.word(k);
      if (a != p) return a < p ? -1 : 1;
    }
    return 0;
  }
}

// The first row at or after `lb` that is not below the key, where row `lb`
// is below it: a galloping search (rows lb + 1, lb + 2, lb + 4, ... until
// one is not below, then a binary search between the last two), so a run
// of equal first words costs log2 of its length.
template <int NW>
__device__ int gallop(const uint64_t* table, int u, const Key<NW>& key,
                      int lb) {
  const int nw = key.nw;
  int below = lb;
  long long step = 1;
  int hi = u;
  while (true) {
    const long long cand = lb + step;
    if (cand >= u) break;
    if (compare_row<NW>(table + cand * nw, key, 0) >= 0) {
      hi = static_cast<int>(cand);
      break;
    }
    below = static_cast<int>(cand);
    step <<= 1;
  }
  int lo = below + 1;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (compare_row<NW>(table + static_cast<long long>(mid) * nw, key, 0) <
        0) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Launch parameters of one probe.
struct Index {
  const uint64_t* blob;   // radix table (int32), fences, first words
  const uint64_t* table;  // the build rows, [u, nw]
  int u;
  int group_shift;        // fence j is first word j << group_shift
  int down;               // the radix bits start `down` bits from the bottom
  uint64_t mask;          // (1 << bits) - 1
  int radix_words;        // 64-bit words of the radix part of the blob
  int fence_words;        // 64-bit words of the fences (even)
};

// The words below p of the group of 8 first words at `g0` (where this
// lane's probe `need`s one), and the first of its words not below p, read
// by the warp together: in round k, the 8 lanes of each quarter of the warp
// read one word each of the group of their quarter's k-th lane, so a load
// instruction touches 4 lines and not 32.
__device__ __forceinline__ void count_group8(const uint64_t* first,
                                             bool need, int g0, uint64_t p,
                                             int* below, uint64_t* f) {
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int quarter = lane & ~7;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int owner = quarter | k;
    const int og0 = __shfl_sync(kAll, g0, owner);
    const uint64_t op = __shfl_sync(kAll, p, owner);
    const int oneed = __shfl_sync(kAll, static_cast<int>(need), owner);
    const uint64_t v = oneed ? __ldg(first + og0 + (lane & 7)) : ~0ULL;
    const unsigned lt = __ballot_sync(kAll, v < op);
    const int n = __popc((lt >> quarter) & 0xffu);
    const uint64_t nv = __shfl_sync(kAll, v, quarter | (n & 7));
    if ((lane & 7) == k) {
      *below = n;
      *f = nv;
    }
  }
}

// kGroups: the fences are every (1 << group_shift)-th first word, and the
// first words themselves stay in device memory; else the fences are all
// the first words.
template <int NW, bool kGroups>
__global__ void __launch_bounds__(kThreads) probe_kernel(
    const uint64_t* __restrict__ words, long long b, int nw_rt, Index ix,
    long long* __restrict__ pos_out, bool* __restrict__ matched_out) {
  extern __shared__ uint4 smem4[];
  uint64_t* smem = reinterpret_cast<uint64_t*>(smem4);
  const int copy_words = ix.radix_words + ix.fence_words;
  for (int i = threadIdx.x; 2 * i < copy_words; i += blockDim.x) {
    cp_async16(smem + 2 * i, ix.blob + 2 * i);
  }
  cp_async_wait_all();
  __syncthreads();
  const int* radix = reinterpret_cast<const int*>(smem);
  const uint64_t* fence = smem + ix.radix_words;
  const uint64_t* first =
      ix.blob + ix.radix_words + (kGroups ? ix.fence_words : 0);
  const int u = ix.u;
  const uint64_t f_lo = fence[0];
  const uint64_t f_hi = __ldg(first + u - 1);
  const int group = 1 << ix.group_shift;
  const int lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  // whole warps go round the loop together (the group reads are the
  // warp's); lanes past b do nothing of their own
  for (long long base = static_cast<long long>(blockIdx.x) * blockDim.x +
                        (threadIdx.x - lane);
       base < b; base += stride) {
    const long long r = base + lane;
    const bool active = r < b;
    Key<NW> key = {};
    if (active) key.load(words, r, nw_rt);
    const uint64_t p0 = key.w[0];
    int lb = 0;
    bool search = false;  // p0 within [f_lo, f_hi]: its lower bound is < u
    int lo = 0;
    if (active && p0 > f_hi) {
      lb = u;
    } else if (active && p0 >= f_lo) {
      search = true;
      // the fences below p0, searched in the probe's radix bucket
      const int x = static_cast<int>((p0 >> ix.down) & ix.mask);
      lo = radix[x];
      int hi = radix[x + 1];
      while (lo < hi) {
        const int mid = lo + ((hi - lo) >> 1);
        if (fence[mid] < p0) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
    }
    uint64_t f = 0;  // the first word at lb
    if (!kGroups) {
      if (search) {
        lb = lo;
        f = fence[lb];
      }
    } else {
      // fence lo - 1 is below p0 and fence lo is not: lb is in its group,
      // (lo - 1) * group + 1 .. lo * group (lb = 0 where lo = 0)
      const bool need = search && lo > 0;
      const int g0 = need ? (lo - 1) << ix.group_shift : 0;
      if (group <= 8) {
        // the words of the next group are not below p0, and the first
        // words are padded past u, so 8 words always do
        int below = 0;
        uint64_t nv = 0;
        count_group8(first, need, g0, p0, &below, &nv);
        if (need) {
          lb = g0 + below;
          f = below < 8 ? nv : fence[lo];
        }
      } else if (need) {
        int glo = 1, ghi = group;
        while (glo < ghi) {
          const int mid = glo + ((ghi - glo) >> 1);
          if (__ldg(first + g0 + mid) < p0) {
            glo = mid + 1;
          } else {
            ghi = mid;
          }
        }
        lb = g0 + glo;
        f = __ldg(first + lb);
      }
      if (search && !need) f = f_lo;
    }
    bool matched = search && f == p0;
    if (NW != 1 && matched) {
      const int nw = key.nw;
      const int c =
          compare_row<NW>(ix.table + static_cast<long long>(lb) * nw, key,
                          1);
      if (c < 0) {
        lb = gallop<NW>(ix.table, u, key, lb);
        matched = lb < u && compare_row<NW>(
                                ix.table + static_cast<long long>(lb) * nw,
                                key, 0) == 0;
      } else {
        matched = c == 0;
      }
    }
    if (active) {
      pos_out[r] = lb < u ? lb : u - 1;
      matched_out[r] = matched;
    }
  }
}

template <int NW, bool kGroups>
int launch(const uint64_t* w, long long b, int nw, const Index& ix,
           size_t smem, int n_sm, long long* p, bool* m, cudaStream_t s,
           bool copy_only) {
  auto kernel = probe_kernel<NW, kGroups>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long grid = static_cast<long long>(per_sm > 0 ? per_sm : 1) * n_sm;
  const long long rows_blocks = (b + kThreads - 1) / kThreads;
  if (grid > rows_blocks) grid = rows_blocks;
  kernel<<<static_cast<unsigned>(grid), kThreads, smem, s>>>(
      w, copy_only ? 0 : b, nw, ix, p, m);
  return static_cast<int>(cudaGetLastError());
}

template <bool kGroups>
int launch_nw(const uint64_t* w, long long b, int nw, const Index& ix,
              size_t smem, int n_sm, long long* p, bool* m, cudaStream_t s,
              bool copy_only) {
  switch (nw) {
    case 1:
      return launch<1, kGroups>(w, b, nw, ix, smem, n_sm, p, m, s,
                                copy_only);
    case 2:
      return launch<2, kGroups>(w, b, nw, ix, smem, n_sm, p, m, s,
                                copy_only);
    case 3:
      return launch<3, kGroups>(w, b, nw, ix, smem, n_sm, p, m, s,
                                copy_only);
    case 4:
      return launch<4, kGroups>(w, b, nw, ix, smem, n_sm, p, m, s,
                                copy_only);
    default:
      return launch<0, kGroups>(w, b, nw, ix, smem, n_sm, p, m, s,
                                copy_only);
  }
}

}  // namespace

// words: [b, nw] uint64 probe rows; table: [u, nw] sorted unique build
// rows; blob: the index (ops/join.py ProbeIndex): `radix_words` 64-bit
// words holding the int32 radix table (2**bits + 1 entries), `fence_words`
// words of fences (every (1 << group_shift)-th first word, padded to an
// even count), and, when group_shift > 0, the u first words padded with ~0
// to a whole group and 8 words more; `down` and `bits` place the radix bits in a first
// word. pos_out: [b] int64, matched_out: [b] bool. All on the current
// device, the blob 16-byte aligned; 1 <= u < 2**31, nw >= 1; the radix
// table and fences must fit a block's shared memory. With copy_only the
// blocks copy them and probe nothing (to time the copy). Returns 0 or the
// cudaError of the launch.
extern "C" int tpx_join_probe(const void* words, long long b, int nw,
                              const void* blob, const void* table, int u,
                              int group_shift, int down, int bits,
                              int radix_words, int fence_words,
                              void* pos_out, void* matched_out,
                              void* stream, int copy_only) {
  if (b <= 0) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int n_sm = 0, smem_max = 0;
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  Index ix;
  ix.blob = static_cast<const uint64_t*>(blob);
  ix.table = static_cast<const uint64_t*>(table);
  ix.u = u;
  ix.group_shift = group_shift;
  ix.down = down;
  ix.mask = bits >= 64 ? ~0ULL : (1ULL << bits) - 1;
  ix.radix_words = radix_words;
  ix.fence_words = fence_words;
  const size_t smem =
      static_cast<size_t>(radix_words + fence_words) * sizeof(uint64_t);
  if (smem > static_cast<size_t>(smem_max)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto w = static_cast<const uint64_t*>(words);
  auto p = static_cast<long long*>(pos_out);
  auto m = static_cast<bool*>(matched_out);
  auto s = static_cast<cudaStream_t>(stream);
  return group_shift > 0
             ? launch_nw<true>(w, b, nw, ix, smem, n_sm, p, m, s, copy_only)
             : launch_nw<false>(w, b, nw, ix, smem, n_sm, p, m, s,
                                copy_only);
}
