// NFA scan: re.search existence for a Glushkov NFA of at most 64 positions
// over a batch of byte strings (u8 [N, W] zero-padded rows + int32 lengths).
//
// Two entry points: tpx_nfa_scan (existence, below) and tpx_nfa_start (the
// leftmost match start, after it; it shares the row-tile loader and the
// chunked follow tables).
//
// Replaces tuplex_tpu/ops/pallas_nfa.py:_build_kernel (the Pallas kernel the
// reference package runs on the TPU). It computes the same function and is
// checked against the plain torch version, NFARegex.match_bitmask in
// tuplex_tpu_torch/ops/nfa.py.
//
// Bound: the least time is set by the bytes it must read (each row's
// in-length bytes once, lengths in, matches out: 0.0135 ms for the log
// grep's [524288, 96] batch on an H100 at 3.35 TB/s), but what limits it on
// the card is the per-byte automaton step. On that batch (H100 80GB HBM3,
// 700 W) the kernel takes 0.050 ms; a copy that only stages the tiles takes
// 0.023 ms and a copy that only scans (no device-memory loads) 0.042 ms.
// The scan is bound by its shared-memory table loads: ceil(P/8) + 1 loads
// of 64 bits for every byte of every row.
//
// Design (the Pallas kernel's TPU form is not carried over):
//   * One block of kRows = 256 threads per 256 consecutive rows, one thread
//     per row. The state S is one uint64 in a register; its bits are the
//     live NFA positions (P <= 64 is guaranteed by NFARegex).
//   * Coalesced row tiles. The block reduces max(min(len, W)) over its rows
//     and walks column chunks of kCols = 128 bytes up to that maximum, not
//     up to W. For each chunk the whole block copies the rows x kCols
//     sub-tile into shared memory, neighbouring threads on neighbouring
//     addresses: 16-byte cp.async copies when W % 16 == 0 and the base is
//     16-aligned, else 4-byte cp.async copies when W % 4 == 0 and it is
//     4-aligned, else bytes. cp.async puts all of a thread's copies in
//     flight before it waits (plain loads stored one by one waited on each).
//   * The tile rows are not padded: a row's 16-byte units are XOR-swizzled
//     by the row (tile_off), so a thread reads its row 16 bytes at a time
//     and the 8 rows of each quarter-warp hit 8 different bank groups, for
//     both the copies in and the reads out. (Padding the stride to 132
//     bytes, conflict-free for 4-byte reads, rules out 16-byte copies.)
//   * Constant-time transition from byte-chunked follow tables:
//     F8[c][v] = OR of FOLLOW[8c + b] over the set bits b of v, for
//     c < NCHUNK = ceil(P / 8), so
//         S' = (OR over c < NCHUNK of F8[c][(S >> 8c) & 0xff]) & CLASSTAB[byte]
//     NCHUNK loads and one class load per byte whatever the live set; NCHUNK
//     is a template argument, the same for every thread of a launch. Without
//     ^ the host folds FIRST into every F8[0] entry, so the seed costs
//     nothing; the first byte of a row ORs in FIRST explicitly (the only
//     seed under ^).
//   * The tables (CLASSTAB, F8, FIRST, LAST) sit in one device buffer that
//     NFARegex uploads once per pattern and device (layout in
//     ops/nfa_cuda.py:pack_tables); each block copies them to shared memory.
//     Shared memory per block: 2 KB x (1 + NCHUNK) of tables + 32 KB of tile.
//   * A thread ORs every state into `acc` and tests acc & LAST once per
//     chunk; once it has matched it skips the rest of its row's scan (it
//     still takes part in the tile copies and barriers).
//   * '$' rule: with anchored_end a hit counts only where j+1 == len or
//     j+1 == end_at (one trailing '\n', python semantics). The thread keeps
//     the states after its last two bytes and the last byte itself, and
//     decides at the end; the bytes past min(len, W) are never read.
//   * Lengths are clamped to [0, W] for the scan; pure-anchor patterns (no
//     positions) never reach the kernel: the host decides them.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 256;           // rows per block, one thread each
constexpr int kCols = 128;           // bytes of each row per column chunk
constexpr int kUnits = kCols / 16;   // 16-byte units of a row's chunk
constexpr int kMaxChunks = 8;        // ceil(64 / 8)
constexpr int kMaxDevices = 64;

// Offset in the tile of byte k of row r's chunk. A row's 16-byte units are
// XOR-swizzled by the row, so the 8 rows of a quarter-warp that read or
// write the same unit touch 8 different 16-byte bank groups.
__device__ __forceinline__ int tile_off(int r, int k) {
  return r * kCols + ((((k >> 4) ^ r) & (kUnits - 1)) << 4) + (k & 15);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

template <int NCHUNK>
__device__ __forceinline__ unsigned long long follow8(
    unsigned long long S, const unsigned long long* __restrict__ f8) {
  unsigned long long nxt = 0ull;
#pragma unroll
  for (int c = 0; c < NCHUNK; ++c)
    nxt |= f8[c * 256 + static_cast<unsigned>((S >> (8 * c)) & 0xffull)];
  return nxt;
}

// Copies columns [c0, cend) of the block's `rows` rows into the shared tile
// and waits for them. cend - c0 <= kCols and both are multiples of VEC.
// 16- and 4-byte copies go through cp.async, so every copy of the thread
// is in flight before it waits; bytes are loaded eight at a time before
// they are stored.
template <int VEC>
__device__ __forceinline__ void load_tile(uint8_t* __restrict__ tile,
                                          const uint8_t* __restrict__ base,
                                          long long w, int rows, int c0,
                                          int cend) {
  constexpr int kPerRow = kCols / VEC;   // copies per row of a full chunk
  const int ncol = cend - c0;
  const int total = rows * kPerRow;
  if constexpr (VEC == 1) {
    for (int i0 = threadIdx.x; i0 < total; i0 += 8 * kRows) {
      uint8_t v[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int i = i0 + q * kRows, r = i / kPerRow, k = i % kPerRow;
        if (i < total && k < ncol)
          v[q] = __ldg(base + static_cast<long long>(r) * w + c0 + k);
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int i = i0 + q * kRows, r = i / kPerRow, k = i % kPerRow;
        if (i < total && k < ncol) tile[tile_off(r, k)] = v[q];
      }
    }
  } else {
    for (int i = threadIdx.x; i < total; i += kRows) {
      const int r = i / kPerRow, k = (i % kPerRow) * VEC;
      if (k >= ncol) continue;
      const uint8_t* src = base + static_cast<long long>(r) * w + c0 + k;
      if constexpr (VEC == 16)
        cp_async16(tile + tile_off(r, k), src);
      else
        cp_async4(tile + tile_off(r, k), src);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  }
}

template <int NCHUNK, int VEC>
__global__ void __launch_bounds__(kRows) nfa_scan_kernel(
    const uint8_t* __restrict__ bytes, const int32_t* __restrict__ lens,
    long long n, long long w, const unsigned long long* __restrict__ tables,
    int anchored_start, int anchored_end, int nullable,
    bool* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_wmax[kRows / 32];
  unsigned long long* s_class = reinterpret_cast<unsigned long long*>(smem);
  unsigned long long* s_f8 = s_class + 256;
  uint8_t* tile = reinterpret_cast<uint8_t*>(s_f8 + 256 * NCHUNK);

  for (int i = threadIdx.x; i < 256 * (1 + NCHUNK); i += kRows)
    s_class[i] = tables[i];
  const unsigned long long first = tables[256 * (1 + NCHUNK)];
  const unsigned long long last = tables[256 * (1 + NCHUNK) + 1];

  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  const int rows = static_cast<int>(n - row0 < kRows ? n - row0 : kRows);
  const long long row = row0 + threadIdx.x;
  long long len = 0;
  if (threadIdx.x < rows) {
    len = lens[row];
    if (len < 0) len = 0;
  }
  const int stop = static_cast<int>(len < w ? len : w);

  const int wmax = __reduce_max_sync(0xffffffffu, static_cast<unsigned>(stop));
  if ((threadIdx.x & 31) == 0) s_wmax[threadIdx.x >> 5] = wmax;
  __syncthreads();
  int maxlen = 0;
#pragma unroll
  for (int k = 0; k < kRows / 32; ++k) maxlen = max(maxlen, s_wmax[k]);
  // columns worth loading: up to maxlen, rounded up to whole loads
  const int lim = static_cast<int>(
      min(w, static_cast<long long>((maxlen + VEC - 1) / VEC * VEC)));

  // a nullable pattern matches at position 0, unless it is '^...$'
  const bool known = nullable && !(anchored_start && anchored_end);
  unsigned long long S = 0ull, Sprev = 0ull, acc = 0ull;
  unsigned long long seed = first;   // ORed into the row's first byte only
  unsigned lastbyte = 0;
  const uint8_t* base = bytes + row0 * w;

  for (int c0 = 0; c0 < maxlen; c0 += kCols) {
    if (c0 > 0) __syncthreads();   // the previous chunk has been scanned
    load_tile<VEC>(tile, base, w, rows, c0, min(c0 + kCols, lim));
    __syncthreads();
    const bool done = known || (!anchored_end && (acc & last) != 0ull);
    const int nb = min(stop - c0, kCols);   // this row's bytes in the chunk
    if (done || nb <= 0) continue;
    const int t = threadIdx.x;
    int k = 0;
    for (; k + 16 <= nb; k += 16) {
      const uint4 q = *reinterpret_cast<const uint4*>(tile + tile_off(t, k));
      const uint32_t words[4] = {q.x, q.y, q.z, q.w};
      unsigned long long s = (follow8<NCHUNK>(S, s_f8) | seed) &
                             s_class[words[0] & 0xffu];
      unsigned long long a = s;
#pragma unroll
      for (int b = 1; b < 15; ++b) {
        s = follow8<NCHUNK>(s, s_f8) &
            s_class[(words[b >> 2] >> (8 * (b & 3))) & 0xffu];
        a |= s;
      }
      Sprev = s;
      S = follow8<NCHUNK>(s, s_f8) & s_class[words[3] >> 24];
      acc |= a | S;
      seed = 0ull;
    }
    for (; k < nb; ++k) {
      Sprev = S;
      S = (follow8<NCHUNK>(S, s_f8) | seed) & s_class[tile[tile_off(t, k)]];
      acc |= S;
      seed = 0ull;
    }
    if (stop <= c0 + kCols) lastbyte = tile[tile_off(t, stop - 1 - c0)];
  }

  bool matched;
  if (!anchored_end) {
    matched = known || (acc & last) != 0ull;
  } else {
    // end_at = len - 1 when byte min(len, W) - 1 is '\n', else len
    const bool nl = stop > 0 && lastbyte == 10u;
    bool hit;
    if (stop == len)        // states after bytes len-1 and len-2 were kept
      hit = (S & last) != 0ull || (nl && (Sprev & last) != 0ull);
    else                    // len > W: only j = W-1 = len-2 can count
      hit = len == w + 1 && nl && (S & last) != 0ull;
    const bool empty = len == 0 || (len == 1 && nl);   // end_at == 0
    matched = hit || (nullable && (!anchored_start || empty));
  }
  if (threadIdx.x < rows) out[row] = matched;
}

using KernelFn = void (*)(const uint8_t*, const int32_t*, long long,
                          long long, const unsigned long long*, int, int, int,
                          bool*);

template <int NCHUNK>
KernelFn pick_vec(int vec) {
  if (vec == 16) return nfa_scan_kernel<NCHUNK, 16>;
  if (vec == 4) return nfa_scan_kernel<NCHUNK, 4>;
  return nfa_scan_kernel<NCHUNK, 1>;
}

KernelFn pick_kernel(int nchunk, int vec) {
  switch (nchunk) {
    case 1: return pick_vec<1>(vec);
    case 2: return pick_vec<2>(vec);
    case 3: return pick_vec<3>(vec);
    case 4: return pick_vec<4>(vec);
    case 5: return pick_vec<5>(vec);
    case 6: return pick_vec<6>(vec);
    case 7: return pick_vec<7>(vec);
    default: return pick_vec<8>(vec);
  }
}

// Leftmost match start: re.search's match position for a Glushkov NFA of at
// most 32 positions (NFARegex.match_start; the reference's min-plus scan,
// tuplex_tpu/ops/nfa.py:328, replaced). The plain torch version it is held
// to is NFARegex.match_start_plain.
//
// Design: a match starts at j iff the REVERSED automaton, fed the row right
// to left and seeded at every valid match end, holds a FIRST position after
// byte j. So the leftmost start is the smallest such j, and the state stays
// one 64-bit word (no per-position start values, no min-plus):
//     R_j = (FOLLOW^T(R_{j+1}) | seed_j) & CLASSTAB[byte j]
//     hit at j iff R_j & FIRST (and, under '^', only j == 0)
// FOLLOW^T comes as byte-chunked tables like the scan's (the host transposes
// the follow sets, ops/nfa_cuda.py:pack_start_tables). Without '$' every
// byte seeds LAST, folded into every F8[0] entry on the host; under '$' the
// seed goes only at j = len - 1 and at j = end_at - 1 (end_at = len - 1 when
// the row ends in '\n'), which the thread finds before the scan.
// One thread per row, as in the scan; the block walks its column chunks
// from the last one down, copying each into the same swizzled tile, and a
// thread reads its row's chunk 16 bytes at a time from the top. Scanning
// down, the last hit is the smallest, so `best` is overwritten at each hit
// (a select); there is no early exit.
template <int NCHUNK, int VEC, bool END>
__global__ void __launch_bounds__(kRows) nfa_start_kernel(
    const uint8_t* __restrict__ bytes, const int32_t* __restrict__ lens,
    long long n, long long w, const unsigned long long* __restrict__ tables,
    int anchored_start, bool* __restrict__ matched_out,
    int32_t* __restrict__ start_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_wmax[kRows / 32];
  unsigned long long* s_class = reinterpret_cast<unsigned long long*>(smem);
  unsigned long long* s_f8 = s_class + 256;
  uint8_t* tile = reinterpret_cast<uint8_t*>(s_f8 + 256 * NCHUNK);

  for (int i = threadIdx.x; i < 256 * (1 + NCHUNK); i += kRows)
    s_class[i] = tables[i];
  const unsigned long long seedset = tables[256 * (1 + NCHUNK)];      // LAST
  const unsigned long long accept = tables[256 * (1 + NCHUNK) + 1];   // FIRST

  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  const int rows = static_cast<int>(n - row0 < kRows ? n - row0 : kRows);
  const long long row = row0 + threadIdx.x;
  long long len = 0;
  if (threadIdx.x < rows) {
    len = lens[row];
    if (len < 0) len = 0;
  }
  const int stop = static_cast<int>(len < w ? len : w);

  const int wmax = __reduce_max_sync(0xffffffffu, static_cast<unsigned>(stop));
  if ((threadIdx.x & 31) == 0) s_wmax[threadIdx.x >> 5] = wmax;
  __syncthreads();
  int maxlen = 0;
#pragma unroll
  for (int k = 0; k < kRows / 32; ++k) maxlen = max(maxlen, s_wmax[k]);
  const int lim = static_cast<int>(
      min(w, static_cast<long long>((maxlen + VEC - 1) / VEC * VEC)));
  const uint8_t* base = bytes + row0 * w;

  // '$': the columns whose byte may end a match (-1: none)
  int j1 = -1, j2 = -1;
  if (END && stop > 0) {
    const bool nl = __ldg(base + threadIdx.x * w + stop - 1) == 10u;
    if (len <= w) j1 = static_cast<int>(len - 1);
    const long long e2 = nl ? len - 2 : len - 1;   // end_at - 1
    if (e2 >= 0 && e2 < stop) j2 = static_cast<int>(e2);
  }

  unsigned long long R = 0ull;
  int best = -1;
  const int t = threadIdx.x;
  for (int c0 = maxlen > 0 ? (maxlen - 1) / kCols * kCols : -1; c0 >= 0;
       c0 -= kCols) {
    __syncthreads();   // every thread is done with the previous tile
    load_tile<VEC>(tile, base, w, rows, c0, min(c0 + kCols, lim));
    __syncthreads();
    const int nb = min(stop - c0, kCols);   // this row's bytes in the chunk
    if (nb <= 0) continue;
    const int full = nb & ~15;
    for (int k = nb - 1; k >= full; --k) {
      const int j = c0 + k;
      unsigned long long sd = 0ull;
      if (END && (j == j1 || j == j2)) sd = seedset;
      R = (follow8<NCHUNK>(R, s_f8) | sd) & s_class[tile[tile_off(t, k)]];
      best = (R & accept) != 0ull ? j : best;
    }
    for (int k = full - 16; k >= 0; k -= 16) {
      const uint4 q = *reinterpret_cast<const uint4*>(tile + tile_off(t, k));
      const uint32_t words[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int b = 15; b >= 0; --b) {
        const int j = c0 + k + b;
        unsigned long long sd = 0ull;
        if (END && (j == j1 || j == j2)) sd = seedset;
        R = (follow8<NCHUNK>(R, s_f8) | sd) &
            s_class[(words[b >> 2] >> (8 * (b & 3))) & 0xffu];
        best = (R & accept) != 0ull ? j : best;
      }
    }
  }
  const bool matched = anchored_start ? best == 0 : best >= 0;
  if (threadIdx.x < rows) {
    matched_out[row] = matched;
    start_out[row] = matched ? best : 0;
  }
}

using StartFn = void (*)(const uint8_t*, const int32_t*, long long, long long,
                         const unsigned long long*, int, bool*, int32_t*);

template <int NCHUNK, bool END>
StartFn pick_start_vec(int vec) {
  if (vec == 16) return nfa_start_kernel<NCHUNK, 16, END>;
  if (vec == 4) return nfa_start_kernel<NCHUNK, 4, END>;
  return nfa_start_kernel<NCHUNK, 1, END>;
}

template <bool END>
StartFn pick_start_end(int nchunk, int vec) {
  switch (nchunk) {
    case 1: return pick_start_vec<1, END>(vec);
    case 2: return pick_start_vec<2, END>(vec);
    case 3: return pick_start_vec<3, END>(vec);
    default: return pick_start_vec<4, END>(vec);
  }
}

constexpr int kMaxStartChunks = 4;   // ceil(32 / 8)

// dynamic shared memory raised past 48 KB, once per device and kernel
bool g_smem_set[kMaxDevices][kMaxChunks][3];
bool g_start_smem_set[kMaxDevices][kMaxStartChunks][3][2];

int vec_for(const void* bytes, long long w) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(bytes);
  return (w % 16 == 0 && addr % 16 == 0) ? 16
         : (w % 4 == 0 && addr % 4 == 0) ? 4 : 1;
}

}  // namespace

// Rows per block, one thread each (the tests probe the block edges).
extern "C" int tpx_nfa_rows_per_block() { return kRows; }

// Plain C entry point, loaded with ctypes. `tables` is the device buffer of
// ops/nfa_cuda.py:pack_tables (256 * (1 + n_chunks) + 2 uint64). Launches on
// `stream`; returns the cudaGetLastError() code of the launch (0 =
// launched).
extern "C" int tpx_nfa_scan(const void* bytes, const void* lens, long long n,
                            long long w, const void* tables, int n_chunks,
                            int anchored_start, int anchored_end, int nullable,
                            void* out, void* stream) {
  if (n_chunks < 1 || n_chunks > kMaxChunks || w < 1 || w > (1ll << 30) ||
      n < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  const int vec = vec_for(bytes, w);
  const KernelFn fn = pick_kernel(n_chunks, vec);
  const size_t smem =
      sizeof(unsigned long long) * 256 * (1 + n_chunks) + kRows * kCols;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vi = vec == 16 ? 2 : vec == 4 ? 1 : 0;
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!g_smem_set[dev][n_chunks - 1][vi]) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    g_smem_set[dev][n_chunks - 1][vi] = true;
  }
  const long long blocks = (n + kRows - 1) / kRows;
  fn<<<static_cast<unsigned>(blocks), kRows, smem,
       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bytes), static_cast<const int32_t*>(lens), n,
      w, static_cast<const unsigned long long*>(tables), anchored_start,
      anchored_end, nullable, static_cast<bool*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Plain C entry point of the start scan. `tables` is the device buffer of
// ops/nfa_cuda.py:pack_start_tables (256 * (1 + n_chunks) + 2 uint64, at
// most 4 chunks: 32 positions). Writes matched [n] and start [n] (0 where
// unmatched). Launches on `stream`; returns the cudaGetLastError() code of
// the launch (0 = launched).
extern "C" int tpx_nfa_start(const void* bytes, const void* lens, long long n,
                             long long w, const void* tables, int n_chunks,
                             int anchored_start, int anchored_end,
                             void* matched, void* start, void* stream) {
  if (n_chunks < 1 || n_chunks > kMaxStartChunks || w < 1 ||
      w > (1ll << 30) || n < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  const int vec = vec_for(bytes, w);
  const StartFn fn = anchored_end ? pick_start_end<true>(n_chunks, vec)
                                  : pick_start_end<false>(n_chunks, vec);
  const size_t smem =
      sizeof(unsigned long long) * 256 * (1 + n_chunks) + kRows * kCols;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  const int vi = vec == 16 ? 2 : vec == 4 ? 1 : 0;
  bool& set = g_start_smem_set[dev][n_chunks - 1][vi][anchored_end ? 1 : 0];
  if (!set) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    set = true;
  }
  const long long blocks = (n + kRows - 1) / kRows;
  fn<<<static_cast<unsigned>(blocks), kRows, smem,
       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bytes), static_cast<const int32_t*>(lens), n,
      w, static_cast<const unsigned long long*>(tables), anchored_start,
      static_cast<bool*>(matched), static_cast<int32_t*>(start));
  return static_cast<int>(cudaGetLastError());
}
