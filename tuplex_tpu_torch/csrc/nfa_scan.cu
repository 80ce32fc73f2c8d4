// NFA scan: re.search existence for a Glushkov NFA of at most 64 positions
// over a batch of byte strings (u8 [N, W] zero-padded rows + int32 lengths).
//
// Two entry points: tpx_nfa_scan (existence, below) and tpx_nfa_start (the
// leftmost match start, after it; it shares the cp.async copies and the
// chunked form of the follow tables, and has its own design, described
// there).
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

// Leftmost match start (tpx_nfa_start): re.search's match position for a
// Glushkov NFA of at most 32 positions (NFARegex.match_start; the
// reference's min-plus scan, tuplex_tpu/ops/nfa.py:328, replaced). The
// plain torch version it is held to is NFARegex.match_start_plain.
//
// Function: a match starts at j iff the REVERSED automaton, fed the row
// right to left and seeded at every valid match end, holds a FIRST
// position after byte j. So the leftmost start is the smallest such j, and
// the state is one 32-bit word (no per-position start values, no min-plus):
//     R_j = (FOLLOW^T(R_{j+1}) | seed_j) & CLASSTAB[byte j]
//     hit at j iff R_j & FIRST (and, under '^', only j == 0)
// FOLLOW^T comes as byte-chunked tables like the scan's (the host
// transposes the follow sets, ops/nfa_cuda.py:pack_start_tables). Without
// '$' every byte seeds LAST, folded into every chunk-0 entry on the host;
// under '$' the seed goes only at j1 = len - 1 and j2 = end_at - 1 (end_at =
// len - 1 when the row ends in '\n'), both among the row's last two bytes.
// Scanning down, the last hit is the smallest, so `best` is overwritten at
// each hit (a select); there is no early exit.
//
// An optional byte mask `live` [N]: a row whose byte is 0 gets (false, 0)
// and none of its bytes or its length is read. The two-pass capture path
// passes the NFA scan's result (the same automaton's truth value), so on
// the status grep only about 22% of the rows are scanned.
//
// Bound: bytes. Each live row's in-length bytes and its length read once,
// the mask read and (matched, start) written for every row: at 3.35 TB/s
// 0.0039 ms on the status grep's [524288, 96] partition with its mask
// (117,640 rows live), 0.0143 with every row live.
// What limits it on the card is the per-byte step: NCHUNK + 1 shared-memory
// lookups at indices set by each lane's own byte and state, about 9
// instructions a byte at one chunk and 20 at four.
//
// Design (the kernel's first form, commit c88b587, scanned every row with
// 64-bit tables, one block per 256 rows; redesigned):
//   * Compaction per block, no host sync. A block owns a contiguous run of
//     windows of 2 x (its threads) candidate rows. For a window each warp
//     reads 2 x 32 mask bytes, ballots and popcounts them; the warps scan
//     the (pass, warp) counts with shuffles, and each live row's index and
//     length (read there, for live rows only) go to a ring queue in shared
//     memory, in row order. Dead rows' outputs are written there and then.
//     A round takes the next (block threads) queued rows, one thread a
//     row, compacting windows until it has them and carrying the rest
//     over, so rounds come out full at any live share; with every row live
//     a round is a run of consecutive rows, as in the first form's blocks.
//   * Persistent grid: as many blocks as are resident at once, so the
//     tables are copied into shared memory once a block, not once a round.
//   * 32-bit state and tables (P <= 32): CLASSTAB, NCHUNK reversed-follow
//     chunks, LAST, FIRST, as uint32.
//   * Table layouts. Plain (blocks of 256 threads, five an SM): entry e at
//     word e, so the lanes of a warp, each at its own state and byte, meet
//     in random banks. Lane-replicated (one block of 1024 threads an SM):
//     entry e for lane l at word e * 32 + l, one multiply-add off the
//     lane's column, so a lookup is one wavefront; CLASSTAB, and the follow
//     table at one chunk (32 KB a table). The layout follows from the chunk
//     count alone (start_rep), as measured: replicated at one chunk (the
//     status grep's pattern), plain at two to four (five blocks of 256 rows
//     beat one of 1024 there).
//   * Staging overlapped with the scan. Row tiles of (block threads) rows
//     x kSCols = 64 bytes (XOR-swizzled 16-byte units, by row pair: a
//     quarter-warp's 16-byte reads meet 8 bank groups) in a two-stage
//     ring. The tile after the current one (the next chunk down, or the
//     next round's last chunk) is started by cp.async (16- or 4-byte
//     copies, as the row stride and base allow; bytes are copied
//     synchronously) before the current one is scanned, committed as a
//     group and waited for with cp.async.wait_group 1. Each row is copied
//     only up to its own length.
//   * A row is scanned 16 bytes at a time. The unit that holds its end
//     skips the bytes past it, and under '$' the units that hold the two
//     seed columns (found from the tile when the row's last byte is
//     staged) test for them; the other units do neither.
//
// Times (NVIDIA H100 80GB HBM3, 700.00 W, scripts/torch_nfastart_compare.py,
// the first form timed in the same call): the status grep's partition
// with its mask 0.0157-0.0159 ms (first form: 0.0577-0.0578, every row),
// every row live 0.0449-0.0451; the random [1000003, 128] matrix, every
// row live, at 8 / 3 / 32 positions 0.0958 / 0.0958 / 0.1689 (first form:
// 0.1203 / 0.1076 / 0.1722).

constexpr int kSCols = 64;                    // bytes of a row per chunk
constexpr int kSUnits = kSCols / 16;          // 16-byte units of a chunk
constexpr int kMaxStartChunks = 4;            // ceil(32 / 8)

// The table layout of the start kernel for NCHUNK follow chunks, measured
// on an H100 (PERF.md): lane-replicated at one chunk, plain at two to four,
// where the replicated variant's one block of 1024 rows an SM is slower
// than five blocks of 256.
__host__ __device__ constexpr bool start_rep(int nchunk) {
  return nchunk == 1;
}

// The block shape of a start-kernel variant: plain tables take blocks of
// 256 threads, several an SM; lane-replicated tables (32 KB a table) one
// block of 1024 threads an SM, so they are copied once an SM and 32 warps
// hide the lookups' latency.
template <bool REP>
struct StartShape {
  static constexpr int kThreads = REP ? 1024 : 256;   // rows a round scans
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kPasses = 2;                   // window rows a thread
  static constexpr int kWindow = kPasses * kThreads;  // rows compacted at once
  static constexpr int kSlots = kPasses * kWarps;     // ballot counts
  // of them a lane scans (lanes past kSlots scan none)
  static constexpr int kPerLane = kSlots < 32 ? 1 : kSlots / 32;
  // the live-row queue, a ring of (row, length): a window on top of what
  // is left of the previous ones, always fewer than a round
  static constexpr int kQueue = kWindow + kThreads;
};

// Offset in a start tile of byte k of row r's chunk: a row's 16-byte units
// are XOR-swizzled by the row pair, so the 8 rows of a quarter-warp that
// read the same unit touch 8 different bank groups.
__device__ __forceinline__ int stile_off(int r, int k) {
  return r * kSCols + ((((k >> 4) ^ (r >> 1)) & (kSUnits - 1)) << 4) +
         (k & 15);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Entry i of a lane-replicated table whose column for this lane starts at
// shared address `col` (entries are 128 bytes apart): one multiply-add
// forms the address, so every lane reads its own bank.
__device__ __forceinline__ uint32_t rep_lookup(uint32_t col, uint32_t i) {
  uint32_t v;
  asm("{\n\t.reg .u32 a;\n\tmad.lo.u32 a, %1, 128, %2;\n\t"
      "ld.shared.u32 %0, [a];\n\t}"
      : "=r"(v)
      : "r"(i), "r"(col));
  return v;
}

// The tables of a start-kernel variant in shared memory. REP: CLASSTAB is
// lane-replicated, and so is the follow table when it is one chunk;
// otherwise plain.
template <int NCHUNK, bool REP>
struct StartTables {
  static constexpr bool kRepF8 = REP && NCHUNK == 1;
  static constexpr int kClsWords = 256 * (REP ? 32 : 1);
  static constexpr int kF8Words = 256 * NCHUNK * (kRepF8 ? 32 : 1);
  const uint32_t* cls;   // plain tables
  const uint32_t* f8;
  uint32_t cls_col;      // replicated tables: this lane's column
  uint32_t f8_col;

  __device__ __forceinline__ uint32_t klass(uint32_t byte) const {
    if constexpr (REP) return rep_lookup(cls_col, byte);
    else return cls[byte];
  }

  // the reversed automaton's successors of R (one lookup a chunk)
  __device__ __forceinline__ uint32_t follow(uint32_t R) const {
    if constexpr (kRepF8) {
      return rep_lookup(f8_col, R & 0xffu);
    } else {
      uint32_t nxt = 0u;
#pragma unroll
      for (int c = 0; c < NCHUNK; ++c)
        nxt |= f8[c * 256 + ((R >> (8 * c)) & 0xffu)];
      return nxt;
    }
  }
};

// Copies `entries` table words to shared memory, lane-replicated (entry e
// for lane l at word e * 32 + l: each warp spreads 32 entries at a time,
// lane l writing its own bank) or plain.
template <bool REPLICATE, int THREADS>
__device__ __forceinline__ void fill_table(uint32_t* dst,
                                           const uint32_t* __restrict__ src,
                                           int entries) {
  const int tid = threadIdx.x, lane = tid & 31;
  if constexpr (REPLICATE) {
    for (int e0 = (tid >> 5) * 32; e0 < entries; e0 += THREADS) {
      const uint32_t v = src[e0 + lane];
#pragma unroll 8
      for (int k = 0; k < 32; ++k)
        dst[(e0 + k) * 32 + lane] = __shfl_sync(0xffffffffu, v, k);
    }
  } else {
    for (int i = tid; i < entries; i += THREADS) dst[i] = src[i];
  }
}

// Scans 16 bytes of this thread's row from its tile, right to left:
// columns c0 + k + 15 down to c0 + k. CHECK: only the bytes below `nb`
// (the row's bytes in the chunk) step, and the '$' seeds j1, j2 are
// tested; the unit that holds the row's end and the units that hold the
// seeds are checked, the rest are not.
template <int NCHUNK, bool END, bool REP, bool CHECK>
__device__ __forceinline__ void scan_unit(
    const uint8_t* tl, int c0, int k, int nb, int j1, int j2,
    uint32_t seedset, uint32_t accept, const StartTables<NCHUNK, REP>& tab,
    uint32_t& R, int& best) {
  const uint4 q =
      *reinterpret_cast<const uint4*>(tl + stile_off(threadIdx.x, k));
  const uint32_t words[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int b = 15; b >= 0; --b) {
    const uint32_t c =
        tab.klass(__byte_perm(words[b >> 2], 0u, 0x4440u + (b & 3)));
    uint32_t nxt = tab.follow(R);
    if constexpr (CHECK) {
      const int j = c0 + k + b;
      if (END && (j == j1 || j == j2)) nxt |= seedset;
      // past the row's end R stays as it is: 0, nothing scanned yet
      R = k + b < nb ? nxt & c : R;
    } else {
      R = nxt & c;
    }
    best = (R & accept) != 0u ? c0 + k + b : best;
  }
}

// A queue position (below 2 * Q) as a ring index.
template <int Q>
__device__ __forceinline__ int qidx(int pos) {
  return pos >= Q ? pos - Q : pos;
}

// Starts the copies of columns [c0, c0 + kSCols) of the round's `cnt`
// rows (queue positions rbase.., their rows and lengths in q_row, q_len)
// into `tile`, each row only up to min(length, w). 16- and 4-byte copies
// go through cp.async and are left in flight (the caller commits them as
// one group); bytes are loaded eight at a time and stored.
template <int VEC, bool REP>
__device__ __forceinline__ void stage_rows(uint8_t* __restrict__ tile,
                                           const uint8_t* __restrict__ bytes,
                                           long long w, const int* q_row,
                                           const int* q_len, int rbase,
                                           int cnt, int c0) {
  using Sh = StartShape<REP>;
  constexpr int kPerRow = kSCols / VEC;
  const int total = cnt * kPerRow;
  const int wi = static_cast<int>(w);   // w <= 2^30
  if constexpr (VEC == 1) {
    for (int i0 = threadIdx.x; i0 < total; i0 += 8 * Sh::kThreads) {
      uint8_t v[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int i = i0 + q * Sh::kThreads, r = i / kPerRow;
        const int k = i % kPerRow;
        if (i < total && c0 + k < min(q_len[qidx<Sh::kQueue>(rbase + r)], wi))
          v[q] = __ldg(bytes +
                       static_cast<long long>(
                           q_row[qidx<Sh::kQueue>(rbase + r)]) * w +
                       c0 + k);
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int i = i0 + q * Sh::kThreads, r = i / kPerRow;
        const int k = i % kPerRow;
        if (i < total && c0 + k < min(q_len[qidx<Sh::kQueue>(rbase + r)], wi))
          tile[stile_off(r, k)] = v[q];
      }
    }
  } else {
    for (int i = threadIdx.x; i < total; i += Sh::kThreads) {
      const int r = i / kPerRow, k = (i % kPerRow) * VEC;
      const int at = qidx<Sh::kQueue>(rbase + r);
      if (c0 + k >= min(q_len[at], wi)) continue;
      const uint8_t* src =
          bytes + static_cast<long long>(q_row[at]) * w + c0 + k;
      if constexpr (VEC == 16)
        cp_async16(tile + stile_off(r, k), src);
      else
        cp_async4(tile + stile_off(r, k), src);
    }
  }
}

template <int NCHUNK, int VEC, bool END>
__global__ void __launch_bounds__(StartShape<start_rep(NCHUNK)>::kThreads)
    nfa_start_kernel(const uint8_t* __restrict__ bytes,
                     const int32_t* __restrict__ lens,
                     const uint8_t* __restrict__ live, long long n,
                     long long w, const uint32_t* __restrict__ tables,
                     int anchored_start, bool* __restrict__ matched_out,
                     int32_t* __restrict__ start_out) {
  constexpr bool REP = start_rep(NCHUNK);
  using Sh = StartShape<REP>;
  constexpr int kT = Sh::kThreads, kQ = Sh::kQueue;
  using Tab = StartTables<NCHUNK, REP>;
  constexpr int kEntries = 256 * (1 + NCHUNK);
  extern __shared__ __align__(16) unsigned char smem[];
  uint8_t* ring = smem;                           // 2 tiles of kT x kSCols
  uint32_t* s_cls = reinterpret_cast<uint32_t*>(ring + 2 * kT * kSCols);
  uint32_t* s_f8 = s_cls + Tab::kClsWords;
  int* q_row = reinterpret_cast<int*>(s_f8 + Tab::kF8Words);
  int* q_len = q_row + kQ;   // lengths, clamped to [0, w + 2]
  __shared__ int s_cnt[Sh::kSlots];
  // each warp's longest stop in a round, by the round's parity: a round
  // writes one half while a slow thread may still read the other, and the
  // next write to a half comes after the barrier of the round between
  __shared__ int s_wmax[2][Sh::kWarps];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  fill_table<REP, kT>(s_cls, tables, 256);
  fill_table<Tab::kRepF8, kT>(s_f8, tables + 256, 256 * NCHUNK);
  const uint32_t seedset = tables[kEntries];      // LAST
  const uint32_t accept = tables[kEntries + 1];   // FIRST
  const Tab tab{s_cls, s_f8,
                static_cast<uint32_t>(__cvta_generic_to_shared(s_cls + lane)),
                static_cast<uint32_t>(__cvta_generic_to_shared(s_f8 + lane))};

  // the block's windows, and the queue's positions (the same in every
  // thread, below 2 * kQ: both drop by kQ once head passes it)
  const long long n_windows = (n + Sh::kWindow - 1) / Sh::kWindow;
  long long win = n_windows * blockIdx.x / gridDim.x;
  const long long win_end = n_windows * (blockIdx.x + 1) / gridDim.x;
  int head = 0, tail = 0, par = 0;

  // Compacts window `win`: its live rows and their lengths go to the
  // queue in row order, its dead rows' outputs are written.
  auto compact = [&]() {
    const long long base = win * Sh::kWindow;
    unsigned bal[Sh::kPasses];
    int len[Sh::kPasses];
#pragma unroll
    for (int p = 0; p < Sh::kPasses; ++p) {
      const long long c = base + p * kT + tid;
      const bool in = c < n;
      const bool alive = in && (live == nullptr || live[c] != 0);
      if (in && !alive) {
        matched_out[c] = false;
        start_out[c] = 0;
      }
      len[p] = alive ? lens[c] : 0;   // in flight across the barrier
      bal[p] = __ballot_sync(0xffffffffu, alive);
    }
    if (lane == 0) {
#pragma unroll
      for (int p = 0; p < Sh::kPasses; ++p)
        s_cnt[p * Sh::kWarps + warp] = __popc(bal[p]);
    }
    __syncthreads();
    // exclusive prefix of the (pass, warp) counts: lane l sums kPerLane
    // of them, the warp scans the sums
    int mine = 0;
#pragma unroll
    for (int k = 0; k < Sh::kPerLane; ++k)
      if (lane * Sh::kPerLane + k < Sh::kSlots)
        mine += s_cnt[lane * Sh::kPerLane + k];
    int incl = mine;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += v;
    }
    const int total = __shfl_sync(0xffffffffu, incl, 31);
    const unsigned below = (1u << lane) - 1u;
#pragma unroll
    for (int p = 0; p < Sh::kPasses; ++p) {
      const int slot = p * Sh::kWarps + warp;
      int off = __shfl_sync(0xffffffffu, incl - mine, slot / Sh::kPerLane);
      for (int k = slot - slot % Sh::kPerLane; k < slot; ++k)
        off += s_cnt[k];
      if ((bal[p] >> lane) & 1u) {
        const int at = qidx<kQ>(tail + off + __popc(bal[p] & below));
        const long long l = len[p] < 0 ? 0 : len[p];
        q_row[at] = static_cast<int>(base + p * kT + tid);
        q_len[at] = static_cast<int>(l < w + 2 ? l : w + 2);
      }
    }
    tail += total;
    ++win;
    __syncthreads();   // the queue is written; s_cnt may be reused
  };

  // The next round: up to kT rows off the queue, compacting windows until
  // it has them or the block's windows are done. Gives this thread's row
  // (-1: none), length and stop, and the round's first queue position,
  // count and longest stop.
  auto prepare = [&](int& rbase, int& cnt, int& maxlen, int& row, int& len,
                     int& stop) {
    while (tail - head < kT && win < win_end) compact();
    cnt = min(tail - head, kT);
    rbase = head;
    row = -1;
    len = 0;
    stop = 0;
    if (tid < cnt) {
      const int at = qidx<kQ>(head + tid);
      row = q_row[at];
      len = q_len[at];
      stop = static_cast<int>(len < w ? len : w);
    }
    head += cnt;
    if (head >= kQ) {
      head -= kQ;
      tail -= kQ;
    }
    const unsigned m =
        __reduce_max_sync(0xffffffffu, static_cast<unsigned>(stop));
    if (lane == 0) s_wmax[par][warp] = static_cast<int>(m);
    __syncthreads();
    maxlen = 0;
#pragma unroll
    for (int k = 0; k < Sh::kWarps; ++k)
      maxlen = max(maxlen, s_wmax[par][k]);
    par ^= 1;
  };

  int rbase, cnt, maxlen, row, len, stop;
  prepare(rbase, cnt, maxlen, row, len, stop);
  if (cnt == 0) return;
  // chunks from the one that holds the round's last byte down to 0
  int c0 = maxlen > 0 ? (maxlen - 1) / kSCols * kSCols : 0;
  int stage = 0;
  stage_rows<VEC, REP>(ring, bytes, w, q_row, q_len, rbase, cnt, c0);
  cp_async_commit();
  uint32_t R = 0u;
  int best = -1, j1 = -1, j2 = -1;
  for (;;) {
    // stage the next tile: the next chunk down, or the next round's first
    int nrbase = rbase, ncnt = cnt, nc0 = c0 - kSCols, nrow = -1, nlen = 0,
        nstop = 0;
    if (c0 == 0) {
      int nmax;
      prepare(nrbase, ncnt, nmax, nrow, nlen, nstop);
      nc0 = ncnt == 0 ? -1 : nmax > 0 ? (nmax - 1) / kSCols * kSCols : 0;
    }
    if (nc0 >= 0)
      stage_rows<VEC, REP>(ring + (stage ^ 1) * kT * kSCols, bytes, w,
                           q_row, q_len, nrbase, ncnt, nc0);
    cp_async_commit();
    cp_async_wait1();   // this thread's copies of the current tile landed
    __syncthreads();    // and every other thread's

    const uint8_t* tl = ring + stage * kT * kSCols;
    const int nb = min(stop - c0, kSCols);   // this row's bytes in the chunk
    if (nb > 0) {
      if (END && stop - 1 - c0 < kSCols) {
        // the row's last byte is in this chunk: its '$' columns
        const bool nl = tl[stile_off(tid, stop - 1 - c0)] == 10u;
        if (len <= w) j1 = len - 1;
        const int e2 = nl ? len - 2 : len - 1;   // end_at - 1
        if (e2 >= 0 && e2 < stop) j2 = e2;
      }
      // 16-byte units from the one that holds byte nb - 1 down; those
      // at or above `cfull` checked (the row's end, the '$' seeds)
      const int top = (nb + 15) & ~15;
      int cfull = (nb & 15) ? top - 16 : top;
      if (END && max(j1, j2) >= c0) {
        const int lo = (j2 >= 0 ? j2 : j1) - c0;   // the lower seed
        if (lo < nb) cfull = min(cfull, max(lo, 0) & ~15);
      }
      int k = top - 16;
      for (; k >= cfull; k -= 16)
        scan_unit<NCHUNK, END, REP, true>(tl, c0, k, nb, j1, j2, seedset,
                                          accept, tab, R, best);
      for (; k >= 0; k -= 16)
        scan_unit<NCHUNK, END, REP, false>(tl, c0, k, nb, j1, j2, seedset,
                                           accept, tab, R, best);
    }
    if (c0 == 0) {   // the round is done
      if (row >= 0) {
        const bool m = anchored_start ? best == 0 : best >= 0;
        matched_out[row] = m;
        start_out[row] = m ? best : 0;
      }
      if (ncnt == 0) break;
      rbase = nrbase;
      cnt = ncnt;
      row = nrow;
      len = nlen;
      stop = nstop;
      R = 0u;
      best = -1;
      j1 = j2 = -1;
    }
    c0 = nc0;
    stage ^= 1;
    __syncthreads();   // every thread is done with this tile
  }
}

using StartFn = void (*)(const uint8_t*, const int32_t*, const uint8_t*,
                         long long, long long, const uint32_t*, int, bool*,
                         int32_t*);

template <int NCHUNK, bool END>
StartFn pick_start_vec(int vec) {
  if (vec == 16) return nfa_start_kernel<NCHUNK, 16, END>;
  if (vec == 4) return nfa_start_kernel<NCHUNK, 4, END>;
  return nfa_start_kernel<NCHUNK, 1, END>;
}

template <bool END>
StartFn pick_start_chunks(int nchunk, int vec) {
  switch (nchunk) {
    case 1: return pick_start_vec<1, END>(vec);
    case 2: return pick_start_vec<2, END>(vec);
    case 3: return pick_start_vec<3, END>(vec);
    default: return pick_start_vec<4, END>(vec);
  }
}

StartFn pick_start(int nchunk, int vec, bool end) {
  return end ? pick_start_chunks<true>(nchunk, vec)
             : pick_start_chunks<false>(nchunk, vec);
}

template <bool REP>
size_t start_smem_of(int nchunk) {
  using Sh = StartShape<REP>;
  const bool rep_f8 = REP && nchunk == 1;
  return 2 * Sh::kThreads * kSCols +
         sizeof(uint32_t) * 256 *
             ((REP ? 32 : 1) + nchunk * (rep_f8 ? 32 : 1)) +
         sizeof(int) * 2 * Sh::kQueue;
}

// One start-kernel variant on one device: its shared memory raised past
// 48 KB and its blocks per SM, found once.
struct StartVariant {
  StartFn fn;
  size_t smem;
  int threads;
  bool rep;
  int blocks_per_sm;   // 0: not set up yet
};

StartVariant g_start[kMaxDevices][kMaxStartChunks][3][2];
int g_sms[kMaxDevices];

cudaError_t start_variant(int dev, int nchunk, int vec, bool end,
                          StartVariant** out) {
  const int vi = vec == 16 ? 2 : vec == 4 ? 1 : 0;
  StartVariant& v = g_start[dev][nchunk - 1][vi][end ? 1 : 0];
  if (v.blocks_per_sm == 0) {
    const bool rep = start_rep(nchunk);
    const StartFn fn = pick_start(nchunk, vec, end);
    const size_t smem =
        rep ? start_smem_of<true>(nchunk) : start_smem_of<false>(nchunk);
    const int threads =
        rep ? StartShape<true>::kThreads : StartShape<false>::kThreads;
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads,
                                                        smem);
    if (err != cudaSuccess) return err;
    if (blocks < 1) return cudaErrorInvalidConfiguration;
    if (g_sms[dev] == 0) {
      err = cudaDeviceGetAttribute(&g_sms[dev],
                                   cudaDevAttrMultiProcessorCount, dev);
      if (err != cudaSuccess) return err;
    }
    v.fn = fn;
    v.smem = smem;
    v.threads = threads;
    v.rep = rep;
    v.blocks_per_sm = blocks;
  }
  *out = &v;
  return cudaSuccess;
}

// dynamic shared memory raised past 48 KB, once per device and kernel
bool g_smem_set[kMaxDevices][kMaxChunks][3];

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


// The start-kernel variant a launch on the current device takes for
// n_chunks, '$' and the copy width `vec` (16, 4 or 1): writes whether its
// tables are lane-replicated (1) or plain (0), its blocks per SM, the SM
// count, its threads a block (rows a round) and its window (candidate rows
// compacted at once; the tests probe their edges). Returns a cudaError_t
// code.
extern "C" int tpx_nfa_start_variant(int n_chunks, int anchored_end, int vec,
                                     int* replicated, int* blocks_per_sm,
                                     int* sms, int* threads, int* window) {
  if (n_chunks < 1 || n_chunks > kMaxStartChunks ||
      (vec != 1 && vec != 4 && vec != 16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  StartVariant* v = nullptr;
  err = start_variant(dev, n_chunks, vec, anchored_end != 0, &v);
  if (err != cudaSuccess) return static_cast<int>(err);
  *replicated = v->rep ? 1 : 0;
  *blocks_per_sm = v->blocks_per_sm;
  *sms = g_sms[dev];
  *threads = v->threads;
  *window = v->rep ? StartShape<true>::kWindow : StartShape<false>::kWindow;
  return 0;
}

// Plain C entry point of the start scan. `tables` is the device buffer of
// ops/nfa_cuda.py:pack_start_tables (256 * (1 + n_chunks) + 2 uint32, at
// most 4 chunks: 32 positions); `live` is a byte mask [n] or null (every
// row live). Writes matched [n] and start [n] (0 where unmatched).
// Launches on `stream` with no host sync; returns the cudaGetLastError()
// code of the launch (0 = launched).
extern "C" int tpx_nfa_start(const void* bytes, const void* lens,
                             const void* live, long long n, long long w,
                             const void* tables, int n_chunks,
                             int anchored_start, int anchored_end,
                             void* matched, void* start, void* stream) {
  if (n_chunks < 1 || n_chunks > kMaxStartChunks || w < 1 ||
      w > (1ll << 30) || n < 0 || n > 0x7fffffffll) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  StartVariant* v = nullptr;
  err = start_variant(dev, n_chunks, vec_for(bytes, w), anchored_end != 0,
                      &v);
  if (err != cudaSuccess) return static_cast<int>(err);
  // persistent: as many blocks as are resident at once, or one a window
  const long long window = v->rep ? StartShape<true>::kWindow
                                  : StartShape<false>::kWindow;
  const long long windows = (n + window - 1) / window;
  const long long resident =
      static_cast<long long>(v->blocks_per_sm) * g_sms[dev];
  const long long blocks = windows < resident ? windows : resident;
  v->fn<<<static_cast<unsigned>(blocks), v->threads, v->smem,
          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bytes), static_cast<const int32_t*>(lens),
      static_cast<const uint8_t*>(live), n, w,
      static_cast<const uint32_t*>(tables), anchored_start,
      static_cast<bool*>(matched), static_cast<int32_t*>(start));
  return static_cast<int>(cudaGetLastError());
}
