// NFA scan: re.search existence for a Glushkov NFA of at most 64 positions
// over a batch of byte strings (u8 [N, W] zero-padded rows + int32 lengths).
//
// Replaces tuplex_tpu/ops/pallas_nfa.py:_build_kernel (the Pallas kernel the
// reference package runs on the TPU). It computes the same function and is
// checked against the plain torch version, NFARegex.match_bitmask in
// tuplex_tpu_torch/ops/nfa.py.
//
// Bound: memory. The scan reads each row's bytes once (at most N*W bytes
// plus 4N bytes of lengths) and writes N bools; the per-byte work is a few
// integer ops per live NFA position, far below the card's integer rate.
//
// Design (the Pallas kernel's TPU form is not carried over):
//   * One thread per row. The state S is one uint64 in a register; its bits
//     are the live NFA positions (P <= 64 is guaranteed by NFARegex).
//   * CLASSTAB (256 x u64, 2 KB) and FOLLOW (P x u64, <= 512 B) arrive by
//     value as a kernel parameter and are copied once per block into shared
//     memory. Each byte is a table lookup, not a one-hot matmul: Mosaic's
//     ban on integer indexing has no counterpart here.
//   * Transition: next = OR of FOLLOW[p] over the set bits p of S, walked
//     with __ffsll; S' = (next | seed) & CLASSTAB[byte]. The seed is FIRST
//     at every column, or only at column 0 when the pattern starts with ^.
//   * Each thread loops over its row's own length, not W: S is zero past
//     len, so no hit can occur there.
//   * '$' rule: with anchored_end a hit counts only where j+1 == len or
//     j+1 == end_at (one trailing '\n', python semantics).
//   * When W is a multiple of 8 and the rows are 8-byte aligned, a thread
//     reads its row 8 bytes per load.
// Known weakness, left for later work: one thread per row over a row-major
// matrix means neighbouring threads read addresses W bytes apart, so warp
// loads are uncoalesced; L1 catches the rest of each line.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxPositions = 64;
constexpr int kThreads = 256;

struct NfaParams {
  unsigned long long classtab[256];
  unsigned long long follow[kMaxPositions];
  unsigned long long first;
  unsigned long long last;
  int anchored_start;
  int anchored_end;
  int nullable;
};

__device__ __forceinline__ unsigned long long step(
    unsigned long long S, unsigned byte, int j,
    const unsigned long long* __restrict__ s_class,
    const unsigned long long* __restrict__ s_follow,
    const NfaParams& p) {
  unsigned long long nxt = 0ull;
  while (S) {
    int q = __ffsll(static_cast<long long>(S)) - 1;
    nxt |= s_follow[q];
    S &= S - 1ull;
  }
  unsigned long long seed = (!p.anchored_start || j == 0) ? p.first : 0ull;
  return (nxt | seed) & s_class[byte];
}

__global__ void __launch_bounds__(kThreads) nfa_scan_kernel(
    const uint8_t* __restrict__ bytes, const int32_t* __restrict__ lens,
    long long n, long long w, int vec8, const __grid_constant__ NfaParams p,
    bool* __restrict__ out) {
  __shared__ unsigned long long s_class[256];
  __shared__ unsigned long long s_follow[kMaxPositions];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) s_class[i] = p.classtab[i];
  for (int i = threadIdx.x; i < kMaxPositions; i += blockDim.x)
    s_follow[i] = p.follow[i];
  __syncthreads();

  long long row = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const uint8_t* r = bytes + row * w;
  long long len = lens[row];
  if (len < 0) len = 0;

  // end_at: '$' may also match just before one trailing newline
  long long lastpos = len - 1;
  if (lastpos < 0) lastpos = 0;
  if (lastpos > w - 1) lastpos = w - 1;
  bool trailing_nl = len > 0 && r[lastpos] == 10;
  long long end_at = trailing_nl ? len - 1 : len;

  bool matched = false;
  if (p.nullable) matched = (p.anchored_start && p.anchored_end) ? end_at == 0 : true;

  long long stop = len < w ? len : w;
  unsigned long long S = 0ull;
  long long j = 0;
  if (vec8) {
    const unsigned long long* r8 = reinterpret_cast<const unsigned long long*>(r);
    for (; j < stop; j += 8) {
      unsigned long long word = r8[j >> 3];
      long long k_end = stop - j < 8 ? stop - j : 8;
      for (long long k = 0; k < k_end; ++k) {
        unsigned byte = static_cast<unsigned>((word >> (8 * k)) & 0xffull);
        S = step(S, byte, static_cast<int>(j + k), s_class, s_follow, p);
        bool hit = (S & p.last) != 0ull;
        if (p.anchored_end)
          hit = hit && (j + k + 1 == len || j + k + 1 == end_at);
        matched |= hit;
      }
    }
  } else {
    for (; j < stop; ++j) {
      S = step(S, r[j], static_cast<int>(j), s_class, s_follow, p);
      bool hit = (S & p.last) != 0ull;
      if (p.anchored_end) hit = hit && (j + 1 == len || j + 1 == end_at);
      matched |= hit;
    }
  }
  out[row] = matched;
}

}  // namespace

// Plain C entry point, loaded with ctypes. The tables are host arrays; they
// travel to the card inside the kernel's parameter block. Returns the
// cudaGetLastError() code of the launch (0 = launched).
extern "C" int tpx_nfa_scan(const void* bytes, const void* lens, long long n,
                            long long w, int vec8,
                            const unsigned long long* classtab,
                            const unsigned long long* follow, int n_pos,
                            unsigned long long first, unsigned long long last,
                            int anchored_start, int anchored_end, int nullable,
                            void* out, void* stream) {
  if (n_pos < 0 || n_pos > kMaxPositions || w < 1 || n < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  NfaParams p;
  std::memset(&p, 0, sizeof(p));
  std::memcpy(p.classtab, classtab, sizeof(p.classtab));
  std::memcpy(p.follow, follow, sizeof(unsigned long long) * n_pos);
  p.first = first;
  p.last = last;
  p.anchored_start = anchored_start;
  p.anchored_end = anchored_end;
  p.nullable = nullable;
  long long blocks = (n + kThreads - 1) / kThreads;
  nfa_scan_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bytes), static_cast<const int32_t*>(lens), n,
      w, vec8, p, static_cast<bool*>(out));
  return static_cast<int>(cudaGetLastError());
}
