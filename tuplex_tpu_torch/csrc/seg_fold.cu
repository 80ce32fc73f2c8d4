// The general aggregate fold on Hopper: a register program folded row by
// row, in row order, into one accumulator per segment.
//
// Replaces the reference package's sequential device folds, the
// `lax.scan` of `tuplex_tpu/plan/aggregates.py:449` `ScanFold.build_fn`
// (whole-dataset `aggregate`) and `:506` `_seg_build_fn` (`aggregateByKey`,
// a scan over a per-key table). There the UDF is traced into the scan's
// body; here one fixed kernel interprets the program that
// compiler/foldprog.py lowers the UDF's recurrence into and ops/segfold.py
// `decode_program` decodes, so no UDF compiles anything at run time. The
// UDF's row terms (what does not read the accumulator) were evaluated over
// the whole batch beforehand by torch ops; the kernel reads each term's
// payload and meta word at the rows it folds.
//
// What it computes. Each segment's rows (order[offsets[s] ..
// offsets[s+1]), ascending) run through the decoded program in row order.
// Registers and leaves are dynamically typed (bool, int, float): each
// instruction applies CPython's rules for the tags it meets, int64
// arithmetic with overflow checks, IEEE double arithmetic by the _rn
// intrinsics (which nvcc never contracts into an FMA: `a * 0.9 + x`
// rounds twice, as CPython does), CPython's float floor division and
// remainder (Objects/floatobject.c _float_div_mod and float_rem),
// first-of-equal `min`/`max`. A row the kernel cannot finish exactly stops
// its segment (the host folds it and the segment's later rows on the
// interpreter); a row that raises an exact exception class is recorded and
// leaves the accumulator as it was.
//
// Design. A fold is serial within a segment, so its time is the longest
// segment's rows times the cost of a row. The decode (Python, once per
// program) names each operand's source, a register, an accumulator leaf, a
// constant or a row term, folds each term check into the instruction it
// precedes, two float operations in a row into one instruction (F2), and
// a RET into the instruction before it, so a row runs only arithmetic,
// comparisons and branches (G3: a branch and one F2 that writes the leaf,
// where the lowered program has 12 instructions). Two layouts share one
// launch:
//   - a segment of at least `long_rows` rows gets a warp of its own
//     (blocks [0, long_blocks); a classify kernel lists those segments).
//     The warp runs the program in lockstep: its row and its branches are
//     the same for every lane. Lane k holds register k and leaf k (every
//     lane holds the leaf of a one-leaf fold), in registers for the whole
//     segment; an operand is read by __shfl_sync, a result kept by the
//     lane it belongs to, and RET moves every leaf at once. The lanes
//     stage the segment's rows 32 at a time: tile k + 1's row numbers,
//     term payloads and meta words go by cp.async into a double-buffered
//     ring in shared memory while the program runs on tile k, and tile
//     k + 2's row numbers are loaded into registers meanwhile. When a
//     tile lands, lane i folds row i's term codes and Nones into two bit
//     masks, so a term check is two ANDs. A tile's statuses are kept by
//     the lanes (lane i, row i) and written back once per tile. A program
//     of one instruction gets a row loop of its own.
//   - the other segments get a thread each (the blocks after those):
//     250,000 segments of 4 rows fill the card that way. A thread keeps
//     its registers and its leaves (two banks, swapped at each RET) in
//     shared memory.
// Neither layout indexes an array in local memory (-Xptxas -v reports no
// stack frame and no spill; a launch bound of more than one block an SM
// makes ptxas spill).
//
// What holds it back. One warp that runs alone issues a dependent
// instruction about every 4 cycles, and the interpreter's dispatch,
// operand reads and tag tests are a chain of such instructions: about 550
// cycles a row for a one-instruction program on an H100 (0.28 us), against
// the 8 cycles of its one dependent FP64 addition. A program fused per UDF
// would remove the dispatch; this kernel is fixed and compiles nothing per
// UDF.
//
// Bound. The bytes it must move: each folded row's term payloads (8 B) and
// meta words (4 B), its place in `order` (8 B) and its status (1 B); the
// segment table is small. At 3.35 TB/s that is microseconds. A segment's
// rows are serial, so a fold with few segments cannot approach it: its
// serial bound is the longest segment's rows times the program's chain of
// dependent arithmetic through the accumulator (ops/segfold.py
// `Decoded.chain`) times one dependent FP64 operation's latency, which
// `tpx_seg_fold_calibrate` measures.
//
// The opcodes, operand kinds, tags and statuses are ops/segfold.py's.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_LEAVES = 16;
constexpr int MAX_TERMS = 32;
constexpr int MAX_REGS = 32;   // one a lane
constexpr int TILE = 32;      // rows a warp stages at once: one a lane
constexpr int WARPS = 4;      // warps in a block
constexpr int THREADS = 32 * WARPS;
constexpr unsigned FULL = 0xffffffffu;

enum Op {
  JZ = 7, JNZ = 8, STOP = 9,
  ADD = 10, SUB, MUL, DIV, FLOORDIV, MOD, MIN, MAX,
  LT = 20, LE, GT, GE, EQ, NE,
  NEG = 30, POS, NOT, ABS, INT, FLOAT, BOOL,
  F_ADD = 40, F_SUB, F_MUL, F_DIV,
  TCHK = 48, RET = 49,
  F2 = 64   // + f + 4 * g (+ 16): two float forms in one
};
enum Kind { K_REG = 0, K_LEAF = 1, K_CONST = 2, K_TERM = 3 };
enum Tag { T_BOOL = 0, T_INT = 1, T_FLOAT = 2, T_NONE = 3 };
enum Status { ST_HOST = 2, ST_FOLDED = 1, ST_EXC = 16 };
enum Class { ZERODIVISION = 1, VALUEERROR = 2, OVERFLOWERROR = 7,
             INTERNAL = 100 };
// a row's outcome: 0 done, STOPPED for the interpreter, else a class
constexpr int STOPPED = -1;

constexpr long long TWO53 = 1LL << 53;
constexpr double TWO63 = 9223372036854775808.0;

struct Val {
  long long p;   // an int64, a bool as 0/1, or a double's bits
  int t;
};

__device__ __forceinline__ double as_f(long long p) {
  return __longlong_as_double(p);
}
__device__ __forceinline__ Val mk_f(double d) {
  return Val{__double_as_longlong(d), T_FLOAT};
}
__device__ __forceinline__ Val mk_i(long long i, int t = T_INT) {
  return Val{i, t};
}
// an int or bool converted as CPython's float(int): round to nearest even
__device__ __forceinline__ double to_f(Val v) {
  return v.t == T_FLOAT ? as_f(v.p) : __ll2double_rn(v.p);
}
__device__ __forceinline__ bool truthy(Val v) {
  return v.t == T_FLOAT ? as_f(v.p) != 0.0 : v.p != 0;
}
__device__ __forceinline__ bool big53(Val v) {
  return v.t != T_FLOAT && (v.p > TWO53 || v.p < -TWO53);
}

// Three-way comparison as CPython's: *c is -1, 0, 1, or 2 when unordered
// (a NaN). An int beyond 2**53 against a float would need the exact
// comparison CPython makes: the row stops instead.
__device__ __forceinline__ int compare(Val x, Val y, int* c) {
  if (x.t != T_FLOAT && y.t != T_FLOAT) {
    *c = x.p < y.p ? -1 : (x.p > y.p ? 1 : 0);
    return 0;
  }
  if (big53(x) || big53(y)) return STOPPED;
  double a = to_f(x), b = to_f(y);
  *c = a < b ? -1 : (a > b ? 1 : (a == b ? 0 : 2));
  return 0;
}

// The arithmetic takes range tests, not switches: a switch over the
// opcode compiles to a jump table, whose indirect branch costs hundreds of
// cycles a row when one warp runs alone.

// fmod(vx, wx), exact. Where |vx / wx| < 2**53 the quotient rounded and
// truncated is n = trunc(vx / wx) or one past it, and vx - q * wx is then
// a double (the remainder, or the remainder less wx, which Sterbenz's
// lemma makes exact): one FMA and a correction. Otherwise, libm's loop.
__device__ __forceinline__ double exact_fmod(double vx, double wx) {
  const double q = trunc(__ddiv_rn(vx, wx));
  if (vx == 0.0 || isinf(wx) || !(fabs(q) < 9007199254740992.0))
    return fmod(vx, wx);
  double mod = __fma_rn(-q, wx, vx);
  if (mod != 0.0 && (mod < 0) != (vx < 0))
    mod = __dadd_rn(mod, (mod < 0) == (wx < 0) ? -wx : wx);
  return mod == 0.0 ? copysign(0.0, vx) : mod;
}

// CPython's float floor division and remainder (Objects/floatobject.c
// _float_div_mod and float_rem); wx is not zero
__device__ __forceinline__ double float_divmod(bool want_mod, double vx,
                                               double wx) {
  double mod = exact_fmod(vx, wx);
  if (want_mod) {
    if (mod != 0.0) {
      if ((wx < 0) != (mod < 0)) mod = __dadd_rn(mod, wx);
    } else {
      mod = copysign(0.0, wx);
    }
    return mod;
  }
  double div = __ddiv_rn(__dsub_rn(vx, mod), wx);
  if (mod != 0.0) {
    if ((wx < 0) != (mod < 0)) div = __dsub_rn(div, 1.0);
  }
  double fd;
  if (div != 0.0) {
    fd = floor(div);
    if (__dsub_rn(div, fd) > 0.5) fd = __dadd_rn(fd, 1.0);
  } else {
    fd = copysign(0.0, __ddiv_rn(vx, wx));
  }
  return fd;
}

// the rarer binary operations: true, floor division and remainder, min
// and max
__device__ __forceinline__ int divide(int op, Val x, Val y, Val* out) {
  const bool fl = x.t == T_FLOAT || y.t == T_FLOAT;
  if (op >= MIN) {
    // Python keeps the first argument unless the second is strictly
    // smaller (larger)
    int c;
    if (compare(y, x, &c)) return STOPPED;
    *out = c == (op == MIN ? -1 : 1) ? y : x;
    return 0;
  }
  if (op == DIV) {
    if (!fl) {
      if (y.p == 0) return ZERODIVISION;
      // int / int is correctly rounded; the float division is too while
      // both ints convert exactly
      if (big53(x) || big53(y)) return STOPPED;
    }
    const double b = to_f(y);
    if (b == 0.0) return ZERODIVISION;
    *out = mk_f(__ddiv_rn(to_f(x), b));
    return 0;
  }
  if (!fl) {     // FLOORDIV, MOD on ints
    const long long a = x.p, b = y.p;
    if (b == 0) return ZERODIVISION;
    if (a == (long long)(1ULL << 63) && b == -1) {
      if (op == FLOORDIV) return STOPPED;   // 2**63
      *out = mk_i(0);
      return 0;
    }
    long long q = a / b, m = a % b;
    if (m != 0 && ((m ^ b) < 0)) {
      m += b;
      q -= 1;
    }
    *out = mk_i(op == FLOORDIV ? q : m);
    return 0;
  }
  const double wx = to_f(y);
  if (wx == 0.0) return ZERODIVISION;
  *out = mk_f(float_divmod(op == MOD, to_f(x), wx));
  return 0;
}

__device__ __forceinline__ int unop(int op, Val x, Val* out) {
  const bool fl = x.t == T_FLOAT;
  if ((op == NOT) | (op == BOOL)) {
    *out = mk_i(truthy(x) != (op == NOT), T_BOOL);
    return 0;
  }
  if (op == FLOAT) {
    *out = mk_f(to_f(x));
    return 0;
  }
  if (op == INT) {
    if (!fl) {
      *out = mk_i(x.p);
      return 0;
    }
    const double d = as_f(x.p);
    if (isnan(d)) return VALUEERROR;
    if (isinf(d)) return OVERFLOWERROR;
    const double t = trunc(d);
    if (t < -TWO63 || t >= TWO63) return STOPPED;   // a big int
    *out = mk_i((long long)t);
    return 0;
  }
  // NEG, POS, ABS
  if (fl) {
    const double d = as_f(x.p);
    *out = mk_f(op == NEG ? -d : (op == ABS ? fabs(d) : d));
    return 0;
  }
  if (op != POS && x.p == (long long)(1ULL << 63)) return STOPPED;
  *out = mk_i(op == NEG ? -x.p : (op == ABS && x.p < 0 ? -x.p : x.p));
  return 0;
}

// One arithmetic instruction. The float forms take both operands as
// floats without testing their tags: the decode knows one is a float, so
// CPython's result is a float whatever the other is.
__device__ __forceinline__ int arith(int op, Val x, Val y, Val* out) {
  const bool fl = x.t == T_FLOAT || y.t == T_FLOAT;
  if (op >= F_ADD || (op <= MUL && fl)) {
    const double a = to_f(x), b = to_f(y);
    const int k = op >= F_ADD ? op - F_ADD : op - ADD;   // + - * /
    if (k == 3) {
      if (b == 0.0) return ZERODIVISION;
      *out = mk_f(__ddiv_rn(a, b));
      return 0;
    }
    const double s = __dadd_rn(a, b), d = __dsub_rn(a, b);
    const double m = __dmul_rn(a, b);
    *out = mk_f(k == 0 ? s : (k == 1 ? d : m));
    return 0;
  }
  if (op <= MUL) {     // ints: the row stops on an overflow
    const long long a = x.p, b = y.p;
    const unsigned long long ua = (unsigned long long)a;
    const unsigned long long ub = (unsigned long long)b;
    long long r;
    bool ovf;
    if (op == ADD) {
      r = (long long)(ua + ub);
      ovf = ((a ^ r) & (b ^ r)) < 0;
    } else if (op == SUB) {
      r = (long long)(ua - ub);
      ovf = ((a ^ b) & (a ^ r)) < 0;
    } else {
      r = (long long)(ua * ub);
      ovf = __mul64hi(a, b) != (r >> 63);
    }
    if (ovf) return STOPPED;
    *out = mk_i(r);
    return 0;
  }
  if (op >= NEG) return unop(op, x, out);
  if (op >= LT) {
    int c;
    if (compare(x, y, &c)) return STOPPED;
    // bit c + 1 (less, equal, greater, unordered) of each operator's row
    constexpr unsigned table = 0x1u | 0x3u << 4 | 0x4u << 8 | 0x6u << 12 |
                               0x2u << 16 | 0xDu << 20;   // LT .. NE
    *out = mk_i(table >> ((op - LT) * 4 + c + 1) & 1, T_BOOL);
    return 0;
  }
  return divide(op, x, y, out);
}

// f(a, b) for f 0 +, 1 -, 2 *: the three computed, one kept
__device__ __forceinline__ double fop(int f, double a, double b) {
  const double s = __dadd_rn(a, b), d = __dsub_rn(a, b);
  const double m = __dmul_rn(a, b);
  return f == 0 ? s : (f == 1 ? d : m);
}

// An F2 instruction: (x f y) g z, or z g (x f y) without the flag 16
__device__ __forceinline__ Val arith2(int op, Val x, Val y, Val z) {
  const int k = op - F2;
  const double t = fop(k & 3, to_f(x), to_f(y));
  const double c = to_f(z);
  return mk_f(k & 16 ? fop(k >> 2 & 3, t, c) : fop(k >> 2 & 3, c, t));
}

// One row through the decoded program: 0 (`row` took the new
// accumulator), STOPPED, or an exception class. An instruction is two
// int4s, (op, x, a, b) and (cm, nm, leaf, c): the term checks run first,
// then the instruction; an arithmetic one with leaf >= 0 writes that leaf
// and ends the row, with leaf <= -2 keeps its value and applies out table
// -2 - leaf. `row` reads operands, keeps results, checks terms
// and moves the leaves in its layout's way. The first instruction (h0,
// h1) is read once per segment and held in registers; the branches are
// ranges and equalities, never a switch (a jump table's indirect branch
// costs a warp that runs alone hundreds of cycles).
constexpr int GO_ON = -2;   // step: the row goes on at pc

template <class Row>
__device__ __forceinline__ int step(const int4 a, const int4 b, int& pc,
                                    Row& row) {
  const int e0 = row.check(static_cast<unsigned>(b.x),
                           static_cast<unsigned>(b.y));
  if (e0) return e0;
  const int op = a.x;
  if (op >= F2 || (op >= ADD && op <= F_DIV)) {
    const Val x = row.get(a.z);
    const Val y = row.get(a.w);   // a unary op's b is its a (the decode)
    Val v;
    if (op >= F2) {
      v = arith2(op, x, y, row.get(b.w));
    } else {
      const int e = arith(op, x, y, &v);
      if (e) return e;
    }
    if (b.z >= 0) {
      row.set_leaf(b.z, v);
      return 0;
    }
    row.set(a.y, v);
    if (b.z <= -2) {
      row.ret(-2 - b.z);
      return 0;
    }
    ++pc;
    return GO_ON;
  }
  if (op == RET) {
    if (a.y >= 0) row.ret(a.y);
    return 0;
  }
  if (op == STOP) return STOPPED;
  if (op == JZ || op == JNZ) {
    pc = truthy(row.get(a.z)) == (op == JNZ) ? a.y : pc + 1;
    return GO_ON;
  }
  ++pc;   // TCHK: its checks only
  return GO_ON;
}

template <class Row>
__device__ __forceinline__ int run_row(const int4* code, const int4 h0,
                                       const int4 h1, Row& row) {
  int pc = 0;
  int e = step(h0, h1, pc, row);
  while (e == GO_ON) e = step(code[2 * pc], code[2 * pc + 1], pc, row);
  return e;
}

struct Params {
  const int4* code;             // [n_code, 2] decoded
  int n_code;
  const int* outs;              // [n_outs, n_leaves] RET tables
  int n_outs;
  const long long* consts;      // [n_consts, 2] tag, payload
  int n_consts;
  int n_regs, n_terms, n_leaves;
  const long long* vals;        // [n_terms, b]
  const int* metas;             // [n_terms, b]
  long long b;
  const long long* order;       // [M]
  const long long* offsets;     // [nseg + 1]
  const long long* limits;      // [nseg]
  int nseg;
  const long long* seeds;       // [nseg, n_leaves]
  const signed char* seed_tags;
  long long* acc_out;
  signed char* tag_out;
  long long* first_out;
  long long* count_out;
  long long* stop_out;
  signed char* status;          // [b]
  const int* n_long;            // the classify kernel's count
  const int* long_ids;          // and its list of long segments
  int long_rows;
  int long_blocks;
};

// shared memory: the program, then the layout's area
__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~15; }
// (a padding instruction after the code, and room for one constant)
__host__ __device__ inline size_t code_bytes(int n_code) {
  return (size_t)(n_code + 1) * 32;
}
__host__ __device__ inline size_t consts_bytes(int n_consts) {
  return (size_t)(n_consts > 0 ? n_consts : 1) * 16;
}
__host__ __device__ inline size_t program_bytes(int n_code, int n_consts,
                                                int n_outs, int n_leaves) {
  return code_bytes(n_code) + consts_bytes(n_consts) +
         align16((size_t)n_outs * n_leaves * 4);
}
// one warp's ring: two tiles of row numbers, term payloads, meta words
// (room for one term at least: an operand reads a term slot whatever its
// kind)
__host__ __device__ inline size_t tile_bytes(int n_terms) {
  return (size_t)TILE * 8 + (size_t)(n_terms > 0 ? n_terms : 1) * TILE * 12;
}
__host__ __device__ inline size_t long_bytes(int n_terms) {
  return (size_t)WARPS * 2 * tile_bytes(n_terms);
}
// a block of threads' registers and two banks of leaves
__host__ __device__ inline size_t short_bytes(int n_regs, int n_leaves) {
  return (size_t)(n_regs + 2 * n_leaves) * THREADS * 9;
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// a warp per segment
// ---------------------------------------------------------------------------

// kScalar: one leaf, which every lane holds (no shuffle on the fold's
// chain); else lane k holds leaf k
template <bool kScalar>
struct WarpRow {
  // this lane's register and its leaf
  long long rp = 0, ap = 0;
  int rt = 0, at = 0;
  int lane, n_leaves;
  const long long* consts;
  const int* outs;
  const long long* tv;   // the row's term payloads, term t at tv[t * TILE]
  const int* tm;         // and its meta words
  unsigned eb, nb;       // the row's terms with a code, with a None

  // the kind is the same on every lane: the branches do not diverge
  __device__ __forceinline__ Val get(int o) const {
    const int kind = o >> 16, i = o & 0xFFFF;
    if (kind == K_TERM) return Val{tv[i * TILE], (tm[i * TILE] >> 8) & 3};
    if (kind == K_CONST) return Val{consts[2 * i + 1], (int)consts[2 * i]};
    if (kScalar && kind == K_LEAF) return Val{ap, at};
    const long long p = kind == K_LEAF ? ap : rp;
    const int t = kind == K_LEAF ? at : rt;
    return Val{__shfl_sync(FULL, p, i), __shfl_sync(FULL, t, i)};
  }
  __device__ __forceinline__ void set_leaf(int j, Val v) {
    if (kScalar || lane == j) {
      ap = v.p;
      at = v.t;
    }
  }
  __device__ __forceinline__ void set(int r, Val v) {
    if (r == lane) {
      rp = v.p;
      rt = v.t;
    }
  }
  // the lowest failing term of the check decides: its code, else its None
  __device__ __forceinline__ int check(unsigned cm, unsigned nm) const {
    const unsigned f = (eb & cm) | (nb & nm);
    if (!f) return 0;
    const int t = __ffs(f) - 1;
    if ((eb & cm) >> t & 1) {
      const int cls = tm[t * TILE] & 0xFF;
      return cls >= INTERNAL ? STOPPED : cls;
    }
    return STOPPED;
  }
  // lane j takes leaf j's operand; every source is read before any lane
  // writes
  __device__ __forceinline__ void ret(int k) {
    if (kScalar) {
      const Val v = get(outs[k]);
      ap = v.p;
      at = v.t;
      return;
    }
    const int o = lane < n_leaves ? outs[k * n_leaves + lane]
                                  : ((K_LEAF << 16) | lane);
    const int kind = o >> 16, i = o & 0xFFFF, src = i & 31;
    const long long qr = __shfl_sync(FULL, rp, src);
    const long long qa = __shfl_sync(FULL, ap, src);
    const int ur = __shfl_sync(FULL, rt, src);
    const int ua = __shfl_sync(FULL, at, src);
    const int ic = kind == K_CONST ? i : 0, it = kind == K_TERM ? i : 0;
    const long long cp = consts[2 * ic + 1], tp = tv[it * TILE];
    const int ct = (int)consts[2 * ic], tt = (tm[it * TILE] >> 8) & 3;
    ap = kind == K_REG ? qr
         : kind == K_LEAF ? qa : (kind == K_CONST ? cp : tp);
    at = kind == K_REG ? ur
         : kind == K_LEAF ? ua : (kind == K_CONST ? ct : tt);
  }
};

// Lane `lane` stages row r (-1: none) of a tile into slot `lane` of the
// ring buffer at `buf`: its number, and unless the segment has stopped,
// its terms by cp.async. Commits a group in every case.
__device__ __forceinline__ void stage_row(char* buf, const Params& P,
                                          int lane, long long r,
                                          bool terms) {
  long long* ord = reinterpret_cast<long long*>(buf);
  long long* tv = ord + TILE;
  int* tm = reinterpret_cast<int*>(tv + (size_t)P.n_terms * TILE);
  if (r >= 0) {
    ord[lane] = r;
    if (terms) {
      for (int t = 0; t < P.n_terms; ++t) {
        cp_async8(tv + t * TILE + lane, P.vals + t * P.b + r);
        cp_async4(tm + t * TILE + lane, P.metas + t * P.b + r);
      }
    }
  }
  cp_async_commit();
}

template <bool kScalar>
__device__ __forceinline__ void fold_long(const Params& P, int s, char* ring,
                          const int4* code, const long long* consts,
                          const int* outs) {
  const int lane = threadIdx.x & 31;
  const size_t tb = tile_bytes(P.n_terms);
  WarpRow<kScalar> row;
  row.lane = lane;
  row.n_leaves = P.n_leaves;
  row.consts = consts;
  row.outs = outs;
  if (kScalar || lane < P.n_leaves) {
    const int j = kScalar ? 0 : lane;
    row.ap = P.seeds[(long long)s * P.n_leaves + j];
    row.at = P.seed_tags[(long long)s * P.n_leaves + j];
  }
  const long long start = P.offsets[s], end = P.offsets[s + 1];
  const long long lim = P.limits[s];
  long long first = -1, count = 0, stop = -1;
  const int4 h0 = code[0], h1 = code[1];
  // tile 0 now; tile 1's row numbers into a register
  stage_row(ring, P, lane,
            start + lane < end ? P.order[start + lane] : -1, true);
  long long rn = start + TILE + lane < end ? P.order[start + TILE + lane]
                                            : -1;
  int k = 0;
  for (long long base = start; base < end; base += TILE, ++k) {
    char* buf = ring + (k & 1) * tb;
    // tile k + 1 goes in flight, tile k + 2's row numbers are loaded
    stage_row(ring + ((k + 1) & 1) * tb, P, lane,
              base + TILE < end ? rn : -1, stop < 0);
    rn = base + 2 * TILE + lane < end ? P.order[base + 2 * TILE + lane]
                                       : -1;
    cp_async_wait<1>();
    __syncwarp();
    const long long* ord = reinterpret_cast<const long long*>(buf);
    const long long* tv = ord + TILE;
    const int* tm = reinterpret_cast<const int*>(tv +
                                                 (size_t)P.n_terms * TILE);
    const int n = end - base < TILE ? (int)(end - base) : TILE;
    // lane i's row: the terms that carry a code, and those that are None
    unsigned eb = 0, nb = 0;
    if (lane < n && stop < 0) {
      for (int t = 0; t < P.n_terms; ++t) {
        const int m = tm[t * TILE + lane];
        eb |= (m & 0xFF ? 1u : 0u) << t;
        nb |= (((m >> 8) & 3) == T_NONE ? 1u : 0u) << t;
      }
    }
    // the rows with a failing term, and the first row at the limit
    const unsigned dirty = __ballot_sync(FULL, (eb | nb) != 0);
    const unsigned past = __ballot_sync(FULL, lane < n && ord[lane] >= lim);
    const int n_ok = past ? __ffs(past) - 1 : n;
    // the rows fold in order until one stops the segment or meets the
    // limit; lane i keeps row i's status, the host's unless it folds
    int mine = ST_HOST;
    auto fold_rows = [&](auto run) {
      for (int i = 0; i < n_ok; ++i) {
        row.eb = __shfl_sync(FULL, eb, i);
        row.nb = __shfl_sync(FULL, nb, i);
        row.tv = tv + i;
        row.tm = tm + i;
        const int e = run();
        if (lane == i) mine = e == 0 ? ST_FOLDED : (e > 0 ? ST_EXC + e
                                                           : ST_HOST);
        if (e < 0) {
          stop = ord[i];
          break;
        }
      }
    };
    if (stop < 0) {
      // a program of one instruction (it ends the row) gets a loop of
      // its own, where that instruction's fields stay decoded
      if (P.n_code == 1) {
        fold_rows([&]() {
          int pc = 0;
          return step(h0, h1, pc, row);
        });
      } else {
        fold_rows([&]() { return run_row(code, h0, h1, row); });
      }
      if (stop < 0 && n_ok < n) stop = ord[n_ok];
    }
    const unsigned folded = __ballot_sync(FULL, lane < n &&
                                                    mine == ST_FOLDED);
    count += __popc(folded);
    if (first < 0 && folded) first = ord[__ffs(folded) - 1];
    if (lane < n) P.status[ord[lane]] = (signed char)mine;
    __syncwarp();
  }
  cp_async_wait<0>();
  __syncwarp();
  if (lane < P.n_leaves) {
    P.acc_out[(long long)s * P.n_leaves + lane] = row.ap;
    P.tag_out[(long long)s * P.n_leaves + lane] = (signed char)row.at;
  }
  if (lane == 0) {
    P.first_out[s] = first;
    P.count_out[s] = count;
    P.stop_out[s] = stop;
  }
}

// ---------------------------------------------------------------------------
// a thread per segment
// ---------------------------------------------------------------------------

struct LaneRow {
  long long* rp;           // register k at rp[k * THREADS]
  signed char* rt;
  long long* ap;           // leaf j at ap[j * THREADS]; np the other bank
  signed char* at;
  long long* np;
  signed char* nt;
  int n_leaves;
  const long long* consts;
  const int* outs;
  const long long* vals;
  const int* metas;
  long long b, r;

  __device__ __forceinline__ Val get(int o) const {
    const int kind = o >> 16, i = o & 0xFFFF;
    if (kind == K_TERM) {
      return Val{vals[i * b + r], (metas[i * b + r] >> 8) & 3};
    }
    // a register, a leaf or a constant: all read, the kind picks
    const int is = kind == K_CONST ? 0 : i, ic = kind == K_CONST ? i : 0;
    const long long* p = kind == K_REG ? rp : ap;
    const signed char* t = kind == K_REG ? rt : at;
    const long long sp = p[is * THREADS], cp = consts[2 * ic + 1];
    const int st = t[is * THREADS], ct = (int)consts[2 * ic];
    return kind == K_CONST ? Val{cp, ct} : Val{sp, st};
  }
  __device__ __forceinline__ void set(int k, Val v) {
    rp[k * THREADS] = v.p;
    rt[k * THREADS] = (signed char)v.t;
  }
  // the row ends here: the current bank takes the leaf
  __device__ __forceinline__ void set_leaf(int j, Val v) {
    ap[j * THREADS] = v.p;
    at[j * THREADS] = (signed char)v.t;
  }
  __device__ __forceinline__ int check(unsigned cm, unsigned nm) const {
    if (!(cm | nm)) return 0;
    for (unsigned f = cm | nm; f; f &= f - 1) {
      const int t = __ffs(f) - 1;
      const int m = metas[t * b + r];
      if ((cm >> t & 1) && (m & 0xFF)) {
        return (m & 0xFF) >= INTERNAL ? STOPPED : (m & 0xFF);
      }
      if ((nm >> t & 1) && ((m >> 8) & 3) == T_NONE) return STOPPED;
    }
    return 0;
  }
  // the new leaves go to the other bank, which becomes the current one
  __device__ __forceinline__ void ret(int k) {
    for (int j = 0; j < n_leaves; ++j) {
      const Val v = get(outs[k * n_leaves + j]);
      np[j * THREADS] = v.p;
      nt[j * THREADS] = (signed char)v.t;
    }
    long long* p = ap;
    ap = np;
    np = p;
    signed char* t = at;
    at = nt;
    nt = t;
  }
};

__device__ __forceinline__ void fold_short(const Params& P, int s, char* area,
                           const int4* code, const long long* consts,
                           const int* outs) {
  const int tid = threadIdx.x;
  const int R = P.n_regs, L = P.n_leaves;
  long long* p64 = reinterpret_cast<long long*>(area);
  signed char* p8 = reinterpret_cast<signed char*>(
      p64 + (size_t)(R + 2 * L) * THREADS);
  LaneRow row;
  row.rp = p64 + tid;
  row.ap = p64 + (size_t)R * THREADS + tid;
  row.np = p64 + (size_t)(R + L) * THREADS + tid;
  row.rt = p8 + tid;
  row.at = p8 + (size_t)R * THREADS + tid;
  row.nt = p8 + (size_t)(R + L) * THREADS + tid;
  row.n_leaves = L;
  row.consts = consts;
  row.outs = outs;
  row.vals = P.vals;
  row.metas = P.metas;
  row.b = P.b;
  for (int j = 0; j < L; ++j) {
    row.ap[j * THREADS] = P.seeds[(long long)s * L + j];
    row.at[j * THREADS] = P.seed_tags[(long long)s * L + j];
  }
  const long long end = P.offsets[s + 1], lim = P.limits[s];
  long long first = -1, count = 0, stop = -1;
  const int4 h0 = code[0], h1 = code[1];
  for (long long i = P.offsets[s]; i < end; ++i) {
    const long long r = P.order[i];
    if (stop >= 0 || r >= lim) {
      if (stop < 0) stop = r;
      P.status[r] = ST_HOST;
      continue;
    }
    row.r = r;
    const int e = run_row(code, h0, h1, row);
    if (e == 0) {
      P.status[r] = ST_FOLDED;
      if (first < 0) first = r;
      ++count;
    } else if (e > 0) {
      P.status[r] = (signed char)(ST_EXC + e);
    } else {
      stop = r;
      P.status[r] = ST_HOST;
    }
  }
  for (int j = 0; j < L; ++j) {
    P.acc_out[(long long)s * L + j] = row.ap[j * THREADS];
    P.tag_out[(long long)s * L + j] = row.at[j * THREADS];
  }
  P.first_out[s] = first;
  P.count_out[s] = count;
  P.stop_out[s] = stop;
}

__global__ void __launch_bounds__(THREADS, 1) seg_fold_kernel(const Params P) {
  extern __shared__ __align__(16) char smem[];
  int4* code = reinterpret_cast<int4*>(smem);
  long long* consts = reinterpret_cast<long long*>(smem +
                                                   code_bytes(P.n_code));
  int* outs = reinterpret_cast<int*>(reinterpret_cast<char*>(consts) +
                                     consts_bytes(P.n_consts));
  char* area = smem + program_bytes(P.n_code, P.n_consts, P.n_outs,
                                    P.n_leaves);
  for (int i = threadIdx.x; i < 2 * (P.n_code + 1); i += THREADS)
    code[i] = i < 2 * P.n_code ? P.code[i]
              : make_int4(i & 1 ? 0 : STOP, 0, i & 1 ? -1 : 0, 0);
  for (int i = threadIdx.x; i < 2 * P.n_consts; i += THREADS)
    consts[i] = P.consts[i];
  if (P.n_consts == 0 && threadIdx.x < 2) consts[threadIdx.x] = 0;
  for (int i = threadIdx.x; i < P.n_outs * P.n_leaves; i += THREADS)
    outs[i] = P.outs[i];
  __syncthreads();
  if ((int)blockIdx.x < P.long_blocks) {
    const int warp = threadIdx.x >> 5;
    char* ring = area + warp * 2 * tile_bytes(P.n_terms);
    const int n_long = *P.n_long, stride = P.long_blocks * WARPS;
    for (int j = blockIdx.x * WARPS + warp; j < n_long; j += stride) {
      if (P.n_leaves == 1) {
        fold_long<true>(P, P.long_ids[j], ring, code, consts, outs);
      } else {
        fold_long<false>(P, P.long_ids[j], ring, code, consts, outs);
      }
    }
    return;
  }
  const int s = (blockIdx.x - P.long_blocks) * THREADS + threadIdx.x;
  if (s < P.nseg && P.offsets[s + 1] - P.offsets[s] < P.long_rows)
    fold_short(P, s, area, code, consts, outs);
}

// The segments of at least long_rows rows, in no particular order.
__global__ void classify_kernel(const long long* offsets, int nseg,
                                int long_rows, int* n_long, int* long_ids) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s < nseg && offsets[s + 1] - offsets[s] >= long_rows)
    long_ids[atomicAdd(n_long, 1)] = s;
}

// A dependent chain of n multiplications and n additions, each waiting
// for the one before: the latency of one dependent FP64 operation.
__global__ void calibrate_kernel(double* x, long long* cycles,
                                 long long n) {
  double v = x[0];
  const double m = x[1], c = x[2];
  const long long t0 = clock64();
  for (long long i = 0; i < n; ++i) v = __dadd_rn(__dmul_rn(v, m), c);
  const long long t1 = clock64();
  x[0] = v;
  cycles[0] = t1 - t0;
}

// the card's SM count and shared memory, read once per device, and the
// largest dynamic shared memory the kernel was allowed there
constexpr int MAX_DEVICES = 64;
struct DeviceInfo {
  int n_sm = 0, smem_max = 0;
  size_t smem_set = 48 << 10;
};
DeviceInfo device_info[MAX_DEVICES];

}  // namespace

// code: [n_code, 8] int32 decoded program; outs: [n_outs, n_leaves] int32;
// consts: [n_consts, 2] int64; vals, metas: [n_terms, b]; order: [M];
// offsets: [nseg + 1]; limits: [nseg]; seeds, seed_tags: [nseg, n_leaves];
// outputs acc, tags: [nseg, n_leaves], first, count, stop: [nseg], status:
// [b] (zeroed by the caller). scratch: [1 + cap] int32, cap >= the number
// of segments of at least long_rows rows (M / long_rows bounds it). All on
// the current device. Returns 0 or the cudaError of a launch.
extern "C" int tpx_seg_fold(
    const int* code, int n_code, const int* outs, int n_outs,
    const long long* consts, int n_consts, int n_regs, int n_terms,
    const long long* vals, const int* metas, long long b,
    const long long* order, const long long* offsets,
    const long long* limits, int nseg, int n_leaves, const long long* seeds,
    const signed char* seed_tags, long long* acc_out, signed char* tag_out,
    long long* first_out, long long* count_out, long long* stop_out,
    signed char* status, int* scratch, int cap, int long_rows,
    void* stream) {
  if (nseg == 0) return 0;
  if (n_leaves < 1 || n_leaves > MAX_LEAVES || n_terms < 0 ||
      n_terms > MAX_TERMS || n_regs < 0 || n_regs > MAX_REGS ||
      long_rows < 1 || cap < 0)
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  DeviceInfo& info = device_info[dev];
  if (info.n_sm == 0) {
    cudaDeviceGetAttribute(&info.n_sm, cudaDevAttrMultiProcessorCount, dev);
    cudaDeviceGetAttribute(&info.smem_max,
                           cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  const int n_sm = info.n_sm;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  Params P;
  P.code = reinterpret_cast<const int4*>(code);
  P.n_code = n_code;
  P.outs = outs;
  P.n_outs = n_outs;
  P.consts = consts;
  P.n_consts = n_consts;
  P.n_regs = n_regs;
  P.n_terms = n_terms;
  P.n_leaves = n_leaves;
  P.vals = vals;
  P.metas = metas;
  P.b = b;
  P.order = order;
  P.offsets = offsets;
  P.limits = limits;
  P.nseg = nseg;
  P.seeds = seeds;
  P.seed_tags = seed_tags;
  P.acc_out = acc_out;
  P.tag_out = tag_out;
  P.first_out = first_out;
  P.count_out = count_out;
  P.stop_out = stop_out;
  P.status = status;
  P.n_long = scratch;
  P.long_ids = scratch + 1;
  P.long_rows = long_rows;
  // enough warps for the long segments, at most 32 on each SM; they walk
  // the list with a stride
  const long long want = ((long long)cap + WARPS - 1) / WARPS;
  P.long_blocks = (int)(want < 8LL * n_sm ? want : 8LL * n_sm);
  const int short_blocks = (nseg + THREADS - 1) / THREADS;
  size_t area = short_bytes(n_regs, n_leaves);
  if (P.long_blocks > 0 && long_bytes(n_terms) > area)
    area = long_bytes(n_terms);
  const size_t smem = program_bytes(n_code, n_consts, n_outs, n_leaves) +
                      area;
  if (smem > (size_t)info.smem_max) return (int)cudaErrorInvalidValue;
  if (P.long_blocks > 0) {
    err = cudaMemsetAsync(scratch, 0, sizeof(int), st);
    if (err != cudaSuccess) return (int)err;
    classify_kernel<<<(nseg + 255) / 256, 256, 0, st>>>(
        offsets, nseg, long_rows, scratch, scratch + 1);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (smem > info.smem_set) {
    err = cudaFuncSetAttribute(seg_fold_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    info.smem_set = smem;
  }
  seg_fold_kernel<<<P.long_blocks + short_blocks, THREADS, smem, st>>>(P);
  return (int)cudaGetLastError();
}

// x: [3] float64 (the chain's start, multiplier and addend; x[0] gets its
// end), cycles: [1] int64 (clock64 ticks of the chain). One thread.
extern "C" int tpx_seg_fold_calibrate(double* x, long long* cycles,
                                      long long n, void* stream) {
  calibrate_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      x, cycles, n);
  return (int)cudaGetLastError();
}
