// The general aggregate fold on Hopper: a register program folded row by
// row, in row order, into one accumulator per segment.
//
// Replaces the reference package's sequential device folds, the
// `lax.scan` of `tuplex_tpu/plan/aggregates.py:449` `ScanFold.build_fn`
// (whole-dataset `aggregate`) and `:506` `_seg_build_fn` (`aggregateByKey`,
// a scan over a per-key table). There the UDF is traced into the scan's
// body; here one fixed kernel interprets the program that
// compiler/foldprog.py lowers the UDF's recurrence into, so no UDF compiles
// anything at run time. The UDF's row terms (what does not read the
// accumulator) were evaluated over the whole batch beforehand by torch ops;
// the kernel reads each term's payload and meta word at the rows it folds.
//
// Design. One thread per segment walks the segment's rows in row order
// (order[offsets[s] .. offsets[s+1]), ascending within a segment), and
// runs the program on each: a fold is sequential within a segment, and the
// segments are independent. The program and its constants sit in shared
// memory; registers, each a 64-bit payload and a type tag (bool, int,
// float), live in the thread's local memory. Each instruction applies
// CPython's rules for the tags it meets: int64 arithmetic with overflow
// checks, IEEE double arithmetic by the _rn intrinsics (which nvcc never
// contracts into an FMA: `a * 0.9 + x` rounds twice, as CPython does),
// CPython's float floor division and remainder (Objects/floatobject.c
// _float_div_mod and float_rem), first-of-equal `min`/`max`. A row the
// kernel cannot finish exactly stops its segment (the host folds it and the
// segment's later rows on the interpreter); a row that raises an exact
// exception class is recorded and leaves the accumulator as it was.
//
// Bound. The bytes it must move: each folded row's term payloads (8 B) and
// meta words (4 B), its place in `order` (8 B) and its status (1 B); the
// segment table is small. At 3.35 TB/s that is microseconds; a segment's
// rows are serial, so a fold with few segments (one, for `aggregate`) runs
// at one thread's latency per row and cannot approach the bound. Making it
// fast is later work: a warp per segment with row tiles staged by cp.async,
// or a program fused per UDF.
//
// The opcodes, tags and statuses are ops/segfold.py's.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_REGS = 64;
constexpr int MAX_LEAVES = 16;

enum Op {
  TERM = 1, ACC, CONST, MOV, OUT, JMP, JZ, JNZ, STOP,
  ADD = 10, SUB, MUL, DIV, FLOORDIV, MOD, MIN, MAX,
  LT = 20, LE, GT, GE, EQ, NE,
  NEG = 30, POS, NOT, ABS, INT, FLOAT, BOOL
};
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

__device__ int binop(int op, Val x, Val y, Val* out) {
  const bool fl = x.t == T_FLOAT || y.t == T_FLOAT;
  switch (op) {
    case ADD: case SUB: case MUL: {
      if (fl) {
        double a = to_f(x), b = to_f(y);
        *out = mk_f(op == ADD ? __dadd_rn(a, b)
                    : op == SUB ? __dsub_rn(a, b) : __dmul_rn(a, b));
        return 0;
      }
      long long a = x.p, b = y.p, r;
      unsigned long long ua = (unsigned long long)a;
      unsigned long long ub = (unsigned long long)b;
      if (op == ADD) {
        r = (long long)(ua + ub);
        if (((a ^ r) & (b ^ r)) < 0) return STOPPED;
      } else if (op == SUB) {
        r = (long long)(ua - ub);
        if (((a ^ b) & (a ^ r)) < 0) return STOPPED;
      } else {
        r = (long long)(ua * ub);
        if (__mul64hi(a, b) != (r >> 63)) return STOPPED;
      }
      *out = mk_i(r);
      return 0;
    }
    case DIV: {
      if (!fl) {
        if (y.p == 0) return ZERODIVISION;
        // int / int is correctly rounded; the float division is too while
        // both ints convert exactly
        if (big53(x) || big53(y)) return STOPPED;
      }
      double a = to_f(x), b = to_f(y);
      if (b == 0.0) return ZERODIVISION;
      *out = mk_f(__ddiv_rn(a, b));
      return 0;
    }
    case FLOORDIV: case MOD: {
      if (!fl) {
        long long a = x.p, b = y.p;
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
      double vx = to_f(x), wx = to_f(y);
      if (wx == 0.0) return ZERODIVISION;
      double mod = fmod(vx, wx);     // exact
      if (op == MOD) {
        if (mod != 0.0) {
          if ((wx < 0) != (mod < 0)) mod = __dadd_rn(mod, wx);
        } else {
          mod = copysign(0.0, wx);
        }
        *out = mk_f(mod);
        return 0;
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
      *out = mk_f(fd);
      return 0;
    }
    case MIN: case MAX: {
      // Python keeps the first argument unless the second is strictly
      // smaller (larger)
      int c;
      if (compare(y, x, &c)) return STOPPED;
      *out = c == (op == MIN ? -1 : 1) ? y : x;
      return 0;
    }
    default: {
      int c;
      if (compare(x, y, &c)) return STOPPED;
      bool r;
      switch (op) {
        case LT: r = c == -1; break;
        case LE: r = c == -1 || c == 0; break;
        case GT: r = c == 1; break;
        case GE: r = c == 1 || c == 0; break;
        case EQ: r = c == 0; break;
        default: r = c != 0; break;   // NE
      }
      *out = mk_i(r, T_BOOL);
      return 0;
    }
  }
}

__device__ int unop(int op, Val x, Val* out) {
  const bool fl = x.t == T_FLOAT;
  switch (op) {
    case NEG:
      if (fl) { *out = mk_f(-as_f(x.p)); return 0; }
      if (x.p == (long long)(1ULL << 63)) return STOPPED;
      *out = mk_i(-x.p);
      return 0;
    case POS:
      *out = fl ? x : mk_i(x.p);
      return 0;
    case NOT:
      *out = mk_i(!truthy(x), T_BOOL);
      return 0;
    case ABS:
      if (fl) { *out = mk_f(fabs(as_f(x.p))); return 0; }
      if (x.p == (long long)(1ULL << 63)) return STOPPED;
      *out = mk_i(x.p < 0 ? -x.p : x.p);
      return 0;
    case INT: {
      if (!fl) { *out = mk_i(x.p); return 0; }
      double d = as_f(x.p);
      if (isnan(d)) return VALUEERROR;
      if (isinf(d)) return OVERFLOWERROR;
      double t = trunc(d);
      if (t < -TWO63 || t >= TWO63) return STOPPED;   // a big int
      *out = mk_i((long long)t);
      return 0;
    }
    case FLOAT:
      *out = mk_f(to_f(x));
      return 0;
    default:   // BOOL
      *out = mk_i(truthy(x), T_BOOL);
      return 0;
  }
}

// One row through the program: 0 (res holds the new accumulator),
// STOPPED, or an exception class.
__device__ int run_row(const int4* code, int n_code, const long long* cp,
                       const long long* vals, const int* metas, long long b,
                       long long r, const Val* acc, Val* res) {
  Val regs[MAX_REGS];
  int pc = 0;
  while (pc < n_code) {
    const int4 ins = code[pc++];
    const int op = ins.x, dst = ins.y, a = ins.z;
    switch (op) {
      case TERM: {
        const int meta = metas[(long long)a * b + r];
        const int cls = meta & 0xFF;
        if (cls) return cls >= INTERNAL ? STOPPED : cls;
        if (dst >= 0) {
          const int t = (meta >> 8) & 3;
          if (t == T_NONE) return STOPPED;
          regs[dst] = Val{vals[(long long)a * b + r], t};
        }
        break;
      }
      case ACC: regs[dst] = acc[a]; break;
      case CONST: regs[dst] = Val{cp[2 * a + 1], (int)cp[2 * a]}; break;
      case MOV: regs[dst] = regs[a]; break;
      case OUT: res[dst] = regs[a]; break;
      case JMP: pc = dst; break;
      case JZ: if (!truthy(regs[a])) pc = dst; break;
      case JNZ: if (truthy(regs[a])) pc = dst; break;
      case STOP: return STOPPED;
      default: {
        Val v;
        const int e = op >= NEG ? unop(op, regs[a], &v)
                                : binop(op, regs[a], regs[ins.w], &v);
        if (e) return e;
        regs[dst] = v;
      }
    }
  }
  return 0;
}

__global__ void __launch_bounds__(128) seg_fold_kernel(
    const int* __restrict__ code, int n_code,
    const long long* __restrict__ consts, int n_consts,
    const long long* __restrict__ vals, const int* __restrict__ metas,
    long long b, const long long* __restrict__ order,
    const long long* __restrict__ offsets,
    const long long* __restrict__ limits, int nseg, int n_leaves,
    const long long* __restrict__ seeds,
    const signed char* __restrict__ seed_tags, long long* acc_out,
    signed char* tag_out, long long* first_out, long long* count_out,
    long long* stop_out, signed char* status) {
  extern __shared__ int4 smem[];
  int4* s_code = smem;
  long long* s_consts = reinterpret_cast<long long*>(smem + n_code);
  for (int i = threadIdx.x; i < n_code; i += blockDim.x)
    s_code[i] = make_int4(code[4 * i], code[4 * i + 1], code[4 * i + 2],
                          code[4 * i + 3]);
  for (int i = threadIdx.x; i < 2 * n_consts; i += blockDim.x)
    s_consts[i] = consts[i];
  __syncthreads();
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= nseg) return;

  Val acc[MAX_LEAVES], res[MAX_LEAVES];
  for (int j = 0; j < n_leaves; ++j)
    acc[j] = Val{seeds[(long long)s * n_leaves + j],
                 (int)seed_tags[(long long)s * n_leaves + j]};
  const long long end = offsets[s + 1], lim = limits[s];
  long long first = -1, count = 0, stop = -1;
  for (long long i = offsets[s]; i < end; ++i) {
    const long long r = order[i];
    if (stop >= 0 || r >= lim) {
      if (stop < 0) stop = r;
      status[r] = ST_HOST;
      continue;
    }
    for (int j = 0; j < n_leaves; ++j) res[j] = acc[j];
    const int e = run_row(s_code, n_code, s_consts, vals, metas, b, r, acc,
                          res);
    if (e == 0) {
      for (int j = 0; j < n_leaves; ++j) acc[j] = res[j];
      status[r] = ST_FOLDED;
      if (first < 0) first = r;
      ++count;
    } else if (e > 0) {
      status[r] = (signed char)(ST_EXC + e);
    } else {
      stop = r;
      status[r] = ST_HOST;
    }
  }
  for (int j = 0; j < n_leaves; ++j) {
    acc_out[(long long)s * n_leaves + j] = acc[j].p;
    tag_out[(long long)s * n_leaves + j] = (signed char)acc[j].t;
  }
  first_out[s] = first;
  count_out[s] = count;
  stop_out[s] = stop;
}

}  // namespace

extern "C" int tpx_seg_fold(
    const int* code, int n_code, const long long* consts, int n_consts,
    const long long* vals, const int* metas, long long b,
    const long long* order, const long long* offsets,
    const long long* limits, int nseg, int n_leaves, const long long* seeds,
    const signed char* seed_tags, long long* acc_out, signed char* tag_out,
    long long* first_out, long long* count_out, long long* stop_out,
    signed char* status, void* stream) {
  if (nseg == 0) return 0;
  if (n_leaves < 1 || n_leaves > MAX_LEAVES) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const int blocks = (nseg + threads - 1) / threads;
  const size_t smem = (size_t)n_code * sizeof(int4) +
                      (size_t)n_consts * 2 * sizeof(long long);
  seg_fold_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      code, n_code, consts, n_consts, vals, metas, b, order, offsets, limits,
      nseg, n_leaves, seeds, seed_tags, acc_out, tag_out, first_out,
      count_out, stop_out, status);
  return (int)cudaGetLastError();
}
