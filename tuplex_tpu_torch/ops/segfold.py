"""The general fold of the aggregate stage: a register program folded
row by row into one accumulator per segment (counterpart of the reference
package's `lax.scan` folds, `tuplex_tpu/plan/aggregates.py:449`
`ScanFold.build_fn` and `:506` `_seg_build_fn`).

An aggregate UDF that `plan/aggregates.py` `recognize_fold` declines is
split by `compiler/foldprog.py` into row terms, evaluated over the whole
batch by the emitter, and a short program that reads the accumulator.
`seg_fold` runs that program over each segment's rows in row order: the
hand-written CUDA kernel `csrc/seg_fold.cu` (ops/segfold_cuda.py) for CUDA
tensors, `seg_fold_plain` below for CPU tensors. A sequential fold has no
form in torch ops short of launches per row, so the plain version is a
Python loop over the same arrays; it repeats the kernel's steps and is the
kernel's yardstick, not its fallback.

The lowered program (compiler/foldprog.py) gives every result a fresh
register and moves values with ACC, CONST, MOV and OUT. `decode_program`
rewrites it once per program into what the kernel and the plain version
run: each operand names its source (a register, an accumulator leaf, a
constant or a row term), so only arithmetic, comparisons, branches and
one RET per path remain; a term check rides on the instruction after it,
two float operations in a row fuse into one (F2), and a RET into the
arithmetic before it. The decode follows every path from the top, so
the code after a branch is copied into each arm; the registers left are
allocated by a linear scan.

Values are dynamically typed as in Python: every register, term and
accumulator leaf carries a tag (bool, int or float) beside a 64-bit
payload (an int64, or a float64's bits), and each instruction applies
Python's rules for the tags it meets. What a row needs beyond them stops
its segment there, and the host folds that row and the segment's later
rows on the interpreter (int64 overflow, an int/int true division or an
int-float comparison with an int beyond 2**53, a None term, a term's
internal error code, a row at or past the segment's `limit`).

The ABI below (the decoded opcodes and operands, tags, row statuses, the
term meta word) is shared with csrc/seg_fold.cu.
"""

from __future__ import annotations

import heapq
import math
import struct
from dataclasses import dataclass, field

import numpy as np
import torch

from ..core.errors import NotCompilable

# -- the lowered program's opcodes: (op, dst, a, b) int32 quadruples --------
TERM = 1     # dst = term a at the row (dst < 0: check only); raise its code
ACC = 2      # dst = accumulator leaf a
CONST = 3    # dst = constant a
MOV = 4      # dst = a
OUT = 5      # result leaf dst = a (committed when the program ends)
JMP = 6      # pc = dst
JZ = 7       # if not truthy(a): pc = dst
JNZ = 8      # if truthy(a): pc = dst
STOP = 9     # the row needs the interpreter
ADD, SUB, MUL, DIV, FLOORDIV, MOD, MIN, MAX = range(10, 18)
LT, LE, GT, GE, EQ, NE = range(20, 26)
NEG, POS, NOT, ABS, INT, FLOAT, BOOL = range(30, 37)

# -- value tags ----------------------------------------------------------------
TAG_BOOL, TAG_INT, TAG_FLOAT, TAG_NONE = 0, 1, 2, 3

# -- row statuses (int8) ------------------------------------------------------
ST_NONE = 0      # in no segment
ST_FOLDED = 1
ST_HOST = 2      # the segment's stop row, or a later row of its segment
ST_EXC = 16      # + the exception class (core/errors.py ExceptionCode)

# a term's meta word: the error class in the low byte (internal classes,
# 100 and up, stop the segment), the row's tag in bits 8-9
INTERNAL_CLASS = 100
ZERODIVISION, VALUEERROR, OVERFLOWERROR = 1, 2, 7

# -- the decoded program: (op, x, a, b, cm, nm, leaf, c) int32 rows -------
# Before an instruction runs, the row's terms in mask cm raise their codes
# and those in mask nm stop the row where None; the lowest failing term
# decides. JZ, JNZ (x: the target, a: the operand), STOP and the
# arithmetic (x: the destination register, a and b: operands) keep their
# opcodes; an arithmetic instruction with leaf >= 0 writes that leaf and
# ends the row (the rest of the accumulator unchanged). The float forms
# apply where an operand is known to be a float, so the result is one
# whatever the other operand's tag.
F_ADD, F_SUB, F_MUL, F_DIV = range(40, 44)
TCHK = 48    # only its checks
RET = 49     # the row's new accumulator: out table x (an operand a leaf;
             # x < 0: the accumulator as it was)
# Two float forms in one: r = (a f b) g c, or c g (a f b) with the flag 16;
# f and g are 0 +, 1 -, 2 *: op = F2 + f + 4 * g (+ 16), c in the eighth
# field. An arithmetic instruction with leaf <= -2 applies out table
# -2 - leaf once its value is kept, and ends the row.
F2 = 64
_F2_OPS = {F_ADD: 0, F_SUB: 1, F_MUL: 2}
# an operand: kind << 16 | index
K_REG, K_LEAF, K_CONST, K_TERM = range(4)

MAX_REGS = 64    # the lowered program's registers
MAX_DECODED_REGS = 32   # the decoded program's: one a lane of a warp
MAX_LEAVES = 16  # accumulator leaves
MAX_TERMS = 32   # row terms (a term check's mask is one 32-bit word)
MAX_CODE = 2048  # lowered instructions
MAX_CONSTS = 512
PROGRAM_BYTES = 48 << 10   # decoded code, constants and out tables: they
                           # sit in the kernel's shared memory

_I64_MIN, _I64_MAX = -(1 << 63), (1 << 63) - 1
_TWO53 = 1 << 53


def segment_layout(codes: torch.Tensor, nseg: int):
    """(order [M] int64, offsets [nseg + 1] int64) of the rows whose code
    in codes [B] is in [0, nseg): the rows sorted stably by segment, so
    that each segment's rows stay in row order, and where each segment's
    run starts."""
    rows = torch.nonzero(codes >= 0).squeeze(1)
    c = codes[rows]
    order = rows[torch.sort(c, stable=True).indices]
    counts = torch.bincount(c, minlength=nseg)
    offsets = torch.zeros(nseg + 1, dtype=torch.int64, device=codes.device)
    offsets[1:] = torch.cumsum(counts, 0)
    return order, offsets


def pack_value(v) -> tuple[int, int]:
    """(tag, int64 payload) of a Python bool, int or float; ValueError for
    anything else, an int beyond int64 included."""
    if isinstance(v, bool):
        return TAG_BOOL, int(v)
    if isinstance(v, int):
        if not _I64_MIN <= v <= _I64_MAX:
            raise ValueError("int beyond int64")
        return TAG_INT, v
    if isinstance(v, float):
        return TAG_FLOAT, struct.unpack("<q", struct.pack("<d", v))[0]
    raise ValueError(f"{type(v).__name__} is not a fold value")


def unpack_value(tag: int, payload: int):
    if tag == TAG_BOOL:
        return bool(payload)
    if tag == TAG_INT:
        return int(payload)
    if tag == TAG_FLOAT:
        return struct.unpack("<d", struct.pack("<q", payload))[0]
    raise ValueError(f"tag {tag} has no value")


class SegFoldResult:
    """What a fold of the segments returns, all on the input's device:
    acc [nseg, L] int64 payloads and acc_tags [nseg, L] int8 (the seeds
    where a segment folded nothing), first [nseg] (its first folded row,
    -1 if none), count [nseg] (rows folded), stop [nseg] (its first row
    that needs the interpreter, -1 if none) and status [B] int8."""

    def __init__(self, acc, acc_tags, first, count, stop, status):
        self.acc, self.acc_tags = acc, acc_tags
        self.first, self.count, self.stop = first, count, stop
        self.status = status


def seg_fold(prog, vals: torch.Tensor, metas: torch.Tensor,
             order: torch.Tensor, offsets: torch.Tensor,
             limits: torch.Tensor, seeds: torch.Tensor,
             seed_tags: torch.Tensor) -> SegFoldResult:
    """Fold each segment's rows, in row order, through the program `prog`
    (compiler/foldprog.py FoldProgram: `code` int32 [n, 4], `consts`
    int64 [k, 2] of tag and payload):

      vals [T, B] int64, metas [T, B] int32: each term's payload and meta
        word at every row of the batch;
      order [M] int64, offsets [nseg + 1] int64: segment s folds rows
        order[offsets[s]:offsets[s+1]], ascending (segment_layout);
      limits [nseg] int64: a segment stops at its first row at or past its
        limit (a boxed row of its key, which only the interpreter folds);
      seeds [nseg, L] int64, seed_tags [nseg, L] int8: the accumulators.

    CUDA tensors go to the kernel (ops/segfold_cuda.py), which raises if
    it cannot launch; CPU tensors to `seg_fold_plain`."""
    if vals.is_cuda:
        from . import segfold_cuda

        return segfold_cuda.seg_fold(prog, vals, metas, order, offsets,
                                     limits, seeds, seed_tags)
    return seg_fold_plain(prog, vals, metas, order, offsets, limits, seeds,
                          seed_tags)


# ---------------------------------------------------------------------------
# the plain version: the kernel's steps, one segment at a time
# ---------------------------------------------------------------------------

class _Stop(Exception):
    """The row needs the interpreter."""


class _Raise(Exception):
    def __init__(self, cls: int):
        self.cls = cls


def _fits(v):
    """v, if an int result still fits int64; else the row stops."""
    if type(v) is int and not _I64_MIN <= v <= _I64_MAX:
        raise _Stop
    return v


def _cmp_ok(a, b) -> None:
    """An int against a float compares exactly in Python; the kernel
    converts the int, which is exact only up to 2**53 in magnitude."""
    for x, y in ((a, b), (b, a)):
        if type(x) is int and type(y) is float and abs(x) > _TWO53:
            raise _Stop


def _binop(op: int, a, b):
    if op == ADD:
        return _fits(a + b)
    if op == SUB:
        return _fits(a - b)
    if op == MUL:
        return _fits(a * b)
    if op in (DIV, FLOORDIV, MOD):
        if b == 0:
            raise _Raise(ZERODIVISION)
        if op == DIV:
            if type(a) is not float and type(b) is not float and \
                    (abs(a) > _TWO53 or abs(b) > _TWO53):
                raise _Stop
            return a / b
        return _fits(a // b if op == FLOORDIV else a % b)
    _cmp_ok(a, b)
    if op == MIN:
        return b if b < a else a
    if op == MAX:
        return b if b > a else a
    if op == LT:
        return a < b
    if op == LE:
        return a <= b
    if op == GT:
        return a > b
    if op == GE:
        return a >= b
    if op == EQ:
        return a == b
    if op == NE:
        return a != b
    raise ValueError(f"opcode {op}")


def _unop(op: int, a):
    if op == NEG:
        return _fits(-a)
    if op == POS:
        return +a
    if op == NOT:
        return not a
    if op == ABS:
        return _fits(abs(a))
    if op == FLOAT:
        return float(a)
    if op == BOOL:
        return bool(a)
    if op == INT:
        if type(a) is float:
            if math.isnan(a):
                raise _Raise(VALUEERROR)
            if math.isinf(a):
                raise _Raise(OVERFLOWERROR)
        return _fits(int(a))
    raise ValueError(f"opcode {op}")


# ---------------------------------------------------------------------------
# the decode: the lowered program -> operands by source, one path at a time
# ---------------------------------------------------------------------------

_ARITH_BIN = (ADD, SUB, MUL, DIV, FLOORDIV, MOD, MIN, MAX,
              LT, LE, GT, GE, EQ, NE)
_FLOAT_FORM = {ADD: F_ADD, SUB: F_SUB, MUL: F_MUL, DIV: F_DIV}
_NUMERIC = (TAG_BOOL, TAG_INT)


def _result_tag(op: int, ta, tb):
    """The tag of op's result when it is known from the operands' (None:
    known only at run time)."""
    if op in (LT, LE, GT, GE, EQ, NE, NOT, BOOL):
        return TAG_BOOL
    if op in (FLOAT, DIV) or TAG_FLOAT in (ta, tb) and op in (
            ADD, SUB, MUL, FLOORDIV, MOD):
        return TAG_FLOAT
    if op == INT or op in (ADD, SUB, MUL, FLOORDIV, MOD) and \
            ta in _NUMERIC and tb in _NUMERIC:
        return TAG_INT
    if op in (MIN, MAX):
        return ta if ta == tb else None
    if op in (NEG, POS, ABS):
        return TAG_FLOAT if ta == TAG_FLOAT else \
            TAG_INT if ta in _NUMERIC else None
    return None


def _arith(op: int) -> bool:
    return ADD <= op <= F_DIV or op >= F2


@dataclass
class Decoded:
    """A decoded program: `code` int32 [n, 8] of (op, x, a, b, cm, nm,
    leaf, c), `outs` int32 [k, L] (the operand of each leaf at each RET),
    `consts` the lowered program's; `n_regs` registers, `n_terms` row
    terms; `chain` the longest run of arithmetic operations, each reading
    the one before, from an accumulator leaf into the new accumulator (the
    fold's serial chain; an F2 counts two)."""
    code: torch.Tensor
    outs: torch.Tensor
    consts: torch.Tensor
    n_leaves: int
    n_regs: int
    n_terms: int
    chain: int
    _copies: dict = field(default_factory=dict, repr=False)

    def __len__(self) -> int:
        return self.code.shape[0]

    def on(self, device) -> tuple:
        """(code, outs, consts) on `device`, copied there once."""
        key = str(device)
        if key not in self._copies:
            self._copies[key] = tuple(t.to(device).contiguous() for t in (
                self.code, self.outs, self.consts))
        return self._copies[key]


def _i32(v: int) -> int:
    return v - (1 << 32) if v >= 1 << 31 else v


def decode_program(code: torch.Tensor, consts: torch.Tensor,
                   n_leaves: int) -> Decoded:
    """Decode a lowered program (compiler/foldprog.py) for `n_leaves`
    accumulator leaves. Raises NotCompilable for one beyond the kernel's
    limits: more than MAX_TERMS terms or MAX_DECODED_REGS registers, or
    paths longer in all than PROGRAM_BYTES allow."""
    prog = [tuple(q) for q in code.tolist()]
    const_tags = [t for t, _ in consts.tolist()]
    const_vals = [unpack_value(t, p) for t, p in consts.tolist()]
    n = len(prog)
    budget = PROGRAM_BYTES // 32
    identity = tuple((K_LEAF, i, None) for i in range(n_leaves))
    out: list = []        # [op, x, a, b, cm, nm, leaf]; operands as
    rets: list = []       # (kind, index, tag)
    ret_at: dict = {}
    targets: set = set()
    depth: dict = {}      # value -> its chain from a leaf (None: no leaf)
    n_values = 0
    n_terms = 0
    # pending paths: (pc, registers, outs, terms checked, jump to patch)
    todo = [(0, {}, list(identity), {}, None)]
    while todo:
        pc, env, outs, checked, patch = todo.pop()
        if patch is not None:
            out[patch][1] = len(out)
            targets.add(len(out))
        cm = nm = 0           # checks for the next instruction

        def emit(op, x=0, a=0, b=0):
            nonlocal cm, nm
            if len(out) >= budget:
                raise NotCompilable("fold program too long once decoded")
            out.append([op, x, a, b, cm, nm, -1])
            cm = nm = 0

        while True:
            if pc >= n:
                key = tuple(outs)
                if key == identity:
                    emit(RET, -1)
                else:
                    if key not in ret_at:
                        ret_at[key] = len(rets)
                        rets.append(key)
                    emit(RET, ret_at[key])
                break
            op, dst, a, b = prog[pc]
            pc += 1
            if op == TERM:
                n_terms = max(n_terms, a + 1)
                if a >= MAX_TERMS:
                    raise NotCompilable(f"fold of more than {MAX_TERMS} "
                                        f"row terms")
                state = checked.get(a, 0)     # 1 codes, 2 codes and None
                want = 2 if dst >= 0 else 1
                if state < want:
                    if (cm | nm) >= 1 << a:   # checks run lowest first
                        emit(TCHK)
                    cm |= 1 << a if state == 0 else 0
                    nm |= 1 << a if want == 2 else 0
                    checked = {**checked, a: want}
                if dst >= 0:
                    env = {**env, dst: (K_TERM, a, None)}
            elif op == ACC:
                env = {**env, dst: (K_LEAF, a, None)}
            elif op == CONST:
                env = {**env, dst: (K_CONST, a, const_tags[a])}
            elif op == MOV:
                env = {**env, dst: env[a]}
            elif op == OUT:
                outs = outs[:dst] + [env[a]] + outs[dst + 1:]
            elif op == JMP:
                pc = dst
            elif op in (JZ, JNZ):
                c = env[a]
                if c[0] == K_CONST:           # decided here
                    if bool(const_vals[c[1]]) == (op == JNZ):
                        pc = dst
                    continue
                todo.append((dst, env, outs, checked, len(out)))
                emit(op, 0, c)
            elif op == STOP:
                emit(STOP)
                break
            else:
                x = env[a]
                y = env[b] if op in _ARITH_BIN else x
                tag = _result_tag(op, x[2], y[2])
                if tag == TAG_FLOAT and op in _FLOAT_FORM:
                    op = _FLOAT_FORM[op]
                deps = [0 if o[0] == K_LEAF else depth.get(o[1])
                        for o in (x, y) if o[0] in (K_LEAF, K_REG)]
                deps = [d for d in deps if d is not None]
                depth[n_values] = 1 + max(deps) if deps else None
                emit(op, n_values, x, y)
                env = {**env, dst: (K_REG, n_values, tag)}
                n_values += 1
    # Fusions of an instruction with the next one on its path (one that is
    # no jump target; the first is never terminal then):
    #  - two float forms where the second alone reads the first's value:
    #    one F2 (the first raises nothing, so the second's checks may run
    #    before it, if they come after the first's);
    #  - an arithmetic instruction and the RET after it: the instruction
    #    writes the one leaf the table moves, or applies the table.
    for ins in out:
        ins.append(0)                      # the third operand
    uses: dict = {}
    for ins in out:
        for o in list(rets[ins[1]]) if ins[0] == RET and ins[1] >= 0 else \
                ins[2:4] if _arith(ins[0]) else \
                ins[2:3] if ins[0] in (JZ, JNZ) else []:
            if isinstance(o, tuple) and o[0] == K_REG:
                uses[o[1]] = uses.get(o[1], 0) + 1
    p = None
    for i in range(len(out)):
        cur = out[i]
        prev = out[p] if p is not None and i not in targets else None
        if prev is not None and _arith(prev[0]) and prev[6] == -1:
            v = (K_REG, prev[1])
            if cur[0] == RET and cur[1] >= 0 and not cur[4] | cur[5]:
                table = rets[cur[1]]
                moved = [j for j, o in enumerate(table) if o != identity[j]]
                prev[6] = moved[0] if len(moved) == 1 and \
                    table[moved[0]][:2] == v else -2 - cur[1]
                out[i] = None
                continue
            checks = cur[4] | cur[5]
            if prev[0] in _F2_OPS and cur[0] in _F2_OPS and \
                    uses.get(prev[1]) == 1 and v in (cur[2][:2], cur[3][:2]) \
                    and (not checks or prev[4] | prev[5] < checks & -checks):
                left = cur[2][:2] == v
                out[p] = [F2 + _F2_OPS[prev[0]] + 4 * _F2_OPS[cur[0]] +
                          (16 if left else 0), cur[1], prev[2], prev[3],
                          prev[4] | cur[4], prev[5] | cur[5], cur[6],
                          cur[3] if left else cur[2]]
                out[i] = None
                continue
        p = i
    keep = [i for i, ins in enumerate(out) if ins is not None]
    at = {i: j for j, i in enumerate(keep)}
    out = [out[i] for i in keep]
    used = sorted({ins[1] for ins in out if ins[0] == RET and ins[1] >= 0} |
                  {-2 - ins[6] for ins in out if ins[6] <= -2})
    rets = [rets[k] for k in used]
    for ins in out:
        if ins[0] in (JZ, JNZ):
            ins[1] = at[ins[1]]
        elif ins[0] == RET and ins[1] >= 0:
            ins[1] = used.index(ins[1])
        elif ins[6] <= -2:
            ins[6] = -2 - used.index(-2 - ins[6])
    # registers: a value lives from its instruction to its last reader in
    # code order (a topological order: every jump is forward)
    last: dict = {}
    for i, (op, x, a, b, _, _, leaf, c) in enumerate(out):
        ops = list(rets[x]) if op == RET and x >= 0 else \
            [a, b, c] if _arith(op) else [a] if op in (JZ, JNZ) else []
        for o in ops:
            if isinstance(o, tuple) and o[0] == K_REG:
                last[o[1]] = i
        # a fused RET reads its table after the instruction keeps its value
        for o in rets[-2 - leaf] if leaf <= -2 else ():
            if o[0] == K_REG:
                last[o[1]] = i + 0.5
    phys: dict = {}
    free: list = []
    live: list = []       # heap of (last reader, register)
    n_regs = 0
    for i, ins in enumerate(out):
        if not _arith(ins[0]) or ins[6] >= 0:
            continue
        while live and live[0][0] <= i:    # operands are read first
            heapq.heappush(free, heapq.heappop(live)[1])
        r = heapq.heappop(free) if free else n_regs
        n_regs = max(n_regs, r + 1)
        phys[ins[1]] = r
        heapq.heappush(live, (last.get(ins[1], i), r))
    if n_regs > MAX_DECODED_REGS:
        raise NotCompilable("fold program needs too many registers")

    def enc(o) -> int:
        return (o[0] << 16) | (phys[o[1]] if o[0] == K_REG else o[1])

    rows = []
    for op, x, a, b, cm, nm, leaf, c in out:
        if _arith(op):
            x = 0 if leaf >= 0 else phys[x]
            a, b = enc(a), enc(b)
            c = enc(c) if op >= F2 else 0
        elif op in (JZ, JNZ):
            a = enc(a)
        rows.append([op, x, a, b, _i32(cm), _i32(nm), leaf, c])
    chain = max((0 if o[0] == K_LEAF else depth.get(o[1]) or 0
                 for r in rets for o in r if o[0] in (K_LEAF, K_REG)),
                default=0)
    chain = max([chain] + [depth.get(ins[1]) or 0 for ins in out
                           if _arith(ins[0]) and ins[6] != -1])
    size = 32 * len(rows) + 16 * len(const_tags) + 4 * len(rets) * n_leaves
    if size > PROGRAM_BYTES:
        raise NotCompilable("fold program too long once decoded")
    return Decoded(torch.tensor(rows, dtype=torch.int32).reshape(-1, 8),
                   torch.tensor([[enc(o) for o in r] for r in rets],
                                dtype=torch.int32).reshape(-1, n_leaves),
                   consts.reshape(-1, 2).to(torch.int64), n_leaves, n_regs,
                   n_terms, chain)


def decoded(prog, n_leaves: int) -> Decoded:
    """prog's decoded program, decoded once (kept on prog)."""
    d = getattr(prog, "_decoded", None)
    if d is None or d.n_leaves != n_leaves:
        d = decode_program(prog.code, prog.consts, n_leaves)
        prog._decoded = d
    return d


# ---------------------------------------------------------------------------
# the plain version: the kernel's steps, one segment at a time
# ---------------------------------------------------------------------------

def _fbinop(op: int, a, b) -> float:
    """A float form: both operands as floats, as the kernel converts them
    (float(int) rounds to nearest, as CPython's int-float arithmetic)."""
    a, b = float(a), float(b)
    if op == F_ADD:
        return a + b
    if op == F_SUB:
        return a - b
    if op == F_MUL:
        return a * b
    if b == 0.0:
        raise _Raise(ZERODIVISION)
    return a / b


def _check(metas, r: int, cm: int, nm: int) -> None:
    """The checks before an instruction: the lowest failing term of masks
    cm (its code) and nm (a None) decides."""
    bits = (cm | nm) & 0xFFFFFFFF
    while bits:
        t = (bits & -bits).bit_length() - 1
        bits &= bits - 1
        meta = metas[t][r]
        cls = meta & 0xFF
        if cm >> t & 1 and cls:
            if cls >= INTERNAL_CLASS:
                raise _Stop
            raise _Raise(cls)
        if nm >> t & 1 and (meta >> 8) & 3 == TAG_NONE:
            raise _Stop


def _run_row(code, outs, consts, vals, metas, r: int, acc: list) -> list:
    """The decoded program over row r with accumulator acc: the new
    accumulator. Raises _Raise (an exact exception class: the row is an
    exception, the accumulator unchanged) or _Stop."""
    regs: list = [None] * MAX_REGS

    def get(o):
        kind, i = o >> 16, o & 0xFFFF
        if kind == K_REG:
            return regs[i]
        if kind == K_LEAF:
            return acc[i]
        if kind == K_CONST:
            return consts[i]
        return unpack_value((metas[i][r] >> 8) & 3, vals[i][r])

    pc = 0
    while True:
        op, x, a, b, cm, nm, leaf, c = code[pc]
        pc += 1
        if cm or nm:
            _check(metas, r, cm, nm)
        if op == RET:
            return acc if x < 0 else [get(o) for o in outs[x]]
        if op == JZ:
            if not get(a):
                pc = x
        elif op == JNZ:
            if get(a):
                pc = x
        elif op == STOP:
            raise _Stop
        elif _arith(op):
            if op >= F2:
                f, g = (op - F2) & 3, (op - F2) >> 2 & 3
                t = _fbinop(F_ADD + f, get(a), get(b))
                v = _fbinop(F_ADD + g, t, get(c)) if op - F2 & 16 else \
                    _fbinop(F_ADD + g, get(c), t)
            elif op >= F_ADD:
                v = _fbinop(op, get(a), get(b))
            elif op >= NEG:
                v = _unop(op, get(a))
            else:
                v = _binop(op, get(a), get(b))
            if leaf >= 0:
                return acc[:leaf] + [v] + acc[leaf + 1:]
            regs[x] = v
            if leaf <= -2:
                return [get(o) for o in outs[-2 - leaf]]


def seg_fold_plain(prog, vals, metas, order, offsets, limits, seeds,
                   seed_tags) -> SegFoldResult:
    """The kernel's function on CPU tensors, as a Python loop: each
    segment's rows in order, each row through the decoded program on
    Python values, whose arithmetic is IEEE double and unbounded int; the
    int64 and 2**53 rules stop a row where the kernel's would."""
    dev = vals.device
    nseg, nleaf = seeds.shape
    b = vals.shape[1] if vals.dim() == 2 else 0
    dec = decoded(prog, nleaf)
    code = [tuple(q) for q in dec.code.tolist()]
    outs = dec.outs.tolist()
    consts = [unpack_value(t, p) for t, p in dec.consts.tolist()]
    vl, ml = vals.tolist(), metas.tolist()
    od, off, lim = order.tolist(), offsets.tolist(), limits.tolist()
    seed_l, tag_l = seeds.tolist(), seed_tags.tolist()
    acc_out = np.zeros((nseg, nleaf), dtype=np.int64)
    tag_out = np.zeros((nseg, nleaf), dtype=np.int8)
    first = np.full(nseg, -1, dtype=np.int64)
    count = np.zeros(nseg, dtype=np.int64)
    stop = np.full(nseg, -1, dtype=np.int64)
    status = np.zeros(b, dtype=np.int8)
    for s in range(nseg):
        acc = [unpack_value(t, p) for t, p in zip(tag_l[s], seed_l[s])]
        for i in range(off[s], off[s + 1]):
            r = od[i]
            if stop[s] >= 0 or r >= lim[s]:
                if stop[s] < 0:
                    stop[s] = r
                status[r] = ST_HOST
                continue
            try:
                acc = _run_row(code, outs, consts, vl, ml, r, acc)
            except _Raise as e:
                status[r] = ST_EXC + e.cls
                continue
            except _Stop:
                stop[s] = r
                status[r] = ST_HOST
                continue
            status[r] = ST_FOLDED
            if first[s] < 0:
                first[s] = r
            count[s] += 1
        for j, v in enumerate(acc):
            tag_out[s, j], acc_out[s, j] = pack_value(v)
    return SegFoldResult(*(torch.from_numpy(a).to(dev) for a in (
        acc_out, tag_out, first, count, stop, status)))
