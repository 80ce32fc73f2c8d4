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

Values are dynamically typed as in Python: every register, term and
accumulator leaf carries a tag (bool, int or float) beside a 64-bit
payload (an int64, or a float64's bits), and each instruction applies
Python's rules for the tags it meets. What a row needs beyond them stops
its segment there, and the host folds that row and the segment's later
rows on the interpreter (int64 overflow, an int/int true division or an
int-float comparison with an int beyond 2**53, a None term, a term's
internal error code, a row at or past the segment's `limit`).

The ABI below (opcodes, tags, row statuses, the term meta word) is shared
with csrc/seg_fold.cu.
"""

from __future__ import annotations

import math
import struct

import numpy as np
import torch

# -- opcodes: (op, dst, a, b) int32 quadruples -------------------------------
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

MAX_REGS = 64    # registers a program may use (the kernel's local array)
MAX_LEAVES = 16  # accumulator leaves
MAX_CODE = 2048  # instructions and constants: with MAX_CONSTS they fit the
MAX_CONSTS = 512  # kernel's 48 KB of shared memory

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


def _run_row(code, consts, vals, metas, r: int, acc: list) -> list:
    """The program over row r with accumulator acc: the new accumulator.
    Raises _Raise (an exact exception class: the row is an exception,
    the accumulator unchanged) or _Stop."""
    regs: list = [None] * MAX_REGS
    res = list(acc)
    pc, n = 0, len(code)
    while pc < n:
        op, dst, a, b = code[pc]
        pc += 1
        if op == TERM:
            meta = metas[a][r]
            cls = meta & 0xFF
            if cls:
                if cls >= INTERNAL_CLASS:
                    raise _Stop
                raise _Raise(cls)
            if dst >= 0:
                tag = (meta >> 8) & 3
                if tag == TAG_NONE:
                    raise _Stop
                regs[dst] = unpack_value(tag, vals[a][r])
        elif op == ACC:
            regs[dst] = acc[a]
        elif op == CONST:
            regs[dst] = consts[a]
        elif op == MOV:
            regs[dst] = regs[a]
        elif op == OUT:
            res[dst] = regs[a]
        elif op == JMP:
            pc = dst
        elif op == JZ:
            if not regs[a]:
                pc = dst
        elif op == JNZ:
            if regs[a]:
                pc = dst
        elif op == STOP:
            raise _Stop
        elif op >= NEG:
            regs[dst] = _unop(op, regs[a])
        else:
            regs[dst] = _binop(op, regs[a], regs[b])
    return res


def seg_fold_plain(prog, vals, metas, order, offsets, limits, seeds,
                   seed_tags) -> SegFoldResult:
    """The kernel's function on CPU tensors, as a Python loop: each
    segment's rows in order, each row through the program on Python
    values, whose arithmetic is IEEE double and unbounded int; the int64
    and 2**53 rules stop a row where the kernel's would."""
    dev = vals.device
    nseg, nleaf = seeds.shape
    b = vals.shape[1] if vals.dim() == 2 else 0
    code = [tuple(q) for q in prog.code.tolist()]
    consts = [unpack_value(t, p) for t, p in prog.consts.tolist()]
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
                acc = _run_row(code, consts, vl, ml, r, acc)
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
