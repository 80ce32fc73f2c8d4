"""Physical planning: stage splitting + fused stage functions (counterpart
of `tuplex_tpu/plan/physical.py`).

A TransformStage turns into ONE Python function over a staged column batch:
every fused operator contributes torch ops in order (reference:
StageBuilder.cc fuses a stage's operators into one compiled function). The
aggregates and the join break the pipeline: a plan is a chain of
TransformStages, AggregateStages and JoinStages. A CSV source's cell decode is the first stage's first
operator: cells parse to their speculated types on the device, and only
the columns the plan reads are split out of the file.

The same function built with `general=True` is the compiled general-case
tier: the decode runs under the general-case types, for the rows the fast
path flagged (`ResolvePlan` says which tiers a stage uses).

Selective filters may be followed by selection-vector compaction: live rows
move to the front of a smaller batch so later operators touch fewer rows.
The reference package uses `jnp.nonzero(size=...)`; here the gather indices
come from a cumsum and a scatter, which never waits for the device.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Callable, Optional

import numpy as np
import torch

from ..compiler.emitter import EmitCtx, Emitter, Frame
from ..compiler.pypipeline import build_python_pipeline
from ..compiler.stagefn import input_row_cv, result_arrays
from ..compiler.values import (CV, cv_arrays, cv_rebuild, materialize,
                               null_cv, tuple_cv)
from ..core import typesys as T
from ..core.errors import (ExceptionCode, NotCompilable,
                           exception_class_for_code)
from ..ops import strings as S
from ..runtime.columns import user_columns
from ..runtime.torchcfg import F64, I32, I64
from ..utils.lru import LruDict
from . import logical as L


@dataclasses.dataclass(frozen=True)
class ResolvePlan:
    """The resolve tiers of one TransformStage, decided at plan time from
    the analyzer's exception-site inventory (`TransformStage.resolve_plan`,
    counterpart of the reference's ResolvePlan, plan/physical.py:29):

    * `use_general`: the compiled general-case tier can retire rows (the
      stage decodes CSV cells and has a general-case decode).
    * `interpreter_possible`: a device-coded row can reach the per-row
      interpreter (a resolver or ignore runs there, or an internal code
      can survive the general tier). Boxed input rows always interpret.
    * `tier`: none | general | interpreter | general+interpreter |
      exact-exit.
    """

    codes: tuple                 # the possible codes, sorted (ints)
    exact_codes: frozenset       # those that are Python exception classes
    use_general: bool
    interpreter_possible: bool
    tier: str

    def new_buffers(self) -> "ResolveBuffers":
        return ResolveBuffers(self.codes)


class ResolveBuffers:
    """A partition's error rows, (row, code, operator id), bucketed by
    their code; the buckets are the plan's possible codes, and a code the
    inventory missed lands in `other` (every row is still routed)."""

    __slots__ = ("by_code", "other")

    def __init__(self, codes):
        self.by_code: dict[int, list] = {int(c): [] for c in codes}
        self.other: list = []

    def add_many(self, idx, packed) -> None:
        """Bucket rows `idx` by their packed lattice values (class code in
        the low byte, operator id above it: core/errors.pack_device_code)."""
        idx = np.asarray(idx)
        packed = np.asarray(packed)
        codes = packed & 0xFF
        opids = packed >> 8
        known = np.zeros(len(idx), dtype=bool)
        for c, buf in self.by_code.items():
            m = codes == c
            if m.any():
                known |= m
                buf.extend(zip(idx[m].tolist(), codes[m].tolist(),
                               opids[m].tolist()))
        m = ~known
        if m.any():
            self.other.extend(zip(idx[m].tolist(), codes[m].tolist(),
                                  opids[m].tolist()))

    def _rows(self, exact: bool) -> list:
        out = [t for buf in (*self.by_code.values(), self.other)
               for t in buf
               if (exception_class_for_code(t[1]) is not None) == exact]
        out.sort()
        return out

    def internal_rows(self) -> list:
        """(idx, code, op_id) of rows whose code is internal: the general
        tier's candidates."""
        return self._rows(False)

    def exact_rows(self) -> list:
        """(idx, code, op_id) of rows whose code is a Python exception
        class: the exact exit's."""
        return self._rows(True)


class TransformStage:
    """A fused chain of row operators over one input: a source operator,
    the breaker whose stage runs before it, or the last operator of the
    segment before it (`segment_stage`). `input_schema` is given where the
    operators were reordered after they were built (a segment's input)."""

    not_compilable = False   # every row interprets: the planner routed
                             # the segment there (`force_interpret`), or
                             # the emitter rejected a fused UDF at run time
    force_interpret = False  # an interpreter segment (`segment_stage`)
    route_reason = ""        # why the planner routed it there
    limit = -1               # rows the stage emits at most (take); -1 all
    compaction_off = False   # set when a compaction bucket overflowed
    fold_spec = None         # the FoldSpec of a whole-dataset aggregate
                             # whose fold runs in this stage's device pass
    fold_failed = False      # set when the fold is outside the compiled
                             # subset: the stage then returns its rows

    def __init__(self, source: L.LogicalOperator, ops: list,
                 input_schema: Optional[T.RowType] = None):
        self.source = source
        self.ops = ops
        self._input_override = input_schema
        self._relink_schemas()
        self._py_pipelines: dict = {}
        # str-column sets of the general tier whose build the emitter
        # rejected (exec/local.py _general_case_pass)
        self.general_refused: set = set()

    def _relink_schemas(self) -> None:
        self.input_schema = self._input_override or self.source.schema()
        last = self.ops[-1] if self.ops else self.source
        self.output_schema = last.schema()
        self.output_columns = last.columns()

    def python_pipeline(self, input_names: Optional[tuple] = None):
        """The stage's interpreter pipeline, built once per runtime input
        column names (the source tier binds column positions when it is
        built)."""
        key = tuple(input_names) if input_names else None
        pipe = self._py_pipelines.get(key)
        if pipe is None:
            pipe = self._py_pipelines[key] = build_python_pipeline(self.ops,
                                                                   key)
        return pipe

    @property
    def has_resolvers(self) -> bool:
        """Whether a resolve or ignore operator rides this stage. Without
        one, a row whose device code is a Python exception class needs no
        interpreter run: the exact exit records it."""
        return any(isinstance(op, L.RESOLVERS) for op in self.ops)

    def udf_reports(self) -> list:
        """[(op, udf attribute, UDFReport)] for every UDF of the stage
        (compiler/analyzer.py)."""
        from ..compiler.analyzer import op_reports

        return [(op, attr, rep) for op in self.ops
                for attr, rep in op_reports(op)]

    def possible_exception_codes(self) -> list:
        """Every ExceptionCode a row of this stage can carry, from the
        analyzer's exception-site inventory (no sampling): the UDFs'
        sites, the decode's codes, PYTHON_FALLBACK where a UDF never
        compiles, TYPEERROR where a UDF reads an Option column (a None
        row raises there). A fused fold's expressions flag their rows
        apart ('#foldok'), not in the lattice."""
        from .optimizer import udf_read_columns

        EC = ExceptionCode
        codes: set = set()
        for op in self.ops:
            if isinstance(op, L.DecodeOperator):
                codes |= {EC.NULLERROR, EC.BADPARSE_STRING_INPUT,
                          EC.NORMALCASEVIOLATION}
        for op, attr, rep in self.udf_reports():
            if isinstance(op, L.RESOLVERS):
                continue   # resolvers run on the interpreter only
            codes |= rep.exception_codes()
            if rep.must_fallback:
                codes.add(EC.PYTHON_FALLBACK)
            if EC.TYPEERROR in codes:
                continue
            sch = op.parent.schema()
            opt_cols = {c for c, t in zip(sch.columns or (), sch.types)
                        if t.is_optional() or t is T.NULL}
            if opt_cols:
                reads = {op.column} if isinstance(op, L.MapColumnOperator) \
                    else udf_read_columns(op.udf)
                if reads is None or opt_cols & reads:
                    codes.add(EC.TYPEERROR)
        return sorted(codes)

    def speculation_pruned(self) -> bool:
        """Whether branch speculation may have pruned an arm of this
        stage's UDFs. The port does not speculate on branches (both arms
        always run), so never."""
        return False

    def resolve_plan(self) -> ResolvePlan:
        """The stage's resolve tiers (ResolvePlan), memoized."""
        memo = getattr(self, "_resolve_plan_memo", None)
        if memo is None:
            EC = ExceptionCode
            codes = self.possible_exception_codes()
            has_general_decode = any(
                isinstance(op, L.DecodeOperator) and op.general is not None
                for op in self.ops)
            retirable = {EC.NORMALCASEVIOLATION, EC.BADPARSE_STRING_INPUT,
                         EC.NULLERROR}
            use_general = self.speculation_pruned() or (
                has_general_decode and any(c in retirable for c in codes))
            exact_codes = frozenset(
                int(c) for c in codes
                if exception_class_for_code(int(c)) is not None)
            interpreter_possible = self.has_resolvers or any(
                int(c) not in exact_codes for c in codes)
            if not codes:
                tier = "none"
            elif use_general and interpreter_possible:
                tier = "general+interpreter"
            elif use_general:
                tier = "general"
            elif interpreter_possible:
                tier = "interpreter"
            else:
                tier = "exact-exit"
            memo = self._resolve_plan_memo = ResolvePlan(
                codes=tuple(int(c) for c in codes), exact_codes=exact_codes,
                use_general=use_general,
                interpreter_possible=interpreter_possible, tier=tier)
        return memo

    def build_device_fn(self, input_schema: Optional[T.RowType] = None,
                        compaction: bool = False,
                        fold: bool = True, general: bool = False,
                        str_cols: frozenset = frozenset()) -> Callable:
        """The fused fast-path function: staged tensors -> output tensors +
        '#err' + '#keep'. Raises NotCompilable (when called) if a fused UDF
        is outside the compiled subset; the backend then interprets every
        row.

        `compaction=True` inserts selection-vector compaction after
        selective filters. Outputs then gain '#rowidx' ([B'] original
        positions, ascending; sentinel = padded input size for dead slots)
        and '#overflow' (survivors exceeded the sample-estimated bucket: the
        host must discard the results and re-run without compaction).

        With `fold` and a fused `fold_spec`, the outputs are not the rows but
        the fold's partials (`_emit_fused_fold`) beside '#err' and '#keep'.
        A fold expression outside the compiled subset sets `fold_failed`
        and the stage returns its rows instead.

        `general=True` builds the compiled general-case tier (reference:
        StageBuilder.cc:1145 generateResolveCodePath): the cell decode runs
        under the decode's general-case types (`_emit_decode`), the
        columns in `str_cols` (positions in the decode) as Option[str],
        with no compaction and no fused fold. Raises NotCompilable at once
        when the stage has no general-case decode.

        The compile plane (exec/compilequeue.py) captures the function
        once per key and replays it, so what it decides in Python must
        follow from the key (the operators, the flags, the input shapes):
        a decision it makes from stage state enters the key, as
        `fold_failed` does."""
        schema = input_schema if input_schema is not None \
            else self.input_schema
        ops = self.ops
        if general and not any(
                isinstance(op, L.DecodeOperator) and op.general is not None
                for op in ops):
            raise NotCompilable("stage has no general-case decode")
        plan = _compaction_plan(ops) if compaction and not general else {}
        spec = self.fold_spec if fold and not self.fold_failed \
            and not general else None

        def fn(arrays: dict) -> dict:
            rowvalid = arrays["#rowvalid"]
            b = rowvalid.shape[0]
            ctx = EmitCtx(b, rowvalid)
            keep = rowvalid
            row = input_row_cv(arrays, schema)
            rowidx = full_err = overflow = None
            bcur = b
            for op in ops:
                ctx.cur_op = op.id
                if isinstance(op, L.DecodeOperator):
                    row = _emit_decode(ctx, op, row, general, str_cols)
                    continue
                row, keep = _emit_op(ctx, op, row, keep)
                frac = plan.get(op.id)
                if frac is not None and bcur >= _COMPACT_MIN_ROWS:
                    from ..runtime.columns import bucket_size

                    b2 = bucket_size(min(bcur, int(b * frac) + 64))
                    if b2 < bcur:
                        (row, keep, rowidx, full_err,
                         overflow) = _compact_rows(ctx, row, keep, rowidx,
                                                   full_err, overflow, b2, b)
                        bcur = b2
            fin = keep & (ctx.err == 0)
            outs = None
            if spec is not None:
                try:
                    outs = _emit_fused_fold(spec, row, fin, bcur,
                                            ctx.device)
                except NotCompilable:
                    self.fold_failed = True
            if outs is None:
                outs = result_arrays(row, bcur, ctx.device)
            if rowidx is None:
                outs["#err"] = ctx.err
                outs["#keep"] = fin
            else:
                zeros = torch.zeros(b, dtype=torch.bool, device=ctx.device)
                outs["#err"] = _scatter_drop(full_err, rowidx, ctx.err)
                outs["#keep"] = _scatter_drop(zeros, rowidx, fin)
                if "#foldok" in outs:
                    outs["#foldok"] = _scatter_drop(zeros, rowidx,
                                                    outs["#foldok"])
                outs["#rowidx"] = rowidx
                outs["#overflow"] = overflow
            return outs

        return fn


class AggregateStage:
    """A pipeline breaker: one aggregate operator over every row of its
    input (reference: physical/AggregateStage.cc). `source` is set when
    the aggregate reads a source directly."""

    limit = -1

    def __init__(self, op: L.LogicalOperator,
                 source: Optional[L.LogicalOperator] = None):
        self.op = op
        self.source = source


class JoinStage:
    """A pipeline breaker: a join of every row of its input (the probe
    side) with the build side, whose own plan runs first (reference:
    PhysicalPlan.cc:145-178). `source` is set when the join reads a source
    directly."""

    limit = -1

    def __init__(self, op: L.LogicalOperator,
                 source: Optional[L.LogicalOperator] = None):
        self.op = op
        self.source = source


# ---------------------------------------------------------------------------
# aggregate folds on the device
# ---------------------------------------------------------------------------

def eval_fold_terms(spec, row: CV, fin: torch.Tensor, b: int, device):
    """The recognized fold's expressions over a batch of rows, under an
    error context of their own: (values [B] per term, ok [B], risk 0-d).
    `ok` holds for rows in `fin` whose expressions did not raise; the rest
    fold on the interpreter. `risk` is `FoldSpec.order_risk` over the rows
    in `ok`. Raises NotCompilable outside the compiled subset."""
    fctx = EmitCtx(b, fin)
    frame = Frame(Emitter(fctx, spec.globals), {spec.row_param: row})
    datas = []
    for expr in spec.exprs:
        cv = frame._require_numeric(frame.eval(expr), "aggregate expr")
        if cv.data is None:
            raise NotCompilable("aggregate expr has no value")
        d = cv.data
        if d.dtype == torch.bool:
            if spec.reducers[len(datas)] != "sum":
                raise NotCompilable("min/max of bools")  # keeps bool type
            d = d.to(torch.int64)
        datas.append(d)
    ok = fin & (fctx.err == 0)
    return datas, ok, spec.order_risk(datas, ok)


def eval_row_terms(prog, row: CV, fin: torch.Tensor, b: int, device):
    """The row terms of a general fold (compiler/foldprog.py FoldProgram)
    over a batch: (vals [T, B] int64, metas [T, B] int32), each term under
    an error context of its own. A term's meta word holds its error class
    (deferred: ops/segfold.py raises it only where the program reaches the
    term; an internal one where an eager term raised anything) and the
    row's value tag, TAG_NONE where an Option term is None.
    A float's payload is its bits. Raises NotCompilable outside the
    compiled subset, or for a term the program reads that is not a
    number."""
    from ..ops import segfold as SF

    env = {prog.row_param: row}
    vals = torch.zeros((len(prog.terms), b), dtype=I64, device=device)
    metas = torch.zeros((len(prog.terms), b), dtype=torch.int32,
                        device=device)
    for t, term in enumerate(prog.terms):
        tctx = EmitCtx(b, fin)
        cv = Frame(Emitter(tctx, prog.globals), dict(env)).eval(term.expr)
        if term.local is not None:
            env[term.local] = cv
        meta = tctx.err & 0xFF
        if term.eager:
            meta = torch.where(meta != 0, SF.INTERNAL_CLASS, 0).to(
                torch.int32)
        if term.loaded:
            cv = materialize(cv, b, device)
            if cv.data is None or cv.base not in (T.BOOL, T.I64, T.F64):
                raise NotCompilable(f"fold term of type {cv.t}")
            tag = {T.BOOL: SF.TAG_BOOL, T.I64: SF.TAG_INT,
                   T.F64: SF.TAG_FLOAT}[cv.base]
            d = cv.data
            vals[t] = d.view(I64) if d.dtype == F64 else d.to(I64)
            tags = torch.full((b,), tag, dtype=torch.int32, device=device)
            if cv.valid is not None:
                tags = torch.where(cv.valid, tags, SF.TAG_NONE)
            meta = meta | (tags << 8)
        metas[t] = meta
    return vals, metas


def fold_identity(red: str, d: torch.Tensor):
    """The value a padded slot holds in a reduction of d (int64 or
    float64): -0.0 adds nothing to a float, the extremes lose every min
    and max."""
    if red == "sum":
        return -0.0 if d.is_floating_point() else 0
    if d.is_floating_point():
        return float("inf") if red == "min" else float("-inf")
    info = torch.iinfo(d.dtype)
    return info.max if red == "min" else info.min


def _emit_fused_fold(spec, row: CV, fin, bcur: int, device) -> dict:
    """A whole-dataset fold inside the transform stage's pass (counterpart
    of the reference's `_emit_fused_fold`, plan/physical.py:605): the
    partials '#fold{i}' over the rows that reach the aggregate, seeded
    with each reducer's identity, the count of rows they cover
    ('#foldcnt'), the rows whose fold expression raised ('#foldok' false
    where `fin` holds) and '#foldrisk' (FoldSpec.order_risk). Padding and
    compacted-away slots are outside `fin`."""
    from ..ops.fold import tree_reduce

    datas, ok, risk = eval_fold_terms(spec, row, fin, bcur, device)
    outs = {}
    for i, (d, red) in enumerate(zip(datas, spec.reducers)):
        outs[f"#fold{i}"] = tree_reduce(
            torch.where(ok, d, fold_identity(red, d)), red)
    outs["#foldcnt"] = ok.sum()
    outs["#foldrisk"] = risk
    outs["#foldok"] = ok
    return outs


def _emit_op(ctx: EmitCtx, op: L.LogicalOperator, row: CV, keep):
    if isinstance(op, L.SelectColumnsOperator):
        if row.elts is None or row.names is None:
            raise NotCompilable("selectColumns on an unnamed row")
        idx = op.resolve_indices(row.names)
        return tuple_cv([row.elts[i] for i in idx],
                        names=op.schema().columns), keep
    if isinstance(op, L.RenameColumnOperator):
        if row.elts is None or row.names is None:
            raise NotCompilable("renameColumn on an unnamed row")
        return tuple_cv(row.elts, names=op.rename(row.names)), keep
    if isinstance(op, L.RESOLVERS):
        # guards of the operator before: its rows that raised re-run on
        # the interpreter, where they apply
        return row, keep
    em = Emitter(ctx, op.udf.globals)
    if isinstance(op, L.MapOperator):
        res = em.eval_udf(op.udf, [row])
        out_cols = op.columns()
        if res.elts is not None and out_cols and \
                len(out_cols) == len(res.elts):
            res = tuple_cv(res.elts, names=out_cols, valid=res.valid)
        return res, keep
    if isinstance(op, L.FilterOperator):
        tr = Frame(em, {}).truthy(em.eval_udf(op.udf, [row]))
        ctx.active = ctx.active & tr   # errors past a filter never fire
        return row, keep & tr
    if isinstance(op, (L.WithColumnOperator, L.MapColumnOperator)):
        if row.elts is None or row.names is None:
            raise NotCompilable(f"{type(op).__name__} on an unnamed row")
        elts, names = list(row.elts), list(row.names)
        if isinstance(op, L.MapColumnOperator):
            ci = names.index(op.column)
            elts[ci] = em.eval_udf(op.udf, [elts[ci]])
        elif op.column in names:
            elts[names.index(op.column)] = em.eval_udf(op.udf, [row])
        else:
            elts.append(em.eval_udf(op.udf, [row]))
            names.append(op.column)
        return tuple_cv(elts, names=names), keep
    raise NotCompilable(f"operator {type(op).__name__} not fusable")


def _emit_decode(ctx: EmitCtx, op: L.DecodeOperator, row: CV,
                 general: bool = False, str_cols: frozenset = frozenset()):
    """Cell decode on the device (reference: CSVParseRowGenerator.cc's
    generated parse).

    The normal case decodes under the declared types. A null cell in a
    column speculated non-Option raises NULLERROR; a cell that does not
    parse as its column's type raises BADPARSE_STRING_INPUT, and a float
    cell that parse_f64 leaves to CPython NORMALCASEVIOLATION. These rows
    re-run on the general tier, then the interpreter.

    `general` decodes under `op.general` (every column an Option, a
    column sampled all null as Option[str]), and the columns in `str_cols`
    as Option[str]: each cell then gets the value the interpreter's decode
    gives it, or its row raises (BADPARSE_STRING_INPUT where a cell does
    not parse, NORMALCASEVIOLATION where a parser leaves it to CPython)
    and interprets."""
    frame = Frame(Emitter(ctx, {}), {})
    cells = row.elts if row.elts is not None else (row,)
    decl = op.general if general else op.declared
    elts = []
    for ci, (cv, t) in enumerate(zip(cells, decl.types)):
        if general and ci in str_cols:
            t = T.option(T.STR)
        base = t.without_option() if t.is_optional() else t
        sb, sl = cv.sbytes, cv.slen
        is_null = ctx.zeros() if cv.valid is None else ~cv.valid
        for nv in op.null_values:
            is_null = is_null | S.equals(
                sb, sl, *S.broadcast_const(nv, ctx.b, ctx.device))
        if base is T.STR:
            if t.is_optional():
                elts.append(CV(t=t, sbytes=sb, slen=sl, valid=~is_null))
            else:
                frame.raise_where(is_null, ExceptionCode.NULLERROR)
                elts.append(CV(t=T.STR, sbytes=sb, slen=sl))
            continue
        if base is T.NULL:
            # a cell in an all-null speculated column violates the normal
            # case: the interpreter's decode keeps it
            frame.raise_where(~is_null, ExceptionCode.NORMALCASEVIOLATION)
            elts.append(null_cv())
            continue
        if base is T.I64:
            val, bad, route = S.parse_i64(sb, sl)
            if not general:
                # a cell outside int64 violates the i64 column either way
                bad = bad | route
                route = None
        elif base is T.F64:
            # route: a float CPython reads that parse_f64 does not evaluate
            val, bad, route = S.parse_f64(sb, sl)
        else:
            # bool cells need strip, not ported yet
            raise NotCompilable(f"decode to {t}")
        if not t.is_optional():
            frame.raise_where(is_null, ExceptionCode.NULLERROR)
        frame.raise_where(bad & ~is_null, ExceptionCode.BADPARSE_STRING_INPUT)
        if route is not None:
            frame.raise_where(route & ~is_null,
                              ExceptionCode.NORMALCASEVIOLATION)
        elts.append(CV(t=t, data=val, valid=~is_null) if t.is_optional()
                    else CV(t=base, data=val))
    names = user_columns(decl)
    if len(elts) == 1 and names is None:
        return elts[0]
    return tuple_cv(elts, names=names)


def runtime_output_columns(stage: TransformStage):
    """Output column names of the stage's device result (None = unnamed),
    following the names through the stage's operators as _emit_op does."""
    names = user_columns(stage.input_schema)
    for op in stage.ops:
        if isinstance(op, (L.MapOperator, L.SelectColumnsOperator)):
            out_cols = op.columns()
            names = tuple(out_cols) if out_cols else None
        elif isinstance(op, L.WithColumnOperator):
            if names is not None and op.column not in names:
                names = tuple(names) + (op.column,)
        elif isinstance(op, L.DecodeOperator):
            names = user_columns(op.declared)
        elif isinstance(op, L.RenameColumnOperator) and names is not None:
            names = op.rename(names)
        # filter, mapColumn, resolve and ignore keep the names
    return names


# ---------------------------------------------------------------------------
# selection-vector compaction
# ---------------------------------------------------------------------------

_COMPACT_MARGIN = 1.15   # multiplicative headroom over the sample estimate
_COMPACT_Z = 5.0         # + this many binomial standard errors (see pad())
_COMPACT_GATHER = 0.5    # gather cost in per-op-pass units
_COMPACT_MIN_ROWS = 8192  # smaller batches are not worth a gather


def _compaction_plan(ops) -> dict[int, float]:
    """Where to compact: op.id -> estimated live fraction (relative to the
    stage input sample) for the chosen filters. A small exhaustive search
    over filter subsets with a unit-cost-per-op model: each operator costs
    its current batch fraction, each compaction a gather at the
    pre-compaction fraction. Estimates come from the operators' samples."""
    base_op = next((op.parents[0] for op in ops if op.parents), None)
    if base_op is None:
        return {}
    base = len(base_op.cached_sample())
    if base < 32:
        return {}

    def pad(f: float) -> float:
        # upper confidence bound on the live fraction: a Wilson-style
        # smoothed variance so an observed 0 still gets real headroom
        fs = (f * base + _COMPACT_Z ** 2 / 2) / (base + _COMPACT_Z ** 2)
        return min(1.0, f * _COMPACT_MARGIN
                   + _COMPACT_Z * math.sqrt(fs * (1.0 - fs) / base))

    fracs = {k: pad(len(op.cached_sample()) / base)
             for k, op in enumerate(ops) if isinstance(op, L.FilterOperator)}
    # candidates must leave >= 2 compute ops downstream
    cand = [k for k in fracs if len(ops) - k - 1 >= 2][:10]
    if not cand:
        return {}

    def cost(subset) -> float:
        factor, total = 1.0, 0.0
        for k in range(len(ops)):
            total += factor
            if k in subset:
                new = min(factor, fracs[k] * 1.06 + 0.01)
                if new < factor:
                    total += _COMPACT_GATHER * factor
                    factor = new
        return total

    best, best_cost = (), cost(())
    for r in (1, 2, 3):
        for subset in itertools.combinations(cand, r):
            c = cost(set(subset))
            if c < best_cost - 1e-9:
                best, best_cost = subset, c
    return {ops[k].id: fracs[k] for k in best}


def _scatter_drop(dst: torch.Tensor, idx: torch.Tensor,
                  src: torch.Tensor) -> torch.Tensor:
    """dst with dst[idx] = src, where indices >= len(dst) are dropped (the
    reference's `.at[idx].set(..., mode="drop")`)."""
    n = dst.shape[0]
    buf = torch.cat([dst, dst.new_zeros(1)])
    buf[torch.clamp(idx.to(torch.int64), max=n)] = src
    return buf[:n]


def _compact_rows(ctx: EmitCtx, row: CV, keep, rowidx, full_err, overflow,
                  b2: int, full_b: int):
    """Gather live rows (keep & no error) to the front of a [b2] batch.

    Maintains `rowidx` [b2] original input positions (ascending; sentinel
    full_b in dead slots), `full_err` [full_b] error codes of rows that
    left the batch, and `overflow` (live count exceeded b2)."""
    bcur = keep.shape[0]
    dev = ctx.device
    cur_orig = rowidx if rowidx is not None \
        else torch.arange(bcur, dtype=I32, device=dev)
    full_err = ctx.err if full_err is None \
        else _scatter_drop(full_err, cur_orig, ctx.err)
    live = keep & (ctx.err == 0)
    # slot of each live row in the compact batch; rows past b2 (overflow)
    # and dead rows go to a discard slot
    pos = torch.cumsum(live.to(torch.int64), 0) - 1
    count = pos[-1] + 1
    slot = torch.where(live & (pos < b2), pos, b2)
    src = torch.full((b2 + 1,), bcur - 1, dtype=torch.int64, device=dev)
    src[slot] = torch.arange(bcur, dtype=torch.int64, device=dev)
    src = src[:b2]
    ovf = count > b2
    overflow = ovf if overflow is None else (overflow | ovf)
    valid = torch.arange(b2, dtype=torch.int64, device=dev) < count
    new_rowidx = torch.where(valid, cur_orig[src].to(I32), full_b)
    leaves: list = []
    cv_arrays(row, leaves)
    row2 = cv_rebuild(row, iter([a[src] for a in leaves]))
    ctx.b = b2
    ctx.err = torch.zeros(b2, dtype=I32, device=dev)
    ctx.active = valid
    return row2, valid, new_rowidx.to(I32), full_err, overflow


# ---------------------------------------------------------------------------
# planning
# ---------------------------------------------------------------------------

def plan_stages(sink: L.LogicalOperator, options=None) -> list:
    """Walk the DAG sink -> source, cutting it at the breakers (reference:
    PhysicalPlan.cc:60-238 splitIntoAndPlanStages; `_plan_stages_impl`,
    tuplex_tpu/plan/physical.py:972, whose passes run here in its order,
    without branch speculation and graph vetting). The first stage reads
    the source; each later one reads the stage before it. A breaker right
    after the source (or after another breaker) reads its input with no
    transform stage between, except a recognized whole-dataset fold, which
    runs inside the transform stage before it. A cached dataset
    (plan/cacheop.py) is a source; a take sets the last stage's `limit`.

    `options` (core/options.py; None: the defaults) turn the passes on:
    filters pushed through joins, then within each transform stage their
    conjunctions split and the filters pushed ahead
    (`tuplex.optimizer.filterPushdown`, `filterBreakdown`), filter runs
    ordered by their pass rate (`operatorReordering`, off by default).
    The first stage reads only the CSV columns the plan needs. Each
    transform stage is cut at the operators the emitter refuses
    (`segment_stage`)."""
    from . import optimizer as O
    from .aggregates import AggregateOperator, device_fold_spec
    from .joins import JoinOperator

    def on(key: str, default: bool = True) -> bool:
        return default if options is None else \
            options.get_bool(key, default)

    chain: list[L.LogicalOperator] = []
    limit = -1
    node = sink
    while node.parents and not getattr(node, "acts_as_source", False):
        if isinstance(node, L.TakeOperator):
            limit = node.limit
        else:
            chain.append(node)
        node = node.parent
    chain.reverse()
    pushdown = on("tuplex.optimizer.filterPushdown")
    if pushdown:
        chain = O.push_filters_through_joins(chain)
    stages: list = []
    cur: list[L.LogicalOperator] = []
    inp: L.LogicalOperator = node
    for op in chain:
        if not op.is_breaker():
            cur.append(op)
            continue
        # a recognized whole-dataset fold always has a transform stage to
        # run in, an empty one if need be
        spec = device_fold_spec(op) if type(op) is AggregateOperator \
            else None
        if cur or spec is not None:
            stages.append(TransformStage(inp, cur))
            stages[-1].fold_spec = spec
        kind = JoinStage if isinstance(op, JoinOperator) else AggregateStage
        stages.append(kind(op, source=None if stages else inp))
        cur, inp = [], op
    if cur or not stages:
        stages.append(TransformStage(inp, cur))
    stages[-1].limit = limit
    for st in stages:
        if not isinstance(st, TransformStage):
            continue
        if pushdown:
            if on("tuplex.optimizer.filterBreakdown"):
                st.ops = O.split_filter_conjunctions(st.ops)
            st.ops = O.filter_pushdown(st.ops)
        if on("tuplex.optimizer.operatorReordering", False):
            st.ops = O.reorder_filters(st.ops)
        st._relink_schemas()
    if isinstance(stages[0], TransformStage):
        nxt = stages[1] if len(stages) > 1 else None
        _apply_projection(stages[0], O.agg_required_columns(nxt.op)
                          if isinstance(nxt, AggregateStage) else None)
    out: list = []
    for st in stages:
        out.extend(segment_stage(st) if isinstance(st, TransformStage)
                   else [st])
    return out


def consumer_kind(stages: list, si: int):
    """Who takes stage `si`'s output on the device (the reference's
    `consumer_kind`, plan/physical.py:1094): "stage", "join" or "agg", or
    False when the stage is the last or the next one runs on the
    interpreter (an interpreter segment, or a stage whose emitter already
    refused it). exec/local.py `run_plan` passes it to each stage."""
    nxt = stages[si + 1] if si + 1 < len(stages) else None
    if isinstance(nxt, AggregateStage):
        return "agg"
    if isinstance(nxt, JoinStage):
        return "join"
    if isinstance(nxt, TransformStage) and not nxt.not_compilable:
        return "stage"
    return False


# ---------------------------------------------------------------------------
# segmentation at the operators the emitter refuses
# ---------------------------------------------------------------------------

def segment_stage(stage: TransformStage) -> list:
    """Cut a transform stage at the operators the emitter refuses
    (reference: `segment_stage`, tuplex_tpu/plan/physical.py:1660): each
    maximal run of operators that compile stays one fused stage, each run
    of refused ones becomes an interpreter segment (`force_interpret`,
    with the analyzer's `route_reason`). A resolve or ignore rides with
    the run of the operator it guards. The first segment keeps the
    stage's source and input; the last its `limit` and fused fold."""
    if not stage.ops:
        return [stage]
    flags: list = []          # True compiles, False not, None rides along
    schemas_before: list = []
    schema = stage.input_schema
    for op in stage.ops:
        schemas_before.append(schema)
        if isinstance(op, L.RESOLVERS):
            flags.append(None)
            continue
        flags.append(op_compiles(op, schema))
        # a filter keeps its input's schema: one pushed ahead of the
        # operators it does not read has a later parent
        if not isinstance(op, L.FilterOperator):
            schema = op.schema()
    if all(f is not False for f in flags):
        return [stage]
    runs: list = []           # [start index, ops, refused]
    for i, (op, ok) in enumerate(zip(stage.ops, flags)):
        if ok is None and runs:
            runs[-1][1].append(op)
            continue
        bad = ok is False
        if runs and runs[-1][2] == bad:
            runs[-1][1].append(op)
        else:
            runs.append([i, [op], bad])
    from ..compiler.analyzer import op_analysis

    segments: list = []
    for start, ops_run, bad in runs:
        if not segments:
            seg = TransformStage(stage.source, ops_run,
                                 input_schema=stage.input_schema)
        else:
            seg = TransformStage(segments[-1].ops[-1], ops_run,
                                 input_schema=schemas_before[start])
        seg.force_interpret = seg.not_compilable = bad
        if bad:
            reasons = []
            for op in ops_run:
                rep = op_analysis(op)
                f = rep.routing_finding() if rep is not None else None
                if f is not None:
                    reasons.append(f"{rep.name}: {f.reason} ({rep.loc(f)})")
            if reasons:
                seg.route_reason = "plan-time fallback — " + \
                    "; ".join(reasons)
        segments.append(seg)
    segments[-1].limit = stage.limit
    segments[-1].fold_spec = stage.fold_spec
    return segments


_PROBE_ROWS = 8
_probe_memo: LruDict = LruDict(4096)


def op_compiles(op: L.LogicalOperator, input_schema: T.RowType) -> bool:
    """Whether the emitter compiles one operator over rows of
    `input_schema` (reference: `op_compiles`, plan/physical.py:1189). An
    operator whose UDF has a fallback finding is refused without a probe
    (counted in the analyzer's `plan_fallback_ops`); one no sample row
    reaches is left to the emitter at run time; another is probed:
    its stage function is built and run over a batch of 8 of its parent's
    sample rows (placeholders where they do not conform) on the CPU,
    never on the card or through the compile plane. Cached per operator
    content (the compile plane's digest) and input schema."""
    from ..compiler import analyzer as AZ

    rep = AZ.op_analysis(op)
    if rep is not None and rep.must_fallback:
        AZ.STATS["plan_fallback_ops"] += 1
        return False
    if not op.parent.cached_sample():
        # no sample row reached the operator: its input schema is a guess
        # (pyobject), and the emitter decides at run time on the
        # partitions' own schema
        return True
    probe = TransformStage(op.parent, [op], input_schema=input_schema)
    from ..exec.compilequeue import _stage_digest

    digest = _stage_digest(probe)     # "identity:..." where not keyable
    key = (digest, input_schema.name)
    if key not in _probe_memo:
        _probe_memo[key] = _probe(probe, op, input_schema)
    return _probe_memo[key]


def _probe(probe: TransformStage, op: L.LogicalOperator,
           schema: T.RowType) -> bool:
    from ..exec.compilequeue import _read_counts, _set_counts
    from ..runtime import columns as C

    try:
        rows = op.parent.cached_sample()[:_PROBE_ROWS]
    except Exception:
        rows = []
    one = len(schema.types) == 1
    values = [r.values[0] if one and len(r.values) == 1 else tuple(r.values)
              for r in rows] or [None] * _PROBE_ROWS
    counts = _read_counts()   # the probe is no launch of the job's
    try:
        part = C.build_partition(values, schema)
        arrays = C.stage_partition(part, torch.device("cpu")).arrays
        probe.build_device_fn(schema)(arrays)
        return True
    except Exception:
        # NotCompilable, or any other failure to build: the interpreter
        # is always right
        return False
    finally:
        _set_counts(counts)


def _apply_projection(stage: TransformStage, output_required=None) -> None:
    """Read only the CSV columns the stage needs (counterpart of the
    reference's `_apply_projection`, plan/physical.py:1116): the source
    and its cell decode are replaced by copies over those columns, and the
    stage's operators are relinked to them. Operator ids stay, so
    exception records name the same operators."""
    import copy

    from ..io.csvsource import CSVSourceOperator
    from .optimizer import required_source_columns

    src = stage.source
    if not isinstance(src, CSVSourceOperator) or not stage.ops or \
            not isinstance(stage.ops[0], L.DecodeOperator):
        return
    cols = tuple(src.schema().columns)
    req = required_source_columns(cols, stage.ops, output_required)
    if req is None or len(req) >= len(cols):
        return
    keep = [cols.index(c) for c in req]
    new_src = src.project(keep)
    dec = stage.ops[0]
    general = None if dec.general is None else T.row_of(
        req, [dec.general.types[i] for i in keep])
    prev = L.DecodeOperator(new_src, T.row_of(
        req, [dec.declared.types[i] for i in keep]), dec.null_values,
        general=general)
    prev.id = dec.id
    new_ops = [prev]
    for op in stage.ops[1:]:
        op = copy.copy(op)
        if isinstance(op, L.SelectColumnsOperator):
            # positions shift when columns are dropped: select by name
            names = op.parent.schema().columns
            op.selected = [names[c] if isinstance(c, int) else c
                           for c in op.selected]
        op.parents = [prev]
        op.__dict__.pop("_sample_memo", None)
        if hasattr(op, "_schema_cache"):
            op._schema_cache = None
        new_ops.append(op)
        prev = op
    stage.source, stage.ops = new_src, new_ops
    stage._relink_schemas()
