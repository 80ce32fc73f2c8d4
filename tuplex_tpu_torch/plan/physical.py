"""Physical planning: stage splitting + fused stage functions (counterpart
of `tuplex_tpu/plan/physical.py`).

A TransformStage turns into ONE Python function over a staged column batch:
every fused operator contributes torch ops in order (reference:
StageBuilder.cc fuses a stage's operators into one compiled function). The
aggregates break the pipeline: a plan is a chain of TransformStages and
AggregateStages. A CSV source's cell decode is the first stage's first
operator: cells parse to their speculated types on the device, and only
the columns the plan reads are split out of the file.

Selective filters may be followed by selection-vector compaction: live rows
move to the front of a smaller batch so later operators touch fewer rows.
The reference package uses `jnp.nonzero(size=...)`; here the gather indices
come from a cumsum and a scatter, which never waits for the device.
"""

from __future__ import annotations

import itertools
import math
from typing import Callable, Optional

import torch

from ..compiler.emitter import EmitCtx, Emitter, Frame
from ..compiler.pypipeline import build_python_pipeline
from ..compiler.stagefn import input_row_cv, result_arrays
from ..compiler.values import CV, cv_arrays, cv_rebuild, null_cv, tuple_cv
from ..core import typesys as T
from ..core.errors import ExceptionCode, NotCompilable
from ..ops import strings as S
from ..runtime.columns import user_columns
from ..runtime.torchcfg import I32
from . import logical as L


class TransformStage:
    """A fused chain of row operators over one input: a source operator,
    or the breaker whose stage runs before it."""

    not_compilable = False   # set by the backend when the emitter rejects
                             # a fused UDF: every row then interprets
    compaction_off = False   # set when a compaction bucket overflowed
    fold_spec = None         # the FoldSpec of a whole-dataset aggregate
                             # whose fold runs in this stage's device pass
    fold_failed = False      # set when the fold is outside the compiled
                             # subset: the stage then returns its rows

    def __init__(self, source: L.LogicalOperator, ops: list):
        self.source = source
        self.ops = ops
        self._relink_schemas()
        self._py_pipeline = None

    def _relink_schemas(self) -> None:
        self.input_schema = self.source.schema()
        last = self.ops[-1] if self.ops else self.source
        self.output_schema = last.schema()
        self.output_columns = last.columns()

    def python_pipeline(self):
        """The stage's interpreter pipeline, built once."""
        if self._py_pipeline is None:
            self._py_pipeline = build_python_pipeline(self.ops)
        return self._py_pipeline

    def build_device_fn(self, input_schema: Optional[T.RowType] = None,
                        compaction: bool = False,
                        fold: bool = True) -> Callable:
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
        and the stage returns its rows instead."""
        schema = input_schema if input_schema is not None \
            else self.input_schema
        ops = self.ops
        plan = _compaction_plan(ops) if compaction else {}
        spec = self.fold_spec if fold and not self.fold_failed else None

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
    if isinstance(op, L.DecodeOperator):
        return _emit_decode(ctx, op, row), keep
    if isinstance(op, L.SelectColumnsOperator):
        if row.elts is None or row.names is None:
            raise NotCompilable("selectColumns on an unnamed row")
        idx = op.resolve_indices(row.names)
        return tuple_cv([row.elts[i] for i in idx],
                        names=op.schema().columns), keep
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


def _emit_decode(ctx: EmitCtx, op: L.DecodeOperator, row: CV) -> CV:
    """Normal-case cell decode on the device (reference:
    CSVParseRowGenerator.cc's generated parse). A null cell in a column
    speculated non-Option raises NULLERROR; a cell that does not parse as
    its column's type raises BADPARSE_STRING_INPUT, and a float cell that
    parse_f64 leaves to CPython NORMALCASEVIOLATION. These rows re-run on
    the interpreter, whose decode keeps the raw string where the parse
    fails."""
    frame = Frame(Emitter(ctx, {}), {})
    cells = row.elts if row.elts is not None else (row,)
    elts = []
    for cv, t in zip(cells, op.declared.types):
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
    names = user_columns(op.declared)
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
        # filter and mapColumn keep the names
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

def plan_stages(sink: L.LogicalOperator) -> list:
    """Walk the DAG sink -> source, cutting it at the breakers (reference:
    PhysicalPlan.cc:60-238 splitIntoAndPlanStages). The first stage reads
    the source; each later one reads the stage before it. A breaker right
    after the source (or after another breaker) reads its input with no
    transform stage between, except a recognized whole-dataset fold, which
    runs inside the transform stage before it. The first stage reads only
    the CSV columns the plan needs."""
    chain: list[L.LogicalOperator] = []
    node = sink
    while node.parents:
        chain.append(node)
        node = node.parent
    chain.reverse()
    stages: list = []
    cur: list[L.LogicalOperator] = []
    inp: L.LogicalOperator = node
    from .aggregates import AggregateOperator, device_fold_spec

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
        stages.append(AggregateStage(op, source=None if stages else inp))
        cur, inp = [], op
    if cur or not stages:
        stages.append(TransformStage(inp, cur))
    if isinstance(stages[0], TransformStage):
        from .optimizer import agg_required_columns

        nxt = stages[1] if len(stages) > 1 else None
        _apply_projection(stages[0], agg_required_columns(nxt.op)
                          if isinstance(nxt, AggregateStage) else None)
    return stages


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
    prev = L.DecodeOperator(new_src, T.row_of(
        req, [dec.declared.types[i] for i in keep]), dec.null_values)
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
