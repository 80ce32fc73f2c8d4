"""Physical planning: stage splitting + fused stage functions (counterpart
of `tuplex_tpu/plan/physical.py`).

A TransformStage turns into ONE Python function over a staged column batch:
every fused operator contributes torch ops in order (reference:
StageBuilder.cc fuses a stage's operators into one compiled function).
None of this package's operators breaks a pipeline, so a plan is a single
stage over its source. A CSV source's cell decode is the stage's first
operator: cells parse to their speculated types on the device.

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
    """A fused chain of row operators over one input source."""

    not_compilable = False   # set by the backend when the emitter rejects
                             # a fused UDF: every row then interprets
    compaction_off = False   # set when a compaction bucket overflowed

    def __init__(self, source: L.LogicalOperator, ops: list):
        self.source = source
        self.ops = ops
        self.input_schema = source.schema()
        last = ops[-1] if ops else source
        self.output_schema = last.schema()
        self.output_columns = last.columns()
        self._py_pipeline = None

    def python_pipeline(self):
        """The stage's interpreter pipeline, built once."""
        if self._py_pipeline is None:
            self._py_pipeline = build_python_pipeline(self.ops)
        return self._py_pipeline

    def build_device_fn(self, input_schema: Optional[T.RowType] = None,
                        compaction: bool = False) -> Callable:
        """The fused fast-path function: staged tensors -> output tensors +
        '#err' + '#keep'. Raises NotCompilable (when called) if a fused UDF
        is outside the compiled subset; the backend then interprets every
        row.

        `compaction=True` inserts selection-vector compaction after
        selective filters. Outputs then gain '#rowidx' ([B'] original
        positions, ascending; sentinel = padded input size for dead slots)
        and '#overflow' (survivors exceeded the sample-estimated bucket: the
        host must discard the results and re-run without compaction)."""
        schema = input_schema if input_schema is not None \
            else self.input_schema
        ops = self.ops
        plan = _compaction_plan(ops) if compaction else {}

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
            outs = result_arrays(row, bcur, ctx.device)
            fin = keep & (ctx.err == 0)
            if rowidx is None:
                outs["#err"] = ctx.err
                outs["#keep"] = fin
            else:
                outs["#err"] = _scatter_drop(full_err, rowidx, ctx.err)
                outs["#keep"] = _scatter_drop(
                    torch.zeros(b, dtype=torch.bool, device=ctx.device),
                    rowidx, fin)
                outs["#rowidx"] = rowidx
                outs["#overflow"] = overflow
            return outs

        return fn


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
    its column's type raises BADPARSE_STRING_INPUT. Both rows re-run on the
    interpreter, whose decode keeps the raw string."""
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
        if base is not T.I64:
            # float and bool cells need parse_f64 / strip, not ported yet
            raise NotCompilable(f"decode to {t}")
        val, bad, route = S.parse_i64(sb, sl)
        # a cell outside int64 violates the i64 column either way
        bad = bad | route
        if t.is_optional():
            frame.raise_where(bad & ~is_null,
                              ExceptionCode.BADPARSE_STRING_INPUT)
            elts.append(CV(t=t, data=val, valid=~is_null))
        else:
            frame.raise_where(is_null, ExceptionCode.NULLERROR)
            frame.raise_where(bad & ~is_null,
                              ExceptionCode.BADPARSE_STRING_INPUT)
            elts.append(CV(t=T.I64, data=val))
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

def plan_stages(sink: L.LogicalOperator) -> list[TransformStage]:
    """Walk the DAG sink -> source (reference: PhysicalPlan.cc:60-238).
    No operator of this package breaks a pipeline, so the plan is one
    stage."""
    chain: list[L.LogicalOperator] = []
    node = sink
    while node.parents:
        chain.append(node)
        node = node.parent
    chain.reverse()
    return [TransformStage(node, chain)]
