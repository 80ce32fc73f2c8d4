"""Per-stage Python fallback pipeline (counterpart of
`tuplex_tpu/compiler/pypipeline.py`, its closure tier).

The interpreter path runs rows the compiled path could not finish through
ONE function built per stage (reference: PythonPipelineBuilder.cc, driven
per row by ResolveTask). Each operator becomes a closure; the chain runs in
a loop, and the resolve and ignore operators guard the operator before
them. The reference package adds a source-specialized tier on top of
this for speed; this package keeps the closure tier only.

Exceptions return as plain tuples (op_id, exc_name, row_value).
"""

from __future__ import annotations

import functools
import itertools
from typing import Any, Callable

from ..core import typesys as T
from ..core.errors import TuplexException
from ..core.row import Row
from ..plan import logical as L


def _make_cell_decoder(t: T.Type, null_values) -> Callable[[Any], Any]:
    """One column's general-case decoder (L.decode_cell_python, with the
    type dispatch done once)."""
    nulls = frozenset(null_values)
    base = t.without_option() if t.is_optional() else t
    if base in (T.I64, T.F64, T.BOOL):
        return functools.partial(L.decode_cell_python, t=t,
                                 null_values=nulls)

    def dec(cell):
        return None if isinstance(cell, str) and cell in nulls else cell

    return dec


def _build_op(op: L.LogicalOperator):
    """(apply_fn, inject_fn) for one operator. apply_fn(row) -> row' |
    None (None = filtered out) runs the operator; inject_fn(v, row) wraps a
    resolver's result v as the operator wraps its own output."""
    if isinstance(op, L.DecodeOperator):
        from ..runtime.columns import user_columns

        decs = [_make_cell_decoder(t, op.null_values)
                for t in op.declared.types]
        out_cols = user_columns(op.declared)

        def apply(row):
            return Row([d(v) for d, v in zip(decs, row.values)], out_cols)

        return apply, None
    if isinstance(op, L.SelectColumnsOperator):
        out_cols = op.schema().columns
        idx_by_cols: dict = {}

        def apply(row):
            idx = idx_by_cols.get(row.columns)
            if idx is None:
                idx = idx_by_cols[row.columns] = op.resolve_indices(
                    row.columns or ())
            return Row([row.values[i] for i in idx], out_cols)

        return apply, None
    if isinstance(op, L.RenameColumnOperator):
        def apply(row):
            return Row(row.values, op.rename(row.columns or ()))

        return apply, None
    if isinstance(op, L.MapColumnOperator):
        f = op.udf.func
        col = op.column

        def inject(v, row):
            vals = list(row.values)
            vals[row.columns.index(col)] = v
            return Row(vals, row.columns)

        def apply(row):
            return inject(f(row.values[row.columns.index(col)]), row)

        return apply, inject
    call = functools.partial(L.apply_udf_python, op.udf)
    if isinstance(op, L.WithColumnOperator):
        col = op.column

        def inject(v, row):
            cols, vals = list(row.columns), list(row.values)
            if col in cols:
                vals[cols.index(col)] = v
            else:
                cols.append(col)
                vals.append(v)
            return Row(vals, cols)
    elif isinstance(op, L.MapOperator):
        cols = op.columns()

        def inject(v, row):
            if isinstance(v, dict):
                return Row(list(v.values()), list(v.keys()))
            return Row.from_value(v, cols)
    elif isinstance(op, L.FilterOperator):
        def inject(v, row):
            return row if v else None
    else:
        raise TuplexException(f"interpreter: unsupported op {op!r}")

    def apply(row):
        return inject(call(row), row)

    return apply, inject


def build_python_pipeline(ops: list) -> Callable[[Row], tuple]:
    """pipeline(row) -> ("ok", Row) | ("drop", None) | ("ignored", None)
    | ("exc", (op_id, exc_name, row_value)).

    The resolve and ignore operators right after an operator guard it
    (reference: ResolveTask): when it raises, the first guard whose class
    matches either drops the row ("ignored") or puts its resolver's result
    in place of the operator's; a resolver that raises passes the row to
    the next guard, and a row no guard takes is an exception of the
    operator."""
    steps = []
    for i, op in enumerate(ops):
        if isinstance(op, L.RESOLVERS):
            continue
        guards = []
        for r in itertools.takewhile(lambda o: isinstance(o, L.RESOLVERS),
                                     ops[i + 1:]):
            guards.append((r.exc_class, None if isinstance(
                r, L.IgnoreOperator) else functools.partial(
                    L.apply_udf_python, r.udf)))
        apply_fn, inject_fn = _build_op(op)
        steps.append((apply_fn, inject_fn, tuple(guards), op.id))

    def pipeline(row: Row) -> tuple:
        for apply_fn, inject_fn, guards, op_id in steps:
            try:
                row2 = apply_fn(row)
            except Exception as e:
                row2 = _resolve(e, guards, inject_fn, row)
                if row2 is _IGNORED:
                    return ("ignored", None)
                if row2 is _UNRESOLVED:
                    return ("exc", (op_id, type(e).__name__, row.unwrap()))
            if row2 is None:
                return ("drop", None)
            row = row2
        return ("ok", row)

    return pipeline


_IGNORED = object()
_UNRESOLVED = object()


def _resolve(e: Exception, guards, inject_fn, row: Row):
    for exc_class, resolver in guards:
        if not isinstance(e, exc_class):
            continue
        if resolver is None:
            return _IGNORED
        try:
            return inject_fn(resolver(row), row)
        except Exception:
            continue   # the resolver raised: the next guard may take it
    return _UNRESOLVED
