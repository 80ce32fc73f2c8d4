"""Per-stage Python fallback pipeline (counterpart of
`tuplex_tpu/compiler/pypipeline.py`, its closure tier).

The interpreter path runs rows the compiled path could not finish through
ONE function built per stage (reference: PythonPipelineBuilder.cc, driven
per row by ResolveTask). Each operator becomes a closure; the chain runs in
a loop. The reference package adds a source-specialized tier on top of
this for speed; this package keeps the closure tier only.

Exceptions return as plain tuples (op_id, exc_name, row_value).
"""

from __future__ import annotations

import functools
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
    """apply_fn(row) -> row' | None (None = filtered out) for one
    operator."""
    if isinstance(op, L.DecodeOperator):
        from ..runtime.columns import user_columns

        decs = [_make_cell_decoder(t, op.null_values)
                for t in op.declared.types]
        out_cols = user_columns(op.declared)

        def apply(row):
            return Row([d(v) for d, v in zip(decs, row.values)], out_cols)

        return apply
    if isinstance(op, L.SelectColumnsOperator):
        out_cols = op.schema().columns
        idx_by_cols: dict = {}

        def apply(row):
            idx = idx_by_cols.get(row.columns)
            if idx is None:
                idx = idx_by_cols[row.columns] = op.resolve_indices(
                    row.columns or ())
            return Row([row.values[i] for i in idx], out_cols)

        return apply
    if isinstance(op, L.MapColumnOperator):
        f = op.udf.func
        col = op.column

        def apply(row):
            vals = list(row.values)
            ci = row.columns.index(col)
            vals[ci] = f(vals[ci])
            return Row(vals, row.columns)

        return apply
    call = functools.partial(L.apply_udf_python, op.udf)
    if isinstance(op, L.WithColumnOperator):
        col = op.column

        def apply(row):
            v = call(row)
            cols, vals = list(row.columns), list(row.values)
            if col in cols:
                vals[cols.index(col)] = v
            else:
                cols.append(col)
                vals.append(v)
            return Row(vals, cols)

        return apply
    if isinstance(op, L.MapOperator):
        cols = op.columns()

        def apply(row):
            v = call(row)
            if isinstance(v, dict):
                return Row(list(v.values()), list(v.keys()))
            return Row.from_value(v, cols)

        return apply
    if isinstance(op, L.FilterOperator):
        def apply(row):
            return row if call(row) else None

        return apply
    raise TuplexException(f"interpreter: unsupported op {op!r}")


def build_python_pipeline(ops: list) -> Callable[[Row], tuple]:
    """pipeline(row) -> ("ok", Row) | ("drop", None)
    | ("exc", (op_id, exc_name, row_value))."""
    steps = [(_build_op(op), op.id) for op in ops]

    def pipeline(row: Row) -> tuple:
        for apply_fn, op_id in steps:
            try:
                row2 = apply_fn(row)
            except Exception as e:
                return ("exc", (op_id, type(e).__name__, row.unwrap()))
            if row2 is None:
                return ("drop", None)
            row = row2
        return ("ok", row)

    return pipeline
