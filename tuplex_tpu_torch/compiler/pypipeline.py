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
from typing import Callable

from ..core.errors import TuplexException
from ..core.row import Row
from ..plan import logical as L


def _build_op(op: L.LogicalOperator):
    """apply_fn(row) -> row' | None (None = filtered out) for one
    operator."""
    call = functools.partial(L.apply_udf_python, op.udf)
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
