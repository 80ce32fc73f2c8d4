"""The aggregates: unique, aggregate and aggregateByKey (counterpart of
`tuplex_tpu/plan/aggregates.py`; reference: logical/AggregateOperator.cc
AGG_UNIQUE/AGG_GENERAL/AGG_BYKEY).

Each is a pipeline breaker: it needs every row of its input before it
emits one, so it ends a stage and runs as an AggregateStage
(exec/aggexec.py). The reference requires `combine` to be associative so
that partitions can fold in parallel; the same contract lets aggregate
UDFs of the form `acc + f(row)`, `min(acc, f(row))` or `max(...)` (or a
tuple of such terms) run as whole-column reductions on the device
(`recognize_fold`). Any other aggregate UDF folds row by row on the
interpreter, with the same result.
"""

from __future__ import annotations

import ast
from typing import Any, Callable, Optional, Sequence

import torch

from ..core import typesys as T
from ..core.row import Row
from ..utils.reflection import get_udf_source
from . import logical as L


class UniqueOperator(L.LogicalOperator):
    """Distinct rows in first-occurrence order (reference: dataset.py:36
    unique)."""

    def __init__(self, parent: L.LogicalOperator):
        super().__init__([parent])

    def is_breaker(self) -> bool:
        return True

    def schema(self) -> T.RowType:
        return self.parent.schema()

    def columns(self):
        return self.parent.columns()

    def sample(self) -> list[Row]:
        seen = set()
        out = []
        for r in self.parent.cached_sample():
            k = tuple(r.values)
            try:
                if k in seen:
                    continue
                seen.add(k)
            except TypeError:
                pass
            out.append(r)
        return out


class AggregateOperator(L.LogicalOperator):
    """One accumulator over the whole dataset (reference: dataset.py:593).
    combine(acc, acc) -> acc must be associative; aggregate(acc, row) ->
    acc folds one row; `initial` seeds the accumulator once."""

    def __init__(self, parent: L.LogicalOperator, combine: Callable,
                 aggregate: Callable, initial: Any):
        super().__init__([parent])
        self.combine_udf = get_udf_source(combine)
        self.aggregate_udf = get_udf_source(aggregate)
        self.initial = initial

    def is_breaker(self) -> bool:
        return True

    def schema(self) -> T.RowType:
        t = T.infer_type(self.initial)
        if isinstance(t, T.TupleType):
            return T.row_of([f"_{i}" for i in range(len(t.elements))],
                            t.elements)
        return T.row_of(["_0"], [t])

    def columns(self):
        return None

    def sample(self) -> list[Row]:
        acc = self.initial
        for r in self.parent.cached_sample():
            try:
                acc = apply_agg(self.aggregate_udf, acc, r)
            except Exception:
                pass
        return [Row.from_value(acc)]


class AggregateByKeyOperator(L.LogicalOperator):
    """One accumulator per distinct key (reference: dataset.py:644
    aggregateByKey). Output rows are the key columns then the accumulator's
    fields, one row per key in the order the keys first folded."""

    def __init__(self, parent: L.LogicalOperator, combine: Callable,
                 aggregate: Callable, initial: Any,
                 key_columns: Sequence[str]):
        super().__init__([parent])
        self.combine_udf = get_udf_source(combine)
        self.aggregate_udf = get_udf_source(aggregate)
        self.initial = initial
        self.key_columns = list(key_columns)

    def is_breaker(self) -> bool:
        return True

    def schema(self) -> T.RowType:
        ps = self.parent.schema()
        key_types = [ps.types[ps.columns.index(c)] for c in self.key_columns]
        t = T.infer_type(self.initial)
        agg_types = list(t.elements) if isinstance(t, T.TupleType) else [t]
        agg_names = [f"_{i}" for i in range(len(agg_types))]
        return T.row_of(self.key_columns + agg_names, key_types + agg_types)

    def columns(self):
        return tuple(self.schema().columns)

    def sample(self) -> list[Row]:
        ps = self.parent.schema()
        kidx = [ps.columns.index(c) for c in self.key_columns]
        groups: dict = {}
        for r in self.parent.cached_sample():
            k = tuple(r.values[i] for i in kidx)
            try:
                groups[k] = apply_agg(self.aggregate_udf,
                                      groups.get(k, self.initial), r)
            except Exception:
                pass
        cols = self.schema().columns
        return [Row(list(k) + list(acc if isinstance(acc, tuple) else (acc,)),
                    cols) for k, acc in groups.items()]


def apply_agg(udf, acc, row: Row):
    """aggregate(acc, row) on the interpreter: a named row goes in whole,
    an unnamed one as its bare value or tuple."""
    return udf.func(acc, row if row.columns else
                    (row.values[0] if len(row.values) == 1
                     else tuple(row.values)))


# ---------------------------------------------------------------------------
# associative folds the device evaluates
# ---------------------------------------------------------------------------

class FoldSpec:
    """aggregate(acc, row) recognized as k independent terms:
    acc'[i] = acc[i] REDUCER_i exprs[i](row), REDUCER in {sum, min, max}.
    `acc_first[i]` says whether the accumulator is min/max's first
    argument: Python keeps the first of two equal arguments, so merging a
    device partial must keep the same order."""

    def __init__(self, reducers: list[str], exprs: list[ast.expr],
                 acc_first: list[bool], row_param: str, globals_: dict,
                 scalar: bool):
        self.reducers = reducers
        self.exprs = exprs
        self.acc_first = acc_first
        self.row_param = row_param
        self.globals = globals_
        self.scalar = scalar

    def combine(self, i: int, acc, partial):
        """Fold a device partial of term i into the running accumulator
        value, as the rows it covers would have folded one by one."""
        red = self.reducers[i]
        if red == "sum":
            return acc + partial
        fn = min if red == "min" else max
        return fn(acc, partial) if self.acc_first[i] else fn(partial, acc)

    def order_risk(self, datas: list, ok):
        """A 0-d bool tensor, computed on the device without waiting: a
        partial over the rows in `ok` could differ from folding them one
        by one. A min/max term meets a NaN or both signed zeros (Python
        keeps one of two unordered or equal-but-distinct arguments by their
        order; zeros of one sign, and ints, tie only with equal bits), or
        an int64 sum could leave int64 (Python's int does not wrap)."""
        risk = torch.zeros((), dtype=torch.bool, device=ok.device)
        n_ok = ok.sum()
        for d, red in zip(datas, self.reducers):
            if not d.is_floating_point():
                if red == "sum":
                    m = torch.where(ok, d, 0)
                    risk = risk | (m == -(1 << 63)).any() | (
                        m.abs().amax().to(torch.float64) * n_ok >= 2.0 ** 62)
            elif red != "sum":
                zero = ok & (d == 0)
                neg = torch.signbit(d)
                risk = risk | (ok & torch.isnan(d)).any() | (
                    (zero & neg).any() & (zero & ~neg).any())
        return risk

    def in_order(self, risk: bool, rows_apart: bool) -> bool:
        """Whether a partition folds every row in row order on the
        interpreter instead of merging a device partial: `risk` is
        `order_risk` on the host, `rows_apart` says some of its rows fold
        on the interpreter anyway (boxed rows, or rows whose expression
        raised), and a min/max term must meet them in their place."""
        return risk or (rows_apart and any(r != "sum" for r in self.reducers))


def recognize_fold(udf) -> Optional[FoldSpec]:
    """Match `lambda acc, row: <update>` where the update is one term or a
    tuple of terms `acc[i] + f(row)`, `min(acc[i], f(row))`, `max(...)` (a
    bare `acc` for a scalar accumulator), with f not reading acc."""
    tree = udf.tree
    if isinstance(tree, ast.Lambda):
        body = tree.body
    elif isinstance(tree, ast.FunctionDef):
        stmts = [s for s in tree.body
                 if not (isinstance(s, ast.Expr)
                         and isinstance(s.value, ast.Constant)
                         and isinstance(s.value.value, str))]  # docstrings
        if len(stmts) != 1 or not isinstance(stmts[0], ast.Return):
            return None
        body = stmts[0].value
    else:
        return None
    params = [a.arg for a in tree.args.args]
    if len(params) != 2 or body is None:
        return None
    acc_p, row_p = params

    def reads_acc(node: ast.expr) -> bool:
        return any(isinstance(n, ast.Name) and n.id == acc_p
                   for n in ast.walk(node))

    def match_term(node: ast.expr, index: Optional[int]):
        """(reducer, expr, acc_first) or None; index None: scalar acc."""

        def is_acc(n: ast.expr) -> bool:
            if index is None:
                return isinstance(n, ast.Name) and n.id == acc_p
            return (isinstance(n, ast.Subscript)
                    and isinstance(n.value, ast.Name)
                    and n.value.id == acc_p
                    and isinstance(n.slice, ast.Constant)
                    and n.slice.value == index)

        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
            for accside, other in ((node.left, node.right),
                                   (node.right, node.left)):
                if is_acc(accside) and not reads_acc(other):
                    return ("sum", other, True)
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id in ("min", "max") and len(node.args) == 2 \
                and not node.keywords \
                and node.func.id not in udf.globals:
            a0, a1 = node.args
            for first, accside, other in ((True, a0, a1), (False, a1, a0)):
                if is_acc(accside) and not reads_acc(other):
                    return (node.func.id, other, first)
        return None

    terms = [match_term(e, i) for i, e in enumerate(body.elts)] \
        if isinstance(body, ast.Tuple) else [match_term(body, None)]
    if not terms or any(t is None for t in terms):
        return None
    return FoldSpec([t[0] for t in terms], [t[1] for t in terms],
                    [t[2] for t in terms], row_p, udf.globals,
                    not isinstance(body, ast.Tuple))


def device_fold_spec(op) -> Optional[FoldSpec]:
    """The recognized fold of an aggregate when its accumulator is numbers
    (one per term) that device partials can merge into, else None: the
    fold then runs on the interpreter."""
    spec = recognize_fold(op.aggregate_udf)
    if spec is None:
        return None
    init = (op.initial,) if spec.scalar else op.initial
    if not isinstance(init, tuple) or len(init) != len(spec.reducers) or \
            not all(isinstance(v, (int, float)) for v in init):
        return None
    return spec
