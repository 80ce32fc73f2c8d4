"""Projection into the CSV source (counterpart of the projection half of
`tuplex_tpu/plan/optimizer.py`; reference: LogicalPlan.cc projection
pushdown, the csv.selectionPushdown option).

Which columns a UDF reads is read off its AST: constant-string subscripts
of its row parameter (`x['col']`). A row that escapes in any other way
(passed whole, iterated, a second parameter) reads every column. The
columns nothing reads are never split out of the file, decoded or staged
to the card.
"""

from __future__ import annotations

import ast
from typing import Optional

from . import logical as L

ALL = None  # the whole row is read


def udf_read_columns(udf) -> Optional[set[str]]:
    """Column names a one-parameter UDF reads as x['col'], or ALL."""
    if len(udf.params) != 1 or udf.source == "":
        return ALL
    p = udf.params[0]
    reads = _param_subscript_reads(udf.tree, p)
    if reads is ALL or _param_leaks(udf.tree, p):
        return ALL
    return reads


def _param_subscript_reads(tree: ast.AST, p: str):
    """The constant-string keys of subscripts of `p`, or ALL when one key
    is anything else."""
    reads: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Subscript) and \
                isinstance(node.value, ast.Name) and node.value.id == p:
            if isinstance(node.slice, ast.Constant) and \
                    isinstance(node.slice.value, str):
                reads.add(node.slice.value)
            else:
                return ALL
    return reads


def _all_params(node) -> tuple:
    a = node.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    names += [x.arg for x in (a.vararg, a.kwarg) if x is not None]
    return tuple(names)


def _param_leaks(tree: ast.AST, p: str) -> bool:
    """Whether `p` is used other than as p['const']. A nested lambda or
    def that rebinds `p` counts as a leak: its subscripts are not row
    reads, and the walk above cannot tell them apart."""

    class V(ast.NodeVisitor):
        leak = False

        def visit_Subscript(self, node: ast.Subscript):
            if isinstance(node.value, ast.Name) and node.value.id == p and \
                    isinstance(node.slice, ast.Constant) and \
                    isinstance(node.slice.value, str):
                return
            self.generic_visit(node)

        def visit_Name(self, node: ast.Name):
            if node.id == p:
                self.leak = True

        def _scope(self, node):
            if node is not tree and p in _all_params(node):
                self.leak = True
                return
            self.generic_visit(node)

        visit_Lambda = visit_FunctionDef = visit_AsyncFunctionDef = _scope

    v = V()
    v.visit(tree)
    return v.leak


def op_reads(op: L.LogicalOperator, current_columns) -> Optional[set[str]]:
    """Columns (by their current names) one operator reads."""
    if isinstance(op, L.MapColumnOperator):
        return {op.column}
    if isinstance(op, (L.MapOperator, L.FilterOperator,
                       L.WithColumnOperator)):
        return udf_read_columns(op.udf)
    if isinstance(op, L.SelectColumnsOperator):
        out = set()
        for c in op.selected:
            if isinstance(c, int):
                if current_columns is None or c >= len(current_columns):
                    return ALL
                out.add(current_columns[c])
            else:
                out.add(c)
        return out
    if isinstance(op, L.DecodeOperator):
        return set()
    return ALL


def agg_required_columns(agg_op) -> Optional[set[str]]:
    """The columns of its input an aggregate reads: the key columns and
    the row parameter's subscripts in the aggregate UDF (the `x` of
    `lambda a, x: ...`). None: the whole row (unique, or a UDF whose row
    escapes)."""
    from .aggregates import AggregateByKeyOperator, AggregateOperator

    if not isinstance(agg_op, (AggregateOperator, AggregateByKeyOperator)):
        return None
    udf = agg_op.aggregate_udf
    if udf.source == "" or len(udf.params) != 2:
        return None
    p = udf.params[1]
    reads = _param_subscript_reads(udf.tree, p)
    if reads is ALL or _param_leaks(udf.tree, p):
        return None
    return reads | set(getattr(agg_op, "key_columns", ()))


def required_source_columns(source_columns: tuple[str, ...],
                            ops: list[L.LogicalOperator],
                            output_required: Optional[set] = None
                            ) -> Optional[list[str]]:
    """The source columns the chain needs, in source order; None when some
    operator needs the whole row. `output_required` names the output
    columns the stage after this one reads (all of them when None)."""
    alias: dict[str, Optional[str]] = {c: c for c in source_columns}
    required: set[str] = set()
    cur_cols: list[str] = list(source_columns)
    for op in ops:
        reads = op_reads(op, cur_cols)
        if reads is ALL:
            return None
        required.update(alias[r] for r in reads if alias.get(r))
        if isinstance(op, L.MapOperator):
            # the row is consumed: nothing of the source flows past it
            return [c for c in source_columns if c in required]
        if isinstance(op, L.WithColumnOperator):
            alias[op.column] = None    # derived, or overwritten
            if op.column not in cur_cols:
                cur_cols.append(op.column)
        elif isinstance(op, L.SelectColumnsOperator):
            sel = [cur_cols[c] if isinstance(c, int) else c
                   for c in op.selected]
            alias = {c: alias.get(c) for c in sel}
            cur_cols = sel
    live = alias if output_required is None else \
        {c: alias.get(c) for c in output_required}
    required.update(s for s in live.values() if s)
    return [c for c in source_columns if c in required]
