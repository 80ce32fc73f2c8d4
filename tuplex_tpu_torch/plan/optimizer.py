"""Logical optimizations (counterpart of `tuplex_tpu/plan/optimizer.py`;
reference: LogicalPlan.cc optimizeFilters, emitPartialFilters and
projection pushdown, FilterBreakdownVisitor.cc).

Which columns a UDF reads is read off its AST: constant-string subscripts
of its row parameter (`x['col']`). A row that escapes in any other way
(passed whole, iterated, a second parameter) reads every column.

  * projection: the columns nothing reads are never split out of the
    file, decoded or staged to the card;
  * conjunction breakdown: `lambda x: a and b` becomes two filters,
    `#and0` and `#and1`, so each clause moves on its own;
  * filter pushdown within a stage: a filter moves ahead of the operators
    whose output it does not read;
  * filter pushdown through joins: a filter that reads one side of a join
    moves to that side (`#joinpush`); the build side of inner joins only;
  * filter reordering (off by default): a run of filters in the order of
    their pass rate over the sample.

Resolvers and ignores pin the operator they guard in place. A filter that
moves ahead stops rows early: like the reference, a row it drops no longer
raises in the operators it would have reached (the
`tuplex.optimizer.filterPushdown` option turns the moves off). Every pass
works on copies: the user's DAG is never changed.
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
    if isinstance(op, (L.DecodeOperator, L.RenameColumnOperator,
                       L.IgnoreOperator)):
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
        elif isinstance(op, L.RenameColumnOperator):
            new_cols = list(op.rename(cur_cols))
            alias = {n: alias.get(o) for o, n in zip(cur_cols, new_cols)}
            cur_cols = new_cols
    live = alias if output_required is None else \
        {c: alias.get(c) for c in output_required}
    required.update(s for s in live.values() if s)
    return [c for c in source_columns if c in required]


def split_filter_conjunctions(ops: list) -> list:
    """FilterBreakdownVisitor analog (reference: FilterBreakdownVisitor.cc;
    LogicalPlan.cc emitPartialFilters): a filter whose body is `a and b`
    splits into SEQUENTIAL filters — order between the clauses is preserved
    (short-circuit intact relative to each other), but each clause can now
    hop over unrelated operators independently during pushdown."""
    out: list = []
    for i, op in enumerate(ops):
        nxt = ops[i + 1] if i + 1 < len(ops) else None
        if isinstance(op, L.FilterOperator) and not isinstance(
                nxt, L.RESOLVERS):
            parts = _split_filter(op)
            if parts is not None:
                out.extend(parts)
                continue
        out.append(op)
    return out


def _split_filter(op) -> Optional[list]:
    from ..utils.reflection import UDFSource

    udf = op.udf
    tree = udf.tree
    if udf.source == "" or len(udf.params) != 1:
        return None
    if isinstance(tree, ast.Lambda):
        body = tree.body
    elif isinstance(tree, ast.FunctionDef):
        # strip DOCSTRINGS only — a bare-call Expr has side effects that a
        # split would silently drop
        stmts = [s for s in tree.body
                 if not (isinstance(s, ast.Expr)
                         and isinstance(s.value, ast.Constant)
                         and isinstance(s.value.value, str))]
        if len(stmts) != 1 or not isinstance(stmts[0], ast.Return):
            return None
        body = stmts[0].value
    else:
        return None
    if not isinstance(body, ast.BoolOp) or not isinstance(body.op, ast.And):
        return None
    # walrus bindings can flow between clauses: splitting unbinds them
    if any(isinstance(n, ast.NamedExpr) for n in ast.walk(body)):
        return None
    p = udf.params[0]
    filters: list = []
    for k, clause in enumerate(body.values):
        try:
            src = f"lambda {p}: ({ast.unparse(clause)})"
            fn = eval(compile(src, f"<filter-split-{udf.name}>", "eval"),
                      dict(udf.globals))
            sub_tree = ast.parse(src, mode="eval").body
            fop = L.FilterOperator(op.parent, fn)
        except Exception:
            return None
        fop.udf = UDFSource(fn, src, sub_tree, dict(udf.globals),
                            f"{udf.name}#and{k}")
        filters.append(fop)
    return filters


def filter_pushdown(ops: list) -> list:
    """Move filters ahead of operators whose outputs they don't read
    (reference: LogicalPlan.cc optimizeFilters — pushing filters toward the
    source shrinks every downstream operator's working set).

    A filter hops over a preceding op when:
      * the op is a Map: never (row shape changes);
      * the op is a WithColumn/MapColumn: the filter doesn't read the
        written column;
      * the op is Rename/Select: names translate through;
    and neither op has resolvers attached (resolver semantics bind to
    operator order).
    """
    guarded: set[int] = set()
    for i, op in enumerate(ops):
        if isinstance(op, L.RESOLVERS) and i > 0:
            guarded.add(id(ops[i - 1]))
            guarded.add(id(op))

    result = list(ops)
    changed = True
    while changed:
        changed = False
        for i in range(1, len(result)):
            f = result[i]
            prev = result[i - 1]
            if not isinstance(f, L.FilterOperator):
                continue
            if id(f) in guarded or id(prev) in guarded:
                continue
            reads = udf_read_columns(f.udf)
            if reads is ALL:
                continue
            if isinstance(prev, L.WithColumnOperator):
                if prev.column in reads:
                    continue
            elif isinstance(prev, L.MapColumnOperator):
                if prev.column in reads:
                    continue
            elif isinstance(prev, L.RenameColumnOperator):
                if prev.new in reads:
                    continue  # name doesn't exist before the rename
            else:
                continue  # Map/Select/Decode/aggregates: don't hop
            result[i - 1], result[i] = f, prev
            changed = True
    return result


def push_filters_through_joins(chain: list) -> list:
    """Push single-side filters ACROSS join boundaries (reference:
    FilterBreakdownVisitor.cc + LogicalPlan.cc optimizeFilters/
    emitPartialFilters — key-side predicates move through join build/probe
    sides so the join materializes fewer rows).

    `chain` is plan_stages' source→sink operator list. A filter downstream
    of a join pushes when every column it reads traces (through renames /
    untouched withColumn/mapColumn outputs) to ONE side of the join:

      * LEFT (probe) side — sound for inner AND left joins: the clone runs
        before the join in the same chain;
      * RIGHT (build) side — inner joins only (a left join keeps unmatched
        probe rows, so dropping build rows early changes nulls): the join
        node is shallow-copied with the clone spliced above its build
        parent (the user's DAG is never mutated; JoinStage plans the build
        side recursively from that parent).

    Column names rewrite via AST (x['CarrierName'] -> x['AirlineName'] ->
    undecorated side name). Resolvers/ignores between filter and join
    block the push (the filter must see resolved rows). Same
    exception-semantics caveat as in-stage pushdown, same option gate
    (tuplex.optimizer.filterPushdown)."""
    import copy

    from .joins import JoinOperator

    def attached_resolver(i: int) -> bool:
        nxt = chain[i + 1] if i + 1 < len(chain) else None
        return isinstance(nxt, L.RESOLVERS)

    changed = True
    while changed:
        changed = False
        for fi, f in enumerate(chain):
            if not isinstance(f, L.FilterOperator) or attached_resolver(fi):
                continue
            reads = udf_read_columns(f.udf)
            if reads is ALL or not reads:
                continue
            # walk upstream translating names until the nearest join
            mapping = {r: r for r in reads}     # filter name -> name at op k
            ji = None
            for k in range(fi - 1, -1, -1):
                op = chain[k]
                if isinstance(op, JoinOperator):
                    ji = k
                    break
                if isinstance(op, L.RESOLVERS):
                    ji = None
                    break
                if isinstance(op, L.FilterOperator):
                    continue
                if isinstance(op, L.RenameColumnOperator):
                    if op.old in mapping.values():
                        ji = None   # upstream-only name already in use
                        break
                    mapping = {r: (op.old if n == op.new else n)
                               for r, n in mapping.items()}
                    continue
                if isinstance(op, (L.WithColumnOperator,
                                   L.MapColumnOperator)):
                    if op.column in mapping.values():
                        ji = None   # reads a column this op writes
                        break
                    continue
                if isinstance(op, L.SelectColumnsOperator):
                    sel = set(c for c in op.selected if isinstance(c, str))
                    if any(isinstance(c, int) for c in op.selected) or \
                            not set(mapping.values()) <= sel:
                        ji = None
                        break
                    continue
                ji = None           # Map / aggregate / unknown: stop
                break
            if ji is None:
                continue
            j = chain[ji]
            side_map = _classify_join_side(j, set(mapping.values()))
            if side_map is None:
                continue
            side, names = side_map
            if side == "right" and j.how != "inner":
                continue
            full_map = {r: names[n] for r, n in mapping.items()}
            parent = j.parents[0] if side == "left" else j.parents[1]
            clone = _rename_filter(f, full_map, parent)
            if clone is None:
                continue
            if side == "left":
                del chain[fi]
                chain.insert(ji, clone)
            else:
                j2 = copy.copy(j)
                j2.parents = [j.parents[0], clone]
                chain[ji] = j2
                del chain[fi]
            changed = True
            break
    return chain


def _classify_join_side(j, names: set):
    """Which join side ALL `names` (join-output columns) come from:
    ("left"|"right", {output name -> side-local name}) or None if mixed."""
    ls = j.left.schema()
    rs = j.right.schema()
    lk = ls.columns.index(j.left_column)
    rk = rs.columns.index(j.right_column)
    left_names = {j._decorate(c, 0): c
                  for i, c in enumerate(ls.columns) if i != lk}
    left_names[j.left_column] = j.left_column
    right_names = {j._decorate(c, 1): c
                   for i, c in enumerate(rs.columns) if i != rk}
    # the key column is both sides' key: usable on either
    right_key_alias = {j.left_column: j.right_column}
    if names <= set(left_names):
        return "left", left_names
    if names <= set(right_names) | set(right_key_alias):
        return "right", {**right_names, **right_key_alias}
    return None


def _rename_filter(f, mapping: dict, parent):
    """Clone a filter with its UDF's x['col'] subscripts renamed."""
    import copy

    from ..utils.reflection import UDFSource

    udf = f.udf
    if udf.source == "" or len(udf.params) != 1:
        return None
    p = udf.params[0]
    tree = copy.deepcopy(udf.tree)

    class R(ast.NodeTransformer):
        def visit_Subscript(self, node: ast.Subscript):
            self.generic_visit(node)
            if isinstance(node.value, ast.Name) and node.value.id == p and \
                    isinstance(node.slice, ast.Constant) and \
                    node.slice.value in mapping:
                node.slice = ast.Constant(mapping[node.slice.value])
            return node

    tree = ast.fix_missing_locations(R().visit(tree))
    try:
        if isinstance(tree, ast.Lambda):
            src = ast.unparse(tree)
            fn = eval(compile(src, f"<join-push-{udf.name}>", "eval"),
                      dict(udf.globals))
        elif isinstance(tree, ast.FunctionDef):
            src = ast.unparse(tree)
            ns = dict(udf.globals)
            exec(compile(src, f"<join-push-{udf.name}>", "exec"), ns)
            fn = ns[tree.name]
        else:
            return None
    except Exception:
        return None
    fop = L.FilterOperator(parent, fn)
    fop.udf = UDFSource(fn, src, tree, dict(udf.globals),
                        f"{udf.name}#joinpush")
    return fop


def reorder_filters(ops: list) -> list:
    """Operator reordering (reference: LogicalPlan.cc's
    tuplex.optimizer.operatorReordering, off by default there too): order
    CONSECUTIVE runs of filters by estimated selectivity so the most
    selective predicate runs first and shrinks the working set for the rest.

    Selectivity is estimated by running each filter's UDF over its
    operator's traced sample; rows that raise count as passing (they must
    still reach the filter that raises for exception parity). Like the
    reference, this is opt-in: reordering changes WHICH filter first drops
    (or raises on) a row, so per-operator exception attribution can shift.
    """
    result = list(ops)
    i = 0
    while i < len(result):
        if not isinstance(result[i], L.FilterOperator):
            i += 1
            continue
        j = i
        while j < len(result) and isinstance(result[j], L.FilterOperator):
            j += 1
        # resolvers bind to the preceding operator: a guarded run stays put
        if j < len(result) and isinstance(
                result[j], L.RESOLVERS):
            i = j + 1
            continue
        if j - i > 1:
            run = result[i:j]
            run.sort(key=_filter_selectivity)
            result[i:j] = run
        i = j
    return result


def _filter_selectivity(op) -> float:
    """Estimated pass fraction of a filter over its traced sample (lower =
    more selective = runs earlier); 1.0 when no sample is available."""
    from .logical import apply_udf_python

    try:
        sample = op.parent.cached_sample()
    except Exception:
        return 1.0
    if not sample:
        return 1.0
    passed = 0
    for row in sample:
        try:
            if apply_udf_python(op.udf, row):
                passed += 1
        except Exception:
            passed += 1  # must reach this filter to raise: treat as pass
    return passed / len(sample)
