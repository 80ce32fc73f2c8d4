"""Per-stage Python fallback pipeline (counterpart of
`tuplex_tpu/compiler/pypipeline.py`).

The interpreter path runs rows the compiled tiers could not finish
through ONE function built per stage (reference: PythonPipelineBuilder.cc,
driven per row by ResolveTask). Two tiers, both built once per stage:

  * the source tier (`_try_build_source_pipeline`): one generated Python
    function, `_tpx_pipeline`, with the row's fields as locals and each
    UDF's `x["col"]` rewritten to a positional parameter (reference:
    UDF.h:183 rewriteDictAccessInAST). The row that succeeds builds no
    Row until the end; a row that raises goes to prebuilt resolver
    helpers.
  * the closure tier (`_build_closure_pipeline`): one closure per
    operator, chained in a loop. It runs stages the source tier does not
    take (no input column names, a map before the last operator, ...)
    and is the per-row escape hatch for rows whose arity or names differ
    from the generated layout.

The resolve and ignore operators right after an operator guard it. Both
tiers return ("ok", Row) | ("drop", None) | ("ignored", None) |
("exc", (op_id, exc_name, row_value)).
"""

from __future__ import annotations

import ast
import copy
import functools
import itertools
from typing import Any, Callable, Optional

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


def build_python_pipeline(ops: list, input_names: Optional[tuple] = None
                          ) -> Callable[[Row], tuple]:
    """pipeline(row) -> ("ok", Row) | ("drop", None) | ("ignored", None)
    | ("exc", (op_id, exc_name, row_value)): the source tier when the
    runtime input column names are known and the stage's shape allows it,
    else the closure tier."""
    closure = _build_closure_pipeline(ops)
    if input_names:
        src = _try_build_source_pipeline(ops, tuple(input_names), closure)
        if src is not None:
            return src
    return closure


def _stage_steps(ops: list) -> list:
    """[(op, guards)]: each operator but the resolvers, with the guards
    (exc_class, resolver UDF or None for an ignore) that follow it."""
    steps = []
    for i, op in enumerate(ops):
        if isinstance(op, L.RESOLVERS):
            continue
        guards = tuple(
            (r.exc_class, None if isinstance(r, L.IgnoreOperator) else
             functools.partial(L.apply_udf_python, r.udf))
            for r in itertools.takewhile(
                lambda o: isinstance(o, L.RESOLVERS), ops[i + 1:]))
        steps.append((op, guards))
    return steps


def _build_closure_pipeline(ops: list) -> Callable[[Row], tuple]:
    """The closure tier. The resolve and ignore operators right after an
    operator guard it (reference: ResolveTask): when it raises, the first
    guard whose class matches either drops the row ("ignored") or puts its
    resolver's result in place of the operator's; a resolver that raises
    passes the row to the next guard, and a row no guard takes is an
    exception of the operator."""
    steps = []
    for op, guards in _stage_steps(ops):
        apply_fn, inject_fn = _build_op(op)
        steps.append((apply_fn, inject_fn, guards, op.id))

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


# ===========================================================================
# the source tier (PythonPipelineBuilder.cc analog)
# ===========================================================================

class _RowParamRewriter(ast.NodeTransformer):
    """Rewrites `x["col"]` and `x[i]` on the row parameter into positional
    argument names (reference: UDF.h:183 rewriteDictAccessInAST). Any other
    use of the row parameter marks the UDF as not specializable."""

    def __init__(self, param: str, names: tuple):
        self.param = param
        self.names = names
        self.used: dict[int, str] = {}     # column index -> arg name
        self.failed = False

    def _arg_for(self, ci: int) -> ast.Name:
        name = self.used.setdefault(ci, f"_a{ci}")
        return ast.Name(id=name, ctx=ast.Load())

    def visit_Subscript(self, node: ast.Subscript):
        # matched before descending: the row parameter's Name node below
        # would mark the UDF as not specializable
        if isinstance(node.value, ast.Name) and node.value.id == self.param \
                and isinstance(node.ctx, ast.Load) \
                and isinstance(node.slice, ast.Constant):
            key = node.slice.value
            if isinstance(key, str) and key in self.names:
                return self._arg_for(self.names.index(key))
            if isinstance(key, int) and not isinstance(key, bool) \
                    and -len(self.names) <= key < len(self.names):
                return self._arg_for(key % len(self.names))
        self.generic_visit(node)
        return node

    def visit_Name(self, node: ast.Name):
        if node.id == self.param:
            self.failed = True  # the row escapes (passed whole, rebound)
        return node

    def _visit_nested_scope(self, node):
        # a nested lambda or def whose parameter shadows the row parameter
        # binds a new name: its subscripts are not the row's columns
        a = node.args
        shadow = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
        shadow += [x.arg for x in (a.vararg, a.kwarg) if x is not None]
        if self.param in shadow:
            self.failed = True
            return node
        self.generic_visit(node)
        return node

    visit_Lambda = _visit_nested_scope
    visit_FunctionDef = _visit_nested_scope

    def visit_AsyncFunctionDef(self, node):
        self.failed = True
        return node


_SPEC_COUNTER = itertools.count(1)


def _specialize_udf(udf, names: tuple):
    """(callable, column indices it takes positionally), or None when the
    UDF cannot be specialized."""
    if not udf.source or udf.tree is None:
        return None
    from .analyzer import analyze_udf

    if analyze_udf(udf).mutates_globals:
        # a rebuilt copy runs against a copy of the globals: writes to a
        # global or closure cell must go through the live function
        return None
    tree = udf.tree
    a = tree.args
    if a.vararg or a.kwarg or a.kwonlyargs or a.posonlyargs or a.defaults:
        return None
    if getattr(tree, "decorator_list", None):
        return None   # a decorator changes what the live function does
    params = udf.params
    if len(params) > 1:
        # the row's fields spread over the parameters already
        if len(params) == len(names):
            return udf.func, list(range(len(names)))
        return None
    if len(params) != 1:
        return None
    body = copy.deepcopy(tree.body if isinstance(tree, ast.Lambda)
                         else tree)
    rw = _RowParamRewriter(params[0], names)
    if isinstance(tree, ast.Lambda):
        new_body = rw.visit(body)
    else:
        new_stmts = [rw.visit(st) for st in body.body]
    if rw.failed:
        return None
    arg_cis = sorted(rw.used)
    args = ast.arguments(
        posonlyargs=[], args=[ast.arg(arg=rw.used[ci]) for ci in arg_cis],
        kwonlyargs=[], kw_defaults=[], defaults=[])
    glb = dict(udf.globals)
    if isinstance(tree, ast.Lambda):
        mod = ast.Expression(body=ast.Lambda(args=args, body=new_body))
        ast.fix_missing_locations(mod)
        code = compile(mod, f"<tpx-spec-{udf.name}>", "eval")
        return eval(code, glb), arg_cis  # noqa: S307 - the UDF's own code
    fname = f"_tpx_spec_{next(_SPEC_COUNTER)}"
    mod = ast.Module(body=[ast.FunctionDef(
        name=fname, args=args, body=new_stmts, decorator_list=[],
        type_params=[])], type_ignores=[])
    ast.fix_missing_locations(mod)
    exec(compile(mod, f"<tpx-spec-{udf.name}>", "exec"), glb)  # noqa: S102
    return glb[fname], arg_cis


def _make_resolver_helper(op, guards, names: tuple):
    """The except-path of one generated operator: the guards applied to
    the row boxed afresh (a rare path). Returns the resolved Row (None
    when a resolved filter drops it), _IGNORED or _UNRESOLVED."""
    _, inject_fn = _build_op(op)

    def handle(e, vals: tuple):
        return _resolve(e, guards, inject_fn, Row(vals, names))

    return handle


def _try_build_source_pipeline(ops: list, input_names: tuple, closure):
    """Generate and exec ONE Python function for the stage, or None when
    its shape is not specialized (a map before the last operator, a
    decode over unnamed or mismatched columns, ...).

    Each current column lives in a local `c<slot>`; operators append or
    rewrite slots, and a row that succeeds builds no Row until the end.
    Rows whose arity or names differ from the generated layout go to the
    closure tier on entry, so both tiers agree by construction."""
    from ..runtime.columns import user_columns

    steps = _stage_steps(ops)
    names = tuple(input_names)
    k_in = len(names)
    env: dict[str, Any] = {"_Row": Row, "_closure": closure,
                           "_DROP": ("drop", None),
                           "_IGN": ("ignored", None), "_exc": _exc_result,
                           "_IGNORED": _IGNORED, "_UNRESOLVED": _UNRESOLVED,
                           "_IN_NAMES": names}
    src: list[str] = ["def _tpx_pipeline(_row):",
                      "    _v = _row.values",
                      f"    if len(_v) != {k_in} or "
                      "_row.columns != _IN_NAMES:",
                      "        return _closure(_row)"]
    src += [f"    c{ci} = _v[{ci}]" for ci in range(k_in)]
    cur = list(range(k_in))     # the local slot of each current column
    next_slot = k_in

    def row_tuple() -> str:
        """The current row as a tuple of locals."""
        return "(" + ", ".join(f"c{s}" for s in cur) + \
            ("," if len(cur) == 1 else "") + ")"

    def row_unwrapped() -> str:
        """As Row.unwrap(): the bare value of a one-column row."""
        return f"c{cur[0]}" if len(cur) == 1 else row_tuple()

    def udf_call_expr(si: int, udf) -> str:
        """A call of the UDF over the current columns: positional locals
        when it specializes, else a boxed Row."""
        spec = _specialize_udf(udf, names)
        if spec is not None:
            fn, arg_cis = spec
            env[f"_u{si}"] = fn
            return f"_u{si}(" + ", ".join(f"c{cur[ci]}"
                                          for ci in arg_cis) + ")"
        env[f"_u{si}"] = functools.partial(L.apply_udf_python, udf)
        env[f"_nm{si}"] = names
        return f"_u{si}(_Row({row_tuple()}, _nm{si}))"

    def emit_handler(si: int, op, guards, on_resolved: list[str]):
        """The except block: the guards, then the exception record."""
        if not guards:
            src.append(f"        return _exc({op.id}, _e, "
                       f"{row_unwrapped()})")
            return
        env[f"_h{si}"] = _make_resolver_helper(op, guards, names)
        src.append(f"        _x = _h{si}(_e, {row_tuple()})")
        src.append("        if _x is _IGNORED:")
        src.append("            return _IGN")
        src.append("        if _x is _UNRESOLVED:")
        src.append(f"            return _exc({op.id}, _e, "
                   f"{row_unwrapped()})")
        src.extend(on_resolved)

    for si, (op, guards) in enumerate(steps):
        if isinstance(op, L.DecodeOperator):
            out_cols = user_columns(op.declared)
            if out_cols is None or len(out_cols) != len(cur) or \
                    len(op.declared.types) != len(cur):
                return None
            for m, s in enumerate(cur):
                env[f"_d{si}_{m}"] = _make_cell_decoder(
                    op.declared.types[m], op.null_values)
                src.append(f"    c{s} = _d{si}_{m}(c{s})")
            names = tuple(out_cols)
        elif isinstance(op, L.WithColumnOperator):
            call = udf_call_expr(si, op.udf)
            replace = op.column in names
            slot = cur[names.index(op.column)] if replace else next_slot
            inj_idx = names.index(op.column) if replace else len(cur)
            src.append("    try:")
            src.append(f"        c{slot} = {call}")
            src.append("    except Exception as _e:")
            emit_handler(si, op, guards,
                         [f"        c{slot} = _x.values[{inj_idx}]"])
            if not replace:
                next_slot += 1
                cur.append(slot)
                names = names + (op.column,)
        elif isinstance(op, L.MapColumnOperator):
            if op.column not in names:
                return None
            ci = names.index(op.column)
            slot = cur[ci]
            env[f"_u{si}"] = op.udf.func
            src.append("    try:")
            src.append(f"        c{slot} = _u{si}(c{slot})")
            src.append("    except Exception as _e:")
            emit_handler(si, op, guards,
                         [f"        c{slot} = _x.values[{ci}]"])
        elif isinstance(op, L.FilterOperator):
            call = udf_call_expr(si, op.udf)
            src.append("    try:")
            src.append(f"        if not {call}:")
            src.append("            return _DROP")
            src.append("    except Exception as _e:")
            emit_handler(si, op, guards, ["        if _x is None:",
                                          "            return _DROP"])
        elif isinstance(op, L.SelectColumnsOperator):
            idx = []
            for c in op.selected:
                if isinstance(c, int) and not isinstance(c, bool):
                    if not -len(cur) <= c < len(cur):
                        return None
                    idx.append(c % len(cur))
                elif isinstance(c, str) and c in names:
                    idx.append(names.index(c))
                else:
                    return None
            # a column selected twice gets a slot of its own: a later
            # mapColumn or withColumn writes its first occurrence only
            seen: set = set()
            new_cur = []
            for i2 in idx:
                s = cur[i2]
                if s in seen:
                    src.append(f"    c{next_slot} = c{s}")
                    s = next_slot
                    next_slot += 1
                seen.add(s)
                new_cur.append(s)
            cur = new_cur
            names = tuple(op.schema().columns)
            if len(names) != len(cur):
                return None
        elif isinstance(op, L.RenameColumnOperator):
            try:
                names = op.rename(names)
            except TuplexException:
                return None
        elif isinstance(op, L.MapOperator) and si == len(steps) - 1:
            # the last operator: its result wraps as the closure's does
            call = udf_call_expr(si, op.udf)
            env[f"_inj{si}"] = _build_op(op)[1]
            src.append("    try:")
            src.append(f"        _x = {call}")
            src.append("    except Exception as _e:")
            emit_handler(si, op, guards, ["        return (\"ok\", _x)"])
            src.append(f"    return (\"ok\", _inj{si}(_x, None))")
            return _finish_source(src, env)
        else:
            return None   # a shape the source tier does not take

    env["_OUT_NAMES"] = names
    src.append(f"    return (\"ok\", _Row({row_tuple()}, _OUT_NAMES))")
    return _finish_source(src, env)


def _exc_result(op_id: int, e: BaseException, rowval) -> tuple:
    return ("exc", (op_id, type(e).__name__, rowval))


def _finish_source(src: list, env: dict):
    try:
        code = compile("\n".join(src), "<tpx-pipeline>", "exec")
        exec(code, env)  # noqa: S102 - source built from the stage's ops
    except SyntaxError:
        return None
    return env["_tpx_pipeline"]
