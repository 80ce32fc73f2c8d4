"""AST -> columnar torch ops: the compiled fast path (counterpart of
`tuplex_tpu/compiler/emitter.py`, the subset this package supports).

The UDF's AST is evaluated over CV column batches:

  * every expression evaluates to a CV (whole-column value)
  * Python exceptions become error-code lattice updates: the first error per
    row wins (matching sequential interpreter semantics), and errored rows
    drop out of the active mask
  * constructs outside the supported subset raise NotCompilable — the stage
    then routes all rows through the interpreter

Supported: lambdas and straight-line functions (assignments, returns);
names, constants, + - * / // % and unary minus/not; comparisons; None and
Option values; tuples and tuple indexing; `str.find`/`rfind`/`index`/
`rindex` with a constant needle, string slicing and `len`; `re.search` /
`re.match` where the reference takes its NFA (boolean-only) path; filter
truthiness. Torch runs eagerly, so there is no scan or fusion barrier here:
each expression launches its ops as it is evaluated.
"""

from __future__ import annotations

import ast
from typing import Any, Callable, Optional

import torch

from ..core import typesys as T
from ..core.errors import ExceptionCode, NotCompilable, pack_device_code
from ..ops import strings as S
from ..runtime.torchcfg import I32, I64
from ..utils.reflection import UDFSource, get_udf_source
from .values import CV, const_cv, dtype_for, materialize, null_cv, tuple_cv


class EmitCtx:
    """Per-stage state: batch size, device, error lattice, active mask."""

    def __init__(self, b: int, rowvalid: torch.Tensor):
        self.b = b
        self.device = rowvalid.device
        self.err = torch.zeros(b, dtype=I32, device=self.device)
        self.cur_op = -1                  # set per fused op by the stage fn
        # rows that are real + normal-case; padding/fallback slots never active
        self.active = rowvalid

    def coded(self, code: ExceptionCode) -> int:
        """(exception class, logical-operator id) packed into ONE lattice
        value: class | op_id << 8 (core.errors.pack_device_code)."""
        return pack_device_code(int(code), self.cur_op)

    def ones(self) -> torch.Tensor:
        return torch.ones(self.b, dtype=torch.bool, device=self.device)

    def zeros(self) -> torch.Tensor:
        return torch.zeros(self.b, dtype=torch.bool, device=self.device)


class Emitter:
    def __init__(self, ctx: EmitCtx, globals_: dict[str, Any]):
        self.ctx = ctx
        self.globals = globals_

    def eval_udf(self, udf: UDFSource, args: list[CV]) -> CV:
        """Evaluate a UDF body over columnar args; returns the result CV."""
        if udf.source == "":
            raise NotCompilable("no source available for UDF")
        tree = udf.tree
        params = udf.params
        if len(params) != len(args):
            # multi-param UDF over a row: spread fields across params
            if len(args) == 1 and args[0].elts is not None and \
                    len(args[0].elts) == len(params):
                args = list(args[0].elts)
            else:
                raise NotCompilable(
                    f"UDF takes {len(params)} args, got {len(args)}")
        frame = Frame(self, dict(zip(params, args)))
        if isinstance(tree, ast.Lambda):
            return frame.eval(tree.body)
        if not isinstance(tree, ast.FunctionDef):
            raise NotCompilable(f"UDF node {type(tree).__name__}")
        frame.exec_block(tree.body)
        return frame.finalize_return()

    def inline_call(self, func: Callable, args: list[CV]) -> CV:
        """Inline a user helper function referenced from UDF globals."""
        src = get_udf_source(func)
        if src.source == "":
            raise NotCompilable(f"no source for helper {src.name}")
        return Emitter(self.ctx, {**src.globals}).eval_udf(src, args)


class Frame:
    """One UDF activation: variable env + return value."""

    def __init__(self, emitter: Emitter, env: dict[str, CV]):
        self.em = emitter
        self.ctx = emitter.ctx
        self.env = env
        self.ret_val: Optional[CV] = None

    def raise_where(self, cond: torch.Tensor, code: ExceptionCode) -> None:
        """Rows where `cond` holds (and that are still live) raise `code`:
        the first error per row wins and the row leaves the active mask."""
        hit = self.ctx.active & cond & (self.ctx.err == 0)
        self.ctx.err = torch.where(hit, self.ctx.coded(code), self.ctx.err)
        self.ctx.active = self.ctx.active & ~hit

    def materialize(self, cv: CV) -> CV:
        return materialize(cv, self.ctx.b, self.ctx.device)

    # ===================================================================
    # statements
    # ===================================================================
    def exec_block(self, stmts: list[ast.stmt]) -> None:
        """Straight-line code: statements after a `return` never run."""
        for s in stmts:
            m = getattr(self, "exec_" + type(s).__name__, None)
            if m is None:
                raise NotCompilable(f"statement {type(s).__name__}")
            m(s)
            if self.ret_val is not None:
                return

    def exec_Return(self, node: ast.Return) -> None:
        self.ret_val = self.eval(node.value) if node.value is not None \
            else null_cv()

    def finalize_return(self) -> CV:
        return null_cv() if self.ret_val is None else self.ret_val

    def exec_Assign(self, node: ast.Assign) -> None:
        val = self.eval(node.value)
        if len(node.targets) != 1:
            raise NotCompilable("chained assignment")
        self._assign_target(node.targets[0], val)

    def _assign_target(self, tgt: ast.expr, val: CV) -> None:
        if isinstance(tgt, ast.Name):
            self.env[tgt.id] = val
        elif isinstance(tgt, (ast.Tuple, ast.List)):
            if val.elts is None:
                if val.is_const and isinstance(val.const, tuple):
                    val = tuple_cv([const_cv(v) for v in val.const])
                else:
                    raise NotCompilable("unpacking non-tuple")
            if len(tgt.elts) != len(val.elts):
                raise NotCompilable("unpack arity mismatch")
            for t_i, v_i in zip(tgt.elts, val.elts):
                self._assign_target(t_i, v_i)
        else:
            raise NotCompilable(f"assign target {type(tgt).__name__}")

    def exec_AugAssign(self, node: ast.AugAssign) -> None:
        res = self._binop(node.op, self.eval(node.target),
                          self.eval(node.value))
        self._assign_target(node.target, res)

    def exec_Pass(self, node: ast.Pass) -> None:
        pass

    # ===================================================================
    # expressions
    # ===================================================================
    def eval(self, node: ast.expr) -> CV:
        m = getattr(self, "eval_" + type(node).__name__, None)
        if m is None:
            raise NotCompilable(f"expression {type(node).__name__}")
        return m(node)

    def eval_Constant(self, node: ast.Constant) -> CV:
        if node.value is None or isinstance(node.value,
                                            (bool, int, float, str, tuple)):
            return const_cv(node.value)
        raise NotCompilable(f"constant {type(node.value).__name__}")

    def eval_Name(self, node: ast.Name) -> CV:
        if node.id in self.env:
            return self.env[node.id]
        if node.id in self.em.globals:
            g = self.em.globals[node.id]
            if isinstance(g, (bool, int, float, str, tuple)) or g is None:
                return const_cv(g)
            return CV(t=T.PYOBJECT, const=g)  # module/function: usable in calls
        raise NotCompilable(f"unknown name {node.id!r}")

    def eval_Tuple(self, node: ast.Tuple) -> CV:
        return tuple_cv([self.eval(e) for e in node.elts])

    def eval_BinOp(self, node: ast.BinOp) -> CV:
        return self._binop(node.op, self.eval(node.left),
                           self.eval(node.right))

    def eval_UnaryOp(self, node: ast.UnaryOp) -> CV:
        v = self.eval(node.operand)
        if isinstance(node.op, ast.Not):
            return CV(t=T.BOOL, data=~self.truthy(v))
        if isinstance(node.op, ast.USub):
            if v.is_const:
                return const_cv(-v.const)
            v = self._require_numeric(v, "unary -")
            data = v.data.to(I64) if v.base is T.BOOL else v.data
            return CV(t=T.I64 if v.base is T.BOOL else v.t, data=-data)
        if isinstance(node.op, ast.UAdd):
            return self._require_numeric(v, "unary +")
        raise NotCompilable("unary op")

    def eval_Compare(self, node: ast.Compare) -> CV:
        left = self.eval(node.left)
        comps = [self.eval(c) for c in node.comparators]
        acc = None
        for op, right in zip(node.ops, comps):
            res = self._compare(op, left, right)
            acc = res if acc is None else acc & res
            left = right
        return CV(t=T.BOOL, data=acc)

    def eval_Subscript(self, node: ast.Subscript) -> CV:
        val = self.eval(node.value)
        if isinstance(node.slice, ast.Slice):
            return self._slice(val, node.slice)
        idx = self.eval(node.slice)
        if val.elts is not None:
            if idx.is_const and isinstance(idx.const, str):
                if val.names is None or idx.const not in val.names:
                    raise NotCompilable(f"column {idx.const!r} not in "
                                        f"{val.names or ()}")
                return val.elts[val.names.index(idx.const)]
            if idx.is_const and isinstance(idx.const, (int, bool)):
                i = int(idx.const)
                if not -len(val.elts) <= i < len(val.elts):
                    raise NotCompilable("tuple index out of range")
                return val.elts[i]
            raise NotCompilable("dynamic tuple index")
        raise NotCompilable(f"subscript on {val.t}")

    def eval_Call(self, node: ast.Call) -> CV:
        if node.keywords:
            raise NotCompilable("keyword arguments")
        if isinstance(node.func, ast.Attribute):
            recv = self.eval(node.func.value)
            attr = node.func.attr
            args = [self.eval(a) for a in node.args]
            if recv.is_const and getattr(recv.const, "__name__", None) == "re" \
                    and attr in ("search", "match"):
                return self._re_search(attr, args)
            if recv.base is T.STR:
                return self._str_method(recv, attr, args)
            raise NotCompilable(f"method {attr}")
        if not isinstance(node.func, ast.Name):
            raise NotCompilable("computed call target")
        name = node.func.id
        args = [self.eval(a) for a in node.args]
        # python name resolution: locals, then globals, THEN builtins
        if name in self.env:
            raise NotCompilable(f"call to local value {name}")
        if name in self.em.globals:
            g = self.em.globals[name]
            if callable(g):
                return self.em.inline_call(g, args)
            raise NotCompilable(f"call to non-callable global {name}")
        builtin = getattr(self, "_builtin_" + name, None)
        if builtin is not None:
            return builtin(args)
        raise NotCompilable(f"call to {name}")

    def _re_search(self, fname: str, args: list[CV]) -> CV:
        """Compiled re.search/re.match on the reference's boolean NFA
        branch. Patterns the reference sends to its anchored engine (or to
        the two-pass capture-group path) are NotCompilable here: that
        engine is not ported, and the interpreter gives the same answers."""
        from ..ops.nfa import compile_nfa
        from ..ops.regex import anchored_engine_accepts

        if len(args) != 2:
            raise NotCompilable("re.search arity")
        pat, s = args
        if not (pat.is_const and isinstance(pat.const, str)):
            raise NotCompilable("dynamic regex pattern")
        pattern = pat.const
        if fname == "match" and not pattern.startswith("^"):
            pattern = "^" + pattern   # re.match anchors implicitly
        if anchored_engine_accepts(pattern):
            raise NotCompilable("anchored regex engine not available")
        if s.base is not T.STR:
            raise NotCompilable("re.search over non-string")
        if s.valid is not None:
            # python: re.search(p, None) raises TypeError
            self.raise_where(~s.valid, ExceptionCode.TYPEERROR)
        if any(ord(c) > 127 for c in pattern):
            raise NotCompilable("non-ASCII regex pattern")
        # byte-space matching diverges from codepoint semantics on
        # multibyte rows: route them to the interpreter
        s = self.materialize(s)
        self._ascii_guard(s.sbytes, s.slen)
        nfa = compile_nfa(pattern)
        if not nfa.anchored_start and not nfa.nullable \
                and nfa.n_pos <= _START_MAX_POS \
                and anchored_engine_accepts("^" + pattern):
            raise NotCompilable("two-pass regex capture path not available")
        return CV(t=T.option(T.tuple_of(T.STR)), elts=(),
                  valid=nfa.match(s.sbytes, s.slen), kind="match")

    def truthy(self, v: CV) -> torch.Tensor:
        if v.kind == "match":
            # a match object is truthy exactly when the match exists
            return v.valid
        if v.is_const:
            return self.ctx.ones() if bool(v.const) else self.ctx.zeros()
        base = v.base
        if base is T.NULL:
            return self.ctx.zeros()
        if base is T.BOOL:
            tr = v.data
        elif base in (T.I64, T.F64):
            tr = v.data != 0
        elif base is T.STR:
            tr = v.slen > 0
        elif v.elts is not None:
            tr = self.ctx.ones() if v.elts else self.ctx.zeros()
        else:
            raise NotCompilable(f"truthiness of {v.t}")
        if v.valid is not None:
            tr = tr & v.valid
        return tr

    def _require_numeric(self, v: CV, what: str) -> CV:
        v = self._unwrap_option(v, what)
        if v.t is T.NULL:
            # the TypeError is already flagged for the active rows; a typed
            # dummy keeps the remaining ops well-formed
            return CV(t=T.I64, data=torch.zeros(self.ctx.b, dtype=I64,
                                                device=self.ctx.device))
        if v.is_const:
            if isinstance(v.const, (bool, int, float)):
                return self.materialize(v)
            raise NotCompilable(f"{what}: not numeric")
        if v.base not in (T.BOOL, T.I64, T.F64):
            raise NotCompilable(f"{what}: {v.t} not numeric")
        return v

    def _unwrap_option(self, v: CV, what: str) -> CV:
        """Using an Option value in a non-None-tolerant op raises TypeError
        for rows where it's None (Python: None + 1 -> TypeError)."""
        if v.t is T.NULL:  # incl. the literal None constant
            self.raise_where(self.ctx.ones(), ExceptionCode.TYPEERROR)
            return CV(t=T.NULL)  # non-const marker: callers emit dummies
        if v.valid is not None:
            self.raise_where(~v.valid, ExceptionCode.TYPEERROR)
            return CV(t=v.base, data=v.data, sbytes=v.sbytes, slen=v.slen,
                      elts=v.elts, names=v.names)
        return v

    def _as_i64(self, v: CV) -> torch.Tensor:
        return v.data.to(I64) if v.base is T.BOOL else v.data

    def _ascii_guard(self, sbytes, slen) -> None:
        """Index-space string ops count BYTES; multibyte UTF-8 rows diverge
        from Python codepoint semantics -> normal-case violation (the row
        re-runs on the interpreter)."""
        self.raise_where(S.non_ascii_rows(sbytes, slen),
                         ExceptionCode.NORMALCASEVIOLATION)

    # -- arithmetic ---------------------------------------------------------
    def _binop(self, op: ast.operator, a: CV, b: CV) -> CV:
        if a.is_const and b.is_const:
            try:
                return const_cv(_const_binop(op, a.const, b.const))
            except ZeroDivisionError:
                self.raise_where(self.ctx.ones(),
                                 ExceptionCode.ZERODIVISIONERROR)
                return const_cv(0)
        if a.base is T.STR or b.base is T.STR or \
                (a.is_const and isinstance(a.const, str)) or \
                (b.is_const and isinstance(b.const, str)):
            raise NotCompilable("string operator")
        a = self._require_numeric(a, "arithmetic")
        b = self._require_numeric(b, "arithmetic")
        out_t = T.super_type(a.base, b.base)
        if out_t is T.BOOL:
            out_t = T.I64  # bool+bool -> int
        ad, bd = self._cast(a.data, out_t), self._cast(b.data, out_t)
        if isinstance(op, ast.Add):
            return CV(t=out_t, data=ad + bd)
        if isinstance(op, ast.Sub):
            return CV(t=out_t, data=ad - bd)
        if isinstance(op, ast.Mult):
            return CV(t=out_t, data=ad * bd)
        if isinstance(op, ast.Div):
            bz = self._cast(b.data, T.F64)
            self.raise_where(bz == 0.0, ExceptionCode.ZERODIVISIONERROR)
            safe = torch.where(bz == 0.0, 1.0, bz)
            return CV(t=T.F64, data=self._cast(a.data, T.F64) / safe)
        if isinstance(op, (ast.FloorDiv, ast.Mod)):
            zero = bd == 0
            self.raise_where(zero, ExceptionCode.ZERODIVISIONERROR)
            bd = torch.where(zero, torch.ones_like(bd), bd)
            if isinstance(op, ast.FloorDiv):
                return CV(t=out_t, data=torch.floor_divide(ad, bd))
            return CV(t=out_t, data=torch.remainder(ad, bd))  # python %
        raise NotCompilable(f"operator {type(op).__name__}")

    def _cast(self, arr: torch.Tensor, t: T.Type) -> torch.Tensor:
        return arr.to(dtype_for(t))

    # -- comparisons --------------------------------------------------------
    def _compare(self, op: ast.cmpop, a: CV, b: CV) -> torch.Tensor:
        if isinstance(op, (ast.Is, ast.IsNot, ast.Eq, ast.NotEq)):
            a_is_none = a.t is T.NULL
            b_is_none = b.t is T.NULL
            if a_is_none or b_is_none:
                other = b if a_is_none else a
                if a_is_none and b_is_none:
                    isn = self.ctx.ones()
                elif other.valid is not None:
                    isn = ~other.valid
                else:
                    isn = self.ctx.zeros()
                return isn if isinstance(op, (ast.Is, ast.Eq)) else ~isn
        if isinstance(op, (ast.Is, ast.IsNot)):
            raise NotCompilable("identity comparison")
        a_str = a.base is T.STR or (a.is_const and isinstance(a.const, str))
        b_str = b.base is T.STR or (b.is_const and isinstance(b.const, str))
        if a_str or b_str:
            raise NotCompilable("string comparison")
        if isinstance(op, (ast.Eq, ast.NotEq)) and \
                (a.valid is not None or b.valid is not None):
            # Option equality: values equal AND both present, or both None
            an = self._require_numeric(
                CV(t=a.base, data=a.data) if a.valid is not None else a,
                "comparison")
            bn = self._require_numeric(
                CV(t=b.base, data=b.data) if b.valid is not None else b,
                "comparison")
            av = a.valid if a.valid is not None else self.ctx.ones()
            bv = b.valid if b.valid is not None else self.ctx.ones()
            eq = (av & bv & (an.data == bn.data)) | (~av & ~bv)
            return eq if isinstance(op, ast.Eq) else ~eq
        ad = self._require_numeric(a, "comparison").data
        bd = self._require_numeric(b, "comparison").data
        table = {ast.Eq: torch.eq, ast.NotEq: torch.ne, ast.Lt: torch.lt,
                 ast.LtE: torch.le, ast.Gt: torch.gt, ast.GtE: torch.ge}
        fn = table.get(type(op))
        if fn is None:
            raise NotCompilable(f"comparison {type(op).__name__}")
        return fn(ad, bd)

    # -- strings ------------------------------------------------------------
    def _slice(self, val: CV, sl: ast.Slice) -> CV:
        if val.base is not T.STR:
            if val.elts is not None:
                lo = self._const_or_none(sl.lower)
                hi = self._const_or_none(sl.upper)
                if sl.step is not None:
                    raise NotCompilable("tuple slice step")
                return tuple_cv(list(val.elts)[slice(lo, hi)])
            raise NotCompilable(f"slice of {val.t}")
        if sl.step is not None:
            raise NotCompilable("string slice step")
        val = self.materialize(self._unwrap_option(val, "slice"))
        if val.t is T.NULL:
            raise NotCompilable("slice of None")
        self._ascii_guard(val.sbytes, val.slen)
        start = self._index_arr(sl.lower)
        stop = self._index_arr(sl.upper)
        rb, rl = S.slice_(val.sbytes, val.slen, start, stop)
        return CV(t=T.STR, sbytes=rb, slen=rl)

    def _const_or_none(self, node):
        if node is None:
            return None
        v = self.eval(node)
        if v.is_const and isinstance(v.const, int):
            return v.const
        raise NotCompilable("non-constant tuple slice bound")

    def _index_arr(self, node):
        if node is None:
            return None
        v = self._require_numeric(self.eval(node), "slice bound")
        return self._as_i64(v).to(I32)

    def _str_method(self, recv: CV, name: str, args: list[CV]) -> CV:
        if recv.is_const and all(a.is_const for a in args):
            try:
                return const_cv(getattr(recv.const, name)(
                    *[a.const for a in args]))
            except Exception:
                pass
        if name not in ("find", "rfind", "index", "rindex"):
            raise NotCompilable(f"str.{name}")
        recv = self.materialize(self._unwrap_option(recv, f"str.{name}"))
        if recv.t is T.NULL:
            raise NotCompilable(f"str.{name} on None")
        rb, rl = recv.sbytes, recv.slen
        self._ascii_guard(rb, rl)  # positions are byte offsets
        if not args or not (args[0].is_const and
                            isinstance(args[0].const, str)):
            raise NotCompilable(f"str.{name}: needs constant str arg")
        start = None
        if len(args) > 1:
            start = self._as_i64(
                self._require_numeric(args[1], "find start")).to(I32)
        if len(args) > 2:
            raise NotCompilable(f"str.{name}: end argument")
        pos = S.find_const(rb, rl, args[0].const, start=start,
                           reverse=name.startswith("r"))
        if name in ("index", "rindex"):
            self.raise_where(pos < 0, ExceptionCode.VALUEERROR)
        return CV(t=T.I64, data=pos.to(I64))

    def _builtin_len(self, args: list[CV]) -> CV:
        if len(args) != 1:
            raise NotCompilable("len() arity")
        v = args[0]
        if v.is_const:
            try:
                return const_cv(len(v.const))
            except TypeError:
                pass  # e.g. None: falls through to the unwrap error path
        if v.elts is not None and v.kind != "match":
            return const_cv(len(v.elts))
        v = self._unwrap_option(v, "len()")
        if v.t is T.NULL:
            return CV(t=T.I64, data=torch.zeros(self.ctx.b, dtype=I64,
                                                device=self.ctx.device))
        if v.base is T.STR:
            self._ascii_guard(v.sbytes, v.slen)
            return CV(t=T.I64, data=v.slen.to(I64))
        raise NotCompilable(f"len() of {v.t}")


_START_MAX_POS = 32   # the reference's NFARegex._START_MAX_POS


def _const_binop(op: ast.operator, a, b):
    import operator as _op

    table = {
        ast.Add: _op.add, ast.Sub: _op.sub, ast.Mult: _op.mul,
        ast.Div: _op.truediv, ast.FloorDiv: _op.floordiv, ast.Mod: _op.mod,
    }
    fn = table.get(type(op))
    if fn is None:
        raise NotCompilable(f"const op {type(op).__name__}")
    return fn(a, b)
