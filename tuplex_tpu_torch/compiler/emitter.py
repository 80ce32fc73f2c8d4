"""AST -> columnar torch ops: the compiled fast path (counterpart of
`tuplex_tpu/compiler/emitter.py`, the subset this package supports).

The UDF's AST is evaluated over CV column batches:

  * every expression evaluates to a CV (whole-column value)
  * Python exceptions become error-code lattice updates: the first error per
    row wins (matching sequential interpreter semantics), and errored rows
    drop out of the active mask
  * control flow is predicated: both arms of an `if` run under their masks
    and assignments and returns merge per row (`merge_cv`); errors raise
    only for rows on the arm that raised
  * constructs outside the supported subset raise NotCompilable — the stage
    then routes all rows through the interpreter

Supported: lambdas and functions with assignments, augmented assignments,
if/elif/else, conditional expressions and returns anywhere; names,
constants, + - * / // % and unary minus/not; `and`/`or` with Python's value
and short-circuit semantics; chained comparisons (int against float
exactly as Python compares them, str ==/!= and code-point ordering,
Option == None); `in` on
strings and constant tuples; None and Option values; tuples, tuple and
named-row indexing; string indexing and slicing, `len`, concatenation,
`'%0Nd' % i`, `'{}'`/`'{:0N}'`/`'{:N}'` with `str.format`, `int()`,
`float()`; `str.find`/`rfind`/`index`/`rindex` with a constant needle,
`lower`/`upper`, `replace` with constant arguments, `strip`/`lstrip`/
`rstrip`, `string.capwords`; `re.search` /
`re.match` where the reference takes its NFA (boolean-only) path; filter
truthiness. Torch runs eagerly, so there is no scan or fusion barrier here:
each expression launches its ops as it is evaluated. Branch speculation
(the reference's `branchprof`) is not ported: both arms always run.
"""

from __future__ import annotations

import ast
import operator as _op
import re
import string
from typing import Any, Callable, Optional

import torch

from ..core import typesys as T
from ..core.errors import ExceptionCode, NotCompilable, pack_device_code
from ..ops import strings as S
from ..runtime.torchcfg import F64, I32, I64
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

    def eval_udf(self, udf: UDFSource, args: list[CV],
                 mask: Optional[torch.Tensor] = None) -> CV:
        """Evaluate a UDF body over columnar args; returns the result CV.
        `mask` restricts the rows the body runs for (an inlined helper runs
        under its call site's mask)."""
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
        frame = Frame(self, dict(zip(params, args)), mask)
        if isinstance(tree, ast.Lambda):
            return frame.eval(tree.body)
        if not isinstance(tree, ast.FunctionDef):
            raise NotCompilable(f"UDF node {type(tree).__name__}")
        frame.exec_block(tree.body)
        return frame.finalize_return()

    def inline_call(self, func: Callable, args: list[CV],
                    mask: torch.Tensor) -> CV:
        """Inline a user helper function referenced from UDF globals."""
        src = get_udf_source(func)
        if src.source == "":
            raise NotCompilable(f"no source for helper {src.name}")
        return Emitter(self.ctx, {**src.globals}).eval_udf(src, args, mask)


class Frame:
    """One UDF activation: variable env, branch predicate and returns."""

    def __init__(self, emitter: Emitter, env: dict[str, CV],
                 mask: Optional[torch.Tensor] = None):
        self.em = emitter
        self.ctx = emitter.ctx
        self.env = env
        self.mask = mask              # branch predicate [B] or None == all
        self._body_mask = mask        # the mask the body started under
        self.ret_val: Optional[CV] = None
        self.ret_mask: Optional[torch.Tensor] = None   # rows that returned
        self.returned = False         # an unconditional return ran

    def active(self) -> torch.Tensor:
        """Rows this point of the body runs for: live, not yet returned,
        on the current branch."""
        a = self.ctx.active
        if self.ret_mask is not None:
            a = a & ~self.ret_mask
        if self.mask is not None:
            a = a & self.mask
        return a

    def raise_where(self, cond: torch.Tensor, code: ExceptionCode) -> None:
        """Rows where `cond` holds (and that are still live here) raise
        `code`: the first error per row wins and the row leaves the active
        mask."""
        hit = self.active() & cond & (self.ctx.err == 0)
        self.ctx.err = torch.where(hit, self.ctx.coded(code), self.ctx.err)
        self.ctx.active = self.ctx.active & ~hit

    def materialize(self, cv: CV) -> CV:
        return materialize(cv, self.ctx.b, self.ctx.device)

    # ===================================================================
    # statements
    # ===================================================================
    def exec_block(self, stmts: list[ast.stmt]) -> None:
        """Statements after an unconditional `return` never run."""
        for s in stmts:
            m = getattr(self, "exec_" + type(s).__name__, None)
            if m is None:
                raise NotCompilable(f"statement {type(s).__name__}")
            m(s)
            if self.returned:
                return

    def exec_Return(self, node: ast.Return) -> None:
        val = self.eval(node.value) if node.value is not None \
            else null_cv()
        live = self.active()
        self.ret_val = val if self.ret_val is None else \
            merge_cv(self, live, val, self.ret_val)
        self.ret_mask = live if self.ret_mask is None \
            else self.ret_mask | live
        if self.mask is self._body_mask:
            self.returned = True

    def finalize_return(self) -> CV:
        if self.ret_val is None:
            return null_cv()
        if not self.returned:
            # rows that fall off the end return None, outside the returned
            # values' type: they resolve on the interpreter
            self.raise_where(self.ctx.ones(),
                             ExceptionCode.NORMALCASEVIOLATION)
        return self.ret_val

    def exec_Assign(self, node: ast.Assign) -> None:
        val = self.eval(node.value)
        if len(node.targets) != 1:
            raise NotCompilable("chained assignment")
        self._assign_target(node.targets[0], val)

    def _assign_target(self, tgt: ast.expr, val: CV) -> None:
        if isinstance(tgt, ast.Name):
            old = self.env.get(tgt.id)
            if self.mask is not None and old is not None:
                # inside a branch: rows off the branch keep the old value
                val = merge_cv(self, self.mask, val, old)
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

    def exec_Expr(self, node: ast.Expr) -> None:
        self.eval(node.value)   # for its errors; the value is dropped

    def exec_If(self, node: ast.If) -> None:
        """Both arms run, each under its branch mask."""
        cond = self.truthy(self.eval(node.test))
        outer = self.mask
        self.mask = cond if outer is None else outer & cond
        self.exec_block(node.body)
        if node.orelse:
            self.mask = ~cond if outer is None else outer & ~cond
            self.exec_block(node.orelse)
        self.mask = outer

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
            if v.base is T.I64:
                # -(-2**63) is beyond int64: Python's int goes on
                self.raise_where(v.data == I64_MIN,
                                 ExceptionCode.NORMALCASEVIOLATION)
            data = v.data.to(I64) if v.base is T.BOOL else v.data
            return CV(t=T.I64 if v.base is T.BOOL else v.t, data=-data)
        if isinstance(node.op, ast.UAdd):
            return self._require_numeric(v, "unary +")
        raise NotCompilable("unary op")

    def eval_Compare(self, node: ast.Compare) -> CV:
        """Chained comparisons: a < b <= c is (a < b) & (b <= c), each
        operand evaluated once."""
        left = self.eval(node.left)
        comps = [self.eval(c) for c in node.comparators]
        if left.is_const and all(c.is_const for c in comps):
            try:
                vals = [left.const] + [c.const for c in comps]
                return const_cv(all(
                    _CONST_CMP[type(op)](a, b)
                    for op, a, b in zip(node.ops, vals, vals[1:])))
            except (KeyError, TypeError):
                pass    # not foldable: the vectorized path decides
        acc = None
        for op, right in zip(node.ops, comps):
            res = self._compare(op, left, right)
            acc = res if acc is None else acc & res
            left = right
        return CV(t=T.BOOL, data=acc)

    def eval_BoolOp(self, node: ast.BoolOp) -> CV:
        """Python value semantics: the result is the first operand that
        decides (falsy for `and`, truthy for `or`), else the last. Operand
        i+1 only runs (and raises) for rows the earlier operands did not
        decide."""
        is_and = isinstance(node.op, ast.And)
        outer = self.mask
        vals = []
        gate = outer
        for operand in node.values:
            self.mask = gate
            v = self.eval(operand)
            vals.append(v)
            tr = self.truthy(v)
            nxt = tr if is_and else ~tr
            gate = nxt if gate is None else gate & nxt
        self.mask = outer
        result = vals[-1]
        for v in reversed(vals[:-1]):
            tr = self.truthy(v)
            result = merge_cv(self, tr if is_and else ~tr, result, v)
        return result

    def eval_IfExp(self, node: ast.IfExp) -> CV:
        cond = self.truthy(self.eval(node.test))
        outer = self.mask
        self.mask = cond if outer is None else outer & cond
        a = self.eval(node.body)
        self.mask = ~cond if outer is None else outer & ~cond
        b = self.eval(node.orelse)
        self.mask = outer
        return merge_cv(self, cond, a, b)

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
        if val.base is T.STR:
            rb, rl = self._to_strpair(val)
            self._ascii_guard(rb, rl)   # byte index == char index
            i = self._as_i64(self._require_numeric(idx, "string index"))
            ch, cl, oob = S.char_at(rb, rl, i.to(I32))
            self.raise_where(oob, ExceptionCode.INDEXERROR)
            return CV(t=T.STR, sbytes=ch, slen=cl)
        raise NotCompilable(f"subscript on {val.t}")

    def eval_Call(self, node: ast.Call) -> CV:
        if node.keywords:
            raise NotCompilable("keyword arguments")
        if isinstance(node.func, ast.Attribute):
            recv = self.eval(node.func.value)
            attr = node.func.attr
            args = [self.eval(a) for a in node.args]
            module = getattr(recv.const, "__name__", None) \
                if recv.is_const else None
            if module == "re" and attr in ("search", "match"):
                return self._re_search(attr, args)
            if module == "string" and attr == "capwords":
                return self._capwords(args)
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
                return self.em.inline_call(g, args, self.active())
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
            except (TypeError, ValueError):
                raise NotCompilable("constant operation raises") from None
            except ZeroDivisionError:
                self.raise_where(self.ctx.ones(),
                                 ExceptionCode.ZERODIVISIONERROR)
                return const_cv(0)
        if a.base is T.STR or b.base is T.STR or \
                (a.is_const and isinstance(a.const, str)) or \
                (b.is_const and isinstance(b.const, str)):
            if isinstance(op, ast.Add):
                return self._str_concat(a, b)
            if isinstance(op, ast.Mod):
                return self._str_format(a, b)
            raise NotCompilable(f"str operator {type(op).__name__}")
        a = self._require_numeric(a, "arithmetic")
        b = self._require_numeric(b, "arithmetic")
        out_t = T.super_type(a.base, b.base)
        if out_t is T.BOOL:
            out_t = T.I64  # bool+bool -> int
        ad, bd = self._cast(a.data, out_t), self._cast(b.data, out_t)
        if isinstance(op, (ast.Add, ast.Sub, ast.Mult)):
            if isinstance(op, ast.Add):
                r = ad + bd
            elif isinstance(op, ast.Sub):
                r = ad - bd
            else:
                r = ad * bd
            if out_t is T.I64:
                # rows whose result left int64 interpret: Python's int
                # does not wrap
                self.raise_where(_i64_wrapped(op, ad, bd, r),
                                 ExceptionCode.NORMALCASEVIOLATION)
            return CV(t=out_t, data=r)
        if isinstance(op, ast.Div):
            if out_t is T.I64:
                # int / int is the correctly rounded quotient; the float
                # division equals it while both ints convert exactly
                big = (ad > _TWO53) | (ad < -_TWO53) | (bd > _TWO53) | \
                    (bd < -_TWO53)
                self.raise_where(big, ExceptionCode.NORMALCASEVIOLATION)
            bz = self._cast(b.data, T.F64)
            self.raise_where(bz == 0.0, ExceptionCode.ZERODIVISIONERROR)
            safe = torch.where(bz == 0.0, 1.0, bz)
            return CV(t=T.F64, data=self._cast(a.data, T.F64) / safe)
        if isinstance(op, (ast.FloorDiv, ast.Mod)):
            zero = bd == 0
            self.raise_where(zero, ExceptionCode.ZERODIVISIONERROR)
            one = zero
            if out_t is T.I64:
                # -2**63 // -1 is 2**63, beyond int64, and interprets;
                # -2**63 % -1 is 0, as with a divisor of 1
                wraps = (ad == I64_MIN) & (bd == -1)
                if isinstance(op, ast.FloorDiv):
                    self.raise_where(wraps,
                                     ExceptionCode.NORMALCASEVIOLATION)
                one = zero | wraps
            bd = torch.where(one, torch.ones_like(bd), bd)
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
                if other.t is T.NULL:
                    isn = self.ctx.ones()
                elif other.valid is not None:
                    isn = ~other.valid
                else:
                    isn = self.ctx.zeros()
                return isn if isinstance(op, (ast.Is, ast.Eq)) else ~isn
        if isinstance(op, (ast.Is, ast.IsNot)):
            raise NotCompilable("identity comparison")
        if isinstance(op, (ast.In, ast.NotIn)):
            res = self._contains(a, b)
            return res if isinstance(op, ast.In) else ~res
        eq_op = isinstance(op, (ast.Eq, ast.NotEq))
        a_str, b_str = _is_str(a), _is_str(b)
        if a_str or b_str:
            if not eq_op:
                return self._str_order(op, a, b)
            if a_str and b_str:
                # None == "x" is False, not an error: Option rows stay
                raw = S.equals(*self._str_payload(a), *self._str_payload(b))
            else:
                raw = self.ctx.zeros()    # a str never equals a number
            return self._option_eq(a, b, raw, op)
        if eq_op and (a.valid is not None or b.valid is not None):
            an = self._require_numeric(
                CV(t=a.base, data=a.data) if a.valid is not None else a,
                "comparison")
            bn = self._require_numeric(
                CV(t=b.base, data=b.data) if b.valid is not None else b,
                "comparison")
            return self._option_eq(a, b, _num_cmp(ast.Eq, an, bn), op)
        an = self._require_numeric(a, "comparison")
        bn = self._require_numeric(b, "comparison")
        if type(op) not in _CMP_FN:
            raise NotCompilable(f"comparison {type(op).__name__}")
        return _num_cmp(type(op), an, bn)

    def _str_order(self, op: ast.cmpop, a: CV, b: CV) -> torch.Tensor:
        """<, <=, >, >= between strings, in code-point order. A None operand
        raises TypeError, as does a string against a non-string."""
        if type(op) not in _CMP_FN:
            raise NotCompilable(f"comparison {type(op).__name__}")
        if not (_is_str(a) or a.t is T.NULL) or \
                not (_is_str(b) or b.t is T.NULL):
            self.raise_where(self.ctx.ones(), ExceptionCode.TYPEERROR)
            return self.ctx.zeros()
        ab, al = self._to_strpair(a)
        bb, bl = self._to_strpair(b)
        if isinstance(op, (ast.Gt, ast.GtE)):
            ab, al, bb, bl = bb, bl, ab, al
        return S.compare_lt(ab, al, bb, bl,
                            or_equal=isinstance(op, (ast.LtE, ast.GtE)))

    def _option_eq(self, a: CV, b: CV, raw_eq: torch.Tensor,
                   op: ast.cmpop) -> torch.Tensor:
        """Equality with None: values equal and both present, or both
        None."""
        av = self.ctx.ones() if a.valid is None else a.valid
        bv = self.ctx.ones() if b.valid is None else b.valid
        eq = (av & bv & raw_eq) | (~av & ~bv)
        return eq if isinstance(op, ast.Eq) else ~eq

    def _contains(self, needle: CV, hay: CV) -> torch.Tensor:
        if _is_str(hay):
            if needle.is_const and isinstance(needle.const, str):
                return S.contains_const(*self._to_strpair(hay), needle.const)
            raise NotCompilable("dynamic needle for `in`")
        if hay.is_const and isinstance(hay.const, (tuple, list, set,
                                                   frozenset)):
            items = [const_cv(v) for v in hay.const]
        elif hay.elts is not None and hay.names is None \
                and hay.kind is None and hay.valid is None:
            items = list(hay.elts)
        else:
            raise NotCompilable(f"`in` over {hay.t}")
        acc = self.ctx.zeros()
        for e in items:
            acc = acc | self._compare(ast.Eq(), needle, e)
        return acc

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

    def _str_payload(self, v: CV):
        """(bytes, lens) of a str or Option[str] CV (constants broadcast)
        without raising for None rows: callers gate on validity."""
        if v.is_const:
            if not isinstance(v.const, str):
                raise NotCompilable("expected str")
            return S.broadcast_const(v.const, self.ctx.b, self.ctx.device)
        if v.base is not T.STR:
            raise NotCompilable(f"expected str, got {v.t}")
        return v.sbytes, v.slen

    def _to_strpair(self, v: CV):
        """(bytes, lens) of a str CV; None rows raise TypeError."""
        v = self._unwrap_option(v, "string op")
        if v.t is T.NULL:   # the error is flagged; a dummy keeps ops going
            return S.broadcast_const("", self.ctx.b, self.ctx.device)
        return self._str_payload(v)

    def _str_concat(self, a: CV, b: CV) -> CV:
        if a.is_const and b.is_const:
            if not (isinstance(a.const, str) and isinstance(b.const, str)):
                raise NotCompilable("str + non-str")
            return const_cv(a.const + b.const)
        rb, rl = S.concat(*self._to_strpair(a), *self._to_strpair(b))
        return CV(t=T.STR, sbytes=rb, slen=rl)

    def _str_format(self, fmt: CV, args: CV) -> CV:
        """'...%0Nd...' % x with a constant format string: %d, %0Nd and %%
        only; any other directive interprets."""
        if not (fmt.is_const and isinstance(fmt.const, str)):
            raise NotCompilable("dynamic format string")
        if args.is_const:
            try:
                return const_cv(fmt.const % args.const)
            except (TypeError, ValueError):
                raise NotCompilable("constant format raises") from None
        if args.elts is not None and args.names is None \
                and args.kind is None and args.valid is None:
            arg_list = list(args.elts)
        else:
            arg_list = [args]
        out: Optional[CV] = None
        ai = 0
        # the split's odd pieces are the specs it captured; a '%' in any
        # other piece is a directive this subset does not compile
        pieces = re.split(r"(%%|%(?:0\d+)?d)", fmt.const)
        for pi, piece in enumerate(pieces):
            if not piece:
                continue
            if piece == "%%":
                part = const_cv("%")
            elif pi % 2:
                if ai >= len(arg_list):
                    raise NotCompilable("format arity")
                arg = self._unwrap_option(arg_list[ai], "%d")
                ai += 1
                if arg.t is T.NULL:
                    vals = torch.zeros(self.ctx.b, dtype=I64,
                                       device=self.ctx.device)
                else:
                    arg = self.materialize(arg)
                    if arg.base not in (T.I64, T.BOOL):
                        raise NotCompilable(f"%d of {arg.t}")
                    vals = self._as_i64(arg)
                width = int(piece[1:-1] or "0")
                fb, fl = S.format_i64(vals, width=width,
                                      pad_zero=width > 0)
                part = CV(t=T.STR, sbytes=fb, slen=fl)
            elif "%" in piece:
                raise NotCompilable(f"format {piece!r}")
            else:
                part = const_cv(piece)
            out = part if out is None else self._str_concat(out, part)
        if ai != len(arg_list):
            raise NotCompilable("surplus % format arguments")
        return out if out is not None else const_cv("")

    def _str_method(self, recv: CV, name: str, args: list[CV]) -> CV:
        if recv.is_const and all(a.is_const for a in args):
            try:
                return const_cv(getattr(recv.const, name)(
                    *[a.const for a in args]))
            except Exception:
                pass
        if name == "format":
            return self._str_dot_format(recv, args)
        if name not in ("find", "rfind", "index", "rindex", "lower",
                        "upper", "replace", "strip", "lstrip", "rstrip"):
            raise NotCompilable(f"str.{name}")
        rb, rl = self._to_strpair(recv)
        if name in ("strip", "lstrip", "rstrip"):
            return self._strip(name, rb, rl, args)
        if name in ("lower", "upper"):
            if args:
                raise NotCompilable(f"str.{name} arguments")
            # byte case maps cover ASCII only: 'é'.upper() must interpret
            self._ascii_guard(rb, rl)
            fb, fl = getattr(S, name)(rb, rl)
            return CV(t=T.STR, sbytes=fb, slen=fl)
        if name == "replace":
            # byte matching of a UTF-8 needle equals code-point matching,
            # so non-ASCII rows need no guard here
            if len(args) != 2 or not all(
                    a.is_const and isinstance(a.const, str) for a in args) \
                    or not args[0].const:
                raise NotCompilable("str.replace: needs two constant str "
                                    "args, the first non-empty")
            fb, fl = S.replace_const(rb, rl, args[0].const, args[1].const)
            return CV(t=T.STR, sbytes=fb, slen=fl)
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

    def _strip(self, name: str, rb, rl, args: list[CV]) -> CV:
        """str.strip/lstrip/rstrip, of whitespace or of a constant ASCII
        set. Whitespace beyond ASCII is multibyte: those rows interpret. A
        set of ASCII bytes never matches inside a multibyte character, so
        with one no row needs the interpreter."""
        if len(args) > 1 or (args and not (args[0].is_const and (
                args[0].const is None or isinstance(args[0].const, str)))):
            raise NotCompilable(f"str.{name}: needs a constant argument")
        chars = args[0].const if args else None
        if chars is None:
            self._ascii_guard(rb, rl)
        elif any(ord(c) > 127 for c in chars):
            raise NotCompilable(f"str.{name}: non-ASCII characters")
        fb, fl = S.strip(rb, rl, chars, left=name != "rstrip",
                         right=name != "lstrip")
        return CV(t=T.STR, sbytes=fb, slen=fl)

    def _capwords(self, args: list[CV]) -> CV:
        if len(args) != 1:
            raise NotCompilable("string.capwords: separator argument")
        rb, rl = self._to_strpair(args[0])
        self._ascii_guard(rb, rl)   # case maps and spaces of ASCII only
        fb, fl = S.capwords(rb, rl)
        return CV(t=T.STR, sbytes=fb, slen=fl)

    def _str_dot_format(self, fmt: CV, args: list[CV]) -> CV:
        """A constant format string's .format(...) with automatic fields
        only: '{}' of a str or an int, '{:0N}' and '{:N}' of an int. Any
        other field interprets. A None argument (formatted as 'None', or
        raising under a width) re-runs on the interpreter."""
        if not (fmt.is_const and isinstance(fmt.const, str)):
            raise NotCompilable("str.format: dynamic format string")
        try:
            fields = list(string.Formatter().parse(fmt.const))
        except ValueError:
            raise NotCompilable("str.format: bad format string") from None
        out: Optional[CV] = None
        ai = 0
        for literal, field, spec, conv in fields:
            part = const_cv(literal) if literal else None
            if field is not None:
                if field != "" or conv is not None or \
                        not re.fullmatch(r"(0?[1-9]\d*)?", spec) or \
                        ai >= len(args):
                    raise NotCompilable(f"str.format field {{{field}:{spec}}}")
                arg = args[ai]
                ai += 1
                if arg.valid is not None:
                    self.raise_where(~arg.valid,
                                     ExceptionCode.NORMALCASEVIOLATION)
                    arg = CV(t=arg.base, data=arg.data, sbytes=arg.sbytes,
                             slen=arg.slen)
                arg = self.materialize(arg)
                if arg.base is T.STR and not spec:
                    val = CV(t=T.STR, sbytes=arg.sbytes, slen=arg.slen)
                elif arg.base is T.I64:
                    width = int(spec or "0")
                    zero = spec.startswith("0")
                    fb, fl = S.format_i64(arg.data, width=width,
                                          pad_zero=zero)
                    if width and not zero:
                        fb, fl = S.pad_left(fb, fl, width)
                    val = CV(t=T.STR, sbytes=fb, slen=fl)
                else:
                    raise NotCompilable(f"str.format of {arg.t} "
                                        f"with {spec!r}")
                part = val if part is None else self._str_concat(part, val)
            if part is not None:
                out = part if out is None else self._str_concat(out, part)
        if ai != len(args):
            raise NotCompilable("str.format: surplus arguments")
        return out if out is not None else const_cv("")

    def _builtin_float(self, args: list[CV]) -> CV:
        """float() of a number (the identity on f64; ints convert rounding
        to nearest, as CPython does) or of a str (parse_f64, which leaves
        what it does not evaluate exactly to CPython). A None row raises
        TypeError."""
        if len(args) != 1:
            raise NotCompilable("float() arity")
        v = args[0]
        if v.is_const:
            try:
                return const_cv(float(v.const))
            except (ValueError, TypeError, OverflowError):
                pass   # every row raises: the vectorized path says so
        v = self._unwrap_option(v, "float()")
        if v.t is T.NULL:
            return CV(t=T.F64, data=torch.zeros(self.ctx.b, dtype=F64,
                                                device=self.ctx.device))
        v = self.materialize(v)
        if v.base is T.STR:
            val, bad, route = S.parse_f64(v.sbytes, v.slen)
            self.raise_where(bad, ExceptionCode.VALUEERROR)
            self.raise_where(route, ExceptionCode.NORMALCASEVIOLATION)
            return CV(t=T.F64, data=val)
        if v.base in (T.F64, T.I64, T.BOOL):
            return CV(t=T.F64, data=v.data.to(F64))
        raise NotCompilable(f"float() of {v.t}")

    def _builtin_int(self, args: list[CV]) -> CV:
        if len(args) != 1:
            raise NotCompilable("int() arity")
        v = args[0]
        if v.is_const:
            try:
                return const_cv(int(v.const))
            except (ValueError, TypeError, OverflowError):
                pass   # every row raises: the vectorized path says so
        v = self._unwrap_option(v, "int()")
        if v.t is T.NULL:
            return CV(t=T.I64, data=torch.zeros(self.ctx.b, dtype=I64,
                                                device=self.ctx.device))
        v = self.materialize(v)
        if v.base is T.STR:
            val, bad, route = S.parse_i64(v.sbytes, v.slen)
            self.raise_where(bad, ExceptionCode.VALUEERROR)
            # a valid Python int this kernel does not evaluate
            self.raise_where(route, ExceptionCode.NORMALCASEVIOLATION)
            return CV(t=T.I64, data=val)
        if v.base is T.F64:
            t = torch.trunc(v.data)
            # nan, inf and values beyond int64 raise or grow in Python
            ok = (t >= -2.0 ** 63) & (t < 2.0 ** 63)
            self.raise_where(~ok, ExceptionCode.NORMALCASEVIOLATION)
            return CV(t=T.I64, data=torch.where(ok, t, 0.0).to(I64))
        if v.base in (T.I64, T.BOOL):
            return CV(t=T.I64, data=self._as_i64(v))
        raise NotCompilable(f"int() of {v.t}")

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


def _is_str(v: CV) -> bool:
    return v.base is T.STR or (v.is_const and isinstance(v.const, str))


_CONST_CMP = {ast.Eq: _op.eq, ast.NotEq: _op.ne, ast.Lt: _op.lt,
              ast.LtE: _op.le, ast.Gt: _op.gt, ast.GtE: _op.ge,
              ast.Is: _op.is_, ast.IsNot: _op.is_not,
              ast.In: lambda a, b: a in b,
              ast.NotIn: lambda a, b: a not in b}
_CMP_FN = {ast.Eq: torch.eq, ast.NotEq: torch.ne, ast.Lt: torch.lt,
           ast.LtE: torch.le, ast.Gt: torch.gt, ast.GtE: torch.ge}
_FLIP = {ast.Eq: ast.Eq, ast.NotEq: ast.NotEq, ast.Lt: ast.Gt,
         ast.LtE: ast.GtE, ast.Gt: ast.Lt, ast.GtE: ast.LtE}
_TWO53 = 1 << 53
_TWO63 = 2.0 ** 63
_BELOW_TWO63 = 9223372036854774784.0   # the largest double below 2**63


def _num_cmp(op: type, a: CV, b: CV) -> torch.Tensor:
    """a <op> b for materialized numeric CVs, exact as Python compares:
    bools as ints, and an int against a float without rounding the int."""
    a_f, b_f = a.base is T.F64, b.base is T.F64
    ad = a.data.to(I64) if a.base is T.BOOL else a.data
    bd = b.data.to(I64) if b.base is T.BOOL else b.data
    if a_f == b_f:
        return _CMP_FN[op](ad, bd)
    if a_f:
        return _int_float_cmp(_FLIP[op], bd, ad)
    return _int_float_cmp(op, ad, bd)


def _int_float_cmp(op: type, x: torch.Tensor, f: torch.Tensor):
    """int64 x <op> float64 f exactly: x < f iff x < ceil(f), x <= f iff
    x <= floor(f) (and so on) for finite f inside int64's range; f beyond
    the range orders against every x, and nan compares unequal."""
    hi = f >= _TWO63
    lo = f < -_TWO63
    nan = torch.isnan(f)
    fc = torch.clamp(torch.where(nan, 0.0, f), -_TWO63, _BELOW_TWO63)
    fl, ce = torch.floor(fc), torch.ceil(fc)
    if op in (ast.Eq, ast.NotEq):
        eq = ~hi & ~lo & ~nan & (fl == fc) & (x == fl.to(I64))
        return eq if op is ast.Eq else ~eq
    if op is ast.Lt:
        res, above = x < ce.to(I64), True
    elif op is ast.LtE:
        res, above = x <= fl.to(I64), True
    elif op is ast.Gt:
        res, above = x > fl.to(I64), False
    else:
        res, above = x >= ce.to(I64), False
    res = torch.where(hi, above, torch.where(lo, not above, res))
    return res & ~nan


def _pad_width(a: torch.Tensor, w: int) -> torch.Tensor:
    return a if a.shape[1] >= w else \
        torch.nn.functional.pad(a, (0, w - a.shape[1]))


def merge_cv(frame: Frame, mask: torch.Tensor, a: CV, b: CV) -> CV:
    """where(mask, a, b) over CVs, unifying their types: the phi node of
    predicated control flow."""
    n = frame.ctx.b
    if a.is_const and b.is_const and type(a.const) is type(b.const) \
            and a.const == b.const:
        return a
    if a.t is T.NULL and b.t is T.NULL:
        return null_cv()
    if a.t is T.NULL or b.t is T.NULL:
        # a None arm: Option of the other side, valid where it is chosen
        other = frame.materialize(b if a.t is T.NULL else a)
        sel = ~mask if a.t is T.NULL else mask
        valid = sel if other.valid is None else sel & other.valid
        return CV(t=T.option(other.base), data=other.data, valid=valid,
                  sbytes=other.sbytes, slen=other.slen, elts=other.elts,
                  names=other.names)
    am, bm = frame.materialize(a), frame.materialize(b)
    if am.elts is not None and bm.elts is not None:
        if len(am.elts) != len(bm.elts) or am.kind != bm.kind:
            raise NotCompilable("merging tuples of different shapes")
        elts = [merge_cv(frame, mask, x, y)
                for x, y in zip(am.elts, bm.elts)]
        return tuple_cv(elts, names=am.names or bm.names,
                        valid=_merge_valid(mask, am, bm, n), kind=am.kind)
    if am.kind is not None or bm.kind is not None:
        raise NotCompilable("merging special objects")
    at, bt = am.base, bm.base
    if at is T.STR and bt is T.STR:
        w = max(am.sbytes.shape[1], bm.sbytes.shape[1])
        sb = torch.where(mask[:, None], _pad_width(am.sbytes, w),
                         _pad_width(bm.sbytes, w))
        valid = _merge_valid(mask, am, bm, n)
        return CV(t=T.option(T.STR) if valid is not None else T.STR,
                  sbytes=sb, slen=torch.where(mask, am.slen, bm.slen),
                  valid=valid)
    if at in (T.BOOL, T.I64, T.F64) and bt in (T.BOOL, T.I64, T.F64):
        out_t = T.super_type(at, bt)
        dt = dtype_for(out_t)
        data = torch.where(mask, am.data.to(dt), bm.data.to(dt))
        valid = _merge_valid(mask, am, bm, n)
        return CV(t=T.option(out_t) if valid is not None else out_t,
                  data=data, valid=valid)
    raise NotCompilable(f"cannot merge {a.t} and {b.t}")


def _merge_valid(mask: torch.Tensor, am: CV, bm: CV, n: int):
    if am.valid is None and bm.valid is None:
        return None
    ones = torch.ones(n, dtype=torch.bool, device=mask.device)
    av = ones if am.valid is None else am.valid
    bv = ones if bm.valid is None else bm.valid
    return torch.where(mask, av, bv)


I64_MIN = -(1 << 63)


def _i64_wrapped(op: ast.operator, a: torch.Tensor, b: torch.Tensor,
                 r: torch.Tensor) -> torch.Tensor:
    """Rows where r, the int64 result of `a op b` (+, - or *), wrapped."""
    if isinstance(op, ast.Add):
        return ((a ^ r) & (b ^ r)) < 0
    if isinstance(op, ast.Sub):
        return ((a ^ b) & (a ^ r)) < 0
    # a product that did not wrap divides back to b exactly; with a == -1
    # it wraps only at b == -2**63, whose quotient would itself wrap
    neg1 = a == -1
    safe = torch.where((a == 0) | neg1, torch.ones_like(a), a)
    back = torch.div(r, safe, rounding_mode="trunc")
    return torch.where(neg1, b == I64_MIN, (a != 0) & (back != b))


def _const_binop(op: ast.operator, a, b):
    table = {
        ast.Add: _op.add, ast.Sub: _op.sub, ast.Mult: _op.mul,
        ast.Div: _op.truediv, ast.FloorDiv: _op.floordiv, ast.Mod: _op.mod,
    }
    fn = table.get(type(op))
    if fn is None:
        raise NotCompilable(f"const op {type(op).__name__}")
    return fn(a, b)
