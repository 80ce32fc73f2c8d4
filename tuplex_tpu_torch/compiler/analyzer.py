"""Plan-time UDF analysis: exception sites and the constructs that keep a
UDF off the compiled path (counterpart of the part of
`tuplex_tpu/compiler/analyzer.py` that the resolve plan and the
interpreter's source tier read).

One AST pass per UDF gives a `UDFReport`:

  * fallback findings: constructs the emitter never compiles (generators,
    try/except, nested defs, imports, I/O and dynamic-code calls, global
    or closure mutation).
  * the exception-site inventory: AST nodes mapped to the ExceptionCode
    the compiled path can raise there (division -> ZERODIVISIONERROR,
    `int(s)` -> VALUEERROR, a method on a possibly-None value (a
    match's `.group` included) -> ATTRIBUTEERROR, `re.search` ->
    TYPEERROR and PYTHON_FALLBACK (the regex engine's suspect rows),
    arithmetic and string indexing -> NORMALCASEVIOLATION, ...), so the
    physical plan knows a stage's possible codes without sampling
    (`TransformStage.possible_exception_codes`). It over-approximates: a
    code it misses still routes its row, under `ResolveBuffers.other`.
  * `mutates_globals`: the UDF writes a global or a closure cell, so the
    source tier must call the live function, never a rebuilt copy.
  * `deterministic`: the UDF calls nothing of `random`, `time`,
    `datetime`, `uuid` or `secrets`; a cache over a chain that does pins
    one outcome (`chain_deterministic`, plan/cacheop.py).

The planner reads the first fallback finding as the reason it routes an
operator to the interpreter at plan time (`routing_finding`,
plan/physical.py `op_compiles` and `segment_stage`); `STATS` counts
those operators (`plan_fallback_ops`, `Metrics.planFallbackOps`). The
reference's lint and its marking of findings inside `if` arms are not
ported (the port does not speculate on branches).
"""

from __future__ import annotations

import ast
import dataclasses
import types
from typing import Optional

from ..core.errors import ExceptionCode, code_for_name
from ..plan.optimizer import _all_params
from ..utils.lru import LruDict

# calls that compile to nothing sensible on the device
_DYNAMIC_CALLS = {"eval", "exec", "compile", "__import__", "globals",
                  "locals", "vars", "delattr", "setattr"}
_IO_CALLS = {"open", "input", "print", "breakpoint"}
_IO_MODULES = {"os", "sys", "io", "shutil", "subprocess", "socket",
               "urllib", "requests", "pathlib"}
_NONDET_MODULES = {"random", "time", "datetime", "uuid", "secrets"}

_FINDINGS_CAP = 64


@dataclasses.dataclass(frozen=True)
class Finding:
    kind: str                 # "fallback" | "exception" | "impure"
    reason: str               # one line
    lineno: int               # relative to the UDF source
    col: int
    code: Optional[ExceptionCode] = None   # exception-site code


@dataclasses.dataclass
class UDFReport:
    name: str
    params: tuple
    filename: str = "<udf>"
    line_base: int = 1        # the file line of the UDF's first line
    findings: list = dataclasses.field(default_factory=list)
    mutates_globals: bool = False
    deterministic: bool = True

    @property
    def fallback_findings(self) -> list:
        return [f for f in self.findings if f.kind == "fallback"]

    @property
    def exception_findings(self) -> list:
        return [f for f in self.findings if f.kind == "exception"]

    @property
    def must_fallback(self) -> bool:
        """Whether any construct the emitter never compiles appears."""
        return bool(self.fallback_findings)

    def routing_finding(self) -> Optional[Finding]:
        """The fallback finding that routes the UDF to the interpreter at
        plan time: the first (the port marks no finding conditional, so
        any routes it, and the reference's `must_fallback_now` is
        `must_fallback`)."""
        return next(iter(self.fallback_findings), None)

    def exception_codes(self) -> set:
        return {f.code for f in self.exception_findings if f.code is not None}

    def loc(self, f: Finding) -> str:
        return f"{self.filename}:{self.line_base + f.lineno - 1}"


class _UdfVisitor(ast.NodeVisitor):
    """One walk over a UDF body. `locals_` over-approximates the names
    bound in the body, so reads of globals are under-reported, never
    over-reported."""

    def __init__(self, report: UDFReport, self_name: str,
                 module_names: dict, locals_: set):
        self.r = report
        self.self_name = self_name
        self.module_names = module_names
        self.locals = locals_

    def _add(self, kind: str, node: ast.AST, reason: str,
             code: Optional[ExceptionCode] = None) -> None:
        if len(self.r.findings) >= _FINDINGS_CAP:
            return
        self.r.findings.append(Finding(
            kind=kind, reason=reason, lineno=getattr(node, "lineno", 1),
            col=getattr(node, "col_offset", 0), code=code))

    def _fallback(self, node, reason):
        self._add("fallback", node, reason)

    def _exc(self, node, reason, code):
        self._add("exception", node, reason, code=code)

    # -- constructs the emitter never compiles ------------------------------
    def visit_Yield(self, node) -> None:
        self._fallback(node, "generator (yield)")
        self.generic_visit(node)

    def visit_YieldFrom(self, node) -> None:
        self._fallback(node, "generator (yield from)")
        self.generic_visit(node)

    def visit_Await(self, node) -> None:
        self._fallback(node, "async construct (await)")
        self.generic_visit(node)

    def visit_Try(self, node) -> None:
        self._fallback(node, "try/except block")
        self.generic_visit(node)

    visit_TryStar = visit_Try

    def visit_With(self, node) -> None:
        self._fallback(node, "with block")
        self.generic_visit(node)

    def visit_AsyncWith(self, node) -> None:
        self._fallback(node, "async with block")

    def visit_AsyncFor(self, node) -> None:
        self._fallback(node, "async for loop")

    def visit_Import(self, node) -> None:
        self._fallback(node, "import inside UDF body")

    visit_ImportFrom = visit_Import

    def visit_Delete(self, node) -> None:
        self._fallback(node, "del statement")

    def visit_Match(self, node) -> None:
        self._fallback(node, "match statement")
        self.generic_visit(node)

    def visit_Global(self, node: ast.Global) -> None:
        self._fallback(node, f"global mutation ({', '.join(node.names)})")
        self.r.mutates_globals = True

    def visit_Nonlocal(self, node: ast.Nonlocal) -> None:
        self._fallback(node,
                       f"closure-cell mutation ({', '.join(node.names)})")
        self.r.mutates_globals = True

    def visit_FunctionDef(self, node) -> None:
        self._fallback(node, f"nested function def {node.name!r}")

    def visit_AsyncFunctionDef(self, node) -> None:
        self._fallback(node, "async function def")

    def visit_ClassDef(self, node) -> None:
        self._fallback(node, f"class def {node.name!r} inside UDF")

    def visit_Lambda(self, node: ast.Lambda) -> None:
        # its body is a scope of its own: not descended into
        self._fallback(node, "nested lambda")

    def visit_SetComp(self, node) -> None:
        self._fallback(node, "set comprehension")

    def visit_While(self, node: ast.While) -> None:
        test = node.test
        if isinstance(test, ast.Constant) and bool(test.value) \
                and not _has_own_break(node):
            self._fallback(node, "unbounded while (constant-true, no break)")
        else:
            self._exc(node, "while loop past the unroll cap interprets "
                      "the row", ExceptionCode.LOOPCAPEXCEEDED)
        self.generic_visit(node)

    # -- writes to captured structures --------------------------------------
    def _check_target(self, tgt: ast.AST) -> None:
        if isinstance(tgt, (ast.Tuple, ast.List)):
            for el in tgt.elts:
                self._check_target(el)
            return
        if isinstance(tgt, ast.Starred):
            self._check_target(tgt.value)
            return
        root = tgt
        while isinstance(root, (ast.Subscript, ast.Attribute)):
            root = root.value
        if isinstance(root, ast.Name) and root is not tgt \
                and root.id not in self.locals:
            self._fallback(tgt, f"mutates captured global {root.id!r}")
            self.r.mutates_globals = True

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            self._check_target(t)
        self.generic_visit(node)

    def visit_AugAssign(self, node) -> None:
        self._check_target(node.target)
        self.generic_visit(node)

    visit_AnnAssign = visit_AugAssign

    # -- calls --------------------------------------------------------------
    def visit_Call(self, node: ast.Call) -> None:
        fn = node.func
        if isinstance(fn, ast.Name):
            n = fn.id
            if n in _DYNAMIC_CALLS:
                self._fallback(node, f"dynamic code/introspection ({n})")
            elif n in _IO_CALLS:
                self._fallback(node, f"I/O call ({n})")
            elif n == self.self_name and n:
                self._fallback(node, f"recursive call to {n!r}")
            elif n in ("int", "float") and node.args:
                a = node.args[0]
                if not (isinstance(a, ast.Constant)
                        and isinstance(a.value, (int, float))):
                    self._exc(node, f"{n}() parse of a non-constant",
                              ExceptionCode.VALUEERROR)
                    self._guard(node, f"{n}() of a value it leaves to "
                                "CPython")
            elif n == "len":
                self._guard(node, "len() of a non-ASCII string")
        if isinstance(fn, ast.Attribute):
            self._guard(node, f".{fn.attr}() on a non-ASCII string")
        if isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Name) \
                and self.module_names.get(fn.value.id) == "re" \
                and fn.attr in ("search", "match"):
            self._exc(node, f"re.{fn.attr} of a possibly-None string",
                      ExceptionCode.TYPEERROR)
            self._exc(node, f"re.{fn.attr} rows the compiled regex engine "
                      "leaves to the interpreter",
                      ExceptionCode.PYTHON_FALLBACK)
        if isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Name):
            # by the module's real name, not its local binding
            real = self.module_names.get(fn.value.id)
            if real in _IO_MODULES:
                self._fallback(node, f"I/O module call "
                               f"({fn.value.id}.{fn.attr})")
            elif real in _NONDET_MODULES:
                self._add("impure", node, f"nondeterministic call "
                          f"{fn.value.id}.{fn.attr}()")
                self.r.deterministic = False
        self.generic_visit(node)

    # -- the exception-site inventory ---------------------------------------
    def visit_Subscript(self, node: ast.Subscript) -> None:
        key = node.slice
        if not (isinstance(key, ast.Constant) and isinstance(key.value, str)):
            self._guard(node, "string index or slice of a non-ASCII row")
        if isinstance(node.ctx, ast.Load) and \
                not isinstance(node.slice, ast.Slice):
            key = node.slice
            if isinstance(key, ast.Constant) and isinstance(key.value, str):
                self._exc(node, f"subscript [{key.value!r}]",
                          ExceptionCode.KEYERROR)
            else:
                self._exc(node, "indexed subscript",
                          ExceptionCode.INDEXERROR)
        self.generic_visit(node)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if isinstance(node.ctx, ast.Load):
            base = node.value
            if not (isinstance(base, ast.Name)
                    and base.id in self.module_names):
                # the port's emitter codes a method on None as CPython
                # does (the reference's inventory says NULLERROR here)
                self._exc(node, f"attribute/method .{node.attr} on a "
                          "possibly-None (Option) value",
                          ExceptionCode.ATTRIBUTEERROR)
        self.generic_visit(node)

    def _guard(self, node, reason: str) -> None:
        """A site where the compiled path's own guard can send a row to
        the interpreter (NORMALCASEVIOLATION): int64 overflow, non-ASCII
        rows in byte-indexed string ops, numbers the parsers leave to
        CPython. The reference's inventory does not list these."""
        self._exc(node, reason, ExceptionCode.NORMALCASEVIOLATION)

    def visit_UnaryOp(self, node: ast.UnaryOp) -> None:
        if isinstance(node.op, ast.USub):
            self._guard(node, "negation past int64")
        self.generic_visit(node)

    def visit_BinOp(self, node: ast.BinOp) -> None:
        if isinstance(node.op, (ast.Add, ast.Sub, ast.Mult, ast.Div,
                                ast.FloorDiv, ast.Mod)):
            self._guard(node, "arithmetic past int64 or 2**53")
        if isinstance(node.op, (ast.Div, ast.FloorDiv, ast.Mod)):
            right_nonzero_const = (isinstance(node.right, ast.Constant)
                                   and isinstance(node.right.value,
                                                  (int, float))
                                   and node.right.value != 0)
            left_is_fmt = isinstance(node.op, ast.Mod) and (
                isinstance(node.left, ast.JoinedStr)
                or (isinstance(node.left, ast.Constant)
                    and isinstance(node.left.value, str)))
            if not right_nonzero_const and not left_is_fmt:
                opn = {ast.Div: "/", ast.FloorDiv: "//",
                       ast.Mod: "%"}[type(node.op)]
                self._exc(node, f"division ({opn})",
                          ExceptionCode.ZERODIVISIONERROR)
        self.generic_visit(node)

    def visit_Assert(self, node: ast.Assert) -> None:
        self._exc(node, "assert", ExceptionCode.ASSERTIONERROR)
        self.generic_visit(node)

    def visit_Raise(self, node: ast.Raise) -> None:
        exc = node.exc
        name = None
        if isinstance(exc, ast.Call) and isinstance(exc.func, ast.Name):
            name = exc.func.id
        elif isinstance(exc, ast.Name):
            name = exc.id
        code = code_for_name(name or "")
        self._exc(node, f"raise {name or '?'}",
                  code if code is not None else ExceptionCode.UNKNOWN)
        self.generic_visit(node)


def _has_own_break(loop: ast.AST) -> bool:
    """Whether the loop's body holds a break bound to this loop: a break in
    a nested loop's body belongs to that loop, one in its `else:` to this
    one."""
    stack = list(loop.body)
    while stack:
        n = stack.pop()
        if isinstance(n, ast.Break):
            return True
        if isinstance(n, (ast.While, ast.For, ast.AsyncFor)):
            stack.extend(n.orelse)
            continue
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda,
                          ast.ClassDef)):
            continue
        stack.extend(ast.iter_child_nodes(n))
    return False


def _bound_names(node: ast.AST) -> set:
    """The names bound inside a UDF body, over-approximated."""
    out: set = set()
    for n in ast.walk(node):
        if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store):
            out.add(n.id)
        elif isinstance(n, ast.NamedExpr) and isinstance(n.target, ast.Name):
            out.add(n.target.id)
        elif isinstance(n, ast.arg):
            out.add(n.arg)
    return out


def analyze_tree(node: ast.AST, name: str = "<udf>",
                 globals_map: Optional[dict] = None) -> UDFReport:
    """The report of one Lambda or FunctionDef node; `globals_map` holds
    the values its globals and closure cells captured."""
    globals_map = globals_map or {}
    module_names = {k: v.__name__.split(".")[0]
                    for k, v in globals_map.items()
                    if isinstance(v, types.ModuleType)}
    params = _all_params(node) if hasattr(node, "args") else ()
    rpt = UDFReport(name=name, params=params)
    body = node.body if isinstance(node, (ast.FunctionDef,
                                          ast.AsyncFunctionDef)) \
        else [node.body]
    locals_ = set(params)
    for s in body:
        locals_ |= _bound_names(s)
    v = _UdfVisitor(rpt, name, module_names, locals_)
    if isinstance(node, ast.AsyncFunctionDef):
        v._fallback(node, "async function def")
    elif isinstance(node, ast.FunctionDef):
        v._guard(node, "a path that falls off the end returns None")
    for s in body:
        v.visit(s)
    return rpt


# (code object, the globals' signature) -> UDFReport
_udf_memo: LruDict = LruDict(4096)


def _globals_sig(globs: dict) -> tuple:
    """What of the captured globals the analysis reads: which names are
    modules, and which modules."""
    return tuple(sorted(
        (k, v.__name__.split(".")[0]) for k, v in globs.items()
        if isinstance(v, types.ModuleType)))


def analyze_udf(udf) -> UDFReport:
    """The report of a reflected UDFSource, memoized per code object and
    globals' signature."""
    code = getattr(udf.func, "__code__", None)
    key = (code, _globals_sig(udf.globals)) if code is not None else None
    if key is not None and key in _udf_memo:
        return _udf_memo[key]
    if not udf.source:
        rpt = UDFReport(name=udf.name, params=())
        rpt.findings.append(Finding(
            kind="fallback", reason="no retrievable UDF source",
            lineno=1, col=0))
    else:
        rpt = analyze_tree(udf.tree, name=udf.name,
                           globals_map=udf.globals)
    if code is not None:
        rpt.filename, rpt.line_base = code.co_filename, code.co_firstlineno
    if key is not None:
        _udf_memo[key] = rpt
    return rpt


_UDF_ATTRS = ("udf", "combine_udf", "aggregate_udf")


def op_reports(op) -> list:
    """[(udf attribute name, UDFReport)] for every UDF an operator
    carries, memoized on the operator."""
    memo = getattr(op, "_az_reports", None)
    if memo is None:
        memo = op._az_reports = [(attr, analyze_udf(u))
                                 for attr in _UDF_ATTRS
                                 if (u := getattr(op, attr, None))
                                 is not None]
    return memo


def op_analysis(op) -> Optional[UDFReport]:
    """The report of an operator's fused UDF (`udf`), or None."""
    return next((rep for attr, rep in op_reports(op) if attr == "udf"),
                None)


def chain_deterministic(op) -> bool:
    """Whether every UDF upstream of `op`, `op`'s own included, is
    deterministic."""
    seen, stack = set(), [op]
    while stack:
        o = stack.pop()
        if id(o) in seen:
            continue
        seen.add(id(o))
        if not all(rep.deterministic for _, rep in op_reports(o)):
            return False
        stack.extend(o.parents)
    return True


#: plan_fallback_ops: operators the planner routed to the interpreter by
#: their fallback findings, without a probe of the emitter
STATS = {"plan_fallback_ops": 0}


def snapshot() -> dict:
    return dict(STATS)


def delta(snap: dict) -> dict:
    return {k: STATS[k] - snap.get(k, 0) for k in STATS}
