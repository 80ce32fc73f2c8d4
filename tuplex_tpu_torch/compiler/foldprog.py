"""An aggregate UDF as row terms and a register program (counterpart of
the reference package's one-row trace, `tuplex_tpu/plan/aggregates.py:428`
`ScanFold._trace_row`).

`aggregate(acc, row)` is split in two:

  * row terms: the maximal subexpressions that read the row and never the
    accumulator, and the locals assigned once from them at the top of a
    function. The emitter evaluates each over the whole batch under an
    error context of its own (plan/physical.py `eval_row_terms`). A term's
    error code is deferred: it counts only for a row whose program reaches
    the term, which keeps `and`/`or`, conditional expressions and `if`
    arms whose test reads the accumulator exact;
  * the recurrence: the rest, lowered once into a short program of
    (op, dst, a, b) instructions over dynamically typed registers, in
    CPython's order of evaluation, with forward jumps for the branches
    (the ABI is ops/segfold.py's). ops/segfold.py decodes it once into
    operands named by their source, and `csrc/seg_fold.cu` interprets the
    decoded form; the same kernel serves every UDF.

Terms stop at conditional expressions, `and`/`or` and
`min`/`max`/`abs`/`bool`: the program evaluates those with Python's
short-circuit and keeps each arm's own type (the emitter's branch merge
would unify an int arm and a float arm into floats). A chained
comparison over the row alone is a term: the emitter evaluates all of its
comparisons, where Python stops at the first that fails, so a row on
which it raised anything is handed to the interpreter (`Term.eager`).

Outside this subset `lower_fold` raises NotCompilable and the fold runs
on the interpreter: an accumulator that is not a number or a flat tuple of
numbers, `**`, bitwise operators, `is`/`in` on the accumulator, method
calls and `math.*` on it (CUDA's libm is not CPython's), calls of the
UDF's own helper functions, loops, comprehensions, a local read where it
may be unassigned, and a program beyond the kernel once decoded (more
than 32 row terms, or so many branches in a row that the paths, each
decoded apart, outgrow the kernel's shared memory).
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Optional

import torch

from ..core.errors import NotCompilable
from ..ops import segfold as S

_BINOPS = {ast.Add: S.ADD, ast.Sub: S.SUB, ast.Mult: S.MUL, ast.Div: S.DIV,
           ast.FloorDiv: S.FLOORDIV, ast.Mod: S.MOD}
_CMPOPS = {ast.Lt: S.LT, ast.LtE: S.LE, ast.Gt: S.GT, ast.GtE: S.GE,
           ast.Eq: S.EQ, ast.NotEq: S.NE}
_UNOPS = {ast.USub: S.NEG, ast.UAdd: S.POS, ast.Not: S.NOT}
# builtins the program evaluates (the emitter has none of the first four)
_PROG_BUILTINS = {"min": S.MIN, "max": S.MAX, "abs": S.ABS, "bool": S.BOOL,
                  "int": S.INT, "float": S.FLOAT}


@dataclass
class Term:
    """A row term: `expr` over the row parameter and earlier row locals;
    `local` names the row local it defines, if any; `loaded` says the
    program reads its value (else it only raises the term's code);
    `eager` says the emitter evaluates more of it than Python would (a
    chained comparison): a row where it raised needs the interpreter."""
    expr: ast.expr
    local: Optional[str] = None
    loaded: bool = False
    eager: bool = False


@dataclass
class FoldProgram:
    code: torch.Tensor           # int32 [n, 4]
    consts: torch.Tensor         # int64 [k, 2]: tag, payload
    terms: list[Term]
    n_leaves: int
    row_param: str
    globals: dict = field(default_factory=dict)
    _decoded: Optional[S.Decoded] = field(default=None, repr=False)

    def __len__(self) -> int:
        return self.code.shape[0]


def _body(tree) -> list[ast.stmt]:
    if isinstance(tree, ast.Lambda):
        return [ast.Return(value=tree.body)]
    if isinstance(tree, ast.FunctionDef):
        return [s for s in tree.body
                if not (isinstance(s, ast.Expr)
                        and isinstance(s.value, ast.Constant)
                        and isinstance(s.value.value, str))]
    raise NotCompilable(f"UDF node {type(tree).__name__}")


def _read_names(node: ast.AST) -> set:
    """Names a node reads as values (a called name is not one)."""
    called = {id(n.func) for n in ast.walk(node) if isinstance(n, ast.Call)}
    return {n.id for n in ast.walk(node)
            if isinstance(n, ast.Name) and id(n) not in called}


def _assign_counts(stmts: list[ast.stmt]) -> dict:
    """name -> how many times `stmts` assign it, anywhere; a tuple target
    or an augmented assignment counts twice (such a name is never a row
    local)."""
    out: dict = {}

    def add(t, n: int):
        if isinstance(t, ast.Name):
            out[t.id] = out.get(t.id, 0) + n
        elif isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                add(e, 2)
        elif isinstance(t, ast.Starred):
            add(t.value, 2)

    for s in stmts:
        for n in ast.walk(s):
            if isinstance(n, ast.Assign):
                for t in n.targets:
                    add(t, 1)
            elif isinstance(n, (ast.AugAssign, ast.AnnAssign)):
                add(n.target, 2)
            elif isinstance(n, ast.NamedExpr):
                raise NotCompilable("assignment expression")
    return out


class _Lowering:
    def __init__(self, udf, n_leaves: int, scalar: bool):
        tree = udf.tree
        params = [a.arg for a in tree.args.args] \
            if isinstance(tree, (ast.Lambda, ast.FunctionDef)) else []
        if len(params) != 2 or tree.args.vararg or tree.args.kwarg or \
                tree.args.kwonlyargs or tree.args.defaults:
            raise NotCompilable("aggregate UDF must take (acc, row)")
        self.acc_p, self.row_p = params
        self.globals = udf.globals
        self.n_leaves = n_leaves
        self.scalar = scalar
        self.code: list[list[int]] = []
        self.consts: list[tuple[int, int]] = []
        self.terms: list[Term] = []
        self.n_regs = 0
        self.stmts = _body(tree)
        counts = _assign_counts(self.stmts)
        if self.row_p in counts:
            raise NotCompilable("the row parameter is reassigned")
        self.acc_assigned = self.acc_p in counts
        self.local_names = set(counts)
        # dynamic names (the accumulator, locals that may change per path)
        # live in registers; a local assigned once, at the top, from a
        # hoistable expression is a row local, evaluated as a term
        self.dynamic = {self.acc_p} | self.local_names
        self.row_locals: dict[str, int] = {}      # name -> term index
        for s in self.stmts:
            if isinstance(s, ast.Assign) and len(s.targets) == 1 and \
                    isinstance(s.targets[0], ast.Name) and \
                    counts[s.targets[0].id] == 1 and \
                    s.targets[0].id != self.acc_p:
                name = s.targets[0].id
                self.dynamic.discard(name)
                if self._hoistable(s.value):
                    self.row_locals[name] = -1    # its term, once lowered
                else:
                    self.dynamic.add(name)
        self.binding: dict[str, list[int]] = {}   # dynamic name -> regs
        self.tuple_local: set = set()
        self.assigned: set = set()                # definitely assigned
        self.returns: list[int] = []

    # -- registers, constants, instructions -------------------------------
    def reg(self) -> int:
        self.n_regs += 1
        if self.n_regs > S.MAX_REGS:
            raise NotCompilable("fold program needs too many registers")
        return self.n_regs - 1

    def emit(self, op: int, dst: int = 0, a: int = 0, b: int = 0) -> int:
        self.code.append([op, dst, a, b])
        return len(self.code) - 1

    def patch(self, at: int) -> None:
        """Point the jump at `at` to the next instruction."""
        self.code[at][1] = len(self.code)

    def const(self, v) -> int:
        if isinstance(v, (bool, int, float)):
            try:
                k = S.pack_value(v)
            except ValueError:
                raise NotCompilable("constant beyond int64") from None
            self.consts.append(k)
            r = self.reg()
            self.emit(S.CONST, r, len(self.consts) - 1)
            return r
        raise NotCompilable(f"constant {type(v).__name__} in the fold")

    # -- classification -----------------------------------------------------
    def _program_only(self, node: ast.AST) -> bool:
        for n in ast.walk(node):
            if isinstance(n, (ast.IfExp, ast.BoolOp)):
                return True
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Name) and (
                    n.func.id in self.globals or
                    n.func.id in ("min", "max", "abs", "bool")):
                # a helper's branches would merge an int and a float arm
                return True
        return False

    def _row_dependent(self, node: ast.AST) -> bool:
        names = _read_names(node)
        return self.row_p in names or bool(names & set(self.row_locals))

    def _hoistable(self, node: ast.expr) -> bool:
        return self._row_dependent(node) and \
            not (_read_names(node) & self.dynamic) and \
            not self._program_only(node)

    def _term(self, node: ast.expr, local: Optional[str] = None) -> int:
        unbound = (_read_names(node) & self.local_names) - self.assigned
        if unbound:
            raise NotCompilable(f"{sorted(unbound)[0]} read before it is "
                                f"assigned")
        eager = any(isinstance(n, ast.Compare) and len(n.ops) > 1
                    for n in ast.walk(node))
        self.terms.append(Term(node, local, eager=eager))
        return len(self.terms) - 1

    def _load_term(self, t: int) -> int:
        self.terms[t].loaded = True
        r = self.reg()
        self.emit(S.TERM, r, t)
        return r

    # -- expressions --------------------------------------------------------
    def scalar_expr(self, node: ast.expr) -> int:
        """Lower `node` to the register that holds its value."""
        if isinstance(node, ast.Name) and node.id in self.row_locals:
            if node.id not in self.assigned:
                raise NotCompilable(f"{node.id} read before it is assigned")
            return self._load_term(self.row_locals[node.id])
        if self._hoistable(node):
            return self._load_term(self._term(node))
        m = getattr(self, "ex_" + type(node).__name__, None)
        if m is None:
            raise NotCompilable(f"{type(node).__name__} in the fold's "
                                f"recurrence")
        return m(node)

    def ex_Constant(self, node: ast.Constant) -> int:
        return self.const(node.value)

    def _acc_leaves(self) -> list[int]:
        regs = []
        for i in range(self.n_leaves):
            r = self.reg()
            self.emit(S.ACC, r, i)
            regs.append(r)
        return regs

    def _is_tuple_name(self, name: str) -> bool:
        if name == self.acc_p and name not in self.binding:
            return not self.scalar
        return name in self.tuple_local

    def ex_Name(self, node: ast.Name) -> int:
        if node.id in self.dynamic:
            if self._is_tuple_name(node.id):
                raise NotCompilable("a tuple where a number is needed")
            return self.tuple_expr(node, None)[0]
        if node.id in self.local_names:
            raise NotCompilable(f"{node.id} read before it is assigned")
        if node.id in self.globals:
            return self.const(self.globals[node.id])
        raise NotCompilable(f"name {node.id!r} in the fold")

    def ex_Subscript(self, node: ast.Subscript) -> int:
        base = node.value
        if not isinstance(base, ast.Name) or base.id not in self.dynamic \
                or not self._is_tuple_name(base.id):
            raise NotCompilable("subscript in the fold's recurrence")
        idx = node.slice
        if isinstance(idx, ast.UnaryOp) and isinstance(idx.op, ast.USub) \
                and isinstance(idx.operand, ast.Constant):
            i = -idx.operand.value
        elif isinstance(idx, ast.Constant):
            i = idx.value
        else:
            raise NotCompilable("dynamic accumulator index")
        n = self.n_leaves if base.id == self.acc_p and \
            base.id not in self.binding else len(self.binding[base.id])
        if type(i) is not int or not -n <= i < n:
            raise NotCompilable("accumulator index out of range")
        if base.id == self.acc_p and base.id not in self.binding:
            r = self.reg()
            self.emit(S.ACC, r, i % n)
            return r
        return self.tuple_expr(base, None)[i]

    def ex_BinOp(self, node: ast.BinOp) -> int:
        op = _BINOPS.get(type(node.op))
        if op is None:
            raise NotCompilable(f"operator {type(node.op).__name__} in the "
                                f"fold")
        a = self.scalar_expr(node.left)
        b = self.scalar_expr(node.right)
        r = self.reg()
        self.emit(op, r, a, b)
        return r

    def ex_UnaryOp(self, node: ast.UnaryOp) -> int:
        op = _UNOPS.get(type(node.op))
        if op is None:
            raise NotCompilable("unary operator in the fold")
        a = self.scalar_expr(node.operand)
        r = self.reg()
        self.emit(op, r, a)
        return r

    def ex_Compare(self, node: ast.Compare) -> int:
        """a < b < c: b is evaluated once, c only when a < b holds."""
        r = self.reg()
        left = self.scalar_expr(node.left)
        jumps = []
        for i, (op, comp) in enumerate(zip(node.ops, node.comparators)):
            cop = _CMPOPS.get(type(op))
            if cop is None:
                raise NotCompilable(f"comparison {type(op).__name__} in "
                                    f"the fold")
            right = self.scalar_expr(comp)
            self.emit(cop, r, left, right)
            if i < len(node.ops) - 1:
                jumps.append(self.emit(S.JZ, 0, r))
            left = right
        for j in jumps:
            self.patch(j)
        return r

    def ex_BoolOp(self, node: ast.BoolOp) -> int:
        """The first operand that decides, else the last: later operands
        run only when the earlier ones did not decide."""
        r = self.reg()
        jump = S.JZ if isinstance(node.op, ast.And) else S.JNZ
        jumps = []
        for i, v in enumerate(node.values):
            self.emit(S.MOV, r, self.scalar_expr(v))
            if i < len(node.values) - 1:
                jumps.append(self.emit(jump, 0, r))
        for j in jumps:
            self.patch(j)
        return r

    def ex_IfExp(self, node: ast.IfExp) -> int:
        r = self.reg()
        c = self.scalar_expr(node.test)
        j_else = self.emit(S.JZ, 0, c)
        self.emit(S.MOV, r, self.scalar_expr(node.body))
        j_end = self.emit(S.JMP)
        self.patch(j_else)
        self.emit(S.MOV, r, self.scalar_expr(node.orelse))
        self.patch(j_end)
        return r

    def ex_Call(self, node: ast.Call) -> int:
        f = node.func
        if not isinstance(f, ast.Name) or f.id not in _PROG_BUILTINS or \
                f.id in self.globals or f.id in self.dynamic or \
                f.id in self.row_locals or node.keywords or \
                any(isinstance(a, ast.Starred) for a in node.args):
            raise NotCompilable("call in the fold's recurrence")
        op = _PROG_BUILTINS[f.id]
        args = [self.scalar_expr(a) for a in node.args]
        r = self.reg()
        if op in (S.MIN, S.MAX):
            # Python evaluates every argument, then keeps the first of
            # equal or unordered ones
            if len(args) < 2:
                raise NotCompilable(f"{f.id}() of one argument")
            self.emit(S.MOV, r, args[0])
            for a in args[1:]:
                self.emit(op, r, r, a)
        else:
            if len(args) != 1:
                raise NotCompilable(f"{f.id}() arity")
            self.emit(op, r, args[0])
        return r

    def tuple_expr(self, node: ast.expr, arity: Optional[int]):
        """Registers of a tuple-valued (or dynamic-name) expression, or
        None when it is not one. `arity` None: any."""
        if isinstance(node, ast.Name) and node.id in self.dynamic:
            if node.id == self.acc_p and node.id not in self.binding:
                regs = self._acc_leaves()
            else:
                if node.id not in self.assigned or \
                        node.id not in self.binding:
                    raise NotCompilable(f"{node.id} read where it may be "
                                        f"unassigned")
                regs = self.binding[node.id]
        elif isinstance(node, ast.Tuple):
            regs = [self.scalar_expr(e) for e in node.elts]
        elif isinstance(node, ast.IfExp) and self._tuple_shaped(node.body):
            c = self.scalar_expr(node.test)
            j_else = self.emit(S.JZ, 0, c)
            a = self.tuple_expr(node.body, arity)
            out = [self.reg() for _ in a]
            for d, s in zip(out, a):
                self.emit(S.MOV, d, s)
            j_end = self.emit(S.JMP)
            self.patch(j_else)
            b = self.tuple_expr(node.orelse, len(a))
            if b is None or len(b) != len(a):
                raise NotCompilable("conditional tuples of two shapes")
            for d, s in zip(out, b):
                self.emit(S.MOV, d, s)
            self.patch(j_end)
            regs = out
        else:
            return None
        if arity is not None and len(regs) != arity:
            raise NotCompilable("a tuple of another arity")
        return regs

    def _tuple_shaped(self, node: ast.expr) -> bool:
        if isinstance(node, ast.Tuple):
            return True
        if isinstance(node, ast.Name):
            return node.id in self.dynamic and self._is_tuple_name(node.id)
        if isinstance(node, ast.IfExp):
            return self._tuple_shaped(node.body)
        return False

    # -- statements ---------------------------------------------------------
    def block(self, stmts: list[ast.stmt]) -> bool:
        """Lower statements; True when every path through them returned."""
        for s in stmts:
            m = getattr(self, "st_" + type(s).__name__, None)
            if m is None:
                raise NotCompilable(f"statement {type(s).__name__} in the "
                                    f"fold")
            if m(s):
                return True
        return False

    def st_Return(self, node: ast.Return) -> bool:
        if node.value is None:
            self.emit(S.STOP)        # the accumulator would become None
            return True
        if self.scalar:
            if self._tuple_shaped(node.value):
                raise NotCompilable("a tuple returned for a number")
            outs = [self.scalar_expr(node.value)]
        else:
            outs = self.tuple_expr(node.value, self.n_leaves)
            if outs is None:
                raise NotCompilable("the fold must return a tuple of "
                                    f"{self.n_leaves}")
        for i, r in enumerate(outs):
            self.emit(S.OUT, i, r)
        self.returns.append(self.emit(S.JMP))
        return True

    def _bind(self, name: str, regs: list[int], is_tuple: bool) -> None:
        if name in self.binding:
            if len(self.binding[name]) != len(regs) or \
                    (name in self.tuple_local) != is_tuple:
                raise NotCompilable(f"{name} changes shape")
        else:
            self.binding[name] = [self.reg() for _ in regs]
            if is_tuple:
                self.tuple_local.add(name)
        for d, s in zip(self.binding[name], regs):
            self.emit(S.MOV, d, s)
        self.assigned.add(name)

    def st_Assign(self, node: ast.Assign) -> bool:
        if len(node.targets) != 1:
            raise NotCompilable("chained assignment")
        tgt = node.targets[0]
        if isinstance(tgt, ast.Name) and tgt.id in self.row_locals:
            t = self._term(node.value, tgt.id)
            self.row_locals[tgt.id] = t
            self.emit(S.TERM, -1, t)       # its errors raise here
            self.assigned.add(tgt.id)
            return False
        if isinstance(tgt, ast.Name):
            if self._tuple_shaped(node.value):
                self._bind(tgt.id, self.tuple_expr(node.value, None), True)
            else:
                self._bind(tgt.id, [self.scalar_expr(node.value)], False)
            return False
        if isinstance(tgt, (ast.Tuple, ast.List)) and \
                all(isinstance(e, ast.Name) for e in tgt.elts):
            regs = self.tuple_expr(node.value, len(tgt.elts))
            if regs is None:
                raise NotCompilable("unpacking a value of unknown shape")
            for e, r in zip(tgt.elts, regs):
                if e.id in self.row_locals:
                    raise NotCompilable("unpacking into a row local")
                self._bind(e.id, [r], False)
            return False
        raise NotCompilable(f"assignment to {type(tgt).__name__}")

    def st_AugAssign(self, node: ast.AugAssign) -> bool:
        tgt = node.target
        op = _BINOPS.get(type(node.op))
        if not isinstance(tgt, ast.Name) or op is None or \
                tgt.id in self.tuple_local:
            raise NotCompilable("augmented assignment in the fold")
        a = self.scalar_expr(ast.Name(id=tgt.id, ctx=ast.Load()))
        b = self.scalar_expr(node.value)
        r = self.reg()
        self.emit(op, r, a, b)
        self._bind(tgt.id, [r], False)
        return False

    def st_If(self, node: ast.If) -> bool:
        c = self.scalar_expr(node.test)
        j_else = self.emit(S.JZ, 0, c)
        before = set(self.assigned)
        body_returns = self.block(node.body)
        after_body = self.assigned
        j_end = None if body_returns else self.emit(S.JMP)
        self.patch(j_else)
        self.assigned = set(before)
        else_returns = self.block(node.orelse)
        after_else = self.assigned
        if j_end is not None:
            self.patch(j_end)
        if body_returns and else_returns:
            return True
        if body_returns:
            self.assigned = after_else
        elif else_returns:
            self.assigned = after_body
        else:
            self.assigned = after_body & after_else
        return False

    def st_Pass(self, node: ast.Pass) -> bool:
        return False

    def st_Expr(self, node: ast.Expr) -> bool:
        self.scalar_expr(node.value)     # for its errors
        return False

    # -- the whole UDF ------------------------------------------------------
    def lower(self) -> FoldProgram:
        if self.acc_assigned:
            # the accumulator is reassigned: it starts in registers
            self._bind(self.acc_p, self._acc_leaves(), not self.scalar)
        if not self.block(self.stmts):
            self.emit(S.STOP)       # falling off the end returns None
        elif self.returns and self.returns[-1] == len(self.code) - 1:
            self.code.pop()         # the last return's jump to the end
            self.returns.pop()
        end = len(self.code)
        for j in self.returns:
            self.code[j][1] = end
        if not self.code:
            raise NotCompilable("empty fold")
        if len(self.code) > S.MAX_CODE or len(self.consts) > S.MAX_CONSTS:
            raise NotCompilable("fold program too long")
        code = torch.tensor(self.code, dtype=torch.int32)
        consts = torch.tensor(self.consts, dtype=torch.int64) \
            if self.consts else torch.zeros((0, 2), dtype=torch.int64)
        prog = FoldProgram(code, consts.reshape(-1, 2), self.terms,
                           self.n_leaves, self.row_p, self.globals)
        S.decoded(prog, self.n_leaves)    # beyond the kernel: NotCompilable
        return prog


def lower_fold(udf, n_leaves: int, scalar: bool) -> FoldProgram:
    """The row terms and the register program of `aggregate(acc, row)`
    for an accumulator of `n_leaves` numbers (a bare number when `scalar`).
    Raises NotCompilable outside the subset the module docstring names."""
    if udf.tree is None or udf.source == "":
        raise NotCompilable("no source for the aggregate UDF")
    if not 1 <= n_leaves <= S.MAX_LEAVES:
        raise NotCompilable(f"accumulator of {n_leaves} leaves")
    return _Lowering(udf, n_leaves, scalar).lower()
