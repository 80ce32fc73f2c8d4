"""The anchored regex engine with capture groups (counterpart of
`tuplex_tpu/ops/regex.py`), as torch ops over [N, W] uint8 byte matrices.

An ANCHORED pattern (leading ^) in the supported subset compiles to a
list of whole-column steps:

  * literals, character classes (\\d \\s \\w, [..] sets, ranges and
    negation, '.')
  * greedy quantifiers ? * + {m} {m,n} of a single character or class
  * capturing groups, ^ and $ (which also matches before one trailing
    newline, as in Python)

Backtracking is one retreat level: where a greedy class run swallows a
following single-character literal (`(\\S*)\\s*"`, '"' being non-space),
the literal retreats to its LAST occurrence inside the run, the first
position CPython's backtracking tries. A row that dies where unexplored
alternatives may remain comes back `suspect`; the emitter sends it to the
interpreter. A greedy run whose follower is disjoint from its class is
rigid (no shorter run can help), so deaths behind it are exact no-matches.
The compiled path therefore never gives an answer CPython would not.
Patterns outside the subset raise NotCompilable.

`compile_regex` memoizes engines per pattern; `calls` counts `match` calls
(each is one sequence of torch launches, no hand-written kernel).
"""

from __future__ import annotations

import re as _pyre
from dataclasses import dataclass
from typing import Optional

import torch

from ..core.errors import NotCompilable
from ..runtime.torchcfg import I32

try:
    from re import _constants as _sc
    from re import _parser as _sre
except ImportError:  # pragma: no cover - older layout
    import sre_constants as _sc         # type: ignore
    import sre_parse as _sre            # type: ignore

_MAXREPEAT = _sc.MAXREPEAT
calls = 0


@dataclass
class _Step:
    kind: str                    # "lit" | "class" | "open" | "close" | "end"
    spec: tuple = ()             # class spec items
    min: int = 1
    max: Optional[int] = 1       # None = unbounded
    group: int = -1
    # retreat plan (set on single-character literal steps by analysis)
    retreat_from: int = -1       # index of the greedy step to retreat into
    retreat_min: int = 0         # that step's min (no retreat past it)
    retreat_groups: tuple = ()   # groups whose END moves with the retreat


def _category_spec(cat) -> tuple:
    name = str(cat).rsplit("_", 1)[-1].lower()
    table = {
        "digit": (("range", 48, 57),),
        "space": (("lit", 9), ("lit", 10), ("lit", 11), ("lit", 12),
                  ("lit", 13), ("lit", 32)),
        "word": (("range", 48, 57), ("range", 65, 90), ("range", 97, 122),
                 ("lit", 95)),
    }
    neg = "not_" in str(cat).lower()
    base = table.get(name)
    if base is None:
        raise NotCompilable(f"regex category {cat}")
    return ((("neg",),) if neg else ()) + base


def _in_spec(items) -> tuple:
    spec: list = []
    neg = False
    for op, av in items:
        opn = str(op)
        if opn.endswith("NEGATE"):
            neg = True
        elif opn.endswith("LITERAL"):
            spec.append(("lit", av))
        elif opn.endswith("RANGE"):
            spec.append(("range", av[0], av[1]))
        elif opn.endswith("CATEGORY"):
            sub = _category_spec(av)
            if sub and sub[0] == ("neg",):
                # negated category inside a set: only as the whole set
                if len(items) != 1:
                    raise NotCompilable("negated category in mixed set")
                return sub
            spec.extend(sub)
        else:
            raise NotCompilable(f"regex set item {op}")
    return (("neg",),) + tuple(spec) if neg else tuple(spec)


def _byte_in_spec(byte: int, spec: tuple) -> bool:
    neg = bool(spec) and spec[0] == ("neg",)
    items = spec[1:] if neg else spec
    hit = any((it[0] == "lit" and byte == it[1]) or
              (it[0] == "range" and it[1] <= byte <= it[2]) for it in items)
    return hit != neg


def _flatten(tree, steps: list) -> None:
    for op, av in tree:
        opn = str(op)
        if opn.endswith("NOT_LITERAL"):
            # NOT_LITERAL must match before the LITERAL suffix check
            steps.append(_Step("class", (("neg",), ("lit", av))))
        elif opn.endswith("LITERAL"):
            steps.append(_Step("lit", (("lit", av),)))
        elif opn.endswith("ANY"):
            steps.append(_Step("class", (("neg",), ("lit", 10))))  # '.'
        elif opn.endswith("IN"):
            steps.append(_Step("class", _in_spec(av)))
        elif opn.endswith("MAX_REPEAT"):
            mn, mx, item = av
            if len(item) != 1:
                raise NotCompilable("regex repeat of a sequence")
            iop, iav = item[0]
            iopn = str(iop)
            if iopn.endswith("NOT_LITERAL"):
                spec = (("neg",), ("lit", iav))
            elif iopn.endswith("LITERAL"):
                spec = (("lit", iav),)
            elif iopn.endswith("IN"):
                spec = _in_spec(iav)
            elif iopn.endswith("ANY"):
                spec = (("neg",), ("lit", 10))
            else:
                raise NotCompilable(f"regex repeat of {iop}")
            steps.append(_Step("class", spec, min=mn,
                               max=None if mx == _MAXREPEAT else mx))
        elif opn.endswith("SUBPATTERN"):
            g, addf, delf, sub = av
            if addf or delf:
                raise NotCompilable("regex inline flags")
            steps.append(_Step("open", group=g))
            _flatten(sub, steps)
            steps.append(_Step("close", group=g))
        elif opn.endswith("AT"):
            name = str(av)
            if name.endswith("AT_BEGINNING"):
                if any(st.kind != "open" for st in steps):
                    raise NotCompilable("^ not at pattern start")
            elif name.endswith("AT_END"):
                steps.append(_Step("end"))
            else:
                raise NotCompilable(f"regex anchor {av}")
        else:
            raise NotCompilable(f"regex op {op}")


def _byte_set(spec: tuple) -> frozenset:
    return frozenset(c for c in range(256) if _byte_in_spec(c, spec))


def _suspect_threshold(steps: list) -> int:
    """The first step index at or after which a death may have unexplored
    backtracking alternatives. Walks each variable-length run's reachable
    followers (past groups and min-0 disjoint classes) looking for class
    overlap."""
    soft = len(steps)
    for j, stj in enumerate(steps):
        if stj.kind != "class" or \
                (stj.max is not None and stj.min == stj.max):
            continue    # fixed width or not a run: no alternatives
        bs = _byte_set(stj.spec)
        k = j + 1
        while k < len(steps):
            sk = steps[k]
            if sk.kind in ("open", "close"):
                k += 1
                continue
            if sk.kind == "end":
                break                       # '$' consumes nothing
            if bs & _byte_set(sk.spec):
                if sk.retreat_from == j:
                    # one retreat level is exact; deeper literal
                    # occurrences are not: deaths from the literal on are
                    # suspect
                    soft = min(soft, k)
                else:
                    soft = min(soft, j)
                break
            if sk.min >= 1:
                break   # must consume a byte the run cannot supply: rigid
            k += 1      # a min-0 disjoint class can be empty: walk on
    return soft


def _analyze_retreats(steps: list) -> None:
    """Mark the single-character literal steps that can retreat into a
    preceding unbounded greedy class run."""
    for i, st in enumerate(steps):
        if st.kind != "lit" and not (st.kind == "class" and st.min == 1
                                     and st.max == 1
                                     and len(st.spec) == 1
                                     and st.spec[0][0] == "lit"):
            continue
        lit_byte = st.spec[-1][1] if st.spec[-1][0] == "lit" else None
        if lit_byte is None:
            continue
        groups: list = []
        j = i - 1
        while j >= 0:
            pj = steps[j]
            if pj.kind in ("open", "close"):
                if pj.kind == "close":
                    groups.append(pj.group)
                j -= 1
                continue
            if pj.kind == "class" and pj.min == 0 and \
                    not _byte_in_spec(lit_byte, pj.spec):
                j -= 1          # can be empty and is disjoint from the lit
                continue
            break
        if j >= 0 and steps[j].kind == "class" and steps[j].max is None \
                and _byte_in_spec(lit_byte, steps[j].spec):
            st.retreat_from = j
            st.retreat_min = steps[j].min
            st.retreat_groups = tuple(groups)


def _class_mask(bytes_: torch.Tensor, spec: tuple) -> torch.Tensor:
    neg = bool(spec) and spec[0] == ("neg",)
    items = spec[1:] if neg else spec
    m = torch.zeros(bytes_.shape, dtype=torch.bool, device=bytes_.device)
    for it in items:
        if it[0] == "lit":
            m = m | (bytes_ == it[1])
        else:
            m = m | ((bytes_ >= it[1]) & (bytes_ <= it[2]))
    return ~m if neg else m


class CompiledRegex:
    """Anchored matcher: match(bytes [N, W] uint8, lens [N] int32) ->
    (matched [N] bool, suspect [N] bool, group_start, group_end), the last
    two lists of G+1 int32 [N] tensors; group 0 is the whole match."""

    def __init__(self, pattern: str):
        self.pattern = pattern
        try:
            tree = _sre.parse(pattern)
        except Exception as e:
            raise NotCompilable(f"regex parse: {e}")
        if tree.state.flags & ~(_pyre.UNICODE.value):
            raise NotCompilable("regex flags")
        steps: list[_Step] = []
        _flatten(list(tree), steps)
        if not pattern.startswith("^"):
            raise NotCompilable("only anchored (^) regex compiles")
        _analyze_retreats(steps)
        self.steps = steps
        self.n_groups = tree.state.groups - 1
        # a greedy run whose reachable follower is disjoint from its class
        # is rigid: deaths behind it are exact no-matches. Only runs with
        # an overlapping follower admit deeper backtracking: with a
        # single-character literal the retreat explores exactly CPython's
        # first alternative (deaths at or after that literal are suspect);
        # other overlaps are unexplored (suspect from the run itself)
        self.first_var = _suspect_threshold(steps)

    def match(self, bytes_: torch.Tensor, lens: torch.Tensor):
        global calls
        calls += 1
        n, w = bytes_.shape
        dev = bytes_.device
        if w == 0:   # no byte to read: one zero column changes no answer
            bytes_ = torch.zeros((n, 1), dtype=bytes_.dtype, device=dev)
            w = 1
        lens = lens.to(I32)
        pos = torch.zeros(n, dtype=I32, device=dev)
        alive = torch.ones(n, dtype=torch.bool, device=dev)
        ng = self.n_groups
        gs = [pos] * (ng + 1)
        ge = [pos] * (ng + 1)
        positions = torch.arange(w, dtype=I32, device=dev)[None, :]
        greedy_state: dict[int, torch.Tensor] = {}   # step -> run start
        died_late = torch.zeros(n, dtype=torch.bool, device=dev)

        def byte_at(p):
            idx = torch.clamp(p, 0, w - 1).to(torch.int64)
            return torch.gather(bytes_, 1, idx[:, None])[:, 0]

        def note_deaths(si, before, after):
            # deaths before the suspect threshold are exact (every earlier
            # run is rigid); at or after it backtracking may remain
            nonlocal died_late
            if si >= self.first_var:
                died_late = died_late | (before & ~after)
            return after

        for si, st in enumerate(self.steps):
            if st.kind == "open":
                gs[st.group] = pos
                continue
            if st.kind == "close":
                ge[st.group] = pos
                continue
            if st.kind == "end":
                at_end = (pos == lens) | \
                    ((pos == lens - 1) & (byte_at(pos) == 10))
                alive = note_deaths(si, alive, alive & at_end)
                continue
            if st.kind == "lit" or (st.min == 1 and st.max == 1):
                ok = (pos < lens) & _class_mask(byte_at(pos), st.spec)
                if st.retreat_from >= 0:
                    # retreat into the greedy run: its last occurrence of
                    # the literal
                    start = greedy_state[st.retreat_from]
                    lit = st.spec[-1][1]
                    window = (positions >=
                              (start + st.retreat_min)[:, None]) & \
                        (positions < pos[:, None]) & (bytes_ == lit)
                    last = torch.where(window, positions, -1).amax(dim=1)
                    use = alive & ~ok & (last >= 0)
                    # group ends recorded at the run's end move back too
                    for g in st.retreat_groups:
                        ge[g] = torch.where(use, last, ge[g])
                    pos = torch.where(use, last, pos)
                    ok = ok | use
                alive = note_deaths(si, alive, alive & ok)
                pos = torch.where(alive, pos + 1, pos)
                continue
            # greedy class run
            blocked = ~_class_mask(bytes_, st.spec) | \
                (positions >= lens[:, None])
            beyond = blocked & (positions >= pos[:, None])
            first_stop = torch.where(beyond, positions, w).amin(dim=1)
            runlen = first_stop - pos
            if st.max is not None:
                runlen = torch.clamp(runlen, max=st.max)
            alive = note_deaths(si, alive, alive & (runlen >= st.min))
            greedy_state[si] = pos
            pos = torch.where(alive, pos + runlen, pos)
        ge[0] = pos
        return alive, died_late, gs, ge


_REGEX_CACHE: dict[str, CompiledRegex] = {}


def compile_regex(pattern: str) -> CompiledRegex:
    rx = _REGEX_CACHE.get(pattern)
    if rx is None:
        rx = CompiledRegex(pattern)
        if len(_REGEX_CACHE) > 256:
            _REGEX_CACHE.clear()
        _REGEX_CACHE[pattern] = rx
    return rx


def try_compile_regex(pattern: str) -> Optional[CompiledRegex]:
    """`compile_regex(pattern)`, or None where the anchored engine does not
    take it (sre parse errors included: the reference rejects them too)."""
    try:
        return compile_regex(pattern)
    except NotCompilable:
        return None


def anchored_engine_accepts(pattern: str) -> bool:
    """Whether `compile_regex` compiles `pattern`."""
    return try_compile_regex(pattern) is not None
