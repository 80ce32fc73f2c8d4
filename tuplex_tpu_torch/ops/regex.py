"""Regex pattern analysis shared by the NFA compiler (counterpart of
`tuplex_tpu/ops/regex.py`, the parts this package uses).

The reference package has two engines for compiled `re.search`: an anchored
matcher with capture groups (its `CompiledRegex`) and the bit-parallel
Glushkov NFA (ops/nfa.py) for boolean existence. This package ports the
NFA. `anchored_engine_accepts` reproduces the reference's accept/reject
decision for the anchored engine, so the emitter takes the NFA exactly
where the reference does and reports NotCompilable where the reference
would use the anchored engine (that engine is not ported yet).
"""

from __future__ import annotations

import re as _pyre

from ..core.errors import NotCompilable

try:
    from re import _parser as _sre
except ImportError:  # pragma: no cover - older layout
    import sre_parse as _sre            # type: ignore


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


def _check_flatten(tree, kinds: list) -> None:
    """The reference's step flattening with only its reject conditions
    kept: raises NotCompilable exactly where `_flatten` does. `kinds`
    collects the step kinds emitted so far ("^" must follow only group
    openings)."""
    for op, av in tree:
        opn = str(op)
        if opn.endswith("NOT_LITERAL") or opn.endswith("LITERAL") \
                or opn.endswith("ANY"):
            kinds.append("char")
        elif opn.endswith("IN"):
            _in_spec(av)
            kinds.append("char")
        elif opn.endswith("MAX_REPEAT"):
            _mn, _mx, item = av
            if len(item) != 1:
                raise NotCompilable("regex repeat of a sequence")
            iop, iav = item[0]
            iopn = str(iop)
            if iopn.endswith("IN"):
                _in_spec(iav)
            elif not (iopn.endswith("LITERAL") or iopn.endswith("ANY")):
                raise NotCompilable(f"regex repeat of {iop}")
            kinds.append("char")
        elif opn.endswith("SUBPATTERN"):
            _g, addf, delf, sub = av
            if addf or delf:
                raise NotCompilable("regex inline flags")
            kinds.append("open")
            _check_flatten(sub, kinds)
            kinds.append("close")
        elif opn.endswith("AT"):
            name = str(av)
            if name.endswith("AT_BEGINNING"):
                if any(k != "open" for k in kinds):
                    raise NotCompilable("^ not at pattern start")
            elif name.endswith("AT_END"):
                kinds.append("end")
            else:
                raise NotCompilable(f"regex anchor {av}")
        else:
            raise NotCompilable(f"regex op {op}")


def anchored_engine_accepts(pattern: str) -> bool:
    """Whether the reference's anchored engine (`compile_regex`) compiles
    `pattern`."""
    try:
        tree = _sre.parse(pattern)
        if tree.state.flags & ~(_pyre.UNICODE.value):
            raise NotCompilable("regex flags")
        _check_flatten(list(tree), [])
        if not pattern.startswith("^"):
            raise NotCompilable("only anchored (^) regex compiles")
    except NotCompilable:
        return False
    except Exception:   # sre parse errors: the reference rejects them too
        return False
    return True
