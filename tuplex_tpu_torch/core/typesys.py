"""Python-ish type lattice for pipeline speculation.

Re-designs the semantics of the reference's interned type system
(reference: tuplex/utils/include/TypeSystem.h:23-60, src/TypeSystem.cc) for a
columnar device execution model: every type additionally knows how it maps onto
fixed-shape device buffers (see `tuplex_tpu_torch/runtime/columns.py`).

Key semantics preserved from the reference:
  - primitives BOOL < I64 < F64 (numeric upcast chain), STR, NULL, PYOBJECT
  - Option[T] (nullable), Tuple[...], List[T], Dict[K, V], EmptyTuple
  - `super_type(a, b)`: least common supertype used for the general case
    (reference: TypeSystem.h `superType`)
  - normal-case inference: majority type over a sample at a threshold
    (reference: utils/src/CSVStatistic.cc + core FileInputOperator.cc:195-260)

Types are interned: equality is identity.
"""

from __future__ import annotations

import threading
from typing import Any, Iterable, Sequence


class Type:
    """Base of all interned types. Compare with `is` or `==` (same thing)."""

    __slots__ = ("_name", "_hash")

    def __init__(self, name: str):
        self._name = name
        self._hash = hash(name)

    @property
    def name(self) -> str:
        return self._name

    def __repr__(self) -> str:
        return self._name

    def __hash__(self) -> int:
        return self._hash

    # interning makes default identity-eq correct; keep explicit for clarity
    def __eq__(self, other) -> bool:
        return self is other

    # --- lattice predicates -------------------------------------------------
    def is_optional(self) -> bool:
        return False

    def is_numeric(self) -> bool:
        return False

    def without_option(self) -> "Type":
        return self


class _Numeric(Type):
    __slots__ = ("rank",)

    def __init__(self, name: str, rank: int):
        super().__init__(name)
        self.rank = rank

    def is_numeric(self) -> bool:
        return True


# ---------------------------------------------------------------------------
# singletons
# ---------------------------------------------------------------------------

BOOL = _Numeric("bool", 0)
I64 = _Numeric("i64", 1)
F64 = _Numeric("f64", 2)
STR = Type("str")
NULL = Type("null")         # NoneType
PYOBJECT = Type("pyobject")        # escape hatch: anything, interpreter-only
UNKNOWN = Type("unknown")
EMPTYTUPLE = Type("()")
EMPTYLIST = Type("[]")
EMPTYDICT = Type("{}")

_intern_lock = threading.Lock()
_interned: dict[str, Type] = {}


def _intern(t: Type) -> Type:
    with _intern_lock:
        existing = _interned.get(t.name)
        if existing is not None:
            return existing
        _interned[t.name] = t
        return t


class OptionType(Type):
    """Option[T]: value of type T or None. Maps to (buffer, validity-bitmap)."""

    __slots__ = ("inner",)

    def __init__(self, inner: Type):
        super().__init__(f"Option[{inner.name}]")
        self.inner = inner

    def is_optional(self) -> bool:
        return True

    def without_option(self) -> Type:
        return self.inner

    def is_numeric(self) -> bool:
        return False


class TupleType(Type):
    __slots__ = ("elements",)

    def __init__(self, elements: tuple[Type, ...]):
        super().__init__("(" + ",".join(e.name for e in elements) + ")")
        self.elements = elements

    def __len__(self):
        return len(self.elements)


class ListType(Type):
    __slots__ = ("elt",)

    def __init__(self, elt: Type):
        super().__init__(f"List[{elt.name}]")
        self.elt = elt


class DictType(Type):
    __slots__ = ("key", "val")

    def __init__(self, key: Type, val: Type):
        super().__init__(f"Dict[{key.name},{val.name}]")
        self.key = key
        self.val = val


class RowType(Type):
    """A named, ordered set of columns — the schema of a DataSet.

    Unlike a TupleType it carries column names; the reference keeps names on
    the operator and uses plain tuple row types (Schema.h:38-80). We fold them
    together since columnar execution is name-addressed.
    """

    __slots__ = ("columns", "types")

    def __init__(self, columns: tuple[str, ...], types: tuple[Type, ...]):
        assert len(columns) == len(types)
        # repr-quote names so arbitrary column strings can't alias another
        # schema's interning key
        super().__init__(
            "Row[" + ",".join(f"{c!r}:{t.name}" for c, t in zip(columns, types)) + "]"
        )
        self.columns = columns
        self.types = types

    def __len__(self):
        return len(self.types)


# ---------------------------------------------------------------------------
# constructors (interned)
# ---------------------------------------------------------------------------

def option(inner: Type) -> Type:
    """Option[T]. Option[Option[T]] == Option[T]; Option[null] == null;
    Option[pyobject] == pyobject."""
    if inner.is_optional() or inner is NULL or inner is PYOBJECT:
        return inner
    return _intern(OptionType(inner))


def tuple_of(*elements: Type) -> Type:
    if not elements:
        return EMPTYTUPLE
    return _intern(TupleType(tuple(elements)))


def list_of(elt: Type) -> Type:
    return _intern(ListType(elt))


def dict_of(key: Type, val: Type) -> Type:
    return _intern(DictType(key, val))


def row_of(columns: Sequence[str], types: Sequence[Type]) -> RowType:
    return _intern(RowType(tuple(columns), tuple(types)))  # type: ignore[return-value]


# ---------------------------------------------------------------------------
# inference from Python values
# ---------------------------------------------------------------------------

def infer_type(value: Any) -> Type:
    """Type of a single Python value (reference: PythonContext.cc:1023 inferType)."""
    if value is None:
        return NULL
    if isinstance(value, bool):
        return BOOL
    if isinstance(value, int):
        # ints beyond i64 range must go through the interpreter path
        if -(2**63) <= value < 2**63:
            return I64
        return PYOBJECT
    if isinstance(value, float):
        return F64
    if isinstance(value, str):
        return STR
    if isinstance(value, tuple):
        if not value:
            return EMPTYTUPLE
        return tuple_of(*(infer_type(v) for v in value))
    if isinstance(value, list):
        if not value:
            return EMPTYLIST
        elt = infer_type(value[0])
        for v in value[1:]:
            elt = super_type(elt, infer_type(v))
            if elt is PYOBJECT:
                break
        return list_of(elt) if elt is not PYOBJECT else PYOBJECT
    if isinstance(value, dict):
        if not value:
            return EMPTYDICT
        kt: Type = UNKNOWN
        vt: Type = UNKNOWN
        for k, v in value.items():
            kt = super_type(kt, infer_type(k)) if kt is not UNKNOWN else infer_type(k)
            nvt = infer_type(v)
            vt = super_type(vt, nvt) if vt is not UNKNOWN else nvt
        if kt is PYOBJECT or vt is PYOBJECT:
            return PYOBJECT
        return dict_of(kt, vt)
    return PYOBJECT


def super_type(a: Type, b: Type) -> Type:
    """Least common supertype; PYOBJECT is top (reference: TypeSystem.h superType).

    Numeric chain bool < i64 < f64. null + T -> Option[T]. Mismatches -> PYOBJECT.
    """
    if a is b:
        return a
    if a is UNKNOWN:
        return b
    if b is UNKNOWN:
        return a
    if a is PYOBJECT or b is PYOBJECT:
        return PYOBJECT
    # null folding -> Option
    if a is NULL:
        return option(b)
    if b is NULL:
        return option(a)
    # option unwrap
    if a.is_optional() or b.is_optional():
        inner = super_type(a.without_option(), b.without_option())
        return inner if inner is PYOBJECT else option(inner)
    if a.is_numeric() and b.is_numeric():
        return a if a.rank >= b.rank else b  # type: ignore[union-attr]
    if isinstance(a, TupleType) and isinstance(b, TupleType) and len(a) == len(b):
        elts = tuple(super_type(x, y) for x, y in zip(a.elements, b.elements))
        if any(e is PYOBJECT for e in elts):
            return PYOBJECT
        return tuple_of(*elts)
    if isinstance(a, ListType) and isinstance(b, ListType):
        e = super_type(a.elt, b.elt)
        return PYOBJECT if e is PYOBJECT else list_of(e)
    if a is EMPTYLIST and isinstance(b, ListType):
        return b
    if b is EMPTYLIST and isinstance(a, ListType):
        return a
    if isinstance(a, DictType) and isinstance(b, DictType):
        k = super_type(a.key, b.key)
        v = super_type(a.val, b.val)
        if k is PYOBJECT or v is PYOBJECT:
            return PYOBJECT
        return dict_of(k, v)
    if a is EMPTYDICT and isinstance(b, DictType):
        return b
    if b is EMPTYDICT and isinstance(a, DictType):
        return a
    if isinstance(a, RowType) and isinstance(b, RowType) and a.columns == b.columns:
        ts = tuple(super_type(x, y) for x, y in zip(a.types, b.types))
        if any(t is PYOBJECT for t in ts):
            return PYOBJECT
        return row_of(a.columns, ts)
    return PYOBJECT


def normal_case_type(
    sample: Iterable[Any], threshold: float = 0.9
) -> tuple[Type, Type, float]:
    """Data-driven speculation over a sample of values.

    Returns (normal_case, general_case, normal_fraction):
      - normal_case: the majority type if its frequency >= threshold, else the
        super type (i.e. no specialization pays off)
      - general_case: super type of everything in the sample
      - normal_fraction: fraction of sample rows conforming to normal_case

    Reference semantics: FileInputOperator.cc:228-232 + CSVStatistic
    (majority >= tuplex.normalcaseThreshold, default 0.9 at
    ContextOptions.cc:507).
    """
    counts: dict[Type, int] = {}
    general: Type = UNKNOWN
    n = 0
    for v in sample:
        t = infer_type(v)
        counts[t] = counts.get(t, 0) + 1
        general = super_type(general, t) if general is not UNKNOWN else t
        n += 1
    if n == 0:
        return UNKNOWN, UNKNOWN, 0.0
    best_t, best_c = max(counts.items(), key=lambda kv: kv[1])
    # strict conformance, matching python_value_conforms: no silent numeric
    # upcast (autoUpcast is a separate opt-in, reference ContextOptions)
    def conforms(t: Type, nc: Type) -> bool:
        if t is nc:
            return True
        if nc.is_optional() and (t is NULL or t is nc.without_option()):
            return True
        return False

    # consider promoting majority with nulls into Option[majority]
    candidates = [best_t]
    if NULL in counts and best_t is not NULL:
        candidates.append(option(best_t))
    best_frac = 0.0
    best_nc = best_t
    for cand in candidates:
        c = sum(cnt for t, cnt in counts.items() if conforms(t, cand))
        frac = c / n
        if frac > best_frac:
            best_frac, best_nc = frac, cand
    if best_frac >= threshold:
        return best_nc, general, best_frac
    return general, general, 1.0


def python_value_conforms(value: Any, t: Type) -> bool:
    """Does `value` fit in the columnar layout of type `t` exactly?"""
    if t is PYOBJECT:
        return True  # boxed object columns accept anything
    vt = infer_type(value)
    if vt is t:
        return True
    if t.is_optional():
        return vt is NULL or python_value_conforms(value, t.without_option())
    if t is F64 and vt is I64:
        return False  # no silent upcast on the normal path: a deviation
    if isinstance(t, TupleType) and isinstance(vt, TupleType) and len(t) == len(vt):
        return all(python_value_conforms(v, et) for v, et in zip(value, t.elements))
    if isinstance(t, ListType) and isinstance(vt, ListType):
        return all(python_value_conforms(v, t.elt) for v in value)
    return False
