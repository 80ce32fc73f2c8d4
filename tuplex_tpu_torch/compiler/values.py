"""Columnar symbolic values (counterpart of `tuplex_tpu/compiler/values.py`)
— what the emitter pushes around while evaluating a UDF over column
batches.

A CV is one of:
  * const    — a Python scalar known while emitting (baked into the op
               sequence, the way the reference bakes constants into IR)
  * numeric  — data [B] (+ valid [B] when Option)
  * str      — sbytes [B, W] uint8 + slen [B] int32 (+ valid)
  * null     — the None value for every row
  * tuple    — tuple of CVs (+ valid for Option[Tuple]); may carry field
               names (row values)
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional, Sequence

import torch

from ..core import typesys as T
from ..core.errors import NotCompilable
from ..runtime.torchcfg import F64, I64

_MISSING = object()


@dataclass
class CV:
    t: T.Type
    data: Any = None            # numeric payload [B]
    valid: Any = None           # Option validity [B] (None => always valid)
    sbytes: Any = None          # str payload [B, W]
    slen: Any = None            # str lengths [B]
    elts: Optional[tuple] = None          # tuple elements (CVs)
    names: Optional[tuple] = None         # field names for row-tuples
    const: Any = _MISSING       # constant known while emitting
    kind: Optional[str] = None  # special object marker ("match" = re result)

    @property
    def is_const(self) -> bool:
        return self.const is not _MISSING

    @property
    def base(self) -> T.Type:
        return self.t.without_option() if self.t.is_optional() else self.t

    def __repr__(self):
        if self.is_const:
            return f"CV(const={self.const!r})"
        return f"CV({self.t})"


def const_cv(value: Any) -> CV:
    return CV(t=T.infer_type(value), const=value)


def null_cv() -> CV:
    return CV(t=T.NULL, const=None)


def tuple_cv(elts: Sequence[CV], names: Optional[Sequence[str]] = None,
             valid: Any = None, kind: Optional[str] = None) -> CV:
    t = T.tuple_of(*(e.t for e in elts))
    if valid is not None:
        t = T.option(t)
    return CV(t=t, elts=tuple(elts), names=tuple(names) if names else None,
              valid=valid, kind=kind)


def materialize(cv: CV, b: int, device) -> CV:
    """Broadcast a const CV to batch tensors of length b on `device`."""
    if not cv.is_const:
        return cv
    v = cv.const
    if v is None:
        return CV(t=T.NULL, const=None)  # null stays symbolic
    if isinstance(v, bool):
        return CV(t=T.BOOL, data=torch.full((b,), v, dtype=torch.bool,
                                            device=device))
    if isinstance(v, int):
        return CV(t=T.I64, data=torch.full((b,), v, dtype=I64,
                                           device=device))
    if isinstance(v, float):
        return CV(t=T.F64, data=torch.full((b,), v, dtype=F64,
                                           device=device))
    if isinstance(v, str):
        from ..ops import strings as S

        sb, sl = S.broadcast_const(v, b, device)
        return CV(t=T.STR, sbytes=sb, slen=sl)
    if isinstance(v, tuple):
        return tuple_cv([materialize(const_cv(x), b, device) for x in v])
    raise NotCompilable(f"cannot materialize constant {type(v).__name__}")


def cv_arrays(cv: CV, out: list) -> None:
    """Append the CV tree's tensors to `out` in deterministic order
    (inverse: cv_rebuild)."""
    if cv.is_const:
        return
    for f in ("data", "valid", "sbytes", "slen"):
        v = getattr(cv, f)
        if v is not None:
            out.append(v)
    if cv.elts is not None:
        for e in cv.elts:
            cv_arrays(e, out)


def cv_rebuild(cv: CV, it) -> CV:
    """Rebuild a CV tree consuming tensors from `it`."""
    if cv.is_const:
        return cv
    kw = {}
    for f in ("data", "valid", "sbytes", "slen"):
        if getattr(cv, f) is not None:
            kw[f] = next(it)
    elts = cv.elts
    if elts is not None:
        elts = tuple(cv_rebuild(e, it) for e in elts)
    return dataclasses.replace(cv, elts=elts, **kw)


def dtype_for(t: T.Type) -> torch.dtype:
    if t is T.BOOL:
        return torch.bool
    if t is T.I64:
        return I64
    if t is T.F64:
        return F64
    raise NotCompilable(f"no dtype for {t}")
