"""Bridging staged batches <-> emitter CVs (counterpart of
`tuplex_tpu/compiler/stagefn.py`): the input row a stage's first UDF sees,
and the flattening of a stage result into output tensors named by the
staging key convention (runtime.columns)."""

from __future__ import annotations

from typing import Any

import torch

from ..core import typesys as T
from ..core.errors import NotCompilable
from .values import CV, materialize, tuple_cv


def leaf_cv(arrays: dict, path: str, t: T.Type) -> CV:
    """CV view over a staged leaf (see runtime.columns.stage_partition)."""
    base = t.without_option() if t.is_optional() else t
    opt = t.is_optional()
    valid = arrays.get(path + "#valid") if opt else None
    if isinstance(base, T.TupleType):
        elts = []
        if opt:
            tvalid = arrays[path + "#opt"]
            valid = tvalid if valid is None else valid & tvalid
        for i, e in enumerate(base.elements):
            elts.append(leaf_cv(arrays, f"{path}.{i}",
                                T.option(e) if opt else e))
        return tuple_cv(elts, valid=valid)
    if base is T.STR:
        return CV(t=t, sbytes=arrays[path + "#bytes"],
                  slen=arrays[path + "#len"], valid=valid)
    if base is T.NULL:
        return CV(t=T.NULL, const=None)
    if base is T.EMPTYTUPLE:
        return tuple_cv([], valid=valid)
    if base in (T.BOOL, T.I64, T.F64):
        return CV(t=t, data=arrays[path], valid=valid)
    raise NotCompilable(f"column type {t} has no device layout")


def input_row_cv(arrays: dict, schema: T.RowType) -> CV:
    """The row value passed to the first UDF: single unnamed column -> bare
    value; otherwise a named row tuple."""
    from ..runtime.columns import user_columns

    cvs = [leaf_cv(arrays, str(i), t) for i, t in enumerate(schema.types)]
    cols = user_columns(schema)
    if len(cvs) == 1 and cols is None:
        return cvs[0]
    return tuple_cv(cvs, names=cols)


def result_arrays(cv: CV, b: int, device) -> dict[str, Any]:
    """Flatten a stage RESULT into row-layout tensors: a plain tuple result
    spreads into columns 0..k-1; anything else is the single column 0."""
    cv = materialize(cv, b, device)
    if cv.elts is not None and cv.valid is None and cv.kind is None:
        out: dict[str, Any] = {}
        for i, e in enumerate(cv.elts):
            out.update(cv_output_arrays(e, b, device, str(i)))
        return out
    return cv_output_arrays(cv, b, device, "0")


def cv_output_arrays(cv: CV, b: int, device, prefix: str) -> dict[str, Any]:
    """Flatten a result CV into named output tensors; the keys mirror the
    staged-input convention so results rebuild into Partitions."""
    cv = materialize(cv, b, device)
    if cv.kind is not None:
        raise NotCompilable(f"{cv.kind} object as a result")
    out: dict[str, Any] = {}
    base = cv.base
    if cv.elts is not None:
        if cv.valid is not None:
            out[prefix + "#opt"] = cv.valid
        if not cv.elts:  # empty tuple: keep a structural marker
            out[prefix + "#unit"] = torch.zeros(b, dtype=torch.bool,
                                                device=device)
            return out
        for i, e in enumerate(cv.elts):
            out.update(cv_output_arrays(e, b, device, f"{prefix}.{i}"))
        return out
    if base is T.STR:
        out[prefix + "#bytes"] = cv.sbytes
        out[prefix + "#len"] = cv.slen
    elif base is T.NULL:
        # structural marker so the column survives the round trip
        out[prefix + "#null"] = torch.zeros(b, dtype=torch.bool,
                                            device=device)
        return out
    elif base in (T.BOOL, T.I64, T.F64):
        out[prefix] = cv.data
    else:
        raise NotCompilable(f"output type {cv.t} has no columnar layout")
    if cv.valid is not None:
        out[prefix + "#valid"] = cv.valid
    return out
