"""Boxed row values for driver-side sampling, transfer and the interpreter path.

Reference semantics: tuplex/utils/src/Row.cc / Field.cc — a Row is an ordered
tuple of fields, optionally with column names; single-element rows unwrap on
collect. Here rows are lightweight wrappers over plain Python values; the
columnar layout lives in `tuplex_tpu_torch/runtime/columns.py`.
"""

from __future__ import annotations

from typing import Any, Iterator, Optional, Sequence


# column-name -> index maps interned per columns tuple: Row['col'] is on the
# interpreter hot path (reference: generated Row class resolves names to
# positions at codegen time, PythonPipelineBuilder.cc:1-60)
_COL_INDEX: dict = {}


def _col_index_map(columns: tuple) -> dict:
    m = _COL_INDEX.get(columns)
    if m is None:
        # reversed so the FIRST occurrence of a duplicated name wins,
        # matching tuple.index semantics
        m = {c: i for i, c in reversed(list(enumerate(columns)))}
        if len(_COL_INDEX) > 4096:
            # data-dependent column sets (dict-returning map UDFs) must not
            # grow the interned cache without bound
            _COL_INDEX.clear()
        _COL_INDEX[columns] = m
    return m


class Row:
    __slots__ = ("values", "columns")

    def __init__(self, values: Sequence[Any], columns: Optional[Sequence[str]] = None):
        self.values: tuple = values if type(values) is tuple else tuple(values)
        self.columns: Optional[tuple] = None if not columns else (
            columns if type(columns) is tuple else tuple(columns))

    @classmethod
    def from_value(cls, value: Any, columns: Optional[Sequence[str]] = None) -> "Row":
        """Wrap a user value as a row: tuples spread into fields, a Row
        keeps its fields and its names, everything else is a single-field
        row (reference: Context.h parallelize)."""
        if isinstance(value, Row):
            return cls(value.values, value.columns)
        if isinstance(value, tuple):
            return cls(value, columns)
        return cls((value,), columns)

    def unwrap(self) -> Any:
        """Single-field rows collect as the bare value (reference: Row semantics
        in PythonDataSet.cc fast decoders)."""
        if len(self.values) == 1:
            return self.values[0]
        return tuple(self.values)

    def __len__(self) -> int:
        return len(self.values)

    def __iter__(self) -> Iterator[Any]:
        return iter(self.values)

    def __getitem__(self, key):
        if isinstance(key, str):
            cols = self.columns
            if cols is None:
                raise KeyError(key)
            i = _col_index_map(cols).get(key)
            if i is None:
                return self.values[cols.index(key)]  # same error as before
            return self.values[i]
        return self.values[key]

    def __eq__(self, other) -> bool:
        if isinstance(other, Row):
            return self.values == other.values
        return self.unwrap() == other

    def __hash__(self) -> int:
        return hash(self.values)

    def __repr__(self) -> str:
        if self.columns:
            inner = ", ".join(f"{c}={v!r}" for c, v in zip(self.columns, self.values))
        else:
            inner = ", ".join(repr(v) for v in self.values)
        return f"Row({inner})"
