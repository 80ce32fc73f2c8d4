"""Logical operator DAG (counterpart of `tuplex_tpu/plan/logical.py`, the
operators this package supports: parallelize, map, filter).

Schema inference IS the sample tracer: operators run their UDF on the
parent's sample rows via CPython and speculate the normal-case output type
(reference: TraceVisitor semantics — execute on sample to annotate types).
The text source lives in io/csvsource.py.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Optional, Sequence

from ..core import typesys as T
from ..core.row import Row
from ..utils.reflection import UDFSource, get_udf_source

_op_ids = itertools.count(1)


def apply_udf_python(udf: UDFSource, row: Row) -> Any:
    """Interpreter-path calling convention shared by sampling and the
    fallback pipeline."""
    f = udf.func
    nparams = len(udf.params) if udf.params else 1
    if nparams > 1 and len(row.values) == nparams:
        return f(*row.values)
    if row.columns is not None:
        return f(row)
    if len(row.values) == 1:
        return f(row.values[0])
    return f(tuple(row.values))


class LogicalOperator:
    """Base: parent links + output schema + sample rows."""

    def __init__(self, parents: Sequence["LogicalOperator"]):
        self.id = next(_op_ids)
        self.parents = list(parents)

    @property
    def parent(self) -> "LogicalOperator":
        return self.parents[0]

    def schema(self) -> T.RowType:
        raise NotImplementedError

    def columns(self) -> Optional[tuple[str, ...]]:
        from ..runtime.columns import user_columns

        return user_columns(self.schema())

    def sample(self) -> list[Row]:
        raise NotImplementedError

    def cached_sample(self) -> list[Row]:
        """Memoized sample(): every consumer shares ONE trace per operator
        instead of re-running the upstream UDF chain per call."""
        memo = getattr(self, "_sample_memo", None)
        if memo is None:
            memo = self._sample_memo = self.sample()
        return memo

    def __repr__(self):
        return f"{type(self).__name__}(#{self.id})"


class ParallelizeOperator(LogicalOperator):
    """In-memory input (reference: core/src/logical/ParallelizeOperator.cc)."""

    def __init__(self, data: list, schema: T.RowType, sample_size: int = 256):
        super().__init__([])
        self.data = data
        self._schema = schema
        self._sample_size = sample_size

    def schema(self) -> T.RowType:
        return self._schema

    def sample(self) -> list[Row]:
        from ..runtime.columns import user_columns

        cols = user_columns(self._schema)
        return [Row.from_value(v, cols)
                for v in self.data[: self._sample_size]]


class UDFOperator(LogicalOperator):
    """Base for operators carrying a UDF (reference: logical/UDFOperator.cc)."""

    def __init__(self, parent: LogicalOperator, func: Callable):
        super().__init__([parent])
        self.udf = get_udf_source(func)
        self._schema_cache: Optional[T.RowType] = None

    def schema(self) -> T.RowType:
        if self._schema_cache is None:
            self._schema_cache = self._infer_schema()
        return self._schema_cache

    def _infer_schema(self) -> T.RowType:
        raise NotImplementedError

    def _sample_outputs(self) -> list:
        outs = []
        for r in self.parent.cached_sample():
            try:
                outs.append(apply_udf_python(self.udf, r))
            except Exception:
                continue   # sample rows that raise do not shape the type
        return outs


class MapOperator(UDFOperator):
    def _infer_schema(self) -> T.RowType:
        outs = self._sample_outputs()
        if not outs:
            # UDF failed on EVERY sample row: the job still runs, all rows
            # become exception rows (schema degrades to pyobject)
            return T.row_of(["_0"], [T.PYOBJECT])
        if all(isinstance(o, tuple) for o in outs) and \
                len({len(o) for o in outs}) == 1:
            k = len(outs[0])
            types = [T.normal_case_type([o[i] for o in outs])[0]
                     for i in range(k)]
            return T.row_of([f"_{i}" for i in range(k)], types)
        # dict results keep column names (reference: map with dict output)
        if all(isinstance(o, dict) for o in outs):
            keys = list(outs[0].keys())
            if all(list(o.keys()) == keys for o in outs):
                types = [T.normal_case_type([o[k] for o in outs])[0]
                         for k in keys]
                return T.row_of(keys, types)
        nc, _, _ = T.normal_case_type(outs)
        return T.row_of(["_0"], [nc])

    def sample(self) -> list[Row]:
        out = []
        cols = self.columns()
        for r in self.parent.cached_sample():
            try:
                v = apply_udf_python(self.udf, r)
            except Exception:
                continue
            if isinstance(v, dict):
                out.append(Row(list(v.values()), list(v.keys())))
            else:
                out.append(Row.from_value(v, cols))
        return out


class FilterOperator(UDFOperator):
    def _infer_schema(self) -> T.RowType:
        return self.parent.schema()

    def columns(self):
        return self.parent.columns()

    def sample(self) -> list[Row]:
        out = []
        for r in self.parent.cached_sample():
            try:
                if apply_udf_python(self.udf, r):
                    out.append(r)
            except Exception:
                continue
        return out
