"""Logical operator DAG (counterpart of `tuplex_tpu/plan/logical.py`, the
operators this package supports: parallelize, map, filter, withColumn,
mapColumn, selectColumns, renameColumn, resolve, ignore, take and the CSV
cell decode; the aggregates are in plan/aggregates.py, the join in
plan/joins.py).

Schema inference IS the sample tracer: operators run their UDF on the
parent's sample rows via CPython and speculate the normal-case output type
(reference: TraceVisitor semantics — execute on sample to annotate types).
The reference package can also type UDFs without a sample
(`compiler/typeinfer.py`); this package infers by sample only. The text and
CSV sources live in io/csvsource.py.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Optional, Sequence

from ..core import typesys as T
from ..core.errors import TuplexException
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

    def is_breaker(self) -> bool:
        """Whether the operator ends a stage: it needs every row of its
        input before it emits one (the aggregates)."""
        return False

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


class WithColumnOperator(UDFOperator):
    """Adds or replaces a named column (reference:
    logical/WithColumnOperator.cc)."""

    def __init__(self, parent: LogicalOperator, column: str, func: Callable):
        self.column = column
        super().__init__(parent, func)

    def _infer_schema(self) -> T.RowType:
        from ..runtime.columns import user_columns

        ps = self.parent.schema()
        if user_columns(ps) is None:
            raise TuplexException("withColumn requires named columns")
        outs = self._sample_outputs()
        nc = T.PYOBJECT if not outs else T.normal_case_type(outs)[0]
        cols, types = list(ps.columns), list(ps.types)
        if self.column in cols:
            types[cols.index(self.column)] = nc
        else:
            cols.append(self.column)
            types.append(nc)
        return T.row_of(cols, types)

    def sample(self) -> list[Row]:
        schema = self.schema()
        out = []
        for r in self.parent.cached_sample():
            try:
                v = apply_udf_python(self.udf, r)
            except Exception:
                continue
            d = dict(zip(r.columns, r.values))
            d[self.column] = v
            out.append(Row([d[c] for c in schema.columns], schema.columns))
        return out


class MapColumnOperator(UDFOperator):
    """A UDF over ONE column's value (reference:
    logical/MapColumnOperator.cc)."""

    def __init__(self, parent: LogicalOperator, column: str, func: Callable):
        self.column = column
        super().__init__(parent, func)

    def _index(self) -> int:
        ps = self.parent.schema()
        if self.column not in (ps.columns or ()):
            raise TuplexException(f"unknown column {self.column!r}")
        return ps.columns.index(self.column)

    def _infer_schema(self) -> T.RowType:
        ps = self.parent.schema()
        ci = self._index()
        outs = []
        for r in self.parent.cached_sample():
            try:
                outs.append(self.udf.func(r.values[ci]))
            except Exception:
                continue
        types = list(ps.types)
        types[ci] = T.PYOBJECT if not outs else T.normal_case_type(outs)[0]
        return T.row_of(ps.columns, types)

    def sample(self) -> list[Row]:
        ci = self._index()
        out = []
        for r in self.parent.cached_sample():
            try:
                v = self.udf.func(r.values[ci])
            except Exception:
                continue
            vals = list(r.values)
            vals[ci] = v
            out.append(Row(vals, r.columns))
        return out


class SelectColumnsOperator(LogicalOperator):
    """Keeps the named (or indexed) columns in the given order."""

    def __init__(self, parent: LogicalOperator, columns: Sequence):
        super().__init__([parent])
        self.selected = list(columns)

    def resolve_indices(self, names: Sequence[str]) -> list[int]:
        idx = []
        for c in self.selected:
            if isinstance(c, int):
                idx.append(c if c >= 0 else len(names) + c)
            elif c in names:
                idx.append(list(names).index(c))
            else:
                raise TuplexException(f"unknown column {c!r}")
        return idx

    def schema(self) -> T.RowType:
        ps = self.parent.schema()
        idx = self.resolve_indices(ps.columns)
        return T.row_of([ps.columns[i] for i in idx],
                        [ps.types[i] for i in idx])

    def sample(self) -> list[Row]:
        idx = self.resolve_indices(self.parent.schema().columns)
        cols = self.schema().columns
        return [Row([r.values[i] for i in idx], cols)
                for r in self.parent.cached_sample()]


class RenameColumnOperator(LogicalOperator):
    """Renames one column, by name or position; the rows are untouched, so
    it costs no stage work (reference: logical/RenameColumnOperator.cc)."""

    def __init__(self, parent: LogicalOperator, old, new: str):
        super().__init__([parent])
        self.old = old
        self.new = new

    def rename(self, names: Sequence[str]) -> tuple:
        """`names` with the renamed column's new name."""
        if isinstance(self.old, int):
            i = self.old
        elif self.old in names:
            i = list(names).index(self.old)
        else:
            raise TuplexException(f"unknown column {self.old!r}")
        cols = list(names)
        cols[i] = self.new
        return tuple(cols)

    def schema(self) -> T.RowType:
        ps = self.parent.schema()
        return T.row_of(self.rename(ps.columns or ()), ps.types)

    def sample(self) -> list[Row]:
        s = self.schema()
        return [Row(r.values, s.columns) for r in self.parent.cached_sample()]


class ResolveOperator(LogicalOperator):
    """Resolves rows whose previous operator raised `exc_class`: the
    resolver's result takes the place of that operator's (reference:
    logical/ResolveOperator.cc; dataset.py:162). It runs on the
    interpreter, where every row that raised goes."""

    def __init__(self, parent: LogicalOperator, exc_class: type,
                 func: Callable):
        super().__init__([parent])
        self.exc_class = exc_class
        self.udf = get_udf_source(func)

    def schema(self) -> T.RowType:
        return self.parent.schema()

    def columns(self):
        return self.parent.columns()

    def sample(self) -> list[Row]:
        return self.parent.cached_sample()


class IgnoreOperator(LogicalOperator):
    """Drops the rows whose previous operator raised `exc_class`; they are
    counted apart and are not exceptions of the job (reference:
    logical/IgnoreOperator.cc; dataset.py:319)."""

    def __init__(self, parent: LogicalOperator, exc_class: type):
        super().__init__([parent])
        self.exc_class = exc_class

    def schema(self) -> T.RowType:
        return self.parent.schema()

    def columns(self):
        return self.parent.columns()

    def sample(self) -> list[Row]:
        return self.parent.cached_sample()


RESOLVERS = (ResolveOperator, IgnoreOperator)


class TakeOperator(LogicalOperator):
    """The first `limit` rows (reference: logical/TakeOperator.cc;
    dataset.py:125 take). The planner takes it out of the chain and sets
    the last stage's `limit`; -1 is no limit."""

    def __init__(self, parent: LogicalOperator, limit: int):
        super().__init__([parent])
        self.limit = limit

    def schema(self) -> T.RowType:
        return self.parent.schema()


class DecodeOperator(LogicalOperator):
    """Typed decode of raw CSV string cells against the speculated
    normal-case schema, fused into the stage so parsing runs on the device
    (reference: JITCSVSourceTaskBuilder / CSVParseRowGenerator fuse parsing
    into the pipeline). On the interpreter path a cell that does not parse
    as its column's type stays the raw string, as the reference's general
    case keeps un-specialized columns. `general` is the general-case row
    type the compiled general tier decodes under (io/csvsource.py
    `general_type`), None when it equals the declared one."""

    def __init__(self, parent: LogicalOperator, declared: T.RowType,
                 null_values: Sequence[str],
                 general: Optional[T.RowType] = None):
        super().__init__([parent])
        self.declared = declared
        self.null_values = tuple(null_values)
        self.general = general if general is not None and \
            general.name != declared.name else None

    def schema(self) -> T.RowType:
        return self.declared

    def sample(self) -> list[Row]:
        cols = self.declared.columns
        return [Row([decode_cell_python(v, t, self.null_values)
                     for v, t in zip(r.values, self.declared.types)], cols)
                for r in self.parent.cached_sample()]


def decode_cell_python(cell, t: T.Type, null_values) -> Any:
    """General-case decode: the normal-case parse where it succeeds, else
    the raw string survives for the interpreter's UDFs."""
    if cell is None:
        return None
    if not isinstance(cell, str):
        return cell
    if cell in null_values:
        return None
    base = t.without_option() if t.is_optional() else t
    try:
        if base is T.I64:
            return int(cell)
        if base is T.F64:
            return float(cell)
        if base is T.BOOL:
            low = cell.strip().lower()
            if low == "true":
                return True
            if low == "false":
                return False
            return cell
    except ValueError:
        return cell
    return cell
