"""Public DataSet — lazy operator-graph builder (counterpart of
`tuplex_tpu/api/dataset.py`; reference: python/tuplex/dataset.py — unique:36,
map:49, filter:83, withColumn/mapColumn/selectColumns, collect:113,
resolve:162, ignore:319, renameColumn, columns:365, types:375, join:384,
leftJoin:442, aggregate:593, aggregateByKey:644, exception_counts:707). Every method returns a NEW DataSet over a new
logical operator; nothing executes until collect()."""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

from ..core import typesys as T
from ..exec.local import run_plan
from ..plan import aggregates as A
from ..plan import logical as L
from ..plan.joins import JoinOperator
from ..runtime import columns as C


class DataSet:
    def __init__(self, context, op: L.LogicalOperator):
        self._context = context
        self._op = op
        self._last_exceptions: list = []

    def map(self, ftor: Callable) -> "DataSet":
        return DataSet(self._context, L.MapOperator(self._op, ftor))

    def filter(self, ftor: Callable) -> "DataSet":
        return DataSet(self._context, L.FilterOperator(self._op, ftor))

    def withColumn(self, column: str, ftor: Callable) -> "DataSet":
        return DataSet(self._context,
                       L.WithColumnOperator(self._op, column, ftor))

    def mapColumn(self, column: str, ftor: Callable) -> "DataSet":
        return DataSet(self._context,
                       L.MapColumnOperator(self._op, column, ftor))

    def selectColumns(self, columns: Sequence) -> "DataSet":
        if not isinstance(columns, (list, tuple)):
            columns = [columns]
        return DataSet(self._context,
                       L.SelectColumnsOperator(self._op, columns))

    def renameColumn(self, key, newColumnName: str) -> "DataSet":
        """The column `key` (a name or a position) renamed."""
        return DataSet(self._context, L.RenameColumnOperator(
            self._op, key, newColumnName))

    def resolve(self, eclass: type, ftor: Callable) -> "DataSet":
        """Rows whose previous operator raised `eclass` take ftor(row) as
        that operator's result."""
        return DataSet(self._context,
                       L.ResolveOperator(self._op, eclass, ftor))

    def ignore(self, eclass: type) -> "DataSet":
        """Rows whose previous operator raised `eclass` are dropped, and
        not counted as exceptions (Metrics.ignoredRows counts them)."""
        return DataSet(self._context, L.IgnoreOperator(self._op, eclass))

    def join(self, dsRight: "DataSet", leftKeyColumn: str,
             rightKeyColumn: str, prefixes=None, suffixes=None) -> "DataSet":
        """Inner join on leftKeyColumn == rightKeyColumn: each left row,
        in order, once for each right row with an equal key, in the right
        side's order."""
        return DataSet(self._context, JoinOperator(
            self._op, dsRight._op, leftKeyColumn, rightKeyColumn, "inner",
            prefixes, suffixes))

    def leftJoin(self, dsRight: "DataSet", leftKeyColumn: str,
                 rightKeyColumn: str, prefixes=None,
                 suffixes=None) -> "DataSet":
        """As join, and a left row that matches nothing appears once with
        None in every right column."""
        return DataSet(self._context, JoinOperator(
            self._op, dsRight._op, leftKeyColumn, rightKeyColumn, "left",
            prefixes, suffixes))

    def unique(self) -> "DataSet":
        """Distinct rows, in the order of their first occurrence."""
        return DataSet(self._context, A.UniqueOperator(self._op))

    def aggregate(self, combine: Callable, aggregate: Callable,
                  initial_value: Any) -> "DataSet":
        """One row: `initial_value` with every row folded in by
        aggregate(acc, row); combine(acc, acc) must be associative."""
        return DataSet(self._context, A.AggregateOperator(
            self._op, combine, aggregate, initial_value))

    def aggregateByKey(self, combine: Callable, aggregate: Callable,
                       initial_value: Any,
                       key_columns: Sequence[str]) -> "DataSet":
        """One row per distinct key: the key columns, then the key's
        accumulator, in the order the keys first folded."""
        return DataSet(self._context, A.AggregateByKeyOperator(
            self._op, combine, aggregate, initial_value, key_columns))

    # -- metadata -----------------------------------------------------------
    @property
    def columns(self) -> Optional[list[str]]:
        cols = self._op.columns()
        return list(cols) if cols else None

    @property
    def types(self) -> list:
        return list(self._op.schema().types)

    @property
    def schema(self) -> T.RowType:
        return self._op.schema()

    # -- actions ------------------------------------------------------------
    def collect(self) -> list:
        """Run the plan's stages in order, each over the partitions the one
        before it returned (the first over its source's)."""
        parts, exceptions = run_plan(self._context, self._op)
        self._last_exceptions = exceptions
        return [v for p in parts for v in C.partition_to_pylist(p)]

    def exception_counts(self) -> dict[str, int]:
        """Counts of unresolved exceptions from the LAST collect() on this
        dataset (reference: dataset.py:707)."""
        counts: dict[str, int] = {}
        for rec in self._last_exceptions:
            counts[rec.exc_name] = counts.get(rec.exc_name, 0) + 1
        return counts
