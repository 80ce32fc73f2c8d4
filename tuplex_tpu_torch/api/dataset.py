"""Public DataSet — lazy operator-graph builder (counterpart of
`tuplex_tpu/api/dataset.py`; reference: python/tuplex/dataset.py — unique:36,
map:49, filter:83, withColumn/mapColumn/selectColumns, collect:113,
columns:365, types:375, aggregate:593, aggregateByKey:644,
exception_counts:707). Every method returns a NEW DataSet over a new
logical operator; nothing executes until collect()."""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

from ..core import typesys as T
from ..plan import aggregates as A
from ..plan import logical as L
from ..plan.physical import plan_stages
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
        exceptions = []
        parts = None
        for stage in plan_stages(self._op):
            if parts is None:
                parts = _source_partitions(self._context, stage.source)
            res = self._context.backend.execute(stage, parts)
            self._context.metrics.record_stage(res.metrics)
            exceptions.extend(res.exceptions)
            parts = res.partitions
        self._last_exceptions = exceptions
        return [v for p in parts for v in C.partition_to_pylist(p)]

    def exception_counts(self) -> dict[str, int]:
        """Counts of unresolved exceptions from the LAST collect() on this
        dataset (reference: dataset.py:707)."""
        counts: dict[str, int] = {}
        for rec in self._last_exceptions:
            counts[rec.exc_name] = counts.get(rec.exc_name, 0) + 1
        return counts


def _source_partitions(context, src) -> list:
    """Materialize a stage source into columnar partitions with one
    dataset-wide string width."""
    if isinstance(src, L.ParallelizeOperator):
        schema = src.schema()
        part_rows = _rows_per_partition(context, schema, len(src.data))
        parts = [C.build_partition(src.data[off: off + part_rows], schema,
                                   start_index=off)
                 for off in range(0, len(src.data), part_rows)]
    else:
        parts = src.load_partitions()
    return C.harmonize_partitions(parts)


def _rows_per_partition(context, schema, total_rows: int) -> int:
    psize = context.options_store.get_size("tuplex.partitionSize", 32 << 20)
    # rough per-row cost: 8B per numeric leaf + 64B per str leaf
    per_row = 0
    for ci, ct in enumerate(schema.types):
        for _, lt in C.flatten_type(ct, str(ci)):
            base = lt.without_option() if lt.is_optional() else lt
            per_row += 64 if base is T.STR else 8
    per_row = max(per_row, 8)
    return max(64, min(total_rows, psize // per_row))
