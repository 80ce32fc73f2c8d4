"""A cached dataset (counterpart of `tuplex_tpu/plan/cacheop.py`;
reference: core/include/logical/CacheOperator.h:73-83, dataset.py:346
cache, PhysicalPlan.cc:85-99).

`cache()` runs the upstream plan at once and keeps its output partitions;
later plans start from them (`acts_as_source`: the planner's walk stops
here) and never run the upstream operators again. With
`store_specialized` the partitions stay as the stage returned them:
normal-case rows in the port's columnar host layout, rows outside the
normal case boxed apart. Without it every row is boxed into one
partition. The partitions are kept on the host; a cache resident on the
card is later work.
"""

from __future__ import annotations

from typing import Optional

from ..core import typesys as T
from ..core.row import Row
from . import logical as L


class CacheOperator(L.LogicalOperator):
    acts_as_source = True

    def __init__(self, parent: L.LogicalOperator,
                 store_specialized: bool = True):
        super().__init__([parent])
        self.store_specialized = store_specialized
        self._partitions: Optional[list] = None
        self._schema: Optional[T.RowType] = None
        self.exceptions: list = []

    @property
    def deterministic(self) -> bool:
        """Whether every UDF upstream is deterministic (compiler/analyzer.py
        `chain_deterministic`). False: the cache pins one outcome of a
        chain that would give other rows when run again."""
        memo = getattr(self, "_det_memo", None)
        if memo is None:
            from ..compiler.analyzer import chain_deterministic

            memo = self._det_memo = chain_deterministic(self.parent)
        return memo

    def materialize(self, context) -> None:
        """Run the upstream plan once and keep its output partitions and
        exceptions."""
        if self._partitions is not None:
            return
        from ..exec.local import run_plan
        from ..runtime import columns as C

        parts, self.exceptions = run_plan(context, self.parent)
        parts = [p for p in parts if p.num_rows]
        self._schema = parts[0].schema if parts else self.parent.schema()
        if not self.store_specialized and parts:
            values = [v for p in parts for v in C.partition_to_pylist(p)]
            parts = [C.build_partition(values, self._schema)]
        self._partitions = parts

    def schema(self) -> T.RowType:
        return self._schema if self._schema is not None \
            else self.parent.schema()

    def sample(self) -> list[Row]:
        if not self._partitions:
            return self.parent.cached_sample()
        from ..runtime import columns as C

        p = self._partitions[0]
        return C.decode_rows(p, range(min(p.num_rows, 256)))

    def load_partitions(self) -> list:
        if self._partitions is None:
            raise RuntimeError("cache() was not materialized")
        return list(self._partitions)
