"""Join operator, inner and left (counterpart of `tuplex_tpu/plan/joins.py`;
reference: core/src/logical/JoinOperator.cc:250, python/tuplex/dataset.py:384
join and :442 leftJoin).

The key column appears once. Output columns are the non-key left columns,
then the key under the left name, then the non-key right columns, with the
optional prefixes and suffixes of each side. The build (right) side is
materialized whole and broadcast to every probe partition; there is no
shuffle (reference: PhysicalPlan.cc:145-178).
"""

from __future__ import annotations

from typing import Optional, Sequence

from ..core import typesys as T
from ..core.errors import TuplexException
from ..core.row import Row
from . import logical as L


class JoinOperator(L.LogicalOperator):
    def __init__(self, left: L.LogicalOperator, right: L.LogicalOperator,
                 left_column: str, right_column: str, how: str = "inner",
                 prefixes: Optional[Sequence[str]] = None,
                 suffixes: Optional[Sequence[str]] = None):
        super().__init__([left, right])
        self.left_column = left_column
        self.right_column = right_column
        self.how = how
        self.prefixes = tuple(prefixes) if prefixes else ("", "")
        self.suffixes = tuple(suffixes) if suffixes else ("", "")

    @property
    def left(self) -> L.LogicalOperator:
        return self.parents[0]

    @property
    def right(self) -> L.LogicalOperator:
        return self.parents[1]

    def is_breaker(self) -> bool:
        return True

    def _decorate(self, name: str, side: int) -> str:
        return f"{self.prefixes[side] or ''}{name}{self.suffixes[side] or ''}"

    def output_layout(self, ls: T.RowType, rs: T.RowType):
        """(columns, types, sources) of the output for input schemas ls and
        rs: sources[i] is (side, input column), side 0 left, 1 right. The
        key column has the left's type (its values are the left's); the
        right columns of a left join are Option."""
        lk = ls.columns.index(self.left_column)
        rk = rs.columns.index(self.right_column)
        cols, types, sources = [], [], []
        for i, (c, t) in enumerate(zip(ls.columns, ls.types)):
            if i != lk:
                cols.append(self._decorate(c, 0))
                types.append(t)
                sources.append((0, i))
        cols.append(self.left_column)
        types.append(ls.types[lk])
        sources.append((0, lk))
        for i, (c, t) in enumerate(zip(rs.columns, rs.types)):
            if i != rk:
                cols.append(self._decorate(c, 1))
                types.append(T.option(t) if self.how == "left" else t)
                sources.append((1, i))
        return cols, types, sources

    def _sides(self):
        ls = self.left.schema()
        rs = self.right.schema()
        if self.left_column not in (ls.columns or ()):
            raise TuplexException(f"unknown left key {self.left_column!r}")
        if self.right_column not in (rs.columns or ()):
            raise TuplexException(f"unknown right key {self.right_column!r}")
        return ls, rs

    def schema(self) -> T.RowType:
        ls, rs = self._sides()
        cols, types, _ = self.output_layout(ls, rs)
        # the key's speculated type covers both sides' keys
        ki = cols.index(self.left_column)
        types[ki] = T.super_type(
            ls.types[ls.columns.index(self.left_column)],
            rs.types[rs.columns.index(self.right_column)])
        return T.row_of(cols, types)

    def sample(self) -> list[Row]:
        ls, rs = self._sides()
        cols = self.schema().columns
        return [Row(v, cols) for v in join_rows(
            self, [tuple(r.values) for r in self.left.cached_sample()],
            [tuple(r.values) for r in self.right.cached_sample()],
            ls.columns.index(self.left_column),
            rs.columns.index(self.right_column), len(rs.columns))]


def join_rows(op: JoinOperator, left: list, right: list, lk: int, rk: int,
              n_right: int, on_error=None) -> list:
    """The join of row tuples by Python's dict equality, left rows in
    order, each with its matches in the right side's order. A right row
    with an unhashable key is unreachable; a left row with one matches
    nothing. A left row without a key column (not a tuple of the schema's
    arity) is passed to on_error(row, exception) and skipped."""
    build: dict = {}
    for r in right:
        try:
            build.setdefault(r[rk], []).append(r)
        except (TypeError, IndexError):
            pass
    out = []
    for r in left:
        try:
            key = r[lk]
        except (TypeError, IndexError) as e:
            if on_error is not None:
                on_error(r, e)
            continue
        try:
            matches = build.get(key, ())
        except TypeError:
            matches = ()
        for m in matches:
            out.append(joined_row(r, lk, m, rk, n_right))
        if not matches and op.how == "left":
            out.append(joined_row(r, lk, None, rk, n_right))
    return out


def joined_row(left, lk: int, right, rk: int, n_right: int) -> tuple:
    """One output row: the left row's values but its key, the key, then
    the right row's values but its key (None for each of the n_right - 1
    when `right` is None, a left join's unmatched row)."""
    rvals = (None,) * (n_right - 1) if right is None else \
        tuple(v for i, v in enumerate(right) if i != rk)
    return tuple(v for i, v in enumerate(left) if i != lk) + \
        (left[lk],) + rvals
