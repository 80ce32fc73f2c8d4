"""The aggregate stage: unique, aggregate and aggregateByKey (counterpart
of `tuplex_tpu/exec/aggexec.py`).

Per partition, on the device:

  * a recognized whole-dataset fold (plan/aggregates.py `recognize_fold`)
    runs inside the transform stage before the aggregate (plan/physical.py
    `_emit_fused_fold`), which hands over a `FoldPartial`;
  * a recognized by-key fold evaluates its expressions over the staged
    rows and reduces them per key, the keys factorized by one torch.unique
    over their byte signatures and numbered in the order of their first
    row (ops/fold.py);
  * `unique` keeps the first row of each distinct signature.

The host merges the partitions' partials in partition order and folds, on
the interpreter, every row the device did not: rows boxed outside the
normal case, rows whose fold expression raised (their exception records
name the aggregate operator), and every row of a partition that must fold
in row order (plan/aggregates.py `FoldSpec.in_order`). A fold that is not
recognized runs on the interpreter row by row. Rows folded or deduplicated
on the host count as the stage's `host_folded_rows`, apart from the
transform stages' `interpreter_rows`.

What the port fixes where the reference's device path differs from a
plain loop: `aggregateByKey` and `unique` emit their groups in the order
their first row folded (the reference sorts a partition's keys by bytes);
the initial value seeds each key once; a key whose rows all raised emits
no row; `aggregate` over no rows is `[initial]`, `aggregateByKey` and
`unique` over no rows are `[]`.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..compiler.stagefn import input_row_cv
from ..core.errors import NotCompilable
from ..core.row import Row
from ..ops import fold as F
from ..plan import aggregates as A
from ..plan.physical import eval_fold_terms
from ..runtime import columns as C


@dataclass
class FoldPartial:
    """What a transform stage with a fused fold returns for one partition
    in place of its rows: the fold's partials over the rows the device
    folded (`count` of them), and the stage's output rows the host folds
    after them, in row order."""
    partials: list
    count: int
    rows: list[Row] = field(default_factory=list)

    @property
    def num_rows(self) -> int:
        return len(self.rows)


class AggregateExecutor:
    def __init__(self, backend):
        self.device = backend.device
        self.device_rows = 0     # rows folded or deduplicated on the device
        self.host_rows = 0       # rows folded on the host (unique: boxed
                                 # rows, which skip the device)
        self.device_s = 0.0

    def execute(self, stage, partitions: list):
        from .local import StageResult

        op = stage.op
        t0 = time.perf_counter()
        if isinstance(op, A.UniqueOperator):
            parts, excs = self._unique(op, partitions)
        elif isinstance(op, (A.AggregateOperator, A.AggregateByKeyOperator)):
            parts, excs = self._aggregate(op, partitions)
        else:
            raise NotCompilable(f"aggregate stage op {op!r}")
        wall = time.perf_counter() - t0
        return StageResult(parts, excs, {
            "wall_s": wall, "fast_path_s": self.device_s,
            "slow_path_s": wall - self.device_s,
            "host_folded_rows": self.host_rows,
            "device_rows": self.device_rows, "exception_rows": len(excs)})

    # ------------------------------------------------------------------
    def _unique(self, op, partitions):
        """Distinct rows, first occurrence first: the device keeps each
        partition's first row per signature, the host merges across
        partitions with a set of the rows' values."""
        seen: set = set()
        out: list[Row] = []
        schema = None
        for part in partitions:
            if part.num_rows == 0:
                continue
            schema = schema or part.schema
            first = self._distinct_rows(part)
            cand = range(part.num_rows) if first is None else \
                sorted(set(first.tolist()) | set(part.fallback))
            for r in C.decode_rows(part, cand):
                try:
                    if tuple(r.values) in seen:
                        continue
                    seen.add(tuple(r.values))
                except TypeError:
                    pass    # an unhashable row stays
                out.append(r)
        if not out:
            return [], []
        single = len(schema.columns) == 1
        return [C.build_partition(
            [r.unwrap() if single else tuple(r.values) for r in out],
            schema)], []

    def _distinct_rows(self, part) -> Optional[np.ndarray]:
        """The first row of each distinct signature among the partition's
        normal rows, ascending; None when a column has no device layout."""
        t0 = time.perf_counter()
        try:
            batch = C.stage_partition(part, self.device)
            row = input_row_cv(batch.arrays, part.schema)
            sig = F.signature([row], batch.b, self.device)
        except NotCompilable:
            return None
        _, first = F.factorize(sig, batch.arrays["#rowvalid"])
        first = first.cpu().numpy()
        self.device_rows += part.n_normal()
        self.host_rows += len(part.fallback)
        self.device_s += time.perf_counter() - t0
        return first

    # ------------------------------------------------------------------
    def _aggregate(self, op, partitions):
        by_key = isinstance(op, A.AggregateByKeyOperator)
        spec = A.device_fold_spec(op)
        excs: list = []
        groups: dict = {} if by_key else {(): op.initial}
        for part in partitions:
            if isinstance(part, FoldPartial):
                self.device_rows += part.count
                if part.count:
                    groups[()] = _merge(spec, groups[()], part.partials)
                self._python_fold(op, part.rows, groups, None, excs)
                continue
            if part.num_rows == 0:
                continue
            kidx = [part.schema.columns.index(c) for c in op.key_columns] \
                if by_key else None
            res = self._device_fold(spec, part, kidx) if spec and by_key \
                else None
            if res is None:
                self._python_fold(op, C.decode_rows(
                    part, range(part.num_rows)), groups, kidx, excs)
                continue
            # a key whose every row raised has no segment: it emits no row
            # unless the interpreter folds one of its rows
            keys, firsts, partials, bad = res
            new: dict = {}
            for si, k in enumerate(keys):
                if k in groups:
                    groups[k] = _merge(spec, groups[k], partials[si])
                else:
                    groups[k] = _merge(spec, op.initial, partials[si])
                    new[k] = firsts[si]
            self._python_fold(op, C.decode_rows(part, bad), groups, kidx,
                              excs, bad, new)
            if new:
                # keys new in this partition enter in the order of their
                # first folded row, device or interpreter
                order = sorted(new, key=new.__getitem__)
                for k in order:
                    groups[k] = groups.pop(k)
        if by_key:
            values = [tuple(k) + (acc if isinstance(acc, tuple) else (acc,))
                      for k, acc in groups.items()]
            if not values:
                return [], excs
        else:
            values = [groups[()]]
        return [C.build_partition(values, op.schema())], excs

    def _python_fold(self, op, rows, groups: dict, kidx, excs,
                     index=None, new: Optional[dict] = None) -> None:
        """Fold rows on the interpreter, in order. `new` (key -> first
        folded row) gains keys the fold adds, at their row `index`."""
        for j, row in enumerate(rows):
            k = () if kidx is None else tuple(row.values[c] for c in kidx)
            fresh = k not in groups
            try:
                groups[k] = A.apply_agg(op.aggregate_udf,
                                        groups.get(k, op.initial), row)
            except Exception as e:
                from .local import ExceptionRecord

                excs.append(ExceptionRecord(op.id, type(e).__name__,
                                            row.unwrap()))
                continue
            if new is not None and (fresh or k in new):
                new[k] = min(new.get(k, index[j]), index[j])
        self.host_rows += len(rows)

    def _device_fold(self, spec, part, kidx):
        """One partition's recognized by-key fold on the device: (keys,
        their first rows, partials per key, rows the interpreter folds),
        or None when the partition folds on the interpreter. Only keys with
        a row the device folded have a segment."""
        t0 = time.perf_counter()
        try:
            batch = C.stage_partition(part, self.device)
            b, rowvalid = batch.b, batch.arrays["#rowvalid"]
            row = input_row_cv(batch.arrays, part.schema)
            datas, ok, risk = eval_fold_terms(spec, row, rowvalid, b,
                                              self.device)
            cvs = [row.elts[c] for c in kidx] if row.elts is not None \
                else [row]
            sig = F.signature(cvs, b, self.device)
        except NotCompilable:
            return None
        bad = np.nonzero((rowvalid & ~ok).cpu().numpy()[:part.num_rows])[0]
        bad = sorted(set(bad.tolist()) | set(part.fallback))
        if spec.in_order(bool(risk), bool(bad)):
            return None
        codes, first = F.factorize(sig, ok)
        nseg = first.shape[0]
        sel = codes >= 0
        cs = codes[sel]
        cols = [F.segment_reduce(d[sel], cs, nseg, r).tolist()
                for d, r in zip(datas, spec.reducers)]
        partials = [list(r) for r in zip(*cols)]
        firsts = first.tolist()
        keys = C.decode_key_tuples(part, firsts, kidx)
        self.device_rows += cs.numel()
        self.device_s += time.perf_counter() - t0
        return keys, firsts, partials, bad


def _merge(spec, acc, partials: list):
    """acc with each term's device partial folded in."""
    if spec.scalar:
        return spec.combine(0, acc, partials[0])
    return tuple(spec.combine(i, a, p)
                 for i, (a, p) in enumerate(zip(acc, partials)))
