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
  * `unique` keeps the first row of each distinct signature;
  * any other aggregate UDF over a numeric accumulator runs as a general
    fold (plan/aggregates.py `ScanFold`): its row terms are evaluated over
    the staged rows, and its register program folds each key's rows (all
    rows for `aggregate`) in row order, one CUDA thread per key
    (ops/segfold.py, csrc/seg_fold.cu), seeded with each key's running
    value.

The host merges the partitions' partials in partition order and folds, on
the interpreter, every row the device did not: rows boxed outside the
normal case, rows whose fold expression raised (their exception records
name the aggregate operator), and every row of a partition that must fold
in row order (plan/aggregates.py `FoldSpec.in_order`). A general fold
stops a key's segment at its first row that needs the interpreter (a
boxed row, a row the program cannot finish exactly, a running value that
left the device's types stops its whole partition), and the host folds
that row and the segment's later rows, in order, onto the value the card
left: the loop's result, where the reference folds such rows after the
rest of their partition (ROADMAP C10). Rows that raise an exact exception
class on the card become exception records there. A fold outside both
forms runs on the interpreter row by row. Rows folded or deduplicated on
the host count as the stage's `host_folded_rows`, apart from the transform
stages' `interpreter_rows`; a general fold's rows also count in
`scan_rows` and its stopped segments in `scan_stopped_segments`.

A partition handed off by the stage before (exec/local.py) is folded and
deduplicated from its device view: `stage_partition` takes the view, and
the key tuples and the rows the interpreter folds are gathered from it
on the device, so only those rows are fetched. A fused fold's
`FoldPartial` has no partition and is unchanged.

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
import torch

from ..compiler.stagefn import input_row_cv
from ..core.errors import NotCompilable, exception_name
from ..core.row import Row
from ..ops import fold as F
from ..ops import segfold as SF
from ..plan import aggregates as A
from ..plan.physical import eval_fold_terms, eval_row_terms
from ..runtime import columns as C
from ..runtime import xferstats


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
        self.budget = backend.handoff_budget
        self.device_rows = 0     # rows folded or deduplicated on the device
        self.host_rows = 0       # rows folded on the host (unique: boxed
                                 # rows, which skip the device)
        self.device_s = 0.0
        self.scan_rows = 0       # rows in a general fold's segments
        self.scan_stopped = 0    # its segments that stopped for the host

    def execute(self, stage, partitions: list, consumer=False):
        from .local import Handoff, StageResult

        op = stage.op
        t0 = time.perf_counter()
        snap = xferstats.snapshot()
        if isinstance(op, A.UniqueOperator):
            parts, excs = self._unique(op, partitions)
        elif isinstance(op, (A.AggregateOperator, A.AggregateByKeyOperator)):
            parts, excs = self._aggregate(op, partitions)
        else:
            raise NotCompilable(f"aggregate stage op {op!r}")
        handoff = Handoff(self.budget, consumer)
        for p in parts:
            handoff.offer_host(p, self.device)
        wall = time.perf_counter() - t0
        return StageResult(parts, excs, {
            "wall_s": wall, "fast_path_s": self.device_s,
            "slow_path_s": wall - self.device_s,
            "host_folded_rows": self.host_rows,
            "device_rows": self.device_rows, "exception_rows": len(excs),
            "scan_rows": self.scan_rows,
            "scan_stopped_segments": self.scan_stopped,
            **handoff.metrics(), **xferstats.since(snap)})

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
                C.release_view(part)
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
            C.release_view(part)
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
        first = xferstats.to_host(first)
        self.device_rows += part.n_normal()
        self.host_rows += len(part.fallback)
        self.device_s += time.perf_counter() - t0
        return first

    # ------------------------------------------------------------------
    def _aggregate(self, op, partitions):
        by_key = isinstance(op, A.AggregateByKeyOperator)
        spec = A.device_fold_spec(op)
        scan = A.ScanFold.try_build(op) if spec is None else None
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
                C.release_view(part)
                continue
            kidx = [part.schema.columns.index(c) for c in op.key_columns] \
                if by_key else None
            if scan is not None and self._scan_fold(op, scan, part, kidx,
                                                    groups, excs):
                C.release_view(part)
                continue
            res = self._device_fold(spec, part, kidx) if spec and by_key \
                else None
            if res is None:
                self._python_fold(op, C.decode_rows(
                    part, range(part.num_rows)), groups, kidx, excs)
                C.release_view(part)
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
            C.release_view(part)
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
                     index=None, new: Optional[dict] = None,
                     at: Optional[list] = None) -> None:
        """Fold rows on the interpreter, in order. `new` (key -> first
        folded row) gains keys the fold adds, at their row `index`; `at`
        gains the row `index` of each exception record."""
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
                if at is not None:
                    at.append(index[j])
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
        bad = np.nonzero(xferstats.to_host(rowvalid & ~ok)[:part.num_rows])[0]
        bad = sorted(set(bad.tolist()) | set(part.fallback))
        if spec.in_order(bool(risk), bool(bad)):
            return None
        codes, first = F.factorize(sig, ok)
        nseg = first.shape[0]
        sel = codes >= 0
        cs = codes[sel]
        cols = [xferstats.to_host(F.segment_reduce(d[sel], cs, nseg,
                                                   r)).tolist()
                for d, r in zip(datas, spec.reducers)]
        partials = [list(r) for r in zip(*cols)]
        firsts = xferstats.to_host(first).tolist()
        keys = C.decode_key_tuples(part, firsts, kidx)
        self.device_rows += cs.numel()
        self.device_s += time.perf_counter() - t0
        return keys, firsts, partials, bad


    def _scan_fold(self, op, scan, part, kidx, groups: dict,
                   excs: list) -> bool:
        """One partition of a general fold: each key's rows (every row for
        `aggregate`) folded in row order on the device from the key's
        running value, the stopped segments' rows and the boxed rows then
        folded on the interpreter in row order. False (nothing folded)
        when the partition must fold on the interpreter: a term outside
        the compiled subset, or a running value the device cannot carry."""
        from .local import ExceptionRecord

        t0 = time.perf_counter()
        try:
            batch = C.stage_partition(part, self.device)
            b, rowvalid = batch.b, batch.arrays["#rowvalid"]
            row = input_row_cv(batch.arrays, part.schema)
            vals, metas = eval_row_terms(scan.prog, row, rowvalid, b,
                                         self.device)
            if kidx is not None:
                cvs = [row.elts[c] for c in kidx] if row.elts is not None \
                    else [row]
                sig = F.signature(cvs, b, self.device)
        except NotCompilable:
            return False
        boxed = sorted(part.fallback)
        limits = [b]
        if kidx is None:
            keys = [()]
            codes = torch.where(rowvalid, 0, -1)
            if boxed:
                limits = [boxed[0]]
        else:
            codes, first = F.factorize(sig, rowvalid)
            keys = C.decode_key_tuples(part, xferstats.to_host(first), kidx)
            limits = [b] * len(keys)
            seg_of = {}
            for si, k in enumerate(keys):
                seg_of.setdefault(k, si)
            for i, r in zip(boxed, C.decode_rows(part, boxed)):
                try:
                    si = seg_of.get(tuple(r.values[c] for c in kidx))
                except TypeError:      # an unhashable key: no segment's
                    continue
                if si is not None:
                    limits[si] = min(limits[si], i)
        seeds = scan.encode_segments([groups.get(k, op.initial)
                                      for k in keys])
        if not keys or seeds is None:
            return False
        order, offsets = SF.segment_layout(codes, len(keys))
        res = SF.seg_fold(scan.prog, vals, metas, order, offsets,
                          xferstats.to_device(np.array(limits, np.int64),
                                              self.device),
                          xferstats.to_device(seeds[0], self.device),
                          xferstats.to_device(seeds[1], self.device))
        hot = torch.nonzero(res.status >= SF.ST_HOST).squeeze(1)
        hot_st = xferstats.to_host(res.status[hot]).tolist()
        hot = xferstats.to_host(hot).tolist()
        accs = scan.decode_segments(xferstats.to_host(res.acc),
                                    xferstats.to_host(res.acc_tags))
        firsts, counts, stops = (xferstats.to_host(t).tolist() for t in
                                 (res.first, res.count, res.stop))
        new: dict = {}
        for k, acc, fst, cnt in zip(keys, accs, firsts, counts):
            if cnt:
                if k not in groups:
                    new[k] = fst
                groups[k] = acc
        exc_rows = [(i, st) for i, st in zip(hot, hot_st)
                    if st >= SF.ST_EXC]
        records = [(i, ExceptionRecord(op.id, exception_name(st - SF.ST_EXC),
                                       r.unwrap()))
                   for (i, st), r in zip(exc_rows, C.decode_rows(
                       part, [i for i, _ in exc_rows]))]
        self.device_rows += sum(counts) + len(exc_rows)
        self.scan_rows += order.shape[0]
        self.scan_stopped += sum(s >= 0 for s in stops)
        self.device_s += time.perf_counter() - t0
        host = sorted(set(boxed) | {i for i, st in zip(hot, hot_st)
                                    if st == SF.ST_HOST})
        host_excs: list = []
        at: list = []
        self._python_fold(op, C.decode_rows(part, host), groups, kidx,
                          host_excs, host, new, at)
        records += zip(at, host_excs)
        records.sort(key=lambda t: t[0])
        excs.extend(r for _, r in records)
        if new:
            # keys new in this partition enter in the order of their first
            # folded row, device or interpreter
            for k in sorted(new, key=new.__getitem__):
                groups[k] = groups.pop(k)
        return True


def _merge(spec, acc, partials: list):
    """acc with each term's device partial folded in."""
    if spec.scalar:
        return spec.combine(0, acc, partials[0])
    return tuple(spec.combine(i, a, p)
                 for i, (a, p) in enumerate(zip(acc, partials)))
