"""Local backend: dual-mode stage execution on one device (counterpart of
`tuplex_tpu/exec/local.py`).

Per partition:

  * the compiled fast path runs the stage function over the staged batch
    (torch ops, the NFA scan as a CUDA kernel on the card)
  * rows whose device error code != 0, and rows that did not conform to
    the normal-case schema, re-run on the interpreter pipeline (the
    reference's ResolveTask)
  * the merge is positional: output rows keep their input order
    (reference: ResolveTask.cc:238-283 merge-in-order)

Device work is queued without waiting: up to `_WINDOW` partitions are in
flight while the host merges an earlier one. A stage that runs a fused
whole-dataset fold fetches the fold's partials and per-row flags, not its
rows (exec/aggexec.py `FoldPartial`); an AggregateStage runs on the
AggregateExecutor. `run_plan` runs a job's stages in order, a JoinStage
on the JoinExecutor after its build side's plan. The reference package's
compiled general-case tier and exact-exception exit need its plan-time
exception inventory and are not ported: every device-error row goes to the
interpreter, which produces the same rows and exception records.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from ..core import typesys as T
from ..core.errors import NotCompilable
from ..core.row import Row
from ..plan import logical as L
from ..plan.physical import (AggregateStage, JoinStage, TransformStage,
                             plan_stages, runtime_output_columns)
from ..runtime import columns as C

_WINDOW = 2   # partitions dispatched ahead of the one being merged


@dataclass
class ExceptionRecord:
    op_id: int
    exc_name: str
    row: Any

    def __repr__(self):
        return f"<{self.exc_name} at op#{self.op_id}: {self.row!r}>"


@dataclass
class StageResult:
    partitions: list[C.Partition]
    exceptions: list[ExceptionRecord] = field(default_factory=list)
    metrics: dict = field(default_factory=dict)


class LocalBackend:
    def __init__(self, device: torch.device):
        self.device = device

    def execute(self, stage, partitions) -> StageResult:
        """Run one transform or aggregate stage over its input partitions
        (a join stage runs through `run_plan`, which has its build side)."""
        if isinstance(stage, AggregateStage):
            from .aggexec import AggregateExecutor

            return AggregateExecutor(self).execute(stage, partitions)
        t0 = time.perf_counter()
        metrics: dict[str, Any] = {k: 0 for k in _SUMMED}
        out_parts: list = []
        exceptions: list[ExceptionRecord] = []
        window: deque = deque()

        def collect_one():
            part, outs, dispatch_s = window.popleft()
            outp, excs, m = self._collect_partition(stage, part, outs,
                                                    dispatch_s)
            for k in _SUMMED:
                metrics[k] += m.get(k, 0)
            exceptions.extend(excs)
            out_parts.append(outp)

        for part in partitions:
            window.append(self._dispatch_partition(part, stage))
            if len(window) > _WINDOW:
                collect_one()
        while window:
            collect_one()
        metrics["tier"] = "interpreter" if stage.not_compilable \
            else "compiled"
        metrics["wall_s"] = time.perf_counter() - t0
        metrics["exception_rows"] = len(exceptions)
        return StageResult(out_parts, exceptions, metrics)

    # ------------------------------------------------------------------
    def _dispatch_partition(self, part: C.Partition, stage: TransformStage,
                            compaction: Optional[bool] = None,
                            fold: bool = True):
        """Stage the batch and queue the stage function's device work
        without waiting for it. Returns (part, outs | None, seconds)."""
        if stage.not_compilable or part.n_normal() == 0:
            return (part, None, 0.0)
        if compaction is None:
            compaction = not stage.compaction_off
        t0 = time.perf_counter()
        batch = C.stage_partition(part, self.device)
        try:
            outs = stage.build_device_fn(part.schema, compaction=compaction,
                                         fold=fold)(batch.arrays)
        except NotCompilable:
            stage.not_compilable = True
            return (part, None, time.perf_counter() - t0)
        return (part, outs, time.perf_counter() - t0)

    def _collect_partition(self, stage: TransformStage, part: C.Partition,
                           outs, dispatch_s: float):
        metrics: dict[str, Any] = {}
        n = part.num_rows
        # rows needing the interpreter: input fallback slots + device errors
        fallback_idx: set[int] = set(part.fallback.keys())
        compiled_ok = np.zeros(n, dtype=np.bool_)
        out_arrays: dict[str, np.ndarray] = {}
        src_map = None
        fold = None
        t0 = time.perf_counter()
        if outs is not None:
            host = self._fetch(outs, metrics)
            fold_on = True
            while True:
                rowidx = host.pop("#rowidx", None)
                ovf = host.pop("#overflow", None)
                if rowidx is not None and bool(ovf):
                    # the sample under-estimated this filter's survivors and
                    # the compaction bucket overflowed: results are
                    # unusable. Re-run without compaction and keep it off
                    # for the stage.
                    stage.compaction_off = True
                elif "#foldcnt" in host and _fold_in_order(stage, part,
                                                           host):
                    # the partition folds in row order on the host: fetch
                    # its rows (the fold is off for this pass only)
                    fold_on = False
                else:
                    break
                _, outs2, d2 = self._dispatch_partition(part, stage,
                                                        fold=fold_on)
                dispatch_s += d2
                host = self._fetch(outs2, metrics)
            if "#foldcnt" in host:
                fold = ([host.pop(f"#fold{i}").item() for i in
                         range(len(stage.fold_spec.reducers))],
                        int(host.pop("#foldcnt")), host.pop("#foldok")[:n])
                host.pop("#foldrisk")
            if rowidx is not None:
                # original row i -> compact slot j (compaction keeps the
                # ascending original order)
                jpos = np.nonzero(rowidx < n)[0]
                src_map = np.full(n, -1, dtype=np.int64)
                src_map[rowidx[jpos]] = jpos
            err = host.pop("#err")[:n]
            keep = host.pop("#keep")[:n]
            rowvalid = np.ones(n, dtype=np.bool_) if part.normal_mask is None \
                else part.normal_mask.astype(np.bool_)
            err_idx = np.nonzero(rowvalid & (err != 0))[0]
            fallback_idx.update(err_idx.tolist())
            metrics["device_error_rows"] = len(err_idx)
            compiled_ok = rowvalid & keep & (err == 0)
            out_arrays = host
            if fold is not None:
                # rows whose fold expression raised re-run on the
                # interpreter, and their output rows fold on the host
                fallback_idx.update(np.nonzero(compiled_ok & ~fold[2])[0]
                                    .tolist())
        else:
            fallback_idx.update(range(n))
        metrics["fast_path_s"] = dispatch_s + time.perf_counter() - t0

        # ---- interpreter path (ResolveTask analog) ------------------------
        t0 = time.perf_counter()
        resolved: dict[int, Row] = {}
        exc_by_row: dict[int, ExceptionRecord] = {}
        if fallback_idx:
            pipeline = stage.python_pipeline()
            order = sorted(fallback_idx)
            ignored = 0
            for i, row in zip(order, C.decode_rows(part, order)):
                status, payload = pipeline(row)
                if status == "ok":
                    resolved[i] = payload
                elif status == "exc":
                    exc_by_row[i] = ExceptionRecord(*payload)
                elif status == "ignored":
                    ignored += 1
            metrics["interpreter_rows"] = len(order)
            metrics["ignored_rows"] = ignored
        exceptions = [exc_by_row[i] for i in sorted(exc_by_row)]
        metrics["slow_path_s"] = time.perf_counter() - t0
        if stage.fold_spec is None:
            return self._merge(stage, part, compiled_ok, out_arrays,
                               resolved, src_map), exceptions, metrics
        # a fused fold returns a FoldPartial: its partials and the rows the
        # host folds after them, or, when the fold did not run on the
        # device, every output row of the partition, in order
        from .aggexec import FoldPartial

        if fold is not None:
            rows = [resolved[i] for i in sorted(resolved)]
            return FoldPartial(fold[0], fold[1], rows), exceptions, metrics
        if outs is None:
            rows = [resolved[i] for i in sorted(resolved)]
        else:
            outp = self._merge(stage, part, compiled_ok, out_arrays,
                               resolved, src_map)
            rows = list(C.decode_rows(outp, range(outp.num_rows)))
        return FoldPartial([], 0, rows), exceptions, metrics

    @staticmethod
    def _fetch(outs: dict, metrics: dict) -> dict:
        """The stage outputs on the host; counts the bytes and the row
        columns (outputs that are not '#' flags or partials) fetched."""
        host = {k: v.cpu().numpy() for k, v in outs.items()}
        metrics["fetch_bytes"] = metrics.get("fetch_bytes", 0) + sum(
            a.nbytes for a in host.values())
        metrics["fetched_row_columns"] = metrics.get(
            "fetched_row_columns", 0) + sum(not k.startswith("#")
                                            for k in host)
        return host

    def _merge(self, stage: TransformStage, part: C.Partition,
               compiled_ok: np.ndarray, out_arrays: dict,
               resolved: dict[int, Row],
               src_map: Optional[np.ndarray] = None) -> C.Partition:
        """Positional merge-in-order (reference: ResolveTask.cc:238-283).

        The output schema comes from the ACTUAL device arrays (never the
        sample-speculated logical schema); with no compiled rows the
        resolved python rows are encoded from scratch."""
        n = part.num_rows
        emit = compiled_ok.copy()
        res_idx = np.asarray(sorted(resolved), dtype=np.int64)
        emit[res_idx] = True
        emit_orig = np.nonzero(emit)[0]          # input rows that emit
        m = len(emit_orig)
        if not out_arrays:
            rows = [resolved[i] for i in emit_orig.tolist()]
            values = [r.unwrap() for r in rows]
            schema = _schema_from_rows(rows) or _normalized_output_schema(
                stage)
            return C.build_partition(values, schema,
                                     start_index=part.start_index)
        n_full = n if src_map is None else \
            int(next(iter(out_arrays.values())).shape[0])
        full = C.partition_from_result_arrays(
            out_arrays, n_full, columns=runtime_output_columns(stage),
            start_index=part.start_index)
        from_device = compiled_ok[emit_orig]
        comp_out = np.nonzero(from_device)[0]
        comp_src = emit_orig[comp_out]
        if src_map is not None and comp_src.size:
            comp_src = src_map[comp_src]
        outp = C.gather_partition(full, comp_out, comp_src, m)
        normal_mask = np.ones(m, dtype=np.bool_)
        fallback: dict[int, Any] = {}
        multi = len(outp.schema.columns) > 1
        for k in np.nonzero(~from_device)[0].tolist():
            row = resolved[int(emit_orig[k])]
            value = tuple(row.values) if multi else row.unwrap()
            if not _try_fold_row(outp.leaves, outp.schema, k, value):
                normal_mask[k] = False
                fallback[k] = value
        if fallback:
            outp.normal_mask = normal_mask
            outp.fallback = fallback
        return outp


def run_plan(context, sink: L.LogicalOperator) -> tuple[list, list]:
    """(partitions, exception records) of the plan ending at `sink`: its
    stages run in order, each over the partitions the one before it
    returned (the first over its source's). A join stage first runs its
    build side's plan, whose exceptions come before the join's own."""
    exceptions: list = []
    parts = None
    for stage in plan_stages(sink):
        if parts is None:
            parts = source_partitions(context, stage.source)
        if isinstance(stage, JoinStage):
            from .joinexec import JoinExecutor

            build, build_excs = run_plan(context, stage.op.right)
            exceptions.extend(build_excs)
            res = JoinExecutor(context.backend).execute(stage, parts, build)
        else:
            res = context.backend.execute(stage, parts)
        context.metrics.record_stage(res.metrics)
        exceptions.extend(res.exceptions)
        parts = res.partitions
    return parts, exceptions


def source_partitions(context, src) -> list:
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


_SUMMED = ("fast_path_s", "slow_path_s", "interpreter_rows",
           "ignored_rows", "device_error_rows", "fetch_bytes",
           "fetched_row_columns")


def _fold_in_order(stage: TransformStage, part: C.Partition,
                   host: dict) -> bool:
    """FoldSpec.in_order for a fused fold's partition: its rows apart
    from the partials are boxed rows, rows the device flagged and rows
    whose fold expression raised."""
    n = part.num_rows
    apart = bool(part.fallback) or bool((host["#err"][:n] != 0).any()) or \
        bool((host["#keep"][:n] & ~host["#foldok"][:n]).any())
    return stage.fold_spec.in_order(bool(host["#foldrisk"]), apart)


def _schema_from_rows(rows: list[Row]) -> Optional[T.RowType]:
    """Normal-case schema speculated from interpreter-produced rows (a
    bounded sample; nonconforming rows box into the fallback)."""
    if not rows:
        return None
    k = len(rows[0].values)
    if any(len(r.values) != k for r in rows):
        return None
    cols = rows[0].columns
    if cols is None or len(cols) != k:
        cols = tuple(f"_{i}" for i in range(k))
    sample = rows[:256]
    types = []
    for ci in range(k):
        nc, _, _ = T.normal_case_type([r.values[ci] for r in sample])
        if nc is T.UNKNOWN:
            return None
        types.append(nc)
    return T.row_of(cols, types)


def _normalized_output_schema(stage: TransformStage) -> T.RowType:
    s = stage.output_schema
    cols = stage.output_columns
    if cols and len(cols) == len(s.types):
        return T.row_of(cols, s.types)
    return s


def _try_fold_row(leaves: dict, schema: T.RowType, k: int,
                  value: Any) -> bool:
    """Write a resolved python row into the columnar slots if it
    conforms (else the caller boxes it)."""
    multi = len(schema.columns) > 1
    row_tuple = value if multi else (value,)
    if multi and not (isinstance(row_tuple, tuple)
                      and len(row_tuple) == len(schema.columns)):
        return False
    for rv, ct in zip(row_tuple, schema.types):
        if not T.python_value_conforms(rv, ct):
            return False
    for ci, (ct, rv) in enumerate(zip(schema.types, row_tuple)):
        for p, lv in C._leaf_paths_for_value(str(ci), ct, rv):
            leaf = leaves[p]
            if isinstance(leaf, C.StrLeaf):
                b = lv.encode("utf-8") if lv is not None else b""
                if len(b) > leaf.bytes.shape[1]:
                    return False  # wider than the column: keep boxed
    for ci, (ct, rv) in enumerate(zip(schema.types, row_tuple)):
        for p, lv in C._leaf_paths_for_value(str(ci), ct, rv):
            leaf = leaves[p]
            if isinstance(leaf, C.StrLeaf):
                b = lv.encode("utf-8") if lv is not None else b""
                leaf.bytes[k, :] = 0
                if b:
                    leaf.bytes[k, : len(b)] = np.frombuffer(b, np.uint8)
                leaf.lengths[k] = len(b)
                if leaf.valid is not None:
                    leaf.valid[k] = lv is not None
            elif isinstance(leaf, C.NumericLeaf):
                if leaf.valid is not None:
                    leaf.valid[k] = lv is not None
                    leaf.data[k] = 0 if lv is None else lv
                else:
                    leaf.data[k] = lv
    return True
