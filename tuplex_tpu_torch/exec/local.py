"""Local backend: dual-mode stage execution on one device (counterpart of
`tuplex_tpu/exec/local.py`).

Per partition:

  * the compiled fast path runs the stage function over the staged batch
    (torch ops, the NFA scan as a CUDA kernel on the card)
  * rows the fast path flagged go down the resolve tiers the stage's
    ResolvePlan names (plan/physical.py):
      - the compiled general-case tier: rows with an internal code re-run
        on the stage's device through the stage function built under the
        decode's general-case types (`_general_case_pass`); rows it
        finishes merge like interpreter rows, and its codes replace the
        fast path's
      - the exact exit: in a stage without resolve or ignore operators, a
        row whose code is a Python exception class becomes an exception
        record straight off the lattice (class and operator id)
      - the interpreter: every other flagged row, and every input row
        outside the normal-case schema, re-runs on the stage's Python
        pipeline (the reference's ResolveTask)
  * the merge is positional: output rows keep their input order
    (reference: ResolveTask.cc:238-283 merge-in-order)

Device work is queued without waiting: up to `_WINDOW` partitions are in
flight while the host merges an earlier one. Each partition's stage
function runs through the compile plane (exec/compilequeue.py): captured
as a CUDA graph for the first partition of a (stage, input shapes) key,
replayed for later ones; the re-runs below (an '#overflow' without
compaction, a fold turned off) are keys of their own. A stage that runs a
fused whole-dataset fold fetches the fold's partials and per-row flags,
not its rows (exec/aggexec.py `FoldPartial`); an AggregateStage runs on the
AggregateExecutor. `run_plan` runs a job's stages in order, a JoinStage
on the JoinExecutor after its build side's plan.

The device handoff (the reference's `execute_any(intermediate=)`): a
stage whose output feeds another stage, a join or an aggregate
(plan/physical.py `consumer_kind`) fetches only its control arrays
('#err', '#keep', '#rowidx', '#overflow'). Its output partitions keep
their columns on the device as a view gathered at the compiled rows'
sources (runtime/columns.py `DeviceView`), with host leaves fetched from
the view only when read. Rows the general tier or the interpreter
finished are encoded on the host and only they are copied into the view;
rows that stay boxed are not `#rowvalid` there. The consumer stages from
the view, and its slow paths gather their rows from it; it drops the view
when it has finished the partition. `Handoff` counts, per stage, the
partitions handed off and the ones that took the host route, by reason:
the stage's budget (`LocalBackend.handoff_budget`, runtime/torchcfg.py;
0 sends every partition by the host route) would be exceeded, a leaf has
no device layout, or nothing on the device consumes the output.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from ..core import typesys as T
from ..core.errors import (ExceptionCode, NotCompilable,
                           exception_class_for_code, exception_name,
                           unpack_device_codes)
from ..core.row import Row
from ..plan import logical as L
from ..plan.physical import (AggregateStage, JoinStage, TransformStage,
                             consumer_kind, plan_stages,
                             runtime_output_columns)
from ..runtime import columns as C
from ..runtime import xferstats
from ..runtime.torchcfg import handoff_budget_bytes
from . import compilequeue

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


class Handoff:
    """One stage's device handoff: its consumer (plan/physical.py
    `consumer_kind`), the device bytes its output views may still take,
    and the route each output partition took."""

    REASONS = ("budget", "no_layout", "no_consumer")

    def __init__(self, budget: int, consumer):
        self.consumer, self.budget, self.left = consumer, budget, budget
        self.parts = 0
        self.host = {r: 0 for r in self.REASONS}

    def route(self, nbytes: Optional[int]) -> bool:
        """Whether an output partition whose view takes `nbytes` (None: a
        leaf without a device layout) is handed off on the device; counts
        the route it takes and charges the budget."""
        if not self.consumer:
            reason = "no_consumer"
        elif nbytes is None:
            reason = "no_layout"
        elif nbytes > self.left:
            reason = "budget"
        else:
            self.left -= nbytes
            self.parts += 1
            return True
        self.host[reason] += 1
        return False

    def offer_host(self, part: C.Partition, device) -> None:
        """Route an output partition built on the host: handed off, it is
        staged on the device now."""
        if self.route(C.view_nbytes(part.leaves, part.num_rows)):
            C.attach_staged_view(part, device)

    def metrics(self) -> dict:
        m = {"handoff_parts": self.parts,
             "host_route_parts": sum(self.host.values()),
             "handoff_budget_bytes": self.budget}
        m.update({f"host_route_{r}": v for r, v in self.host.items()})
        return m


class LocalBackend:
    def __init__(self, device: torch.device):
        self.device = device
        # device bytes each stage's handed-off outputs may hold; 0 sends
        # every partition by the host route
        self.handoff_budget = handoff_budget_bytes(device)

    def execute(self, stage, partitions, consumer=False) -> StageResult:
        """Run one transform or aggregate stage over its input partitions
        (a join stage runs through `run_plan`, which has its build side).
        `consumer` is who takes its output (plan/physical.py
        `consumer_kind`)."""
        if isinstance(stage, AggregateStage):
            from .aggexec import AggregateExecutor

            return AggregateExecutor(self).execute(stage, partitions,
                                                   consumer)
        t0 = time.perf_counter()
        snap = xferstats.snapshot()
        cq_snap = compilequeue.snapshot()
        handoff = Handoff(self.handoff_budget, consumer)
        metrics: dict[str, Any] = {k: 0 for k in _SUMMED}
        out_parts: list = []
        exceptions: list[ExceptionRecord] = []
        window: deque = deque()
        limit, emitted = stage.limit, 0

        def collect_one():
            nonlocal emitted
            part, outs, dispatch_s = window.popleft()
            if 0 <= limit <= emitted:
                # the limit is met: work dispatched ahead is dropped
                C.release_view(part)
                metrics["dropped_parts"] += 1
                return
            outp, excs, m = self._collect_partition(stage, part, outs,
                                                    dispatch_s, handoff)
            C.release_view(part)
            for k in _SUMMED:
                metrics[k] += m.get(k, 0)
            exceptions.extend(excs)
            if limit >= 0:
                outp = _truncate_partition(outp, limit - emitted)
                emitted += outp.num_rows
            out_parts.append(outp)

        for part in partitions:
            if 0 <= limit <= emitted:
                break   # no partition is dispatched past the window
            window.append(self._dispatch_partition(part, stage))
            metrics["dispatched_parts"] += 1
            if len(window) > _WINDOW:
                collect_one()
        while window:
            collect_one()
        metrics["tier"] = "interpreter" if stage.not_compilable \
            else "compiled"
        metrics["resolve_tier"] = stage.resolve_plan().tier
        metrics["wall_s"] = time.perf_counter() - t0
        metrics["exception_rows"] = len(exceptions)
        metrics.update(handoff.metrics())
        metrics.update(xferstats.since(snap))
        metrics.update(compilequeue.stage_metrics(
            compilequeue.delta(cq_snap)))
        return StageResult(out_parts, exceptions, metrics)

    # ------------------------------------------------------------------
    def _dispatch_partition(self, part: C.Partition, stage: TransformStage,
                            compaction: Optional[bool] = None,
                            fold: bool = True):
        """Stage the batch and queue the stage function's device work
        without waiting for it, through the compile plane (a replay of the
        stage's graph for this key, else a capture or an eager run).
        Returns (part, outs | None, seconds)."""
        if stage.not_compilable or part.n_normal() == 0:
            return (part, None, 0.0)
        if compaction is None:
            compaction = not stage.compaction_off
        t0 = time.perf_counter()
        try:
            outs = compilequeue.run_stage(stage, part, self.device,
                                          compaction, fold)
        except NotCompilable:
            stage.not_compilable = True
            return (part, None, time.perf_counter() - t0)
        return (part, outs, time.perf_counter() - t0)

    def _collect_partition(self, stage: TransformStage, part: C.Partition,
                           outs, dispatch_s: float, handoff: Handoff):
        metrics: dict[str, Any] = {}
        # a partition bound for a device consumer fetches its control
        # arrays only; a fused fold's output never hands off
        lazy = bool(handoff.consumer) and stage.fold_spec is None
        n = part.num_rows
        # rows needing the interpreter: input fallback slots + device errors
        fallback_idx: set[int] = set(part.fallback.keys())
        compiled_ok = np.zeros(n, dtype=np.bool_)
        out_arrays: dict[str, np.ndarray] = {}
        src_map = None
        fold = None
        bufs = stage.resolve_plan().new_buffers()
        t0 = time.perf_counter()
        if outs is not None:
            host = self._fetch(outs, metrics, lazy)
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
                _, outs, d2 = self._dispatch_partition(part, stage,
                                                       fold=fold_on)
                dispatch_s += d2
                host = self._fetch(outs, metrics, lazy)
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
            bufs.add_many(err_idx, err[err_idx])
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
        resolved: dict[int, Row] = {}
        exact = bufs.exact_rows()

        # ---- compiled general-case tier (ResolveTask resolve_f analog) ----
        if fallback_idx and outs is not None and \
                stage.resolve_plan().use_general:
            t0 = time.perf_counter()
            cand = [(i, code) for i, code, _ in bufs.internal_rows()
                    if i not in part.fallback]
            if cand:
                exact += self._general_case_pass(stage, part, cand,
                                                 fallback_idx, resolved,
                                                 metrics)
            metrics["general_path_s"] = time.perf_counter() - t0

        # ---- exact exceptions: no resolver, no interpreter run ------------
        exc_by_row: dict[int, ExceptionRecord] = {}
        if exact and not stage.has_resolvers:
            exact.sort()
            rows = C.decode_rows(part, [i for i, _, _ in exact])
            for (i, code, op_id), row in zip(exact, rows):
                exc_by_row[i] = ExceptionRecord(op_id, exception_name(code),
                                                row.unwrap())
                fallback_idx.discard(i)
            metrics["exact_exit_rows"] = len(exact)

        # ---- interpreter path (ResolveTask analog) ------------------------
        t0 = time.perf_counter()
        if fallback_idx:
            pipeline = stage.python_pipeline(part.user_columns)
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
            on_dev = None
            if lazy and outs is not None:
                on_dev = {k: v for k, v in outs.items()
                          if not k.startswith("#")}
            return self._merge(stage, part, compiled_ok, out_arrays,
                               resolved, src_map, handoff, on_dev,
                               metrics), exceptions, metrics
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

    def _general_case_pass(self, stage: TransformStage, part: C.Partition,
                           cand: list, fallback_idx: set, resolved: dict,
                           metrics: dict) -> list:
        """The compiled general-case tier (reference: `_general_case_pass`,
        exec/local.py:1664; StageBuilder.cc:1145 generateResolveCodePath):
        the candidate rows `cand` (internal codes, not boxed) re-run as a
        sub-partition on the stage's device through the stage function
        built under the general-case decode. A row it finishes leaves
        `fallback_idx` (into `resolved` unless a filter dropped it); its
        other rows keep going down the tiers under the general run's code.

        A cell that does not parse as its column's type is a string on the
        interpreter: a row the fast path flagged so re-runs with those
        columns decoded as str (`_general_groups`), in a group with the
        rows that share them. Returns (row, code, op_id) of the rows the
        general run coded with a Python exception class. A stage function
        the emitter rejects leaves its rows to the interpreter, counted in
        `general_not_compilable_rows`."""
        from ..plan.physical import runtime_output_columns

        exact: list = []
        retired = refused = 0
        for str_cols, idx in _general_groups(stage, part, cand).items():
            k = len(idx)
            if str_cols in stage.general_refused:
                refused += k
                continue
            batch = C.stage_rows(part, idx, self.device)
            try:
                outs = stage.build_device_fn(part.schema, general=True,
                                             str_cols=str_cols)(batch.arrays)
            except NotCompilable:
                stage.general_refused.add(str_cols)
                refused += k
                continue
            host = {kk: xferstats.to_host(v) for kk, v in outs.items()}
            err = host.pop("#err")[:k]
            keep = host.pop("#keep")[:k]
            ok = err == 0
            bad_j = np.nonzero(~ok)[0]
            for j, (code, op_id) in zip(bad_j.tolist(),
                                        unpack_device_codes(err[bad_j])):
                if exception_class_for_code(code) is not None:
                    exact.append((int(idx[j]), code, op_id))
            ok_j = np.nonzero(ok)[0]
            if not len(ok_j):
                continue
            retired += len(ok_j)
            outp = C.partition_from_result_arrays(
                host, k, columns=runtime_output_columns(stage))
            vals = C.partition_to_pylist(outp)
            cols = outp.user_columns
            single = len(outp.schema.types) == 1
            for j in ok_j.tolist():
                i = int(idx[j])
                fallback_idx.discard(i)
                if keep[j]:
                    v = vals[j]
                    resolved[i] = Row((v,), cols) if single else Row(v, cols)
        metrics["general_rows"] = retired
        metrics["general_not_compilable_rows"] = refused
        return exact

    @staticmethod
    def _fetch(outs: dict, metrics: dict, control_only: bool = False
               ) -> dict:
        """The stage outputs on the host (with `control_only`, only the '#'
        flags and partials); counts the bytes and the row columns (outputs
        that are not '#' flags or partials) fetched."""
        host = {k: xferstats.to_host(v) for k, v in outs.items()
                if not control_only or k.startswith("#")}
        metrics["fetch_bytes"] = metrics.get("fetch_bytes", 0) + sum(
            a.nbytes for a in host.values())
        metrics["fetched_row_columns"] = metrics.get(
            "fetched_row_columns", 0) + sum(not k.startswith("#")
                                            for k in host)
        return host

    def _merge(self, stage: TransformStage, part: C.Partition,
               compiled_ok: np.ndarray, out_arrays: dict,
               resolved: dict[int, Row],
               src_map: Optional[np.ndarray] = None,
               handoff: Optional[Handoff] = None,
               on_dev: Optional[dict] = None,
               metrics: Optional[dict] = None) -> C.Partition:
        """Positional merge-in-order (reference: ResolveTask.cc:238-283).

        The output schema comes from the ACTUAL device arrays (never the
        sample-speculated logical schema); with no compiled rows the
        resolved python rows are encoded from scratch. `on_dev` holds the
        data outputs still on the device (a partition bound for a device
        consumer): when `handoff` routes the partition to the device its
        view is gathered from them (the host leaves lazy), else they are
        fetched now."""
        n = part.num_rows
        emit = compiled_ok.copy()
        res_idx = np.asarray(sorted(resolved), dtype=np.int64)
        emit[res_idx] = True
        emit_orig = np.nonzero(emit)[0]          # input rows that emit
        m = len(emit_orig)
        if not out_arrays and on_dev is None:
            rows = [resolved[i] for i in emit_orig.tolist()]
            values = [r.unwrap() for r in rows]
            schema = _schema_from_rows(rows) or _normalized_output_schema(
                stage)
            outp = C.build_partition(values, schema,
                                     start_index=part.start_index)
            if handoff is not None:
                handoff.offer_host(outp, self.device)
            return outp
        arrays = out_arrays if on_dev is None else on_dev
        n_full = n if src_map is None else \
            int(next(iter(arrays.values())).shape[0])
        full = C.partition_from_result_arrays(
            arrays, n_full, columns=runtime_output_columns(stage),
            start_index=part.start_index)
        from_device = compiled_ok[emit_orig]
        comp_out = np.nonzero(from_device)[0]
        comp_src = emit_orig[comp_out]
        if src_map is not None and comp_src.size:
            comp_src = src_map[comp_src]
        multi = len(full.schema.columns) > 1
        ks = np.nonzero(~from_device)[0]
        values = [tuple(r.values) if multi else r.unwrap()
                  for r in (resolved[int(i)] for i in emit_orig[ks])]
        view = None
        if handoff is not None and handoff.route(
                C.view_nbytes(full.leaves, m)):
            view = C.gather_view(
                full.leaves, m, self.device,
                xferstats.to_device(comp_out, self.device),
                xferstats.to_device(comp_src, self.device))
            outp = C.Partition(schema=full.schema, num_rows=m,
                               start_index=part.start_index)
            C.hand_off(outp, view)
            boxed = _fold_rows_view(view, outp.schema, ks, values)
        else:
            if on_dev is not None:
                full = C.partition_from_result_arrays(
                    self._fetch(on_dev, metrics), n_full,
                    columns=runtime_output_columns(stage),
                    start_index=part.start_index)
            outp = C.gather_partition(full, comp_out, comp_src, m)
            boxed = _fold_rows(outp, ks, values)
        if boxed.any():
            outp.normal_mask = np.ones(m, dtype=np.bool_)
            outp.normal_mask[ks[boxed]] = False
            outp.fallback = {int(ks[j]): values[j]
                             for j in np.nonzero(boxed)[0].tolist()}
            if view is not None:
                view.arrays["#rowvalid"][
                    xferstats.to_device(ks[boxed], self.device)] = False
        return outp


def run_plan(context, sink: L.LogicalOperator) -> tuple[list, list]:
    """(partitions, exception records) of the plan ending at `sink`,
    planned under the context's options: its stages run in order, each
    over the partitions the one before it returned (the first over its
    source's, read lazily when it has a limit). A join stage first runs
    its build side's plan, whose exceptions come before the join's own.
    The plan's record (`Metrics.record_plan`) counts its stages,
    interpreter segments and the operators the analyzer routed."""
    from ..compiler import analyzer as AZ

    exceptions: list = []
    parts = None
    snap = AZ.snapshot()
    stages = plan_stages(sink, context.options_store)
    context.metrics.record_plan({
        "stages": len(stages),
        "interpreter_segments": sum(getattr(s, "force_interpret", False)
                                    for s in stages),
        "plan_fallback_ops": AZ.delta(snap)["plan_fallback_ops"]})
    for si, stage in enumerate(stages):
        if parts is None:
            parts = source_partitions(
                context, stage.source,
                lazy=isinstance(stage, TransformStage) and stage.limit >= 0)
        consumer = consumer_kind(stages, si)
        if isinstance(stage, JoinStage):
            from .joinexec import JoinExecutor

            build, build_excs = run_plan(context, stage.op.right)
            exceptions.extend(build_excs)
            res = JoinExecutor(context.backend).execute(stage, parts, build,
                                                        consumer)
        else:
            res = context.backend.execute(stage, parts, consumer)
        context.metrics.record_stage(res.metrics)
        exceptions.extend(res.exceptions)
        parts = res.partitions
        if stage.limit >= 0 and not isinstance(stage, TransformStage):
            parts = _truncate_partitions(parts, stage.limit)
    return parts, exceptions


def source_partitions(context, src, lazy: bool = False):
    """Materialize a stage source into columnar partitions with one
    dataset-wide string width. `lazy` (a take): an iterator over them
    instead, read as the stage pulls, whose string widths are each
    partition's own."""
    if isinstance(src, L.ParallelizeOperator):
        schema = src.schema()
        part_rows = _rows_per_partition(context, schema, len(src.data))
        parts = (C.build_partition(src.data[off: off + part_rows], schema,
                                   start_index=off)
                 for off in range(0, len(src.data), part_rows))
    elif lazy and hasattr(src, "iter_partitions"):
        parts = src.iter_partitions()
    else:
        parts = src.load_partitions()
    return iter(parts) if lazy else C.harmonize_partitions(list(parts))


def _truncate_partition(part: C.Partition, k: int) -> C.Partition:
    """The first `k` rows of a host partition."""
    if k >= part.num_rows:
        return part
    idx = np.arange(k, dtype=np.int64)
    out = C.gather_partition(part, idx, idx, k)
    if part.normal_mask is not None:
        out.normal_mask = part.normal_mask[:k].copy()
    out.fallback = {i: v for i, v in part.fallback.items() if i < k}
    return out


def _truncate_partitions(parts: list, limit: int) -> list:
    out, left = [], limit
    for p in parts:
        if left <= 0:
            break
        p = _truncate_partition(p, left)
        left -= p.num_rows
        out.append(p)
    return out


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
           "fetched_row_columns", "general_path_s", "general_rows",
           "exact_exit_rows", "general_not_compilable_rows",
           "dispatched_parts", "dropped_parts")


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


def _general_groups(stage: TransformStage, part: C.Partition,
                    cand: list) -> dict:
    """The general tier's candidate rows grouped by the decode columns
    each must read as str: {frozenset of decode positions: row indices}.
    Only a row the fast path flagged BADPARSE_STRING_INPUT has such
    columns: those whose cell the interpreter's decode
    (`L.decode_cell_python`) keeps as a string, checked on the host."""
    badparse = int(ExceptionCode.BADPARSE_STRING_INPUT)
    dec = stage.ops[0]   # a stage with a general-case decode starts there
    groups: dict = {}
    plain = [i for i, code in cand if code != badparse]
    if plain:
        groups[frozenset()] = plain
    bad = [i for i, code in cand if code == badparse]
    if bad:
        typed = [(ci, t) for ci, t in enumerate(dec.declared.types)
                 if (t.without_option() if t.is_optional() else t)
                 in (T.I64, T.F64)]
        for i, row in zip(bad, C.decode_rows(part, bad)):
            cols = frozenset(
                ci for ci, t in typed
                if isinstance(L.decode_cell_python(row.values[ci], t,
                                                   dec.null_values), str))
            groups.setdefault(cols, []).append(i)
    return {k: np.asarray(v, dtype=np.int64) for k, v in groups.items()}


def _fold_plan(schema: T.RowType, widths: dict, values: list):
    """Resolved Python rows `values` encoded as a partition of `schema`
    (whose str leaves have the widths `widths`): (that partition, the mask
    of the rows that stay boxed: they do not conform to the schema, or a
    string is wider than its column)."""
    n = len(values)
    boxed = np.zeros(n, dtype=np.bool_)
    if len(schema.columns) == 1:
        # a 1-tuple that is not the column's value must not unwrap
        t = schema.types[0]
        for j, v in enumerate(values):
            if isinstance(v, tuple) and len(v) == 1 and \
                    not T.python_value_conforms(v, t):
                boxed[j] = True
    sub = C.build_partition(values, schema)
    if sub.normal_mask is not None:
        boxed |= ~sub.normal_mask
    for p, src in sub.leaves.items():
        if isinstance(src, C.StrLeaf):
            boxed |= src.lengths > widths[p]
    return sub, boxed


def _fold_rows_view(view: C.DeviceView, schema: T.RowType, ks: np.ndarray,
                    values: list) -> np.ndarray:
    """`_fold_rows` into a device view: only the resolved rows' leaf
    values are copied to the device, scattered into slots `ks`; returns
    the mask of the rows that stay boxed."""
    if not values:
        return np.zeros(0, dtype=np.bool_)
    sub, boxed = _fold_plan(schema, view.widths, values)
    j = np.nonzero(~boxed)[0]
    if not len(j):
        return boxed
    a = view.arrays
    dev = a["#rowvalid"].device
    pos = xferstats.to_device(ks[j], dev)
    for p, src in sub.leaves.items():
        if isinstance(src, C.StrLeaf):
            w = min(src.width, view.widths[p])
            a[p + "#bytes"][pos] = 0
            a[p + "#bytes"][pos, :w] = xferstats.to_device(
                src.bytes[j, :w], dev)
            a[p + "#len"][pos] = xferstats.to_device(src.lengths[j], dev)
        elif isinstance(src, C.NumericLeaf):
            a[p][pos] = xferstats.to_device(src.data[j], dev)
        if getattr(src, "valid", None) is not None:
            a[p + "#valid"][pos] = xferstats.to_device(src.valid[j], dev)
    return boxed


def _fold_rows(outp: C.Partition, ks: np.ndarray,
               values: list) -> np.ndarray:
    """Write resolved Python rows `values` into the partition's columnar
    slots `ks`, all at once (encoded as a partition of the same schema,
    whose leaves are scattered in); returns the mask of the rows that stay
    boxed (`_fold_plan`)."""
    if not values:
        return np.zeros(0, dtype=np.bool_)
    sub, boxed = _fold_plan(outp.schema, {
        p: lf.width for p, lf in outp.leaves.items()
        if isinstance(lf, C.StrLeaf)}, values)
    j = np.nonzero(~boxed)[0]
    pos = ks[j]
    for p, src in sub.leaves.items():
        dst = outp.leaves[p]
        if isinstance(src, C.StrLeaf):
            w = min(src.bytes.shape[1], dst.bytes.shape[1])
            dst.bytes[pos] = 0
            dst.bytes[pos, :w] = src.bytes[j, :w]
            dst.lengths[pos] = src.lengths[j]
        elif isinstance(src, C.NumericLeaf):
            dst.data[pos] = src.data[j]
        if getattr(src, "valid", None) is not None:
            dst.valid[pos] = src.valid[j]
    return boxed
