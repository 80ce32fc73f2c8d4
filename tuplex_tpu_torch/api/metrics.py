"""Job metrics (counterpart of `tuplex_tpu/api/metrics.py`; reference:
core/include/JobMetrics.h — fast/slow path wall time, exception counts)."""

from __future__ import annotations


class Metrics:
    def __init__(self):
        self.stages: list[dict] = []
        self.plans: list[dict] = []

    def record_stage(self, m: dict) -> None:
        self.stages.append(dict(m))

    def record_plan(self, m: dict) -> None:
        """One planned job or sub-plan (a join's build side, a cache):
        its `stages`, `interpreter_segments` and `plan_fallback_ops`
        (exec/local.py `run_plan`)."""
        self.plans.append(dict(m))

    def planFallbackOps(self) -> int:
        """Operators the planner routed to the interpreter by the
        analyzer's findings alone, with no probe of the emitter
        (compiler/analyzer.py STATS; reference: metrics.py:33)."""
        return sum(int(m.get("plan_fallback_ops", 0)) for m in self.plans)

    def _sum(self, key: str):
        return sum(m.get(key, 0) for m in self.stages)

    @property
    def totalExceptionCount(self) -> int:
        return int(self._sum("exception_rows"))

    def fastPathWallTime(self) -> float:
        """Seconds spent staging, running and fetching the compiled path."""
        return float(self._sum("fast_path_s"))

    def slowPathWallTime(self) -> float:
        """Seconds spent on the interpreter path."""
        return float(self._sum("slow_path_s"))

    def generalPathWallTime(self) -> float:
        """Seconds spent on the compiled general-case tier."""
        return float(self._sum("general_path_s"))

    def totalWallTime(self) -> float:
        return float(self._sum("wall_s"))

    def interpreterRows(self) -> int:
        """Rows the interpreter ran through a transform stage: input rows
        outside the normal case plus rows whose device error code was
        set."""
        return int(self._sum("interpreter_rows"))

    def ignoredRows(self) -> int:
        """Rows that an ignore() dropped: their operator raised the class
        it names. They are not exceptions of the job."""
        return int(self._sum("ignored_rows"))

    def hostFoldedRows(self) -> int:
        """Rows the aggregate stages folded or deduplicated on the host
        instead of the device (the rows of an interpreted transform are
        interpreterRows)."""
        return int(self._sum("host_folded_rows"))

    def deviceRows(self) -> int:
        """Rows the aggregate stages folded or deduplicated on the device
        (a general fold's rows that raised there included)."""
        return int(self._sum("device_rows"))

    def scanRows(self) -> int:
        """Rows the aggregate stages' general folds (plan/aggregates.py
        ScanFold) put in their segments on the device, the rows past a
        segment's stop included."""
        return int(self._sum("scan_rows"))

    def scanStoppedSegments(self) -> int:
        """Segments of the general folds that stopped at a row the
        interpreter had to fold: it folded that row and the segment's later
        rows (counted in hostFoldedRows)."""
        return int(self._sum("scan_stopped_segments"))

    def deviceErrorRows(self) -> int:
        """Rows the compiled path flagged with an error code."""
        return int(self._sum("device_error_rows"))

    def generalRows(self) -> int:
        """Rows the compiled general-case tier finished: their device error
        code was internal, and the stage's function under the general-case
        decode ran them without error."""
        return int(self._sum("general_rows"))

    def exactExitRows(self) -> int:
        """Rows recorded as exceptions straight off the device lattice (a
        stage without resolve or ignore, a Python exception class)."""
        return int(self._sum("exact_exit_rows"))

    def h2dBytes(self) -> int:
        """Bytes the stages copied from the host to the device: staged
        leaves, join leaves and key columns, row indices, resolved rows
        scattered into views (runtime/xferstats.py)."""
        return int(self._sum("h2d_bytes"))

    def d2hBytes(self) -> int:
        """Bytes the stages copied from the device to the host: stage
        outputs (control arrays alone for a partition handed off), rows
        gathered for the slow paths, lazy leaves fetched whole."""
        return int(self._sum("d2h_bytes"))

    def compileTime(self) -> float:
        """Seconds the transform stages spent capturing their graphs
        (exec/compilequeue.py; reference: JobMetrics.h get_compile_time).
        A graph found in the in-process store costs nothing here: a fully
        warm second run reports 0.0."""
        return float(self._sum("compile_s"))

    def stageCompileCount(self) -> int:
        """Graphs the transform stages captured (0 on a warm second run
        of a job in the same process)."""
        return int(self._sum("stage_compiles"))

    def graphReplays(self) -> int:
        """Partitions the transform stages dispatched by replaying a
        captured graph."""
        return int(self._sum("graph_replays"))

    def graphDeclines(self) -> dict:
        """{reason: partitions} run eagerly because their stage function
        could not be captured (a wait on the device, a host copy, a failed
        capture)."""
        out: dict = {}
        for m in self.stages:
            for k, v in m.items():
                if k.startswith("graph_declined_"):
                    r = k[len("graph_declined_"):]
                    out[r] = out.get(r, 0) + v
        return out

    def resolveTierMix(self) -> dict:
        """The share of the rows that left the fast path which each resolve
        tier finished: {'exact_exit': f, 'general': f, 'interpreter': f}
        (all 0.0 when no row left it)."""
        tiers = {"exact_exit": self.exactExitRows(),
                 "general": self.generalRows(),
                 "interpreter": self.interpreterRows()}
        total = sum(tiers.values())
        return {k: (v / total if total else 0.0) for k, v in tiers.items()}
