"""Job metrics (counterpart of `tuplex_tpu/api/metrics.py`; reference:
core/include/JobMetrics.h — fast/slow path wall time, exception counts)."""

from __future__ import annotations


class Metrics:
    def __init__(self):
        self.stages: list[dict] = []

    def record_stage(self, m: dict) -> None:
        self.stages.append(dict(m))

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

    def resolveTierMix(self) -> dict:
        """The share of the rows that left the fast path which each resolve
        tier finished: {'exact_exit': f, 'general': f, 'interpreter': f}
        (all 0.0 when no row left it)."""
        tiers = {"exact_exit": self.exactExitRows(),
                 "general": self.generalRows(),
                 "interpreter": self.interpreterRows()}
        total = sum(tiers.values())
        return {k: (v / total if total else 0.0) for k, v in tiers.items()}
