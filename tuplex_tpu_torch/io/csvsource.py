"""Text file source (counterpart of `tuplex_tpu/io/csvsource.py`, its
`TextSourceOperator`: one row per line). CSV comes in a later slice."""

from __future__ import annotations

from typing import Optional, Sequence

from ..core import typesys as T
from ..core.errors import TuplexException
from ..core.row import Row
from ..plan import logical as L
from ..runtime import columns as C
from .vfs import VirtualFileSystem


class TextSourceOperator(L.LogicalOperator):
    """One row per line (reference: logical FileInputOperator text mode +
    physical/TextReader.cc). Lines split like `str.splitlines`; bytes that
    are not UTF-8 decode as U+FFFD."""

    def __init__(self, options, pattern: str, files: list[str],
                 null_values: Optional[Sequence[str]] = None):
        super().__init__([])
        self.options = options
        self.pattern = pattern
        self.files = files
        self.null_values = tuple(null_values) if null_values else ()
        self._schema = T.row_of(
            ["_0"], [T.option(T.STR) if self.null_values else T.STR])

    def _null_map(self, lines):
        if not self.null_values:
            return lines
        nv = set(self.null_values)
        return [None if ln in nv else ln for ln in lines]

    def schema(self) -> T.RowType:
        return self._schema

    def sample(self) -> list[Row]:
        lines: list[str] = []
        for f in self.files[:1]:
            with VirtualFileSystem.open_read(f, "rb") as fp:
                chunk = fp.read(256 << 10).decode("utf-8", errors="replace")
            lines = chunk.splitlines()[:1000]
        return [Row((ln,), None) for ln in self._null_map(lines)]

    def load_partitions(self) -> list[C.Partition]:
        parts = []
        offset = 0
        rows_pp = max(256, self.options.get_size(
            "tuplex.partitionSize", 32 << 20) // 64)
        for f in self.files:
            with VirtualFileSystem.open_read(f, "rb") as fp:
                text = fp.read().decode("utf-8", errors="replace")
            lines = self._null_map(text.splitlines())
            for s in range(0, len(lines), rows_pp):
                parts.append(C.build_partition(lines[s: s + rows_pp],
                                               self._schema,
                                               start_index=offset + s))
            offset += len(lines)
        return parts


def make_text_operator(options, pattern: str, null_values=None):
    files = VirtualFileSystem.glob_input(pattern)
    if not files:
        raise TuplexException(f"no files match {pattern!r}")
    return TextSourceOperator(options, pattern, files,
                              null_values=null_values)
