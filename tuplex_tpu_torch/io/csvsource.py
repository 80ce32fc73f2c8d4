"""Text and CSV file sources (counterpart of `tuplex_tpu/io/csvsource.py`).

CSV follows the reference's split of the work (reference:
utils/src/CSVStatistic.cc sniffing; physical/CSVParseRowGenerator.cc parsing
fused into the pipeline):

  * sniffing: Python-side over a 256KB sample (delimiter candidates scored
    by per-line count consistency, header detected by type mismatch,
    per-column normal-case type at tuplex.normalcaseThreshold)
  * bulk read: every column a byte matrix built straight from the file's
    bytes, no Python string per cell (the reference package uses
    pyarrow.csv here; this package does not need pyarrow): the native
    module's one-pass splitter and gather, or numpy where it is not
    available
  * typed decoding runs on the device inside the fused stage
    (DecodeOperator); rows whose cells do not fit the normal case re-run
    under each column's general-case type (`general_type`), and the rest
    on the interpreter
"""

from __future__ import annotations

import csv as _pycsv
import io as _io
import math
from collections import Counter
from typing import Any, Optional, Sequence

import numpy as np

from .. import native
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
        return list(self.iter_partitions())

    def iter_partitions(self):
        """The partitions in order, each built when it is asked for (a
        take stops reading the files at its limit)."""
        offset = 0
        rows_pp = max(256, self.options.get_size(
            "tuplex.partitionSize", 32 << 20) // 64)
        # null values need a Python string per line to compare
        direct = not self.null_values and native.get() is not None
        for f in self.files:
            with VirtualFileSystem.open_read(f, "rb") as fp:
                data = fp.read()
            if direct:
                src, starts, lens = _line_ranges(data)
                for s in range(0, len(starts), rows_pp):
                    n = min(rows_pp, len(starts) - s)
                    (mat, ln), = native.gather_rows(
                        src, starts[s: s + n], lens[s: s + n], None, n)
                    yield C.Partition(
                        schema=self._schema, num_rows=n,
                        leaves={"0": C.StrLeaf(mat, ln)},
                        start_index=offset + s)
                offset += len(starts)
                continue
            text = data.decode("utf-8", errors="replace")
            lines = self._null_map(text.splitlines())
            for s in range(0, len(lines), rows_pp):
                yield C.build_partition(lines[s: s + rows_pp], self._schema,
                                        start_index=offset + s)
            offset += len(lines)


def _line_ranges(data: bytes):
    """(source bytes, line starts, line lengths) such that the lines of
    `data.decode("utf-8", "replace").splitlines()` are the source's byte
    ranges, UTF-8 encoded. Lines come straight from `data`; only the rare
    pieces the native splitter marks odd (another splitlines separator, or
    bytes that are not UTF-8) are decoded and split by Python, and their
    lines appended to the source."""
    starts, ends, odd = native.split_lines(data)
    if not odd:
        return data, starts, ends - starts
    extra = bytearray()
    segs_s, segs_l, prev = [], [], 0
    for i in odd:
        segs_s.append(starts[prev:i])
        segs_l.append(ends[prev:i] - starts[prev:i])
        # the piece with its terminator, so a separator at its end still
        # ends an (empty) line, as in the whole text
        stop = int(starts[i + 1]) if i + 1 < len(starts) else len(data)
        for line in data[starts[i]: stop].decode(
                "utf-8", errors="replace").splitlines():
            b = line.encode("utf-8")
            segs_s.append(np.array([len(data) + len(extra)], np.int64))
            segs_l.append(np.array([len(b)], np.int64))
            extra += b
        prev = i + 1
    segs_s.append(starts[prev:])
    segs_l.append(ends[prev:] - starts[prev:])
    return data + bytes(extra), np.concatenate(segs_s), np.concatenate(segs_l)


def make_text_operator(options, pattern: str, null_values=None):
    files = VirtualFileSystem.glob_input(pattern)
    if not files:
        raise TuplexException(f"no files match {pattern!r}")
    return TextSourceOperator(options, pattern, files,
                              null_values=null_values)


# ---------------------------------------------------------------------------
# sniffing (CSVStatistic semantics, as in the reference package)
# ---------------------------------------------------------------------------

DEFAULT_NULL_VALUES = ("",)
_DELIM_CANDIDATES = (",", ";", "|", "\t")


def sniff_delimiter(sample_text: str) -> str:
    lines = [ln for ln in sample_text.splitlines() if ln.strip()][:64]
    best, best_score = ",", -1.0
    for d in _DELIM_CANDIDATES:
        counts = []
        for ln in lines:
            try:
                counts.append(len(next(_pycsv.reader([ln], delimiter=d))))
            except Exception:
                counts.append(1)
        if not counts:
            continue
        mode, freq = Counter(counts).most_common(1)[0]
        score = 0.0 if mode <= 1 else freq / len(counts) * mode
        if score > best_score:
            best, best_score = d, score
    return best


def _cell_type(cell: str, null_values: Sequence[str]) -> T.Type:
    if cell in null_values:
        return T.NULL
    try:
        int(cell)
        return T.I64
    except ValueError:
        pass
    try:
        float(cell)
        return T.F64
    except ValueError:
        pass
    if cell.lower() in ("true", "false"):
        return T.BOOL
    return T.STR


def detect_header(rows: list[list[str]], null_values: Sequence[str]) -> bool:
    """The first row is a header iff all its cells are non-numeric strings
    AND some body column has a different type (reference: CSVStatistic
    header heuristic)."""
    if len(rows) < 2:
        return False
    head = rows[0]
    if any(_cell_type(c, ()) is not T.STR or c == "" for c in head):
        return False
    k = len(head)
    body_types = []
    for ci in range(k):
        col = [r[ci] for r in rows[1:] if len(r) == k]
        body_types.append({_cell_type(c, null_values) for c in col}
                          - {T.NULL})
    if any(ts and T.STR not in ts for ts in body_types):
        return True
    # all-string file: header iff the first row's values never reappear
    flat = {c for r in rows[1:] for c in r}
    return not any(h in flat for h in head)


def infer_column_types(rows: list[list[str]], k: int,
                       null_values: Sequence[str],
                       threshold: float) -> list[T.Type]:
    """The normal-case type per column: the majority type over the sample
    at the threshold."""
    types = []
    for ci in range(k):
        vals: list[Any] = []
        for c in (r[ci] for r in rows if len(r) == k):
            ct = _cell_type(c, null_values)
            if ct is T.NULL:
                vals.append(None)
            elif ct is T.I64:
                vals.append(int(c))
            elif ct is T.F64:
                vals.append(float(c))
            elif ct is T.BOOL:
                vals.append(c.lower() == "true")
            else:
                vals.append(c)
        nc = T.normal_case_type(vals, threshold)[0]
        types.append(T.STR if nc in (T.UNKNOWN, T.PYOBJECT) else nc)
    return types


def general_type(t: T.Type) -> T.Type:
    """A column's general-case type: the type under which the general
    tier's columnar decode gives a cell the value the interpreter's decode
    (`L.decode_cell_python`) gives it. That is Option of the normal-case
    type, so null cells decode as None where the normal case raises
    NULLERROR, and Option[str] for a column sampled all null, whose cells
    the interpreter keeps as strings. A cell that does not parse as the
    normal-case type stays a string on the interpreter too: the general
    tier decodes such a column as str for those rows only
    (`exec/local.py` `_general_case_pass`)."""
    base = t.without_option() if t.is_optional() else t
    return T.option(T.STR if base is T.NULL else base)


class CSVStatistic:
    """Sniffing result over a file sample."""

    def __init__(self, sample_bytes: bytes, options,
                 delimiter: Optional[str] = None,
                 header: Optional[bool] = None,
                 null_values: Optional[Sequence[str]] = None,
                 columns: Optional[Sequence[str]] = None,
                 type_hints: Optional[dict] = None,
                 quotechar: str = '"'):
        text = sample_bytes.decode("utf-8", errors="replace")
        # drop a possibly truncated last line
        if not sample_bytes.endswith(b"\n") and "\n" in text:
            text = text[: text.rfind("\n")]
        self.null_values = tuple(null_values) if null_values is not None \
            else DEFAULT_NULL_VALUES
        self.delimiter = delimiter or sniff_delimiter(text)
        self.quotechar = quotechar or '"'
        rows = [r for r in _pycsv.reader(_io.StringIO(text),
                                         delimiter=self.delimiter,
                                         quotechar=self.quotechar) if r]
        if not rows:
            raise TuplexException("empty CSV sample")
        self.has_header = detect_header(rows, self.null_values) \
            if header is None else header
        body = rows[1:] if self.has_header else rows
        k = Counter(len(r) for r in body).most_common(1)[0][0] if body \
            else len(rows[0])
        self.num_columns = k
        if columns:
            self.columns = list(columns)
        elif self.has_header:
            self.columns = [c if c else f"_{i}"
                            for i, c in enumerate(rows[0])]
        else:
            self.columns = [f"_{i}" for i in range(k)]
        threshold = options.get_float("tuplex.normalcaseThreshold", 0.9)
        max_rows = options.get_int("tuplex.csv.maxDetectionRows", 1000)
        self.types = infer_column_types(body[:max_rows], k,
                                        self.null_values, threshold)
        for key, t in (type_hints or {}).items():
            idx = key if isinstance(key, int) else self.columns.index(key)
            self.types[idx] = t
        self.general_types = [general_type(t) for t in self.types]
        self.sample_rows = body[:max_rows]


# ---------------------------------------------------------------------------
# the CSV source
# ---------------------------------------------------------------------------

class CSVSourceOperator(L.LogicalOperator):
    """Raw-cell CSV source: every column is Option[str] (a missing cell of
    a malformed record is None). The typed decode is the DecodeOperator
    above it, fused into the stage. `columns` (positions in the file, in
    order) restricts the source to the columns a plan reads. Bytes that
    are not UTF-8 raise UnicodeDecodeError naming the file when the
    partitions load, before any row, as a loop over the file opened as
    UTF-8 raises (the text source decodes them as U+FFFD instead)."""

    def __init__(self, options, pattern: str, stat: CSVStatistic,
                 files: list[str], columns: Optional[list[int]] = None):
        super().__init__([])
        self.options = options
        self.pattern = pattern
        self.stat = stat
        self.files = files
        self.keep = list(range(stat.num_columns)) if columns is None \
            else list(columns)
        self._raw_schema = T.row_of([stat.columns[i] for i in self.keep],
                                    [T.option(T.STR)] * len(self.keep))

    def project(self, columns: list[int]) -> "CSVSourceOperator":
        """A copy of this source that reads only `columns` of its own."""
        return CSVSourceOperator(self.options, self.pattern, self.stat,
                                 self.files, [self.keep[i] for i in columns])

    def schema(self) -> T.RowType:
        return self._raw_schema

    def sample(self) -> list[Row]:
        k = self.stat.num_columns
        return [Row([r[i] if i < len(r) else None for i in self.keep],
                    self._raw_schema.columns)
                for r in (r[:k] for r in self.stat.sample_rows)]

    def load_partitions(self) -> list[C.Partition]:
        return list(self.iter_partitions())

    def iter_partitions(self):
        """The partitions in order, each built when it is asked for."""
        offset = 0
        for path in self.files:
            with VirtualFileSystem.open_read(path, "rb") as fp:
                data = fp.read()
            try:
                for p in csv_partitions(data, self.stat, self.options,
                                        offset, self.keep):
                    yield p
                    offset += p.num_rows
            except UnicodeDecodeError as e:
                # a loop over the file opened as UTF-8 raises this; the
                # reason names the file
                raise UnicodeDecodeError(
                    e.encoding, e.object, e.start, e.end,
                    f"{e.reason} (CSV file {path})") from None


def make_csv_operator(options, pattern: str, columns=None, header=None,
                      delimiter=None, type_hints=None, null_values=None,
                      quotechar: Optional[str] = None):
    files = VirtualFileSystem.glob_input(pattern)
    if not files:
        raise TuplexException(f"no files match {pattern!r}")
    max_sample = options.get_size("tuplex.csv.maxDetectionMemory", 256 << 10)
    with VirtualFileSystem.open_read(files[0], "rb") as fp:
        sample = fp.read(max_sample)
    stat = CSVStatistic(sample, options, delimiter=delimiter, header=header,
                        null_values=null_values, columns=columns,
                        type_hints=type_hints, quotechar=quotechar or '"')
    src = CSVSourceOperator(options, pattern, stat, files)
    return L.DecodeOperator(src, _decoded_schema(stat), stat.null_values,
                            general=T.row_of(stat.columns,
                                             stat.general_types))


def _decoded_schema(stat: CSVStatistic) -> T.RowType:
    return T.row_of(stat.columns, stat.types)


# ---------------------------------------------------------------------------
# the splitter: file bytes -> per-column byte matrices
# ---------------------------------------------------------------------------

def csv_partitions(data: bytes, stat: CSVStatistic, options,
                   base_index: int = 0, columns: Optional[list] = None):
    """Partitions of raw cells over one file's bytes, in file order, of
    the file's `columns` (positions, all of them when None).

    Records whose quotes are all whole-field quoting ("a,b" as one field)
    take the fast path: the native module's one-pass splitter (or
    `_split_records`, its numpy counterpart) gives each field's start and
    length, and a gather builds each column's byte matrix. Records the
    splitter does not take (a quote inside a field, a doubled "" escape, a
    newline inside quotes, a wrong field count, a cell wider than
    tuplex.tpu.maxStrBytes) are read by Python's csv module and keep their
    slot as boxed rows for the interpreter, as the reference package's
    malformed rows do."""
    k = stat.num_columns
    cols = list(range(k)) if columns is None else list(columns)
    max_w = options.get_int("tuplex.tpu.maxStrBytes", 4096)
    if not data:
        return
    use_native = native.get() is not None
    split = native.split_csv if use_native else _split_records
    starts, ends, good, fstart, flen = split(
        data, ord(stat.delimiter), ord(stat.quotechar), k, stat.has_header)
    if len(cols) < k:
        fstart, flen = fstart[:, cols], flen[:, cols]
    too_wide = (flen > max_w).any(axis=1)
    if too_wide.any():
        good[np.flatnonzero(good)[too_wide]] = False
        fstart, flen = fstart[~too_wide], flen[~too_wide]
    # the boxed rows: every record the splitter did not take, re-read by
    # Python's csv module from its own bytes
    boxed = []
    for r in np.nonzero(~good)[0].tolist():
        text = data[starts[r]: ends[r]].decode("utf-8", errors="replace")
        try:
            records = list(_pycsv.reader(_io.StringIO(text),
                                         delimiter=stat.delimiter,
                                         quotechar=stat.quotechar))
        except _pycsv.Error:
            records = [[text]]
        for cells in records:
            if cells:
                boxed.append((r, tuple(cells[i] if i < len(cells) else None
                                       for i in cols)))
    # output slots: fast records and boxed rows interleaved in file order
    n_fast = len(fstart)
    slot_rec = np.concatenate([np.nonzero(good)[0],
                               np.asarray([r for r, _ in boxed], np.int64)])
    order = np.argsort(slot_rec, kind="stable")   # boxed rows of one record
    total = len(order)                            # keep their csv order
    slot_of = np.empty(total, dtype=np.int64)
    slot_of[order] = np.arange(total)
    fast_slot = slot_of[:n_fast]
    boxed_slot = slot_of[n_fast:]
    schema = T.row_of([stat.columns[i] for i in cols],
                      [T.option(T.STR)] * len(cols))
    if not use_native:
        # room for a full-width window at the last field
        padded = np.concatenate([np.frombuffer(data, np.uint8),
                                 np.zeros(max(int(flen.max(initial=0)), 1),
                                          np.uint8)])
    bytes_per_row = max(16, 2 * len(data) // max(total, 1))
    rows_pp = max(256, options.get_size("tuplex.partitionSize", 32 << 20)
                  // bytes_per_row)
    start = 0
    for m in _chunk_sizes(total, rows_pp):
        f0, f1 = np.searchsorted(fast_slot, [start, start + m])
        pos = fast_slot[f0:f1] - start
        if use_native:    # every column of the partition in one pass
            leaves = {str(ci): C.StrLeaf(mat, lens) for ci, (mat, lens) in
                      enumerate(native.gather_rows(
                          data, fstart[f0:f1], flen[f0:f1],
                          None if f1 - f0 == m else pos, m))}
        else:
            leaves = {str(ci): _column_leaf(padded, fstart[f0:f1, ci],
                                            flen[f0:f1, ci], pos, m)
                      for ci in range(len(cols))}
        part = C.Partition(schema=schema, num_rows=m, leaves=leaves,
                           start_index=base_index + start)
        b0, b1 = np.searchsorted(boxed_slot, [start, start + m])
        if b1 > b0:
            mask = np.ones(m, dtype=np.bool_)
            for j in range(b0, b1):
                mask[boxed_slot[j] - start] = False
                part.fallback[int(boxed_slot[j] - start)] = boxed[j][1]
            part.normal_mask = mask
        yield part
        start += m


def _split_records(data: bytes, delim: int, quote: int, k: int,
                   has_header: bool):
    """(record starts, record ends, fast-path flag per record, field starts
    [F, k], field lengths [F, k] of the F fast records). Blank lines are no
    records, and the header is dropped.

    One pass over the bytes finds the structural candidates (delimiter,
    quote, newline, CR) and the bytes >= 0x80; the rest are running counts
    over their positions: a byte lies inside quotes when an odd number of
    quotes comes before it, and a record's number is the count of newlines
    outside quotes before it. The bytes >= 0x80 must be UTF-8, else
    UnicodeDecodeError: each run of them is checked, since an ASCII byte
    ends any sequence."""
    buf = np.frombuffer(data, dtype=np.uint8)
    table = bytearray(256)
    for c in (delim, quote, 10, 13, *range(0x80, 0x100)):
        table[c] = 1
    pos = np.flatnonzero(np.frombuffer(data.translate(table), np.bool_))
    kind = buf[pos]
    high = kind >= 0x80
    if high.any():
        _check_utf8(data, pos[high])
        pos, kind = pos[~high], kind[~high]
    isq = kind == quote
    # quotes up to and including each position, mod 2; the positions it is
    # read at are no quotes, so this counts the quotes before them
    inside = (np.cumsum(isq, dtype=np.uint8) & 1).view(np.bool_)
    is_nl = kind == 10
    nl_out = is_nl & ~inside
    raw_rec = np.cumsum(nl_out, dtype=np.int32) - nl_out   # line number
    ends = pos[nl_out]
    if not len(ends) or ends[-1] != len(buf) - 1:
        ends = np.append(ends, len(buf))
    starts = np.concatenate([[0], ends[:-1] + 1])
    # a CR before the record's newline belongs to the line terminator
    term_cr = (ends > starts) & (buf[np.maximum(ends - 1, 0)] == 13)
    ends = ends - term_cr
    keep = ends > starts
    if has_header and keep.any():
        keep[np.argmax(keep)] = False
    # line number -> record number, -1 for blank lines and the header
    rec_of_line = np.where(keep, np.cumsum(keep) - 1, -1).astype(np.int32)
    starts, ends = starts[keep], ends[keep]
    nrec = len(starts)
    if nrec == 0:
        empty = np.zeros((0, k), np.int64)
        return starts, ends, np.zeros(0, np.bool_), empty, empty
    rec = rec_of_line[raw_rec]
    # terminators belong to no record
    rec[nl_out] = -1
    cr = np.flatnonzero(kind == 13)
    cr = cr[rec[cr] >= 0]
    rec[cr[pos[cr] == ends[rec[cr]]]] = -1

    def per_record(mask):
        return np.bincount(rec[mask & (rec >= 0)], minlength=nrec)

    is_delim = (kind == delim) & ~inside
    good = per_record(is_delim) == k - 1
    # a newline inside quotes, or a CR that ends no line, sends the record
    # to Python's csv
    good &= per_record(is_nl | (kind == 13)) == 0
    d = pos[is_delim & (rec >= 0) & good[np.maximum(rec, 0)]
            ].reshape(int(good.sum()), k - 1)
    fstart = np.concatenate([starts[good][:, None], d + 1], axis=1)
    fend = np.concatenate([d, ends[good][:, None]], axis=1)
    flen = fend - fstart
    # whole-field quoting: strip the two quotes; every quote byte of the
    # record must be one of them, else the record goes to csv
    quoted = (flen >= 2) & (buf[np.minimum(fstart, len(buf) - 1)] == quote) \
        & (buf[np.maximum(fend - 1, 0)] == quote)
    whole = per_record(isq)[good] == 2 * quoted.sum(axis=1)
    good[np.flatnonzero(good)[~whole]] = False
    return (starts, ends, good, (fstart + quoted)[whole],
            (flen - 2 * quoted)[whole])


def _check_utf8(data: bytes, hi: np.ndarray) -> None:
    """Raise UnicodeDecodeError unless every run of the bytes at the
    ascending positions `hi` (all >= 0x80) is UTF-8: the runs are decoded
    together, one ASCII byte between two runs, which ends a sequence as the
    file's own ASCII byte there does."""
    brk = np.flatnonzero(np.diff(hi) != 1) + 1        # where runs start
    joined = np.insert(np.frombuffer(data, np.uint8)[hi], brk, 0x20)
    try:
        joined.tobytes().decode("utf-8")
    except UnicodeDecodeError as e:
        # an error starts at a byte of a run, never at a separator
        seps = brk + np.arange(len(brk))
        at = int(hi[e.start - np.searchsorted(seps, e.start)])
        raise native.invalid_utf8(data, at) from None


def _column_leaf(padded: np.ndarray, fstart: np.ndarray, flen: np.ndarray,
                 pos: np.ndarray, m: int) -> C.StrLeaf:
    """One column's [m, W] byte matrix: the fields' bytes at rows `pos`
    (ascending), zero elsewhere and past each field's length."""
    w = max(int(flen.max(initial=0)), 1)
    rows = np.lib.stride_tricks.sliding_window_view(padded, w)[fstart]
    rows *= np.arange(w, dtype=np.int32)[None, :] < flen[:, None]
    lens = flen.astype(np.int32)
    if len(pos) == m:           # no boxed rows here: rows are in order
        return C.StrLeaf(rows, lens)
    mat = np.zeros((m, w), dtype=np.uint8)
    full = np.zeros(m, dtype=np.int32)
    mat[pos] = rows
    full[pos] = lens
    return C.StrLeaf(mat, full)


def _chunk_sizes(total: int, cap: int) -> list[int]:
    """Balanced partition sizes: a small tail is absorbed (within +25% of
    the cap), else equal chunks."""
    if total <= 0:
        return []
    if total <= cap + cap // 4:
        return [total]
    n = math.ceil(total / cap)
    base, rem = divmod(total, n)
    return [base + (1 if i < rem else 0) for i in range(n)]
