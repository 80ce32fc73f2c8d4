"""tuplex_tpu_torch.native, the host data plane, against its Python paths
and the reference package's native module.

Oracles: the port's Python path for every entry point (forced by setting
the module's `_mod = None, _tried = True`): `_split_records` for
`split_csv`, `str.splitlines` for `split_lines`, `_column_leaf` for
`gather_rows`, and the Python loops of `runtime/columns.py` for the
encoders and decoders. The reference's entry points (`encode_*`,
`offsets_to_matrix`, `decode_str`, `decode_columns`, `encode_rows`) are
also held against `tuplex_tpu.native`, called directly, with no Context.
Tolerance: none; every comparison is exact, dtypes and shapes included.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from tuplex_tpu import native as ref_native
from tuplex_tpu_torch import native as N
from tuplex_tpu_torch.core import typesys as T
from tuplex_tpu_torch.core.options import ContextOptions
from tuplex_tpu_torch.io import csvsource
from tuplex_tpu_torch.runtime import columns as C

from test_torch_csv import FILES as CSV_FILES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _private_aot_store(tmp_path, monkeypatch):
    """The reference package keeps compiled stages in an on-disk store
    that every process of one HOME shares; nothing here compiles a stage,
    and this file keeps off the store all the same."""
    monkeypatch.setenv("TUPLEX_AOT_CACHE", str(tmp_path / "aot"))


@pytest.fixture
def python_path(monkeypatch):
    """Run the body with the native module switched off."""
    def force():
        monkeypatch.setattr(N, "_mod", None)
        monkeypatch.setattr(N, "_tried", True)
    return force


def _same(a, b):
    """Exact equality of (nested tuples of) arrays, dtypes and shapes
    included."""
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)
        return
    assert type(a) is type(b)
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert a == b


def _same_partition(a: C.Partition, b: C.Partition):
    assert (a.schema, a.num_rows, a.start_index) == \
        (b.schema, b.num_rows, b.start_index)
    assert sorted(a.leaves) == sorted(b.leaves)
    for p in a.leaves:
        la, lb = a.leaves[p], b.leaves[p]
        assert type(la) is type(lb)
        for f in ("bytes", "lengths", "data", "valid"):
            if hasattr(la, f):
                if getattr(la, f) is None:
                    assert getattr(lb, f) is None
                else:
                    _same(getattr(la, f), getattr(lb, f))
    assert a.fallback == b.fallback
    if a.normal_mask is None:
        assert b.normal_mask is None
    else:
        _same(a.normal_mask, b.normal_mask)


def test_module_builds_and_counts():
    mod = N.get()
    assert mod is not None, "g++ is on PATH here, so the module must load"
    assert os.path.dirname(mod.__file__) == N.BUILD_DIR
    before = dict(N.calls)
    N.split_lines(b"a\nb")
    N.encode_i64([1])
    assert N.calls["split_lines"] == before["split_lines"] + 1
    assert N.calls["encode_i64"] == before["encode_i64"] + 1
    assert {k: v for k, v in N.calls.items()
            if k not in ("split_lines", "encode_i64")} == \
        {k: v for k, v in before.items()
         if k not in ("split_lines", "encode_i64")}


def test_failed_build_raises(tmp_path, monkeypatch):
    """With a compiler on PATH, a build that fails raises; the Python path
    is only for hosts without one."""
    monkeypatch.setattr(N, "_mod", None)
    monkeypatch.setattr(N, "_tried", False)
    monkeypatch.setattr(N, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(N, "CXX", "false")
    with pytest.raises(RuntimeError, match="false failed"):
        N.get()
    assert N._mod is None and not N._tried
    monkeypatch.setattr(N, "CXX", "no-such-compiler-here")
    assert N.get() is None


# -- the reference's entry points against tuplex_tpu.native ----------------

MIXED = [1, 2, None, "x", True, 2**70, -2**63, 2**63 - 1, 1.5, "日本", b"b",
         float("nan"), False, ""]


@pytest.mark.parametrize("name", ["encode_i64", "encode_f64", "encode_bool",
                                  "encode_str"])
def test_encoders_match_reference(name):
    ref = getattr(ref_native.get(), name)
    assert getattr(N, name)(MIXED) == ref(MIXED)
    assert getattr(N, name)([]) == ref([])


def test_offsets_to_matrix_matches_reference_and_numpy():
    vals = [b"", b"a", b"hello world", "日本語テキスト".encode(), b"x" * 50,
            b"tail"]
    data = b"".join(vals)
    offs = np.concatenate([[0], np.cumsum([len(v) for v in vals])]) \
        .astype(np.int64).tobytes()
    for n, off, max_w in ((6, 0, 16), (4, 2, 16), (6, 0, 100), (0, 0, 8),
                          (3, 1, 0)):
        got = N.offsets_to_matrix(data, offs, n, off, max_w)
        assert got == ref_native.get().offsets_to_matrix(data, offs, n, off,
                                                         max_w)
        # the Python counterpart: clamp each value to w bytes
        mat_b, lens_b, full_b, w = got
        sel = vals[off: off + n]
        want_w = min(max([len(v) for v in sel] + [1]), max_w)
        assert w == want_w
        assert mat_b == b"".join(v[:w].ljust(w, b"\0") for v in sel)
        assert np.frombuffer(lens_b, np.int32).tolist() == \
            [min(len(v), w) for v in sel]
        assert np.frombuffer(full_b, np.int64).tolist() == \
            [len(v) for v in sel]


def _str_matrix():
    rows = [b"ab", b"", "日本語".encode(), b"\xff\xfebad", b"\xe6\x97",
            b"x" * 9, b"tail\xed\xa0\x80"]
    w = 9
    mat = b"".join(r.ljust(w, b"\0") for r in rows)
    lens = np.array([len(r) for r in rows], np.int32).tobytes()
    return mat, lens, w, len(rows)


def test_decode_str_matches_reference_and_python(python_path):
    mat, lens, w, n = _str_matrix()
    got = N.decode_str(mat, lens, w, n)
    assert got == ref_native.get().decode_str(mat, lens, w, n)
    leaf = C.StrLeaf(np.frombuffer(mat, np.uint8).reshape(n, w),
                     np.frombuffer(lens, np.int32),
                     np.array([1, 0, 1, 1, 1, 0, 1], np.bool_))
    native_rows = C._leaf_to_pylist(leaf, n)
    python_path()
    assert native_rows == C._leaf_to_pylist(leaf, n)
    assert native_rows[3] == "\ufffd\ufffdbad" and native_rows[1] is None


def _flat_partition():
    mat, lens, w, n = _str_matrix()
    leaves = {
        "0": C.NumericLeaf(np.array([1, -2**63, 0, 7, 2**63 - 1, 5, 9]),
                           np.array([1, 1, 0, 1, 1, 1, 0], np.bool_)),
        "1": C.StrLeaf(np.frombuffer(mat, np.uint8).reshape(n, w).copy(),
                       np.frombuffer(lens, np.int32).copy(),
                       np.array([1, 0, 1, 1, 1, 1, 1], np.bool_)),
        "2": C.NumericLeaf(np.array([1.5, -0.0, np.inf, 2.25, 0, 1, 3])),
        "3": C.NumericLeaf(np.array([1, 0, 1, 1, 0, 0, 1], np.bool_),
                           np.array([1, 1, 1, 0, 1, 1, 1], np.bool_)),
    }
    schema = T.row_of(["a", "b", "c", "d"],
                      [T.option(T.I64), T.option(T.STR), T.F64,
                       T.option(T.BOOL)])
    part = C.Partition(schema=schema, num_rows=n, leaves=leaves)
    part.normal_mask = np.array([1, 1, 1, 1, 1, 0, 1], np.bool_)
    part.fallback = {5: ("boxed", None, 1, 2)}
    return part


def test_decode_columns_matches_reference_and_python(python_path):
    part = _flat_partition()
    n = part.num_rows
    lv = part.leaves
    spec = [(0, lv["0"].data, lv["0"].valid.astype(np.uint8)),
            (3, lv["1"].bytes, lv["1"].valid.astype(np.uint8),
             lv["1"].lengths, lv["1"].width),
            (1, lv["2"].data, None),
            (2, lv["3"].data.astype(np.uint8),
             lv["3"].valid.astype(np.uint8))]
    assert N.decode_columns(spec, n) == \
        ref_native.get().decode_columns(spec, n)
    one = C.Partition(schema=T.row_of(["b"], [T.option(T.STR)]),
                      num_rows=n, leaves={"0": lv["1"]})
    before = N.calls["decode_columns"]
    rows, rows_one = C.partition_to_pylist(part), C.partition_to_pylist(one)
    assert N.calls["decode_columns"] == before + 2
    python_path()
    want = C.partition_to_pylist(part)
    assert rows == want
    assert [tuple(map(type, r)) for r in rows] == \
        [tuple(map(type, r)) for r in want]
    assert rows[5] == ("boxed", None, 1, 2)
    assert rows[3][1] == "\ufffd\ufffdbad" and rows[1][1] is None
    # one column: bare values
    assert rows_one == C.partition_to_pylist(one) == \
        C._leaf_to_pylist(lv["1"], n)


ROWS = [(1, "a", 1.5, True), (None, None, None, None),
        ("bad", "b", 2.5, False), (3, "日本", 0.0, True), "not-a-tuple",
        (5, "e", 1.0, False, 99), (2**63, "big", 0.5, True),
        (4, 1, 1.0, True), (6, "f", 2, True), (7, "g", 3.0, 1),
        (8, "h" * 40, -1.0, False)]
FLAT = T.row_of(["i", "s", "f", "b"], [T.option(T.I64), T.option(T.STR),
                                        T.option(T.F64), T.option(T.BOOL)])


def test_encode_rows_matches_reference():
    kinds = [0, 3, 1, 2]
    assert N.encode_rows(list(ROWS), kinds) == \
        ref_native.get().encode_rows(list(ROWS), kinds)


@pytest.mark.parametrize("values,schema", [
    (ROWS, FLAT),
    ([(1, "x"), (2, None), (None, "z"), (3, "w")],
     T.row_of(["a", "b"], [T.I64, T.STR])),
    ([1, None, 3, True, 2**64, (4,)], T.row_of(["x"], [T.I64])),
    (["a", None, "日本", 3, ("b",)], T.row_of(["x"], [T.option(T.STR)])),
    ([1.5, 2, None, 0.0], T.row_of(["x"], [T.option(T.F64)])),
    ([True, False, 1, None], T.row_of(["x"], [T.BOOL])),
    ([], FLAT),
])
def test_build_partition_native_matches_python(values, schema, python_path):
    """The same rows out, and the same rows boxed, as the Python loop; on
    rows that all conform, the same leaves."""
    before = (N.calls["encode_rows"], sum(N.calls[f"encode_{k}"] for k in
                                          ("i64", "f64", "bool", "str")))
    fast = C.build_partition(values, schema, start_index=3)
    after = (N.calls["encode_rows"], sum(N.calls[f"encode_{k}"] for k in
                                         ("i64", "f64", "bool", "str")))
    assert after != before
    python_path()
    slow = C.build_partition(values, schema, start_index=3)
    assert C.partition_to_pylist(fast) == C.partition_to_pylist(slow)
    assert set(fast.fallback) == set(slow.fallback)
    if not slow.fallback:
        _same_partition(fast, slow)


# -- the readers against the Python paths -----------------------------------

EXTRA_CSV = {
    "crlf": b"a,b\r\n1,2\r\n3,4\r\n",
    "lone cr": b"a,b\r1,2\n3,4\r\n5\r,6\n",
    "no final newline": b"a,b\n1,2\n3,4",
    "bom": "\ufeffa,b\n1,2\n".encode(),
    "blank lines": b"\n\na,b\n\n1,2\n\r\n\n3,4\n\n",
    "escapes": b'a,b\n"x ""y""",2\n"",""\n"""",3\n',
    "newline in quotes": b'a,b\n"1\n2",3\n"4\r\n5",6\n7,8\n',
    "ragged": b"a,b\n1\n1,2,3\n,\n1,2\n",
    "stray quote": b'a,b\n1,x"y\n2,3\n"4,5\n',
    "only header": b"a,b\n",
    "one column": b"a\n1\n\"2\"\n3\n",
}


def _csv_cases():
    for name, text in sorted(CSV_FILES.items()):
        yield name, text.encode(), 3
    for name, data in sorted(EXTRA_CSV.items()):
        yield name, data, 1 if name == "one column" else 2


@pytest.mark.parametrize("name,data,k", list(_csv_cases()),
                         ids=[c[0] for c in _csv_cases()])
@pytest.mark.parametrize("has_header", [True, False])
def test_split_csv_matches_numpy_splitter(name, data, k, has_header):
    _same(N.split_csv(data, ord(","), ord('"'), k, has_header),
          csvsource._split_records(data, ord(","), ord('"'), k, has_header))


@settings(max_examples=300, deadline=None)
@given(st.lists(st.sampled_from([b"a", b",", b'"', b"\n", b"\r",
                                 "é".encode()]), min_size=1, max_size=60),
       st.integers(1, 4), st.booleans())
def test_split_csv_random_bytes(pieces, k, has_header):
    data = b"".join(pieces)
    _same(N.split_csv(data, ord(","), ord('"'), k, has_header),
          csvsource._split_records(data, ord(","), ord('"'), k, has_header))


class _Stat:
    delimiter, quotechar = ",", '"'

    def __init__(self, k, has_header):
        self.num_columns, self.has_header = k, has_header
        self.columns = [f"c{i}" for i in range(k)]


@pytest.mark.parametrize("name,data,k", list(_csv_cases()),
                         ids=[c[0] for c in _csv_cases()])
def test_csv_partitions_native_matches_numpy(name, data, k, python_path):
    """Partitions of the C++ splitter and gather equal those of the numpy
    splitter and strided-window gather: matrices, widths, lengths, boxed
    rows and their slots, and partition sizes (a small partition size
    makes several)."""
    opts = ContextOptions({"tuplex.partitionSize": "64B",
                           "tuplex.tpu.maxStrBytes": "20"})
    stat = _Stat(k, True)
    before = N.calls["gather_rows"]
    fast = list(csvsource.csv_partitions(data, stat, opts, 5))
    assert N.calls["gather_rows"] > before or not fast
    python_path()
    slow = list(csvsource.csv_partitions(data, stat, opts, 5))
    assert len(fast) == len(slow)
    for a, b in zip(fast, slow):
        _same_partition(a, b)


@pytest.mark.parametrize("pos", [None, "some"])
def test_gather_rows_matches_column_leaf(pos):
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, 500, dtype=np.uint8).tobytes()
    fstart = rng.integers(0, 400, size=(40, 3))
    flen = rng.integers(0, 30, size=(40, 3))
    flen[:, 1] = 0
    m = 40 if pos is None else 57
    rows = None if pos is None else \
        np.sort(rng.choice(m, 40, replace=False)).astype(np.int64)
    padded = np.concatenate([np.frombuffer(data, np.uint8),
                             np.zeros(32, np.uint8)])
    cols = N.gather_rows(data, fstart, flen, rows, m)
    assert len(cols) == 3
    for ci, (mat, lens) in enumerate(cols):
        leaf = csvsource._column_leaf(
            padded, fstart[:, ci], flen[:, ci],
            np.arange(40) if rows is None else rows, m)
        _same((mat, lens), (leaf.bytes, leaf.lengths))
        # one column alone, as the text source gathers its lines
        _same(N.gather_rows(data, fstart[:, ci], flen[:, ci], rows, m)[0],
              (mat, lens))
    with pytest.raises(ValueError):
        N.gather_rows(data, np.array([495]), np.array([6]), None, 1)
    with pytest.raises(ValueError):
        N.gather_rows(data, np.array([0]), np.array([1]), np.array([1]), 1)
    with pytest.raises(ValueError):
        N.gather_rows(data, np.array([0]), np.array([1]), None, 2)


LINE_CASES = {
    "empty": b"",
    "newline only": b"\n",
    "no final newline": b"a\nb",
    "crlf and lone cr": b"a\r\nb\rc\r\r\nd\n\re",
    "blank lines": b"\n\na\n\n",
    "other separators": b"a\x0bb\x0cc\x1cd\x1de\x1ef\n\x0b\n",
    "separator at the end": b"x\x0b\ny\x0c",
    "unicode separators": "a\x85b\u2028c\u2029d\n\u2028".encode(),
    "invalid utf-8": b"ok\n\xff\xfe\nbad\xc3\n\xe2\x80\nx\xed\xa0\x80y\n",
    "truncated before a newline": b"a\xe6\x97\nb\xf0\x9f\x98",
    "valid non-ascii": "élève\n日本語\n😀\n".encode(),
    "nul bytes": b"a\x00b\n\x00\n",
}


def _lines_of(src, starts, lens):
    return [bytes(src[s: s + n]) for s, n in zip(starts.tolist(),
                                                 lens.tolist())]


@pytest.mark.parametrize("name", sorted(LINE_CASES))
def test_split_lines_matches_splitlines(name):
    data = LINE_CASES[name]
    want = [ln.encode() for ln in
            data.decode("utf-8", "replace").splitlines()]
    assert _lines_of(*csvsource._line_ranges(data)) == want


@settings(max_examples=300, deadline=None)
@given(st.lists(st.sampled_from(
    [b"a", b"\n", b"\r", b"\x0b", b"\x0c", b"\x1c", b"\x1e", b"\x85",
     "\x85".encode(), "\u2029".encode(), "é".encode(), b"\xff", b"\xc2",
     b"\xe2\x80", b"\xed\xa0\x80", b" "]), max_size=40))
def test_split_lines_random_bytes(pieces):
    data = b"".join(pieces)
    want = [ln.encode() for ln in
            data.decode("utf-8", "replace").splitlines()]
    assert _lines_of(*csvsource._line_ranges(data)) == want


@pytest.mark.parametrize("name", sorted(LINE_CASES))
def test_text_source_native_matches_python(name, tmp_path, python_path):
    """The text source's partitions from the line ranges equal those built
    from Python strings: [n, W] matrices with W the longest line of each
    partition, lengths, start indices."""
    path = tmp_path / "t.txt"
    path.write_bytes(LINE_CASES[name] * 40)
    op = csvsource.TextSourceOperator(
        ContextOptions({"tuplex.partitionSize": "16KB"}), str(path),
        [str(path)])
    before = N.calls["split_lines"]
    fast = op.load_partitions()
    assert N.calls["split_lines"] == before + 1
    python_path()
    slow = op.load_partitions()
    assert len(fast) == len(slow)
    for a, b in zip(fast, slow):
        _same_partition(a, b)


def test_concurrent_builds_load_one_library(tmp_path):
    """Two processes that build into one empty directory at once both load
    a whole library and give equal results."""
    build = tmp_path / "build"
    script = tmp_path / "b.py"
    script.write_text(textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {REPO!r})
        from tuplex_tpu_torch import native as N
        N.BUILD_DIR = {str(build)!r}
        data = b'a,"b",c\\nd,e,f\\r\\n"g\\nh",i,j\\n'
        print(N.get().__file__)
        print([a.tolist() for a in N.split_csv(data, 44, 34, 3, False)])
    """))
    procs = [subprocess.Popen([sys.executable, str(script)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    assert outs[0][0] == outs[1][0]
    lib = outs[0][0].splitlines()[0]
    assert os.path.dirname(lib) == str(build)
    assert sorted(os.listdir(build)) == sorted([os.path.basename(lib),
                                                "native.lock"])


@settings(max_examples=300, deadline=None)
@given(st.lists(st.sampled_from([b"a", b",", b'"', b"\n", b"\xc3\xa9",
                                 b"\xe2\x82\xac", b"\xf0\x9f\x98\x80",
                                 b"\xc3", b"\xe2\x82", b"\x80", b"\xff",
                                 b"\xed\xa0\x80", b"\xc0\xaf"]),
                min_size=1, max_size=40), st.integers(1, 3))
def test_split_csv_utf8_check_matches_cpython(pieces, k):
    """Both splitters accept exactly the bytes CPython decodes as UTF-8
    and otherwise raise its error: the same offsets and reason."""
    data = b"".join(pieces)
    try:
        data.decode("utf-8")
        want = None
    except UnicodeDecodeError as e:
        want = (e.start, e.end, e.reason)
    for split in (N.split_csv, csvsource._split_records):
        try:
            split(data, ord(","), ord('"'), k, False)
            got = None
        except UnicodeDecodeError as e:
            got = (e.start, e.end, e.reason)
        assert got == want, split
