"""tuplex_tpu_torch's CSV source against Python's csv module and the
reference package.

Oracles: the stdlib `csv` reader for the raw cells of every record (the
splitter must give the same cells, rows in file order); the reference
package's `CSVStatistic` for the sniffed delimiter, header, column names and
normal-case types; the reference's device decode (`_emit_decode`, run
eagerly on the CPU) for where NULLERROR and BADPARSE_STRING_INPUT fire.
Tolerance: exact.
"""

import csv
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tuplex_tpu_torch
from tuplex_tpu.compiler import emitter as ref_emitter
from tuplex_tpu.compiler import stagefn as ref_stagefn
from tuplex_tpu.core.options import ContextOptions as RefOptions
from tuplex_tpu.io import csvsource as ref_csv
from tuplex_tpu.plan import physical as ref_physical
from tuplex_tpu.runtime import columns as ref_columns
from tuplex_tpu_torch.core.options import ContextOptions
from tuplex_tpu_torch.io import csvsource
from tuplex_tpu_torch.plan import physical
from tuplex_tpu_torch.runtime import columns as C


@pytest.fixture(autouse=True)
def _private_aot_store(tmp_path, monkeypatch):
    """The reference package keeps compiled stages in an on-disk store
    that every process of one HOME shares; this file's reference runs use
    a store of their own."""
    monkeypatch.setenv("TUPLEX_AOT_CACHE", str(tmp_path / "aot"))


HEADER = "name,qty,note\n"
FILES = {
    "plain": HEADER + "a,1,x\nb,2,y\nc,3,z\n",
    "quoted commas": HEADER + 'a,1,"x, y"\n"b, c",2,""\nd,3,"z"\n',
    "crlf": HEADER.replace("\n", "\r\n") + "a,1,x\r\nb,2,\r\nc,3,z\r\n",
    "blank lines, no final newline": HEADER + "a,1,x\n\n\nb,2,y\n\nc,3,z",
    "doubled quotes": HEADER + 'a,1,"say ""hi"""\nb,2,y\nc,3,"""q"""\n',
    "newline in quotes": HEADER + 'a,1,"two\nlines"\nb,2,y\nc,3,"cr\r\nlf"\n',
    "wrong field counts": HEADER + "a,1\nb,2,y,extra\nc,3,z\n,,\n",
    "stray quote": HEADER + 'a,1,x"y\nb,2,y\nc,3,z\n',
    "empty cells": HEADER + ",,\na,,\n,5,\nb,6,last,\n",
    "wide cell": HEADER + "a,1," + "w" * 300 + "\nb,2,y\n",
}


def _stdlib_rows(text: str, k: int, delimiter=","):
    rows = [r for r in csv.reader(io.StringIO(text, newline=""),
                                  delimiter=delimiter) if r][1:]
    return [tuple(r[i] if i < len(r) else None for i in range(k))
            for r in rows]


def _port_rows(path, options=None):
    ds = tuplex_tpu_torch.Context(options, device="cpu").csv(path)
    src = ds._op.parent
    parts = src.load_partitions()
    return [v for p in parts for v in C.partition_to_pylist(p)], parts, src


@pytest.mark.parametrize("name", sorted(FILES))
def test_splitter_matches_stdlib_csv(name, tmp_path):
    path = tmp_path / "f.csv"
    path.write_bytes(FILES[name].encode())
    opts = {"tuplex.tpu.maxStrBytes": "256"} if name == "wide cell" else None
    got, parts, src = _port_rows(str(path), opts)
    assert src.stat.columns == ["name", "qty", "note"]
    assert got == _stdlib_rows(FILES[name], 3)
    # records the splitter takes stay on the fast path; the others are
    # boxed rows for the interpreter. A stray quote flips the quote parity
    # for the rest of the file: every record after it is read by csv
    boxed = sum(len(p.fallback) for p in parts)
    want_boxed = {"doubled quotes": 2, "newline in quotes": 2,
                  "wrong field counts": 2, "stray quote": 3,
                  "empty cells": 1, "wide cell": 1}.get(name, 0)
    assert boxed == want_boxed


def test_splitter_partitions_keep_file_order(tmp_path):
    """Many partitions, bad records spread over them: every row keeps its
    slot and start_index counts rows across partitions."""
    rng = np.random.default_rng(5)
    lines = []
    for i in range(3000):
        r = rng.random()
        if r < 0.02:
            lines.append(f'r{i},{i},"a ""q"" b"')
        elif r < 0.04:
            lines.append(f"r{i},{i}")
        else:
            lines.append(f'r{i},{i},"n, {i}"')
    text = HEADER + "\n".join(lines) + "\n"
    path = tmp_path / "many.csv"
    path.write_text(text)
    got, parts, _ = _port_rows(str(path), {"tuplex.partitionSize": "8KB"})
    assert len(parts) > 4
    assert got == _stdlib_rows(text, 3)
    starts = [p.start_index for p in parts]
    assert starts == list(np.cumsum([0] + [p.num_rows for p in parts])[:-1])


SAMPLES = {
    "zillow-like": "a,b,c\n" + "".join(f"x{i},{i},{i * 0.5}\n"
                                       for i in range(50)),
    "no header": "".join(f"{i},{i * 2},s{i}\n" for i in range(40)),
    "semicolons": "k;v\n" + "".join(f"{i};t{i}\n" for i in range(30)),
    "nulls": "id,maybe\n" + "".join(
        f"{i},{'' if i % 5 == 0 else i}\n" for i in range(60)),
    "mostly null": "id,maybe\n" + "".join(
        f"{i},{'' if i % 2 else i}\n" for i in range(60)),
    "bools and strings": "f,s\n" + "".join(
        f"{'true' if i % 2 else 'False'},w{i}\n" for i in range(30)),
    "all strings": "p,q\n" + "".join(f"u{i},v{i}\n" for i in range(30)),
    "tabs": "a\tb\n" + "".join(f"{i}\tx y {i}\n" for i in range(30)),
}


@pytest.mark.parametrize("name", sorted(SAMPLES))
def test_statistic_matches_reference(name):
    data = SAMPLES[name].encode()
    got = csvsource.CSVStatistic(data, ContextOptions())
    want = ref_csv.CSVStatistic(data, RefOptions())
    assert (got.delimiter, got.has_header, got.columns, got.num_columns) \
        == (want.delimiter, want.has_header, want.columns, want.num_columns)
    assert [t.name for t in got.types] == [t.name for t in want.types]
    assert got.sample_rows == want.sample_rows


def test_zillow_schema_matches_reference(tmp_path):
    """The inferred schema of the Zillow file, read by both packages."""
    import tuplex_tpu
    from tuplex_tpu_torch.models import zillow

    path = str(tmp_path / "z.csv")
    zillow.generate_csv(path, 2000, seed=42)
    got = tuplex_tpu_torch.Context(device="cpu").csv(path)._op.schema()
    want = tuplex_tpu.Context().csv(path)._op.schema()
    assert got.columns == want.columns
    assert [t.name for t in got.types] == [t.name for t in want.types]
    assert str(got) == (
        "Row['title':str,'address':str,'city':str,'state':str,"
        "'postal_code':Option[i64],'price':str,'facts and features':"
        "Option[str],'real estate provider':str,'url':str,"
        "'sales_date':str]")


DECODE_TEXT = ("s,n,on,os\n" + "".join(
    f"w{i},{i},{i},t{i}\n" for i in range(40)) +
    ",7,,\n"                 # null str -> NULLERROR; Option cells -> None
    "x,,5,a\n"               # null in the i64 column -> NULLERROR
    "y,12a,x9,b\n"           # bad parses -> BADPARSE_STRING_INPUT
    "z, 8 ,-0,c\n"           # int() strips and takes a sign
    "q,1_0,99999999999999999999,d\n"   # valid for int(), outside the kernel
    "r,+3,١,e\n")            # non-ASCII digit


def test_decode_errors_match_reference(tmp_path):
    """The fused decode raises NULLERROR and BADPARSE_STRING_INPUT on the
    same rows as the reference's device decode, and decodes the same
    values elsewhere."""
    from tuplex_tpu.core import typesys as RT
    from tuplex_tpu_torch.core import typesys as PT

    path = tmp_path / "d.csv"
    path.write_text(DECODE_TEXT)
    # a sniffed column with a null is Option; the hints make two non-Option
    ds = tuplex_tpu_torch.Context(device="cpu").csv(
        str(path), type_hints={0: PT.STR, 1: PT.I64})
    dec_op = ds._op
    assert [t.name for t in dec_op.schema().types] == \
        ["str", "i64", "Option[i64]", "Option[str]"]
    stage = physical.plan_stages(dec_op)[0]
    (part,) = C.harmonize_partitions(stage.source.load_partitions())
    batch = C.stage_partition(part, torch.device("cpu"))
    outs = stage.build_device_fn()(batch.arrays)
    got_err = outs["#err"][: part.num_rows].numpy() & 0xFF

    ref_stat = ref_csv.CSVStatistic(path.read_bytes(), RefOptions(),
                                    type_hints={0: RT.STR, 1: RT.I64})
    ref_op = ref_physical.L.DecodeOperator(
        ref_csv.CSVSourceOperator(RefOptions(), str(path), ref_stat,
                                  [str(path)]),
        ref_csv._decoded_schema(ref_stat), ref_stat.null_values)
    raw = C.partition_to_pylist(part)
    ref_part = ref_columns.build_partition(raw, ref_op.parent.schema())
    ref_batch = ref_columns.stage_partition(ref_part)
    arrays = {k: jnp.asarray(v) for k, v in ref_batch.arrays.items()}
    ctx = ref_emitter.EmitCtx(ref_batch.b, arrays["#rowvalid"])
    row = ref_stagefn.input_row_cv(arrays, ref_op.parent.schema())
    frame = ref_emitter.Frame(ref_emitter.Emitter(ctx, {}), {})
    ref_row, _, _ = ref_physical._emit_decode(ctx, frame, ref_op, row,
                                              arrays["#rowvalid"])
    want_err = np.asarray(ctx.err)[: part.num_rows] & 0xFF
    np.testing.assert_array_equal(got_err, want_err)
    assert set(got_err.tolist()) == {0, 101, 102}
    ok = want_err == 0
    for ci in (1, 2):
        np.testing.assert_array_equal(
            outs[f"{ci}"][: part.num_rows].numpy()[ok],
            np.asarray(ref_row.elts[ci].data)[: part.num_rows][ok])
    np.testing.assert_array_equal(
        outs["2#valid"][: part.num_rows].numpy()[ok],
        np.asarray(ref_row.elts[2].valid)[: part.num_rows][ok])


def test_csv_pipeline_matches_reference(tmp_path):
    """A small CSV pipeline through both packages: decode errors resolve
    on the interpreter, nulls reach the UDFs as None."""
    import tuplex_tpu

    path = tmp_path / "d.csv"
    path.write_text(DECODE_TEXT)

    def build(ctx):
        return (ctx.csv(str(path))
                .withColumn("m", lambda x: x["n"] * 2 if x["on"] is None
                            else x["n"] + x["on"])
                .filter(lambda x: x["m"] % 3 != 1)
                .mapColumn("os", lambda v: v + "!")
                .selectColumns(["os", "m", "s"]))

    port = tuplex_tpu_torch.Context(device="cpu")
    ds = build(port)
    got = ds.collect()
    ref = build(tuplex_tpu.Context())
    assert got == ref.collect()
    assert ds.exception_counts() == ref.exception_counts()
    assert port.metrics.stages[-1]["tier"] == "compiled"
    assert port.metrics.deviceErrorRows() >= 5


# -- C12: bytes that are not UTF-8 ---------------------------------------------

BAD_UTF8 = b"a,b\n1,\xff\xfe\n2,ok\n"


@pytest.mark.parametrize("path_kind", ["native", "python"])
def test_c12_invalid_utf8_raises_before_any_row(tmp_path, monkeypatch,
                                                path_kind):
    """The CSV source raises UnicodeDecodeError naming the file, at the
    same offset and for the same reason as CPython's decode of the file,
    on the native splitter and on its numpy path, before any row."""
    from tuplex_tpu_torch import native

    if path_kind == "python":
        monkeypatch.setattr(native, "_mod", None)
        monkeypatch.setattr(native, "_tried", True)
    elif native.get() is None:
        pytest.skip("no g++ on PATH: the native module is not built")
    path = tmp_path / "bad.csv"
    path.write_bytes(BAD_UTF8)
    with pytest.raises(UnicodeDecodeError) as got:
        BAD_UTF8.decode("utf-8")
    want = got.value
    ds = tuplex_tpu_torch.Context(device="cpu").csv(str(path))
    with pytest.raises(UnicodeDecodeError) as got:
        ds.collect()
    e = got.value
    assert (e.start, e.end) == (want.start, want.end)
    assert e.reason.startswith(want.reason) and str(path) in str(e)


def test_c12_loop_and_reference_raise_too(tmp_path):
    """The oracles: a loop over the file opened as UTF-8 and the reference
    package both raise a ValueError (UnicodeDecodeError, ArrowInvalid)."""
    import tuplex_tpu

    path = tmp_path / "bad.csv"
    path.write_bytes(BAD_UTF8)
    with pytest.raises(ValueError):
        with open(path, encoding="utf-8", newline="") as fp:
            list(csv.reader(fp))
    with pytest.raises(ValueError):
        tuplex_tpu.Context().csv(str(path)).collect()


def test_c12_text_source_keeps_replacement_characters(tmp_path):
    path = tmp_path / "bad.txt"
    path.write_bytes(BAD_UTF8)
    got = tuplex_tpu_torch.Context(device="cpu").text(str(path)).collect()
    assert got == BAD_UTF8.decode("utf-8", "replace").splitlines()
