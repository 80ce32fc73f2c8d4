"""Zillow Z1 through tuplex_tpu_torch.Context(device="cpu") against the
reference package, plus emitter goldens for the constructs Z1's UDFs use.

Oracles:
  * rows, order and types: `tuplex_tpu.models.zillow.run_reference_python`
    (pure CPython, no JAX) on the same file; exact;
  * exception counts: one `tuplex_tpu.Context` run at 400 rows, and a
    CPython loop over the same rows. The port sends every device-error row
    to the interpreter, so its counts are CPython's. The reference's
    exact-exception exit reports a method call on None (`val.find(...)`
    with a null "facts and features" cell) as TypeError where CPython
    raises AttributeError; the comparison with the reference says so
    explicitly;
  * the emitter goldens: the CPython interpreter row by row (the harness
    of tests/test_emitter.py): values equal, exception classes equal, rows
    routed to the interpreter by an internal code skipped.
"""

import collections
import csv

import pytest
import torch

import tuplex_tpu_torch
from tuplex_tpu.models import zillow as ref_zillow
from tuplex_tpu_torch.compiler.emitter import EmitCtx, Emitter
from tuplex_tpu_torch.compiler.stagefn import input_row_cv, result_arrays
from tuplex_tpu_torch.core import typesys as T
from tuplex_tpu_torch.core.errors import ExceptionCode
from tuplex_tpu_torch.core.row import Row
from tuplex_tpu_torch.models import zillow
from tuplex_tpu_torch.runtime import columns as C
from tuplex_tpu_torch.utils.reflection import get_udf_source


@pytest.fixture(autouse=True)
def _private_aot_store(tmp_path, monkeypatch):
    """The reference package keeps compiled stages in an on-disk store
    that every process of one HOME shares; this file's reference runs use
    a store of their own."""
    monkeypatch.setenv("TUPLEX_AOT_CACHE", str(tmp_path / "aot"))


@pytest.mark.parametrize("seed,n", [(7, 400), (42, 3000)])
def test_generator_matches_reference(tmp_path, seed, n):
    a, b = tmp_path / "a.csv", tmp_path / "b.csv"
    zillow.generate_csv(str(a), n, seed=seed)
    ref_zillow.generate_csv(str(b), n, seed=seed)
    assert a.read_bytes() == b.read_bytes()


def _cpython_exception_counts(path: str) -> dict:
    """The first exception of each row through Z1 in plain CPython, cells
    decoded as the CSV source speculates them (empty -> None, postal codes
    to int where they parse)."""
    chain = [("bedrooms", zillow.extractBd),
             (None, lambda x: x["bedrooms"] < 10),
             ("type", zillow.extractType),
             (None, lambda x: x["type"] == "house"),
             ("zipcode", lambda x: "%05d" % int(x["postal_code"])),
             ("city", lambda x: x["city"][0].upper()
              + x["city"][1:].lower()),
             ("bathrooms", zillow.extractBa), ("sqft", zillow.extractSqft),
             ("offer", zillow.extractOffer), ("price", zillow.extractPrice),
             (None, lambda x: 100000 < x["price"] <= 2e7)]
    counts = collections.Counter()
    with open(path, newline="") as fp:
        for row in csv.DictReader(fp):
            x = {k: (None if v == "" else v) for k, v in row.items()}
            try:
                x["postal_code"] = int(x["postal_code"])
            except (TypeError, ValueError):
                pass
            for col, f in chain:
                try:
                    v = f(x)
                except Exception as e:
                    counts[type(e).__name__] += 1
                    break
                if col is None and not v:
                    break
                if col is not None:
                    x[col] = v
    return dict(counts)


def _types(rows):
    return [tuple(type(v) for v in r) for r in rows]


def test_z1_400_rows_matches_reference(tmp_path):
    import tuplex_tpu

    path = str(tmp_path / "z.csv")
    zillow.generate_csv(path, 400, seed=7)
    want = ref_zillow.run_reference_python(path)
    ctx = tuplex_tpu_torch.Context(device="cpu")
    ds = zillow.build_pipeline(ctx.csv(path))
    got = ds.collect()
    assert got == want and _types(got) == _types(want)
    assert len(got) > 150
    ref_ds = ref_zillow.build_pipeline(tuplex_tpu.Context().csv(path))
    assert str(ds._op.schema()) == str(ref_ds._op.schema())
    assert ref_ds.collect() == want
    counts = ds.exception_counts()
    assert counts == _cpython_exception_counts(path)
    assert counts == {"ValueError": 9, "TypeError": 1, "AttributeError": 6}
    as_reference = dict(counts)
    as_reference["TypeError"] += as_reference.pop("AttributeError")
    assert as_reference == ref_ds.exception_counts()
    # compiled; the dirty rows leave through the exact exit (exception
    # classes off the lattice) and the general tier (postal codes that do
    # not parse as ints), none through the interpreter
    m = ctx.metrics
    assert m.stages[-1]["tier"] == "compiled"
    assert 16 <= m.interpreterRows() + m.generalRows() + \
        m.exactExitRows() == m.deviceErrorRows() < 40
    assert m.interpreterRows() == 0 and m.exactExitRows() == 16


def test_z1_2000_rows_matches_python(tmp_path):
    path = str(tmp_path / "z.csv")
    zillow.generate_csv(path, 2000, seed=7)
    want = ref_zillow.run_reference_python(path)
    assert zillow.run_reference_python(path) == want
    ctx = tuplex_tpu_torch.Context({"tuplex.partitionSize": "64KB"},
                                   device="cpu")
    ds = zillow.build_pipeline(ctx.csv(path))
    got = ds.collect()
    assert got == want and _types(got) == _types(want)
    assert ds.exception_counts() == _cpython_exception_counts(path)
    assert len(ctx.metrics.stages) == 1
    assert ctx.metrics.stages[-1]["tier"] == "compiled"


# ---------------------------------------------------------------------------
# emitter goldens: compiled columnar UDF against the interpreter, per row
# ---------------------------------------------------------------------------

_CLASS_OF = {ExceptionCode.ZERODIVISIONERROR: "ZeroDivisionError",
             ExceptionCode.VALUEERROR: "ValueError",
             ExceptionCode.TYPEERROR: "TypeError",
             ExceptionCode.INDEXERROR: "IndexError",
             ExceptionCode.KEYERROR: "KeyError"}


def _schema(values, columns=None):
    if values and all(isinstance(v, tuple) for v in values):
        types = [T.normal_case_type([v[i] for v in values], 0.5)[0]
                 for i in range(len(values[0]))]
        return T.row_of(columns or [f"_{i}" for i in range(len(types))],
                        types)
    return T.row_of(columns or ["_0"],
                    [T.normal_case_type(values, 0.5)[0]])


def _run_compiled(f, values, columns=None):
    """Per row: the value, an exception class name, or None for a row
    routed to the interpreter by an internal code."""
    schema = _schema(values, columns)
    part = C.build_partition(values, schema)
    batch = C.stage_partition(part, torch.device("cpu"))
    ctx = EmitCtx(batch.b, batch.arrays["#rowvalid"])
    ctx.cur_op = 1
    udf = get_udf_source(f)
    res = Emitter(ctx, udf.globals).eval_udf(
        udf, [input_row_cv(batch.arrays, schema)])
    outs = {k: v.numpy()
            for k, v in result_arrays(res, batch.b, ctx.device).items()}
    vals = C.partition_to_pylist(C.partition_from_result_arrays(outs,
                                                                batch.b))
    out = []
    for i in range(part.num_rows):
        code = int(ctx.err[i]) & 0xFF
        if part.normal_mask is not None and not part.normal_mask[i]:
            out.append(None)    # outside the normal case: interpreted
        elif code == 0:
            out.append(vals[i])
        else:
            out.append(_CLASS_OF.get(ExceptionCode(code)))
    return out


def _run_interp(f, values, columns=None):
    out = []
    for v in values:
        try:
            out.append(f(Row.from_value(v, columns)) if columns else f(v))
        except Exception as e:
            out.append(type(e).__name__)
    return out


def check(f, values, columns=None):
    want = _run_interp(f, values, columns)
    got = _run_compiled(f, values, columns)
    compared = 0
    for i, (w, g) in enumerate(zip(want, got)):
        if g is None:
            continue    # resolved by the interpreter, exact by construction
        assert w == g and type(w) is type(g), (i, values[i], w, g)
        compared += 1
    assert compared > 0
    return got


def test_golden_zillow_extract_bd():
    rows = [("3 bds , 2 ba , 1,560 sqft",), ("2 bds , 1 ba , 800 sqft",),
            ("no data here",), ("10 bds , 9 ba",), ("",), ("7",)]
    got = check(zillow.extractBd, rows, columns=["facts and features"])
    assert got[:2] == [3, 2] and got[2] == "ValueError"


def test_golden_zillow_extract_price_style():
    def extractPrice(x):
        price = x["price"]
        p = 0
        if x["offer"] == "rent":
            max_idx = price.rfind("/")
            p = int(price[1:max_idx].replace(",", ""))
        else:
            p = int(price[1:].replace(",", ""))
        return p

    rows = [("$1,200/mo", "rent"), ("$350,000", "sale"), ("bad", "sale"),
            ("$9,999,000", "sold"), ("/mo", "rent")]
    got = check(extractPrice, rows, columns=["price", "offer"])
    assert got[:3] == [1200, 350000, "ValueError"]


def test_golden_extract_price_sold_branch():
    rows = [("--", "sold", "2 bds , Price/sqft: $312 , more", 1000),
            ("$500,000", "sale", "x", 10), ("$2,100/mo", "rent", "", 5),
            ("--", "sold", "no price here", 7)]
    check(zillow.extractPrice, rows,
          columns=["price", "offer", "facts and features", "sqft"])


def test_golden_if_else_or_in():
    def classify(x):
        t = x["title"].lower()
        kind = "unknown"
        if "condo" in t or "apartment" in t:
            kind = "condo"
        elif t == "":
            kind = "empty"
        else:
            if "house" in t:
                kind = "house"
        return kind

    rows = [("Nice Condo",), ("Big House",), ("Apartment 3B",), ("Land",),
            ("",), ("CONDO house",)]
    assert check(classify, rows, columns=["title"]) == \
        ["condo", "house", "condo", "unknown", "empty", "condo"]


def test_golden_returns_in_branches():
    rows = [(t,) for t in ["House For Sale", "Condo for rent",
                           "Sold: lovely house", "foreclosed barn", "Plot",
                           "Résidence for sale"]]
    got = check(zillow.extractOffer, rows, columns=["title"])
    assert got[:5] == ["sale", "rent", "sold", "foreclosed", "plot"]
    assert got[5] is None     # non-ASCII: lower() interprets

    def positive(x):
        if x > 0:
            return x * 2
    # rows that fall off the end return None: they interpret
    assert check(positive, [3, -1, 0, 8]) == [6, None, None, 16]


@pytest.mark.parametrize("f,values", [
    (lambda x: x > 3 or x < -3, [5, 0, -7, 3]),
    (lambda a: a and a * 2, [0, 4, -1]),
    (lambda s: s or "empty", ["", "x", "abc"]),
    (lambda x: "big" if x > 10 else "small", [11, 10, -3]),
])
def test_golden_bool_ops_and_conditional(f, values):
    check(f, values)


@pytest.mark.parametrize("f,values", [
    (lambda x: 100000 < x <= 2e7, [100000, 100001, 20000000, 20000001,
                                   -5, 2 ** 62]),
    # 2**53 + 1 is above the float 2**53: a float cast would call it equal
    (lambda x: x > 9007199254740992.0, [2 ** 53, 2 ** 53 + 1, 2 ** 53 - 1]),
    (lambda x: x == 2.5 or x <= -1e300 or x >= 1e19, [2, 3, -2 ** 63,
                                                      2 ** 63 - 1]),
    (lambda x: 1 < x["a"] < x["b"] != 4, [(2, 3), (2, 4), (0, 5),
                                          (3, 3)]),
])
def test_golden_chained_compare(f, values):
    cols = ["a", "b"] if isinstance(values[0], tuple) else None
    check(f, values, columns=cols)


@pytest.mark.parametrize("f,values", [
    (lambda s: "sale" in s.lower(), ["For SALE", "rent", "", "wholesale"]),
    (lambda x: x in (1, 2, 5), [1, 3, 5, -1]),
    (lambda s: "ab" not in s, ["xaby", "ba", "a b"]),
])
def test_golden_in(f, values):
    check(f, values)


def test_golden_int_and_format():
    got = check(lambda s: int(s), [" 42", "+7", "-0", "N/A", "0210A", "",
                                   "1_000", "12345678901234567890", "٣"])
    assert got[:6] == [42, 7, 0, "ValueError", "ValueError", "ValueError"]
    assert got[6:] == [None, None, None]   # valid for int(): interpreted
    check(lambda x: "%05d" % x, [42, 7, 123456, -3, -42, 0, -99999])
    check(lambda x: "id-%d!" % x, [1, -20, 0])
    check(lambda x: "%05d" % int(x), ["12", "x", "-7"])


def test_golden_map_column_city():
    got = check(lambda x: x[0].upper() + x[1:].lower(),
                ["boston", "CAMBRIDGE", "", "q", "éa"])
    assert got[:4] == ["Boston", "Cambridge", "IndexError", "Q"]


def test_golden_aug_assign_in_branch():
    def f(x):
        i = x.rfind(",")
        if i < 0:
            i = 0
        else:
            i += 2
        n = 1
        n += i
        return x[i:], n

    check(f, ["a, b, c", "nocomma", "x,", ""])


def test_golden_replace_and_options():
    check(lambda x: x.replace(",", ""), ["1,560", "", "a,,b,", "12"])
    check(lambda x: x is None or x > 2, [None, 1, 5])
    is_none = check(lambda x: x == None, [None, 3, 4])  # noqa: E711
    assert is_none == [True, False, False]
