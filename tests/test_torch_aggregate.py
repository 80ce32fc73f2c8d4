"""aggregate, aggregateByKey and unique through
tuplex_tpu_torch.Context(device="cpu"), and the DataSet metadata.

Oracles: a plain Python loop over the same rows (order, values and types
exact, with `repr` so that -0.0 and NaN count; exception counts exact),
and `tuplex_tpu.Context()` for NYC 311 and the metadata (`columns`,
`types`, `schema`). Small partitions make every case cross partition
boundaries.
"""

import math

import jax  # noqa: F401  (configured for the CPU by conftest)
import numpy as np
import pytest
import torch

import tuplex_tpu
import tuplex_tpu_torch
from tuplex_tpu.models import nyc311 as ref_nyc311
from tuplex_tpu_torch.compiler.values import CV
from tuplex_tpu_torch.core import typesys as T
from tuplex_tpu_torch.models import nyc311, tpch, zillow
from tuplex_tpu_torch.ops import fold as F
from tuplex_tpu_torch.runtime import columns as C

CONF = {"tuplex.partitionSize": "1KB"}   # 64 rows a partition


@pytest.fixture(autouse=True)
def _private_aot_store(tmp_path, monkeypatch):
    """The reference package keeps compiled stages in an on-disk store
    that every process of one HOME shares; this file's reference runs use
    a store of their own. They compile in the test's own process: the
    reference's default on the CPU, a forked compile child per stage,
    costs seconds a pipeline and gives the same results."""
    monkeypatch.setenv("TUPLEX_AOT_CACHE", str(tmp_path / "aot"))
    monkeypatch.setenv("TUPLEX_COMPILE_ISOLATION", "thread")


def _port():
    return tuplex_tpu_torch.Context(CONF, device="cpu")


def _loop_by_key(rows, key, fold, initial):
    groups, excs = {}, {}
    for x in rows:
        k = key(x)
        try:
            groups[k] = fold(groups.get(k, initial), x)
        except Exception as e:
            excs[type(e).__name__] = excs.get(type(e).__name__, 0) + 1
    return groups, excs


def test_metadata_matches_reference(tmp_path):
    z, li = str(tmp_path / "z.csv"), str(tmp_path / "li.csv")
    zillow.generate_csv(z, 300, seed=7)
    tpch.generate_csv(li, 300, seed=7)
    for path in (z, li):
        got = tuplex_tpu_torch.Context(device="cpu").csv(path)
        ref = tuplex_tpu.Context().csv(path)
        assert got.columns == ref.columns
        assert [t.name for t in got.types] == [t.name for t in ref.types]
        assert got.schema.name == ref.schema.name
    ds = tpch.q1(tuplex_tpu_torch.Context(device="cpu").csv(li))
    assert ds.columns == ["l_returnflag", "l_linestatus", "_0", "_1", "_2",
                          "_3"]


def test_nyc311_matches_reference_and_loop(tmp_path):
    path = str(tmp_path / "311.csv")
    nyc311.generate_csv(path, 3000, seed=23)
    ctx = _port()
    got = nyc311.build_pipeline(ctx, path).collect()
    assert got == nyc311.run_reference_python(path)
    ref = ref_nyc311.build_pipeline(tuplex_tpu.Context(), path).collect()
    assert sorted(map(repr, got)) == sorted(map(repr, ref))
    assert ctx.metrics.stages[0]["tier"] == "compiled"
    assert ctx.metrics.stages[1]["device_rows"] == 3000


def test_unique_first_occurrence_with_signed_zeros_and_nan():
    nan = float("nan")
    rows = [(float(v), "k" + str(v % 3)) for v in np.random.default_rng(
        3).integers(0, 9, 400)]
    rows[5] = (-0.0, "k0")
    rows[70] = (0.0, "k0")
    rows[8] = (nan, "k1")
    rows[300] = (float("nan"), "k1")
    rows[9] = (None, "k2")
    rows[200] = (None, "k2")
    ds = _port().parallelize(rows).unique()
    seen, want = set(), []
    for r in rows:
        if r not in seen:
            seen.add(r)
            want.append(r)
    assert repr(ds.collect()) == repr(want)
    assert _port().parallelize([1, 1]).filter(lambda x: x > 5).unique() \
        .collect() == []


def test_group_order_is_first_folded_row():
    """Keys come out in the order their first row folded, device or
    interpreter: a boxed row (a str value in the int column) that raises
    does not place its key, one that folds (a float) does."""
    rng = np.random.default_rng(4)
    rows = [("k%d" % int(rng.integers(0, 12)), int(rng.integers(0, 100)))
            for _ in range(600)]
    rows[0] = ("late", "x")
    rows[1] = ("boxed", 2.5)
    rows[400] = ("late", 7)
    rows[450] = ("boxed", 3)
    ds = _port().parallelize(rows, columns=["k", "v"]).aggregateByKey(
        lambda a, b: a + b, lambda a, x: a + x["v"], 0, ["k"])
    got = ds.collect()
    want, excs = _loop_by_key(rows, lambda r: r[0],
                              lambda a, r: a + r[1], 0)
    assert repr(got) == repr([k + (v,) for k, v in
                              ((k if isinstance(k, tuple) else (k,), v)
                               for k, v in want.items())])
    assert ds.exception_counts() == excs == {"TypeError": 1}


def test_ghost_group_initial_once_and_exceptions():
    """A key whose every row raises in the fold on the device emits no
    row; the initial value seeds each key once, whatever the number of
    partitions; exceptions name the aggregate."""
    rows = [("g" if i % 5 == 0 else "h%d" % (i % 3), i, 0 if i % 5 == 0
             else 1 + i % 4) for i in range(500)]
    ctx = _port()
    ds = ctx.parallelize(rows, columns=["k", "v", "d"]).aggregateByKey(
        lambda a, b: (a[0] + b[0], a[1] + b[1]),
        lambda a, x: (a[0] + x["v"] // x["d"], a[1] + 1), (100, 0), ["k"])
    got = ds.collect()
    want, excs = _loop_by_key(rows, lambda r: r[0],
                              lambda a, r: (a[0] + r[1] // r[2], a[1] + 1),
                              (100, 0))
    assert got == [(k, *v) for k, v in want.items()]
    assert "g" not in [r[0] for r in got]
    assert ds.exception_counts() == excs == {"ZeroDivisionError": 100}
    agg_id = ds._op.id
    assert {r.op_id for r in ds._last_exceptions} == {agg_id}
    assert ctx.metrics.stages[-1]["device_rows"] == 400


def test_empty_inputs():
    ds = _port().parallelize([1, 2, 3])
    none = ds.filter(lambda x: x > 5)
    assert none.aggregate(lambda a, b: a + b, lambda a, x: a + x,
                          7).collect() == [7]
    assert none.map(lambda x: (x, x)).aggregateByKey(
        lambda a, b: a + b, lambda a, x: a + x[1], 0, ["_0"]).collect() == []
    assert none.unique().collect() == []


def test_unrecognized_fold_runs_on_the_interpreter():
    rows = list(range(1, 300))
    ctx = _port()
    got = ctx.parallelize(rows).aggregate(
        lambda a, b: a + b, lambda a, x: a * 3 % 1000003 + x, 1).collect()
    want = 1
    for x in rows:
        want = want * 3 % 1000003 + x
    assert got == [want]
    assert ctx.metrics.stages[-1]["host_folded_rows"] == len(rows)
    assert ctx.metrics.stages[-1]["device_rows"] == 0
    assert ctx.metrics.interpreterRows() == 0


@pytest.mark.parametrize("fold", [
    lambda a, x: min(a, x), lambda a, x: min(x, a),
    lambda a, x: max(a, x), lambda a, x: max(x, a)],
    ids=["min-acc-first", "min-acc-last", "max-acc-first", "max-acc-last"])
@pytest.mark.parametrize("initial", [0.0, -0.0, 5.0, 0])
@pytest.mark.parametrize("fused", [False, True])
def test_min_max_with_nan_and_signed_zero(fold, initial, fused):
    """Python's min/max keep one of two equal (or unordered) arguments by
    their order: partitions that meet NaN or both signed zeros fold in
    order on the interpreter, the others on the device (by key in the
    aggregate stage; the whole-dataset fold in the transform stage before
    it, an empty one or one with a map)."""
    rng = np.random.default_rng(5)
    vals = [float(v) for v in rng.uniform(-50, 50, 700)]
    vals[3], vals[90], vals[91] = 0.0, -0.0, 0.0
    vals[200], vals[650] = float("nan"), -0.0
    ctx = _port()
    ds = ctx.parallelize(vals)
    if fused:
        ds = ds.map(lambda x: x * 1.0)
    got = ds.aggregate(lambda a, b: a, fold, initial).collect()
    want = initial
    for v in vals:
        want = fold(want, v)
    assert repr(got) == repr([want])
    dev = ctx.metrics.stages[-1]["device_rows"]
    assert 0 < dev < len(vals)
    by_key = ctx.parallelize([(i % 2, v) for i, v in enumerate(vals)]) \
        .aggregateByKey(lambda a, b: a, lambda a, x: fold(a, x[1]),
                        initial, ["_0"]).collect()
    want2, _ = _loop_by_key([(i % 2, v) for i, v in enumerate(vals)],
                            lambda r: r[0], lambda a, r: fold(a, r[1]),
                            initial)
    assert repr(by_key) == repr([(k, v) for k, v in want2.items()])


@pytest.mark.parametrize("zeros", ["int", "positive", "negative", "mixed"])
def test_min_max_zeros_fold_on_the_device_unless_signs_mix(zeros):
    """Zeros that are all equal bits (int zeros, or floats that hold only
    +0.0 or only -0.0) tie with nothing distinct: every partition folds
    on the device, and the result is the loop's, the sign of a zero that
    the initial value brings included. A partition whose extreme is both
    +0.0 and -0.0 folds in row order on the interpreter."""
    base = [int(v) for v in np.random.default_rng(9).integers(1, 40, 500)]
    base[7] = base[8] = base[300] = 0

    def conv(i, v):
        if zeros == "int":
            return v
        if v != 0:
            return float(v)
        neg = zeros == "negative" or (zeros == "mixed" and i == 8)
        return -0.0 if neg else 0.0

    cases = [(lambda a, x: min(a, x), lambda a, x: min(a, x[1]),
              [conv(i, v) for i, v in enumerate(base)]),
             (lambda a, x: max(x, a), lambda a, x: max(x[1], a),
              [conv(i, -v) for i, v in enumerate(base)])]

    def check_device_rows(ctx):
        dev = ctx.metrics.stages[-1]["device_rows"]
        if zeros == "mixed":
            assert 0 < dev < len(base) and ctx.metrics.hostFoldedRows() > 0
        else:
            assert dev == len(base) and ctx.metrics.hostFoldedRows() == 0

    for fold, fold_kv, vals in cases:
        for initial in (-0.0, 0):
            ctx = _port()
            got = ctx.parallelize(vals).aggregate(lambda a, b: a, fold,
                                                  initial).collect()
            want = initial
            for v in vals:
                want = fold(want, v)
            assert repr(got) == repr([want])
            check_device_rows(ctx)
            ctx = _port()
            rows = [(i % 3, v) for i, v in enumerate(vals)]
            got = ctx.parallelize(rows).aggregateByKey(
                lambda a, b: a, fold_kv, initial, ["_0"]).collect()
            want, _ = _loop_by_key(rows, lambda r: r[0], fold_kv, initial)
            assert repr(got) == repr([(k, v) for k, v in want.items()])
            check_device_rows(ctx)


def test_min_max_keep_row_order_with_interpreter_rows():
    """A boxed row (3.0 in an int column) that ties with device values: the
    partition folds in row order on the interpreter, so min keeps the
    first of the equal values, as CPython does."""
    rows = [10, 3.0] + [3] * 100 + [7] * 100
    for fold in (lambda a, x: min(a, x), lambda a, x: min(x, a)):
        got = _port().parallelize(rows).aggregate(lambda a, b: a, fold,
                                                  50).collect()
        want = 50
        for v in rows:
            want = fold(want, v)
        assert repr(got) == repr([want])


def test_factorize_numbers_groups_by_first_row():
    """Group codes follow the order of each group's first row, and rows
    outside `ok` get -1."""
    keys = ["c", "a", "c", "b", "a", "d", "b"]
    leaf = C.encode_str_leaf(keys, False)
    cv = CV(t=T.STR, sbytes=torch.from_numpy(leaf.bytes.copy()),
            slen=torch.from_numpy(leaf.lengths))
    ok = torch.tensor([True] * 5 + [False, True])
    codes, first = F.factorize(F.signature([cv], 7, "cpu"), ok)
    assert codes.tolist() == [0, 1, 0, 2, 1, -1, 2]
    assert first.tolist() == [0, 1, 3]


def test_int64_sum_does_not_wrap():
    rows = [(i % 2, 2 ** 62 + i) for i in range(200)]
    ds = _port().parallelize(rows)
    got = ds.aggregate(lambda a, b: a + b, lambda a, x: a + x[1],
                       0).collect()
    assert got == [sum(v for _, v in rows)] and got[0] > 2 ** 63
    got = ds.aggregateByKey(lambda a, b: a + b, lambda a, x: a + x[1], 0,
                            ["_0"]).collect()
    assert got == [(k, sum(v for kk, v in rows if kk == k)) for k in (0, 1)]
    small = _port().parallelize(list(range(-100, 100)))
    assert small.aggregate(lambda a, b: a + b, lambda a, x: a + x,
                           0).collect() == [-100]


def test_fused_fold_rows_that_raise_fold_on_the_interpreter():
    """A whole-dataset fold inside the transform stage: rows whose fold
    expression raises (None in an Option column) re-run on the
    interpreter and raise there, under the aggregate's id."""
    rows = [(i, None if i % 7 == 0 else float(i)) for i in range(300)]
    ctx = _port()
    ds = ctx.parallelize(rows, columns=["i", "v"]) \
        .filter(lambda x: x["i"] % 2 == 0) \
        .aggregate(lambda a, b: a + b, lambda a, x: a + x["v"] * 2, 0.0)
    (got,) = ds.collect()
    want = sum(v * 2 for i, v in rows if i % 2 == 0 and v is not None)
    assert math.isclose(got, want, rel_tol=1e-12)
    n_none = len([1 for i, v in rows if i % 2 == 0 and v is None])
    assert ds.exception_counts() == {"TypeError": n_none}
    assert ctx.metrics.stages[0]["fetched_row_columns"] == 0
    # each such row ran the interpreter once, and folded on the host once
    # (a fold expression flags its rows apart, not in the lattice, so no
    # other tier takes them)
    m = ctx.metrics
    assert m.interpreterRows() + m.generalRows() + m.exactExitRows() \
        == n_none
    assert m.interpreterRows() == n_none
    assert ctx.metrics.hostFoldedRows() == n_none


def test_reductions_are_fixed_order():
    """tree_reduce and segment_reduce add in one fixed order: the same
    bits on every call, and the plain sum within rounding."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.uniform(-1e6, 1e6, 10_001))
    codes = torch.from_numpy(rng.integers(0, 7, 10_001))
    a = F.tree_reduce(x, "sum")
    assert a.item() == F.tree_reduce(x.clone(), "sum").item()
    assert math.isclose(a.item(), math.fsum(x.tolist()), rel_tol=1e-9)
    seg = F.segment_reduce(x, codes, 8, "sum")
    for s in range(7):
        assert math.isclose(seg[s].item(), math.fsum(
            x[codes == s].tolist()), rel_tol=1e-9)
    assert seg[7].item() == 0.0
    assert F.segment_reduce(x, codes, 8, "max")[:7].tolist() == [
        x[codes == s].max().item() for s in range(7)]


def test_string_ordering_compiles_with_python_semantics():
    """<, <=, >, >= and chained forms on strings run on the device, in
    code-point order; a None operand and a str against an int raise
    TypeError for the row, as in CPython."""
    words = ["apple", "Apple", "", "é", "zebra", "m", "mango", None,
             "日本", "a\x00", "1994-01-01", "1995-06-30"] * 20
    fns = [lambda x: "b" <= x < "n", lambda x: x > "é",
           lambda x: (x >= "1994-01-01") and (x < "1995-01-01"),
           lambda x: "m" >= x]
    for fn in fns:
        ctx = _port()
        ds = ctx.parallelize(words).filter(fn)
        got = ds.collect()
        want, excs = [], {}
        for w in words:
            try:
                if fn(w):
                    want.append(w)
            except TypeError:
                excs["TypeError"] = excs.get("TypeError", 0) + 1
        assert got == want and ds.exception_counts() == excs
        assert ctx.metrics.stages[0]["tier"] == "compiled"
    ds = _port().parallelize(["a", "b"]).map(lambda x: x < 3)
    assert ds.collect() == [] and ds.exception_counts() == {"TypeError": 2}
