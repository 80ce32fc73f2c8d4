"""General aggregate folds (plan/aggregates.py `ScanFold`,
compiler/foldprog.py, ops/segfold.py) through
tuplex_tpu_torch.Context(device="cpu"), where the kernel's plain version
folds.

Oracles: a plain CPython loop over the same rows, exact (rows, group
order, Python types via `repr`, so -0.0, NaN and int-versus-float count,
and exception counts), and `tuplex_tpu.Context()` on the reference's own
scan-fold cases (tests/test_agg_join.py), where its ScanFold is a sound
oracle (no boxed rows): ints exact, floats within 1e-12 relative. On
boxed rows the reference folds a partition's flagged rows after the rest
(ROADMAP C10); one test pins that it differs from the loop there and the
port does not. Small partitions make every case cross partition
boundaries.
"""

import ast
import math

import jax  # noqa: F401  (configured for the CPU by conftest)
import numpy as np
import pytest
import torch

import tuplex_tpu
import tuplex_tpu_torch
from tuplex_tpu_torch.core.row import Row
from tuplex_tpu_torch.models import tpch
from tuplex_tpu_torch.ops import segfold as SF
from tuplex_tpu_torch.plan import aggregates as A

CONF = {"tuplex.partitionSize": "4KB"}
COLS = ["k", "v", "w", "i", "j"]


@pytest.fixture(autouse=True)
def _private_aot_store(tmp_path, monkeypatch):
    """The reference package keeps compiled stages in an on-disk store
    that every process of one HOME shares; this file's reference runs use
    a store of their own, compiled in the test's own process."""
    monkeypatch.setenv("TUPLEX_AOT_CACHE", str(tmp_path / "aot"))
    monkeypatch.setenv("TUPLEX_COMPILE_ISOLATION", "thread")


def _port():
    return tuplex_tpu_torch.Context(CONF, device="cpu")


def _loop(rows, fold, initial, key=None):
    """(collect()'s rows, exception counts) of a plain loop."""
    groups, excs = {}, {}
    for x in rows:
        k = () if key is None else key(x)
        try:
            groups[k] = fold(groups.get(k, initial), x)
        except Exception as e:
            excs[type(e).__name__] = excs.get(type(e).__name__, 0) + 1
    if key is None:
        return [groups.get((), initial)], excs
    return [k + (v if isinstance(v, tuple) else (v,))
            for k, v in groups.items()], excs


def _rows(n=700, seed=3):
    """Seeded rows (k, v, w, i, j): 4 keys, floats with NaN and both signed
    zeros, small float and int divisors with zeros, ints of 7 digits."""
    rng = np.random.default_rng(seed)
    vs = [float(v) for v in rng.uniform(-50, 50, n)]
    for at, v in ((3, 0.0), (90, -0.0), (91, 0.0), (200, math.nan),
                  (250, -0.0)):
        if at < n:
            vs[at] = v
    cols = (rng.integers(0, 4, n), vs, rng.integers(-3, 4, n),
            rng.integers(-10 ** 6, 10 ** 6, n), rng.integers(-3, 4, n))
    return [(int(k), v, float(w), int(i), int(j))
            for k, v, w, i, j in zip(*cols)]


def _both(rows, fold, initial, cols=COLS, key_col="k"):
    """The fold through the port as `aggregate` and by `key_col` against
    the loop; returns the two contexts' aggregate-stage metrics."""
    out = []
    named = [Row(list(r), cols) for r in rows]
    for by_key in (False, True):
        ctx = _port()
        ds = ctx.parallelize(rows, columns=cols)
        ds = ds.aggregateByKey(lambda a, b: a, fold, initial, [key_col]) \
            if by_key else ds.aggregate(lambda a, b: a, fold, initial)
        got = ds.collect()
        want, excs = _loop(named, fold, initial,
                           (lambda x: (x[key_col],)) if by_key else None)
        assert repr(got) == repr(want), (by_key, got[:5], want[:5])
        assert ds.exception_counts() == excs
        out.append(ctx.metrics.stages[-1])
    return out


def decay(a, x):
    return a * 0.9 + x["v"]


def with_locals(a, x):
    """A def with locals, if/else and returns in both arms."""
    w = x["v"] * 2
    if a > 100:
        s = a - w
    else:
        s = a + w
    if x["k"] == 1:
        return s // 3
    return s


FOLDS = {
    "conditional-sum": (lambda a, x: a + x["v"] if x["v"] > 0 else a, 0),
    "decay": (decay, 0.0),
    "decay-int-initial": (decay, 0),
    "def-locals-if-else": (with_locals, 0),
    "min-max-acc-first": (lambda a, x: (min(a[0], x["v"]), max(a[1], x["v"]))
                          if x["i"] != 0 else a, (0.0, -0.0)),
    "min-max-acc-last": (lambda a, x: (min(x["v"], a[0]), max(x["v"], a[1]))
                         if x["i"] != 0 else a, (-0.0, 0.0)),
    "min-max-int-float": (lambda a, x: (min(x["w"], a[0]), max(a[1], x["j"]),
                                        a[2] + 1) if x["k"] else a,
                          (0, 0.0, 0)),
    "floordiv-mod-int": (lambda a, x: a * 7 % 1000 + x["i"] // x["j"] +
                         x["i"] % x["j"], 0),
    "floordiv-mod-float": (lambda a, x: a * 0.5 + x["v"] // x["w"] +
                           x["v"] % x["w"], 0.0),
    "floordiv-mod-acc": (lambda a, x: (a // x["j"]) + (a % 7) + x["v"]
                         if x["j"] else a - 1, 100),
    "int-truediv": (lambda a, x: a * 0.5 + x["i"] / x["j"], 0),
    "and-or-values": (lambda a, x: (a and x["v"]) or (a + 1), 1),
    "chained-compare": (lambda a, x: a + 1 if 0 < x["v"] < a else a - 1, 3),
    "chained-compare-row": (lambda a, x: a * 0.5 + x["v"]
                            if -10.0 <= x["v"] < x["w"] else a, 0.0),
    "chained-compare-none": (lambda a, x: a * 0.5 + x["v"]
                             if 0.0 <= x["v"] < x["n"] else a - 1, 0.0),
    "arms-of-two-types": (lambda a, x: a + 1 if x["i"] % 2 else a + 0.5, 0),
    "abs-bool": (lambda a, x: (a[0] + abs(x["v"]), a[1] or bool(x["i"] % 3)),
                 (0, False)),
    "int-float-builtins": (lambda a, x: int(a + x["v"]) if x["i"] % 5
                           else float(a), 0),
    "neg-not": (lambda a, x: -a + (not x["i"] % 2), 0),
}


@pytest.mark.parametrize("name", sorted(FOLDS))
def test_plain_fold_equals_the_loop(name):
    fold, initial = FOLDS[name]
    rows = _rows()
    cols = COLS
    if name == "chained-compare-none":
        # n is None on some rows: Python raises only where 0.0 <= v holds
        rows = [r + (None if i % 9 == 0 else 10.0,)
                for i, r in enumerate(rows)]
        cols = COLS + ["n"]
    for m in _both(rows, fold, initial, cols=cols):
        assert m["device_rows"] > 0 and m["scan_rows"] > 0
        assert m["device_rows"] + m["host_folded_rows"] == len(rows)


NOT_COMPILABLE = {
    "option-acc": (lambda a, x: x["v"] if a is None else a + x["v"], None),
    "str-acc": (lambda a, x: a + str(x["k"]), ""),
    "pow": (lambda a, x: a ** 2 % 1000 + x["i"], 1),
    "str-method-on-acc": (lambda a, x: a.upper() if x["k"] else a, "a"),
    "math-on-acc": (lambda a, x: math.floor(a * 1.5) + x["i"], 1),
    "helper-call": (lambda a, x: a + _half_or_one(x["i"]) if x["k"] >= 0
                    else a, 0),
}


def _half_or_one(i):
    return i / 2 if i % 2 == 0 else 1


@pytest.mark.parametrize("name", sorted(NOT_COMPILABLE))
def test_not_compilable_folds_run_on_the_interpreter(name):
    fold, initial = NOT_COMPILABLE[name]
    rows = _rows(200)
    ctx = _port()
    op = ctx.parallelize(rows, columns=COLS).aggregate(
        lambda a, b: a, fold, initial)._op
    assert A.ScanFold.try_build(op) is None
    for m in _both(rows, fold, initial):
        assert m["device_rows"] == 0 and m["scan_rows"] == 0
        assert m["host_folded_rows"] == len(rows)


def test_chaining_across_partitions():
    """Each partition folds from the running values; the initial value
    seeds each key once (the reference's chaining case, with a decay that
    makes any reseeding show)."""
    rows = [(i % 3, i) for i in range(3000)]
    ms = _both(rows, lambda a, x: a * 0.5 + x["v"] if x["v"] % 2 == 0
               else a, 100, cols=["k", "v"])
    assert ms[1]["device_rows"] == len(rows)
    assert ms[1]["host_folded_rows"] == 0


def test_group_order_ghost_groups_and_zero_division():
    """Keys enter in the order of their first folded row: key 'b''s first
    row raises, so 'c' comes first. A key whose every row raises emits no
    row. ZeroDivisionError rows are counted, named after the aggregate
    operator, and leave the accumulator as it was."""
    rows = [("b", 0), ("c", 1), ("b", 2), ("g", 0), ("c", 0), ("g", 0)] * 40
    fold = lambda a, x: a * 3 % 101 + 10 // x["v"]  # noqa: E731
    ctx = _port()
    ds = ctx.parallelize(rows, columns=["k", "v"]).aggregateByKey(
        lambda a, b: a, fold, 1, ["k"])
    got = ds.collect()
    want, excs = _loop([Row(list(r), ["k", "v"]) for r in rows], fold, 1,
                       lambda x: (x["k"],))
    assert got == want and [r[0] for r in got] == ["c", "b"]
    assert ds.exception_counts() == excs == {"ZeroDivisionError": 160}
    assert {r.op_id for r in ds._last_exceptions} == {ds._op.id}
    m = ctx.metrics.stages[-1]
    assert m["device_rows"] == len(rows) and m["host_folded_rows"] == 0


def test_int64_overflow_mid_fold_gives_a_big_int():
    """A product past int64 stops its segment: the interpreter finishes
    it with Python's int, and later partitions, whose running value no
    longer fits, fold on the interpreter too."""
    rows = [(i % 2, i + 1) for i in range(400)]
    ms = _both(rows, lambda a, x: a * 3 + x["v"] if x["v"] < 390 else a,
               1, cols=["k", "v"])
    for m in ms:
        assert m["scan_stopped_segments"] >= 1 and m["host_folded_rows"] > 0
        assert m["device_rows"] > 0
    ctx = _port()
    (got,) = ctx.parallelize(rows, columns=["k", "v"]).aggregate(
        lambda a, b: a, lambda a, x: a * 3 + x["v"], 1).collect()
    assert type(got) is int and got > 2 ** 63


def test_int_initial_with_float_rows_keeps_python_types():
    """An int leaf becomes a float at the first row that makes it one; a
    key that folds no such row keeps an int (the reference widens every
    key's leaf to float)."""
    rows = [(k, float(i) if k == 1 and i > 50 else i, i)
            for i in range(300) for k in (0, 1, 2)]
    ms = _both(rows, lambda a, x: (a[0] + x["v"], a[1] + 1,
                                   max(a[2], x["v"])) if x["i"] >= 0 else a,
               (0, 0, -1), cols=["k", "v", "i"])
    assert ms[1]["device_rows"] > 0
    ctx = _port()
    got = ctx.parallelize(rows, columns=["k", "v", "i"]).aggregateByKey(
        lambda a, b: a, lambda a, x: a + x["v"] if x["i"] > 0 else a, 0,
        ["k"]).collect()
    assert [type(r[1]) for r in got] == [int, float, int]


def test_c10_boxed_rows_fold_in_their_place():
    """ROADMAP C10: a boxed row (1.5 among ints) folds where it stands.
    tuplex_tpu folds it after the rest of its partition and differs from
    the loop on an order-dependent fold; the port equals the loop."""
    fold = lambda a, x: a * 3 % 1000003 + x  # noqa: E731
    data = list(range(40))
    data[20] = 1.5
    want, _ = _loop(data, fold, 7)
    assert want == [511957.5]
    ctx = _port()
    assert ctx.parallelize(data).aggregate(lambda a, b: a + b, fold,
                                           7).collect() == want
    m = ctx.metrics
    assert m.scanStoppedSegments() == 1 and m.scanRows() == 39
    assert m.deviceRows() == 20 and m.hostFoldedRows() == 20
    ref = tuplex_tpu.Context(CONF)
    assert ref.parallelize(data).aggregate(lambda a, b: a + b, fold,
                                           7).collect() == [671523.5]

    rows = [(i % 3, i) for i in range(60)]
    rows[31] = (1, 2.5)
    kfold = lambda a, x: a * 3 % 1000003 + x["v"]  # noqa: E731
    want, _ = _loop([Row(list(r), ["k", "v"]) for r in rows], kfold, 7,
                    lambda x: (x["k"],))
    got = _port().parallelize(rows, columns=["k", "v"]).aggregateByKey(
        lambda a, b: a + b, kfold, 7, ["k"]).collect()
    assert got == want and dict((r[0], r[1]) for r in got)[1] == 324016.5
    ref_got = tuplex_tpu.Context(CONF).parallelize(
        rows, columns=["k", "v"]).aggregateByKey(
        lambda a, b: a + b, kfold, 7, ["k"]).collect()
    assert dict(ref_got)[1] == 973495.5


def _close(a, b) -> bool:
    if isinstance(a, float) or isinstance(b, float):
        return math.isclose(a, b, rel_tol=1e-12, abs_tol=0.0)
    return a == b


# the reference's scan-fold cases, tests/test_agg_join.py:463-540
REFERENCE_CASES = {
    "by-key-conditional": (
        [(i % 7, float(i), i % 3 == 0) for i in range(4000)],
        ["k", "v", "flag"],
        lambda a, x: a + x["v"] if x["flag"] else a, 0.0),
    "cross-partition-chaining": (
        [(i % 3, i) for i in range(3000)], ["k", "v"],
        lambda a, x: a + x["v"] if x["v"] % 2 == 0 else a, 100),
    "no-ghost-groups": (
        [(1, 2), (1, 4), (2, 0), (2, 0)], ["k", "v"],
        lambda a, x: a + 10 // x["v"] if x["v"] != 99 else a, 0),
}


@pytest.mark.parametrize("name", sorted(REFERENCE_CASES))
def test_reference_scan_fold_cases(name):
    rows, cols, fold, initial = REFERENCE_CASES[name]
    ctx = _port()
    ds = ctx.parallelize(rows, columns=cols).aggregateByKey(
        lambda a, b: a + b, fold, initial, ["k"])
    got = ds.collect()
    want, excs = _loop([Row(list(r), cols) for r in rows], fold, initial,
                       lambda x: (x["k"],))
    assert repr(got) == repr(want) and ds.exception_counts() == excs
    assert ctx.metrics.stages[-1]["device_rows"] == len(rows)
    ref = tuplex_tpu.Context(CONF).parallelize(rows, columns=cols) \
        .aggregateByKey(lambda a, b: a + b, fold, initial, ["k"])
    ref_got = dict((r[0], r[1]) for r in ref.collect())
    assert sorted(ref_got) == sorted(r[0] for r in got)
    assert all(_close(r[1], ref_got[r[0]]) and
               type(r[1]) is type(ref_got[r[0]]) for r in got)
    assert ref.exception_counts() == excs


def test_reference_float_drift_case():
    """The reference's case where a boxed 3.5 turns key 0's accumulator
    into a float: the port folds it in place and keeps key 1 an int."""
    rows = [(0, 3.5)] + [(0, i) for i in range(2000)] + \
        [(1, i) for i in range(2000)]
    _, ms = _both(rows, lambda a, x: a + x["v"] * 2 if x["v"] > -1 else a,
                  0, cols=["k", "v"])
    got = _port().parallelize(rows, columns=["k", "v"]).aggregateByKey(
        lambda a, b: a + b, lambda a, x: a + x["v"] * 2 if x["v"] > -1
        else a, 0, ["k"]).collect()
    assert got == [(0, 7.0 + 2 * sum(range(2000))), (1, 2 * sum(range(2000)))]
    assert [type(r[1]) for r in got] == [float, int]
    assert ms["scan_stopped_segments"] == 1


@pytest.mark.parametrize("job", ["g1", "g2", "g3"])
@pytest.mark.parametrize("dirty", [False, True], ids=["clean", "dirty"])
def test_lineitem_fold_jobs(tmp_path, job, dirty):
    """The chip phase's three jobs on small files: equal to the loop; on
    the clean file every row folds on the device, no segment stops and no
    lazy leaf of the handed-off input is fetched whole."""
    path = str(tmp_path / "li.csv")
    (tpch.generate_dirty_csv if dirty else tpch.generate_csv)(path, 2000,
                                                              seed=7)
    ctx = tuplex_tpu_torch.Context(device="cpu")
    ds = getattr(tpch, "fold_" + job)(ctx.csv(path))
    got = ds.collect()
    want, excs = tpch.fold_python(tpch.read_lineitem_dicts(path), job)
    assert repr(got) == repr(want) and ds.exception_counts() == excs
    m = ctx.metrics
    agg = m.stages[-1]
    assert m.stages[0]["handoff_parts"] >= 1 and agg["forced_leaves"] == 0
    assert agg["scan_rows"] > 0 and m.interpreterRows() == 0
    if not dirty:
        assert agg["host_folded_rows"] == 0 and not excs
        assert agg["scan_stopped_segments"] == 0
        assert agg["device_rows"] == 2000
    elif job == "g1":
        assert agg["scan_stopped_segments"] == 6 and excs


def test_program_and_deferred_codes():
    """The decay's program, and a term's error code counting only where
    the program reaches it: `x // w` raises on rows whose test passes,
    and at a row local's assignment on every row."""
    ctx = _port()
    op = ctx.parallelize([(1, 2.0)], columns=["k", "v"]).aggregate(
        lambda a, b: a, decay, 0.0)._op
    scan = A.ScanFold.try_build(op)
    assert [q[0] for q in scan.prog.code.tolist()] == [
        SF.ACC, SF.CONST, SF.MUL, SF.TERM, SF.ADD, SF.OUT]
    assert len(scan.prog.terms) == 1
    op = ctx.parallelize([(1, 2.0, 3.0)], columns=["k", "v", "w"]) \
        .aggregate(lambda a, b: a, FOLDS["chained-compare-row"][0], 0.0)._op
    assert [ast.unparse(t.expr) for t in
            A.ScanFold.try_build(op).prog.terms] == [
        "-10.0 <= x['v'] < x['w']", "x['v']"]

    def at_assignment(a, x):
        y = x["i"] // x["j"]
        if a > 5:
            return a + y
        return a + 1

    rows = _rows(300)
    for fold in (at_assignment,
                 lambda a, x: a + x["i"] // x["j"] if a > 5 else a + 1):
        _both(rows, fold, 0)


def test_plain_version_statuses_and_stop_rule():
    """seg_fold_plain on hand-built terms: rows fold in order per
    segment, an exact class is recorded and skipped, an internal code and
    the limit stop a segment, and every later row of it is the host's."""
    code = torch.tensor([[SF.ACC, 0, 0, 0], [SF.TERM, 1, 0, 0],
                         [SF.ADD, 2, 0, 1], [SF.OUT, 0, 2, 0]],
                        dtype=torch.int32)

    class Prog:
        pass

    prog = Prog()
    prog.code, prog.consts = code, torch.zeros((0, 2), dtype=torch.int64)
    vals = torch.arange(10, dtype=torch.int64)[None, :] * 10
    metas = torch.full((1, 10), SF.TAG_INT << 8, dtype=torch.int32)
    metas[0, 3] |= SF.ZERODIVISION
    metas[0, 6] |= SF.INTERNAL_CLASS
    codes = torch.tensor([0, 1, 0, 0, 1, 0, 1, 1, 0, -1])
    order, offsets = SF.segment_layout(codes, 2)
    assert order.tolist() == [0, 2, 3, 5, 8, 1, 4, 6, 7]
    limits = torch.tensor([5, 10])
    seeds = torch.tensor([[1], [2]])
    res = SF.seg_fold_plain(prog, vals, metas, order, offsets, limits,
                            seeds, torch.full((2, 1), SF.TAG_INT,
                                              dtype=torch.int8))
    assert res.acc.tolist() == [[1 + 0 + 20], [2 + 10 + 40]]
    assert res.first.tolist() == [0, 1] and res.count.tolist() == [2, 2]
    assert res.stop.tolist() == [5, 6]
    assert res.status.tolist() == [1, 1, 1, SF.ST_EXC + SF.ZERODIVISION, 1,
                                   2, 2, 2, 2, 0]
