"""The interpreter's source tier (tuplex_tpu_torch/compiler/pypipeline.py):
one generated Python function per stage, `_tpx_pipeline`, with the row's
fields as locals.

Oracles: the port's closure tier on the same operators and rows (the
source tier must give the same statuses, rows and exception records),
and the reference package's source tier
(`tuplex_tpu.compiler.pypipeline._try_build_source_pipeline`) on the same
UDFs and rows, normalized as its own tests normalize (tests/
test_pypipeline.py `norm`: the row data of an exception, not its
traceback; the port's "ignored" status is the reference's "drop"). The
pipelines of Z1's and flights' stages are held to the closure tier on
every row that reaches the interpreter. Tolerance: exact.
"""

import csv
import functools

import jax  # noqa: F401  (configured for the CPU by conftest)
import numpy as np
import pytest
import torch

import tuplex_tpu
import tuplex_tpu_torch
from tuplex_tpu.compiler import pypipeline as RP
from tuplex_tpu.core.row import Row as RRow
from tuplex_tpu.plan import logical as RL
from tuplex_tpu_torch.compiler import pypipeline as P
from tuplex_tpu_torch.core.row import Row
from tuplex_tpu_torch.exec.local import run_plan, source_partitions
from tuplex_tpu_torch.models import flights, zillow
from tuplex_tpu_torch.plan import logical as L
from tuplex_tpu_torch.plan import physical
from tuplex_tpu_torch.runtime import columns as C


@pytest.fixture(autouse=True)
def _private_aot_store(tmp_path, monkeypatch):
    """The reference package keeps compiled stages in an on-disk store
    that every process of one HOME shares; this file's reference runs use
    a store of their own."""
    monkeypatch.setenv("TUPLEX_AOT_CACHE", str(tmp_path / "aot"))


def _negate(f):
    @functools.wraps(f)
    def wrapped(*a, **kw):
        return -f(*a, **kw)
    return wrapped


@_negate
def _decorated(x):
    return x["a"] + 1


def _shadowing(x):
    g = lambda x: x["a"] * 2   # noqa: E731 - the inner x is not the row
    return g({"a": 50})


# Each case: (build(L, src) -> ops, input column names, input rows, the
# expected normalized output of the source tier or None). `src` makes the
# parallelize operator the ops read from.
def _withcolumn_filter(L, src):
    wc = L.WithColumnOperator(src([(1, 2)], ["a", "b"]), "s",
                              lambda x: x["a"] + x["b"])
    return [wc, L.FilterOperator(wc, lambda x: x["s"] > 3)]


def _withcolumn_replace(L, src):
    return [L.WithColumnOperator(src([(1, 2)], ["a", "b"]), "a",
                                 lambda x: x["a"] * 10)]


def _exception_record(L, src):
    return [L.WithColumnOperator(src([(1, 2)], ["a", "b"]), "q",
                                 lambda x: x["a"] // x["b"])]


def _resolver(L, src):
    wc = L.WithColumnOperator(src([(1, 2)], ["a", "b"]), "q",
                              lambda x: x["a"] // x["b"])
    return [wc, L.ResolveOperator(wc, ZeroDivisionError, lambda x: -1)]


def _ignore(L, src):
    wc = L.WithColumnOperator(src([(1, 2)], ["a", "b"]), "q",
                              lambda x: x["a"] // x["b"])
    return [wc, L.IgnoreOperator(wc, ZeroDivisionError)]


def _filter_resolver(L, src):
    fl = L.FilterOperator(src([(1,)], ["a"]), lambda x: 10 // x["a"] > 3)
    return [fl, L.ResolveOperator(fl, ZeroDivisionError, lambda x: True)]


def _mapcolumn_select(L, src):
    mc = L.MapColumnOperator(src([(1, "x")], ["n", "s"]), "n",
                             lambda v: v * 3)
    return [mc, L.SelectColumnsOperator(mc, ["s", "n"])]


def _terminal_map(L, src):
    return [L.MapOperator(src([(1, 2)], ["a", "b"]),
                          lambda x: x["a"] + x["b"])]


def _row_escape(L, src):
    # the row goes whole to a helper: not specializable, so the boxed-Row
    # calling convention runs inside the generated function
    return [L.WithColumnOperator(src([(1, 2)], ["a", "b"]), "d",
                                 lambda x: dict(zip(x.columns,
                                                    x.values))["a"])]


def _multiparam(L, src):
    return [L.FilterOperator(src([(1, 2)], ["a", "b"]),
                             lambda a, b: a < b)]


def _nested_shadowing(L, src):
    return [L.WithColumnOperator(src([(1, 2)], ["a", "b"]), "d",
                                 _shadowing)]


def _select_duplicate(L, src):
    sel = L.SelectColumnsOperator(src([(3, 4)], ["a", "b"]), ["a", "a"])
    return [sel, L.MapColumnOperator(sel, "a", lambda v: v * 10)]


def _decorated_udf(L, src):
    return [L.WithColumnOperator(src([(1, 2)], ["a", "b"]), "d",
                                 _decorated)]


AB = ("a", "b")
CASES = {
    "withcolumn_filter": (_withcolumn_filter, AB,
                          [(1, 2), (2, 5), (0, 0), (10, -7)],
                          [("drop", None), ("ok", (2, 5, 7), AB + ("s",)),
                           ("drop", None), ("drop", None)]),
    "withcolumn_replace_existing": (_withcolumn_replace, AB,
                                    [(3, 4), (5, 6)],
                                    [("ok", (30, 4), AB),
                                     ("ok", (50, 6), AB)]),
    "exception_record": (_exception_record, AB, [(4, 2), (1, 0)], None),
    "resolver": (_resolver, AB, [(4, 2), (1, 0)],
                 [("ok", (4, 2, 2), AB + ("q",)),
                  ("ok", (1, 0, -1), AB + ("q",))]),
    "ignore": (_ignore, AB, [(4, 2), (1, 0)],
               [("ok", (4, 2, 2), AB + ("q",)), ("ignored", None)]),
    "filter_resolver_verdict": (_filter_resolver, ("a",),
                                [(1,), (0,), (9,)], None),
    "mapcolumn_and_select": (_mapcolumn_select, ("n", "s"),
                             [(2, "a"), (5, "b")],
                             [("ok", ("a", 6), ("s", "n")),
                              ("ok", ("b", 15), ("s", "n"))]),
    "terminal_map": (_terminal_map, AB, [(1, 2), (5, 6)],
                     [("ok", (3,), None), ("ok", (11,), None)]),
    "row_escape_uses_generic_caller": (_row_escape, AB, [(7, 8)],
                                       [("ok", (7, 8, 7), AB + ("d",))]),
    "multiparam_udf_spread": (_multiparam, AB, [(1, 2), (5, 2)], None),
    "nested_lambda_shadowing": (_nested_shadowing, AB, [(1, 2)],
                                [("ok", (1, 2, 100), AB + ("d",))]),
    "select_duplicate_then_mapcolumn": (_select_duplicate, AB, [(3, 4)],
                                        [("ok", (30, 3), ("a", "a"))]),
    "decorated_udf_not_specialized": (_decorated_udf, AB, [(1, 2)],
                                      [("ok", (1, 2, -2), AB + ("d",))]),
}


def _norm(results, ignored="ignored", ops=None):
    """Statuses, row data and exception records; with `ops`, an exception's
    operator as its position there (each package numbers its operators
    with its own counter)."""
    out = []
    for status, payload in results:
        if status == "ok":
            out.append(("ok", tuple(payload.values), payload.columns))
        elif status == "exc":
            op = payload[0] if ops is None else \
                [o.id for o in ops].index(payload[0])
            out.append(("exc", (op,) + tuple(payload[1:3])))
        else:
            out.append(("drop" if status == "ignored" else status, None)
                       if ignored == "drop" else (status, None))
    return out


def _ops(which, build):
    if which == "port":
        ctx = tuplex_tpu_torch.Context(device="cpu")
        return build(L, lambda data, cols: ctx.parallelize(
            data, columns=cols)._op)
    ctx = tuplex_tpu.Context({"tuplex.partitionSize": "256KB",
                              "tuplex.sample.maxDetectionRows": "64"})
    return build(RL, lambda data, cols: ctx.parallelize(
        data, columns=cols)._op)


def _run(pipe, row_cls, rows, names):
    return [pipe(row_cls(vals, names)) for vals in rows]


@pytest.mark.parametrize("case", sorted(CASES))
def test_source_tier_matches_closure_and_reference(case):
    build, names, rows, want = CASES[case]
    ops = _ops("port", build)
    closure = P._build_closure_pipeline(ops)
    source = P._try_build_source_pipeline(ops, names, closure)
    assert source is not None and source.__name__ == "_tpx_pipeline"
    got = _norm(_run(source, Row, rows, names))
    assert got == _norm(_run(closure, Row, rows, names))
    if want is not None:
        assert got == want
    rops = _ops("ref", build)
    rsource = RP._try_build_source_pipeline(
        rops, names, RP._build_closure_pipeline(rops))
    assert rsource is not None
    assert _norm(_run(source, Row, rows, names), "drop", ops) == \
        _norm(_run(rsource, RRow, rows, names), ops=rops)


def test_midchain_map_takes_the_closure_tier():
    def build(L, src):
        mp = L.MapOperator(src([(1, 2)], ["a", "b"]),
                           lambda x: (x["a"], x["b"]))
        return [mp, L.FilterOperator(mp, lambda x: x[0] > 0)]

    ops = _ops("port", build)
    closure = P._build_closure_pipeline(ops)
    assert P._try_build_source_pipeline(ops, AB, closure) is None
    assert P.build_python_pipeline(ops, AB).__name__ == "pipeline"
    rops = _ops("ref", build)
    assert RP._try_build_source_pipeline(
        rops, AB, RP._build_closure_pipeline(rops)) is None


def test_arity_mismatch_delegates_to_closure():
    def build(L, src):
        return [L.WithColumnOperator(src([(1, 2)], ["a", "b"]), "s",
                                     lambda x: x["a"] + x["b"])]

    ops = _ops("port", build)
    closure = P._build_closure_pipeline(ops)
    source = P._try_build_source_pipeline(ops, AB, closure)
    bad = ((1, 2, 3), ("a", "b", "c"))
    got = _norm([source(Row(*bad))])
    assert got == _norm([closure(Row(*bad))])
    rops = _ops("ref", build)
    rsource = RP._try_build_source_pipeline(
        rops, AB, RP._build_closure_pipeline(rops))
    assert got == _norm([rsource(RRow(*bad))])


def _interpreter_rows(stage, parts):
    """(row, closure result, pipeline) for every row of `parts` that the
    stage's fast path sends to the interpreter: boxed rows and rows with
    an error code."""
    out = []
    for part in parts:
        batch = C.stage_partition(part, torch.device("cpu"))
        outs = stage.build_device_fn(part.schema)(batch.arrays)
        n = part.num_rows
        err = outs["#err"][:n].numpy()
        idx = sorted(set(np.nonzero(err != 0)[0].tolist())
                     | set(part.fallback))
        pipe = stage.python_pipeline(part.user_columns)
        out += [(pipe, row) for row in C.decode_rows(part, idx)]
    return out


def _check_stage(stage, parts) -> int:
    rows = _interpreter_rows(stage, parts)
    closure = P._build_closure_pipeline(stage.ops)
    for pipe, row in rows:
        assert pipe.__name__ == "_tpx_pipeline"
        assert _norm([pipe(row)]) == _norm([closure(row)])
    return len(rows)


def test_z1_stage_runs_the_source_tier(tmp_path):
    path = str(tmp_path / "z.csv")
    zillow.generate_csv(path, 400, seed=7)
    ctx = tuplex_tpu_torch.Context(device="cpu")
    ds = zillow.build_pipeline(ctx.csv(path))
    (stage,) = physical.plan_stages(ds._op)
    assert _check_stage(stage, source_partitions(ctx, stage.source)) == 17


def test_flights_stages_run_the_source_tier(tmp_path):
    p = flights.generate_perf_csv(str(tmp_path / "perf.csv"), 200, seed=13)
    pc = flights.generate_carrier_csv(str(tmp_path / "carrier.csv"))
    pa = flights.generate_airport_db(str(tmp_path / "airports.txt"))
    ctx = tuplex_tpu_torch.Context(device="cpu")
    ds = flights.build_pipeline(ctx, p, pc, pa)
    stages = physical.plan_stages(ds._op)
    first, last = stages[0], stages[-1]
    assert any(isinstance(op, L.IgnoreOperator) for op in first.ops)
    # the first stage's decode violations, and the boxed rows the joins
    # hand the last stage
    assert _check_stage(first, source_partitions(ctx, first.source)) == 10
    parts, _ = run_plan(ctx, last.source)
    assert _check_stage(last, parts) > 0


# -- C11: a map that returns its row ------------------------------------------

def _returned_row_csv(path) -> list:
    """A CSV file whose last three records take the interpreter (a short
    record, a long one and one with a quoted newline), and the loop's rows
    for it: cells decoded as the sniffed types (int, str, float), a missing
    cell None, cells past the header's three dropped."""
    lines = [f"{i},x{i},{i}.5" for i in range(40)]
    lines += ["2,y", "2,y,3.5,9", '1,"x\ny",2.5']
    with open(path, "w") as fp:
        fp.write("a,b,c\n" + "\n".join(lines) + "\n")
    with open(path, newline="") as fp:
        recs = list(csv.reader(fp))[1:]
    dec = (int, str, float)
    return [tuple(d(r[i]) if i < len(r) and r[i] != "" else None
                  for i, d in enumerate(dec)) for r in recs]


def _returned_row_cases(tmp_path):
    data = [(1, "a"), ("z", "b")] + [(i, "c") for i in range(30)]
    path = str(tmp_path / "rows.csv")
    want = _returned_row_csv(path)
    return {"boxed": (lambda c: c.parallelize(data, columns=["a", "b"]),
                      data),
            "csv": (lambda c: c.csv(path), want)}


@pytest.mark.parametrize("udf,loop_fn", [
    (lambda x: x, tuple),
    (lambda x: x[1], lambda t: t[1]),
    (lambda x: len(x), len),
], ids=["identity", "second-field", "len"])
@pytest.mark.parametrize("case", ["boxed", "csv"])
def test_c11_returned_row_collects_the_loops_values(tmp_path, case, udf,
                                                    loop_fn):
    """`.map(lambda x: x)` returns the row itself: boxed and CSV rows that
    take the interpreter (short, long and quoted-newline records among
    them) collect the loop's tuples, and a map after it reads the row's
    fields, as a loop over the same rows does."""
    make, rows = _returned_row_cases(tmp_path)[case]
    ctx = tuplex_tpu_torch.Context(device="cpu")
    got = make(ctx).map(lambda x: x).map(udf).collect()
    assert got == [loop_fn(r) for r in rows]
    assert ctx.metrics.interpreterRows() >= (3 if case == "csv" else 1)
    assert not any(isinstance(v, Row) for v in got)


def test_c11_source_tier_keeps_a_returned_rows_fields():
    """The generated pipeline (and the closure tier) over a terminal map
    that returns its row: the result keeps the row's values and names."""
    def build(L, src):
        return [L.MapOperator(src([(1, "a")], ["a", "b"]), lambda x: x)]

    ops = _ops("port", build)
    closure = P._build_closure_pipeline(ops)
    source = P._try_build_source_pipeline(ops, AB, closure)
    assert source is not None and source.__name__ == "_tpx_pipeline"
    for pipe in (source, closure):
        status, out = pipe(Row(("z", "b"), AB))
        assert status == "ok" and out.values == ("z", "b")
        assert out.columns == AB and out.unwrap() == ("z", "b")
