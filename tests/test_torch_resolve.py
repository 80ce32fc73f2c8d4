"""The resolve tiers between the fast path and the interpreter
(tuplex_tpu_torch/exec/local.py): the compiled general-case tier over the
general-case CSV decode, the exact-exception exit, and the plan that picks
them (`TransformStage.resolve_plan`).

Oracles, stated per test: a plain CPython loop over the same file (rows,
order, values, exception classes), CPython itself for the class a UDF
raises on None, and the port's own tier counters for which tier finished a
row. The reference package's tier counts are no oracle: its general tier
retires nothing on these inputs (ROADMAP C9). Tolerance: exact; Q6's sum
within 1e-9 relative of the loop's.
"""

import csv
import string

import pytest
import torch

import tuplex_tpu_torch
from tuplex_tpu_torch.core.errors import exception_name
from tuplex_tpu_torch.models import flights, tpch, widened, zillow
from tuplex_tpu_torch.plan import physical
from tuplex_tpu_torch.runtime import columns as C


def _port():
    return tuplex_tpu_torch.Context(device="cpu")


def _tiers(m) -> tuple:
    return m.interpreterRows(), m.generalRows(), m.exactExitRows()


# --- the emitter's code for a None receiver --------------------------------

NONE_UDFS = [
    ("upper", lambda s: s.upper()),
    ("find", lambda s: s.find("b")),
    ("strip", lambda s: s.strip()),
    ("capwords", lambda s: string.capwords(s)),
    ("concat", lambda s: s + "x"),
    ("len", lambda s: len(s)),
    ("slice", lambda s: s[1:]),
    ("float", lambda s: float(s)),
]


@pytest.mark.parametrize("name,udf", NONE_UDFS, ids=[n for n, _ in NONE_UDFS])
def test_none_receiver_codes_cpython_class(name, udf):
    """Oracle: CPython's class for the UDF on None. A str method on None
    raises AttributeError (the lattice codes ATTRIBUTEERROR), any other use
    of None TypeError."""
    with pytest.raises(Exception) as info:
        udf(None)
    data = ["1.5", None, "2.0"]
    ds = _port().parallelize(data).map(udf)
    stage = physical.plan_stages(ds._op)[0]
    part = C.build_partition(data, stage.input_schema)
    outs = stage.build_device_fn()(
        C.stage_partition(part, torch.device("cpu")).arrays)
    code = int(outs["#err"][1])
    assert exception_name(code & 0xFF) == type(info.value).__name__
    assert code >> 8 == ds._op.id
    assert int(outs["#err"][0]) == 0


# --- the widened-column CSV (models/widened.py) ------------------------------

def test_widened_column_retired_by_the_general_tier(tmp_path):
    """Oracles: the loop (rows), the tier counters (every row with a filled
    c cell violates the null speculation and the general tier finishes it,
    none interprets)."""
    path = str(tmp_path / "w.csv")
    filled = widened.generate_csv(path, 4000)
    ctx = _port()
    ds = widened.build_pipeline(ctx.csv(path))
    stage = physical.plan_stages(ds._op)[0]
    dec = stage.ops[0]
    assert str(dec.declared.types[2]) == "null"
    assert str(dec.general.types[2]) == "Option[str]"
    assert ds.collect() == widened.run_reference_python(path)
    assert ds.exception_counts() == {}
    m = ctx.metrics
    assert m.deviceErrorRows() == m.generalRows() == filled > 1000
    assert m.interpreterRows() == 0 == m.exactExitRows()
    assert m.resolveTierMix() == {"exact_exit": 0.0, "general": 1.0,
                                  "interpreter": 0.0}
    assert m.generalPathWallTime() > 0


def test_general_codes_reach_the_ignore(tmp_path):
    """A stage with ignore(TypeError) takes no exact exit: rows the
    general run codes TypeError (a str cell against an int) go on to the
    interpreter, whose ignore drops them. Oracle: the loop."""
    path = str(tmp_path / "w.csv")
    filled = widened.generate_csv(path, 4000)
    ctx = _port()
    ds = ctx.csv(path).withColumn(
        "d", lambda x: x["c"] < 5 if x["c"] else False).ignore(TypeError)
    got = ds.collect()
    with open(path, newline="") as fp:
        r = csv.reader(fp)
        next(r)
        want = [(int(a), b, None, False) for a, b, c in r if not c]
    assert got == want and ds.exception_counts() == {}
    m = ctx.metrics
    assert m.ignoredRows() == m.interpreterRows() == filled
    assert m.generalRows() == 0 == m.exactExitRows()


def test_general_tier_the_emitter_rejects_is_counted(tmp_path):
    """str + int does not compile: the general run is refused, and its
    rows interpret, counted. Oracle: the loop's TypeError per filled
    cell."""
    path = str(tmp_path / "w.csv")
    filled = widened.generate_csv(path, 4000)
    ctx = _port()
    ds = ctx.csv(path).withColumn(
        "d", lambda x: x["c"] + x["a"] if x["c"] else 0)
    got = ds.collect()
    assert len(got) == 4000 - filled
    assert ds.exception_counts() == {"TypeError": filled}
    m = ctx.metrics
    assert m.interpreterRows() == filled == \
        m.stages[0]["general_not_compilable_rows"]
    assert m.generalRows() == 0 == m.exactExitRows()


# --- Zillow Z1: the exact exit ---------------------------------------------

def test_z1_exact_exit_counts_match_cpython(tmp_path):
    """Oracles: CPython's first exception per row
    (`zillow.exception_counts_python`); the loop's rows."""
    path = str(tmp_path / "z.csv")
    zillow.generate_csv(path, 400, seed=7)
    ctx = _port()
    ds = zillow.build_pipeline(ctx.csv(path))
    assert ds.collect() == zillow.run_reference_python(path)
    counts = ds.exception_counts()
    assert counts == zillow.exception_counts_python(path) == \
        {"ValueError": 9, "TypeError": 1, "AttributeError": 6}
    m = ctx.metrics
    assert m.exactExitRows() > 0
    assert sum(_tiers(m)) == m.deviceErrorRows()
    assert physical.plan_stages(ds._op)[0].resolve_plan().tier == \
        "general+interpreter"


# --- flights: the first stage's decode violations ---------------------------

def test_flights_decode_violations_retired_by_the_general_tier(tmp_path):
    """Oracles: the loop (rows in order, values, exceptions); the first
    stage's tier counters against the file: a row with a filled cell in a
    column the sample typed null violates the decode, and the general tier
    finishes it."""
    p = flights.generate_perf_csv(str(tmp_path / "perf.csv"), 200, seed=13)
    pc = flights.generate_carrier_csv(str(tmp_path / "carrier.csv"))
    pa = flights.generate_airport_db(str(tmp_path / "airports.txt"))
    ctx = _port()
    ds = flights.build_pipeline(ctx, p, pc, pa)
    got = ds.collect()
    excs: dict = {}
    assert got == flights.run_reference_python(p, pc, pa, exceptions=excs)
    assert ds.exception_counts() == excs
    dec = physical.plan_stages(ds._op)[0].ops[0]
    null_cols = [c for c, t in zip(dec.declared.columns,
                                   dec.declared.types) if str(t) == "null"]
    assert len(null_cols) == 3
    with open(p, newline="") as fp:
        violations = sum(any(row[c] for c in null_cols)
                         for row in csv.DictReader(fp))
    first = ctx.metrics.stages[0]
    assert first["general_rows"] == first["device_error_rows"] == \
        violations > 0
    assert first["interpreter_rows"] == 0


# --- TPC-H's dirty file -----------------------------------------------------

def test_tpch_dirty_counts_match_the_loop(tmp_path):
    """'N/A' and empty cells: an empty cell decodes None under the general
    types, an 'N/A' cell is re-run with its column as str, as the
    interpreter sees it. Oracles: the counting loops over the same cells
    (rows, sums, exception classes); the tier counters (no row
    interprets)."""
    path = tpch.generate_dirty_csv(str(tmp_path / "d.csv"), 2000, seed=7)
    rows = tpch.read_lineitem_dicts(path)
    want6, exc6 = tpch.q6_python_counting(rows)
    ctx = _port()
    ds = tpch.q6(ctx.csv(path))
    (got6,) = ds.collect()
    assert abs(got6 - want6) <= 1e-9 * abs(want6)
    assert ds.exception_counts() == exc6 and sum(exc6.values()) > 0
    m = ctx.metrics
    assert m.interpreterRows() == 0 < m.generalRows()
    assert m.exactExitRows() == sum(exc6.values())
    assert sum(_tiers(m)) == m.deviceErrorRows()
    want1, exc1 = tpch.q1_python_counting(rows)
    ctx = _port()
    ds = tpch.q1(ctx.csv(path))
    got1 = {r[:2]: r[2:] for r in ds.collect()}
    assert set(got1) == set(want1)
    assert all(got1[k][3] == want1[k][3] for k in want1)
    assert ds.exception_counts() == exc1 and sum(exc1.values()) > 50
    m = ctx.metrics
    assert m.interpreterRows() == 0
    assert m.generalRows() == m.deviceErrorRows() > 0


# --- the plan's tiers ------------------------------------------------------

def _option_filter(ctx, ignore: bool):
    ds = ctx.parallelize([(1, None), (2, 3), (5, 6)], columns=["a", "v"]) \
        .filter(lambda x: x["v"] > 3)
    return ds.ignore(TypeError) if ignore else ds


@pytest.mark.parametrize("ignore", [False, True], ids=["plain", "ignore"])
def test_resolve_plan_tiers(ignore):
    """An Option column read by a filter: TypeError is its only possible
    code. Without a resolver the plan's tier is the exact exit and the None
    row takes it; with ignore(TypeError) the row must interpret. Oracles:
    the plan, CPython's TypeError on `None > 3`, the tier counters."""
    ctx = _port()
    ds = _option_filter(ctx, ignore)
    stage = physical.plan_stages(ds._op)[0]
    plan = stage.resolve_plan()
    assert stage.has_resolvers == ignore
    assert not plan.use_general and plan.codes[0] == 3
    assert plan.tier == ("interpreter" if ignore else "exact-exit")
    assert ds.collect() == [(5, 6)]
    m = ctx.metrics
    if ignore:
        assert ds.exception_counts() == {} and m.ignoredRows() == 1
        assert _tiers(m) == (1, 0, 0)
    else:
        assert ds.exception_counts() == {"TypeError": 1}
        assert _tiers(m) == (0, 0, 1)


def test_csv_stage_plans_the_general_tier(tmp_path):
    path = str(tmp_path / "w.csv")
    widened.generate_csv(path, 1200)
    ds = widened.build_pipeline(_port().csv(path))
    stage = physical.plan_stages(ds._op)[0]
    plan = stage.resolve_plan()
    assert plan.use_general and plan.tier == "general+interpreter"
    assert {100, 101, 102} <= set(plan.codes)
