"""The device handoff between stages (tuplex_tpu_torch/exec/local.py
`Handoff`, runtime/columns.py `DeviceView` and `LazyLeaves`), on the CPU
device, where it runs the same code as on the card.

Oracles, named in each test:
  * a plain CPython loop over the same input (rows in order, values,
    exception classes and counts);
  * the port's own host route, the same job with the backend's
    `handoff_budget` at 0 (rows, exception counts; each view equals
    `stage_partition` of the host route's partition, key by key);
  * `tuplex_tpu.Context().collect()` where the pipeline's own parity test
    compares with it (Q1, NYC 311, flights): the reference keeps its own
    handoff off on the CPU, so its run there is a host run.
Tolerance: exact, apart from float sums (Q1, Q19: within 1e-9 relative,
partials summed per partition) and flights' Distance against the
reference (one ulp, ROADMAP C8).
"""

import math
import random

import jax  # noqa: F401  (configured for the CPU by conftest)
import numpy as np
import pytest
import torch

import tuplex_tpu
import tuplex_tpu_torch
from tuplex_tpu.models import flights as ref_flights
from tuplex_tpu.models import nyc311 as ref_nyc311
from tuplex_tpu.models import tpch as ref_tpch
from tuplex_tpu_torch.exec.local import source_partitions
from tuplex_tpu_torch.models import flights, nyc311, tpch, widened
from tuplex_tpu_torch.plan.physical import consumer_kind, plan_stages
from tuplex_tpu_torch.runtime import columns as C
from tuplex_tpu_torch.runtime import xferstats

CPU = torch.device("cpu")
CONF = {"tuplex.partitionSize": "16KB"}   # several partitions a stage


@pytest.fixture(autouse=True)
def _private_aot_store(tmp_path, monkeypatch):
    """The reference package keeps compiled stages in an on-disk store
    that every process of one HOME shares; this file's reference runs use
    a store of their own, compiled in the test's own process."""
    monkeypatch.setenv("TUPLEX_AOT_CACHE", str(tmp_path / "aot"))
    monkeypatch.setenv("TUPLEX_COMPILE_ISOLATION", "thread")


def _port(budget=None):
    ctx = tuplex_tpu_torch.Context(CONF, device="cpu")
    if budget is not None:
        ctx.backend.handoff_budget = budget
    return ctx


def _close(a: float, b: float) -> bool:
    return math.isclose(a, b, rel_tol=1e-9, abs_tol=0.0)


class _Consumed:
    """Records every partition a consumer finishes (at `release_view`,
    so after the consumer has read its view): rows, boxed rows and a copy
    of its view's arrays."""

    def __init__(self, monkeypatch):
        self.parts: list = []
        real = C.release_view

        def record(part):
            view = getattr(part, "device", None)
            self.parts.append((
                part, None if view is None else
                {k: v.clone() for k, v in view.arrays.items()}))
            real(part)

        monkeypatch.setattr(C, "release_view", record)


def _run(monkeypatch, make, budget=None):
    """(collect() rows, exception counts, stage metrics, consumed
    partitions) of the job `make(ctx)` builds."""
    ctx = _port(budget)
    with monkeypatch.context() as mp:
        seen = _Consumed(mp)
        ds = make(ctx)
        rows = ds.collect()
    return rows, ds.exception_counts(), ctx.metrics.stages, seen.parts


def _assert_views_equal_staging(handed, host):
    """Oracle: the host route. Partition by partition in consumption
    order, each view has the keys, shapes and dtypes of `stage_partition`
    of the host route's partition, the same `#rowvalid`, the same values
    at valid rows, and zero padding. Returns the views checked."""
    assert len(handed) == len(host)
    views = 0
    for (hp, arrays), (op, none) in zip(handed, host):
        assert none is None
        assert hp.num_rows == op.num_rows and hp.fallback == op.fallback
        assert (hp.normal_mask is None) == (op.normal_mask is None)
        if op.normal_mask is not None:
            assert np.array_equal(hp.normal_mask, op.normal_mask)
        if arrays is None:
            continue
        views += 1
        want = C.stage_partition(op, CPU).arrays
        assert set(arrays) == set(want)
        rv = want["#rowvalid"]
        assert torch.equal(arrays["#rowvalid"], rv)
        n = op.num_rows
        for k, w in want.items():
            got = arrays[k]
            assert got.shape == w.shape and got.dtype == w.dtype, k
            assert torch.equal(got[rv], w[rv]), k
            assert not got[n:].any(), k
    return views


def _intermediate(stages):
    """The stages whose output partitions have a consumer on the device:
    not the last of the job or of a build side's plan (their partitions
    take the host route for want of one), nor one with a fused fold (its
    output is the fold's partials)."""
    return [s for s in stages if s["host_route_no_consumer"] == 0
            and s["handoff_parts"] + s["host_route_parts"] > 0]


def _assert_clean_handoff(stages):
    """Every partition of every intermediate stage handed off, and no data
    column fetched: the producer fetched control arrays only, and no
    consumer fetched a lazy leaf whole."""
    mid = _intermediate(stages)
    assert mid
    for s in mid:
        assert s["handoff_parts"] > 0 and s["host_route_parts"] == 0, s
        assert s.get("fetched_row_columns", 0) == 0, s
    assert all(s["forced_leaves"] == 0 for s in stages)


# ---------------------------------------------------------------------------
# TPC-H Q1 and NYC 311: a transform stage into an aggregate
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lineitem(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("handoff") / "lineitem.csv")
    tpch.generate_csv(path, 3000, seed=8)
    return path


def test_q1_hands_its_rows_to_the_aggregate(lineitem, monkeypatch):
    """Oracles: the loop (`run_reference_q1`), the host route and the
    reference package. The filter's rows reach `aggregateByKey` on the
    device: no data column is fetched."""
    def make(ctx):
        return tpch.q1(ctx.csv(lineitem))

    rows, excs, stages, handed = _run(monkeypatch, make)
    rows0, excs0, stages0, host = _run(monkeypatch, make, budget=0)
    want = tpch.run_reference_q1(lineitem)
    got = {r[:2]: r[2:] for r in rows}
    assert list(got) == list(want) and all(
        g[3] == w[3] and all(_close(x, y) for x, y in zip(g[:3], w[:3]))
        for g, w in zip(got.values(), want.values()))
    assert rows == rows0 and excs == excs0 == {}
    ref = {r[:2]: r[2:] for r in
           ref_tpch.q1(tuplex_tpu.Context().csv(lineitem)).collect()}
    assert set(ref) == set(got) and all(
        all(_close(x, y) for x, y in zip(got[k], ref[k])) for k in got)
    _assert_clean_handoff(stages)
    assert stages[0]["handoff_parts"] > 1
    assert stages0[0]["handoff_parts"] == 0 and \
        stages0[0]["host_route_budget"] == stages[0]["handoff_parts"]
    assert stages0[0]["fetched_row_columns"] > 0
    assert _assert_views_equal_staging(handed, host) == \
        stages[0]["handoff_parts"]


def test_nyc311_hands_its_rows_to_unique(tmp_path, monkeypatch):
    """Oracles: the loop, the host route and the reference package
    (compared as a multiset: its device path sorts)."""
    path = str(tmp_path / "311.csv")
    nyc311.generate_csv(path, 3000, seed=23)

    def make(ctx):
        return nyc311.build_pipeline(ctx, path)

    rows, excs, stages, handed = _run(monkeypatch, make)
    rows0, excs0, _, host = _run(monkeypatch, make, budget=0)
    assert rows == nyc311.run_reference_python(path) == rows0
    assert excs == excs0 == {}
    ref = ref_nyc311.build_pipeline(tuplex_tpu.Context(), path).collect()
    assert sorted(map(repr, rows)) == sorted(map(repr, ref))
    _assert_clean_handoff(stages)
    assert stages[1]["device_rows"] == 3000
    assert _assert_views_equal_staging(handed, host) > 1


# ---------------------------------------------------------------------------
# Q19 and flights: stages into joins, joins into stages
# ---------------------------------------------------------------------------

def test_q19_hands_off_into_and_out_of_the_join(tmp_path, monkeypatch):
    """Oracles: the loop (`run_reference_q19`) and the host route. The
    filters' rows reach the join on the device, and the join's output the
    fused fold."""
    part, li = str(tmp_path / "part.csv"), str(tmp_path / "li.csv")
    tpch.generate_q19_csvs(part, li, 400, 6000, seed=19)

    def make(ctx):
        return tpch.q19(ctx, part, li)

    rows, excs, stages, handed = _run(monkeypatch, make)
    rows0, excs0, _, host = _run(monkeypatch, make, budget=0)
    want = tpch.run_reference_q19(part, li)
    assert want > 0 and _close(rows[0], want) and _close(rows0[0], want)
    assert excs == excs0 == {}
    _assert_clean_handoff(stages)
    join = next(s for s in stages if "host_probed_rows" in s)
    assert join["handoff_parts"] > 0 and join["host_probed_rows"] == 0
    assert _assert_views_equal_staging(handed, host) > 2


@pytest.fixture(scope="module")
def flights_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("flights")
    paths = [str(d / n) for n in ("perf.csv", "carrier.csv", "airports.txt")]
    flights.generate_perf_csv(paths[0], 300, seed=13)
    flights.generate_carrier_csv(paths[1])
    flights.generate_airport_db(paths[2])
    return paths


def test_flights_hands_off_through_three_joins(flights_files, monkeypatch):
    """Oracles: the loop, the host route and the reference package (its
    Distance at most one ulp off, ROADMAP C8). The first stage's rows
    that the general tier finishes are scattered into its views; the
    joins' boxed rows stay boxed."""
    def make(ctx):
        return flights.build_pipeline(ctx, *flights_files)

    rows, excs, stages, handed = _run(monkeypatch, make)
    rows0, excs0, _, host = _run(monkeypatch, make, budget=0)
    loop_excs: dict = {}
    want = flights.run_reference_python(*flights_files, exceptions=loop_excs)
    assert rows == want == rows0 and excs == excs0 == loop_excs
    # the stages before the three joins, the defunct filter pushed between
    # the first two (plan/optimizer.py push_filters_through_joins) and
    # the joins before the last stage
    mid = _intermediate(stages)
    assert len(mid) == 5 and all(s["handoff_parts"] > 0 for s in mid)
    assert stages[0]["general_rows"] > 0
    joins = [s for s in stages if "host_probed_rows" in s]
    assert all(s["host_probed_rows"] == 0 for s in joins)
    assert _assert_views_equal_staging(handed, host) >= 4
    ds = ref_flights.build_pipeline(tuplex_tpu.Context(), *flights_files)
    ref = ds.collect()
    d = flights.OUTPUT_COLS.index("Distance")
    assert len(ref) == len(rows) and ds.exception_counts() == excs
    for g, r in zip(rows, ref):
        assert g[:d] + g[d + 1:] == r[:d] + r[d + 1:]
        assert math.isclose(g[d], r[d], rel_tol=2.3e-16, abs_tol=0.0)


# ---------------------------------------------------------------------------
# resolved rows: the general tier and the interpreter scatter into views
# ---------------------------------------------------------------------------

def test_widened_general_rows_reach_the_join_on_the_device(tmp_path,
                                                           monkeypatch):
    """Two stages over models/widened.py: the rows whose c cell is filled
    leave the fast path and the general tier finishes them; they are
    scattered into the views the leftJoin probes. Oracles: the loop and
    the host route."""
    path = str(tmp_path / "w.csv")
    filled = widened.generate_csv(path, 4000)
    names = [(d, f"n{d}") for d in range(-198, 200, 2)]

    def make(ctx):
        right = ctx.parallelize(names, columns=["dd", "name"])
        return (widened.build_pipeline(ctx.csv(path))
                .leftJoin(right, "d", "dd")
                .map(lambda x: (x["a"], x["e"], x["name"])))

    rows, excs, stages, handed = _run(monkeypatch, make)
    rows0, excs0, _, host = _run(monkeypatch, make, budget=0)
    lookup = dict(names)
    want = [(a, e, lookup.get(d))
            for a, d, e in widened.run_reference_python(path)]
    assert rows == want == rows0 and excs == excs0 == {}
    assert stages[0]["general_rows"] == filled > 0
    assert stages[0]["interpreter_rows"] == 0
    mid = _intermediate(stages)
    assert len(mid) == 2 and all(s["handoff_parts"] > 0 and
                                 s["host_route_parts"] == 0 for s in mid)
    # the join fetched no left leaf whole; the last stage no joined one
    assert all(s["forced_leaves"] == 0 for s in stages)
    assert _assert_views_equal_staging(handed, host) >= 2


def _resolver(x):
    if x["s"] == "cde":
        return (x["s"], 1 // 0)          # raises: an exception record
    if x["s"] == "f":
        return (x["s"] * 9, -1)          # wider than the column: boxed
    return (x["s"], -2)                  # scattered into the view


def _resolve_job(ctx, data):
    return (ctx.parallelize(data, columns=["s", "k"])
            .map(lambda x: (x["s"], 12 // x["k"]))
            .resolve(ZeroDivisionError, _resolver)
            .unique()
            .map(lambda t: (t[1], t[0])))


def _resolve_loop(data):
    out, excs = [], {}
    for s, k in data:
        try:
            v = (s, 12 // k)
        except ZeroDivisionError:
            try:
                v = _resolver({"s": s, "k": k})
            except ZeroDivisionError as e:
                excs[type(e).__name__] = excs.get(type(e).__name__, 0) + 1
                continue
        out.append(v)
    return [(t[1], t[0]) for t in dict.fromkeys(out)], excs


def test_resolved_and_boxed_rows_in_a_view(monkeypatch):
    """A UDF that raises on some rows under `resolve`: the interpreter
    finishes them; those that conform are scattered into the view, a
    string wider than its column stays boxed (not `#rowvalid`), and the
    resolver's own raise is an exception record. `unique` takes the view;
    its output is staged for the last stage. Oracles: the loop and the
    host route."""
    rng = random.Random(3)
    data = [(rng.choice(["ab", "cde", "f"]), rng.randint(-3, 9))
            for _ in range(3000)]

    def make(ctx):
        return _resolve_job(ctx, data)

    rows, excs, stages, handed = _run(monkeypatch, make)
    rows0, excs0, _, host = _run(monkeypatch, make, budget=0)
    want, want_excs = _resolve_loop(data)
    assert rows == want == rows0
    assert excs == excs0 == want_excs and want_excs
    assert stages[0]["interpreter_rows"] > 0
    assert stages[0]["handoff_parts"] > 1 and \
        stages[0]["host_route_parts"] == 0
    boxed = [p for p, arrays in handed if arrays is not None and p.fallback]
    assert boxed and all(
        not arrays["#rowvalid"][list(p.fallback)].any()
        for p, arrays in handed if arrays is not None and p.fallback)
    assert stages[1]["handoff_parts"] == 1      # unique's output, staged
    assert _assert_views_equal_staging(handed, host) == \
        stages[0]["handoff_parts"] + 1


# ---------------------------------------------------------------------------
# the budget, and lazy leaves
# ---------------------------------------------------------------------------

def test_budget_smaller_than_a_partition_takes_the_host_route(lineitem):
    """A budget of one partition and a half: the first partition hands
    off, the rest go by the host route for the budget, with the rows the
    whole budget gives (oracle: the unlimited run). A second collect() on
    the same context gets the whole budget back."""
    rows = tpch.q1(_port().csv(lineitem)).collect()
    probe = _port()
    stage = plan_stages(tpch.q1(probe.csv(lineitem))._op)[0]
    parts = source_partitions(probe, stage.source)
    res = probe.backend.execute(stage, parts, "agg")
    one = C.view_nbytes(res.partitions[0].leaves,
                        res.partitions[0].num_rows)
    ctx = _port(budget=one * 3 // 2)
    for _ in range(2):
        before = len(ctx.metrics.stages)
        assert tpch.q1(ctx.csv(lineitem)).collect() == rows
        first = ctx.metrics.stages[before]
        assert first["handoff_parts"] == 1
        assert first["host_route_budget"] == len(parts) - 1 > 0
        assert first["handoff_budget_bytes"] == one * 3 // 2


def test_reading_one_leaf_of_a_lazy_partition_fetches_it_alone(lineitem):
    """Oracle: the host route's leaf. Reading one key leaf of a handed-off
    partition fetches that leaf, and only it."""
    outs = {}
    for budget in (None, 0):
        ctx = _port(budget)
        stage = plan_stages(tpch.q1(ctx.csv(lineitem))._op)[0]
        parts = source_partitions(ctx, stage.source)
        outs[budget] = ctx.backend.execute(stage, parts, "agg").partitions
    lazy, host = outs[None][0], outs[0][0]
    assert isinstance(lazy.leaves, C.LazyLeaves) and lazy.device is not None
    assert set(lazy.leaves) == set(host.leaves) and len(lazy.leaves) > 1
    key = next(p for p in lazy.leaves
               if isinstance(host.leaves[p], C.StrLeaf))
    snap = xferstats.snapshot()
    leaf = lazy.leaves[key]
    got = xferstats.since(snap)
    assert got["forced_leaves"] == 1
    assert got["d2h_bytes"] == leaf.bytes.nbytes + leaf.lengths.nbytes + (
        0 if leaf.valid is None else leaf.valid.nbytes)
    want = host.leaves[key]
    assert np.array_equal(leaf.bytes, want.bytes) and \
        np.array_equal(leaf.lengths, want.lengths)
    assert [p for p in lazy.leaves if dict.__contains__(lazy.leaves, p)] \
        == [key]
    # the host leaf is a copy: writing it leaves the view as it was
    before = lazy.device.arrays[key + "#bytes"].clone()
    leaf.bytes[:] = 0
    assert torch.equal(lazy.device.arrays[key + "#bytes"], before)
    C.release_view(lazy)
    other = next(p for p in lazy.leaves if p != key)
    with pytest.raises(Exception, match="released"):
        lazy.leaves[other]


def test_consumer_kind_names_the_next_stage(flights_files, lineitem):
    """Oracle: the plan's own stage list. Flights' stages hand to a join
    (the filter pushed between the carrier join and the Origin join
    takes the first join's output), joins to joins and to the last stage,
    which has none; a stage whose emitter refused its UDFs (interpreted)
    is no device consumer."""
    ds = flights.build_pipeline(_port(), *flights_files)
    stages = plan_stages(ds._op)
    kinds = [consumer_kind(stages, i) for i in range(len(stages))]
    assert kinds == ["join", "stage", "join", "join", "stage", False]
    stages[-1].not_compilable = True
    assert consumer_kind(stages, len(stages) - 2) is False
    q1 = plan_stages(tpch.q1(_port().csv(lineitem))._op)
    assert [consumer_kind(q1, i) for i in range(len(q1))] == ["agg", False]


def test_timed_copies_split_the_stage_wall(lineitem, monkeypatch):
    """`xferstats.TIMED` (chip_smoke's copy split) times every copy and
    the wait before it, and changes no result (oracle: the untimed
    run)."""
    rows = tpch.q1(_port().csv(lineitem)).collect()
    monkeypatch.setattr(xferstats, "TIMED", True)
    ctx = _port(budget=0)
    assert tpch.q1(ctx.csv(lineitem)).collect() == rows
    first = ctx.metrics.stages[0]
    assert first["copy_s"] > 0 and first["wait_s"] >= 0
    assert first["copy_s"] + first["wait_s"] <= first["wall_s"]
