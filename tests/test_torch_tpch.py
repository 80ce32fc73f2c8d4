"""TPC-H Q6 and Q1 through tuplex_tpu_torch.Context(device="cpu").

Oracles: the plain Python loops of `tuplex_tpu_torch.models.tpch`
(`q6_python`, `q1_python` and their exception-counting forms over the
same file) and `tuplex_tpu.Context()` on the same file (the reference;
its groups compared as a dict, since its device path sorts them).
Tolerance: float sums within 1e-9 relative (partials are summed per
partition, then merged in partition order); counts, keys, group order
and exception counts exact.
"""

import math

import jax  # noqa: F401  (configured for the CPU by conftest)
import pytest

import tuplex_tpu
import tuplex_tpu_torch
from tuplex_tpu.models import tpch as ref_tpch
from tuplex_tpu_torch.models import tpch
from tuplex_tpu_torch.plan.physical import plan_stages
from tuplex_tpu_torch.runtime import columns as C

ROWS = 3000
# about 300 rows a partition: every query runs over several partitions
CONF = {"tuplex.partitionSize": "16KB"}


@pytest.fixture(autouse=True)
def _private_aot_store(tmp_path, monkeypatch):
    """The reference package keeps compiled stages in an on-disk store
    that every process of one HOME shares; this file's reference runs use
    a store of their own. They compile in the test's own process: the
    reference's default on the CPU, a forked compile child per stage,
    costs seconds a pipeline and gives the same results."""
    monkeypatch.setenv("TUPLEX_AOT_CACHE", str(tmp_path / "aot"))
    monkeypatch.setenv("TUPLEX_COMPILE_ISOLATION", "thread")


@pytest.fixture(scope="module")
def lineitem(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tpch") / "lineitem.csv")
    tpch.generate_csv(path, ROWS, seed=8)
    return path


@pytest.fixture(scope="module")
def dirty(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tpch") / "dirty.csv")
    tpch.generate_dirty_csv(path, 2000, seed=8)
    return path


def _port():
    return tuplex_tpu_torch.Context(CONF, device="cpu")


def _close(a: float, b: float) -> bool:
    return math.isclose(a, b, rel_tol=1e-9, abs_tol=0.0)


def _same_groups(got: dict, want: dict) -> bool:
    return list(got) == list(want) and all(
        g[3] == w[3] and all(_close(x, y) for x, y in zip(g[:3], w[:3]))
        for g, w in zip(got.values(), want.values()))


def test_generator_writes_the_reference_bytes(tmp_path):
    a, b = str(tmp_path / "a.csv"), str(tmp_path / "b.csv")
    tpch.generate_csv(a, 500, seed=7)
    ref_tpch.generate_csv(b, 500, seed=7)
    assert open(a, "rb").read() == open(b, "rb").read()


def test_q6_matches_reference_and_loop(lineitem):
    ctx = _port()
    ds = tpch.q6(ctx.csv(lineitem))
    (got,) = ds.collect()
    want = tpch.run_reference_q6(lineitem)
    (ref,) = ref_tpch.q6(tuplex_tpu.Context().csv(lineitem)).collect()
    assert _close(got, want) and _close(got, ref)
    assert ds.exception_counts() == {}
    # the filters and the fold ran in one device pass per partition,
    # which sent back partials and flags but no row
    stage = ctx.metrics.stages[0]
    assert stage["tier"] == "compiled" and stage["fetched_row_columns"] == 0
    assert ctx.metrics.interpreterRows() == 0
    assert ctx.metrics.stages[1]["device_rows"] > 0
    (again,) = tpch.q6(_port().csv(lineitem)).collect()
    assert again.hex() == got.hex()


def test_q1_matches_reference_and_loop(lineitem):
    ctx = _port()
    ds = tpch.q1(ctx.csv(lineitem))
    rows = ds.collect()
    got = {r[:2]: r[2:] for r in rows}
    want = tpch.run_reference_q1(lineitem)
    # first-occurrence order, as the loop's dict
    assert _same_groups(got, want)
    assert [type(v) for v in rows[0]] == [str, str, float, float, float, int]
    ref = {r[:2]: r[2:] for r in
           ref_tpch.q1(tuplex_tpu.Context().csv(lineitem)).collect()}
    assert _same_groups(got, {k: ref[k] for k in got}) and set(ref) == \
        set(got)
    assert ctx.metrics.interpreterRows() == 0
    assert ds.exception_counts() == {}


def test_dirty_cells_rows_and_exceptions_match_the_loop(dirty):
    """'N/A' and empty l_quantity and l_discount cells: the rows that
    raise and their classes are CPython's."""
    rows = tpch.read_lineitem_dicts(dirty)
    want6, exc6 = tpch.q6_python_counting(rows)
    ctx = _port()
    ds = tpch.q6(ctx.csv(dirty))
    (got6,) = ds.collect()
    assert _close(got6, want6) and ds.exception_counts() == exc6
    assert sum(exc6.values()) > 0
    # a dirty row leaves the fast path once, in the transform stage, and
    # the general tier or the exact exit finishes it
    n_dirty = sum(not isinstance(x[c], float) for x in rows
                  for c in ("l_quantity", "l_discount"))
    m = ctx.metrics
    tiers = ("interpreter_rows", "general_rows", "exact_exit_rows")
    assert 0 < m.interpreterRows() + m.generalRows() + m.exactExitRows() \
        == sum(m.stages[0][k] for k in tiers) <= n_dirty
    assert m.interpreterRows() == 0
    want1, exc1 = tpch.q1_python_counting(rows)
    ds = tpch.q1(_port().csv(dirty))
    got1 = {r[:2]: r[2:] for r in ds.collect()}
    assert _same_groups(got1, want1) and ds.exception_counts() == exc1
    assert exc1 == {"TypeError": sum(exc1.values())} and \
        sum(exc1.values()) > 50


def test_q1_reads_no_l_tax(lineitem, monkeypatch):
    """Projection: Q1's plan splits out, decodes and stages only the six
    columns it reads; Q6 only four."""
    ctx = _port()
    staged = []
    real = C.stage_partition

    def spy(part, device, **kw):
        staged.append(tuple(part.schema.columns))
        return real(part, device, **kw)

    monkeypatch.setattr(C, "stage_partition", spy)
    tpch.q1(ctx.csv(lineitem)).collect()
    assert staged and all("l_tax" not in cols for cols in staged)
    first = plan_stages(tpch.q1(ctx.csv(lineitem))._op)[0]
    assert first.source.schema().columns == (
        "l_quantity", "l_extendedprice", "l_discount", "l_returnflag",
        "l_linestatus", "l_shipdate")
    parts = first.source.load_partitions()
    assert len(parts) > 1 and all(len(p.leaves) == 6 for p in parts)
    q6 = plan_stages(tpch.q6(ctx.csv(lineitem))._op)
    assert len(q6[0].source.schema().columns) == 4
    assert q6[0].fold_spec.reducers == ["sum"]
