"""The flights pipeline through tuplex_tpu_torch.Context(device="cpu"): a
carrier join and two airport leftJoins with prefixes, renames, strip,
str.format, float(), string.capwords and ignore(TypeError).

Oracles: the plain Python loop `run_reference_python` (rows in order,
values exact) and `tuplex_tpu.Context()` running the reference package's
`build_pipeline` on the same files (its joins take their host path on the
CPU; its device join is not an oracle, ROADMAP C6). The reference computes
`Distance / 0.00062137119224` as a product with the reciprocal, one ulp off
the quotient on some rows (ROADMAP C8); there the port equals the loop.
"""

import csv
import math

import jax  # noqa: F401  (configured for the CPU by conftest)
import pytest

import tuplex_tpu
import tuplex_tpu_torch
from tuplex_tpu.models import flights as ref_flights
from tuplex_tpu_torch.models import flights

ROWS = 200
CONF = {"tuplex.partitionSize": "16KB"}   # several perf partitions


@pytest.fixture(autouse=True)
def _private_aot_store(tmp_path, monkeypatch):
    """The reference package keeps compiled stages in an on-disk store
    that every process of one HOME shares; this file's reference runs use
    a store of their own, compiled in the test's own process."""
    monkeypatch.setenv("TUPLEX_AOT_CACHE", str(tmp_path / "aot"))
    monkeypatch.setenv("TUPLEX_COMPILE_ISOLATION", "thread")


def _files(d, rows=ROWS):
    paths = [str(d / n) for n in ("perf.csv", "carrier.csv", "airports.txt")]
    flights.generate_perf_csv(paths[0], rows, seed=13)
    flights.generate_carrier_csv(paths[1])
    flights.generate_airport_db(paths[2])
    return paths


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return _files(tmp_path_factory.mktemp("flights"))


@pytest.fixture(scope="module")
def port_run(files):
    ctx = tuplex_tpu_torch.Context(CONF, device="cpu")
    ds = flights.build_pipeline(ctx, *files)
    return ds.collect(), ds, ctx


def test_generators_write_the_reference_bytes(tmp_path):
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    mine = _files(tmp_path / "a", 300)
    theirs = [str(tmp_path / "b" / n) for n in
              ("perf.csv", "carrier.csv", "airports.txt")]
    ref_flights.generate_perf_csv(theirs[0], 300, seed=13)
    ref_flights.generate_carrier_csv(theirs[1])
    ref_flights.generate_airport_db(theirs[2])
    for a, b in zip(mine, theirs):
        assert open(a, "rb").read() == open(b, "rb").read()


def test_flights_equals_the_loop(files, port_run):
    """Oracle: run_reference_python, rows in order and values exact (the
    loop parses the airport altitudes as floats; the pipeline, like the
    reference package's, sniffs them as ints, which compare equal)."""
    got, ds, _ = port_run
    excs: dict = {}
    want = flights.run_reference_python(*files, exceptions=excs)
    assert len(want) > ROWS // 2 and got == want
    d = flights.OUTPUT_COLS.index("Distance")
    assert [r[d].hex() for r in got] == [r[d].hex() for r in want]
    assert ds.exception_counts() == excs == {}


def test_flights_runs_its_joins_on_the_device_path(port_run):
    """Every left row of the three joins is probed on the device path,
    with two-word keys (the string key bytes, their length); the transform
    stages compile."""
    _, _, ctx = port_run
    joins = [m for m in ctx.metrics.stages if "host_probed_rows" in m]
    assert len(joins) == 3
    assert all(m["host_probed_rows"] == 0 and m["device_probed_rows"] > 0
               and m["key_words"] == 2 for m in joins)
    assert all(m["tier"] == "compiled" for m in ctx.metrics.stages
               if "tier" in m)


@pytest.fixture(scope="module")
def reference_run(files, tmp_path_factory):
    """The reference package's run, once for the module. A module-scoped
    fixture runs before the autouse one above, so it points the
    reference's store at its own directory itself."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TUPLEX_AOT_CACHE", str(tmp_path_factory.mktemp("aot")))
        mp.setenv("TUPLEX_COMPILE_ISOLATION", "thread")
        ds = ref_flights.build_pipeline(tuplex_tpu.Context(), *files)
        return ds.collect(), ds.exception_counts()


def test_flights_equals_the_reference_package(port_run, reference_run):
    """Oracle: the reference package's pipeline on the same files: the
    same rows, values and types, but Distance, where the reference is at
    most one ulp off the loop's quotient (ROADMAP C8)."""
    got, ds, _ = port_run
    ref, ref_excs = reference_run
    d = flights.OUTPUT_COLS.index("Distance")
    assert len(got) == len(ref) and ds.exception_counts() == ref_excs
    for g, r in zip(got, ref):
        assert g[:d] + g[d + 1:] == r[:d] + r[d + 1:]
        assert [type(v) for v in g] == [type(v) for v in r]
        assert math.isclose(g[d], r[d], rel_tol=2.3e-16, abs_tol=0.0)


def _with_unresolved_diversions(src: str, dst: str) -> int:
    """The perf file with DivActualElapsedTime emptied on every row that
    reached its diversion destination, so fillInTimesUDF raises TypeError
    (float(None)) there. Returns the number of such rows."""
    with open(src, newline="") as fp:
        rows = list(csv.reader(fp))
    ci = rows[0].index("div_reached_dest")
    cj = rows[0].index("div_actual_elapsed_time")
    n = 0
    for r in rows[1:]:
        if r[ci] == "1.00":
            r[cj] = ""
            n += 1
    with open(dst, "w", newline="") as fp:
        csv.writer(fp).writerows(rows)
    return n


def test_ignore_type_error_drops_and_counts_rows(tmp_path):
    """ignore(TypeError) after fillInTimesUDF: the rows that raise it are
    dropped, counted by Metrics.ignoredRows and not exceptions of the job,
    as in the reference package. Oracles: the loop (which skips them) and
    tuplex_tpu.Context()."""
    paths = _files(tmp_path, 600)
    dirty = str(tmp_path / "dirty.csv")
    n = _with_unresolved_diversions(paths[0], dirty)
    assert n > 0
    ctx = tuplex_tpu_torch.Context(CONF, device="cpu")
    ds = flights.build_pipeline(ctx, dirty, *paths[1:])
    got = ds.collect()
    excs: dict = {}
    assert got == flights.run_reference_python(dirty, *paths[1:],
                                               exceptions=excs)
    assert ds.exception_counts() == excs == {}
    assert ctx.metrics.ignoredRows() == n
    rds = ref_flights.build_pipeline(tuplex_tpu.Context(), dirty,
                                     *paths[1:])
    assert len(rds.collect()) == len(got) and rds.exception_counts() == {}
