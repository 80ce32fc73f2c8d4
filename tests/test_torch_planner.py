"""The planner of tuplex_tpu_torch (plan/physical.py `plan_stages`,
plan/optimizer.py, plan/cacheop.py) and the API built on it, on the CPU.

Oracles:
  * plans: the reference package's `plan_stages` over the same pipeline
    and options, stage by stage (kind, interpreter flag, each operator's
    kind and UDF name). The reference runs with `tuplex.executorMemory`
    16GB and `tuplex.tpu.maxStageOps` 0, so its graph vetting and its
    split tuner, which the port does not have, cut no stage;
  * rows: the plain Python loops of the models, with pushdown on and off
    (exact; Q6's and Q19's sums within 1e-9 relative, Q1's groups too);
  * exception counts: the reference package's run of the same pipeline
    under the same options, and the loop's with pushdown off;
  * the API: the reference's `show`, `options` and `explain` output, and
    the loop's first rows for `take`.
"""

import json
import math
import re

import pytest

import tuplex_tpu
from tuplex_tpu.models import flights as ref_flights
from tuplex_tpu.models import logs as ref_logs
from tuplex_tpu.models import nyc311 as ref_nyc311
from tuplex_tpu.models import tpch as ref_tpch
from tuplex_tpu.models import zillow as ref_zillow
from tuplex_tpu.plan import physical as ref_physical
from tuplex_tpu_torch.api.context import Context
from tuplex_tpu_torch.compiler import analyzer
from tuplex_tpu_torch.exec import local
from tuplex_tpu_torch.io import csvsource
from tuplex_tpu_torch.models import flights, logs, nyc311, tpch, zillow
from tuplex_tpu_torch.plan import physical

PUSH = "tuplex.optimizer.filterPushdown"
REF_CONF = {"tuplex.executorMemory": "16GB", "tuplex.tpu.maxStageOps": 0}


@pytest.fixture(autouse=True)
def _private_aot_store(tmp_path, monkeypatch):
    """The reference package keeps compiled stages in an on-disk store
    that every process of one HOME shares; this file's reference runs use
    a store of their own, compiled in the test's own process."""
    monkeypatch.setenv("TUPLEX_AOT_CACHE", str(tmp_path / "aot"))
    monkeypatch.setenv("TUPLEX_COMPILE_ISOLATION", "thread")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("planner")
    f = {"perf": flights.generate_perf_csv(str(d / "perf.csv"), 400,
                                           seed=13),
         "carrier": flights.generate_carrier_csv(str(d / "carrier.csv")),
         "airports": flights.generate_airport_db(str(d / "airports.txt")),
         "zillow": zillow.generate_csv(str(d / "z.csv"), 400, seed=7),
         "lineitem": tpch.generate_csv(str(d / "li.csv"), 1500, seed=7),
         "part": str(d / "part.csv"), "li19": str(d / "li19.csv"),
         "nyc": nyc311.generate_csv(str(d / "nyc.csv"), 600),
         "log": logs.generate_log(str(d / "access.log"), 600, seed=17,
                                  non_ascii_every=100)}
    tpch.generate_q19_csvs(f["part"], f["li19"], 300, 1500, seed=19)
    return f


# the model pipelines: name -> build(model module, context, files)
PIPELINES = {
    "flights": lambda m, c, f: m.build_pipeline(c, f["perf"], f["carrier"],
                                                f["airports"]),
    "z1": lambda m, c, f: m.build_pipeline(c.csv(f["zillow"])),
    "q6": lambda m, c, f: m.q6(c.csv(f["lineitem"])),
    "q1": lambda m, c, f: m.q1(c.csv(f["lineitem"])),
    "q19": lambda m, c, f: m.q19(c, f["part"], f["li19"]),
    "nyc311": lambda m, c, f: m.build_pipeline(c, f["nyc"]),
    "weblogs_strip": lambda m, c, f: m.build_pipeline(c.text(f["log"]),
                                                      "strip"),
    "weblogs_regex": lambda m, c, f: m.build_pipeline(c.text(f["log"]),
                                                      "regex"),
}
MODELS = {"flights": (ref_flights, flights), "z1": (ref_zillow, zillow),
          "q6": (ref_tpch, tpch), "q1": (ref_tpch, tpch),
          "q19": (ref_tpch, tpch), "nyc311": (ref_nyc311, nyc311),
          "weblogs_strip": (ref_logs, logs),
          "weblogs_regex": (ref_logs, logs)}


def _port(conf=None):
    return Context(conf or {}, device="cpu")


def _ref(conf=None):
    return tuplex_tpu.Context({**REF_CONF, **(conf or {})})


def _signature(stages) -> list:
    """(stage kind, interpreter flag, [(operator kind, UDF name)])."""
    return [(type(s).__name__, bool(getattr(s, "force_interpret", False)),
             [(type(o).__name__, getattr(getattr(o, "udf", None), "name",
                                         None))
              for o in getattr(s, "ops", [])]) for s in stages]


def _plans(build, conf):
    """(the reference's signature, the port's) of one pipeline."""
    rc, pc = _ref(conf), _port(conf)
    ref = ref_physical.plan_stages(build(0, rc)._op, rc.options_store)
    port = physical.plan_stages(build(1, pc)._op, pc.options_store)
    return _signature(ref), _signature(port)


# ---------------------------------------------------------------------------
# plan parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("push", [True, False], ids=["push", "nopush"])
@pytest.mark.parametrize("name", list(PIPELINES))
def test_plans_match_the_reference(files, name, push):
    mods = MODELS[name]
    ref, port = _plans(lambda i, c: PIPELINES[name](mods[i], c, files),
                       {PUSH: push})
    assert port == ref
    if name == "flights":
        kinds = [k for k, _, _ in port]
        defunct = ("FilterOperator", "filterDefunctFlights#joinpush#joinpush")
        if push:
            # the filter stands alone between the carrier join and the
            # Origin and Dest joins
            assert kinds == ["TransformStage", "JoinStage", "TransformStage",
                             "JoinStage", "JoinStage", "TransformStage"]
            assert port[2][2] == [defunct]
        else:
            assert kinds == ["TransformStage", "JoinStage", "JoinStage",
                             "JoinStage", "TransformStage"]
            assert ("FilterOperator", "filterDefunctFlights") in port[-1][2]


def _loop_rows(name, f, exceptions=None):
    if name == "flights":
        return flights.run_reference_python(f["perf"], f["carrier"],
                                            f["airports"],
                                            exceptions=exceptions)
    if name == "z1":
        return zillow.run_reference_python(f["zillow"])
    if name == "q6":
        return tpch.run_reference_q6(f["lineitem"])
    if name == "q1":
        return tpch.run_reference_q1(f["lineitem"])
    if name == "q19":
        return tpch.run_reference_q19(f["part"], f["li19"])
    if name == "nyc311":
        return nyc311.run_reference_python(f["nyc"])
    return logs.run_reference_python(f["log"], name.split("_")[1])


def _close(a, b) -> bool:
    return math.isclose(a, b, rel_tol=1e-9, abs_tol=0.0)


@pytest.mark.parametrize("push", [True, False], ids=["push", "nopush"])
@pytest.mark.parametrize("name", list(PIPELINES))
def test_rows_equal_the_loop(files, name, push):
    ctx = _port({PUSH: push, "tuplex.partitionSize": "32KB"})
    ds = PIPELINES[name](MODELS[name][1], ctx, files)
    got = ds.collect()
    loop_excs: dict = {}
    want = _loop_rows(name, files, loop_excs)
    if name in ("q6", "q19"):
        assert len(got) == 1 and _close(got[0], want)
    elif name == "q1":
        groups = {r[:2]: r[2:] for r in got}
        assert list(groups) == list(want)
        for k, v in want.items():
            assert all(_close(a, b) for a, b in zip(groups[k], v))
    else:
        assert got == want
    if name == "flights":
        # the loop applies no pushdown; flights raises nothing either way
        assert ds.exception_counts() == loop_excs == {}
        joins = [m for m in ctx.metrics.stages if "device_probed_rows" in m]
        into = [m["device_probed_rows"] + m["host_probed_rows"]
                for m in joins]
        kept = sum(1 for r in flights.run_reference_python(
            files["perf"], files["carrier"], files["airports"]))
        assert into[0] == 400
        if push:
            # the Origin and Dest joins probe only the rows the defunct
            # filter keeps
            assert into[1] == into[2] == kept < 400
        else:
            assert into[1] == into[2] == 400


# ---------------------------------------------------------------------------
# segmentation at the operators the emitter refuses
# ---------------------------------------------------------------------------

SEGMENT_MAPS = {
    "json": lambda x: json.dumps(x),
    "encode": lambda x: x.encode("utf-8"),
    "sorted": lambda x: sorted(x),
    "set": lambda x: len(set(x)),
    "split": lambda x: x.split(" ")[1],
    "fstring": lambda x: f"<{len(x):05}|{x[:3]}>",
}


def _grep(ds, f):
    return ds.filter(lambda x: re.search(r"GET", x) is not None) \
        .map(f).map(lambda y: (y, 1))


@pytest.mark.parametrize("form", list(SEGMENT_MAPS))
def test_segments_match_the_reference(files, form):
    f = SEGMENT_MAPS[form]
    ref, port = _plans(lambda i, c: _grep(c.text(files["log"]), f), {})
    assert [(k, interp) for k, interp, _ in port] == \
        [(k, interp) for k, interp, _ in ref]
    assert port == ref
    ctx = _port({"tuplex.partitionSize": "16KB"})
    ds = _grep(ctx.text(files["log"]), f)
    want = []
    for line in open(files["log"], encoding="utf-8").read().splitlines():
        if re.search(r"GET", line) is not None:
            want.append((f(line), 1))
    assert ds.collect() == want
    assert ds.exception_counts() == {}
    stages = ctx.metrics.stages
    segments = [bool(s.get("tier") == "interpreter") for s in stages]
    assert segments == [interp for _, interp, _ in port]
    if any(segments):
        # the interpreter segment runs exactly the rows the filter keeps
        first = segments.index(True)
        assert stages[first]["interpreter_rows"] == len(want)


def test_a_resolver_rides_with_the_operator_it_guards(files):
    """An ignore after a refused map rides in its interpreter segment;
    the rows it drops are ignored, not exceptions, as in the loop."""
    def build(i, c):
        return c.text(files["log"]).filter(
            lambda x: re.search(r"GET", x) is not None) \
            .map(lambda x: sorted(x)[80]).ignore(IndexError) \
            .map(lambda y: (y, 1))

    ref, port = _plans(build, {})
    assert port == ref
    assert [(interp, [k for k, _ in ops]) for _, interp, ops in port] == [
        (False, ["FilterOperator"]),
        (True, ["MapOperator", "IgnoreOperator"]),
        (False, ["MapOperator"])]
    ctx = _port({"tuplex.partitionSize": "16KB"})
    ds = build(1, ctx)
    kept = [x for x in _lines(files["log"])
            if re.search(r"GET", x) is not None]
    want = [(sorted(x)[80], 1) for x in kept if len(x) > 80]
    assert ds.collect() == want
    assert ds.exception_counts() == {}
    assert ctx.metrics.ignoredRows() == len(kept) - len(want) > 0


def test_split_and_fstring_forms_equal_cpython():
    """The emitter's `s.split(sep)[k]` and f-strings against CPython: rows
    with too few pieces raise IndexError, None rows AttributeError or a
    TypeError of len, non-ASCII rows split by bytes as by code points."""
    data = ["a b c", "a", "", "é b ü", "  x", "b  c", None, "q r"] * 40
    ctx = _port()

    def run(f):
        ds = ctx.parallelize(data).map(f)
        want, excs = [], {}
        for v in data:
            try:
                want.append(f(v))
            except Exception as e:
                excs[type(e).__name__] = excs.get(type(e).__name__, 0) + 1
        assert ds.collect() == want
        assert ds.exception_counts() == excs

    run(lambda x: x.split(" ")[1])
    run(lambda x: x.split("b")[0])
    run(lambda x: f"[{x}]")
    run(lambda x: f"{len(x):3}:{x}")
    stages = physical.plan_stages(
        ctx.parallelize(data).map(lambda x: x.split(" ")[2])._op)
    assert [s.force_interpret for s in stages] == [False]


def test_a_plan_time_fallback_is_routed_and_counted(files):
    """An operator with a fallback finding (print) is an interpreter
    segment with the analyzer's reason, counted in planFallbackOps; the
    reference plans and explains it alike."""
    def build(i, c):
        return c.text(files["log"]).map(lambda x: len(x)) \
            .map(lambda n: print(n) or n).map(lambda n: n + 1)

    ref, port = _plans(build, {})
    assert port == ref
    assert [interp for _, interp, _ in port] == [False, True, False]
    ctx = _port()
    ds = build(1, ctx)
    before = analyzer.STATS["plan_fallback_ops"]
    stages = physical.plan_stages(ds._op)
    assert analyzer.STATS["plan_fallback_ops"] - before == 1
    assert stages[1].route_reason.startswith(
        "plan-time fallback — <lambda>: I/O call (print) (")
    assert consumer_kinds(stages) == [False, "stage", False]


def consumer_kinds(stages):
    return [physical.consumer_kind(stages, i) for i in range(len(stages))]


# ---------------------------------------------------------------------------
# conjunction breakdown and pushdown within a stage
# ---------------------------------------------------------------------------

def test_conjunction_breakdown_on_z1(files):
    """A Z1 chain with an added `and`-filter: the filter splits into
    `#and0` and `#and1`, as in the reference, and the rows equal the
    loop's with the passes on and off."""
    def build(i, c):
        mod = (ref_zillow, zillow)[i]
        return mod.build_pipeline(c.csv(files["zillow"])).filter(
            lambda x: x["price"] > 100000 and x["bedrooms"] < 5)

    ref, port = _plans(build, {})
    assert port == ref
    names = [n for _, _, ops in port for _, n in ops if n and "#and" in n]
    assert names == ["<lambda>#and0", "<lambda>#and1"]
    ref_off, port_off = _plans(build, {"tuplex.optimizer.filterBreakdown":
                                       False})
    assert port_off == ref_off
    assert not any("#and" in (n or "") for _, _, ops in port_off
                   for _, n in ops)
    want = [r for r in zillow.run_reference_python(files["zillow"])
            if _z1_keep(r)]
    for conf in ({}, {PUSH: False}, {"tuplex.optimizer.filterBreakdown":
                                     False}):
        assert build(1, _port(conf)).collect() == want


def _z1_keep(row) -> bool:
    r = dict(zip(zillow.OUT_COLUMNS, row))
    return r["price"] > 100000 and r["bedrooms"] < 5


def test_pushdown_and_reordering_exception_counts_match_the_reference():
    """A filter pushed ahead of a withColumn that raises: its rows stop
    raising, in both packages alike; with pushdown off the counts are the
    loop's. Filter reordering (off by default) orders a run of filters by
    their pass rate, as the reference does."""
    data = [(i, 7 - i % 8) for i in range(400)]

    def build(c):
        return c.parallelize(data, columns=["a", "b"]) \
            .withColumn("q", lambda x: 100 // x["b"]) \
            .filter(lambda x: x["a"] % 8 != 7 and x["a"] > 5) \
            .filter(lambda x: x["a"] % 3 == 0)

    loop, loop_excs = [], {}
    for a, b in data:
        try:
            q = 100 // b
        except ZeroDivisionError:
            loop_excs["ZeroDivisionError"] = \
                loop_excs.get("ZeroDivisionError", 0) + 1
            continue
        if a % 8 != 7 and a > 5 and a % 3 == 0:
            loop.append((a, b, q))
    for conf in ({}, {PUSH: False},
                 {"tuplex.optimizer.operatorReordering": True}):
        rds, pds = build(_ref(conf)), build(_port(conf))
        rows = pds.collect()
        assert rows == rds.collect() == loop
        assert pds.exception_counts() == rds.exception_counts()
        if conf.get(PUSH) is False:
            assert pds.exception_counts() == loop_excs
        else:
            assert pds.exception_counts() == {}
        ref, port = (_signature(p) for p in (
            ref_physical.plan_stages(rds._op, rds._context.options_store),
            physical.plan_stages(pds._op, pds._context.options_store)))
        assert port == ref


# ---------------------------------------------------------------------------
# take, show, cache, options, explain
# ---------------------------------------------------------------------------

def _lines(path):
    return open(path, encoding="utf-8").read().splitlines()


def test_take_stops_at_the_dispatch_window(files, monkeypatch):
    """take(n) equals the loop's first n rows; the last stage dispatches
    no partition past the window after the one that met the limit, and
    the lazy source builds no more partitions than that."""
    built = []
    real = csvsource.TextSourceOperator.iter_partitions

    def counting(self):
        for p in real(self):
            built.append(p.num_rows)
            yield p

    monkeypatch.setattr(csvsource.TextSourceOperator, "iter_partitions",
                        counting)
    ctx = _port({"tuplex.partitionSize": "4KB"})   # 64 lines a partition
    ds = ctx.text(files["log"]).filter(
        lambda x: re.search(r"GET", x) is not None).map(lambda x: x[:20])
    want = [x[:20] for x in _lines(files["log"])
            if re.search(r"GET", x) is not None]
    assert ds.take(10) == want[:10]
    (m,) = ctx.metrics.stages
    assert m["dispatched_parts"] == len(built) == 1 + local._WINDOW
    assert m["dropped_parts"] == local._WINDOW
    assert len(built) < math.ceil(len(_lines(files["log"])) / 64)
    assert ds.take(len(want) + 5) == want
    assert ds.take(0) == []


def test_take_after_a_join_and_an_aggregate(files):
    ctx = _port({"tuplex.partitionSize": "16KB"})
    q19 = tpch.q19(ctx, files["part"], files["li19"])
    assert len(q19.take(1)) == 1
    fl = PIPELINES["flights"](flights, ctx, files)
    want = flights.run_reference_python(files["perf"], files["carrier"],
                                        files["airports"])
    assert fl.take(7) == want[:7]


def test_show_prints_the_references_format(files, capsys):
    def build(c):
        return c.text(files["log"]).map(
            lambda x: {"verb": x.split(" ")[5][1:], "n": len(x)})

    build(_ref()).show(5)
    ref_out = capsys.readouterr().out
    build(_port()).show(5)
    assert capsys.readouterr().out == ref_out
    _port().parallelize([1, 2, 3]).show()
    assert capsys.readouterr().out.splitlines()[-3:] == ["1", "2", "3"]


def test_cache_reads_the_source_once(files, monkeypatch):
    loads = []
    real = csvsource.TextSourceOperator.load_partitions

    def counting(self):
        loads.append(1)
        return real(self)

    monkeypatch.setattr(csvsource.TextSourceOperator, "load_partitions",
                        counting)
    ctx = _port({"tuplex.partitionSize": "16KB"})
    cached = ctx.text(files["log"]).filter(
        lambda x: re.search(r"GET", x) is not None).cache()
    assert len(loads) == 1
    kept = [x for x in _lines(files["log"])
            if re.search(r"GET", x) is not None]
    assert cached.map(lambda x: len(x)).collect() == [len(x) for x in kept]
    assert cached.map(lambda x: x.upper()).take(3) == \
        [x.upper() for x in kept[:3]]
    assert cached.collect() == kept and len(loads) == 1
    stages = physical.plan_stages(cached.map(lambda x: 1)._op)
    assert type(stages[0].source).__name__ == "CacheOperator"
    assert cached._op.deterministic
    boxed = ctx.text(files["log"]).cache(store_specialized=False)
    assert boxed.collect() == _lines(files["log"])


def test_a_cache_of_a_random_chain_is_not_deterministic():
    import random as rnd

    ctx = _port()
    ds = ctx.parallelize([1, 2, 3]).map(lambda x: x + rnd.random())
    assert not ds.cache()._op.deterministic
    assert analyzer.chain_deterministic(ctx.parallelize([1]).map(
        lambda x: x + 1)._op)


def test_options_match_the_reference(tmp_path):
    port, ref = _port(), tuplex_tpu.Context()
    p, r = port.options(), ref.options()
    # the port's keys are the reference's release values; filterBreakdown,
    # which the reference reads with a default of true, is listed too
    assert set(p) - set(r) == {"tuplex.optimizer.filterBreakdown"}
    assert {k: p[k] for k in p if k in r} == {k: r[k] for k in p if k in r}
    for k in ("tuplex.optimizer.filterPushdown",
              "tuplex.optimizer.operatorReordering",
              "tuplex.optimizer.selectionPushdown"):
        assert k in p
    assert p["tuplex.optimizer.filterBreakdown"] == "true"
    assert not any(k.startswith("tuplex.tpu.") for k in p)
    nested = port.options(nested=True)
    assert nested["tuplex"]["optimizer"]["filterPushdown"] == "true"
    path = str(tmp_path / "conf.yaml")
    _port({"optimizer": {"filterPushdown": False},
           "partitionSize": "1MB"}).optionsToYAML(path)
    again = Context(path, device="cpu")
    assert again.options_store.get_bool(PUSH, True) is False
    assert again.options_store.get_size("tuplex.partitionSize") == 1 << 20
    assert again.options() == {**p, PUSH: "false",
                               "tuplex.partitionSize": "1MB"}


def _normalized(text: str) -> list:
    return [re.sub(r"#\d+ ", "#N ", ln) for ln in text.splitlines()]


@pytest.mark.parametrize("name", ["flights", "q1", "routed"])
def test_explain_matches_the_reference(files, name, capsys):
    def build(i, c):
        if name == "routed":
            return c.text(files["log"]).map(lambda x: len(x)).map(
                lambda n: print(n) or n).map(lambda n: n + 1)
        return PIPELINES[name](MODELS[name][i], c, files)

    ref_text = build(0, _ref()).explain()
    port_text = build(1, _port()).explain()
    assert capsys.readouterr().out.endswith(port_text + "\n")
    ref_lines = [ln for ln in _normalized(ref_text)
                 if not ln.startswith(("  codegen", "  hazard", "  jaxpr",
                                       "  pre-degraded"))]
    assert _normalized(port_text) == ref_lines
    if name == "routed":
        assert any(ln.startswith("  routed: plan-time fallback")
                   for ln in ref_lines)


def test_to_dot_names_every_operator(files):
    ds = PIPELINES["q19"](tpch, _port(), files)
    dot = ds.to_dot()
    assert dot.startswith("digraph plan {") and dot.endswith("}")
    assert f"n{ds._op.id} [label=\"#{ds._op.id} " in dot
    assert dot.count("->") >= 4
