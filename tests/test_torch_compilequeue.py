"""The compile plane (tuplex_tpu_torch/exec/compilequeue.py) on the CPU:
its stand-in for CUDA graphs (static inputs copied in, the closure re-run,
outputs copied into static buffers and cloned out), its content address,
its store, and its declines.

Oracles: a plain Python loop over the same rows and the eager path
(`compilequeue.eager()`, the dispatch before the plane). Tolerance: exact
(rows, order, exception records and counts). Small inputs, no waits, no
processes.
"""

import contextlib
import gc
import linecache
import sys
import types

import numpy as np
import pytest
import torch

import tuplex_tpu_torch
from tuplex_tpu_torch.core import typesys as T
from tuplex_tpu_torch.exec import compilequeue as CQ
from tuplex_tpu_torch.models import logs
from tuplex_tpu_torch.ops import regex
from tuplex_tpu_torch.plan import physical
from tuplex_tpu_torch.runtime import columns as C

CONF = {"tuplex.partitionSize": "8KB"}   # 1,024 int rows a partition
SCALE = 3


@pytest.fixture(autouse=True)
def _fresh_store():
    """Every test starts from an empty store and zeroed counts."""
    CQ.clear()
    yield
    CQ.clear()


def _ctx():
    return tuplex_tpu_torch.Context(device="cpu", conf=CONF)


def _job(ctx, data):
    return ctx.parallelize(data).map(lambda x: x * SCALE + 1) \
        .filter(lambda y: y % 5 != 0)


def test_second_job_captures_nothing():
    """Three partitions of one bucket: one capture, two replays; a fresh
    job of the same pipeline finds the graph (a dedup hit) and captures
    nothing, and compileTime() is 0 there."""
    data = list(range(3 * 1024))
    want = [x * SCALE + 1 for x in data if (x * SCALE + 1) % 5 != 0]
    c1 = _ctx()
    assert _job(c1, data).collect() == want
    m = c1.metrics
    assert (m.stageCompileCount(), m.graphReplays(), m.graphDeclines()) \
        == (1, 2, {})
    assert m.compileTime() > 0.0
    assert m.stages[0]["capture_dispatches"] == 1
    c2 = _ctx()
    assert _job(c2, data).collect() == want
    m2 = c2.metrics
    assert (m2.stageCompileCount(), m2.graphReplays(), m2.compileTime()) \
        == (0, 3, 0.0)
    assert m2.stages[0]["dedup_hits"] == 1 and len(CQ.STORE) == 1


def _stage_and_part(data, schema=None):
    ds = _ctx().parallelize(data, schema=schema).map(lambda x: x).filter(
        lambda x: x is not None)
    stage = physical.plan_stages(ds._op)[0]
    return stage, C.build_partition(data, stage.input_schema)


def _key(stage, part, **kw):
    flags = CQ._flags(stage, part, torch.device("cpu"),
                      kw.pop("compaction", False), kw.pop("fold", True))
    flags.update(kw)
    return CQ.fingerprint_stage(stage, C.host_arrays(part), flags)


def test_shapes_flags_and_schema_give_new_keys():
    """The key moves with the bucket, a string width, the compaction and
    fold flags and the schema, and stays for equal content."""
    s1, p1 = _stage_and_part(["ab", "cd"] * 50)
    s2, p2 = _stage_and_part(["ab", "cd"] * 50)
    base = _key(s1, p1)
    assert _key(s2, p2) == base                     # another job, same key
    assert _key(s1, C.build_partition(["ab"] * 300, s1.input_schema)) \
        != base                                     # another bucket
    assert _key(s1, C.build_partition(["a" * 40] * 100, s1.input_schema)) \
        != base                                     # a wider string bucket
    assert _key(s1, p1, compaction=True) != base
    assert _key(s1, p1, fold=False) == base         # no fold: no flag
    assert _key(s1, p1, schema="Row['x':i64]") != base
    s3, p3 = _stage_and_part([1, 2, 3] * 40)
    floats = C.build_partition([1.5, 2.5, 3.5] * 40,
                               T.row_of(["_0"], [T.F64]))
    assert _key(s3, p3) != _key(s3, floats)          # another dtype
    assert _key(s3, p3) != _key(s3, floats, schema=p3.schema.name)


def test_fold_flag_is_part_of_the_key(tmp_path):
    from tuplex_tpu_torch.models import tpch

    path = str(tmp_path / "li.csv")
    tpch.generate_csv(path, 400, seed=7)
    ds = tpch.q6(_ctx().csv(path))
    stage = physical.plan_stages(ds._op)[0]
    assert stage.fold_spec is not None
    part = stage.source.load_partitions()[0]
    assert _key(stage, part) != _key(stage, part, fold=False)


def _closure_job(ctx, data, k):
    return ctx.parallelize(data).map(lambda x: x * k)


K = 3


def _global_job(ctx, data):
    return ctx.parallelize(data).map(lambda x: x + K)


def test_closure_values_and_globals_never_share_a_graph():
    """Equal code, other closure values; a module global changed between
    two jobs: each job equals its loop and captures its own graph."""
    global K
    data = list(range(2048))
    for k in (2, 7):
        ctx = _ctx()
        assert _closure_job(ctx, data, k).collect() == [x * k for x in data]
        assert ctx.metrics.stageCompileCount() == 1
    for k in (3, 11):
        K = k
        ctx = _ctx()
        assert _global_job(ctx, data).collect() == [x + k for x in data]
        assert ctx.metrics.stageCompileCount() == 1
    assert len(CQ.STORE) == 4


def _join_job(ctx, left, right):
    r = ctx.parallelize(right, columns=["k", "name"])
    return ctx.parallelize(left, columns=["k", "v"]) \
        .map(lambda t: (t["k"] % 13, t["v"] * 2)) \
        .join(r.map(lambda t: (t["k"], t["name"])), "_0", "_0") \
        .map(lambda t: (t[0] + t[1], t[2]))     # (v * 2 + key, name)


def test_replayed_outputs_are_copies():
    """A join hands its partitions to the stage after it as device views;
    that stage and the first replay the same graph on later partitions
    while two partitions are in flight. Every row equals the eager path's
    and the loop's: an output that were the graph's own buffer would be
    overwritten by the next replay."""
    left = [(i, i % 97) for i in range(6 * 512)]
    right = [(k, f"n{k}") for k in range(13)]
    with CQ.eager():
        ctx = _ctx()
        eager_rows = _join_job(ctx, left, right).collect()
    ctx = _ctx()
    rows = _join_job(ctx, left, right).collect()
    want = [(v * 2 + k % 13, f"n{k % 13}") for k, v in left]
    assert rows == eager_rows == want
    stages = ctx.metrics.stages
    assert ctx.metrics.graphDeclines() == {}
    assert stages[0]["graph_replays"] >= 2
    assert stages[-2]["handoff_parts"] >= 3          # the join's views
    assert stages[-1]["graph_replays"] >= 2


def test_overflow_rerun_is_a_key_of_its_own():
    """The sample sees no survivor, the data many: the compacted batch
    overflows, the partition re-runs without compaction under its own
    key, and the stage keeps compaction off; a second job replays."""
    data = [0] * 1000 + [3] * 11000

    def job(ctx):
        return ctx.parallelize(data).filter(lambda x: x == 3) \
            .map(lambda x: x + 1).map(lambda y: (y, -y))

    c1 = tuplex_tpu_torch.Context(device="cpu")
    assert job(c1).collect() == [(4, -4)] * 11000
    assert c1.metrics.stageCompileCount() == 2
    assert c1.metrics.graphDeclines() == {}
    c2 = tuplex_tpu_torch.Context(device="cpu")
    assert job(c2).collect() == [(4, -4)] * 11000
    assert c2.metrics.stageCompileCount() == 0


@pytest.mark.parametrize("hazard", ["host_sync", "h2d_copy"])
def test_a_stage_that_waits_declines(monkeypatch, hazard):
    """A stage function that reads a device value on the host, or copies
    host data to the device, while it runs cannot be captured: every
    partition runs eagerly, counted by reason, with the loop's rows."""
    real = physical._emit_op

    def emit(ctx, op, row, keep):
        if hazard == "host_sync":
            bool(keep.any())
        else:
            keep = keep & torch.tensor([True], device=keep.device)
        return real(ctx, op, row, keep)

    monkeypatch.setattr(physical, "_emit_op", emit)
    data = list(range(3 * 1024))
    ctx = _ctx()
    assert _job(ctx, data).collect() == \
        [x * SCALE + 1 for x in data if (x * SCALE + 1) % 5 != 0]
    m = ctx.metrics
    assert m.graphDeclines() == {hazard: 3}
    assert (m.stageCompileCount(), m.graphReplays()) == (0, 0)
    assert [why[0] for why in CQ.declines().values()] == [hazard]


def test_a_host_scalar_is_no_copy(monkeypatch):
    """A factory that names no device makes a host tensor, on the card as
    on the CPU: a 0-d one used beside device tensors is a scalar argument,
    no copy, and the stage is captured and replayed."""
    real = physical._emit_op

    def emit(ctx, op, row, keep):
        return real(ctx, op, row, keep & torch.tensor(True))

    monkeypatch.setattr(physical, "_emit_op", emit)
    data = list(range(3 * 1024))
    ctx = _ctx()
    assert _job(ctx, data).collect() == \
        [x * SCALE + 1 for x in data if (x * SCALE + 1) % 5 != 0]
    m = ctx.metrics
    assert (m.stageCompileCount(), m.graphReplays(), m.graphDeclines()) \
        == (1, 2, {})


def test_exceptions_name_the_later_jobs_operators():
    """A replay under other operator ids moves the ids packed into '#err':
    each job's exception records name its own operator, as eagerly."""
    data = [5, 0, 2, 0, -3] * 300
    for _ in range(2):
        ctx = _ctx()
        ds = ctx.parallelize(data).map(lambda x: 10 // x)
        assert ds.collect() == [10 // x for x in data if x]
        assert {(e.op_id, e.exc_name) for e in ds._last_exceptions} == \
            {(ds._op.id, "ZeroDivisionError")}
        assert ds.exception_counts() == {"ZeroDivisionError": 600}
    # two keys, 1,024 rows, then 476: each found by the second job
    assert CQ.STATS["stage_compiles"] == CQ.STATS["dedup_hits"] == 2


def test_store_evicts_the_least_recently_used_by_bytes(monkeypatch):
    """With room for about one graph, each job's capture evicts the one
    before; the rows stay the loop's, and a job whose graph was evicted
    captures again."""
    data = list(range(1024))
    for k in (2, 3):
        assert _closure_job(_ctx(), data, k).collect() == \
            [x * k for x in data]
    one = max(g.nbytes for g in CQ.STORE.graphs())
    monkeypatch.setattr(CQ.STORE, "capacity", one + one // 2)
    assert _closure_job(_ctx(), data, 5).collect() == [x * 5 for x in data]
    assert len(CQ.STORE) == 1 and CQ.STORE.nbytes <= one + one // 2
    assert CQ.STORE.evictions == 2
    ctx = _ctx()
    assert _closure_job(ctx, data, 2).collect() == [x * 2 for x in data]
    assert ctx.metrics.stageCompileCount() == 1


def test_engine_calls_count_replays(tmp_path):
    """The anchored engine's `calls` (and the kernels' launch counters on
    the card) move on a replay as they would eagerly."""
    path = str(tmp_path / "a.log")
    logs.generate_log(path, 1500, seed=17)
    conf = {"tuplex.partitionSize": "64KB"}
    counts = []
    for mode in ("eager", "capture", "replay"):
        before = regex.calls
        ctx = tuplex_tpu_torch.Context(device="cpu", conf=conf)
        with CQ.eager() if mode == "eager" else contextlib.nullcontext():
            rows = logs.build_status_grep(ctx.text(path)).collect()
        assert rows == logs.run_status_grep_reference(path)
        counts.append(regex.calls - before)
    assert counts[0] > 0 and counts[0] == counts[1] == counts[2]
    assert ctx.metrics.stageCompileCount() == 0
    assert ctx.metrics.graphReplays() > 0 and ctx.metrics.graphDeclines() == {}


def test_host_and_view_partitions_share_a_key():
    """A host partition keys on its padded host arrays, a handed-off one on
    its view's tensors: the same layout gives the same key, so a stage fed
    both ways replays one graph."""
    rng = np.random.default_rng(5)
    data = [(int(x), None if x % 3 == 0 else f"s{x}" * int(x % 4))
            for x in rng.integers(0, 100, size=300)]
    ds = _ctx().parallelize(data, columns=["a", "b"]).map(
        lambda t: (t["a"] + 1, t["b"]))
    stage = physical.plan_stages(ds._op)[0]
    part = C.build_partition(data, stage.input_schema)
    host = C.host_arrays(part)
    view = C.stage_partition(part, torch.device("cpu"), host=host).arrays
    assert {k: (a.shape, str(a.dtype)) for k, a in host.items()} == \
        {k: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
         for k, t in view.items()}
    flags = CQ._flags(stage, part, torch.device("cpu"), False, True)
    assert CQ.fingerprint_stage(stage, host, flags) == \
        CQ.fingerprint_stage(stage, view, flags)


def test_helpers_of_a_module_without_a_file_key_by_content(monkeypatch):
    """`__main__` has no `__file__` in a notebook, a REPL or `python -c`:
    a helper defined there and redefined between two jobs is user code,
    keyed by its content. Each job equals its loop and captures its own
    graph."""
    mod = types.ModuleType("cq_notebook")
    monkeypatch.setitem(sys.modules, mod.__name__, mod)

    def cell(n, src):
        name = f"<cq-cell-{n}>"
        monkeypatch.setitem(linecache.cache, name,
                            (len(src), None, src.splitlines(True), name))
        exec(compile(src, name, "exec"), mod.__dict__)

    cell(1, "def helper(x):\n    return x * 3 + 1\n")
    cell(2, "def udf(x):\n    return helper(x) - 1\n")
    data = list(range(2048))
    for n, f in ((3, lambda x: x * 3), (4, lambda x: x * 5 - 3)):
        ctx = _ctx()
        assert ctx.parallelize(data).map(mod.udf).collect() == \
            [f(x) for x in data]
        assert ctx.metrics.stageCompileCount() == 1
        cell(n, "def helper(x):\n    return x * 5 - 2\n")
    assert len(CQ.STORE) == 2


@pytest.mark.parametrize("job", ["strip", "regex", "status grep"])
def test_a_job_leaves_no_tensor_in_a_cycle(tmp_path, job):
    """A captured stage's intermediate tensors die with its graph: none is
    held by a reference cycle, which would keep their blocks of a graph
    pool on the card until the cyclic collector ran, past the graph's
    eviction. Checked with the collector off during the job, then every
    unreachable object kept for inspection."""
    path = str(tmp_path / "a.log")
    logs.generate_log(path, 1500, seed=17)
    conf = {"tuplex.partitionSize": "32KB"}
    gc.collect()
    gc.disable()
    try:
        ctx = tuplex_tpu_torch.Context(device="cpu", conf=conf)
        ds = ctx.text(path)
        ds = logs.build_status_grep(ds) if job == "status grep" else \
            logs.build_pipeline(ds, job)
        assert ds.collect()
        assert ctx.metrics.graphReplays() > 0
        CQ.clear()
        gc.set_debug(gc.DEBUG_SAVEALL)
        gc.collect()
        held = [tuple(o.shape) for o in gc.garbage
                if isinstance(o, torch.Tensor)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()
    assert held == []
