"""The weblogs pipelines and the status grep through tuplex_tpu_torch on
the CPU, against their plain Python loops and the reference package.

Oracles: `run_reference_python` (the reference's loop, copied), the status
grep's loop, and one module-scoped `tuplex_tpu.Context()` run of each
weblogs variant at 2,000 lines. Tolerance: exact (rows, order and types).
The interpreter rows are held to the reference's: none for the strip
variant, at most the reference's for the regex variant (the rows its
anchored engine marks suspect), none for a filter on a truth value.
"""

import re

import pytest

import tuplex_tpu
import tuplex_tpu_torch
from tuplex_tpu.models import logs as ref_logs
from tuplex_tpu_torch.models import logs
from tuplex_tpu_torch.ops import nfa_cuda, regex as port_regex


@pytest.fixture(autouse=True)
def _private_aot_store(tmp_path, monkeypatch):
    """The reference package keeps compiled stages in an on-disk store
    that every process of one HOME shares; this file's reference runs use
    a store of their own. They compile in the test's own process: the
    reference's default on the CPU, a forked compile child per stage,
    forks a process that torch's threads already run in."""
    monkeypatch.setenv("TUPLEX_AOT_CACHE", str(tmp_path / "aot"))
    monkeypatch.setenv("TUPLEX_COMPILE_ISOLATION", "thread")


@pytest.fixture(scope="module")
def log5k(tmp_path_factory):
    return logs.generate_log(str(tmp_path_factory.mktemp("logs") /
                                 "access.log"), 5000, seed=17)


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    """The reference package's weblogs runs at 2,000 lines: (path,
    {mode: (rows, interpreter rows)})."""
    d = tmp_path_factory.mktemp("ref")
    mp = pytest.MonkeyPatch()
    mp.setenv("TUPLEX_AOT_CACHE", str(d / "aot"))
    mp.setenv("TUPLEX_COMPILE_ISOLATION", "thread")
    try:
        path = logs.generate_log(str(d / "access.log"), 2000, seed=17,
                                 non_ascii_every=500)
        out = {}
        for mode in ("strip", "regex"):
            ctx = tuplex_tpu.Context()
            rows = ref_logs.build_pipeline(ctx.text(path), mode).collect()
            interp = sum(int(m.get("resolve_interpreter_rows", 0))
                         for m in ctx.metrics.stages)
            out[mode] = (rows, interp)
    finally:
        mp.undo()
    return path, out


def _types(rows):
    return [tuple(type(v) for v in r) for r in rows]


@pytest.mark.parametrize("mode,limit", [("strip", 0), ("regex", 157)])
def test_weblogs_on_the_cpu(log5k, mode, limit):
    """5,000 lines of seed 17: rows, order and types equal the loop; the
    strip variant interprets no row (a dict row compiles), the regex
    variant at most the 157 lines its engine marks suspect."""
    ctx = tuplex_tpu_torch.Context(device="cpu")
    calls = port_regex.calls
    got = logs.build_pipeline(ctx.text(log5k), mode).collect()
    want = logs.run_reference_python(log5k, mode)
    assert got == want and _types(got) == _types(want)
    assert len(got) == 4843
    assert ctx.metrics.interpreterRows() <= limit
    assert (port_regex.calls > calls) == (mode == "regex")


@pytest.mark.parametrize("mode", ["strip", "regex"])
def test_weblogs_equal_reference_package(reference_runs, mode):
    path, ref = reference_runs
    ref_rows, ref_interp = ref[mode]
    ctx = tuplex_tpu_torch.Context(device="cpu")
    got = logs.build_pipeline(ctx.text(path), mode).collect()
    assert got == ref_rows == logs.run_reference_python(path, mode)
    assert _types(got) == _types(ref_rows)
    # the 4 non-ASCII lines interpret in the port (byte-indexed strings)
    assert ctx.metrics.interpreterRows() <= ref_interp + 4
    if mode == "strip":
        assert ctx.metrics.interpreterRows() == 4
    else:
        assert ctx.metrics.interpreterRows() - 4 == _suspect_rows(path)


def _suspect_rows(path):
    """Rows the anchored engine marks suspect and unmatched, over the
    file's ASCII lines."""
    import torch

    from tuplex_tpu_torch.runtime import columns as C

    with open(path, encoding="utf-8") as fp:
        lines = [ln for ln in fp.read().splitlines() if ln.isascii()]
    leaf = C.encode_str_leaf(lines, False)
    rx = port_regex.compile_regex(logs.WEBLOGS_REGEX)
    m, s, _, _ = rx.match(torch.from_numpy(leaf.bytes.copy()),
                          torch.from_numpy(leaf.lengths))
    return int((s & ~m).sum())


def test_status_grep(tmp_path):
    path = logs.generate_log(str(tmp_path / "access.log"), 3000, seed=17,
                             non_ascii_every=1000)
    ctx = tuplex_tpu_torch.Context(device="cpu")
    calls = port_regex.calls
    launches = (nfa_cuda.start_launches, nfa_cuda.launches)
    got = logs.build_status_grep(ctx.text(path)).collect()
    want = logs.run_status_grep_reference(path)
    assert got == want and _types(got) == _types(want)
    assert all(s in (400, 404) for _, s in got) and len(got) > 500
    # only the 3 non-ASCII lines interpret; the groups ran the engine
    assert ctx.metrics.interpreterRows() == 3
    assert port_regex.calls > calls
    # on CPU tensors no kernel launches
    assert (nfa_cuda.start_launches, nfa_cuda.launches) == launches


def test_truth_value_filter_interprets_nothing(log5k):
    ctx = tuplex_tpu_torch.Context(device="cpu")
    got = ctx.text(log5k).filter(
        lambda x: re.search(r'GET /images', x)).collect()
    with open(log5k, encoding="utf-8") as fp:
        want = [ln for ln in fp.read().splitlines()
                if re.search(r'GET /images', ln)]
    assert got == want and len(got) > 0
    assert ctx.metrics.interpreterRows() == 0


@pytest.mark.parametrize("kind", ["strip", "regex", "status"])
def test_stage_plans_the_reference_tier(log5k, kind):
    """The analyzer's new sites: re.search on None (TypeError), .group on
    a None match (AttributeError) and the engine's suspects
    (PYTHON_FALLBACK); with them the stage plans the reference's tier."""
    from tuplex_tpu.plan import physical as ref_physical
    from tuplex_tpu_torch.core.errors import ExceptionCode as EC
    from tuplex_tpu_torch.plan import physical

    def build(mod, ctx):
        ds = ctx.text(log5k)
        return logs.build_status_grep(ds) if kind == "status" \
            else mod.build_pipeline(ds, kind)

    ref = ref_physical.plan_stages(build(ref_logs, tuplex_tpu.Context())._op)
    port = physical.plan_stages(
        build(logs, tuplex_tpu_torch.Context(device="cpu"))._op)
    assert [s.resolve_plan().tier for s in port] == \
        [s.resolve_plan().tier for s in ref]
    codes = set(port[0].resolve_plan().codes)
    regex_sites = {int(EC.TYPEERROR), int(EC.ATTRIBUTEERROR),
                   int(EC.PYTHON_FALLBACK)}
    assert (regex_sites <= codes) == (kind != "strip")
