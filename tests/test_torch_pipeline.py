"""Whole pipelines through tuplex_tpu_torch.Context(device="cpu") against
the reference package and plain Python.

Oracles: `tuplex_tpu.Context().collect()` on the same input (the reference;
under the test harness's 8 forced host devices it may resolve rows through
its own interpreter, and its answer is still the reference) and a plain
Python loop; the compaction and fallback cases use the Python loop alone.
Tolerance: exact (rows, order, exception counts).
"""

import re

import jax  # noqa: F401  (configured for the CPU by conftest)
import numpy as np
import pytest
import torch

import tuplex_tpu
import tuplex_tpu_torch
from tuplex_tpu_torch.models import logs
from tuplex_tpu_torch.plan import physical
from tuplex_tpu_torch.runtime import columns as C


@pytest.fixture(autouse=True)
def _private_aot_store(tmp_path, monkeypatch):
    """The reference package keeps compiled stages in an on-disk store
    that every process of one HOME shares; this file's reference runs use
    a store of their own."""
    monkeypatch.setenv("TUPLEX_AOT_CACHE", str(tmp_path / "aot"))


def _port():
    return tuplex_tpu_torch.Context(device="cpu")


def test_dual_mode_smoke():
    ref = tuplex_tpu.Context()
    ref_ds = ref.parallelize([1, 2, None, 4]).map(lambda x: (x, x * x))
    ctx = _port()
    ds = ctx.parallelize([1, 2, None, 4]).map(lambda x: (x, x * x))
    got = ds.collect()
    assert got == [(1, 1), (2, 4), (4, 16)] == ref_ds.collect()
    assert ds.exception_counts() == ref_ds.exception_counts() \
        == {"TypeError": 1}
    # the None row raised TypeError on the compiled path, an exact class
    # in a stage without resolvers: the exact exit records it
    m = ctx.metrics
    assert m.interpreterRows() + m.generalRows() + m.exactExitRows() == 1
    assert m.interpreterRows() == 0 and m.exactExitRows() == 1
    assert ctx.metrics.deviceErrorRows() == 1
    assert ctx.metrics.totalExceptionCount == 1
    assert ctx.metrics.stages[-1]["tier"] == "compiled"


@pytest.mark.parametrize("op_id", [5, 1 << 23])
def test_error_lattice_matches_reference(op_id):
    """The #err lattice: the same exception-class codes as the reference,
    packed as class | op_id << 8 (ids that do not fit pack as 0)."""
    from tuplex_tpu.core import errors as ref_errors
    from tuplex_tpu_torch.core import errors as port_errors

    assert {c.name: int(c) for c in port_errors.ExceptionCode} == \
        {c.name: int(c) for c in ref_errors.ExceptionCode}
    code = int(port_errors.ExceptionCode.ZERODIVISIONERROR)
    assert port_errors.pack_device_code(code, op_id) == \
        ref_errors.pack_device_code(code, op_id)


def test_stage_error_codes():
    """Rows that raise carry their class and the raising operator's id."""
    data = [5, 0, 2, 0]
    ds = _port().parallelize(data).map(lambda x: 10 // x)
    stage = physical.plan_stages(ds._op)[0]
    part = C.build_partition(data, stage.input_schema)
    outs = stage.build_device_fn()(
        C.stage_partition(part, torch.device("cpu")).arrays)
    code = 1 | (ds._op.id << 8)      # ZERODIVISIONERROR from this map
    assert outs["#err"][:4].tolist() == [0, code, 0, code]
    assert outs["#keep"][:4].tolist() == [True, False, True, False]


def test_log_grep(tmp_path):
    path = str(tmp_path / "access.log")
    logs.generate_log(path, 3000, seed=17, non_ascii_every=250)
    want = logs.run_grep_reference(path)
    ctx = _port()
    got = logs.build_grep(ctx.text(path)).collect()
    assert got == want
    assert got == logs.build_grep(tuplex_tpu.Context().text(path)).collect()
    assert len(want) > 500
    # the non-ASCII lines left the compiled path at _ascii_guard and were
    # merged back in order from the interpreter (a text source has no
    # general-case decode)
    m = ctx.metrics
    assert m.interpreterRows() + m.generalRows() + m.exactExitRows() \
        == 3000 // 250
    assert m.interpreterRows() == 3000 // 250
    assert ctx.metrics.stages[-1]["tier"] == "compiled"


def test_generator_matches_reference(tmp_path):
    from tuplex_tpu.models import logs as ref_logs

    a, b = str(tmp_path / "a.log"), str(tmp_path / "b.log")
    logs.generate_log(a, 500, seed=17)
    ref_logs.generate_log(b, 500, seed=17)
    assert open(a).read() == open(b).read()


def test_filter_compaction():
    data = list(range(12000))
    want = [(2 * x, 2 * x // 7) for x in data if x % 10 == 3]
    ds = _port().parallelize(data).filter(lambda x: x % 10 == 3) \
        .map(lambda x: x * 2).map(lambda y: (y, y // 7))
    assert ds.collect() == want
    # the stage function did compact after the filter
    stage = physical.plan_stages(ds._op)[0]
    part = C.build_partition(data, stage.input_schema)
    batch = C.stage_partition(part, torch.device("cpu"))
    outs = stage.build_device_fn(compaction=True)(batch.arrays)
    assert "#rowidx" in outs and not bool(outs["#overflow"])
    assert outs["0"].shape[0] < batch.b


def test_compaction_overflow_reruns_without_compaction():
    """The sample (first 1000 rows) sees no survivors; the data has many:
    the compacted batch overflows and the partition re-runs plain."""
    data = [0] * 1000 + [3] * 11000
    ds = _port().parallelize(data).filter(lambda x: x == 3) \
        .map(lambda x: x + 1).map(lambda y: (y, -y))
    assert ds.collect() == [(4, -4)] * 11000


def test_device_exception_resolves_like_reference():
    data = [5, 0, 2, 0, -3]
    ref_ds = tuplex_tpu.Context().parallelize(data).map(lambda x: 10 // x)
    ctx = _port()
    ds = ctx.parallelize(data).map(lambda x: 10 // x)
    assert ds.collect() == ref_ds.collect() == [2, 5, -4]
    assert ds.exception_counts() == ref_ds.exception_counts() \
        == {"ZeroDivisionError": 2}
    m = ctx.metrics
    assert m.interpreterRows() + m.generalRows() + m.exactExitRows() == 2
    assert m.interpreterRows() == 0


@pytest.mark.parametrize("kind", ["method", "anchored-regex"])
def test_not_compilable_interprets_like_reference(kind):
    rows = ["GET /a", "post /b", "GET /c", "héllo", ""]
    if kind == "method":
        def build(ds):
            return ds.map(lambda s: s.title())
    else:
        # the anchored engine compiles `re.search("^GET", s)` itself
        # (tests/test_torch_regex.py); a match's .start() stays outside
        def build(ds):
            return ds.filter(lambda s: re.search("^GET", s).start() == 0)
    ctx = _port()
    got = build(ctx.parallelize(rows)).collect()
    assert got == build(tuplex_tpu.Context().parallelize(rows)).collect()
    assert ctx.metrics.stages[-1]["tier"] == "interpreter"
    m = ctx.metrics
    assert m.interpreterRows() + m.generalRows() + m.exactExitRows() \
        == len(rows)
    assert m.interpreterRows() == len(rows)


def test_fallback_rows():
    """Rows outside the speculated normal case (a str among ints) keep their
    slot and resolve on the interpreter."""
    data = [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, "11"]
    ctx = _port()
    got = ctx.parallelize(data).map(lambda x: x * 2).collect()
    assert got == [2 * x for x in data]
    m = ctx.metrics
    assert m.interpreterRows() + m.generalRows() + m.exactExitRows() == 1
    assert m.interpreterRows() == 1


def test_byte_matrix_encoding():
    values = ["", "ab", "é", "x" * 9]
    leaf = C.encode_str_leaf(values, False)
    assert leaf.bytes.shape == (4, 9) and leaf.bytes.flags.writeable
    assert leaf.lengths.tolist() == [0, 2, 2, 9]
    assert C._leaf_to_pylist(leaf, 4) == values
    np.testing.assert_array_equal(leaf.bytes[1, :3], [97, 98, 0])


def _client_and_len(line):
    i = line.find(" ")
    ip = line[:i]
    n = len(ip)
    n += 1
    return ip, n - 1


def test_straight_line_def_udf():
    rows = ["1.2.3.4 - x", "no-space", "", "a b", "10.0.0.1 GET"]
    ctx = _port()
    got = ctx.parallelize(rows).map(_client_and_len).collect()
    assert got == [_client_and_len(r) for r in rows]
    assert ctx.metrics.stages[-1]["tier"] == "compiled"
    assert ctx.metrics.interpreterRows() == 0
