"""The join of tuplex_tpu_torch (plan/joins.py, exec/joinexec.py,
ops/join.py), the API methods that came with it (renameColumn, resolve,
ignore), the string methods the flights pipeline compiles (strip, format,
float(), string.capwords), and TPC-H Q19, on the CPU.

Oracles, named in each test: the reference package's numpy
`key_signature_matrix` and `_pack_sig_words`; its `_build_probe_fn`
through jax.jit on the CPU; `tuplex_tpu.Context()`, whose join on the CPU
takes its host path (its device join is not an oracle, ROADMAP C6); a plain
Python loop; CPython; `run_reference_q19`. Tolerance: exact, except Q19's
float sum (within 1e-9 relative: partials are summed per partition).
"""

import math
import random
import string

import jax  # noqa: F401  (configured for the CPU by conftest)
import numpy as np
import pytest
import torch

import tuplex_tpu
import tuplex_tpu_torch
from tuplex_tpu.core import typesys as RT
from tuplex_tpu.exec import joinexec as ref_joinexec
from tuplex_tpu.models import tpch as ref_tpch
from tuplex_tpu.runtime import columns as RC
from tuplex_tpu_torch.core import typesys as T
from tuplex_tpu_torch.models import tpch
from tuplex_tpu_torch.ops import join as J
from tuplex_tpu_torch.plan.physical import JoinStage, plan_stages
from tuplex_tpu_torch.runtime import columns as C

CONF = {"tuplex.partitionSize": "4KB"}   # several partitions a side


@pytest.fixture(autouse=True)
def _private_aot_store(tmp_path, monkeypatch):
    """The reference package keeps compiled stages in an on-disk store
    that every process of one HOME shares; this file's reference runs use
    a store of their own, compiled in the test's own process."""
    monkeypatch.setenv("TUPLEX_AOT_CACHE", str(tmp_path / "aot"))
    monkeypatch.setenv("TUPLEX_COMPILE_ISOLATION", "thread")


def _port():
    return tuplex_tpu_torch.Context(CONF, device="cpu")


# ---------------------------------------------------------------------------
# signatures, packing and the probe
# ---------------------------------------------------------------------------

def _leaves(rng, n: int, kind: str):
    """(port leaf, reference leaf, port type, reference type) over the same
    arrays: None slots with garbage under them, -0.0, stale bytes past the
    lengths."""
    valid = rng.random(n) > 0.2
    if kind == "str":
        w = int(rng.integers(1, 13))
        b = rng.integers(0, 256, size=(n, w)).astype(np.uint8)
        ln = rng.integers(0, w + 1, size=n).astype(np.int32)
        return (C.StrLeaf(b, ln, valid), RC.StrLeaf(b, ln, valid),
                T.option(T.STR), RT.option(RT.STR))
    if kind == "f64":
        d = rng.choice([0.0, -0.0, 1.5, -2.25, 1e300], size=n)
        return (C.NumericLeaf(d, valid), RC.NumericLeaf(d, valid),
                T.option(T.F64), RT.option(RT.F64))
    if kind == "i64":
        d = rng.integers(-2**63, 2**63 - 1, size=n, dtype=np.int64)
        return (C.NumericLeaf(d, None), RC.NumericLeaf(d, None), T.I64,
                RT.I64)
    d = rng.random(n) > 0.5
    return (C.NumericLeaf(d, valid), RC.NumericLeaf(d, valid),
            T.option(T.BOOL), RT.option(RT.BOOL))


@pytest.mark.parametrize("kinds", [("str",), ("f64",), ("i64",), ("bool",),
                                   ("str", "i64", "f64"), ("str", "str")])
def test_key_signatures_and_words_match_reference(kinds):
    """Oracle: the reference's numpy key_signature_matrix and
    _pack_sig_words on partitions over the same arrays."""
    rng = np.random.default_rng(len(kinds) * 7 + len(kinds[0]))
    n = 257
    cols = [_leaves(rng, n, k) for k in kinds]
    names = [f"c{i}" for i in range(len(kinds))]
    port = C.Partition(T.row_of(names, [c[2] for c in cols]), n,
                       {str(i): c[0] for i, c in enumerate(cols)})
    ref = RC.Partition(RT.row_of(names, [c[3] for c in cols]), n,
                       {str(i): c[1] for i, c in enumerate(cols)})
    cis = list(range(len(kinds)))
    got = C.key_signature_matrix(port, cis)
    want = RC.key_signature_matrix(ref, cis)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    words = C.pack_sig_words(got).numpy().view(np.uint64)
    np.testing.assert_array_equal(words, ref_joinexec._pack_sig_words(want))


def test_nan_float_keys_have_no_signature():
    """Oracle: the reference's key_signature_matrix (NaN != NaN)."""
    d = np.array([1.0, float("nan")])
    port = C.Partition(T.row_of(["k"], [T.F64]), 2, {"0": C.NumericLeaf(d)})
    ref = RC.Partition(RT.row_of(["k"], [RT.F64]), 2,
                       {"0": RC.NumericLeaf(d)})
    assert C.key_signature_matrix(port, [0]) is None
    assert RC.key_signature_matrix(ref, [0]) is None


def _probe_case(nw: int, u: int, case: str, seed: int):
    """Sorted unique build words (unsigned order, top bits set and clear)
    and probe words: build rows, rows that differ in the last word only,
    and random rows; 'miss' keeps only rows equal to no build row; 'runs'
    gives the build rows' first words three values and 'same' one (runs
    of equal first words, as long string keys with a common 8-byte prefix
    give); 'ends' adds probes below the first build row and above the
    last."""
    rng = np.random.default_rng(seed)
    build = rng.integers(0, 2**64 - 1, size=(u, nw), dtype=np.uint64)
    if case in ("runs", "same"):
        firsts = rng.integers(0, 2**64 - 1, size=3 if case == "runs" else 1,
                              dtype=np.uint64)
        build[:, 0] = firsts[rng.integers(0, len(firsts), size=u)]
    build = np.unique(build, axis=0)
    b = 300
    probe = build[rng.integers(0, len(build), size=b)].copy()
    near = rng.random(b) < 0.3
    probe[near, -1] += np.uint64(1)
    rand = rng.random(b) < 0.3
    probe[rand] = rng.integers(0, 2**64 - 1, size=(int(rand.sum()), nw),
                               dtype=np.uint64)
    probe[:2] = build[[0, -1]]
    if case != "miss":
        probe[2] = 0
        probe[3] = np.uint64(2**64 - 1)
        probe[4] = build[0]
        probe[4, 0] -= np.uint64(probe[4, 0] > 0)
    if case == "miss":
        keep = ~(probe[:, None, :] == build[None, :, :]).all(-1).any(-1)
        probe = probe[keep]
    return build, probe


@pytest.mark.parametrize("nw", [1, 2, 3])
@pytest.mark.parametrize("u,case", [(1, "hit"), (1, "miss"), (7, "hit"),
                                    (300, "hit"), (300, "miss"),
                                    (300, "runs"), (64, "same"),
                                    (300, "ends")])
def test_probe_matches_reference(nw, u, case):
    """Oracle: the reference's _build_probe_fn(u, nw) through jax.jit on
    the CPU. join_probe's CPU route (the kernel's plain version over the
    default index), the plain version over every index layout the kernel
    reads (few radix bits, fences every 1, 2, 4, 8 and 32 first words),
    and the plain whole-row binary search."""
    build, probe = _probe_case(nw, u, case, seed=nw * 1000 + u)
    u = len(build)
    want_pos, want_m = ref_joinexec._build_probe_fn(u, nw)(probe, build)
    want_pos, want_m = np.asarray(want_pos), np.asarray(want_m)
    if case == "miss":
        assert not want_m.any()
    tw = torch.from_numpy(probe.view(np.int64))
    tb = torch.from_numpy(build.view(np.int64))
    got = [J.join_probe(tw, J.probe_index(tb)), J.lower_bound_plain(tw, tb)]
    got += [J.lower_bound_index_plain(tw, J.probe_index(tb, bits, gs))
            for bits, gs in ((1, 0), (3, 1), (2, 2), (4, 3), (6, 5))]
    for pos, matched in got:
        np.testing.assert_array_equal(pos.numpy(), want_pos)
        np.testing.assert_array_equal(matched.numpy(), want_m)


def test_probe_index_layouts():
    """probe_index's default layout: every first word a fence while the
    fences fit a block's shared memory beside the radix table, else the
    smallest group that fits; the radix table counts the fences below
    each bucket. Oracle: numpy over the same words."""
    rng = np.random.default_rng(3)
    for u, group in ((9300, 1), (28_030, 1), (28_031, 2), (200_000, 8),
                     (300_000, 16)):
        first = np.sort(rng.choice(2**62, size=u, replace=False)) + 2**62
        words = torch.from_numpy(first.astype(np.int64)[:, None])
        index = J.probe_index(words)
        assert 1 << index.group_shift == group
        assert (index.radix_words + index.fence_words) * 8 <= \
            J.SHARED_BYTES
        fences = first[::group]
        np.testing.assert_array_equal(index.fences.numpy(), fences)
        assert index.shift == 64 - int(first[0] ^ first[-1]).bit_length()
        bucket = (fences >> index.down) & ((1 << index.bits) - 1)
        np.testing.assert_array_equal(
            index.radix.numpy(),
            np.searchsorted(np.sort(bucket), np.arange((1 << index.bits)
                                                       + 1)))


# ---------------------------------------------------------------------------
# join semantics
# ---------------------------------------------------------------------------

def _loop_join(left, right, lk, rk, how):
    """The plain loop: a dict of lists over the right rows, the left rows
    in order."""
    build = {}
    for r in right:
        build.setdefault(r[rk], []).append(r)
    out = []
    for r in left:
        lv = tuple(v for i, v in enumerate(r) if i != lk)
        ms = build.get(r[lk], [])
        for m in ms:
            out.append(lv + (r[lk],) + tuple(
                v for i, v in enumerate(m) if i != rk))
        if not ms and how == "left":
            out.append(lv + (r[lk],) + (None,) * (len(right[0]) - 1))
    return out


def _run(ctx, left, right, how, lcols, rcols, **kw):
    lds = ctx.parallelize(left, columns=lcols)
    rds = ctx.parallelize(right, columns=rcols)
    fn = lds.join if how == "inner" else lds.leftJoin
    ds = fn(rds, lcols[0], rcols[0], **kw)
    return ds, ds.collect()


def _join_stats(ctx):
    return [m for m in ctx.metrics.stages if "host_probed_rows" in m][-1]


_CASES = {
    # duplicate build keys, unmatched keys on both sides, None keys
    "int": ([((i * 7) % 13 if i % 11 else None, f"l{i}") for i in range(90)],
            [((i * 5) % 17 if i % 9 else None, i * 0.5) for i in range(60)]),
    # string keys of different widths on the two sides, empty strings
    "str": ([("k" * (i % 5) + str(i % 4), i) for i in range(80)],
            [("k" * (i % 3) + str(i % 6), f"r{i}") for i in range(40)]
            + [("", "empty")]),
    # a boxed row on each side (a None key in a column typed non-Option,
    # and a row of another arity)
    "boxed": ([(i % 6, i) for i in range(95)] + [(None, -1), (3, 3.5)],
              [(i % 8, f"b{i}") for i in range(98)] + [(None, "nb"),
                                                        (2, None)]),
}


@pytest.mark.parametrize("how", ["inner", "left"])
@pytest.mark.parametrize("case", sorted(_CASES))
def test_join_matches_loop_and_reference(case, how):
    """Oracles: the plain loop, in order; tuplex_tpu.Context()'s host join
    as a multiset (its order within a left row differs for boxed build
    rows). Every left row is probed on the device path."""
    left, right = _CASES[case]
    ctx = _port()
    ds, got = _run(ctx, left, right, how, ["k", "a"], ["k2", "b"])
    assert got == _loop_join(left, right, 0, 0, how)
    assert ds.columns == ["a", "k", "b"]
    stats = _join_stats(ctx)
    assert stats["host_probed_rows"] == 0
    assert stats["device_probed_rows"] == len(left)
    _, ref = _run(tuplex_tpu.Context(), left, right, how, ["k", "a"],
                  ["k2", "b"])
    assert sorted(map(repr, ref)) == sorted(map(repr, got))


def test_reference_host_join_keeps_the_loops_order():
    """Oracle: the plain loop. With every row in the normal case, the
    reference's host join emits each left row's matches in the build
    side's order, as the loop does (duplicate build keys)."""
    left, right = [(i % 4, i) for i in range(40)], \
        [(i % 3, i) for i in range(30)]
    _, ref = _run(tuplex_tpu.Context(), left, right, "inner", ["k", "a"],
                  ["k2", "b"])
    assert ref == _loop_join(left, right, 0, 0, "inner")


def test_prefixes_and_suffixes_name_the_columns():
    """Oracle: tuplex_tpu.Context() (columns and rows)."""
    left = [(i % 3, f"x{i}", i) for i in range(12)]
    right = [(i, f"y{i}") for i in range(2)]
    for how in ("inner", "left"):
        kw = {"prefixes": ("l_", "r_"), "suffixes": (None, "_s")}
        ds, got = _run(_port(), left, right, how, ["k", "v", "n"],
                       ["k", "v"], **kw)
        rds, ref = _run(tuplex_tpu.Context(), left, right, how,
                        ["k", "v", "n"], ["k", "v"], **kw)
        assert ds.columns == rds.columns == ["l_v", "l_n", "k", "r_v_s"]
        assert got == ref


def test_cross_type_keys_take_the_counted_host_path():
    """i64 keys against f64 keys compare as Python does (1 == 1.0), which
    no byte signature carries: the host dict path, counted. Oracles: the
    plain loop and tuplex_tpu.Context()."""
    left = [(i % 5, f"l{i}") for i in range(30)]
    right = [(float(i), f"r{i}") for i in range(0, 8, 2)] + [(1.5, "x")]
    for how in ("inner", "left"):
        ctx = _port()
        _, got = _run(ctx, left, right, how, ["k", "a"], ["k2", "b"])
        assert got == _loop_join(left, right, 0, 0, how)
        assert _join_stats(ctx)["host_probed_rows"] == len(left)
        _, ref = _run(tuplex_tpu.Context(), left, right, how, ["k", "a"],
                      ["k2", "b"])
        assert got == ref


def _dict_join(left, right, how, n_right):
    """The plain loop with Python's dict rules for odd keys (key first on
    both sides): a right row with an unhashable key is never found, and a
    left row with one finds nothing."""
    build = {}
    for r in right:
        try:
            build.setdefault(r[0], []).append(r)
        except TypeError:
            pass
    out = []
    for r in left:
        try:
            ms = build.get(r[0], [])
        except TypeError:
            ms = []
        out.extend(r[1:] + r[:1] + m[1:] for m in ms)
        if not ms and how == "left":
            out.append(r[1:] + r[:1] + (None,) * (n_right - 1))
    return out


_LAYOUTS = {
    # tuple and list payload columns (a left join makes them Option)
    "tuple_payloads": ([(i % 7, (i, f"s{i}")) for i in range(60)],
                       [(i % 9, (i * 0.5, f"t{i}"), [i, i + 1])
                        for i in range(40)]),
    # an Option[tuple] payload column
    "option_tuple": ([(i % 7, i) for i in range(60)],
                     [(i % 9, (i, "x") if i % 3 else None)
                      for i in range(40)]),
    # keys of type null: None equals None
    "null_keys": ([(None, i) for i in range(30)],
                  [(None, f"r{i}") for i in range(5)]),
    # boxed rows with unhashable keys on both sides, past the sample
    "unhashable": ([(i % 5, f"a{i}") for i in range(300)]
                   + [([2], "x"), (3, "y")],
                   [(i % 4, f"r{i}") for i in range(300)]
                   + [([3], "q"), (3, "z")]),
    # a build side that a filter empties
    "empty_build": ([(i % 7, i) for i in range(60)],
                    [(i, f"r{i}") for i in range(10)]),
}


@pytest.mark.parametrize("how", ["inner", "left"])
@pytest.mark.parametrize("case", sorted(_LAYOUTS))
def test_join_layouts_and_odd_keys_stay_on_the_device(case, how):
    """Payload columns of any layout, null keys, unhashable boxed keys and
    an empty build side take the device path, not the host dict path.
    Oracles: the plain loop with Python's dict rules, in order, and
    tuplex_tpu.Context()."""
    left, right = _LAYOUTS[case]

    def run(ctx):
        lds = ctx.parallelize(left, columns=["k", "a"])
        rds = ctx.parallelize(right, columns=["k2"] + [
            f"b{j}" for j in range(len(right[0]) - 1)])
        if case == "empty_build":
            rds = rds.filter(lambda x: x["k2"] > 100)
        fn = lds.join if how == "inner" else lds.leftJoin
        ds = fn(rds, "k", "k2")
        return ds, ds.collect()

    ctx = _port()
    ds, got = run(ctx)
    if case == "unhashable":
        assert ds.types[ds.columns.index("k")] is T.I64   # boxed, not typed
    want = _dict_join(left, [] if case == "empty_build" else right, how,
                      len(right[0]))
    assert got == want
    stats = _join_stats(ctx)
    assert stats["host_probed_rows"] == 0
    assert stats["device_probed_rows"] == len(left)
    _, ref = run(tuplex_tpu.Context(CONF))
    assert got == ref


def test_join_stage_brings_build_partitions_to_one_schema():
    """Build partitions of different schemas join on the device; boxed rows
    without a key are exception records on the left and never found on the
    right. Build partitions whose key types differ (i64 and f64) take the
    counted host path, where 1 == 1.0. Oracle: a plain loop."""
    from tuplex_tpu_torch.exec.joinexec import JoinExecutor
    from tuplex_tpu_torch.plan.joins import JoinOperator

    ctx = _port()
    lschema = T.row_of(["k", "a"], [T.I64, T.STR])
    lrows = [(i % 6, f"a{i}") for i in range(40)] + [(9,), 42, ([1], "w")]
    lparts = [C.build_partition(lrows[:25], lschema),
              C.build_partition(lrows[25:], lschema, start_index=25)]
    assert lparts[1].fallback       # the odd rows are boxed
    rows_a = [(i % 4, f"r{i}") for i in range(12)] + [(7,), ([3], "u")]
    rows_b = [(None if i % 5 == 0 else i % 5, f"s{i}") for i in range(10)]
    rows_c = [(i % 3, None) for i in range(6)]
    build = [C.build_partition(rows_a, T.row_of(["k2", "b"],
                                                [T.I64, T.STR])),
             C.build_partition(rows_b, T.row_of(["k2", "b"],
                                                [T.option(T.I64), T.STR])),
             C.build_partition(rows_c, T.row_of(["k2", "b"],
                                                [T.I64, T.NULL]))]

    def loop(right, how):
        found = {}
        for r in right:
            try:
                found.setdefault(r[0], []).append(r)
            except (TypeError, IndexError):
                pass
        out, errs = [], []
        for r in lrows:
            try:
                key = r[0]
            except TypeError as e:
                errs.append(type(e).__name__)
                continue
            if not isinstance(r, tuple) or len(r) < 2:
                out.extend((key,) + m[1:] for m in found.get(key, []))
                if how == "left" and key not in found:
                    out.append((key, None))
                continue
            try:
                ms = found.get(key, [])
            except TypeError:
                ms = []
            out.extend((r[1], key) + m[1:] for m in ms)
            if not ms and how == "left":
                out.append((r[1], key, None))
        return out, errs

    for how in ("inner", "left"):
        op = JoinOperator(ctx.parallelize([(0, "a")], columns=["k", "a"])._op,
                          ctx.parallelize([(0, "b")], columns=["k2", "b"])._op,
                          "k", "k2", how)
        res = JoinExecutor(ctx.backend).execute(JoinStage(op), lparts, build)
        got = [v for p in res.partitions for v in C.partition_to_pylist(p)]
        want, errs = loop(rows_a + rows_b + rows_c, how)
        assert got == want
        assert [e.exc_name for e in res.exceptions] == errs
        assert res.metrics["host_probed_rows"] == 0
        assert res.metrics["device_probed_rows"] == len(lrows)

        floats = [C.build_partition([(1.0, "f"), (2.5, "g")],
                                    T.row_of(["k2", "b"], [T.F64, T.STR]))]
        res = JoinExecutor(ctx.backend).execute(JoinStage(op), lparts,
                                                build[:1] + floats)
        got = [v for p in res.partitions for v in C.partition_to_pylist(p)]
        assert got == loop(rows_a + [(1.0, "f"), (2.5, "g")], how)[0]
        assert res.metrics["host_probed_rows"] == len(lrows)


def test_tuple_keys_raise_and_mixed_keys_take_the_host_path():
    """A key column of tuples is not ported: it raises. A key column of
    mixed types (pyobject: a list in the sample) takes the counted host
    dict path. Oracle: tuplex_tpu.Context()."""
    from tuplex_tpu_torch.core.errors import TuplexException

    ctx = _port()
    ds = ctx.parallelize([((i, "a"), i) for i in range(9)],
                         columns=["k", "a"]).join(
        ctx.parallelize([((i, "a"), f"r{i}") for i in range(3)],
                        columns=["k2", "b"]), "k", "k2")
    with pytest.raises(TuplexException, match="not ported"):
        ds.collect()

    left = [(i % 4 if i % 2 else [i % 4], f"a{i}") for i in range(20)]
    right = [(float(i % 3) if i % 2 else [i], f"r{i}") for i in range(9)]
    for how in ("inner", "left"):
        ctx = _port()
        ds, got = _run(ctx, left, right, how, ["k", "a"], ["k2", "b"])
        assert ds.types[ds.columns.index("k")] is T.PYOBJECT
        assert _join_stats(ctx)["host_probed_rows"] == len(left)
        _, ref = _run(tuplex_tpu.Context(), left, right, how, ["k", "a"],
                      ["k2", "b"])
        assert got == ref


def test_join_feeds_a_compiled_stage_and_plans_a_join_stage():
    """The join's output partitions feed the next transform stage, which
    compiles. Oracle: the plain loop."""
    left = [(i % 7, i) for i in range(200)]
    right = [(i, f"name{i}") for i in range(5)]
    ctx = _port()
    ds = ctx.parallelize(left, columns=["k", "v"]).join(
        ctx.parallelize(right, columns=["k2", "name"]), "k", "k2") \
        .map(lambda x: x["name"].upper() + "%d" % (x["v"] * 2))
    kinds = [type(s).__name__ for s in plan_stages(ds._op)]
    assert kinds == ["JoinStage", "TransformStage"]
    assert isinstance(plan_stages(ds._op)[0], JoinStage)
    assert ds.collect() == [n.upper() + str(v * 2) for v, _k, n in
                            _loop_join(left, right, 0, 0, "inner")]
    assert ctx.metrics.stages[-1]["tier"] == "compiled"


# ---------------------------------------------------------------------------
# renameColumn, ignore, resolve
# ---------------------------------------------------------------------------

def test_rename_column_by_name_and_position():
    """Oracle: tuplex_tpu.Context() (columns and rows)."""
    rows = [(i, f"s{i}", i * 0.5) for i in range(50)]
    out = []
    for ctx in (_port(), tuplex_tpu.Context()):
        ds = ctx.parallelize(rows, columns=["a", "b", "c"]) \
            .renameColumn("b", "B").renameColumn(0, "A") \
            .withColumn("d", lambda x: x["A"] + len(x["B"]))
        out.append((ds.columns, ds.collect()))
    assert out[0] == out[1]
    assert out[0][0] == ["A", "B", "c", "d"]


def _dirty_csv(path):
    rng = random.Random(3)
    with open(path, "w") as fp:
        fp.write("a,b\n")
        for i in range(400):
            b = rng.choice(["", "x", str(i)]) if rng.random() < 0.1 \
                else str(i % 9)
            fp.write(f"{i},{b}\n")
    return path


def _loop_ignore(path):
    """The pipeline below as a loop: a ZeroDivisionError row is dropped,
    other exceptions counted."""
    import csv

    out, excs = [], {}
    with open(path) as fp:
        r = csv.reader(fp)
        next(r)
        for a, b in r:
            a = int(a)
            b = None if b == "" else (int(b) if b.isdigit() else b)
            try:
                out.append((a, b, a // b))
            except ZeroDivisionError:
                continue
            except Exception as e:
                excs[type(e).__name__] = excs.get(type(e).__name__, 0) + 1
    return out, excs


def test_ignore_drops_and_counts_rows_outside_exception_counts(tmp_path):
    """ignore(ZeroDivisionError) over a small CSV file: the dropped rows
    are counted by Metrics.ignoredRows and are not in exception_counts().
    Oracles: the plain loop and tuplex_tpu.Context()."""
    path = _dirty_csv(str(tmp_path / "d.csv"))
    want, excs = _loop_ignore(path)
    ctx = _port()
    ds = ctx.csv(path).withColumn("q", lambda x: x["a"] // x["b"]) \
        .ignore(ZeroDivisionError)
    got = ds.collect()
    assert got == want and ds.exception_counts() == excs
    assert "ZeroDivisionError" not in excs and sum(excs.values()) > 0
    n_zero = sum(1 for line in open(path).read().split("\n")[1:]
                 if line.endswith(",0"))
    assert ctx.metrics.ignoredRows() == n_zero > 0
    rds = tuplex_tpu.Context().csv(path) \
        .withColumn("q", lambda x: x["a"] // x["b"]).ignore(ZeroDivisionError)
    assert rds.collect() == got and rds.exception_counts() == excs


def test_resolve_replaces_a_raising_operator():
    """resolve(ZeroDivisionError, f) takes f(row) as the withColumn's
    value; a resolver that raises leaves the row an exception. Oracles:
    the plain loop and tuplex_tpu.Context()."""
    rows = [(i, i % 4) for i in range(60)] + [(7, None)]
    want = [(a, b, a // b if b else -a) for a, b in rows if b is not None]
    out = []
    for ctx in (_port(), tuplex_tpu.Context()):
        ds = ctx.parallelize(rows, columns=["a", "b"]) \
            .withColumn("q", lambda x: x["a"] // x["b"]) \
            .resolve(ZeroDivisionError, lambda x: -x["a"])
        out.append((ds.collect(), ds.exception_counts()))
    assert out[0] == out[1] == (want, {"TypeError": 1})


# ---------------------------------------------------------------------------
# strip, str.format, float(), string.capwords
# ---------------------------------------------------------------------------

def _strings(seed: int, n: int = 400):
    rng = random.Random(seed)
    alpha = "aZ b\t\n\x0b\x0c\r\x1c\x1f x.,-(1)9"
    vals = ["".join(rng.choice(alpha) for _ in range(rng.randint(0, 14)))
            for _ in range(n)]
    return vals + ["", " ", " x ", " café ok "]


_STR_UDFS = {
    "strip": lambda s: s.strip(),
    "lstrip": lambda s: s.lstrip(),
    "rstrip": lambda s: s.rstrip(),
    "strip_chars": lambda s: s.strip(".-a"),
    "capwords": lambda s: string.capwords(s),
    "format_str": lambda s: "<{}|{}>".format(s, s[:2]),
}


@pytest.mark.parametrize("name", sorted(_STR_UDFS))
def test_string_methods_compile_and_match_cpython(name):
    """Oracle: CPython over seeded ASCII strings with every ASCII
    whitespace byte, and a few non-ASCII ones, which re-run on the
    interpreter (for whitespace and case) and still equal CPython."""
    vals = _strings(len(name))
    fn = _STR_UDFS[name]
    ctx = _port()
    got = ctx.parallelize(vals).map(fn).collect()
    assert got == [fn(v) for v in vals]
    assert all(m["tier"] == "compiled" for m in ctx.metrics.stages)
    assert ctx.metrics.interpreterRows() <= 2


_NUM_UDFS = {
    "format_pad": lambda x: "{:02}:{:02}".format(int(x / 100), x % 100),
    "format_space": lambda x: "[{:6}]{}".format(x, x),
    "float_int": lambda x: float(x) / 7,
    "true_div": lambda x: x / 0.00062137119224,
}


@pytest.mark.parametrize("name", sorted(_NUM_UDFS))
def test_number_formats_compile_and_match_cpython(name):
    """Oracle: CPython, bit for bit (floats by their hex), over seeded
    ints including negatives and int64's extremes (2**62 and beyond take
    the interpreter in true division)."""
    rng = random.Random(11)
    vals = [rng.randint(-3000, 3000) for _ in range(300)] + \
        [0, -1, 2**62, -2**63, 2**63 - 1, 2**53 + 1]
    fn = _NUM_UDFS[name]
    ctx = _port()
    got = ctx.parallelize(vals).map(fn).collect()
    want = [fn(v) for v in vals]
    assert [repr(g) for g in got] == [repr(w) for w in want]
    assert ctx.metrics.stages[-1]["tier"] == "compiled"


def test_float_of_strings_and_options_matches_cpython():
    """float() of a str column (parse_f64, with its CPython routing) and
    of an Option[f64] column (None raises TypeError). Oracle: CPython."""
    strs = ["1.5", " -2e3 ", "abc", "1e23", "inf", "0.1", "7", "", "1_0"]
    ctx = _port()
    ds = ctx.parallelize([(s, (i * 0.25 if i % 4 else None))
                          for i, s in enumerate(strs * 20)],
                         columns=["s", "f"]) \
        .map(lambda x: (float(x["s"]), float(x["f"])))
    got = ds.collect()
    want, excs = [], {}
    for i, s in enumerate(strs * 20):
        f = i * 0.25 if i % 4 else None
        try:
            want.append((float(s), float(f)))
        except Exception as e:
            excs[type(e).__name__] = excs.get(type(e).__name__, 0) + 1
    assert [repr(r) for r in got] == [repr(r) for r in want]
    assert ds.exception_counts() == excs
    assert ctx.metrics.stages[-1]["tier"] == "compiled"


# ---------------------------------------------------------------------------
# TPC-H Q19
# ---------------------------------------------------------------------------

def test_generator_writes_the_reference_q19_bytes(tmp_path):
    a = [str(tmp_path / n) for n in ("p1", "l1", "p2", "l2")]
    tpch.generate_q19_csvs(a[0], a[1], 300, 900, seed=19)
    ref_tpch.generate_q19_csvs(a[2], a[3], 300, 900, seed=19)
    assert open(a[0], "rb").read() == open(a[2], "rb").read()
    assert open(a[1], "rb").read() == open(a[3], "rb").read()


def test_q19_matches_the_loop(tmp_path):
    """Q19 at 400 parts and 6,000 lineitems: a join on l_partkey (one
    key word: torch.searchsorted), the three-branch OR filter and the
    fused fold. Oracle: run_reference_q19, within 1e-9 relative."""
    part, li = str(tmp_path / "part.csv"), str(tmp_path / "li.csv")
    tpch.generate_q19_csvs(part, li, 400, 6000, seed=19)
    want = tpch.run_reference_q19(part, li)
    ctx = _port()
    ds = tpch.q19(ctx, part, li)
    (got,) = ds.collect()
    assert want > 0 and math.isclose(got, want, rel_tol=1e-9, abs_tol=0.0)
    assert ds.exception_counts() == {}
    stats = _join_stats(ctx)
    assert stats["host_probed_rows"] == 0 and stats["key_words"] == 1
    assert ctx.metrics.interpreterRows() == 0
    (again,) = tpch.q19(_port(), part, li).collect()
    assert again.hex() == got.hex()
