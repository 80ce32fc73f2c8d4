"""tuplex_tpu_torch on the card: the CUDA NFA scan, the CUDA join probe
and the CUDA general fold against their plain versions, the string
kernels and the aggregate reductions on CUDA against the same ops on the
CPU, and the pipelines
(smoke, log grep, Zillow Z1, TPC-H Q6, Q1 and Q19, NYC 311, flights)
through Context() on CUDA.

Every test here is marked `cuda` and skips without a GPU. This file
imports neither jax nor tuplex_tpu, so it runs on a GPU host without them:

    python3 -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Oracles: the plain versions (`NFARegex.match_bitmask`,
`ops/join.py:lower_bound_plain`, `ops/segfold.py:seg_fold_plain`) on the
same CUDA tensors, Python `re`, the CPU run of each string kernel (itself held
against the reference package by tests/test_torch_strings.py), and a
plain Python loop. Tolerance: exact.
"""

import ast
import re

import numpy as np
import pytest
import torch

import tuplex_tpu_torch
from tuplex_tpu_torch.models import flights, logs, nyc311, tpch, zillow
from tuplex_tpu_torch.ops import nfa as port_nfa
from tuplex_tpu_torch.ops import fold as F
from tuplex_tpu_torch.ops import join as J
from tuplex_tpu_torch.compiler.foldprog import FoldProgram, lower_fold
from tuplex_tpu_torch.ops import join_cuda, nfa_cuda, segfold_cuda
from tuplex_tpu_torch.ops import segfold as SF
from tuplex_tpu_torch.plan import aggregates as A
from tuplex_tpu_torch.utils.reflection import get_udf_source
from tuplex_tpu_torch.ops import strings as S
from tuplex_tpu_torch.runtime import columns as C

PATTERNS = ["abc", "a+b", "GET|POST", "a*b", "[0-9]+-[0-9]+", "^abc",
            "abc$", "^a.*b$", r"\d+", "(ab)+", "^$", "b$",
            r'" (4\d\d|5\d\d) ', "[ab]" * 64, r"[^a-z]\s?x{2,3}"]


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


def _random_batch(seed: int, n: int, w: int):
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b'ab cxGETPOS"45\n09z', dtype=np.uint8)
    mat = alphabet[rng.integers(0, len(alphabet), size=(n, w))]
    wide = rng.random(n) < 0.1
    mat[wide] = rng.integers(0, 256, size=(int(wide.sum()), w),
                             dtype=np.uint8)
    lens = rng.integers(0, w + 1, size=n).astype(np.int32)
    runs = rng.random(n) < 0.05
    mat[runs] = np.frombuffer(b"ab", dtype=np.uint8)[
        rng.integers(0, 2, size=(int(runs.sum()), w))]
    nl = (rng.random(n) < 0.2) & (lens > 0)
    mat[np.nonzero(nl)[0], lens[nl] - 1] = 10
    mat[np.arange(w)[None, :] >= lens[:, None]] = 0
    return mat, lens


def _check(rx, pattern, b, l):
    """The kernel on CUDA tensors b, l against the plain version on the
    same tensors and against `re` on their rows; one launch per call."""
    before = nfa_cuda.launches
    got = rx.match(b, l).cpu()
    assert torch.equal(got, rx.match_bitmask(b, l).cpu())
    assert nfa_cuda.launches == before + (1 if rx.n_pos else 0)
    mat, lens = b.cpu().numpy(), l.cpu().numpy()
    rows = [bytes(r[:k]) for r, k in zip(mat, lens)]
    assert got.tolist() == [re.search(pattern.encode(), r) is not None
                            for r in rows]


# 8-byte rows (4-byte loads), bytes, 16-byte loads, eight column chunks
@pytest.mark.cuda
@pytest.mark.parametrize("w", [72, 75, 128, 1000])
@pytest.mark.parametrize("pattern", PATTERNS)
def test_kernel_matches_plain_and_re(pattern, w, cuda_device):
    mat, lens = _random_batch(11, 1001, w)
    b = torch.from_numpy(mat).to(cuda_device)
    l = torch.from_numpy(lens).to(cuda_device)
    _check(port_nfa.compile_nfa(pattern), pattern, b, l)


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", ["a+b$", r'" (4\d\d|5\d\d) ', "^a.*b$",
                                     "[ab]" * 64])
def test_kernel_block_and_alignment_edges(pattern, cuda_device):
    """Row counts around the kernel's block of R rows (1, R-1, R, R+1), and
    bases that are not 16-byte aligned: rows 1.. of a contiguous [N+1, 75]
    matrix (byte loads) and a [N, 128] matrix 4 bytes into its buffer
    (4-byte loads where the aligned matrix takes 16-byte loads)."""
    rx = port_nfa.compile_nfa(pattern)
    R = nfa_cuda.rows_per_block()
    for n in (1, R - 1, R, R + 1):
        mat, lens = _random_batch(13 + n, n, 96)
        _check(rx, pattern, torch.from_numpy(mat).to(cuda_device),
               torch.from_numpy(lens).to(cuda_device))
    mat, lens = _random_batch(5, 301, 75)
    b = torch.from_numpy(mat).to(cuda_device)[1:]
    assert b.is_contiguous() and b.data_ptr() % 16 != 0
    _check(rx, pattern, b, torch.from_numpy(lens[1:]).to(cuda_device))
    mat, lens = _random_batch(6, 300, 128)
    flat = torch.zeros(4 + mat.size, dtype=torch.uint8, device=cuda_device)
    flat[4:] = torch.from_numpy(mat.ravel()).to(cuda_device)
    b = flat[4:].view(300, 128)
    assert b.data_ptr() % 16 == 4
    _check(rx, pattern, b, torch.from_numpy(lens).to(cuda_device))


@pytest.mark.cuda
def test_wrapper_rejects_bad_inputs(cuda_device):
    t = port_nfa.compile_nfa("abc").tables
    buf = torch.from_numpy(nfa_cuda.pack_tables(t).view(np.int64)).to(
        cuda_device)
    b = torch.zeros((4, 8), dtype=torch.uint8, device=cuda_device)
    l = torch.zeros(4, dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        nfa_cuda.match_cuda(t, buf, b, l.to(torch.int64))
    with pytest.raises(ValueError):
        nfa_cuda.match_cuda(t, buf, b.t(), l)
    with pytest.raises(ValueError):
        nfa_cuda.match_cuda(t, buf, b, l.cpu())
    with pytest.raises(ValueError):
        nfa_cuda.match_cuda(t, buf[:-1], b, l)


@pytest.mark.cuda
def test_pipelines_on_cuda(tmp_path, cuda_device):
    ctx = tuplex_tpu_torch.Context()
    assert ctx.device.type == "cuda"
    ds = ctx.parallelize([1, 2, None, 4]).map(lambda x: (x, x * x))
    assert ds.collect() == [(1, 1), (2, 4), (4, 16)]
    assert ds.exception_counts() == {"TypeError": 1}
    path = str(tmp_path / "access.log")
    logs.generate_log(path, 5000, seed=17, non_ascii_every=1000)
    ctx = tuplex_tpu_torch.Context()
    before = nfa_cuda.launches
    assert logs.build_grep(ctx.text(path)).collect() == \
        logs.run_grep_reference(path)
    assert nfa_cuda.launches > before
    m = ctx.metrics
    assert m.interpreterRows() + m.generalRows() + m.exactExitRows() == 5
    assert m.interpreterRows() == 5


STRING_ROWS = ["", " 42", "+7", "-0", "1_000", "N/A", "0210A", "3 bds , 2 ba",
               "9223372036854775807", "-9223372036854775808",
               "9223372036854775808", "12345678901234567890", "\u0661",
               "$1,200/mo", "House For Sale", "a,,b,", "aaaa", "abab",
               "caf\u00e9", " " * 30 + "8", "x" * 40]

STRING_OPS = {
    "lower": lambda b, l: S.lower(b, l),
    "upper": lambda b, l: S.upper(b, l),
    "contains": lambda b, l: S.contains_const(b, l, "ab"),
    "rfind": lambda b, l: S.find_const(b, l, ",", reverse=True),
    "replace-delete": lambda b, l: S.replace_const(b, l, ",", ""),
    "replace-grow": lambda b, l: S.replace_const(b, l, "a", "xyz"),
    "replace-overlap": lambda b, l: S.replace_const(b, l, "aa", "b"),
    "concat": lambda b, l: S.concat(b, l, b, l),
    "equals": lambda b, l: S.equals(b, l, *S.broadcast_const(
        "aaaa", b.shape[0], b.device)),
    "char_at": lambda b, l: S.char_at(b, l, torch.zeros_like(l)),
    "parse_i64": lambda b, l: S.parse_i64(b, l),
    "parse_f64": lambda b, l: S.parse_f64(b, l),
    "compare_lt": lambda b, l: S.compare_lt(b, l, b.flip(0), l.flip(0)),
    "compare_le-const": lambda b, l: S.compare_lt(
        b, l, *S.broadcast_const("abab", b.shape[0], b.device),
        or_equal=True),
    "parse_i64-wide": lambda b, l: S.parse_i64(
        torch.nn.functional.pad(b, (0, 40)), l),
    "format_i64": lambda b, l: S.format_i64(
        torch.tensor([0, 7, -42, 99999, -2 ** 63, 2 ** 63 - 1,
                      10 ** 18], dtype=torch.int64, device=b.device),
        width=5, pad_zero=True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("op", sorted(STRING_OPS))
def test_string_kernels_cuda_match_cpu(op, cuda_device):
    leaf = C.encode_str_leaf(STRING_ROWS, False)
    b = torch.from_numpy(np.ascontiguousarray(leaf.bytes))
    l = torch.from_numpy(leaf.lengths)
    want = STRING_OPS[op](b, l)
    got = STRING_OPS[op](b.to(cuda_device), l.to(cuda_device))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for g, w in zip(got, want):
        assert g.device.type == "cuda"
        assert torch.equal(g.cpu(), w), op


@pytest.mark.cuda
def test_zillow_on_cuda(tmp_path, cuda_device):
    path = str(tmp_path / "z.csv")
    zillow.generate_csv(path, 2000, seed=7)
    ctx = tuplex_tpu_torch.Context()
    ds = zillow.build_pipeline(ctx.csv(path))
    assert ds.collect() == zillow.run_reference_python(path)
    assert ds.exception_counts() == {"ValueError": 62, "TypeError": 4,
                                     "AttributeError": 34}
    assert ctx.metrics.stages[-1]["tier"] == "compiled"
    m = ctx.metrics
    assert m.interpreterRows() + m.generalRows() + m.exactExitRows() == 109
    assert (m.interpreterRows(), m.generalRows(), m.exactExitRows()) == \
        (0, 9, 100)


F64_ROWS = ["17.0", "0.05", "-0.0", ".5", "5.", " 2.5 ", "1e22", "1e23",
            "1e-22", "9007199254740993", "123.456", "nan", "1_0", "e5",
            "0e999", "45678.91", "\u0663", "1" * 40]


@pytest.mark.cuda
def test_parse_f64_cuda_matches_cpu_bits(cuda_device):
    rng = np.random.default_rng(9)
    rows = F64_ROWS + ["%.*f" % (int(rng.integers(0, 9)), v) for v in
                       rng.uniform(-1e6, 1e6, 20_000)]
    leaf = C.encode_str_leaf(rows, False)
    b = torch.from_numpy(np.ascontiguousarray(leaf.bytes))
    l = torch.from_numpy(leaf.lengths)
    want = S.parse_f64(b, l)
    got = S.parse_f64(b.to(cuda_device), l.to(cuda_device))
    for g, w in zip(got, want):
        assert torch.equal(g.cpu().view(torch.uint8), w.view(torch.uint8))


def _fold_inputs(seed: int, n: int, nkeys: int):
    rng = np.random.default_rng(seed)
    keys = C.encode_str_leaf(["k%d" % v for v in rng.integers(0, nkeys, n)],
                             True)
    keys.valid = rng.random(n) > 0.05
    vals = torch.from_numpy(rng.uniform(-1e5, 1e5, n))
    ints = torch.from_numpy(rng.integers(-10 ** 6, 10 ** 6, n))
    return keys, vals, ints


@pytest.mark.cuda
@pytest.mark.parametrize("n,nkeys", [(1, 1), (1000, 3), (100_003, 6),
                                     (50_000, 20_000)])
def test_fold_reductions_cuda_match_cpu(n, nkeys, cuda_device):
    """Key factorization, tree and segmented reductions: the same codes
    and the same bits on the card as on the CPU, and on the card the same
    bits run to run."""
    from tuplex_tpu_torch.compiler.values import CV
    from tuplex_tpu_torch.core import typesys as T

    keys, vals, ints = _fold_inputs(7, n, nkeys)
    ok = torch.from_numpy(np.random.default_rng(8).random(n) > 0.1)

    def run(dev):
        cv = CV(t=T.option(T.STR), sbytes=torch.from_numpy(
            keys.bytes.copy()).to(dev), slen=torch.from_numpy(
            keys.lengths).to(dev), valid=torch.from_numpy(keys.valid).to(dev))
        sig = F.signature([cv], n, dev)
        codes, first = F.factorize(sig, ok.to(dev))
        sel = codes >= 0
        nseg = first.shape[0]
        out = [codes.cpu(), first.cpu()]
        for x in (vals.to(dev), ints.to(dev)):
            for red in ("sum", "min", "max"):
                out.append(F.segment_reduce(x[sel], codes[sel], nseg,
                                            red).cpu())
                out.append(F.tree_reduce(torch.where(
                    ok.to(dev), x, x.new_zeros(())), red).cpu())
        return out

    want = run(torch.device("cpu"))
    got = run(cuda_device)
    again = run(cuda_device)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, w) and torch.equal(a, g)


@pytest.mark.cuda
def test_tpch_and_nyc311_on_cuda(tmp_path, cuda_device):
    li = str(tmp_path / "li.csv")
    tpch.generate_csv(li, 3000, seed=8)
    ctx = tuplex_tpu_torch.Context()
    (q6,) = tpch.q6(ctx.csv(li)).collect()
    want = tpch.run_reference_q6(li)
    assert abs(q6 - want) <= 1e-9 * abs(want)
    assert ctx.metrics.stages[0]["fetched_row_columns"] == 0
    assert ctx.metrics.interpreterRows() == 0
    assert ctx.metrics.hostFoldedRows() == 0
    q1 = tpch.q1(tuplex_tpu_torch.Context().csv(li)).collect()
    want = tpch.run_reference_q1(li)
    assert [r[:2] for r in q1] == list(want)
    for r in q1:
        w = want[r[:2]]
        assert r[5] == w[3] and all(abs(a - b) <= 1e-9 * abs(b)
                                    for a, b in zip(r[2:5], w[:3]))
    path = str(tmp_path / "311.csv")
    nyc311.generate_csv(path, 3000, seed=23)
    assert nyc311.build_pipeline(tuplex_tpu_torch.Context(), path) \
        .collect() == nyc311.run_reference_python(path)


def _probe_words(seed: int, u: int, nw: int, b: int, runs: int = 0):
    """Sorted unique build words in unsigned order (top bits set and
    clear) and probe words: build rows, rows one off in their last word,
    random rows, and rows below the first key and above the last. With
    `runs`, the first words take only `runs` values (runs of equal first
    words, as long string keys with a common 8-byte prefix give)."""
    rng = np.random.default_rng(seed)
    build = rng.integers(0, 2**64 - 1, size=(u, nw), dtype=np.uint64)
    if runs:
        build[:, 0] = rng.integers(0, 2**64 - 1, size=runs,
                                   dtype=np.uint64)[
            rng.integers(0, runs, size=u)]
    build = np.unique(build, axis=0)
    probe = build[rng.integers(0, len(build), size=b)].copy()
    near = rng.random(b) < 0.3
    probe[near, -1] += np.uint64(1)
    rand = rng.random(b) < 0.2
    probe[rand] = rng.integers(0, 2**64 - 1, size=(int(rand.sum()), nw),
                               dtype=np.uint64)
    probe[:2] = 0
    probe[2:4] = np.uint64(2**64 - 1)
    return (torch.from_numpy(build.view(np.int64)),
            torch.from_numpy(probe.view(np.int64)))


# 227 KB of shared memory a block: 14,528 keys of two words (the table
# the earlier kernel held whole), and 28,030 first words beside an 11-bit
# radix table (the most keys whose first words all fit)
_SHARED_KEYS = 232_448 // 16
_FENCE_KEYS = 28_030


@pytest.mark.cuda
@pytest.mark.parametrize("nw", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("u,runs", [
    (1, 0), (2, 0), (9, 0), (1000, 0), (9300, 0), (100_000, 0),
    (200_000, 0), (300_000, 0), (_SHARED_KEYS - 3, 0), (_SHARED_KEYS, 0),
    (_SHARED_KEYS + 3, 0), (_FENCE_KEYS - 3, 0), (_FENCE_KEYS, 0),
    (_FENCE_KEYS + 1, 0), (_FENCE_KEYS + 4, 0), (5000, 3), (100_000, 7),
    (4000, 1)])
def test_join_probe_kernel_matches_plain(nw, u, runs, cuda_device):
    """The kernel against its plain versions on the same CUDA tensors:
    one to five words; tables whose first words all fit shared memory,
    tables a few keys either side of a block's 227 KB, tables searched in
    groups of 2-8 first words and in groups of more (300,000 keys); long
    runs of equal first words (all u keys sharing one where runs is 1);
    probes below the first key and above the last; a probe batch that is
    not a multiple of a block."""
    build, probe = _probe_words(nw * 1_000_000 + u + runs, u, nw, 50_001,
                                runs)
    build, probe = build.to(cuda_device), probe.to(cuda_device)
    index = J.probe_index(build)
    before = join_cuda.launches
    pos, matched = J.join_probe(probe, index)
    assert join_cuda.launches == before + 1
    want_pos, want_m = J.lower_bound_plain(probe, build)
    assert torch.equal(pos, want_pos) and torch.equal(matched, want_m)
    got_pos, got_m = J.lower_bound_index_plain(probe, index)
    assert torch.equal(got_pos, want_pos) and torch.equal(got_m, want_m)
    assert 0 < int(matched.sum()) < probe.shape[0]


@pytest.mark.cuda
@pytest.mark.parametrize("bits,group_shift", [(1, 0), (3, 1), (2, 2),
                                              (4, 3), (6, 5)])
def test_join_probe_kernel_layouts_match_plain(bits, group_shift,
                                               cuda_device):
    """Every index layout the kernel reads: few radix bits (large
    buckets), fences every 1, 2, 4, 8 and 32 first words."""
    for nw, runs in ((1, 0), (3, 0), (2, 5)):
        build, probe = _probe_words(bits * 100 + nw, 20_000, nw, 30_001,
                                    runs)
        build, probe = build.to(cuda_device), probe.to(cuda_device)
        index = J.probe_index(build, bits, group_shift)
        pos, matched = join_cuda.probe(probe, index)
        want_pos, want_m = J.lower_bound_plain(probe, build)
        assert torch.equal(pos, want_pos) and torch.equal(matched, want_m)


@pytest.mark.cuda
def test_join_probe_wrapper_rejects_bad_inputs(cuda_device):
    build, probe = _probe_words(1, 10, 2, 10)
    with pytest.raises(ValueError):
        join_cuda.probe(probe, J.probe_index(build))    # CPU tensors
    index = J.probe_index(build.to(cuda_device))
    with pytest.raises(ValueError):
        join_cuda.probe(probe.to(cuda_device)[:, :1], index)  # word counts
    with pytest.raises(TypeError):
        join_cuda.probe(probe.to(cuda_device).to(torch.int32), index)
    # a layout whose fences do not fit a block's shared memory
    big, probe = _probe_words(2, 40_000, 1, 10)
    with pytest.raises(RuntimeError):
        join_cuda.probe(probe.to(cuda_device),
                        J.probe_index(big.to(cuda_device), 2, 0))


@pytest.mark.cuda
def test_flights_and_q19_on_cuda(tmp_path, cuda_device):
    paths = [str(tmp_path / n) for n in
             ("perf.csv", "carrier.csv", "airports.txt")]
    flights.generate_perf_csv(paths[0], 3000, seed=13)
    flights.generate_carrier_csv(paths[1])
    flights.generate_airport_db(paths[2])
    ctx = tuplex_tpu_torch.Context()
    before = join_cuda.launches
    got = flights.build_pipeline(ctx, *paths).collect()
    assert got == flights.run_reference_python(*paths)
    assert join_cuda.launches > before
    joins = [m for m in ctx.metrics.stages if "host_probed_rows" in m]
    assert len(joins) == 3 and all(m["host_probed_rows"] == 0
                                   for m in joins)
    part, li = str(tmp_path / "part.csv"), str(tmp_path / "li.csv")
    tpch.generate_q19_csvs(part, li, 500, 5000, seed=19)
    (q19,) = tpch.q19(tuplex_tpu_torch.Context(), part, li).collect()
    want = tpch.run_reference_q19(part, li)
    assert abs(q19 - want) <= 1e-9 * abs(want)


def _dict_join(left, right, how, n_right):
    """The plain loop with Python's dict rules (key first on both sides):
    a right row with an unhashable key is never found, and a left row with
    one finds nothing."""
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


_JOIN_LAYOUTS = {
    # str keys of two words (the kernel), tuple and list payloads
    "tuple_payloads": ([(f"carrier{i % 7}", (i, f"s{i}"))
                        for i in range(60)],
                       [(f"carrier{i % 9}", (i * 0.5, f"t{i}"), [i, i + 1])
                        for i in range(40)]),
    "option_tuple": ([(f"key{i % 7}", i) for i in range(60)],
                     [(f"key{i % 9}", (i, "x") if i % 3 else None)
                      for i in range(40)]),
    "null_keys": ([(None, i) for i in range(30)],
                  [(None, f"r{i}") for i in range(5)]),
    # boxed rows with unhashable keys on both sides, past the sample
    "unhashable": ([(f"key{i % 5}", f"a{i}") for i in range(300)]
                   + [(["key2"], "x"), ("key3", "y")],
                   [(f"key{i % 4}", f"r{i}") for i in range(300)]
                   + [(["key3"], "q"), ("key3", "z")]),
    "empty_build": ([(f"key{i % 7}", i) for i in range(60)],
                    [(f"key{i}", f"r{i}") for i in range(10)]),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(_JOIN_LAYOUTS))
def test_join_layouts_and_odd_keys_on_cuda(case, cuda_device):
    """Payload columns of any layout, null keys, unhashable boxed keys and
    an empty build side join on the card, none on the host dict path.
    Oracle: the plain loop with Python's dict rules."""
    left, right = _JOIN_LAYOUTS[case]
    for how in ("inner", "left"):
        ctx = tuplex_tpu_torch.Context({"tuplex.partitionSize": "4KB"})
        lds = ctx.parallelize(left, columns=["k", "a"])
        rds = ctx.parallelize(right, columns=["k2"] + [
            f"b{j}" for j in range(len(right[0]) - 1)])
        if case == "empty_build":
            rds = rds.filter(lambda x: x["k2"] == "none")
        before = join_cuda.launches
        got = (lds.join if how == "inner" else lds.leftJoin)(
            rds, "k", "k2").collect()
        assert got == _dict_join(left, [] if case == "empty_build"
                                 else right, how, len(right[0]))
        (stats,) = [m for m in ctx.metrics.stages
                    if "host_probed_rows" in m]
        assert stats["host_probed_rows"] == 0
        assert stats["device_probed_rows"] == len(left)
        if case in ("tuple_payloads", "option_tuple", "unhashable"):
            assert join_cuda.launches > before


# -- the general fold (csrc/seg_fold.cu) --------------------------------------

def _segfold_short(a, x):
    return a + x[0]


def _segfold_ints(a, x):
    return a * 3 % 1000003 + x[1] if x[2] else a - x[3]


def _segfold_mixed(a, x):
    return (min(a[0], x[0]), max(x[1], a[1]), a[2] + (x[0] < x[1]))


def _segfold_builtins(a, x):
    return -abs(a) // (x[3] or 1) + int(x[0] % 7.5) if a != x[1] \
        else float(a) / 3 + bool(x[2])


def _segfold_locals(a, x):
    y = x[0] * 2
    if a > 0 and y < 50:
        s = a % 7
    else:
        s = a // (x[3] + 0.5)
    return s + y


_SEGFOLD_PROGRAMS = {"short": (_segfold_short, 0.0),
                     "ints": (_segfold_ints, 1),
                     "mixed": (_segfold_mixed, (0.0, 0, 0)),
                     "builtins": (_segfold_builtins, 2),
                     "locals": (_segfold_locals, 1)}


def _segfold_inputs(prog, init, n, nseg, seed, dev):
    """Seeded terms for programs over x[0] (floats with NaN, signed zeros
    and infinities), x[1] (ints), x[2] (bools) and x[3] (small ints with
    zeros); exact classes in some rows. What stops a segment (ints beyond
    2**53 and near int64's ends, internal codes, Nones, a limit row) only
    in odd segments, so that even ones fold to their end."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(-1, nseg, n)     # -1: a row in no segment
    odd = codes % 2 == 1
    vals = np.zeros((len(prog.terms), n), dtype=np.int64)
    metas = np.zeros((len(prog.terms), n), dtype=np.int32)
    for t, term in enumerate(prog.terms):
        src = ast.unparse(term.expr)
        if src == "x[0]":
            f = rng.uniform(-100.0, 100.0, n)
            f[rng.random(n) < 0.01] = np.nan
            f[rng.random(n) < 0.01] = -0.0
            f[rng.random(n) < 0.005] = np.inf
            vals[t], tag = f.view(np.int64), SF.TAG_FLOAT
        elif src == "x[1]":
            v = rng.integers(-1000, 1000, n)
            big = odd & (rng.random(n) < 0.02)
            v[big] = rng.integers(-(1 << 62), 1 << 62, int(big.sum())) * 2
            vals[t], tag = v, SF.TAG_INT
        elif src == "x[2]":
            vals[t], tag = rng.random(n) < 0.5, SF.TAG_BOOL
        else:
            vals[t], tag = rng.integers(-3, 4, n), SF.TAG_INT
        u = rng.random(n)
        meta = np.full(n, tag << 8, dtype=np.int32)
        meta[u < 0.002] |= 3                         # TypeError
        meta[odd & (u >= 0.002) & (u < 0.0025)] |= SF.INTERNAL_CLASS
        meta[odd & (u >= 0.003) & (u < 0.0035)] = SF.TAG_NONE << 8
        metas[t] = meta
    order, offsets = SF.segment_layout(torch.from_numpy(codes).to(dev), nseg)
    limits = np.full(nseg, n, dtype=np.int64)
    few = (rng.random(nseg) < 0.05) & (np.arange(nseg) % 2 == 1)
    limits[few] = rng.integers(0, n, int(few.sum()))
    seeds, tags = A.ScanFold(prog, prog.n_leaves,
                             not isinstance(init, tuple)).encode_segments(
        [init] * nseg)
    put = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
           for a in (vals, metas, limits, seeds, tags)]
    return put[0], put[1], order, offsets, put[2], put[3], put[4]


def _lowered(name):
    """(the program of a fold of _SEGFOLD_PROGRAMS, its initial value)."""
    fn, init = _SEGFOLD_PROGRAMS[name]
    scalar = not isinstance(init, tuple)
    return lower_fold(get_udf_source(fn), 1 if scalar else len(init),
                      scalar), init


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(_SEGFOLD_PROGRAMS))
@pytest.mark.parametrize("nseg", [1, 3, 1000])
def test_seg_fold_kernel_matches_plain(name, nseg, cuda_device):
    """Every output of the kernel equals its plain version's, bits and
    tags included, over int overflow, int-float comparisons beyond 2**53,
    NaN, infinities, division by zero, term codes, Nones and limits."""
    prog, init = _lowered(name)
    inputs = _segfold_inputs(prog, init, 20_000, nseg, nseg + len(name),
                             cuda_device)
    before = segfold_cuda.launches
    got = SF.seg_fold(prog, *inputs)
    want = SF.seg_fold_plain(prog, *inputs)
    torch.cuda.synchronize()
    assert segfold_cuda.launches == before + 1
    for f in ("acc", "acc_tags", "first", "count", "stop", "status"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    st = want.status
    assert (st == SF.ST_FOLDED).any() and (st >= SF.ST_EXC).any()
    assert (want.stop >= 0).any() == (nseg > 1)


@pytest.mark.cuda
def test_seg_fold_kernel_stop_rule_and_codes(cuda_device):
    """The CPU test's hand-built case on the card: an exact class is
    recorded and skipped, an internal code and the limit stop a segment,
    and every later row of it is the host's."""
    code = torch.tensor([[SF.ACC, 0, 0, 0], [SF.TERM, 1, 0, 0],
                         [SF.ADD, 2, 0, 1], [SF.OUT, 0, 2, 0]],
                        dtype=torch.int32)
    prog = FoldProgram(code, torch.zeros((0, 2), dtype=torch.int64), [], 1,
                       "x")
    vals = torch.arange(10, dtype=torch.int64)[None, :] * 10
    metas = torch.full((1, 10), SF.TAG_INT << 8, dtype=torch.int32)
    metas[0, 3] |= SF.ZERODIVISION
    metas[0, 6] |= SF.INTERNAL_CLASS
    codes = torch.tensor([0, 1, 0, 0, 1, 0, 1, 1, 0, -1])
    order, offsets = SF.segment_layout(codes, 2)
    args = [t.to(cuda_device) for t in (
        vals, metas, order, offsets, torch.tensor([5, 10]),
        torch.tensor([[1], [2]]),
        torch.full((2, 1), SF.TAG_INT, dtype=torch.int8))]
    res = SF.seg_fold(prog, *args)
    assert res.acc.tolist() == [[21], [52]]
    assert res.first.tolist() == [0, 1] and res.count.tolist() == [2, 2]
    assert res.stop.tolist() == [5, 6]
    assert res.status.tolist() == [1, 1, 1, SF.ST_EXC + SF.ZERODIVISION, 1,
                                   2, 2, 2, 2, 0]


@pytest.mark.cuda
def test_seg_fold_wrapper_rejects_bad_inputs(cuda_device):
    prog, init = _lowered("short")
    inputs = list(_segfold_inputs(prog, init, 100, 2, 1, cuda_device))
    with pytest.raises(ValueError):
        segfold_cuda.seg_fold(prog, inputs[0].cpu(), *inputs[1:])
    bad = list(inputs)
    bad[1] = bad[1].to(torch.int64)
    with pytest.raises(TypeError):
        segfold_cuda.seg_fold(prog, *bad)


@pytest.mark.cuda
def test_decay_fold_equals_the_loops_bits_on_cuda(cuda_device):
    """`a * 0.9 + x` over 10,000 floats: the kernel rounds the product and
    the sum apart, as CPython does (no FMA), so the result has the loop's
    bits; by key too, in the loop's group order."""
    rng = np.random.default_rng(9)
    vals = [float(v) for v in rng.uniform(-1e3, 1e3, 10_000)]
    want = 0.0
    for v in vals:
        want = want * 0.9 + v
    ctx = tuplex_tpu_torch.Context({"tuplex.partitionSize": "16KB"})
    before = segfold_cuda.launches
    got = ctx.parallelize(vals).aggregate(lambda a, b: a + b,
                                          lambda a, x: a * 0.9 + x,
                                          0.0).collect()
    assert got[0].hex() == want.hex()
    assert segfold_cuda.launches > before
    m = ctx.metrics.stages[-1]
    assert m["device_rows"] == len(vals) and m["host_folded_rows"] == 0
    rows = [(int(k), v) for k, v in zip(rng.integers(0, 50, 10_000), vals)]
    groups: dict = {}
    for k, v in rows:
        groups[k] = groups.get(k, 0.0) * 0.9 + v
    got = tuplex_tpu_torch.Context().parallelize(
        rows, columns=["k", "v"]).aggregateByKey(
        lambda a, b: a + b, lambda a, x: a * 0.9 + x["v"], 0.0,
        ["k"]).collect()
    assert repr(got) == repr(list(groups.items()))


@pytest.mark.cuda
def test_lineitem_fold_jobs_on_cuda(tmp_path, cuda_device):
    """G1-G3 of chip_smoke.py on small clean and dirty files on the card,
    equal to the loops (exception counts too), through the kernel."""
    for gen in (tpch.generate_csv, tpch.generate_dirty_csv):
        path = str(tmp_path / f"{gen.__name__}.csv")
        gen(path, 3000, seed=7)
        rows = tpch.read_lineitem_dicts(path)
        for job in ("g1", "g2", "g3"):
            before = segfold_cuda.launches
            ds = getattr(tpch, "fold_" + job)(tuplex_tpu_torch.Context()
                                              .csv(path))
            got = ds.collect()
            want, excs = tpch.fold_python(rows, job)
            assert repr(got) == repr(want)
            assert ds.exception_counts() == excs
            assert segfold_cuda.launches > before
