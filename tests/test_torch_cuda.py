"""tuplex_tpu_torch on the card: the CUDA NFA scan and start scan, the
CUDA join probe and the CUDA general fold against their plain versions,
the string kernels and the aggregate reductions on CUDA against the same
ops on the CPU, and the pipelines (smoke, log grep, Zillow Z1, TPC-H Q6,
Q1 and Q19, NYC 311, flights, the weblogs variants and the status grep)
through Context() on CUDA.

Every test here is marked `cuda` and skips without a GPU. This file
imports neither jax nor tuplex_tpu, so it runs on a GPU host without them:

    python3 -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Oracles: the plain versions (`NFARegex.match_bitmask`,
`NFARegex.match_start_plain`, `ops/join.py:lower_bound_plain`,
`ops/segfold.py:seg_fold_plain`) on the same CUDA tensors, Python `re`,
the CPU run of each string kernel (itself held against the reference
package by tests/test_torch_strings.py), and a plain Python loop. Tolerance: exact.
"""

import ast
import contextlib
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


def _random_batch(seed: int, n: int, w: int, lens=None):
    """Seeded rows [n, w] over a small alphabet (a tenth of them any
    byte), zero past their lengths: `lens` (int32 [n]) or random in
    [0, w]."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b'ab cxGETPOS"45\n09z', dtype=np.uint8)
    mat = alphabet[rng.integers(0, len(alphabet), size=(n, w))]
    wide = rng.random(n) < 0.1
    mat[wide] = rng.integers(0, 256, size=(int(wide.sum()), w),
                             dtype=np.uint8)
    if lens is None:
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


START_PATTERNS = [logs.STATUS_GROUPS, r"\S+x", "a+b$", "GET|POST",
                  "^a.*b$", "[ab]" * 32, "b\n?$", "x$", logs.ERROR_LINE]


def _check_start(rx, pattern, b, l, live=None):
    """The start kernel on CUDA tensors b, l (rows where the bool mask
    `live` is True, or all) against match_start_plain on the same tensors
    and against re.search(...).start() on their rows; one launch per
    call."""
    before = nfa_cuda.start_launches
    m, s = rx.match_start(b, l, live=live)
    assert nfa_cuda.start_launches == before + 1
    pm, ps = rx.match_start_plain(b, l, live)
    assert torch.equal(m, pm) and torch.equal(s, ps)
    mat, lens = b.cpu().numpy(), l.cpu().numpy()
    keep = [True] * len(lens) if live is None else live.cpu().tolist()
    rows = [bytes(r[:k]) for r, k in zip(mat, lens)]
    py = [re.search(pattern.encode(), r) if k else None
          for r, k in zip(rows, keep)]
    assert m.tolist() == [x is not None for x in py]
    assert s.tolist() == [x.start() if x else 0 for x in py]


def _start_masks(rx, b, l, seed: int) -> dict:
    """Live masks on b's device: all, none, 1%, 22% and 90% of the rows
    (seeded), and the NFA scan's own result."""
    n = b.shape[0]
    rng = np.random.default_rng(seed)
    out = {"all": torch.ones(n, dtype=torch.bool, device=b.device),
           "none": torch.zeros(n, dtype=torch.bool, device=b.device),
           "scan's own": rx.match(b, l)}
    for frac in (0.01, 0.22, 0.9):
        out[f"{frac:.0%}"] = torch.from_numpy(rng.random(n) < frac).to(
            b.device)
    return out


# 8-byte rows (4-byte loads), bytes, 16-byte loads, eight column chunks;
# rows of length 0, trailing newlines, a leading class run (\S+x)
@pytest.mark.cuda
@pytest.mark.parametrize("w", [72, 75, 128, 1000])
@pytest.mark.parametrize("pattern", START_PATTERNS)
def test_start_kernel_matches_plain_and_re(pattern, w, cuda_device):
    mat, lens = _random_batch(17, 1001, w)
    _check_start(port_nfa.compile_nfa(pattern), pattern,
                 torch.from_numpy(mat).to(cuda_device),
                 torch.from_numpy(lens).to(cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", START_PATTERNS)
def test_start_kernel_block_and_alignment_edges(pattern, cuda_device):
    """Row counts around the block (1, R-1, R, R+1), rows whose match ends
    at the length or before a final newline, and bases that are not
    16-byte aligned (byte loads and 4-byte loads)."""
    rx = port_nfa.compile_nfa(pattern)
    R = nfa_cuda.rows_per_block()
    for n in (1, R - 1, R, R + 1):
        mat, lens = _random_batch(23 + n, n, 96)
        _check_start(rx, pattern, torch.from_numpy(mat).to(cuda_device),
                     torch.from_numpy(lens).to(cuda_device))
    ends = ["", "\n", "x", "ab", "ab\n", "b\n\n", 'a" 404 - ', '" 500 x\n',
            "zzzzx", "aaab\n", "GET", "b"]
    leaf = C.encode_str_leaf(ends, False)
    _check_start(rx, pattern,
                 torch.from_numpy(np.ascontiguousarray(leaf.bytes)).to(
                     cuda_device),
                 torch.from_numpy(leaf.lengths).to(cuda_device))
    mat, lens = _random_batch(5, 301, 75)
    b = torch.from_numpy(mat).to(cuda_device)[1:]
    assert b.is_contiguous() and b.data_ptr() % 16 != 0
    _check_start(rx, pattern, b, torch.from_numpy(lens[1:]).to(cuda_device))
    mat, lens = _random_batch(6, 300, 128)
    flat = torch.zeros(4 + mat.size, dtype=torch.uint8, device=cuda_device)
    flat[4:] = torch.from_numpy(mat.ravel()).to(cuda_device)
    b = flat[4:].view(300, 128)
    assert b.data_ptr() % 16 == 4
    _check_start(rx, pattern, b, torch.from_numpy(lens).to(cuda_device))


@pytest.mark.cuda
def test_start_wrapper_rejects_bad_inputs(cuda_device):
    t = port_nfa.compile_nfa("abc").tables
    buf = torch.from_numpy(nfa_cuda.pack_start_tables(t).view(np.int32)).to(
        cuda_device)
    b = torch.zeros((4, 8), dtype=torch.uint8, device=cuda_device)
    l = torch.zeros(4, dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        nfa_cuda.match_start_cuda(t, buf, b, l.to(torch.int64))
    with pytest.raises(ValueError):
        nfa_cuda.match_start_cuda(t, buf, b.t(), l)
    with pytest.raises(ValueError):
        nfa_cuda.match_start_cuda(t, buf, b, l.cpu())
    with pytest.raises(ValueError):
        nfa_cuda.match_start_cuda(t, buf[:-1], b, l)
    big = port_nfa.compile_nfa("[ab]" * 33).tables
    with pytest.raises(ValueError):
        nfa_cuda.match_start_cuda(big, buf, b, l)
    # the packed tables are 32-bit: a 64-bit buffer is refused
    wide = torch.zeros(256 * 2 + 2, dtype=torch.int64, device=cuda_device)
    with pytest.raises(ValueError):
        nfa_cuda.match_start_cuda(t, wide, b, l)
    # the live mask: bool, [N], contiguous, on the rows' device
    live = torch.ones(4, dtype=torch.bool, device=cuda_device)
    with pytest.raises(TypeError):
        nfa_cuda.match_start_cuda(t, buf, b, l, live.to(torch.uint8))
    with pytest.raises(ValueError):
        nfa_cuda.match_start_cuda(t, buf, b, l, live[:3])
    with pytest.raises(ValueError):
        nfa_cuda.match_start_cuda(t, buf, b, l, live.cpu())
    with pytest.raises(ValueError):
        nfa_cuda.match_start_cuda(
            t, buf, b, l, torch.ones(8, dtype=torch.bool,
                                     device=cuda_device)[::2])


# 1 to 4 follow chunks, with and without '$'
START_CHUNK_PATTERNS = [logs.STATUS_GROUPS, "a+b$", "[ab]" * 16,
                        "[ab]" * 15 + "b$", "[ab]" * 24, "[ab]" * 23 + "$",
                        "[ab]" * 32, "[ab]" * 31 + "b$"]


@pytest.mark.cuda
@pytest.mark.parametrize("w", [75, 96, 128, 1000])
@pytest.mark.parametrize("pattern", START_CHUNK_PATTERNS)
def test_start_kernel_live_masks(pattern, w, cuda_device):
    """Every mask (all, none, 1%, 22%, 90%, the scan's own) and no mask,
    over byte loads (75), 16-byte loads (96, 128) and 16 column chunks
    (1000); lane-replicated tables at one follow chunk, plain past it."""
    mat, lens = _random_batch(29, 4100, w)
    b = torch.from_numpy(mat).to(cuda_device)
    l = torch.from_numpy(lens).to(cuda_device)
    rx = port_nfa.compile_nfa(pattern)
    _check_start(rx, pattern, b, l, None)
    for live in _start_masks(rx, b, l, w).values():
        _check_start(rx, pattern, b, l, live)


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", [logs.STATUS_GROUPS, "a+b$",
                                     "[ab]" * 16, "[ab]" * 15 + "b$"])
def test_start_kernel_short_round_then_long(pattern, cuda_device):
    """Rounds of rows that fit one 64-byte column chunk followed by rounds
    of longer rows, every row live: a round of one chunk starts the next
    round's set-up straight after its own, so the block's per-warp maxima
    must not be overwritten while another warp still reads them. One
    window, then eight with short and long rounds in turn; each launched
    several times. Lane-replicated tables (one chunk) and plain (two),
    with and without '$'."""
    rx = port_nfa.compile_nfa(pattern)
    v = nfa_cuda.start_variant((rx.n_pos + 7) // 8, rx.tables.anchored_end)
    R, K = v.threads, v.window
    rng = np.random.default_rng(41)
    for n in (K, 8 * K):
        short = (np.arange(n) // R) % 2 == 0
        lens = np.where(short, rng.integers(1, 65, size=n),
                        rng.integers(65, 97, size=n)).astype(np.int32)
        mat, lens = _random_batch(43 + n, n, 96, lens)
        b = torch.from_numpy(mat).to(cuda_device)
        l = torch.from_numpy(lens).to(cuda_device)
        pm, ps = rx.match_start_plain(b, l, None)
        for live in (None, torch.ones(n, dtype=torch.bool,
                                      device=cuda_device)):
            for _ in range(10):
                m, st = rx.match_start(b, l, live=live)
                assert torch.equal(m, pm) and torch.equal(st, ps)
        _check_start(rx, pattern, b, l)


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", [logs.STATUS_GROUPS, "a+b$",
                                     "[ab]" * 24])
def test_start_kernel_window_edges(pattern, cuda_device):
    """Row counts around the round (R) and the candidate window (K) of
    the variant the pattern takes, and masks that leave a window 0, 1 or
    all of its rows; bases that are not 16-byte aligned, with a mask."""
    rx = port_nfa.compile_nfa(pattern)
    v = nfa_cuda.start_variant((rx.n_pos + 7) // 8, rx.tables.anchored_end)
    R, K = v.threads, v.window
    assert K > R
    for n in (1, R - 1, R, R + 1, K - 1, K, K + 1, 2 * K + R + 3):
        mat, lens = _random_batch(31 + n, n, 96)
        b = torch.from_numpy(mat).to(cuda_device)
        l = torch.from_numpy(lens).to(cuda_device)
        idx = torch.arange(n, device=cuda_device)
        masks = list(_start_masks(rx, b, l, n).values()) + [
            idx == n // 2,                        # one live row
            (idx // K) % 2 == 1,                  # windows dead, then live
            (idx % K) == K - 1]                   # each window's last row
        for live in masks:
            _check_start(rx, pattern, b, l, live)
    mat, lens = _random_batch(5, 301, 75)
    b = torch.from_numpy(mat).to(cuda_device)[1:]
    l = torch.from_numpy(lens[1:]).to(cuda_device)
    assert b.is_contiguous() and b.data_ptr() % 16 != 0
    for live in _start_masks(rx, b, l, 1).values():
        _check_start(rx, pattern, b, l, live)
    mat, lens = _random_batch(6, 300, 128)
    flat = torch.zeros(4 + mat.size, dtype=torch.uint8, device=cuda_device)
    flat[4:] = torch.from_numpy(mat.ravel()).to(cuda_device)
    b = flat[4:].view(300, 128)
    l = torch.from_numpy(lens).to(cuda_device)
    assert b.data_ptr() % 16 == 4
    for live in _start_masks(rx, b, l, 2).values():
        _check_start(rx, pattern, b, l, live)
    # lengths past the width, the last row's too: the bytes stop at W and
    # '$' goes by the length, as in the plain version (not `re` on the
    # cut row); the copies stay inside the matrix
    mat, lens = _random_batch(7, 300, 96)
    lens[::3] = 97 + np.arange(len(lens[::3])) % 2
    lens[-1] = 98
    b = torch.from_numpy(mat).to(cuda_device)
    l = torch.from_numpy(lens).to(cuda_device)
    for live in [None, *_start_masks(rx, b, l, 3).values()]:
        m, st = rx.match_start(b, l, live=live)
        pm, pst = rx.match_start_plain(b, l, live)
        assert torch.equal(m, pm) and torch.equal(st, pst)


@pytest.mark.cuda
@pytest.mark.parametrize("frac", [None, 0.22, 0.9])
def test_start_kernel_many_windows_a_block(frac, cuda_device):
    """Enough rows that every block of the persistent grid compacts
    several windows and carries rows over between rounds."""
    v = nfa_cuda.start_variant(1)
    n = 3 * v.blocks_per_sm * v.sms * v.window + 7
    mat, lens = _random_batch(37, n, 96)
    b = torch.from_numpy(mat).to(cuda_device)
    l = torch.from_numpy(lens).to(cuda_device)
    live = None if frac is None else torch.from_numpy(
        np.random.default_rng(3).random(n) < frac).to(cuda_device)
    for pattern in (logs.STATUS_GROUPS, "a+b$"):
        rx = port_nfa.compile_nfa(pattern)
        before = nfa_cuda.start_launches
        m, s = rx.match_start(b, l, live=live)
        assert nfa_cuda.start_launches == before + 1
        pm, ps = rx.match_start_plain(b, l, live)
        assert torch.equal(m, pm) and torch.equal(s, ps)


@pytest.mark.cuda
def test_start_variants(cuda_device):
    """Lane-replicated tables at one follow chunk, one block of 1024 rows
    an SM; plain tables at 2-4 chunks, at least 2 blocks of 256 rows an
    SM; with and without '$'."""
    for end in (False, True):
        for n_chunks in (1, 2, 3, 4):
            v = nfa_cuda.start_variant(n_chunks, end)
            if n_chunks == 1:
                assert (v.replicated, v.blocks_per_sm, v.threads) == \
                    (True, 1, 1024)
            else:
                assert (v.replicated, v.threads) == (False, 256)
                assert v.blocks_per_sm >= 2
            assert v.window > v.threads


@pytest.mark.cuda
def test_weblogs_and_status_grep_on_cuda(tmp_path, cuda_device):
    path = str(tmp_path / "access.log")
    logs.generate_log(path, 5000, seed=17, non_ascii_every=1000)
    for mode, limit in (("strip", 5), ("regex", 5 + 157)):
        ctx = tuplex_tpu_torch.Context()
        assert logs.build_pipeline(ctx.text(path), mode).collect() == \
            logs.run_reference_python(path, mode)
        assert ctx.metrics.interpreterRows() <= limit
    ctx = tuplex_tpu_torch.Context()
    before = (nfa_cuda.launches, nfa_cuda.start_launches)
    assert logs.build_status_grep(ctx.text(path)).collect() == \
        logs.run_status_grep_reference(path)
    assert nfa_cuda.launches > before[0]
    assert nfa_cuda.start_launches > before[1]
    assert ctx.metrics.interpreterRows() == 5


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


def _segfold_inputs(prog, init, n, nseg, seed, dev, codes=None):
    """Seeded terms for programs over x[0] (floats with NaN, signed zeros
    and infinities), x[1] (ints), x[2] (bools) and x[3] (small ints with
    zeros); exact classes in some rows. What stops a segment (ints beyond
    2**53 and near int64's ends, internal codes, Nones, a limit row) only
    in odd segments, so that even ones fold to their end. `codes` [n]
    gives each row's segment (-1: none), else they are drawn."""
    rng = np.random.default_rng(seed)
    if codes is None:
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


def _same_fold(prog, inputs):
    """The kernel's six outputs against its plain version's; returns the
    plain result."""
    before = segfold_cuda.launches
    got = SF.seg_fold(prog, *inputs)
    want = SF.seg_fold_plain(prog, *inputs)
    torch.cuda.synchronize()
    assert segfold_cuda.launches == before + 1
    for f in ("acc", "acc_tags", "first", "count", "stop", "status"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    return want


def _sized_codes(lens, seed: int):
    """Row codes giving segment s exactly lens[s] rows, the segments'
    rows interleaved, and some rows in no segment."""
    rng = np.random.default_rng(seed)
    codes = np.concatenate([np.repeat(np.arange(len(lens)), lens),
                            np.full(len(lens) + 7, -1)])
    return rng.permutation(codes)


# a warp stages TILE rows at once; LONG_ROWS rows take a warp
_TILE = 32
_SEG_LENS = [0, 1, _TILE - 1, _TILE, _TILE + 1, 2 * _TILE - 1, 2 * _TILE,
             2 * _TILE + 1, 3 * _TILE - 1, 3 * _TILE, 3 * _TILE + 1,
             3 * _TILE + 5]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["short", "mixed", "locals"])
@pytest.mark.parametrize("length", _SEG_LENS)
def test_seg_fold_kernel_segment_lengths(name, length, cuda_device):
    """Two segments of one length (one folds to its end, one may stop),
    across the tile and the warp layout's thresholds."""
    prog, init = _lowered(name)
    codes = _sized_codes([length, length], length)
    inputs = _segfold_inputs(prog, init, len(codes), 2, length, cuda_device,
                             codes)
    _same_fold(prog, inputs)
    assert segfold_cuda.layout_counts(inputs[3].cpu()) == (
        (2, 0) if length >= segfold_cuda.LONG_ROWS else (0, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(_SEGFOLD_PROGRAMS))
def test_seg_fold_kernel_both_layouts_in_one_launch(name, cuda_device):
    """Every length of _SEG_LENS and long segments of 500-3,000 rows in
    one launch: warps and threads side by side."""
    prog, init = _lowered(name)
    lens = _SEG_LENS * 3 + [500, 1234, 3000, 64 * 40 + 3]
    codes = _sized_codes(lens, 5)
    inputs = _segfold_inputs(prog, init, len(codes), len(lens), 11,
                             cuda_device, codes)
    want = _same_fold(prog, inputs)
    n_long, n_short = segfold_cuda.layout_counts(inputs[3].cpu())
    assert n_long > 0 and n_short > 0
    assert (want.status == SF.ST_FOLDED).any()


@pytest.mark.cuda
def test_seg_fold_kernel_stops_and_limits_at_tile_edges(cuda_device):
    """An internal code on the first and on the last row of a warp's
    tile, and a limit on a tile boundary, in long segments; a stop on a
    short segment's first row. Even segments fold to their end otherwise,
    so each stop is where it was put."""
    prog, init = _lowered("short")
    lens = [5 * _TILE] * 8 + [40] * 4
    codes = _sized_codes(lens, 3)
    vals, metas, order, offsets, limits, seeds, tags = _segfold_inputs(
        prog, init, len(codes), len(lens), 3, cuda_device, codes)
    seg_rows = [order[offsets[s]:offsets[s + 1]].cpu() for s in
                range(len(lens))]
    metas = metas.clone()
    limits = limits.clone()
    want_stop = {}
    for s, at in ((0, 2 * _TILE), (2, 3 * _TILE - 1), (8, 0)):
        r = int(seg_rows[s][at])
        metas[:, r] = SF.INTERNAL_CLASS
        want_stop[s] = r
    r = int(seg_rows[4][3 * _TILE])
    limits[4] = r
    want_stop[4] = r
    want = _same_fold(prog, (vals, metas, order, offsets, limits, seeds,
                             tags))
    for s, r in want_stop.items():
        assert int(want.stop[s]) == r, s
        assert int(want.count[s]) < lens[s]
    assert int(want.stop[6]) == -1 and int(want.stop[10]) == -1


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["short", "ints", "builtins"])
def test_seg_fold_kernel_one_long_segment(name, cuda_device):
    """One segment of 200,000 rows (the warp layout over 6,250 tiles)."""
    prog, init = _lowered(name)
    codes = np.zeros(200_000, dtype=np.int64)
    codes[::997] = -1
    inputs = _segfold_inputs(prog, init, len(codes), 1, 17, cuda_device,
                             codes)
    want = _same_fold(prog, inputs)
    assert int(want.count[0]) > 150_000


@pytest.mark.cuda
@pytest.mark.parametrize("nseg", [1, 3])
def test_seg_fold_kernel_decay_bits(nseg, cuda_device):
    """`a * 0.9 + x` straight through the wrapper over 200,000 floats: the
    product and the sum round apart (__dmul_rn, __dadd_rn), so every
    segment's result has a loop's bits."""
    def decay(a, x):
        return a * 0.9 + x

    prog = lower_fold(get_udf_source(decay), 1, True)
    rng = np.random.default_rng(23)
    n = 200_000
    v = rng.uniform(-1e3, 1e3, n)
    codes = rng.integers(0, nseg, n)
    order, offsets = SF.segment_layout(torch.from_numpy(codes), nseg)
    inputs = [torch.from_numpy(v.view(np.int64))[None, :],
              torch.full((1, n), SF.TAG_FLOAT << 8, dtype=torch.int32),
              order, offsets, torch.full((nseg,), n),
              torch.zeros((nseg, 1), dtype=torch.int64),
              torch.full((nseg, 1), SF.TAG_FLOAT, dtype=torch.int8)]
    got = SF.seg_fold(prog, *[t.to(cuda_device) for t in inputs])
    want = [0.0] * nseg
    for x, k in zip(v.tolist(), codes.tolist()):
        want[k] = want[k] * 0.9 + x
    assert got.acc[:, 0].cpu().numpy().view(np.float64).tolist() == want


@pytest.mark.cuda
def test_seg_fold_kernel_float_floordiv_mod_edges(cuda_device):
    """Float `//` and `%` (the kernel's exact remainder: one FMA where the
    quotient is below 2**53, libm's fmod beyond) over quotients near
    integers, exact multiples, huge and tiny ratios, signed zeros,
    infinities and NaN. One row a segment, the divisor its accumulator,
    so every result is an output."""
    def divmod_fold(a, x):
        return (x // a[0], x % a[0])

    prog = lower_fold(get_udf_source(divmod_fold), 2, False)
    ops = {q[0] for q in SF.decoded(prog, 2).code.tolist()}
    assert {SF.FLOORDIV, SF.MOD} <= ops
    rng = np.random.default_rng(31)
    n = 60_000
    y = rng.uniform(-50.0, 50.0, n) * 10.0 ** rng.integers(-5, 6, n)
    q = rng.integers(-(1 << 20), 1 << 20, n).astype(np.float64)
    x = q * y + rng.choice([0.0, 1e-12, -1e-12, 0.5], n) * y
    x[::7] = rng.uniform(-1e300, 1e300, len(x[::7]))
    x[::11] = np.nextafter(x[::11], np.inf)
    y[::13] = np.nextafter(y[::13], -np.inf)
    for at, v in ((0, -0.0), (1, np.inf), (2, -np.inf), (3, np.nan),
                  (4, 1e-308), (5, 5e-324)):
        x[at] = v
    for at, v in ((6, np.inf), (7, -np.inf), (8, np.nan), (9, 5e-324),
                  (10, -0.0)):
        y[at] = v
    order, offsets = SF.segment_layout(torch.arange(n), n)
    seeds, tags = A.ScanFold(prog, 2, False).encode_segments(
        [(float(v), 0.0) for v in y])
    nt = len(prog.terms)            # each `x` is a term of its own
    inputs = [t.to(cuda_device) for t in (
        torch.from_numpy(np.stack([x] * nt).view(np.int64).copy()),
        torch.full((nt, n), SF.TAG_FLOAT << 8, dtype=torch.int32),
        order, offsets, torch.full((n,), n), torch.from_numpy(seeds),
        torch.from_numpy(tags))]
    want = _same_fold(prog, inputs)
    assert (want.status == SF.ST_EXC + SF.ZERODIVISION).sum() == 1
    assert (want.status == SF.ST_FOLDED).sum() == n - 1


# ---------------------------------------------------------------------------
# the compile plane: CUDA graphs replayed against the eager path
# ---------------------------------------------------------------------------

def _plane_jobs(tmp_path):
    from tuplex_tpu_torch.models import logs, zillow

    log = str(tmp_path / "a.log")
    logs.generate_log(log, 6000, seed=17, non_ascii_every=1000)
    z = str(tmp_path / "z.csv")
    zillow.generate_csv(z, 3000, seed=7)
    return {
        "log grep": lambda c: logs.build_grep(c.text(log)),
        "zillow": lambda c: zillow.build_pipeline(c.csv(z)),
        "weblogs regex": lambda c: logs.build_pipeline(c.text(log), "regex"),
        "status grep": lambda c: logs.build_status_grep(c.text(log)),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("job", ["log grep", "zillow", "weblogs regex",
                                 "status grep"])
def test_graph_replays_equal_the_eager_path(job, tmp_path, cuda_device):
    """Each job eagerly (compilequeue.eager()), then through the store
    twice (captures, then replays only): rows equal bit for bit (repr), the
    same exceptions, and the kernel counters (nfa_scan, nfa_start, the
    anchored engine) the same in all three runs."""
    from tuplex_tpu_torch.exec import compilequeue as CQ
    from tuplex_tpu_torch.ops import regex as RX

    make = _plane_jobs(tmp_path)[job]
    conf = {"tuplex.partitionSize": "128KB"}   # several partitions
    runs = []
    CQ.clear()
    for mode in ("eager", "capture", "replay"):
        nfa_cuda.launches = nfa_cuda.start_launches = RX.calls = 0
        ctx = tuplex_tpu_torch.Context(conf=conf)
        with CQ.eager() if mode == "eager" else contextlib.nullcontext():
            ds = make(ctx)
            rows = ds.collect()
        torch.cuda.synchronize()
        runs.append((repr(rows), ds.exception_counts(), (
            nfa_cuda.launches, nfa_cuda.start_launches, RX.calls),
            ctx.metrics))
    assert runs[0][:3] == runs[1][:3] == runs[2][:3]
    cap, rep = runs[1][3], runs[2][3]
    assert cap.graphDeclines() == {}, CQ.declines()
    assert cap.stageCompileCount() >= 1
    assert rep.stageCompileCount() == 0 and rep.graphReplays() >= 2
    assert rep.compileTime() == 0.0


@pytest.mark.cuda
def test_evicted_graphs_return_their_pool(tmp_path, cuda_device,
                                          monkeypatch):
    """The store counts the memory its graphs' pool holds, and evicting
    the graphs gives it back: after `shrink(0)` the card's reserved memory
    (the allocator's cache emptied) falls by at least the pool's bytes.
    With a capacity below one job's graphs a later job's captures start
    pools of their own and evict the earlier job's graphs, pools and all."""
    from tuplex_tpu_torch.exec import compilequeue as CQ

    jobs = _plane_jobs(tmp_path)
    conf = {"tuplex.partitionSize": "128KB"}

    def reserved():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        return torch.cuda.memory_reserved()

    CQ.clear()
    r0 = reserved()
    jobs["weblogs regex"](tuplex_tpu_torch.Context(conf=conf)).collect()
    first = CQ.STORE.pool_bytes()
    assert first > 0 and len(CQ.STORE.pools()) == 1
    assert CQ.STORE.nbytes == first + sum(g.nbytes
                                          for g in CQ.STORE.graphs())
    r1 = reserved()
    assert r1 - r0 >= first
    CQ.STORE.shrink(0)
    assert len(CQ.STORE) == 0 and CQ.STORE.nbytes == 0
    assert r1 - reserved() >= first

    jobs["weblogs regex"](tuplex_tpu_torch.Context(conf=conf)).collect()
    old = CQ.STORE.pools()
    monkeypatch.setattr(CQ.STORE, "capacity", 1)
    ctx = tuplex_tpu_torch.Context(conf=conf)
    jobs["zillow"](ctx).collect()
    assert ctx.metrics.stageCompileCount() >= 1
    assert len(CQ.STORE) == 1 and CQ.STORE.evictions > 0
    assert all(p is not q for p in old for q in CQ.STORE.pools())
    CQ.clear()


# ---------------------------------------------------------------------------
# the planner: take, segments and the pushed filter's stage on the card
# ---------------------------------------------------------------------------

def _grep_lines(path):
    return [x for x in open(path, encoding="utf-8").read().splitlines()
            if re.search(r"GET", x) is not None]


@pytest.mark.cuda
def test_take_stops_dispatching_past_the_window(tmp_path, cuda_device):
    """take(10) on a grep over many partitions: the loop's first 10 rows;
    the stage dispatches the partition that meets the limit and the
    window after it, no more, and the scan launches once for each."""
    from tuplex_tpu_torch.exec import local

    log = logs.generate_log(str(tmp_path / "a.log"), 20000, seed=17)
    ctx = tuplex_tpu_torch.Context(conf={"tuplex.partitionSize": "64KB"})
    ds = ctx.text(log).filter(lambda x: re.search(r"GET", x) is not None)
    nfa_cuda.launches = 0
    assert ds.take(10) == _grep_lines(log)[:10]
    (m,) = ctx.metrics.stages
    assert m["dispatched_parts"] == 1 + local._WINDOW
    assert m["dropped_parts"] == local._WINDOW
    assert nfa_cuda.launches == m["dispatched_parts"]


@pytest.mark.cuda
def test_segments_capture_and_replay_their_own_graphs(tmp_path,
                                                      cuda_device):
    """A grep, a map the emitter refuses (set), a compiled map: three
    segments, the middle one on the interpreter. Each compiled segment
    captures its own graph in the first job and replays it in the second;
    the interpreter runs exactly the rows the filter keeps."""
    from tuplex_tpu_torch.exec import compilequeue as CQ

    log = logs.generate_log(str(tmp_path / "a.log"), 20000, seed=17)
    conf = {"tuplex.partitionSize": "128KB"}
    want = [(len(set(x)), 1) for x in _grep_lines(log)]
    CQ.clear()
    for run in ("capture", "replay"):
        nfa_cuda.launches = 0
        ctx = tuplex_tpu_torch.Context(conf=conf)
        ds = ctx.text(log).filter(
            lambda x: re.search(r"GET", x) is not None) \
            .map(lambda x: len(set(x))).map(lambda y: (y, 1))
        assert ds.collect() == want
        seg = ctx.metrics.stages
        assert [s["tier"] for s in seg] == ["compiled", "interpreter",
                                            "compiled"]
        assert seg[1]["interpreter_rows"] == len(want)
        parts = seg[0]["dispatched_parts"]
        assert parts > 2 and nfa_cuda.launches == parts
        for s in (seg[0], seg[2]):
            if run == "capture":
                assert s["stage_compiles"] >= 1
            else:
                assert s["stage_compiles"] == 0 and s["graph_replays"] >= 2
        assert ctx.metrics.graphDeclines() == {}, CQ.declines()
    CQ.clear()


@pytest.mark.cuda
def test_pushed_filter_stage_keeps_the_handoff(tmp_path, cuda_device):
    """Flights with the defunct filter pushed between the carrier join
    and the Origin join: that stage takes the join's output as a device
    view and hands its own to the next join, no partition by the host
    route; the rows equal the loop's."""
    p = flights.generate_perf_csv(str(tmp_path / "perf.csv"), 3000,
                                  seed=13)
    pc = flights.generate_carrier_csv(str(tmp_path / "carrier.csv"))
    pa = flights.generate_airport_db(str(tmp_path / "airports.txt"))
    ctx = tuplex_tpu_torch.Context(conf={"tuplex.partitionSize": "256KB"})
    rows = flights.build_pipeline(ctx, p, pc, pa).collect()
    assert rows == flights.run_reference_python(p, pc, pa)
    stages = ctx.metrics.stages
    is_join = ["device_probed_rows" in s for s in stages]
    first = is_join.index(True)
    carrier, pushed = stages[first], stages[first + 1]
    assert not is_join[first + 1]
    for s in (carrier, pushed):
        assert s["handoff_parts"] > 0 and s["host_route_parts"] == 0
    assert pushed["tier"] == "compiled" and pushed["forced_leaves"] == 0
    joins = [s for s in stages if "device_probed_rows" in s]
    assert joins[1]["device_probed_rows"] == len(rows) < 3000
