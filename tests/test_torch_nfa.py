"""tuplex_tpu_torch.ops.nfa against the reference package's NFA and Python
`re`.

Oracles: `tuplex_tpu.ops.nfa.compile_nfa(p).match` with
TUPLEX_NFA_IMPL=pallas, which runs the reference's Pallas kernel in
interpret mode on the CPU (as tests/test_string_ops.py does), and
`re.search`. Tolerance: exact (booleans). The port's tables must equal the
reference's bit for bit.

The CPU runs the port's plain version (`match_bitmask`); the CUDA kernel is
held against it on the card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import re

import jax  # noqa: F401  (configured for the CPU by conftest)
import numpy as np
import pytest
import torch

from tuplex_tpu.ops import nfa as ref_nfa
from tuplex_tpu.ops import regex as ref_regex
from tuplex_tpu_torch.ops import nfa as port_nfa
from tuplex_tpu_torch.ops import nfa_cuda
from tuplex_tpu_torch.ops import regex as port_regex
from tuplex_tpu_torch.runtime import columns as C

STRINGS = ["", "a", "abc", "zabcz", "GET /idx HTTP/1.0", "aaab", "ab\n",
           "aXb", "2023-04-01", "foo123bar", "a" * 50 + "b"]
PATTERNS = ["abc", "a+b", "GET|POST", "a*b", "[0-9]+-[0-9]+", "^abc",
            "abc$", "^a.*b$", r"\d+", "(ab)+", "^$", "b$"]
# log grep's filter, a 64-position pattern (bit 63 in use) and a few
# classes/repeats the matrix above lacks
EXTRA = [r'" (4\d\d|5\d\d) ', "[ab]" * 64, "GET /" + "[a-z]" * 57 + "(x|y)",
         r"[^a-z]\s?x{2,3}", r"\w+@\W", "a.?b$", "^(a|b)*c"]


def _port_batch(strings):
    leaf = C.encode_str_leaf(strings, False)
    return torch.from_numpy(np.ascontiguousarray(leaf.bytes)), \
        torch.from_numpy(leaf.lengths)


def _ref_match(pattern, bytes_, lens, monkeypatch):
    monkeypatch.setenv("TUPLEX_NFA_IMPL", "pallas")
    rx = ref_nfa.compile_nfa(pattern)
    return np.asarray(rx.match(np.asarray(bytes_), np.asarray(lens))).tolist()


def _random_batch(seed: int, n: int, w: int):
    """Seeded rows over a small alphabet plus some arbitrary bytes, with
    trailing newlines, lengths 0..w."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b'ab cxGETPOS"45\n09z', dtype=np.uint8)
    mat = alphabet[rng.integers(0, len(alphabet), size=(n, w))]
    wide = rng.random(n) < 0.1
    mat[wide] = rng.integers(0, 256, size=(int(wide.sum()), w),
                             dtype=np.uint8)
    lens = rng.integers(0, w + 1, size=n).astype(np.int32)
    nl = (rng.random(n) < 0.2) & (lens > 0)
    mat[np.nonzero(nl)[0], lens[nl] - 1] = 10
    mat[np.arange(w)[None, :] >= lens[:, None]] = 0
    return mat, lens


@pytest.mark.parametrize("pattern", PATTERNS + EXTRA)
def test_port_matches_reference_pallas_and_re(pattern, monkeypatch):
    b, l = _port_batch(STRINGS)
    got = port_nfa.compile_nfa(pattern).match(b, l).tolist()
    assert got == [re.search(pattern, s) is not None for s in STRINGS]
    assert got == _ref_match(pattern, b.numpy(), l.numpy(), monkeypatch)


@pytest.mark.parametrize("pattern", PATTERNS + EXTRA)
def test_tables_from_reference_equal_own_compile(pattern):
    ref = ref_nfa.compile_nfa(pattern)
    own = port_nfa.compile_nfa(pattern).tables
    assert port_nfa.tables_from_reference(ref) == own
    npz_like = {k: getattr(ref, k) for k in (
        "_classtab", "_follow_np", "first", "last", "n_pos", "nullable",
        "anchored_start", "anchored_end")}
    assert port_nfa.tables_from_reference(npz_like) == own


@pytest.mark.parametrize("n", [255, 256, 257, 513])
def test_block_edge_sizes(n, monkeypatch):
    """Row counts around the reference kernel's 256-row block."""
    strings = [("ab" if i % 3 == 0 else f"x{i}") for i in range(n)]
    b, l = _port_batch(strings)
    got = port_nfa.compile_nfa("a+b$").match(b, l).tolist()
    assert got == [re.search("a+b$", s) is not None for s in strings]
    assert got == _ref_match("a+b$", b.numpy(), l.numpy(), monkeypatch)


@pytest.mark.parametrize("pattern", ["GET|POST", r'" (4\d\d|5\d\d) ',
                                     "b$", "^a.*b$", "a*b", "[ab]" * 64])
def test_seeded_byte_matrices(pattern, monkeypatch):
    mat, lens = _random_batch(7, 300, 40)
    got = port_nfa.compile_nfa(pattern).match(
        torch.from_numpy(mat), torch.from_numpy(lens)).tolist()
    assert got == _ref_match(pattern, mat, lens, monkeypatch)
    rows = [bytes(r[:k]) for r, k in zip(mat, lens)]
    assert got == [re.search(pattern.encode(), r) is not None for r in rows]


@pytest.mark.parametrize("pattern", [
    "^abc", "abc", "^(a|b)c", "^a+b$", "^[0-9]{2,3}-x", "^(ab)+", r"^\d+\s*$",
    "^a^b", "^(?i)abc", "GET|POST", "^.*(x|y)", r'" (4\d\d|5\d\d) ',
    r"^\bfoo", r"^[^\W]x", "^a{2}", "^(?:ab)c", "^a|b", "^(", "^a$b"])
def test_anchored_engine_decision_matches_reference(pattern):
    """The emitter takes the NFA exactly where the reference does: the port
    must accept a pattern for the anchored engine iff the reference's
    compile_regex does (the port then interprets it)."""
    try:
        ref_regex.compile_regex(pattern)
        want = True
    except Exception:
        want = False
    assert port_regex.anchored_engine_accepts(pattern) == want


@pytest.mark.parametrize("pattern", PATTERNS + EXTRA)
def test_follow_chunks_transition(pattern):
    """The CUDA kernel's byte-chunked transition: for 512 seeded state sets
    S, OR over c of F8[c][(S >> 8c) & 0xff] equals the OR of follow[p] over
    the set bits p of S; F8 from the port's tables equals F8 from the
    reference's; the kernel's table buffer holds CLASSTAB, F8 (FIRST folded
    into chunk 0 unless the pattern has '^'), FIRST and LAST."""
    own = port_nfa.compile_nfa(pattern).tables
    f8 = port_nfa.follow_chunks(own.follow, own.n_pos)
    nchunk = (own.n_pos + 7) // 8
    assert f8.shape == (nchunk, 256) and f8.dtype == np.uint64
    ref = port_nfa.tables_from_reference(ref_nfa.compile_nfa(pattern))
    assert np.array_equal(port_nfa.follow_chunks(ref.follow, ref.n_pos), f8)
    rng = np.random.default_rng(3)
    live = (1 << own.n_pos) - 1
    for s in rng.integers(0, 1 << 63, size=512, dtype=np.uint64):
        S = (int(s) << 1 | int(s) >> 62) & live
        want = 0
        for p in range(own.n_pos):
            if S >> p & 1:
                want |= int(own.follow[p])
        got = 0
        for c in range(nchunk):
            got |= int(f8[c][(S >> 8 * c) & 0xFF])
        assert got == want
    buf = nfa_cuda.pack_tables(own)
    assert buf.dtype == np.uint64 and buf.shape == (256 * (1 + nchunk) + 2,)
    assert np.array_equal(buf[:256], own.classtab)
    seed = np.uint64(0 if own.anchored_start else own.first)
    f8[:1] |= seed
    assert np.array_equal(buf[256:-2], f8.ravel())
    assert buf[-2:].tolist() == [own.first, own.last]


def test_too_many_positions_is_not_compilable():
    from tuplex_tpu_torch.core.errors import NotCompilable

    with pytest.raises(NotCompilable):
        port_nfa.compile_nfa("[ab]" * 65)
