"""The leftmost-start scan's live mask (`NFARegex.match_start(..., live=)`)
on the CPU, against the unmasked scan, the reference package and CPython.

`match_start_plain(bytes, lens, live)` must equal the unmasked result
where `live` is True and give (False, 0) elsewhere, for random masks and
for the NFA scan's own result (`NFARegex.match`, the mask the two-pass
capture path passes). With that mask it must equal
`tuplex_tpu.ops.nfa.NFARegex.match_start` and `re.search(...).start()`,
since the scan's truth value is the start scan's `matched`. The emitter's
two-pass path must hand `match_start` the scan's result, and the status
grep's rows must not change. Tolerance: exact (booleans and int32
offsets). The CUDA kernel is held to `match_start_plain` with the same
masks on the card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import random
import re

import jax  # noqa: F401  (configured for the CPU by conftest)
import numpy as np
import pytest
import torch

import tuplex_tpu_torch
from tuplex_tpu.ops import nfa as ref_nfa
from tuplex_tpu_torch.models import logs
from tuplex_tpu_torch.ops import nfa as port_nfa
from tuplex_tpu_torch.ops import nfa_cuda
from tuplex_tpu_torch.plan import physical
from tuplex_tpu_torch.runtime import columns as C

# 1 to 4 follow chunks, with and without '$', a leading class run, the
# status grep's pattern
PATTERNS = [logs.STATUS_GROUPS, r"\S+x", "a+b$", "GET|POST", "^ab",
            "b\n?$", "[ab]" * 16, "[ab]" * 24, "[ab]" * 32, "x$"]
ALPHABET = b'ab cxGETPOS"45\n09z- '


def _batch(seed: int, n: int, w: int):
    """Seeded rows over ALPHABET and log lines in one matrix, lengths
    0..w, some ending in a newline, zero past each length."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(ALPHABET, dtype=np.uint8)
    mat = alpha[rng.integers(0, len(alpha), size=(n, w))]
    lens = rng.integers(0, w + 1, size=n).astype(np.int32)
    nl = (rng.random(n) < 0.15) & (lens > 0)
    mat[np.nonzero(nl)[0], lens[nl] - 1] = 10
    mat[np.arange(w)[None, :] >= lens[:, None]] = 0
    pyrng = random.Random(seed)
    leaf = C.encode_str_leaf([logs.gen_logline(pyrng) for _ in range(50)],
                             False)
    lw = leaf.bytes.shape[1]
    width = max(w, lw)
    pad = lambda m: np.pad(m, ((0, 0), (0, width - m.shape[1])))  # noqa: E731
    return (np.ascontiguousarray(np.concatenate([pad(mat),
                                                 pad(leaf.bytes)])),
            np.concatenate([lens, leaf.lengths]).astype(np.int32))


def _masks(rx, b, l, seed: int):
    rng = np.random.default_rng(seed)
    n = b.shape[0]
    out = {"none live": torch.zeros(n, dtype=torch.bool),
           "all live": torch.ones(n, dtype=torch.bool),
           "scan's own": rx.match(b, l)}
    for frac in (0.01, 0.22, 0.9):
        out[f"{frac:.0%} live"] = torch.from_numpy(rng.random(n) < frac)
    return out


@pytest.mark.parametrize("pattern", PATTERNS)
def test_live_mask_keeps_live_rows_and_clears_the_rest(pattern):
    rx = port_nfa.compile_nfa(pattern)
    mat, lens = _batch(3, 150, 40)
    b, l = torch.from_numpy(mat), torch.from_numpy(lens)
    m0, s0 = rx.match_start_plain(b, l)
    for what, live in _masks(rx, b, l, 5).items():
        # the dispatcher takes the plain version for CPU tensors
        m, s = rx.match_start(b, l, live=live)
        assert m.dtype == torch.bool and s.dtype == torch.int32, what
        assert torch.equal(m, m0 & live), what
        assert torch.equal(s, torch.where(live, s0, 0)), what


@pytest.mark.parametrize("pattern", PATTERNS)
def test_scan_mask_equals_reference_and_re(pattern):
    """With the NFA scan's result as the mask, the start scan equals the
    reference's unmasked match_start and CPython's leftmost start: the
    scan rejects exactly the rows the start scan would not match."""
    rx = port_nfa.compile_nfa(pattern)
    mat, lens = _batch(7, 150, 40)
    b, l = torch.from_numpy(mat), torch.from_numpy(lens)
    valid = rx.match(b, l)
    m, s = rx.match_start(b, l, live=valid)
    rm, rs = ref_nfa.compile_nfa(pattern).match_start(mat, lens)
    assert m.tolist() == np.asarray(rm).tolist()
    assert s.tolist() == np.asarray(rs).tolist()
    assert torch.equal(m, valid)
    for i in range(len(lens)):
        py = re.search(pattern.encode(), bytes(mat[i, :lens[i]]))
        assert bool(m[i]) == (py is not None)
        assert int(s[i]) == (py.start() if py else 0)


def test_start_tables_are_32_bit():
    for pattern, n_chunks in ((logs.STATUS_GROUPS, 1), ("[ab]" * 16, 2),
                              ("[ab]" * 32, 4)):
        buf = nfa_cuda.pack_start_tables(port_nfa.compile_nfa(pattern).tables)
        assert buf.dtype == np.uint32
        assert buf.shape == (256 * (1 + n_chunks) + 2,)
    with pytest.raises(ValueError):
        nfa_cuda.pack_start_tables(port_nfa.compile_nfa("[ab]" * 33).tables)


def test_two_pass_hands_match_start_the_scan_result(tmp_path, monkeypatch):
    """The status grep's map reads a group of an unanchored pattern: the
    emitter calls match_start with `live` equal to the same pattern's scan
    over the same rows, and the rows still equal the loop's."""
    calls = []
    real = port_nfa.NFARegex.match_start

    def spy(self, bytes_, lens, live=None):
        calls.append((self, bytes_, lens, live))
        return real(self, bytes_, lens, live)

    monkeypatch.setattr(port_nfa.NFARegex, "match_start", spy)
    path = logs.generate_log(str(tmp_path / "access.log"), 3000, seed=17,
                             non_ascii_every=1000)
    ctx = tuplex_tpu_torch.Context(device="cpu")
    got = logs.build_status_grep(ctx.text(path)).collect()
    assert got == logs.run_status_grep_reference(path)
    assert calls
    rx = port_nfa.compile_nfa(logs.STATUS_GROUPS)
    for nfa, b, l, live in calls:
        assert nfa is rx
        assert live is not None and live.dtype == torch.bool
        assert torch.equal(live, rx.match(b, l))
    # about a fifth of the lines match: most rows are not scanned (the
    # planner's probe of the map runs over the sample's first 8 lines)
    job = [live for _, _, _, live in calls
           if live.shape[0] > physical._PROBE_ROWS]
    assert job
    for live in job:
        assert 0 < int(live.sum()) < live.shape[0] // 2
