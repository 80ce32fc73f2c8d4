"""tuplex_tpu_torch.ops.strings against the reference package's kernels.

Oracle: `tuplex_tpu.ops.strings` on the same numpy inputs, plus Python
string semantics. Tolerance: exact (int32 positions, bytes and lengths).
Inputs cover empty rows, rows filling the whole width and non-ASCII rows.
"""

import jax  # noqa: F401  (configured for the CPU by conftest)
import numpy as np
import pytest
import torch

from tuplex_tpu.ops import strings as RS
from tuplex_tpu_torch.ops import strings as PS
from tuplex_tpu_torch.runtime import columns as C

CORPUS = ["", "hello world", "a", " leading", "trailing ", "abcabcabc",
          "x" * 24, "no-space-at-all-here!!", "café au lait", "naïve ü x",
          "199.72.81.55 - - [01/Jul/1995:00:00:01 -0400]", "  "]


def _inputs():
    leaf = C.encode_str_leaf(CORPUS, False)
    b = np.ascontiguousarray(leaf.bytes)
    return b, leaf.lengths, torch.from_numpy(b), torch.from_numpy(leaf.lengths)


def _i32(values):
    return torch.tensor(values, dtype=torch.int32)


@pytest.mark.parametrize("needle", [" ", "a", "", "abc", "zzz", "ü",
                                    "x" * 24, "x" * 25])
@pytest.mark.parametrize("reverse", [False, True])
def test_find_const_matches_reference(needle, reverse):
    b, l, tb, tl = _inputs()
    got = PS.find_const(tb, tl, needle, reverse=reverse).numpy()
    want = np.asarray(RS.find_const(b, l, needle, reverse=reverse))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    ascii_rows = [i for i, s in enumerate(CORPUS) if s.isascii()]
    py = [s.rfind(needle) if reverse else s.find(needle) for s in CORPUS]
    assert [got[i] for i in ascii_rows] == [py[i] for i in ascii_rows]


@pytest.mark.parametrize("start", [0, 2, -3, 30])
def test_find_const_with_start(start):
    b, l, tb, tl = _inputs()
    st = np.full(len(CORPUS), start, dtype=np.int32)
    got = PS.find_const(tb, tl, "a", start=torch.from_numpy(st)).numpy()
    want = np.asarray(RS.find_const(b, l, "a", start=st))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("start,stop", [(None, 3), (None, -1), (2, None),
                                        (-4, None), (1, -1), (5, 2),
                                        (None, 40), (-40, 40)])
def test_slice_matches_reference(start, stop):
    b, l, tb, tl = _inputs()
    n = len(CORPUS)

    def arr(v):
        return None if v is None else np.full(n, v, dtype=np.int32)

    gb, gl = PS.slice_(tb, tl, None if start is None else _i32(arr(start)),
                       None if stop is None else _i32(arr(stop)))
    wb, wl = RS.slice_(b, l, arr(start), arr(stop))
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    np.testing.assert_array_equal(gb.numpy(), np.asarray(wb))
    ascii_rows = [i for i, s in enumerate(CORPUS) if s.isascii()]
    got = [bytes(gb.numpy()[i, : gl[i]]).decode() for i in ascii_rows]
    assert got == [CORPUS[i][slice(start, stop)] for i in ascii_rows]


def test_slice_by_find_is_log_grep_client_field():
    """line[:line.find(" ")], the map of the log grep."""
    b, l, tb, tl = _inputs()
    pos = PS.find_const(tb, tl, " ")
    gb, gl = PS.slice_(tb, tl, None, pos)
    wb, wl = RS.slice_(b, l, None, RS.find_const(b, l, " "))
    np.testing.assert_array_equal(gb.numpy(), np.asarray(wb))
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))


def test_take_cols_and_non_ascii_rows():
    b, l, tb, tl = _inputs()
    rng = np.random.default_rng(3)
    idx = rng.integers(0, b.shape[1], size=b.shape).astype(np.int32)
    got = PS.take_cols(tb, torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got, np.asarray(RS.take_cols(b, idx)))
    np.testing.assert_array_equal(PS.non_ascii_rows(tb, tl).numpy(),
                                  np.asarray(RS.non_ascii_rows(b, l)))
    assert PS.non_ascii_rows(tb, tl).tolist() == \
        [not s.isascii() for s in CORPUS]
