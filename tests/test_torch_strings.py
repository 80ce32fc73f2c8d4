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


# ---------------------------------------------------------------------------
# the kernels of the Zillow pipeline and the CSV decode
# ---------------------------------------------------------------------------

def _enc(values):
    leaf = C.encode_str_leaf(values, False)
    b = np.ascontiguousarray(leaf.bytes)
    return b, leaf.lengths, torch.from_numpy(b), torch.from_numpy(leaf.lengths)


def _seeded_words(seed, n=64):
    """Seeded rows over a small alphabet with the needles below, commas,
    digits, case and empty rows."""
    rng = np.random.default_rng(seed)
    parts = ["a", "b", "ab", ",", ", ", "Sale", "rent", "HOUSE", "$",
             "1", "23", "/mo", " ", "aa", "x"]
    rows = ["".join(rng.choice(parts, size=rng.integers(0, 9)))
            for _ in range(n)]
    return rows + ["", "aaaa", "abab", ",,,", "é,ü"]


@pytest.mark.parametrize("fn", ["lower", "upper"])
def test_case_maps_match_reference(fn):
    b, l, tb, tl = _enc(_seeded_words(11) + CORPUS)
    gb, gl = getattr(PS, fn)(tb, tl)
    wb, wl = getattr(RS, fn)(b, l)
    np.testing.assert_array_equal(gb.numpy(), np.asarray(wb))
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))


@pytest.mark.parametrize("needle", ["a", "ab", "sale", ", ", "", "zz"])
def test_contains_const_matches_reference(needle):
    rows = _seeded_words(12)
    b, l, tb, tl = _enc(rows)
    got = PS.contains_const(tb, tl, needle).numpy()
    np.testing.assert_array_equal(got,
                                  np.asarray(RS.contains_const(b, l, needle)))
    assert got.tolist() == [needle in s for s in rows]


@pytest.mark.parametrize("old,new", [(",", ""), (",", ";"), ("ab", "X"),
                                     ("a", "bb"), ("aa", "b"), ("ab", ""),
                                     ("aa", "aaa"), (", ", "::"),
                                     ("nope", "y")])
def test_replace_const_matches_reference(old, new):
    rows = _seeded_words(13)
    b, l, tb, tl = _enc(rows)
    gb, gl = PS.replace_const(tb, tl, old, new)
    wb, wl = RS.replace_const(b, l, old, new)
    np.testing.assert_array_equal(gb.numpy(), np.asarray(wb))
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    got = [bytes(gb.numpy()[i, : gl[i]]).decode() for i in range(len(rows))]
    assert got == [s.replace(old, new) for s in rows]


def test_concat_and_equals_match_reference():
    rows = _seeded_words(14)
    other = list(reversed(rows))
    a, al, ta, tal = _enc(rows)
    b, bl, tb, tbl = _enc(other)
    gb, gl = PS.concat(ta, tal, tb, tbl)
    wb, wl = RS.concat(a, al, b, bl)
    np.testing.assert_array_equal(gb.numpy(), np.asarray(wb))
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    assert [bytes(gb.numpy()[i, : gl[i]]).decode() for i in range(len(rows))] \
        == [x + y for x, y in zip(rows, other)]
    for cb, cl, tcb, tcl in (_enc(other), _enc(["ab"] * len(rows)),
                             _enc(rows)):
        got = PS.equals(ta, tal, tcb, tcl).numpy()
        np.testing.assert_array_equal(got,
                                      np.asarray(RS.equals(a, al, cb, cl)))


def test_table_lookup_and_char_at_match_reference():
    rows = _seeded_words(15)
    b, l, tb, tl = _enc(rows)
    table = (np.arange(256) % 7 == 0)
    got = PS.table_lookup(table, tb.to(torch.int32)).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        RS.table_lookup(table, b.astype(np.int32))))
    for i in (0, 1, -1, 5):
        idx = np.full(len(rows), i, dtype=np.int32)
        g = PS.char_at(tb, tl, torch.from_numpy(idx))
        r = RS.char_at(b, l, idx)
        for x, y in zip(g, r):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))


PARSE_EDGES = [" 42", "+7", "-0", "1_000", "", "N/A", "0210A", "02108",
               "9223372036854775807", "-9223372036854775808",
               "9223372036854775808", "12345678901234567890",
               "-1234567890123456789", "١٢", "\xa012", "12 3", " - 5", "-",
               "+", "  ", "\t7\n", "0" * 25 + "7", " " * 30 + "8" + " " * 5,
               "00", "1_", "_1", "1e3", "3.0", "\x1c5"]


@pytest.mark.parametrize("pad", [0, 40])
def test_parse_i64_matches_reference_and_int(pad):
    """Edges plus seeded numbers; `pad` widens the matrix past the parse
    window so the narrowed path runs."""
    rng = np.random.default_rng(16)
    nums = [str(int(v)) for v in rng.integers(-10 ** 18, 10 ** 18, size=40)]
    rows = PARSE_EDGES + nums + [" %d " % v for v in range(-5, 5)]
    b, l, tb, tl = _enc(rows)
    if pad:
        b = np.pad(b, ((0, 0), (0, pad)))
        tb = torch.from_numpy(b)
    val, bad, route = PS.parse_i64(tb, tl)
    wv, wbad, wroute = (np.asarray(x) for x in RS.parse_i64(b, l))
    np.testing.assert_array_equal(bad.numpy(), wbad)
    np.testing.assert_array_equal(route.numpy(), wroute)
    ok = ~wbad & ~wroute
    np.testing.assert_array_equal(val.numpy()[ok], wv[ok])
    for i, s in enumerate(rows):
        try:
            want = int(s)
        except ValueError:
            want = None
        if bad[i]:
            assert want is None, s
        elif route[i]:
            # valid for CPython or not, the interpreter decides
            assert want is None or not -2 ** 63 < want < 2 ** 63 \
                or not s.isascii() or "_" in s or len(s.strip()) > 19, s
        else:
            assert want == int(val[i]), s


@pytest.mark.parametrize("width,pad_zero", [(0, False), (5, True),
                                            (1, True), (25, True)])
def test_format_i64_matches_reference(width, pad_zero):
    rng = np.random.default_rng(17)
    vals = np.concatenate([
        np.array([0, 7, -7, 42, -42, 99999, -99999, 100000, -3, 2 ** 63 - 1,
                  -2 ** 63, -2 ** 63 + 1, 10 ** 18, -10 ** 18], np.int64),
        rng.integers(-10 ** 12, 10 ** 12, size=30)])
    gb, gl = PS.format_i64(torch.from_numpy(vals), width=width,
                           pad_zero=pad_zero)
    wb, wl = RS.format_i64(vals, width=width, pad_zero=pad_zero)
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    np.testing.assert_array_equal(gb.numpy(), np.asarray(wb))
    fmt = f"%0{width}d" if pad_zero else "%d"
    assert [bytes(gb.numpy()[i, : gl[i]]).decode() for i in range(len(vals))] \
        == [fmt % int(v) for v in vals]


# ---------------------------------------------------------------------------
# parse_f64 and compare_lt
# ---------------------------------------------------------------------------

F64_EDGES = ["1e22", "1e23", "-0.0", ".5", "5.", " 2.5 ", "1_0", "inf",
             "NaN", "-Infinity", "+.5", "-.5e-3", "1.5E+3", "e5", ".e5",
             "5e", "5e+", "1.2.3", "1e5e5", "", ".", "+", "-", "0x10",
             "1 2", "\t3.25\n", "٣", "0e999", "-0e5", "1e-22",
             "0.000000000000000000001", "00000000000000000000001.5",
             "9007199254740991", "9007199254740992", "9007199254740993",
             "12345678901234567", "123456789012345678",
             "1234567890123456789", "12345678901234567890", "4.9e-324",
             "1.7976931348623157e308", "1e0000000000000000000000005",
             "1" * 40 + "x", "0" * 40 + "7", "17.0", "0.05", "45678.91"]


def _f64_corpus(n: int, seed: int) -> list:
    """Seeded float literals of every shape float() reads (signs, leading
    zeros, no integer or no fraction digits, exponents, 1-20 digit
    mantissas, surrounding whitespace) and near misses."""
    rng = np.random.default_rng(seed)
    out = list(F64_EDGES)
    while len(out) < n:
        ni = int(rng.integers(0, 12))
        nf = int(rng.integers(0, 12))
        s = "".join(rng.choice(list("0123456789"), ni)) + (
            "." + "".join(rng.choice(list("0123456789"), nf))
            if rng.random() < 0.7 else "")
        if rng.random() < 0.3:
            s = str(rng.choice(["+", "-"])) + s
        if rng.random() < 0.4:
            s += str(rng.choice(["e", "E"])) + str(
                rng.choice(["", "+", "-"])) + str(int(rng.integers(0, 40)))
        r = rng.random()
        if r < 0.05:
            s = " " * int(rng.integers(1, 3)) + s + "\t"
        elif r < 0.10:    # a near miss: one character replaced
            i = int(rng.integers(0, len(s) + 1))
            s = s[:i] + str(rng.choice(list("x_e.+- é"))) + s[i + 1:]
        out.append(s)
    return out


def test_parse_f64_equals_float():
    """Every value parse_f64 returns is float()'s, bit for bit; `bad` rows
    are exactly float()'s ValueErrors; `route` rows are left to CPython."""
    strs = _f64_corpus(20_000, seed=11)
    leaf = C.encode_str_leaf(strs, False)
    val, bad, route = PS.parse_f64(torch.from_numpy(
        np.ascontiguousarray(leaf.bytes)), torch.from_numpy(leaf.lengths))
    val, bad, route = val.numpy(), bad.numpy(), route.numpy()
    assert val.dtype == np.float64 and not (bad & route).any()
    n_value = 0
    for s, v, b, r in zip(strs, val, bad, route):
        try:
            want = float(s)
        except ValueError:
            want = None
        if b:
            assert want is None, s
        elif r:
            assert want is not None or "_" in s or not s.isascii() or \
                len(s.strip()) > 32, s
        else:
            assert want is not None and \
                np.float64(want).tobytes() == v.tobytes(), s
            n_value += 1
    assert n_value > 10_000   # the corpus mostly takes the fast path
    got = dict(zip(strs, zip(val.tolist(), bad.tolist(), route.tolist())))
    assert repr(got["-0.0"][0]) == "-0.0" and got["1e22"][0] == 1e22
    assert got["1e23"][2] and got["9007199254740992"][2]
    assert got["9007199254740991"][0] == 9007199254740991.0
    assert got["1_0"][2] and got["NaN"][2] and got["inf"][2]
    assert got[" 2.5 "][0] == 2.5 and got["5e"][1] and got["."][1]


def test_parse_f64_matches_reference_in_its_exact_range():
    """Where the port returns a value, the reference's parse_f64 returns
    the same bits (a mantissa below 2**53 and an exponent within 22: its
    exact range too)."""
    strs = _f64_corpus(3000, seed=12)
    leaf = C.encode_str_leaf(strs, False)
    b = np.ascontiguousarray(leaf.bytes)
    val, bad, route = (t.numpy() for t in PS.parse_f64(
        torch.from_numpy(b), torch.from_numpy(leaf.lengths)))
    rv, rbad, rroute = (np.asarray(t) for t in RS.parse_f64(b, leaf.lengths))
    mine = ~bad & ~route
    np.testing.assert_array_equal(val[mine].view(np.int64),
                                  rv[mine].view(np.int64))
    assert not (rbad | rroute)[mine].any()
    np.testing.assert_array_equal(bad & ~rroute, rbad & ~rroute)


def test_reference_parse_f64_misses_only_where_the_port_routes():
    """ROADMAP C7, a fault of the reference kept as it is: outside its
    exact range (17 and more mantissa digits, exponents beyond 22) the
    reference's parse_f64 approximates and can miss float() by an ulp or
    more ('1e23' parses to 1.0000000000000001e+23). The port routes every
    such string to CPython."""
    rng = np.random.default_rng(13)
    strs = ["1e23", "4.9e-324", "123456789012345678",
            "3.14159265358979323846"]
    for _ in range(500):
        m = str(int(rng.integers(10 ** 16, 10 ** 18)))
        d = int(rng.integers(0, len(m)))
        strs.append(m[:d] + "." + m[d:] + f"e{int(rng.integers(-30, 30))}")
    leaf = C.encode_str_leaf(strs, False)
    b = np.ascontiguousarray(leaf.bytes)
    rv, rbad, rroute = (np.asarray(t) for t in RS.parse_f64(b, leaf.lengths))
    _, _, route = PS.parse_f64(torch.from_numpy(b),
                               torch.from_numpy(leaf.lengths))
    misses = [i for i, s in enumerate(strs) if not rbad[i] and not rroute[i]
              and np.float64(float(s)).tobytes() != rv[i].tobytes()]
    assert 0 in misses and len(misses) > 100
    assert route.numpy()[misses].all()


CMP_STRINGS = ["", "a", "b", "ab", "abc", "abd", "B", "a\x00", "a\x00b",
               "1994-01-01", "1995-01-01", "1998-09-02", "1994-1-01",
               "café", "cafe", "cafz", "é", "日本",
               "日", "\U0001f600", "z" * 30, "z" * 29 + "é",
               " ", "~", "\x7f", "\u0080"]


@pytest.mark.parametrize("or_equal", [False, True])
def test_compare_lt_equals_python_order(or_equal):
    """Byte order over UTF-8 equals Python's code-point order, for every
    pair of a corpus with prefixes, NUL bytes and multi-byte characters,
    and against a broadcast constant."""
    pairs = [(a, b) for a in CMP_STRINGS for b in CMP_STRINGS]
    la = C.encode_str_leaf([a for a, _ in pairs], False)
    lb = C.encode_str_leaf([b for _, b in pairs], False)
    got = PS.compare_lt(torch.from_numpy(la.bytes.copy()),
                        torch.from_numpy(la.lengths),
                        torch.from_numpy(lb.bytes.copy()),
                        torch.from_numpy(lb.lengths), or_equal=or_equal)
    want = [(a <= b) if or_equal else (a < b) for a, b in pairs]
    assert got.tolist() == want
    ref = RS.compare_lt(la.bytes, la.lengths, lb.bytes, lb.lengths,
                        or_equal=or_equal)
    assert np.asarray(ref).tolist() == want
    leaf = C.encode_str_leaf(CMP_STRINGS, False)
    cb, cl = PS.broadcast_const("cafe", len(CMP_STRINGS), "cpu")
    got = PS.compare_lt(torch.from_numpy(leaf.bytes.copy()),
                        torch.from_numpy(leaf.lengths), cb, cl,
                        or_equal=or_equal)
    assert got.tolist() == [(s <= "cafe") if or_equal else (s < "cafe")
                            for s in CMP_STRINGS]
