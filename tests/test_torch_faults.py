"""Repairs of the port's faults C1 (% formatting) and C2 (int64 overflow)
against CPython, with the reference package's rows recorded beside them.

Oracle: CPython on the same values (the gate of the port's correctness).
`tuplex_tpu.Context().collect()` runs on the same input beside it: it
gives CPython's rows on the format cases and CPython's rows wrapped to
int64 on the overflow cases (ROADMAP C2), and the tests assert that too.
Tolerance: exact (rows, order, types).
"""

import jax  # noqa: F401  (configured for the CPU by conftest)
import pytest

import tuplex_tpu
import tuplex_tpu_torch

I64_MIN = -2**63


@pytest.fixture(autouse=True)
def _private_aot_store(tmp_path, monkeypatch):
    """The reference package keeps compiled stages in an on-disk store
    that every process of one HOME shares; this file's reference runs use
    a store of their own."""
    monkeypatch.setenv("TUPLEX_AOT_CACHE", str(tmp_path / "aot"))


def fmt_width(x):
    return "%5d" % x


def fmt_hex(x):
    return "%x" % x


def fmt_octal(x):
    return "%o" % x


def fmt_exp(x):
    return "%e" % x


def fmt_plus(x):
    return "%+d" % x


def fmt_left(x):
    return "%-4d" % x


def fmt_zero_pad(x):
    return "%05d" % x


def fmt_percent(x):
    return "%d%% of %d" % (x, x)


FORMAT_INTS = [5, 255, -3, 0, 12345]

# C1: the directives outside the compiled subset interpret; the compiled
# ones (%0Nd, %%, %d) stay on the device. The reference gives CPython's
# rows on every case.
FORMAT_CASES = [(fmt_width, "interpreter"), (fmt_hex, "interpreter"),
                (fmt_octal, "interpreter"), (fmt_exp, "interpreter"),
                (fmt_plus, "interpreter"), (fmt_left, "interpreter"),
                (fmt_zero_pad, "compiled"), (fmt_percent, "compiled")]


@pytest.mark.parametrize("udf,tier", FORMAT_CASES,
                         ids=[f.__name__ for f, _ in FORMAT_CASES])
def test_percent_format_matches_cpython(udf, tier):
    want = [udf(x) for x in FORMAT_INTS]
    ctx = tuplex_tpu_torch.Context(device="cpu")
    assert ctx.parallelize(FORMAT_INTS).map(udf).collect() == want
    assert ctx.metrics.stages[-1]["tier"] == tier
    assert tuplex_tpu.Context().parallelize(FORMAT_INTS).map(udf) \
        .collect() == want


def neg(x):
    return -x


def absolute(x):
    return abs(x)


def floordiv_minus_one(x):
    return x // -1


def mod_minus_one(x):
    return x % -1


def times_four(x):
    return x * 4


def plus_one(x):
    return x + 1


def minus_one(x):
    return x - 1


def square(x):
    return x * x


OVERFLOW_INTS = [I64_MIN, I64_MIN + 1, 2**62, -2**62 - 1, 2**63 - 1, 7, -1, 0]


def _wrapped(v: int) -> int:
    """v wrapped to int64, as the reference computes it."""
    return (v + 2**63) % 2**64 - 2**63


# C2: (udf, rows that leave int64 and so interpret). The reference gives
# CPython's rows wrapped to int64 (ROADMAP C2); abs() interprets in the
# port (its emitter does not compile abs), so every row interprets there.
OVERFLOW_CASES = [(neg, 1), (absolute, len(OVERFLOW_INTS)),
                  (floordiv_minus_one, 1), (mod_minus_one, 0),
                  (times_four, 5), (plus_one, 1), (minus_one, 1),
                  (square, 5)]


@pytest.mark.parametrize("udf,n_wrapped", OVERFLOW_CASES,
                         ids=[c[0].__name__ for c in OVERFLOW_CASES])
def test_int64_overflow_matches_cpython(udf, n_wrapped):
    want = [udf(x) for x in OVERFLOW_INTS]
    ctx = tuplex_tpu_torch.Context(device="cpu")
    got = ctx.parallelize(OVERFLOW_INTS).map(udf).collect()
    assert got == want
    assert [type(v) for v in got] == [int] * len(want)
    m = ctx.metrics
    assert m.interpreterRows() + m.generalRows() + m.exactExitRows() \
        == n_wrapped
    assert m.interpreterRows() == n_wrapped
    assert ctx.metrics.stages[-1]["tier"] == \
        ("interpreter" if udf is absolute else "compiled")
    ref_rows = [_wrapped(v) for v in want]
    assert ref_rows != want or udf is mod_minus_one
    assert tuplex_tpu.Context().parallelize(OVERFLOW_INTS).map(udf) \
        .collect() == ref_rows
