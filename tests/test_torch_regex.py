"""The anchored regex engine, the NFA's leftmost match start and the
emitter's regex and dict paths of tuplex_tpu_torch, against the reference
package and CPython.

Oracles: `tuplex_tpu.ops.regex.CompiledRegex.match` and
`tuplex_tpu.ops.nfa.NFARegex.match_start` on the same seeded byte
matrices (plain jnp on the CPU), `re.search`, and the UDFs run by CPython.
Tolerance: exact (booleans and int32 offsets). The CUDA start kernel is
held against `match_start_plain` on the card by tests/test_torch_cuda.py
and chip_smoke.py; here `test_start_tables_reverse_scan` checks its tables
and its right-to-left scan, written out in numpy.
"""

import random
import re

import jax  # noqa: F401  (configured for the CPU by conftest)
import numpy as np
import pytest
import torch

from tuplex_tpu.core.errors import NotCompilable as RefNotCompilable
from tuplex_tpu.models import logs as ref_logs
from tuplex_tpu.ops import nfa as ref_nfa
from tuplex_tpu.ops import regex as ref_regex
from tuplex_tpu_torch.compiler.emitter import EmitCtx, Emitter
from tuplex_tpu_torch.compiler.stagefn import input_row_cv, result_arrays
from tuplex_tpu_torch.core import typesys as T
from tuplex_tpu_torch.core.errors import ExceptionCode, NotCompilable
from tuplex_tpu_torch.models import logs
from tuplex_tpu_torch.ops import nfa as port_nfa
from tuplex_tpu_torch.ops import nfa_cuda
from tuplex_tpu_torch.ops import regex as port_regex
from tuplex_tpu_torch.runtime import columns as C
from tuplex_tpu_torch.utils.reflection import get_udf_source

WEBLOGS = logs.WEBLOGS_REGEX
# tests/test_string_ops.py:284-340, tests/test_emitter.py:589-660 (re.match
# anchored), the weblogs pattern and the status grep's second pass
ANCHORED = [r"^(\d+) (\d+) \[(\w+)\]$", r'^(\S+) (\S+) \[(\w+)\] "(\S+)" (\d+)$',
            r"^(\w+)x$", r"^(\d+)0$", r"^(\d+)-(\w+)$", r"^(\w+) (\d+)",
            r'^"([^"]*)" (\d+)$', r"^[^0]\d$", r"^(.)-", WEBLOGS,
            '^' + logs.STATUS_GROUPS, r"^a{2,3}(b?)c*$", r"^([ab]+)(a)"]
START_PATTERNS = [logs.STATUS_GROUPS, r"\S+x", "abc", "a+b$", "GET|POST",
                  r"\d\d", "a.*b", "^ab", "x$", "[ab]+c", "(ab)+c", "b\n?$",
                  "[ab]" * 32, logs.ERROR_STATUS]


def _batch(seed: int, n: int, w: int, alphabet: bytes):
    """Seeded rows over `alphabet`, lengths 0..w, some with a trailing
    newline, zero past each length."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(alphabet, dtype=np.uint8)
    mat = alpha[rng.integers(0, len(alpha), size=(n, w))]
    lens = rng.integers(0, w + 1, size=n).astype(np.int32)
    nl = (rng.random(n) < 0.15) & (lens > 0)
    mat[np.nonzero(nl)[0], lens[nl] - 1] = 10
    mat[np.arange(w)[None, :] >= lens[:, None]] = 0
    return np.ascontiguousarray(mat), lens


def _log_batch(n: int, seed: int):
    rng = random.Random(seed)
    lines = [logs.gen_logline(rng) for _ in range(n)]
    # lines cut short, as a truncated file gives them
    lines += [ln[:k] for ln, k in zip(lines[:40], range(5, 85, 2))]
    leaf = C.encode_str_leaf(lines, False)
    return lines, np.ascontiguousarray(leaf.bytes), leaf.lengths


def _mixed_batch(seed: int, alphabet: bytes):
    """Seeded random rows and log lines in one matrix (one shape, so the
    reference's jnp ops compile once per pattern)."""
    mat, lens = _batch(seed, 200, 40, alphabet)
    _, lmat, llens = _log_batch(100, seed)
    w = max(mat.shape[1], lmat.shape[1])
    pad = lambda m: np.pad(m, ((0, 0), (0, w - m.shape[1])))  # noqa: E731
    return (np.ascontiguousarray(np.concatenate([pad(mat), pad(lmat)])),
            np.concatenate([lens, llens]).astype(np.int32))


ALPHABET = b'0123456789abx -"[]:/+\tA'


@pytest.mark.parametrize("pattern", ANCHORED)
def test_anchored_engine_equals_reference(pattern):
    """matched, suspect and every group's start and end equal the
    reference's, bit for bit; rows the engine calls matched equal CPython's
    match and its group spans."""
    rx = port_regex.compile_regex(pattern)
    ref = ref_regex.CompiledRegex(pattern)
    for mat, lens in [_mixed_batch(7, ALPHABET)]:
        m, s, gs, ge = rx.match(torch.from_numpy(mat),
                                torch.from_numpy(lens))
        rm, rs, rgs, rge = ref.match(mat, lens)
        assert m.tolist() == np.asarray(rm).tolist()
        assert s.tolist() == np.asarray(rs).tolist()
        assert len(gs) == len(rgs) == rx.n_groups + 1
        for a, b in zip(gs + ge, rgs + rge):
            assert a.dtype == torch.int32
            assert a.tolist() == np.asarray(b).tolist()
        for i in range(len(lens)):
            row = bytes(mat[i, :lens[i]])
            py = re.search(pattern.encode(), row)
            if bool(m[i]):
                assert py is not None
                assert [py.span(g) for g in range(rx.n_groups + 1)] == \
                    [(int(gs[g][i]), int(ge[g][i]))
                     for g in range(rx.n_groups + 1)]
            elif not bool(s[i]):
                assert py is None, (pattern, row)


@pytest.mark.parametrize("pattern", ANCHORED)
def test_steps_and_suspect_threshold_equal_reference(pattern):
    rx = port_regex.compile_regex(pattern)
    ref = ref_regex.CompiledRegex(pattern)
    fields = ("kind", "spec", "min", "max", "group", "retreat_from",
              "retreat_min", "retreat_groups")
    assert [tuple(getattr(s, f) for f in fields) for s in rx.steps] == \
        [tuple(getattr(s, f) for f in fields) for s in ref.steps]
    assert rx.first_var == ref.first_var
    assert rx.n_groups == ref.n_groups


@pytest.mark.parametrize("pattern", ["abc", "^(a|b)c", "^(ab)+", "^a^b",
                                     "^(?i)abc", "^(", r"^\bfoo", "^a|b"])
def test_anchored_engine_rejects_like_reference(pattern):
    try:
        ref_regex.compile_regex(pattern)
        want = True
    except Exception:
        want = False
    try:
        port_regex.compile_regex(pattern)
        got = True
    except NotCompilable:
        got = False
    assert got == want == port_regex.anchored_engine_accepts(pattern)


def test_compile_regex_cache_is_bounded():
    port_regex._REGEX_CACHE.clear()
    for k in range(300):
        port_regex.compile_regex(f"^a{{{k}}}")
    assert len(port_regex._REGEX_CACHE) <= 257
    assert port_regex.compile_regex("^ab") is port_regex.compile_regex("^ab")


START_ALPHABET = b'ab cxGETPOS"45\n09z- '


@pytest.mark.parametrize("pattern", START_PATTERNS)
def test_match_start_plain_equals_reference_and_re(pattern):
    rx = port_nfa.compile_nfa(pattern)
    ref = ref_nfa.compile_nfa(pattern)
    for mat, lens in [_mixed_batch(11, START_ALPHABET)]:
        m, s = rx.match_start(torch.from_numpy(mat), torch.from_numpy(lens))
        assert s.dtype == torch.int32
        rm, rs = ref.match_start(mat, lens)
        assert m.tolist() == np.asarray(rm).tolist()
        assert s.tolist() == np.asarray(rs).tolist()
        for i in range(len(lens)):
            py = re.search(pattern.encode(), bytes(mat[i, :lens[i]]))
            assert bool(m[i]) == (py is not None)
            assert int(s[i]) == (py.start() if py else 0)


@pytest.mark.parametrize("pattern", ["a*", "(a|)", "x?", "^$", "^",
                                     "[ab]" * 33, "a" * 40])
def test_match_start_raises_like_reference(pattern):
    b = np.zeros((2, 4), dtype=np.uint8)
    l = np.zeros(2, dtype=np.int32)
    with pytest.raises(RefNotCompilable):
        ref_nfa.compile_nfa(pattern).match_start(b, l)
    rx = port_nfa.compile_nfa(pattern)
    with pytest.raises(NotCompilable):
        rx.match_start(torch.from_numpy(b), torch.from_numpy(l))
    with pytest.raises(NotCompilable):
        rx.match_start_plain(torch.from_numpy(b), torch.from_numpy(l))


def _reverse_scan(tables, mat, lens):
    """The CUDA start kernel's scan (csrc/nfa_scan.cu nfa_start_kernel)
    written out per row: pack_start_tables' reversed chunked follow
    tables, fed right to left."""
    buf = nfa_cuda.pack_start_tables(tables)
    nch = (tables.n_pos + 7) // 8
    cls = [int(v) for v in buf[:256]]
    f8 = buf[256:256 * (1 + nch)].reshape(nch, 256)
    seed, accept = int(buf[-2]), int(buf[-1])
    w = mat.shape[1]
    out_m, out_s = [], []
    for r in range(mat.shape[0]):
        ln = max(int(lens[r]), 0)
        stop = min(ln, w)
        ends = set()
        if tables.anchored_end and stop > 0:
            nl = mat[r, stop - 1] == 10
            if ln <= w:
                ends.add(ln - 1)
            e2 = ln - 2 if nl else ln - 1
            if 0 <= e2 < stop:
                ends.add(e2)
        R, best = 0, -1
        for j in range(stop - 1, -1, -1):
            nxt = 0
            for c in range(nch):
                nxt |= int(f8[c][(R >> (8 * c)) & 0xFF])
            sd = seed if j in ends else 0
            R = (nxt | sd) & cls[mat[r, j]]
            if R & accept:
                best = j
        m = best == 0 if tables.anchored_start else best >= 0
        out_m.append(m)
        out_s.append(best if m else 0)
    return out_m, out_s


@pytest.mark.parametrize("pattern", START_PATTERNS)
def test_start_tables_reverse_scan(pattern):
    """The kernel's formulation (the reversed automaton, seeded at every
    match end, its smallest accepting column) equals match_start_plain."""
    mat, lens = _batch(19, 60, 21, START_ALPHABET)
    rx = port_nfa.compile_nfa(pattern)
    m, s = rx.match_start_plain(torch.from_numpy(mat),
                                torch.from_numpy(lens))
    assert _reverse_scan(rx.tables, mat, lens) == (m.tolist(), s.tolist())
    rev = nfa_cuda.reversed_follow(rx.tables)
    for q in range(rx.n_pos):
        for p in range(rx.n_pos):
            assert bool((int(rx.tables.follow[q]) >> p) & 1) == \
                bool((int(rev[p]) >> q) & 1)


# -- the emitter: compiled rows against CPython -----------------------------

_CLASS_OF = {ExceptionCode.VALUEERROR: "ValueError",
             ExceptionCode.TYPEERROR: "TypeError",
             ExceptionCode.INDEXERROR: "IndexError",
             ExceptionCode.KEYERROR: "KeyError",
             ExceptionCode.ATTRIBUTEERROR: "AttributeError"}


def _run_compiled(f, values):
    """Per row: the value (a dict row as a dict, its keys in the row's
    order), an exception class name, or None for a row left to the
    interpreter."""
    nc = T.normal_case_type(values, 0.5)[0]
    schema = T.row_of(["_0"], [nc])
    part = C.build_partition(values, schema)
    batch = C.stage_partition(part, torch.device("cpu"))
    ctx = EmitCtx(batch.b, batch.arrays["#rowvalid"])
    ctx.cur_op = 1
    udf = get_udf_source(f)
    res = Emitter(ctx, udf.globals).eval_udf(
        udf, [input_row_cv(batch.arrays, schema)])
    outs = {k: v.numpy()
            for k, v in result_arrays(res, batch.b, ctx.device).items()}
    vals = C.partition_to_pylist(C.partition_from_result_arrays(outs,
                                                                batch.b))
    out = []
    for i in range(part.num_rows):
        code = ExceptionCode(int(ctx.err[i]) & 0xFF)
        if part.normal_mask is not None and not part.normal_mask[i]:
            out.append(None)
        elif code == 0:
            out.append(dict(zip(res.names, vals[i])) if res.names
                       else vals[i])
        else:
            out.append(_CLASS_OF.get(code))
    return out


def _interp(f, v):
    try:
        r = f(v)
    except Exception as e:
        return type(e).__name__
    return r


def _ordered(v):
    return list(v.items()) if isinstance(v, dict) else v


def check(f, values):
    """Every row the compiled path decides equals CPython's value and type
    (a dict's keys in CPython's order); a row routed to the interpreter
    counts as equal. Returns the number of routed rows."""
    got = _run_compiled(f, values)
    routed = 0
    for v, g in zip(values, got):
        if g is None:
            routed += 1
            continue
        want = _interp(f, v)
        assert _ordered(g) == _ordered(want) and type(g) is type(want), \
            (v, g, want)
    assert routed < len(values)
    return routed


def test_re_search_groups():
    def f(s):
        m = re.search(r"^(\d+)-(\w+)$", s)
        if m is None:
            return "none"
        return m.group(2) + ":" + m.group(1)

    assert check(f, ["12-abc", "7-x", "nope", "-abc", "12-", "999-zz9"]) == 0


def test_re_match_implicit_anchor():
    def f(s):
        m = re.match(r"(\w+) (\d+)", s)
        return -1 if m is None else int(m.group(2))

    check(f, ["ab 42", "x 7 tail", "nope", " 5"])


def test_re_negated_class_and_dollar_newline():
    def f(s):
        m = re.search(r'^"([^"]*)" (\d+)$', s)
        return -1 if m is None else int(m.group(2)) + len(m.group(1))

    check(f, ['"abc" 12', '"a b" 7', '"x" 5\n', 'no', '"" 3'])

    def g(s):
        m = re.search(r"^[^0]\d$", s)
        return m is not None

    check(g, ["12", "05", "99", "5", "x7"])


def test_re_non_ascii_rows_fall_back():
    def f(s):
        m = re.search(r"^(.)-", s)
        return "none" if m is None else m.group(1)

    assert check(f, ["a-b", "é-x", "日-q", "xy"]) == 2


def test_group_of_none_match_raises_attribute_error():
    got = _run_compiled(lambda s: re.search(r"^(\d+)x", s).group(1),
                        ["12x", "ab", "7x"])
    assert got == ["12", "AttributeError", "7"]


@pytest.mark.parametrize("method", ["start", "end", "groups"])
def test_other_match_methods_not_compilable(method):
    f = {"start": lambda s: re.search(r"^(\d+)", s).start(),
         "end": lambda s: re.search(r"^(\d+)", s).end(),
         "groups": lambda s: re.search(r"^(\d+)", s).groups()}[method]
    with pytest.raises(NotCompilable):
        _run_compiled(f, ["1", "2"])


def test_two_pass_groups_and_truth_value():
    """Unanchored patterns: the truth value from the NFA scan alone, the
    groups from the leftmost start and the anchored engine there."""
    lines, _, _ = _log_batch(200, 9)
    lines += ['x" 404 a" 500 b', '" 4x', '"" 503 -', '" 404 ', 'a" 412 zz\n']

    def status(s):
        m = re.search(r'" ([45]\d\d) (\S+)', s)
        return "-" if m is None else m.group(1) + "/" + m.group(2)

    assert check(status, lines) == 0
    assert check(lambda s: re.search(r'" [45]\d\d ', s) is not None,
                 lines) == 0
    assert check(lambda s: int(re.search(r'" ([45]\d\d) ', s).group(1)),
                 lines) == 0


def test_two_pass_routes_where_the_engine_falls_short():
    """'(\\w+)\\d' at the leftmost start: the greedy run swallows the
    digit and a class cannot retreat, so the anchored engine is suspect
    there and the row interprets."""
    def f(s):
        m = re.search(r"(\w+)\d", s)
        return "" if m is None else m.group(1)

    assert check(f, ["ab1", "-x2-", "none", "12"]) == 3


def test_weblogs_parsers_compile_row_for_row():
    lines, _, _ = _log_batch(200, 21)
    lines.append(lines[3].replace(" - - ", " - élève ", 1))
    for fn in (logs.ParseWithStrip, logs.ParseWithRegex):
        routed = check(fn, lines)
        assert routed <= 40 if fn is logs.ParseWithRegex else routed == 1


def test_dict_rows():
    def f(x):
        if x > 2:
            return {"a": x, "b": "big"}
        return {"a": -x, "b": "small"}

    assert check(f, [1, 2, 3, 4]) == 0
    assert check(lambda x: {"v": x * 2, "s": x}, [1, 5, 7]) == 0
    for f in (lambda x: {x: 1}, lambda x: {"a": x, "a": 2}):  # noqa: F601
        with pytest.raises(NotCompilable):
            _run_compiled(f, [1, 2])


def _key_swap(x):
    if x % 2:
        return {"a": x, "b": -x}
    return {"b": -x, "a": x * 10}


def _dict_or_tuple(x):
    if x > 0:
        return {"a": x, "b": 1}
    return (x, 2)


def test_dict_branches_must_agree_on_keys():
    """Branches that return dicts with other key orders, or a dict and a
    tuple, cannot share one named row: NotCompilable, so the rows
    interpret, and the pipeline equals the loop."""
    import tuplex_tpu_torch

    for f in (_key_swap, _dict_or_tuple):
        with pytest.raises(NotCompilable):
            _run_compiled(f, [1, 2, 3])
    rows = list(range(-3, 9))
    ctx = tuplex_tpu_torch.Context(device="cpu")
    got = ctx.parallelize(rows).map(_key_swap).filter(
        lambda r: r["a"] > 2).collect()
    want = [tuple(d.values()) for d in map(_key_swap, rows) if d["a"] > 2]
    assert got == want


def _either(s):
    m = re.search(r"x(\d)", s) or re.search(r"y(\w)", s)
    return m.group(1)


def _one_of(s):
    if s[:1] == "a":
        m = re.search(r"x(\d)", s)
    else:
        m = re.search(r"y(\w)", s)
    return "-" if m is None else m.group(1)


@pytest.mark.parametrize("f", [_either, _one_of])
def test_matches_of_two_patterns_keep_their_groups(f):
    """A match merged from two patterns (`or`, or one per branch) keeps
    each row's own groups: the merge is NotCompilable and the rows
    interpret, equal to the loop with its exceptions."""
    import tuplex_tpu_torch

    rows = ["ax1", "by2", "x3y4", "yq", "zz", "y5x6", "ay7", "bx8"]
    with pytest.raises(NotCompilable):
        _run_compiled(f, rows)
    ctx = tuplex_tpu_torch.Context(device="cpu")
    ds = ctx.parallelize(rows).map(f)
    want, errors = [], 0
    for s in rows:
        try:
            want.append(f(s))
        except AttributeError:
            errors += 1
    assert ds.collect() == want
    assert ds.exception_counts() == ({"AttributeError": errors}
                                     if errors else {})


def test_port_parsers_are_the_reference_copies():
    import inspect

    for name in ("ParseWithStrip", "ParseWithRegex", "build_pipeline",
                 "run_reference_python"):
        want = inspect.getsource(getattr(ref_logs, name))
        got = inspect.getsource(getattr(logs, name))
        if name != "run_reference_python":   # the port's opens as UTF-8
            assert got.split('"""')[-1] == want.split('"""')[-1], name
    assert logs.COLUMNS == ref_logs.COLUMNS
    import ast

    tree = ast.parse(inspect.getsource(logs.ParseWithRegex))
    consts = [n.args[0].value for n in ast.walk(tree)
              if isinstance(n, ast.Call) and n.args
              and isinstance(n.args[0], ast.Constant)
              and isinstance(n.args[0].value, str)]
    assert consts[0] == logs.WEBLOGS_REGEX


def test_anchored_filter_compiles_in_a_pipeline():
    """re.search("^GET", s) in a filter runs on the anchored engine: only
    the non-ASCII row interprets."""
    import tuplex_tpu_torch

    rows = ["GET /a", "post /b", "GET /c", "héllo", ""]
    ctx = tuplex_tpu_torch.Context(device="cpu")
    got = ctx.parallelize(rows).filter(
        lambda s: re.search("^GET", s)).collect()
    assert got == [r for r in rows if re.search("^GET", r)]
    assert ctx.metrics.stages[-1]["tier"] == "compiled"
    assert ctx.metrics.interpreterRows() == 1
