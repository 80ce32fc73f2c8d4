"""String kernels over fixed-width byte matrices (counterpart of
`tuplex_tpu/ops/strings.py`, the subset this package's emitter and CSV
decode use).

Representation: a batch of N strings is (bytes: uint8 [N, W] zero-padded,
lens: int32 [N]) on one device. Constant needles are Python values baked
into the op sequence. Kernels never raise: they return sentinels (-1 for
"not found") that the emitter turns into error-lattice updates.

Byte gathers use `torch.gather`, scatters `Tensor.scatter_` and table
lookups plain indexing. The reference package rewrites them as one-hot bf16
contractions on accelerators (its `_mxu_gather`); that form exists for the
TPU's matrix unit and costs W times the work on a GPU.

Every kernel stays in int64/int32/uint8: torch's CPU uint64 lacks shifts and
some arithmetic, and the CPU path must equal the CUDA one.
"""

from __future__ import annotations

import numpy as np
import torch

from ..runtime.torchcfg import I32, U8
from ..utils.lru import LruDict


def const_bytes(s: str) -> np.ndarray:
    return np.frombuffer(s.encode("utf-8"), dtype=np.uint8)


# constant tables and UDF string constants already on a device: a stage
# uses them once per partition, and each copy to the card is a
# synchronous host-to-device transfer
_DEVICE_CONSTS = LruDict(4096)


def _on(device, name: str, arr: np.ndarray) -> torch.Tensor:
    """A constant table on `device`, copied there once. Callers never
    write to it."""
    key = (name, str(device))
    if key not in _DEVICE_CONSTS:
        _DEVICE_CONSTS[key] = torch.from_numpy(arr).to(device)
    return _DEVICE_CONSTS[key]


def broadcast_const(s: str, n: int, device):
    """Materialize a python str constant as an [n, W] batch."""
    b = const_bytes(s)
    row = np.zeros((1, max(len(b), 1)), dtype=np.uint8)
    row[0, : len(b)] = b
    return (_on(device, "str:" + s, row).expand(n, row.shape[1]),
            torch.full((n,), len(b), dtype=I32, device=device))


def _pos_mask(width: int, lens: torch.Tensor) -> torch.Tensor:
    """[N, width] bool — True where position < len."""
    return torch.arange(width, dtype=I32, device=lens.device)[None, :] \
        < lens[:, None]


def take_cols(mat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """take_along_axis(mat, idx, axis=1); idx must already be clipped to
    [0, W)."""
    return torch.gather(mat, 1, idx.to(torch.int64))


def find_const(bytes_, lens, needle: str, start=None, reverse: bool = False):
    """str.find / str.rfind with a constant needle. Returns int32 [N], -1 if
    absent. Empty needle matches at `start` (Python: ''.find -> 0)."""
    n, w = bytes_.shape
    dev = bytes_.device
    nb = const_bytes(needle)
    m = len(nb)
    if m == 0:
        if reverse:
            return lens.to(I32)  # s.rfind('') == len(s)
        base = torch.zeros(n, dtype=I32, device=dev) if start is None \
            else start
        return torch.where(base > lens, -1, base).to(I32)
    if m > w:
        return torch.full((n,), -1, dtype=I32, device=dev)
    # match[i, p] = bytes[i, p:p+m] == needle, for p in [0, w-m]
    npos = w - m + 1
    match = bytes_[:, 0:npos] == int(nb[0])
    for j in range(1, m):
        match = match & (bytes_[:, j: j + npos] == int(nb[j]))
    pos = torch.arange(npos, dtype=I32, device=dev)[None, :]
    match = match & (pos + m <= lens[:, None])
    if start is not None:
        # Python semantics: negative start counts from the end
        nstart = torch.where(start < 0, torch.clamp(start + lens, min=0),
                             start)
        match = match & (pos >= nstart[:, None])
    if reverse:
        found = torch.where(match, pos, -1).max(dim=1).values
    else:
        big = npos + 1
        first = torch.where(match, pos, big).min(dim=1).values
        found = torch.where(first >= big, -1, first)
    return found.to(I32)


def slice_(bytes_, lens, start, stop):
    """s[start:stop] with per-row bounds (int32 tensors, Python index
    semantics, or None for the defaults). Returns (bytes [N, Wout],
    lens [N]). Prefix slices (`s[:x]`) move no bytes: only the length
    shrinks and the tail is zeroed."""
    n, w = bytes_.shape
    dev = bytes_.device
    if stop is None:
        stop = lens
    stop = torch.minimum(
        torch.clamp(torch.where(stop < 0, stop + lens, stop), min=0), lens)
    cols = torch.arange(w, dtype=I32, device=dev)[None, :]
    if start is None:
        out_len = stop
        keep = cols < out_len[:, None]
        return torch.where(keep, bytes_, 0).to(U8), out_len.to(I32)
    start = torch.minimum(
        torch.clamp(torch.where(start < 0, start + lens, start), min=0),
        lens)
    out_len = torch.clamp(stop - start, min=0)
    idx = torch.clamp(start[:, None] + cols, 0, w - 1)
    out = take_cols(bytes_, idx)
    keep = cols < out_len[:, None]
    return torch.where(keep, out, 0).to(U8), out_len.to(I32)


def non_ascii_rows(bytes_, lens):
    """[N] bool — rows containing any non-ASCII byte inside their length.
    Index-space string ops count UTF-8 BYTES; for multibyte rows that
    diverges from Python's codepoint semantics, so those rows take the
    interpreter path."""
    inside = _pos_mask(bytes_.shape[1], lens)
    return (inside & (bytes_ >= 128)).any(dim=1)


def table_lookup(table, idx):
    """table[idx] for a small (<= 256-entry) lookup table and integer
    indices of any shape: the byte-classification primitive."""
    table = torch.as_tensor(table, device=idx.device)
    return table[idx.to(torch.int64)]


def contains_const(bytes_, lens, needle: str):
    return find_const(bytes_, lens, needle) >= 0


def char_at(bytes_, lens, idx):
    """s[i] -> (bytes [N, 1], lens [N] = 1, out-of-range [N] bool)."""
    n, w = bytes_.shape
    nidx = torch.where(idx < 0, idx + lens, idx)
    oob = (nidx < 0) | (nidx >= lens)
    ch = take_cols(bytes_, torch.clamp(nidx, 0, w - 1)[:, None])
    return ch.to(U8), torch.ones(n, dtype=I32, device=bytes_.device), oob


# ---------------------------------------------------------------------------
# case / replace / concat
# ---------------------------------------------------------------------------

def lower(bytes_, lens):
    is_up = (bytes_ >= 65) & (bytes_ <= 90)
    return torch.where(is_up, bytes_ + 32, bytes_).to(U8), lens


def upper(bytes_, lens):
    is_lo = (bytes_ >= 97) & (bytes_ <= 122)
    return torch.where(is_lo, bytes_ - 32, bytes_).to(U8), lens


def _py_space(bytes_):
    """The ASCII bytes str.isspace() holds for (\\t \\n \\v \\f \\r, the
    separators \\x1c-\\x1f, space): what str.strip() and str.split()
    remove. (int() and float() strip a smaller set, `_is_space`.)"""
    return (bytes_ == 32) | ((bytes_ >= 9) & (bytes_ <= 13)) | \
        ((bytes_ >= 28) & (bytes_ <= 31))


def strip(bytes_, lens, chars=None, left: bool = True, right: bool = True):
    """str.strip / lstrip / rstrip (`left`, `right`): without `chars` the
    ASCII whitespace of `_py_space`, else the bytes of the ASCII string
    `chars`. Whitespace beyond ASCII (U+0085, U+00A0, ...) is not seen:
    the caller sends rows with non-ASCII bytes to the interpreter."""
    w = bytes_.shape[1]
    pos = torch.arange(w, dtype=I32, device=bytes_.device)[None, :]
    if chars is None:
        strippable = _py_space(bytes_)
    else:
        strippable = torch.zeros_like(bytes_, dtype=torch.bool)
        for c in const_bytes(chars).tolist():
            strippable = strippable | (bytes_ == c)
    keep = (pos < lens[:, None]) & ~strippable
    if left:
        first = torch.where(keep, pos, w).min(dim=1).values
        start = torch.where(first >= w, lens, first)
    else:
        start = torch.zeros_like(lens)
    if right:
        last = torch.where(keep, pos, -1).max(dim=1).values
        stop = torch.where(last < 0, start, last + 1)
    else:
        stop = lens
    return slice_(bytes_, lens, start.to(I32),
                  torch.maximum(stop, start).to(I32))


def capwords(bytes_, lens):
    """string.capwords(s), ' '.join(w.capitalize() for w in s.split()),
    on ASCII: the words (runs outside `_py_space`) with their first byte
    upper case and the rest lower case, one space between them, none at
    the ends. The caller sends rows with non-ASCII bytes to the
    interpreter."""
    n, w = bytes_.shape
    dev = bytes_.device
    pos = torch.arange(w, dtype=I32, device=dev)[None, :]
    inside = pos < lens[:, None]
    space = _py_space(bytes_) & inside
    word = inside & ~space
    prev_word = torch.nn.functional.pad(word[:, :-1], (1, 0))
    low, _ = lower(bytes_, lens)
    up = word & ~prev_word & (low >= 97) & (low <= 122)
    cased = torch.where(up, low - 32, low)
    # a space right after a word, with another word later, becomes the
    # single separator
    words_after = word.sum(dim=1, keepdim=True) - torch.cumsum(word, dim=1)
    sep = space & prev_word & (words_after > 0)
    kept = word | sep
    dest = torch.cumsum(kept.to(I32), dim=1) - kept.to(I32)
    out = _scatter_cols(torch.zeros_like(bytes_),
                        torch.where(kept, dest, w),
                        torch.where(sep, 32, cased), w)
    return out.to(U8), kept.sum(dim=1).to(I32)


def pad_left(bytes_, lens, width: int):
    """s.rjust(width): the string moved right to end at `width`, the gap
    filled with spaces (longer strings unchanged)."""
    n, w = bytes_.shape
    wout = max(w, width)
    pos = torch.arange(wout, dtype=I32, device=bytes_.device)[None, :]
    gap = torch.clamp(width - lens, min=0)[:, None]
    src = take_cols(bytes_, torch.clamp(pos - gap, 0, w - 1))
    out_len = torch.maximum(lens, torch.full_like(lens, width))
    out = torch.where(pos < gap, 32, src)
    return torch.where(pos < out_len[:, None], out, 0).to(U8), \
        out_len.to(I32)


def _shift_right(mask, j: int):
    """mask moved j columns to the right (zeros shifted in)."""
    if j == 0:
        return mask
    return torch.nn.functional.pad(mask[:, : mask.shape[1] - j], (j, 0))


def _has_border(nb: np.ndarray) -> bool:
    """Whether some proper prefix of the needle is also its suffix: only
    then can two matches overlap."""
    m = len(nb)
    return any(np.array_equal(nb[:k], nb[m - k:]) for k in range(1, m))


def replace_const(bytes_, lens, old: str, new: str):
    """str.replace with constant old/new (Python's greedy left-to-right,
    non-overlapping matches). Same-length replacement rewrites in place,
    deletion compacts the kept bytes, anything else grows the width by the
    worst-case expansion factor."""
    ob, nbytes = const_bytes(old), const_bytes(new)
    m, k = len(ob), len(nbytes)
    n, w = bytes_.shape
    dev = bytes_.device
    if m == 0:
        raise NotImplementedError("replace with empty pattern")
    npos = w - m + 1
    if npos <= 0:
        return bytes_, lens
    match = bytes_[:, 0:npos] == int(ob[0])
    for j in range(1, m):
        match = match & (bytes_[:, j: j + npos] == int(ob[j]))
    pos = torch.arange(npos, dtype=I32, device=dev)[None, :]
    match = match & (pos + m <= lens[:, None])
    if m > 1 and _has_border(ob):
        # overlapping candidates: keep a match only if no kept match starts
        # in the m-1 columns before it (the sequential greedy scan)
        next_ok = torch.zeros(n, dtype=I32, device=dev)
        cols = []
        for c in range(npos):
            real = match[:, c] & (next_ok <= 0)
            next_ok = torch.where(real, m - 1, next_ok - 1)
            cols.append(real)
        match = torch.stack(cols, dim=1)
    is_start = torch.nn.functional.pad(match, (0, w - npos))   # [n, w]
    if k == m:
        out = bytes_
        for j in range(k):
            out = torch.where(_shift_right(is_start, j), int(nbytes[j]), out)
        return out.to(U8), lens
    consumed = is_start
    for j in range(1, m):
        consumed = consumed | _shift_right(is_start, j)
    inside = _pos_mask(w, lens)
    copied = inside & ~consumed
    if k == 0:
        # deletion: stable compaction of the kept bytes
        tgt = torch.where(copied, torch.cumsum(copied, dim=1) - 1, w)
        out = _scatter_cols(torch.zeros((n, w), dtype=U8, device=dev), tgt,
                            bytes_, w)
        return out, copied.sum(dim=1).to(I32)
    starts = is_start & inside
    contrib = torch.where(starts, k, copied.to(torch.int64))
    out_start = torch.cumsum(contrib, dim=1) - contrib   # exclusive prefix
    out_len = contrib.sum(dim=1).to(I32)
    grow = max(1, -(-k // m))
    wout = w * grow if k > m else w
    out = torch.zeros((n, wout), dtype=U8, device=dev)
    out = _scatter_cols(out, torch.where(copied, out_start, wout), bytes_,
                        wout)
    for j in range(k):
        src = torch.full((n, w), int(nbytes[j]), dtype=U8, device=dev)
        out = _scatter_cols(out, torch.where(starts, out_start + j, wout),
                            src, wout)
    return out, out_len


def _scatter_cols(out, tgt, src, wout: int):
    """out[row, tgt] = src where tgt < wout; targets >= wout are dropped.
    Targets in range are distinct within a row."""
    n = out.shape[0]
    buf = torch.cat([out, out.new_zeros((n, 1))], dim=1)
    buf.scatter_(1, torch.clamp(tgt, 0, wout).to(torch.int64),
                 src.to(out.dtype))
    return buf[:, :wout]


def concat(a_bytes, a_lens, b_bytes, b_lens):
    n, wa = a_bytes.shape
    wb = b_bytes.shape[1]
    wout = wa + wb
    dev = a_bytes.device
    pos = torch.arange(wout, dtype=I32, device=dev)[None, :]
    b_idx = pos - a_lens[:, None]
    valid_b = (b_idx >= 0) & (b_idx < b_lens[:, None])
    b_gathered = take_cols(b_bytes, torch.clamp(b_idx, 0, wb - 1))
    out = torch.nn.functional.pad(a_bytes, (0, wb))
    out = torch.where(valid_b, b_gathered, out)
    inside = (pos < a_lens[:, None]) | valid_b
    return torch.where(inside, out, 0).to(U8), (a_lens + b_lens).to(I32)


def equals(a_bytes, a_lens, b_bytes, b_lens):
    """a == b. Bytes past each length are zero, so equal lengths plus equal
    bytes over the narrower width decide it: a string longer than the
    narrow side's width fails the length check."""
    w = min(a_bytes.shape[1], b_bytes.shape[1])
    same = (a_bytes[:, :w] == b_bytes[:, :w]).all(dim=1)
    return same & (a_lens == b_lens)


def compare_lt(a_bytes, a_lens, b_bytes, b_lens, or_equal: bool = False):
    """a < b (a <= b with `or_equal`), byte-lexicographic over UTF-8, which
    is Python's code-point order for valid UTF-8: the first differing byte
    decides, else the shorter string is the smaller. Bytes past each length
    are masked, so a string that is a prefix of the other compares by
    length."""
    w = max(a_bytes.shape[1], b_bytes.shape[1])
    a, b = _pad_width(a_bytes, w), _pad_width(b_bytes, w)
    pos = torch.arange(w, dtype=I32, device=a.device)[None, :]
    a = torch.where(pos < a_lens[:, None], a, 0)
    b = torch.where(pos < b_lens[:, None], b, 0)
    first = torch.where(a != b, pos, w).min(dim=1).values
    no_diff = first >= w
    at = torch.clamp(first, max=w - 1)[:, None].to(torch.int64)
    lt = torch.where(no_diff, a_lens < b_lens,
                     torch.gather(a, 1, at)[:, 0] < torch.gather(b, 1, at)[:, 0])
    if or_equal:
        return lt | (no_diff & (a_lens == b_lens))
    return lt


def _pad_width(a, w: int):
    return a if a.shape[1] >= w else \
        torch.nn.functional.pad(a, (0, w - a.shape[1]))


# ---------------------------------------------------------------------------
# parse / format
# ---------------------------------------------------------------------------

# post-strip width cap for numeric parses: an i64 needs <= 20 characters;
# longer non-space spans route to the interpreter
_PARSE_WIN = 32


def _is_space(bytes_):
    """ASCII whitespace as str.strip() sees it (\\t \\n \\v \\f \\r and
    space); the other Unicode whitespace is non-ASCII and routes."""
    return (bytes_ == 32) | ((bytes_ >= 9) & (bytes_ <= 13))


def _span(bytes_, lens):
    """(first, last) non-space position inside each row: first = w + 1 and
    last = -1 for empty or all-space rows."""
    w = bytes_.shape[1]
    pos = torch.arange(w, dtype=I32, device=bytes_.device)[None, :]
    inside = pos < lens[:, None]
    core = inside & ~_is_space(bytes_)
    fs = torch.where(core, pos, w + 1).min(dim=1).values
    ls = torch.where(core, pos, -1).max(dim=1).values
    return pos, inside, fs, ls


def _narrowed_parse(core, bytes_, lens):
    """Run a numeric parse core on a _PARSE_WIN-wide window that starts at
    each row's first non-space byte, instead of the full width. Rows whose
    non-space span is wider than the window can still be valid numbers
    ('0' * 40 + '7'): they route to the interpreter."""
    w = bytes_.shape[1]
    dev = bytes_.device
    _, _, fs, ls = _span(bytes_, lens)
    span = torch.clamp(ls - fs + 1, min=0)
    win = min(w, _PARSE_WIN)
    cols = torch.arange(win, dtype=I32, device=dev)[None, :]
    sb = take_cols(bytes_, torch.clamp(fs[:, None] + cols, 0, w - 1))
    sl = torch.clamp(span, max=win).to(I32)
    sb = torch.where(cols < sl[:, None], sb, 0).to(U8)
    val, bad, route = core(sb, sl)
    long_rows = span > win
    return val, bad & ~long_rows, route | long_rows


def parse_i64(bytes_, lens):
    """int(s) semantics: optional surrounding whitespace, optional sign,
    ASCII digits. Returns (val int64 [N], bad bool [N], route bool [N]).
    `bad` rows raise ValueError in CPython. `route` rows are valid for
    CPython but outside this kernel: PEP 515 underscores ('1_000'),
    non-ASCII digits or whitespace, values outside int64 (and int64's
    minimum, conservatively), spans wider than the parse window; they
    resolve on the interpreter."""
    if bytes_.shape[1] <= _PARSE_WIN:
        return _parse_i64_core(bytes_, lens)
    return _narrowed_parse(_parse_i64_core, bytes_, lens)


_I64_MAX_LIT = np.frombuffer(b"9223372036854775807", np.uint8).astype(
    np.int64) - 48
_P10 = np.array([10 ** k for k in range(19)], dtype=np.int64)


def _parse_i64_core(sb, sl):
    """Digits are read from a <= 20-byte window after the sign, weighted by
    their power of ten and summed: every term is exact and partial sums of
    an in-range value never exceed it, so this equals the sequential
    Horner evaluation."""
    n, w = sb.shape
    dev = sb.device
    pos, inside, fs, ls = _span(sb, sl)
    sp = _is_space(sb)
    empty = ls < 0
    # whitespace strictly inside the span is invalid ("1 2")
    inner_sp = (sp & (pos >= fs[:, None]) & (pos <= ls[:, None])).any(dim=1)
    first = take_cols(sb, torch.clamp(fs, 0, w - 1)[:, None])[:, 0]
    has_sign = (first == 43) | (first == 45)
    neg = first == 45
    digit_start = fs + has_sign.to(I32)
    ndigits = ls - digit_start + 1
    win = min(w, 20)
    pos_w = digit_start[:, None] + torch.arange(win, dtype=I32,
                                                device=dev)[None, :]
    wb = take_cols(sb, torch.clamp(pos_w, 0, w - 1))
    in_zone = pos_w <= ls[:, None]
    is_digit = (wb >= 48) & (wb <= 57)
    bad = (in_zone & ~is_digit).any(dim=1) | (ndigits <= 0) | empty \
        | inner_sp
    dw = torch.where(in_zone, wb.to(torch.int64) - 48, 0)
    exp = ndigits[:, None] - 1 - torch.arange(win, dtype=I32,
                                              device=dev)[None, :]
    term_ok = in_zone & (exp >= 0) & (exp <= 18)
    p10 = _on(dev, "p10", _P10)
    val = torch.where(term_ok, dw * p10[torch.clamp(exp, 0, 18).to(
        torch.int64)], 0).sum(dim=1)
    if win >= 19:
        # 19-digit magnitudes above the int64 maximum: compare the digits
        # with the maximum's literal at the first place they differ
        diff = dw[:, :19] - _on(dev, "i64max", _I64_MAX_LIT)[None, :]
        cols19 = torch.arange(19, dtype=torch.int64, device=dev)[None, :]
        firstd = torch.where(diff != 0, cols19, 19).min(dim=1).values
        over = torch.gather(torch.nn.functional.pad(diff, (0, 1)), 1,
                            firstd[:, None])[:, 0] > 0
        ovf = (ndigits == 19) & over
    else:
        ovf = torch.zeros(n, dtype=torch.bool, device=dev)
    outside = (inside & ((sb == 95) | (sb >= 128))).any(dim=1)
    bad = bad & ~outside
    route = (ovf | (ndigits > 19) | outside) & ~bad
    return torch.where(neg, -val, val), bad, route


_I64_MAX_DIGITS = 20   # sign + 19 digits


def format_i64(vals, width: int = 0, pad_zero: bool = False):
    """str(i) / '%0Nd' % i -> (bytes [N, max(20, width) + 1], lens [N]).

    Digits come from the value's non-positive mirror (v for v < 0, -v
    otherwise) by truncating division, so the int64 minimum needs no
    clamp and nothing leaves int64."""
    n = vals.shape[0]
    dev = vals.device
    w = max(_I64_MAX_DIGITS, width)
    neg = vals < 0
    q = torch.where(neg, vals, -vals)
    # uint64-free: 10**19 exceeds int64, and every int64 has a 0 there
    p10 = _on(dev, "p10_desc", _P10[::-1].copy())               # 10**18..1
    digits = -torch.fmod(torch.div(q[:, None], p10[None, :],
                                   rounding_mode="trunc"), 10)
    digits = digits.to(U8) + 48
    digits = torch.cat([torch.full((n, w - 19), 48, dtype=U8, device=dev),
                        digits], dim=1)
    lead = (torch.cumsum(digits != 48, dim=1) == 0).sum(dim=1)
    ndig = torch.clamp(w - lead, min=1)
    if pad_zero and width > 0:
        ndig = torch.maximum(ndig, width - neg.to(ndig.dtype))
    negi = neg.to(torch.int64)
    out_len = (ndig + negi).to(I32)
    pos = torch.arange(w + 1, dtype=torch.int64, device=dev)[None, :]
    digit_idx = pos - negi[:, None] + (w - ndig)[:, None]
    padded = torch.nn.functional.pad(digits, (0, 1))
    out = torch.gather(padded, 1, torch.clamp(digit_idx, 0, w))
    out = torch.where((pos == 0) & neg[:, None], 45, out)
    out = torch.where(pos < out_len[:, None], out, 0)
    return out.to(U8), out_len


# exact doubles: 10**k for k <= 22 (the Clinger fast path's range)
_P10F = np.array([10.0 ** k for k in range(23)], dtype=np.float64)
_TWO53 = 1 << 53


def parse_f64(bytes_, lens):
    """float(s) semantics: optional surrounding whitespace, optional sign,
    digits with at most one '.', an optional exponent. Returns (val float64
    [N], bad bool [N], route bool [N]). `bad` rows raise ValueError in
    CPython. `route` rows are valid for CPython, or may be, but outside
    this kernel, and resolve on the interpreter: 'inf'/'infinity'/'nan'
    words, PEP 515 underscores, non-ASCII bytes, spans wider than the parse
    window, and every value outside the exact fast path below. So every
    value returned equals CPython's float() bit for bit."""
    return _narrowed_parse(_parse_f64_core, bytes_, lens)


def _parse_f64_core(sb, sl):
    """The value is one correctly rounded multiply or divide: an integer
    mantissa below 2**53 is exact in float64, as is 10**|e| for |e| <= 22
    (Clinger's fast path, the one strtod takes for such inputs). A zero
    mantissa is a signed zero for any exponent. Mantissas of 2**53 or more,
    or with a nonzero digit past the 16th place, and exponents beyond the
    range route; the powers come from an exact table, never `pow`."""
    n, w = sb.shape
    dev = sb.device
    pos = torch.arange(w, dtype=I32, device=dev)[None, :]
    inside = pos < sl[:, None]
    first = sb[:, 0]
    neg = first == 45
    b0 = ((first == 43) | neg).to(I32)
    digit = (sb >= 48) & (sb <= 57)
    big = w + 1
    e_pos = torch.where(inside & ((sb == 101) | (sb == 69)), pos,
                        big).min(dim=1).values
    has_e = e_pos < big
    mant_end = torch.where(has_e, e_pos, sl)
    in_mant = inside & (pos >= b0[:, None]) & (pos < mant_end[:, None])
    dot = in_mant & (sb == 46)
    n_dot = dot.sum(dim=1)
    dot_pos = torch.where(dot, pos, big).min(dim=1).values
    mdig = in_mant & digit
    n_mdig = mdig.sum(dim=1)
    valid = ~(in_mant & ~digit & ~dot).any(dim=1) & (n_dot <= 1) \
        & (n_mdig > 0)
    # the exponent: [+-] and at least one digit, nothing else
    es = torch.clamp(e_pos + 1, max=w - 1)
    ech = torch.gather(sb, 1, es[:, None].to(torch.int64))[:, 0]
    e_sign = has_e & (e_pos + 1 < sl) & ((ech == 43) | (ech == 45))
    e_neg = e_sign & (ech == 45)
    in_exp = has_e[:, None] & inside & \
        (pos >= (e_pos + 1 + e_sign.to(I32))[:, None])
    edig = in_exp & digit
    valid = valid & ~(has_e & ((in_exp & ~digit).any(dim=1)
                               | (edig.sum(dim=1) == 0)))
    # digit weights: the count of digits after each one in its part. A
    # valid mantissa is digits and at most one dot, an exponent digits
    # only, so that count follows from positions (no scan)
    d = sb.to(torch.int64) - 48
    p10 = _on(dev, "p10", _P10)
    m_exp = mant_end[:, None] - 1 - pos - (
        (n_dot > 0)[:, None] & (dot_pos[:, None] > pos)).to(I32)
    mant = torch.where(mdig & (m_exp <= 15),
                       d * p10[torch.clamp(m_exp, 0, 15).to(torch.int64)],
                       0).sum(dim=1)
    wide_mant = (mdig & (d != 0) & (m_exp > 15)).any(dim=1)
    x_exp = sl[:, None] - 1 - pos
    e_val = torch.where(edig & (x_exp <= 4),
                        d * p10[torch.clamp(x_exp, 0, 4).to(torch.int64)],
                        0).sum(dim=1)
    wide_exp = (edig & (d != 0) & (x_exp > 4)).any(dim=1)
    n_frac = torch.where(n_dot > 0, mant_end - dot_pos - 1, 0)
    e = torch.where(e_neg, -e_val, e_val) - n_frac
    zero = mant == 0
    fast = ~wide_mant & ~wide_exp & (mant < _TWO53) & (e.abs() <= 22)
    mf = mant.to(torch.float64)
    pw = _on(dev, "p10f", _P10F)[torch.clamp(e.abs(), 0, 22)]
    val = torch.where(e >= 0, mf * pw, mf / pw)
    val = torch.where(zero, 0.0, val)
    val = torch.where(neg, -val, val)
    # words and bytes this kernel does not read: CPython decides
    outside = (inside & ((sb == 95) | (sb >= 128))).any(dim=1)
    words = _word_at(sb, sl, b0, "inf") | _word_at(sb, sl, b0, "infinity") \
        | _word_at(sb, sl, b0, "nan")
    route = outside | words | (valid & ~zero & ~fast)
    bad = ~valid & ~outside & ~words
    return val, bad, route


def _word_at(sb, sl, b0, word: str):
    """Rows whose text after the sign is `word`, in any case."""
    n, w = sb.shape
    k = len(word)
    idx = b0[:, None] + torch.arange(k, dtype=I32, device=sb.device)[None, :]
    ch = torch.gather(sb, 1, torch.clamp(idx, 0, w - 1).to(torch.int64))
    want = _on(sb.device, "word:" + word, const_bytes(word).copy())
    return ((sl - b0) == k) & ((ch | 32) == want[None, :]).all(dim=1)
