"""Unanchored regex existence: bit-parallel Glushkov NFA (counterpart of
`tuplex_tpu/ops/nfa.py`).

The pattern becomes a Glushkov position automaton of at most 64 positions,
so a row's state set is one 64-bit word. Per byte column j:

    S' = (follow(S) | FIRST) & CLASSTAB[byte]       # unanchored restart
    matched |= S' & LAST (subject to the '$' rule)

NFA simulation explores every alternative at once, so `matched` is EXACT
for the supported features (literals, classes, '.', alternation, groups as
grouping, ?, *, +, {m,n} by expansion, leading ^ and trailing $). No
capture groups: a UDF that calls `.group()` on this path is NotCompilable
and interprets.

`NFARegex.match` sends CUDA tensors to the hand-written CUDA kernel
(ops/nfa_cuda.py, csrc/nfa_scan.cu) and CPU tensors to `match_bitmask`,
the plain torch version of the same scan. The masks are held as int64
(bit 63 is the sign bit): torch's uint64 has no shifts on the CPU, and
`(S >> p) & 1` tests bit p correctly under an arithmetic shift.
"""

from __future__ import annotations

from collections.abc import Mapping
from dataclasses import dataclass

import numpy as np
import torch

from ..core.errors import NotCompilable
from ..runtime.torchcfg import I32, I64
from .regex import _byte_in_spec, _in_spec

try:
    from re import _constants as _sc
    from re import _parser as _sre
except ImportError:  # pragma: no cover - older layout
    import sre_constants as _sc         # type: ignore
    import sre_parse as _sre            # type: ignore

_MAXREPEAT = _sc.MAXREPEAT
_MAX_POSITIONS = 64   # one 64-bit state word
_MAX_EXPAND = 32      # {m,n} expansion cap


class _Frag:
    """Glushkov attributes of a subpattern: nullable, first/last position
    sets (bitmasks), with follow edges accumulated in the builder."""

    __slots__ = ("nullable", "first", "last")

    def __init__(self, nullable: bool, first: int, last: int):
        self.nullable = nullable
        self.first = first
        self.last = last


class _Builder:
    def __init__(self):
        self.specs: list[tuple] = []     # position -> class spec
        self.follow: list[int] = []      # position -> bitmask of successors

    def add_position(self, spec: tuple) -> int:
        p = len(self.specs)
        if p >= _MAX_POSITIONS:
            raise NotCompilable("regex too large for the NFA lane")
        self.specs.append(spec)
        self.follow.append(0)
        return p

    def link(self, lasts: int, firsts: int) -> None:
        p = 0
        while lasts:
            if lasts & 1:
                self.follow[p] |= firsts
            lasts >>= 1
            p += 1

    def _then(self, frag: _Frag, nxt: _Frag) -> _Frag:
        self.link(frag.last, nxt.first)
        return _Frag(frag.nullable and nxt.nullable,
                     frag.first | (nxt.first if frag.nullable else 0),
                     nxt.last | (frag.last if nxt.nullable else 0))

    def build_seq(self, seq) -> _Frag:
        frag = _Frag(True, 0, 0)
        for term in seq:
            frag = self._then(frag, self.build_term(term))
        return frag

    def build_term(self, term) -> _Frag:
        op, av = term
        opn = str(op)
        if opn.endswith("NOT_LITERAL"):
            p = self.add_position((("neg",), ("lit", av)))
            return _Frag(False, 1 << p, 1 << p)
        if opn.endswith("LITERAL"):
            p = self.add_position((("lit", av),))
            return _Frag(False, 1 << p, 1 << p)
        if opn.endswith("ANY"):
            p = self.add_position((("neg",), ("lit", 10)))   # '.'
            return _Frag(False, 1 << p, 1 << p)
        if opn.endswith("IN"):
            p = self.add_position(_in_spec(av))
            return _Frag(False, 1 << p, 1 << p)
        if opn.endswith("BRANCH"):
            _, branches = av
            frag = None
            for b in branches:
                f = self.build_seq(list(b))
                frag = f if frag is None else _Frag(
                    frag.nullable or f.nullable,
                    frag.first | f.first, frag.last | f.last)
            return frag if frag is not None else _Frag(True, 0, 0)
        if opn.endswith("SUBPATTERN"):
            _g, addf, delf, sub = av
            if addf or delf:
                raise NotCompilable("regex inline flags")
            return self.build_seq(list(sub))
        if opn.endswith("MAX_REPEAT") or opn.endswith("MIN_REPEAT"):
            # lazy repeats change which match python picks, not WHETHER
            # one exists: boolean existence is identical
            mn, mx, item = av
            sub = list(item)
            if mx != _MAXREPEAT and mx > _MAX_EXPAND:
                raise NotCompilable("regex repeat bound too large")
            if mn > _MAX_EXPAND:
                raise NotCompilable("regex repeat bound too large")
            frag = _Frag(True, 0, 0)
            for _ in range(mn):                     # m mandatory copies
                frag = self._then(frag, self.build_seq(sub))
            if mx == _MAXREPEAT:
                # one looping copy (E* after the mandatory prefix)
                nxt = self.build_seq(sub)
                self.link(frag.last, nxt.first)
                self.link(nxt.last, nxt.first)
                return _Frag(frag.nullable,
                             frag.first | (nxt.first if frag.nullable else 0),
                             frag.last | nxt.last)
            for _ in range(mx - mn):
                nxt = self.build_seq(sub)
                self.link(frag.last, nxt.first)
                frag = _Frag(frag.nullable,
                             frag.first | (nxt.first if frag.nullable else 0),
                             frag.last | nxt.last)
            return frag
        raise NotCompilable(f"regex op {op} (NFA)")


@dataclass(frozen=True)
class NFATables:
    """Everything the scan needs: CLASSTAB[c] is the bitmask of positions
    whose class contains byte c, follow[p] the successors of position p."""

    classtab: np.ndarray      # uint64 [256]
    follow: np.ndarray        # uint64 [n_pos]
    first: int
    last: int
    n_pos: int
    nullable: bool
    anchored_start: bool
    anchored_end: bool

    def __eq__(self, other) -> bool:
        if not isinstance(other, NFATables):
            return NotImplemented
        return (np.array_equal(self.classtab, other.classtab)
                and np.array_equal(self.follow, other.follow)
                and (self.first, self.last, self.n_pos, self.nullable,
                     self.anchored_start, self.anchored_end)
                == (other.first, other.last, other.n_pos, other.nullable,
                    other.anchored_start, other.anchored_end))


def tables_from_reference(npz_like) -> NFATables:
    """The port's tables from the reference package's `NFARegex` numpy
    tables (`_classtab`, `_follow_np`, `first`, `last`, `n_pos`,
    `nullable`, `anchored_start`, `anchored_end`), given as a mapping (an
    npz archive, a dict) or as the object itself."""
    get = npz_like.__getitem__ if isinstance(npz_like, Mapping) \
        else lambda k: getattr(npz_like, k)
    return NFATables(
        classtab=np.asarray(get("_classtab"), dtype=np.uint64).copy(),
        follow=np.asarray(get("_follow_np"), dtype=np.uint64).copy(),
        first=int(get("first")), last=int(get("last")),
        n_pos=int(get("n_pos")), nullable=bool(get("nullable")),
        anchored_start=bool(get("anchored_start")),
        anchored_end=bool(get("anchored_end")))


def follow_chunks(follow, n_pos: int) -> np.ndarray:
    """Byte-chunked follow tables, uint64 [ceil(n_pos / 8), 256]:
    F8[c][v] is the OR of follow[8c + b] over the set bits b of v. The
    successors of a state set S are then the OR over c of
    F8[c][(S >> 8c) & 0xff], a fixed number of lookups whatever S holds
    (the CUDA kernel's transition)."""
    nchunk = (n_pos + 7) // 8
    fol = np.zeros(nchunk * 8, dtype=np.uint64)
    fol[:n_pos] = np.asarray(follow, dtype=np.uint64)[:n_pos]
    fol = fol.reshape(nchunk, 8)
    bits = (np.arange(256)[None, :] >> np.arange(8)[:, None]) & 1  # [8, 256]
    f8 = np.zeros((nchunk, 256), dtype=np.uint64)
    for b in range(8):
        f8 |= np.where(bits[b][None, :] == 1, fol[:, b:b + 1], np.uint64(0))
    return f8


def _signed(mask: int) -> int:
    """A 64-bit mask as the int64 with the same bits."""
    return mask - (1 << 64) if mask >= 1 << 63 else mask


class NFARegex:
    """match(bytes [N, W] uint8, lens [N] int32) -> matched [N] bool."""

    def __init__(self, pattern: str, anchored_start: bool = False):
        try:
            tree = _sre.parse(pattern)
        except Exception as e:
            raise NotCompilable(f"regex parse: {e}")
        import re as _pyre

        if tree.state.flags & ~_pyre.UNICODE.value:
            raise NotCompilable("regex flags")
        if any(ord(c) > 127 for c in pattern):
            raise NotCompilable("non-ASCII regex pattern")
        terms = list(tree)
        anchored_end = False
        # leading ^ / trailing $ (top level only); the sre op name for
        # anchors is exactly "AT" (endswith would also hit MAX_REPEAT)
        if terms and str(terms[0][0]) == "AT":
            if "AT_BEGINNING" in str(terms[0][1]):
                anchored_start = True
                terms = terms[1:]
            else:
                raise NotCompilable(f"regex anchor {terms[0][1]}")
        if terms and str(terms[-1][0]) == "AT":
            if str(terms[-1][1]).endswith("AT_END"):
                anchored_end = True
                terms = terms[:-1]
            else:
                raise NotCompilable(f"regex anchor {terms[-1][1]}")
        if any(str(op) == "AT" for op, _ in terms):
            raise NotCompilable("regex anchor mid-pattern")
        b = _Builder()
        frag = b.build_seq(terms)
        tab = np.zeros(256, dtype=np.uint64)
        for p, spec in enumerate(b.specs):
            for c in range(256):
                if _byte_in_spec(c, spec):
                    tab[c] |= np.uint64(1 << p)
        self.tables = NFATables(
            classtab=tab, follow=np.asarray(b.follow, dtype=np.uint64),
            first=frag.first, last=frag.last, n_pos=len(b.specs),
            nullable=frag.nullable, anchored_start=anchored_start,
            anchored_end=anchored_end)
        self._dev_tables: dict = {}
        self._kernel_bufs: dict = {}

    @property
    def n_pos(self) -> int:
        return self.tables.n_pos

    @property
    def anchored_start(self) -> bool:
        return self.tables.anchored_start

    @property
    def nullable(self) -> bool:
        return self.tables.nullable

    def match(self, bytes_: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
        """The CUDA kernel for CUDA tensors, the plain version for CPU
        tensors. Pure-anchor patterns (no positions, e.g. '^$') are decided
        by `_matched0` alone."""
        if self.tables.n_pos == 0:
            _, end_at = self._end_masks(bytes_, lens)
            return self._matched0(end_at)
        if bytes_.is_cuda:
            from . import nfa_cuda

            return nfa_cuda.match_cuda(
                self.tables, self._kernel_tables(bytes_.device),
                bytes_.contiguous(), lens.contiguous())
        return self.match_bitmask(bytes_, lens)

    @staticmethod
    def _end_masks(bytes_, lens):
        """(lens64, end_at): '$' also matches just before one trailing
        newline (python semantics)."""
        w = bytes_.shape[1]
        lens64 = lens.to(I64)
        lastpos = torch.clamp(lens64 - 1, 0, max(w - 1, 0))
        trailing_nl = (lens64 > 0) & (
            torch.gather(bytes_, 1, lastpos[:, None])[:, 0] == 10)
        return lens64, torch.where(trailing_nl, lens64 - 1, lens64)

    def _matched0(self, end_at):
        """Rows matched before any byte: a nullable pattern matches the
        empty string at position 0, except that '^...$' needs the row to
        be empty (up to one trailing newline)."""
        t = self.tables
        if t.nullable:
            if t.anchored_start and t.anchored_end:
                return end_at == 0
            return torch.ones_like(end_at, dtype=torch.bool)
        return torch.zeros_like(end_at, dtype=torch.bool)

    def _int64_tables(self, device):
        key = str(device)
        hit = self._dev_tables.get(key)
        if hit is None:
            t = self.tables
            hit = self._dev_tables[key] = torch.from_numpy(
                t.classtab.view(np.int64).copy()).to(device)
        return hit

    def _kernel_tables(self, device):
        """The CUDA kernel's table buffer (nfa_cuda.pack_tables), uploaded
        once per device."""
        key = str(device)
        hit = self._kernel_bufs.get(key)
        if hit is None:
            from . import nfa_cuda

            hit = self._kernel_bufs[key] = torch.from_numpy(
                nfa_cuda.pack_tables(self.tables).view(np.int64)).to(device)
        return hit

    _START_MAX_POS = 32   # the reference's cap for start tracking

    def match_start(self, bytes_: torch.Tensor, lens: torch.Tensor,
                    live: torch.Tensor | None = None):
        """(matched [N] bool, start [N] int32): the LEFTMOST match start,
        which is where CPython's re.search finds its match (start 0 where
        there is none). `live`, a bool [N] or None, limits the scan to
        its rows: a row where it is False gives (False, 0). The two-pass
        capture path passes this pattern's `match`, so only matched rows
        are scanned. CUDA tensors go to the hand-written kernel
        (ops/nfa_cuda.py `match_start_cuda`), CPU tensors to
        `match_start_plain`. Nullable patterns (a zero-width match) and
        patterns of no or more than 32 positions raise NotCompilable, as
        in the reference."""
        self._check_start()
        if bytes_.is_cuda:
            from . import nfa_cuda

            return nfa_cuda.match_start_cuda(
                self.tables, self._start_tables(bytes_.device),
                bytes_.contiguous(), lens.contiguous(),
                None if live is None else live.contiguous())
        return self.match_start_plain(bytes_, lens, live)

    def _check_start(self) -> None:
        if self.nullable:
            raise NotCompilable("start tracking over nullable pattern")
        if self.n_pos == 0 or self.n_pos > self._START_MAX_POS:
            raise NotCompilable("pattern outside start-tracking bounds")

    def _start_tables(self, device):
        """The start kernel's table buffer (nfa_cuda.pack_start_tables),
        uploaded once per device."""
        key = ("start", str(device))
        hit = self._kernel_bufs.get(key)
        if hit is None:
            from . import nfa_cuda

            hit = self._kernel_bufs[key] = torch.from_numpy(
                nfa_cuda.pack_start_tables(self.tables).view(
                    np.int32)).to(device)
        return hit

    def match_start_plain(self, bytes_, lens, live=None):
        """Plain torch version of the start scan, the reference package's
        min-plus formulation: S [N, P] holds for each NFA position the
        earliest seed column that reaches it (INF = inactive), and per
        byte column j

            S'[p] = min(min over q -> p of S[q], j if p in FIRST)
                    where the byte is in class(p), else INF
            best  = min(best, min over p in LAST of S'[p])  (subject to $)

        `live` (bool [N] or None) is applied to the result: (False, 0)
        where it is False. It holds the CUDA kernel to the reference's
        function."""
        self._check_start()
        t = self.tables
        n, w = bytes_.shape
        dev = bytes_.device
        P = t.n_pos
        INF = 1 << 29          # INF + INF stays inside int32
        bits = np.arange(P, dtype=np.uint64)
        unpack = lambda v: ((np.uint64(v) >> bits) & np.uint64(1)) == 1  # noqa: E731
        follow = np.stack([unpack(m) for m in t.follow])       # [q, p]
        cost = torch.from_numpy(
            np.where(follow, 0, INF).astype(np.int32)).to(dev)
        cmtab = torch.from_numpy(
            (t.classtab[:, None] >> bits[None, :]) & np.uint64(1) == 1
        ).to(dev)                                             # [256, P]
        first_b = torch.from_numpy(unpack(t.first)).to(dev)
        last_b = torch.from_numpy(unpack(t.last)).to(dev)
        lens64, end_at = self._end_masks(bytes_, lens)
        S = torch.full((n, P), INF, dtype=I32, device=dev)
        best = torch.full((n,), INF, dtype=I32, device=dev)
        inf = torch.full((), INF, dtype=I32, device=dev)
        for j in range(w):
            cm = cmtab[bytes_[:, j].to(I64)]
            nxt = (S[:, :, None] + cost[None, :, :]).amin(dim=1)
            if t.anchored_start:
                seed = torch.where(first_b & (j == 0), 0, inf)
            else:
                seed = torch.where(first_b, j, inf)
            S2 = torch.minimum(nxt, seed[None, :])
            S2 = torch.where(cm & (j < lens64)[:, None], S2, inf)
            hit = torch.where(last_b[None, :], S2, inf).amin(dim=1)
            if t.anchored_end:
                hit = torch.where((lens64 == j + 1) | (end_at == j + 1),
                                  hit, inf)
            S = S2
            best = torch.minimum(best, hit)
        matched = best < INF
        if live is not None:
            matched = matched & live
        return matched, torch.where(matched, best, 0).to(I32)

    def match_bitmask(self, bytes_, lens):
        """Plain torch version of the scan (one op sequence per byte
        column), the reference for the CUDA kernel."""
        t = self.tables
        n, w = bytes_.shape
        classtab = self._int64_tables(bytes_.device)
        first, last = _signed(t.first), _signed(t.last)
        follow = [_signed(int(m)) for m in t.follow]
        lens64, end_at = self._end_masks(bytes_, lens)
        matched = self._matched0(end_at)
        S = torch.zeros(n, dtype=I64, device=bytes_.device)
        for j in range(w):
            cm = classtab[bytes_[:, j].to(I64)]
            nxt = torch.zeros_like(S)
            for p, fm in enumerate(follow):
                if fm:
                    nxt |= (-((S >> p) & 1)) & fm
            seed = first if (j == 0 or not t.anchored_start) else 0
            S = (nxt | seed) & cm
            S = torch.where(j < lens64, S, 0)
            hit = (S & last) != 0
            if t.anchored_end:
                hit = hit & ((lens64 == j + 1) | (end_at == j + 1))
            matched = matched | hit
        return matched


_NFA_CACHE: dict[tuple, NFARegex] = {}


def compile_nfa(pattern: str, anchored_start: bool = False) -> NFARegex:
    key = (pattern, anchored_start)
    rx = _NFA_CACHE.get(key)
    if rx is None:
        rx = NFARegex(pattern, anchored_start)
        if len(_NFA_CACHE) > 256:
            _NFA_CACHE.clear()
        _NFA_CACHE[key] = rx
    return rx
