"""The join probe (counterpart of the device probe of the reference
package's join, `tuplex_tpu/exec/joinexec.py:629` `_build_probe_fn`).

For B probe rows of nw packed key words (`runtime/columns.py`
`pack_sig_words`: a key signature's bytes big-endian in 64-bit words,
held in int64 tensors), `join_probe` gives the lower bound of each row in
the u sorted unique build rows, clipped to [0, u - 1], and whether the
build row there equals it. The words are ordered as unsigned integers,
first word first; torch compares int64 as signed, so the torch routes
flip each word's top bit, which maps unsigned order onto signed order.

The build side's words are held in a `ProbeIndex`, built once per build
side: the rows, their first words, fences of the first words and a radix
table over the bits after the prefix they all share, which names each
probe's bucket of fences. `join_probe` sends every width to the
hand-written CUDA kernel (csrc/join_probe.cu, ops/join_cuda.py) for CUDA
tensors, and to `lower_bound_index_plain`, the kernel's plain torch
version, only for CPU tensors. `lower_bound_plain` is the textbook binary
search over whole rows, the yardstick both are held to.
"""

from __future__ import annotations

import torch

I64_MIN = -(1 << 63)
RADIX_MAX_BITS = 14      # a 64 KB radix table (int32)
SHARED_BYTES = 232_448   # a block's shared memory on an H100 (opt-in)


def flip(words: torch.Tensor) -> torch.Tensor:
    """int64 words whose signed order is the unsigned order of `words`."""
    return words ^ I64_MIN


def _layout(u: int, shift: int, bits: int | None,
            group_shift: int | None):
    """(group_shift, bits, radix_words, fence_words): the smallest group
    (a fence every 2**group_shift first words) whose fences fit shared
    memory beside a radix table of up to `bits` bits (default: the bit
    length of the fence count, at most RADIX_MAX_BITS, giving up to three
    bits for a smaller group; a given `bits` shrinks as far as need be).
    A given `group_shift` is taken as it is, fitting or not (the kernel
    then refuses it)."""
    for gs in range(32) if group_shift is None else [group_shift]:
        m = -(-u // (1 << gs))
        top = min(bits if bits is not None else
                  min(RADIX_MAX_BITS, m.bit_length()), 64 - shift)
        lowest = 0 if bits is not None else max(top - 3, 0)
        fence_words = (m + 1) // 2 * 2
        for b in range(top, lowest - 1, -1):
            radix_words = ((1 << b) + 1 + 3) // 4 * 2
            if (radix_words + fence_words) * 8 <= SHARED_BYTES or \
                    (group_shift is not None and b == lowest):
                return gs, b, radix_words, fence_words
    raise ValueError(f"probe_index: {u} keys do not fit")


class ProbeIndex:
    """The sorted unique build words [u, nw] (u >= 1) and the search index
    the probe kernel reads, on the words' device.

    The fences are every (2**group_shift)-th first word (all of them when
    group_shift is 0, as long as they fit a block's shared memory beside
    the radix table). The first words share their top `shift` bits;
    `radix[x]` is the number of fences whose `bits` bits after those are
    below x, so a first word p in [first[0], first[-1]] has the fences
    below it among fence[radix[x]:radix[x + 1]] for
    x = (p >> down) & (2**bits - 1). With groups, the fences below p
    name the group of first words that holds its lower bound.

    `blob` (int64) holds `radix_words` words that hold the int32 radix
    table `radix` (2**bits + 1 entries), then `fence_words` words of
    fences, then (with groups) the first words padded with ~0 past a whole
    group; the kernel copies the radix table and the fences into shared
    memory (cp.async, 16 bytes at a time). `group_shift` and `bits`
    choose the layout (tests pass them to reach every path); by default
    the group is the smallest that fits."""

    def __init__(self, words: torch.Tensor, bits: int | None = None,
                 group_shift: int | None = None):
        if words.dim() != 2 or words.shape[0] < 1 or words.shape[1] < 1 or \
                words.dtype != torch.int64:
            raise ValueError(f"probe_index: want int64 [u >= 1, nw >= 1] "
                             f"words, got {words.dtype} "
                             f"{tuple(words.shape)}")
        self.words = words.contiguous()
        u, self.nw = self.words.shape
        self.u = u
        first = self.words[:, 0]
        lo, hi = torch.stack([first[0], first[-1]]).tolist()
        self.shift = 64 - ((lo ^ hi) & ((1 << 64) - 1)).bit_length()
        self.group_shift, self.bits, self.radix_words, self.fence_words = \
            _layout(u, self.shift, bits, group_shift)
        self.down = 64 - self.shift - self.bits
        group = 1 << self.group_shift
        fences = first[::group]
        n = 1 << self.bits
        counts = torch.bincount(self.bucket(fences), minlength=n)
        self.max_bucket = int(counts.max())
        # with groups, the first words padded to a whole group and 8
        # words more (the kernel reads groups of up to 8 as 8 words)
        first_words = (-(-u // group) * group + 9) // 2 * 2 \
            if self.group_shift else 0
        dev = self.words.device
        self.blob = torch.full(
            (self.radix_words + self.fence_words + first_words,), -1,
            dtype=torch.int64, device=dev)
        self.radix = self.blob[:self.radix_words].view(torch.int32)[:n + 1]
        self.radix[0] = 0
        self.radix[1:] = torch.cumsum(counts, 0)
        self.fences = self.blob[self.radix_words:
                                self.radix_words + len(fences)]
        self.fences.copy_(fences)
        # the first words: after the fences with groups, else the fences
        at = self.radix_words + (self.fence_words if self.group_shift
                                 else 0)
        self.first = self.blob[at:at + u]
        if self.group_shift:
            self.first.copy_(first)

    def bucket(self, first: torch.Tensor) -> torch.Tensor:
        """The radix bits of first words (meaningful for words within
        [first[0], first[-1]], which share the prefix)."""
        return (first >> self.down) & ((1 << self.bits) - 1)


def probe_index(words: torch.Tensor, bits: int | None = None,
                group_shift: int | None = None) -> ProbeIndex:
    """The index of the sorted unique build words [u, nw], once per build
    side (see ProbeIndex)."""
    return ProbeIndex(words, bits, group_shift)


def _search_rows(fw: torch.Tensor, fb: torch.Tensor, lo: torch.Tensor,
                 hi: torch.Tensor, steps: int) -> torch.Tensor:
    """The lower bound of each flipped row of fw among the flipped build
    rows fb[lo:hi] (hi where none is not below), by `steps` binary-search
    steps over every row at once, the first differing word deciding."""
    u = fb.shape[0]
    for _ in range(steps):
        mid = (lo + hi) // 2
        mw = fb[torch.clamp(mid, max=u - 1)]
        diff = mw != fw
        first = torch.argmax(diff.to(torch.uint8), dim=1, keepdim=True)
        below = diff.any(dim=1) & (torch.gather(mw, 1, first) <
                                   torch.gather(fw, 1, first))[:, 0]
        open_ = lo < hi
        lo = torch.where(open_ & below, mid + 1, lo)
        hi = torch.where(open_ & ~below, mid, hi)
    return lo


def lower_bound_plain(words: torch.Tensor, build: torch.Tensor):
    """(pos int64 [B], matched bool [B]) by a binary search of every row
    at once over the whole build rows: log2(u) + 1 steps, each comparing
    the row with the build row at its midpoint."""
    b = words.shape[0]
    u = build.shape[0]
    lo = torch.zeros(b, dtype=torch.int64, device=words.device)
    hi = torch.full((b,), u, dtype=torch.int64, device=words.device)
    lo = _search_rows(flip(words), flip(build), lo, hi, u.bit_length())
    return _finish(lo, words, build)


def lower_bound_index_plain(words: torch.Tensor, index: ProbeIndex):
    """(pos int64 [B], matched bool [B]) by the kernel's steps: probes
    outside [first[0], first[-1]] go to either end; the others search the
    fences of their radix bucket and, with groups, count the words of the
    group that holds their lower bound; a probe whose first word ties
    settles on the build rows from the first of the tie on."""
    u = index.u
    p0 = words[:, 0]
    fp0, ff = flip(p0), flip(index.first)
    fences = flip(index.fences)
    below, above = fp0 < ff[0], fp0 > ff[-1]
    x = index.bucket(p0)
    radix = index.radix.to(torch.int64)
    lo = torch.where(below | above, 0, radix[x])
    hi = torch.where(below | above, 0, radix[x + 1])
    m = len(fences)
    for _ in range(index.max_bucket.bit_length()):
        mid = (lo + hi) // 2
        less = fences[torch.clamp(mid, max=m - 1)] < fp0
        open_ = lo < hi
        lo = torch.where(open_ & less, mid + 1, lo)
        hi = torch.where(open_ & ~less, mid, hi)
    if index.group_shift:
        group = 1 << index.group_shift
        g0 = torch.clamp(lo - 1, min=0) * group
        at = torch.clamp(g0[:, None] + torch.arange(group, device=lo.device),
                         max=u - 1)
        inside = g0[:, None] + torch.arange(group, device=lo.device) < u
        n_below = ((ff[at] < fp0[:, None]) & inside).sum(dim=1)
        lo = torch.where(lo > 0, g0 + n_below, 0)
    lo = torch.where(below, 0, torch.where(above, u, lo))
    if index.nw > 1:
        tie = (lo < u) & (ff[torch.clamp(lo, max=u - 1)] == fp0)
        rows = torch.nonzero(tie)[:, 0]
        if len(rows):
            lo[rows] = _search_rows(
                flip(words[rows]), flip(index.words), lo[rows],
                torch.full_like(rows, u), u.bit_length())
    return _finish(lo, words, index.words)


def _finish(lo: torch.Tensor, words: torch.Tensor, build: torch.Tensor):
    u = build.shape[0]
    pos = torch.clamp(lo, max=u - 1)
    matched = (lo < u) & (build[pos] == words).all(dim=1)
    return pos, matched


def join_probe(words: torch.Tensor, index: ProbeIndex):
    """(pos int64 [B], matched bool [B]) of probe words [B, nw] in the
    build side's `index`, on their device."""
    if words.dim() != 2 or words.shape[1] != index.nw:
        raise ValueError(f"join_probe: bad shapes {tuple(words.shape)} and "
                         f"{tuple(index.words.shape)}")
    if words.is_cuda:
        from . import join_cuda

        return join_cuda.probe(words, index)
    return lower_bound_index_plain(words, index)
