"""The join probe (counterpart of the device probe of the reference
package's join, `tuplex_tpu/exec/joinexec.py:629` `_build_probe_fn`).

For B probe rows of nw packed key words (`runtime/columns.py`
`pack_sig_words`: a key signature's bytes big-endian in 64-bit words,
held in int64 tensors), `join_probe` gives the lower bound of each row in
the u sorted unique build rows, clipped to [0, u - 1], and whether the
build row there equals it. The words are ordered as unsigned integers,
first word first; torch compares int64 as signed, so the torch routes
flip each word's top bit, which maps unsigned order onto signed order.

Routes: one-word keys go to `torch.searchsorted` on every device; wider
keys go to the hand-written CUDA kernel (csrc/join_probe.cu, ops/
join_cuda.py) for CUDA tensors, and to `lower_bound_plain`, the kernel's
plain torch version, only for CPU tensors.
"""

from __future__ import annotations

import torch

I64_MIN = -(1 << 63)


def flip(words: torch.Tensor) -> torch.Tensor:
    """int64 words whose signed order is the unsigned order of `words`."""
    return words ^ I64_MIN


def lower_bound_plain(words: torch.Tensor, build: torch.Tensor):
    """(pos int64 [B], matched bool [B]) by a binary search of every row
    at once: log2(u) + 1 steps, each comparing the row with the build row
    at its midpoint, the first differing word deciding."""
    b, nw = words.shape
    u = build.shape[0]
    fw, fb = flip(words), flip(build)
    lo = torch.zeros(b, dtype=torch.int64, device=words.device)
    hi = torch.full((b,), u, dtype=torch.int64, device=words.device)
    for _ in range(u.bit_length()):
        mid = (lo + hi) // 2
        mw = fb[torch.clamp(mid, max=u - 1)]
        diff = mw != fw
        first = torch.argmax(diff.to(torch.uint8), dim=1, keepdim=True)
        below = diff.any(dim=1) & (torch.gather(mw, 1, first) <
                                   torch.gather(fw, 1, first))[:, 0]
        open_ = lo < hi
        lo = torch.where(open_ & below, mid + 1, lo)
        hi = torch.where(open_ & ~below, mid, hi)
    return _finish(lo, words, build)


def _finish(lo: torch.Tensor, words: torch.Tensor, build: torch.Tensor):
    u = build.shape[0]
    pos = torch.clamp(lo, max=u - 1)
    matched = (lo < u) & (build[pos] == words).all(dim=1)
    return pos, matched


def join_probe(words: torch.Tensor, build: torch.Tensor):
    """(pos int64 [B], matched bool [B]) of probe words [B, nw] in the
    sorted unique build words [u, nw] (u >= 1), on their device."""
    if words.dim() != 2 or build.dim() != 2 or \
            words.shape[1] != build.shape[1] or build.shape[0] < 1:
        raise ValueError(f"join_probe: bad shapes {tuple(words.shape)} and "
                         f"{tuple(build.shape)}")
    if words.shape[1] == 1:
        fb = flip(build[:, 0]).contiguous()
        lo = torch.searchsorted(fb, flip(words[:, 0]).contiguous())
        return _finish(lo, words, build)
    if words.is_cuda:
        from . import join_cuda

        return join_cuda.probe(words, build)
    return lower_bound_plain(words, build)
