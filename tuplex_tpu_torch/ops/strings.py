"""String kernels over fixed-width byte matrices (counterpart of
`tuplex_tpu/ops/strings.py`, the subset this package's emitter uses).

Representation: a batch of N strings is (bytes: uint8 [N, W] zero-padded,
lens: int32 [N]) on one device. Constant needles are Python values baked
into the op sequence. Kernels never raise: they return sentinels (-1 for
"not found") that the emitter turns into error-lattice updates.

Byte gathers use `torch.gather`. The reference package rewrites them as
one-hot bf16 contractions on accelerators (its `_mxu_gather`); that form
exists for the TPU's matrix unit and costs W times the work on a GPU.
"""

from __future__ import annotations

import numpy as np
import torch

from ..runtime.torchcfg import I32, U8


def const_bytes(s: str) -> np.ndarray:
    return np.frombuffer(s.encode("utf-8"), dtype=np.uint8)


def broadcast_const(s: str, n: int, device):
    """Materialize a python str constant as an [n, W] batch."""
    b = const_bytes(s)
    w = max(len(b), 1)
    row = torch.zeros((1, w), dtype=U8, device=device)
    if len(b):
        row[0, : len(b)] = torch.from_numpy(b.copy()).to(device)
    return (row.expand(n, w),
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
