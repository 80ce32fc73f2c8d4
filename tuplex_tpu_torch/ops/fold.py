"""Device reductions of the aggregate stage: key factorization and sum,
min and max per segment (counterpart of the reference package's
`jnp.sum` / `jax.ops.segment_sum` calls in `exec/aggexec.py` and its key
factorization, `runtime/columns.py` `key_signature_matrix` and
`unique_rows`).

Every reduction has one fixed order of operations, given the shapes: a
float sum is the same bits run to run, and the same on the CPU and the
card. So no reduction here uses atomics (`index_add_` and `scatter_add_`
on CUDA do): a whole-batch reduction is a pairwise tree of elementwise
ops, a per-segment one a segmented scan over the rows sorted stably by
segment.
"""

from __future__ import annotations

import torch

_OPS = {"sum": torch.add, "min": torch.minimum, "max": torch.maximum}


def tree_reduce(x: torch.Tensor, reducer: str) -> torch.Tensor:
    """x [N] -> a 0-d tensor: pairs of neighbours combined level by level.
    N must be positive."""
    op = _OPS[reducer]
    while x.shape[0] > 1:
        if x.shape[0] % 2:
            x = torch.cat([op(x[:-1:2], x[1::2]), x[-1:]])
        else:
            x = op(x[0::2], x[1::2])
    return x[0]


def segment_reduce(vals: torch.Tensor, codes: torch.Tensor, nseg: int,
                   reducer: str) -> torch.Tensor:
    """[nseg] reductions of vals [N] by segment codes [N] in [0, nseg):
    the rows sorted stably by code, then an inclusive segmented scan
    (log2 N steps, each combining a row with the one d places before it
    when both lie in the same segment); each segment's result is the scan
    at its last row. Empty segments give 0."""
    op = _OPS[reducer]
    order = torch.sort(codes, stable=True).indices
    v, s = vals[order], codes[order]
    n = v.shape[0]
    d = 1
    while d < n:
        same = s[d:] == s[:-d]
        v = torch.cat([v[:d], torch.where(same, op(v[:-d], v[d:]), v[d:])])
        d *= 2
    counts = torch.bincount(codes, minlength=nseg)
    ends = torch.clamp(torch.cumsum(counts, 0) - 1, min=0)
    out = v[ends] if n else torch.zeros(nseg, dtype=vals.dtype,
                                        device=vals.device)
    return torch.where(counts > 0, out, torch.zeros_like(out))


def factorize(sig: torch.Tensor, ok: torch.Tensor):
    """Group numbers of the rows of a signature matrix sig [B, K] (uint8)
    where ok [B] holds: (codes [B] int64, -1 where not ok; first [nseg]
    int64, the first row of each group, ascending). Groups are numbered in
    the order of their first row; one torch.unique over the rows (as int64
    lanes) finds them."""
    b, k = sig.shape
    dev = sig.device
    rows = torch.nonzero(ok).squeeze(1)
    codes = torch.full((b,), -1, dtype=torch.int64, device=dev)
    if rows.numel() == 0:
        return codes, rows
    lanes = -(-max(k, 1) // 8)
    sub = torch.nn.functional.pad(sig[rows], (0, lanes * 8 - k))
    sub = sub.view(torch.int64)
    if lanes == 1:
        sub = sub[:, 0]
        _, inv = torch.unique(sub, return_inverse=True)
    else:
        _, inv = torch.unique(sub, dim=0, return_inverse=True)
    nseg = int(inv.max()) + 1
    first = torch.full((nseg,), b, dtype=torch.int64, device=dev)
    first = first.scatter_reduce(0, inv, rows, "amin")
    first, order = torch.sort(first)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(nseg, dtype=torch.int64, device=dev)
    codes[rows] = rank[inv]
    return codes, first


def signature(cvs, b: int, device) -> torch.Tensor:
    """[b, K] uint8 rows whose bytes are equal exactly when the key values
    (a list of CVs) are equal in Python: None slots and bytes past a
    string's length are zero, float -0.0 is 0.0, and a NaN gets its row
    number so that no two NaN keys meet (Python's NaN equals nothing but
    itself, and each row's NaN is a new object)."""
    from ..compiler.values import materialize
    from ..core import typesys as T

    pieces: list = []
    row_no = torch.arange(b, dtype=torch.int64, device=device)

    def as_bytes(x: torch.Tensor) -> torch.Tensor:
        return x.contiguous().view(torch.uint8).reshape(b, -1)

    def add(cv, valid=None):
        cv = materialize(cv, b, device)
        if cv.valid is not None:
            valid = cv.valid if valid is None else valid & cv.valid
        if cv.elts is not None:
            for e in cv.elts:
                add(e, valid)
        elif cv.base is T.STR:
            w = cv.sbytes.shape[1]
            keep = torch.arange(w, device=device)[None, :] < cv.slen[:, None]
            ln = cv.slen.to(torch.int32)
            if valid is not None:
                keep = keep & valid[:, None]
                ln = torch.where(valid, ln, 0)
            pieces.append(torch.where(keep, cv.sbytes, 0).to(torch.uint8))
            pieces.append(as_bytes(ln))
        elif cv.base in (T.BOOL, T.I64, T.F64):
            x = cv.data if valid is None else \
                torch.where(valid, cv.data, torch.zeros_like(cv.data))
            if x.dtype == torch.bool:
                x = x.to(torch.uint8)[:, None]
            elif x.is_floating_point():
                nan = torch.isnan(x)
                x = torch.where((x == 0) | nan, 0.0, x)
                pieces.append(as_bytes(torch.where(nan, row_no, -1)))
            pieces.append(x if x.dtype == torch.uint8 else as_bytes(x))
        elif cv.base is not T.NULL:
            from ..core.errors import NotCompilable

            raise NotCompilable(f"key of type {cv.t}")
        if valid is not None:
            pieces.append(valid.to(torch.uint8)[:, None])

    for cv in cvs:
        add(cv)
    if not pieces:
        return torch.zeros((b, 1), dtype=torch.uint8, device=device)
    return torch.cat(pieces, dim=1)
