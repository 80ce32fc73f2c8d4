"""Wrapper for the CUDA general fold (csrc/seg_fold.cu).

Replaces the sequential device folds of the reference package,
`tuplex_tpu/plan/aggregates.py:449` `ScanFold.build_fn` and `:506`
`_seg_build_fn` (each a `lax.scan`): one thread per segment interprets
the fold's register program over the segment's rows in row order. Its
least time is set by the bytes it moves (each folded row's term payloads
and meta words, its place in `order`, its status), but a segment's rows
are serial: see the source for its design.

The library is built by nvcc at first use (ops/cuda_build.py). `launches`
counts kernel launches; nothing else adds to it.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import CudaLibrary, current_stream
from .segfold import MAX_CODE, MAX_CONSTS, SegFoldResult

launches = 0


def _bind(lib) -> None:
    fn = lib.tpx_seg_fold
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [
        p, i, p, i,             # code, n_code, consts, n_consts
        p, p, ll,               # vals, metas, b
        p, p, p, i, i,          # order, offsets, limits, nseg, n_leaves
        p, p,                   # seeds, seed_tags
        p, p, p, p, p, p,       # acc, tags, first, count, stop, status
        p,                      # stream
    ]
    fn.restype = ctypes.c_int


LIBRARY = CudaLibrary("seg_fold.cu", _bind)
build = LIBRARY.build


def seg_fold(prog, vals: torch.Tensor, metas: torch.Tensor,
             order: torch.Tensor, offsets: torch.Tensor,
             limits: torch.Tensor, seeds: torch.Tensor,
             seed_tags: torch.Tensor):
    """ops/segfold.py `seg_fold` on the card: every tensor on one CUDA
    device (the program's are copied there once). Launches the kernel on the
    current stream; raises if it cannot."""
    global launches
    dev = vals.device
    ins = (vals, metas, order, offsets, limits, seeds, seed_tags)
    if not all(t.is_cuda and t.device == dev for t in ins):
        raise ValueError("seg_fold: inputs must be on one CUDA device")
    want = (torch.int64, torch.int32, torch.int64, torch.int64, torch.int64,
            torch.int64, torch.int8)
    if any(t.dtype != d for t, d in zip(ins, want)):
        raise TypeError(f"seg_fold: dtypes {[t.dtype for t in ins]}, want "
                        f"{list(want)}")
    if not all(t.is_contiguous() for t in ins):
        raise ValueError("seg_fold: inputs must be contiguous")
    nseg, nleaf = seeds.shape
    b = vals.shape[1]
    if vals.dim() != 2 or metas.shape != vals.shape or \
            offsets.shape != (nseg + 1,) or limits.shape != (nseg,) or \
            seed_tags.shape != seeds.shape:
        raise ValueError("seg_fold: shapes do not agree")
    n_code, n_consts = prog.code.shape[0], prog.consts.shape[0]
    if n_code > MAX_CODE or n_consts > MAX_CONSTS:
        raise ValueError(f"seg_fold: program of {n_code} instructions and "
                         f"{n_consts} constants is too long")
    code, consts = prog.on(dev)
    acc = torch.empty((nseg, nleaf), dtype=torch.int64, device=dev)
    tags = torch.empty((nseg, nleaf), dtype=torch.int8, device=dev)
    first = torch.empty(nseg, dtype=torch.int64, device=dev)
    count = torch.empty(nseg, dtype=torch.int64, device=dev)
    stop = torch.empty(nseg, dtype=torch.int64, device=dev)
    status = torch.zeros(b, dtype=torch.int8, device=dev)
    if nseg == 0:
        return SegFoldResult(acc, tags, first, count, stop, status)
    fn = LIBRARY.load().tpx_seg_fold
    with torch.cuda.device(dev):
        rc = fn(code.data_ptr(), n_code, consts.data_ptr(), n_consts,
                vals.data_ptr(), metas.data_ptr(), b, order.data_ptr(),
                offsets.data_ptr(), limits.data_ptr(), nseg, nleaf,
                seeds.data_ptr(), seed_tags.data_ptr(), acc.data_ptr(),
                tags.data_ptr(), first.data_ptr(), count.data_ptr(),
                stop.data_ptr(), status.data_ptr(), current_stream(dev))
    if rc != 0:
        raise RuntimeError(f"seg_fold launch failed: cudaError {rc}")
    launches += 1
    return SegFoldResult(acc, tags, first, count, stop, status)
