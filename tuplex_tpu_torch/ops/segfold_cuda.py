"""Wrapper for the CUDA general fold (csrc/seg_fold.cu).

Replaces the sequential device folds of the reference package,
`tuplex_tpu/plan/aggregates.py:449` `ScanFold.build_fn` and `:506`
`_seg_build_fn` (each a `lax.scan`): the fold's decoded program
(ops/segfold.py `decode_program`) runs over each segment's rows in row
order, a segment of at least LONG_ROWS rows on a warp of its own, the
others on a thread each, in one launch (the kernel reads the lengths from
`offsets` on the card). Its least time is set by the bytes it moves, but a
segment's rows are serial: see the source for its design and its serial
bound.

The library is built by nvcc at first use (ops/cuda_build.py). `launches`
counts fold launches, whatever layouts they ran; nothing else adds to it.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import CudaLibrary, current_stream
from .segfold import SegFoldResult, decoded

# a segment of this many rows or more takes a warp of its own; a thread
# runs a shorter one (the kernel applies the same rule)
LONG_ROWS = 64

launches = 0


def _bind(lib) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = lib.tpx_seg_fold
    fn.argtypes = [
        p, i, p, i,             # code, n_code, outs, n_outs
        p, i, i, i,             # consts, n_consts, n_regs, n_terms
        p, p, ll,               # vals, metas, b
        p, p, p, i, i,          # order, offsets, limits, nseg, n_leaves
        p, p,                   # seeds, seed_tags
        p, p, p, p, p, p,       # acc, tags, first, count, stop, status
        p, i, i,                # scratch, cap, long_rows
        p,                      # stream
    ]
    fn.restype = ctypes.c_int
    cal = lib.tpx_seg_fold_calibrate
    cal.argtypes = [p, p, ll, p]
    cal.restype = ctypes.c_int


LIBRARY = CudaLibrary("seg_fold.cu", _bind)
build = LIBRARY.build


def layout_counts(offsets: torch.Tensor) -> tuple[int, int]:
    """(segments on a warp each, segments on a thread each) for the
    segment table `offsets` [nseg + 1]: the kernel's rule, on the host."""
    n = offsets[1:] - offsets[:-1]
    long_ = int((n >= LONG_ROWS).sum())
    return long_, int(n.shape[0]) - long_


def seg_fold(prog, vals: torch.Tensor, metas: torch.Tensor,
             order: torch.Tensor, offsets: torch.Tensor,
             limits: torch.Tensor, seeds: torch.Tensor,
             seed_tags: torch.Tensor):
    """ops/segfold.py `seg_fold` on the card: every tensor on one CUDA
    device (the decoded program is copied there once). Launches the kernel
    on the current stream; raises if it cannot."""
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
    dec = decoded(prog, nleaf)
    if vals.shape[0] < dec.n_terms:
        raise ValueError(f"seg_fold: {vals.shape[0]} term rows for a "
                         f"program of {dec.n_terms} terms")
    code, outs, consts = dec.on(dev)
    acc = torch.empty((nseg, nleaf), dtype=torch.int64, device=dev)
    tags = torch.empty((nseg, nleaf), dtype=torch.int8, device=dev)
    first = torch.empty(nseg, dtype=torch.int64, device=dev)
    count = torch.empty(nseg, dtype=torch.int64, device=dev)
    stop = torch.empty(nseg, dtype=torch.int64, device=dev)
    status = torch.zeros(b, dtype=torch.int8, device=dev)
    if nseg == 0:
        return SegFoldResult(acc, tags, first, count, stop, status)
    # no more segments can reach LONG_ROWS than the rows allow
    cap = min(nseg, order.shape[0] // LONG_ROWS)
    scratch = torch.empty(1 + cap, dtype=torch.int32, device=dev)
    fn = LIBRARY.load().tpx_seg_fold
    with torch.cuda.device(dev):
        rc = fn(code.data_ptr(), code.shape[0], outs.data_ptr(),
                outs.shape[0], consts.data_ptr(), consts.shape[0],
                dec.n_regs, dec.n_terms, vals.data_ptr(), metas.data_ptr(),
                b, order.data_ptr(), offsets.data_ptr(), limits.data_ptr(),
                nseg, nleaf, seeds.data_ptr(), seed_tags.data_ptr(),
                acc.data_ptr(), tags.data_ptr(), first.data_ptr(),
                count.data_ptr(), stop.data_ptr(), status.data_ptr(),
                scratch.data_ptr(), cap, LONG_ROWS, current_stream(dev))
    if rc != 0:
        raise RuntimeError(f"seg_fold launch failed: cudaError {rc}")
    launches += 1
    return SegFoldResult(acc, tags, first, count, stop, status)


def calibrate(device, n: int = 1 << 22) -> tuple[float, float]:
    """(ns, cycles) of one dependent FP64 operation on `device`: a chain
    of n multiplications and n additions on one thread, timed by CUDA
    events and by the SM's clock."""
    x = torch.tensor([1.0, 0.999, 1e-3], dtype=torch.float64, device=device)
    cycles = torch.zeros(1, dtype=torch.int64, device=device)
    fn = LIBRARY.load().tpx_seg_fold_calibrate
    with torch.cuda.device(device):
        stream = current_stream(x.device)
        if fn(x.data_ptr(), cycles.data_ptr(), n, stream):
            raise RuntimeError("seg_fold calibration did not launch")
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        if fn(x.data_ptr(), cycles.data_ptr(), n, stream):
            raise RuntimeError("seg_fold calibration did not launch")
        end.record()
        torch.cuda.synchronize()
    return (start.elapsed_time(end) * 1e6 / (2 * n),
            int(cycles.item()) / (2 * n))
