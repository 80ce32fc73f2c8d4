"""Wrappers for the CUDA NFA kernels (csrc/nfa_scan.cu).

`match_cuda`, the existence scan, replaces the reference package's TPU
kernel, `tuplex_tpu/ops/pallas_nfa.py:_build_kernel` (driven by
`match_pallas`). Its least time is set by the bytes it reads (each row's
bytes once); on the card it is limited by the per-byte automaton step, a
fixed number of shared-memory table lookups per byte. `match_start_cuda`,
the leftmost match start, replaces the reference's min-plus scan
`NFARegex.match_start` (`tuplex_tpu/ops/nfa.py:328`): the same bitmask
step over the reversed automaton, fed each row right to left. See the
source for both designs.

The library is compiled by `nvcc` for sm_90a at first use into
`tuplex_tpu_torch/_build/` (a plain C interface loaded with ctypes;
ops/cuda_build.py), so a checkout needs nothing prebuilt. `launches` counts
kernel launches of the scan, `start_launches` those of the start scan;
nothing else adds to them.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .cuda_build import CudaLibrary, current_stream
from .nfa import follow_chunks

launches = 0
start_launches = 0


def _bind(lib) -> None:
    fn = lib.tpx_nfa_scan
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p,          # bytes, lens
        ctypes.c_longlong, ctypes.c_longlong,      # n, w
        ctypes.c_void_p, ctypes.c_int,             # tables, n_chunks
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # ^, $, nullable
        ctypes.c_void_p, ctypes.c_void_p,          # out, stream
    ]
    fn.restype = ctypes.c_int
    fn = lib.tpx_nfa_start
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p,          # bytes, lens
        ctypes.c_longlong, ctypes.c_longlong,      # n, w
        ctypes.c_void_p, ctypes.c_int,             # tables, n_chunks
        ctypes.c_int, ctypes.c_int,                # ^, $
        ctypes.c_void_p, ctypes.c_void_p,          # matched, start
        ctypes.c_void_p,                           # stream
    ]
    fn.restype = ctypes.c_int
    lib.tpx_nfa_rows_per_block.argtypes = []
    lib.tpx_nfa_rows_per_block.restype = ctypes.c_int


LIBRARY = CudaLibrary("nfa_scan.cu", _bind)
build = LIBRARY.build


def rows_per_block() -> int:
    """Rows one block of the kernel scans (one thread each)."""
    return LIBRARY.load().tpx_nfa_rows_per_block()


def pack_tables(tables) -> np.ndarray:
    """The kernel's table buffer for `tables` (ops.nfa.NFATables), uint64
    [256 * (1 + n_chunks) + 2]: CLASSTAB, then F8 (ops.nfa.follow_chunks)
    chunk by chunk, then FIRST and LAST. Without '^' FIRST is ORed into
    every F8[0] entry, so the transition itself seeds every byte."""
    f8 = follow_chunks(tables.follow, tables.n_pos)
    if not tables.anchored_start:
        f8[:1] |= np.uint64(tables.first)
    return np.concatenate([
        np.asarray(tables.classtab, dtype=np.uint64), f8.ravel(),
        np.array([tables.first, tables.last], dtype=np.uint64)])


def reversed_follow(tables) -> np.ndarray:
    """uint64 [n_pos]: the predecessors of each position (bit q of entry
    p is set when p follows q), the follow sets of the reversed
    automaton."""
    rev = [0] * tables.n_pos
    for q in range(tables.n_pos):
        m = int(tables.follow[q])
        for p in range(tables.n_pos):
            if (m >> p) & 1:
                rev[p] |= 1 << q
    return np.asarray(rev, dtype=np.uint64)


def pack_start_tables(tables) -> np.ndarray:
    """The start kernel's table buffer for `tables`, uint64
    [256 * (1 + n_chunks) + 2]: CLASSTAB, then the chunked follow tables
    of the reversed automaton (follow_chunks of `reversed_follow`), then
    LAST (its seed set) and FIRST (its accepting set). Without '$' LAST is
    ORed into every chunk-0 entry, so every byte seeds a match end."""
    f8 = follow_chunks(reversed_follow(tables), tables.n_pos)
    if not tables.anchored_end:
        f8[:1] |= np.uint64(tables.last)
    return np.concatenate([
        np.asarray(tables.classtab, dtype=np.uint64), f8.ravel(),
        np.array([tables.last, tables.first], dtype=np.uint64)])


def _check_inputs(what: str, bytes_, lens, table_buf,
                  n_chunks: int) -> None:
    if not (bytes_.is_cuda and lens.is_cuda and table_buf.is_cuda and
            bytes_.device == lens.device == table_buf.device):
        raise ValueError(f"{what}: bytes, lens and tables must be on one "
                         "CUDA device")
    if bytes_.dtype != torch.uint8 or lens.dtype != torch.int32:
        raise TypeError(f"{what}: want uint8 bytes and int32 lens, got "
                        f"{bytes_.dtype} and {lens.dtype}")
    if bytes_.dim() != 2 or lens.dim() != 1 or \
            lens.shape[0] != bytes_.shape[0] or bytes_.shape[1] < 1:
        raise ValueError(f"{what}: bad shapes {tuple(bytes_.shape)} and "
                         f"{tuple(lens.shape)}")
    if not (bytes_.is_contiguous() and lens.is_contiguous()):
        raise ValueError(f"{what}: inputs must be contiguous")
    if table_buf.dtype != torch.int64 or not table_buf.is_contiguous() or \
            table_buf.numel() != 256 * (1 + n_chunks) + 2:
        raise ValueError(f"{what}: table_buf is not the packed tables")


def match_start_cuda(tables, table_buf: torch.Tensor, bytes_: torch.Tensor,
                     lens: torch.Tensor):
    """(matched [N] bool, start [N] int32) for `tables` (ops.nfa.NFATables,
    1..32 positions, not nullable) over bytes_ u8 [N, W] and lens int32
    [N] on one CUDA device; start is 0 where unmatched. `table_buf` is
    pack_start_tables(tables) on that device, as int64. Launches the
    kernel on the current stream; raises if it cannot."""
    global start_launches
    if not 1 <= tables.n_pos <= 32 or tables.nullable:
        raise ValueError(f"nfa_start: {tables.n_pos} positions, nullable "
                         f"{tables.nullable} (want 1..32, not nullable)")
    n_chunks = (tables.n_pos + 7) // 8
    _check_inputs("nfa_start", bytes_, lens, table_buf, n_chunks)
    n, w = bytes_.shape
    matched = torch.empty(n, dtype=torch.bool, device=bytes_.device)
    start = torch.empty(n, dtype=torch.int32, device=bytes_.device)
    if n == 0:
        return matched, start
    fn = LIBRARY.load().tpx_nfa_start
    with torch.cuda.device(bytes_.device):
        rc = fn(bytes_.data_ptr(), lens.data_ptr(), n, w,
                table_buf.data_ptr(), n_chunks, int(tables.anchored_start),
                int(tables.anchored_end), matched.data_ptr(),
                start.data_ptr(), current_stream(bytes_.device))
    if rc != 0:
        raise RuntimeError(f"nfa_start launch failed: cudaError {rc}")
    start_launches += 1
    return matched, start


def match_cuda(tables, table_buf: torch.Tensor, bytes_: torch.Tensor,
               lens: torch.Tensor) -> torch.Tensor:
    """matched [N] bool for `tables` (ops.nfa.NFATables, n_pos >= 1) over
    bytes_ u8 [N, W] and lens int32 [N] on one CUDA device. `table_buf` is
    pack_tables(tables) on that device, as int64 (NFARegex keeps one per
    device). Launches the kernel on the current stream; raises if it
    cannot."""
    global launches
    if not 1 <= tables.n_pos <= 64:
        raise ValueError(f"nfa_scan: {tables.n_pos} positions (want 1..64)")
    n_chunks = (tables.n_pos + 7) // 8
    _check_inputs("nfa_scan", bytes_, lens, table_buf, n_chunks)
    n, w = bytes_.shape
    out = torch.empty(n, dtype=torch.bool, device=bytes_.device)
    if n == 0:
        return out
    fn = LIBRARY.load().tpx_nfa_scan
    with torch.cuda.device(bytes_.device):
        rc = fn(bytes_.data_ptr(), lens.data_ptr(), n, w,
                table_buf.data_ptr(), n_chunks, int(tables.anchored_start),
                int(tables.anchored_end), int(tables.nullable),
                out.data_ptr(), current_stream(bytes_.device))
    if rc != 0:
        raise RuntimeError(f"nfa_scan launch failed: cudaError {rc}")
    launches += 1
    return out
