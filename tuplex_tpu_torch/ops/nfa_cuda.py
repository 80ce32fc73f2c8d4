"""Wrappers for the CUDA NFA kernels (csrc/nfa_scan.cu).

`match_cuda`, the existence scan, replaces the reference package's TPU
kernel, `tuplex_tpu/ops/pallas_nfa.py:_build_kernel` (driven by
`match_pallas`). Its least time is set by the bytes it reads (each row's
bytes once); on the card it is limited by the per-byte automaton step, a
fixed number of shared-memory table lookups per byte. `match_start_cuda`,
the leftmost match start, replaces the reference's min-plus scan
`NFARegex.match_start` (`tuplex_tpu/ops/nfa.py:328`): the same bitmask
step over the reversed automaton, fed each row right to left, with 32-bit
tables, over only the rows an optional `live` mask keeps (compacted per
block on the card, no host sync). See the source for both designs.

The library is compiled by `nvcc` for sm_90a at first use into
`tuplex_tpu_torch/_build/` (a plain C interface loaded with ctypes;
ops/cuda_build.py), so a checkout needs nothing prebuilt. `launches` counts
kernel launches of the scan, `start_launches` those of the start scan;
nothing else adds to them.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

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
        ctypes.c_void_p,                           # live (or null)
        ctypes.c_longlong, ctypes.c_longlong,      # n, w
        ctypes.c_void_p, ctypes.c_int,             # tables, n_chunks
        ctypes.c_int, ctypes.c_int,                # ^, $
        ctypes.c_void_p, ctypes.c_void_p,          # matched, start
        ctypes.c_void_p,                           # stream
    ]
    fn.restype = ctypes.c_int
    fn = lib.tpx_nfa_start_variant
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 5
    fn.restype = ctypes.c_int
    lib.tpx_nfa_rows_per_block.argtypes = []
    lib.tpx_nfa_rows_per_block.restype = ctypes.c_int


LIBRARY = CudaLibrary("nfa_scan.cu", _bind)
build = LIBRARY.build


def rows_per_block() -> int:
    """Rows one block of the kernel scans (one thread each)."""
    return LIBRARY.load().tpx_nfa_rows_per_block()


class StartVariant(NamedTuple):
    replicated: bool     # lane-replicated tables (else plain)
    blocks_per_sm: int
    sms: int
    threads: int         # a block's threads: the rows of one round
    window: int          # candidate rows compacted at once


def start_variant(n_chunks: int, anchored_end: bool = False) -> StartVariant:
    """The start-kernel variant a launch on the current CUDA device takes
    for `n_chunks` follow chunks and '$', with 16-byte copies (rows of a
    multiple of 16 bytes at a 16-byte aligned base); its table layout
    follows from `n_chunks`."""
    out = [ctypes.c_int() for _ in StartVariant._fields]
    rc = LIBRARY.load().tpx_nfa_start_variant(
        n_chunks, int(anchored_end), 16, *(ctypes.byref(o) for o in out))
    if rc != 0:
        raise RuntimeError(f"nfa_start variant: cudaError {rc}")
    v = [o.value for o in out]
    return StartVariant(bool(v[0]), *v[1:])


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
    """The start kernel's table buffer for `tables` (at most 32
    positions), uint32 [256 * (1 + n_chunks) + 2]: CLASSTAB, then the
    chunked follow tables of the reversed automaton (follow_chunks of
    `reversed_follow`), then LAST (its seed set) and FIRST (its accepting
    set). Without '$' LAST is ORed into every chunk-0 entry, so every byte
    seeds a match end."""
    if tables.n_pos > 32:
        raise ValueError(f"nfa_start: {tables.n_pos} positions (want <= 32)")
    f8 = follow_chunks(reversed_follow(tables), tables.n_pos)
    if not tables.anchored_end:
        f8[:1] |= np.uint64(tables.last)
    return np.concatenate([
        np.asarray(tables.classtab, dtype=np.uint64), f8.ravel(),
        np.array([tables.last, tables.first], dtype=np.uint64)
    ]).astype(np.uint32)


def _check_inputs(what: str, bytes_, lens, table_buf, n_chunks: int,
                  table_dtype=torch.int64) -> None:
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
    if table_buf.dtype != table_dtype or not table_buf.is_contiguous() or \
            table_buf.numel() != 256 * (1 + n_chunks) + 2:
        raise ValueError(f"{what}: table_buf is not the packed tables")


def match_start_cuda(tables, table_buf: torch.Tensor, bytes_: torch.Tensor,
                     lens: torch.Tensor, live: torch.Tensor | None = None):
    """(matched [N] bool, start [N] int32) for `tables` (ops.nfa.NFATables,
    1..32 positions, not nullable) over bytes_ u8 [N, W] and lens int32
    [N] on one CUDA device; start is 0 where unmatched. `live`, a bool [N]
    on that device or None (every row), marks the rows to scan: the others
    get (False, 0), and the kernel reads none of their bytes or lengths.
    `table_buf` is pack_start_tables(tables) on that device, as int32.
    Launches the kernel on the current stream, with no host sync; raises
    if it cannot."""
    global start_launches
    if not 1 <= tables.n_pos <= 32 or tables.nullable:
        raise ValueError(f"nfa_start: {tables.n_pos} positions, nullable "
                         f"{tables.nullable} (want 1..32, not nullable)")
    n_chunks = (tables.n_pos + 7) // 8
    _check_inputs("nfa_start", bytes_, lens, table_buf, n_chunks,
                  torch.int32)
    n, w = bytes_.shape
    if live is not None:
        if live.dtype != torch.bool:
            raise TypeError(f"nfa_start: want a bool live mask, got "
                            f"{live.dtype}")
        if live.device != bytes_.device or live.dim() != 1 or \
                live.shape[0] != n or not live.is_contiguous():
            raise ValueError(f"nfa_start: the live mask must be a contiguous "
                             f"[{n}] tensor on {bytes_.device}, got "
                             f"{tuple(live.shape)} on {live.device}")
    if n >= 1 << 31:
        raise ValueError(f"nfa_start: {n} rows (want fewer than 2**31)")
    matched = torch.empty(n, dtype=torch.bool, device=bytes_.device)
    start = torch.empty(n, dtype=torch.int32, device=bytes_.device)
    if n == 0:
        return matched, start
    fn = LIBRARY.load().tpx_nfa_start
    with torch.cuda.device(bytes_.device):
        rc = fn(bytes_.data_ptr(), lens.data_ptr(),
                None if live is None else live.data_ptr(), n, w,
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
