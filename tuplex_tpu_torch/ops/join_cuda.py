"""Wrapper for the CUDA join probe (csrc/join_probe.cu).

Replaces the device probe of the reference package's join,
`tuplex_tpu/exec/joinexec.py:629` `_build_probe_fn`, for keys of every
width. It reads the build side's `ops/join.py` `ProbeIndex` (built once per
build side). Its least time is set by the bytes it moves: the probe words
and the build table read once, a position and a flag written per row. See
the source for its design.

The library is built by nvcc at first use (ops/cuda_build.py). `launches`
counts kernel launches; nothing else adds to it.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import CudaLibrary, current_stream

launches = 0


def _bind(lib) -> None:
    fn = lib.tpx_join_probe
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,  # words, b, nw
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,    # blob, table, u
        ctypes.c_int, ctypes.c_int, ctypes.c_int,   # group_shift, down, bits
        ctypes.c_int, ctypes.c_int,                 # radix and fence words
        ctypes.c_void_p, ctypes.c_void_p,           # pos, matched
        ctypes.c_void_p, ctypes.c_int,              # stream, copy_only
    ]
    fn.restype = ctypes.c_int


LIBRARY = CudaLibrary("join_probe.cu", _bind)
build = LIBRARY.build


def probe(words: torch.Tensor, index, copy_only: bool = False):
    """(pos int64 [B], matched bool [B]) of words int64 [B, nw] in the
    build side's `index` (ops/join.py ProbeIndex), both on one CUDA
    device. Launches the kernel on the current stream; raises if it
    cannot. With `copy_only` the kernel copies its tables into shared
    memory and probes nothing (the outputs are left unset), to time the
    copy apart."""
    global launches
    if not (words.is_cuda and index.blob.is_cuda and
            words.device == index.blob.device):
        raise ValueError("join_probe: words and build words must be on one "
                         "CUDA device")
    if words.dtype != torch.int64:
        raise TypeError(f"join_probe: want int64 words, got {words.dtype}")
    if words.dim() != 2 or words.shape[1] != index.nw:
        raise ValueError(f"join_probe: bad shapes {tuple(words.shape)} and "
                         f"{tuple(index.words.shape)}")
    if not words.is_contiguous():
        raise ValueError("join_probe: inputs must be contiguous")
    if index.u >= 1 << 31 or index.blob.data_ptr() % 16:
        raise ValueError("join_probe: the index must be 16-byte aligned "
                         "and hold fewer than 2**31 keys")
    b, nw = words.shape
    pos = torch.empty(b, dtype=torch.int64, device=words.device)
    matched = torch.empty(b, dtype=torch.bool, device=words.device)
    if b == 0:
        return pos, matched
    fn = LIBRARY.load().tpx_join_probe
    with torch.cuda.device(words.device):
        rc = fn(words.data_ptr(), b, nw, index.blob.data_ptr(),
                index.words.data_ptr(), index.u, index.group_shift,
                index.down, index.bits, index.radix_words,
                index.fence_words, pos.data_ptr(), matched.data_ptr(),
                current_stream(words.device), int(copy_only))
    if rc != 0:
        raise RuntimeError(f"join_probe launch failed: cudaError {rc}")
    launches += 1
    return pos, matched
