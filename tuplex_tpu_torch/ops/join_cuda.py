"""Wrapper for the CUDA join probe (csrc/join_probe.cu).

Replaces the device probe of the reference package's join,
`tuplex_tpu/exec/joinexec.py:629` `_build_probe_fn`, for keys of two or
more words (one-word keys take torch.searchsorted, ops/join.py). Its least
time is set by the bytes it moves: the probe words and the build table read
once, a position and a flag written per row. See the source for its
design.

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
        ctypes.c_void_p, ctypes.c_void_p,          # words, build
        ctypes.c_longlong, ctypes.c_longlong,      # b, u
        ctypes.c_int,                              # nw
        ctypes.c_void_p, ctypes.c_void_p,          # pos, matched
        ctypes.c_void_p,                           # stream
    ]
    fn.restype = ctypes.c_int


LIBRARY = CudaLibrary("join_probe.cu", _bind)
build = LIBRARY.build


def probe(words: torch.Tensor, build_words: torch.Tensor):
    """(pos int64 [B], matched bool [B]) of words int64 [B, nw] in the
    sorted unique build_words int64 [u, nw] (u >= 1), both contiguous on
    one CUDA device. Launches the kernel on the current stream; raises if
    it cannot."""
    global launches
    if not (words.is_cuda and build_words.is_cuda and
            words.device == build_words.device):
        raise ValueError("join_probe: words and build words must be on one "
                         "CUDA device")
    if words.dtype != torch.int64 or build_words.dtype != torch.int64:
        raise TypeError(f"join_probe: want int64 words, got {words.dtype} "
                        f"and {build_words.dtype}")
    if words.dim() != 2 or build_words.dim() != 2 or \
            words.shape[1] != build_words.shape[1] or \
            build_words.shape[0] < 1 or words.shape[1] < 1:
        raise ValueError(f"join_probe: bad shapes {tuple(words.shape)} and "
                         f"{tuple(build_words.shape)}")
    if not (words.is_contiguous() and build_words.is_contiguous()):
        raise ValueError("join_probe: inputs must be contiguous")
    b, nw = words.shape
    pos = torch.empty(b, dtype=torch.int64, device=words.device)
    matched = torch.empty(b, dtype=torch.bool, device=words.device)
    if b == 0:
        return pos, matched
    fn = LIBRARY.load().tpx_join_probe
    with torch.cuda.device(words.device):
        rc = fn(words.data_ptr(), build_words.data_ptr(), b,
                build_words.shape[0], nw, pos.data_ptr(), matched.data_ptr(),
                current_stream(words.device))
    if rc != 0:
        raise RuntimeError(f"join_probe launch failed: cudaError {rc}")
    launches += 1
    return pos, matched
