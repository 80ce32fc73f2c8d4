"""Wrapper for the CUDA NFA scan kernel (csrc/nfa_scan.cu).

Replaces the reference package's TPU kernel,
`tuplex_tpu/ops/pallas_nfa.py:_build_kernel` (driven by `match_pallas`).
Its least time is set by the bytes it reads (each row's bytes once); on
the card it is limited by the per-byte automaton step, a fixed number of
shared-memory table lookups per byte. See the source for its design.

The library is compiled by `nvcc` for sm_90a at first use into
`tuplex_tpu_torch/_build/` (a plain C interface loaded with ctypes), so a
checkout needs nothing prebuilt. `launches` counts kernel launches; nothing
else adds to it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np
import torch

from .nfa import follow_chunks

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "nfa_scan.cu")
BUILD_DIR = os.path.join(_PKG, "_build")

launches = 0
build_log = ""      # nvcc's output (-Xptxas -v) from the last build here

_lib = None
_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the NFA scan kernel is built "
                           "from source at first use")
    return found


def build() -> str:
    """Compile the kernel library if this source has not been built yet;
    returns the library path. The file name carries a hash of the source,
    so an edited kernel is rebuilt."""
    with open(SOURCE, "rb") as fp:
        digest = hashlib.sha256(fp.read()).hexdigest()[:16]
    lib = os.path.join(BUILD_DIR, f"libnfa_scan_{digest}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-Xptxas", "-v", "-o", tmp, SOURCE]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    global build_log
    build_log = res.stdout + res.stderr
    os.replace(tmp, lib)
    return lib


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            fn = lib.tpx_nfa_scan
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p,          # bytes, lens
                ctypes.c_longlong, ctypes.c_longlong,      # n, w
                ctypes.c_void_p, ctypes.c_int,             # tables, n_chunks
                ctypes.c_int, ctypes.c_int, ctypes.c_int,  # ^, $, nullable
                ctypes.c_void_p, ctypes.c_void_p,          # out, stream
            ]
            fn.restype = ctypes.c_int
            lib.tpx_nfa_rows_per_block.argtypes = []
            lib.tpx_nfa_rows_per_block.restype = ctypes.c_int
            _lib = lib
    return _lib


def rows_per_block() -> int:
    """Rows one block of the kernel scans (one thread each)."""
    return _load().tpx_nfa_rows_per_block()


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


def match_cuda(tables, table_buf: torch.Tensor, bytes_: torch.Tensor,
               lens: torch.Tensor) -> torch.Tensor:
    """matched [N] bool for `tables` (ops.nfa.NFATables, n_pos >= 1) over
    bytes_ u8 [N, W] and lens int32 [N] on one CUDA device. `table_buf` is
    pack_tables(tables) on that device, as int64 (NFARegex keeps one per
    device). Launches the kernel on the current stream; raises if it
    cannot."""
    global launches
    if not (bytes_.is_cuda and lens.is_cuda and table_buf.is_cuda and
            bytes_.device == lens.device == table_buf.device):
        raise ValueError("nfa_scan: bytes, lens and tables must be on one "
                         "CUDA device")
    if bytes_.dtype != torch.uint8 or lens.dtype != torch.int32:
        raise TypeError(f"nfa_scan: want uint8 bytes and int32 lens, got "
                        f"{bytes_.dtype} and {lens.dtype}")
    if bytes_.dim() != 2 or lens.dim() != 1 or \
            lens.shape[0] != bytes_.shape[0] or bytes_.shape[1] < 1:
        raise ValueError(f"nfa_scan: bad shapes {tuple(bytes_.shape)} and "
                         f"{tuple(lens.shape)}")
    if not (bytes_.is_contiguous() and lens.is_contiguous()):
        raise ValueError("nfa_scan: inputs must be contiguous")
    if not 1 <= tables.n_pos <= 64:
        raise ValueError(f"nfa_scan: {tables.n_pos} positions (want 1..64)")
    n_chunks = (tables.n_pos + 7) // 8
    if table_buf.dtype != torch.int64 or not table_buf.is_contiguous() or \
            table_buf.numel() != 256 * (1 + n_chunks) + 2:
        raise ValueError("nfa_scan: table_buf is not pack_tables(tables)")
    n, w = bytes_.shape
    out = torch.empty(n, dtype=torch.bool, device=bytes_.device)
    if n == 0:
        return out
    fn = _load().tpx_nfa_scan
    with torch.cuda.device(bytes_.device):
        # the raw handle, without building a torch.cuda.Stream per call
        stream = torch._C._cuda_getCurrentRawStream(bytes_.device.index)
        rc = fn(bytes_.data_ptr(), lens.data_ptr(), n, w,
                table_buf.data_ptr(), n_chunks, int(tables.anchored_start),
                int(tables.anchored_end), int(tables.nullable),
                out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"nfa_scan launch failed: cudaError {rc}")
    launches += 1
    return out
