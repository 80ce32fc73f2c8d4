"""Wrapper for the CUDA NFA scan kernel (csrc/nfa_scan.cu).

Replaces the reference package's TPU kernel,
`tuplex_tpu/ops/pallas_nfa.py:_build_kernel` (driven by `match_pallas`).
The kernel is bounded by memory: it reads each row's bytes once. See the
source for its design.

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
                ctypes.c_int,                              # vec8
                ctypes.c_void_p, ctypes.c_void_p,          # classtab, follow
                ctypes.c_int,                              # n_pos
                ctypes.c_ulonglong, ctypes.c_ulonglong,    # first, last
                ctypes.c_int, ctypes.c_int, ctypes.c_int,  # ^, $, nullable
                ctypes.c_void_p, ctypes.c_void_p,          # out, stream
            ]
            fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def match_cuda(tables, bytes_: torch.Tensor,
               lens: torch.Tensor) -> torch.Tensor:
    """matched [N] bool for `tables` (ops.nfa.NFATables, n_pos >= 1) over
    bytes_ u8 [N, W] and lens int32 [N] on one CUDA device. Launches the
    kernel on the current stream; raises if it cannot."""
    global launches
    if not (bytes_.is_cuda and lens.is_cuda and
            bytes_.device == lens.device):
        raise ValueError("nfa_scan: bytes and lens must be on one CUDA "
                         "device")
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
    n, w = bytes_.shape
    out = torch.empty(n, dtype=torch.bool, device=bytes_.device)
    if n == 0:
        return out
    fn = _load().tpx_nfa_scan
    classtab = np.ascontiguousarray(tables.classtab, dtype=np.uint64)
    follow = np.zeros(64, dtype=np.uint64)
    follow[: tables.n_pos] = tables.follow
    vec8 = int(w % 8 == 0 and bytes_.data_ptr() % 8 == 0)
    with torch.cuda.device(bytes_.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(bytes_.data_ptr(), lens.data_ptr(), n, w, vec8,
                classtab.ctypes.data, follow.ctypes.data, tables.n_pos,
                tables.first, tables.last, int(tables.anchored_start),
                int(tables.anchored_end), int(tables.nullable),
                out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"nfa_scan launch failed: cudaError {rc}")
    launches += 1
    return out
