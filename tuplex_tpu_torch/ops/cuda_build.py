"""Build and load the port's CUDA kernels (csrc/*.cu).

Each source is compiled by `nvcc` for sm_90a at first use into the
gitignored `tuplex_tpu_torch/_build/`, as a shared library with a plain C
interface, and loaded with ctypes. The library's file name carries a hash
of the source and the flags, so an edited kernel is rebuilt. The build
runs under a file lock and writes a temporary file renamed into place, so
processes that start at once all load a whole library. A failed build
raises.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "source at first use")
    return found


class CudaLibrary:
    """One kernel source: `build()` compiles it if need be, `load()` opens
    it once per process and lets `bind` set the entry points' ctypes
    signatures. `build_log` holds nvcc's output (-Xptxas -v) when this
    process built it."""

    def __init__(self, source: str, bind):
        self.source = os.path.join(CSRC, source)
        self.name = os.path.splitext(source)[0]
        self.bind = bind
        self.build_log = ""
        self._lib = None
        self._lock = threading.Lock()

    def build(self) -> str:
        """The library's path, compiling it first if this source and these
        flags have not been built."""
        with open(self.source, "rb") as fp:
            digest = hashlib.sha256(fp.read() + " ".join(FLAGS).encode())
        lib = os.path.join(BUILD_DIR, f"lib{self.name}_"
                                      f"{digest.hexdigest()[:16]}.so")
        if os.path.exists(lib):
            return lib
        os.makedirs(BUILD_DIR, exist_ok=True)
        with open(os.path.join(BUILD_DIR, f"{self.name}.lock"), "w") as lk:
            fcntl.flock(lk, fcntl.LOCK_EX)
            if os.path.exists(lib):       # built while this process waited
                return lib
            tmp = f"{lib}.{os.getpid()}.tmp"
            res = subprocess.run([nvcc(), *FLAGS, "-o", tmp, self.source],
                                 capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed on {self.source} "
                                   f"({res.returncode}):\n{res.stderr}")
            self.build_log = res.stdout + res.stderr
            os.replace(tmp, lib)
        return lib

    def load(self):
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(self.build())
                self.bind(lib)
                self._lib = lib
        return self._lib


def current_stream(device) -> int:
    """The raw handle of torch's current stream on `device`, without
    building a torch.cuda.Stream per call (CUDA builds of torch only)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(device.index)
