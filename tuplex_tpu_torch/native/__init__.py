"""The host data plane: a C++ extension (src/fasttransfer.cpp) built at
first use.

Its encoders and decoders are the reference package's
(`tuplex_tpu/native`), with the same semantics; this copy adds the readers
the port needs without pyarrow: `split_csv`, `split_lines` and
`gather_rows`. The extension is compiled by g++ into the gitignored
`tuplex_tpu_torch/_build/`, under a file lock and through a temporary file
renamed into place, so processes that start at once all load a whole
library. Without g++ on PATH, `get()` returns None and every caller takes
its Python path; with g++, a failed build or load raises.

Each entry point counts its calls in `calls`; nothing else adds to it.
Tests force the Python path by setting `_mod = None` and `_tried = True`.
"""

from __future__ import annotations

import fcntl
import hashlib
import importlib.util
import os
import shutil
import subprocess
import sysconfig
import threading
from typing import Optional

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "native", "src", "fasttransfer.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX = "g++"
FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]
MODULE = "_tuplex_torch_native"

calls = {name: 0 for name in (
    "encode_i64", "encode_f64", "encode_bool", "encode_str",
    "offsets_to_matrix", "decode_str", "decode_columns", "encode_rows",
    "split_csv", "split_lines", "gather_rows")}

_mod = None
_tried = False
_lock = threading.Lock()


def build() -> str:
    """Compile the extension if this source has not been built yet; returns
    the library path, named by a hash of the source and the flags."""
    with open(SOURCE, "rb") as fp:
        digest = hashlib.sha256(fp.read() + " ".join(FLAGS).encode())
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    lib = os.path.join(BUILD_DIR, f"{MODULE}_{digest.hexdigest()[:16]}"
                                  f"{suffix}")
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "native.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(lib):       # built while this process waited
            return lib
        tmp = f"{lib}.{os.getpid()}.tmp"
        cmd = [CXX, *FLAGS, f"-I{sysconfig.get_paths()['include']}",
               SOURCE, "-o", tmp]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"{CXX} failed ({res.returncode}):\n"
                               f"{res.stderr}")
        os.replace(tmp, lib)
    return lib


def get() -> Optional[object]:
    """The loaded extension, or None when there is no g++ on PATH."""
    global _mod, _tried
    with _lock:
        if _mod is not None or _tried:
            return _mod
        if shutil.which(CXX) is None:
            _tried = True
            return None
        spec = importlib.util.spec_from_file_location(MODULE, build())
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _mod, _tried = mod, True
        return _mod


def _entry(name: str):
    mod = get()
    if mod is None:
        raise RuntimeError("the native module is not available (no g++)")
    calls[name] += 1
    return getattr(mod, name)


# -- the reference package's entry points: same arguments, same results ----

def encode_i64(values: list):
    return _entry("encode_i64")(values)


def encode_f64(values: list):
    return _entry("encode_f64")(values)


def encode_bool(values: list):
    return _entry("encode_bool")(values)


def encode_str(values: list):
    return _entry("encode_str")(values)


def offsets_to_matrix(data, offsets, n: int, offset: int, max_w: int):
    return _entry("offsets_to_matrix")(data, offsets, n, offset, max_w)


def decode_str(mat: bytes, lens: bytes, w: int, n: int) -> list:
    return _entry("decode_str")(mat, lens, w, n)


def decode_columns(spec: list, n: int) -> list:
    return _entry("decode_columns")(spec, n)


def encode_rows(rows: list, kinds: list):
    return _entry("encode_rows")(rows, kinds)


# -- the readers ------------------------------------------------------------

def invalid_utf8(data: bytes, at: int) -> UnicodeDecodeError:
    """The error `data.decode("utf-8")` raises, given the offset `at` of
    the first sequence it refuses: CPython's reason and end, read from a
    window of the bytes there."""
    try:
        bytes(data[at:at + 4]).decode("utf-8")
        end, reason = at + 1, "invalid UTF-8"
    except UnicodeDecodeError as e:
        end, reason = at + e.end, e.reason
    return UnicodeDecodeError("utf-8", data, at, end, reason)


def split_csv(data: bytes, delim: int, quote: int, k: int, has_header: bool):
    """(record starts, record ends, fast flag per record, field starts
    [F, k], field lengths [F, k]): the arrays of the numpy splitter
    `io.csvsource._split_records`, with its dtypes. Raises
    UnicodeDecodeError, as the splitter does, where the bytes are not
    UTF-8."""
    s, e, g, fs, fl, n_fast, bad = _entry("split_csv")(data, delim, quote,
                                                       k, has_header)
    if bad >= 0:
        raise invalid_utf8(data, bad)
    return (np.frombuffer(s, np.int64), np.frombuffer(e, np.int64),
            np.frombuffer(g, np.bool_),
            np.frombuffer(fs, np.int64).reshape(n_fast, k),
            np.frombuffer(fl, np.int64).reshape(n_fast, k))


def split_lines(data: bytes):
    """(piece starts, piece ends, odd piece indices) of the pieces between
    \\n, \\r and \\r\\n. A piece not listed as odd is one line of
    `data.decode("utf-8", "replace").splitlines()`, byte for byte; an odd
    one holds another splitlines separator or invalid UTF-8, and Python
    reads it."""
    s, e, odd = _entry("split_lines")(data)
    return np.frombuffer(s, np.int64), np.frombuffer(e, np.int64), odd


def gather_rows(data, starts: np.ndarray, lens: np.ndarray,
                pos: Optional[np.ndarray], m: int) -> list:
    """[(uint8 [m, w_j] matrix, int32 [m] lengths)] for each column j of
    starts and lens ([F, k], or [F] for one column): the byte range
    data[starts[i, j]:][:lens[i, j]] at row pos[i] (row i when pos is None)
    of column j's matrix, zero elsewhere; w_j is column j's longest range,
    at least 1."""
    starts = np.ascontiguousarray(starts, np.int64)
    lens = np.ascontiguousarray(lens, np.int64)
    k = starts.shape[1] if starts.ndim == 2 else 1
    cols = _entry("gather_rows")(
        data, starts, lens, k,
        None if pos is None else np.ascontiguousarray(pos, np.int64), m)
    return [(np.frombuffer(mat, np.uint8).reshape(m, w),
             np.frombuffer(lb, np.int32)) for mat, lb, w in cols]
