"""Copies of row data between host and device, counted (counterpart of
`tuplex_tpu/runtime/xferstats.py`, trimmed to the counts a stage reports).

`COUNTS` grows over the process; an executor takes a `snapshot()` when a
stage starts and reports `since(snapshot)` in the stage's metrics. The
counts cover the executors' copies of leaves, stage outputs, row gathers
and row indices (`to_device`, `copy_to_device`, `to_host`), not scalars
or the emitter's constants. They are kept on the CPU device as well, so
the tests there see the copies the card would make.

With `TIMED` set (a measurement, off on the main path) every copy first
waits for the device's queued work, timed as `wait_s`, then copies and
waits for the copy, timed as `copy_s`: a stage's wall time less those is
its host work.
"""

from __future__ import annotations

import time

import numpy as np
import torch

COUNTS = {"h2d_bytes": 0, "d2h_bytes": 0, "forced_leaves": 0,
          "copy_s": 0.0, "wait_s": 0.0}
TIMED = False


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _copy(fn, device: torch.device):
    if not TIMED:
        return fn()
    t0 = time.perf_counter()
    _sync(device)
    t1 = time.perf_counter()
    out = fn()
    _sync(device)
    COUNTS["wait_s"] += t1 - t0
    COUNTS["copy_s"] += time.perf_counter() - t1
    return out


def to_device(a: np.ndarray, device) -> torch.Tensor:
    """A host array as a tensor on `device`, counted."""
    a = np.ascontiguousarray(a)
    COUNTS["h2d_bytes"] += a.nbytes
    device = torch.device(device)
    return _copy(lambda: torch.from_numpy(a).to(device), device)


def copy_to_device(dst: torch.Tensor, a: np.ndarray) -> None:
    """A host array copied into the device tensor `dst` (of its shape and
    dtype), counted."""
    a = np.ascontiguousarray(a)
    COUNTS["h2d_bytes"] += a.nbytes
    _copy(lambda: dst.copy_(torch.from_numpy(a)), dst.device)


def to_host(t: torch.Tensor, copy: bool = False) -> np.ndarray:
    """A tensor as a host array, counted. With `copy` the array never
    shares memory with the tensor, on the CPU device too."""
    h = _copy(lambda: t.cpu().numpy(), t.device)
    if copy and t.device.type == "cpu":
        h = h.copy()
    COUNTS["d2h_bytes"] += h.nbytes
    return h


def snapshot() -> dict:
    return dict(COUNTS)


def since(snap: dict) -> dict:
    """The counts added since `snap`."""
    return {k: COUNTS[k] - snap[k] for k in COUNTS}
