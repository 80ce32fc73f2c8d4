"""How busy the card is during a job, by torch.profiler (the part of the
reference package's `runtime/devprof.py` the chip scripts use).

`device_busy(fn)` runs fn() under the profiler and returns its wall time
and the union of the intervals in which a kernel or a copy ran on the
card: the job's idle share is 1 - busy / wall.
"""

from __future__ import annotations

import time

import torch


def device_intervals(prof) -> list[tuple[float, float]]:
    """(start, end) in microseconds of every kernel and copy the profiler
    saw on the card."""
    from torch.autograd import DeviceType

    return [(e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type == DeviceType.CUDA]


def union_us(intervals) -> float:
    """Microseconds covered by at least one interval."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def device_busy(fn) -> tuple[float, float, object]:
    """(wall s, device busy s, fn's result) of one call of fn() under
    torch.profiler, the card synchronized before the clock stops."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return wall, union_us(device_intervals(prof)) / 1e6, out
