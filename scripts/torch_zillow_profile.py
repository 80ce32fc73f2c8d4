"""Where a Zillow Z1 job's time goes on one NVIDIA GPU, by torch.profiler.

    python3 scripts/torch_zillow_profile.py [--rows N] [--seed S]
        [--out chiprun_out/z1_profile.json]

Generates the Z1 CSV (tuplex_tpu_torch/models/zillow.py, default 1,000,000
rows, seed 42) and prints:

  1. the card's name and power limit, and the native host module (built
     before any job is timed);
  2. one partition's fused stage (decode and the 12 operators), run once
     to warm up and once under the profiler: its host wall time, the top
     host-side ops by the device time of their kernels (with their calls),
     and the number of device events (kernels and copies) in all;
  3. the whole job: `collect()` --runs times without the profiler (wall
     time and the backend's split), then once under it: the device's busy
     time (the union of kernel and copy intervals) and its idle share of
     the job's wall time.

The tables also go to --out as JSON. Needs CUDA: without it the script
exits nonzero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from tuplex_tpu_torch import Context, native              # noqa: E402
from tuplex_tpu_torch.models import zillow                # noqa: E402
from tuplex_tpu_torch.plan.physical import plan_stages    # noqa: E402
from tuplex_tpu_torch.runtime import columns as C         # noqa: E402

ACTIVITIES = [ProfilerActivity.CPU, ProfilerActivity.CUDA]


def _device_us(avg) -> float:
    """Self device time of a key_averages() row (the attribute's name
    differs between torch versions)."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(avg, name, None)
        if v is not None:
            return float(v)
    return 0.0


def _device_intervals(prof) -> list[tuple[float, float]]:
    return [(e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type == DeviceType.CUDA]


def _union_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def stage_profile(path: str, top: int) -> dict:
    ctx = Context()
    ds = zillow.build_pipeline(ctx.csv(path))
    stage = plan_stages(ds._op)[0]
    part = C.harmonize_partitions(stage.source.load_partitions())[0]
    batch = C.stage_partition(part, ctx.device)
    fn = stage.build_device_fn(part.schema, compaction=True)
    fn(batch.arrays)
    torch.cuda.synchronize()
    with profile(activities=ACTIVITIES) as prof:
        t0 = time.perf_counter()
        fn(batch.arrays)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # host-side ops with the device time of the kernels they launched
    # (key_averages also lists each kernel under its own name: skipped)
    rows = [{"op": a.key, "calls": a.count, "device_ms": _device_us(a) / 1e3}
            for a in prof.key_averages()
            if getattr(a, "device_type", DeviceType.CPU) == DeviceType.CPU
            and _device_us(a) > 0]
    rows.sort(key=lambda r: -r["device_ms"])
    intervals = _device_intervals(prof)
    return {"rows": part.num_rows, "padded_rows": batch.b,
            "host_wall_ms": wall * 1e3,
            "device_ms": sum(r["device_ms"] for r in rows),
            "device_busy_ms": _union_us(intervals) / 1e3,
            "device_events": len(intervals), "top": rows[:top]}


def job_profile(path: str, runs: int) -> dict:
    out: dict = {"runs": []}
    for _ in range(runs):
        ctx = Context()
        t0 = time.perf_counter()
        n_out = len(zillow.build_pipeline(ctx.csv(path)).collect())
        torch.cuda.synchronize()
        m = ctx.metrics
        out["runs"].append({
            "rows_out": n_out, "wall_s": time.perf_counter() - t0,
            "fast_path_s": m.fastPathWallTime(),
            "slow_path_s": m.slowPathWallTime(),
            "backend_s": m.totalWallTime(),
            "interpreter_rows": m.interpreterRows()})
    ctx = Context()
    with profile(activities=ACTIVITIES) as prof:
        t0 = time.perf_counter()
        zillow.build_pipeline(ctx.csv(path)).collect()
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    busy = _union_us(_device_intervals(prof)) / 1e6
    out.update(profiled_wall_s=prof_wall, device_busy_s=busy,
               device_idle_share=1.0 - busy / prof_wall)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--runs", type=int, default=3,
                    help="unprofiled jobs timed before the profiled one")
    ap.add_argument("--out", default="chiprun_out/z1_profile.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_zillow_profile: CUDA is not available")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}")
    # the host data plane is built before any job is timed
    mod = native.get()
    print(f"native module: {mod.__file__ if mod else 'none (no g++)'}")
    with tempfile.TemporaryDirectory(prefix="z1_profile_") as tmp:
        path = os.path.join(tmp, "zillow.csv")
        zillow.generate_csv(path, args.rows, seed=args.seed)
        st = stage_profile(path, args.top)
        print(f"one partition's stage: {st['rows']} rows (padded "
              f"{st['padded_rows']}), host wall {st['host_wall_ms']:.3f} "
              f"ms, device {st['device_ms']:.3f} ms in "
              f"{st['device_events']} device events (busy "
              f"{st['device_busy_ms']:.3f} ms)")
        print(f"{'device ms':>10} {'calls':>6}  op")
        for r in st["top"]:
            print(f"{r['device_ms']:10.3f} {r['calls']:6d}  {r['op'][:90]}")
        job = job_profile(path, args.runs)
    for r in job["runs"]:
        print(f"job: {args.rows} rows -> {r['rows_out']} rows, wall "
              f"{r['wall_s']:.3f} s (fast path {r['fast_path_s']:.3f} s, "
              f"slow path {r['slow_path_s']:.3f} s, backend "
              f"{r['backend_s']:.3f} s)")
    print(f"job under the profiler: {job['profiled_wall_s']:.3f} s, device "
          f"busy {job['device_busy_s']:.3f} s, idle share "
          f"{job['device_idle_share']:.4f}")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as fp:
        json.dump({"card": card, "rows": args.rows, "seed": args.seed,
                   "stage": st, "job": job}, fp, indent=1)


if __name__ == "__main__":
    main()
