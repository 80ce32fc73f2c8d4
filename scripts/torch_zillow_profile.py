"""Where a job's time goes on one NVIDIA GPU, by torch.profiler: Zillow
Z1 by default, or TPC-H Q6 or Q1, or NYC 311.

    python3 scripts/torch_zillow_profile.py [--pipeline z1|q6|q1|nyc311]
        [--rows N] [--seed S] [--out chiprun_out/<pipeline>_profile.json]

Generates the pipeline's CSV (tuplex_tpu_torch/models: zillow.py, default
1,000,000 rows, seed 42; tpch.py lineitem, seed 7; nyc311.py, seed 23)
and prints:

  1. the card's name and power limit, and the native host module (built
     before any job is timed);
  2. one partition's first stage (decode and the fused operators, and for
     Q6 the fused fold), run once to warm up and once under the profiler:
     its host wall time, the top host-side ops by the device time of
     their kernels (with their calls), and the number of device events
     (kernels and copies) in all;
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
from tuplex_tpu_torch.models import nyc311, tpch, zillow  # noqa: E402
from tuplex_tpu_torch.plan.physical import plan_stages    # noqa: E402
from tuplex_tpu_torch.runtime import columns as C         # noqa: E402
from tuplex_tpu_torch.runtime.devprof import (            # noqa: E402
    device_busy, device_intervals, union_us)

ACTIVITIES = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

# pipeline -> (generator, default seed, the DataSet over a file)
PIPELINES = {
    "z1": (zillow.generate_csv, 42,
           lambda ctx, p: zillow.build_pipeline(ctx.csv(p))),
    "q6": (tpch.generate_csv, 7, lambda ctx, p: tpch.q6(ctx.csv(p))),
    "q1": (tpch.generate_csv, 7, lambda ctx, p: tpch.q1(ctx.csv(p))),
    "nyc311": (nyc311.generate_csv, 23, nyc311.build_pipeline),
}


def _device_us(avg) -> float:
    """Self device time of a key_averages() row (the attribute's name
    differs between torch versions)."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(avg, name, None)
        if v is not None:
            return float(v)
    return 0.0


def stage_profile(make_ds, path: str, top: int) -> dict:
    ctx = Context()
    stage = plan_stages(make_ds(ctx, path)._op)[0]
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
    intervals = device_intervals(prof)
    return {"rows": part.num_rows, "padded_rows": batch.b,
            "host_wall_ms": wall * 1e3,
            "device_ms": sum(r["device_ms"] for r in rows),
            "device_busy_ms": union_us(intervals) / 1e3,
            "device_events": len(intervals), "top": rows[:top]}


def job_profile(make_ds, path: str, runs: int) -> dict:
    out: dict = {"runs": []}
    for _ in range(runs):
        ctx = Context()
        t0 = time.perf_counter()
        n_out = len(make_ds(ctx, path).collect())
        torch.cuda.synchronize()
        m = ctx.metrics
        out["runs"].append({
            "rows_out": n_out, "wall_s": time.perf_counter() - t0,
            "fast_path_s": m.fastPathWallTime(),
            "slow_path_s": m.slowPathWallTime(),
            "backend_s": m.totalWallTime(),
            "interpreter_rows": m.interpreterRows()})
    ctx = Context()
    prof_wall, busy, _ = device_busy(lambda: make_ds(ctx, path).collect())
    out.update(profiled_wall_s=prof_wall, device_busy_s=busy,
               device_idle_share=1.0 - busy / prof_wall)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pipeline", choices=sorted(PIPELINES), default="z1")
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--runs", type=int, default=3,
                    help="unprofiled jobs timed before the profiled one")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    gen, seed, make_ds = PIPELINES[args.pipeline]
    args.seed = seed if args.seed is None else args.seed
    args.out = args.out or f"chiprun_out/{args.pipeline}_profile.json"
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
    with tempfile.TemporaryDirectory(prefix="profile_") as tmp:
        path = os.path.join(tmp, "data.csv")
        gen(path, args.rows, seed=args.seed)
        st = stage_profile(make_ds, path, args.top)
        print(f"one partition's stage: {st['rows']} rows (padded "
              f"{st['padded_rows']}), host wall {st['host_wall_ms']:.3f} "
              f"ms, device {st['device_ms']:.3f} ms in "
              f"{st['device_events']} device events (busy "
              f"{st['device_busy_ms']:.3f} ms)")
        print(f"{'device ms':>10} {'calls':>6}  op")
        for r in st["top"]:
            print(f"{r['device_ms']:10.3f} {r['calls']:6d}  {r['op'][:90]}")
        job = job_profile(make_ds, path, args.runs)
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
        json.dump({"card": card, "pipeline": args.pipeline,
                   "rows": args.rows, "seed": args.seed,
                   "stage": st, "job": job}, fp, indent=1)


if __name__ == "__main__":
    main()
