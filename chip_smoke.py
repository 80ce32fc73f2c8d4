"""Smoke run of tuplex_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a nonzero exit:

  1. the card's name and power limit;
  2. build the NFA scan kernel (csrc/nfa_scan.cu) with nvcc;
  3. the kernel against its plain torch version on the card: the pattern
     x string matrix of the reference package's NFA tests, seeded random
     byte matrices of 1,000,003 rows x 128 bytes, edge inputs (widths 75,
     128 and 1000, bases that are not 16-byte aligned, row counts around
     the kernel's block), and the log-grep batch at the shape the main path
     stages; results must match exactly. Each timed input's kernel time is
     printed beside the time PERF.md records for the kernel this one
     replaced;
  4. the dual-mode smoke pipeline through Context() on the card;
  5. the log grep over 1,891,715 generated Apache log lines (seed 17, one
     non-ASCII line in every 100,000), checked against a plain Python loop;
  6. Zillow Z1 over 1,000,000 generated rows (seed 42, about 148 MB of
     CSV): the CSV source timed apart (read, split, byte matrices), then
     the pipeline through Context() on the card, checked against the plain
     Python loop on the same file (rows, order and types).

It prints one JSON line of kernel numbers, then the card's name and power
limit, and as its last line {"ok": true, "device": {...}}. It needs CUDA
and the rest of the repository; without either it exits nonzero and prints
no result.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: CUDA is not available")

from tuplex_tpu_torch import Context                      # noqa: E402
from tuplex_tpu_torch.io import csvsource                 # noqa: E402
from tuplex_tpu_torch.models import logs, zillow          # noqa: E402
from tuplex_tpu_torch.ops import nfa_cuda                 # noqa: E402
from tuplex_tpu_torch.ops.nfa import compile_nfa          # noqa: E402
from tuplex_tpu_torch.runtime import columns as C         # noqa: E402

LOG_LINES = 1_891_715       # NASA-HTTP, July 1995: one month of requests
ZILLOW_ROWS = 1_000_000     # cut from a full scrape for the time limit
ZILLOW_SEED = 42
NON_ASCII_EVERY = 100_000
RANDOM_ROWS = 1_000_003     # not a multiple of any block size
RANDOM_WIDTH = 128
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate (data sheet)
SLEEP_CYCLES = 400_000_000  # busy-wait that hides launch overhead (~0.2 s)

# the pattern x string matrix of tests/test_string_ops.py:270-273
MATRIX_STRINGS = ["", "a", "abc", "zabcz", "GET /idx HTTP/1.0", "aaab",
                  "ab\n", "aXb", "2023-04-01", "foo123bar", "a" * 50 + "b"]
MATRIX_PATTERNS = ["abc", "a+b", "GET|POST", "a*b", "[0-9]+-[0-9]+",
                   "^abc", "abc$", "^a.*b$", r"\d+", "(ab)+", "^$", "b$"]
# the patterns phase 3 runs over the random matrices; the last two use all
# 64 positions of the state word (bit 63 included)
RANDOM_PATTERNS = ["GET|POST", logs.ERROR_STATUS, "^a.*b$", "b$", "^$",
                   "a*b", "GET /" + "[a-z]" * 57 + "(x|y)", "[ab]" * 64]
# the edge inputs: 1, 2 and 8 follow chunks, with and without '$'
EDGE_PATTERNS = [logs.ERROR_STATUS, "b$", "^a.*b$", "[ab]" * 64]
# ms of the one-thread-per-row kernel this one replaced, as PERF.md records
# it (H100 80GB HBM3, 700 W): log-grep batch, random rows with 9 and 64
# positions
EARLIER_MS = {"log-grep batch": 0.1118, logs.ERROR_STATUS: 0.2972,
              "[ab]" * 64: 2.036}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def kernel_device_ms(fn, reps: int) -> tuple[float, float]:
    """(device ms, host ms) per call of fn(), which launches one kernel.
    The calls are queued behind a busy-wait on the card, so the events time
    the launches back to back and not the host's per-call overhead; fails
    if the host did not finish queueing before the busy-wait ended."""
    fn()
    torch.cuda.synchronize()
    e_sleep = torch.cuda.Event(enable_timing=True)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    e_sleep.record()
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    torch.cuda.synchronize()
    if host_ms >= e_sleep.elapsed_time(start):
        raise AssertionError("kernel timing: the host did not get ahead of "
                             "the card; raise SLEEP_CYCLES")
    return start.elapsed_time(end) / reps, host_ms / reps


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() over `reps` runs, by CUDA events, after one
    warm-up run (host launch overhead included)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def random_matrix(rng: np.random.Generator, n: int, w: int):
    """Seeded byte rows over a small alphabet (so the patterns match
    often), 1% of rows over all 256 byte values, 1% long a/b runs, lengths
    0..w, and 5% of the non-empty rows ending in a newline."""
    alphabet = np.frombuffer(b'abxyzGETPOS /"0123456789\n', dtype=np.uint8)
    mat = alphabet[rng.integers(0, len(alphabet), size=(n, w))]
    wide = rng.random(n) < 0.01
    mat[wide] = rng.integers(0, 256, size=(int(wide.sum()), w),
                             dtype=np.uint8)
    runs = rng.random(n) < 0.01
    mat[runs] = np.frombuffer(b"ab", dtype=np.uint8)[
        rng.integers(0, 2, size=(int(runs.sum()), w))]
    lens = rng.integers(0, w + 1, size=n).astype(np.int32)
    lens[runs] = rng.integers(64, w + 1, size=int(runs.sum()))
    nl = (rng.random(n) < 0.05) & (lens > 0)
    mat[np.nonzero(nl)[0], lens[nl] - 1] = 10
    mat[np.arange(w)[None, :] >= lens[:, None]] = 0
    return mat, lens


def edge_inputs(rng: np.random.Generator, rows_per_block: int, dev):
    """(what, bytes, lens) on the card: widths 75 (byte loads), 128
    (16-byte loads) and 1000 (eight column chunks); rows 1.. of a
    contiguous [N+1, 75] matrix and a [N, 128] matrix 4 bytes into its
    buffer (bases not 16-byte aligned); 1, R-1, R and R+1 rows."""
    out = []
    for w in (75, 128, 1000):
        mat, lens = random_matrix(rng, 3001, w)
        out.append((f"[3001, {w}]", torch.from_numpy(mat).to(dev),
                    torch.from_numpy(lens).to(dev)))
    mat, lens = random_matrix(rng, 3002, 75)
    out.append(("rows 1.. of [3002, 75]", torch.from_numpy(mat).to(dev)[1:],
                torch.from_numpy(lens[1:]).to(dev)))
    mat, lens = random_matrix(rng, 3000, 128)
    flat = torch.zeros(4 + mat.size, dtype=torch.uint8, device=dev)
    flat[4:] = torch.from_numpy(mat.ravel()).to(dev)
    out.append(("[3000, 128] at base + 4", flat[4:].view(3000, 128),
                torch.from_numpy(lens).to(dev)))
    r = rows_per_block
    for n in (1, r - 1, r, r + 1):
        mat, lens = random_matrix(rng, n, 96)
        out.append((f"[{n}, 96]", torch.from_numpy(mat).to(dev),
                    torch.from_numpy(lens).to(dev)))
    return out


def check_kernel(rx, b: torch.Tensor, l: torch.Tensor, what: str) -> int:
    """Kernel against the plain version on the same tensors; returns the
    largest absolute difference (0 = identical)."""
    got = rx.match(b, l)
    want = rx.match_bitmask(b, l)
    torch.cuda.synchronize()
    err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
    if err:
        raise AssertionError(f"kernel != plain version on {what}")
    return err


def zillow_phase(tmp: str) -> None:
    """Z1 on the card against the plain Python loop on the same file."""
    path = os.path.join(tmp, "zillow.csv")
    t0 = time.perf_counter()
    zillow.generate_csv(path, ZILLOW_ROWS, seed=ZILLOW_SEED)
    print(f"zillow: generated {ZILLOW_ROWS} rows, "
          f"{os.path.getsize(path)} bytes, in "
          f"{time.perf_counter() - t0:.2f} s")

    # the CSV source alone, the same work the job does
    stat = Context().csv(path)._op.parent.stat
    t0 = time.perf_counter()
    with open(path, "rb") as fp:
        data = fp.read()
    read_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    csvsource._split_records(data, ord(stat.delimiter), ord(stat.quotechar),
                             stat.num_columns, stat.has_header)
    split_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    parts = list(csvsource.csv_partitions(data, stat,
                                          Context().options_store))
    parts_s = time.perf_counter() - t0
    print(f"zillow CSV source: read {read_s:.3f} s, split {split_s:.3f} s, "
          f"byte matrices {parts_s - split_s:.3f} s (split and matrices "
          f"{parts_s:.3f} s) -> {len(parts)} partitions, "
          f"{sum(len(p.fallback) for p in parts)} boxed rows")
    del data, parts

    t0 = time.perf_counter()
    want = zillow.run_reference_python(path)
    ref_s = time.perf_counter() - t0
    ctx = Context()
    t0 = time.perf_counter()
    ds = zillow.build_pipeline(ctx.csv(path))
    got = ds.collect()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if got != want or [tuple(map(type, r)) for r in got] != \
            [tuple(map(type, r)) for r in want]:
        bad = next((i for i, (g, w) in enumerate(zip(got, want))
                    if g != w), min(len(got), len(want)))
        raise AssertionError(f"zillow: {len(got)} rows != python "
                             f"{len(want)} rows; first difference at "
                             f"row {bad}")
    m = ctx.metrics
    if m.stages[-1]["tier"] != "compiled":
        raise AssertionError("zillow: the stage did not compile")
    if not 0 < m.interpreterRows() < ZILLOW_ROWS // 10:
        raise AssertionError(f"zillow: {m.interpreterRows()} interpreter "
                             "rows")
    print(f"zillow Z1: {ZILLOW_ROWS} rows -> {len(got)} rows in "
          f"{wall:.3f} s ({ZILLOW_ROWS / wall:.0f} rows/s; python loop "
          f"{ref_s:.3f} s), exceptions {ds.exception_counts()}, "
          f"interpreter rows {m.interpreterRows()}, device error rows "
          f"{m.deviceErrorRows()}, fast path {m.fastPathWallTime():.3f} s, "
          f"slow path {m.slowPathWallTime():.3f} s, backend "
          f"{m.totalWallTime():.3f} s (fast + slow + merge), outside the "
          f"backend {wall - m.totalWallTime():.3f} s (sniff, CSV source, "
          f"results to Python)")
    os.remove(path)


def main() -> None:
    dev = torch.device("cuda", 0)

    # 1 --------------------------------------------------------------
    card = card_line()
    print(f"card: {card} | torch.cuda: {torch.cuda.get_device_name(0)}")

    # 2 --------------------------------------------------------------
    t0 = time.perf_counter()
    lib = nfa_cuda.build()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {lib}")
    if nfa_cuda.build_log:
        print(nfa_cuda.build_log.strip())

    # 3 --------------------------------------------------------------
    max_err = 0
    enc = C.encode_str_leaf(MATRIX_STRINGS, False)
    mb = torch.from_numpy(np.ascontiguousarray(enc.bytes)).to(dev)
    ml = torch.from_numpy(enc.lengths).to(dev)
    for pat in MATRIX_PATTERNS:
        rx = compile_nfa(pat)
        got = rx.match(mb, ml).cpu().tolist()
        want = [re.search(pat, s) is not None for s in MATRIX_STRINGS]
        if got != want:
            raise AssertionError(f"pattern {pat!r}: {got} != re {want}")
        if rx.n_pos:
            max_err = max(max_err, check_kernel(rx, mb, ml, repr(pat)))
    rng = np.random.default_rng(17)
    mat, lens = random_matrix(rng, RANDOM_ROWS, RANDOM_WIDTH)
    rb = torch.from_numpy(mat).to(dev)
    rl = torch.from_numpy(lens).to(dev)
    for pat in RANDOM_PATTERNS:
        rx = compile_nfa(pat)
        if rx.n_pos:
            max_err = max(max_err, check_kernel(rx, rb, rl, repr(pat)))
    edges = edge_inputs(rng, nfa_cuda.rows_per_block(), dev)
    for pat in EDGE_PATTERNS:
        rx = compile_nfa(pat)
        for what, b, l in edges:
            max_err = max(max_err, check_kernel(rx, b, l,
                                                f"{pat!r} on {what}"))
    del edges
    print(f"kernel == plain on {len(MATRIX_PATTERNS)} x "
          f"{len(MATRIX_STRINGS)} matrix, {len(RANDOM_PATTERNS)} "
          f"patterns over {RANDOM_ROWS} x {RANDOM_WIDTH} random rows and "
          f"{len(EDGE_PATTERNS)} patterns over the edge inputs")
    need = int(rl.to(torch.int64).sum())
    for pat in (logs.ERROR_STATUS, "[ab]" * 64):
        rx = compile_nfa(pat)
        ms, _ = kernel_device_ms(lambda: rx.match(rb, rl), 20)
        bound = (need + 5 * RANDOM_ROWS) / HBM_BYTES_PER_S * 1e3
        print(f"nfa_scan at [{RANDOM_ROWS}, {RANDOM_WIDTH}] random rows, "
              f"{rx.n_pos} positions ({pat[:24]!r}): kernel {ms:.4f} ms "
              f"(earlier kernel {EARLIER_MS[pat]} ms), bound {bound:.4f} ms")

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    path = os.path.join(tmp, "access.log")
    t0 = time.perf_counter()
    logs.generate_log(path, LOG_LINES, seed=17,
                      non_ascii_every=NON_ASCII_EVERY)
    print(f"generated {LOG_LINES} lines in {time.perf_counter() - t0:.2f} s")

    # the batch the log grep stages: first partition, harmonized width
    ctx = Context()
    src = ctx.text(path)._op
    t0 = time.perf_counter()
    parts = C.harmonize_partitions(src.load_partitions())
    load_s = time.perf_counter() - t0
    part = parts[0]
    del parts
    batch = C.stage_partition(part, dev)
    gb, gl = batch.arrays["0#bytes"], batch.arrays["0#len"]
    grx = compile_nfa(logs.ERROR_STATUS)
    max_err = max(max_err, check_kernel(grx, gb, gl, "log-grep batch"))
    kernel_ms, call_ms = kernel_device_ms(lambda: grx.match(gb, gl), 50)
    plain_ms = cuda_ms(lambda: grx.match_bitmask(gb, gl), 3)
    n_rows, width = gb.shape
    need = int(torch.clamp(gl, max=width).to(torch.int64).sum())
    # the scan stops at each row's length: count the in-length bytes it
    # must read, plus lens in and matches out; the full matrix beside it
    bound_ms = (need + 4 * n_rows + n_rows) / HBM_BYTES_PER_S * 1e3
    full_ms = (n_rows * width + 5 * n_rows) / HBM_BYTES_PER_S * 1e3
    print(f"nfa_scan at [{n_rows}, {width}]: kernel {kernel_ms:.4f} ms "
          f"on the card (earlier kernel {EARLIER_MS['log-grep batch']} ms; "
          f"{call_ms:.4f} ms of host time per wrapper call), "
          f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({need} row bytes + lens + out at {HBM_BYTES_PER_S:.3g} B/s; "
          f"all N*W bytes: {full_ms:.4f} ms)")
    print(f"text source: read, split and encode {LOG_LINES} lines into "
          f"partitions: {load_s:.3f} s")
    del batch, gb, gl, rb, rl

    # 4 --------------------------------------------------------------
    nfa_cuda.launches = 0
    ctx = Context()
    ds = ctx.parallelize([1, 2, None, 4]).map(lambda x: (x, x * x))
    got = ds.collect()
    if got != [(1, 1), (2, 4), (4, 16)]:
        raise AssertionError(f"smoke pipeline: {got}")
    if ctx.metrics.interpreterRows() != 1 or \
            ds.exception_counts() != {"TypeError": 1}:
        raise AssertionError(f"smoke pipeline: interpreter rows "
                             f"{ctx.metrics.interpreterRows()}, exceptions "
                             f"{ds.exception_counts()}")
    print(f"smoke: {got}, interpreter rows 1, exceptions "
          f"{ds.exception_counts()}, NFA launches {nfa_cuda.launches}")

    # 5 --------------------------------------------------------------
    t0 = time.perf_counter()
    want = logs.run_grep_reference(path)
    ref_s = time.perf_counter() - t0
    ctx = Context()
    nfa_cuda.launches = 0
    t0 = time.perf_counter()
    got = logs.build_grep(ctx.text(path)).collect()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = nfa_cuda.launches
    if got != want:
        raise AssertionError(f"log grep: {len(got)} rows != python "
                             f"{len(want)} rows")
    if launches <= 0:
        raise AssertionError("log grep did not launch the NFA scan kernel")
    m = ctx.metrics
    n_non_ascii = LOG_LINES // NON_ASCII_EVERY
    if m.interpreterRows() != n_non_ascii:
        raise AssertionError(f"log grep: {m.interpreterRows()} interpreter "
                             f"rows, want {n_non_ascii}")
    print(f"log grep: {LOG_LINES} lines -> {len(got)} rows in {wall:.3f} s "
          f"({LOG_LINES / wall:.0f} lines/s; python loop {ref_s:.3f} s), "
          f"interpreter rows {m.interpreterRows()}, NFA launches {launches}, "
          f"fast path {m.fastPathWallTime():.3f} s, slow path "
          f"{m.slowPathWallTime():.3f} s, backend {m.totalWallTime():.3f} s "
          f"(fast + slow + merge), outside the backend "
          f"{wall - m.totalWallTime():.3f} s (source read and encode, "
          f"results to Python)")
    os.remove(path)

    # 6 --------------------------------------------------------------
    zillow_phase(tmp)
    os.rmdir(tmp)

    print(json.dumps({"kernels": [{
        "name": "nfa_scan", "route": "cuda",
        "source": "tuplex_tpu_torch/csrc/nfa_scan.cu",
        "replaces": "tuplex_tpu/ops/pallas_nfa.py:29",
        "launches": launches, "max_abs_err": max_err,
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes", "library_ms": None}]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
