"""Smoke run of tuplex_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a nonzero exit. The
script's elapsed time is printed at the end of each phase:

  1. the card's name and power limit;
  2. build the kernels (csrc/nfa_scan.cu with its two entry points,
     csrc/join_probe.cu, csrc/seg_fold.cu) with nvcc and, at the same time, the native host
     module (native/src/fasttransfer.cpp) with g++;
  3. the kernel against its plain torch version on the card: the pattern
     x string matrix of the reference package's NFA tests, seeded random
     byte matrices of 1,000,003 rows x 128 bytes, edge inputs (widths 75,
     128 and 1000, bases that are not 16-byte aligned, row counts around
     the kernel's block), and the log-grep batch at the shape the main path
     stages; results must match exactly. Each timed input's kernel time is
     printed beside the time PERF.md records for the kernel this one
     replaced. Then the leftmost-start kernel (nfa_start, the second entry
     point of csrc/nfa_scan.cu) against its plain version
     (NFARegex.match_start_plain), exactly in matched and start: on the
     matrix (and re.search(...).start()), the random matrices with
     patterns of 2 to 32 positions (the status grep's second pass and a
     leading class run among them) and the edge inputs, each with no live
     mask, with the NFA scan's own result and with a seeded 22% mask;
     timed on the random matrix with every row live, beside the time
     PERF.md records for the kernel this one replaced;
  4. the dual-mode smoke pipeline through Context() on the card (its None
     row leaves through the exact exit);
  5. the log grep over 1,891,715 generated Apache log lines (seed 17, one
     non-ASCII line in every 100,000): the text source timed apart with the
     native module and with its Python path (their partitions must be
     equal), then the pipeline through Context() on the card, checked
     against a plain Python loop, then its results decoded to Python both
     ways (equal rows);
 5b. the weblogs pipelines over the same file: the anchored engine
     (ops/regex.py, torch ops) on each staged partition, its launches and
     device time on the first by torch.profiler, and the lines it marks
     suspect; then the strip and regex variants (models/logs.py
     build_pipeline) and the status grep (build_status_grep) through
     Context() on the card, each equal to its plain loop in rows, order
     and types, with its wall, lines/s, the loop's time, its resolve tiers
     and its launches of nfa_scan, nfa_start and the engine. The strip
     variant and the status grep may interpret only the non-ASCII lines,
     the regex variant those and the suspect lines; the status grep must
     launch both kernels; the regex variant runs once more under
     torch.profiler for the card's busy time and idle share. The start
     kernel is then held against its plain version on the largest input
     the status grep gave it, with the live mask the path gave it (the
     NFA scan's result), with every row live and with none, and timed
     with its mask and with every row live, each beside the bound of its
     work and the replaced kernel's recorded time;
  6. Zillow Z1 over 1,000,000 generated rows (seed 42, about 148 MB of
     CSV): the CSV source timed apart (read; split and byte matrices with
     the native module and with the numpy path, whose arrays and
     partitions must be equal), then the pipeline through Context() on the
     card, checked against the plain Python loop on the same file (rows,
     order and types) and CPython's exception classes, then its results
     decoded to Python both ways;
  7. the aggregate stage: TPC-H Q6 and Q1 over 1,000,000 generated
     lineitem rows (seed 7; SF1 has 6,001,215), each run twice through
     Context() on the card and checked against the plain Python loops over
     the same file (floats within 1e-9 relative, counts, keys and Q1's
     group order exact), the two runs' results the same bits, Q6's
     transform stage fetching no row column and no row taking the
     interpreter; the CSV source timed apart, then Q6 under torch.profiler
     for the card's busy time and idle share; a 2,000-row lineitem file
     with 'N/A' and empty quantity and discount cells through both queries
     (rows and exception counts equal a plain CPython loop's, no row
     interpreted); and NYC 311
     over 1,000,000 generated rows (seed 23), equal in order to the plain
     loop;
  8. the join probe kernel (csrc/join_probe.cu) against its plain torch
     version (ops/join.py lower_bound_plain) on seeded batches through the
     join's own key signatures: string keys, None keys and probe matrices
     wider than the build's among them, 1,000,000 probes into 9,300 keys
     of two words (about the rows of the public GlobalAirportDatabase.txt)
     and into 200,000 keys of three words; int keys, 1,000,000 probes into
     9,300 and into 200,000 keys of one word. Results must match exactly.
     The kernel, its table copy alone, the plain version, the index's
     build and torch.searchsorted on the first words (on one-word keys the
     same lower bound) are timed;
  9. the flights pipeline over 1,000,000 generated perf rows (seed 13,
     all 30 columns; about a month and a half of the public BTS on-time
     table) with the six-row carrier and airport files as build sides,
     through Context() on the card, checked against the plain Python loop
     (rows in order, values exact, exception counts); every row of the
     first stage that violates its decode (a filled cell in a column the
     sample typed null) finished by the general-case tier, none
     interpreted; every join probed on the card, the kernel launched on
     the path, and held against its plain version on the largest probe
     the path gave it. Under the default options the defunct-airline
     filter runs in a stage of its own between the carrier join and the
     Origin join (plan/optimizer.py push_filters_through_joins);
 10. TPC-H Q19 over 200,000 parts (SF1's part table) and 1,000,000
     lineitems (seed 19), twice, within 1e-9 relative of the plain loop and
     the same bits both runs, every row probed on the card through the
     kernel (one-word keys), which is held against its plain version and
     torch.searchsorted on the largest probe the path gave it;
 11. the widened-column CSV (models/widened.py) over 1,000,000 rows
     (seed 5): a column empty through the sniffed sample, then filled;
     every filled row finished by the general-case tier on the card, none
     interpreted, the rows equal to the plain loop's;
 12. the general fold (csrc/seg_fold.cu): the latency of one dependent
     FP64 operation on the card (the kernel's calibration chain); the
     kernel against its plain version (ops/segfold.py seg_fold_plain) on
     seeded batches of 1,000,000 rows in 1, 6, 2,352 and 250,000
     segments, each through a 4-instruction and a longer program, every
     output equal bit for bit, kernel and plain version timed, each
     batch's layout (segments on a warp, on a thread), its memory bound
     and its serial bound printed beside PR 15's kernel time; then three
     general folds over phase
     7's lineitem file through Context() on the card, each equal to a
     plain loop with `==` on its repr (floats bit for bit, groups in the
     loop's order): G1 by (returnflag, linestatus), G2 by shipdate, G3 over
     the whole file, each with the kernel launched, no row folded on the
     host and no lazy leaf fetched whole, then once more with the general
     fold off (every row on the interpreter, as before it), rows equal and
     both times printed; the kernel re-checked and timed on the largest
     input G2 gave it; G1-G3 on the 2,000-row dirty file
     against the loops, exception counts included;
 13. the planner at full size, over phase 9's and phase 5's files: (a)
     flights under the defaults, the defunct filter pushed through the
     Origin and Dest left joins into a stage of its own, and once more
     with tuplex.optimizer.filterPushdown off, both equal to the loop,
     each with its stage list, the rows into the carrier, Origin and Dest
     joins (with pushdown the Origin and Dest joins must see exactly the
     rows the filter keeps, fewer than without), the join probe's
     launches and its wall; (b) the log grep with a map the emitter
     refuses (len(set(x))) and a compiled map after it: three segments,
     the middle one on the interpreter with exactly the rows the grep
     keeps, the NFA scan launched once on every partition, rows equal to
     the loop; (c) take(10) of the log grep: the loop's first 10 rows, the
     scan launched on fewer partitions than the file has; (d) cache() of
     the grep's lines and two maps over it, each equal to its loop, the
     source read once; (e) show(5) of a map over the cache, equal to the
     reference's format for the loop's first 5 rows;
 14. every entry point of the native module against its Python path on
     small inputs. The run fails unless the main path (phases 4-7) called
     the native entry points it uses and every entry point was called.

Phases 4, 6, 7, 9 and 11 print each job's resolve tiers: the rows the
interpreter, the general-case tier and the exact exit finished, the
general tier's and the interpreter's seconds, and microseconds per
interpreter row.

Every job's transform stages dispatch through the compile plane
(exec/compilequeue.py): each (stage, input shapes) key is captured once as
a CUDA graph and replayed on later partitions and later jobs. Each job
line (phases 4-7 and 9-11, and the log grep's) prints its captures,
replays, eager dispatches, declines by reason, compileTime, the graph
pools' bytes and share of the card, the store's bytes and evictions, and
the card's peak memory since the previous job line; the run fails on a decline that DECLINES_LISTED (PERF.md)
does not list. The log grep (phase 5), the weblogs strip variant and the
status grep (5b) and Z1 (6) then run twice more: through the store again,
which must capture nothing, and under compilequeue.eager() (the dispatch
before the plane). Rows must equal the loop's and the kernel counters
(nfa_scan, nfa_start, the anchored engine, which count replays) the first
run's; the three walls and the host ms per partition dispatch (captures,
replays, eager runs) are printed.

Phases 7, 9 and 10 print, for every stage of Q6, Q1, NYC 311, flights and
Q19 (the build sides' plans included), the device handoff between stages:
partitions handed off on the card, partitions sent by the host route and
why (the budget, a leaf with no device layout, no device consumer), bytes
copied each way and lazy leaves fetched whole. Q1, NYC 311, Q19 and
flights then run twice with the backend's handoff budget at 0 (every
partition by the host route) and once more with the handoff: every run's
rows must equal the first run's, and the four wall times are printed. The run fails unless every intermediate
stage of Q1, NYC 311 and Q19 (no slow path) hands off every partition and
no data column is fetched. Flights and Q19 run once more each way with
every copy timed (runtime/xferstats.py `TIMED`): each stage's wall time
split into copies, waiting for the card, and host work.

It prints one JSON line of kernel numbers, then the card's name and power
limit, and as its last line {"ok": true, "device": {...}}. It needs CUDA
and the rest of the repository; without either it exits nonzero and prints
no result.
"""

from __future__ import annotations

import ast
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: CUDA is not available")

from tuplex_tpu_torch import Context, native              # noqa: E402
from tuplex_tpu_torch.compiler.foldprog import lower_fold  # noqa: E402
from tuplex_tpu_torch.compiler.pypipeline import (        # noqa: E402
    build_python_pipeline)
from tuplex_tpu_torch.core import typesys as T            # noqa: E402
from tuplex_tpu_torch.exec import compilequeue as CQ      # noqa: E402
from tuplex_tpu_torch.exec.joinexec import KeyLayout      # noqa: E402
from tuplex_tpu_torch.exec.local import source_partitions  # noqa: E402
from tuplex_tpu_torch.io import csvsource                 # noqa: E402
from tuplex_tpu_torch.models import (flights, logs,       # noqa: E402
                                     nyc311, tpch, widened, zillow)
from tuplex_tpu_torch.ops import join as J                # noqa: E402
from tuplex_tpu_torch.ops import regex as RX              # noqa: E402
from tuplex_tpu_torch.ops import strings as S             # noqa: E402
from tuplex_tpu_torch.ops import join_cuda, nfa_cuda      # noqa: E402
from tuplex_tpu_torch.ops import segfold as SF            # noqa: E402
from tuplex_tpu_torch.ops import segfold_cuda             # noqa: E402
from tuplex_tpu_torch.ops.nfa import compile_nfa          # noqa: E402
from tuplex_tpu_torch.plan import aggregates as A         # noqa: E402
from tuplex_tpu_torch.plan.physical import plan_stages    # noqa: E402
from tuplex_tpu_torch.runtime import columns as C         # noqa: E402
from tuplex_tpu_torch.runtime import xferstats            # noqa: E402
from tuplex_tpu_torch.runtime.devprof import (           # noqa: E402
    device_busy, device_intervals, union_us)
from tuplex_tpu_torch.utils.reflection import get_udf_source  # noqa: E402

LOG_LINES = 1_891_715       # NASA-HTTP, July 1995: one month of requests
ZILLOW_ROWS = 1_000_000     # cut from a full scrape for the time limit
ZILLOW_SEED = 42
TPCH_ROWS = 1_000_000       # SF1's lineitem has 6,001,215: cut for time
TPCH_SEED = 7
NYC311_ROWS = 1_000_000
NYC311_SEED = 23
FLIGHTS_ROWS = 1_000_000    # about 1.5 months of the BTS on-time table
FLIGHTS_SEED = 13
Q19_PARTS = 200_000         # TPC-H SF1's part table
Q19_ITEMS = 1_000_000       # SF1's lineitem has 6,001,215: cut for time
Q19_SEED = 19
WIDENED_ROWS = 1_000_000
WIDENED_SEED = 5
# compile-plane declines the main path may show (PERF.md lists each with
# its reason): none
DECLINES_LISTED: frozenset = frozenset()
PROBES = 1_000_000          # probe rows of the kernel phase's batches
FOLD_ROWS = 1_000_000       # rows of the general fold's seeded batches
FOLD_SEGMENTS = (1, 6, 2_352, 250_000)   # whole file, Q1's keys, ship
                                         # dates, keys of 4 rows
AIRPORT_KEYS = 9_300        # about the rows of GlobalAirportDatabase.txt
REL_TOL = 1e-9              # float sums: partials merged per partition
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
# the leftmost-start kernel (nfa_start): the matrix's patterns it takes
# (not nullable, 1..32 positions), the patterns over the random matrices
# (a leading class run among them) and over the edge inputs (1 to 4 follow
# chunks, with and without '$')
START_MATRIX_PATTERNS = [p for p in MATRIX_PATTERNS
                         if p not in ("^$", "a*b")] + ["a*b"]
START_RANDOM_PATTERNS = [logs.STATUS_GROUPS, r"\S+x", "GET|POST", "a+b$",
                         "[ab]" * 32]
START_EDGE_PATTERNS = [logs.STATUS_GROUPS, r"\S+x", "b$", "[ab]" * 32]
# ms of the one-thread-per-row kernel this one replaced, as PERF.md records
# it (H100 80GB HBM3, 700 W): log-grep batch, random rows with 9 and 64
# positions
EARLIER_MS = {"log-grep batch": 0.1118, logs.ERROR_STATUS: 0.2972,
              "[ab]" * 64: 2.036}
# ms of the start kernel this one replaced (every row scanned, 64-bit
# tables), as PERF.md records it (H100 80GB HBM3, 700 W): the status
# grep's largest input, random rows with 8, 3 and 32 positions
EARLIER_START_MS = {"status grep input": 0.0577, logs.STATUS_GROUPS: 0.1205,
                    r"\S+x": 0.1077, "[ab]" * 32: 0.1722}
# ms of the one-thread-per-segment general fold (PR 15) on the seeded
# batches and on G2's largest input, as PERF.md records them (H100 80GB
# HBM3, 700 W)
EARLIER_FOLD_MS = {("fold_short", 1): 1090.43, ("fold_short", 6): 219.55,
                   ("fold_short", 2_352): 0.7410,
                   ("fold_short", 250_000): 0.1020,
                   ("fold_long", 1): 3398.36, ("fold_long", 6): 919.40,
                   ("fold_long", 2_352): 3.6087,
                   ("fold_long", 250_000): 0.6375,
                   ("G2's largest input", 2_352): 0.3521}


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


def check_start(rx, b: torch.Tensor, l: torch.Tensor, what: str,
                live=None) -> int:
    """The start kernel against match_start_plain on the same tensors and
    live mask; returns the largest absolute difference of matched and
    start (0 = identical)."""
    m, st = rx.match_start(b, l, live=live)
    pm, pst = rx.match_start_plain(b, l, live)
    torch.cuda.synchronize()
    err = max(int((m.to(torch.int32) - pm.to(torch.int32)).abs().max()),
              int((st - pst).abs().max()))
    if err:
        raise AssertionError(f"start kernel != plain version on {what}")
    return err


def start_bound_ms(l: torch.Tensor, width: int, live=None) -> float:
    """The start scan's bytes at the memory rate: each live row's
    in-length bytes and its 4 B length read once, the 1 B mask read (when
    there is one) and 5 B (matched, start) written for every row. A dead
    row's length and bytes are not needed."""
    n = l.shape[0]
    if live is not None:
        l = l[live]
    need = int(torch.clamp(l, 0, width).to(torch.int64).sum())
    return (need + 4 * l.shape[0] + (0 if live is None else n) + 5 * n) \
        / HBM_BYTES_PER_S * 1e3


def start_masks(rx, b: torch.Tensor, l: torch.Tensor, seed: int) -> dict:
    """Live masks for the start kernel's checks: none, the NFA scan's own
    result (the main path's), and a seeded 22% of the rows."""
    rng = np.random.default_rng(seed)
    return {"no mask": None, "the scan's mask": rx.match(b, l),
            "22% live": torch.from_numpy(
                rng.random(b.shape[0]) < 0.22).to(b.device)}


def start_variant_line() -> str:
    """The start kernel's variant at 1-4 follow chunks (16-byte copies, no
    '$'): table layout, threads and blocks per SM."""
    out = []
    for k in (1, 2, 3, 4):
        v = nfa_cuda.start_variant(k)
        out.append(f"{k} chunk(s): "
                   f"{'lane-replicated' if v.replicated else 'plain'} "
                   f"tables, {v.blocks_per_sm} block(s) of {v.threads}/SM")
    return f"nfa_start variants on {v.sms} SMs: " + "; ".join(out)


def start_kernel_phase(mb, ml, rb, rl, edges) -> int:
    """Phase 3's start-kernel half: the leftmost-start kernel against its
    plain version (and re.search(...).start() on the matrix) on the
    matrix, the random matrices and the edge inputs; timed on the random
    matrix. Returns the largest difference."""
    print(start_variant_line())
    max_err = 0
    for pat in START_MATRIX_PATTERNS:
        rx = compile_nfa(pat)
        m, st = rx.match_start(mb, ml)
        want = [re.search(pat, x) for x in MATRIX_STRINGS]
        if m.cpu().tolist() != [w is not None for w in want] or \
                st.cpu().tolist() != [w.start() if w else 0 for w in want]:
            raise AssertionError(f"start of {pat!r} != re")
        max_err = max(max_err, check_start(rx, mb, ml, repr(pat)))
    for pat in START_RANDOM_PATTERNS:
        rx = compile_nfa(pat)
        for what, live in start_masks(rx, rb, rl, 1).items():
            max_err = max(max_err, check_start(rx, rb, rl,
                                               f"{pat!r}, {what}", live))
    for pat in START_EDGE_PATTERNS:
        rx = compile_nfa(pat)
        for what, b, l in edges:
            for mask, live in start_masks(rx, b, l, 2).items():
                max_err = max(max_err, check_start(
                    rx, b, l, f"{pat!r} on {what}, {mask}", live))
    print(f"start kernel == plain on {len(START_MATRIX_PATTERNS)} x "
          f"{len(MATRIX_STRINGS)} matrix (== re's start), "
          f"{len(START_RANDOM_PATTERNS)} patterns over {RANDOM_ROWS} x "
          f"{RANDOM_WIDTH} random rows and {len(START_EDGE_PATTERNS)} "
          f"patterns over the edge inputs, each with no mask, the scan's "
          f"mask and a 22% mask")
    for pat in (logs.STATUS_GROUPS, r"\S+x", "[ab]" * 32):
        rx = compile_nfa(pat)
        ms, call_ms = kernel_device_ms(lambda: rx.match_start(rb, rl), 20)
        plain_ms = cuda_ms(lambda: rx.match_start_plain(rb, rl), 1)
        print(f"nfa_start at [{RANDOM_ROWS}, {RANDOM_WIDTH}] random rows, "
              f"{rx.n_pos} positions ({pat[:24]!r}), every row live: "
              f"kernel {ms:.4f} ms (earlier kernel "
              f"{EARLIER_START_MS[pat]} ms; {call_ms:.4f} ms of host time "
              f"per wrapper call), plain {plain_ms:.2f} ms, bound "
              f"{start_bound_ms(rl, RANDOM_WIDTH):.4f} ms")
    return max_err


@contextlib.contextmanager
def recording(module, attr: str, inputs: list, pick):
    """Records pick(*args) of every call the main path makes to a kernel's
    wrapper, module.attr, while the context is open (eagerly or in a
    graph's warm-up; a replay calls no wrapper)."""
    kernel = getattr(module, attr)

    def wrapper(*args, **kw):
        # a call made while a graph is captured computes nothing then:
        # its tensors hold no input yet
        if not torch.cuda.is_current_stream_capturing():
            inputs.append(pick(*args, **kw))
        return kernel(*args, **kw)

    setattr(module, attr, wrapper)
    try:
        yield
    finally:
        setattr(module, attr, kernel)


def engine_per_partition(parts, dev) -> int:
    """The anchored engine (ops/regex.py, torch ops) on the regex
    variant's staged partitions: its torch launches and device ms on the
    first, by torch.profiler, and the rows it marks suspect and unmatched
    over the file's ASCII lines (the regex variant may send those to the
    interpreter). Returns that count."""
    from torch.profiler import ProfilerActivity, profile

    rx = RX.compile_regex(logs.WEBLOGS_REGEX)
    suspects = 0
    for i, part in enumerate(parts):
        batch = C.stage_partition(part, dev)
        b, l = batch.arrays["0#bytes"], batch.arrays["0#len"]
        live = batch.arrays["#rowvalid"] & ~S.non_ascii_rows(b, l)
        if i == 0:
            rx.match(b, l)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                rx.match(b, l)
                torch.cuda.synchronize()
            spans = device_intervals(prof)
            ms = cuda_ms(lambda: rx.match(b, l), 5)
            print(f"anchored engine on a partition [{b.shape[0]}, "
                  f"{b.shape[1]}] ({len(rx.steps)} steps, "
                  f"{rx.n_groups} groups): {len(spans)} device launches, "
                  f"device busy {union_us(spans) / 1e3:.3f} ms "
                  f"(torch.profiler), {ms:.3f} ms a call by CUDA events "
                  f"(host launch time included)")
        m, sus, _, _ = rx.match(b, l)
        suspects += int((sus & ~m & live).sum())
    return suspects


def weblogs_phase(path: str, dev) -> tuple[int, int, dict]:
    """The weblogs pipelines (strip and regex variants) and the status grep
    over phase 5's file through Context() on the card, each against its
    plain Python loop (rows, order, types), with their interpreter rows
    held to the non-ASCII lines (plus the engine's suspects for the regex
    variant). Then the start kernel against its plain version on the
    largest input the status grep gave it, timed. Returns (start-kernel
    launches in the status grep, largest difference, its numbers)."""
    n_non_ascii = LOG_LINES // NON_ASCII_EVERY
    src = Context().text(path)._op
    parts = C.harmonize_partitions(src.load_partitions())
    suspects = engine_per_partition(parts, dev)
    del parts
    starts: list = []
    start_launches = 0
    jobs = (("weblogs strip", lambda ds: logs.build_pipeline(ds, "strip"),
             lambda: logs.run_reference_python(path, "strip"), n_non_ascii),
            ("weblogs regex", lambda ds: logs.build_pipeline(ds, "regex"),
             lambda: logs.run_reference_python(path, "regex"),
             n_non_ascii + suspects),
            ("status grep", logs.build_status_grep,
             lambda: logs.run_status_grep_reference(path), n_non_ascii))
    for what, build, loop, limit in jobs:
        want, loop_s = timed(loop)
        ctx = Context()
        nfa_cuda.launches = nfa_cuda.start_launches = RX.calls = 0
        # copies: a graph's replays overwrite what its warm-up was given
        with recording(nfa_cuda, "match_start_cuda", starts,
                       lambda tables, buf, b, l, live=None:
                       (b.clone(), l.clone(),
                        None if live is None else live.clone())):
            t0 = time.perf_counter()
            got = build(ctx.text(path)).collect()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counts = (nfa_cuda.launches, nfa_cuda.start_launches, RX.calls)
        if got != want or [tuple(map(type, r)) for r in got] != \
                [tuple(map(type, r)) for r in want]:
            raise AssertionError(f"{what}: {len(got)} rows != the loop's "
                                 f"{len(want)} (or their order or types)")
        m = ctx.metrics
        if m.interpreterRows() > limit:
            raise AssertionError(f"{what}: {m.interpreterRows()} interpreter "
                                 f"rows, more than {limit}")
        if what == "status grep":
            start_launches = counts[1]
            if min(counts) <= 0:
                raise AssertionError(f"status grep: launches {counts}")
        print(f"{what}: {LOG_LINES} lines -> {len(got)} rows in {wall:.3f} s "
              f"({LOG_LINES / wall:.0f} lines/s; python loop {loop_s:.3f} "
              f"s), {tier_line(m)}, tier mix {m.resolveTierMix()}, "
              f"interpreter limit {limit}; fast path "
              f"{m.fastPathWallTime():.3f} s, backend "
              f"{m.totalWallTime():.3f} s; launches: nfa_scan {counts[0]}, "
              f"nfa_start {counts[1]}, anchored engine calls {counts[2]}")
        if what == "weblogs regex":   # the anchored engine's job
            pwall, busy, _ = device_busy(
                lambda: build(Context().text(path)).collect())
            print(f"{what} under torch.profiler: {pwall:.3f} s, device "
                  f"busy {busy:.4f} s, idle share {1 - busy / pwall:.4f}")
        else:
            plane_compare(what, lambda c: build(c.text(path)), want,
                          (wall, m, counts))
    print(f"weblogs: the port's engine marks {suspects} ASCII lines "
          f"suspect and unmatched")
    b, l, live = max(starts, key=lambda bl: bl[0].shape[0])
    del starts
    rx = compile_nfa(logs.STATUS_GROUPS)
    if live is None or not torch.equal(live, rx.match(b, l)):
        raise AssertionError("status grep: the start kernel was not given "
                             "the NFA scan's result as its live mask")
    every = torch.ones_like(live)
    err = 0
    for what, mask in (("its mask", live), ("every row live", every),
                       ("no row live", torch.zeros_like(live))):
        err = max(err, check_start(rx, b, l, f"the status grep's largest "
                                   f"input, {what}", mask))
    nums = {}
    for what, mask in (("its mask", live), ("every row live", every)):
        ms, call_ms = kernel_device_ms(
            lambda: rx.match_start(b, l, live=mask), 50)
        plain_ms = cuda_ms(lambda: rx.match_start_plain(b, l, mask), 3)
        bound = start_bound_ms(l, b.shape[1], mask)
        print(f"nfa_start at the status grep's largest input [{b.shape[0]}, "
              f"{b.shape[1]}], {what} ({int(mask.sum())} rows live): kernel "
              f"{ms:.4f} ms (earlier kernel, every row scanned, "
              f"{EARLIER_START_MS['status grep input']} ms; {call_ms:.4f} ms "
              f"of host time per wrapper call), plain {plain_ms:.4f} ms, "
              f"bound {bound:.4f} ms; kernel == plain")
        if not nums:   # the main path's input: with the scan's mask
            nums = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound}
    return start_launches, err, nums


@contextlib.contextmanager
def python_path():
    """The native module switched off: every caller takes its Python
    path, as on a host without g++."""
    saved = native._mod, native._tried
    native._mod, native._tried = None, True
    try:
        yield
    finally:
        native._mod, native._tried = saved


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def tier_line(m) -> str:
    """The resolve tiers of a job's transform stages (api/metrics.py),
    then its compile plane (`plane_line`, which fails the run on a decline
    PERF.md does not list)."""
    n = m.interpreterRows()
    per_row = f"{m.slowPathWallTime() / n * 1e6:.1f} us" if n else "-"
    return (f"interpreter rows {n}, general rows {m.generalRows()}, "
            f"exact-exit rows {m.exactExitRows()}, general path "
            f"{m.generalPathWallTime():.3f} s, slow path "
            f"{m.slowPathWallTime():.3f} s ({per_row} per interpreter "
            f"row); {plane_line(m)}")


def _stage_sum(m, key: str):
    return sum(s.get(key, 0) for s in m.stages)


def dispatch_ms(m) -> str:
    """Host ms per partition dispatch of a job's transform stages: all of
    them, and those that captured, replayed and ran eagerly."""
    kinds = (("capture", "capture_dispatches", "capture_dispatch_s"),
             ("replay", "graph_replays", "replay_dispatch_s"),
             ("eager", "eager_dispatches", "eager_dispatch_s"))
    n_all = sum(_stage_sum(m, n) for _, n, _ in kinds)
    s_all = sum(_stage_sum(m, s) for _, _, s in kinds)
    parts = [f"{s_all / n_all * 1e3:.3f} ms over {n_all}" if n_all
             else "no dispatch"]
    for what, n, sec in kinds:
        k = _stage_sum(m, n)
        if k:
            parts.append(f"{what} {_stage_sum(m, sec) / k * 1e3:.3f} ms x "
                         f"{k}")
    return ", ".join(parts)


def plane_line(m) -> str:
    """A job's compile plane (exec/compilequeue.py): captures, replays,
    eager dispatches, declines by reason, compileTime, and `memory_line`;
    fails on a decline not listed in DECLINES_LISTED."""
    declines = m.graphDeclines()
    unlisted = set(declines) - DECLINES_LISTED
    if unlisted:
        raise AssertionError(f"compile plane declined {declines}: "
                             f"{CQ.declines()}")
    fallbacks = {k: v for s in m.stages for k, v in s.items()
                 if k.startswith("key_fallback_")}
    return (f"plane: captures {m.stageCompileCount()}, replays "
            f"{m.graphReplays()}, eager dispatches "
            f"{_stage_sum(m, 'eager_dispatches')}, declines {declines}, "
            f"key fallbacks {fallbacks}, dedup hits "
            f"{_stage_sum(m, 'dedup_hits')}, compileTime "
            f"{m.compileTime():.3f} s; {memory_line()}")


def memory_line() -> str:
    """The store's memory on the card (its graphs' pools, their share of
    the card, all it holds, its evictions so far) beside the card's peak
    allocated and reserved memory since the previous such line, which the
    eager stages (aggregates, joins, the general tier) share with the
    graphs."""
    dev = torch.device("cuda")
    total = torch.cuda.get_device_properties(dev).total_memory
    pools = CQ.STORE.pool_bytes()
    peak = (torch.cuda.max_memory_allocated(dev),
            torch.cuda.max_memory_reserved(dev))
    torch.cuda.reset_peak_memory_stats(dev)
    return (f"graph pools {pools} B ({pools / total:.4f} of the card) in "
            f"{len(CQ.STORE.pools())}, store {CQ.STORE.nbytes} B in "
            f"{len(CQ.STORE)} graphs, evictions {CQ.STORE.evictions}; "
            f"card peak allocated {peak[0]} B, reserved {peak[1]} B")


def kernel_counts() -> tuple:
    return (nfa_cuda.launches, nfa_cuda.start_launches, RX.calls)


def plane_compare(what: str, make, want, cold) -> None:
    """A job run twice more: through the store again (a warm run: it must
    capture nothing) and under compilequeue.eager() (every partition's
    stage function run eagerly, as before the plane). Each run's rows
    must equal the loop's `want` and its kernel counters (nfa_scan and
    nfa_start launches, anchored engine calls) the cold run's; printed:
    the wall and the host ms per partition dispatch of the cold run
    (`cold` = (wall, metrics, counters)), the warm one and the eager
    one."""
    runs = {"cold store": cold}
    for mode in ("warm store", "eager"):
        ctx = Context()
        nfa_cuda.launches = nfa_cuda.start_launches = RX.calls = 0
        with CQ.eager() if mode == "eager" else contextlib.nullcontext():
            t0 = time.perf_counter()
            got = make(ctx).collect()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        if got != want:
            raise AssertionError(f"{what} ({mode}): {len(got)} rows != the "
                                 f"loop's {len(want)}")
        runs[mode] = (wall, ctx.metrics, kernel_counts())
    if runs["warm store"][1].stageCompileCount() != 0:
        raise AssertionError(f"{what}: the warm run captured "
                             f"{runs['warm store'][1].stageCompileCount()}")
    if len({r[2] for r in runs.values()}) != 1:
        raise AssertionError(f"{what}: kernel counters differ: "
                             f"{ {k: r[2] for k, r in runs.items()} }")
    for mode, (wall, m, counts) in runs.items():
        print(f"  {what}, {mode}: {wall:.3f} s, dispatch host "
              f"{dispatch_ms(m)}; {plane_line(m)}; counters {counts}")


def interpreter_tiers(ctx, ds, what: str, n: int = 20_000) -> str:
    """The first stage's interpreter on the first n rows of its first
    partition, through the generated source tier and through the closure
    tier: microseconds a row each; their results must be equal."""
    stage = plan_stages(ds._op)[0]
    part = source_partitions(ctx, stage.source)[0]
    rows = C.decode_rows(part, range(min(n, part.num_rows)))
    src = stage.python_pipeline(part.user_columns)
    closure = build_python_pipeline(stage.ops)
    if src.__name__ != "_tpx_pipeline":
        raise AssertionError(f"{what}: the stage took no source tier")
    got, src_s = timed(lambda: [src(r) for r in rows])
    want, clo_s = timed(lambda: [closure(r) for r in rows])

    def norm(res):
        return [(st, (p.values, p.columns) if st == "ok" else p)
                for st, p in res]

    if norm(got) != norm(want):
        raise AssertionError(f"{what}: source tier != closure tier")
    return (f"{what} interpreter over {len(rows)} rows of its first stage: "
            f"source tier {src_s / len(rows) * 1e6:.1f} us a row, closure "
            f"tier {clo_s / len(rows) * 1e6:.1f} us a row; results equal")


def same_arrays(a, b, what: str) -> None:
    for x, y in zip(a, b, strict=True):
        if x.dtype != y.dtype or x.shape != y.shape or \
                not np.array_equal(x, y):
            raise AssertionError(f"{what}: native != Python path")


def same_partitions(pa: list, pb: list, what: str) -> None:
    """Equal partitions: sizes, start indices, every leaf's arrays, boxed
    rows and their slots."""
    if len(pa) != len(pb):
        raise AssertionError(f"{what}: {len(pa)} != {len(pb)} partitions")
    for a, b in zip(pa, pb):
        if (a.num_rows, a.start_index, a.fallback, sorted(a.leaves)) != \
                (b.num_rows, b.start_index, b.fallback, sorted(b.leaves)):
            raise AssertionError(f"{what}: partitions differ")
        same_arrays([a.normal_mask if a.normal_mask is not None
                     else np.ones(0, bool)],
                    [b.normal_mask if b.normal_mask is not None
                     else np.ones(0, bool)], what)
        for key, la in a.leaves.items():
            lb = b.leaves[key]
            same_arrays([la.bytes, la.lengths], [lb.bytes, lb.lengths], what)
            if (la.valid is None) != (lb.valid is None):
                raise AssertionError(f"{what}: validity differs")


def results_to_python(make_ds) -> tuple[float, float, int]:
    """(native s, Python-path s, rows) to decode one run's result
    partitions to Python values, the last step of collect(); the two
    decodes must give the same rows."""
    ctx = Context()
    stage = plan_stages(make_ds(ctx)._op)[0]
    res = ctx.backend.execute(
        stage, C.harmonize_partitions(stage.source.load_partitions()))
    rows, nat_s = timed(lambda: [v for p in res.partitions
                                 for v in C.partition_to_pylist(p)])
    with python_path():
        rows_py, py_s = timed(lambda: [v for p in res.partitions
                                       for v in C.partition_to_pylist(p)])
    if rows != rows_py:
        raise AssertionError("results to Python: native != Python path")
    return nat_s, py_s, len(rows)


def zero_native_calls() -> None:
    for k in native.calls:
        native.calls[k] = 0


def native_path_calls(total: dict, need: tuple, what: str) -> dict:
    """Read the native calls of one main-path run (counted from zero), add
    them to `total`, and fail unless each entry point in `need` moved."""
    moved = dict(native.calls)
    for k, v in moved.items():
        total[k] += v
    missing = [k for k in need if not moved[k]]
    if missing:
        raise AssertionError(f"{what}: native {missing} not called")
    return {k: v for k, v in moved.items() if v}


def native_check() -> None:
    """Each native entry point against its Python path on small inputs
    (flat schemas of every kind, boxed rows, invalid UTF-8, CSV and line
    edge cases)."""
    cases = [
        ([1, None, 3, True, 2**64], T.row_of(["x"], [T.option(T.I64)])),
        ([1.5, 2, None], T.row_of(["x"], [T.option(T.F64)])),
        ([True, False, 1], T.row_of(["x"], [T.BOOL])),
        (["a", None, "\u65e5", 3], T.row_of(["x"], [T.option(T.STR)])),
        ([(1, "a", 1.5, True), (None, None, None, None), ("bad", "b", 2.5,
          False), "row", (2**63, "c", 0.5, True)],
         T.row_of(list("ifsb"), [T.option(T.I64), T.option(T.STR),
                                 T.option(T.F64), T.option(T.BOOL)])),
    ]
    for values, schema in cases:
        part = C.build_partition(values, schema)
        got = C.partition_to_pylist(part)
        with python_path():
            slow = C.build_partition(values, schema)
            want = C.partition_to_pylist(slow)
        if got != want or set(part.fallback) != set(slow.fallback):
            raise AssertionError(f"native encode/decode != Python path on "
                                 f"{schema}")
    rows = [b"ab", b"", "\u65e5\u672c".encode(), b"\xff\xfebad", b"x" * 9]
    leaf = C.StrLeaf(
        np.frombuffer(b"".join(r.ljust(9, b"\0") for r in rows),
                      np.uint8).reshape(len(rows), 9),
        np.array([len(r) for r in rows], np.int32))
    got = C._leaf_to_pylist(leaf, len(rows))
    with python_path():
        if got != C._leaf_to_pylist(leaf, len(rows)):
            raise AssertionError("native decode_str != Python path")
    offs = np.concatenate([[0], np.cumsum([len(r) for r in rows])])
    mat, lens, full, w = native.offsets_to_matrix(
        b"".join(rows), offs.astype(np.int64).tobytes(), len(rows), 0, 4)
    if (mat, np.frombuffer(lens, np.int32).tolist(),
            np.frombuffer(full, np.int64).tolist(), w) != \
            (b"".join(r[:4].ljust(4, b"\0") for r in rows),
             [min(len(r), 4) for r in rows], [len(r) for r in rows], 4):
        raise AssertionError("native offsets_to_matrix != its definition")
    data = b'a,b\r\n1,"2"\n\n"3\n4",5\r6,7\n8,"9""",\n'
    for k in (1, 2):
        same_arrays(native.split_csv(data, 44, 34, k, True),
                    csvsource._split_records(data, 44, 34, k, True),
                    "split_csv")
    text = b"a\r\nb\x0bc\n\xff\n\xc2\x85d\re"
    src, starts, lens = csvsource._line_ranges(text)
    if [src[s: s + n] for s, n in zip(starts.tolist(), lens.tolist())] != \
            [ln.encode() for ln in
             text.decode("utf-8", "replace").splitlines()]:
        raise AssertionError("native split_lines != str.splitlines")


def zillow_phase(tmp: str, total_calls: dict) -> None:
    """Z1 on the card against the plain Python loop on the same file."""
    path = os.path.join(tmp, "zillow.csv")
    t0 = time.perf_counter()
    zillow.generate_csv(path, ZILLOW_ROWS, seed=ZILLOW_SEED)
    print(f"zillow: generated {ZILLOW_ROWS} rows, "
          f"{os.path.getsize(path)} bytes, in "
          f"{time.perf_counter() - t0:.2f} s")

    # the CSV source alone, the same work the job does, with the native
    # module and with the numpy path; their outputs must be equal
    stat = Context().csv(path)._op.parent.stat
    opts = Context().options_store
    t0 = time.perf_counter()
    with open(path, "rb") as fp:
        data = fp.read()
    read_s = time.perf_counter() - t0
    args = (data, ord(stat.delimiter), ord(stat.quotechar),
            stat.num_columns, stat.has_header)
    split, split_s = timed(lambda: native.split_csv(*args))
    split_py, split_py_s = timed(lambda: csvsource._split_records(*args))
    same_arrays(split, split_py, "zillow split")
    del split, split_py
    parts, parts_s = timed(
        lambda: list(csvsource.csv_partitions(data, stat, opts)))
    with python_path():
        parts_py, parts_py_s = timed(
            lambda: list(csvsource.csv_partitions(data, stat, opts)))
    same_partitions(parts, parts_py, "zillow partitions")
    print(f"zillow CSV source: read {read_s:.3f} s; native / numpy path: "
          f"split {split_s:.3f} / {split_py_s:.3f} s, byte matrices "
          f"{parts_s - split_s:.3f} / {parts_py_s - split_py_s:.3f} s "
          f"(split and matrices {parts_s:.3f} / {parts_py_s:.3f} s) -> "
          f"{len(parts)} partitions, "
          f"{sum(len(p.fallback) for p in parts)} boxed rows; split arrays "
          f"and partitions equal")
    del data, parts, parts_py

    t0 = time.perf_counter()
    want = zillow.run_reference_python(path)
    ref_s = time.perf_counter() - t0
    want_excs = zillow.exception_counts_python(path)
    ctx = Context()
    zero_native_calls()
    nfa_cuda.launches = nfa_cuda.start_launches = RX.calls = 0
    t0 = time.perf_counter()
    ds = zillow.build_pipeline(ctx.csv(path))
    got = ds.collect()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    calls = native_path_calls(total_calls, ("split_csv", "gather_rows",
                                            "decode_columns"), "zillow")
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
    resolved = m.interpreterRows() + m.generalRows() + m.exactExitRows()
    if not 0 < resolved == m.deviceErrorRows() < ZILLOW_ROWS // 10 or \
            not m.exactExitRows():
        raise AssertionError(f"zillow: {tier_line(m)}, device error rows "
                             f"{m.deviceErrorRows()}")
    if ds.exception_counts() != want_excs:
        raise AssertionError(f"zillow: exceptions {ds.exception_counts()} "
                             f"!= python {want_excs}")
    print(f"zillow Z1: {ZILLOW_ROWS} rows -> {len(got)} rows in "
          f"{wall:.3f} s ({ZILLOW_ROWS / wall:.0f} rows/s; python loop "
          f"{ref_s:.3f} s), exceptions {ds.exception_counts()} (python "
          f"{want_excs}), {tier_line(m)}, device error rows "
          f"{m.deviceErrorRows()}, fast path {m.fastPathWallTime():.3f} s, "
          f"backend "
          f"{m.totalWallTime():.3f} s (fast + slow + merge), outside the "
          f"backend {wall - m.totalWallTime():.3f} s (sniff, CSV source, "
          f"results to Python); native calls {calls}")
    plane_compare("zillow Z1", lambda c: zillow.build_pipeline(c.csv(path)),
                  want, (wall, m, kernel_counts()))
    ctx = Context()
    print(interpreter_tiers(ctx, zillow.build_pipeline(ctx.csv(path)),
                            "zillow"))
    nat_s, py_s, n_rows = results_to_python(
        lambda c: zillow.build_pipeline(c.csv(path)))
    print(f"zillow results to Python ({n_rows} rows): native {nat_s:.3f} s, "
          f"Python path {py_s:.3f} s; rows equal")
    os.remove(path)


def close(a: float, b: float) -> bool:
    return abs(a - b) <= REL_TOL * abs(b)


def query_line(name: str, ctx, wall: float, loop_s: float) -> str:
    """One run's times: collect() wall beside the plain loop's, and the
    stages' split."""
    m = ctx.metrics
    first, agg = m.stages[0], m.stages[-1]
    return (f"{name}: collect() {wall:.3f} s (python loop {loop_s:.3f} s); "
            f"transform stage {first['wall_s']:.3f} s (fast path "
            f"{first['fast_path_s']:.3f} s, {first['fetch_bytes']} bytes "
            f"fetched, {first['fetched_row_columns']} row columns), "
            f"aggregate stage {agg['wall_s']:.3f} s ({agg['device_rows']} "
            f"rows on the card); outside the backend "
            f"{wall - m.totalWallTime():.3f} s (sniff, CSV source, results "
            f"to Python); {tier_line(m)}, rows folded on the host "
            f"{m.hostFoldedRows()}")


def stage_kind(s: dict) -> str:
    return "join" if "host_probed_rows" in s else \
        "aggregate" if "device_rows" in s else "transform"


def handoff_lines(name: str, m) -> None:
    """One line per stage of a job (its build sides' plans included, in
    the order they ran): partitions handed off on the card, partitions
    sent by the host route and why, bytes copied each way, lazy leaves
    fetched whole."""
    for i, s in enumerate(m.stages):
        print(f"  {name} stage {i} ({stage_kind(s)}): handoff parts "
              f"{s['handoff_parts']}, host route parts "
              f"{s['host_route_parts']} (budget {s['host_route_budget']}, "
              f"no layout {s['host_route_no_layout']}, no consumer "
              f"{s['host_route_no_consumer']}), h2d {s['h2d_bytes']} "
              f"bytes, d2h {s['d2h_bytes']} bytes, forced leaves "
              f"{s['forced_leaves']}, wall {s['wall_s']:.3f} s")


def intermediate(m) -> list:
    """The stages whose output partitions have a consumer on the card:
    not the last of a plan (the job's or a build side's), nor one with a
    fused fold (its output is the fold's partials)."""
    return [s for s in m.stages if s["host_route_no_consumer"] == 0
            and s["handoff_parts"] + s["host_route_parts"] > 0]


def check_clean_handoff(name: str, m) -> None:
    """A job with no slow path: every partition of every intermediate
    stage handed off on the card, and no data column fetched (the
    producers fetched control arrays only, no lazy leaf was fetched)."""
    mid = intermediate(m)
    if not mid or any(s["handoff_parts"] == 0 or s["host_route_parts"] or
                      s.get("fetched_row_columns", 0) for s in mid) or \
            any(s["forced_leaves"] for s in m.stages):
        raise AssertionError(f"{name}: a partition of an intermediate "
                             "stage took the host route or fetched a data "
                             "column (the stage lines above)")


def budget0_runs(name: str, make, want, wall: float):
    """After the job's run with the handoff (`wall` s, rows `want`), the
    job `make(ctx)` twice with the backend's handoff budget at 0 (every
    partition by the host route), then once more with the handoff: the
    two routes in the order A B B A. Every run's rows must equal `want`.
    Prints the four wall times and each route's bytes copied. Returns the
    last budget-0 run's DataSet."""
    walls = {"handoff": [wall], "budget 0": []}
    copied = {}
    for budget in (0, 0, None):
        ctx = Context()
        route = "handoff" if budget is None else "budget 0"
        if budget is not None:
            ctx.backend.handoff_budget = budget
        t0 = time.perf_counter()
        ds = make(ctx)
        got = ds.collect()
        torch.cuda.synchronize()
        walls[route].append(time.perf_counter() - t0)
        if got != want:
            raise AssertionError(f"{name}: a {route} run's rows differ "
                                 "from the first run's")
        if budget is not None and any(s["handoff_parts"]
                                      for s in ctx.metrics.stages):
            raise AssertionError(f"{name}: a partition handed off at "
                                 "budget 0")
        copied[route] = (ctx.metrics.h2dBytes(), ctx.metrics.d2hBytes())
        if budget is not None:
            ds0 = ds
    print(f"{name}: handoff runs " + " / ".join(
        f"{w:.3f}" for w in walls["handoff"]) + " s, budget-0 runs " +
        " / ".join(f"{w:.3f}" for w in walls["budget 0"]) +
        " s (run in the order handoff, budget 0, budget 0, handoff), rows "
        f"equal; h2d / d2h bytes with the handoff {copied['handoff'][0]} / "
        f"{copied['handoff'][1]}, at budget 0 {copied['budget 0'][0]} / "
        f"{copied['budget 0'][1]}")
    return ds0


def copy_split(name: str, make) -> None:
    """The job once with the handoff and once at budget 0, every copy
    timed (runtime/xferstats.py TIMED): each stage's wall time split into
    copies, waiting for the card before a copy, and host work."""
    for budget in (None, 0):
        ctx = Context()
        if budget is not None:
            ctx.backend.handoff_budget = budget
        xferstats.TIMED = True
        try:
            make(ctx).collect()
            torch.cuda.synchronize()
        finally:
            xferstats.TIMED = False
        route = "handoff" if budget is None else "budget 0"
        for i, s in enumerate(ctx.metrics.stages):
            w, c, q = s["wall_s"], s["copy_s"], s["wait_s"]
            print(f"  {name} ({route}, copies timed) stage {i} "
                  f"({stage_kind(s)}): wall {w:.3f} s = copies {c:.3f} s "
                  f"+ waiting for the card {q:.3f} s + host work "
                  f"{w - c - q:.3f} s; h2d {s['h2d_bytes']} bytes, d2h "
                  f"{s['d2h_bytes']} bytes")


def tpch_phase(tmp: str, total_calls: dict) -> tuple[str, str]:
    """Q6 and Q1 on the card against the plain loops on the same file.
    Returns the lineitem file and the dirty file, which phase 12 reads."""
    path = os.path.join(tmp, "lineitem.csv")
    t0 = time.perf_counter()
    tpch.generate_csv(path, TPCH_ROWS, seed=TPCH_SEED)
    print(f"tpch: generated {TPCH_ROWS} lineitem rows, "
          f"{os.path.getsize(path)} bytes, in "
          f"{time.perf_counter() - t0:.2f} s")
    rows, read_s = timed(lambda: tpch.read_lineitem_csv(path))
    want6, q6_s = timed(lambda: tpch.q6_python(rows))
    want1, q1_s = timed(lambda: tpch.q1_python(rows))
    del rows
    for name, query in (("q6", tpch.q6), ("q1", tpch.q1)):
        first = plan_stages(query(Context().csv(path))._op)[0]
        parts, src_s = timed(first.source.load_partitions)
        print(f"{name} CSV source: read, split and byte matrices of "
              f"{len(first.source.schema().columns)} of 7 columns in "
              f"{src_s:.3f} s -> {len(parts)} partitions")
        del parts
    q6_bits = set()
    for run in (1, 2):
        ctx = Context()
        zero_native_calls()
        t0 = time.perf_counter()
        ds = tpch.q6(ctx.csv(path))
        (got,) = ds.collect()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        native_path_calls(total_calls, ("split_csv", "gather_rows"), "q6")
        m = ctx.metrics
        if not close(got, want6) or ds.exception_counts():
            raise AssertionError(f"q6: {got!r} != python {want6!r}, "
                                 f"exceptions {ds.exception_counts()}")
        if m.stages[0]["tier"] != "compiled" or \
                m.stages[0]["fetched_row_columns"] or m.interpreterRows() \
                or m.hostFoldedRows():
            raise AssertionError(f"q6: stage {m.stages[0]}, interpreter "
                                 f"rows {m.interpreterRows()}, host-folded "
                                 f"rows {m.hostFoldedRows()}")
        q6_bits.add(got.hex())
        print(query_line(f"q6 run {run}", ctx, wall, read_s + q6_s) +
              f"; revenue {got!r} (python {want6!r})")
        handoff_lines(f"q6 run {run}", m)
    if len(q6_bits) != 1:
        raise AssertionError(f"q6: two runs gave {q6_bits}")
    wall, busy, _ = device_busy(lambda: tpch.q6(Context().csv(path))
                                .collect())
    print(f"q6 under torch.profiler: {wall:.3f} s, device busy {busy:.4f} "
          f"s, idle share {1 - busy / wall:.4f}")
    q1_bits = set()
    for run in (1, 2):
        ctx = Context()
        t0 = time.perf_counter()
        ds = tpch.q1(ctx.csv(path))
        got = ds.collect()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        keys = [r[:2] for r in got]
        if keys != list(want1) or ds.exception_counts() or \
                ctx.metrics.interpreterRows() or \
                ctx.metrics.hostFoldedRows() or any(
                    r[5] != want1[r[:2]][3] or
                    not all(close(a, b) for a, b in
                            zip(r[2:5], want1[r[:2]][:3])) for r in got):
            raise AssertionError(f"q1: {got} != python {want1}")
        q1_bits.add(repr([tuple(v.hex() if isinstance(v, float) else v
                                for v in r) for r in got]))
        print(query_line(f"q1 run {run}", ctx, wall, read_s + q1_s) +
              f"; {len(got)} groups in first-occurrence order")
        handoff_lines(f"q1 run {run}", ctx.metrics)
        check_clean_handoff("q1", ctx.metrics)
    if len(q1_bits) != 1:
        raise AssertionError("q1: the two runs differ")
    budget0_runs("q1", lambda c: tpch.q1(c.csv(path)), got, wall)

    dirty = os.path.join(tmp, "dirty.csv")
    tpch.generate_dirty_csv(dirty, 2000, seed=TPCH_SEED)
    rows = tpch.read_lineitem_dicts(dirty)
    want, excs = tpch.q6_python_counting(rows)
    ctx6 = Context()
    ds = tpch.q6(ctx6.csv(dirty))
    (got,) = ds.collect()
    if not close(got, want) or ds.exception_counts() != excs or \
            ctx6.metrics.interpreterRows():
        raise AssertionError(f"dirty q6: {got}, {ds.exception_counts()} != "
                             f"python {want}, {excs}; "
                             f"{tier_line(ctx6.metrics)}")
    want1, excs1 = tpch.q1_python_counting(rows)
    ctx1 = Context()
    ds = tpch.q1(ctx1.csv(dirty))
    got1 = ds.collect()
    if [r[:2] for r in got1] != list(want1) or \
            ds.exception_counts() != excs1 or any(
                r[5] != want1[r[:2]][3] or not all(
                    close(a, b) for a, b in zip(r[2:5], want1[r[:2]][:3]))
                for r in got1):
        raise AssertionError(f"dirty q1: {got1}, {ds.exception_counts()} "
                             f"!= python {want1}, {excs1}")
    if ctx1.metrics.interpreterRows():
        raise AssertionError(f"dirty q1: {tier_line(ctx1.metrics)}")
    print(f"tpch dirty cells (2000 rows): q6 exceptions {excs}, q1 "
          f"exceptions {excs1}, rows equal to the python loop's; q6 "
          f"{tier_line(ctx6.metrics)}; q1 {tier_line(ctx1.metrics)}")
    return path, dirty


def nyc311_phase(tmp: str) -> None:
    path = os.path.join(tmp, "311.csv")
    nyc311.generate_csv(path, NYC311_ROWS, seed=NYC311_SEED)
    want, loop_s = timed(lambda: nyc311.run_reference_python(path))
    ctx = Context()
    t0 = time.perf_counter()
    got = nyc311.build_pipeline(ctx, path).collect()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if got != want:
        raise AssertionError(f"nyc311: {got} != python {want}")
    print(query_line(f"nyc311 ({NYC311_ROWS} rows -> {len(got)} distinct "
                     f"zip codes)", ctx, wall, loop_s))
    handoff_lines("nyc311", ctx.metrics)
    check_clean_handoff("nyc311", ctx.metrics)
    budget0_runs("nyc311", lambda c: nyc311.build_pipeline(c, path), got,
                 wall)
    os.remove(path)


def key_words(rng, n: int, width: int, leaf_width: int, dev,
              pick_from=None):
    """Key words of n string keys through the join's own signature
    (exec/joinexec.py KeyLayout at `width` bytes with a valid byte): keys
    of 3..width uppercase letters in a `leaf_width`-wide matrix with
    stale bytes past each length (a wider matrix is cut to `width`), 1% of
    them None. With `pick_from` (bytes, lens), about half the keys are
    drawn from it. Returns (words, bytes, lens)."""
    b = rng.integers(65, 91, size=(n, leaf_width), dtype=np.uint8)
    lens = rng.integers(3, width + 1, size=n).astype(np.int32)
    if pick_from is not None:
        take = rng.random(n) < 0.5
        src = rng.integers(0, len(pick_from[1]), size=int(take.sum()))
        b[take, :width] = pick_from[0][src]
        lens[take] = pick_from[1][src]
    valid = rng.random(n) >= 0.01
    layout = KeyLayout(T.STR, width, has_valid=True)
    key, _ = layout.key_leaf(C.StrLeaf(b, lens, valid), {}, n, dev)
    return layout.words(key, dev), b, lens


def probe_phase(rng, u: int, width: int, dev):
    """The kernel against its plain version on u distinct build keys and
    PROBES probe keys (about half matching, probe matrix 4 bytes wider
    than the build's); times both and torch.searchsorted on the first
    words. Returns (largest difference, numbers)."""
    words, b, lens = key_words(rng, u * 5 // 4, width, width, dev)
    flat = torch.unique(J.flip(words), dim=0)     # sorted, unique
    keep = torch.randperm(len(flat), device=dev)[:u].sort().values
    build = J.flip(flat[keep]).contiguous()
    probe, _, _ = key_words(rng, PROBES, width, width + 4, dev,
                            pick_from=(b, lens))
    return time_probe(probe, build, f"{u} string keys")


def int_probe_phase(rng, u: int, dev):
    """The same on one-word keys: u distinct int keys drawn from 1..4u
    through the join's own signature (exec/joinexec.py KeyLayout), PROBES
    probes of which about half are build keys."""
    layout = KeyLayout(T.I64, 0, has_valid=False)

    def sig(vals):
        leaf, _ = layout.key_leaf(C.NumericLeaf(vals.astype(np.int64)), {},
                                  len(vals), dev)
        return layout.words(leaf, dev)

    vals = rng.choice(4 * u, size=u, replace=False) + 1
    build = J.flip(torch.unique(J.flip(sig(vals)), dim=0)).contiguous()
    pv = np.where(rng.random(PROBES) < 0.5, rng.choice(vals, PROBES),
                  rng.integers(1, 4 * u + 1, PROBES))
    return time_probe(sig(pv).contiguous(), build, f"{u} int keys")


def time_probe(words: torch.Tensor, build: torch.Tensor, what: str):
    """join_probe's kernel against its plain version on the card (exact),
    and the times of the kernel, of its table copy alone, of the plain
    version, of torch.searchsorted on the first words (for one-word keys
    the same lower bound, without the equality flag), of the index's
    build, and the bound: probe words and the table read once, 9 bytes a
    row written, at the device memory rate."""
    index = J.probe_index(build)
    before = join_cuda.launches
    pos, matched = J.join_probe(words, index)
    want_pos, want_m = J.lower_bound_plain(words, build)
    torch.cuda.synchronize()
    if join_cuda.launches != before + 1:
        raise AssertionError(f"join_probe on {what}: no kernel launch")
    err = int((pos - want_pos).abs().max()) + int(
        (matched != want_m).sum())
    if err:
        raise AssertionError(f"join_probe kernel != plain on {what}")
    b, nw = words.shape
    u = build.shape[0]
    ms, host_ms = kernel_device_ms(lambda: J.join_probe(words, index), 50)
    copy_ms, _ = kernel_device_ms(
        lambda: join_cuda.probe(words, index, copy_only=True), 50)
    plain_ms = cuda_ms(lambda: J.lower_bound_plain(words, build), 3)
    index_ms = cuda_ms(lambda: J.probe_index(build), 5)
    one = J.flip(build[:, 0]).sort().values
    first = J.flip(words[:, 0]).contiguous()
    lib_ms, _ = kernel_device_ms(lambda: torch.searchsorted(one, first), 50)
    bound_ms = (b * nw * 8 + u * nw * 8 + 9 * b) / HBM_BYTES_PER_S * 1e3
    lib = "the same keys" if nw == 1 else \
        f"the first words only ({nw} words a key)"
    print(f"join_probe at [{b}, {nw}] probes into [{u}, {nw}] build words "
          f"({what}; index: fences every {1 << index.group_shift} keys, "
          f"{index.bits} radix bits, {(index.radix_words + index.fence_words) * 8}"
          f" bytes in shared memory, built in {index_ms:.4f} ms): "
          f"{int(matched.sum())} matched; kernel {ms:.4f} ms (its table "
          f"copy alone {copy_ms:.4f} ms; {host_ms:.4f} ms of host time per "
          f"wrapper call), plain {plain_ms:.4f} ms, torch.searchsorted on "
          f"{lib} {lib_ms:.4f} ms, bound {bound_ms:.4f} ms; kernel == plain")
    return err, {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                 "library_ms": lib_ms if nw == 1 else None}


def recording_probes(inputs: list):
    """Records every (words, build words) the join hands the kernel."""
    return recording(join_cuda, "probe", inputs,
                     lambda words, index, **kw: (words, index.words))


def flights_phase(tmp: str):
    """Flights on the card against the plain loop on the same files.
    Returns (kernel launches in the pipeline's run, the probe inputs the
    path gave the kernel, (the files, the loop's rows and exceptions, the
    run's wall) for phase 13)."""
    paths = [os.path.join(tmp, n) for n in
             ("perf.csv", "carrier.csv", "airports.txt")]
    t0 = time.perf_counter()
    flights.generate_perf_csv(paths[0], FLIGHTS_ROWS, seed=FLIGHTS_SEED)
    flights.generate_carrier_csv(paths[1])
    flights.generate_airport_db(paths[2])
    print(f"flights: generated {FLIGHTS_ROWS} perf rows, "
          f"{os.path.getsize(paths[0])} bytes, in "
          f"{time.perf_counter() - t0:.2f} s")
    excs: dict = {}
    want, loop_s = timed(lambda: flights.run_reference_python(
        *paths, exceptions=excs))
    violations = decode_violations(paths[0], flights.build_pipeline(
        Context(), *paths))
    inputs = []
    ctx = Context()
    with recording_probes(inputs):
        join_cuda.launches = 0
        t0 = time.perf_counter()
        ds = flights.build_pipeline(ctx, *paths)
        got = ds.collect()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = join_cuda.launches
    d = flights.OUTPUT_COLS.index("Distance")
    if got != want or [r[d].hex() for r in got] != \
            [r[d].hex() for r in want]:
        bad = next((i for i, (g, w) in enumerate(zip(got, want))
                    if g != w or g[d].hex() != w[d].hex()),
                   min(len(got), len(want)))
        raise AssertionError(f"flights: {len(got)} rows != python "
                             f"{len(want)} rows; first difference at {bad}")
    if ds.exception_counts() != excs:
        raise AssertionError(f"flights: exceptions {ds.exception_counts()} "
                             f"!= python {excs}")
    m = ctx.metrics
    joins = [s for s in m.stages if "host_probed_rows" in s]
    if len(joins) != 3 or any(s["host_probed_rows"] for s in joins):
        raise AssertionError(f"flights: joins {joins}")
    if launches <= 0:
        raise AssertionError("flights did not launch the join probe kernel")
    first = m.stages[0]
    if not first["device_error_rows"] == violations == \
            first["general_rows"] or first["interpreter_rows"]:
        raise AssertionError(f"flights: {violations} decode violations, "
                             f"first stage {first}")
    print(f"flights: {FLIGHTS_ROWS} rows -> {len(got)} rows in {wall:.3f} s "
          f"({FLIGHTS_ROWS / wall:.0f} rows/s; python loop {loop_s:.3f} s), "
          f"exceptions {ds.exception_counts()} (python {excs}), ignored "
          f"rows {m.ignoredRows()}, {tier_line(m)}; the first stage's "
          f"{violations} decode violations all finished by the general "
          f"tier; fast path {m.fastPathWallTime():.3f} s, backend "
          f"{m.totalWallTime():.3f} s; join_probe launches {launches}")
    ctx = Context()
    print(interpreter_tiers(ctx, flights.build_pipeline(ctx, *paths),
                            "flights"))
    for i, s in enumerate(m.stages):
        print(f"  flights stage {i}: " + ", ".join(
            f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in s.items()))
    handoff_lines("flights", m)
    # the stages before the three joins, the defunct filter's stage pushed
    # between the first two, and the first two joins
    if len(intermediate(m)) != 5 or any(
            s["handoff_parts"] == 0 for s in intermediate(m)):
        raise AssertionError("flights: an intermediate stage handed off "
                             "no partition")
    ds0 = budget0_runs("flights",
                       lambda c: flights.build_pipeline(c, *paths), got,
                       wall)
    if ds0.exception_counts() != excs:
        raise AssertionError(f"flights at budget 0: exceptions "
                             f"{ds0.exception_counts()} != python {excs}")
    copy_split("flights", lambda c: flights.build_pipeline(c, *paths))
    return launches, inputs, (paths, want, excs, wall)


def decode_violations(path: str, ds) -> int:
    """Rows of a CSV file with a filled cell in a column its first stage's
    decode declares null (the sample saw it empty)."""
    import csv

    dec = plan_stages(ds._op)[0].ops[0]
    cols = [c for c, t in zip(dec.declared.columns, dec.declared.types)
            if t is T.NULL]
    with open(path, newline="") as fp:
        r = csv.reader(fp)
        head = next(r)
        idx = [head.index(c) for c in cols]
        return sum(any(rec[i] for i in idx) for rec in r)


def widened_phase(tmp: str) -> None:
    """The widened-column CSV on the card against the plain loop: every
    filled row leaves the fast path at the decode and the general-case
    tier finishes it."""
    path = os.path.join(tmp, "widened.csv")
    t0 = time.perf_counter()
    filled = widened.generate_csv(path, WIDENED_ROWS, seed=WIDENED_SEED)
    print(f"widened: generated {WIDENED_ROWS} rows ({filled} with c "
          f"filled), {os.path.getsize(path)} bytes, in "
          f"{time.perf_counter() - t0:.2f} s")
    want, loop_s = timed(lambda: widened.run_reference_python(path))
    ctx = Context()
    t0 = time.perf_counter()
    ds = widened.build_pipeline(ctx.csv(path))
    got = ds.collect()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    m = ctx.metrics
    if got != want or ds.exception_counts():
        raise AssertionError(f"widened: {len(got)} rows != python "
                             f"{len(want)}, exceptions "
                             f"{ds.exception_counts()}")
    if not m.deviceErrorRows() == m.generalRows() == filled or \
            m.interpreterRows() or m.exactExitRows():
        raise AssertionError(f"widened: {filled} filled rows, "
                             f"{tier_line(m)}")
    print(f"widened: {WIDENED_ROWS} rows -> {len(got)} rows in {wall:.3f} s "
          f"(python loop {loop_s:.3f} s), {tier_line(m)}, fast path "
          f"{m.fastPathWallTime():.3f} s, backend {m.totalWallTime():.3f} s")
    os.remove(path)


def q19_phase(tmp: str):
    """Q19 on the card, twice, against the plain loop. Returns (kernel
    launches in the two runs, the probe inputs the path gave the
    kernel)."""
    part, li = os.path.join(tmp, "part.csv"), os.path.join(tmp, "li.csv")
    t0 = time.perf_counter()
    tpch.generate_q19_csvs(part, li, Q19_PARTS, Q19_ITEMS, seed=Q19_SEED)
    print(f"q19: generated {Q19_PARTS} parts and {Q19_ITEMS} lineitems in "
          f"{time.perf_counter() - t0:.2f} s")
    want, loop_s = timed(lambda: tpch.run_reference_q19(part, li))
    bits = set()
    inputs, launches = [], 0
    for run in (1, 2):
        ctx = Context()
        with recording_probes(inputs):
            join_cuda.launches = 0
            t0 = time.perf_counter()
            ds = tpch.q19(ctx, part, li)
            (got,) = ds.collect()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches += join_cuda.launches
        m = ctx.metrics
        (join,) = [s for s in m.stages if "host_probed_rows" in s]
        if not close(got, want) or ds.exception_counts() or \
                join["host_probed_rows"] or m.interpreterRows():
            raise AssertionError(f"q19: {got!r} != python {want!r}, "
                                 f"exceptions {ds.exception_counts()}, "
                                 f"join {join}, interpreter rows "
                                 f"{m.interpreterRows()}")
        handoff_lines(f"q19 run {run}", m)
        check_clean_handoff("q19", m)
        bits.add(got.hex())
        print(f"q19 run {run}: collect() {wall:.3f} s (python loop "
              f"{loop_s:.3f} s); revenue {got!r} (python {want!r}); join "
              f"stage {join['wall_s']:.3f} s (build {join['build_s']:.3f} "
              f"s, {join['build_keys']} keys of {join['key_words']} word, "
              f"{join['device_probed_rows']} rows probed on the card, "
              f"{join['host_probed_rows']} on the host, {join['rows_out']} "
              f"out); stages " + " / ".join(
                  f"{s['wall_s']:.3f}" for s in m.stages) + " s")
    if len(bits) != 1:
        raise AssertionError(f"q19: two runs gave {bits}")
    if launches <= 0:
        raise AssertionError("q19 did not launch the join probe kernel")
    budget0_runs("q19", lambda c: tpch.q19(c, part, li), [got], wall)
    copy_split("q19", lambda c: tpch.q19(c, part, li))
    print(f"q19: join_probe launches {launches} in two runs")
    os.remove(part)
    os.remove(li)
    return launches, inputs


def fold_short(a, x):
    """The seeded batches' short fold: 4 instructions."""
    return a + x


def fold_long(a, x):
    """The seeded batches' long fold: a condition, min, float floor
    division and an int leaf."""
    if x[1]:
        return (min(a[0] * 0.999 + x[0], a[0] // x[2]), a[1] + 1)
    return a


def fold_batch(rng, prog, nseg: int, dev):
    """seg_fold's inputs for FOLD_ROWS seeded rows in `nseg` segments, on
    the card: float terms (x[2] small ints as floats, zeros among them,
    so the program's floor division raises), a bool term (x[1]); 0.02% of
    each term's rows raise an exact class; in odd segments 0.002% carry an
    internal code and 0.02% a None (both stop their segment), and 1% of
    the segments have a limit row."""
    n = FOLD_ROWS
    codes = rng.integers(0, nseg, n)
    odd = codes % 2 == 1
    vals = np.zeros((len(prog.terms), n), dtype=np.int64)
    metas = np.zeros((len(prog.terms), n), dtype=np.int32)
    for t, term in enumerate(prog.terms):
        src = ast.unparse(term.expr)
        if src == "x[1]":
            vals[t], tag = rng.random(n) < 0.7, SF.TAG_BOOL
        else:
            f = rng.integers(-3, 4, n).astype(np.float64) \
                if src == "x[2]" else rng.uniform(-100.0, 100.0, n)
            vals[t], tag = f.view(np.int64), SF.TAG_FLOAT
        u = rng.random(n)
        meta = np.full(n, tag << 8, dtype=np.int32)
        meta[u < 2e-4] |= 2                                  # ValueError
        meta[odd & (u >= 2e-4) & (u < 2.2e-4)] |= SF.INTERNAL_CLASS
        meta[odd & (u >= 3e-4) & (u < 5e-4)] = SF.TAG_NONE << 8
        metas[t] = meta
    limits = np.full(nseg, n, dtype=np.int64)
    few = (rng.random(nseg) < 0.01) & (nseg > 1)
    limits[few] = rng.integers(0, n, int(few.sum()))
    seeds = rng.uniform(-10.0, 10.0, (nseg, prog.n_leaves)).view(np.int64)
    tags = np.full((nseg, prog.n_leaves), SF.TAG_FLOAT, dtype=np.int8)
    if prog.n_leaves > 1:
        seeds[:, 1] = rng.integers(0, 5, nseg)
        tags[:, 1] = SF.TAG_INT
    order, offsets = SF.segment_layout(
        torch.from_numpy(codes).to(dev), nseg)
    put = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
           for a in (vals, metas, limits, seeds, tags)]
    return put[0], put[1], order, offsets, put[2], put[3], put[4]


def fold_kernel(prog, inputs, what: str, op_ns: float,
                reps: int = 3) -> dict:
    """seg_fold's kernel against its plain version on the same inputs on
    the card (every output equal), and the times of both. Two bounds: the
    memory bound (each folded row's terms, 8-byte payload and 4-byte meta
    word, and its place in `order` read once, the segment table read once,
    the statuses and the segments' outputs written once, at the device
    memory rate) and the serial bound (the longest segment's folded rows
    times the program's chain of dependent arithmetic through the
    accumulator times `op_ns`, one dependent FP64 operation)."""
    t0 = time.perf_counter()
    want = SF.seg_fold_plain(prog, *inputs)
    plain_ms = (time.perf_counter() - t0) * 1e3
    before = segfold_cuda.launches
    got = segfold_cuda.seg_fold(prog, *inputs)
    torch.cuda.synchronize()
    if segfold_cuda.launches != before + 1:
        raise AssertionError(f"seg_fold on {what}: no kernel launch")
    fields = ("acc", "acc_tags", "first", "count", "stop", "status")
    bad = [f for f in fields
           if not torch.equal(getattr(got, f), getattr(want, f))]
    if bad:
        raise AssertionError(f"seg_fold kernel != plain on {what}: {bad}")
    ms, host_ms = kernel_device_ms(
        lambda: segfold_cuda.seg_fold(prog, *inputs), reps)
    vals, _, order, offsets, _, seeds, _ = inputs
    nterm, b = vals.shape
    m = order.shape[0]
    nseg, nleaf = seeds.shape
    bytes_ = m * (12 * nterm + 8) + nseg * (16 + 9 * nleaf) + b + \
        nseg * (24 + 9 * nleaf)
    bound_ms = bytes_ / HBM_BYTES_PER_S * 1e3
    dec = SF.decoded(prog, nleaf)
    longest = int(want.count.max()) if nseg else 0
    serial_ms = longest * dec.chain * op_ns * 1e-6
    n_warp, n_thread = segfold_cuda.layout_counts(offsets.cpu())
    key = (what.split("(")[-1].rstrip(")"), nseg) if "(" in what \
        else (what, nseg)
    earlier = EARLIER_FOLD_MS.get(key)
    st = got.status
    print(f"seg_fold on {what}: {m} rows in {nseg} segments "
          f"({n_warp} on a warp each, {n_thread} on a thread each), "
          f"{len(prog)}-instruction program decoded to {len(dec)}, "
          f"{nterm} terms: {int((st == SF.ST_FOLDED).sum())} folded, "
          f"{int((st >= SF.ST_EXC).sum())} exceptions, "
          f"{int((got.stop >= 0).sum())} segments stopped "
          f"({int((st == SF.ST_HOST).sum())} rows for the host); kernel "
          f"{ms:.4f} ms (PR 15's kernel {earlier} ms; {host_ms:.4f} ms of "
          f"host time per wrapper call), plain {plain_ms:.1f} ms, memory "
          f"bound {bound_ms:.4f} ms ({bytes_} bytes), serial bound "
          f"{serial_ms:.4f} ms ({longest} rows x chain {dec.chain} x "
          f"{op_ns:.3f} ns); kernel == plain")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "serial_bound_ms": serial_ms}


def recording_folds(inputs: list):
    """Records every (program, arguments) the aggregate stage hands the
    general fold's kernel."""
    return recording(segfold_cuda, "seg_fold", inputs,
                     lambda prog, *args: (prog, args))


def fold_phase(path: str, dirty: str, dev) -> tuple[int, dict]:
    """The general fold's kernel on seeded batches, then G1-G3 on the
    card against the plain loops. Returns (kernel launches in G1-G3's runs
    on the clean file, the kernel's numbers on G2's largest input)."""
    op_ns, op_cycles = segfold_cuda.calibrate(dev)
    print(f"seg_fold calibration: a dependent FP64 operation (__dmul_rn, "
          f"__dadd_rn chain on one thread) takes {op_ns:.3f} ns, "
          f"{op_cycles:.2f} cycles")
    rng = np.random.default_rng(11)
    for fn, n_leaves, scalar in ((fold_short, 1, True),
                                 (fold_long, 2, False)):
        prog = lower_fold(get_udf_source(fn), n_leaves, scalar)
        for nseg in FOLD_SEGMENTS:
            fold_kernel(prog, fold_batch(rng, prog, nseg, dev),
                        f"a seeded batch ({fn.__name__})", op_ns)
    rows, read_s = timed(lambda: tpch.read_lineitem_dicts(path))
    print(f"general folds: read {len(rows)} lineitem rows as dicts for "
          f"the loops in {read_s:.3f} s")
    launches = 0
    recorded: list = []
    for job in ("g1", "g2", "g3"):
        (want, excs), loop_s = timed(lambda: tpch.fold_python(rows, job))
        ctx = Context()
        segfold_cuda.launches = 0
        with recording_folds(recorded if job == "g2" else []):
            t0 = time.perf_counter()
            ds = getattr(tpch, "fold_" + job)(ctx.csv(path))
            got = ds.collect()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        n = segfold_cuda.launches
        launches += n
        m = ctx.metrics
        agg = m.stages[-1]
        forced = sum(st.get("forced_leaves", 0) for st in m.stages)
        if repr(got) != repr(want) or ds.exception_counts() != excs:
            raise AssertionError(f"{job}: {len(got)} rows != the loop's "
                                 f"{len(want)}, or exceptions "
                                 f"{ds.exception_counts()} != {excs}")
        if n <= 0 or m.hostFoldedRows() or forced or m.interpreterRows():
            raise AssertionError(f"{job}: {n} seg_fold launches, "
                                 f"{m.hostFoldedRows()} rows folded on the "
                                 f"host, {forced} lazy leaves fetched whole")
        print(f"general fold {job}: {len(rows)} rows -> {len(got)} groups "
              f"in {wall:.3f} s (python loop {loop_s:.3f} s), equal to the "
              f"loop bit for bit; seg_fold launches {n}, aggregate stage "
              f"{agg['wall_s']:.3f} s ({agg['device_rows']} rows on the "
              f"card, {agg['scan_rows']} in segments, "
              f"{agg['scan_stopped_segments']} stopped), rows folded on the "
              f"host {m.hostFoldedRows()}, h2d {m.h2dBytes()} bytes, d2h "
              f"{m.d2hBytes()} bytes, lazy leaves fetched whole {forced}")
        # the same job on the path this one replaced: every row decoded
        # and folded on the interpreter
        try_build = A.ScanFold.try_build
        A.ScanFold.try_build = classmethod(lambda cls, op: None)
        try:
            ctx = Context()
            t0 = time.perf_counter()
            interp = getattr(tpch, "fold_" + job)(ctx.csv(path)).collect()
            interp_s = time.perf_counter() - t0
        finally:
            A.ScanFold.try_build = try_build
        if repr(interp) != repr(want) or \
                ctx.metrics.hostFoldedRows() != len(rows):
            raise AssertionError(f"{job} on the interpreter differs")
        print(f"general fold {job} on the interpreter (the general fold "
              f"off): {interp_s:.3f} s, rows equal")
    drows = tpch.read_lineitem_dicts(dirty)
    for job in ("g1", "g2", "g3"):
        want, excs = tpch.fold_python(drows, job)
        ctx = Context()
        ds = getattr(tpch, "fold_" + job)(ctx.csv(dirty))
        got = ds.collect()
        if repr(got) != repr(want) or ds.exception_counts() != excs:
            raise AssertionError(f"dirty {job}: {got} != the loop's {want}, "
                                 f"or exceptions {ds.exception_counts()} != "
                                 f"{excs}")
        agg = ctx.metrics.stages[-1]
        print(f"general fold {job} on the dirty file (2000 rows): equal to "
              f"the loop, exceptions {excs}; {agg['device_rows']} rows on "
              f"the card, {agg['scan_stopped_segments']} segments stopped, "
              f"{agg['host_folded_rows']} rows folded on the host")
    prog, args = max(recorded, key=lambda pa: pa[1][2].shape[0])
    nums = fold_kernel(prog, args, "G2's largest input", op_ns, reps=10)
    return launches, nums


def stage_list(ds, conf=None) -> str:
    """The job's plan (plan/physical.py plan_stages) in one line: T(n) a
    transform stage of n operators (Ti an interpreter segment), J a join,
    A an aggregate."""
    out = []
    for st in plan_stages(ds._op, Context(conf).options_store):
        ops = getattr(st, "ops", None)
        kind = type(st).__name__[0]
        if ops is None:
            out.append(kind)
        else:
            interp = "i" if st.force_interpret else ""
            out.append(f"{kind}{interp}({len(ops)})")
    return " ".join(out)


def flights_pushdown_runs(flights_run) -> None:
    """13a: flights under the defaults (the defunct filter pushed through
    the Origin and Dest left joins) and with tuplex.optimizer.filterPushdown
    off, both equal to the loop; the rows into each join, the join probe
    kernel's launches and the walls."""
    paths, want, excs, wall = flights_run
    into = {}
    for push in (True, False):
        conf = {"tuplex.optimizer.filterPushdown": push}
        ctx = Context(conf)
        join_cuda.launches = 0
        t0 = time.perf_counter()
        ds = flights.build_pipeline(ctx, *paths)
        got = ds.collect()
        torch.cuda.synchronize()
        w = time.perf_counter() - t0
        if got != want or ds.exception_counts() != excs:
            raise AssertionError(f"flights, pushdown {push}: rows or "
                                 "exceptions differ from the loop's")
        joins = [s for s in ctx.metrics.stages if "host_probed_rows" in s]
        into[push] = [s["device_probed_rows"] + s["host_probed_rows"]
                      for s in joins]
        print(f"flights, filterPushdown {push}: stages "
              f"[{stage_list(ds, conf)}], rows into the carrier / Origin / "
              f"Dest joins {' / '.join(map(str, into[push]))}, join_probe "
              f"launches {join_cuda.launches}, wall {w:.3f} s (phase 9's "
              f"run under the defaults {wall:.3f} s); {card_line()}")
    # no operator after the joins drops a row but the defunct filter, so
    # the loop's rows are the rows it keeps
    if not into[True][1] == into[True][2] == len(want) < into[False][1] \
            == into[False][2]:
        raise AssertionError(f"flights: rows into the joins {into}")


def planner_phase(flights_run, path: str) -> None:
    """Phase 13: the planner's paths at full size (plan/optimizer.py
    pushdown, plan/physical.py segment_stage, take, cache, show)."""
    flights_pushdown_runs(flights_run)
    lines = open(path, "rb").read().decode("utf-8", errors="replace") \
        .splitlines()
    kept = [x for x in lines if re.search(logs.ERROR_STATUS, x)]

    # 13b: a segmented stage: the grep, a map the emitter refuses (set)
    # on the interpreter, a compiled map
    def segmented(c):
        return c.text(path).filter(
            lambda x: re.search(r'" (4\d\d|5\d\d) ', x)) \
            .map(lambda x: len(set(x))).map(lambda y: (y, y * 2))

    want = [(len(set(x)), 2 * len(set(x))) for x in kept]
    ctx = Context()
    nfa_cuda.launches = 0
    t0 = time.perf_counter()
    ds = segmented(ctx)
    got = ds.collect()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    segs = ctx.metrics.stages
    tiers = [s["tier"] for s in segs]
    if got != want or tiers != ["compiled", "interpreter", "compiled"]:
        raise AssertionError(f"segmented grep: {len(got)} rows (loop "
                             f"{len(want)}), segments {tiers}")
    parts = segs[0]["dispatched_parts"]
    if nfa_cuda.launches != parts or segs[1]["interpreter_rows"] != \
            len(kept):
        raise AssertionError(f"segmented grep: {nfa_cuda.launches} scan "
                             f"launches over {parts} partitions, "
                             f"{segs[1]['interpreter_rows']} interpreter "
                             f"rows, the filter keeps {len(kept)}")
    print(f"segmented grep: stages [{stage_list(ds)}] ({tiers}), "
          f"{len(lines)} lines -> {len(got)} rows in {wall:.3f} s, "
          f"nfa_scan launches {nfa_cuda.launches} on {parts} partitions, "
          f"interpreter rows per segment "
          f"{[s['interpreter_rows'] for s in segs]}, segment walls "
          + " / ".join(f"{s['wall_s']:.3f}" for s in segs)
          + f" s, graphs captured {[s['stage_compiles'] for s in segs]}, "
          f"plan record {ctx.metrics.plans[-1]}; {card_line()}")

    # 13c: take(10) stops dispatching past the window
    ctx = Context()
    nfa_cuda.launches = 0
    t0 = time.perf_counter()
    got = logs.build_grep(ctx.text(path)).take(10)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    (m,) = ctx.metrics.stages
    n_parts = len(csvsource.make_text_operator(
        ctx.options_store, path).load_partitions())
    if got != [x[:x.find(" ")] for x in kept[:10]] or \
            nfa_cuda.launches != m["dispatched_parts"] or \
            nfa_cuda.launches >= n_parts:
        raise AssertionError(f"take(10): {got}, nfa_scan launches "
                             f"{nfa_cuda.launches} of {n_parts} partitions")
    print(f"take(10) of the grep: equal to the loop's first 10 rows in "
          f"{wall:.3f} s, nfa_scan launches {nfa_cuda.launches} of "
          f"{n_parts} partitions, partitions dropped unmerged "
          f"{m['dropped_parts']}; {card_line()}")

    # 13d: cache() reads the source once; two maps over it
    ctx = Context()
    ds = ctx.text(path)
    src, reads = ds._op, []
    load = src.load_partitions
    src.load_partitions = lambda: reads.append(1) or load()
    t0 = time.perf_counter()
    cached = ds.filter(lambda x: re.search(r'" (4\d\d|5\d\d) ', x)) \
        .cache()
    cache_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    lens = cached.map(lambda x: len(x)).collect()
    heads = cached.map(lambda x: x[:x.find(" ")]).collect()
    maps_s = time.perf_counter() - t0
    if lens != [len(x) for x in kept] or \
            heads != [x[:x.find(" ")] for x in kept] or reads != [1]:
        raise AssertionError(f"cache: rows differ from the loops', or the "
                             f"source was read {len(reads)} times")
    print(f"cache of the grep's {len(kept)} lines: built in {cache_s:.3f} s,"
          f" two maps over it in {maps_s:.3f} s, equal to their loops; "
          f"source read {len(reads)} time; {card_line()}")

    # 13e: show(5) prints the reference's format
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cached.map(lambda x: {"client": x[:x.find(" ")], "n": len(x)}) \
            .show(5)
    rows = [(x[:x.find(" ")], len(x)) for x in kept[:5]]
    expect = ["client | n", "-" * (3 * 2 + len("client") + len("n"))] + \
        [" | ".join(repr(v) for v in r) for r in rows]
    if buf.getvalue().splitlines() != expect:
        raise AssertionError(f"show(5): {buf.getvalue()!r}")
    print("show(5):\n" + buf.getvalue().rstrip())


def main() -> None:
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    def done(phase: str) -> None:
        print(f"phase {phase} done at {time.perf_counter() - t_start:.1f} s")

    # 1 --------------------------------------------------------------
    card = card_line()
    print(f"card: {card} | torch.cuda: {torch.cuda.get_device_name(0)}")

    # 2 --------------------------------------------------------------
    t0 = time.perf_counter()
    kernels = (nfa_cuda, join_cuda, segfold_cuda)
    with ThreadPoolExecutor(4) as pool:      # nvcc (3 times) and g++ at once
        libs = [pool.submit(k.build) for k in kernels]
        mod_f = pool.submit(native.get)
        libs, mod = [f.result() for f in libs], mod_f.result()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {libs}")
    for k in kernels:
        if k.LIBRARY.build_log:
            print(k.LIBRARY.build_log.strip())
    if mod is None:
        raise AssertionError("native module: no g++ on PATH")
    print(f"native module: {mod.__file__}")

    done("2")

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
    max_start_err = start_kernel_phase(mb, ml, rb, rl, edges)
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
    parts = C.harmonize_partitions(src.load_partitions())
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
    del batch, gb, gl, rb, rl

    done("3")

    # 4 --------------------------------------------------------------
    total_calls = {k: 0 for k in native.calls}
    nfa_cuda.launches = 0
    ctx = Context()
    ds = ctx.parallelize([1, 2, None, 4]).map(lambda x: (x, x * x))
    zero_native_calls()
    got = ds.collect()
    calls = native_path_calls(total_calls, ("encode_i64", "decode_columns"),
                              "smoke")
    if got != [(1, 1), (2, 4), (4, 16)]:
        raise AssertionError(f"smoke pipeline: {got}")
    m = ctx.metrics
    if (m.interpreterRows(), m.generalRows(), m.exactExitRows()) != \
            (0, 0, 1) or ds.exception_counts() != {"TypeError": 1}:
        raise AssertionError(f"smoke pipeline: {tier_line(m)}, exceptions "
                             f"{ds.exception_counts()}")
    print(f"smoke: {got}, {tier_line(m)}, exceptions "
          f"{ds.exception_counts()}, NFA launches {nfa_cuda.launches}, "
          f"native calls {calls}")

    done("4")

    # 5 --------------------------------------------------------------
    parts, nat_s = timed(src.load_partitions)
    with python_path():
        parts_py, py_s = timed(src.load_partitions)
    same_partitions(parts, parts_py, "text source")
    print(f"text source: read, split and encode {LOG_LINES} lines into "
          f"{len(parts)} partitions: native {nat_s:.3f} s, Python path "
          f"{py_s:.3f} s; partitions equal")
    del parts, parts_py
    t0 = time.perf_counter()
    want = logs.run_grep_reference(path)
    ref_s = time.perf_counter() - t0
    ctx = Context()
    nfa_cuda.launches = nfa_cuda.start_launches = RX.calls = 0
    zero_native_calls()
    t0 = time.perf_counter()
    got = logs.build_grep(ctx.text(path)).collect()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = nfa_cuda.launches
    grep_counts = kernel_counts()
    calls = native_path_calls(total_calls, ("split_lines", "gather_rows",
                                            "decode_columns"), "log grep")
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
          f"results to Python); native calls {calls}; {plane_line(m)}")
    plane_compare("log grep", lambda c: logs.build_grep(c.text(path)), want,
                  (wall, m, grep_counts))
    nat_s, py_s, n_rows = results_to_python(
        lambda c: logs.build_grep(c.text(path)))
    print(f"log grep results to Python ({n_rows} rows): native "
          f"{nat_s:.3f} s, Python path {py_s:.3f} s; rows equal")

    done("5")

    # 5b -------------------------------------------------------------
    start_launches, err, start_nums = weblogs_phase(path, dev)
    max_start_err = max(max_start_err, err)

    done("5b")

    # 6 --------------------------------------------------------------
    zillow_phase(tmp, total_calls)

    done("6")

    # 7 --------------------------------------------------------------
    tpch_tmp = tmp
    lineitem, dirty = tpch_phase(tmp, total_calls)
    nyc311_phase(tmp)

    done("7")

    # 8 --------------------------------------------------------------
    max_probe_err = 0
    for u, width in ((AIRPORT_KEYS, 8), (Q19_PARTS, 16)):
        err, _ = probe_phase(np.random.default_rng(u), u, width, dev)
        max_probe_err = max(max_probe_err, err)
    for u in (AIRPORT_KEYS, Q19_PARTS):
        err, _ = int_probe_phase(np.random.default_rng(u + 1), u, dev)
        max_probe_err = max(max_probe_err, err)

    done("8")

    # 9 --------------------------------------------------------------
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    flights_launches, probe_inputs, flights_run = flights_phase(tmp)
    # the kernel at the path's own inputs: the largest probe it made
    words, build = max(probe_inputs, key=lambda wb: wb[0].shape[0])
    err, _ = time_probe(words, build, "flights probe")
    max_probe_err = max(max_probe_err, err)
    del probe_inputs, words, build

    done("9")

    # 10 -------------------------------------------------------------
    q19_launches, probe_inputs = q19_phase(tmp)

    done("10")

    # 11 -------------------------------------------------------------
    widened_phase(tmp)
    # one-word keys: torch.searchsorted computes the same lower bound
    words, build = max(probe_inputs, key=lambda wb: wb[0].shape[0])
    err, probe_nums = time_probe(words, build, "q19 probe")
    max_probe_err = max(max_probe_err, err)
    probe_launches = flights_launches + q19_launches
    del probe_inputs, words, build

    done("11")

    # 12 -------------------------------------------------------------
    fold_launches, fold_nums = fold_phase(lineitem, dirty, dev)
    for f in (lineitem, dirty):
        os.remove(f)

    done("12")

    # 13 -------------------------------------------------------------
    planner_phase(flights_run, path)
    for f in (path, *flights_run[0]):
        os.remove(f)
    os.rmdir(tmp)
    os.rmdir(tpch_tmp)

    done("13")

    # 14 -------------------------------------------------------------
    zero_native_calls()
    native_check()
    for k, v in native.calls.items():
        total_calls[k] += v
    if not all(total_calls.values()):
        raise AssertionError(f"native entry points never called: "
                             f"{[k for k, v in total_calls.items() if not v]}")
    print(f"native module == Python path on every entry point; calls in "
          f"this run {total_calls}")

    done("14")
    print(json.dumps({"kernels": [{
        "name": "nfa_scan", "route": "cuda",
        "source": "tuplex_tpu_torch/csrc/nfa_scan.cu",
        "replaces": "tuplex_tpu/ops/pallas_nfa.py:29",
        "launches": launches, "max_abs_err": max_err,
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes", "library_ms": None}, {
        "name": "nfa_start", "route": "cuda",
        "source": "tuplex_tpu_torch/csrc/nfa_scan.cu",
        "replaces": "tuplex_tpu/ops/nfa.py:328",
        "launches": start_launches, "max_abs_err": max_start_err,
        **start_nums, "bound_by": "bytes", "library_ms": None}, {
        "name": "join_probe", "route": "cuda",
        "source": "tuplex_tpu_torch/csrc/join_probe.cu",
        "replaces": "tuplex_tpu/exec/joinexec.py:629",
        "launches": probe_launches, "max_abs_err": max_probe_err,
        **probe_nums, "bound_by": "bytes"}, {
        "name": "seg_fold", "route": "cuda",
        "source": "tuplex_tpu_torch/csrc/seg_fold.cu",
        "replaces": "tuplex_tpu/plan/aggregates.py:449",
        "launches": fold_launches, "max_abs_err": 0, **fold_nums,
        "bound_by": "bytes", "library_ms": None}]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
