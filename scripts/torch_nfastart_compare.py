"""The leftmost-start kernel against an earlier form of it, and its two
table layouts against each other, on one NVIDIA GPU, in turns on the same
inputs.

    git show <commit>:tuplex_tpu_torch/csrc/nfa_scan.cu > _chip/earlier.cu
    python3 scripts/torch_nfastart_compare.py --earlier _chip/earlier.cu
        [--reps 20] [--out chiprun_out/nfastart_compare.json]

`--earlier` is an nfa_scan.cu whose `tpx_nfa_start` scans every row with
64-bit tables (the interface of the commit that added the start kernel).
Both sources are built by nvcc for sm_90a. Inputs, as chip_smoke.py makes
them: the status grep's largest input (the first partition of the
1,891,715-line log, seed 17) with the NFA scan's result as its live mask,
with every row live and with no mask; the seeded random [1000003, 128]
matrix with patterns of 8, 3 and 32 positions, every row live. On each,
the two kernels must give equal outputs (the earlier one scans every row:
masked, its result is the same), then they are timed by CUDA events in
the order earlier, current, current, earlier. Then the two table layouts:
the kernel takes its layout from the follow-chunk count alone
(`start_rep` in nfa_scan.cu: lane-replicated at one chunk, plain at two
to four), so the script also builds a copy of the source with that rule
flipped, which runs the other layout at every chunk count (at two to four,
replicated CLASSTAB beside plain follow tables). With patterns of 8, 3,
16, 24 and 32 positions (1 to 4 follow chunks) on the random matrix and
the status grep's pattern on its input with its mask and with none, the
two must agree and are timed plain, replicated, replicated, plain, with
each layout's block shape and blocks per SM.
Prints one line an input and the card's name and power limit; the numbers
also go to --out as JSON. Needs CUDA: without it the script exits nonzero.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("torch_nfastart_compare: CUDA is not available")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as CS                                   # noqa: E402
from tuplex_tpu_torch import Context                      # noqa: E402
from tuplex_tpu_torch.models import logs                  # noqa: E402
from tuplex_tpu_torch.ops import nfa_cuda                 # noqa: E402
from tuplex_tpu_torch.ops.cuda_build import (             # noqa: E402
    CudaLibrary, current_stream)
from tuplex_tpu_torch.ops.nfa import (                    # noqa: E402
    compile_nfa, follow_chunks)
from tuplex_tpu_torch.runtime import columns as C         # noqa: E402

# patterns of 1, 1, 2, 3 and 4 follow chunks for the layout comparison
LAYOUT_PATTERNS = (logs.STATUS_GROUPS, r"\S+x", "[ab]" * 16, "[ab]" * 24,
                   "[ab]" * 32)
# nfa_scan.cu's layout rule, and the rule of the copy that runs the other
# layout at every chunk count
LAYOUT_RULE = "bool start_rep(int nchunk) {\n  return nchunk == 1;\n}"
FLIPPED_RULE = "bool start_rep(int nchunk) {\n  return nchunk != 1;\n}"


def _bind_earlier(lib) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.tpx_nfa_start.argtypes = [p, p, ll, ll, p, i, i, i, p, p, p]
    lib.tpx_nfa_start.restype = ctypes.c_int


def earlier_tables(tables) -> np.ndarray:
    """The earlier kernel's table buffer: pack_start_tables' layout in
    uint64."""
    f8 = follow_chunks(nfa_cuda.reversed_follow(tables), tables.n_pos)
    if not tables.anchored_end:
        f8[:1] |= np.uint64(tables.last)
    return np.concatenate([
        np.asarray(tables.classtab, dtype=np.uint64), f8.ravel(),
        np.array([tables.last, tables.first], dtype=np.uint64)])


def earlier_start(lib, rx, buf, b, l):
    """(matched, start) of the earlier kernel over every row."""
    n, w = b.shape
    t = rx.tables
    matched = torch.empty(n, dtype=torch.bool, device=b.device)
    start = torch.empty(n, dtype=torch.int32, device=b.device)
    rc = lib.tpx_nfa_start(b.data_ptr(), l.data_ptr(), n, w, buf.data_ptr(),
                           (t.n_pos + 7) // 8, int(t.anchored_start),
                           int(t.anchored_end), matched.data_ptr(),
                           start.data_ptr(), current_stream(b.device))
    if rc:
        raise RuntimeError(f"earlier nfa_start launch failed: {rc}")
    return matched, start


def flipped_library(tmp: str) -> CudaLibrary:
    """The current source with its layout rule flipped, as a library of
    the same interface, written under `tmp`."""
    with open(nfa_cuda.LIBRARY.source) as fp:
        src = fp.read()
    if src.count(LAYOUT_RULE) != 1:
        sys.exit("torch_nfastart_compare: nfa_scan.cu has no layout rule "
                 f"{LAYOUT_RULE!r}")
    path = os.path.join(tmp, "nfa_scan_flipped.cu")
    with open(path, "w") as fp:
        fp.write(src.replace(LAYOUT_RULE, FLIPPED_RULE))
    lib = CudaLibrary("nfa_scan.cu", nfa_cuda._bind)
    lib.source = path
    lib.name = "nfa_scan_flipped"
    return lib


def start_with(lib, rx, buf, b, l, live):
    """(matched, start) of the current interface's kernel in `lib`."""
    n, w = b.shape
    t = rx.tables
    matched = torch.empty(n, dtype=torch.bool, device=b.device)
    start = torch.empty(n, dtype=torch.int32, device=b.device)
    rc = lib.tpx_nfa_start(b.data_ptr(), l.data_ptr(),
                           None if live is None else live.data_ptr(), n, w,
                           buf.data_ptr(), (t.n_pos + 7) // 8,
                           int(t.anchored_start), int(t.anchored_end),
                           matched.data_ptr(), start.data_ptr(),
                           current_stream(b.device))
    if rc:
        raise RuntimeError(f"nfa_start launch failed: {rc}")
    return matched, start


def variant_of(lib, n_chunks: int, anchored_end: bool) -> dict:
    """nfa_cuda.start_variant's answer from the kernel in `lib`."""
    out = [ctypes.c_int() for _ in nfa_cuda.StartVariant._fields]
    rc = lib.tpx_nfa_start_variant(n_chunks, int(anchored_end), 16,
                                   *(ctypes.byref(o) for o in out))
    if rc:
        raise RuntimeError(f"nfa_start variant: cudaError {rc}")
    return dict(zip(nfa_cuda.StartVariant._fields, (o.value for o in out)))


def in_turns(a, b, reps: int, order=("a", "b", "b", "a")) -> dict:
    """Device ms of a() and b() (one launch each), timed in turns."""
    times = {"a": [], "b": []}
    for which in order:
        times[which].append(CS.kernel_device_ms(a if which == "a" else b,
                                                reps)[0])
    return times


def status_input(dev):
    """The status grep's largest input: the log's first partition as the
    text source stages it (chip_smoke.py phase 3's log-grep batch)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "access.log")
        logs.generate_log(path, CS.LOG_LINES, seed=17,
                          non_ascii_every=CS.NON_ASCII_EVERY)
        src = Context().text(path)._op
        part = C.harmonize_partitions(src.load_partitions())[0]
        batch = C.stage_partition(part, dev)
        return batch.arrays["0#bytes"], batch.arrays["0#len"]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--earlier", required=True)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default="chiprun_out/nfastart_compare.json")
    args = ap.parse_args()
    dev = torch.device("cuda", 0)
    card = CS.card_line()
    earlier = CudaLibrary("nfa_scan.cu", _bind_earlier)
    earlier.source = os.path.abspath(args.earlier)
    earlier.name = "nfa_scan_earlier"
    with tempfile.TemporaryDirectory() as tmp, \
            ThreadPoolExecutor(3) as pool:   # the nvcc builds at once
        libs = [pool.submit(x.load) for x in
                (earlier, nfa_cuda.LIBRARY, flipped_library(tmp))]
        lib, current, flipped = (x.result() for x in libs)

    sb, sl = status_input(dev)
    mat, lens = CS.random_matrix(np.random.default_rng(17), CS.RANDOM_ROWS,
                                 CS.RANDOM_WIDTH)
    rb, rl = torch.from_numpy(mat).to(dev), torch.from_numpy(lens).to(dev)
    srx = compile_nfa(logs.STATUS_GROUPS)
    smask = srx.match(sb, sl)
    cases = [("status grep input, its mask", logs.STATUS_GROUPS, sb, sl,
              smask),
             ("status grep input, every row live", logs.STATUS_GROUPS, sb,
              sl, torch.ones_like(smask)),
             ("status grep input, no mask", logs.STATUS_GROUPS, sb, sl,
              None)]
    cases += [(f"random rows, {compile_nfa(p).n_pos} positions, no mask", p,
               rb, rl, None) for p in (logs.STATUS_GROUPS, r"\S+x",
                                       "[ab]" * 32)]
    rows = []
    for what, pat, b, l, live in cases:
        rx = compile_nfa(pat)
        buf = torch.from_numpy(earlier_tables(rx.tables).view(
            np.int64)).to(dev)
        em, es = earlier_start(lib, rx, buf, b, l)
        cm, cs = rx.match_start(b, l, live=live)
        torch.cuda.synchronize()
        if not (torch.equal(em, cm) and torch.equal(es, cs)):
            raise AssertionError(f"{what}: the kernels differ")
        t = in_turns(lambda: earlier_start(lib, rx, buf, b, l),
                     lambda: rx.match_start(b, l, live=live), args.reps)
        e, c = np.mean(t["a"]), np.mean(t["b"])
        bound = CS.start_bound_ms(l, b.shape[1], live)
        rows.append({"input": what, "shape": list(b.shape),
                     "positions": rx.n_pos,
                     "live_rows": None if live is None else int(live.sum()),
                     "earlier_ms": t["a"], "current_ms": t["b"],
                     "bound_ms": bound, "earlier_over_current": e / c})
        print(f"{what} {list(b.shape)}: earlier (every row, 64-bit "
              f"tables) {t['a']} ms, current {t['b']} ms, {e / c:.3f}x; "
              f"bound {bound:.4f} ms; equal outputs")

    layouts = []
    for pat in LAYOUT_PATTERNS:
        rx = compile_nfa(pat)
        buf = rx._start_tables(dev)
        inputs = [("random rows, no mask", rb, rl, None)]
        if pat == logs.STATUS_GROUPS:
            inputs += [("status grep input, its mask", sb, sl, smask),
                       ("status grep input, no mask", sb, sl, None)]
        k = (rx.n_pos + 7) // 8
        end = rx.tables.anchored_end
        # the layout each build runs at this chunk count
        by = {bool(variant_of(x, k, end)["replicated"]): x
              for x in (current, flipped)}
        if len(by) != 2:
            raise AssertionError(f"{k} chunk(s): the flipped copy runs the "
                                 "current layout")
        var = {name: variant_of(by[r], k, end)
               for name, r in (("plain", False), ("replicated", True))}
        default = "replicated" if by[True] is current else "plain"
        for what, b, l, live in inputs:
            run = {r: (lambda x=x: start_with(x, rx, buf, b, l, live))
                   for r, x in by.items()}
            outs = [run[r]() for r in run]
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(*outs)):
                raise AssertionError(f"{pat!r} on {what}: the layouts differ")
            t = in_turns(run[False], run[True], args.reps)
            layouts.append({"positions": rx.n_pos, "input": what,
                            "plain_ms": t["a"], "replicated_ms": t["b"],
                            "variants": var, "default": default})
            print(f"layouts, {rx.n_pos} positions ({k} chunk(s)), {what}: "
                  f"plain {t['a']} ms ({var['plain']['blocks_per_sm']} blocks of "
                  f"{var['plain']['threads']}/SM), lane-replicated {t['b']} "
                  f"ms ({var['replicated']['blocks_per_sm']} block of "
                  f"{var['replicated']['threads']}/SM); default "
                  f"{layouts[-1]['default']}")
    print(card)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as fp:
        json.dump({"card": card, "inputs": rows, "layouts": layouts}, fp,
                  indent=1)


if __name__ == "__main__":
    main()
