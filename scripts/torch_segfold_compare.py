"""The general fold's kernel against an earlier form of it, on one NVIDIA
GPU, in turns on the same inputs.

    git show <commit>:tuplex_tpu_torch/csrc/seg_fold.cu > _chip/earlier.cu
    python3 scripts/torch_segfold_compare.py --earlier _chip/earlier.cu
        [--reps 3] [--out chiprun_out/segfold_compare.json]

`--earlier` is a seg_fold.cu with the one-thread-per-segment interface
(`tpx_seg_fold` over the lowered program, as in the commit that added
the kernel). Both are built by nvcc for sm_90a. On chip_smoke.py phase
12's seeded batches (1,000,000 rows in 1, 6, 2,352 and 250,000 segments,
its 4- and 22-instruction folds, the same seed), each batch is folded by
both kernels, which must agree on all six outputs, and then timed by CUDA
events in the order earlier, current, current, earlier. Prints one line a
batch and the card's name and power limit; the numbers also go to --out
as JSON. Needs CUDA: without it the script exits nonzero.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("torch_segfold_compare: CUDA is not available")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as CS                                   # noqa: E402
from tuplex_tpu_torch.compiler.foldprog import lower_fold  # noqa: E402
from tuplex_tpu_torch.ops import segfold as SF            # noqa: E402
from tuplex_tpu_torch.ops import segfold_cuda             # noqa: E402
from tuplex_tpu_torch.ops.cuda_build import (             # noqa: E402
    CudaLibrary, current_stream)
from tuplex_tpu_torch.utils.reflection import get_udf_source  # noqa: E402


def _bind_earlier(lib) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = lib.tpx_seg_fold
    fn.argtypes = [p, i, p, i, p, p, ll, p, p, p, i, i, p, p,
                   p, p, p, p, p, p, p]
    fn.restype = ctypes.c_int


def earlier_fold(lib, code, consts, vals, metas, order, offsets, limits,
                 seeds, seed_tags) -> SF.SegFoldResult:
    """The earlier kernel over the lowered program (`code`, `consts`, on
    the card already: no decode)."""
    dev = vals.device
    nseg, nleaf = seeds.shape
    out = [torch.empty((nseg, nleaf), dtype=torch.int64, device=dev),
           torch.empty((nseg, nleaf), dtype=torch.int8, device=dev),
           *(torch.empty(nseg, dtype=torch.int64, device=dev)
             for _ in range(3)),
           torch.zeros(vals.shape[1], dtype=torch.int8, device=dev)]
    rc = lib.tpx_seg_fold(
        code.data_ptr(), code.shape[0], consts.data_ptr(), consts.shape[0],
        vals.data_ptr(), metas.data_ptr(), vals.shape[1], order.data_ptr(),
        offsets.data_ptr(), limits.data_ptr(), nseg, nleaf, seeds.data_ptr(),
        seed_tags.data_ptr(), *(t.data_ptr() for t in out),
        current_stream(dev))
    if rc:
        raise RuntimeError(f"earlier seg_fold launch failed: {rc}")
    return SF.SegFoldResult(*out)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--earlier", required=True)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default="chiprun_out/segfold_compare.json")
    args = ap.parse_args()
    dev = torch.device("cuda", 0)
    card = CS.card_line()
    earlier = CudaLibrary("seg_fold.cu", _bind_earlier)
    earlier.source = os.path.abspath(args.earlier)
    earlier.name = "seg_fold_earlier"
    lib = earlier.load()
    segfold_cuda.LIBRARY.load()
    fields = ("acc", "acc_tags", "first", "count", "stop", "status")
    rng = np.random.default_rng(11)       # chip_smoke.py phase 12's seed
    rows = []
    for fn, n_leaves, scalar in ((CS.fold_short, 1, True),
                                 (CS.fold_long, 2, False)):
        prog = lower_fold(get_udf_source(fn), n_leaves, scalar)
        lowered = (prog.code.to(dev).contiguous(),
                   prog.consts.to(dev).contiguous())
        for nseg in CS.FOLD_SEGMENTS:
            inputs = CS.fold_batch(rng, prog, nseg, dev)
            a = earlier_fold(lib, *lowered, *inputs)
            b = segfold_cuda.seg_fold(prog, *inputs)
            torch.cuda.synchronize()
            bad = [f for f in fields
                   if not torch.equal(getattr(a, f), getattr(b, f))]
            if bad:
                raise AssertionError(f"{fn.__name__} x {nseg}: the kernels "
                                     f"differ in {bad}")
            times = {"earlier": [], "current": []}
            for which in ("earlier", "current", "current", "earlier"):
                run = (lambda: earlier_fold(lib, *lowered, *inputs)) \
                    if which == "earlier" else \
                    (lambda: segfold_cuda.seg_fold(prog, *inputs))
                times[which].append(CS.kernel_device_ms(run, args.reps)[0])
            e, c = np.mean(times["earlier"]), np.mean(times["current"])
            row = {"fold": fn.__name__, "segments": nseg,
                   "instructions": len(prog),
                   "decoded": len(SF.decoded(prog, n_leaves)),
                   "layout": segfold_cuda.layout_counts(inputs[3].cpu()),
                   "earlier_ms": times["earlier"],
                   "current_ms": times["current"], "speedup": e / c}
            rows.append(row)
            print(f"{fn.__name__} x {nseg} segments: earlier "
                  f"{times['earlier']} ms, current {times['current']} ms, "
                  f"{e / c:.2f}x; equal outputs")
    print(card)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as fp:
        json.dump({"card": card, "batches": rows}, fp, indent=1)


if __name__ == "__main__":
    main()
