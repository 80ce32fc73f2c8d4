"""What the CSV source's UTF-8 check costs: the one-pass record splitter
with the check and an earlier form of it without, on Z1's and flights'
generated files.

    git show <commit>:tuplex_tpu_torch/native/src/fasttransfer.cpp \\
        > _chip/earlier_fasttransfer.cpp
    git show <commit>:tuplex_tpu_torch/io/csvsource.py \\
        > _chip/earlier_csvsource.py
    python3 scripts/torch_csv_utf8_cost.py \\
        --earlier-native _chip/earlier_fasttransfer.cpp \\
        --earlier-csvsource _chip/earlier_csvsource.py [--rows 1000000]

Generates models/zillow.py's CSV (seed 42) and models/flights.py's perf
CSV (seed 13) at --rows rows, then times on each the native splitter
(`split_csv`: this tree's, which checks the bytes in its pass, and the
earlier source's, built by g++ beside it) and the numpy splitter
(`_split_records`: this tree's, and the earlier file's), in the order
earlier, current, current, earlier, --reps runs a turn, and prints the
best time of each with the card's name and power limit when nvidia-smi
is there. The splitters must give equal arrays. Host time only: the card
does nothing here.
"""

from __future__ import annotations

import argparse
import ast
import importlib.util
import os
import subprocess
import sys
import sysconfig
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import tuplex_tpu_torch                                   # noqa: E402
from tuplex_tpu_torch import native                       # noqa: E402
from tuplex_tpu_torch.io import csvsource                 # noqa: E402
from tuplex_tpu_torch.models import flights, zillow       # noqa: E402


def earlier_native(source: str, build_dir: str):
    """The extension built from an earlier fasttransfer.cpp."""
    lib = os.path.join(build_dir, native.MODULE +
                       (sysconfig.get_config_var("EXT_SUFFIX") or ".so"))
    subprocess.run([native.CXX, *native.FLAGS,
                    f"-I{sysconfig.get_paths()['include']}", source, "-o",
                    lib], check=True)
    spec = importlib.util.spec_from_file_location(native.MODULE, lib)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def earlier_split_records(path: str):
    """`_split_records` as an earlier csvsource.py defines it."""
    tree = ast.parse(open(path).read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "_split_records")
    env = {"np": np}
    exec(compile(ast.Module([fn], []), path, "exec"), env)  # noqa: S102
    return env["_split_records"]


def best(fn, reps: int) -> float:
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        out.append(time.perf_counter() - t0)
    return min(out)


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return "no nvidia-smi"


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--earlier-native", required=True)
    ap.add_argument("--earlier-csvsource", required=True)
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    tmp = tempfile.mkdtemp(prefix="utf8_cost_")
    old = earlier_native(os.path.abspath(args.earlier_native), tmp)
    cur = native.get()
    old_py = earlier_split_records(args.earlier_csvsource)
    files = {"zillow": zillow.generate_csv(os.path.join(tmp, "z.csv"),
                                           args.rows, seed=42),
             "flights": flights.generate_perf_csv(
                 os.path.join(tmp, "perf.csv"), args.rows, seed=13)}
    for name, path in files.items():
        ctx = tuplex_tpu_torch.Context(device="cpu")
        stat = ctx.csv(path)._op.parent.stat
        with open(path, "rb") as fp:
            data = fp.read()
        a = (data, ord(stat.delimiter), ord(stat.quotechar),
             stat.num_columns, stat.has_header)
        runs = {"native earlier": lambda: old.split_csv(*a),
                "native current": lambda: cur.split_csv(*a),
                "numpy earlier": lambda: old_py(*a),
                "numpy current": lambda: csvsource._split_records(*a)}
        ref = [np.frombuffer(x, np.int64) for x in old.split_csv(*a)[:2]]
        for key in ("native current", "numpy earlier", "numpy current"):
            got = runs[key]()
            got = [np.frombuffer(x, np.int64) if isinstance(x, bytearray)
                   else x for x in got[:2]]
            if not all(np.array_equal(x, y) for x, y in zip(got, ref)):
                raise AssertionError(f"{name}: {key} differs")
        times: dict = {k: [] for k in runs}
        for kind in ("native", "numpy"):
            for which in ("earlier", "current", "current", "earlier"):
                key = f"{kind} {which}"
                times[key].append(best(runs[key], args.reps))
        t = {k: min(v) for k, v in times.items()}
        line = ", ".join(f"{k} {v:.4f} s" for k, v in t.items())
        print(f"{name}: {args.rows} rows, {len(data)} bytes: {line}; the "
              f"check costs "
              f"{t['native current'] - t['native earlier']:+.4f} s native, "
              f"{t['numpy current'] - t['numpy earlier']:+.4f} s numpy")
        os.remove(path)
    print(card_line())


if __name__ == "__main__":
    main()
