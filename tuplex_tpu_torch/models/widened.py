"""A CSV whose column `c` is empty through the sniffed sample and filled
after it: the normal case types `c` null, so every row with a filled cell
leaves the fast path at the decode, and the general case, Option[str],
decodes it on the device (`io/csvsource.py` `general_type`). The compiled
general-case tier's own workload; a plain Python loop over the same file
is its oracle."""

from __future__ import annotations

import csv
import random

EMPTY_PREFIX = 1500   # rows before the first filled cell: past the sample


def generate_csv(path: str, n: int, seed: int = 5) -> int:
    """Columns a (the row number), b (one of three words) and c (empty in
    the first EMPTY_PREFIX rows, then an int with spaces around it in about
    70% of the rows). Returns the count of filled c cells."""
    rng = random.Random(seed)
    filled = 0
    with open(path, "w", newline="") as fp:
        w = csv.writer(fp)
        w.writerow(["a", "b", "c"])
        for i in range(n):
            c = "" if i < EMPTY_PREFIX or rng.random() < 0.3 else \
                f" {rng.randint(-99, 99)} "
            filled += c != ""
            w.writerow([i, rng.choice(["x", "yy", "zzz"]), c])
    return filled


def build_pipeline(ds):
    return (ds.withColumn("d", lambda x: int(x["c"]) * 2 if x["c"] else -1)
            .filter(lambda x: x["d"] != 0)
            .withColumn("e", lambda x: x["c"].strip() + x["b"]
                        if x["c"] else x["b"])
            .selectColumns(["a", "d", "e"]))


def run_reference_python(path: str) -> list:
    """The pipeline as a plain loop: its output rows in order."""
    out = []
    with open(path, newline="") as fp:
        r = csv.reader(fp)
        next(r)
        for a, b, c in r:
            c = c or None
            d = int(c) * 2 if c else -1
            if d == 0:
                continue
            out.append((int(a), d, c.strip() + b if c else b))
    return out
