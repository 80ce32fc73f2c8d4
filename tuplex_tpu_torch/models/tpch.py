"""TPC-H Q6 and Q1 over lineitem (counterpart of the Q6/Q1 half of
`tuplex_tpu/models/tpch.py`; reference: benchmarks/tpch/Q06 — filter and
aggregate pipelines used to compare against Hyper/Weld).

A data generator for the seven lineitem columns these queries read (the
reference package's bytes for the same seed), the queries as pipelines,
and plain Python loops over the same file for checking them. Q19 needs a
join and is not here. This package imports nothing of `tuplex_tpu`.
"""

from __future__ import annotations

import random

LINEITEM_COLUMNS = ["l_quantity", "l_extendedprice", "l_discount", "l_tax",
                    "l_returnflag", "l_linestatus", "l_shipdate"]


def gen_lineitem_rows(n: int, seed: int = 7):
    rng = random.Random(seed)
    flags = ["A", "N", "R"]
    stats = ["F", "O"]
    rows = []
    for _ in range(n):
        rows.append((
            float(rng.randint(1, 50)),
            round(rng.uniform(900.0, 105000.0), 2),
            round(rng.choice([0.0, 0.01, 0.02, 0.03, 0.04, 0.05, 0.06,
                              0.07, 0.08, 0.09, 0.1]), 2),
            round(rng.uniform(0.0, 0.08), 2),
            rng.choice(flags),
            rng.choice(stats),
            f"199{rng.randint(2, 8)}-{rng.randint(1, 12):02d}-"
            f"{rng.randint(1, 28):02d}",
        ))
    return rows


def generate_csv(path: str, n: int, seed: int = 7) -> str:
    import csv

    with open(path, "w", newline="") as fp:
        w = csv.writer(fp)
        w.writerow(LINEITEM_COLUMNS)
        for r in gen_lineitem_rows(n, seed):
            w.writerow(r)
    return path


# --- Q6: revenue from discounted small-quantity shipments -------------------

def q6(ds):
    """SELECT sum(l_extendedprice * l_discount) WHERE l_shipdate in [1994,
    1995) AND l_discount in [0.05, 0.07] AND l_quantity < 24."""
    return (ds
            .filter(lambda x: x["l_shipdate"] >= "1994-01-01")
            .filter(lambda x: x["l_shipdate"] < "1995-01-01")
            .filter(lambda x: 0.05 <= x["l_discount"] <= 0.07)
            .filter(lambda x: x["l_quantity"] < 24)
            .aggregate(lambda a, b: a + b,
                       lambda a, x: a + x["l_extendedprice"] * x["l_discount"],
                       0.0))


def read_lineitem_csv(path: str):
    """Parse the lineitem CSV with csv+typed conversion — the pure-python
    side of the SAME work the framework pipeline does (CSV read + parse +
    query), so suite speedups compare like for like."""
    return read_csv_rows(path, (float, float, float, float, str, str, str))


def run_reference_q1(path: str) -> dict:
    return q1_python(read_lineitem_csv(path))


def run_reference_q6(path: str) -> float:
    return q6_python(read_lineitem_csv(path))


def q6_python(rows) -> float:
    total = 0.0
    for (qty, price, disc, tax, rf, ls, ship) in rows:
        if "1994-01-01" <= ship < "1995-01-01" and \
                0.05 <= disc <= 0.07 and qty < 24:
            total += price * disc
    return total


# --- Q1: pricing summary report ---------------------------------------------

def q1(ds):
    """Grouped sums by (returnflag, linestatus) for l_shipdate <= cutoff."""
    return (ds
            .filter(lambda x: x["l_shipdate"] <= "1998-09-02")
            .aggregateByKey(
                lambda a, b: (a[0] + b[0], a[1] + b[1], a[2] + b[2],
                              a[3] + b[3]),
                lambda a, x: (a[0] + x["l_quantity"],
                              a[1] + x["l_extendedprice"],
                              a[2] + x["l_extendedprice"] *
                              (1 - x["l_discount"]),
                              a[3] + 1),
                (0.0, 0.0, 0.0, 0),
                ["l_returnflag", "l_linestatus"]))


def q1_python(rows) -> dict:
    groups: dict = {}
    for (qty, price, disc, tax, rf, ls, ship) in rows:
        if ship <= "1998-09-02":
            k = (rf, ls)
            a = groups.get(k, (0.0, 0.0, 0.0, 0))
            groups[k] = (a[0] + qty, a[1] + price,
                         a[2] + price * (1 - disc), a[3] + 1)
    return groups


def read_csv_rows(path: str, parsers) -> list:
    import csv as _csv

    out = []
    with open(path, newline="") as f:
        r = _csv.reader(f)
        next(r)
        for rec in r:
            out.append(tuple(p(c) for p, c in zip(parsers, rec)))
    return out


# --- dirty cells -------------------------------------------------------------

DIRTY_RATE = 0.03   # share of l_quantity and of l_discount cells made dirty


def generate_dirty_csv(path: str, n: int, seed: int = 7) -> str:
    """The lineitem file with DIRTY_RATE of the l_quantity and of the
    l_discount cells replaced by 'N/A' or an empty cell."""
    import csv

    rng = random.Random(seed + 1)
    with open(path, "w", newline="") as fp:
        w = csv.writer(fp)
        w.writerow(LINEITEM_COLUMNS)
        for r in gen_lineitem_rows(n, seed):
            r = list(r)
            for ci in (0, 2):
                if rng.random() < DIRTY_RATE:
                    r[ci] = rng.choice(["N/A", ""])
            w.writerow(r)
    return path


def read_lineitem_dicts(path: str) -> list:
    """The lineitem rows as the pipelines see them: an empty cell is None,
    a float cell that does not parse stays its string."""
    import csv

    def cell(c: str, parse):
        if c == "":
            return None
        try:
            return parse(c)
        except ValueError:
            return c

    parsers = (float, float, float, float, str, str, str)
    with open(path, newline="") as fp:
        r = csv.reader(fp)
        next(r)
        return [dict(zip(LINEITEM_COLUMNS, (cell(c, p) for c, p in
                                            zip(rec, parsers))))
                for rec in r]


def q6_python_counting(rows) -> tuple:
    """Q6 row by row over read_lineitem_dicts rows: (revenue, exception
    counts by class), a row that raises counted and skipped."""
    total, excs = 0.0, {}
    for x in rows:
        try:
            if not ("1994-01-01" <= x["l_shipdate"] < "1995-01-01"
                    and 0.05 <= x["l_discount"] <= 0.07
                    and x["l_quantity"] < 24):
                continue
            total = total + x["l_extendedprice"] * x["l_discount"]
        except Exception as e:
            excs[type(e).__name__] = excs.get(type(e).__name__, 0) + 1
    return total, excs


def q1_python_counting(rows) -> tuple:
    """Q1 row by row over read_lineitem_dicts rows: (groups, exception
    counts by class)."""
    groups, excs = {}, {}
    for x in rows:
        try:
            if x["l_shipdate"] <= "1998-09-02":
                k = (x["l_returnflag"], x["l_linestatus"])
                a = groups.get(k, (0.0, 0.0, 0.0, 0))
                groups[k] = (a[0] + x["l_quantity"],
                             a[1] + x["l_extendedprice"],
                             a[2] + x["l_extendedprice"] *
                             (1 - x["l_discount"]), a[3] + 1)
        except Exception as e:
            excs[type(e).__name__] = excs.get(type(e).__name__, 0) + 1
    return groups, excs
