"""TPC-H Q6, Q1 and Q19 (counterpart of `tuplex_tpu/models/tpch.py`;
reference: benchmarks/tpch/Q06, Q19 — filter, join and aggregate pipelines
used to compare against Hyper/Weld).

Data generators for the lineitem and part columns these queries read (the
reference package's bytes for the same seed), the queries as pipelines,
and plain Python loops over the same files for checking them. This package
imports nothing of `tuplex_tpu`.
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


# --- Q19: discounted revenue over brand/container/quantity disjunction ------
# (reference: benchmarks/tpch/Q19 — lineitem JOIN part with a three-branch
# OR predicate; exercises join + compound filter + aggregate together)

PART_COLUMNS = ["p_partkey", "p_brand", "p_size", "p_container"]
LINEITEM19_COLUMNS = ["l_partkey", "l_quantity", "l_extendedprice",
                      "l_discount", "l_shipinstruct", "l_shipmode"]

_CONTAINERS_SM = ["SM CASE", "SM BOX", "SM PACK", "SM PKG"]
_CONTAINERS_MED = ["MED BAG", "MED BOX", "MED PKG", "MED PACK"]
_CONTAINERS_LG = ["LG CASE", "LG BOX", "LG PACK", "LG PKG"]


def gen_part_rows(n: int, seed: int = 19):
    rng = random.Random(seed)
    brands = [f"Brand#{i}{j}" for i in range(1, 6) for j in range(1, 6)]
    containers = (_CONTAINERS_SM + _CONTAINERS_MED + _CONTAINERS_LG +
                  ["JUMBO JAR", "WRAP CAN"])
    return [(k, rng.choice(brands), rng.randint(1, 50),
             rng.choice(containers)) for k in range(1, n + 1)]


def gen_lineitem19_rows(n: int, n_parts: int, seed: int = 23):
    rng = random.Random(seed)
    modes = ["AIR", "AIR REG", "RAIL", "TRUCK", "SHIP"]
    instr = ["DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN"]
    return [(rng.randint(1, n_parts), float(rng.randint(1, 50)),
             round(rng.uniform(900.0, 105000.0), 2),
             round(rng.uniform(0.0, 0.1), 2),
             rng.choice(instr), rng.choice(modes)) for _ in range(n)]


def generate_q19_csvs(part_path: str, lineitem_path: str, n_parts: int,
                      n_items: int, seed: int = 19) -> None:
    import csv

    with open(part_path, "w", newline="") as fp:
        w = csv.writer(fp)
        w.writerow(PART_COLUMNS)
        w.writerows(gen_part_rows(n_parts, seed))
    with open(lineitem_path, "w", newline="") as fp:
        w = csv.writer(fp)
        w.writerow(LINEITEM19_COLUMNS)
        w.writerows(gen_lineitem19_rows(n_items, n_parts, seed + 4))


def _q19_pred(x) -> bool:
    return ((x["p_brand"] == "Brand#12"
             and x["p_container"] in ("SM CASE", "SM BOX", "SM PACK",
                                      "SM PKG")
             and 1 <= x["l_quantity"] <= 11 and 1 <= x["p_size"] <= 5)
            or (x["p_brand"] == "Brand#23"
                and x["p_container"] in ("MED BAG", "MED BOX", "MED PKG",
                                         "MED PACK")
                and 10 <= x["l_quantity"] <= 20 and 1 <= x["p_size"] <= 10)
            or (x["p_brand"] == "Brand#34"
                and x["p_container"] in ("LG CASE", "LG BOX", "LG PACK",
                                         "LG PKG")
                and 20 <= x["l_quantity"] <= 30
                and 1 <= x["p_size"] <= 15))


def q19(ctx, part_path: str, lineitem_path: str):
    """SELECT sum(l_extendedprice * (1 - l_discount)) over the brand/
    container/quantity disjunction, shipmode AIR/AIR REG, DELIVER IN
    PERSON."""
    part = ctx.csv(part_path)
    li = (ctx.csv(lineitem_path)
          .filter(lambda x: x["l_shipinstruct"] == "DELIVER IN PERSON")
          .filter(lambda x: x["l_shipmode"] == "AIR" or
                  x["l_shipmode"] == "AIR REG"))
    joined = li.join(part, "l_partkey", "p_partkey")
    return (joined
            .filter(_q19_pred)
            .aggregate(lambda a, b: a + b,
                       lambda a, x: a + x["l_extendedprice"] *
                       (1 - x["l_discount"]), 0.0))


def run_reference_q19(part_path: str, lineitem_path: str) -> float:
    """File-based python baseline doing the SAME csv parse work."""
    parts = read_csv_rows(part_path, (int, str, int, str))
    lis = read_csv_rows(lineitem_path,
                        (int, float, float, float, str, str))
    return q19_python(parts, lis)


def q19_python(part_rows, li_rows) -> float:
    parts = {r[0]: r for r in part_rows}
    total = 0.0
    for (pk, qty, price, disc, instr, mode) in li_rows:
        if instr != "DELIVER IN PERSON" or mode not in ("AIR", "AIR REG"):
            continue
        p = parts.get(pk)
        if p is None:
            continue
        _, brand, size, container = p
        if ((brand == "Brand#12" and container in _CONTAINERS_SM
             and 1 <= qty <= 11 and 1 <= size <= 5)
                or (brand == "Brand#23" and container in _CONTAINERS_MED
                    and 10 <= qty <= 20 and 1 <= size <= 10)
                or (brand == "Brand#34" and container in _CONTAINERS_LG
                    and 20 <= qty <= 30 and 1 <= size <= 15)):
            total += price * (1 - disc)
    return total


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


# --- general folds over lineitem ----------------------------------------------
# Aggregate UDFs that plan/aggregates.py `recognize_fold` declines (a
# condition, a decay), so they run as general folds (csrc/seg_fold.cu):
# by (returnflag, linestatus), 6 keys; by shipdate, 2,352 keys; and over
# the whole file, one segment.

def fold_g1(ds):
    """Discounted revenue and row count of the rows discounted by 0.05 or
    more, by (returnflag, linestatus)."""
    return ds.aggregateByKey(
        lambda a, b: (a[0] + b[0], a[1] + b[1]),
        lambda a, x: (a[0] + x["l_extendedprice"] * (1 - x["l_discount"]),
                      a[1] + 1) if x["l_discount"] >= 0.05 else a,
        (0.0, 0), ["l_returnflag", "l_linestatus"])


def fold_g2(ds):
    """An exponentially decayed price per ship date."""
    return ds.aggregateByKey(
        lambda a, b: a + b,
        lambda a, x: a * 0.9 + x["l_extendedprice"],
        0.0, ["l_shipdate"])


def fold_g3(ds):
    """A decayed price over the rows shipped by the Q1 cutoff, over the
    whole file."""
    return ds.aggregate(
        lambda a, b: a + b,
        lambda a, x: a * 0.999 + x["l_extendedprice"]
        if x["l_shipdate"] <= "1998-09-02" else a,
        0.0)


def fold_python(rows, job: str) -> tuple:
    """A general fold job ('g1', 'g2' or 'g3') as a plain loop over
    read_lineitem_dicts rows: (the rows `collect()` gives, exception
    counts by class), a row that raises counted and skipped."""
    groups, excs = {}, {}
    for x in rows:
        try:
            if job == "g1":
                k = (x["l_returnflag"], x["l_linestatus"])
                a = groups.get(k, (0.0, 0))
                groups[k] = (a[0] + x["l_extendedprice"] *
                             (1 - x["l_discount"]), a[1] + 1) \
                    if x["l_discount"] >= 0.05 else a
            elif job == "g2":
                k = (x["l_shipdate"],)
                groups[k] = groups.get(k, 0.0) * 0.9 + x["l_extendedprice"]
            else:
                a = groups.get((), 0.0)
                groups[()] = a * 0.999 + x["l_extendedprice"] \
                    if x["l_shipdate"] <= "1998-09-02" else a
        except Exception as e:
            excs[type(e).__name__] = excs.get(type(e).__name__, 0) + 1
    if job == "g3":
        return [groups.get((), 0.0)], excs
    return [k + (v if isinstance(v, tuple) else (v,))
            for k, v in groups.items()], excs
