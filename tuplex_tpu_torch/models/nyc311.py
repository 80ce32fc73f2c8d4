"""NYC 311 service-request pipeline (counterpart of
`tuplex_tpu/models/nyc311.py`; reference: benchmarks/311/runtuplex.py —
csv with aggressive null_values, fix_zip_codes mapColumn, unique). The
generator writes the reference package's bytes for the same seed."""

from __future__ import annotations

import random

NULL_VALUES = ["Unspecified", "NO CLUE", "NA", "N/A", "0", ""]


def fix_zip_codes(zips):
    if not zips:
        return None
    # Truncate everything to length 5
    s = zips[:5]
    # Set 00000 zip codes to nan
    if s == "00000":
        return None
    else:
        return s


def build_pipeline(ctx, path: str):
    from ..core import typesys as T

    df = ctx.csv(path, null_values=NULL_VALUES,
                 type_hints={0: T.option(T.STR)})
    return df.mapColumn("Incident Zip", fix_zip_codes).unique()


def generate_csv(path: str, n: int, seed: int = 23) -> str:
    import csv

    rng = random.Random(seed)
    zips = ["02139", "10025-1234", "00000", "11201", "94105", "N/A",
            "Unspecified", "021", "  ", "60614"]
    with open(path, "w", newline="") as fp:
        w = csv.writer(fp)
        w.writerow(["Incident Zip"])
        for _ in range(n):
            w.writerow([rng.choice(zips)])
    return path


def run_reference_python(path: str) -> list:
    import csv

    out = []
    seen = set()
    with open(path, newline="") as fp:
        for row in csv.DictReader(fp):
            z = row["Incident Zip"]
            if z in NULL_VALUES:
                z = None
            z = fix_zip_codes(z)
            if z not in seen:
                seen.add(z)
                out.append(z)
    return out
