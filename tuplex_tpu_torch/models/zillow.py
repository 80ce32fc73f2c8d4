"""The Zillow dirty-data cleaning pipeline Z1, the reference package's
headline benchmark (counterpart of `tuplex_tpu/models/zillow.py`; reference:
benchmarks/zillow/Z1/runtuplex.py — extractBd/Ba/Sqft/Type/Offer/Price plus
filters; data schema from benchmarks/zillow/data).

The UDFs re-implement the benchmark's published cleaning logic (they are
the workload, so their semantics must not change), plus a synthetic
dirty-data generator, so the benchmark runs without the original scraped
dataset. This package keeps its own copy: it imports nothing of
`tuplex_tpu`. The generator writes the same bytes as the reference
package's for the same seed.
"""

from __future__ import annotations

import random

COLUMNS = ["title", "address", "city", "state", "postal_code", "price",
           "facts and features", "real estate provider", "url", "sales_date"]


# --- the cleaning UDFs (workload under test) --------------------------------

def extractBd(x):
    val = x["facts and features"]
    max_idx = val.find(" bd")
    if max_idx < 0:
        max_idx = len(val)
    s = val[:max_idx]
    split_idx = s.rfind(",")
    if split_idx < 0:
        split_idx = 0
    else:
        split_idx += 2
    r = s[split_idx:]
    return int(r)


def extractBa(x):
    val = x["facts and features"]
    max_idx = val.find(" ba")
    if max_idx < 0:
        max_idx = len(val)
    s = val[:max_idx]
    split_idx = s.rfind(",")
    if split_idx < 0:
        split_idx = 0
    else:
        split_idx += 2
    r = s[split_idx:]
    return int(r)


def extractSqft(x):
    val = x["facts and features"]
    max_idx = val.find(" sqft")
    if max_idx < 0:
        max_idx = len(val)
    s = val[:max_idx]
    split_idx = s.rfind("ba ,")
    if split_idx < 0:
        split_idx = 0
    else:
        split_idx += 5
    r = s[split_idx:]
    r = r.replace(",", "")
    return int(r)


def extractOffer(x):
    offer = x["title"].lower()
    if "sale" in offer:
        return "sale"
    if "rent" in offer:
        return "rent"
    if "sold" in offer:
        return "sold"
    if "foreclose" in offer:
        return "foreclosed"
    return offer


def extractType(x):
    t = x["title"].lower()
    type_ = "unknown"
    if "condo" in t or "apartment" in t:
        type_ = "condo"
    if "house" in t:
        type_ = "house"
    return type_


def extractPrice(x):
    price = x["price"]
    p = 0
    if x["offer"] == "sold":
        val = x["facts and features"]
        s = val[val.find("Price/sqft:") + len("Price/sqft:") + 1:]
        r = s[s.find("$") + 1: s.find(", ") - 1]
        price_per_sqft = int(r)
        p = price_per_sqft * x["sqft"]
    elif x["offer"] == "rent":
        max_idx = price.rfind("/")
        p = int(price[1:max_idx].replace(",", ""))
    else:
        p = int(price[1:].replace(",", ""))
    return p


def build_pipeline(ds):
    """The Z1 chain (reference: runtuplex.py pipeline body)."""
    return (ds
            .withColumn("bedrooms", extractBd)
            .filter(lambda x: x["bedrooms"] < 10)
            .withColumn("type", extractType)
            .filter(lambda x: x["type"] == "house")
            .withColumn("zipcode", lambda x: "%05d" % int(x["postal_code"]))
            .mapColumn("city", lambda x: x[0].upper() + x[1:].lower())
            .withColumn("bathrooms", extractBa)
            .withColumn("sqft", extractSqft)
            .withColumn("offer", extractOffer)
            .withColumn("price", extractPrice)
            .filter(lambda x: 100000 < x["price"] <= 2e7)
            .selectColumns(OUT_COLUMNS))


# --- synthetic dirty data ---------------------------------------------------

_CITIES = ["boston", "CAMBRIDGE", "Somerville", "newton", "BROOKLINE",
           "quincy", "medford", "arlington"]
_STATES = ["MA", "NY", "CA", "WA"]
_TITLES_SALE = ["House For Sale", "Colonial house for sale",
                "New construction house - for sale!", "Big house for sale"]
_TITLES_RENT = ["Condo for rent", "Apartment For Rent", "Studio for rent"]
_TITLES_SOLD = ["House recently sold", "Sold: lovely house"]
_PROVIDERS = ["RE/MAX", "Zillow", "Coldwell Banker", "agent"]


def gen_row(rng: random.Random) -> dict:
    kind = rng.random()
    bd = rng.randint(1, 12)
    ba = rng.randint(1, 5)
    sqft = rng.randint(400, 9000)
    dirty = rng.random()
    if kind < 0.55:
        title = rng.choice(_TITLES_SALE)
        price = f"${rng.randint(100, 3000) * 1000:,}"
    elif kind < 0.8:
        title = rng.choice(_TITLES_RENT)
        price = f"${rng.randint(800, 9000):,}/mo"
    else:
        title = rng.choice(_TITLES_SOLD)
        price = "--"
    facts = f"{bd} bds , {ba} ba , {sqft:,} sqft"
    if kind >= 0.8:
        facts += f" , Price/sqft: ${rng.randint(100, 900)} , more"
    # dirt: ~4% rows have broken facts; ~2% broken postal codes
    if dirty < 0.04:
        facts = rng.choice(["studio , no data", "-- , contact agent", ""])
    postal = f"{rng.randint(1000, 99999):05d}"
    if 0.04 <= dirty < 0.06:
        postal = rng.choice(["N/A", "0210A", ""])
    return {
        "title": title,
        "address": f"{rng.randint(1, 999)} Main St",
        "city": rng.choice(_CITIES),
        "state": rng.choice(_STATES),
        "postal_code": postal,
        "price": price,
        "facts and features": facts,
        "real estate provider": rng.choice(_PROVIDERS),
        "url": f"https://example.com/homes/{rng.randint(10**6, 10**7)}",
        "sales_date": f"202{rng.randint(0,5)}-0{rng.randint(1,9)}-1{rng.randint(0,9)}",
    }


def generate_csv(path: str, n_rows: int, seed: int = 42) -> str:
    import csv

    rng = random.Random(seed)
    with open(path, "w", newline="") as fp:
        w = csv.DictWriter(fp, fieldnames=COLUMNS)
        w.writeheader()
        for _ in range(n_rows):
            w.writerow(gen_row(rng))
    return path


OUT_COLUMNS = ["url", "zipcode", "address", "city", "state", "bedrooms",
               "bathrooms", "sqft", "offer", "type", "price"]


def run_reference_python(path: str) -> list:
    """Pure-CPython implementation of the Z1 pipeline: the golden output
    (reference analog: the pure-python comparison scripts in
    benchmarks/zillow)."""
    import csv

    out = []
    with open(path, newline="") as fp:
        for row in csv.DictReader(fp):
            try:
                x = dict(row)
                x["bedrooms"] = extractBd(x)
                if not x["bedrooms"] < 10:
                    continue
                x["type"] = extractType(x)
                if x["type"] != "house":
                    continue
                x["zipcode"] = "%05d" % int(x["postal_code"])
                c = x["city"]
                x["city"] = c[0].upper() + c[1:].lower()
                x["bathrooms"] = extractBa(x)
                x["sqft"] = extractSqft(x)
                x["offer"] = extractOffer(x)
                x["price"] = extractPrice(x)
                if not 100000 < x["price"] <= 2e7:
                    continue
                out.append(tuple(x[c] for c in OUT_COLUMNS))
            except Exception:
                continue
    return out


def exception_counts_python(path: str) -> dict:
    """The first exception of each row through Z1 in plain CPython, by
    class, the cells decoded as the CSV source speculates them: an empty
    cell is None, a postal code an int where it parses."""
    import csv

    chain = [("bedrooms", extractBd),
             (None, lambda x: x["bedrooms"] < 10),
             ("type", extractType),
             (None, lambda x: x["type"] == "house"),
             ("zipcode", lambda x: "%05d" % int(x["postal_code"])),
             ("city", lambda x: x["city"][0].upper() + x["city"][1:].lower()),
             ("bathrooms", extractBa), ("sqft", extractSqft),
             ("offer", extractOffer), ("price", extractPrice),
             (None, lambda x: 100000 < x["price"] <= 2e7)]
    counts: dict = {}
    with open(path, newline="") as fp:
        for row in csv.DictReader(fp):
            x = {k: (None if v == "" else v) for k, v in row.items()}
            try:
                x["postal_code"] = int(x["postal_code"])
            except (TypeError, ValueError):
                pass
            for col, f in chain:
                try:
                    v = f(x)
                except Exception as e:
                    name = type(e).__name__
                    counts[name] = counts.get(name, 0) + 1
                    break
                if col is None and not v:
                    break
                if col is not None:
                    x[col] = v
    return counts
