"""Apache Common Log Format pipelines (counterpart of
`tuplex_tpu/models/logs.py`; reference: Tuplex's benchmarks/logs).

`gen_logline` and `generate_log` are copies of the reference package's
generator, so a seed gives the same lines in both packages.

* The weblogs benchmark, `build_pipeline(ds, mode)`: each line parsed
  into a dict row, by find/rfind/slice chains (`ParseWithStrip`) or by the
  anchored nine-group regex (`ParseWithRegex`), then the rows with an
  endpoint kept. `COLUMNS`, the parse functions, `build_pipeline` and
  `run_reference_python` are copies of the reference's. Both compile: the
  strip variant to string kernels and a named row, the regex variant to
  the anchored engine (ops/regex.py), whose suspect rows interpret.
* The client/server-error grep, `build_grep`: the lines whose status code
  is 4xx or 5xx, each line's first field (the client address). The
  unanchored alternation is outside the anchored engine, so the filter is
  the NFA scan's truth value alone.
* The error grep with the status captured, `build_status_grep`: the same
  lines as (client, status). The filter is the NFA scan's truth value;
  the map's groups come from the NFA's leftmost match start
  (`NFARegex.match_start`) and the anchored engine at that offset.
"""

from __future__ import annotations

import random
import re

ERROR_STATUS = r'" (4\d\d|5\d\d) '
ERROR_LINE = r'" [45]\d\d '
STATUS_GROUPS = r'" ([45]\d\d) (\S+)'
# ParseWithRegex's pattern
WEBLOGS_REGEX = (r'^(\S+) (\S+) (\S+) \[([\w:/]+\s[+\-]\d{4})\] "(\S+) (\S+)'
                 r'\s*(\S*)\s*" (\d{3}) (\S+)')

COLUMNS = ["ip", "client_id", "user_id", "date", "method", "endpoint",
           "protocol", "response_code", "content_size"]


def ParseWithStrip(x):
    y = x

    i = y.find(" ")
    ip = y[:i]
    y = y[i + 1:]

    i = y.find(" ")
    client_id = y[:i]
    y = y[i + 1:]

    i = y.find(" ")
    user_id = y[:i]
    y = y[i + 1:]

    i = y.find("]")
    date = y[:i][1:]
    y = y[i + 2:]

    y = y[y.find('"') + 1:]

    method = ""
    endpoint = ""
    protocol = ""
    failed = False
    if y.find(" ") < y.rfind('"'):
        i = y.find(" ")
        method = y[:i]
        y = y[i + 1:]

        i = y.find(" ")
        endpoint = y[:i]
        y = y[i + 1:]

        i = y.rfind('"')
        protocol = y[:i]
        protocol = protocol[protocol.rfind(" ") + 1:]
        y = y[i + 2:]
    else:
        failed = True
        i = y.rfind('"')
        y = y[i + 2:]

    i = y.find(" ")
    response_code = y[:i]
    content_size = y[i + 1:]

    if not failed:
        return {"ip": ip,
                "client_id": client_id,
                "user_id": user_id,
                "date": date,
                "method": method,
                "endpoint": endpoint,
                "protocol": protocol,
                "response_code": int(response_code),
                "content_size": 0 if content_size == "-" else
                int(content_size)}
    else:
        return {"ip": "",
                "client_id": "",
                "user_id": "",
                "date": "",
                "method": "",
                "endpoint": "",
                "protocol": "",
                "response_code": -1,
                "content_size": -1}


def ParseWithRegex(logline):
    match = re.search(
        r'^(\S+) (\S+) (\S+) \[([\w:/]+\s[+\-]\d{4})\] "(\S+) (\S+)\s*(\S*)'
        r'\s*" (\d{3}) (\S+)', logline)
    if match is None:
        return {"ip": "", "client_id": "", "user_id": "", "date": "",
                "method": "", "endpoint": "", "protocol": "",
                "response_code": -1, "content_size": -1}
    size_field = match.group(9)
    size = 0 if size_field == "-" else int(size_field)
    return {"ip": match.group(1), "client_id": match.group(2),
            "user_id": match.group(3), "date": match.group(4),
            "method": match.group(5), "endpoint": match.group(6),
            "protocol": match.group(7),
            "response_code": int(match.group(8)), "content_size": size}


def build_pipeline(ds, mode: str = "strip"):
    """map(parse).filter(len(endpoint) > 0), as Tuplex's runtuplex.py."""
    fn = ParseWithStrip if mode == "strip" else ParseWithRegex
    return ds.map(fn).filter(lambda x: len(x["endpoint"]) > 0)


def run_reference_python(path: str, mode: str = "strip") -> list:
    """The weblogs pipeline as a plain Python loop: rows as tuples in
    COLUMNS order, lines that raise skipped."""
    fn = ParseWithStrip if mode == "strip" else ParseWithRegex
    out = []
    with open(path, encoding="utf-8") as fp:
        for line in fp:
            line = line.rstrip("\n")
            try:
                d = fn(line)
                if len(d["endpoint"]) > 0:
                    out.append(tuple(d[c] for c in COLUMNS))
            except Exception:
                continue
    return out


_METHODS = ["GET", "POST", "HEAD"]
_ENDPOINTS = ["/index.html", "/images/logo.gif", "/about", "/~user/page",
              "/api/v1/items", "/search?q=x"]


def gen_logline(rng: random.Random) -> str:
    if rng.random() < 0.03:   # malformed request line
        return (f"{rng.randint(1,255)}.{rng.randint(0,255)}.0.1 - - "
                f"[01/Jul/1995:00:00:0{rng.randint(0,9)} -0400] "
                f'"garbage" 400 -')
    ip = f"{rng.randint(1,255)}.{rng.randint(0,255)}.{rng.randint(0,255)}.{rng.randint(1,254)}"
    size = rng.choice(["-", str(rng.randint(100, 99999))])
    return (f"{ip} - - [0{rng.randint(1,9)}/Jul/1995:12:{rng.randint(10,59)}:"
            f"{rng.randint(10,59)} -0400] "
            f'"{rng.choice(_METHODS)} {rng.choice(_ENDPOINTS)} HTTP/1.0" '
            f"{rng.choice([200, 200, 200, 304, 404])} {size}")


def generate_log(path: str, n: int, seed: int = 17,
                 non_ascii_every: int = 0) -> str:
    """Write n lines from `gen_logline`. With `non_ascii_every` = k > 0,
    every k-th line (0-based index k-1, 2k-1, ...) gets a non-ASCII user
    field, which sends it through the interpreter path of both packages."""
    rng = random.Random(seed)
    lines = []
    for i in range(n):
        line = gen_logline(rng)
        if non_ascii_every and (i + 1) % non_ascii_every == 0:
            line = line.replace(" - - ", " - élève ", 1)
        lines.append(line)
    with open(path, "w", encoding="utf-8") as fp:
        fp.write("\n".join(lines) + "\n")
    return path


def build_grep(ds):
    """The error grep over a DataSet of lines."""
    is_error = lambda line: re.search(r'" (4\d\d|5\d\d) ', line)  # noqa: E731
    client = lambda line: line[:line.find(" ")]  # noqa: E731
    return ds.filter(is_error).map(client)


def run_grep_reference(path: str) -> list:
    """The grep as a plain Python loop over the file, read the way the
    text source reads it."""
    with open(path, "rb") as fp:
        text = fp.read().decode("utf-8", errors="replace")
    return [line[:line.find(" ")] for line in text.splitlines()
            if re.search(ERROR_STATUS, line)]


def build_status_grep(ds):
    """The error grep with the status code captured: (client, status) of
    each 4xx or 5xx line."""
    is_error = lambda line: re.search(r'" [45]\d\d ', line)  # noqa: E731
    status = lambda line: (  # noqa: E731
        line[:line.find(" ")],
        int(re.search(r'" ([45]\d\d) (\S+)', line).group(1)))
    return ds.filter(is_error).map(status)


def run_status_grep_reference(path: str) -> list:
    """The status grep as a plain Python loop over the file, read the way
    the text source reads it."""
    with open(path, "rb") as fp:
        text = fp.read().decode("utf-8", errors="replace")
    return [(line[:line.find(" ")],
             int(re.search(STATUS_GROUPS, line).group(1)))
            for line in text.splitlines() if re.search(ERROR_LINE, line)]
