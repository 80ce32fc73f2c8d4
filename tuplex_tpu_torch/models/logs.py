"""Apache Common Log Format lines and the client/server-error grep
(counterpart of `tuplex_tpu/models/logs.py`: `gen_logline` and
`generate_log` are copies of the reference package's generator, so a seed
gives the same lines in both packages).

The grep keeps the lines whose status code is 4xx or 5xx and returns each
line's first field (the client address):

    ds.filter(lambda line: re.search(r'" (4\\d\\d|5\\d\\d) ', line))
      .map(lambda line: line[:line.find(" ")])

The unanchored alternation is outside the reference's anchored regex
engine, so both packages compile the filter to the NFA scan.
"""

from __future__ import annotations

import random
import re

ERROR_STATUS = r'" (4\d\d|5\d\d) '

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
