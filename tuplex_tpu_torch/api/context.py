"""Public Context — the engine entry point (counterpart of
`tuplex_tpu/api/context.py`; reference: python/tuplex/context.py:50).

`Context()` runs on the CUDA device; `Context(device="cpu")` runs the same
plan on the CPU (the kernels' plain versions). With no device asked for and
no CUDA present it raises."""

from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence

from ..core import typesys as T
from ..core.errors import TuplexException
from ..core.options import ContextOptions
from ..exec.local import LocalBackend
from ..plan import logical as L
from ..runtime.torchcfg import resolve_device
from .metrics import Metrics


class Context:
    def __init__(self, conf: Mapping[str, Any] | str | None = None,
                 device=None, **kwargs):
        """`conf`: option keys (nested or dotted; the `tuplex.` prefix may
        be left out), or the path of a JSON or `key: value` YAML file of
        them (reference: context.py:50). Keyword arguments are options
        too."""
        self.options_store = ContextOptions(conf, **kwargs)
        self.device = resolve_device(device)
        self.backend = LocalBackend(self.device)
        self.metrics = Metrics()

    def parallelize(self, value_list: Sequence[Any],
                    columns: Optional[Sequence[str]] = None,
                    schema: Optional[T.RowType] = None) -> "DataSet":
        """A DataSet over Python values (reference: context.py:246). The
        normal-case schema is the majority type over a sample; rows outside
        it take the interpreter path."""
        from .dataset import DataSet

        data = list(value_list)
        if not data:
            raise TuplexException("parallelize: empty input")
        max_rows = self.options_store.get_int(
            "tuplex.sample.maxDetectionRows", 1000)
        threshold = self.options_store.get_float(
            "tuplex.normalcaseThreshold", 0.9)
        if schema is None:
            schema = _infer_row_schema(data[:max_rows], columns, threshold)
        elif columns:
            schema = T.row_of(columns, schema.types)
        return DataSet(self, L.ParallelizeOperator(data, schema,
                                                   sample_size=max_rows))

    def csv(self, pattern: str, columns=None, header=None, delimiter=None,
            quotechar: Optional[str] = None, null_values=None,
            type_hints=None) -> "DataSet":
        """Rows of CSV files (reference: context.py:147). The delimiter,
        header, column names and normal-case column types are sniffed from
        the first file's first 256KB unless given; cells decode to their
        types on the device."""
        from ..io.csvsource import make_csv_operator
        from .dataset import DataSet

        return DataSet(self, make_csv_operator(
            self.options_store, pattern, columns=columns, header=header,
            delimiter=delimiter, quotechar=quotechar, type_hints=type_hints,
            null_values=null_values))

    def text(self, pattern: str, null_values=None) -> "DataSet":
        """One row per line; lines equal to a null value load as None."""
        from ..io.csvsource import make_text_operator
        from .dataset import DataSet

        return DataSet(self, make_text_operator(self.options_store, pattern,
                                                null_values=null_values))

    def options(self, nested: bool = False) -> dict:
        """Every option as {key: value string}; with `nested`, as a tree
        split at the dots (reference: context.py:184)."""
        flat = self.options_store.as_dict()
        if not nested:
            return flat
        out: dict = {}
        for k, v in flat.items():
            cur = out
            ks = k.split(".")
            for piece in ks[:-1]:
                nxt = cur.setdefault(piece, {})
                if not isinstance(nxt, dict):   # a leaf, then its group
                    nxt = cur[piece] = {"": nxt}
                cur = nxt
            if isinstance(cur.get(ks[-1]), dict):
                cur[ks[-1]][""] = v             # a group, then its leaf
            else:
                cur[ks[-1]] = v
        return out

    def optionsToYAML(self, file_path: str = "config.yaml") -> None:
        """Write every option as a `key: value` line, sorted by key; the
        file is a `conf` for a later Context."""
        with open(file_path, "w") as fp:
            for k, v in sorted(self.options_store.as_dict().items()):
                fp.write(f"{k}: {v}\n")


def _infer_row_schema(sample: list, columns, threshold: float) -> T.RowType:
    """Column-wise normal-case speculation (reference: PythonContext.cc:1023
    inferType — majority type over the sample)."""
    tuples = [v for v in sample if isinstance(v, tuple)]
    if tuples and len(tuples) >= threshold * len(sample):
        k = len(tuples[0])
        if all(len(t) == k for t in tuples):
            types = [T.normal_case_type([t[ci] for t in tuples],
                                        threshold)[0] for ci in range(k)]
            names = list(columns) if columns else [f"_{i}" for i in range(k)]
            if len(names) != k:
                raise TuplexException(
                    f"{k} columns in data but {len(names)} names given")
            return T.row_of(names, types)
    nc, _, _ = T.normal_case_type(sample, threshold)
    names = list(columns) if columns else ["_0"]
    return T.row_of(names[:1], [nc])
