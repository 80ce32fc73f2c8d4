"""tuplex_tpu_torch — the PyTorch/CUDA port of tuplex_tpu.

The same Spark-like API and dual-mode execution as `tuplex_tpu`, written in
PyTorch for an NVIDIA H100: normal-case rows run as torch ops and
hand-written CUDA kernels on the card, rows that raise re-run on the
CPython interpreter, and the results merge back in order.

    import tuplex_tpu_torch as tuplex
    c = tuplex.Context()                 # the CUDA device
    c.parallelize([1, 2, None, 4]).map(lambda x: (x, x * x)).collect()

`Context(device="cpu")` runs the same plan on the CPU. This package imports
neither jax nor tuplex_tpu.
"""

from .core.errors import TuplexException

__version__ = "0.1.0"

__all__ = ["Context", "DataSet", "Metrics", "TuplexException",
           "__version__"]


def __getattr__(name):
    # lazy: importing the package must not import torch
    if name == "Context":
        from .api.context import Context
        return Context
    if name == "DataSet":
        from .api.dataset import DataSet
        return DataSet
    if name == "Metrics":
        from .api.metrics import Metrics
        return Metrics
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
