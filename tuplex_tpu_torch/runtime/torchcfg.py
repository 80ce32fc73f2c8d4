"""Device choice and numeric settings (counterpart of
`tuplex_tpu/runtime/jaxcfg.py`).

The reference package turns on JAX's x64 mode so Python ints are int64 and
floats float64 everywhere. Torch has no such switch, so every tensor this
package creates states its dtype (`I64`, `F64`, `I32`, `U8` below). TF32 is
turned off for matrix products and cuDNN so float32 math stays IEEE
float32 on the card.

Entry points run on CUDA unless the caller asks for the CPU
(`Context(device="cpu")`); with no device asked for and no CUDA present
they raise instead of falling back.
"""

from __future__ import annotations

import torch

from ..core.errors import TuplexException

I64 = torch.int64
F64 = torch.float64
I32 = torch.int32
U8 = torch.uint8

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The device a Context runs on: CUDA by default, the CPU only when the
    caller names it."""
    if device is None:
        if not torch.cuda.is_available():
            raise TuplexException(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise TuplexException(f"device {device!r} asked for, but CUDA "
                                  "is not available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise TuplexException(f"unsupported device {device!r}")
    return dev
