"""Exception-code lattice for dual-mode execution.

On device, every fused pipeline computes a per-row int32 error code alongside
its outputs; code 0 means the row took the normal path. Non-zero rows are
masked out of device outputs and shipped to the interpreter resolve path.

Re-designs the reference's exception-code enum + exception partitions
(reference: tuplex/utils/include/ExceptionCodes.h:24-118, compiled branch to
exception_handler_f at core/include/physical/CodeDefs.h:43) as a vectorized
code lattice: composed ops propagate the FIRST error per row (lower op index
wins), matching sequential Python semantics.
"""

from __future__ import annotations

import enum


class ExceptionCode(enum.IntEnum):
    OK = 0
    # Python exception classes reproducible by compiled paths
    ZERODIVISIONERROR = 1
    VALUEERROR = 2
    TYPEERROR = 3
    INDEXERROR = 4
    KEYERROR = 5
    ATTRIBUTEERROR = 6
    OVERFLOWERROR = 7
    STOPITERATION = 8
    ASSERTIONERROR = 9
    # internal codes (reference: ExceptionCodes.h NORMALCASEVIOLATION etc.)
    NORMALCASEVIOLATION = 100
    BADPARSE_STRING_INPUT = 101
    NULLERROR = 102            # unexpected None on a non-Option path
    GENERALCASEVIOLATION = 103
    LOOPCAPEXCEEDED = 104      # while-loop unroll cap hit: interpreter row
    PYTHON_FALLBACK = 110      # UDF not compilable: row routed to interpreter
    UNKNOWN = 120


_PY_TO_CODE = {
    ZeroDivisionError: ExceptionCode.ZERODIVISIONERROR,
    ValueError: ExceptionCode.VALUEERROR,
    TypeError: ExceptionCode.TYPEERROR,
    IndexError: ExceptionCode.INDEXERROR,
    KeyError: ExceptionCode.KEYERROR,
    AttributeError: ExceptionCode.ATTRIBUTEERROR,
    OverflowError: ExceptionCode.OVERFLOWERROR,
    StopIteration: ExceptionCode.STOPITERATION,
    AssertionError: ExceptionCode.ASSERTIONERROR,
}
# code (int) -> Python exception class, None for the internal codes; a
# plain dict, so the exact exit classifies a row with one lookup
_CODE_INT_TO_PY = {int(c): None for c in ExceptionCode}
_CODE_INT_TO_PY.update({int(c): cls for cls, c in _PY_TO_CODE.items()})
_CODE_INT_TO_NAME = {
    int(c): (cls.__name__ if cls is not None else ExceptionCode(c).name)
    for c, cls in _CODE_INT_TO_PY.items()}


def exception_class_for_code(code: int):
    """The Python exception class a device code stands for, or None for an
    internal code (the row's outcome is not known until it re-runs)."""
    return _CODE_INT_TO_PY.get(code)


def exception_name(code: int) -> str:
    """The class name of an exact code ('ValueError'), the enum name of an
    internal one, or 'code<n>' for a code outside the enum."""
    name = _CODE_INT_TO_NAME.get(code)
    return name if name is not None else f"code{code}"


def code_for_name(name: str):
    """The ExceptionCode of an exception class's name ('ValueError' ->
    VALUEERROR), or None when no code has that name."""
    return ExceptionCode.__members__.get(name.upper()) if name else None


# Packed device-lattice layout: exception-class code in the low byte,
# logical-operator id above it. One int32 per row carries both — a second
# per-row operator lattice measured a 20x kLoop recompute pathology on
# XLA-CPU. Operator ids are process-global and unbounded; ids that would
# overflow the 23 bits left in an int32 pack as 0 ("unknown operator") —
# attribution degrades, correctness (the class code) never does.
_OP_ID_LIMIT = 1 << 23


def pack_device_code(code: int, op_id: int) -> int:
    if not 0 < op_id < _OP_ID_LIMIT:
        op_id = 0
    return int(code) | (op_id << 8)


def unpack_device_codes(codes):
    """(code, operator id) pairs of a numpy array of packed lattice values,
    unpacked in two vector operations."""
    return zip((codes & 0xFF).tolist(), (codes >> 8).tolist())


class TuplexException(Exception):
    """Driver-side framework error (not a per-row exception)."""


class NotCompilable(TuplexException):
    """Raised by the emitter when a UDF uses constructs outside the compiled
    subset; the operator then runs rows on the interpreter path (reference:
    fallback mode, python/tests/test_fallback.py semantics)."""
