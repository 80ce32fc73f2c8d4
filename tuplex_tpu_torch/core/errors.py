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


class TuplexException(Exception):
    """Driver-side framework error (not a per-row exception)."""


class NotCompilable(TuplexException):
    """Raised by the emitter when a UDF uses constructs outside the compiled
    subset; the operator then runs rows on the interpreter path (reference:
    fallback mode, python/tests/test_fallback.py semantics)."""
