"""Local-file input resolution (counterpart of `tuplex_tpu/io/vfs.py`).

The reference dispatches URIs by scheme to posix or object-store backends
(reference: io/include/VirtualFileSystem.h). This package reads local files
only; a `file://` prefix is accepted and stripped.
"""

from __future__ import annotations

import glob as _glob
import os


class VirtualFileSystem:
    @staticmethod
    def _strip(uri: str) -> str:
        return uri.split("://", 1)[1] if uri.startswith("file://") else uri

    @classmethod
    def glob_input(cls, pattern: str) -> list[str]:
        """Comma-separated patterns / dirs / globs -> file list (reference:
        FileInputOperator detectFiles)."""
        out: list[str] = []
        for pat in pattern.split(","):
            pat = pat.strip()
            if not pat:
                continue
            if "://" in pat and not pat.startswith("file://"):
                raise ValueError(f"only local files are readable: {pat!r}")
            p = cls._strip(pat)
            if os.path.isdir(p):
                out.extend(sorted(
                    os.path.join(p, f) for f in os.listdir(p)
                    if os.path.isfile(os.path.join(p, f))))
            elif os.path.isfile(p):
                out.append(p)
            else:
                out.extend(sorted(_glob.glob(p)))
        return out

    @classmethod
    def open_read(cls, uri: str, mode: str = "rb"):
        return open(cls._strip(uri), mode)
