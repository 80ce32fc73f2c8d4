"""Flat key-value config system.

Keeps the reference's option names (reference: core/src/ContextOptions.cc:198-250
release defaults; python/tuplex/context.py:147-187 normalization) so pipelines
written against tuplex/tuplex configure this framework unchanged.

Values are stored stringly (like the reference) with typed getters; inputs may
be nested dicts, kwargs or a YAML/JSON file, flattened to `tuplex.`-prefixed
keys.
"""

from __future__ import annotations

import json
from typing import Any, Mapping


def _size_to_bytes(s: str | int | float) -> int:
    if isinstance(s, (int, float)):
        return int(s)
    s = s.strip()
    units = {
        "KB": 1 << 10, "MB": 1 << 20, "GB": 1 << 30, "TB": 1 << 40,
        "K": 1 << 10, "M": 1 << 20, "G": 1 << 30, "T": 1 << 40, "B": 1,
    }
    for suffix in sorted(units, key=len, reverse=True):
        if s.upper().endswith(suffix):
            return int(float(s[: -len(suffix)]) * units[suffix])
    return int(float(s))


def _to_bool(v: Any) -> bool:
    if isinstance(v, bool):
        return v
    return str(v).strip().lower() in ("true", "1", "yes", "on")


#: defaults mirror the reference's release table for the keys this
#: package reads
DEFAULTS: dict[str, str] = {
    "tuplex.partitionSize": "32MB",
    "tuplex.normalcaseThreshold": "0.9",
    "tuplex.optimizer.filterPushdown": "true",
    "tuplex.optimizer.filterBreakdown": "true",
    "tuplex.optimizer.operatorReordering": "false",
    "tuplex.optimizer.selectionPushdown": "true",
    "tuplex.csv.maxDetectionMemory": "256KB",
    "tuplex.csv.maxDetectionRows": "1000",
    "tuplex.sample.maxDetectionRows": "1000",
}


class ContextOptions:
    def __init__(self, conf: Mapping[str, Any] | None = None, **kwargs: Any):
        self._store: dict[str, str] = dict(DEFAULTS)
        if conf:
            self.update(conf)
        if kwargs:
            self.update(kwargs)

    # -- updates ------------------------------------------------------------
    def update(self, conf: Mapping[str, Any] | str) -> None:
        """Set the keys of a (nested) mapping, or of a JSON or `key: value`
        YAML file named by a path."""
        if isinstance(conf, str):
            with open(conf) as fp:
                text = fp.read()
            try:
                data = json.loads(text)
            except json.JSONDecodeError:
                data = _parse_simple_yaml(text)
            self.update(data)
            return
        for k, v in _flatten(conf).items():
            self._store[_normalize_key(k)] = _stringify(v)

    def set(self, key: str, value: Any) -> None:
        self._store[_normalize_key(key)] = _stringify(value)

    # -- getters ------------------------------------------------------------
    def get(self, key: str, default: Any = None) -> Any:
        return self._store.get(_normalize_key(key), default)

    def get_str(self, key: str, default: str = "") -> str:
        return str(self.get(key, default))

    def get_bool(self, key: str, default: bool = False) -> bool:
        v = self.get(key)
        return default if v is None else _to_bool(v)

    def get_int(self, key: str, default: int = 0) -> int:
        v = self.get(key)
        if v is None:
            return default
        if isinstance(v, str) and v == "auto":
            return default
        return int(float(v))

    def get_float(self, key: str, default: float = 0.0) -> float:
        v = self.get(key)
        return default if v is None else float(v)

    def get_size(self, key: str, default: int = 0) -> int:
        v = self.get(key)
        return default if v is None else _size_to_bytes(v)

    def as_dict(self) -> dict[str, str]:
        return dict(self._store)

    def __contains__(self, key: str) -> bool:
        return _normalize_key(key) in self._store

    def __repr__(self) -> str:
        return f"ContextOptions({len(self._store)} keys)"


def _normalize_key(key: str) -> str:
    # reference: context.py:183-187 — keys are normalized to tuplex.*
    return key if key.startswith("tuplex.") else "tuplex." + key


def _stringify(v: Any) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    return str(v)


def _flatten(d: Mapping[str, Any], prefix: str = "") -> dict[str, Any]:
    out: dict[str, Any] = {}
    for k, v in d.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, key))
        else:
            out[key] = v
    return out


def _parse_simple_yaml(text: str) -> dict[str, Any]:
    """The `key: value` subset of YAML, one key a line (dotted keys, no
    nesting by indentation), as `Context.optionsToYAML` writes it."""
    out: dict[str, Any] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#") or ":" not in line:
            continue
        k, _, v = line.partition(":")
        out[k.strip()] = v.strip().strip("\"'")
    return out
