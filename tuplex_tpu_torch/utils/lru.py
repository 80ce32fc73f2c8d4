"""Bounded LRU dict for the UDF source memo (utils/reflection.py) and the
device constants of ops/strings.py.

Reads refresh recency and an insert past the cap evicts only the single
oldest entry, so a steady workload keeps its warm entries (a grow-then-
clear memo drops all of them at once)."""

from __future__ import annotations

from collections import OrderedDict


class LruDict:
    """Minimal LRU mapping. Not thread-safe by itself; the memos it backs
    are only touched under the GIL from planning and stage code."""

    __slots__ = ("_store", "capacity")

    def __init__(self, capacity: int = 256):
        if capacity <= 0:
            raise ValueError("LruDict capacity must be positive")
        self._store: OrderedDict = OrderedDict()
        self.capacity = capacity

    def __getitem__(self, key):
        v = self._store[key]
        self._store.move_to_end(key)
        return v

    def __setitem__(self, key, value) -> None:
        self._store[key] = value
        self._store.move_to_end(key)
        while len(self._store) > self.capacity:
            self._store.popitem(last=False)

    def __contains__(self, key) -> bool:
        return key in self._store
