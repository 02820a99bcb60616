"""TTL + LRU result cache (reference moka caches: query_engine.rs:117-211,
performance/cache_manager.rs:5-91)."""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Any, Generic, Hashable, Optional, Tuple, TypeVar

__all__ = ["TtlCache"]

V = TypeVar("V")


class TtlCache(Generic[V]):
    def __init__(self, max_size: int = 50_000, ttl_s: float = 1800.0):
        self.max_size = max_size
        self.ttl_s = ttl_s
        self._lock = threading.Lock()
        self._data: "OrderedDict[Hashable, Tuple[float, V]]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, key: Hashable) -> Optional[V]:
        now = time.monotonic()
        with self._lock:
            item = self._data.get(key)
            if item is None or now - item[0] > self.ttl_s:
                if item is not None:
                    del self._data[key]
                self.misses += 1
                return None
            self._data.move_to_end(key)
            self.hits += 1
            return item[1]

    def put(self, key: Hashable, value: V) -> None:
        now = time.monotonic()
        with self._lock:
            self._data[key] = (now, value)
            self._data.move_to_end(key)
            while len(self._data) > self.max_size:
                self._data.popitem(last=False)

    def invalidate_all(self) -> None:
        with self._lock:
            self._data.clear()

    def __len__(self) -> int:
        return len(self._data)

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0
