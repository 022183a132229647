"""Encoder-output cache shared across requests.

Counterpart of the JAX package's ``worker/encoder_cache.py``: a
byte-budgeted LRU of whole encoder outputs (the projected image rows, on
the device), keyed by ``MMInputs.content_hash()``, the key that also feeds
the KV page hashes. The same image in two requests is encoded once, and a
preempted request that resumes is not encoded again.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Optional


class EncoderCache:

    def __init__(self, budget_bytes: int = 512 * 1024 * 1024) -> None:
        self.budget = budget_bytes
        self._entries: OrderedDict[Any, Any] = OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    @staticmethod
    def _nbytes(embeds) -> int:
        return getattr(embeds, "nbytes", 0) or 0

    def get(self, key) -> Optional[Any]:
        if key is None:
            return None
        e = self._entries.get(key)
        if e is None:
            self.misses += 1
            return None
        self._entries.move_to_end(key)
        self.hits += 1
        return e

    def put(self, key, embeds) -> None:
        if key is None:
            return
        n = self._nbytes(embeds)
        if n > self.budget:
            return  # larger than the whole budget: never cached
        old = self._entries.pop(key, None)
        if old is not None:
            self._bytes -= self._nbytes(old)
        while self._bytes + n > self.budget and self._entries:
            _, victim = self._entries.popitem(last=False)
            self._bytes -= self._nbytes(victim)
            self.evictions += 1
        self._entries[key] = embeds
        self._bytes += n

    @property
    def num_entries(self) -> int:
        return len(self._entries)

    def stats_dict(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "entries": self.num_entries,
                "bytes": self._bytes}
