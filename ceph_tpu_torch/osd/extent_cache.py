"""Stripe-granular extent cache for the EC read-modify-write pipeline.

The analog of the reference's ExtentCache (src/osd/ExtentCache.h:120):
there it keeps in-flight write extents so overlapping RMW ops read from
the cache rather than racing disk; here do_op already serializes writes
per PG, so the cache's job is the sequential-overwrite hot path -- a
small overwrite re-reads the stripes the previous overwrite just wrote,
and those bytes are sitting right here.  Entries are whole stripes of
LOGICAL bytes keyed (oid, stripe_index), LRU-evicted under a byte
budget, and invalidated whenever shard content changes outside the RMW
path (recovery pushes, backfill, peering resets).
"""

from __future__ import annotations

from collections import OrderedDict


class ExtentCache:
    def __init__(self, max_bytes: int = 8 << 20) -> None:
        self.max_bytes = max_bytes
        self._lru: OrderedDict[tuple[str, int], bytes] = OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0

    def get(self, oid: str, stripe: int) -> bytes | None:
        entry = self._lru.get((oid, stripe))
        if entry is None:
            self.misses += 1
            return None
        self.hits += 1
        self._lru.move_to_end((oid, stripe))
        return entry

    def put(self, oid: str, stripe: int, data: bytes) -> None:
        key = (oid, stripe)
        old = self._lru.pop(key, None)
        if old is not None:
            self._bytes -= len(old)
        self._lru[key] = data
        self._bytes += len(data)
        while self._bytes > self.max_bytes and self._lru:
            _, evicted = self._lru.popitem(last=False)
            self._bytes -= len(evicted)

    def invalidate(self, oid: str) -> None:
        for key in [k for k in self._lru if k[0] == oid]:
            self._bytes -= len(self._lru.pop(key))

    def truncate_beyond(self, oid: str, stripe: int) -> None:
        """Drop cached stripes at index >= stripe (object shrank)."""
        for key in [k for k in self._lru
                    if k[0] == oid and k[1] >= stripe]:
            self._bytes -= len(self._lru.pop(key))

    def clear(self) -> None:
        self._lru.clear()
        self._bytes = 0

    @property
    def used_bytes(self) -> int:
        return self._bytes
