"""ObjectCacher: client-side write-back cache over object extents.

src/osdc/ObjectCacher.cc role, async-native: librbd (and the CephFS
client) buffer writes as DIRTY extents and ack immediately; a
background flusher writes them back within ``flush_interval``; writers
throttle when dirty bytes pass ``max_dirty`` (ObjectCacher's
dirty/tx state machine + flusher thread, compressed to the extent
granularity this client actually uses).

States per extent: dirty (in cache only) -> tx (flush in flight;
concurrent writes copy-on-write a fresh dirty extent, never mutate an
in-flight buffer) -> clean (readable, evictable).  Reads overlay
dirty/tx/clean extents over a read-through of the missing ranges.

Flush barriers -- fsync/close, snapshot create, exclusive-lock loss --
call ``flush()``; fencing calls ``discard_all()`` (a fenced client's
dirty data must die, not land).

Port of ``ceph_tpu/client/object_cacher.py``; runs unchanged over the
port's librados.
"""

from __future__ import annotations

import asyncio
import time
from collections import OrderedDict

DIRTY = "dirty"
TX = "tx"
CLEAN = "clean"


class _Extent:
    __slots__ = ("off", "data", "state")

    def __init__(self, off: int, data: bytes, state: str) -> None:
        self.off = off
        self.data = bytearray(data)
        self.state = state

    @property
    def end(self) -> int:
        return self.off + len(self.data)


class ObjectCacher:
    def __init__(self, ioctx, *,
                 max_dirty: int = 32 << 20,
                 target_dirty: int = 16 << 20,
                 max_clean: int = 64 << 20,
                 flush_interval: float = 1.0) -> None:
        self.ioctx = ioctx
        self.max_dirty = max_dirty
        self.target_dirty = target_dirty
        self.max_clean = max_clean
        self.flush_interval = flush_interval
        # oid -> sorted list of non-overlapping extents
        self.objects: dict[str, list[_Extent]] = {}
        # incremental accounting: per-object byte sums roll up into
        # totals so the write-path throttle check is O(1), not a walk
        # of every cached extent
        self._obj_dirty: dict[str, int] = {}
        self._obj_total: dict[str, int] = {}
        self._dirty_total = 0
        self._cached_total = 0
        self._clean_lru: OrderedDict[str, None] = OrderedDict()
        self._flush_locks: dict[str, asyncio.Lock] = {}
        self._dirty_waiters: list[asyncio.Future] = []
        self._flusher: asyncio.Task | None = None
        self._stopped = False
        self.stats = {"hit_bytes": 0, "miss_bytes": 0,
                      "write_bytes": 0, "flush_ops": 0}

    # -- accounting -----------------------------------------------------------
    def dirty_bytes(self) -> int:
        return self._dirty_total

    def cached_bytes(self) -> int:
        return self._cached_total

    def _reaccount(self, oid: str) -> None:
        """Recompute one object's byte sums after its extent list
        changed; totals adjust by the delta (every mutation of
        self.objects[oid] must be followed by this)."""
        exts = self.objects.get(oid, [])
        dirty = sum(len(e.data) for e in exts
                    if e.state in (DIRTY, TX))
        total = sum(len(e.data) for e in exts)
        self._dirty_total += dirty - self._obj_dirty.get(oid, 0)
        self._cached_total += total - self._obj_total.get(oid, 0)
        if exts:
            self._obj_dirty[oid] = dirty
            self._obj_total[oid] = total
        else:
            self._obj_dirty.pop(oid, None)
            self._obj_total.pop(oid, None)

    # -- write ----------------------------------------------------------------
    async def write(self, oid: str, off: int, data: bytes) -> None:
        """Stage a write in cache; returns once buffered (NOT
        durable -- flush() is the durability barrier).  Throttles when
        dirty bytes exceed the cap (ObjectCacher::wait_for_write)."""
        self._ensure_flusher()
        self._merge(oid, off, bytes(data), DIRTY)
        self.stats["write_bytes"] += len(data)
        while self.dirty_bytes() > self.max_dirty:
            fut = asyncio.get_event_loop().create_future()
            self._dirty_waiters.append(fut)
            self._kick()
            await fut

    def _merge(self, oid: str, off: int, data: bytes,
               state: str) -> None:
        """Insert an extent, trimming whatever it overlaps.  A DIRTY
        insert never mutates a TX buffer (it is in flight): overlapped
        TX/CLEAN extents are trimmed out of the visible range and the
        new bytes win reads immediately."""
        exts = self.objects.setdefault(oid, [])
        end = off + len(data)
        keep: list[_Extent] = []
        for e in exts:
            if e.end <= off or e.off >= end:
                keep.append(e)
                continue
            # overlap: keep non-overlapping head/tail pieces
            if e.off < off:
                keep.append(_Extent(e.off,
                                    e.data[:off - e.off], e.state))
            if e.end > end:
                keep.append(_Extent(end, e.data[end - e.off:],
                                    e.state))
        keep.append(_Extent(off, data, state))
        keep.sort(key=lambda e: e.off)
        # coalesce adjacent same-state extents (bounds flush op count)
        out: list[_Extent] = []
        for e in keep:
            if out and out[-1].state == e.state \
                    and out[-1].end == e.off:
                out[-1].data += e.data
            else:
                out.append(e)
        self.objects[oid] = out
        self._reaccount(oid)
        if state == CLEAN:
            self._touch_clean(oid)

    # -- read -----------------------------------------------------------------
    async def read(self, oid: str, off: int, length: int,
                   reader=None) -> bytes:
        """Cached read: cache extents overlay a read-through of the
        missing ranges.  ``reader(off, length) -> bytes`` customizes
        the miss path (e.g. librbd's parent/clone fallback); default
        reads the object via the ioctx (short reads zero-fill)."""
        end = off + length
        exts = [e for e in self.objects.get(oid, [])
                if e.off < end and e.end > off]
        # missing ranges
        holes: list[tuple[int, int]] = []
        pos = off
        for e in sorted(exts, key=lambda e: e.off):
            if e.off > pos:
                holes.append((pos, e.off))
            pos = max(pos, e.end)
        if pos < end:
            holes.append((pos, end))
        buf = bytearray(length)
        hit = length
        for h0, h1 in holes:
            hit -= h1 - h0
            got = await self._read_through(oid, h0, h1 - h0, reader)
            buf[h0 - off:h0 - off + len(got)] = got
            # cache the miss as CLEAN -- but a concurrent write() may
            # have landed in this hole DURING the await, and stale
            # CLEAN bytes must never trim an acked DIRTY extent: clip
            # the insert to the ranges still uncovered right now
            for g0, g1 in self._uncovered(oid, h0, h1):
                self._merge(oid, g0, bytes(buf[g0 - off:g1 - off]),
                            CLEAN)
        self.stats["hit_bytes"] += hit
        for e in exts:
            s = max(e.off, off)
            t = min(e.end, end)
            buf[s - off:t - off] = e.data[s - e.off:t - e.off]
        # racing writes win the returned view too (read-your-writes
        # for a writer that overlapped our read-through)
        for e in self.objects.get(oid, []):
            if e.state in (DIRTY, TX) and e.off < end and e.end > off:
                s = max(e.off, off)
                t = min(e.end, end)
                buf[s - off:t - off] = e.data[s - e.off:t - e.off]
        self._touch_clean(oid)
        self._evict_clean()
        return bytes(buf)

    def _uncovered(self, oid: str, start: int,
                   end: int) -> list[tuple[int, int]]:
        """Sub-ranges of [start, end) no current extent covers."""
        out: list[tuple[int, int]] = []
        pos = start
        for e in sorted((e for e in self.objects.get(oid, [])
                         if e.off < end and e.end > start),
                        key=lambda e: e.off):
            if e.off > pos:
                out.append((pos, e.off))
            pos = max(pos, e.end)
        if pos < end:
            out.append((pos, end))
        return out

    async def _read_through(self, oid, off, length, reader) -> bytes:
        self.stats["miss_bytes"] += length
        if reader is not None:
            got = await reader(off, length)
        else:
            from .rados import RadosError
            try:
                got = await self.ioctx.read(oid, length=length,
                                            offset=off)
            except RadosError as e:
                if e.errno_name == "ENOENT":
                    got = b""
                else:
                    raise
        return bytes(got).ljust(length, b"\x00")

    # -- flush / invalidate ----------------------------------------------------
    async def flush(self, oid: str | None = None) -> None:
        """Write back every dirty extent (of one object or all);
        returns when the data is at the OSDs.  Per-object flushes
        serialize (in-flight TX buffers are never re-sent)."""
        oids = [oid] if oid is not None else list(self.objects)
        await asyncio.gather(*(self._flush_one(o) for o in oids))
        self._wake_waiters()

    async def _flush_one(self, oid: str) -> None:
        lock = self._flush_locks.setdefault(oid, asyncio.Lock())
        async with lock:
            dirty = [e for e in self.objects.get(oid, [])
                     if e.state == DIRTY]
            if not dirty:
                return
            for e in dirty:
                e.state = TX
            try:
                # offset order: overlapping writes were merged at
                # write time, so extents are disjoint and order is
                # only a determinism nicety
                for e in sorted(dirty, key=lambda e: e.off):
                    await self.ioctx.write(oid, bytes(e.data),
                                           offset=e.off)
                    self.stats["flush_ops"] += 1
            except BaseException:
                # flush failed: the data is NOT at the OSDs; put it
                # back to dirty so the next barrier retries (never
                # silently drop acked-to-app writes).  Scan the LIVE
                # list too: a racing write may have trimmed a TX
                # extent into fragments not in our snapshot
                for e in dirty + self.objects.get(oid, []):
                    if e.state == TX:
                        e.state = DIRTY
                self._reaccount(oid)
                raise
            for e in dirty + self.objects.get(oid, []):
                # every TX piece (snapshot originals AND fragments a
                # racing write trimmed them into) holds bytes the
                # writes above put on the OSDs: clean, evictable
                if e.state == TX:
                    e.state = CLEAN
            self._reaccount(oid)
            self._touch_clean(oid)
        self._evict_clean()

    async def invalidate(self, oid: str | None = None) -> None:
        """Flush dirty data, then drop the cache (watch/notify told us
        another client may have written: cached cleans are stale).
        Loops until no dirty remains: a write buffered DURING the
        flush must reach the OSDs, never be dropped by the pop."""
        while True:
            for o in ([oid] if oid is not None
                      else list(self.objects)):
                kept = [e for e in self.objects.get(o, [])
                        if e.state != CLEAN]
                if kept:
                    self.objects[o] = kept
                else:
                    self.objects.pop(o, None)
                    self._clean_lru.pop(o, None)
                self._reaccount(o)
            targets = ([oid] if oid is not None
                       else list(self.objects))
            if not any(e.state in (DIRTY, TX)
                       for o in targets
                       for e in self.objects.get(o, [])):
                return
            await self.flush(oid)

    def discard(self, oid: str) -> None:
        """Drop everything INCLUDING dirty data (object deleted, or
        this client was fenced -- its buffered writes must die)."""
        self.objects.pop(oid, None)
        self._clean_lru.pop(oid, None)
        self._reaccount(oid)
        self._wake_waiters()

    def discard_all(self) -> None:
        self.objects.clear()
        self._clean_lru.clear()
        self._obj_dirty.clear()
        self._obj_total.clear()
        self._dirty_total = 0
        self._cached_total = 0
        self._wake_waiters()

    async def close(self) -> None:
        self._stopped = True
        if self._flusher is not None:
            self._flusher.cancel()
            try:
                await self._flusher
            except (asyncio.CancelledError, Exception):
                pass
        await self.flush()

    # -- background flusher ----------------------------------------------------
    def _ensure_flusher(self) -> None:
        if self._stopped:
            return
        if self._flusher is None or self._flusher.done():
            self._flusher = asyncio.ensure_future(self._flush_loop())

    def _kick(self) -> None:
        self._ensure_flusher()

    async def _flush_loop(self) -> None:
        try:
            while not self._stopped:
                await asyncio.sleep(self.flush_interval
                                    if self.dirty_bytes()
                                    <= self.max_dirty else 0)
                try:
                    await self.flush()
                except Exception:
                    await asyncio.sleep(self.flush_interval)
                if not self.dirty_bytes() and not self._dirty_waiters:
                    return            # idle: next write restarts us
        except asyncio.CancelledError:
            pass

    def _wake_waiters(self) -> None:
        if self.dirty_bytes() <= self.target_dirty:
            waiters, self._dirty_waiters = self._dirty_waiters, []
            for fut in waiters:
                if not fut.done():
                    fut.set_result(None)

    # -- clean-side bound ------------------------------------------------------
    def _touch_clean(self, oid: str) -> None:
        self._clean_lru[oid] = None
        self._clean_lru.move_to_end(oid)

    def _evict_clean(self) -> None:
        over = self.cached_bytes() - self.max_clean \
            - self.dirty_bytes()
        if over <= 0:
            return
        for oid in list(self._clean_lru):
            exts = self.objects.get(oid, [])
            kept = [e for e in exts if e.state != CLEAN]
            over -= sum(len(e.data) for e in exts) \
                - sum(len(e.data) for e in kept)
            if kept:
                self.objects[oid] = kept
            else:
                self.objects.pop(oid, None)
            self._clean_lru.pop(oid, None)
            self._reaccount(oid)
            if over <= 0:
                return


class CachingIoCtx:
    """Duck-typed ioctx wrapper: object read/write go through an
    ObjectCacher, data-shape ops (truncate/remove) flush-then-
    invalidate, everything else passes through.  Lets any consumer
    that talks to an ioctx (the cephfs striper, tools) gain the
    write-back cache without knowing it exists."""

    def __init__(self, ioctx, cacher: ObjectCacher | None = None,
                 **kw) -> None:
        self.ioctx = ioctx
        self.cacher = cacher or ObjectCacher(ioctx, **kw)

    async def write(self, oid, data, offset: int = 0):
        await self.cacher.write(oid, offset, bytes(data))
        return len(data)

    async def read(self, oid, length=None, offset: int = 0, **kw):
        if kw.get("snap") is not None or length is None:
            # snap reads and whole-object reads bypass the cache (the
            # cache indexes head extents of known length); dirty data
            # must land first so the passthrough sees it
            await self.cacher.flush(oid)
            return await self.ioctx.read(oid, length=length,
                                         offset=offset, **kw)
        return await self.cacher.read(oid, offset, length)

    async def truncate(self, oid, size: int):
        # earlier buffered writes land BEFORE the truncate (a flush
        # after it would resurrect dropped bytes), later cached state
        # is dropped
        await self.cacher.flush(oid)
        out = await self.ioctx.truncate(oid, size)
        self.cacher.discard(oid)
        return out

    async def remove(self, oid):
        self.cacher.discard(oid)       # dying object's dirty data dies
        return await self.ioctx.remove(oid)

    async def flush(self, oid=None):
        await self.cacher.flush(oid)

    def __getattr__(self, name):
        return getattr(self.ioctx, name)
