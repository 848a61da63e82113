"""AsyncReserver: bounded, priority-ordered reservation slots.

The analog of src/common/AsyncReserver.h: recovery/backfill work must
take a slot before moving data so a recovering cluster cannot saturate
every OSD at once (the slot count is the `osd_max_backfills` knob).
Local and remote reservations use the same primitive -- the remote side
simply services requests arriving as messages.
"""

from __future__ import annotations

import asyncio
import heapq


class AsyncReserver:
    def __init__(self, max_allowed: int = 1) -> None:
        self.max_allowed = max_allowed
        self.granted: set = set()
        self._queue: list[tuple[int, int, object, asyncio.Future]] = []
        self._seq = 0
        self._leases: dict = {}     # item -> monotonic expiry

    def _do_grants(self) -> None:
        while self._queue and len(self.granted) < self.max_allowed:
            _, _, item, fut = heapq.heappop(self._queue)
            if fut.done():          # cancelled while queued
                continue
            self.granted.add(item)
            fut.set_result(True)

    async def request(self, item, prio: int = 0,
                      timeout: float | None = None) -> None:
        """Wait for a slot.  Re-requesting a granted item is a no-op."""
        self._purge_leases()    # a crashed remote holder's expired
        if item in self.granted:  # lease must not starve local waiters
            return
        fut = asyncio.get_event_loop().create_future()
        heapq.heappush(self._queue, (-prio, self._seq, item, fut))
        self._seq += 1
        self._do_grants()
        try:
            await asyncio.wait_for(fut, timeout)
        except asyncio.TimeoutError:
            self.cancel(item)
            raise

    def get_or_fail(self, item, lease: float | None = None) -> bool:
        """Immediate grant or False -- never queues (the remote-
        reservation pattern: a busy peer answers 'rejected' and the
        requester retries later rather than parking a slot).

        ``lease`` bounds the grant's lifetime: a remote holder that
        crashes (or whose release message is lost) must not leak the
        slot forever -- with one slot that would wedge the feature
        until restart.  Expired leases are purged lazily."""
        import time
        self._purge_leases()
        if item in self.granted:
            if lease is not None:
                self._leases[item] = time.monotonic() + lease
            return True
        if len(self.granted) >= self.max_allowed:
            return False
        self.granted.add(item)
        if lease is not None:
            self._leases[item] = time.monotonic() + lease
        return True

    def _purge_leases(self) -> None:
        import time
        if not self._leases:
            return
        now = time.monotonic()
        for item, expires in list(self._leases.items()):
            if now >= expires:
                del self._leases[item]
                self.granted.discard(item)
        self._do_grants()

    def release(self, item) -> None:
        self.granted.discard(item)
        self._leases.pop(item, None)
        self._do_grants()

    def cancel(self, item) -> None:
        """Drop a queued (or granted) reservation."""
        for entry in self._queue:
            if entry[2] == item and not entry[3].done():
                entry[3].cancel()
        self._queue = [e for e in self._queue if not e[3].done()]
        heapq.heapify(self._queue)
        self.release(item)
