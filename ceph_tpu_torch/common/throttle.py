"""Throttle, Finisher, FaultInjector (src/common analogs).

Port of ``ceph_tpu/common/throttle.py``, host code:

  * Throttle (src/common/Throttle.h): async token bucket with
    backpressure -- get() waits while the budget is exhausted, FIFO
    fair.  The OSD caps in-flight client op bytes with one
    (osd_client_message_size_cap).
  * Finisher (src/common/Finisher.h): ordered completion queue -- one
    drain task executes callbacks strictly in queue order.
  * FaultInjector (src/common/fault_injector.h:66): typed, targeted
    failure injection for tests -- arm a site by name with a
    probability or a countdown; hot paths call check()/maybe_raise().
    Wired consumers: the object stores' reads ("objectstore_read": EIO)
    and the messenger's socket failures.
"""

from __future__ import annotations

import asyncio
import random
from collections import deque
from typing import Awaitable, Callable


class Throttle:
    def __init__(self, name: str, limit: int) -> None:
        self.name = name
        self.limit = limit
        self.current = 0
        self._waiters: deque[tuple[int, asyncio.Future]] = deque()

    def _wake(self) -> None:
        while self._waiters:
            count, fut = self._waiters[0]
            if self.current + count > self.limit and self.current > 0:
                break
            self._waiters.popleft()
            if not fut.done():
                self.current += count
                fut.set_result(None)

    async def get(self, count: int = 1) -> None:
        """Take ``count`` tokens, waiting while over limit.  A single
        request larger than the whole limit is admitted alone rather
        than deadlocking (Throttle::get oversized semantics)."""
        if count < 0:
            raise ValueError("negative throttle count")
        if (self.current + count <= self.limit or self.current == 0) \
                and not self._waiters:
            self.current += count
            return
        fut = asyncio.get_event_loop().create_future()
        self._waiters.append((count, fut))
        try:
            await fut
        except asyncio.CancelledError:
            # Task.cancel() cancels the FUTURE (fut.done() is True but
            # no tokens were granted); only a future _wake resolved
            # with a result actually took tokens and owes a put()
            if fut.cancelled():
                try:
                    self._waiters.remove((count, fut))
                except ValueError:
                    pass
                self._wake()     # our slot may have blocked others
            else:
                self.put(count)
            raise

    def get_or_fail(self, count: int = 1) -> bool:
        if self.current + count > self.limit and self.current > 0:
            return False
        self.current += count
        return True

    def put(self, count: int = 1) -> None:
        self.current = max(0, self.current - count)
        self._wake()

    def past_midpoint(self) -> bool:
        return self.current * 2 >= self.limit


class Finisher:
    """Ordered completion runner: queue() preserves execution order."""

    def __init__(self, name: str = "fin") -> None:
        self.name = name
        self._q: asyncio.Queue = asyncio.Queue()
        self._task: asyncio.Task | None = None
        self._drained = asyncio.Event()
        self._drained.set()

    def start(self) -> None:
        if self._task is None or self._task.done():
            self._task = asyncio.ensure_future(self._run())

    def queue(self, fn: Callable[[], None | Awaitable]) -> None:
        self._drained.clear()
        self._q.put_nowait(fn)
        self.start()

    async def _run(self) -> None:
        try:
            while True:
                if self._q.empty():
                    self._drained.set()
                fn = await self._q.get()
                try:
                    out = fn()
                    if asyncio.iscoroutine(out):
                        await out
                except Exception:
                    pass                      # completions never kill the drain
        except asyncio.CancelledError:
            pass

    async def wait_for_empty(self) -> None:
        await self._drained.wait()

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None



class FaultInjector:
    """Named injection sites armed with probability or countdown."""

    def __init__(self, seed: int | None = None) -> None:
        self._sites: dict[str, dict] = {}
        self._rng = random.Random(seed)
        self.fired: dict[str, int] = {}

    def arm(self, site: str, *, probability: float = 0.0,
            countdown: int = 0, error: type = IOError,
            detail: str = "") -> None:
        """probability: fire on each check with p; countdown: fire once
        after N-1 passes (the reference's one-shot typed injection)."""
        self._sites[site] = {"p": probability, "count": countdown,
                             "error": error, "detail": detail}

    def disarm(self, site: str) -> None:
        self._sites.pop(site, None)

    def check(self, site: str) -> bool:
        """True when the fault fires (caller raises/acts)."""
        spec = self._sites.get(site)
        if spec is None:
            return False
        if spec["count"] > 0:
            spec["count"] -= 1
            if spec["count"] == 0:
                self._sites.pop(site, None)
                self.fired[site] = self.fired.get(site, 0) + 1
                return True
            return False
        if spec["p"] > 0 and self._rng.random() < spec["p"]:
            self.fired[site] = self.fired.get(site, 0) + 1
            return True
        return False

    def maybe_raise(self, site: str) -> None:
        spec = self._sites.get(site)
        if spec is not None and self.check(site):
            raise spec["error"](
                spec["detail"] or f"injected fault at {site}")


# process-wide injector the wired sites consult (tests arm it)
injector = FaultInjector()
