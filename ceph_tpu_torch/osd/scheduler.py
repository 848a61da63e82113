"""Op scheduler: dmClock-style QoS across client/recovery/best-effort.

Implements the dmClock tagging scheme the reference's mClockScheduler
uses (src/osd/scheduler/mClockScheduler.cc over vendored src/dmclock):
each class has (reservation r, weight w, limit l) in ops/sec; every op
gets a reservation tag and a weight tag; dispatch serves reservation
tags that are due first (guaranteeing r), then weight tags subject to
limit (proportional sharing of spare capacity).
"""

from __future__ import annotations

import heapq
import itertools
import time
from dataclasses import dataclass
from enum import Enum
from typing import Any


class OpClass(str, Enum):
    CLIENT = "client"
    RECOVERY = "recovery"
    BEST_EFFORT = "best_effort"


@dataclass
class ClassSpec:
    reservation: float   # guaranteed ops/sec (0 = none)
    weight: float        # proportional share of spare capacity
    limit: float         # max ops/sec (0 = unlimited)


# defaults mirror the shape of mclock's high_client profile: clients are
# reservation-guaranteed, recovery is weight-limited so it cannot starve
# client I/O.
DEFAULT_SPECS: dict[OpClass, ClassSpec] = {
    OpClass.CLIENT: ClassSpec(reservation=1000.0, weight=2.0, limit=0.0),
    OpClass.RECOVERY: ClassSpec(reservation=100.0, weight=1.0, limit=500.0),
    OpClass.BEST_EFFORT: ClassSpec(reservation=0.0, weight=1.0, limit=200.0),
}


@dataclass(frozen=True)
class _Tags:
    r: float
    w: float
    l: float


class _ClassState:
    __slots__ = ("spec", "prev", "queue")

    def __init__(self, spec: ClassSpec) -> None:
        self.spec = spec
        self.prev = _Tags(0.0, 0.0, 0.0)   # tags of the last enqueued op
        self.queue: list[tuple[int, _Tags, Any]] = []


class MClockScheduler:
    def __init__(self, specs: dict[OpClass, ClassSpec] | None = None,
                 clock=time.monotonic, perf=None) -> None:
        self.clock = clock
        self._last_now = float("-inf")
        # observability sink (the OSD's "scheduler" perf set): queue
        # depth per class as gauges, enqueue/dispatch totals per class
        # as counters, so QoS behavior is REPORTED, not inferred
        self.perf = perf
        self._seq = itertools.count()
        self.classes = {c: _ClassState(s)
                        for c, s in (specs or DEFAULT_SPECS).items()}

    def _now(self) -> float:
        """Clock read clamped against regression.

        Tags are times: the default clock is ``time.monotonic`` (an
        NTP step on the wall clock must never starve a class whose
        tags suddenly sit in the future, nor burst one whose tags fell
        into the past), and any injected clock gets the same guarantee
        by clamping -- a backwards step freezes `now` instead of
        rewinding the tag arithmetic.
        """
        now = self.clock()
        if now < self._last_now:
            now = self._last_now
        else:
            self._last_now = now
        return now

    def __len__(self) -> int:
        return sum(len(st.queue) for st in self.classes.values())

    def _note_depth(self, op_class: OpClass) -> None:
        if self.perf is not None:
            st = self.classes[op_class]
            self.perf.set_gauge(f"depth_{op_class.value}",
                                len(st.queue))
            self.perf.set_gauge("depth_total", len(self))

    def enqueue(self, op_class: OpClass, item: Any) -> None:
        """Stamp the op with its own dmclock tags.

        Each tag advances from the previous op's tag by 1/rate, floored
        at now (the dmClock tag formula): an idle class restarts at
        `now`; a backlogged class spaces ops 1/rate apart.
        """
        st = self.classes[op_class]
        now = self._now()
        sp = st.spec
        tags = _Tags(
            r=(max(st.prev.r + 1.0 / sp.reservation, now)
               if sp.reservation > 0 else float("inf")),
            w=max(st.prev.w + 1.0 / sp.weight, now) if sp.weight > 0
              else float("inf"),
            l=(max(st.prev.l + 1.0 / sp.limit, now)
               if sp.limit > 0 else 0.0),
        )
        st.prev = tags
        heapq.heappush(st.queue, (next(self._seq), tags, item))
        if self.perf is not None:
            self.perf.inc(f"enqueued_{op_class.value}")
            self._note_depth(op_class)

    def dequeue(self) -> tuple[OpClass, Any] | None:
        """Pick per dmclock, comparing HEAD-of-queue op tags:
        reservation tags that are due first, then weight tags among
        classes whose head op is under its limit.
        """
        now = self._now()
        best_c, best_tag = None, None
        lane = "reservation"
        for c, st in self.classes.items():
            if not st.queue:
                continue
            head = st.queue[0][1]
            if head.r <= now and (best_tag is None or head.r < best_tag):
                best_c, best_tag = c, head.r
        if best_c is None:
            lane = "weight"
            for c, st in self.classes.items():
                if not st.queue:
                    continue
                head = st.queue[0][1]
                if head.l > now:
                    continue
                if best_tag is None or head.w < best_tag:
                    best_c, best_tag = c, head.w
        if best_c is None:
            # every head op is limit-deferred: fall back to global FIFO
            # so the queue still drains (the real scheduler would wait)
            lane = "fifo"
            candidates = [(st.queue[0][0], c)
                          for c, st in self.classes.items() if st.queue]
            if not candidates:
                return None
            best_c = min(candidates)[1]
        st = self.classes[best_c]
        _, _, item = heapq.heappop(st.queue)
        if self.perf is not None:
            self.perf.inc(f"dispatched_{best_c.value}")
            self.perf.inc(f"lane_{lane}")
            self._note_depth(best_c)
        return best_c, item
