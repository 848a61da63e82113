"""OpTracker: in-flight op introspection and historic-op retention.

The TrackedOp/OpTracker analog (src/common/TrackedOp.h): every client
op registers on arrival, marks named EVENTS as it moves through the
pipeline (queued -> reached_pg -> started -> sub_op_commit ...), and
on completion migrates into a bounded historic ring kept two ways --
most recent and slowest -- exactly the pair ``dump_historic_ops`` /
``dump_historic_ops_by_duration`` serve.  Ops in flight past the
complaint threshold surface as slow ops (the OSD warns the cluster
log and counts them; src/osd/OSD.cc get_health_metrics).
"""

from __future__ import annotations

import itertools
import time
from collections import deque


class TrackedOp:
    __slots__ = ("tracker", "opid", "desc", "start", "events", "done")

    def __init__(self, tracker: "OpTracker", opid: int,
                 desc: dict) -> None:
        self.tracker = tracker
        self.opid = opid
        self.desc = desc
        self.start = time.monotonic()
        self.events: list[tuple[float, str]] = [(self.start,
                                                 "initiated")]
        self.done = False

    def event(self, name: str) -> None:
        if not self.done:
            self.events.append((time.monotonic(), name))

    @property
    def age(self) -> float:
        return time.monotonic() - self.start

    @property
    def duration(self) -> float:
        return (self.events[-1][0] - self.start) if self.done \
            else self.age

    def finish(self) -> None:
        if not self.done:
            self.event("done")
            self.done = True
            self.tracker._retire(self)

    def to_dict(self) -> dict:
        t0 = self.start
        return {
            "id": self.opid, **self.desc,
            "age": round(self.age, 4),
            "duration": round(self.duration, 4),
            "events": [{"t": round(t - t0, 4), "event": name}
                       for t, name in self.events],
        }


class OpTracker:
    def __init__(self, history_size: int = 20,
                 history_slow_size: int = 20,
                 complaint_time: float = 30.0) -> None:
        self.inflight: dict[int, TrackedOp] = {}
        self.history: deque[TrackedOp] = deque(maxlen=history_size)
        self.history_slow: list[TrackedOp] = []   # kept sorted, bounded
        self.history_slow_size = history_slow_size
        self.complaint_time = complaint_time
        self._serial = itertools.count(1)
        self.complained: set[int] = set()         # slow ops already warned

    def create(self, **desc) -> TrackedOp:
        op = TrackedOp(self, next(self._serial), desc)
        self.inflight[op.opid] = op
        return op

    def _retire(self, op: TrackedOp) -> None:
        self.inflight.pop(op.opid, None)
        self.complained.discard(op.opid)
        self.history.append(op)
        self.history_slow.append(op)
        self.history_slow.sort(key=lambda o: -o.duration)
        del self.history_slow[self.history_slow_size:]

    # -- dumps (admin socket surface) ----------------------------------------
    def dump_ops_in_flight(self) -> dict:
        ops = sorted(self.inflight.values(), key=lambda o: o.start)
        return {"num_ops": len(ops),
                "ops": [o.to_dict() for o in ops]}

    def dump_historic_ops(self) -> dict:
        return {"num_ops": len(self.history),
                "ops": [o.to_dict() for o in self.history]}

    def dump_historic_ops_by_duration(self) -> dict:
        return {"num_ops": len(self.history_slow),
                "ops": [o.to_dict() for o in self.history_slow]}

    def slow_ops(self) -> list[TrackedOp]:
        """In-flight ops past the complaint threshold."""
        return [o for o in self.inflight.values()
                if o.age > self.complaint_time]
