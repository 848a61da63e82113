"""Cross-daemon trace spans (src/common/tracer.h:10-27 role).

A trace id is minted at the CLIENT when an op is submitted; every hop
-- client -> primary OSD -> replica OSDs -> object store -- opens a
child span carrying (trace_id, parent span id) and records its own
timing.  Span contexts ride the wire inside message data ("trace"
field on osd_op / rep_op), and within a daemon they propagate through
the asyncio task via a ContextVar, so deep call chains (pg -> backend
-> store) pick up their parent without threading arguments.

Each daemon keeps its finished spans in a bounded ring, dumpable via
the admin socket ("dump_tracing"); assembling the rings from every
daemon yields the full hop tree for any op (the tracepoint + jaeger
span story, compressed to what this framework can verify in-process).
"""

from __future__ import annotations

import contextvars
import os
import time
from collections import deque

# the active span of THIS asyncio task (or sync call chain under it)
current_span: contextvars.ContextVar = contextvars.ContextVar(
    "ceph_tpu_span", default=None)

RING = 2048


class Span:
    __slots__ = ("trace_id", "span_id", "parent_id", "name", "daemon",
                 "start", "end", "tags", "_tracer", "_token")

    def __init__(self, tracer: "Tracer", name: str, trace_id: str,
                 parent_id: str | None, tags: dict) -> None:
        self._tracer = tracer
        self.name = name
        self.daemon = tracer.daemon
        self.trace_id = trace_id
        self.span_id = os.urandom(4).hex()
        self.parent_id = parent_id
        self.tags = tags
        self.start = time.time()
        self.end: float | None = None
        self._token = None

    def ctx(self) -> dict:
        """The wire context a child hop embeds in its message."""
        return {"id": self.trace_id, "parent": self.span_id}

    def finish(self) -> None:
        if self.end is None:
            self.end = time.time()
            self._tracer._done(self)
        if self._token is not None:
            current_span.reset(self._token)
            self._token = None

    def activate(self) -> "Span":
        """Make this the task's current span (children attach to it)."""
        self._token = current_span.set(self)
        return self

    def to_dict(self) -> dict:
        return {"trace_id": self.trace_id, "span_id": self.span_id,
                "parent_id": self.parent_id, "name": self.name,
                "daemon": self.daemon, "start": self.start,
                "end": self.end,
                "duration_ms": None if self.end is None
                else round((self.end - self.start) * 1000, 3),
                "tags": self.tags}


class Tracer:
    def __init__(self, daemon: str) -> None:
        self.daemon = daemon
        self.finished: deque[Span] = deque(maxlen=RING)

    def start(self, name: str, parent: dict | None = None,
              **tags) -> Span:
        """Open a span.  ``parent`` is a wire context ({"id",
        "parent"}) from an incoming message; absent that, the task's
        current span is the parent; absent both, this is a ROOT span
        with a fresh trace id."""
        if parent and parent.get("id"):
            return Span(self, name, parent["id"],
                        parent.get("parent"), tags)
        cur = current_span.get()
        if cur is not None:
            return Span(self, name, cur.trace_id, cur.span_id, tags)
        return Span(self, name, os.urandom(8).hex(), None, tags)

    def _done(self, span: Span) -> None:
        self.finished.append(span)

    def dump(self, trace_id: str | None = None) -> list[dict]:
        return [s.to_dict() for s in self.finished
                if trace_id is None or s.trace_id == trace_id]


# per-process registry (daemon name -> tracer): tests and admin
# sockets look tracers up here
_TRACERS: dict[str, Tracer] = {}


def get_tracer(daemon: str) -> Tracer:
    t = _TRACERS.get(daemon)
    if t is None:
        t = _TRACERS[daemon] = Tracer(daemon)
    return t


def all_spans(trace_id: str) -> list[dict]:
    """Every span of a trace across every tracer IN THIS PROCESS
    (tests run whole clusters in-process; multi-process deployments
    dump per-daemon over the admin socket instead)."""
    out = []
    for t in _TRACERS.values():
        out.extend(t.dump(trace_id))
    return sorted(out, key=lambda s: s["start"])
