"""await-under-lock: no peer round trips while holding an asyncio lock.

``blocking-under-lock`` catches synchronous stalls (time.sleep, raw
sockets) inside a lock region; the failure mode it cannot see is the
*asynchronous* one: an ``await`` under an ``async with <lock>`` whose
call chain reaches a peer RPC suspends the holder for a full network
round trip, and every task queued on that lock inherits the wait.
That is exactly how a pipelined op path silently re-serializes -- the
device and the messenger may both be asynchronous, but if the commit
fan-out is awaited under the PG lock, the PG still processes one write
per round trip (the PR-12 write-spine refactor exists because this
rule fired on pg.do_op).

Mechanics: every *async* lock region the call-graph engine collected
(``CallGraph.lock_regions``) is projected through call edges of
fan-out <= 4 with ``spawn=False`` (a task the region only scheduled
does not hold its locks).  If the closure reaches one of the known
round-trip sinks (the OSD fan-out/request APIs, the mon RPC, the
hedged-gather engine), the region is a finding -- one per (region,
sink), anchored at the ``async with`` line.

Scoped to ``osd/``, ``mon/``, ``msg/``.  Deliberate holds (recovery
blocking client ops per round is a correctness choice, not an
accident) carry a ``# lint: disable=await-under-lock -- why`` on the
region line; the suppression is the documentation.
"""

from __future__ import annotations

from typing import Iterable

from ..callgraph import CallGraph
from ..core import Finding
from ..registry import ProjectChecker, register

MAX_FANOUT = 4
_SCOPE = ("osd/", "mon/", "msg/")

# the peer-round-trip sinks: awaiting any of these suspends the caller
# until a remote daemon answers (or a timeout fires).  Named the same
# way device_path.ROOTS names launch entry points -- ``Class.method``
# or a bare function name, resolved against the live symbol table.
SINKS = (
    "OSD.fanout_and_wait",
    "OSD.fanout_staged",
    "OSD._mon_request",
    "OSD._mon_send_failover",
    "HedgedGather.gather_shards",
    "HedgedGather.first_reply",
    "Messenger.send",
    "Connection.send",
)


def _in_scope(path: str) -> bool:
    return any(s in path for s in _SCOPE)


@register
class AwaitUnderLock(ProjectChecker):
    name = "await-under-lock"
    description = ("awaits inside async lock regions in osd/, mon/, "
                   "msg/ that can suspend the holder across a peer "
                   "round trip (interprocedural hold-time rule)")

    def check_project(self, graph: CallGraph) -> Iterable[Finding]:
        sink_of: dict[str, str] = {}
        for spec in SINKS:
            for qual in graph.lookup(spec):
                sink_of[qual] = spec
        if not sink_of:
            return
        # reachability is shared across regions: memoize per callee
        reach_cache: dict[str, set[str]] = {}

        def sinks_from(dst: str) -> set[str]:
            if dst not in reach_cache:
                closure = graph.reachable([dst], max_fanout=MAX_FANOUT,
                                          spawn=False)
                reach_cache[dst] = {sink_of[q] for q in closure
                                    if q in sink_of}
            return reach_cache[dst]

        for region in graph.lock_regions:
            if not region.is_async or not _in_scope(region.path):
                continue
            hit: dict[str, str] = {}       # sink spec -> via callee
            for dst, fo in region.callees:
                if fo > MAX_FANOUT:
                    continue
                fi = graph.functions.get(dst)
                if fi is None or not fi.is_async:
                    # a sync callee cannot await; it can only *create*
                    # a coroutine, and creating is not suspending
                    continue
                for spec in sinks_from(dst):
                    hit.setdefault(spec, dst)
            for spec in sorted(hit):
                via = graph.functions[hit[spec]].local
                yield Finding(
                    region.path, region.line, self.name,
                    f"'{region.locks[0]}' is held across a peer "
                    f"round trip: the region awaits {via}(), which "
                    f"reaches {spec} -- every task queued on the "
                    f"lock inherits the RTT and the op path "
                    f"re-serializes; move the wait outside the "
                    f"region or justify with a disable comment")
