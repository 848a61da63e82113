"""Process-wide workload perf counters (the client swarm's side).

One ``PerfCounters`` set shared by every swarm/driver in the process
and ADOPTED into each OSD's collection (like the integrity set), so a
plain ``perf dump`` shows the offered load — ops and bytes the clients
pushed, errors they saw — right next to what the daemons did with it.

Kept dependency-free (common.perf only): the OSD imports this at
construction time and must not drag the whole harness in.
"""

from __future__ import annotations

from ..common.perf import PerfCounters

PERF = PerfCounters("workload")

# counter keys (all plain counters; the swarm holds latency in its own
# log-bucketed histograms, not here):
#   ops_read / ops_write / ops_rmw   completed ops per class
#   bytes_read / bytes_written      payload bytes moved
#   op_errors                       ops that returned an error
#   op_wedged                       ops that exceeded the op deadline
#   open_loop_stalls                open-loop dispatcher hit the
#                                   in-flight cap (offered load was
#                                   NOT met; reported, never hidden)


def snapshot() -> dict:
    """Point-in-time dump (for before/after deltas in reports)."""
    return dict(PERF.dump())


def delta(before: dict, after: dict) -> dict:
    """Numeric counter deltas between two snapshot() dumps."""
    out = {}
    for key, v in after.items():
        if isinstance(v, (int, float)):
            out[key] = v - before.get(key, 0)
    return out
