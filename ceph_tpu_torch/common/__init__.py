"""Common runtime: typed config, perf counters, admin socket, logging.

Port of ``ceph_tpu/common/``: host code, copied.  ``perf.py`` holds the
counters every layer of the port reports to; ``denc.py`` the wire and
on-disk encodings; ``throttle.py`` the Throttle, the Finisher and the
fault injector.

The src/common analog: ConfigProxy with observers
(src/common/config_proxy.h), PerfCounters (src/common/perf_counters.cc),
per-daemon admin socket (src/common/admin_socket.cc), and the dout
ring-buffer logger (src/log/Log.cc).
"""

from .config import Option, ConfigProxy, OPT_INT, OPT_FLOAT, OPT_STR, \
    OPT_BOOL
from .faults import FaultDecision, FaultRule, MessageFaultInjector
from .perf import PerfCounters, PerfCountersCollection
from .admin_socket import AdminSocket
from .log import Logger, log_context


def make_task_tracker(tasks: list):
    """Track a background task with a strong ref that self-prunes on
    completion -- long-running daemons spawn periodic tasks and an
    append-only list is an unbounded leak."""
    def track(t):
        tasks.append(t)

        def _done(task, _tasks=tasks):
            try:
                _tasks.remove(task)
            except ValueError:
                pass
        t.add_done_callback(_done)
        return t
    return track


__all__ = [
    "Option", "ConfigProxy", "OPT_INT", "OPT_FLOAT", "OPT_STR",
    "OPT_BOOL", "PerfCounters", "PerfCountersCollection", "AdminSocket",
    "Logger", "log_context", "make_task_tracker", "FaultDecision",
    "FaultRule", "MessageFaultInjector",
]
