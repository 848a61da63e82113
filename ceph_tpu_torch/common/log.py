"""dout-style logging: per-subsystem levels, ring buffer, crash dump.

src/log/Log.cc + SubsystemMap analog: every entry is kept in a bounded
ring regardless of level; entries at or below the subsystem's level
also go to the sink immediately.  On a crash the recent ring is dumped
— the low-overhead always-on flight recorder the reference relies on.
"""

from __future__ import annotations

import sys
import time
import threading
from collections import deque


class Logger:
    def __init__(self, max_recent: int = 1000,
                 sink=None) -> None:
        self._levels: dict[str, int] = {}
        self.default_level = 1
        self._recent: deque[tuple[float, str, int, str]] = deque(
            maxlen=max_recent)
        self._lock = threading.Lock()
        self._sink = sink or sys.stderr

    def set_level(self, subsys: str, level: int) -> None:
        self._levels[subsys] = level

    def get_level(self, subsys: str) -> int:
        return self._levels.get(subsys, self.default_level)

    def log(self, subsys: str, level: int, msg: str) -> None:
        now = time.time()
        with self._lock:
            self._recent.append((now, subsys, level, msg))
        if level <= self.get_level(subsys):
            ts = time.strftime("%H:%M:%S", time.localtime(now))
            print(f"{ts} {subsys} {level} : {msg}", file=self._sink)

    # dout(n) convenience
    def debug(self, subsys: str, msg: str, level: int = 10) -> None:
        self.log(subsys, level, msg)

    def info(self, subsys: str, msg: str) -> None:
        self.log(subsys, 1, msg)

    def error(self, subsys: str, msg: str) -> None:
        self.log(subsys, 0, msg)

    def recent(self, n: int | None = None) -> list[tuple]:
        with self._lock:
            items = list(self._recent)
        return items if n is None else items[-n:]

    def dump_recent(self, sink=None) -> None:
        """Crash-time dump of the ring buffer (Log::dump_recent)."""
        sink = sink or self._sink
        print("--- begin dump of recent events ---", file=sink)
        for ts, subsys, level, msg in self.recent():
            t = time.strftime("%H:%M:%S", time.localtime(ts))
            print(f"  {t} {subsys} {level} : {msg}", file=sink)
        print("--- end dump of recent events ---", file=sink)


_context: Logger | None = None


def log_context() -> Logger:
    """Process-wide logger (CephContext::_log analog)."""
    global _context
    if _context is None:
        _context = Logger()
    return _context
