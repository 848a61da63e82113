"""Typed per-daemon performance counters.

src/common/perf_counters.cc analog: plain counters (u64), gauges,
time-averages (sum+count pairs, the avgcount scheme), and fixed-bucket
histograms; collections are dumped as JSON via the admin socket
(`perf dump`) and scraped by the mgr analog.
"""

from __future__ import annotations

import bisect
import threading
import time


class PerfCounters:
    """One component's counter set (e.g. 'osd', 'paxos', 'messenger')."""

    def __init__(self, name: str) -> None:
        self.name = name
        self._lock = threading.Lock()
        self._counters: dict[str, int] = {}
        self._gauges: dict[str, float] = {}
        self._avgs: dict[str, tuple[float, int]] = {}   # sum, count
        self._hists: dict[str, tuple[list[float], list[int]]] = {}
        self._hist_sums: dict[str, tuple[float, int]] = {}

    def inc(self, key: str, by: int = 1) -> None:
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + by

    def get(self, key: str, default: int = 0) -> int:
        """One plain counter's value without a full dump() (chaos/test
        assertions read single counters in tight loops)."""
        with self._lock:
            return self._counters.get(key, default)

    def set_gauge(self, key: str, value: float) -> None:
        with self._lock:
            self._gauges[key] = value

    def tinc(self, key: str, seconds: float) -> None:
        """Time-average sample (avgcount scheme)."""
        with self._lock:
            s, c = self._avgs.get(key, (0.0, 0))
            self._avgs[key] = (s + seconds, c + 1)

    def time(self, key: str):
        """Context manager timing a block into tinc(key)."""
        return _Timer(self, key)

    def hist_register(self, key: str, buckets: list[float]) -> None:
        with self._lock:
            self._hists[key] = (list(buckets), [0] * (len(buckets) + 1))
            self._hist_sums[key] = (0.0, 0)

    def hist_sample(self, key: str, value: float) -> None:
        with self._lock:
            buckets, counts = self._hists[key]
            counts[bisect.bisect_right(buckets, value)] += 1
            s, c = self._hist_sums[key]
            self._hist_sums[key] = (s + value, c + 1)

    def dump(self) -> dict:
        with self._lock:
            out: dict = dict(self._counters)
            out.update({k: v for k, v in self._gauges.items()})
            for k, (s, c) in self._avgs.items():
                out[k] = {"avgcount": c, "sum": s,
                          "avg": (s / c if c else 0.0)}
            for k, (buckets, counts) in self._hists.items():
                s, c = self._hist_sums[k]
                # avg alongside the buckets: a scraper reading mean
                # occupancy (e.g. stripes-per-batch) should not have
                # to re-derive it from bucket midpoints
                out[k] = {"buckets": buckets, "counts": counts,
                          "count": c, "sum": s,
                          "avg": (s / c if c else 0.0)}
            return out


class _Timer:
    def __init__(self, pc: PerfCounters, key: str) -> None:
        self.pc, self.key = pc, key

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.pc.tinc(self.key, time.perf_counter() - self.t0)
        return False


class PerfCountersCollection:
    """All counter sets of one daemon (PerfCountersCollection analog)."""

    def __init__(self) -> None:
        self._sets: dict[str, PerfCounters] = {}

    def create(self, name: str) -> PerfCounters:
        pc = self._sets.get(name)
        if pc is None:
            pc = self._sets[name] = PerfCounters(name)
        return pc

    def adopt(self, pc: PerfCounters) -> PerfCounters:
        """Register an externally-owned counter set under its own name
        (e.g. the OSDMap's placement_cache counters, which live and
        die with the map object) so dump() and get() cover it."""
        self._sets[pc.name] = pc
        return pc

    def get(self, name: str) -> PerfCounters | None:
        return self._sets.get(name)

    def dump(self) -> dict:
        return {name: pc.dump() for name, pc in sorted(self._sets.items())}
