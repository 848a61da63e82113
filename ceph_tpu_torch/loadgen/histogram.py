"""Log-bucketed latency histogram: tails without storing samples.

The HdrHistogram idea in miniature: bucket bounds grow geometrically
(default 2^(1/8) per bucket, i.e. 8 sub-buckets per octave), so any
reported percentile is within a bounded RELATIVE error of the true
sample — ``growth - 1`` (~9%) worst case — while memory stays O(log
range) no matter how many million ops are recorded.  Exact count,
sum, min and max ride along, so means and ops/s are exact.

Percentile values are the geometric midpoint of the selected bucket
(the unbiased point under the log layout); ``percentile_bounds``
returns the enclosing interval for callers (and tests) that need the
guarantee, not the estimate.
"""

from __future__ import annotations

import math

DEFAULT_GROWTH = 2 ** 0.125     # 8 buckets per octave, <=9.1% error
DEFAULT_MIN = 1e-5              # 10us: below client-op resolution

PERCENTILES = (50.0, 95.0, 99.0, 99.9)


class LatencyHistogram:
    __slots__ = ("growth", "min_value", "_log_g", "counts",
                 "n", "sum", "min", "max")

    def __init__(self, growth: float = DEFAULT_GROWTH,
                 min_value: float = DEFAULT_MIN) -> None:
        if growth <= 1.0:
            raise ValueError(f"growth must exceed 1.0, got {growth}")
        self.growth = float(growth)
        self.min_value = float(min_value)
        self._log_g = math.log(self.growth)
        self.counts: dict[int, int] = {}
        self.n = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = 0.0

    # -- recording ----------------------------------------------------------
    def _index(self, value: float) -> int:
        if value <= self.min_value:
            return 0
        return 1 + int(math.log(value / self.min_value) / self._log_g)

    def bucket_bounds(self, index: int) -> tuple[float, float]:
        """[lo, hi) covered by bucket `index` (bucket 0 = underflow)."""
        if index <= 0:
            return (0.0, self.min_value)
        return (self.min_value * self.growth ** (index - 1),
                self.min_value * self.growth ** index)

    def record(self, value: float) -> None:
        value = max(0.0, float(value))
        idx = self._index(value)
        self.counts[idx] = self.counts.get(idx, 0) + 1
        self.n += 1
        self.sum += value
        if value < self.min:
            self.min = value
        if value > self.max:
            self.max = value

    def merge(self, other: "LatencyHistogram") -> None:
        if (other.growth != self.growth
                or other.min_value != self.min_value):
            raise ValueError("histogram layouts differ")
        for idx, c in other.counts.items():
            self.counts[idx] = self.counts.get(idx, 0) + c
        self.n += other.n
        self.sum += other.sum
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)

    # -- reading ------------------------------------------------------------
    def _percentile_index(self, q: float) -> int:
        """Bucket holding the q-th percentile sample (nearest-rank)."""
        if self.n == 0:
            return 0
        rank = max(1, math.ceil(q / 100.0 * self.n))
        seen = 0
        for idx in sorted(self.counts):
            seen += self.counts[idx]
            if seen >= rank:
                return idx
        return max(self.counts)

    def percentile(self, q: float) -> float:
        """Point estimate: geometric midpoint of the rank's bucket,
        clamped to the exactly-tracked [min, max]."""
        if self.n == 0:
            return 0.0
        lo, hi = self.bucket_bounds(self._percentile_index(q))
        mid = math.sqrt(lo * hi) if lo > 0 else hi / 2.0
        return min(max(mid, self.min), self.max)

    def percentile_bounds(self, q: float) -> tuple[float, float]:
        """The interval GUARANTEED to contain the true percentile."""
        if self.n == 0:
            return (0.0, 0.0)
        return self.bucket_bounds(self._percentile_index(q))

    @property
    def mean(self) -> float:
        return self.sum / self.n if self.n else 0.0

    def summary(self) -> dict:
        """count/mean/min/max exact, percentiles log-bucketed."""
        out = {
            "count": self.n,
            "mean_s": round(self.mean, 6),
            "min_s": round(self.min, 6) if self.n else 0.0,
            "max_s": round(self.max, 6),
        }
        for q in PERCENTILES:
            key = f"p{q:g}".replace(".", "_")
            out[key + "_s"] = round(self.percentile(q), 6)
        return out

    def to_dict(self) -> dict:
        return {"growth": self.growth, "min_value": self.min_value,
                "counts": {str(k): v for k, v in self.counts.items()},
                "n": self.n, "sum": self.sum,
                "min": self.min if self.n else None, "max": self.max}

    @classmethod
    def from_dict(cls, d: dict) -> "LatencyHistogram":
        h = cls(growth=d["growth"], min_value=d["min_value"])
        h.counts = {int(k): int(v) for k, v in d["counts"].items()}
        h.n = int(d["n"])
        h.sum = float(d["sum"])
        h.min = math.inf if d.get("min") is None else float(d["min"])
        h.max = float(d["max"])
        return h
