"""FaultInjector (src/common/fault_injector.h:66 analog).

Port of the injector half of ``ceph_tpu/common/throttle.py``: typed,
targeted failure injection for tests -- arm a site by name with a
probability or a countdown; hot paths call check()/maybe_raise().  The
object stores' reads are wired sites ("objectstore_read": EIO).
"""

from __future__ import annotations

import random


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
