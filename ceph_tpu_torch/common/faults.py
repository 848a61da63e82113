"""Deterministic cluster-level fault injection for the messenger.

Where common/throttle.py's FaultInjector arms named SITES inside one
process (EIO on a store read, a socket drop mid-send), this module
injects at the MESSAGE level between daemons: drop, delay or duplicate
messages matched by peer name and/or message type, and partition whole
name groups from each other -- the qa/tasks thrasher's network side
(mon_thrash / msgr-failures) in library form.

Determinism is the point: every decision is drawn from ONE seeded RNG
in message-arrival order, so a chaos run that found a bug replays the
same drop/delay schedule from the same seed (fault_injector.h keeps
its injection deterministic for the same reason).  tools/chaos.py
drives clusters with one of these per daemon; tests pin the
schedule-reproducibility in tests/test_fault_injection.py.

Straggler mode: ``straggler()`` arms per-peer HEAVY-TAIL delay
profiles (seeded lognormal / pareto draws from a per-(seed, peer) RNG
stream, so each peer's delay sequence replays independently of
cross-peer message ordering) -- the induced-straggler workload the
hedged-read engine (osd/hedged_gather.py) and ``bench.py
--straggler`` measure against.
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass, field


SEND = "send"
RECV = "recv"
BOTH = "both"

# heavy-tail delay distributions a rule may draw from ("fixed" = the
# classic constant `delay`)
DISTRIBUTIONS = ("fixed", "lognormal", "pareto")


def _match_name(pattern: str | None, name: str) -> bool:
    """None matches everything; "osd." prefix-matches every OSD;
    "osd.3" matches exactly (prefix match would alias osd.30)."""
    if pattern is None:
        return True
    if pattern.endswith("."):
        return name.startswith(pattern)
    return name == pattern


@dataclass
class FaultRule:
    """One armed fault: `action` on messages matching peer/mtype.

    Delay rules may carry a heavy-tail DISTRIBUTION instead of the
    fixed ``delay``: ``dist="lognormal"`` (params ``mu``/``sigma`` of
    the underlying normal) or ``dist="pareto"`` (params ``scale``/
    ``alpha``; alpha <= 1 has infinite mean -- the true straggler
    regime).  ``cap`` bounds any sample so a test's worst case stays
    finite.  Distribution rules draw from a PER-PEER seeded RNG stream
    (see MessageFaultInjector), so each peer's delay sequence is a
    deterministic function of (seed, peer) alone.
    """

    action: str                      # "drop" | "delay" | "dup"
    peer: str | None = None          # peer name or "svc." prefix
    mtype: str | None = None         # message type, None = any
    direction: str = BOTH            # send / recv / both
    probability: float = 1.0
    count: int | None = None         # remaining firings; None = forever
    delay: float = 0.05              # seconds, for "delay" dist=fixed
    dist: str = "fixed"              # fixed | lognormal | pareto
    dist_params: dict = field(default_factory=dict)
    fired: int = 0

    def __post_init__(self) -> None:
        if self.dist not in DISTRIBUTIONS:
            raise ValueError(f"unknown delay distribution {self.dist!r}")

    def matches(self, direction: str, peer: str, mtype: str) -> bool:
        if self.count is not None and self.count <= 0:
            return False
        if self.direction != BOTH and self.direction != direction:
            return False
        return _match_name(self.peer, peer) and (
            self.mtype is None or self.mtype == mtype)

    def sample_delay(self, rng: random.Random) -> float:
        """One delay draw (seconds) from this rule's distribution."""
        p = self.dist_params
        if self.dist == "lognormal":
            v = rng.lognormvariate(
                p.get("mu", math.log(max(self.delay, 1e-9))),
                p.get("sigma", 1.0))
        elif self.dist == "pareto":
            v = p.get("scale", self.delay) * rng.paretovariate(
                p.get("alpha", 1.5))
        else:
            return self.delay
        cap = p.get("cap")
        return min(v, cap) if cap is not None else v


@dataclass
class FaultDecision:
    drop: bool = False
    delay: float = 0.0
    copies: int = 1                  # >1 = duplicate delivery


class MessageFaultInjector:
    """Seeded, rule-driven message mangling for one endpoint.

    One instance is threaded into a Messenger (and from there consulted
    on every app-level send and every delivered message).  All
    endpoints of a test cluster may share one instance -- decisions
    stay deterministic because the event loop serializes the calls.
    """

    def __init__(self, seed: int = 0, perf=None) -> None:
        self.seed = seed
        self._rng = random.Random(seed)
        self.rules: list[FaultRule] = []
        # symmetric partitions: (group_a, group_b) name patterns
        self.partitions: list[tuple[str, str]] = []
        self.stats: dict[str, int] = {}
        self.perf = perf             # optional PerfCounters sink
        # per-peer RNG streams for distribution-backed delay rules:
        # each peer's delay sequence is seeded by (seed, peer) ALONE,
        # so reordering traffic across peers -- or adding an unrelated
        # straggler profile -- cannot shift another peer's schedule
        self._peer_rngs: dict[str, random.Random] = {}

    # -- arming --------------------------------------------------------------
    def add_rule(self, rule: FaultRule) -> FaultRule:
        self.rules.append(rule)
        return rule

    def drop(self, *, peer: str | None = None, mtype: str | None = None,
             direction: str = BOTH, probability: float = 1.0,
             count: int | None = None) -> FaultRule:
        return self.add_rule(FaultRule("drop", peer, mtype, direction,
                                       probability, count))

    def delay(self, seconds: float, *, peer: str | None = None,
              mtype: str | None = None, direction: str = BOTH,
              probability: float = 1.0,
              count: int | None = None) -> FaultRule:
        return self.add_rule(FaultRule("delay", peer, mtype, direction,
                                       probability, count,
                                       delay=seconds))

    def straggler(self, peer: str, *, dist: str = "lognormal",
                  mtype: str | None = None, direction: str = RECV,
                  probability: float = 1.0, count: int | None = None,
                  **params) -> FaultRule:
        """Arm a heavy-tail per-peer straggler profile.

        ``dist="lognormal"`` takes mu/sigma (seconds of the underlying
        normal's exp); ``dist="pareto"`` takes scale/alpha; both honor
        ``cap``.  Defaults to RECV so the delay lands in the receiver's
        dispatch task (a SEND delay would serialize the whole
        connection behind the sleep and stall unrelated traffic --
        stragglers are slow, not head-of-line-blocking).  Same seed ->
        same per-peer delay sequence: the draw comes from the peer's
        own RNG stream, so a chaos run's straggler schedule replays
        exactly."""
        return self.add_rule(FaultRule(
            "delay", peer, mtype, direction, probability, count,
            dist=dist, dist_params=dict(params)))

    def duplicate(self, *, peer: str | None = None,
                  mtype: str | None = None, direction: str = BOTH,
                  probability: float = 1.0,
                  count: int | None = None) -> FaultRule:
        return self.add_rule(FaultRule("dup", peer, mtype, direction,
                                       probability, count))

    def partition(self, a: str, b: str) -> None:
        """Drop EVERYTHING between name groups a and b (both
        directions; "osd." partitions every OSD from b)."""
        self.partitions.append((a, b))

    def heal(self, a: str | None = None, b: str | None = None) -> None:
        """Remove partitions (all of them when called bare)."""
        if a is None:
            self.partitions.clear()
        else:
            self.partitions = [p for p in self.partitions
                               if p != (a, b) and p != (b, a)]

    def clear(self) -> None:
        self.rules.clear()
        self.partitions.clear()

    # -- the decision point --------------------------------------------------
    def _count(self, key: str) -> None:
        self.stats[key] = self.stats.get(key, 0) + 1
        if self.perf is not None:
            self.perf.inc(key)

    def _partitioned(self, local: str, peer: str) -> bool:
        for a, b in self.partitions:
            if (_match_name(a, local) and _match_name(b, peer)) or \
                    (_match_name(b, local) and _match_name(a, peer)):
                return True
        return False

    def _peer_rng(self, peer: str) -> random.Random:
        rng = self._peer_rngs.get(peer)
        if rng is None:
            rng = self._peer_rngs[peer] = random.Random(
                f"{self.seed}:straggler:{peer}")
        return rng

    def decide(self, direction: str, local: str, peer: str,
               mtype: str) -> FaultDecision:
        """One deterministic decision for one message traversal."""
        if self._partitioned(local, peer):
            self._count("partition_dropped")
            return FaultDecision(drop=True)
        out = FaultDecision()
        for rule in self.rules:
            if not rule.matches(direction, peer, mtype):
                continue
            # the RNG is consumed ONLY for matching rules with p < 1 so
            # unrelated traffic cannot shift the schedule of the flow
            # under test; distribution-backed rules draw EVERYTHING
            # (probability and delay) from the peer's own stream so the
            # per-peer sequence is independent of cross-peer ordering
            dist_rule = (rule.action == "delay"
                         and rule.dist != "fixed")
            draw = self._peer_rng(peer) if dist_rule else self._rng
            if rule.probability < 1.0 and \
                    draw.random() >= rule.probability:
                continue
            rule.fired += 1
            if rule.count is not None:
                rule.count -= 1
            if rule.action == "drop":
                self._count("dropped")
                out.drop = True
                return out
            if rule.action == "delay":
                self._count("delayed")
                if dist_rule:
                    self._count("straggler_delays")
                    out.delay += rule.sample_delay(
                        self._peer_rng(peer))
                else:
                    out.delay += rule.delay
            elif rule.action == "dup":
                self._count("duplicated")
                out.copies += 1
        return out

    def on_send(self, local: str, peer: str,
                mtype: str) -> FaultDecision:
        return self.decide(SEND, local, peer, mtype)

    def on_recv(self, local: str, peer: str,
                mtype: str) -> FaultDecision:
        return self.decide(RECV, local, peer, mtype)
