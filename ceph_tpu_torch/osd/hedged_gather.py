"""Straggler-tolerant hedged gathers for the EC read spine.

A degraded read, scrub collection or recovery pull used to await a
FIXED shard set: one slow OSD set the whole op's latency ("Rateless
Codes for Near-Perfect Load Balancing..." frames the fix -- treat slow
shards like slow workers and decode from the first sufficient set to
arrive).  This module is that engine:

* ``PeerLatencyEWMA`` -- per-peer latency estimator (EWMA mean + EWMA
  absolute deviation -> an adaptive quantile estimate per peer).  The
  hedge timer is armed off the COHORT estimate (the median of the
  candidate peers' quantile estimates), not any single peer's own
  history: a persistently slow peer must not get to define its own
  "normal", and a plan whose only outstanding source is the straggler
  still hedges at the healthy cohort's pace.

* ``HedgedGather`` -- issues the minimum sub-read set as INDIVIDUAL
  awaitables (``OSD.start_request``), arms the hedge timer, and when it
  fires requests up to ``h`` extra shards chosen by the caller
  (``minimum_to_decode_with_cost`` with EWMA costs, so the LRC
  plugin's locality preference composes).  The gather completes on the
  FIRST sufficient verified set; outstanding sub-reads are cancelled
  AND awaited (reaped -- no orphan tasks), and a cancelled sub-read's
  late reply is dropped at the tid-waiter layer so it cannot crosstalk
  into a later op.  Every hedge fired/won/wasted and every extra byte
  read is counted in the ``ec_hedge`` perf set.

Config (``osd_ec_hedge_*``) is snapshot at construction -- the gather
loop never reads the config dict (hot-path-config-read discipline).
"""

from __future__ import annotations

import asyncio
from statistics import NormalDist, median

# MAD -> sigma for a normal distribution: sigma = MAD * sqrt(pi/2)
_MAD_TO_SIGMA = 1.2533141373155003


class PeerLatencyEWMA:
    """Per-peer sub-read latency EWMA + adaptive quantile estimate.

    ``observe()`` feeds one completed sub-read; ``estimate()`` returns
    the peer's q-quantile service-time estimate (EWMA mean + z * sigma
    with sigma recovered from the EWMA absolute deviation), or None
    while the peer is cold (< min_samples).  ``cohort_delay()`` is what
    the hedge timer arms on: the MEDIAN estimate across the candidate
    peers -- robust to one straggler skewing the cohort view.
    """

    def __init__(self, alpha: float = 0.2, quantile: float = 0.9,
                 min_samples: int = 8) -> None:
        self.alpha = float(alpha)
        self.quantile = min(max(float(quantile), 0.5), 0.999)
        self.min_samples = max(1, int(min_samples))
        self._z = NormalDist().inv_cdf(self.quantile)
        # peer -> [n, ewma_mean, ewma_abs_dev]
        self._stats: dict[int, list[float]] = {}

    @classmethod
    def from_config(cls, config: dict) -> "PeerLatencyEWMA":
        cfg = config if isinstance(config, dict) else {}
        return cls(
            alpha=float(cfg.get("osd_ec_hedge_ewma_alpha", 0.2)),
            quantile=float(cfg.get("osd_ec_hedge_quantile", 0.9)),
            min_samples=int(cfg.get("osd_ec_hedge_min_samples", 8)))

    def observe(self, peer: int, seconds: float) -> None:
        seconds = max(0.0, float(seconds))
        st = self._stats.get(peer)
        if st is None:
            # first sample seeds the mean; deviation starts at half the
            # sample so the early estimate is wide, not overconfident
            self._stats[peer] = [1, seconds, seconds / 2.0]
            return
        err = seconds - st[1]
        st[1] += self.alpha * err
        st[2] += self.alpha * (abs(err) - st[2])
        st[0] += 1

    def samples(self, peer: int) -> int:
        st = self._stats.get(peer)
        return 0 if st is None else int(st[0])

    def estimate(self, peer: int) -> float | None:
        """q-quantile service-time estimate; None while cold."""
        st = self._stats.get(peer)
        if st is None or st[0] < self.min_samples:
            return None
        return max(0.0, st[1] + self._z * _MAD_TO_SIGMA * st[2])

    def cohort_delay(self, peers) -> float | None:
        """Median of the warm peers' quantile estimates (None = the
        cohort is entirely cold and the caller should use its
        conservative default)."""
        ests = [e for e in (self.estimate(p) for p in set(peers))
                if e is not None]
        if not ests:
            return None
        return float(median(ests))

    def cost_us(self, peer: int, default_s: float) -> int:
        """Integer microsecond cost for minimum_to_decode_with_cost
        (cold peers cost the conservative default: prefer sources with
        a warm, fast history over unknowns)."""
        est = self.estimate(peer)
        return int(round((default_s if est is None else est) * 1e6))


class GatherOutcome:
    """What one hedged gather did (the caller folds this into its own
    failed/fetched bookkeeping)."""

    __slots__ = ("completed", "accepted", "timed_out", "cancelled",
                 "hedged", "hedge_fired")

    def __init__(self) -> None:
        self.completed = False       # sufficiency reached
        self.accepted: set = set()   # shards verified into the result
        self.timed_out: set = set()  # outstanding at deadline (failure)
        self.cancelled: set = set()  # cancelled after sufficiency (NOT
        #                              failures: merely slow)
        self.hedged: set = set()     # shards issued by the hedge
        self.hedge_fired = False


class HedgedGather:
    """First-k-of-(k+h) sub-read engine, one per OSD (shared by every
    ECBackend, scrub and recovery consumer on the daemon)."""

    def __init__(self, osd, tracker: PeerLatencyEWMA, perf=None, *,
                 enabled: bool = True, delay_min: float = 0.002,
                 delay_max: float = 1.0, max_extra: int = 2) -> None:
        self._osd = osd
        self.tracker = tracker
        self.perf = perf
        self.enabled = bool(enabled)
        self.delay_min = float(delay_min)
        self.delay_max = float(delay_max)
        self.max_extra = max(0, int(max_extra))

    @classmethod
    def from_config(cls, osd, config: dict, perf=None,
                    tracker: PeerLatencyEWMA | None = None
                    ) -> "HedgedGather":
        """ONE config read, at construction (the snapshot discipline)."""
        cfg = config if isinstance(config, dict) else {}
        return cls(
            osd,
            tracker or PeerLatencyEWMA.from_config(cfg),
            perf=perf,
            enabled=bool(cfg.get("osd_ec_hedge_enabled", True)),
            delay_min=float(cfg.get("osd_ec_hedge_delay_min", 0.002)),
            delay_max=float(cfg.get("osd_ec_hedge_delay_max", 1.0)),
            max_extra=int(cfg.get("osd_ec_hedge_max_extra", 2)))

    def note(self, key: str, by: int = 1) -> None:
        if self.perf is not None:
            self.perf.inc(key, by)

    def hedge_delay(self, peers) -> float:
        """The armed delay: adaptive cohort quantile, clamped.  A cold
        cohort gets delay_max -- hedge conservatively until the EWMA
        has evidence."""
        d = self.tracker.cohort_delay(peers)
        if d is None:
            return self.delay_max
        return min(max(d, self.delay_min), self.delay_max)

    # -- the gather core -----------------------------------------------------
    async def gather_shards(self, plan: dict, *, on_reply,
                            sufficient=None, hedge_pool=None,
                            choose_extras=None,
                            timeout: float = 10.0) -> GatherOutcome:
        """Issue ``plan`` ({shard: (peer_osd, mtype, payload)}) as
        individual sub-reads; complete on the first sufficient set.

        ``on_reply(shard, msg_or_None)`` feeds each arrival (None =
        send failure) to the caller, which verifies and accumulates.
        ``sufficient()`` returns the accepted shard set once it can
        decode (falsy = keep waiting); None means "complete when every
        request arrived" (scrub's collect-all mode -- no hedging).
        ``choose_extras(h)`` returns up to h extra sub-reads ({shard:
        (peer, mtype, payload)}) from ``hedge_pool`` when the timer
        fires.

        Outstanding sub-reads are ALWAYS cancelled and awaited on exit
        (even on exception) -- no orphan tasks, and the popped tid
        waiter drops any late reply on the messenger floor.
        """
        loop = asyncio.get_event_loop()
        tasks: dict[int, tuple[asyncio.Task, int, float]] = {}
        out = GatherOutcome()
        self.note("gathers")

        def _start(shard: int, peer: int, mtype: str,
                   payload: dict) -> None:
            _tid, task = self._osd.start_request(peer, mtype, payload,
                                                 [])
            tasks[shard] = (task, peer, loop.time())
            self.note("subreads")

        for shard, (peer, mtype, payload) in plan.items():
            _start(shard, peer, mtype, payload)
        pending = set(tasks)
        pool = dict(hedge_pool or {})
        armed = (self.enabled and sufficient is not None and pool
                 and choose_extras is not None and self.max_extra > 0)
        hedge_at = None
        if armed:
            cohort = {peer for peer, _, _ in plan.values()}
            cohort |= {peer for peer, _, _ in pool.values()}
            delay = self.hedge_delay(cohort)
            hedge_at = loop.time() + delay
            self.note("hedges_armed")
            if self.perf is not None:
                self.perf.tinc("hedge_delay", delay)
        deadline = loop.time() + timeout

        def _drain() -> bool:
            """Feed completed tasks to the caller; True if any."""
            arrived = [s for s in pending if tasks[s][0].done()]
            for s in arrived:
                pending.discard(s)
                task, peer, t0 = tasks[s]
                msg = None
                if not task.cancelled() and task.exception() is None:
                    msg = task.result()
                    self.tracker.observe(peer, loop.time() - t0)
                    self.note("ewma_observations")
                    nbytes = sum(len(seg) for seg in msg.segments)
                    self.note("subread_bytes", nbytes)
                    if s in out.hedged:
                        self.note("hedge_bytes", nbytes)
                on_reply(s, msg)
            return bool(arrived)

        try:
            while True:
                _drain()
                acc = sufficient() if sufficient is not None else None
                if sufficient is not None and acc:
                    out.completed = True
                    out.accepted = set(acc)
                    break
                if not pending:
                    # everything answered (or failed) and still not
                    # sufficient: the caller's retry ladder takes over
                    out.completed = sufficient is None
                    break
                now = loop.time()
                if now >= deadline:
                    break
                wait_until = deadline
                if hedge_at is not None and not out.hedge_fired:
                    wait_until = min(wait_until, hedge_at)
                await asyncio.wait(
                    [tasks[s][0] for s in pending],
                    timeout=max(wait_until - now, 1e-4),
                    return_when=asyncio.FIRST_COMPLETED)
                if (hedge_at is not None and not out.hedge_fired
                        and loop.time() >= hedge_at):
                    extras = choose_extras(self.max_extra)
                    if extras:
                        out.hedge_fired = True
                        self.note("hedges_fired")
                        for s, (peer, mtype, payload) in extras.items():
                            if s in tasks:
                                continue
                            _start(s, peer, mtype, payload)
                            out.hedged.add(s)
                            pending.add(s)
                            self.note("hedge_subreads")
                    else:
                        # nothing sound to add: disarm instead of
                        # polling the chooser every wake
                        hedge_at = None
                        self.note("hedges_noop")
        finally:
            leftovers = [s for s in pending if not tasks[s][0].done()]
            for s in leftovers:
                tasks[s][0].cancel()
            if leftovers:
                # REAP: awaiting the cancelled tasks runs their
                # finally-blocks (tid waiters popped) before the next
                # op can possibly reuse the wire
                await asyncio.gather(
                    *(tasks[s][0] for s in leftovers),
                    return_exceptions=True)
                self.note("cancelled_subreads", len(leftovers))
            if out.completed:
                out.cancelled = set(leftovers)
                if pending - set(leftovers):
                    # sufficiency beat sub-reads that were already done
                    # but not drained; fold them in as cancelled too
                    out.cancelled |= pending - set(leftovers)
            else:
                out.timed_out = set(pending)
        if out.completed and pending:
            self.note("first_set_completions")
        if out.hedge_fired:
            if out.completed and (out.accepted & out.hedged):
                self.note("hedges_won")
            else:
                self.note("hedges_wasted")
        return out

    # -- hedged single-reply fan-out (recovery pulls) ------------------------
    async def first_reply(self, targets: list[int], mtype: str,
                          payload: dict, segments=(), *,
                          timeout: float = 10.0, accept=None):
        """Hedge one request across equivalent sources: issue to
        ``targets[0]``, escalate to the next source when the cohort
        quantile elapses (or the current source answers with a
        rejected reply), return the first accepted reply.  Losers are
        cancelled and reaped.  Returns None on exhaustion/deadline --
        the caller's retry path is unchanged."""
        loop = asyncio.get_event_loop()
        tasks: dict[int, tuple[asyncio.Task, float]] = {}
        seen: set[int] = set()
        idx = 0
        self.note("first_replies")

        def _start_next() -> None:
            nonlocal idx
            t = targets[idx]
            idx += 1
            _tid, task = self._osd.start_request(t, mtype,
                                                 dict(payload),
                                                 list(segments))
            tasks[t] = (task, loop.time())
            self.note("subreads")

        _start_next()
        armed = self.enabled and len(targets) > 1
        delay = self.hedge_delay(targets)
        if armed:
            self.note("hedges_armed")
            if self.perf is not None:
                self.perf.tinc("hedge_delay", delay)
        next_hedge = loop.time() + delay
        deadline = loop.time() + timeout
        winner = None
        fired = False
        try:
            while winner is None:
                live = [t for t in tasks if not tasks[t][0].done()]
                for t in list(tasks):
                    task, t0 = tasks[t]
                    if t in seen or not task.done():
                        continue
                    seen.add(t)
                    if task.cancelled() or task.exception() is not None:
                        continue
                    msg = task.result()
                    self.tracker.observe(t, loop.time() - t0)
                    self.note("ewma_observations")
                    self.note("subread_bytes",
                              sum(len(s) for s in msg.segments))
                    if accept is None or accept(msg):
                        winner = (t, msg)
                        break
                if winner is not None:
                    break
                now = loop.time()
                if now >= deadline:
                    break
                can_add = armed and idx < len(targets)
                if not live:
                    if not can_add:
                        break               # exhausted
                    _start_next()           # all answers rejected:
                    fired = True            # escalate immediately
                    self.note("hedges_fired")
                    next_hedge = loop.time() + delay
                    continue
                wait_until = min(deadline,
                                 next_hedge if can_add else deadline)
                await asyncio.wait(
                    [tasks[t][0] for t in live],
                    timeout=max(wait_until - now, 1e-4),
                    return_when=asyncio.FIRST_COMPLETED)
                if can_add and loop.time() >= next_hedge:
                    _start_next()
                    fired = True
                    self.note("hedges_fired")
                    next_hedge = loop.time() + delay
        finally:
            leftovers = [t for t in tasks if not tasks[t][0].done()]
            for t in leftovers:
                tasks[t][0].cancel()
            if leftovers:
                await asyncio.gather(
                    *(tasks[t][0] for t in leftovers),
                    return_exceptions=True)
                self.note("cancelled_subreads", len(leftovers))
        if fired:
            if winner is not None and winner[0] != targets[0]:
                self.note("hedges_won")
            else:
                self.note("hedges_wasted")
        return None if winner is None else winner[1]
