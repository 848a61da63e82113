"""Objecter: client-side op engine with resend-on-map-change.

Mirrors src/osdc/Objecter.cc: _calc_target (:2783) computes
object -> PG -> primary OSD from the client's OSDMap; ops that land on
a stale primary (ENOTPRIMARY / EAGAIN / timeout) are re-targeted
against the refreshed map and resent — the client rides out failover
without the application noticing (:2866 pg_to_up_acting_osds and the
resend-on-epoch-change machinery around op_submit).

Port of ``ceph_tpu/client/objecter.py``: the client's map builds its
epoch table on the client's ``device`` (CUDA unless the caller names the
CPU, resolved at construction).
"""

from __future__ import annotations

import asyncio
import collections
import itertools

from ..device import resolve_device
from ..mon.osdmap import OSDMap, Incremental
from ..msg import Message, Messenger
from ..osd.backend import pack_mutations

RETRYABLE = {"ENOTPRIMARY", "EAGAIN", "ENXIO no such pg"}

# process-wide resend counters, by cause: ``retryable`` (a RETRYABLE
# error reply), ``conn_error`` (the send raised), ``conn_reset`` (the
# connection the attempt went out on was reset or replaced while it
# waited) and ``map_change`` (a newer map moved the op's target while it
# waited).  An attempt that merely waits long is never resent, so no cause
# counts a timer
RESENDS: collections.Counter = collections.Counter()
RESEND_CAUSES = ("retryable", "conn_error", "conn_reset", "map_change")
# seconds between a waiting op's checks of its target and connection
RECHECK_INTERVAL = 5.0


class ObjecterError(Exception):
    pass


class Objecter:
    def __init__(self, name: str = "client.objecter",
                 secret: bytes | None = None,
                 msgr_opts: dict | None = None, device=None) -> None:
        self.device = resolve_device(device)
        self.msgr = Messenger(name, secret=secret, **(msgr_opts or {}))
        self.osdmap = OSDMap(device=self.device, shared_tables=True)
        self.mon_addr: tuple[str, int] | None = None
        self._tid = itertools.count(1)
        self._reqid_serial = itertools.count(1)
        self._waiters: dict[int, asyncio.Future] = {}
        self._cmd_waiters: dict[int, asyncio.Future] = {}
        self._refresh_tasks: set[asyncio.Task] = set()
        self._watches: dict[tuple, object] = {}
        # the attempts of ops abandoned by their caller (cancelled, as a
        # client's op deadline does), newest last: what a wedged op tried
        self.abandoned: collections.deque = collections.deque(maxlen=64)
        self.msgr.add_dispatcher(self._dispatch)

    # -- lifecycle ----------------------------------------------------------
    async def start(self, mon_addr: tuple[str, int]) -> None:
        self.mon_addr = tuple(mon_addr)
        await self.msgr.bind()
        await self._refresh_map()

    async def shutdown(self) -> None:
        await self.msgr.shutdown()

    # -- cephx ---------------------------------------------------------------
    async def authenticate(self, entity: str, key_hex: str,
                           services: tuple = ("osd",)) -> None:
        """Prove our entity key to the mon and hold live tickets for
        the given service classes; OSD connections then authenticate
        with the ticket's session key instead of the cluster PSK
        (CephxClientHandler role)."""
        from ..common.cephx import fetch_ticket
        self._auth = (entity, key_hex, tuple(services))
        for svc in services:
            await fetch_ticket(self.msgr, self.mon_addr, entity,
                               key_hex, svc)

    async def _maybe_refresh_tickets(self) -> None:
        """Re-fetch any ticket at (or within 30s of) expiry so long-
        lived clients ride rotations without a failed handshake."""
        auth = getattr(self, "_auth", None)
        if auth is None:
            return
        import time as _time
        from ..common.cephx import fetch_ticket
        entity, key_hex, services = auth
        for svc in services:
            t = self.msgr.tickets.get(svc)
            if t is None or t["expires"] - _time.time() < 30.0:
                try:
                    await fetch_ticket(self.msgr, self.mon_addr,
                                       entity, key_hex, svc)
                except Exception:
                    pass         # retried on the next op

    async def _refresh_map(self, timeout: float = 10,
                           force: bool = True) -> None:
        """Fetch the full map -- COALESCED: concurrent callers share
        one in-flight fetch, and (``force=False``, the op-retry path)
        back-to-back fetches inside _REFRESH_MIN_S reuse the map we
        just got.  During cluster churn every op attempt of every
        client retries through here; un-coalesced, 32 clients
        serialized a full 64-OSD map out of the mon several times per
        second EACH, and that fetch storm (on the shared event loop)
        was a leg of the peering-cascade collapse the degraded-phase
        bench caught.  Explicit callers (open_ioctx after a pool
        create, the start() subscribe) keep ``force=True``: they need
        CURRENT state, not recent state."""
        loop = asyncio.get_event_loop()
        inflight = getattr(self, "_refresh_inflight", None)
        if inflight is not None and not inflight.done():
            await asyncio.wait_for(asyncio.shield(inflight), timeout)
            return
        if not force and loop.time() - getattr(self, "_refresh_at",
                                               -1e9) \
                < self._REFRESH_MIN_S:
            return
        task = loop.create_task(self._refresh_map_once(timeout))
        self._refresh_inflight = task
        task.add_done_callback(self._refresh_done)
        # shielded: a caller cancelled mid-fetch (its op timed out) must
        # not cancel the fetch the other callers share
        await asyncio.shield(task)

    def _refresh_done(self, task: asyncio.Task) -> None:
        if getattr(self, "_refresh_inflight", None) is task:
            self._refresh_inflight = None
        if not task.cancelled():
            task.exception()     # retrieved by whoever awaited it

    _REFRESH_MIN_S = 0.5

    async def _refresh_map_once(self, timeout: float = 10) -> None:
        q: asyncio.Queue = asyncio.Queue()

        async def d(conn, msg):
            if msg.type == "osdmap_full":
                await q.put(("full", msg.data["map"]))
            elif msg.type == "osdmap_incs":
                await q.put(("incs", msg.data.get("incs", [])))

        self.msgr.add_dispatcher(d)
        try:
            # delta catch-up: the mon answers with the incremental
            # chain while it still holds it, the full map otherwise
            await self.msgr.send(self.mon_addr, "mon.0",
                                 Message("get_osdmap",
                                         {"since": self.osdmap.epoch}))
            kind, payload = await asyncio.wait_for(q.get(), timeout)
            self._refresh_at = asyncio.get_event_loop().time()
            if kind == "incs":
                for inc_d in payload:
                    inc = Incremental.from_dict(inc_d)
                    # _dispatch may have applied some while we waited
                    if inc.epoch == self.osdmap.epoch + 1:
                        self.osdmap.apply_incremental(inc)
                return
            new_map = OSDMap.from_dict(payload, device=self.device,
                                     shared_tables=True)
            # a slow full-map reply must not regress past incrementals
            # _dispatch applied while we waited
            if new_map.epoch >= self.osdmap.epoch:
                # placement counters are per-client, not per-map object
                new_map._placement_perf = self.osdmap._placement_perf
                self.osdmap = new_map
        finally:
            self.msgr.dispatchers.remove(d)

    # -- watch/notify (linger ops) ------------------------------------------
    def register_watch(self, pool_id: int, oid: str, cookie: int,
                       callback, nspace: str = "") -> None:
        """Track a watch; it re-registers itself whenever its PG's
        primary moves (the linger-op resend, Objecter::linger_watch)."""
        self._watches[(pool_id, oid, cookie)] = {
            "cb": callback, "nspace": nspace,
            "target": self.calc_target(pool_id, oid, nspace)}

    def unregister_watch(self, pool_id: int, oid: str,
                         cookie: int) -> None:
        self._watches.pop((pool_id, oid, cookie), None)

    async def _rewatch_all(self) -> None:
        """Re-register watches whose primary moved, concurrently --
        unrelated map churn must not trigger K serial round trips."""
        stale = []
        for key, w in list(self._watches.items()):
            pool_id, oid, cookie = key
            target = self.calc_target(pool_id, oid, w["nspace"])
            if target != w["target"]:
                stale.append((key, w, target))

        async def one(key, w, target):
            pool_id, oid, cookie = key
            try:
                await self.op_submit(
                    pool_id, oid,
                    [{"op": "watch", "cookie": cookie,
                      "addr": list(self.msgr.addr)}],
                    nspace=w["nspace"], timeout=10)
                # only a SUCCESSFUL re-registration settles the target;
                # a failure leaves it stale so the next map change (or
                # repeated attempt) retries
                w["target"] = target
            except ObjecterError:
                pass
        if stale:
            await asyncio.gather(*(one(*s) for s in stale))

    async def _handle_watch_notify(self, conn, msg: Message) -> None:
        payload = msg.segments[0] if msg.segments else b""
        for (pool_id, oid, cookie), w in list(self._watches.items()):
            if pool_id == msg.data.get("pool") \
                    and oid == msg.data.get("oid") \
                    and cookie == msg.data.get("cookie"):
                try:
                    res = w["cb"](payload)
                    if asyncio.iscoroutine(res):
                        await res
                except Exception:
                    pass
        try:
            await conn.send(Message(
                "watch_notify_ack",
                {"notify_id": msg.data.get("notify_id")}))
        except (ConnectionError, OSError):
            pass

    # -- dispatch -----------------------------------------------------------
    async def _dispatch(self, conn, msg: Message) -> None:
        if msg.type == "watch_notify":
            await self._handle_watch_notify(conn, msg)
            return
        if msg.type == "osd_op_reply":
            fut = self._waiters.pop(msg.data.get("tid"), None)
            if fut is not None and not fut.done():
                fut.set_result(msg)
        elif msg.type == "osdmap_inc":
            inc = Incremental.from_dict(msg.data["inc"])
            if inc.epoch == self.osdmap.epoch + 1:
                self.osdmap.apply_incremental(inc)
                if self._watches:
                    t = asyncio.ensure_future(self._rewatch_all())
                    self._refresh_tasks.add(t)
                    t.add_done_callback(self._refresh_tasks.discard)
            elif inc.epoch > self.osdmap.epoch:
                t = asyncio.ensure_future(self._guarded_refresh())
                self._refresh_tasks.add(t)
                t.add_done_callback(self._refresh_tasks.discard)
        elif msg.type == "mon_command_reply":
            fut = self._cmd_waiters.pop(msg.data.get("tid"), None)
            if fut is not None and not fut.done():
                fut.set_result(msg.data)

    async def _guarded_refresh(self, force: bool = True) -> None:
        try:
            await self._refresh_map(timeout=5, force=force)
            if self._watches:
                await self._rewatch_all()
        except (asyncio.TimeoutError, ConnectionError, OSError):
            pass     # next op's retry path refreshes again

    # -- placement ----------------------------------------------------------
    def calc_target(self, pool_id: int, oid: str, nspace: str = "",
                    ps: int | None = None) -> tuple[str, int | None]:
        """(pgid, primary osd) for an object — Objecter.cc:2783.

        Pass ``ps`` to target a specific PG (pgls-style ops that
        address a placement group, not an object).

        No CRUSH runs here: pg_to_up_acting_osds reads the epoch-
        memoized placement table (mon/pg_mapping.py), recomputed in
        bulk only when a new map epoch lands — per-op cost no longer
        scales with map size, and a hot client does zero placement
        math between epochs.
        """
        if ps is None:
            _, ps = self.osdmap.object_to_pg(pool_id, oid, nspace)
        up = self.osdmap.pg_to_up_acting_osds(pool_id, ps)
        return self.osdmap.pg_name(pool_id, ps), self.osdmap.pg_primary(up)

    # -- op submission ------------------------------------------------------
    async def op_submit(self, pool_id: int, oid: str, ops: list[dict],
                        nspace: str = "", timeout: float = 30,
                        ps: int | None = None,
                        extra: dict | None = None) -> Message:
        """Run ops on the object's primary, retrying through map churn."""
        loop = asyncio.get_event_loop()
        deadline = loop.time() + timeout
        # reqid is stable across RESENDS of this op (unlike the per-
        # attempt tid) so the PG can detect and absorb duplicates
        # (osd_reqid_t semantics)
        reqid = [f"{self.msgr.name}:{self.msgr.incarnation}",
                 next(self._reqid_serial)]
        await self._maybe_refresh_tickets()
        from ..common.tracing import get_tracer
        span = get_tracer(self.msgr.name).start(
            "client.osd_op", oid=oid, pool=pool_id)
        try:
            return await self._op_attempts(
                span, pool_id, oid, ops, nspace, deadline, timeout, ps,
                extra, reqid, loop)
        finally:
            span.finish()

    async def _op_attempts(self, span, pool_id, oid, ops, nspace,
                           deadline, timeout, ps, extra, reqid, loop):
        """Send the op to its primary and wait, resending only when the
        attempt cannot be answered (Objecter.cc's resend rules): a
        RETRYABLE reply, a failed send or a reset connection, or a newer
        map that moves the op's target.  An attempt that merely waits is
        not resent: the op keeps one tid and one waiter for its whole
        life, so any attempt's reply completes it, and every
        ``RECHECK_INTERVAL`` seconds the wait re-checks the target and the
        connection (and asks for a newer map) instead."""
        last_err = None
        attempts: list[dict] = []
        tid = next(self._tid)
        fut = None
        try:
            while loop.time() < deadline:
                pgid, primary = self.calc_target(pool_id, oid, nspace,
                                                 ps=ps)
                if primary is None:
                    await self._pause_and_refresh()
                    continue
                info = self.osdmap.osds.get(primary)
                if info is None or info.addr is None:
                    await self._pause_and_refresh()
                    continue
                attempts.append({"pgid": pgid, "primary": primary,
                                 "epoch": self.osdmap.epoch,
                                 "t": round(loop.time(), 3)})
                if fut is None or fut.done():
                    fut = loop.create_future()
                    self._waiters[tid] = fut
                meta, segs = pack_mutations(ops)
                addr, peer = tuple(info.addr), f"osd.{primary}"
                try:
                    conn = await self.msgr.connect(addr, peer)
                    gen = conn.generation
                    await conn.send(
                        Message("osd_op", {"pgid": pgid, "oid": oid,
                                           "ops": meta, "tid": tid,
                                           "reqid": reqid,
                                           "trace": span.ctx(),
                                           **(extra or {})},
                                segments=segs))
                except (ConnectionError, OSError) as e:
                    last_err = e
                    RESENDS["conn_error"] += 1
                    attempts[-1]["end"] = "conn_error"
                    await self._pause_and_refresh()
                    continue
                cause = await self._await_reply(
                    fut, conn, gen, (pgid, primary, addr), pool_id, oid,
                    nspace, ps, deadline, loop)
                if cause is not None:
                    last_err = ObjecterError(cause)
                    attempts[-1]["end"] = cause
                    if cause != "deadline":
                        RESENDS[cause] += 1
                    continue
                reply = fut.result()
                err = reply.data.get("err")
                if err in RETRYABLE:
                    last_err = ObjecterError(err)
                    RESENDS["retryable"] += 1
                    attempts[-1]["end"] = err
                    await self._pause_and_refresh()
                    continue
                return reply
        except asyncio.CancelledError:
            self.abandoned.append({"pool": pool_id, "oid": oid,
                                   "reqid": list(reqid), "tid": tid,
                                   "attempts": attempts})
            raise
        finally:
            self._waiters.pop(tid, None)
        raise ObjecterError(
            f"op on {oid} timed out after {timeout}s: {last_err!r}")

    async def _await_reply(self, fut, conn, gen, target, pool_id, oid,
                           nspace, ps, deadline, loop) -> str | None:
        """Wait for ``fut``: None once it holds a reply, else why the op
        must be sent again (``conn_reset``, ``map_change``) or
        ``deadline``.  While the target stands and its connection lives,
        the wait goes on across checks."""
        while True:
            left = deadline - loop.time()
            if left <= 0:
                return "deadline"
            await asyncio.wait({fut}, timeout=min(RECHECK_INTERVAL, left))
            if fut.done():
                return None
            if conn.closed or conn.generation != gen \
                    or self.msgr.conns.get(conn.peer_name) is not conn:
                return "conn_reset"
            pgid, primary = self.calc_target(pool_id, oid, nspace, ps=ps)
            info = self.osdmap.osds.get(primary) \
                if primary is not None else None
            addr = tuple(info.addr) if info and info.addr else None
            if (pgid, primary, addr) != target:
                return "map_change"
            self._refresh_soon()

    def _refresh_soon(self) -> None:
        """A rate-limited map fetch in the background: an op that waits
        learns of a map it missed without leaving its wait."""
        t = asyncio.ensure_future(self._guarded_refresh(force=False))
        self._refresh_tasks.add(t)
        t.add_done_callback(self._refresh_tasks.discard)

    async def _pause_and_refresh(self) -> None:
        await asyncio.sleep(0.25)
        try:
            # rate-limited: the retry storm must not serialize a full
            # map out of the mon per attempt per client
            await self._refresh_map(timeout=5, force=False)
        except (asyncio.TimeoutError, ConnectionError, OSError):
            pass

    # -- mon commands -------------------------------------------------------
    async def mon_command(self, cmd: str, args: dict | None = None,
                          timeout: float = 15) -> dict | list | int | str:
        tid = next(self._tid)
        fut = asyncio.get_event_loop().create_future()
        self._cmd_waiters[tid] = fut
        try:
            await self.msgr.send(
                self.mon_addr, "mon.0",
                Message("mon_command", {"cmd": cmd, "args": args or {},
                                        "tid": tid}))
            data = await asyncio.wait_for(fut, timeout)
        finally:
            self._cmd_waiters.pop(tid, None)
        if not data["ok"]:
            raise ObjecterError(data["error"])
        return data["result"]
