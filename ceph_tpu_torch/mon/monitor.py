"""Monitor daemon: map authority, paxos-lite replication, failure handling.

Functional rendering of the src/mon stack: a replicated commit log with
collect/begin/accept/commit phases and a leader lease (Paxos.cc:154-1530),
map services that batch pending changes and propose them
(PaxosService.cc:196), and the OSDMonitor behaviors the data path needs:
osd boot -> up, failure reports with a min-reporter threshold
(mon_osd_min_down_reporters), down->out aging, pool and EC-profile
commands, CRUSH rule creation at pool create (OSDMonitor.cc:7484-7566).

Port of ``ceph_tpu/mon/monitor.py``.  The monitor runs on one device
(``device``, CUDA unless the caller names the CPU, resolved at
construction): its ``OSDMap`` builds its epoch table there, and the EC
plugin it instantiates to check a profile and to size a pool runs there.
The default EC profile names the ``cuda`` plugin.
"""

from __future__ import annotations

import asyncio
import json
import sqlite3
import time
from collections import defaultdict

from ..common import AdminSocket, PerfCountersCollection
from ..device import resolve_device
from ..msg import Message, Messenger
from ..crush.types import (
    Bucket, CrushMap, CRUSH_BUCKET_STRAW2,
)
from ..crush.builder import replicated_rule, erasure_rule
from ..ec import registry as ec_registry
from .osdmap import (
    OSDMap, Incremental, PoolSpec, crush_to_dict,
    POOL_TYPE_REPLICATED, POOL_TYPE_ERASURE,
)

DEFAULT_EC_PROFILE = {"plugin": "cuda", "k": "2", "m": "1",
                      "technique": "reed_sol_van"}


class MonStore:
    """Versioned commit log + stashed full maps (MonitorDBStore analog)."""

    def __init__(self, path: str = ":memory:") -> None:
        self.conn = sqlite3.connect(path)
        with self.conn:
            self.conn.execute(
                "CREATE TABLE IF NOT EXISTS log ("
                "version INTEGER PRIMARY KEY, value BLOB)")
            self.conn.execute(
                "CREATE TABLE IF NOT EXISTS kv (key TEXT PRIMARY KEY, "
                "value BLOB)")

    def last_committed(self) -> int:
        row = self.conn.execute("SELECT MAX(version) FROM log").fetchone()
        return row[0] or 0

    def commit(self, version: int, value: bytes) -> None:
        with self.conn:
            self.conn.execute("INSERT OR REPLACE INTO log VALUES (?,?)",
                              (version, value))

    def get(self, version: int) -> bytes | None:
        row = self.conn.execute("SELECT value FROM log WHERE version=?",
                                (version,)).fetchone()
        return None if row is None else row[0]

    def put_kv(self, key: str, value: bytes) -> None:
        with self.conn:
            self.conn.execute("INSERT OR REPLACE INTO kv VALUES (?,?)",
                              (key, value))

    def get_kv(self, key: str) -> bytes | None:
        row = self.conn.execute("SELECT value FROM kv WHERE key=?",
                                (key,)).fetchone()
        return None if row is None else row[0]


class Monitor:
    def __init__(self, rank: int = 0, peers: list[tuple[str, int]] | None = None,
                 store_path: str = ":memory:", secret: bytes | None = None,
                 config: dict | None = None,
                 admin_socket_path: str | None = None,
                 msgr_opts: dict | None = None, device=None) -> None:
        # where the map's table is built and the EC plugins run: CUDA
        # unless the caller names the CPU
        self.device = resolve_device(device)
        self.rank = rank
        self.peer_addrs = peers or []     # rank -> addr (incl. self slot)
        self.msgr = Messenger(f"mon.{rank}", secret=secret,
                              **(msgr_opts or {}))
        self.store = MonStore(store_path)
        self.osdmap = OSDMap(device=self.device)
        self.config = {
            "mon_osd_min_down_reporters": 2,
            "mon_osd_down_out_interval": 600.0,
            "mon_lease": 5.0,
            **(config or {}),
        }
        self.incrementals: dict[int, Incremental] = {}
        self.subscribers: dict[str, object] = {}   # peer name -> Connection
        self.failure_reports: dict[int, set[str]] = defaultdict(set)
        self._pending_lock = asyncio.Lock()
        self._boot_lock = asyncio.Lock()
        self._pending_up_thru: set[int] = set()
        self._up_thru_flush: asyncio.Future | None = None
        self._up_thru_task: asyncio.Task | None = None
        self._tick_task: asyncio.Task | None = None
        self._down_since: dict[int, float] = {}
        # paxos-lite
        self.quorum: set[int] = {rank}
        self.accepts: dict[int, set[int]] = {}
        self._commit_waiters: dict[int, asyncio.Future] = {}
        # elections (ElectionLogic analog): epoch odd while electing,
        # even when a leader holds a quorum; the LOWEST alive rank wins
        # and data consistency is the collect phase's job, not the
        # election's (Elector.cc / Paxos.cc:154)
        self.election_epoch = 0
        self.leader: int | None = None
        self._election_acks: set[int] = set()
        self._election_task: asyncio.Task | None = None
        self._lease_expire = 0.0       # peon: leader lease deadline
        self._lease_acks: set[int] = set()
        self._lease_misses = 0
        self._lease_round = 0
        self._collect_replies: dict[int, dict] = {}
        self._collected = False        # leader ran collect this term
        self._stopped = False
        # observability (Paxos registers PerfCounters too, Paxos.cc:117)
        self.perf = PerfCountersCollection()
        self.perf_paxos = self.perf.create("paxos")
        self.admin_socket: AdminSocket | None = None
        self._admin_socket_path = admin_socket_path
        # the other PaxosServices (auth/config/log/health) ride the
        # same paxos commits via Incremental.service_kv
        from .services import MonServices
        self.services = MonServices(self)
        self.msgr.add_dispatcher(self._dispatch)
        self._replay()

    # -- lifecycle ----------------------------------------------------------
    def _replay(self) -> None:
        last = self.store.last_committed()
        for v in range(1, last + 1):
            blob = self.store.get(v)
            if blob:
                inc = Incremental.from_dict(json.loads(blob))
                self.osdmap.apply_incremental(inc)
                self.services.apply(inc.service_kv)
                self.incrementals[inc.epoch] = inc

    async def start(self, host: str = "127.0.0.1", port: int = 0):
        addr = await self.msgr.bind(host, port)
        while len(self.peer_addrs) <= self.rank:
            self.peer_addrs.append(None)
        self.peer_addrs[self.rank] = addr
        self._tick_task = asyncio.ensure_future(self._tick_loop())
        if self._admin_socket_path:
            self.admin_socket = AdminSocket(self._admin_socket_path)

            async def perf_dump(req):
                return self.perf.dump()

            async def mon_status(req):
                return {"rank": self.rank, "quorum": sorted(self.quorum),
                        "leader": self.is_leader,
                        "epoch": self.osdmap.epoch,
                        "last_committed": self.store.last_committed()}

            self.admin_socket.register("perf dump",
                                       "dump perf counters", perf_dump)
            self.admin_socket.register("mon_status", "monitor status",
                                       mon_status)
            await self.admin_socket.start()
        return addr

    async def stop(self) -> None:
        self._stopped = True
        if self.admin_socket is not None:
            await self.admin_socket.stop()
        if self._tick_task:
            self._tick_task.cancel()
        if self._election_task:
            self._election_task.cancel()
        await self.msgr.shutdown()

    @property
    def is_leader(self) -> bool:
        return self.leader == self.rank or self._n_mons() <= 1

    # -- public accessors (the in-process daemon boundary) ------------------
    # Harness/bench code must not hold the mon's live subsystems
    # (cross-daemon-state rule): these return plain data that a
    # mon_command round-trip could equally serve in the swarm.

    @property
    def addr(self) -> tuple[str, int] | None:
        """The mon's bound messenger address (None before start)."""
        return self.msgr.addr

    def osd_is_up(self, osd_id: int) -> bool:
        """Liveness of one OSD in the mon's current map view."""
        return self.osdmap.is_up(osd_id)

    def osd_addr(self, osd_id: int) -> tuple[str, int] | None:
        """Bound address of one OSD per the mon's current map view."""
        info = self.osdmap.osds.get(osd_id)
        addr = getattr(info, "addr", None)
        return tuple(addr) if addr else None

    def placement_counters(self) -> dict:
        """Snapshot of the mon-side placement-cache perf counters."""
        return self.osdmap.placement_perf.dump()

    def _n_mons(self) -> int:
        return len([a for a in self.peer_addrs if a is not None])

    # -- elections ----------------------------------------------------------
    def _mon_peers(self) -> list[int]:
        return [r for r, a in enumerate(self.peer_addrs)
                if a is not None and r != self.rank]

    async def _send_mon(self, r: int, msg: Message) -> None:
        try:
            await self.msgr.send(tuple(self.peer_addrs[r]), f"mon.{r}",
                                 msg)
        except (ConnectionError, OSError):
            pass

    def start_election(self) -> None:
        if self._n_mons() <= 1:
            self.leader = self.rank
            self.quorum = {self.rank}
            return
        if self._election_task is None or self._election_task.done():
            self._election_task = asyncio.ensure_future(
                self._run_election())

    async def _run_election(self) -> None:
        """Campaign until a leader (us or a lower rank) holds a quorum.

        Lowest alive rank wins; a higher-ranked campaigner defers as
        soon as it sees a lower rank's proposal (ElectionLogic's
        rank-priority deferral)."""
        try:
            backoff = 0.3
            while not self._stopped:
                # every campaign uses a FRESH odd epoch: reusing one
                # would let acks from an abandoned round count toward a
                # relaunched candidacy (double victory)
                self.election_epoch += 2 if self.election_epoch % 2 \
                    else 1
                self.leader = None
                self._election_acks = {self.rank}
                epoch = self.election_epoch
                for r in self._mon_peers():
                    await self._send_mon(r, Message(
                        "mon_election_propose",
                        {"epoch": epoch, "rank": self.rank,
                         "last_committed": self.store.last_committed()}))
                await asyncio.sleep(backoff)
                if self.election_epoch != epoch or self.leader is not None:
                    return        # someone else won (or a newer round)
                if len(self._election_acks) >= self._majority():
                    await self._declare_victory(epoch)
                    return
                self.election_epoch += 2   # new odd round
                backoff = min(2.0, backoff * 1.7)
        except asyncio.CancelledError:
            pass

    async def _declare_victory(self, epoch: int) -> None:
        self.election_epoch = epoch + 1        # even: stable
        self.leader = self.rank
        self.quorum = set(self._election_acks)
        self._lease_misses = 0
        self._collected = False
        for r in sorted(self.quorum - {self.rank}):
            await self._send_mon(r, Message(
                "mon_election_victory",
                {"epoch": self.election_epoch, "rank": self.rank,
                 "quorum": sorted(self.quorum)}))
        # recover any in-flight value before serving (Paxos collect)
        await self._paxos_collect()

    async def _h_mon_election_propose(self, conn, msg) -> None:
        epoch, rank = msg.data["epoch"], msg.data["rank"]
        if epoch < self.election_epoch:
            return                              # stale round
        if epoch > self.election_epoch:
            self.election_epoch = epoch
            self.leader = None
        if rank < self.rank:
            # defer to the lower rank; stop our own candidacy and hold
            # off re-campaigning long enough for its victory to land
            # (without the hold, the tick loop would relaunch us at a
            # higher epoch and depose the winner -- election flapping)
            if self._election_task and not self._election_task.done():
                self._election_task.cancel()
            self._defer_until = time.monotonic() + 1.5
            # the PROMISE: at most ONE ack per epoch -- acking a second
            # candidate in the same epoch (even a lower rank) could
            # hand two candidates a majority at once.  The lower rank
            # simply wins the next round instead.
            acked = getattr(self, "_acked", None)
            if acked is None or epoch > acked[0]:
                self._acked = (epoch, rank)
                await self._send_mon(rank, Message(
                    "mon_election_ack",
                    {"epoch": epoch, "rank": self.rank}))
        elif (self.leader is None
              and time.monotonic() > getattr(self, "_defer_until", 0.0)):
            self.start_election()               # outrank them: campaign

    async def _h_mon_election_ack(self, conn, msg) -> None:
        if msg.data["epoch"] == self.election_epoch:
            self._election_acks.add(msg.data["rank"])

    async def _h_mon_election_victory(self, conn, msg) -> None:
        epoch = msg.data["epoch"]
        if epoch < self.election_epoch:
            return
        if self._election_task and not self._election_task.done():
            self._election_task.cancel()
        self.election_epoch = epoch
        self.leader = msg.data["rank"]
        self.quorum = set(msg.data["quorum"])
        self._lease_expire = (time.monotonic()
                              + self.config["mon_lease"])

    # -- leases (Paxos lease: peons trust the leader while fresh) -----------
    async def _h_mon_lease(self, conn, msg) -> None:
        if msg.data["epoch"] != self.election_epoch:
            return
        self._lease_expire = time.monotonic() + self.config["mon_lease"]
        await conn.send(Message("mon_lease_ack",
                                {"epoch": self.election_epoch,
                                 "rank": self.rank}))

    async def _h_mon_lease_ack(self, conn, msg) -> None:
        if msg.data["epoch"] == self.election_epoch:
            self._lease_acks.add(msg.data["rank"])

    # -- paxos collect (Paxos.cc:154-613) -----------------------------------
    async def _paxos_collect(self) -> None:
        """New-leader recovery: learn every committed version the
        quorum has, re-propose any accepted-but-uncommitted value, and
        catch lagging peons up.  Nothing is served until this runs."""
        peers = sorted(self.quorum - {self.rank})
        self._collect_replies: dict[int, dict] = {}
        for r in peers:
            await self._send_mon(r, Message(
                "paxos_collect",
                {"epoch": self.election_epoch,
                 "last_committed": self.store.last_committed()}))
        deadline = time.monotonic() + 5.0
        while (len(self._collect_replies) < len(peers)
               and time.monotonic() < deadline):
            await asyncio.sleep(0.05)
        # 1. adopt committed versions we missed (they are FACTS)
        for rep in self._collect_replies.values():
            for v_str, blob_hex in sorted(rep.get("missing", {}).items(),
                                          key=lambda kv: int(kv[0])):
                v = int(v_str)
                if v == self.store.last_committed() + 1:
                    self._commit_local(v, bytes.fromhex(blob_hex))
        # 2. re-propose the HIGHEST-BALLOT accepted-but-uncommitted
        # value (classic phase-1: among competing accepted values, the
        # newest term's may already be committed somewhere unseen)
        next_v = self.store.last_committed() + 1
        best: tuple[int, bytes] | None = None
        if (blob := self.store.get_kv(f"pending_{next_v}")) is not None:
            ballot = int(self.store.get_kv(f"pending_e_{next_v}")
                         or b"0")
            best = (ballot, blob)
        for rep in self._collect_replies.values():
            u = rep.get("uncommitted")
            if u and int(u[0]) == next_v:
                ballot = int(u[2]) if len(u) > 2 else 0
                if best is None or ballot > best[0]:
                    best = (ballot, bytes.fromhex(u[1]))
        if best is not None:
            inc = Incremental.from_dict(json.loads(best[1]))
            inc.epoch = 0
            await self._propose_locked(inc, recovery=True)
        # 3. catch lagging peons up to our committed state
        for r, rep in self._collect_replies.items():
            for v in range(int(rep["last_committed"]) + 1,
                           self.store.last_committed() + 1):
                blob = self.store.get(v)
                if blob is not None:
                    await self._send_mon(r, Message(
                        "paxos_commit",
                        {"version": v, "value": blob.decode()}))
        self._collected = True

    async def _h_paxos_collect(self, conn, msg) -> None:
        if msg.data["epoch"] != self.election_epoch:
            return
        leader_lc = int(msg.data["last_committed"])
        mine = self.store.last_committed()
        missing = {str(v): self.store.get(v).hex()
                   for v in range(leader_lc + 1, mine + 1)
                   if self.store.get(v) is not None}
        uncommitted = None
        pending = self.store.get_kv(f"pending_{mine + 1}")
        if pending is not None:
            ballot = int(self.store.get_kv(f"pending_e_{mine + 1}")
                         or b"0")
            uncommitted = [mine + 1, pending.hex(), ballot]
        await conn.send(Message("paxos_last",
                                {"epoch": self.election_epoch,
                                 "rank": self.rank,
                                 "last_committed": mine,
                                 "missing": missing,
                                 "uncommitted": uncommitted}))

    async def _h_paxos_last(self, conn, msg) -> None:
        if msg.data["epoch"] == self.election_epoch:
            self._collect_replies[msg.data["rank"]] = msg.data

    def _majority(self) -> int:
        return len([a for a in self.peer_addrs if a is not None]) // 2 + 1

    # -- proposal path ------------------------------------------------------
    async def propose(self, inc: Incremental) -> None:
        """Commit one incremental through the quorum (leader-side)."""
        self.perf_paxos.inc("begin")
        with self.perf_paxos.time("commit_latency"):
            await self._propose_locked(inc)
        self.perf_paxos.inc("commit")

    async def _propose_locked(self, inc: Incremental,
                              recovery: bool = False) -> None:
        async with self._pending_lock:
            inc.epoch = self.osdmap.epoch + 1
            blob = json.dumps(inc.to_dict()).encode()
            version = inc.epoch
            n_peers = len([a for a in self.peer_addrs if a is not None])
            if n_peers <= 1:
                self._commit_local(version, blob)
            else:
                # a proposal that lands while an election is settling
                # waits for the term AND for the collect phase: serving
                # before collect could assign a version number the old
                # quorum already committed elsewhere (recovery=True is
                # the collect phase's own re-proposal)
                deadline = time.monotonic() + 5.0
                while (time.monotonic() < deadline
                       and (self.leader is None
                            or (self.is_leader and not recovery
                                and not self._collected))):
                    await asyncio.sleep(0.1)
                if not self.is_leader or (not recovery
                                          and not self._collected):
                    raise RuntimeError(
                        f"mon.{self.rank} cannot propose "
                        f"(leader={self.leader}, "
                        f"collected={self._collected})")
                inc.epoch = self.osdmap.epoch + 1
                blob = json.dumps(inc.to_dict()).encode()
                version = inc.epoch
                self.accepts[version] = {self.rank}
                fut = asyncio.get_event_loop().create_future()
                self._commit_waiters[version] = fut
                for r, addr in enumerate(self.peer_addrs):
                    if r == self.rank or addr is None:
                        continue
                    try:
                        await self.msgr.send(
                            tuple(addr), f"mon.{r}",
                            Message("paxos_begin",
                                    {"version": version,
                                     "e": self.election_epoch,
                                     "value": blob.decode()}))
                    except (ConnectionError, OSError):
                        pass
                await asyncio.wait_for(fut, timeout=10)
                self._commit_local(version, blob)
            await self._publish(inc)

    def _commit_local(self, version: int, blob: bytes) -> None:
        self.store.commit(version, blob)
        inc = Incremental.from_dict(json.loads(blob))
        self.osdmap.apply_incremental(inc)
        self.services.apply(inc.service_kv)
        if "config" in inc.service_kv:
            # EVERY mon pushes config to ITS subscribers (a daemon
            # subscribed to a peon must see changes the leader commits)
            t = asyncio.ensure_future(self.push_config())
            self._bg_tasks = getattr(self, "_bg_tasks", set())
            self._bg_tasks.add(t)
            t.add_done_callback(self._bg_tasks.discard)
        self.incrementals[inc.epoch] = inc
        # EVERY mon pushes deltas to its own subscribers (peons serve
        # map subscriptions too; the reference mons all publish)
        if self.subscribers:
            t = asyncio.ensure_future(self._push_subscribers(inc))
            self._bg_tasks = getattr(self, "_bg_tasks", set())
            self._bg_tasks.add(t)
            t.add_done_callback(self._bg_tasks.discard)

    async def _push_subscribers(self, inc: Incremental) -> None:
        # one dict for every subscriber's message: each is encoded on its
        # own connection, none is changed after
        body = inc.to_dict()
        dead = []
        for name, conn in list(self.subscribers.items()):
            try:
                await conn.send(Message("osdmap_inc", {"inc": body}))
            except (ConnectionError, OSError):
                dead.append(name)
        for name in dead:
            self.subscribers.pop(name, None)

    async def _publish(self, inc: Incremental) -> None:
        # distribute commit (with its value: a peon that missed the
        # begin still converges) to the quorum
        n_peers = len([a for a in self.peer_addrs if a is not None])
        if n_peers > 1:
            blob = json.dumps(inc.to_dict()).encode()
            for r, addr in enumerate(self.peer_addrs):
                if r == self.rank or addr is None:
                    continue
                try:
                    await self.msgr.send(
                        tuple(addr), f"mon.{r}",
                        Message("paxos_commit",
                                {"version": inc.epoch,
                                 "value": blob.decode()}))
                except (ConnectionError, OSError):
                    pass

    # -- dispatch -----------------------------------------------------------
    async def _dispatch(self, conn, msg: Message) -> None:
        handler = getattr(self, f"_h_{msg.type}", None)
        if handler is not None:
            await handler(conn, msg)

    async def _h_paxos_begin(self, conn, msg) -> None:
        version = msg.data["version"]
        blob = msg.data["value"].encode()
        # peon: accept if it extends our log AND comes from the current
        # term (a deposed leader's in-flight begin must not be accepted
        # into the new leader's quorum)
        e = msg.data.get("e")
        if e is not None and e != self.election_epoch:
            return
        if version == self.store.last_committed() + 1:
            self.store.put_kv(f"pending_{version}", blob)
            # record the BALLOT (term) with the acceptance: collect
            # picks the highest-ballot value among competing pendings
            self.store.put_kv(f"pending_e_{version}",
                              str(e if e is not None
                                  else self.election_epoch).encode())
            await conn.send(Message("paxos_accept", {"version": version,
                                                     "rank": self.rank}))

    async def _h_paxos_accept(self, conn, msg) -> None:
        version = msg.data["version"]
        acc = self.accepts.get(version)
        if acc is None:
            return
        acc.add(msg.data["rank"])
        if len(acc) >= self._majority():
            fut = self._commit_waiters.pop(version, None)
            if fut and not fut.done():
                fut.set_result(True)

    async def _h_paxos_commit(self, conn, msg) -> None:
        version = msg.data["version"]
        # commit messages may carry the value (collect catch-up path);
        # otherwise it was stashed at begin time
        if "value" in msg.data:
            blob = msg.data["value"].encode()
        else:
            blob = self.store.get_kv(f"pending_{version}")
        if blob is not None and version == self.store.last_committed() + 1:
            self._commit_local(version, blob)

    async def _h_mon_probe(self, conn, msg) -> None:
        # discovery only: quorum membership comes from ELECTIONS, never
        # from a probe (a stale or partitioned mon must not inject
        # itself into an active quorum)
        await conn.send(Message("mon_probe_ack",
                                {"rank": self.rank,
                                 "election_epoch": self.election_epoch,
                                 "leader": self.leader}))

    async def _h_mon_probe_ack(self, conn, msg) -> None:
        pass

    # -- osd lifecycle ------------------------------------------------------
    async def _h_osd_boot(self, conn, msg) -> None:
        """OSD announces itself: {uuid, addr, host, osd_id?}.

        Identity (uuid->id) and topology (id->host) come from the
        replicated MAP, so any elected leader resolves reboots
        identically -- never from a single mon's in-memory registry.

        Serialized: id assignment reads ``osdmap.max_osd`` and the
        commit that bumps it happens inside ``propose`` -- two fresh
        OSDs booting concurrently (the cluster harness boots in
        batches) would otherwise both read the same ``max_osd`` and
        claim the same id."""
        async with self._boot_lock:
            await self._h_osd_boot_locked(conn, msg)

    async def _h_osd_boot_locked(self, conn, msg) -> None:
        uuid = msg.data["uuid"]
        host = msg.data.get("host", "host0")
        addr = msg.data["addr"]
        osd_id = msg.data.get("osd_id")
        if osd_id is None:
            for o, info in self.osdmap.osds.items():
                if info.uuid == uuid:
                    osd_id = o
                    break
        if osd_id is None:
            osd_id = self.osdmap.max_osd
        inc = Incremental(epoch=0)
        inc.new_up[osd_id] = list(addr)
        inc.new_in.append(osd_id)
        inc.new_weights[osd_id] = 0x10000
        inc.new_uuids[osd_id] = uuid
        inc.new_hosts[osd_id] = host
        inc.new_max_osd = max(self.osdmap.max_osd, osd_id + 1)
        inc.new_crush = self._build_crush_dict(extra_osd=(osd_id, host))
        await self.propose(inc)
        await conn.send(Message(
            "osd_boot_ack",
            {"osd_id": osd_id, "epoch": self.osdmap.epoch,
             "monmap": [list(a) for a in self.peer_addrs
                        if a is not None]}))

    def _build_crush_dict(self, extra_osd=None) -> dict:
        """Rebuild the CRUSH map from the osd->host registry.

        Two-level straw2 hierarchy root->host->osd with rule 0 replicated
        and rule 1 erasure (chooseleaf over hosts when >1 host, else
        direct osd choose) -- the default map OSDMonitor builds as OSDs
        register.
        """
        hosts: dict[str, list[int]] = defaultdict(list)
        for osd, info in self.osdmap.osds.items():
            if info.host:
                hosts[info.host].append(osd)
        if extra_osd is not None:
            osd, host = extra_osd
            if osd not in hosts[host]:
                hosts[host].append(osd)
        cm = CrushMap()
        host_ids = []
        for i, hname in enumerate(sorted(hosts)):
            hid = -(2 + i)
            osds = sorted(hosts[hname])
            cm.add_bucket(
                Bucket(id=hid, type=1, alg=CRUSH_BUCKET_STRAW2, items=osds,
                       item_weights=[0x10000] * len(osds)), hname)
            host_ids.append(hid)
        cm.add_bucket(
            Bucket(id=-1, type=10, alg=CRUSH_BUCKET_STRAW2, items=host_ids,
                   item_weights=[0x10000 * len(hosts[h])
                                 for h in sorted(hosts)]), "default")
        multi_host = len(host_ids) > 1
        cm.add_rule(replicated_rule(0, -1, choose_type=1 if multi_host else 0,
                                    leaf=multi_host))
        cm.add_rule(erasure_rule(1, -1, choose_type=1 if multi_host else 0,
                                 leaf=multi_host))
        return crush_to_dict(cm)

    async def _h_osd_failure(self, conn, msg) -> None:
        """Failure report; mark down once enough distinct reporters agree."""
        target = msg.data["target"]
        reporter = msg.data.get("reporter") or msg.from_name
        if not self.is_leader:
            if self.leader is not None:
                await self._send_mon(self.leader, Message(
                    "osd_failure", {"target": target,
                                    "reporter": reporter}))
            return
        if not self.osdmap.is_up(target):
            return
        self.failure_reports[target].add(reporter)
        n_up = sum(1 for o in self.osdmap.osds.values() if o.up)
        need = min(self.config["mon_osd_min_down_reporters"],
                   max(1, n_up - 1))
        if len(self.failure_reports[target]) >= need:
            inc = Incremental(epoch=0)
            inc.new_down.append(target)
            # the mark-down rides with its cluster-log entry in ONE
            # commit (LogMonitor entries share the map's paxos)
            inc.service_kv = {"log": self.services.log_entry(
                "WRN", f"osd.{target} marked down after "
                       f"{len(self.failure_reports[target])} reports")}
            self.failure_reports.pop(target, None)
            self._down_since[target] = time.monotonic()
            await self.propose(inc)

    async def _h_osd_alive(self, conn, msg) -> None:
        """MOSDAlive: clears pending failure reports and, when the OSD
        asks (want_up_thru), bumps its up_thru in the map so peering
        can prove the new interval went active (OSDMonitor::
        prepare_alive -- up_thru is the prior-interval-liveness fact
        past_intervals pruning depends on)."""
        osd = msg.data["osd_id"]
        self.failure_reports.pop(osd, None)
        want = int(msg.data.get("want_up_thru", 0))
        if want and not self.is_leader and self.leader is not None:
            # peon: forward to the leader (as _h_osd_failure does) and
            # ROUTE THE REPLY BACK -- without the relay the OSD whose
            # mon session landed here would never see osd_alive_reply
            # and peering would stall on the request timeout
            tid = f"alivefwd-{self.rank}-{time.monotonic_ns()}"
            self._fwd_register(tid, conn, "osd_alive_reply")
            await self._send_mon(self.leader, Message(
                "osd_alive", {**msg.data,
                              "fwd_tids": msg.data.get("fwd_tids", [])
                              + [tid]}))
            return
        if want and self.is_leader and self.osdmap.is_up(osd):
            if self.osdmap.get_up_thru(osd) < want:
                await self._up_thru_batched(osd)
            await conn.send(Message(
                "osd_alive_reply",
                {"osd_id": osd, "up_thru": self.osdmap.get_up_thru(osd),
                 "epoch": self.osdmap.epoch,
                 **({"fwd_tids": msg.data["fwd_tids"]}
                    if "fwd_tids" in msg.data else {})}))

    async def _up_thru_batched(self, osd: int) -> None:
        """Coalesce up_thru bumps into one proposal per window.

        A pool create on a big cluster makes EVERY new PG's primary
        request up_thru within milliseconds; one paxos epoch (and one
        map-delta broadcast to every subscriber) per request is an
        epoch storm -- hundreds of epochs x every OSD applying each.
        OSDMonitor batches the same way via pending_inc: requests
        arriving within mon_up_thru_batch_window commit as ONE epoch.
        """
        self._pending_up_thru.add(osd)
        if self._up_thru_flush is None or self._up_thru_flush.done():
            self._up_thru_flush = asyncio.get_event_loop() \
                .create_future()
            self._up_thru_task = asyncio.ensure_future(
                self._flush_up_thru(self._up_thru_flush))
        await self._up_thru_flush

    async def _flush_up_thru(self, fut: asyncio.Future) -> None:
        try:
            await asyncio.sleep(float(self.config.get(
                "mon_up_thru_batch_window", 0.05)))
            batch, self._pending_up_thru = self._pending_up_thru, set()
            inc = Incremental(epoch=0)
            for o in batch:
                if self.osdmap.is_up(o):
                    inc.new_up_thru[o] = self.osdmap.epoch
            if inc.new_up_thru:
                await self.propose(inc)
        finally:
            if not fut.done():
                fut.set_result(None)

    async def _h_osd_alive_reply(self, conn, msg) -> None:
        # mon side: a forwarded alive's reply coming back from the
        # leader; relay to the waiting OSD connection
        await self._auth_relay_reply(msg)

    # -- subscriptions ------------------------------------------------------
    async def _h_osd_pg_temp(self, conn, msg) -> None:
        """An OSD requests an acting-set override for a pg (MOSDPGTemp:
        the gapped CRUSH primary hands serving to a complete peer while
        it backfills; an empty list clears the override)."""
        if not self.is_leader:
            return                  # the OSD's mon failover finds the leader
        pgid = msg.data["pgid"]
        osds = [int(o) for o in msg.data.get("osds", [])]
        if self.osdmap.pg_temp.get(pgid, []) != osds:
            inc = Incremental(epoch=0)
            inc.new_pg_temp[pgid] = osds
            await self.propose(inc)
        await conn.send(Message("osd_pg_temp_reply",
                                {"pgid": pgid,
                                 "tid": msg.data.get("tid"),
                                 "epoch": self.osdmap.epoch}))

    # -- cephx (AuthMonitor ticket service) ----------------------------------
    @property
    def cephx(self):
        from ..common.cephx import CephxAuthority
        if getattr(self, "_cephx", None) is None:
            self._cephx = CephxAuthority(
                ttl=float(self.config.get("auth_service_ticket_ttl",
                                          3600.0)),
                ticket_ttl=float(self.config.get("auth_ticket_ttl",
                                                 600.0)))
            # replicated rotating keys (peons validate/restore from
            # the paxos log via services.apply)
            for svc, d in getattr(self.services, "cephx_keys",
                                  {}).items():
                from ..common.cephx import RotatingKeys
                self._cephx.rotating[svc] = RotatingKeys.from_dict(
                    d, self._cephx.ttl)
        return self._cephx

    async def _persist_rotating(self, service: str) -> None:
        rk = self.cephx.rotating[service]
        await self.propose_service_kv(
            "cephx", {service: json.dumps(rk.to_dict())})

    async def _auth_forward(self, conn, msg, reply_type: str) -> None:
        """Relay an auth request to the leader and route the reply
        back to the original requester: only the LEADER may create or
        rotate service keys (it alone persists them through paxos); a
        peon minting keys locally would issue tickets no service can
        validate.  Forwarding pushes onto a
        fwd_tids STACK so a stale-leadership re-forward chain still
        routes the reply hop by hop back to the origin."""
        if self.leader is None or self.peer_addrs[self.leader] is None:
            await conn.send(Message(
                reply_type, {"err": "no quorum leader",
                             **({"tid": msg.data["tid"]}
                                if "tid" in msg.data else {})}))
            return
        tid = f"authfwd-{self.rank}-{time.monotonic_ns()}"
        self._fwd_register(tid, conn, reply_type)
        await self._send_mon(self.leader, Message(
            msg.type, {**msg.data,
                       "fwd_tids": msg.data.get("fwd_tids", [])
                       + [tid]}))

    def _fwd_register(self, tid: str, conn, reply_type: str) -> None:
        """Track a forwarded request; sweep entries the leader never
        answered (e.g. it crashed) so dead Connections don't pin."""
        fwd = getattr(self, "_auth_fwd", None)
        if fwd is None:
            fwd = self._auth_fwd = {}
        now = time.monotonic()
        for k in [k for k, (_, _, dl) in fwd.items() if dl < now]:
            del fwd[k]
        fwd[tid] = (conn, reply_type, now + 30.0)

    async def _h_auth_ticket_reply(self, conn, msg) -> None:
        await self._auth_relay_reply(msg)

    async def _h_auth_rotating_reply(self, conn, msg) -> None:
        await self._auth_relay_reply(msg)

    async def _auth_relay_reply(self, msg) -> None:
        tids = list(msg.data.get("fwd_tids", []))
        if not tids:
            return
        ent = getattr(self, "_auth_fwd", {}).pop(tids[-1], None)
        if ent is not None:
            c, reply_type, _ = ent
            rest = tids[:-1]
            await c.send(Message(
                reply_type,
                {**{k: v for k, v in msg.data.items()
                    if k != "fwd_tids"},
                 **({"fwd_tids": rest} if rest else {})}))

    async def _h_auth_get_ticket(self, conn, msg) -> None:
        """CephxServiceHandler: a client proves its entity key and
        receives a session ticket for a service."""
        from ..common.cephx import CephxError
        if not self.is_leader:
            await self._auth_forward(conn, msg, "auth_ticket_reply")
            return
        d = msg.data
        entity = d["entity"]
        rec = self.services.auth_db.get(entity)
        extra = {k: d[k] for k in ("fwd_tids", "tid") if k in d}
        try:
            if rec is None:
                raise CephxError(f"unknown entity {entity}")
            self.cephx.verify_entity_proof(rec["key"], d["nonce"],
                                           d["proof"])
            before = self.cephx.rotating.get(d["service"])
            gen_before = before.gen if before else 0
            pkg = self.cephx.issue_ticket(entity, rec["key"],
                                          d["service"])
            if self.cephx.rotating[d["service"]].gen != gen_before:
                await self._persist_rotating(d["service"])
            await conn.send(Message("auth_ticket_reply",
                                    {**pkg, **extra}))
        except CephxError as e:
            await conn.send(Message("auth_ticket_reply",
                                    {"err": str(e), **extra}))

    async def _h_auth_rotating(self, conn, msg) -> None:
        """A service daemon fetches its rotating validation keys,
        proving its own entity key; keys ship sealed under it."""
        from ..common.cephx import CephxError, seal
        if not self.is_leader:
            await self._auth_forward(conn, msg, "auth_rotating_reply")
            return
        d = msg.data
        entity = d["entity"]
        rec = self.services.auth_db.get(entity)
        extra = {k: d[k] for k in ("fwd_tids", "tid") if k in d}
        try:
            if rec is None:
                raise CephxError(f"unknown entity {entity}")
            if not entity.startswith(f"{d['service']}."):
                raise CephxError(
                    f"{entity} may not read {d['service']} keys")
            self.cephx.verify_entity_proof(rec["key"], d["nonce"],
                                           d["proof"])
            before = self.cephx.rotating.get(d["service"])
            gen_before = before.gen if before else 0
            rk = self.cephx.service_keys(d["service"])
            if rk.gen != gen_before:
                await self._persist_rotating(d["service"])
            # the reply must seal with the key the client just
            # proved with; a rotation landing during the persist must
            # not swap it mid-exchange (clients re-auth on failure)
            # lint: disable=await-invalidates-snapshot -- proof-bound key
            blob = seal(bytes.fromhex(rec["key"]), rk.to_dict())
            await conn.send(Message("auth_rotating_reply",
                                    {"sealed": blob, **extra}))
        except CephxError as e:
            await conn.send(Message("auth_rotating_reply",
                                    {"err": str(e), **extra}))

    # -- MDSMonitor (FSMap) --------------------------------------------------
    MDS_BEACON_GRACE = 8.0

    async def _h_mds_beacon(self, conn, msg) -> None:
        """MMDSBeacon: mon-owned MDS membership (MDSMonitor::
        preprocess_beacon).  The leader assigns the active rank and
        promotes a standby when the active's beacons go silent past
        the grace; every change bumps the FSMap epoch through paxos."""
        name = msg.data["name"]
        addr = tuple(msg.data["addr"])
        if not self.is_leader:
            if self.leader is not None:
                await self._send_mon(self.leader, Message(
                    "mds_beacon", dict(msg.data)))
            # the peon answers from its REPLICATED fsmap: the leader's
            # assignment reaches the mds even when only a peon is
            # reachable (the forwarded beacon keeps liveness flowing)
            fsm = self.services.fsmap
            you = ("active" if fsm.get("active")
                   and fsm["active"]["name"] == name else "standby")
            await conn.send(Message("mds_beacon_ack",
                                    {"fsmap": fsm, "you": you}))
            return
        now = time.monotonic()
        beats = getattr(self, "mds_last_beacon", None)
        if beats is None:
            beats = self.mds_last_beacon = {}
        beats[name] = now
        fsmap = self.services.fsmap
        active = fsmap.get("active")
        changed = False
        new = {"epoch": fsmap.get("epoch", 0),
               "active": dict(active) if active else None,
               "standbys": [dict(s) for s in fsmap.get("standbys", [])]}
        if new["active"] and new["active"]["name"] == name:
            if tuple(new["active"]["addr"]) != addr:
                new["active"]["addr"] = list(addr)
                changed = True
        else:
            sb = {s["name"]: s for s in new["standbys"]}
            if name not in sb or tuple(sb[name]["addr"]) != addr:
                sb[name] = {"name": name, "addr": list(addr)}
                new["standbys"] = list(sb.values())
                changed = True
        # failover: the active's beacons lapsed -> promote a live
        # standby (MDSMonitor::tick fail_mds_gid path)
        act = new["active"]
        if act is not None and act["name"] != name:
            # a fresh leader has an empty beacon table: grace is
            # measured from FIRST observation, never from epoch zero
            last = beats.setdefault(act["name"], now)
            if now - last > self.MDS_BEACON_GRACE:
                act = None
        if act is None:
            live = [s for s in new["standbys"]
                    if now - beats.get(s["name"], 0.0)
                    < self.MDS_BEACON_GRACE]
            if live:
                promoted = live[0]
                new["standbys"] = [s for s in new["standbys"]
                                   if s["name"] != promoted["name"]]
                # a deposed daemon rejoins as a standby on its next
                # beacon (the registration branch above)
                new["active"] = promoted
                changed = True
            else:
                if new["active"] is not None:
                    new["active"] = None
                    changed = True
        if changed:
            new["epoch"] = new.get("epoch", 0) + 1
            await self.propose_service_kv("fsmap", {"map": new})
        fsmap = self.services.fsmap
        you = ("active" if fsmap.get("active")
               and fsmap["active"]["name"] == name else "standby")
        await conn.send(Message("mds_beacon_ack",
                                {"fsmap": fsmap, "you": you}))

    async def _h_sub_fsmap(self, conn, msg) -> None:
        # subscription reply for MDS clients that subscribe over the
        # wire; the in-tree client polls `fs dump` via mon_command
        # instead, so no dispatcher matches the type yet
        # lint: disable=wire-safety -- no in-tree fsmap subscriber
        await conn.send(Message("fsmap",
                                {"fsmap": self.services.fsmap}))

    async def _h_osd_slow_ops(self, conn, msg) -> None:
        """An OSD complains about ops in flight past the complaint
        threshold (OSD::get_health_metrics -> mon SLOW_OPS health +
        cluster log)."""
        osd = msg.data["osd_id"]
        if not self.is_leader and self.leader is not None:
            # health answers come from the leader: forward like
            # _h_osd_failure so the report lands where it is read
            await self._send_mon(self.leader, Message(
                "osd_slow_ops", dict(msg.data)))
            return
        reports = getattr(self, "slow_ops_reports", None)
        if reports is None:
            reports = self.slow_ops_reports = {}
        reports[osd] = {"count": int(msg.data.get("count", 0)),
                        "oldest_age": float(msg.data.get(
                            "oldest_age", 0.0)),
                        "stamp": time.monotonic()}
        if self.is_leader and msg.data.get("log"):
            await self.propose_service_kv("log", self.services.log_entry(
                "WRN", f"osd.{osd} has {msg.data['count']} slow ops, "
                       f"oldest {msg.data.get('oldest_age', 0):.0f}s",
                who=f"osd.{osd}"))

    MGR_BEACON_GRACE = 8.0

    async def _h_mgr_beacon(self, conn, msg) -> None:
        """MgrMonitor::prepare_beacon: the LEADER owns the replicated
        MgrMap -- first mgr to beacon becomes active, later ones stand
        by, and a lapsed active is deposed in _tick with a standby
        promoted.  Peons forward so the map is mon-agnostic."""
        name = msg.data.get("name", "")
        addr = list(msg.data["addr"])
        if not self.is_leader:
            if self.leader is not None:
                await self._send_mon(self.leader, Message(
                    "mgr_beacon", dict(msg.data)))
            return
        beats = getattr(self, "mgr_last_beacon", None)
        if beats is None:
            beats = self.mgr_last_beacon = {}
        beats[name] = time.monotonic()
        m = dict(self.services.mgrmap)
        changed = False
        if m.get("active") is None:
            m.update({"active": name, "active_addr": addr,
                      "epoch": m["epoch"] + 1,
                      "standbys": [x for x in m.get("standbys", [])
                                   if x["name"] != name]})
            changed = True
        elif m["active"] == name:
            if m.get("active_addr") != addr:
                m.update({"active_addr": addr,
                          "epoch": m["epoch"] + 1})
                changed = True
        else:
            stand = list(m.get("standbys", []))
            cur = next((x for x in stand if x["name"] == name), None)
            if cur is None:
                m["standbys"] = stand + [{"name": name, "addr": addr}]
                m["epoch"] += 1
                changed = True
            elif cur["addr"] != addr:
                # a restarted standby's NEW address must be the one a
                # later failover promotes
                cur["addr"] = addr
                m["standbys"] = stand
                m["epoch"] += 1
                changed = True
        if changed:
            await self.propose_service_kv(
                "mgrmap", {"map": json.dumps(m)})
            await self._publish_mgr_map()

    async def _publish_mgr_map(self) -> None:
        m = self.services.mgrmap
        if not m.get("active"):
            return
        payload = {"name": m["active"], "addr": m["active_addr"]}
        for name, sub in list(self.subscribers.items()):
            try:
                await sub.send(Message("mgr_map", payload))
            except (ConnectionError, OSError):
                self.subscribers.pop(name, None)

    def _full_map(self) -> dict:
        """``self.osdmap.to_dict()``, made once a map generation: every
        daemon's map-freshness probe fetches the full map every few quiet
        seconds.  Shared by the messages that carry it; none changes it."""
        key = (self.osdmap.epoch, self.osdmap._mutation_gen)
        memo = getattr(self, "_full_map_memo", None)
        if memo is None or memo[0] != key:
            memo = self._full_map_memo = (key, self.osdmap.to_dict())
        return memo[1]

    async def _h_sub_osdmap(self, conn, msg) -> None:
        self.subscribers[msg.from_name] = conn
        await conn.send(Message("osdmap_full", {"map": self._full_map()}))
        cfg = self.services.config_for(msg.from_name)
        if cfg:                  # central config lands at subscription
            await conn.send(Message("config_update", {"config": cfg}))
        mgrm = self.services.mgrmap
        if mgrm.get("active"):             # late joiners learn the mgr
            await conn.send(Message("mgr_map",
                                    {"name": mgrm["active"],
                                     "addr": mgrm["active_addr"]}))

    async def _h_get_osdmap(self, conn, msg) -> None:
        # a delta fetch keeps the caller on the broadcast feed: the
        # refresh path must survive a mon restart that dropped the
        # subscriber table
        self.subscribers[msg.from_name] = conn
        since = msg.data.get("since", 0)
        incs = [self.incrementals[e].to_dict()
                for e in range(since + 1, self.osdmap.epoch + 1)
                if e in self.incrementals]
        if len(incs) == self.osdmap.epoch - since:
            await conn.send(Message("osdmap_incs", {"incs": incs}))
        else:
            await conn.send(Message("osdmap_full",
                                    {"map": self._full_map()}))

    # -- commands -----------------------------------------------------------
    async def _h_mon_command(self, conn, msg) -> None:
        cmd = msg.data.get("cmd", "")
        args = msg.data.get("args", {})
        if not self.is_leader and not msg.data.get("fwd"):
            # peon: relay mutating traffic to the leader (the reference
            # forwards with MForward); the reply routes back here
            data = await self._forward_to_leader(msg)
            data["tid"] = msg.data.get("tid")
            await conn.send(Message("mon_command_reply", data))
            return
        try:
            result = await self.handle_command(cmd, args)
            await conn.send(Message("mon_command_reply",
                                    {"ok": True, "result": result,
                                     "tid": msg.data.get("tid")}))
        except Exception as e:  # command errors return to caller
            await conn.send(Message("mon_command_reply",
                                    {"ok": False, "error": str(e),
                                     "tid": msg.data.get("tid")}))

    async def _forward_to_leader(self, msg) -> dict:
        if self.leader is None or self.peer_addrs[self.leader] is None:
            return {"ok": False, "error": "no quorum leader"}
        relay_tid = f"fwd-{self.rank}-{time.monotonic_ns()}"
        fut: asyncio.Future = asyncio.get_event_loop().create_future()
        self._fwd_waiters = getattr(self, "_fwd_waiters", {})
        self._fwd_waiters[relay_tid] = fut
        try:
            await self._send_mon(self.leader, Message(
                "mon_command", {"cmd": msg.data.get("cmd", ""),
                                "args": msg.data.get("args", {}),
                                "tid": relay_tid, "fwd": True}))
            return await asyncio.wait_for(fut, 10)
        except asyncio.TimeoutError:
            return {"ok": False, "error": "leader did not answer"}
        finally:
            self._fwd_waiters.pop(relay_tid, None)

    async def _h_mon_command_reply(self, conn, msg) -> None:
        fut = getattr(self, "_fwd_waiters", {}).pop(
            msg.data.get("tid"), None)
        if fut is not None and not fut.done():
            fut.set_result({k: v for k, v in msg.data.items()
                            if k != "tid"})

    async def propose_service_kv(self, service: str, kv: dict) -> None:
        """Commit a non-osdmap service mutation through paxos."""
        inc = Incremental(epoch=0)
        inc.service_kv = {service: kv}
        await self.propose(inc)

    async def push_config(self) -> None:
        """Push effective config to subscribed daemons (the mon sends
        MConfig on changes; daemons apply via ConfigProxy observers)."""
        for name, conn in list(self.subscribers.items()):
            try:
                await conn.send(Message(
                    "config_update",
                    {"config": self.services.config_for(name)}))
            except (ConnectionError, OSError):
                pass

    async def handle_command(self, cmd: str, args: dict):
        from .services import UnknownCommand
        try:
            return await self.services.handle_command(cmd, args)
        except UnknownCommand:
            pass                 # not a service command; fall through
        if cmd == "osd blocklist":
            # fence a client INSTANCE ("name:incarnation") at the data
            # path: every OSD refuses its ops once the map propagates
            # (OSDMonitor.cc blocklist; fences lease-lapsed cephfs
            # clients and deposed rbd lock holders)
            iid = args["id"]
            inc = Incremental(epoch=0)
            if args.get("rm"):
                inc.old_blocklist.append(iid)
            else:
                until = time.time() + float(args.get("duration", 3600))
                inc.new_blocklist[iid] = until
            inc.service_kv = {"log": self.services.log_entry(
                "WRN", f"blocklist {'rm ' if args.get('rm') else ''}"
                       f"{iid}")}
            await self.propose(inc)
            return {"id": iid, "epoch": self.osdmap.epoch}
        if cmd == "osd blocklist ls":
            now = time.time()
            return {iid: exp for iid, exp in
                    self.osdmap.blocklist.items() if exp > now}
        if cmd == "osd pool create":
            return await self._cmd_pool_create(args)
        if cmd == "osd pool rm":
            return await self._cmd_pool_rm(args)
        if cmd == "osd pool ls":
            return sorted(self.osdmap.pool_names)
        if cmd == "osd erasure-code-profile set":
            name = args["name"]
            profile = dict(args.get("profile", {}))
            # validate by instantiating the plugin
            plugin = profile.get("plugin", "cuda")
            codec = ec_registry().factory(
                plugin, {k: v for k, v in profile.items()
                         if k != "plugin"}, device=self.device)
            if "stripe_unit" in profile:
                # prepare_pool_stripe_width analog (OSDMonitor.cc:7782):
                # reject unaligned/zero/garbage stripe units HERE, not
                # at first I/O on some OSD
                from ..osd.ec_util import parse_stripe_unit
                parse_stripe_unit(codec, profile["stripe_unit"])
            inc = Incremental(epoch=0)
            inc.new_ec_profiles[name] = profile
            await self.propose(inc)
            return name
        if cmd == "osd erasure-code-profile ls":
            return sorted(self.osdmap.ec_profiles)
        if cmd == "osd erasure-code-profile get":
            return self.osdmap.ec_profiles[args["name"]]
        if cmd == "osd erasure-code-profile rm":
            inc = Incremental(epoch=0)
            inc.removed_ec_profiles.append(args["name"])
            await self.propose(inc)
            return args["name"]
        if cmd == "osd out":
            inc = Incremental(epoch=0)
            inc.new_out.append(int(args["osd_id"]))
            await self.propose(inc)
            return int(args["osd_id"])
        if cmd == "osd in":
            inc = Incremental(epoch=0)
            inc.new_in.append(int(args["osd_id"]))
            await self.propose(inc)
            return int(args["osd_id"])
        if cmd == "osd reweight":
            inc = Incremental(epoch=0)
            inc.new_weights[int(args["osd_id"])] = int(args["weight"])
            await self.propose(inc)
            return True
        if cmd == "osd pool selfmanaged-snap create":
            # serialize allocation: two concurrent creates reading the
            # same snap_seq would hand out one id twice
            if not hasattr(self, "_snap_alloc_lock"):
                self._snap_alloc_lock = asyncio.Lock()
            async with self._snap_alloc_lock:
                pool = self.osdmap.get_pool_by_name(args["pool"])
                if pool is None:
                    raise ValueError(f"no pool {args['pool']}")
                snapid = pool.snap_seq + 1
                inc = Incremental(epoch=0)
                inc.new_pool_snaps[pool.pool_id] = {"snap_seq": snapid}
                await self.propose(inc)
            return snapid
        if cmd == "osd pool selfmanaged-snap rm":
            pool = self.osdmap.get_pool_by_name(args["pool"])
            if pool is None:
                raise ValueError(f"no pool {args['pool']}")
            sid = int(args["snap"])
            inc = Incremental(epoch=0)
            inc.new_pool_snaps[pool.pool_id] = {
                "snap_seq": pool.snap_seq, "removed": [sid]}
            await self.propose(inc)
            return sid
        if cmd == "osd pg-upmap-items":
            pgid = args["pgid"]
            items = [[int(a), int(b)] for a, b in args["mappings"]]
            for _, to in items:
                if not self.osdmap.exists(to):
                    raise ValueError(f"osd.{to} does not exist")
            inc = Incremental(epoch=0)
            inc.new_pg_upmap_items[pgid] = items
            await self.propose(inc)
            return pgid
        if cmd == "osd rm-pg-upmap-items":
            inc = Incremental(epoch=0)
            inc.removed_pg_upmap_items.append(args["pgid"])
            await self.propose(inc)
            return args["pgid"]
        if cmd == "osd balancer run":
            from ..mgr.balancer import balance
            res = balance(self.osdmap, max_moves=int(args.get("max", 10)))
            plans = res["plans"]
            if plans:
                from ..mgr.balancer import compact_items
                inc = Incremental(epoch=0)
                for pgid, items in plans.items():
                    inc.new_pg_upmap_items[pgid] = compact_items(
                        self.osdmap.pg_upmap_items.get(pgid, []), items)
                await self.propose(inc)
            return {"moved": len(plans), "before": res["before"],
                    "after": res["after"]}
        if cmd == "osd dump":
            return self.osdmap.to_dict()
        if cmd == "osd tree":
            return self._cmd_osd_tree()
        if cmd == "status":
            n_up = sum(1 for o in self.osdmap.osds.values() if o.up)
            n_in = sum(1 for o in self.osdmap.osds.values() if o.in_cluster)
            health = self.services.health()
            return {"epoch": self.osdmap.epoch,
                    "num_osds": len(self.osdmap.osds),
                    "num_up": n_up, "num_in": n_in,
                    "pools": len(self.osdmap.pools),
                    "quorum": sorted(self.quorum),
                    "health": health["status"],
                    "checks": {k: v["summary"]
                               for k, v in health["checks"].items()}}
        raise ValueError(f"unknown command: {cmd}")

    async def _cmd_pool_create(self, args: dict):
        name = args["name"]
        if name in self.osdmap.pool_names:
            return self.osdmap.pool_names[name]
        pg_num = int(args.get("pg_num", 32))
        pool_id = max(self.osdmap.pools, default=0) + 1
        pool_type = args.get("type", "replicated")
        inc = Incremental(epoch=0)
        if pool_type == "erasure":
            profile_name = args.get("erasure_code_profile", "default")
            profile = self.osdmap.ec_profiles.get(profile_name)
            if profile is None:
                if profile_name != "default":
                    raise ValueError(f"no EC profile {profile_name}")
                profile = dict(DEFAULT_EC_PROFILE)
                inc.new_ec_profiles["default"] = profile
            # pool width comes from the PLUGIN, not k+m: layered codes
            # (lrc) add local parity chunks beyond k+m (the reference
            # sizes pools via the instantiated codec the same way,
            # OSDMonitor::get_erasure_code -> get_chunk_count)
            codec = ec_registry().factory(
                profile.get("plugin", "cuda"),
                {pk: pv for pk, pv in profile.items() if pk != "plugin"},
                device=self.device)
            if "stripe_unit" in profile:
                # pool creation is the last gate before the profile's
                # stripe geometry becomes I/O-visible
                from ..osd.ec_util import parse_stripe_unit
                parse_stripe_unit(codec, profile["stripe_unit"])
            width = codec.get_chunk_count()
            k = codec.get_data_chunk_count()
            spec = PoolSpec(pool_id=pool_id, name=name,
                            type=POOL_TYPE_ERASURE, size=width,
                            min_size=k + 1 if width - k > 1 else k,
                            pg_num=pg_num, pgp_num=pg_num, crush_rule=1,
                            erasure_code_profile=profile_name)
        else:
            spec = PoolSpec(pool_id=pool_id, name=name,
                            type=POOL_TYPE_REPLICATED,
                            size=int(args.get("size", 3)),
                            min_size=int(args.get("min_size", 2)),
                            pg_num=pg_num, pgp_num=pg_num, crush_rule=0)
        from dataclasses import asdict
        inc.new_pools[pool_id] = asdict(spec)
        await self.propose(inc)
        return pool_id

    async def _cmd_pool_rm(self, args: dict):
        name = args["name"]
        pid = self.osdmap.pool_names.get(name)
        if pid is None:
            raise ValueError(f"no pool {name}")
        inc = Incremental(epoch=0)
        inc.removed_pools.append(pid)
        await self.propose(inc)
        # pid is the id the command resolved and removed; returning
        # the captured value after the commit is the contract
        # lint: disable=await-invalidates-snapshot -- captured return value
        return pid

    def _cmd_osd_tree(self):
        tree = []
        hosts = defaultdict(list)
        for osd, info in self.osdmap.osds.items():
            if info.host:
                hosts[info.host].append(osd)
        for host in sorted(hosts):
            tree.append({"type": "host", "name": host})
            for osd in sorted(hosts[host]):
                info = self.osdmap.osds.get(osd)
                tree.append({"type": "osd", "id": osd,
                             "up": bool(info and info.up),
                             "in": bool(info and info.in_cluster),
                             "weight": info.weight if info else 0})
        return tree

    # -- ticking (down->out aging) -----------------------------------------
    async def _tick_loop(self) -> None:
        try:
            while True:
                # lease renewal must outpace lease expiry by a
                # comfortable margin (the reference renews at lease/2)
                await asyncio.sleep(min(0.5,
                                        self.config["mon_lease"] / 3))
                await self._tick()
        except asyncio.CancelledError:
            pass

    async def _tick(self) -> None:
        now = time.monotonic()
        # -- election/lease upkeep ------------------------------------------
        if self._n_mons() > 1:
            if self.leader is None:
                if now > getattr(self, "_defer_until", 0.0):
                    self.start_election()
            elif self.is_leader:
                # renew the lease; two consecutive sub-majority rounds
                # mean we lost the quorum: step down and re-elect
                if len(self._lease_acks | {self.rank}) < self._majority() \
                        and self._lease_round > 0:
                    self._lease_misses += 1
                    if self._lease_misses >= 2:
                        self.leader = None
                        self._lease_misses = 0
                        self.start_election()
                else:
                    self._lease_misses = 0
                self._lease_acks = set()
                self._lease_round = getattr(self, "_lease_round", 0) + 1
                for r in sorted(self.quorum - {self.rank}):
                    await self._send_mon(r, Message(
                        "mon_lease", {"epoch": self.election_epoch}))
            else:
                if now > self._lease_expire:
                    # leader went quiet: elect
                    self.leader = None
                    self.start_election()
        interval = self.config["mon_osd_down_out_interval"]
        to_out = [osd for osd, t in self._down_since.items()
                  if now - t > interval
                  and self.osdmap.osds.get(osd)
                  and self.osdmap.osds[osd].in_cluster
                  and not self.osdmap.osds[osd].up]
        if to_out and self.is_leader:
            inc = Incremental(epoch=0)
            inc.new_out.extend(to_out)
            for osd in to_out:
                self._down_since.pop(osd, None)
            await self.propose(inc)
        # MgrMonitor: a lapsed active mgr is deposed and a standby
        # promoted (mgr failover)
        if self.is_leader:
            m = self.services.mgrmap
            beats = getattr(self, "mgr_last_beacon", None)
            if beats is None:
                beats = self.mgr_last_beacon = {}
            act = m.get("active")
            if act and act not in beats:
                # a NEW leader has no beat record for the active: start
                # the grace clock now instead of resetting it each tick
                # (else a dead active is never deposed after a mon
                # leadership change)
                beats[act] = now
            if act and now - beats[act] > self.MGR_BEACON_GRACE:
                nm = dict(m)
                nm["epoch"] += 1
                stand = nm.get("standbys", [])
                if stand:
                    nxt = stand[0]
                    nm.update({"active": nxt["name"],
                               "active_addr": nxt["addr"],
                               "standbys": stand[1:]})
                else:
                    nm.update({"active": None, "active_addr": None})
                await self.propose_service_kv(
                    "mgrmap", {"map": json.dumps(nm)})
                await self._publish_mgr_map()
        # expired blocklist entries leave the map (OSDMonitor::tick
        # does the same sweep); without it every fence ever made rides
        # in every full map forever
        if self.is_leader:
            expired = [iid for iid, exp in self.osdmap.blocklist.items()
                       if exp <= time.time()]
            if expired:
                inc = Incremental(epoch=0)
                inc.old_blocklist.extend(expired)
                await self.propose(inc)
