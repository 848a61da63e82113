"""OSD daemon: boot, map handling, heartbeats, op dispatch, PG hosting.

Mirrors the src/osd/OSD.cc skeleton: boot to the monitor, subscribe to
OSDMap deltas, a ping mesh with failure reports past a grace period
(handle_osd_ping :5767, heartbeat_check :6138), fast dispatch of client
ops into per-PG execution (ms_fast_dispatch :7550 -> dequeue_op :9793),
and dmClock admission for client vs recovery work.

Port of ``ceph_tpu/osd/osd.py``.  An OSD runs on one device
(``device``, CUDA unless the caller names the CPU; resolved at
construction, so a daemon without a card raises instead of carrying on
on the CPU).  It reaches the device through its epoch placement table
(the ``OSDMap``'s, K5 on the card), its ``CodecBatcher`` (one
``MeshCodec`` launch a batch: K2 and K4), its ``DeviceShardCache`` and
the EC codec of every PG it hosts.  Its map-change sweep visits only
the PGs of ``PGMapping.delta``.  Every daemon of a process launches on
the default stream of its device.
"""

from __future__ import annotations

import asyncio
import itertools
import time
import uuid as uuid_mod

from ..common import AdminSocket, ConfigProxy, PerfCountersCollection, \
    make_task_tracker
from ..device import resolve_device
from ..mon.osdmap import OSDMap, Incremental
from ..msg import Message, Messenger
from ..os.store import MemStore, make_default_store
from .pg import PG, WRITE_OPS
from .scheduler import MClockScheduler, OpClass


class OSD:
    def __init__(self, uuid: str | None = None, whoami: int | None = None,
                 store=None, host: str = "host0",
                 secret: bytes | None = None,
                 config: dict | None = None,
                 admin_socket_path: str | None = None,
                 msgr_opts: dict | None = None,
                 cephx_key: str | None = None,
                 require_ticket: bool = False,
                 fault_injector=None, device=None) -> None:
        # the device every map, codec, batcher and cache of this daemon
        # runs on: CUDA unless the caller names the CPU
        self.device = resolve_device(device)
        self.msgr_opts = msgr_opts
        # deterministic chaos (common/faults.py MessageFaultInjector):
        # threaded into the messenger at start(); its firings surface
        # in the "fault_inject" perf counter set.  None in production.
        self.faults = fault_injector
        # cephx: this OSD's entity key (hex).  When set, boot fetches
        # the rotating "osd" service keys (to VALIDATE tickets peers
        # present) and its own ticket (to PRESENT on osd->osd
        # connections); require_ticket makes the messenger NACK
        # ticketless peers (src/auth/cephx/CephxProtocol.h)
        self.cephx_key = cephx_key
        self.require_ticket = require_ticket
        self._rk_holder: dict | None = None
        self.host = host
        self.store = store or make_default_store()
        # identity lives in the store (OSD superblock analog,
        # OSD::read_superblock): a daemon restarted on a durable store
        # must reclaim its osd id (the mon resolves uuid->id), not
        # register as a fresh OSD and orphan its own data
        sb = self._read_superblock()
        self.uuid = uuid or sb.get("uuid") or uuid_mod.uuid4().hex
        if whoami is not None:
            self.whoami = whoami
        elif self.uuid == sb.get("uuid"):
            # the stored id belongs to the stored uuid: reclaiming it
            # under a DIFFERENT uuid would evict whatever daemon
            # legitimately owns that id in the map
            self.whoami = int(sb.get("whoami", -1))
        else:
            self.whoami = -1
        if not sb:
            self._write_superblock()
        self.config = {
            "osd_heartbeat_interval": 0.5,
            "osd_heartbeat_grace": 3.0,
            "osd_max_backfills": 2,
            **(config or {}),
        }
        # pre-override snapshot: central-config removals revert to this
        self._base_config = dict(self.config)
        self._pushed_config: set[str] = set()
        # in-flight client payload byte cap (Throttle backpressure,
        # osd_client_message_size_cap = 500 MiB in the reference)
        from ..common.throttle import Throttle
        self.client_throttle = Throttle(
            "osd_client_bytes",
            int(self.config.get("osd_client_message_size_cap",
                                500 << 20)))
        # typed registry over the same values: admin-socket `config set`
        # flows through the schema validation and back into the dict the
        # hot paths read (ConfigProxy observer pattern)
        from ..common.config import DEFAULT_SCHEMA
        known = {o.name for o in DEFAULT_SCHEMA}
        self.conf = ConfigProxy(values={
            k: v for k, v in self.config.items() if k in known})
        for name in known:
            self.conf.add_observer(
                name, lambda k, v: self.config.__setitem__(k, v))
        self.secret = secret
        self.msgr: Messenger | None = None
        self.mon_addr: tuple[str, int] | None = None
        self.monmap: list[list] = []
        self.osdmap = OSDMap(device=self.device, shared_tables=True)
        self.pgs: dict[str, PG] = {}
        # backfill reservation slots (AsyncReserver.h / osd_max_backfills):
        # local = backfills this OSD primaries, remote = backfills
        # targeting this OSD
        from ..common.reserver import AsyncReserver
        self.local_reserver = AsyncReserver(
            int(self.config["osd_max_backfills"]))
        self.remote_reserver = AsyncReserver(
            int(self.config["osd_max_backfills"]))
        # scrub slots (osd_max_scrubs; separate from backfill so a
        # recovering cluster can still scrub and vice versa)
        self.scrub_reserver = AsyncReserver(
            int(self.config.get("osd_max_scrubs", 1)))
        self._scrub_stamps: dict[str, float] = {}
        self._scrubbing: set[str] = set()
        self._sched_event = asyncio.Event()
        self._tid = itertools.count(1)
        self._waiters: dict[int, asyncio.Future] = {}
        self._hb_last: dict[int, float] = {}
        # the heartbeat peers of the last tick (``_heartbeat_once``)
        self._hb_peers: set[int] = set()
        self._tasks: list[asyncio.Task] = []
        self._stopped = False
        self._track = make_task_tracker(self._tasks)
        self._rebooting = False
        # observability (src/common/perf_counters + TrackedOp analog)
        self.perf = PerfCountersCollection()
        self.perf_osd = self.perf.create("osd")
        # dmClock admission with its own perf set: per-class queue
        # depth gauges + dispatch counters, so a load harness can
        # report client-vs-recovery QoS behavior instead of inferring
        # it from latency alone
        self.sched = MClockScheduler(perf=self.perf.create("scheduler"))
        # the traffic harness's process-wide workload counters (ops and
        # bytes the client swarm pushed); adopting them means a plain
        # `perf dump` shows offered load next to what the daemon did
        from ..loadgen.stats import PERF as _workload_perf
        self.perf.adopt(_workload_perf)
        # the map owns the placement-cache counters (they live and die
        # with it); adopt them so `perf dump` includes the set.  A
        # full-map ingest re-adopts the fresh map's instance.
        self.perf.adopt(self.osdmap.placement_perf)
        # the integrity pipeline's counters are process-wide (every
        # CRC path -- codec batcher, scrub, blockstore, native scalar
        # fallback -- reports to one set); adopt so `perf dump` shows
        # batched vs scalar call mix
        from ..ops.crc32c_batch import PERF as _integrity_perf
        self.perf.adopt(_integrity_perf)
        # write-pipeline observability ("ec_pipeline" perf set): the
        # double-buffered batcher (staged_batches, overlap windows,
        # stage stalls), the deferred commit path (commit_overlap_ms)
        # and the per-peer sub-op coalescer (coalesced_subops,
        # flush_windows) all report here.  Pipeline knobs are SNAPSHOT
        # at construction -- the kill switch osd_pipeline_enabled=false
        # restores the serial chain end to end.
        self.perf_pipeline = self.perf.create("ec_pipeline")
        for key in ("staged_batches", "inflight_overlap_windows",
                    "stage_stalls", "overlapped_commits",
                    "commit_overlap_ms", "coalesced_subops",
                    "flush_windows"):
            self.perf_pipeline.inc(key, 0)    # visible even when idle
        self.pipeline_enabled = bool(
            self.config.get("osd_pipeline_enabled", True))
        self._pipeline_flush_window = float(
            self.config.get("osd_pipeline_flush_window", 0.002))
        self.subop_pipe = None       # built in start() (needs msgr)
        # cross-PG EC codec aggregation stage: every ECBackend on this
        # OSD funnels encode/decode work through ONE batcher so
        # concurrent ops share accelerator launches
        # (ceph_tpu/osd/codec_batcher.py)
        # every knob (batching AND the sharded-mesh data plane) is
        # snapshot here, once: the launch loop never reads config
        from .codec_batcher import CodecBatcher
        self.codec_batcher = CodecBatcher.from_config(
            self.config, perf=self.perf.create("ec_batch"),
            pipe_perf=self.perf_pipeline, device=self.device)
        # device-resident shard cache (os/device_cache.py): hot shard
        # buffers stay resident across encode -> commit -> read-verify
        # -> scrub -> decode instead of round-tripping the store.
        # Attached to the store UNCONDITIONALLY (None detaches): the
        # store boundary invalidates on every mutating txn, and a
        # revived OSD re-attaching a fresh (empty) cache is what makes
        # kill/revive incapable of serving stale resident bytes.
        from ..os.device_cache import DeviceShardCache
        from ..os.device_cache import PERF as _datapath_perf
        self.shard_cache = DeviceShardCache.from_config(
            self.config, device=self.device)
        self.store.attach_shard_cache(self.shard_cache)
        self.perf.adopt(_datapath_perf)
        # straggler-tolerant hedged gathers (osd/hedged_gather.py):
        # ONE engine + per-peer latency EWMA per daemon -- every
        # ECBackend, scrub collection and recovery pull on this OSD
        # shares the tracker (a peer's history is a daemon-level fact)
        # and the "ec_hedge" perf set.  All osd_ec_hedge_* knobs are
        # snapshot here, once.
        from .hedged_gather import HedgedGather, PeerLatencyEWMA
        self.peer_latency = PeerLatencyEWMA.from_config(self.config)
        self.hedger = HedgedGather.from_config(
            self, self.config, perf=self.perf.create("ec_hedge"),
            tracker=self.peer_latency)
        self._notify_serial = itertools.count(1)
        self._notify_waiters: dict[str, asyncio.Future] = {}
        # TrackedOp/OpTracker (src/common/TrackedOp.h): in-flight op
        # introspection + historic retention + slow-op complaints
        from ..common.optracker import OpTracker
        self.op_tracker = OpTracker(
            complaint_time=float(self.config.get(
                "osd_op_complaint_time", 30.0)))
        self.admin_socket: AdminSocket | None = None
        self._admin_socket_path = admin_socket_path

    # -- lifecycle ----------------------------------------------------------
    # -- superblock (identity persisted with the data) ----------------------
    _SB_COLL = "osd_superblock"
    _SB_OID = "superblock"

    def _read_superblock(self) -> dict:
        if not self.store.collection_exists(self._SB_COLL):
            return {}
        omap = self.store.omap_get(self._SB_COLL, self._SB_OID)
        return {k: v.decode() for k, v in omap.items()}

    def _write_superblock(self) -> None:
        from ..os.transaction import Transaction
        txn = Transaction()
        if not self.store.collection_exists(self._SB_COLL):
            txn.create_collection(self._SB_COLL)
            txn.touch(self._SB_COLL, self._SB_OID)
        txn.omap_setkeys(self._SB_COLL, self._SB_OID, {
            "uuid": self.uuid.encode(),
            "whoami": str(self.whoami).encode()})
        self.store.queue_transaction(txn)

    async def start(self, mon_addr: tuple[str, int],
                    host: str = "127.0.0.1", port: int = 0) -> int:
        self.mon_addr = tuple(mon_addr)
        self.store.mount()
        name = f"osd.{self.whoami}" if self.whoami >= 0 else \
            f"osd-boot-{self.uuid[:8]}"
        if self.faults is not None and self.faults.perf is None:
            self.faults.perf = self.perf.create("fault_inject")
        self.msgr = Messenger(name, secret=self.secret,
                              faults=self.faults,
                              **(self.msgr_opts or {}))
        self.msgr.add_dispatcher(self._dispatch)
        self.msgr.fast_dispatch = self.fast_dispatch
        if self.pipeline_enabled:
            # per-peer sub-op coalescing (msg/messenger.py SubOpPipe):
            # concurrent ops' sub-writes to one peer share a framed
            # flush per window instead of one send per shard
            from ..msg.messenger import SubOpPipe
            self.subop_pipe = SubOpPipe(
                self.msgr,
                flush_window=self._pipeline_flush_window,
                perf=self.perf_pipeline)
        addr = await self.msgr.bind(host, port)
        ack = await self._mon_request(
            "osd_boot", {"uuid": self.uuid, "host": self.host,
                         "addr": list(addr),
                         "osd_id": self.whoami if self.whoami >= 0
                         else None},
            reply_type="osd_boot_ack")
        self.whoami = ack["osd_id"]
        self._write_superblock()
        self.monmap = [list(a) for a in ack.get("monmap", [])] or \
            [list(self.mon_addr)]
        self.msgr.name = f"osd.{self.whoami}"
        if self.cephx_key:
            await self._cephx_boot()
        # subscribe to map deltas; mon replies with the full map
        full = await self._mon_request("sub_osdmap", {},
                                       reply_type="osdmap_full")
        self._apply_full_map(full["map"])
        # extend, never reassign: anything registered into _tasks before
        # this point would lose its only strong reference and get
        # garbage-collected mid-await
        self._tasks += [
            asyncio.ensure_future(self._heartbeat_loop()),
            asyncio.ensure_future(self._sched_loop()),
        ]
        if self._admin_socket_path:
            self.admin_socket = AdminSocket(self._admin_socket_path)
            self._register_admin_commands()
            await self.admin_socket.start()
        return self.whoami

    def _register_admin_commands(self) -> None:
        sock = self.admin_socket

        async def perf_dump(req):
            return self.perf.dump()

        async def scrub_cmd(req):
            pgid = req.get("pgid")
            if not pgid or pgid not in self.pgs:
                return {"err": f"no such pg {pgid!r}"}
            pg = self.pgs[pgid]
            if not pg.is_primary():
                return {"err": f"osd.{self.whoami} is not primary "
                               f"for {pgid}"}
            if pgid in self._scrubbing:
                return {"err": f"pg {pgid} already scrubbing"}
            # operator scrubs obey the same slot budget as scheduled
            # ones -- osd_max_scrubs must bound BOTH
            self._scrubbing.add(pgid)
            try:
                await self.scrub_reserver.request(pgid, timeout=30)
                # the slot wait suspended: the PG may have been
                # replaced or re-targeted by an epoch change -- scrub
                # the current object, not the pre-wait snapshot
                pg = self.pgs.get(pgid)
                if pg is None or not pg.is_primary():
                    return {"err": f"pg {pgid} moved while waiting "
                                   f"for a scrub slot"}
                from .scrub import scrub_pg
                res = await scrub_pg(pg,
                                     repair=bool(req.get("repair")))
                self._scrub_stamps[pgid] = time.monotonic()
                return res.to_dict()
            except asyncio.TimeoutError:
                return {"err": "scrub slots busy; try again"}
            finally:
                self.scrub_reserver.release(pgid)
                self._scrubbing.discard(pgid)

        async def status(req):
            return {"whoami": self.whoami, "epoch": self.osdmap.epoch,
                    "num_pgs": len(self.pgs),
                    "pg_states": {pgid: pg.state
                                  for pgid, pg in self.pgs.items()}}

        async def ops_in_flight(req):
            return self.op_tracker.dump_ops_in_flight()

        async def historic_ops(req):
            return self.op_tracker.dump_historic_ops()

        async def historic_ops_by_duration(req):
            return self.op_tracker.dump_historic_ops_by_duration()

        async def config_show(req):
            return self.conf.show()

        async def config_get(req):
            return self.conf.describe(req["name"])

        async def config_set(req):
            self.conf.set(req["name"], req["value"])
            return {req["name"]: self.conf.get(req["name"])}

        sock.register("perf dump", "dump perf counters", perf_dump)
        sock.register("status", "osd status", status)
        sock.register("dump_ops_in_flight", "in-flight client ops",
                      ops_in_flight)
        sock.register("dump_historic_ops", "recently completed ops",
                      historic_ops)
        sock.register("dump_historic_ops_by_duration",
                      "slowest completed ops",
                      historic_ops_by_duration)
        async def dump_tracing(req):
            from ..common.tracing import get_tracer
            return get_tracer(f"osd.{self.whoami}").dump(
                (req or {}).get("trace_id"))

        sock.register("dump_tracing",
                      "finished trace spans (optionally one trace_id)",
                      dump_tracing)
        sock.register("config show", "all config values", config_show)
        sock.register("scrub", "scrub a pg: {pgid, repair}", scrub_cmd)
        sock.register("config get", "describe one option", config_get)
        sock.register("config set", "set option (name=..., value=...)",
                      config_set)

    async def stop(self) -> None:
        self._stopped = True
        if self.codec_batcher is not None:
            self.codec_batcher.close()
        if self.subop_pipe is not None:
            # ship staged sub-ops before the messenger dies: a parked
            # flush would wedge every op awaiting its replies
            await self.subop_pipe.close()
            self.subop_pipe = None
        if self.admin_socket is not None:
            await self.admin_socket.stop()
        for t in list(self._tasks):
            t.cancel()
        for pg in self.pgs.values():
            if pg._recovery_task:
                pg._recovery_task.cancel()
            if pg._peering_task:
                pg._peering_task.cancel()
            if pg._snap_trim_task:
                pg._snap_trim_task.cancel()
        if self.msgr:
            await self.msgr.shutdown()
        self.store.umount()

    # -- public accessors (the in-process daemon boundary) ------------------
    # Harness/bench code must not reach into the OSD's private state
    # (cross-daemon-state rule): these expose the few facts the
    # kill/revive/wait helpers need as plain data.

    def is_stopped(self) -> bool:
        return self._stopped

    def revive_token(self) -> dict:
        """Everything a revive needs to rebuild this OSD in place.
        The store object rides along because an in-process revive
        re-mounts the same backend; a multiprocess revive would carry
        its path instead."""
        return {"uuid": self.uuid, "whoami": self.whoami,
                "store": self.store, "host": self.host,
                "config": dict(self._base_config), "device": self.device}

    def inflight_ops(self) -> int:
        """Client ops awaiting replies on this OSD right now."""
        return len(self._waiters)

    def has_pending_recovery(self) -> bool:
        """True while any primary PG here is degraded or still owes
        recovery work (the wait_clean predicate)."""
        for pg in self.pgs.values():
            if not pg.is_primary():
                continue
            if pg.state != "active" or pg._recovery_pending():
                return True
        return False

    def primary_pg_states(self) -> dict[str, int]:
        """State -> count over the PGs this OSD leads."""
        states: dict[str, int] = {}
        for pg in self.pgs.values():
            if pg.is_primary():
                states[pg.state] = states.get(pg.state, 0) + 1
        return states

    async def _mon_request(self, mtype: str, data: dict,
                           reply_type: str, timeout: float = 10) -> dict:
        """Mon RPC with monmap failover: a dead mon rotates the request
        to the next one (the MonClient hunting behavior).  Peons either
        answer (map reads) or forward to the leader."""
        q: asyncio.Queue = asyncio.Queue()

        async def d(conn, msg):
            if msg.type == reply_type:
                await q.put(msg.data)

        targets = self._mon_targets()
        per_try = max(2.0, timeout / max(1, len(targets)))
        self.msgr.add_dispatcher(d)
        try:
            last_err: Exception | None = None
            for addr, rank in targets:
                try:
                    await self.msgr.send(addr, f"mon.{rank}",
                                         Message(mtype, data))
                    reply = await asyncio.wait_for(q.get(), per_try)
                    self.mon_addr = addr        # stick with a live mon
                    return reply
                except (ConnectionError, OSError,
                        asyncio.TimeoutError) as e:
                    last_err = e
            raise last_err or asyncio.TimeoutError(mtype)
        finally:
            self.msgr.dispatchers.remove(d)

    def _mon_targets(self) -> list[tuple[tuple[str, int], int]]:
        """(addr, rank) hunting order: the current mon first, then the
        rest of the monmap."""
        mons = [tuple(a) for a in (self.monmap or [self.mon_addr])]
        if tuple(self.mon_addr) in mons:
            i0 = mons.index(tuple(self.mon_addr))
            mons = mons[i0:] + mons[:i0]
        return [(addr,
                 self.monmap.index(list(addr))
                 if self.monmap and list(addr) in self.monmap else 0)
                for addr in mons]

    async def _mon_send_failover(self, msg: Message) -> None:
        """Fire-and-forget to the mon cluster: a dead mon rotates the
        send to the next monmap entry (and re-homes mon_addr)."""
        for addr, rank in self._mon_targets():
            try:
                await asyncio.wait_for(
                    self.msgr.send(addr, f"mon.{rank}", msg), 2.0)
                self.mon_addr = addr
                return
            except (ConnectionError, OSError, asyncio.TimeoutError):
                continue

    # -- map handling -------------------------------------------------------
    def _apply_full_map(self, map_dict: dict) -> None:
        # steady-state dedupe: epochs are monotonic per change, so a
        # full map at an epoch we already hold is byte-for-byte the
        # map we have -- re-ingesting it would rebuild the placement
        # cache and sweep every PG for nothing.  The heartbeat's
        # map-freshness probe refetches the full map every few quiet
        # seconds per OSD; before this guard that re-ingest was the
        # single largest steady-state CPU line in the cluster bench
        # (the op loop starved under its own liveness probes).
        if int(map_dict.get("epoch", 0)) <= self.osdmap.epoch \
                and self.osdmap.epoch > 0:
            self._last_map_time = time.monotonic()
            return
        # capture the outgoing table: delta() against it lets the new
        # map touch only the PGs that actually moved
        prev = self.osdmap.peek_placement_cache()
        old_perf = self.osdmap._placement_perf
        self.osdmap = OSDMap.from_dict(map_dict, device=self.device,
                                         shared_tables=True)
        if old_perf is not None:
            # counters are per-daemon, not per-map-object: a full-map
            # ingest must not zero the recompute/delta history
            self.osdmap._placement_perf = old_perf
        self.perf.adopt(self.osdmap.placement_perf)
        self._last_map_time = time.monotonic()
        # full-map ingest rebuilds EVERY PoolSpec object, so hosted
        # PGs must rebind their pool regardless of placement deltas
        self._on_map_change(prev_cache=prev, rebuilt_pools=None)

    def _apply_incremental(self, inc_dict: dict) -> None:
        inc = Incremental.from_dict(inc_dict)
        self._last_map_time = time.monotonic()
        if inc.epoch <= self.osdmap.epoch:
            return          # duplicate delivery (multi-mon subscriptions)
        if inc.epoch != self.osdmap.epoch + 1:
            self._track(asyncio.ensure_future(self._catch_up_maps()))
            return
        prev = self.osdmap.peek_placement_cache()
        self.osdmap.apply_incremental(inc)
        self._on_map_change(prev_cache=prev,
                            rebuilt_pools=set(inc.new_pools))

    async def _catch_up_maps(self) -> None:
        try:
            full = await self._mon_request("sub_osdmap", {},
                                           reply_type="osdmap_full")
            self._apply_full_map(full["map"])
        except (asyncio.TimeoutError, ConnectionError, OSError):
            pass

    def _on_map_change(self, prev_cache=None,
                       rebuilt_pools: set[int] | None = None) -> None:
        """Instantiate/retarget PGs after an epoch change.

        With the previous epoch's placement table in hand the sweep is
        delta-driven: only PGs whose up/acting actually moved are
        visited (PGMapping.delta), so an epoch that merely bumps
        up_thru or fences a client touches nothing.  Without one (boot,
        gap catch-up) it walks the whole cached table once.

        ``rebuilt_pools`` names pools whose PoolSpec objects were
        REPLACED by this map (inc.new_pools); None means all of them
        (full-map ingest) -- hosted PGs rebind to the live object so
        snap state et al keep flowing (the old full-sweep did this as
        a side effect of visiting every PG)."""
        t0 = time.monotonic()
        epoch = self.osdmap.epoch
        cache = self.osdmap.placement_cache()
        if rebuilt_pools is None or rebuilt_pools:
            for pgid, pg in self.pgs.items():
                pool_id = int(pgid.split(".")[0])
                if rebuilt_pools is not None \
                        and pool_id not in rebuilt_pools:
                    continue
                live = self.osdmap.pools.get(pool_id)
                if live is not None:
                    pg.pool = live
        if prev_cache is not None:
            todo = cache.delta(prev_cache,
                               perf=self.osdmap.placement_perf)
        else:
            todo = [(pool_id, pg_no) for pool_id, pg_no, _, _
                    in cache.iter_all()]
        profiles: dict[int, dict | None] = {}
        for pool_id, pg_no in todo:
            pool = self.osdmap.pools.get(pool_id)
            if pool is None or pg_no >= pool.pg_num:
                continue        # deleted pool / shrunk range: dropped below
            if pool_id not in profiles:
                profiles[pool_id] = (self.osdmap.ec_profiles.get(
                    pool.erasure_code_profile)
                    if pool.is_erasure() else None)
            up, acting = cache.lookup(pool_id, pg_no)
            pgid = f"{pool_id}.{pg_no:x}"
            involved = self.whoami in up or self.whoami in acting
            pg = self.pgs.get(pgid)
            if pg is None:
                if not involved:
                    continue
                pg = PG(self, pgid, pool, profiles[pool_id])
                self.pgs[pgid] = pg
            # a full-map catch-up builds NEW PoolSpec objects: the
            # pg must track the live one (removed_snaps et al)
            pg.pool = pool
            changed = pg.update_mapping(up, acting, epoch)
            if changed and pg.is_primary():
                pg.kick_peering()
        # drop PGs for deleted pools
        live_pools = set(self.osdmap.pools)
        for pgid in list(self.pgs):
            pool_id = int(pgid.split(".")[0])
            if pool_id not in live_pools:
                self.pgs.pop(pgid)
        # restart the failure-detection clock for peers currently down
        # so a re-booted OSD is not instantly re-reported from a stale
        # last-heard timestamp
        for osd, info in self.osdmap.osds.items():
            if not info.up:
                self._hb_last.pop(osd, None)
        # a long synchronous map change stalls OUR event loop; peers
        # were not silent, we were deaf — credit the stall to the
        # failure-detection clocks
        stall = time.monotonic() - t0
        if stall > 0.05:
            for osd in self._hb_last:
                self._hb_last[osd] += stall
        # falsely marked down (we are clearly alive): re-assert with a
        # fresh boot, as the reference OSD does on seeing itself down
        # in a new map
        me = self.osdmap.osds.get(self.whoami)
        if (me is not None and not me.up and not self._stopped
                and not self._rebooting):
            self._rebooting = True
            self._track(asyncio.ensure_future(self._reboot()))

    async def _reboot(self) -> None:
        try:
            await asyncio.sleep(0.2)     # let the down epoch settle
            await self._mon_request(
                "osd_boot", {"uuid": self.uuid, "host": self.host,
                             "addr": list(self.msgr.addr),
                             "osd_id": self.whoami},
                reply_type="osd_boot_ack")
        except (asyncio.TimeoutError, ConnectionError, OSError):
            pass
        finally:
            self._rebooting = False

    def _get_pg(self, pgid: str) -> PG | None:
        pg = self.pgs.get(pgid)
        if pg is not None:
            return pg
        # a peer knows about a PG we have not instantiated yet (e.g. a
        # query raced our map delivery): create it if the pool exists
        try:
            pool_id = int(pgid.split(".")[0])
        except ValueError:
            return None
        pool = self.osdmap.pools.get(pool_id)
        if pool is None:
            return None
        profile = self.osdmap.ec_profiles.get(
            pool.erasure_code_profile) if pool.is_erasure() else None
        pg = PG(self, pgid, pool, profile)
        ps = int(pgid.split(".")[1], 16)
        up, acting = self.osdmap.pg_to_up_acting(pool_id, ps)
        pg.update_mapping(up, acting, self.osdmap.epoch)
        self.pgs[pgid] = pg
        return pg

    def osd_is_up(self, osd: int) -> bool:
        return osd == self.whoami or self.osdmap.is_up(osd)

    async def ensure_up_thru(self, min_epoch: int,
                             timeout: float = 30.0) -> bool:
        """Block until the osdmap records our up_thru >= min_epoch
        (PeeringState WaitUpThru: the primary may not activate a new
        interval before the map proves the interval went live, or a
        later peering could prune it as never-active and lose writes).

        All waiting PGs share ONE MOSDAlive sender (the reference
        sends one alive per map epoch per OSD, not per PG): the task
        asks for the max wanted epoch and every waiter just watches
        the subscribed map."""
        self._alive_want = max(getattr(self, "_alive_want", 0),
                               min_epoch)
        if (getattr(self, "_alive_task", None) is None
                or self._alive_task.done()):
            self._alive_task = asyncio.ensure_future(self._alive_loop())
            self._track(self._alive_task)
        deadline = asyncio.get_event_loop().time() + timeout
        while self.osdmap.get_up_thru(self.whoami) < min_epoch:
            if asyncio.get_event_loop().time() > deadline:
                return False
            await asyncio.sleep(0.05)
        return True

    async def _alive_loop(self) -> None:
        """Single in-flight MOSDAlive per OSD, re-sent every 2s until
        the map catches up to the largest wanted epoch."""
        while self.osdmap.get_up_thru(self.whoami) < self._alive_want:
            try:
                await self._mon_request(
                    "osd_alive",
                    {"osd_id": self.whoami,
                     "want_up_thru": self._alive_want},
                    reply_type="osd_alive_reply", timeout=5)
                # the reply races the map incremental; fetch once
                await self._catch_up_maps()
            except (asyncio.TimeoutError, ConnectionError, OSError):
                pass
            if self.osdmap.get_up_thru(self.whoami) >= self._alive_want:
                return
            await asyncio.sleep(2.0)

    def request_pg_temp(self, pgid: str, osds: list[int]) -> None:
        """Fire-and-forget MOSDPGTemp to the mon (an empty list clears
        the override); the map change comes back as an incremental."""
        async def _send():
            try:
                await self._mon_request(
                    "osd_pg_temp", {"pgid": pgid, "osds": osds},
                    reply_type="osd_pg_temp_reply", timeout=10)
            except (asyncio.TimeoutError, ConnectionError, OSError):
                pass                 # re-requested on the next peering
        self._track(asyncio.ensure_future(_send()))

    # -- peer RPC -----------------------------------------------------------
    def _peer_addr(self, osd: int) -> tuple[str, int]:
        info = self.osdmap.osds.get(osd)
        if info is None or info.addr is None:
            raise ConnectionError(f"no address for osd.{osd}")
        return tuple(info.addr)

    def start_request(self, osd: int, mtype: str, data: dict,
                      segments=()) -> tuple[int, asyncio.Task]:
        """Issue ONE peer request; the returned task resolves to the
        reply Message (matched by tid, like fanout_and_wait) or raises
        ConnectionError on a send failure.

        The caller OWNS the task: awaiting, cancelling and reaping it
        are its job (HedgedGather is the owning engine on the read
        spine).  Cancellation pops the tid waiter in the task's
        finally, so a straggler's late reply is dropped at the
        dispatch layer instead of crosstalking into a later op that
        happens to reuse the wire."""
        tid = next(self._tid)
        fut = asyncio.get_event_loop().create_future()
        self._waiters[tid] = fut
        d = dict(data)
        d["tid"] = tid

        async def _issue():
            try:
                try:
                    await self.msgr.send(
                        self._peer_addr(osd), f"osd.{osd}",
                        Message(mtype, d, segments=list(segments)))
                except (ConnectionError, OSError) as e:
                    if not fut.done():
                        fut.set_exception(ConnectionError(str(e)))
                return await fut
            finally:
                self._waiters.pop(tid, None)
                # a cancel landing between the send failure and the
                # await leaves the failure un-consumed: mark it
                # retrieved (or park the waiter) so nothing warns at GC
                if fut.done() and not fut.cancelled():
                    fut.exception()
                else:
                    fut.cancel()

        return tid, asyncio.ensure_future(_issue())

    async def fanout_and_wait(self, requests, collect: bool = False,
                              timeout: float = 10):
        """Send (osd, type, data, segments) requests; await all replies.

        Replies are matched by tid (every handler echoes it).  Raises
        TimeoutError if any peer fails to respond — callers treat that
        as a failed sub-op (the op layer above re-peers on map change).
        """
        futs = []
        for osd, mtype, data, segments in requests:
            tid = next(self._tid)
            fut = asyncio.get_event_loop().create_future()
            self._waiters[tid] = fut
            futs.append((tid, fut))
            d = dict(data)
            d["tid"] = tid
            try:
                await self.msgr.send(
                    self._peer_addr(osd), f"osd.{osd}",
                    Message(mtype, d, segments=list(segments)))
            except (ConnectionError, OSError) as e:
                if not fut.done():
                    fut.set_exception(ConnectionError(str(e)))
        return await self.await_staged(futs, collect=collect,
                                       timeout=timeout)

    def fanout_staged(self, requests) -> list:
        """Stage (osd, type, data, segments) sub-op sends through the
        per-peer coalescing pipe and return the (tid, future) reply
        waiters for ``await_staged``.

        Staging is SYNCHRONOUS (no await between requests): staging
        order is the per-peer wire order, which is what keeps replica
        logs applied in version order when commits overlap.  The
        caller owns the reply futures -- a bare call orphans them
        (the dropped-task lint roots this entry point)."""
        pipe = self.subop_pipe
        futs = []
        for osd, mtype, data, segments in requests:
            tid = next(self._tid)
            fut = asyncio.get_event_loop().create_future()
            self._waiters[tid] = fut
            futs.append((tid, fut))
            d = dict(data)
            d["tid"] = tid

            def on_error(e, fut=fut):
                if not fut.done():
                    fut.set_exception(ConnectionError(str(e)))

            try:
                pipe.stage(self._peer_addr(osd), f"osd.{osd}",
                           Message(mtype, d, segments=list(segments)),
                           on_error=on_error)
            except (ConnectionError, OSError) as e:
                on_error(e)
        return futs

    async def await_staged(self, futs, collect: bool = False,
                           timeout: float = 10):
        """Await the (tid, future) reply waiters of a staged fan-out
        (shared wait tail of fanout_and_wait)."""
        try:
            if futs:
                done, pending = await asyncio.wait(
                    [f for _, f in futs], timeout=timeout)
            else:
                done, pending = set(), set()
        finally:
            for tid, _ in futs:
                self._waiters.pop(tid, None)
        replies, errors = [], []
        for f in done:
            if f.exception() is not None:
                errors.append(f.exception())
            else:
                replies.append(f.result())
        for f in pending:
            f.cancel()
        if collect:
            return replies      # partial results are fine (down peers)
        if errors:
            raise errors[0]
        if pending:
            raise asyncio.TimeoutError(
                f"{len(pending)} sub-op replies outstanding")
        return replies

    def _resolve_tid(self, msg: Message) -> None:
        fut = self._waiters.pop(msg.data.get("tid"), None)
        if fut is not None and not fut.done():
            fut.set_result(msg)

    # reply types whose whole handler is the synchronous tid
    # resolution above: they take the messenger's fast-dispatch path
    # (no task per message) -- the bulk of sub-op traffic on the
    # pipelined write spine is exactly these
    _FAST_REPLIES = frozenset((
        "rep_op_reply", "ec_subop_write_reply", "ec_subop_read_reply",
        "pg_pull_reply", "pg_push_reply", "scrub_release_ack"))

    def fast_dispatch(self, conn, msg: Message) -> bool:
        """Synchronous fast path consulted by the messenger before
        spawning a dispatch task; True = consumed."""
        t = msg.type
        if t in self._FAST_REPLIES:
            self._resolve_tid(msg)
            return True
        if t == "osd_ping_reply":
            self._hb_last[msg.data["from_osd"]] = time.monotonic()
            return True
        return False

    # -- dmclock admission --------------------------------------------------
    async def admit(self, op_class: OpClass):
        fut = asyncio.get_event_loop().create_future()
        self.sched.enqueue(op_class, fut)
        self._sched_event.set()
        await fut

    async def _sched_loop(self) -> None:
        try:
            while True:
                await self._sched_event.wait()
                item = self.sched.dequeue()
                if item is None:
                    self._sched_event.clear()
                    continue
                _, fut = item
                if not fut.done():
                    fut.set_result(None)
                # yield so the admitted op actually starts
                await asyncio.sleep(0)
        except asyncio.CancelledError:
            pass

    # -- heartbeats ---------------------------------------------------------
    async def _heartbeat_loop(self) -> None:
        try:
            while True:
                interval = self.config["osd_heartbeat_interval"]
                t0 = time.monotonic()
                await asyncio.sleep(interval)
                # scheduling-lag credit: if OUR sleep woke late, the
                # event loop was starved -- and peers sharing it were
                # equally starved, not silent.  Crediting the clocks
                # keeps loop congestion (peering bursts, recovery
                # storms) from reading as peer death; false failure
                # reports during a real failure are how one kill
                # cascades into a cluster-wide peering storm (the
                # degraded-phase collapse the bench caught).
                # the lag credit must use the SAME interval the
                # sleep ran with; a config change applies next tick
                # lint: disable=await-invalidates-snapshot -- per-tick snapshot
                late = time.monotonic() - t0 - interval
                if late > 0.2:
                    for osd in self._hb_last:
                        self._hb_last[osd] += late
                await self._heartbeat_once()
        except asyncio.CancelledError:
            pass

    # -- cephx ---------------------------------------------------------------
    async def _cephx_boot(self) -> None:
        """Fetch rotating validation keys + our own service ticket
        over the (PSK-authenticated) mon session, install the
        messenger validator (src/auth/RotatingKeyRing.h role)."""
        from ..common.cephx import (fetch_rotating, fetch_ticket,
                                    install_validator)
        entity = f"osd.{self.whoami}"
        rk = await fetch_rotating(self.msgr, self.mon_addr, entity,
                                  self.cephx_key, "osd")
        self._rk_holder = {"rk": rk}
        install_validator(self.msgr, self._rk_holder)
        self.msgr.require_ticket = self.require_ticket
        await fetch_ticket(self.msgr, self.mon_addr, entity,
                           self.cephx_key, "osd")
        self._cephx_next_refresh = time.monotonic() + 60.0

    async def _cephx_refresh(self) -> None:
        """Keep validation keys current across rotations and our own
        ticket live past its expiry; runs on the heartbeat cadence."""
        if not self.cephx_key or self._rk_holder is None:
            return
        now = time.monotonic()
        if now < getattr(self, "_cephx_next_refresh", 0):
            return
        self._cephx_next_refresh = now + 60.0
        from ..common.cephx import fetch_rotating, fetch_ticket
        entity = f"osd.{self.whoami}"
        try:
            t = self.msgr.tickets.get("osd")
            if t is None or t["expires"] - time.time() < 120.0:
                await fetch_ticket(self.msgr, self.mon_addr, entity,
                                   self.cephx_key, "osd")
            self._rk_holder["rk"] = await fetch_rotating(
                self.msgr, self.mon_addr, entity,
                self.cephx_key, "osd")
        except Exception:
            pass            # mon hunt/retry next cycle

    async def _ping_one(self, osd: int, now: float) -> None:
        """One bounded ping send — a dead peer's connect/reconnect stall
        must never block the heartbeat cycle (the reference runs a
        dedicated hb messenger for the same reason)."""
        try:
            # a timeout scope, not wait_for's task: 64 OSDs ping ten
            # peers a second each on one event loop
            async with asyncio.timeout(1.0):
                await self.msgr.send(
                    self._peer_addr(osd), f"osd.{osd}",
                    Message("osd_ping", {"from_osd": self.whoami,
                                         "stamp": now}))
        except (ConnectionError, OSError, asyncio.TimeoutError):
            pass

    def _heartbeat_peers(self) -> list[int]:
        """Up peers this OSD pings, capped at osd_heartbeat_max_peers.

        A full mesh is O(N^2) messages per interval — fine at 3 OSDs,
        ruinous at the 64–1000 the cluster harness brings up.  The
        reference picks heartbeat peers from hosted PGs plus map-order
        neighbors (OSD::maybe_update_heartbeat_peers); we do the same:
        PG peers (whose liveness gates OUR peering/recovery) first,
        then ring neighbors by osd id so the detection graph stays
        connected and every OSD is somebody's neighbor.
        """
        ups = sorted(o for o, info in self.osdmap.osds.items()
                     if o != self.whoami and info.up)
        cap = int(self.config.get("osd_heartbeat_max_peers", 10))
        if cap <= 0 or len(ups) <= cap:
            return ups
        cap = max(cap, 4)
        # ring neighbors FIRST: every up OSD is the +-1 neighbor of two
        # others, so even a PG-less daemon has someone watching it
        import bisect
        i = bisect.bisect_left(ups, self.whoami)
        n = len(ups)
        peers: list[int] = []
        seen: set[int] = set()

        def add(o: int) -> None:
            if o != self.whoami and o not in seen:
                seen.add(o)
                peers.append(o)

        add(ups[i % n])              # i points past self (not in ups)
        add(ups[(i - 1) % n])
        add(ups[(i + 1) % n])
        for pg in self.pgs.values():
            if len(peers) >= cap:
                break
            for o in pg.up:
                if o in self.osdmap.osds and self.osdmap.osds[o].up:
                    add(o)
        for step in range(2, n):
            if len(peers) >= cap:
                break
            add(ups[(i + step) % n])
            add(ups[(i - step) % n])
        return peers[:cap]

    async def _heartbeat_once(self) -> None:
        now = time.monotonic()
        grace = self.config["osd_heartbeat_grace"]
        # map-feed freshness: our subscribed mon may have died -- a
        # quiet feed re-subscribes through the failover path (MonClient
        # re-hunts on session loss the same way)
        if now - getattr(self, "_last_map_time", now) > 5.0:
            self._last_map_time = now          # one probe per window
            self._track(asyncio.ensure_future(self._catch_up_maps()))
        await self._cephx_refresh()
        # mgr perf reporting rides the same cadence (MgrClient reports)
        if now - getattr(self, "_last_mgr_report", 0.0) > 2.0:
            self._last_mgr_report = now
            self._track(asyncio.ensure_future(self._report_to_mgr()))
        # slow-op complaints (OSD::get_health_metrics): ops in flight
        # past osd_op_complaint_time surface in the mon's health and,
        # once per op, in the cluster log
        # re-read the threshold each tick: central config may have
        # changed osd_op_complaint_time at runtime
        self.op_tracker.complaint_time = float(
            self.config.get("osd_op_complaint_time", 30.0))
        slow = self.op_tracker.slow_ops()
        if slow or getattr(self, "_had_slow_ops", False):
            self._had_slow_ops = bool(slow)
            fresh = [o for o in slow
                     if o.opid not in self.op_tracker.complained]
            for o in fresh:
                self.op_tracker.complained.add(o.opid)
                self.perf_osd.inc("slow_ops")
            self._track(asyncio.ensure_future(
                self._mon_send_failover(Message(
                    "osd_slow_ops",
                    {"osd_id": self.whoami, "count": len(slow),
                     "oldest_age": max((o.age for o in slow),
                                       default=0.0),
                     "log": bool(fresh)}))))
        # opportunistic re-kicks: a recovery push/pull that raced a peer
        # reboot backs off (the tick restarts it); a peering task that
        # died leaves the PG stranded (the tick re-runs it)
        for pg in self.pgs.values():
            if not pg.is_primary():
                continue
            if pg.state == "active" and pg._recovery_pending():
                pg.kick_recovery()
            elif pg.state in ("peering", "incomplete", "wait_up_thru",
                              "wait_acting_change"):
                # incomplete re-probes each tick (a revived peer with
                # complete history un-wedges it -- the reference reacts
                # to MNotifyRec; the tick is our notify cadence), and a
                # wait-state whose task DIED (e.g. up_thru timeout with
                # the epoch moved, so peer() exited) restarts here;
                # kick_peering is a no-op while the task still runs
                pg.kick_peering()
            if pg.state == "active" and pg.pool.removed_snaps:
                pg.kick_snap_trim(pg.pool.removed_snaps)
        self._maybe_schedule_scrubs(now)
        peers = self._heartbeat_peers()
        # a peer that enters the set starts a fresh clock, as the
        # reference's new HeartbeatInfo does (OSD::maybe_update_heartbeat
        # _peers): the stamp it left with, or one from its pings while it
        # was out of the set, is no evidence for this peering.  Judged by
        # it, a map change that swaps a ring neighbour (a kill) reports a
        # live peer at once, and each false mark-down's epoch swaps more
        entered = set(peers) - self._hb_peers
        self._hb_peers = set(peers)
        for osd in entered:
            self._hb_last[osd] = now
        await asyncio.gather(*(self._ping_one(o, now) for o in peers),
                             return_exceptions=True)
        for osd in peers:
            last = self._hb_last.get(osd)
            if last is None:
                self._hb_last[osd] = now     # start the clock
            # one sweep judges every peer against ONE grace;
            # re-reading mid-sweep grades peers on different clocks
            # lint: disable=await-invalidates-snapshot -- per-sweep snapshot
            elif now - last > grace:
                # yield once so queued ping/reply handlers run, then
                # re-check: distinguishes "peer silent" from "our loop
                # was busy and the replies are still in the queue"
                await asyncio.sleep(0)
                last = self._hb_last.get(osd, now)
                if now - last <= grace:
                    continue
                await self._mon_send_failover(
                    Message("osd_failure", {"target": osd}))

    # -- dispatch -----------------------------------------------------------
    async def _dispatch(self, conn, msg: Message) -> None:
        handler = getattr(self, f"_h_{msg.type}", None)
        if handler is not None:
            await handler(conn, msg)

    async def _h_config_update(self, conn, msg) -> None:
        """Central config push (ConfigMonitor -> MConfig): values flow
        through the ConfigProxy so observers fire on change.  The
        message carries the FULL effective config: keys previously
        pushed but now absent revert to their local values (config rm
        must actually undo the override)."""
        cfg = msg.data.get("config", {})
        pushed = getattr(self, "_pushed_config", set())
        for name in pushed - set(cfg):
            if name in self._base_config:
                self.config[name] = self._base_config[name]
                try:
                    self.conf.set(name, self._base_config[name])
                except (KeyError, ValueError):
                    pass
            else:
                self.config.pop(name, None)
        applied = set()
        for name, value in cfg.items():
            try:
                self.conf.set(name, value)
                applied.add(name)
            except ValueError:
                # KNOWN option, invalid value: reject the NEW value --
                # but keep tracking the key if an earlier push set it,
                # or a later `config rm` could never revert it
                if name in pushed:
                    applied.add(name)
                continue
            except KeyError:
                # unschema'd option: best-effort numeric cast so hot
                # paths comparing against numbers keep working
                for cast in (int, float):
                    try:
                        value = cast(value)
                        break
                    except (TypeError, ValueError):
                        continue
                self.config[name] = value
                applied.add(name)
        self._pushed_config = applied

    async def _h_osdmap_inc(self, conn, msg) -> None:
        self._apply_incremental(msg.data["inc"])

    async def _h_osdmap_full(self, conn, msg) -> None:
        self._apply_full_map(msg.data["map"])

    async def _h_osd_ping(self, conn, msg) -> None:
        self._hb_last[msg.data["from_osd"]] = time.monotonic()
        await conn.send(Message("osd_ping_reply",
                                {"from_osd": self.whoami,
                                 "stamp": msg.data["stamp"]}))

    async def _h_mgr_map(self, conn, msg) -> None:
        self._mgr_addr = tuple(msg.data["addr"])
        self._mgr_name = msg.data.get("name", "0")

    async def _report_to_mgr(self) -> None:
        """Push a perf summary to the active mgr (the MgrClient report
        protocol the DaemonServer aggregates)."""
        addr = getattr(self, "_mgr_addr", None)
        if addr is None:
            return
        summary = {}
        try:
            dump = self.perf.dump().get("osd", {})
            for key in ("op", "op_w", "op_r", "op_in_bytes",
                        "op_out_bytes", "subop_w", "recovery_ops"):
                if key in dump:
                    v = dump[key]
                    summary[key] = v.get("value", v) \
                        if isinstance(v, dict) else v
            summary["num_pgs"] = len(self.pgs)
            # recovery/backfill state for the mgr progress module
            # (pg stats feeding progress events in the reference)
            states: dict[str, int] = {}
            missing = 0
            backfills = 0
            for pg in self.pgs.values():
                states[pg.state] = states.get(pg.state, 0) + 1
                if pg.is_primary():
                    missing += len(pg.missing) + sum(
                        len(ms) for ms in pg.peer_missing.values())
                    backfills += len(pg.backfill_targets)
            summary["pg_states"] = states
            summary["slow_ops"] = len(self.op_tracker.slow_ops())
            summary["missing_objects"] = missing
            summary["backfills"] = backfills
        except Exception:
            return
        try:
            await asyncio.wait_for(self.msgr.send(
                addr, f"mgr.{getattr(self, '_mgr_name', '0')}",
                Message("mgr_report",
                        {"daemon": f"osd.{self.whoami}",
                         "summary": summary})), 2.0)
        except (ConnectionError, OSError, asyncio.TimeoutError):
            # keep the address: a transient stall must not silence
            # reporting forever (the mon only re-publishes mgr_map on
            # CHANGE); the next cadence simply retries
            pass

    async def _h_mgr_report_ack(self, conn, msg) -> None:
        pass

    async def _h_watch_notify_ack(self, conn, msg) -> None:
        fut = self._notify_waiters.pop(msg.data.get("notify_id"), None)
        if fut is not None and not fut.done():
            fut.set_result(msg.data)

    async def _h_osd_ping_reply(self, conn, msg) -> None:
        self._hb_last[msg.data["from_osd"]] = time.monotonic()

    # client I/O
    async def _h_osd_op(self, conn, msg) -> None:
        await self.admit(OpClass.CLIENT)
        # byte throttle on in-flight client payloads
        # (osd_client_message_size_cap backpressure); the limit re-reads
        # config so runtime `config set` takes effect
        self.client_throttle.limit = int(
            self.config.get("osd_client_message_size_cap", 500 << 20))
        nbytes = sum(len(s) for s in msg.segments)
        await self.client_throttle.get(nbytes)
        try:
            await self._do_osd_op(conn, msg)
        finally:
            self.client_throttle.put(nbytes)

    async def _do_osd_op(self, conn, msg) -> None:
        # blocklist fence (OSD.cc session blocklist check): a fenced
        # instance's delayed/in-flight writes must NOT land -- this is
        # what makes cap revocation and rbd lock steal safe against a
        # wedged-but-alive client.  The instance is the connection's
        # ("name:incarnation" as the handshake gave them), never the
        # message's reqid: a client stamping another reqid would step
        # round its own fence
        iid = f"{conn.peer_name}:{conn.peer_inst}"
        # an entry may name a full instance ("client.x:inc") or a bare
        # entity ("client.x" -- rbd lock break fences every instance)
        if self.osdmap.is_blocklisted(iid) \
                or self.osdmap.is_blocklisted(conn.peer_name):
            await conn.send(Message(
                "osd_op_reply", {"tid": msg.data.get("tid"),
                                 "err": "EBLOCKLISTED"}))
            return
        reqid = msg.data.get("reqid")
        if reqid and str(reqid[0]) != iid:
            await conn.send(Message(
                "osd_op_reply", {"tid": msg.data.get("tid"),
                                 "err": "EPERM reqid names another "
                                        "instance"}))
            return
        pg = self._get_pg(msg.data["pgid"])
        if pg is None:
            await conn.send(Message(
                "osd_op_reply", {"tid": msg.data.get("tid"),
                                 "err": "ENXIO no such pg"}))
            return
        from ..common.tracing import get_tracer
        span = get_tracer(f"osd.{self.whoami}").start(
            "osd.do_op", parent=msg.data.get("trace"),
            pgid=msg.data["pgid"], oid=msg.data["oid"]).activate()
        try:
            await self._do_osd_op_traced(conn, msg, pg)
        finally:
            span.finish()

    async def _do_osd_op_traced(self, conn, msg, pg) -> None:
        op_names = [o.get("op") for o in msg.data.get("ops", [])]
        top = self.op_tracker.create(
            oid=msg.data["oid"], pgid=msg.data["pgid"],
            type="+".join(op_names),
            client=str(msg.from_name))
        try:
            with self.perf_osd.time("op_latency"):
                data, segments = await pg.do_op(msg, conn, top=top)
        finally:
            top.finish()
        if "err" not in data:          # rejected ops aren't throughput
            self.perf_osd.inc("op")
            if any(n in WRITE_OPS for n in op_names):
                self.perf_osd.inc("op_w")
                self.perf_osd.inc("op_in_bytes",
                                  sum(len(s) for s in msg.segments))
            else:
                self.perf_osd.inc("op_r")
                self.perf_osd.inc("op_out_bytes",
                                  sum(len(s) for s in segments))
        data["tid"] = msg.data.get("tid")
        data["epoch"] = self.osdmap.epoch
        await conn.send(Message("osd_op_reply", data, segments=segments))

    # replication / EC sub-ops
    async def _h_rep_op(self, conn, msg) -> None:
        from ..common.tracing import get_tracer
        span = get_tracer(f"osd.{self.whoami}").start(
            "osd.rep_op", parent=msg.data.get("trace"),
            pgid=msg.data["pgid"]).activate()
        try:
            await self._h_rep_op_traced(conn, msg)
        finally:
            span.finish()

    async def _h_rep_op_traced(self, conn, msg) -> None:
        from .types import LogEntry
        from .backend import unpack_mutations
        pg = self._get_pg(msg.data["pgid"])
        if pg is not None:
            entry = LogEntry.from_dict(msg.data["entry"])
            muts = unpack_mutations(msg.data["muts"], msg.segments)
            pg.backend.apply_rep_op(entry, muts,
                                    log_only=bool(
                                        msg.data.get("log_only")))
            self.perf_osd.inc("subop_w")
        await conn.send(Message("rep_op_reply",
                                {"tid": msg.data.get("tid"),
                                 "from_osd": self.whoami}))

    async def _h_rep_op_reply(self, conn, msg) -> None:
        self._resolve_tid(msg)

    async def _h_ec_subop_write(self, conn, msg) -> None:
        from .types import LogEntry
        from .backend import unpack_mutations
        pg = self._get_pg(msg.data["pgid"])
        if pg is not None:
            entry = LogEntry.from_dict(msg.data["entry"])
            w = msg.data["w"]
            if w.get("writes") is not None:      # ranged RMW sub-write
                n_data_segs = len(w["writes"])
            elif w.get("remove") or w.get("touch") or w.get("log_only"):
                n_data_segs = 0
            else:
                n_data_segs = 1
            attr_muts = unpack_mutations(msg.data.get("attr_muts", []),
                                         msg.segments[n_data_segs:])
            pg.backend.apply_sub_write(
                entry, w, msg.segments[:n_data_segs], attr_muts,
                shard=msg.data.get("shard"))
            self.perf_osd.inc("subop_w")
        await conn.send(Message("ec_subop_write_reply",
                                {"tid": msg.data.get("tid"),
                                 "from_osd": self.whoami}))

    async def _h_ec_subop_write_reply(self, conn, msg) -> None:
        self._resolve_tid(msg)

    # -- scrub scheduling (osd_scrub_sched.cc in miniature) -----------------
    def _maybe_schedule_scrubs(self, now: float) -> None:
        interval = float(self.config.get("osd_scrub_interval", 0))
        if interval <= 0:       # scheduling off unless configured
            return
        import random
        due = []
        for pgid, pg in self.pgs.items():
            if (not pg.is_primary() or pg.state != "active"
                    or pgid in self._scrubbing
                    or pg._recovery_pending()):
                continue
            last = self._scrub_stamps.get(pgid, 0.0)
            if now - last < interval:
                continue
            due.append(pgid)
        if not due:
            return
        # ONE scrub kick per tick, randomly chosen: launching every due
        # PG at once makes all primaries collide on the replicas'
        # single scrub slots in lockstep, tick after tick
        pgid = random.choice(due)
        self._scrubbing.add(pgid)
        self._track(asyncio.ensure_future(
            self._run_scheduled_scrub(pgid)))

    async def _run_scheduled_scrub(self, pgid: str) -> None:
        """One reserved scrub: local slot + a slot on every acting
        replica, then the scrub itself (repair on by default, the
        osd_scrub_auto_repair discipline)."""
        pg = self.pgs.get(pgid)
        granted_remote: list[int] = []
        got_local = False
        try:
            if pg is None or not pg.is_primary():
                return
            await self.scrub_reserver.request(pgid, timeout=30)
            got_local = True
            # the slot wait suspended: re-read the PG, an epoch
            # change may have replaced or deposed it meanwhile
            pg = self.pgs.get(pgid)
            if pg is None or not pg.is_primary():
                return
            peers = [o for o in pg.acting_peers() if self.osd_is_up(o)]
            for o in peers:
                replies = await self.fanout_and_wait(
                    [(o, "scrub_reserve", {"pgid": pgid}, [])],
                    collect=True, timeout=10)
                if not replies or not replies[0].data.get("granted"):
                    return          # replica busy; retried next tick
                granted_remote.append(o)
            from .scrub import scrub_pg
            # the replica handshakes suspended too
            pg = self.pgs.get(pgid)
            if pg is None or not pg.is_primary():
                return
            res = await scrub_pg(pg, repair=bool(
                self.config.get("osd_scrub_auto_repair", True)))
            self._scrub_stamps[pgid] = time.monotonic()
            self.perf_osd.inc("scrubs")
            if not res.clean:
                self.perf_osd.inc("scrub_repairs", len(res.repaired))
        except (ConnectionError, OSError, asyncio.TimeoutError):
            pass                    # retried next tick
        finally:
            if got_local:
                self.scrub_reserver.release(pgid)
            for o in granted_remote:
                try:
                    await self.fanout_and_wait(
                        [(o, "scrub_release", {"pgid": pgid}, [])],
                        collect=True, timeout=5)
                except (ConnectionError, OSError,
                        asyncio.TimeoutError):
                    pass
            self._scrubbing.discard(pgid)

    async def _h_pg_scrub_map_req(self, conn, msg) -> None:
        """Replica side of a scrub round: digest every local object
        (scrub_backend.cc building the replica scrub map)."""
        from .scrub import build_scrub_map
        pg = self._get_pg(msg.data["pgid"])
        smap = await build_scrub_map(self.store, pg.coll) if pg else {}
        await conn.send(Message("pg_scrub_map", {
            "pgid": msg.data["pgid"], "map": smap,
            "from_osd": self.whoami, "tid": msg.data.get("tid")}))

    async def _h_pg_scrub_map(self, conn, msg) -> None:
        self._resolve_tid(msg)

    async def _h_scrub_reserve(self, conn, msg) -> None:
        """Remote scrub slot (the scrubber's replica reservations --
        a replica scrubs for at most osd_max_scrubs PGs at once)."""
        granted = self.scrub_reserver.get_or_fail(
            msg.data["pgid"], lease=120.0)
        await conn.send(Message("scrub_reserve_reply", {
            "pgid": msg.data["pgid"], "granted": granted,
            "from_osd": self.whoami, "tid": msg.data.get("tid")}))

    async def _h_scrub_reserve_reply(self, conn, msg) -> None:
        self._resolve_tid(msg)

    async def _h_scrub_release(self, conn, msg) -> None:
        self.scrub_reserver.release(msg.data["pgid"])
        await conn.send(Message("scrub_release_ack", {
            "pgid": msg.data["pgid"], "from_osd": self.whoami,
            "tid": msg.data.get("tid")}))

    async def _h_scrub_release_ack(self, conn, msg) -> None:
        self._resolve_tid(msg)

    async def _h_ec_subop_read(self, conn, msg) -> None:
        pg = self._get_pg(msg.data["pgid"])
        data, buf = {"tid": msg.data.get("tid")}, b""
        if msg.data.get("shard") is not None:
            # echo what the requester ASKED for, so it can match the
            # reply to its plan independently of what we report below
            data["req_shard"] = int(msg.data["shard"])
        if pg is not None and msg.data.get("frag_for") is not None:
            # regenerating-code repair fragment: combine MY stored
            # chunk by the codec's fragment row for the lost shard and
            # ship beta-sized bytes instead of the whole chunk.  The
            # fragment carries its own CRC plus this shard's write-time
            # label/version so the aggregator can verify before mixing.
            oid = msg.data["oid"]
            backend = pg.backend
            frag = backend.fragment_of(oid, int(msg.data["frag_for"])) \
                if hasattr(backend, "fragment_of") else None
            if frag is None:
                data["frag_err"] = "ENOFRAG"
            else:
                fbuf, size, ver, label = frag
                buf = fbuf
                data["size"] = size
                data["ver"] = list(ver)
                data["frag_for"] = int(msg.data["frag_for"])
                if label is not None:
                    data["shard"] = int(label)
                from .backend import shard_crc
                data["crc"] = shard_crc(fbuf)
            await conn.send(Message("ec_subop_read_reply", data,
                                    segments=[buf]))
            return
        if pg is not None:
            oid = msg.data["oid"]
            off = int(msg.data.get("off", 0))
            length = msg.data.get("len")     # None = whole shard
            # serve from the device-resident shard cache when the
            # bytes are resident: the reply (identity xattrs included)
            # never touches the store -- the wire segment is the one
            # unavoidable materialization of a remote read
            entry = self.shard_cache.get(pg.coll, oid) \
                if self.shard_cache is not None else None
            if entry is not None:
                arr = entry.buf if length is None \
                    else entry.buf[off:off + length]
                buf = arr.tobytes()
                data["size"] = entry.size
                data["ver"] = list(entry.ver)
                if entry.shard is not None:
                    data["shard"] = entry.shard
                if entry.crc is not None:
                    data["crc"] = entry.crc
                await conn.send(Message("ec_subop_read_reply", data,
                                        segments=[buf]))
                return
            try:
                buf = self.store.read(pg.coll, oid, off, length)
            except FileNotFoundError:
                buf = b""
            from .backend import (CRC_XATTR, SIZE_XATTR, VER_XATTR,
                                  ver_decode)
            sx = self.store.getattr(pg.coll, oid, SIZE_XATTR)
            data["size"] = int(sx) if sx else 0
            data["ver"] = list(ver_decode(
                self.store.getattr(pg.coll, oid, VER_XATTR)))
            # report the WRITE-TIME identity of the stored bytes (per-
            # object pin, PG pin fallback), NOT the current acting-set
            # index: after a re-peer the index is a claim about where
            # shards SHOULD live; the label is what these bytes ARE.
            # The reader rejects a mismatch instead of decoding garbage.
            label = pg.backend.shard_label(oid) \
                if hasattr(pg.backend, "shard_label") else None
            if label is not None:
                data["shard"] = int(label)
            crc = self.store.getattr(pg.coll, oid, CRC_XATTR)
            if crc is not None:
                data["crc"] = int(crc)
            if self.shard_cache is not None:
                self.shard_cache.note_host_read(len(buf))
                if length is None and off == 0 and (buf or data["size"]):
                    # read-through fill: repeat remote reads of a hot
                    # shard stop re-materializing it from the store
                    self.shard_cache.put(
                        pg.coll, oid, buf, size=data["size"],
                        ver=tuple(data["ver"]), shard=label,
                        crc=data.get("crc"))
        await conn.send(Message("ec_subop_read_reply", data,
                                segments=[buf]))

    async def _h_ec_subop_read_reply(self, conn, msg) -> None:
        self._resolve_tid(msg)

    # peering
    async def _h_pg_query(self, conn, msg) -> None:
        pg = self._get_pg(msg.data["pgid"])
        if pg is not None:
            data = pg.on_query()
        else:
            from .types import PGInfo
            data = {"pgid": msg.data["pgid"],
                    "info": PGInfo(pgid=msg.data["pgid"]).to_dict(),
                    "entries": [], "from_osd": self.whoami}
        data["tid"] = msg.data.get("tid")
        await conn.send(Message("pg_notify", data))

    async def _h_pg_notify(self, conn, msg) -> None:
        self._resolve_tid(msg)

    async def _h_pg_activate(self, conn, msg) -> None:
        pg = self._get_pg(msg.data["pgid"])
        if pg is None:
            await conn.send(Message("pg_activate_ack",
                                    {"tid": msg.data.get("tid"),
                                     "err": "ENXIO", "missing": {},
                                     "from_osd": self.whoami}))
            return
        data = await pg.on_activate(msg)
        data["tid"] = msg.data.get("tid")
        await conn.send(Message("pg_activate_ack", data))

    async def _h_pg_activate_ack(self, conn, msg) -> None:
        self._resolve_tid(msg)

    # recovery
    async def _h_pg_pull(self, conn, msg) -> None:
        pg = self._get_pg(msg.data["pgid"])
        if pg is None:
            await conn.send(Message("pg_pull_reply",
                                    {"tid": msg.data.get("tid"),
                                     "err": "ENXIO"}))
            return
        data, segments = await pg.on_pull(msg)
        data["tid"] = msg.data.get("tid")
        await conn.send(Message("pg_pull_reply", data, segments=segments))

    async def _h_pg_pull_reply(self, conn, msg) -> None:
        self._resolve_tid(msg)

    async def _h_pg_push(self, conn, msg) -> None:
        pg = self._get_pg(msg.data["pgid"])
        if pg is None:
            await conn.send(Message("pg_push_reply",
                                    {"tid": msg.data.get("tid"),
                                     "err": "ENXIO"}))
            return
        data = await pg.on_push(msg)
        self.perf_osd.inc("recovery_ops")
        data["tid"] = msg.data.get("tid")
        await conn.send(Message("pg_push_reply", data))

    async def _h_pg_push_reply(self, conn, msg) -> None:
        self._resolve_tid(msg)

    # backfill (scan diff + completion + reservations)
    async def _h_pg_scan(self, conn, msg) -> None:
        pg = self._get_pg(msg.data["pgid"])
        data = {"tid": msg.data.get("tid"), "from_osd": self.whoami}
        if pg is None:
            data["err"] = "ENXIO"
        else:
            objs, exhausted = pg.scan_range(
                msg.data.get("begin", ""),
                int(msg.data.get("limit", 0)) or 10 ** 9)
            data["objects"] = {o: list(v) for o, v in objs.items()}
            data["exhausted"] = exhausted
        await conn.send(Message("pg_scan_reply", data))

    async def _h_pg_backfill_progress(self, conn, msg) -> None:
        pg = self._get_pg(msg.data["pgid"])
        if pg is None:
            data = {"err": "ENXIO", "from_osd": self.whoami}
        else:
            data = pg.on_backfill_progress(msg.data["cursor"])
        data["tid"] = msg.data.get("tid")
        await conn.send(Message("pg_backfill_progress_reply", data))

    async def _h_pg_backfill_progress_reply(self, conn, msg) -> None:
        self._resolve_tid(msg)

    async def _h_pg_scan_reply(self, conn, msg) -> None:
        self._resolve_tid(msg)

    async def _h_pg_backfill_done(self, conn, msg) -> None:
        pg = self._get_pg(msg.data["pgid"])
        if pg is None:
            data = {"err": "ENXIO", "from_osd": self.whoami}
        else:
            data = pg.on_backfill_done()
        data["tid"] = msg.data.get("tid")
        await conn.send(Message("pg_backfill_done_reply", data))

    async def _h_pg_backfill_done_reply(self, conn, msg) -> None:
        self._resolve_tid(msg)

    async def _h_backfill_reserve(self, conn, msg) -> None:
        """Grant-or-busy: the primary polls again next recovery round
        rather than queueing forever on a busy target."""
        token = msg.data["pgid"]
        try:
            await self.remote_reserver.request(token, timeout=5)
            granted = True
        except asyncio.TimeoutError:
            granted = False
        await conn.send(Message("backfill_reserve_reply",
                                {"tid": msg.data.get("tid"),
                                 "granted": granted,
                                 "from_osd": self.whoami}))

    async def _h_backfill_reserve_reply(self, conn, msg) -> None:
        self._resolve_tid(msg)

    async def _h_backfill_release(self, conn, msg) -> None:
        self.remote_reserver.release(msg.data["pgid"])
        await conn.send(Message("backfill_release_reply",
                                {"tid": msg.data.get("tid"),
                                 "from_osd": self.whoami}))

    async def _h_backfill_release_reply(self, conn, msg) -> None:
        self._resolve_tid(msg)
