"""PG: per-placement-group op execution, peering, log-based recovery.

The op path mirrors PrimaryLogPG (do_op -> execute -> issue_repop,
PrimaryLogPG.cc:1982,4160,11456); peering follows the PeeringState
machine's happy path GetInfo -> GetLog -> GetMissing -> Activate
(PeeringState.h:645-680); recovery pulls objects the primary is
missing and pushes to behind replicas (recover_primary/replicas,
PrimaryLogPG.cc:13446,13719).
"""

from __future__ import annotations

import asyncio
import collections
import json

from ..msg import Message
from ..os.transaction import Transaction
from .backend import (
    HIDDEN_XATTRS, META_OID, ReplicatedBackend, apply_mutations,
    build_pg_backend, pack_mutations, unpack_mutations,
)
from .pg_log import PGLog
from .scheduler import OpClass
from .types import (
    DELETE, EVersion, LogEntry, MissingSet, MODIFY, PGInfo, PastIntervals,
    ZERO,
)

# process-wide counts of client ops whose reqid the PG had seen:
# ``completed`` (a write already applied, acknowledged again) and
# ``inflight`` (a copy of an op still queued or running on the PG)
DUP_REQIDS: collections.Counter = collections.Counter()

LOG_CAP = 512           # entries kept in the in-memory/persisted log
SCAN_BATCH = 128        # objects per pg_scan page / backfill batch


def _log_key(v: EVersion) -> str:
    """Per-entry omap key for the PG log; zero-padded so the plain
    lexicographic omap order IS (epoch, version) order."""
    return f"log.{v.epoch:010d}.{v.version:012d}"

# client op names that mutate
WRITE_OPS = {"create", "write", "writefull", "append", "truncate", "zero",
             "remove", "setxattr", "rmxattr", "omap_set", "omap_rm",
             "omap_clear"}
READ_OPS = {"read", "stat", "getxattr", "getxattrs", "omap_get", "list"}
WATCH_OPS = {"watch", "unwatch", "notify", "list_watchers", "list_snaps"}
CALL_OPS = {"call"}     # cls method execution (CEPH_OSD_OP_CALL)



async def _reacquire(lock: asyncio.Lock) -> None:
    """Take ``lock`` back, even when the caller is cancelled while it
    waits: the acquire runs on as its own task, the caller waits for it
    through every cancellation, and the first cancellation is raised
    once the lock is held again."""
    acquire = asyncio.ensure_future(lock.acquire())
    cancelled = None
    while True:
        try:
            await asyncio.shield(acquire)
            break
        except asyncio.CancelledError as e:
            if acquire.cancelled():
                raise
            cancelled = cancelled or e
            if acquire.done():
                break
    if cancelled is not None:
        raise cancelled

class PG:
    def __init__(self, osd, pgid: str, pool, ec_profile: dict | None) -> None:
        self.osd = osd
        self.pgid = pgid
        self.pool = pool
        self.ec_profile = dict(ec_profile or {})
        self.coll = f"pg_{pgid}"
        self.log = PGLog()
        self.info = PGInfo(pgid=pgid)
        self.missing = MissingSet()
        self.peer_info: dict[int, PGInfo] = {}
        self.peer_log_entries: dict[int, list[LogEntry]] = {}
        self.peer_missing: dict[int, MissingSet] = {}
        self.backfill_targets: set[int] = set()
        # per-target incremental backfill state (primary side):
        # cursor  -- the peer's confirmed last_backfill watermark
        # inflight -- oid -> Event while a push is in progress (client
        #             writes to that oid wait instead of racing it)
        # pushed  -- oids pushed in the current batch (> cursor): client
        #            writes to these DO go to the peer
        self.backfill_info: dict[int, dict] = {}
        self.past_intervals = PastIntervals()
        self.up: list[int] = []
        self.acting: list[int] = []
        # WRITE-TIME-PINNED shard identity of this PG instance (EC
        # pools; the spg_t shard of the reference).  Pinned when the
        # first shard write lands, persisted with the PG meta, and kept
        # across acting-set changes -- the CURRENT acting index is a
        # claim about placement, the pin is a fact about the bytes on
        # disk.  When the map genuinely remaps this OSD to a different
        # position, _check_shard_identity queues every local object for
        # re-recovery instead of serving old-shard bytes under the new
        # label.
        self.shard_id: int | None = None
        self.state = "initial"
        # transition trace for introspection/tests (NamedState events)
        self.state_history: list[str] = ["initial"]
        self.lock = asyncio.Lock()
        # pipelined write spine: per-object chains of deferred
        # commit tasks.  A write's peer fan-out is awaited OUTSIDE the
        # PG lock; ordering per (PG, object) is preserved by chaining
        # commits per oid and gating the next op on the chain head.
        self._obj_commits: dict[str, asyncio.Task] = {}
        self._recovery_task: asyncio.Task | None = None
        self._peering_task: asyncio.Task | None = None
        self._completed_reqids: dict[tuple[str, int], EVersion] = {}
        # reqid -> the result of the copy of that op now queued or
        # running here: a resent copy waits for it instead of running
        self._inflight_reqids: dict[tuple[str, int], asyncio.Future] = {}
        # watch/notify (Watch.cc): oid -> {(client, cookie):
        # {"conn", "addr"}}.  Registrations PERSIST in a replicated
        # registry object (the reference keeps them in object_info),
        # so a new primary reloads them at activation and a notify
        # right after failover still reaches every watcher -- the
        # objecter's linger re-watch is the backstop, not the only
        # mechanism
        self.watchers: dict[str, dict[tuple, dict]] = {}
        self.trimmed_snaps: set[int] = set()
        self._snap_trim_task: asyncio.Task | None = None
        # incremental log persistence (the PR-12 store-txn hot path):
        # entries live as individual ``log.<epoch>.<version>`` omap
        # keys, so a write persists ONE new entry (+ trims) instead of
        # re-encoding the whole capped log -- at LOG_CAP=512 the
        # monolithic blob cost ~6ms of denc per shard per write, the
        # single largest CPU line of the cluster bench's write path.
        # _log_keys mirrors what the store holds; _log_dirty forces a
        # full rewrite after wholesale log surgery (peering merges).
        self._log_keys: set[str] = set()
        self._log_dirty = False
        self._legacy_log_key = False
        if not self.osd.store.collection_exists(self.coll):
            txn = Transaction()
            txn.create_collection(self.coll)
            txn.touch(self.coll, META_OID)
            self.osd.store.queue_transaction(txn)
        self._load_meta()
        self.backend = build_pg_backend(self)

    # -- persistence --------------------------------------------------------
    # PG metadata persists in denc form (versioned binary envelopes,
    # common/denc.py) as the reference encodes pg_info_t/pg_log_entry_t;
    # a leading '{'/'[' marks a pre-denc JSON store and decodes through
    # the dict path (cross-version compat in the ceph-object-corpus
    # sense -- the corpus pins the byte format, tests/test_denc.py).
    @staticmethod
    def _is_json(raw: bytes) -> bool:
        return raw[:1] in (b"{", b"[")

    def _load_meta(self) -> None:
        from ..common.denc import Decoder
        omap = self.osd.store.omap_get(self.coll, META_OID)

        def load(key, denc_fn, json_fn):
            raw = omap.get(key)
            if raw is None:
                return None
            if self._is_json(raw):
                return json_fn(json.loads(raw))
            return denc_fn(raw)
        got = load("info", lambda r: PGInfo.dedenc(Decoder(r)),
                   PGInfo.from_dict)
        if got is not None:
            self.info = got
        log_keys = {k: v for k, v in omap.items()
                    if k.startswith("log.")}
        if log_keys:
            # per-entry format: lexicographic key order is version
            # order by construction
            entries = [LogEntry.dedenc(Decoder(raw))
                       for _, raw in sorted(log_keys.items())]
            tail = head = ZERO
            lm = omap.get("logmeta")
            if lm:
                t, h = json.loads(lm)
                tail = EVersion.from_list(t)
                head = EVersion.from_list(h)
            elif entries:
                tail, head = ZERO, entries[-1].version
            self.log = PGLog(tail=tail, head=head, entries=entries)
            self._reindex_reqids()
            self._log_keys = set(log_keys)
        else:
            # legacy monolithic blob: load it, then the first persist
            # migrates to per-entry keys (and drops the blob)
            got = load("log", lambda r: PGLog.dedenc(Decoder(r)),
                       PGLog.from_dict)
            if got is not None:
                self.log = got
                self._reindex_reqids()
                self._log_dirty = True
                self._legacy_log_key = True
        got = load("missing", lambda r: MissingSet.dedenc(Decoder(r)),
                   MissingSet.from_dict)
        if got is not None:
            self.missing = got
        got = load("past_intervals",
                   lambda r: PastIntervals.dedenc(Decoder(r)),
                   PastIntervals.from_dict)
        if got is not None:
            self.past_intervals = got
        if "trimmed_snaps" in omap:
            self.trimmed_snaps = set(json.loads(omap["trimmed_snaps"]))
        if omap.get("shard"):
            self.shard_id = int(omap["shard"])

    def _meta_kv(self) -> dict[str, bytes]:
        from ..common.denc import denc_bytes
        kv = {
            "info": denc_bytes(self.info),
            "logmeta": json.dumps(
                [self.log.tail.to_list(),
                 self.log.head.to_list()]).encode(),
            "missing": denc_bytes(self.missing),
            "past_intervals": denc_bytes(self.past_intervals),
            "trimmed_snaps": json.dumps(
                sorted(self.trimmed_snaps)).encode(),
        }
        if self.shard_id is not None:
            kv["shard"] = str(self.shard_id).encode()
        return kv

    def _persist_log(self, txn: Transaction) -> None:
        """Per-entry log persistence, O(changed entries): new entries
        get their own omap keys, trimmed ones are removed.  Keys are
        (epoch, version)-unique, and a merge never re-adopts a version
        it rewound (divergent = absent from the authoritative log), so
        diffing against the persisted key set is exact; wholesale log
        surgery sets _log_dirty and rewrites everything anyway."""
        from ..common.denc import denc_bytes
        want = {_log_key(e.version): e for e in self.log.entries}
        have = set() if self._log_dirty else self._log_keys
        stale = self._log_keys - set(want)
        if self._legacy_log_key:
            stale = stale | {"log"}
            self._legacy_log_key = False
        to_add = set(want) - have
        if stale:
            txn.omap_rmkeys(self.coll, META_OID, sorted(stale))
        if to_add:
            txn.omap_setkeys(self.coll, META_OID,
                             {k: denc_bytes(want[k])
                              for k in sorted(to_add)})
        self._log_keys = set(want)
        self._log_dirty = False

    def persist_meta(self, txn: Transaction | None = None) -> None:
        own = txn is None
        if own:
            txn = Transaction()
        txn.omap_setkeys(self.coll, META_OID, self._meta_kv())
        self._persist_log(txn)
        if own:
            self.osd.store.queue_transaction(txn)

    def append_log_and_meta(self, txn: Transaction, entry: LogEntry) -> None:
        """Log append + pg meta, in the SAME transaction as the data ops
        (the atomic data+log commit log-based recovery depends on,
        PGLog persisted via ObjectStore::Transaction)."""
        if entry.version > self.log.head:
            self.log.add(entry)
            if entry.reqid is not None:
                self._completed_reqids[tuple(entry.reqid)] = entry.version
            if len(self.log.entries) > LOG_CAP:
                self.log.trim(self.log.entries[-LOG_CAP].version)
                self._reindex_reqids()
            self.info.last_update = entry.version
            self.info.log_tail = self.log.tail
            if not self.missing:
                self.info.last_complete = entry.version
        self.persist_meta(txn)

    def _sync_info_from_log(self) -> None:
        """info mirrors the log after merges/trims -- peers decide
        overlap-vs-backfill from the ADVERTISED tail, so a stale
        info.log_tail would hide trim gaps."""
        self.info.last_update = self.log.head
        self.info.log_tail = self.log.tail

    def _reindex_reqids(self) -> None:
        """Rebuild the dup-detection index from the trimmed log
        (pg_log_dup_t analog: dedup window == log window)."""
        self._completed_reqids = {
            tuple(e.reqid): e.version
            for e in self.log.entries if e.reqid is not None}

    def _set_state(self, state: str) -> None:
        if state != self.state:
            self.state = state
            self.state_history.append(state)
            if len(self.state_history) > 64:
                del self.state_history[:-64]

    # -- role / mapping -----------------------------------------------------
    @property
    def whoami(self) -> int:
        return self.osd.whoami

    def is_primary(self) -> bool:
        # first non-hole in the acting set is primary (EC acting sets
        # keep -1 holes to preserve shard positions)
        for o in self.acting:
            if o >= 0:
                return o == self.whoami
        return False

    def acting_peers(self) -> list[int]:
        return [o for o in self.acting if o >= 0 and o != self.whoami]

    def update_mapping(self, up: list[int], acting: list[int],
                       epoch: int) -> bool:
        """Returns True when the interval changed (peering needed)."""
        if up == self.up and acting == self.acting:
            return False
        if self.acting:
            # maybe_went_rw: the closing interval could only have served
            # writes if its primary got an up_thru bump at/after the
            # interval start (osd_types.cc check_new_interval); the
            # current map's up_thru can only OVERSTATE (monotone), so
            # rw=True is the safe direction
            prev_primary = next((o for o in self.acting if o >= 0), -1)
            rw = (prev_primary >= 0
                  and (self.osd.osdmap.get_up_thru(prev_primary)
                       >= self.info.same_interval_since))
            self.past_intervals.note_interval(
                self.info.same_interval_since, epoch - 1, self.acting,
                rw=rw)
        self.up = list(up)
        self.acting = list(acting)
        self.info.same_interval_since = epoch
        if not self.pool.can_shift_osds():
            self._check_shard_identity()
        self._set_state("peering" if self.is_primary() else "stray")
        self.backend.invalidate_extents()   # interval change: stale cache
        if self._recovery_task:
            self._recovery_task.cancel()
            self._recovery_task = None
        if self._peering_task:
            self._peering_task.cancel()
            self._peering_task = None
        if self._snap_trim_task:
            self._snap_trim_task.cancel()
            self._snap_trim_task = None
        self.watchers.clear()     # clients re-watch on the new interval
        return True

    def _check_shard_identity(self) -> None:
        """EC pools: reconcile the write-time shard pin with the new
        acting position.

        Same position (the common case -- holes keep positions stable
        across down events): nothing to do.  A GENUINE remap (this OSD
        now serves a different shard, e.g. after a mark-out rebalance):
        the local bytes are the OLD shard and must not be served under
        the new label, so every local object is queued for re-recovery
        at its stored version and the pin moves.  The per-object shard
        xattrs keep rejecting the stale bytes until recovery rewrites
        them (backend read verification), so a slow recovery degrades
        reads instead of corrupting them."""
        try:
            pos = self.acting.index(self.whoami)
        except ValueError:
            return                   # not serving this interval
        if self.shard_id is None:
            return                   # pinned by the first shard write
        if pos == self.shard_id:
            return
        from ..common.log import log_context
        log_context().log(
            "osd", 1,
            f"pg {self.pgid}: osd.{self.whoami} remapped shard "
            f"{self.shard_id} -> {pos}; re-recovering local objects")
        for oid, ver in self.object_vers().items():
            self.missing.add(oid, need=EVersion(*ver), have=ZERO)
        self.shard_id = pos
        self.persist_meta()

    # -- peering (primary drives GetInfo -> GetLog -> Activate) -------------
    def kick_peering(self) -> None:
        """Own the peering task on the PG (strong ref + retry)."""
        if self._peering_task is None or self._peering_task.done():
            self._peering_task = asyncio.ensure_future(self.peer())

    async def peer(self) -> None:
        """Run peering to completion.

        Retries for as long as this interval lasts: choosing an auth log
        from a PARTIAL set of replies would let a stale primary rewind a
        late peer's newer client-acked writes (the reference blocks
        peering on every unqueried up peer; an unreachable-but-up peer
        stalls peering until the mons mark it down, which starts a new
        interval and a fresh peering attempt)."""
        import random as _random
        epoch = self.osd.osdmap.epoch
        cfg = self.osd.config
        base = float(cfg.get("osd_peering_retry_base", 0.5))
        cap = float(cfg.get("osd_peering_retry_max", 8.0))
        jitter = float(cfg.get("osd_peering_retry_jitter", 0.25))
        attempt = 0
        while True:
            if (not self.is_primary()
                    or self.osd.osdmap.epoch != epoch):
                return       # a newer interval owns peering now
            try:
                # lint: disable=await-under-lock -- peering deliberately freezes the PG across its peer consultations: ops queue until the interval is established (the reference's peering interlock)
                async with self.lock:
                    await self._peer_locked()
                return
            except asyncio.CancelledError:
                raise
            except (ConnectionError, OSError, asyncio.TimeoutError,
                    KeyError, ValueError):
                # exponential backoff with jitter: N primaries retrying
                # a shared dead peer must not hammer it in lockstep
                delay = min(base * (2 ** attempt), cap)
                delay *= 1.0 + jitter * _random.random()
                attempt += 1
                await asyncio.sleep(delay)

    async def _await_acting_change(self,
                                   timeout: float | None = None) -> None:
        """WaitActingChange: a pg_temp override was requested; hold
        peering until the map reflecting it arrives (PeeringState.h:802
        -- queries are answered, I/O is not served).  The new map's
        update_mapping CANCELS this task, so running the full sleep
        always means the override never landed (mon unreachable) and
        the caller falls back to serving the interval itself."""
        if timeout is None:
            timeout = float(self.osd.config.get(
                "osd_wait_acting_change_timeout", 10.0))
        await asyncio.sleep(timeout)

    async def _peer_locked(self) -> None:
        epoch = self.osd.osdmap.epoch
        self._set_state("peering")
        self.peer_info.clear()
        self.peer_log_entries.clear()
        self.peer_missing.clear()
        # GetInfo: probe current + past-interval peers that are up
        targets = [o for o in self.past_intervals.probe_targets(self.acting)
                   if o != self.whoami and self.osd.osd_is_up(o)]
        replies = await self.osd.fanout_and_wait(
            [(o, "pg_query", {"pgid": self.pgid, "epoch": epoch}, [])
             for o in targets], collect=True, timeout=5)
        for rep in replies:
            osd_id = rep.data["from_osd"]
            self.peer_info[osd_id] = PGInfo.from_dict(rep.data["info"])
            self.peer_log_entries[osd_id] = [
                LogEntry.from_dict(e) for e in rep.data["entries"]]
        # every probe target that is still up MUST have answered before
        # an auth log is chosen -- a missing reply may hide the most
        # advanced history (PeeringState blocks on unqueried peers)
        unheard = [o for o in targets
                   if o not in self.peer_info and self.osd.osd_is_up(o)]
        if unheard:
            raise asyncio.TimeoutError(
                f"pg {self.pgid}: no GetInfo reply from up peers {unheard}")
        # GetLog: adopt the most advanced BACKFILL-COMPLETE history (a
        # mid-backfill peer's log was adopted wholesale, so its
        # last_update overstates what its data holds)
        candidates = [(self.whoami, self.info)] \
            if self.info.backfill_complete else []
        candidates += [(o, pi) for o, pi in self.peer_info.items()
                       if pi.backfill_complete]
        if not candidates:
            # Incomplete (PeeringState.h:1377): every reachable history
            # is mid-backfill -- no copy is known whole, and activating
            # from an overstated log would present missing objects as
            # present.  Hold I/O; the tick re-probes as peers come up
            # or the interval changes.
            self._set_state("incomplete")
            return
        best_osd, best_info = candidates[0]
        for osd_id, pinfo in candidates[1:]:
            if pinfo.last_update > best_info.last_update:
                best_osd, best_info = osd_id, pinfo
        if best_osd != self.whoami:
            primary_gap = (not self.log.overlaps(best_info)
                           or not self.info.backfill_complete)
            auth_entries = self.peer_log_entries[best_osd]
            if primary_gap:
                self.info.backfill_complete = False
                if (self.pool.can_shift_osds()
                        and self.acting == self.up
                        and best_info.backfill_complete):
                    # our data is gapped but a complete peer exists:
                    # hand it the primary role via pg_temp so clients
                    # are served at full speed while IT backfills US
                    # (OSDMonitor pg_temp / choose_acting semantics).
                    # WaitActingChange until the override lands -- the
                    # new interval cancels this task; a timeout means
                    # the mon never answered and we serve it ourselves
                    temp = [best_osd] + [o for o in self.up
                                         if o >= 0 and o != best_osd]
                    self.osd.request_pg_temp(self.pgid, temp)
                    self._set_state("wait_acting_change")
                    await self._await_acting_change()
                    self._set_state("peering")
            # a new interval cancels this peering task outright; if
            # the acting-change wait returned, the entries snapshot
            # still belongs to the interval being peered
            # lint: disable=await-invalidates-snapshot -- interval-scoped task
            divergent = self.log.merge(auth_entries, best_info, self.missing)
            self._log_dirty = True       # wholesale surgery: rewrite
            self._clean_divergent(divergent)
            self._reindex_reqids()
            self._sync_info_from_log()
            if primary_gap:
                # log-based recovery cannot bridge the trim gap: diff
                # the full object set against the auth peer by version
                await self._backfill_self(best_osd)
        # GetMissing: what does each acting peer need?
        auth_log = self.log
        self.backfill_targets.clear()
        self.backfill_info.clear()
        for osd_id in self.acting_peers():
            pinfo = self.peer_info.get(osd_id)
            if pinfo is None:
                continue
            if (pinfo.last_update < auth_log.tail
                    or not pinfo.backfill_complete):
                # peer's log cannot bridge: incremental cursor-driven
                # backfill.  The peer's persisted last_backfill is only
                # a valid resume point while its log still OVERLAPS the
                # auth log -- across a fresh trim gap, writes below the
                # cursor may hide in the lost window, so the scan must
                # restart (activate resets the peer's own copy the same
                # way)
                self.backfill_targets.add(osd_id)
                cursor = (pinfo.last_backfill
                          if (not pinfo.backfill_complete
                              and pinfo.last_update >= auth_log.tail)
                          else "")
                self.backfill_info[osd_id] = {
                    "cursor": cursor, "inflight": {}, "pushed": set(),
                    "dirty": set(), "done": False}
                self.peer_missing[osd_id] = MissingSet()
            else:
                self.peer_missing[osd_id] = PGLog.proc_replica_log(
                    pinfo, self.peer_log_entries.get(osd_id, []), auth_log)
        # WaitUpThru (PeeringState.h:1348): before the interval may
        # serve writes, the map must record our up_thru >= the interval
        # start -- otherwise a future peering could prune this interval
        # as never-active (maybe_went_rw false) and skip probing its
        # members, losing the writes we are about to accept
        if (self.osd.osdmap.get_up_thru(self.whoami)
                < self.info.same_interval_since):
            self._set_state("wait_up_thru")
            ok = await self.osd.ensure_up_thru(
                self.info.same_interval_since)
            if not ok:
                raise asyncio.TimeoutError(
                    f"pg {self.pgid}: up_thru not recorded")
            self._set_state("peering")
        # Activate: ship the authoritative log to the acting set
        self.info.last_epoch_started = epoch
        act_targets = [o for o in self.acting_peers()
                       if self.osd.osd_is_up(o)]
        acts = [(o, "pg_activate",
                 {"pgid": self.pgid, "epoch": epoch,
                  "info": self.info.to_dict(),
                  "entries": [e.to_dict() for e in self.log.entries]}, [])
                for o in act_targets]
        replies = await self.osd.fanout_and_wait(acts, collect=True,
                                                 timeout=5)
        acked = set()
        for rep in replies:
            osd_id = rep.data["from_osd"]
            acked.add(osd_id)
            replica_missing = MissingSet.from_dict(rep.data["missing"])
            if osd_id in self.backfill_targets:
                # the scan diff is the complete picture; the replica's
                # own view (auth-window objects only) folds into it
                self.peer_missing[osd_id].items.update(
                    replica_missing.items)
            else:
                self.peer_missing[osd_id] = replica_missing
        unacked = [o for o in act_targets
                   if o not in acked and self.osd.osd_is_up(o)]
        if unacked:
            raise asyncio.TimeoutError(
                f"pg {self.pgid}: no activate ack from up peers {unacked}")
        self._set_state("active")
        self._load_watchers()
        self.persist_meta()
        if (self.missing or any(self.peer_missing.values())
                or self.backfill_targets):
            self.kick_recovery()
        else:
            # nothing to recover: a leftover pg_temp override (e.g. the
            # target finished under a previous interval) clears here
            self._maybe_clear_pg_temp()

    def _internal_oid(self, oid: str) -> bool:
        from .snaps import INTERNAL_OIDS, is_clone
        return oid == META_OID or oid in INTERNAL_OIDS or is_clone(oid)

    def object_vers(self) -> dict[str, tuple[int, int]]:
        """oid -> stored version stamp for every object in this PG."""
        from .backend import VER_XATTR, ver_decode
        from .snaps import INTERNAL_OIDS
        out: dict[str, tuple[int, int]] = {}
        for oid in self.osd.store.list_objects(self.coll):
            if oid == META_OID or oid in INTERNAL_OIDS:
                continue
            out[oid] = ver_decode(
                self.osd.store.getattr(self.coll, oid, VER_XATTR))
        return out

    def scan_range(self, begin: str,
                   limit: int) -> tuple[dict[str, tuple[int, int]], bool]:
        """Bounded scan: up to ``limit`` objects with name > begin, in
        name order, plus an exhausted flag.  Keeps pg_scan messages and
        backfill working sets O(limit) instead of O(PG)."""
        from .backend import VER_XATTR, ver_decode
        # +1 as the exhaustion probe; META_OID may occupy one slot
        from .snaps import INTERNAL_OIDS
        names = [o for o in self.osd.store.list_objects_range(
            self.coll, begin, limit + 2)
            if o != META_OID and o not in INTERNAL_OIDS]
        batch = names[:limit]
        out = {oid: ver_decode(
            self.osd.store.getattr(self.coll, oid, VER_XATTR))
            for oid in batch}
        return out, len(names) <= limit

    async def _fetch_scan_page(
            self, osd_id: int, begin: str,
            limit: int) -> tuple[dict[str, tuple[int, int]], bool]:
        """One bounded scan page from a peer: ({oid: ver}, exhausted)."""
        replies = await self.osd.fanout_and_wait(
            [(osd_id, "pg_scan",
              {"pgid": self.pgid, "begin": begin, "limit": limit}, [])],
            collect=True, timeout=10)
        if not replies or replies[0].data.get("err"):
            raise asyncio.TimeoutError(f"pg_scan osd.{osd_id} failed")
        objs = {o: tuple(v)
                for o, v in replies[0].data["objects"].items()}
        return objs, bool(replies[0].data.get("exhausted", True))

    async def _fetch_scan(self, osd_id: int) -> dict[str, tuple[int, int]]:
        """Full peer scan, paged so every message stays O(SCAN_BATCH)."""
        out: dict[str, tuple[int, int]] = {}
        cursor = ""
        while True:
            objs, exhausted = await self._fetch_scan_page(
                osd_id, cursor, SCAN_BATCH)
            out.update(objs)
            if exhausted or not objs:
                return out
            cursor = max(objs)

    async def _backfill_self(self, auth_osd: int) -> None:
        """The PRIMARY's own data is gapped: pull-diff against the auth
        peer.  Objects with differing versions go to the missing set
        (recovered via the normal pull path); local extras are removed."""
        auth_objs = await self._fetch_scan(auth_osd)
        local = self.object_vers()
        for oid, ver in auth_objs.items():
            if local.get(oid) != ver:
                self.missing.add(oid, need=EVersion(*ver), have=ZERO)
        txn = Transaction()
        extras = [oid for oid in local if oid not in auth_objs]
        for oid in extras:
            txn.remove(self.coll, oid)
            self.missing.items.pop(oid, None)
        if extras:
            self.osd.store.queue_transaction(txn)
        self.persist_meta()

    def on_query(self) -> dict:
        return {"pgid": self.pgid, "info": self.info.to_dict(),
                "entries": [e.to_dict() for e in self.log.entries],
                "from_osd": self.whoami}

    async def on_activate(self, msg) -> dict:
        async with self.lock:
            auth_info = PGInfo.from_dict(msg.data["info"])
            auth_entries = [LogEntry.from_dict(e)
                            for e in msg.data["entries"]]
            if not self.log.overlaps(auth_info):
                # adopting the log wholesale across a trim gap: data is
                # NOT caught up until the primary's backfill finishes.
                # The gap also invalidates any existing backfill cursor:
                # writes to objects below it may hide in the lost log
                # window, so the scan must restart (an overlapping log
                # keeps the cursor -- that is the resume case).
                self.info.last_backfill = ""
                self.info.backfill_complete = False
            divergent = self.log.merge(auth_entries, auth_info,
                                       self.missing)
            self._log_dirty = True       # wholesale surgery: rewrite
            self._clean_divergent(divergent)
            self._reindex_reqids()
            self._sync_info_from_log()
            self.info.last_epoch_started = msg.data["epoch"]
            if not self.missing:
                self.info.last_complete = self.info.last_update
            self._set_state("replica_active")
            self.persist_meta()
            return {"pgid": self.pgid, "missing": self.missing.to_dict(),
                    "from_osd": self.whoami}

    def on_backfill_progress(self, cursor: str) -> dict:
        """The primary's backfill scan passed ``cursor``: persist it so
        an interrupted backfill resumes here instead of from scratch
        (PeeringState.h:1928 last_backfill update)."""
        if cursor > self.info.last_backfill:
            self.info.last_backfill = cursor
            self.persist_meta()
        return {"pgid": self.pgid, "from_osd": self.whoami}

    def on_backfill_done(self) -> dict:
        """Primary finished the backfill scan: our data now matches
        our (wholesale-adopted) log."""
        self.info.backfill_complete = True
        self.info.last_backfill = ""
        if not self.missing:
            self.info.last_complete = self.info.last_update
        self.persist_meta()
        return {"pgid": self.pgid, "from_osd": self.whoami}

    def _clean_divergent(self, divergent: list[LogEntry]) -> None:
        """Remove objects that exist locally only because of divergent
        (never-committed) creates."""
        if not divergent:
            return
        auth_oids = {e.oid for e in self.log.entries}
        txn = Transaction()
        removed = set()
        for e in divergent:
            if (not e.prior_version and e.oid not in auth_oids
                    and e.oid not in removed and not e.is_delete()):
                txn.remove(self.coll, e.oid)
                removed.add(e.oid)
        if removed:
            self.osd.store.queue_transaction(txn)

    # -- client op execution (primary) --------------------------------------
    async def do_op(self, msg, conn=None,
                    top=None) -> tuple[dict, list[bytes]]:
        """Run a client op once per reqid: a copy that arrives while an
        earlier copy of the same op is queued or running here (a resend)
        waits for that copy and answers with its result, and runs itself
        only if that copy failed or was cancelled."""
        rq = msg.data.get("reqid")
        reqid = (rq[0], rq[1]) if rq else None
        if reqid is None:
            return await self._execute_op(msg, conn, top)
        while (first := self._inflight_reqids.get(reqid)) is not None:
            DUP_REQIDS["inflight"] += 1
            if top is not None:
                top.event("waiting_for_first_copy")
            await asyncio.wait({first})
            if not first.cancelled() and first.exception() is None:
                data, segments = first.result()
                return dict(data), list(segments)
        mine = asyncio.get_running_loop().create_future()
        self._inflight_reqids[reqid] = mine
        try:
            result = await self._execute_op(msg, conn, top)
        except asyncio.CancelledError:
            mine.cancel()
            raise
        except BaseException as e:
            mine.set_exception(e)
            mine.exception()          # retrieved: a waiter may not come
            raise
        else:
            mine.set_result(result)
            return result
        finally:
            if self._inflight_reqids.get(reqid) is mine:
                del self._inflight_reqids[reqid]

    async def _execute_op(self, msg, conn=None,
                          top=None) -> tuple[dict, list[bytes]]:
        ops = unpack_mutations(msg.data["ops"], msg.segments)
        oid = msg.data["oid"]
        rq = msg.data.get("reqid")
        reqid = (rq[0], rq[1]) if rq else None
        snapc = msg.data.get("snapc")
        snapid = msg.data.get("snapid")
        if top is not None:
            top.event("queued_for_pg")
        commit: asyncio.Task | None = None
        # lint: disable=await-under-lock -- the deliberate remainder of the pipelined write spine: the COMMIT RTT is deferred past the region (the rule's original finding, fixed); what still awaits under the lock is read gathers (overlapping those is the ROADMAP read-path follow-up) and on-demand recovery of the op's own object (per-object blocking is correctness)
        async with self.lock:
            if top is not None:
                top.event("reached_pg")
            # per-(PG, object) completion ordering: an op may not
            # observe or extend an object whose earlier commit is
            # still in flight (the pipelined spine overlaps commits
            # ACROSS objects, never within one)
            await self._yield_to_commits(oid)
            if self.state != "active" or not self.is_primary():
                return ({"err": "ENOTPRIMARY", "state": self.state}, [])
            if reqid is not None and reqid in self._completed_reqids:
                # the client resent a write we already applied (its
                # reply was lost): acknowledge without re-applying
                DUP_REQIDS["completed"] += 1
                v = self._completed_reqids[reqid]
                return ({"results": [{"ok": True} for _ in ops],
                         "version": v.to_list(), "dup": True}, [])
            n_up = sum(1 for o in self.acting if o >= 0
                       and self.osd.osd_is_up(o))
            if n_up < self.pool.min_size:
                return ({"err": "EAGAIN",
                         "detail": f"acting {n_up} < min_size "
                                   f"{self.pool.min_size}"}, [])
            if self.missing.is_missing(oid):
                await self._recover_object(oid)
            for peer, ms in self.peer_missing.items():
                if ms.is_missing(oid) and self.osd.osd_is_up(peer) \
                        and self.should_send_to(peer, oid):
                    await self._push_object(peer, oid)
            # ops execute strictly in vector order (the reference runs
            # the vector through one ObjectContext): reads that follow
            # writes observe the accumulated pending state via an
            # overlay snapshot; all writes commit atomically at the end
            # snap reads resolve through the SnapSet to the clone that
            # froze the content live at that snap
            read_oid = oid
            if snapid:
                from .snaps import clone_oid, load_snapset, resolve_read
                ss = load_snapset(self.osd.store, self.coll, oid)
                target = resolve_read(ss, int(snapid))
                if target is None:
                    return ({"results": [{"err": "ENOENT"}
                                         for _ in ops]}, [])
                if target:
                    read_oid = clone_oid(oid, target)
            results: list[dict] = []
            segments: list[bytes] = []
            writes: list[dict] = []
            overlay: dict | None = None
            applied = 0
            for op in ops:
                name = op["op"]
                if name in READ_OPS:
                    # a degraded read that exhausted its bounded shard
                    # retries must ERROR (client sees EIO inside its
                    # deadline), never propagate and leave the op
                    # without a reply -- that is the wedged-read mode
                    try:
                        if writes:
                            if overlay is None:
                                overlay = await self._make_overlay(oid)
                            if applied < len(writes):
                                self._apply_overlay(overlay,
                                                    writes[applied:])
                                applied = len(writes)
                            r, seg = self._read_overlay_op(overlay, oid,
                                                           op)
                        else:
                            r, seg = await self._do_read_op(read_oid, op)
                    except (OSError, ConnectionError, TimeoutError,
                            asyncio.TimeoutError, RuntimeError,
                            ValueError) as e:
                        r, seg = {"err": "EIO", "detail": str(e)}, None
                    if seg is not None:
                        r["seg"] = len(segments)
                        segments.append(seg)
                    results.append(r)
                elif name in WRITE_OPS:
                    if snapid:
                        results.append({"err": "EROFS snap read context"})
                    else:
                        writes.append(op)
                        results.append({"ok": True})
                elif name in WATCH_OPS:
                    r = await self._do_watch_op(oid, op, msg, conn)
                    results.append(r)
                elif name in CALL_OPS:
                    # cls method: runs against the overlay so it reads
                    # earlier ops in the vector and its writes join the
                    # same atomic commit (ClassHandler / do_osd_ops CALL)
                    from . import cls as cls_mod
                    if overlay is None:
                        overlay = await self._make_overlay(read_oid)
                    if applied < len(writes):
                        self._apply_overlay(overlay, writes[applied:])
                        applied = len(writes)
                    try:
                        out = cls_mod.call(
                            self, oid, overlay, writes,
                            msg.from_name or "?", op.get("cls", ""),
                            op.get("method", ""), op.get("data", b""),
                            read_only_ctx=bool(snapid))
                        applied = len(writes)   # hctx applied its own
                        r = {"ok": True}
                        if out:
                            r["seg"] = len(segments)
                            segments.append(out)
                        results.append(r)
                    except cls_mod.ClsError as e:
                        # a failed cls method aborts the whole vector
                        # (negative return from the class method)
                        return ({"err": e.errno_name,
                                 "detail": e.detail}, [])
                    except Exception as e:
                        # malformed indata etc. must produce a reply,
                        # not a dead op the client retries to timeout
                        return ({"err": "EINVAL",
                                 "detail": f"cls: {type(e).__name__}: "
                                           f"{e}"}, [])
                else:
                    results.append({"err": f"EOPNOTSUPP {name}"})
            if writes:
                if top is not None:
                    top.event("started")
                try:
                    err, commit = await self._do_writes(oid, writes,
                                                        reqid,
                                                        snapc=snapc)
                except (OSError, ConnectionError, TimeoutError,
                        asyncio.TimeoutError, RuntimeError,
                        ValueError) as e:
                    # commit fan-out failed mid-flight: answer EAGAIN so
                    # the client RETRIES (reqid dedup absorbs a partial
                    # local apply) instead of timing out reply-less
                    err, commit = "EAGAIN", None
                    if top is not None:
                        top.event(f"write_failed: {e}")
                if top is not None:
                    top.event("commit_sent")
                if err:
                    return ({"err": err}, [])
                if commit is not None:
                    commit = self._chain_commit(oid, commit)
            ret = ({"results": results,
                    "version": self.info.last_update.to_list()}, segments)
        # the PG lock is free from here: the deferred commit's peer
        # round trip overlaps the NEXT op's gather/encode/store phases
        # (the pipelined write spine) -- client-visible semantics are
        # unchanged because the reply below still waits for the
        # commits, and _chain_commit keeps per-object order
        if commit is not None:
            err = await self._await_commit(commit, top)
            if err:
                return ({"err": err}, [])
        # notify ack-waits run OUTSIDE the PG lock (see _do_watch_op)
        for r in results:
            wait = r.pop("__wait", None)
            if wait is not None:
                await wait()
        return ret

    # -- pipelined commit ordering --------------------------------------------
    async def _yield_to_commits(self, oid: str) -> None:
        """Block until no deferred commit is pending for ``oid``.

        Entered and exited with the PG lock HELD, but the lock is
        RELEASED around the wait: holding it across the commit's peer
        round trip would re-serialize the whole PG on one object --
        exactly the await-under-lock failure mode the pipeline
        removes.  Loops because another op may slot a new commit for
        the same object between the wake-up and the re-acquire.  An op
        cancelled here leaves with the lock held all the same
        (``_reacquire``), so the caller's ``async with`` releases what
        it holds."""
        while True:
            gate = self._obj_commits.get(oid)
            if gate is None or gate.done():
                return
            self.lock.release()
            try:
                await asyncio.wait({gate})
            finally:
                await _reacquire(self.lock)

    def _chain_commit(self, oid: str, commit) -> asyncio.Task:
        """Per-(PG, object) completion ordering: this op's commit
        (a bare coroutine from the backend) resolves only after every
        earlier commit on the same object, so replies reach clients
        in version order even when the fan-outs themselves overlap.
        Called under the PG lock; the returned task runs to
        completion even if the op that awaits it is cancelled (the
        laggard healing inside must not be lost)."""
        prev = self._obj_commits.get(oid)

        async def _ordered():
            if prev is not None:
                # the earlier op consumes its own failure; prev only
                # ORDERS us here
                await asyncio.wait({prev})
            await commit

        task = asyncio.ensure_future(_ordered())

        def _cleanup(t: asyncio.Task) -> None:
            if self._obj_commits.get(oid) is t:
                del self._obj_commits[oid]
            if not t.cancelled():
                t.exception()    # consumed: the awaiting op reports it

        task.add_done_callback(_cleanup)
        self._obj_commits[oid] = task
        return task

    async def _await_commit(self, commit: asyncio.Task,
                            top=None) -> str | None:
        """Await a chained commit OUTSIDE the PG lock; the wait time
        is exactly the round trip the pipeline overlapped with other
        ops' prepare phases (counted as commit_overlap_ms)."""
        loop = asyncio.get_event_loop()
        t0 = loop.time()
        try:
            await commit
        except (OSError, ConnectionError, TimeoutError,
                asyncio.TimeoutError, RuntimeError, ValueError) as e:
            if top is not None:
                top.event(f"commit_failed: {e}")
            return "EAGAIN"
        finally:
            perf = getattr(self.osd, "perf_pipeline", None)
            if perf is not None:
                perf.inc("overlapped_commits")
                perf.inc("commit_overlap_ms",
                         int((loop.time() - t0) * 1000))
        if top is not None:
            top.event("commit_acked")
        return None

    async def drain_commits(self) -> None:
        """Wait for every pending deferred commit on this PG (scrub
        and other whole-PG readers quiesce the pipeline before
        comparing shard states).  Call WITHOUT the PG lock."""
        pending = [t for t in self._obj_commits.values()
                   if not t.done()]
        if pending:
            await asyncio.wait(pending)

    # -- pending-write overlay (in-order read-after-write) -------------------
    async def _make_overlay(self, oid: str) -> dict:
        exists = self.osd.store.exists(self.coll, oid) or \
            (not isinstance(self.backend, ReplicatedBackend)
             and await self.backend.object_size(oid) > 0)
        if not exists:
            return {"exists": False, "data": bytearray(),
                    "xattrs": {}, "omap": {}}
        data = bytearray(await self.backend.object_read(oid, 0, None))
        try:
            xattrs = dict(self.osd.store.getattrs(self.coll, oid))
        except FileNotFoundError:
            xattrs = {}
        return {"exists": True, "data": data, "xattrs": xattrs,
                "omap": dict(self.osd.store.omap_get(self.coll, oid))}

    def _apply_overlay(self, ov: dict, ops: list[dict]) -> None:
        for op in ops:
            name = op["op"]
            if name == "create":
                ov["exists"] = True
            elif name == "write":
                off, data = op.get("off", 0), op["data"]
                end = off + len(data)
                if len(ov["data"]) < end:
                    ov["data"].extend(b"\0" * (end - len(ov["data"])))
                ov["data"][off:end] = data
                ov["exists"] = True
            elif name == "writefull":
                ov["data"] = bytearray(op["data"])
                ov["exists"] = True
            elif name == "append":
                ov["data"].extend(op["data"])
                ov["exists"] = True
            elif name == "truncate":
                size = op["size"]
                if len(ov["data"]) < size:
                    ov["data"].extend(b"\0" * (size - len(ov["data"])))
                else:
                    del ov["data"][size:]
                ov["exists"] = True
            elif name == "zero":
                end = min(op["off"] + op["len"], len(ov["data"]))
                if end > op["off"]:
                    ov["data"][op["off"]:end] = b"\0" * (end - op["off"])
            elif name == "remove":
                ov.update(exists=False, data=bytearray(),
                          xattrs={}, omap={})
            elif name == "setxattr":
                ov["xattrs"][op["name"]] = bytes(op["value"])
                ov["exists"] = True
            elif name == "rmxattr":
                ov["xattrs"].pop(op["name"], None)
            elif name == "omap_set":
                ov["omap"].update({k: bytes(v)
                                   for k, v in op["kv"].items()})
                ov["exists"] = True
            elif name == "omap_rm":
                for k in op["keys"]:
                    ov["omap"].pop(k, None)
            elif name == "omap_clear":
                ov["omap"].clear()

    def _read_overlay_op(self, ov: dict, oid: str,
                         op: dict) -> tuple[dict, bytes | None]:
        name = op["op"]
        if name == "list":
            oids = {o for o in self.osd.store.list_objects(self.coll)
                    if not self._internal_oid(o)}
            (oids.add if ov["exists"] else oids.discard)(oid)
            return {"ok": True, "oids": sorted(oids)}, None
        if name == "stat":
            if not ov["exists"]:
                return {"err": "ENOENT"}, None
            return {"ok": True, "size": len(ov["data"])}, None
        if not ov["exists"]:
            return {"err": "ENOENT"}, None
        if name == "read":
            off = op.get("off", 0)
            ln = op.get("len")
            seg = bytes(ov["data"][off:] if ln is None
                        else ov["data"][off:off + ln])
            return {"ok": True, "len": len(seg)}, seg
        if name == "getxattr":
            v = (None if op["name"] in HIDDEN_XATTRS
                 else ov["xattrs"].get(op["name"]))
            if v is None:
                return {"err": "ENODATA"}, None
            return {"ok": True}, v
        if name == "getxattrs":
            return {"ok": True,
                    "attrs": {k: v.hex()
                              for k, v in ov["xattrs"].items()
                              if k not in HIDDEN_XATTRS}}, None
        if name == "omap_get":
            return {"ok": True,
                    "omap": {k: v.hex()
                             for k, v in ov["omap"].items()}}, None
        return {"err": f"EOPNOTSUPP {name}"}, None

    async def _do_read_op(self, oid: str,
                          op: dict) -> tuple[dict, bytes | None]:
        name = op["op"]
        exists = self.osd.store.exists(self.coll, oid) or \
            (not isinstance(self.backend, ReplicatedBackend)
             and await self.backend.object_size(oid) > 0)
        if name == "list":
            oids = [o for o in self.osd.store.list_objects(self.coll)
                    if not self._internal_oid(o)]
            return {"ok": True, "oids": sorted(oids)}, None
        if not exists and name != "stat":
            return {"err": "ENOENT"}, None
        if name == "read":
            data = await self.backend.object_read(
                oid, op.get("off", 0), op.get("len"))
            return {"ok": True, "len": len(data)}, bytes(data)
        if name == "stat":
            if not exists:
                return {"err": "ENOENT"}, None
            size = await self.backend.object_size(oid)
            return {"ok": True, "size": size}, None
        if name == "getxattr":
            v = (None if op["name"] in HIDDEN_XATTRS
                 else self.osd.store.getattr(self.coll, oid, op["name"]))
            if v is None:
                return {"err": "ENODATA"}, None
            return {"ok": True}, v
        if name == "getxattrs":
            attrs = self.osd.store.getattrs(self.coll, oid)
            return {"ok": True,
                    "attrs": {k: v.hex() for k, v in attrs.items()
                              if k not in HIDDEN_XATTRS}}, None
        if name == "omap_get":
            omap = self.osd.store.omap_get(self.coll, oid)
            return {"ok": True,
                    "omap": {k: v.hex() for k, v in omap.items()}}, None
        return {"err": f"EOPNOTSUPP {name}"}, None

    # -- watch/notify (Watch.cc) ---------------------------------------------
    WATCH_REGISTRY_OID = ".rados_watch_registry"

    async def _persist_watchers(self, oid: str) -> None:
        """Replicate this object's watcher set through the normal
        write path (PG log + repop), so the registry survives primary
        failover and travels with recovery/backfill like any object
        (the reference carries watchers in object_info_t)."""
        entries = [[cl, ck, w.get("addr")]
                   for (cl, ck), w in self.watchers.get(oid, {}).items()
                   if w.get("addr")]
        try:
            if entries:
                _, commit = await self._do_writes(
                    self.WATCH_REGISTRY_OID, [
                        {"op": "omap_set",
                         "kv": {oid: json.dumps(entries).encode()}}],
                    None)
            else:
                _, commit = await self._do_writes(
                    self.WATCH_REGISTRY_OID, [
                        {"op": "omap_rm", "keys": [oid]}], None)
            if commit is not None:
                await commit     # registry writes stay synchronous
        except (ConnectionError, OSError, asyncio.TimeoutError):
            pass              # next watch/unwatch rewrites the set

    def _load_watchers(self) -> None:
        """Activation: reload persisted registrations (conn-less; the
        notify path dials their stored addresses)."""
        try:
            omap = self.osd.store.omap_get(self.coll,
                                           self.WATCH_REGISTRY_OID)
        except Exception:
            return
        for oid, raw in omap.items():
            try:
                rows = json.loads(raw)
            except ValueError:
                continue
            slot = self.watchers.setdefault(oid, {})
            for cl, ck, addr in rows:
                slot.setdefault((cl, int(ck)),
                                {"conn": None, "addr": addr})

    async def _do_watch_op(self, oid: str, op: dict, msg,
                           conn) -> dict:
        name = op["op"]
        client = msg.from_name or "?"
        cookie = int(op.get("cookie", 0))
        if name == "watch":
            if conn is None:
                return {"err": "EINVAL watch needs a connection"}
            self.watchers.setdefault(oid, {})[(client, cookie)] = {
                "conn": conn, "addr": op.get("addr")}
            await self._persist_watchers(oid)
            return {"ok": True, "watchers": len(self.watchers[oid])}
        if name == "unwatch":
            self.watchers.get(oid, {}).pop((client, cookie), None)
            await self._persist_watchers(oid)
            return {"ok": True}
        if name == "list_watchers":
            live = {k: w for k, w in self.watchers.get(oid, {}).items()
                    if not getattr(w.get("conn"), "closed", False)
                    or w.get("addr")}
            self.watchers[oid] = live
            return {"ok": True,
                    "watchers": [[cl, ck] for cl, ck in live]}
        if name == "list_snaps":
            from .snaps import load_snapset
            ss = load_snapset(self.osd.store, self.coll, oid)
            return {"ok": True, "snapset": ss}
        if name == "notify":
            payload = bytes(op.get("data", b""))
            timeout = float(op.get("timeout", 5.0))
            targets = list(self.watchers.get(oid, {}).items())
            acks: list[list] = []
            missed: list[list] = []
            waiting = []
            dropped = False
            for (cl, ck), w in targets:
                nid = f"{self.pgid}:{oid}:{next(self.osd._notify_serial)}"
                fut = asyncio.get_event_loop().create_future()
                self.osd._notify_waiters[nid] = fut
                note = Message(
                    "watch_notify",
                    {"pool": self.pool.pool_id, "oid": oid,
                     "notify_id": nid, "cookie": ck},
                    segments=[payload])
                try:
                    wconn = w.get("conn")
                    if wconn is not None \
                            and not getattr(wconn, "closed", False):
                        await wconn.send(note)
                    elif w.get("addr"):
                        # failover-reloaded watcher: no live conn yet;
                        # dial the client's listening address
                        await self.osd.msgr.send(
                            tuple(w["addr"]), cl, note)
                    else:
                        raise ConnectionError("no path to watcher")
                    waiting.append(([cl, ck], nid, fut))
                except (ConnectionError, OSError):
                    self.osd._notify_waiters.pop(nid, None)
                    self.watchers.get(oid, {}).pop((cl, ck), None)
                    dropped = True
                    missed.append([cl, ck])
            if dropped:
                await self._persist_watchers(oid)
            # the ACK WAIT must not run under the PG lock: a watcher
            # whose callback writes to this PG would deadlock until the
            # timeout, and every client op would stall behind it.  The
            # caller awaits this after releasing the lock.
            result = {"ok": True, "acks": acks, "timeouts": missed}

            async def wait_acks():
                # one shared deadline, all watchers concurrently -- a
                # serial wait would stack timeouts per slow watcher
                if waiting:
                    await asyncio.wait([f for _, _, f in waiting],
                                       timeout=timeout)
                for who, nid, fut in waiting:
                    (acks if fut.done() else missed).append(who)
                    self.osd._notify_waiters.pop(nid, None)
            result["__wait"] = wait_acks
            return result
        return {"err": f"EOPNOTSUPP {name}"}

    # -- snap trim (SnapMapper.h:339 reverse index -> purge clones) ----------
    def kick_snap_trim(self, removed: list[int]) -> None:
        pending = sorted(set(int(s) for s in removed)
                         - self.trimmed_snaps)
        if not pending or not self.is_primary() \
                or self.state != "active":
            return
        if self._snap_trim_task is None or self._snap_trim_task.done():
            self._snap_trim_task = asyncio.ensure_future(
                self._snap_trim(pending))

    async def _snap_trim(self, snaps: list[int]) -> None:
        """Purge removed snaps: walk the SnapMapper rows, shrink clone
        coverage, delete clones nobody references.  All mutations ride
        normal log entries, so replicas trim in lockstep and recovery
        replays interrupted trims."""
        from .snaps import (
            SNAPMAPPER_OID, clone_oid, load_snapset, snapmapper_key)
        try:
            for sid in snaps:
                prefix = f"{sid:016x}/"
                rows = [k for k in self.osd.store.omap_get(
                    self.coll, SNAPMAPPER_OID) if k.startswith(prefix)]
                for key in rows:
                    head = key[len(prefix):]
                    # lint: disable=await-under-lock -- snap trim rewrites clones through the normal write path one object at a time; the background cadence tolerates the hold and a torn trim would corrupt the snapset
                    async with self.lock:
                        if self.state != "active" \
                                or not self.is_primary():
                            return
                        ss = load_snapset(self.osd.store, self.coll,
                                          head)
                        target = next((c for c in ss["clones"]
                                       if sid in c[1]), None)
                        muts = [{"op": "snapmap_rm", "keys": [key]}]
                        entry_oid = head
                        delete = False
                        if target is not None:
                            target[1].remove(sid)
                            entry_oid = clone_oid(head, target[0])
                            if not target[1]:
                                ss["clones"].remove(target)
                                muts.append({"op": "remove"})
                                delete = True
                        muts.append({"op": "snapset_set", "head": head,
                                     "value": json.dumps(ss)})
                        entry = LogEntry(
                            op=DELETE if delete else MODIFY,
                            oid=entry_oid,
                            version=EVersion(
                                self.osd.osdmap.epoch,
                                self.info.last_update.version + 1),
                            prior_version=ZERO, mutations=[],
                            reqid=None)
                        await self.backend.submit_transaction(entry,
                                                              muts)
                async with self.lock:
                    self.trimmed_snaps.add(sid)
                    self.persist_meta()
        except asyncio.CancelledError:
            pass
        except (ConnectionError, OSError, asyncio.TimeoutError):
            pass                    # re-kicked by the next tick

    # -- snapshots (snaps.py; SnapMapper.h:339, make_writeable) --------------
    async def _prepare_cow(self, oid: str, snapc: dict,
                           size: int) -> list[dict] | str:
        """Clone-on-write: the first mutation after a newer snap clones
        the head so the snap keeps its frozen content.  Returns the
        snapset-update mutations to ride with the write entry, or an
        error string."""
        from .backend import ReplicatedBackend
        from .snaps import clone_oid, load_snapset
        if not isinstance(self.backend, ReplicatedBackend):
            return "EOPNOTSUPP snapshots on erasure pools"
        ss = load_snapset(self.osd.store, self.coll, oid)
        seq = int(snapc.get("seq", 0))
        exists = self.osd.store.exists(self.coll, oid)
        # a stale client snapc may still list snaps that were removed
        # and trimmed -- cloning for them would leak untrimmable clones
        # (make_writeable filters against removed_snaps the same way)
        removed = set(getattr(self.pool, "removed_snaps", []))
        if exists and seq > ss["seq"]:
            newly = sorted(int(s) for s in snapc.get("snaps", [])
                           if int(s) > ss["seq"]
                           and int(s) not in removed)
            if newly:
                cid = newly[-1]
                centry = LogEntry(
                    op=MODIFY, oid=clone_oid(oid, cid),
                    version=EVersion(self.osd.osdmap.epoch,
                                     self.info.last_update.version + 1),
                    prior_version=ZERO, mutations=[], reqid=None)
                await self.backend.submit_transaction(
                    centry, [{"op": "clone_from", "src": oid,
                              "snaps": newly}])
                ss["clones"].append([cid, newly, size])
        if not exists:
            # created (or re-created after a delete) under this snap
            # context: snaps <= seq predate this incarnation, so reads
            # at them must not see the new head (deletion intervals)
            ss["born"] = max(ss.get("born", 0), seq)
        ss["seq"] = max(ss["seq"], seq)
        return [{"op": "snapset_set", "head": oid,
                 "value": json.dumps(ss)}]

    async def _do_writes(self, oid: str, ops: list[dict],
                         reqid: tuple[str, int] | None = None,
                         snapc: dict | None = None) -> tuple:
        """Resolve logical ops to offset-explicit mutations, append a log
        entry, run the backend transaction.

        Returns ``(err, commit)``: on the pipelined spine ``commit``
        is the deferred remote-commit Task (local apply + sub-op sends
        already happened; the caller awaits it OUTSIDE the PG lock),
        None on the serial chain or pure-local writes."""
        await self.wait_for_backfill_pushes(oid)
        size = await self.backend.object_size(oid)
        snap_muts: list[dict] = []
        if snapc and snapc.get("snaps"):
            got = await self._prepare_cow(oid, snapc, size)
            if isinstance(got, str):
                return got, None
            snap_muts = got
        muts: list[dict] = []
        is_delete = False       # tracks the FINAL state: remove followed
        for op in ops:          # by a recreate is a MODIFY, not a DELETE
            name = op["op"]
            if name == "create":
                muts.append({"op": "create"})
                is_delete = False
            elif name == "write":
                data = op["data"]
                muts.append({"op": "write", "off": op.get("off", 0),
                             "data": data})
                size = max(size, op.get("off", 0) + len(data))
                is_delete = False
            elif name == "writefull":
                data = op["data"]
                muts.append({"op": "truncate", "size": 0})
                muts.append({"op": "write", "off": 0, "data": data})
                size = len(data)
                is_delete = False
            elif name == "append":
                data = op["data"]
                muts.append({"op": "write", "off": size, "data": data})
                size += len(data)
                is_delete = False
            elif name == "truncate":
                muts.append({"op": "truncate", "size": op["size"]})
                size = op["size"]
                is_delete = False
            elif name == "zero":
                # reference semantics: zero never extends the object
                # (PrimaryLogPG CEPH_OSD_OP_ZERO truncates the range)
                zlen = min(op["len"], max(0, size - op["off"]))
                if zlen > 0:
                    muts.append({"op": "zero", "off": op["off"],
                                 "len": zlen})
            elif name == "remove":
                muts.append({"op": "remove"})
                is_delete = True
                size = 0
            elif name == "setxattr":
                if op["name"] in HIDDEN_XATTRS:
                    return f"EINVAL reserved xattr {op['name']}", None
                muts.append({"op": "setxattr", "name": op["name"],
                             "value": op["value"]})
                is_delete = False
            elif name == "rmxattr":
                if op["name"] in HIDDEN_XATTRS:
                    return f"EINVAL reserved xattr {op['name']}", None
                muts.append({"op": "rmxattr", "name": op["name"]})
            elif name == "omap_set":
                muts.append({"op": "omap_set", "kv": op["kv"]})
            elif name == "omap_rm":
                muts.append({"op": "omap_rm", "keys": op["keys"]})
            elif name == "omap_clear":
                muts.append({"op": "omap_clear"})
        muts += snap_muts
        prior = self.log.last_version_of(oid) or ZERO
        entry = LogEntry(
            op=DELETE if is_delete else MODIFY, oid=oid,
            version=EVersion(self.osd.osdmap.epoch,
                             self.info.last_update.version + 1),
            prior_version=prior, mutations=[], reqid=reqid)
        commit = await self.backend.submit_transaction(entry, muts)
        return None, commit

    # -- recovery -----------------------------------------------------------
    def kick_recovery(self) -> None:
        if self._recovery_task is None or self._recovery_task.done():
            self._recovery_task = asyncio.ensure_future(
                self._recovery_loop())

    def _recovery_pending(self) -> bool:
        return bool(self.missing) or any(
            ms and self.osd.osd_is_up(peer)
            for peer, ms in self.peer_missing.items()) or any(
            self.osd.osd_is_up(p) for p in self.backfill_targets)

    async def _recovery_loop(self) -> None:
        """Recover until clean; transient peer failures (reboots, races)
        back off and retry rather than abandoning recovery.

        Log-based pulls/pushes run directly; whole-PG backfill pushes
        take local + remote AsyncReserver slots first so a recovering
        cluster can't saturate every OSD at once (AsyncReserver.h,
        osd_max_backfills)."""
        try:
            for _ in range(60):
                if self.state != "active" or not self._recovery_pending():
                    break
                await self.osd.admit(OpClass.RECOVERY)
                try:
                    # lint: disable=await-under-lock -- log-based recovery deliberately blocks client ops for its round (the per-object interlock); whole-PG backfill runs OUTSIDE the lock below
                    async with self.lock:
                        for oid in list(self.missing.items):
                            await self._recover_object(oid)
                        if not self.missing:
                            if not self.info.backfill_complete:
                                self.info.backfill_complete = True
                                self.info.last_backfill = ""
                            self.info.last_complete = self.info.last_update
                        for peer, ms in list(self.peer_missing.items()):
                            if (not self.osd.osd_is_up(peer)
                                    or peer in self.backfill_targets):
                                continue
                            for oid in list(ms.items):
                                await self._push_object(peer, oid)
                    # backfill runs OUTSIDE the PG lock (it takes it
                    # per scan batch / payload read): client I/O to the
                    # PG proceeds between pushes instead of stalling for
                    # the whole round (PrimaryLogPG interleaves recovery
                    # with ops the same way, per-object blocking only)
                    await self._do_backfills()
                    self._maybe_clear_pg_temp()
                    async with self.lock:
                        self.persist_meta()
                except (ConnectionError, OSError, asyncio.TimeoutError,
                        ValueError):
                    pass
                if self._recovery_pending():
                    await asyncio.sleep(0.5)
        except asyncio.CancelledError:
            pass

    # -- incremental, cursor-driven backfill --------------------------------
    def should_send_to(self, peer: int, oid: str) -> bool:
        """Does a client write to ``oid`` go to ``peer``?

        Backfill targets only receive writes for objects the backfill
        has already covered (oid <= cursor, or pushed in the current
        batch); anything beyond the watermark is picked up when the
        scan reaches it (PrimaryLogPG's should_send_op / last_backfill
        check).  Non-targets always receive writes.

        SIDE EFFECT: a skip is recorded in the target's dirty set --
        the object may sit inside the batch window the scan already
        snapshotted (equal versions then, changed now), so the batch
        re-pushes dirty objects before advancing the cursor past them.
        """
        if peer not in self.backfill_targets:
            return True
        bi = self.backfill_info.get(peer)
        if bi is None:
            return False
        if bi["done"] or oid <= bi["cursor"] or oid in bi["pushed"]:
            return True
        bi["dirty"].add(oid)
        return False

    async def wait_for_backfill_pushes(self, oid: str) -> None:
        """Client writes to an object with an in-flight backfill push
        wait for the push: otherwise the pushed (old) content could land
        after the write's fan-out and resurrect stale bytes."""
        while True:
            evs = [bi["inflight"][oid]
                   for bi in self.backfill_info.values()
                   if oid in bi["inflight"]]
            if not evs:
                return
            for ev in evs:
                await ev.wait()

    @staticmethod
    def _push_payload(oid: str, payload: dict) -> tuple[dict, list]:
        """Wire form of a recovery/backfill payload (shared by push,
        backfill push and the pull reply -- one place owns the format).

        Every payload carries its integrity tag: the CRC of the data
        bytes and, for EC shards, the write-time shard id the bytes
        were encoded as.  The receiver verifies BOTH before applying
        (_apply_recovery_payload) -- a mislabeled or corrupt payload is
        rejected and retried, never silently installed."""
        from .backend import shard_crc
        data = {"oid": oid,
                "absent": payload.get("absent", False),
                "crc": shard_crc(payload["data"]),
                "xattrs": {k: v.hex()
                           for k, v in payload["xattrs"].items()},
                "omap": {k: v.hex()
                         for k, v in payload["omap"].items()}}
        if payload.get("shard") is not None:
            data["shard"] = int(payload["shard"])
        return data, [payload["data"]]

    async def _backfill_push(self, peer: int, oid: str) -> bool:
        """Push one object (or its absence) to a backfill target with
        the per-object interlock.  Returns True on ack."""
        bi = self.backfill_info[peer]
        try:
            shard = self._shard_of(peer)
        except ValueError:
            return False           # peer left the acting set; re-peered
        ev = asyncio.Event()
        try:
            # the lock is held ONLY to mark the interlock: no write is
            # mid-submit when the mark lands (writers hold the lock for
            # their whole submit), and later writers wait on the event.
            # The payload read itself -- a remote shard fanout for EC
            # pools -- runs without the lock so client I/O proceeds.
            async with self.lock:
                bi["inflight"][oid] = ev
            payload = await self.backend.read_recovery_payload(
                oid, shard)
            data, segs = self._push_payload(oid, payload)
            data["pgid"] = self.pgid
            replies = await self.osd.fanout_and_wait(
                [(peer, "pg_push", data, segs)],
                collect=True, timeout=10)
            if not replies or replies[0].data.get("err"):
                return False
            bi["pushed"].add(oid)
            ms = self.peer_missing.get(peer)
            if ms is not None:
                ms.items.pop(oid, None)
            return True
        finally:
            bi["inflight"].pop(oid, None)
            ev.set()

    async def _backfill_one(self, peer: int) -> None:
        """Advance one peer's backfill to completion in SCAN_BATCH
        batches.  The PG lock is held only for the local scan and each
        payload read -- client I/O proceeds between pushes."""
        bi = self.backfill_info[peer]
        while not bi["done"]:
            if not self.osd.osd_is_up(peer):
                raise asyncio.TimeoutError(f"osd.{peer} down mid-backfill")
            async with self.lock:
                local, local_done = self.scan_range(bi["cursor"],
                                                    SCAN_BATCH)
            remote, remote_done = await self._fetch_scan_page(
                peer, bi["cursor"], SCAN_BATCH)
            # compare only below the lowest exhausted bound; names above
            # it belong to the next batch
            bounds = ([] if local_done else [max(local)]) + \
                     ([] if remote_done else [max(remote)])
            bound = min(bounds) if bounds else None
            work_l = {o: v for o, v in local.items()
                      if bound is None or o <= bound}
            work_r = {o: v for o, v in remote.items()
                      if bound is None or o <= bound}
            todo = [o for o, v in work_l.items() if work_r.get(o) != v]
            todo += [o for o in work_r if o not in work_l]
            for oid in sorted(todo):
                if not await self._backfill_push(peer, oid):
                    raise asyncio.TimeoutError(
                        f"backfill push {oid} to osd.{peer} failed")
            # this task is the sole owner of its peer's
            # backfill_info record; a new interval cancels the task
            # before replacing the dict
            # lint: disable=await-invalidates-snapshot -- sole-owner cursor
            fallback = max(list(work_l) + list(work_r) + [bi["cursor"]])
            new_cursor = bound if bound is not None else fallback
            # drain writes that were skipped (log_only) while this batch
            # was in flight: their objects sit inside the window the
            # scan snapshotted, so the diff above missed them.  Repeat
            # until quiet -- pushes can race yet more writes in.
            while True:
                # the FINAL batch (bound None) drains everything: a
                # brand-new object past the last scanned name has no
                # later batch to catch it
                redo = sorted(o for o in bi["dirty"]
                              if bound is None or o <= new_cursor)
                if not redo:
                    break
                for oid in redo:
                    if not await self._backfill_push(peer, oid):
                        raise asyncio.TimeoutError(
                            f"backfill dirty push {oid} to osd.{peer} "
                            f"failed")
                    bi["dirty"].discard(oid)
            # no await between the quiet check and the cursor advance:
            # nothing can slip in below new_cursor
            bi["cursor"] = new_cursor
            bi["pushed"] = {o for o in bi["pushed"] if o > new_cursor}
            # dirty oids above the cursor are re-scanned by later
            # batches (their writes committed before those scans run)
            bi["dirty"] = {o for o in bi["dirty"] if o > new_cursor}
            if bound is None:
                bi["done"] = True
            replies = await self.osd.fanout_and_wait(
                [(peer, "pg_backfill_progress",
                  {"pgid": self.pgid, "cursor": new_cursor}, [])],
                collect=True, timeout=10)
            if not replies or replies[0].data.get("err"):
                raise asyncio.TimeoutError(
                    f"backfill progress to osd.{peer} failed")
        # the snap-index objects (snapsets/snapmapper omaps) mutate
        # without version stamps, so the scan diff cannot see their
        # divergence: push them unconditionally before declaring done
        from .snaps import INTERNAL_OIDS
        for ioid in sorted(INTERNAL_OIDS):
            if self.osd.store.exists(self.coll, ioid):
                await self._backfill_push(peer, ioid)
        replies = await self.osd.fanout_and_wait(
            [(peer, "pg_backfill_done", {"pgid": self.pgid}, [])],
            collect=True, timeout=10)
        if replies and not replies[0].data.get("err"):
            self.backfill_targets.discard(peer)
            pinfo = self.peer_info.get(peer)
            if pinfo is not None:
                pinfo.backfill_complete = True

    def _maybe_clear_pg_temp(self) -> None:
        """Every up member is complete: drop the pg_temp override so
        the CRUSH primary takes back over."""
        if (not self.backfill_targets and self.acting != self.up
                and self.osd.osdmap.pg_temp.get(self.pgid)
                and not self.missing
                and all(pi.backfill_complete
                        for o, pi in self.peer_info.items()
                        if o in self.up)):
            self.osd.request_pg_temp(self.pgid, [])

    async def _do_backfills(self) -> None:
        """Advance every backfill target under reservation slots
        (AsyncReserver.h / osd_max_backfills)."""
        for peer in list(self.backfill_targets):
            if not self.osd.osd_is_up(peer):
                continue
            if peer not in self.backfill_info:
                continue
            token = (self.pgid, peer)
            granted_remote = False
            try:
                await self.osd.local_reserver.request(token, timeout=10)
                replies = await self.osd.fanout_and_wait(
                    [(peer, "backfill_reserve",
                      {"pgid": self.pgid}, [])], collect=True, timeout=10)
                if not replies or not replies[0].data.get("granted"):
                    continue            # remote slot busy; next round
                granted_remote = True
                await self._backfill_one(peer)
            except asyncio.TimeoutError:
                continue                # retried next recovery round
            finally:
                self.osd.local_reserver.release(token)
                if granted_remote:
                    try:
                        await self.osd.fanout_and_wait(
                            [(peer, "backfill_release",
                              {"pgid": self.pgid}, [])],
                            collect=True, timeout=5)
                    except (ConnectionError, OSError,
                            asyncio.TimeoutError):
                        pass

    def _shard_of(self, osd_id: int) -> int:
        """Shard position ``osd_id`` SERVES in the current acting set.

        An OSD outside the acting set has no shard position; the seed's
        silent `return 0` here was the corruption amplifier -- recovery
        payloads and sub-op reads got labeled shard 0 and decoded as
        data they were not.  Raising turns that into a retryable error
        the caller's backoff absorbs (-1 holes are never valid inputs
        and never match)."""
        if osd_id >= 0 and osd_id in self.acting:
            return self.acting.index(osd_id)
        from ..common.log import log_context
        log_context().log(
            "osd", 1,
            f"pg {self.pgid}: osd.{osd_id} not in acting {self.acting}"
            f" -- no shard position")
        raise ValueError(
            f"pg {self.pgid}: osd.{osd_id} has no shard position in "
            f"acting {self.acting}")

    async def _recover_object(self, oid: str) -> None:
        """Pull the authoritative copy (our shard of it) from a peer."""
        if not self.missing.is_missing(oid):
            return
        need, _ = self.missing.items[oid]
        sources = [o for o, pi in self.peer_info.items()
                   if self.osd.osd_is_up(o)
                   and pi.last_update >= need
                   and pi.backfill_complete
                   and not self.peer_missing.get(
                       o, MissingSet()).is_missing(oid)]
        if not sources:
            return        # unfound; retried on next peering round
        payload = {"pgid": self.pgid, "oid": oid,
                   "shard": self._shard_of(self.whoami)}
        hedger = getattr(self.osd, "hedger", None)
        if hedger is not None and hedger.enabled and len(sources) > 1:
            # hedged pull: every listed source can serve this object,
            # so a straggling (or EIO-answering) source escalates to
            # the next one after the cohort's adaptive quantile
            # instead of eating the full timeout before the retry
            rep = await hedger.first_reply(
                sources, "pg_pull", payload, timeout=10,
                accept=lambda m: not m.data.get("err"))
            if rep is None:
                return              # no source ready; retried later
        else:
            replies = await self.osd.fanout_and_wait(
                [(sources[0], "pg_pull", payload, [])],
                collect=True, timeout=10)
            if not replies or replies[0].data.get("err"):
                return              # source not ready; retried later
            rep = replies[0]
        try:
            self._apply_recovery_payload(oid, rep.data, rep.segments)
        except ValueError:
            return      # mislabeled/corrupt payload: keep missing, retry
        self.missing.items.pop(oid, None)
        self.persist_meta()

    def _verify_recovery_payload(self, oid: str, data: dict,
                                 segments: list[bytes]) -> None:
        """Integrity gate on the recovery apply path: the payload's CRC
        tag must match its bytes, and an EC shard payload must be
        labeled with THE SHARD THIS OSD SERVES -- installing a
        mislabeled shard is exactly the degraded-read corruption.
        Raises ValueError; callers reply err / retry."""
        from .backend import ReplicatedBackend, shard_crc
        if data.get("absent"):
            return
        buf = segments[0] if segments else b""
        if data.get("crc") is not None \
                and shard_crc(buf) != int(data["crc"]):
            self._count_degraded("crc_mismatch")
            raise ValueError(
                f"pg {self.pgid}/{oid}: recovery payload crc mismatch "
                f"(got {shard_crc(buf)}, tagged {data['crc']})")
        if data.get("shard") is None \
                or isinstance(self.backend, ReplicatedBackend):
            return
        want = self._shard_of(self.whoami)
        if int(data["shard"]) != want:
            self._count_degraded("shard_mismatch")
            raise ValueError(
                f"pg {self.pgid}/{oid}: recovery payload is shard "
                f"{data['shard']}, but this OSD serves shard {want}")

    def _count_degraded(self, key: str) -> None:
        pc = getattr(self.backend, "perf_degraded", None)
        if pc is not None:
            pc.inc(key)

    def _apply_recovery_payload(self, oid: str, data: dict,
                                segments: list[bytes]) -> None:
        self._verify_recovery_payload(oid, data, segments)
        self.backend.invalidate_extents(oid)
        txn = Transaction()
        if data.get("absent"):
            txn.remove(self.coll, oid)
        else:
            buf = segments[0] if segments else b""
            txn.remove(self.coll, oid)
            txn.touch(self.coll, oid)
            txn.write(self.coll, oid, 0, buf)
            for k, v in data.get("xattrs", {}).items():
                txn.setattr(self.coll, oid, k, bytes.fromhex(v))
            omap = {k: bytes.fromhex(v)
                    for k, v in data.get("omap", {}).items()}
            if omap:
                txn.omap_setkeys(self.coll, oid, omap)
        self.osd.store.queue_transaction(txn)
        # an applied EC shard re-pins the PG identity (first write on a
        # fresh replica may arrive via recovery rather than a sub-write)
        if data.get("shard") is not None and self.shard_id is None:
            self.shard_id = int(data["shard"])

    async def on_pull(self, msg) -> tuple[dict, list[bytes]]:
        """Serve a recovery read: reconstruct the REQUESTER's shard."""
        oid = msg.data["oid"]
        shard = msg.data.get("shard", 0)
        try:
            payload = await self.backend.read_recovery_payload(oid,
                                                               shard)
        except (ConnectionError, OSError, asyncio.TimeoutError,
                ValueError) as e:
            # cannot assemble the shard right now: an ERROR reply lets
            # the puller back off and retry instead of timing out
            return ({"oid": oid, "err": "EIO", "detail": str(e)}, [])
        return self._push_payload(oid, payload)

    async def _push_object(self, peer: int, oid: str) -> None:
        ms = self.peer_missing.get(peer)
        if ms is None or not ms.is_missing(oid):
            return
        try:
            shard = self._shard_of(peer)
        except ValueError:
            return        # peer left the acting set; next peering drops it
        payload = await self.backend.read_recovery_payload(oid, shard)
        data, segs = self._push_payload(oid, payload)
        data["pgid"] = self.pgid
        replies = await self.osd.fanout_and_wait(
            [(peer, "pg_push", data, segs)], collect=True, timeout=10)
        if not replies or replies[0].data.get("err"):
            return                      # peer not ready; retried later
        # new peering rebuilds peer_missing wholesale; a pop on a
        # superseded missing-set mutates an orphaned object
        # lint: disable=await-invalidates-snapshot -- stale pop is harmless
        ms.items.pop(oid, None)

    async def on_push(self, msg) -> dict:
        async with self.lock:
            oid = msg.data["oid"]
            try:
                self._apply_recovery_payload(oid, msg.data,
                                             msg.segments)
            except ValueError as e:
                # mislabeled/corrupt payload: REFUSE it (the primary
                # keeps the object missing and retries) rather than
                # installing bytes that would decode as garbage
                return {"pgid": self.pgid, "oid": oid,
                        "err": "EBADPAYLOAD", "detail": str(e),
                        "from_osd": self.whoami}
            self.missing.items.pop(oid, None)
            if not self.missing:
                self.info.last_complete = self.info.last_update
            self.persist_meta()
            return {"pgid": self.pgid, "oid": oid,
                    "from_osd": self.whoami}
