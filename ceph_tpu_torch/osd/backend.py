"""PGBackend: replication fan-out vs erasure-coded shard I/O.

The SPI mirrors src/osd/PGBackend.cc:570 build_pg_backend — the pool
type selects ReplicatedBackend (primary-copy fan-out, MOSDRepOp) or
ECBackend (encode + per-shard sub-writes, MOSDECSubOpWrite; reads
gather minimum_to_decode shards and reconstruct, ECCommon.cc:597).

Mutations are resolved to concrete, offset-explicit ops at the primary
(append/writefull become plain writes) so replicas and shards apply
them deterministically — the same discipline as
PrimaryLogPG ops -> ObjectStore::Transaction translation.
"""

from __future__ import annotations

import asyncio

import numpy as np

from ..os.transaction import Transaction
from .ec_util import StripeInfo
from .types import LogEntry, MissingSet, ZERO

META_OID = "_pgmeta_"
SIZE_XATTR = "_size"
VER_XATTR = "_ver"     # per-object version stamp, "epoch,v" (object_info_t
                       # analog: lets readers reject stale shards and lets
                       # backfill diff object versions without log overlap)
SHARD_XATTR = "_shard"  # WRITE-TIME-PINNED shard id of the stored bytes
                        # (shard_id_t in the reference's ghobject): reads
                        # and recovery verify this label instead of
                        # trusting the OSD's CURRENT acting-set position,
                        # which changes across re-peering
CRC_XATTR = "_crc"      # CRC32C of the stored shard bytes (the per-shard
                        # hashinfo digest): rejects payloads/replies whose
                        # bytes don't match their claimed identity
HIDDEN_XATTRS = frozenset({SIZE_XATTR, VER_XATTR, SHARD_XATTR,
                           CRC_XATTR})               # never client-visible


def shard_crc(data) -> int:
    """CRC32C of shard bytes -- ONE polynomial everywhere (the same
    kernel the codec batcher, scrub and blockstore ride).  Pre-
    unification tags were zlib.crc32 (a different polynomial);
    shard_crc_matches() keeps those readable."""
    from ..ops.crc32c_batch import crc32c_batch
    return int(crc32c_batch([bytes(data)])[0])


def shard_crc_matches(data, tag, precomputed: int | None = None) -> bool:
    """Does a stored/reported ``_crc`` tag vouch for ``data``?

    Matches the unified CRC32C first (``precomputed`` lets batched
    verify paths pass a value they already hold).  On mismatch, ONE
    compat re-check against the pre-unification zlib.crc32 polynomial
    accepts tags stamped before the integrity pipeline unified -- a
    genuinely corrupt buffer pays the second hash only on the failure
    path, and the legacy acceptance is counted so it can be watched
    going to zero.
    """
    if tag is None:
        return True
    tag = int(tag)
    crc = shard_crc(data) if precomputed is None else int(precomputed)
    if crc == tag:
        return True
    import zlib
    if zlib.crc32(bytes(data)) & 0xFFFFFFFF == tag:
        from ..ops.crc32c_batch import PERF
        PERF.inc("legacy_crc_tags")
        return True
    return False


def ver_encode(version) -> bytes:
    return f"{version.epoch},{version.version}".encode()


def ver_decode(raw: bytes | None) -> tuple[int, int]:
    if not raw:
        return (0, 0)
    a, b = raw.decode().split(",")
    return (int(a), int(b))


# -- wire packing: JSON meta + binary segments ------------------------------

def pack_mutations(muts: list[dict]) -> tuple[list[dict], list[bytes]]:
    meta, segments = [], []
    for m in muts:
        m2 = dict(m)
        for key in ("data", "value"):
            if key in m2 and isinstance(m2[key], (bytes, bytearray,
                                                  np.ndarray)):
                buf = bytes(m2[key]) if not isinstance(
                    m2[key], np.ndarray) else m2[key].tobytes()
                m2[key] = {"seg": len(segments), "len": len(buf)}
                segments.append(buf)
        if "kv" in m2:
            kv = m2["kv"]
            buf = b"".join(
                len(k.encode()).to_bytes(4, "big") + k.encode()
                + len(v).to_bytes(4, "big") + bytes(v)
                for k, v in kv.items())
            m2["kv"] = {"seg": len(segments), "n": len(kv)}
            segments.append(buf)
        meta.append(m2)
    return meta, segments


def unpack_mutations(meta: list[dict],
                     segments: list[bytes]) -> list[dict]:
    out = []
    for m in meta:
        m2 = dict(m)
        for key in ("data", "value"):
            if isinstance(m2.get(key), dict):
                m2[key] = segments[m2[key]["seg"]]
        if isinstance(m2.get("kv"), dict):
            buf = segments[m2["kv"]["seg"]]
            kv, pos = {}, 0
            for _ in range(m2["kv"]["n"]):
                klen = int.from_bytes(buf[pos:pos + 4], "big"); pos += 4
                k = buf[pos:pos + klen].decode(); pos += klen
                vlen = int.from_bytes(buf[pos:pos + 4], "big"); pos += 4
                kv[k] = buf[pos:pos + vlen]; pos += vlen
            m2["kv"] = kv
        out.append(m2)
    return out


def apply_mutations(txn: Transaction, coll: str, oid: str,
                    muts: list[dict]) -> None:
    """Translate resolved logical mutations into Transaction ops."""
    for m in muts:
        op = m["op"]
        if op == "create":
            txn.touch(coll, oid)
        elif op == "write":
            txn.write(coll, oid, m["off"], m["data"])
        elif op == "truncate":
            txn.truncate(coll, oid, m["size"])
        elif op == "zero":
            txn.zero(coll, oid, m["off"], m["len"])
        elif op == "remove":
            txn.remove(coll, oid)
        elif op == "setxattr":
            txn.setattr(coll, oid, m["name"], m["value"])
        elif op == "rmxattr":
            txn.rmattr(coll, oid, m["name"])
        elif op == "omap_set":
            txn.omap_setkeys(coll, oid, m["kv"])
        elif op == "omap_rm":
            txn.omap_rmkeys(coll, oid, m["keys"])
        elif op == "omap_clear":
            txn.omap_clear(coll, oid)
        # -- snapshot machinery (ceph_tpu/osd/snaps.py): these ride in
        # the same entry as the data op so replicas stay in lockstep
        elif op == "clone_from":
            # clone-on-write: oid here is the CLONE object; src is the
            # head whose current state it freezes
            from .snaps import SNAPMAPPER_OID, snapmapper_key
            txn.clone(coll, m["src"], oid)
            txn.omap_setkeys(coll, SNAPMAPPER_OID,
                             {snapmapper_key(s, m["src"]): b""
                              for s in m.get("snaps", [])})
        elif op == "snapset_set":
            from .snaps import SNAPSETS_OID
            txn.touch(coll, SNAPSETS_OID)
            value = m["value"]
            if isinstance(value, str):
                value = value.encode()
            txn.omap_setkeys(coll, SNAPSETS_OID, {m["head"]: value})
        elif op == "snapmap_rm":
            from .snaps import SNAPMAPPER_OID
            txn.omap_rmkeys(coll, SNAPMAPPER_OID, m["keys"])
        else:
            raise ValueError(f"unknown mutation op {op}")


class PGBackend:
    """SPI both backends implement; `pg` provides log/info/persistence
    and `osd` provides peer RPC + the local store."""

    def __init__(self, pg) -> None:
        self.pg = pg
        self.osd = pg.osd
        # pipelined write spine: when on, submit_transaction
        # stages its sub-op sends through the per-peer coalescing pipe
        # and RETURNS the commit wait instead of awaiting it -- the PG
        # releases its lock before awaiting, so the next op's
        # gather/encode/store phases overlap this op's peer round
        # trip.  Snapshot at construction (hot-path-config-read).
        self._pipeline = self._cfg("osd_pipeline_enabled", True)

    def _cfg(self, name: str, default):
        cfg = getattr(self.osd, "config", None)
        if not isinstance(cfg, dict):
            return default
        return type(default)(cfg.get(name, default))

    @property
    def store(self):
        return self.osd.store

    @property
    def coll(self) -> str:
        return self.pg.coll

    def _queue_txn_traced(self, txn: Transaction, oid: str) -> None:
        """Commit the txn with a store.txn span when an op trace is
        active on this task (the client->OSD->store hop chain)."""
        from ..common.tracing import current_span, get_tracer
        cur = current_span.get()
        if cur is None:
            self.store.queue_transaction(txn)
            return
        sp = get_tracer(cur._tracer.daemon).start("store.txn", oid=oid)
        try:
            self.store.queue_transaction(txn)
        finally:
            sp.finish()

    async def submit_transaction(self, entry: LogEntry,
                                 muts: list[dict]) -> None:
        raise NotImplementedError

    async def object_read(self, oid: str, off: int,
                          length: int | None) -> bytes:
        raise NotImplementedError

    async def object_size(self, oid: str) -> int:
        raise NotImplementedError

    # recovery: full-object state transfer units
    async def read_recovery_payload(self, oid: str, shard: int) -> dict:
        raise NotImplementedError

    def invalidate_extents(self, oid: str | None = None) -> None:
        """Shard content changed outside the write path (recovery push,
        backfill, peering reset): drop any cached extents.  No-op for
        backends without a cache."""

    async def _fanout_commits(self, awaiting, entry: LogEntry) -> None:
        """All-commit fan-out with laggard healing.

        A peer that fails to ack inside the timeout has NOT applied the
        write but stays acting (nobody died, no re-peer).  Leaving it be
        is a time bomb: the object's data there is stale, and a later
        write that only stamps versions (the ranged RMW path) would make
        the staleness invisible.  The reference wedges the op until the
        laggard commits or is marked down (all_commit); this framework
        heals forward instead -- the laggard is recorded missing that
        object and recovery re-pushes the full object.  The op only
        ACKS when commits (local + acked peers) still reach the pool's
        min_size; below that the durability story is too thin and the
        error surfaces to the client."""
        if not awaiting:
            return
        replies = await self.osd.fanout_and_wait(awaiting, collect=True)
        self._heal_laggards(awaiting, replies, entry)

    def _heal_laggards(self, awaiting, replies, entry: LogEntry) -> None:
        """The all-commit accounting tail shared by the serial and
        pipelined fan-outs: record laggards missing, kick recovery,
        error below min_size."""
        acked = {r.data.get("from_osd") for r in replies}
        laggards = [t[0] for t in awaiting if t[0] not in acked]
        if not laggards:
            return
        for osd_id in laggards:
            ms = self.pg.peer_missing.setdefault(osd_id, MissingSet())
            ms.add(entry.oid, need=entry.version, have=ZERO)
        self.pg.kick_recovery()
        n_committed = 1 + len(acked)         # local shard + repliers
        if n_committed < self.pg.pool.min_size:
            raise TimeoutError(
                f"{entry.oid}: only {n_committed} commits < min_size "
                f"{self.pg.pool.min_size} (laggards {laggards})")

    def _start_commits(self, awaiting, entry: LogEntry):
        """Deferred all-commit fan-out, the pipelined half of
        ``_fanout_commits``: stage every sub-op send NOW -- staging is
        synchronous, so the per-peer wire order is the submit order
        (replica logs apply in version order) -- and return a Task
        that resolves when the commits land, with the same laggard
        healing and min_size semantics.  None when the pipeline is
        off (kill switch) or the coalescing pipe is not up."""
        pipe = getattr(self.osd, "subop_pipe", None)
        if not self._pipeline or pipe is None or pipe.closed:
            return None
        futs = self.osd.fanout_staged(awaiting)

        async def _commit():
            replies = await self.osd.await_staged(futs, collect=True)
            self._heal_laggards(awaiting, replies, entry)

        # a bare coroutine, not a task: PG._chain_commit wraps it in
        # the ONE per-write ordering task (two tasks per write is
        # measurable overhead on a saturated loop)
        return _commit()

    async def _commit_or_defer(self, awaiting, entry: LogEntry):
        """Serial chain (await the fan-out under the caller) or
        pipelined chain (return the commit wait for the PG to await
        OUTSIDE its lock).  The two paths share the send payloads and
        the healing tail; only WHERE the await happens differs.

        The staged sends deliberately ship from the pipe's per-peer
        workers, NOT inline here: an inline send runs under the PG
        lock, and a dead peer's reconnect backoff would hold the lock
        across it -- measured at 64 OSDs as the degraded phase
        collapsing into wedged ops (the serial chain's exact failure
        mode, reintroduced).  The one scheduling pass a worker costs
        is the price of keeping peer death out of the lock."""
        if not awaiting:
            return None
        commit = self._start_commits(awaiting, entry)
        if commit is None:
            await self._fanout_commits(awaiting, entry)
        return commit


def build_pg_backend(pg):
    """PGBackend.cc:570 — pool type picks the backend."""
    if pg.pool.is_erasure():
        return ECBackend(pg)
    return ReplicatedBackend(pg)


class ReplicatedBackend(PGBackend):
    async def submit_transaction(self, entry, muts) -> None:
        txn = Transaction()
        apply_mutations(txn, self.coll, entry.oid, muts)
        if not entry.is_delete():
            txn.setattr(self.coll, entry.oid, VER_XATTR,
                        ver_encode(entry.version))
        self.pg.append_log_and_meta(txn, entry)
        self._queue_txn_traced(txn, entry.oid)
        # fan out to every other acting replica and wait for all commits
        # (ReplicatedBackend.cc: all_commit before client reply).
        # Backfill targets beyond their last_backfill watermark get the
        # LOG ENTRY only (empty transaction): their data for that object
        # arrives when the backfill scan reaches it, but their log/
        # last_update must stay in step with the acting set.
        meta, segs = pack_mutations(muts)
        from ..common.tracing import current_span
        cur = current_span.get()
        tr = {"trace": cur.ctx()} if cur is not None else {}
        targets = []
        for o in self.pg.acting:
            if o < 0 or o == self.osd.whoami:
                continue
            if self.pg.should_send_to(o, entry.oid):
                targets.append((o, "rep_op",
                                {"pgid": self.pg.pgid,
                                 "entry": entry.to_dict(),
                                 "muts": meta, **tr}, segs))
            else:
                targets.append((o, "rep_op",
                                {"pgid": self.pg.pgid,
                                 "entry": entry.to_dict(),
                                 "muts": [], "log_only": True,
                                 **tr}, []))
        return await self._commit_or_defer(targets, entry)

    def apply_rep_op(self, entry: LogEntry, muts: list[dict],
                     log_only: bool = False) -> None:
        """Replica side: apply the primary's resolved mutations."""
        txn = Transaction()
        if not log_only:
            apply_mutations(txn, self.coll, entry.oid, muts)
            if not entry.is_delete():
                txn.setattr(self.coll, entry.oid, VER_XATTR,
                            ver_encode(entry.version))
        self.pg.append_log_and_meta(txn, entry)
        self._queue_txn_traced(txn, entry.oid)

    async def object_read(self, oid, off, length) -> bytes:
        return self.store.read(self.coll, oid, off, length)

    async def object_size(self, oid) -> int:
        st = self.store.stat(self.coll, oid)
        return 0 if st is None else st["size"]

    async def read_recovery_payload(self, oid, shard) -> dict:
        try:
            data = self.store.read(self.coll, oid, 0, None)
        except FileNotFoundError:
            return {"data": b"", "xattrs": {}, "omap": {},
                    "absent": True}
        return {"data": data,
                "xattrs": self.store.getattrs(self.coll, oid),
                "omap": self.store.omap_get(self.coll, oid)}


class ECBackend(PGBackend):
    """Erasure-coded object I/O over acting-set shards.

    Shard i of every object lives on acting[i] (shard id = position in
    the acting set, ErasureCodeInterface.h:39-78).  Writes that cover
    whole objects (fresh objects, truncate/remove chains, rewrites of
    every stripe) run full-object RMW: reconstruct current logical
    bytes, apply the mutation, re-encode, distribute per-shard
    sub-writes.  Partial overwrites of existing objects take the
    RMW pipeline (ECCommon.cc:704 start_rmw analog, _plan_rmw /
    _submit_partial below): only the touched stripes are read (the
    ExtentCache feeds repeats), merged, re-encoded and shipped as
    RANGED per-shard sub-writes — write amplification is
    O(touched stripes), not O(object)
    (tests/test_ec_rmw.py pins both the byte movement and this
    docstring's claim).

    Codec launches go through the per-OSD CodecBatcher
    (osd.codec_batcher): all stripes of an op share one
    encode_batch/decode_batch launch, and concurrent ops across PGs
    coalesce into common launches.  The batcher in turn launches
    coalesced batches through the sharded device mesh
    (parallel/mesh_codec.MeshCodec) when one is configured, so
    full-stripe writes, degraded-read decodes and recovery
    reconstructions all ride the multichip data plane transparently
    -- on a single device that is a 1-device mesh, same code path.
    """

    def __init__(self, pg) -> None:
        super().__init__(pg)
        profile = dict(pg.ec_profile)
        plugin = profile.pop("plugin", "cuda")
        from ..ec import registry
        from .ec_util import parse_stripe_unit
        from .extent_cache import ExtentCache
        # the codec runs on the OSD's device, passed beside the profile
        # (the profile is the map's, the same on every daemon)
        self.codec = registry().factory(
            plugin, profile, device=getattr(self.osd, "device", None))
        self.sinfo = StripeInfo.for_codec(
            self.codec, stripe_unit=parse_stripe_unit(
                self.codec, profile.get("stripe_unit", 4096)))
        self.cache = ExtentCache()
        # degraded-path observability (perf counter set "ec_degraded"):
        # reconstructions actually run, mislabeled/corrupt shards
        # rejected, gather retry rounds (None on bare-backend tests)
        perf = getattr(self.osd, "perf", None)
        self.perf_degraded = perf.create("ec_degraded") \
            if perf is not None else None
        # repair-I/O observability (perf counter set "ec_recovery"):
        # the bytes recovery actually gathers vs ships is the whole
        # point of the recovery-bandwidth-optimal codes -- chaos and
        # bench.py --recovery pin the per-code ratios on these instead
        # of trusting the repair-math claim
        self.perf_recovery = perf.create("ec_recovery") \
            if perf is not None else None
        # hot-path config SNAPSHOT (the ROADMAP config-reads-on-hot-
        # paths item): _gather_shards runs per degraded read; looking
        # these up per call put a dict probe chain on the read path
        self._read_retries = self._cfg("osd_ec_read_retries", 3)
        self._read_timeout = self._cfg("osd_ec_read_timeout", 5.0)
        self._read_backoff = self._cfg("osd_ec_read_backoff", 0.25)
        # device-resident shard cache (os/device_cache.py): full-shard
        # reads, ranged RMW slices, scrub verifies and the write-path
        # identity stamp all serve from residency instead of
        # round-tripping the store.  None in bare tests / when disabled.
        self.dcache = getattr(self.osd, "shard_cache", None)
        # partial-stripe writes delta-update parity in place
        # (MeshCodec.rmw / CodecBatcher.rmw) instead of re-encoding
        # whole stripes; snapshot, never read per write
        self._rmw_delta = self._cfg("osd_ec_rmw_delta_enabled", True)
        # straggler-tolerant gathers: the OSD-wide HedgedGather engine
        # (osd/hedged_gather.py) + per-peer latency EWMA.  None on bare
        # test backends -- every hedged path degrades to the legacy
        # fixed fanout.
        self.hedger = getattr(self.osd, "hedger", None)
        # regenerating-code repair fragments (the pmsr plugin): helpers
        # ship beta-sized COMPUTED sub-chunks instead of full chunks;
        # snapshot the gate and the stripe geometry the fragment
        # algebra reshapes at (hot-path-config-read discipline)
        self._frag_repair = self._cfg("osd_ec_repair_fragments_enabled",
                                      True)
        if hasattr(self.codec, "set_fragment_chunk_size"):
            self.codec.set_fragment_chunk_size(self.sinfo.chunk_size)

    def _count(self, key: str, by: int = 1) -> None:
        if self.perf_degraded is not None:
            self.perf_degraded.inc(key, by)

    def _rcount(self, key: str, by: int = 1) -> None:
        if self.perf_recovery is not None:
            self.perf_recovery.inc(key, by)

    @property
    def batcher(self):
        """The OSD-wide codec aggregation stage (None in bare tests)."""
        return getattr(self.osd, "codec_batcher", None)

    def _log_only_subop(self, osd: int, shard: int, entry: LogEntry):
        """ec_subop_write carrying only the log entry (backfill target
        beyond its watermark)."""
        return (osd, "ec_subop_write",
                {"pgid": self.pg.pgid, "oid": entry.oid, "shard": shard,
                 "entry": entry.to_dict(), "w": {"log_only": True},
                 "attr_muts": []}, [])

    @property
    def k(self) -> int:
        return self.sinfo.k

    def my_shard(self) -> int:
        """This OSD's shard position in the CURRENT acting set.  The
        PG-pinned shard_id (write-time identity) normally agrees; when
        they diverge the PG has been remapped and pg._check_shard_identity
        already queued the local objects for re-recovery."""
        return self.pg.acting.index(self.osd.whoami)

    def shard_label(self, oid: str) -> int | None:
        """The WRITE-TIME shard id of the locally stored bytes: the
        per-object pin first, the PG-level pin as fallback for objects
        predating per-object stamps, else the current acting position."""
        raw = self.store.getattr(self.coll, oid, SHARD_XATTR)
        if raw is not None:
            try:
                return int(raw)
            except ValueError:
                pass
        if self.pg.shard_id is not None:
            return self.pg.shard_id
        try:
            return self.my_shard()
        except ValueError:
            return None

    def invalidate_extents(self, oid: str | None = None) -> None:
        if oid is None:
            self.cache.clear()
        else:
            self.cache.invalidate(oid)

    # -- logical object reconstruction --------------------------------------
    def _local_entry(self, oid: str,
                     rng: tuple[int, int] | None = None):
        """(buf, size, ver, label, crc, cached) for my shard; absent
        -> (b'', 0, (0,0), ..., False).

        ``rng`` = (chunk_off, chunk_len) reads only that slice of the
        shard (the partial-stripe RMW read phase).  The device-resident
        cache serves full reads AND ranged slices without touching the
        store; misses read through the store's checksum-on-read path
        and (full reads) populate the cache so scrub re-verifies and
        repeat degraded reads hit.  ``cached`` marks content that was
        verified at fill/write time and needs no CRC re-hash."""
        cache = self.dcache
        if cache is not None:
            e = cache.get(self.coll, oid)
            if e is not None:
                buf = e.buf if rng is None \
                    else e.buf[rng[0]:rng[0] + rng[1]]
                return buf, e.size, e.ver, e.shard, e.crc, True
        off, length = rng if rng else (0, None)
        try:
            raw = self.store.read(self.coll, oid, off, length)
        except FileNotFoundError:
            raw = b""
        sx = self.store.getattr(self.coll, oid, SIZE_XATTR)
        size = int(sx) if sx else 0
        ver = ver_decode(self.store.getattr(self.coll, oid, VER_XATTR))
        label = self.shard_label(oid)
        crc_raw = self.store.getattr(self.coll, oid, CRC_XATTR)
        crc = int(crc_raw) if crc_raw is not None else None
        buf = np.frombuffer(raw, np.uint8)
        if cache is not None:
            cache.note_host_read(len(raw))
            if rng is None and (raw or size):
                # read-through fill: content just came through the
                # store's verified read path, with its identity xattrs
                cache.put(self.coll, oid, buf, size=size, ver=ver,
                          shard=label, crc=crc)
        return buf, size, ver, label, crc, False

    def _label_ok(self, shard: int, label, buf, ver) -> bool:
        """Is a stored/reported shard label consistent with serving
        position ``shard``?  Absent objects (no version, no bytes) are
        consistent everywhere; an explicit mismatched label means the
        bytes were written AS a different shard -- decoding them under
        this position is the mislabeling corruption, so the source is
        rejected instead."""
        if tuple(ver) == (0, 0) and not len(buf):
            return True
        return label is None or int(label) == shard

    def _entry_from_reply(self, rep, default_shard: int | None = None
                          ) -> tuple:
        """An ec_subop_read reply as a gather entry: (shard, label,
        crc, buf, size, ver, trusted)."""
        s = rep.data.get("req_shard", rep.data.get("shard",
                                                   default_shard))
        buf = np.frombuffer(
            rep.segments[0] if rep.segments else b"", np.uint8)
        return (s, rep.data.get("shard"), rep.data.get("crc"), buf,
                rep.data.get("size", 0),
                tuple(rep.data.get("ver", (0, 0))), False)

    def _admit_entries(self, entries: list[tuple],
                       rng: tuple[int, int] | None,
                       out: dict, failed: set,
                       relabeled: dict) -> set[int]:
        """Verify one batch of gathered entries into the caller's
        (out, failed, relabeled) state; returns the accepted shards.

        Whole-shard fetches verify their CRC tags in ONE batched pass
        over the batch (the hot read path used to re-hash each reply
        with its own scalar host call); cache-resident buffers were
        verified when they became resident and skip the re-hash
        entirely -- deep scrub re-checks them on its cadence."""
        have: dict[int, int] = {}
        if rng is None:
            idx = [i for i, e in enumerate(entries) if not e[6]]
            if idx:
                from ..ops.crc32c_batch import crc32c_batch
                crcs = crc32c_batch([entries[i][3] for i in idx])
                have = {i: int(c) for i, c in zip(idx, crcs)}
        accepted: set[int] = set()
        for i, (s, label, crc, buf, size, ver,
                trusted) in enumerate(entries):
            hv = have.get(i)
            if not self._label_ok(s, label, buf, ver):
                self._count("shard_mismatch")
                failed.add(s)
                # CRC-verified bytes under their OWN label are salvage,
                # not garbage (ranged reads can't re-check the whole-
                # shard crc; the label xattr alone vouches there)
                if label is not None and int(label) >= 0 and \
                        (rng is not None or crc is None or trusted
                         or shard_crc_matches(buf, crc,
                                              precomputed=hv)):
                    relabeled.setdefault(int(label), (buf, size, ver))
                continue
            if rng is None and crc is not None and not trusted \
                    and not shard_crc_matches(buf, crc,
                                              precomputed=hv):
                self._count("crc_mismatch")
                failed.add(s)
                continue
            out[s] = (buf, size, ver)
            accepted.add(s)
        return accepted

    async def _fetch_shards(self, oid: str, shards: list[int],
                            avail: dict[int, int],
                            rng: tuple[int, int] | None = None,
                            timeout: float = 10.0, *,
                            want: set[int] | None = None,
                            have: frozenset = frozenset(),
                            rejected: frozenset = frozenset()
                            ) -> tuple[dict, set[int], dict]:
        """Fetch several shards' (buf, size, ver) in ONE parallel pass
        (the hot read path: serial round trips would multiply latency
        by k).

        With ``want`` given (and the OSD's HedgedGather enabled), the
        remote sub-reads are HEDGED: issued individually, a hedge
        timer armed off the per-peer latency EWMA's adaptive quantile,
        extra shards requested on fire, and the gather completed on
        the FIRST verified sufficient set -- a straggling source is
        decoded around instead of awaited.  Without ``want`` (ranged
        RMW parity fetches, bare-test backends) the legacy fixed
        fanout runs.

        Returns (fetched, failed, relabeled): a shard lands in
        ``failed`` when its source did not answer inside ``timeout``
        (and the gather still needed it), reported a mismatched
        write-time shard label, or returned bytes that fail the CRC
        tag -- the caller excludes those sources and re-plans, so a
        dead or mislabeled source can never wedge or corrupt a read.
        A sub-read cancelled because the gather already held a
        sufficient set is NOT failed: its source is merely slow.  A
        mismatched source whose bytes verify under their OWN label
        goes into ``relabeled`` keyed by that label: a remapped OSD's
        old-shard bytes are still perfectly good data for the shard
        they WERE, and using them is what lets reads and recovery
        converge while relocation is in flight."""
        out: dict[int, tuple] = {}
        failed: set[int] = set()
        relabeled: dict[int, tuple] = {}
        # (shard, label, crc, buf, size, ver, trusted); trusted marks
        # cache-resident content verified at fill/write time
        entries: list[tuple] = []
        remote = []
        for s in shards:
            if avail[s] == self.osd.whoami:
                buf, size, ver, label, crc, cached = \
                    self._local_entry(oid, rng)
                entries.append((s, label, crc, buf, size, ver, cached))
            else:
                remote.append(s)
        self._admit_entries(entries, rng, out, failed, relabeled)
        if not remote:
            return out, failed, relabeled
        hedger = self.hedger
        if want is not None and hedger is not None and hedger.enabled:
            await self._fetch_remote_hedged(
                oid, remote, avail, rng, timeout, set(want),
                set(have), set(rejected), out, failed, relabeled)
        else:
            await self._fetch_remote_fanout(
                oid, remote, avail, rng, timeout, out, failed,
                relabeled)
        return out, failed, relabeled

    async def _fetch_remote_fanout(self, oid, remote, avail, rng,
                                   timeout, out, failed,
                                   relabeled) -> None:
        """Legacy fixed fan-out: one parallel wait for every reply."""
        payload = {"pgid": self.pg.pgid, "oid": oid}
        if rng is not None:
            payload["off"], payload["len"] = rng
        replies = await self.osd.fanout_and_wait(
            [(avail[s], "ec_subop_read", {**payload, "shard": s}, [])
             for s in remote],
            collect=True, timeout=timeout)
        # same sub-read accounting as the hedged path, so a hedged-vs-
        # unhedged comparison (bench.py --straggler's extra-bytes gate)
        # reads one counter set either way
        if self.hedger is not None:
            self.hedger.note("subreads", len(remote))
            self.hedger.note("subread_bytes",
                             sum(len(seg) for rep in replies
                                 for seg in rep.segments))
        entries = []
        for rep in replies:
            e = self._entry_from_reply(rep)
            if e[0] is None or e[0] not in remote:
                continue
            entries.append(e)
        self._admit_entries(entries, rng, out, failed, relabeled)
        failed |= {s for s in remote
                   if s not in out and s not in failed}

    async def _fetch_remote_hedged(self, oid, remote, avail, rng,
                                   timeout, want, have, rejected,
                                   out, failed, relabeled) -> None:
        """First-k-of-(k+h) remote gather through the OSD's
        HedgedGather engine.

        Sufficiency re-plans ``minimum_to_decode`` over everything
        verified so far (prior rounds + this one + relabeled salvage),
        so a late-set switch -- the hedged parity shard arriving
        before a straggling data shard -- completes the gather with a
        DIFFERENT set than originally planned; the decode-repair-
        matrix cache makes that switch cheap downstream.  Hedge extras
        are chosen by ``minimum_to_decode_with_cost`` with per-peer
        EWMA costs (in-hand shards cost zero, outstanding stragglers
        carry a lateness penalty), which preserves the LRC plugin's
        locality preference."""
        hedger = self.hedger
        tracker = hedger.tracker
        payload = {"pgid": self.pg.pgid, "oid": oid}
        if rng is not None:
            payload["off"], payload["len"] = rng

        def sub(s):
            return (avail[s], "ec_subop_read", {**payload, "shard": s})

        plan = {s: sub(s) for s in remote}
        pool = {s: sub(s) for s in avail
                if s not in remote and s not in have
                and s not in rejected
                and avail[s] != self.osd.whoami}
        pending_entries: list[tuple] = []

        def on_reply(s, msg):
            if msg is None:                  # send failure: dead peer
                failed.add(s)
                return
            pending_entries.append(
                self._entry_from_reply(msg, default_shard=s))

        def flush():
            if pending_entries:
                self._admit_entries(pending_entries, rng, out, failed,
                                    relabeled)
                pending_entries.clear()

        def sufficient():
            flush()
            usable = have | set(out) | set(relabeled)
            try:
                plan2 = set(self.codec.minimum_to_decode(want, usable))
            except Exception:
                return False
            return plan2 if plan2 <= usable else False

        default_s = hedger.delay_max
        late_penalty = int(1e6 * hedger.delay_max) + 1

        def choose_extras(h):
            flush()
            in_hand = have | set(out) | set(relabeled)
            costs = {s: 0 for s in in_hand}
            for s in plan:
                if s not in costs and s not in failed:
                    # outstanding and already late relative to the
                    # cohort quantile: costlier than any fresh source
                    costs[s] = tracker.cost_us(avail[s], default_s) \
                        + late_penalty
            for s in pool:
                if s not in costs:
                    costs[s] = max(
                        1, tracker.cost_us(avail[s], default_s))
            try:
                cheap = set(self.codec.minimum_to_decode_with_cost(
                    set(want), costs))
            except Exception:
                return {}
            picks = sorted(s for s in cheap if s in pool)[:h]
            return {s: pool[s] for s in picks}

        outcome = await hedger.gather_shards(
            plan, on_reply=on_reply, sufficient=sufficient,
            hedge_pool=pool, choose_extras=choose_extras,
            timeout=timeout)
        flush()
        if not outcome.completed:
            # sources that never answered (and were still needed) are
            # failures for the caller's re-plan; cancelled sub-reads
            # of a COMPLETED gather never land here
            failed |= {s for s in outcome.timed_out if s not in out}
            failed |= {s for s in remote
                       if s not in out and s not in failed
                       and s not in outcome.cancelled}

    async def _gather_shards(self, oid: str,
                             need_shards: set[int] | None = None,
                             rng: tuple[int, int] | None = None,
                             exclude: set[int] | None = None
                             ) -> tuple[dict[int, np.ndarray], int]:
        """Read enough CONSISTENT shard buffers to decode.

        A shard OSD that missed the object (recovering peer, stale
        incarnation) must not contribute zero-fill as if it were data --
        decoding from it silently corrupts the reconstruction (the
        reference gates shard reads on peer_missing / object versions).
        Every shard write stamps VER_XATTR; here only shards carrying the
        newest version seen participate, and minimum_to_decode is re-run
        over the survivors when a shard is rejected.
        """
        acting = self.pg.acting
        avail: dict[int, int] = {}           # shard -> osd
        for shard, osd in enumerate(acting):
            if osd >= 0 and self.osd.osd_is_up(osd) \
                    and (exclude is None or shard not in exclude):
                avail[shard] = osd
        want = set(need_shards
                   or self.sinfo.data_positions(self.codec))
        if not want <= set(avail):
            self._count("degraded_reads")    # a decode must reconstruct
        retries = self._read_retries
        timeout = self._read_timeout
        backoff = self._read_backoff
        fetched: dict[int, tuple[np.ndarray, int, tuple]] = {}
        rejected: set[int] = set()
        # bounded: staleness can reject at most len(acting) shards and
        # transient fetch failures get `retries` extra rounds -- beyond
        # that the read ERRORS instead of wedging (the seed's unbounded
        # wait turned one dead source into a hung client read)
        for attempt in range(retries + len(acting) + 1):
            # what's already verified in hand (including relabeled
            # salvage from remapped holders) counts as available
            usable = (set(avail) | set(fetched)) - rejected
            try:
                plan = set(self.codec.minimum_to_decode(want, usable))
            except Exception as e:
                raise IOError(
                    f"EIO {oid}: cannot decode shards {sorted(want)} "
                    f"from {sorted(usable)}") from e
            to_fetch = sorted(s for s in plan - set(fetched)
                              if s in avail)
            got, failed, relabeled = await self._fetch_shards(
                oid, to_fetch, avail, rng, timeout, want=want,
                have=frozenset(fetched), rejected=frozenset(rejected))
            fetched.update(got)
            for label, item in relabeled.items():
                # direct position-keyed fetches take precedence over
                # salvage; salvage never overwrites either
                fetched.setdefault(label, item)
            rejected |= failed
            # decodable from what's in hand?  A hedged fetch may have
            # completed with a DIFFERENT sufficient set than the
            # pre-fetch plan (the late-set switch), so re-plan over the
            # fetched set instead of insisting on the original one.
            try:
                plan2 = set(self.codec.minimum_to_decode(
                    want, set(fetched)))
            except Exception:
                plan2 = None
            if plan2 is None or not plan2 <= set(fetched):
                # insufficient: THIS is the only path into the retry/
                # backoff ladder.  A gather already holding a
                # sufficient set can therefore never ALSO schedule a
                # retry round -- hedging does not multiply with
                # osd_ec_read_retries (the combined sub-read bound is
                # pinned in tests/test_hedged_reads.py).
                self._count("gather_retries")
                if backoff > 0 and attempt < retries:
                    await asyncio.sleep(min(backoff * (2 ** attempt),
                                            2.0))
                continue                     # re-plan around the losses
            vers = {s: fetched[s][2] for s in plan2}
            newest = max(vers.values())
            stale = {s for s, v in vers.items() if v < newest}
            if not stale:
                bufs = {s: fetched[s][0] for s in plan2}
                size = max((fetched[s][1] for s in plan2), default=0)
                # ranged reads must pad every shard to the full range so
                # decode sees aligned slices (a short read = the shard
                # file ends inside the range; logical zeros beyond)
                shard_len = (rng[1] if rng is not None else
                             max((len(b) for b in bufs.values()),
                                 default=0))
                for s, b in list(bufs.items()):
                    if len(b) < shard_len:
                        nb = np.zeros(shard_len, np.uint8)
                        nb[:len(b)] = b
                        bufs[s] = nb
                return bufs, size, newest
            rejected |= stale
            for s in stale:
                fetched.pop(s, None)
        self._count("gather_failures")
        raise IOError(
            f"EIO {oid}: no consistent shard set "
            f"(rejected {sorted(rejected)})")

    async def _read_logical(self, oid: str) -> bytes:
        bufs, size, _ = await self._gather_shards(oid)
        if not bufs or not any(len(b) for b in bufs.values()):
            return b""
        if not set(self.sinfo.data_positions(self.codec)) <= set(bufs):
            self._count("reconstructions")   # decode fills a data shard
        data = await self.sinfo.reconstruct_logical_async(
            self.codec, bufs, batcher=self.batcher)
        return data[:size]

    async def collect_shard_states(self, oid: str
                                   ) -> tuple[list[tuple], int]:
        """Every up acting shard's stored state for scrub: a list of
        (shard, buf, label, crc, ver, trusted) plus the count of up
        acting shards.

        One PARALLEL gather through the HedgedGather sub-read
        machinery (scrub used to round-trip each shard serially, so a
        deep scrub of a wide stripe paid k+m sequential RTTs); every
        reply feeds the same per-peer latency EWMA the hedge timer
        draws from.  No hedging applies -- scrub wants EVERY stored
        shard, not a sufficient subset -- but a straggler is bounded
        by the read deadline instead of stalling the whole scrub: a
        missing shard simply falls out to the reconstruct path."""
        pg = self.pg
        stored: list[tuple] = []
        remote: dict[int, int] = {}
        n_acting = 0
        for shard, osd_id in enumerate(pg.acting):
            if osd_id < 0 or not self.osd.osd_is_up(osd_id):
                continue
            n_acting += 1
            if osd_id == self.osd.whoami:
                buf, _, over, label, crc, cached = \
                    self._local_entry(oid)
                stored.append((shard, buf, label, crc, tuple(over),
                               cached))
            else:
                remote[shard] = osd_id
        if remote:
            payload = {"pgid": pg.pgid, "oid": oid}
            collected: dict[int, object] = {}
            if self.hedger is not None:
                def on_reply(s, msg):
                    if msg is not None:
                        collected[s] = msg
                await self.hedger.gather_shards(
                    {s: (o, "ec_subop_read",
                         {**payload, "shard": s})
                     for s, o in remote.items()},
                    on_reply=on_reply, timeout=self._read_timeout)
            else:
                replies = await self.osd.fanout_and_wait(
                    [(o, "ec_subop_read", {**payload, "shard": s}, [])
                     for s, o in remote.items()],
                    collect=True, timeout=self._read_timeout)
                for rep in replies:
                    s = rep.data.get("req_shard", rep.data.get("shard"))
                    if s in remote:
                        collected[s] = rep
            for s, rep in sorted(collected.items()):
                raw = rep.segments[0] if rep.segments else b""
                stored.append((s, raw, rep.data.get("shard"),
                               rep.data.get("crc"),
                               tuple(rep.data.get("ver", (0, 0))),
                               False))
        stored.sort(key=lambda e: e[0])
        return stored, n_acting

    # -- write path ---------------------------------------------------------
    async def submit_transaction(self, entry, muts) -> None:
        """Full-object RMW: new logical content -> k+m shard writes."""
        data_muts = [m for m in muts if m["op"] in
                     ("create", "write", "truncate", "zero", "remove")]
        attr_muts = [m for m in muts if m not in data_muts]
        content_muts = [m for m in data_muts if m["op"] != "create"]
        if not content_muts:
            # create-only (touch) or attr-only: existing shard content is
            # preserved -- re-encoding "empty" here would truncate a live
            # object to zero (the replicated path uses touch for the same
            # reason)
            attr_meta, attr_segs = pack_mutations(attr_muts)
            acting = self.pg.acting
            awaiting = []
            for shard, osd in enumerate(acting):
                if osd < 0:
                    continue
                if osd == self.osd.whoami:
                    self.apply_sub_write(entry, {"touch": True}, [],
                                         attr_muts, shard=shard)
                elif not self.pg.should_send_to(osd, entry.oid):
                    awaiting.append(
                        self._log_only_subop(osd, shard, entry))
                else:
                    payload = {"pgid": self.pg.pgid, "oid": entry.oid,
                               "shard": shard, "entry": entry.to_dict(),
                               "w": {"touch": True},
                               "attr_muts": attr_meta}
                    awaiting.append((osd, "ec_subop_write", payload,
                                     attr_segs))
            return await self._commit_or_defer(awaiting, entry)
        old_size = await self.object_size(entry.oid)
        plan = self._plan_rmw(content_muts, old_size)
        if plan is not None:
            return await self._submit_partial(entry, content_muts,
                                              attr_muts, old_size,
                                              *plan)
        logical = bytearray(await self._read_logical(entry.oid))
        remove = False          # tracks the FINAL state: a remove followed
        for m in content_muts:  # by a write recreates the object in-order
            if m["op"] == "write":
                end = m["off"] + len(m["data"])
                if len(logical) < end:
                    logical.extend(b"\0" * (end - len(logical)))
                logical[m["off"]:end] = m["data"]
                remove = False
            elif m["op"] == "truncate":
                if len(logical) < m["size"]:
                    logical.extend(b"\0" * (m["size"] - len(logical)))
                else:
                    del logical[m["size"]:]
                remove = False
            elif m["op"] == "zero":
                end = min(m["off"] + m["len"], len(logical))
                logical[m["off"]:end] = b"\0" * max(0, end - m["off"])
            elif m["op"] == "remove":
                logical = bytearray()
                remove = True

        acting = self.pg.acting
        if remove:
            self.cache.invalidate(entry.oid)
            per_shard = [{"remove": True} for _ in acting]
            segs_per_shard = [[] for _ in acting]
        else:
            size = len(logical)
            padded = bytes(logical) + b"\0" * (
                self.sinfo.logical_to_next_stripe_offset(size) - size)
            if padded:
                # the codec launch returns the shard CRCs along with
                # the parity: the identity stamp below consumes them
                # instead of re-hashing bytes the encoder just produced
                shards, shard_crcs = await self.sinfo.encode_async(
                    self.codec, padded, batcher=self.batcher,
                    with_crc=True)
            else:
                shards = {i: np.zeros(0, np.uint8)
                          for i in range(len(acting))}
                empty_crc = shard_crc(b"")
                shard_crcs = {i: empty_crc
                              for i in range(len(acting))}
            sw = self.sinfo.stripe_width
            self.cache.truncate_beyond(entry.oid, len(padded) // sw)
            if len(padded) <= self.cache.max_bytes // 4:
                for s in range(len(padded) // sw):
                    self.cache.put(entry.oid, s,
                                   padded[s * sw:(s + 1) * sw])
            else:
                # a huge rewrite would churn the whole LRU for entries
                # that mostly evict each other; drop stale ones instead
                self.cache.invalidate(entry.oid)
            per_shard, segs_per_shard = [], []
            for shard in range(len(acting)):
                buf = shards[shard].tobytes()
                per_shard.append({"size": size, "shard_len": len(buf),
                                  "attrs": None,
                                  "crc": int(shard_crcs[shard])})
                segs_per_shard.append([buf])
        # local shard applies in-line; remote shards via ec_subop_write
        awaiting = []
        for shard, osd in enumerate(acting):
            if osd < 0:
                continue
            if osd == self.osd.whoami:
                self.apply_sub_write(entry, per_shard[shard],
                                     segs_per_shard[shard], attr_muts,
                                     shard=shard)
            elif not self.pg.should_send_to(osd, entry.oid):
                awaiting.append(self._log_only_subop(osd, shard, entry))
            else:
                payload = {"pgid": self.pg.pgid, "oid": entry.oid,
                           "shard": shard, "entry": entry.to_dict(),
                           "w": per_shard[shard],
                           "attr_muts": pack_mutations(attr_muts)[0]}
                segs = (segs_per_shard[shard]
                        + pack_mutations(attr_muts)[1])
                awaiting.append((osd, "ec_subop_write", payload, segs))
        return await self._commit_or_defer(awaiting, entry)

    # -- partial-stripe RMW pipeline ----------------------------------------
    # The reference's RMWPipeline (ECCommon.cc:704 start_rmw ->
    # try_state_to_reads -> try_reads_to_commit): only the stripes a
    # write touches are read, merged, re-encoded and shipped as ranged
    # per-shard sub-writes, so a 4KiB overwrite of a huge object moves
    # O(stripe), not O(object).  The ExtentCache feeds the read phase
    # for stripes a recent write already materialized.

    def _plan_rmw(self, muts: list[dict],
                  old_size: int) -> tuple[int, list[int]] | None:
        """(new_size, touched stripe indices) for the partial path, or
        None when the full-object path is required (truncate/remove
        chains, fresh objects, or writes covering everything)."""
        if old_size == 0:
            return None
        sw = self.sinfo.stripe_width
        size = old_size
        touched: set[int] = set()
        for m in muts:          # content_muts: create is pre-filtered
            op = m["op"]
            if op == "write":
                data, off = m["data"], m["off"]
                # empty writes still extend to `off` (the full path's
                # bytearray-extend semantics); they just touch nothing
                if data:
                    end = off + len(data)
                    touched.update(range(off // sw, (end - 1) // sw + 1))
                size = max(size, off + len(data))
            elif op == "zero":
                # clamp to the RUNNING size: a zero may target a region
                # an earlier write in this op vector just extended
                end = min(m["off"] + m["len"], size)
                if end > m["off"]:
                    touched.update(range(m["off"] // sw,
                                         (end - 1) // sw + 1))
            else:               # truncate / remove: full path
                return None
        if not touched:
            return None
        n_stripes = (self.sinfo.logical_to_next_stripe_offset(size) // sw)
        if len(touched) >= n_stripes:
            return None         # rewriting everything anyway
        return size, sorted(touched)

    @staticmethod
    def _runs(stripes: list[int]) -> list[tuple[int, int]]:
        """Contiguous [lo, hi] inclusive runs of sorted stripe indices."""
        runs: list[tuple[int, int]] = []
        for s in stripes:
            if runs and s == runs[-1][1] + 1:
                runs[-1] = (runs[-1][0], s)
            else:
                runs.append((s, s))
        return runs

    async def _read_stripes(self, oid: str, stripes: list[int],
                            old_size: int) -> dict[int, bytearray]:
        """Old logical content of ``stripes``: ExtentCache first, then
        ranged shard gathers (degraded-safe: _gather_shards picks shards
        via minimum_to_decode and decodes when data shards are down)."""
        sw, cs = self.sinfo.stripe_width, self.sinfo.chunk_size
        n_old = self.sinfo.logical_to_next_stripe_offset(old_size) // sw
        dpos = self.sinfo.data_positions(self.codec)
        out: dict[int, bytearray] = {}
        misses: list[int] = []
        for s in stripes:
            if s >= n_old:
                out[s] = bytearray(sw)       # beyond old EOF: zeros
                continue
            c = self.cache.get(oid, s)
            if c is not None:
                out[s] = bytearray(c)
            else:
                misses.append(s)
        async def _fetch_run(lo: int, hi: int):
            rng = (lo * cs, (hi - lo + 1) * cs)
            bufs, _, _ = await self._gather_shards(oid, rng=rng)
            return lo, hi, await self.sinfo.decode_async(
                self.codec, bufs, want=set(dpos), batcher=self.batcher)

        # runs fetch+decode concurrently: their gathers overlap and
        # their decodes coalesce in the batcher
        for lo, hi, data_shards in await asyncio.gather(
                *(_fetch_run(lo, hi) for lo, hi in self._runs(misses))):
            for i, s in enumerate(range(lo, hi + 1)):
                # one concatenate+tobytes per stripe, not one
                # asarray+tobytes hop per data chunk
                out[s] = bytearray(np.concatenate(
                    [data_shards[p][i * cs:(i + 1) * cs]
                     for p in dpos]).tobytes())
        return out

    async def _submit_partial(self, entry, content_muts: list[dict],
                              attr_muts: list[dict], old_size: int,
                              new_size: int, stripes: list[int]) -> None:
        oid = entry.oid
        sw, cs = self.sinfo.stripe_width, self.sinfo.chunk_size
        stripe_data = await self._read_stripes(oid, stripes, old_size)
        # snapshot the OLD stripe bytes before merging: the delta-RMW
        # parity path encodes (new XOR old) and XORs it onto the stored
        # parity (GF linearity) instead of re-encoding whole stripes
        old_data = {s: bytes(d) for s, d in stripe_data.items()} \
            if self._rmw_delta else {}
        # merge the mutations into the touched stripes; `cur` tracks the
        # running logical size so a zero clamps against what earlier
        # writes in this vector extended, not the stale old_size
        cur = old_size
        for m in content_muts:
            if m["op"] == "write":
                off, data = m["off"], m["data"]
                end = off + len(data)
                cur = max(cur, end)
            elif m["op"] == "zero":
                off = m["off"]
                end = min(off + m["len"], cur)
                data = None
            else:
                continue
            for s in stripes:
                lo, hi = s * sw, (s + 1) * sw
                a, b = max(off, lo), min(end, hi)
                if a >= b:
                    continue
                if data is None:
                    stripe_data[s][a - lo:b - lo] = b"\0" * (b - a)
                else:
                    stripe_data[s][a - lo:b - lo] = data[a - off:b - off]
        # process each contiguous run in one driver call (runs submit
        # concurrently so the batcher coalesces them — and any other
        # op's stripes — into a single launch); collect ranged
        # per-shard writes.  Runs whose stripes already exist take the
        # DELTA path: parity' = parity XOR encode(new XOR old) -- one
        # rmw launch, and data shards whose chunks did not change ship
        # NO payload (their sub-write carries only the version stamp),
        # so the per-write byte movement drops from (k+m) chunks per
        # stripe to (changed data chunks + m parity chunks).  Runs past
        # old EOF (no stored parity) and delta-ineligible codecs keep
        # the full re-encode.
        acting = self.pg.acting
        shard_writes: list[list[tuple[int, bytes]]] = [
            [] for _ in acting]
        runs = self._runs(stripes)
        n_old = self.sinfo.logical_to_next_stripe_offset(old_size) // sw
        dpos = self.sinfo.data_positions(self.codec)
        ppos = [i for i in range(self.sinfo.k + self.sinfo.m)
                if i not in dpos]
        from .codec_batcher import CodecBatcher
        delta_ok = (self._rmw_delta and self.batcher is not None
                    and CodecBatcher.supports(self.codec)
                    and len(acting) == self.sinfo.k + self.sinfo.m)
        avail = {shard: osd for shard, osd in enumerate(acting)
                 if osd >= 0 and self.osd.osd_is_up(osd)}

        async def _full_run(lo: int, hi: int):
            """Re-encode the whole run: every shard gets its chunk."""
            blob = b"".join(bytes(stripe_data[s])
                            for s in range(lo, hi + 1))
            shards = await self.sinfo.encode_async(
                self.codec, blob, batcher=self.batcher)
            if self.batcher is not None:
                self.batcher.note_rmw(delta=False)
            return [(shard, lo * cs, shards[shard].tobytes())
                    for shard in range(len(acting))]

        async def _delta_run(lo: int, hi: int):
            """Delta-update parity in place; ship only changed data
            chunks + the m parity chunks."""
            n = hi - lo + 1
            rng = (lo * cs, n * cs)
            pbufs, pfailed, _ = await self._fetch_shards(
                oid, [p for p in ppos if p in avail], avail, rng,
                self._read_timeout)
            if pfailed or set(ppos) - set(pbufs) or any(
                    len(pbufs[p][0]) != n * cs for p in ppos):
                # a parity source is down/stale/short: the delta has
                # nothing sound to XOR onto -- re-encode instead
                return await _full_run(lo, hi)
            old_parity = np.stack(
                [np.asarray(pbufs[p][0], np.uint8).reshape(n, cs)
                 for p in ppos], axis=1)              # (n, m, cs)
            new_arr = np.frombuffer(
                b"".join(bytes(stripe_data[s])
                         for s in range(lo, hi + 1)),
                np.uint8).reshape(n, self.sinfo.k, cs)
            old_arr = np.frombuffer(
                b"".join(old_data[s] for s in range(lo, hi + 1)),
                np.uint8).reshape(n, self.sinfo.k, cs)
            delta = new_arr ^ old_arr
            new_parity = await self.batcher.rmw(self.codec,
                                                old_parity, delta)
            self.batcher.note_rmw(delta=True)
            out = []
            changed = delta.any(axis=2)               # (n, k)
            for j, p in enumerate(dpos):
                for i in range(n):
                    if changed[i, j]:
                        out.append((p, (lo + i) * cs,
                                    new_arr[i, j].tobytes()))
            for r, p in enumerate(ppos):
                out.append((p, lo * cs, np.ascontiguousarray(
                    new_parity[:, r]).reshape(-1).tobytes()))
            return out

        async def _run_one(lo: int, hi: int):
            if delta_ok and hi < n_old and all(
                    s in old_data for s in range(lo, hi + 1)):
                return await _delta_run(lo, hi)
            return await _full_run(lo, hi)

        for writes in await asyncio.gather(
                *(_run_one(lo, hi) for lo, hi in runs)):
            for shard, off, buf in writes:
                shard_writes[shard].append((off, buf))
        for s in stripes:
            self.cache.put(oid, s, bytes(stripe_data[s]))
        shard_len = self.sinfo.object_size_to_shard_size(new_size)
        attr_meta, attr_segs = pack_mutations(attr_muts)
        awaiting = []
        for shard, osd in enumerate(acting):
            if osd < 0:
                continue
            w = {"size": new_size, "shard_len": shard_len,
                 "writes": [[off, len(buf)]
                            for off, buf in shard_writes[shard]]}
            segs = [buf for _, buf in shard_writes[shard]]
            if osd == self.osd.whoami:
                self.apply_sub_write(entry, w, segs, attr_muts,
                                     shard=shard)
            elif not self.pg.should_send_to(osd, oid):
                awaiting.append(self._log_only_subop(osd, shard, entry))
            else:
                payload = {"pgid": self.pg.pgid, "oid": oid,
                           "shard": shard, "entry": entry.to_dict(),
                           "w": w, "attr_muts": attr_meta}
                awaiting.append((osd, "ec_subop_write", payload,
                                 segs + attr_segs))
        return await self._commit_or_defer(awaiting, entry)

    def apply_sub_write(self, entry: LogEntry, w: dict,
                        segs: list[bytes], attr_muts: list[dict],
                        shard: int | None = None) -> None:
        txn = Transaction()
        oid = entry.oid
        if w.get("log_only"):
            # backfill target beyond its watermark: log entry only
            self.pg.append_log_and_meta(txn, entry)
            self.store.queue_transaction(txn)
            return
        # write-time identity pin: remember which shard these bytes ARE
        # (per-object xattr) and which shard this PG instance serves
        # (PG meta, persisted by append_log_and_meta below) -- readers
        # and recovery verify against the pin, never the live index
        if shard is None:
            try:
                shard = self.my_shard()
            except ValueError:
                shard = self.pg.shard_id
        if shard is not None and self.pg.shard_id is None:
            self.pg.shard_id = shard
        # final shard content for the device-resident cache: full-shard
        # writes hand their payload straight through; ranged RMW writes
        # patch the PRE-txn resident copy (captured before the store's
        # coherence invalidation fires) so the identity stamp never
        # reads the shard back from the store
        content = size = vtuple = None
        if w.get("remove"):
            txn.remove(self.coll, oid)
        elif w.get("writes") is not None:
            # partial-stripe RMW: ranged chunk writes + final length
            pre = self.dcache.get(self.coll, oid) \
                if self.dcache is not None else None
            txn.touch(self.coll, oid)
            for i, (off, ln) in enumerate(w["writes"]):
                buf = segs[i] if i < len(segs) else b""
                assert len(buf) == ln, (len(buf), ln)
                txn.write(self.coll, oid, off, buf)
            txn.truncate(self.coll, oid, w["shard_len"])
            txn.setattr(self.coll, oid, SIZE_XATTR,
                        str(w["size"]).encode())
            txn.setattr(self.coll, oid, VER_XATTR,
                        ver_encode(entry.version))
            if pre is not None:
                arr = np.zeros(w["shard_len"], np.uint8)
                n = min(pre.buf.size, w["shard_len"])
                arr[:n] = pre.buf[:n]
                for (off, ln), buf in zip(w["writes"], segs):
                    arr[off:off + ln] = np.frombuffer(buf, np.uint8)
                content, size = arr, w["size"]
                vtuple = (entry.version.epoch, entry.version.version)
        elif w.get("touch"):
            # create-only / attr-only: never rewrite shard content
            txn.touch(self.coll, oid)
            if self.store.getattr(self.coll, oid, SIZE_XATTR) is None:
                txn.setattr(self.coll, oid, SIZE_XATTR, b"0")
            txn.setattr(self.coll, oid, VER_XATTR,
                        ver_encode(entry.version))
        else:
            buf = segs[0] if segs else b""
            txn.truncate(self.coll, oid, 0)
            txn.write(self.coll, oid, 0, buf)
            txn.truncate(self.coll, oid, w["shard_len"])
            txn.setattr(self.coll, oid, SIZE_XATTR,
                        str(w["size"]).encode())
            txn.setattr(self.coll, oid, VER_XATTR,
                        ver_encode(entry.version))
            if len(buf) == w["shard_len"]:
                content, size = buf, w["size"]
                vtuple = (entry.version.epoch, entry.version.version)
        apply_mutations(txn, self.coll, oid, attr_muts)
        self.pg.append_log_and_meta(txn, entry)
        self.store.queue_transaction(txn)
        if not w.get("remove"):
            self._stamp_identity(oid, shard, crc=w.get("crc"),
                                 content=content, size=size,
                                 ver=vtuple)

    def _stamp_identity(self, oid: str, shard: int | None,
                        crc: int | None = None, content=None,
                        size: int | None = None,
                        ver: tuple | None = None) -> None:
        """Post-commit identity tag: shard label + CRC of the FINAL
        shard content.  Full-shard writes pass the ``crc`` the codec
        launch already computed (no read-back, no re-hash); ranged RMW
        writes pass the patched resident ``content`` (no store
        read-back) or, with no resident copy, read back from the store
        after the txn applied (queue_transaction is synchronous, no
        interleaving await) -- still through the batched kernel.

        When the final content is in hand it becomes the cache entry
        for ``(coll, oid)`` -- the write's encoded bytes flow straight
        into residency, so the next read/scrub/decode never touches
        the store."""
        if crc is None:
            if content is None:
                try:
                    content = self.store.read(self.coll, oid, 0, None)
                except FileNotFoundError:
                    return
                if self.dcache is not None:
                    self.dcache.note_host_read(len(content))
            crc = shard_crc(content)
        txn = Transaction()
        if shard is not None:
            txn.setattr(self.coll, oid, SHARD_XATTR,
                        str(int(shard)).encode())
        txn.setattr(self.coll, oid, CRC_XATTR,
                    str(int(crc)).encode())
        self.store.queue_transaction(txn)
        if self.dcache is not None and content is not None \
                and size is not None and ver is not None:
            self.dcache.put(self.coll, oid, content, size=size,
                            ver=ver, shard=shard, crc=int(crc))

    # -- read path ----------------------------------------------------------
    async def object_read(self, oid, off, length) -> bytes:
        data = await self._read_logical(oid)
        if length is None:
            return data[off:]
        return data[off:off + length]

    async def object_size(self, oid) -> int:
        sx = self.store.getattr(self.coll, oid, SIZE_XATTR)
        if sx is not None:
            return int(sx)
        _, size, _ = await self._gather_shards(oid)
        return size

    async def read_recovery_payload(self, oid, shard) -> dict:
        """Reconstruct the target shard's buffer for a recovering peer.

        Regenerating codecs (pmsr) take the FRAGMENT path first: d
        helpers each ship one beta-sized computed sub-chunk instead of
        a full chunk, so rebuilding one shard moves d/alpha chunks of
        bytes instead of k (counted in ``ec_recovery``, asserted by
        chaos/bench, never assumed).  Any fragment-path failure --
        helper down, version skew, codec ineligible -- falls back to
        the full shard gather transparently."""
        self._rcount("repair_reads")
        frag = await self._fragment_recover(oid, shard)
        if frag is not None:
            buf, size, ver = frag
        else:
            # the target shard is being REBUILT: its holder's current
            # (empty or stale) bytes must never serve as the source of
            # itself -- a revived OSD answering the gather for its own
            # missing shard used to satisfy the plan with an absent
            # reply, and the "recovery" pushed a remove instead of a
            # reconstruction (the shard stayed lost forever)
            bufs, size, ver = await self._gather_shards(
                oid, need_shards={shard}, exclude={int(shard)})
            self._rcount("repair_bytes_read",
                         sum(len(b) for b in bufs.values()))
            if len(bufs) < self.sinfo.k:
                # a layered plan (the LRC local group) read fewer than
                # k chunks: the locality savings, counted
                self._rcount("repair_local_repairs")
            else:
                self._rcount("repair_global_decodes")
            if ver == (0, 0) and not any(len(b) for b in bufs.values()):
                # object exists on no shard: tell the peer to remove
                # its copy (backfill pushes extras as absent)
                return {"data": b"", "xattrs": {}, "omap": {},
                        "absent": True}
            if shard in bufs:
                buf = bufs[shard]
            else:
                # reconstruction decode rides the batcher: concurrent
                # recovery/backfill pushes for the same down-shard
                # pattern share one decode_batch launch
                self._count("reconstructions")
                decoded = await self.sinfo.decode_async(
                    self.codec, bufs, want={shard},
                    batcher=self.batcher)
                buf = decoded[shard]
        # the pushed shard must carry the version stamp (an unstamped
        # recovered shard would read as (0,0) and be rejected as stale
        # by _gather_shards forever after) AND its identity pin: the
        # shard label + CRC travel in the xattrs so the applied copy is
        # self-describing, and again at the payload top level so the
        # receiver can verify BEFORE applying anything
        raw = buf.tobytes()
        self._rcount("repair_bytes_shipped", len(raw))
        return {"data": raw,
                "xattrs": {**self._user_xattrs(oid, ver),
                           SIZE_XATTR: str(size).encode(),
                           VER_XATTR: f"{ver[0]},{ver[1]}".encode(),
                           SHARD_XATTR: str(int(shard)).encode(),
                           CRC_XATTR: str(shard_crc(raw)).encode()},
                "omap": {},
                "shard": int(shard)}

    def _user_xattrs(self, oid: str, ver) -> dict[str, bytes]:
        """The object's client-visible xattrs, from this OSD's own shard
        when it is at the version being rebuilt.  Every shard of an EC
        object holds them and the primary serves ``getxattr`` from its
        own, so a rebuilt shard must carry them beside its identity
        xattrs: a shard moved by an upmap, or backfilled, would otherwise
        answer ENODATA (a striped file's size read as 0)."""
        attrs = self.store.getattrs(self.coll, oid)
        if tuple(ver_decode(attrs.get(VER_XATTR))) != tuple(ver):
            return {}
        return {k: v for k, v in attrs.items() if k not in HIDDEN_XATTRS}

    # -- regenerating-code repair fragments (pmsr) ---------------------------
    def fragment_of(self, oid: str, lost_shard: int
                    ) -> tuple[bytes, int, tuple, int | None] | None:
        """This OSD's beta-sized repair fragment for ``lost_shard``:
        the locally stored chunk combined by the codec's fragment row.
        Returns (fragment bytes, size, ver, my shard label), or None
        when the codec has no fragment algebra or nothing is stored."""
        if not hasattr(self.codec, "fragment_for"):
            return None
        buf, size, ver, label, _, _ = self._local_entry(oid)
        if not len(buf):
            return None
        frag = self.codec.fragment_for(lost_shard, buf)
        return frag.tobytes(), size, tuple(ver), label

    async def _fragment_recover(self, oid: str, shard: int
                                ) -> tuple | None:
        """Rebuild ``shard`` from beta-sized helper fragments, or None
        (fall back to the full-chunk gather).  Every fragment reply is
        identity-checked -- the helper's write-time shard label must
        match its serving position and all versions must agree -- so a
        remapped or stale helper degrades to the safe path instead of
        aggregating garbage."""
        codec = self.codec
        if not self._frag_repair \
                or not hasattr(codec, "minimum_to_repair"):
            return None
        acting = self.pg.acting
        avail = {s: osd for s, osd in enumerate(acting)
                 if osd >= 0 and self.osd.osd_is_up(osd)}
        plan = codec.minimum_to_repair(int(shard),
                                       set(avail) - {int(shard)})
        if not plan:
            return None
        sub = codec.get_sub_chunk_count()
        if all(sum(c for _, c in spec) >= sub
               for spec in plan.values()):
            return None           # no fragment saving: gather instead
        frags: dict[int, np.ndarray] = {}
        meta: dict[int, tuple] = {}
        remote = []
        for h in plan:
            if h not in avail:
                return None
            if avail[h] == self.osd.whoami:
                local = self.fragment_of(oid, int(shard))
                if local is None:
                    return None
                fbuf, size, ver, label = local
                if not self._label_ok(h, label, fbuf, ver):
                    return None
                frags[h] = np.frombuffer(fbuf, np.uint8)
                meta[h] = (size, ver)
            else:
                remote.append(h)
        if remote:
            payload = {"pgid": self.pg.pgid, "oid": oid,
                       "frag_for": int(shard)}
            try:
                replies = await self.osd.fanout_and_wait(
                    [(avail[h], "ec_subop_read",
                      {**payload, "shard": h}, []) for h in remote],
                    collect=True, timeout=self._read_timeout)
            except (ConnectionError, OSError, asyncio.TimeoutError):
                self._rcount("repair_fragment_falls")
                return None
            for rep in replies:
                h = rep.data.get("req_shard")
                if h is None or h not in remote \
                        or rep.data.get("frag_err"):
                    continue
                fbuf = rep.segments[0] if rep.segments else b""
                crc = rep.data.get("crc")
                if crc is not None and not shard_crc_matches(fbuf, crc):
                    self._count("crc_mismatch")
                    continue
                label = rep.data.get("shard")
                ver = tuple(rep.data.get("ver", (0, 0)))
                if not self._label_ok(h, label,
                                      np.frombuffer(fbuf, np.uint8),
                                      ver):
                    self._count("shard_mismatch")
                    continue
                frags[h] = np.frombuffer(fbuf, np.uint8)
                meta[h] = (rep.data.get("size", 0), ver)
        if set(frags) != set(plan):
            self._rcount("repair_fragment_falls")
            return None
        vers = {v for _, v in meta.values()}
        lens = {len(f) for f in frags.values()}
        if len(vers) != 1 or len(lens) != 1 or not lens.pop():
            # version skew mid-recovery or ragged fragments: the
            # aggregate would mix stripes from different writes
            self._rcount("repair_fragment_falls")
            return None
        try:
            buf = codec.aggregate_fragments(int(shard), frags)
        except (IOError, OSError, ValueError):
            self._rcount("repair_fragment_falls")
            return None
        nbytes = sum(len(f) for f in frags.values())
        self._rcount("repair_fragment_pulls")
        self._rcount("repair_fragments", len(frags))
        self._rcount("repair_bytes_read", nbytes)
        size = max(s for s, _ in meta.values())
        return buf, size, vers.pop()          # uint8 ndarray from the
                                              # aggregate, shard-sized
