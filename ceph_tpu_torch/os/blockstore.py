"""BlockStore: raw-file block store with allocator, WAL, checksums,
and KV-backed metadata.

Port of ``ceph_tpu/os/blockstore.py``, copied: host code with no device
hop.

The BlueStore analog (src/os/bluestore/BlueStore.cc): object data lives
in a single raw block file this store ALLOCATES itself -- no filesystem
per object, no sqlite row per write.  The moving parts map one-to-one:

  * 4 KiB allocation units managed by a free-list allocator
    (src/os/bluestore/Allocator.h; contiguous-first, scatter fallback);
  * every transaction commits by appending ONE crc-framed record to a
    write-ahead log; a flusher drains the submit queue and fsyncs in
    GROUPS (_kv_sync_thread, BlueStore.cc:14643) -- durable on return;
  * small writes defer: the payload rides the WAL record and the block
    write happens without its own fsync (deferred writes,
    BlueStore.cc:15334 queue_transactions); replay re-applies them.
    Large writes go redirect-on-write to fresh blocks, fsynced before
    the WAL record commits (new-extent writes need no data in the log);
  * crc32c per block, verified on every read (checksum-on-read,
    BlueStore verify_csum);
  * clones share blocks by refcount (SharedBlob); a deferred in-place
    write to a shared block is forced down the redirect path (COW);
  * metadata (onodes: size, block map, xattrs; omap; per-block csums)
    lives in a KeyValueDB (os/kv.py -- the KeyValueDB.h role, sqlite
    engine) exactly as BlueStore keeps onodes in RocksDB: a bounded
    LRU onode cache serves reads, mutations accumulate as in-memory
    dirty overlays, and a checkpoint flushes ONLY the dirty entries in
    one atomic KV batch before truncating the WAL.  Memory stays
    bounded at any object count; checkpoints are incremental, not
    wholesale.

Layout under ``path/``: ``block`` (data), ``wal`` (log), ``md.db``
(KeyValueDB).
"""

from __future__ import annotations

import json
import os
import struct
import threading
from collections import OrderedDict

from ..common.denc import Decoder, Encoder
from ..native import crc32c
from ..ops.crc32c_batch import crc32c_batch, crc32c_rows
from .kv import SqliteKVDB
from .store import ObjectStore
from .transaction import Transaction

BLOCK = 4096                     # allocation/checksum unit
DEFERRED_MAX = 16 * BLOCK        # <=64 KiB writes take the WAL path
WAL_CKPT_BYTES = 8 << 20         # checkpoint + truncate past this
QUAR_MAX_BLOCKS = 4096           # force a checkpoint past 16 MiB of
                                 # quarantined frees (space amp bound)
ONODE_CACHE_MAX = 512            # clean onodes held in RAM
CSUM_CACHE_MAX = 1 << 16         # cached per-block crcs
REC_MAGIC = b"BSR1"

# KV prefixes (BlueStore's column families)
P_ONODE = "O"       # c\0o -> onode blob (size, blocks, xattrs)
P_OMAP = "M"        # c\0o\0key -> value
P_CSUM = "C"        # u64be(dev) -> u32le(crc)
P_STATE = "S"       # "seq" -> u64le
P_COLL = "L"        # coll -> b""


def _crc(data) -> int:
    return crc32c(bytes(data))


def _okey(c: str, o: str) -> bytes:
    return f"{c}\x00{o}".encode()


def _mkey(c: str, o: str, k: str = "") -> bytes:
    return f"{c}\x00{o}\x00{k}".encode()


class _Onode:
    __slots__ = ("size", "blocks", "xattrs", "dirty")

    def __init__(self) -> None:
        self.size = 0
        self.blocks: dict[int, int] = {}    # logical blk -> device blk
        self.xattrs: dict[str, bytes] = {}
        self.dirty = True                   # new onodes need a flush

    def encode(self) -> bytes:
        enc = Encoder()
        enc.start(1, 1)
        enc.u64(self.size)
        enc.map(self.blocks, lambda e, k: e.u64(k),
                lambda e, v: e.u64(v))
        enc.map(self.xattrs, lambda e, k: e.string(k),
                lambda e, v: e.blob(v))
        enc.finish()
        return enc.bytes()

    @classmethod
    def decode(cls, blob: bytes) -> "_Onode":
        dec = Decoder(blob)
        dec.start(1)
        on = cls()
        on.size = dec.u64()
        on.blocks = dec.map(Decoder.u64, Decoder.u64)
        on.xattrs = dec.map(Decoder.string, Decoder.blob)
        dec.finish()
        on.dirty = False
        return on


class Allocator:
    """Free-list block allocator: contiguous run first, scatter
    fallback, grow-the-device last (Allocator.h role)."""

    def __init__(self) -> None:
        self.free: set[int] = set()
        self.high = 0                # device size in blocks

    def alloc(self, n: int) -> list[int]:
        out: list[int] = []
        if len(self.free) >= n:
            run = self._find_run(n)
            if run is not None:
                out = list(range(run, run + n))
        if not out:
            take = sorted(self.free)[:n]
            out = take
        self.free -= set(out)
        while len(out) < n:
            out.append(self.high)
            self.high += 1
        return out

    def _find_run(self, n: int) -> int | None:
        run_start = None
        run_len = 0
        prev = None
        for b in sorted(self.free):
            if prev is not None and b == prev + 1:
                run_len += 1
            else:
                run_start, run_len = b, 1
            if run_len >= n:
                return run_start
            prev = b
        return None

    def release(self, blocks) -> None:
        self.free.update(blocks)


class BlockStore(ObjectStore):
    def __init__(self, path: str) -> None:
        self.path = path
        os.makedirs(path, exist_ok=True)
        self.kv: SqliteKVDB | None = None
        # in-memory state is disk-derived: (re)set at every mount
        self._reset_state()
        self._block_fd = -1
        self._wal_fd = -1
        self._wal_size = 0
        self._mounted = False
        # kv-sync group commit: submitters enqueue (record, event) and
        # block; the flusher writes+fsyncs EVERYTHING queued in one go
        self._submit: list[tuple[bytes, threading.Event]] = []
        self._submit_lock = threading.Lock()
        self._submit_cv = threading.Condition(self._submit_lock)
        self._flusher: threading.Thread | None = None
        self._stop = False
        # serializes apply+commit+checkpoint across submitter threads
        # (MemStore holds a lock for the same contract)
        self._txn_lock = threading.Lock()

    # -- lifecycle ----------------------------------------------------------
    def _f(self, name: str) -> str:
        return os.path.join(self.path, name)

    def _reset_state(self) -> None:
        """In-memory state rebuilt from disk truth at every mount (a
        prior failed txn leaves nothing behind).  Everything here is
        an OVERLAY over the KV: committed-but-not-checkpointed
        mutations, bounded caches, and the allocator."""
        # bounded LRU of onodes; dirty entries are flush-pinned (never
        # evicted until a checkpoint writes them to the KV)
        self._oncache: OrderedDict[tuple, _Onode] = OrderedDict()
        # objects removed since the last checkpoint (pending KV rm)
        self._removed: set[tuple] = set()
        # omap overlay: (c,o) -> {key -> value | None=deleted}
        self._om_dirty: dict[tuple, dict[str, bytes | None]] = {}
        # full-clear markers (applied before the overlay on reads;
        # rm_range at checkpoint) -- also shields a recreated object
        # from its prior incarnation's KV rows
        self._om_cleared: set[tuple] = set()
        # csum overlay + bounded cache (dev -> crc | None=dropped)
        self._csum_dirty: dict[int, int | None] = {}
        self._csum_cache: OrderedDict[int, int] = OrderedDict()
        # collections: tiny cardinality, full set in RAM
        self._coll_set: set[str] = set()
        self._coll_dirty: dict[str, bool] = {}   # c -> exists
        self.alloc = Allocator()
        self.refcnt: dict[int, int] = {}    # shared blocks only (>1)
        self._seq = 0
        # deferred writes staged this txn but not yet on the device:
        # later ops in the SAME txn must read through this overlay
        self._pending: dict[int, bytes] = {}
        # freed blocks quarantined until the WAL is truncated: a live
        # WAL record may still carry a deferred payload for them, and
        # replay after a crash would pwrite that stale payload over
        # whatever a reallocation put there (BlueStore holds frees
        # until the kv log no longer references the extent)
        self._quarantine: set[int] = set()
        # a txn that died mid-commit leaves memory inconsistent with
        # the log: refuse further work, like BlueStore's abort path
        self._failed = False
        # a (re)mount rebuilds truth from disk: any device-resident
        # shard buffers from the previous incarnation are unverifiable
        # (a kill may have lost their final txn) -- drop them all
        if self.shard_cache is not None:
            self.shard_cache.clear()
        # observability: KV ops in the last checkpoint batch (proves
        # incremental flushing -- tests assert it stays proportional
        # to the delta, not the store size)
        self._last_ckpt_ops = 0

    def mount(self) -> None:
        if self._mounted:
            return
        self._reset_state()
        self._block_fd = os.open(self._f("block"),
                                 os.O_RDWR | os.O_CREAT, 0o644)
        self.kv = SqliteKVDB(self._f("md.db"))
        seq = self.kv.get(P_STATE, b"seq")
        self._seq = struct.unpack("<Q", seq)[0] if seq else 0
        self._coll_set = {k.decode()
                          for k, _ in self.kv.get_range(P_COLL)}
        good = self._replay_wal()
        self._rebuild_allocator()
        self._wal_fd = os.open(self._f("wal"),
                               os.O_RDWR | os.O_CREAT | os.O_APPEND,
                               0o644)
        if os.fstat(self._wal_fd).st_size > good:
            # cut the torn tail NOW: records appended after garbage
            # would be unreachable by every future replay
            os.ftruncate(self._wal_fd, good)
            os.fsync(self._wal_fd)
        self._wal_size = good
        if good > 0:
            # checkpoint the replayed state so the WAL holds no stale
            # deferred payloads: only then is the rebuilt free list
            # safe to allocate from (see _quarantine)
            self._checkpoint()
        self._stop = False
        self._flusher = threading.Thread(target=self._kv_sync,
                                         daemon=True)
        self._flusher.start()
        self._mounted = True

    def umount(self) -> None:
        if not self._mounted:
            return
        with self._submit_cv:
            self._stop = True
            self._submit_cv.notify()
        self._flusher.join()
        if not self._failed:
            self._checkpoint()
        # on failure: do NOT checkpoint -- the in-memory state is
        # half-applied and the WAL (which never got the failed txn's
        # record) is the only consistent truth; remount replays it
        os.close(self._wal_fd)
        os.close(self._block_fd)
        self.kv.close()
        self._mounted = False

    def _ensure(self) -> None:
        if not self._mounted:
            self.mount()        # resets a prior failure from disk
            return
        if self._failed:
            # reads too: the in-memory maps may hold the half-applied
            # txn (new csums over old device content), so serving them
            # would misreport corruption or leak uncommitted state
            raise IOError("blockstore failed mid-commit; "
                          "remount required")

    # -- kv-sync flusher (group commit) --------------------------------------
    def _kv_sync(self) -> None:
        while True:
            with self._submit_cv:
                while not self._submit and not self._stop:
                    self._submit_cv.wait()
                if self._stop and not self._submit:
                    return
                batch, self._submit = self._submit, []
            buf = b"".join(rec for rec, _ in batch)
            os.write(self._wal_fd, buf)
            os.fsync(self._wal_fd)
            self._wal_size += len(buf)
            for _, ev in batch:
                ev.set()

    def _wal_commit(self, record: bytes) -> None:
        ev = threading.Event()
        with self._submit_cv:
            self._submit.append((record, ev))
            self._submit_cv.notify()
        ev.wait()

    # -- transaction apply ----------------------------------------------------
    def queue_transaction(self, txn: Transaction) -> None:
        """Apply + durably commit one transaction.

        Data placement happens NOW (large writes hit fresh blocks and
        fsync; small writes merge in place, payload deferred into the
        log); the metadata delta commits as one WAL record via the
        group flusher.  On return the transaction is crash-durable.

        The call BLOCKS the submitting thread on the log fsync, as the
        reference's queue_transactions blocks its submitter until
        kv-sync acks; under asyncio that stalls the loop for one local
        fsync (~0.1-1 ms) per txn -- acceptable against multi-second
        heartbeat grace, and the price of ack==durable semantics."""
        self._ensure()
        with self._txn_lock:
            # validate-then-apply, as MemStore: missing collections
            # fail the whole transaction up front (mkcolls earlier in
            # the same txn count); under the lock so the set is stable
            pending = set(self._coll_set)
            for op in txn.ops:
                if op.op == "mkcoll":
                    pending.add(op.coll)
                elif op.coll not in pending:
                    raise KeyError(f"no collection {op.coll}")
            if self._failed:
                raise IOError("blockstore failed mid-commit; "
                              "remount required")
            # cache coherence: drop resident copies of every object
            # this txn can mutate BEFORE applying (even a failed apply
            # must not leave a stale resident buffer behind)
            self._note_txn_for_cache(txn)
            try:
                self._commit_locked(txn)
            except BaseException:
                self._failed = True
                raise
            finally:
                self._pending.clear()

    def _commit_locked(self, txn: Transaction) -> None:
        self._seq += 1
        delta: dict = {"seq": self._seq, "ops": []}
        ctx = {"sync": False, "deferred": [], "to_release": []}
        for op in txn.ops:
            self._apply_op(op, delta, ctx)
        if ctx["sync"]:
            # metadata must never point at data the device might not
            # hold: new-extent data syncs BEFORE the WAL record lands
            os.fsync(self._block_fd)
        meta = json.dumps(delta, separators=(",", ":")).encode()
        rec = (REC_MAGIC + struct.pack("<II", len(meta), _crc(meta))
               + meta)
        self._wal_commit(rec)
        # deferred in-place writes land only AFTER the record is
        # durable: overwriting the old content first would destroy a
        # previously committed write if we crashed before the log
        # caught up (exactly BlueStore's deferred ordering)
        for dev, content in ctx["deferred"]:
            os.pwrite(self._block_fd, content, dev * BLOCK)
        self._quarantine.update(ctx["to_release"])
        self._pending.clear()
        self._evict()
        if (self._wal_size > WAL_CKPT_BYTES
                or len(self._quarantine) > QUAR_MAX_BLOCKS):
            self._checkpoint()

    # each ops entry in a delta is self-contained for idempotent
    # replay: resulting block assignments, csums, payloads -- never
    # read-modify state
    def _apply_op(self, op, delta: dict, ctx: dict) -> None:
        c, oid = op.coll, op.oid
        a = op.args
        if op.op == "mkcoll":
            if c not in self._coll_set:
                self._coll_set.add(c)
                self._coll_dirty[c] = True
            delta["ops"].append({"op": "mkcoll", "c": c})
        elif op.op == "rmcoll":
            for o in self._list_objects(c):
                self._free_object(c, o, ctx)
            self._coll_set.discard(c)
            self._coll_dirty[c] = False
            delta["ops"].append({"op": "rmcoll", "c": c})
        elif op.op == "touch":
            self._onode(c, oid, create=True)
            delta["ops"].append({"op": "touch", "c": c, "o": oid})
        elif op.op == "write":
            self._do_write(c, oid, a["offset"], a["data"], delta, ctx)
        elif op.op == "zero":
            self._do_write(c, oid, a["offset"],
                           b"\x00" * a["length"], delta, ctx)
        elif op.op == "truncate":
            self._do_truncate(c, oid, a["size"], delta, ctx)
        elif op.op == "remove":
            self._free_object(c, oid, ctx)
            delta["ops"].append({"op": "remove", "c": c, "o": oid})
        elif op.op == "clone":
            self._do_clone(c, oid, a["dst"], delta, ctx)
        elif op.op == "setattr":
            on = self._onode(c, oid, create=True)
            on.xattrs[a["name"]] = a["value"]
            on.dirty = True
            delta["ops"].append({"op": "setattr", "c": c, "o": oid,
                                 "n": a["name"],
                                 "v": a["value"].hex()})
        elif op.op == "rmattr":
            on = self._onode(c, oid, create=True)
            on.xattrs.pop(a["name"], None)
            on.dirty = True
            delta["ops"].append({"op": "rmattr", "c": c, "o": oid,
                                 "n": a["name"]})
        elif op.op == "omap_setkeys":
            self._onode(c, oid, create=True)
            self._om_dirty.setdefault((c, oid), {}).update(a["kv"])
            delta["ops"].append({"op": "omap_setkeys", "c": c,
                                 "o": oid,
                                 "kv": {k: v.hex()
                                        for k, v in a["kv"].items()}})
        elif op.op == "omap_rmkeys":
            self._onode(c, oid, create=True)
            d = self._om_dirty.setdefault((c, oid), {})
            for k in a["keys"]:
                d[k] = None
            delta["ops"].append({"op": "omap_rmkeys", "c": c, "o": oid,
                                 "keys": list(a["keys"])})
        elif op.op == "omap_clear":
            self._onode(c, oid, create=True)
            self._om_cleared.add((c, oid))
            self._om_dirty.pop((c, oid), None)
            delta["ops"].append({"op": "omap_clear", "c": c, "o": oid})
        else:
            raise ValueError(f"unknown op {op.op}")

    # -- onode cache ----------------------------------------------------------
    def _onode(self, c: str, oid: str,
               create: bool = False) -> _Onode | None:
        key = (c, oid)
        on = self._oncache.get(key)
        if on is not None:
            self._oncache.move_to_end(key)
            return on
        if key not in self._removed:
            blob = self.kv.get(P_ONODE, _okey(c, oid)) \
                if self.kv is not None else None
            if blob is not None:
                on = _Onode.decode(blob)
                self._oncache[key] = on
                self._evict()    # read-heavy paths must stay bounded
                return on
        if not create:
            return None
        self._removed.discard(key)
        on = _Onode()
        self._oncache[key] = on
        return on

    def _evict(self) -> None:
        """Drop least-recently-used CLEAN onodes past the cache bound;
        dirty onodes are pinned until a checkpoint flushes them."""
        while len(self._csum_cache) > CSUM_CACHE_MAX:
            self._csum_cache.popitem(last=False)
        excess = len(self._oncache) - ONODE_CACHE_MAX
        if excess <= 0:
            return
        for key in [k for k, v in self._oncache.items()
                    if not v.dirty][:excess]:
            del self._oncache[key]

    # -- csums ----------------------------------------------------------------
    def _get_csum(self, dev: int) -> int | None:
        if dev in self._csum_dirty:
            return self._csum_dirty[dev]
        got = self._csum_cache.get(dev)
        if got is not None:
            self._csum_cache.move_to_end(dev)
            return got
        raw = self.kv.get(P_CSUM, struct.pack(">Q", dev))
        if raw is None:
            return None
        crc = struct.unpack("<I", raw)[0]
        self._csum_cache[dev] = crc
        return crc

    def _set_csum(self, dev: int, crc: int | None) -> None:
        self._csum_dirty[dev] = crc
        if crc is None:
            self._csum_cache.pop(dev, None)
        else:
            self._csum_cache[dev] = crc

    # -- data path ------------------------------------------------------------
    def _read_dev_block(self, dev_blk: int, verify: bool = True) -> bytes:
        pend = self._pending.get(dev_blk)
        if pend is not None:
            return pend
        buf = os.pread(self._block_fd, BLOCK, dev_blk * BLOCK)
        buf = buf.ljust(BLOCK, b"\x00")
        if verify:
            want = self._get_csum(dev_blk)
            if want is not None and _crc(buf) != want:
                raise IOError(
                    f"checksum mismatch on device block {dev_blk}")
        return buf

    def _deref(self, dev_blk: int, ctx: dict) -> None:
        n = self.refcnt.get(dev_blk, 1)
        if n > 1:
            self.refcnt[dev_blk] = n - 1
        else:
            self.refcnt.pop(dev_blk, None)
            self._set_csum(dev_blk, None)
            # never straight back to the allocator: a live WAL record
            # (this txn's or an earlier uncheckpointed one) may carry a
            # deferred payload for this block, and replay would smear
            # it over whatever a reallocation wrote here.  Quarantined
            # until the WAL is truncated (_checkpoint).
            ctx["to_release"].append(dev_blk)

    def _do_write(self, c: str, oid: str, offset: int, data: bytes,
                  delta: dict, ctx: dict) -> None:
        on = self._onode(c, oid, create=True)
        end = offset + len(data)
        lb0, lb1 = offset // BLOCK, (end + BLOCK - 1) // BLOCK
        deferred = len(data) <= DEFERRED_MAX
        assign: dict[int, int] = {}
        contents: list[tuple[int, bytes]] = []   # (dev, final bytes)
        payloads: list[list] = []      # [dev_blk, hex] for replay
        pwrites: list[tuple[int, bytes]] = []
        for lb in range(lb0, lb1):
            blk_off = lb * BLOCK
            s = max(offset, blk_off) - blk_off
            e = min(end, blk_off + BLOCK) - blk_off
            piece = data[max(offset, blk_off) - offset:
                         min(end, blk_off + BLOCK) - offset]
            old_dev = on.blocks.get(lb)
            partial = (s > 0 or e < BLOCK) and blk_off < on.size
            shared = (old_dev is not None
                      and self.refcnt.get(old_dev, 1) > 1)
            if partial and old_dev is not None:
                base = bytearray(self._read_dev_block(old_dev))
            else:
                base = bytearray(BLOCK)
            base[s:e] = piece
            content = bytes(base)
            if deferred and old_dev is not None and not shared:
                # deferred small write: merge IN PLACE, payload rides
                # the WAL, no per-block fsync (replay restores it)
                dev = old_dev
            else:
                # redirect-on-write: fresh block (also the COW path
                # for blocks a clone still references)
                dev = self.alloc.alloc(1)[0]
                if old_dev is not None:
                    self._deref(old_dev, ctx)
            if deferred and dev == old_dev:
                # in-place overwrite: must not hit the device until
                # the WAL record is durable
                ctx["deferred"].append((dev, content))
                self._pending[dev] = content
            else:
                pwrites.append((dev, content))
            assign[lb] = dev
            contents.append((dev, content))
            if deferred:
                payloads.append([dev, content.hex()])
        for dev, content in pwrites:
            os.pwrite(self._block_fd, content, dev * BLOCK)
        on.blocks.update(assign)
        # per-block checksums for the whole write extent in ONE batched
        # pass (the per-block scalar call was the last host CRC loop on
        # the block write path)
        csums: dict[int, int] = {
            dev: int(crc) for (dev, _), crc in zip(
                contents, crc32c_batch([b for _, b in contents]))}
        for dev, crc in csums.items():
            self._set_csum(dev, crc)
        on.size = max(on.size, end)
        on.dirty = True
        delta["ops"].append({
            "op": "write", "c": c, "o": oid, "size": on.size,
            "assign": {str(k): v for k, v in assign.items()},
            "csums": {str(k): v for k, v in csums.items()},
            "payloads": payloads if deferred else []})
        if not deferred:
            ctx["sync"] = True

    def _do_truncate(self, c: str, oid: str, size: int,
                     delta: dict, ctx: dict) -> None:
        on = self._onode(c, oid, create=True)
        keep = (size + BLOCK - 1) // BLOCK
        for lb in [b for b in on.blocks if b >= keep]:
            self._deref(on.blocks.pop(lb), ctx)
        if size % BLOCK and size < on.size \
                and size // BLOCK in on.blocks:
            # zero the tail of the last kept block through the write
            # path: it COWs shared blocks and keeps deferred ordering
            self._do_write(c, oid, size,
                           b"\x00" * (BLOCK - size % BLOCK), delta,
                           ctx)
        on.size = size
        on.dirty = True
        delta["ops"].append({"op": "truncate", "c": c, "o": oid,
                             "size": size})

    def _do_clone(self, c: str, src: str, dst: str,
                  delta: dict, ctx: dict) -> None:
        son = self._onode(c, src)
        if son is None:
            return                      # MemStore contract: no-op
        src_omap = self._omap_get(c, src)
        self._free_object(c, dst, ctx)
        don = self._onode(c, dst, create=True)
        don.size = son.size
        don.blocks = dict(son.blocks)
        don.xattrs = dict(son.xattrs)
        don.dirty = True
        self._om_cleared.add((c, dst))
        self._om_dirty[(c, dst)] = dict(src_omap)
        for dev in son.blocks.values():
            self.refcnt[dev] = self.refcnt.get(dev, 1) + 1
        # the record carries the COPIED state: replay must not re-read
        # the source, which a checkpoint that landed before the crash
        # may have advanced past the clone point (idempotent replay)
        delta["ops"].append({
            "op": "clone", "c": c, "o": src, "dst": dst,
            "size": don.size,
            "blocks": {str(k): v for k, v in don.blocks.items()},
            "xattrs": {k: v.hex() for k, v in don.xattrs.items()},
            "omap": {k: v.hex() for k, v in src_omap.items()}})

    def _free_object(self, c: str, oid: str, ctx: dict) -> None:
        on = self._onode(c, oid)
        if on is None:
            return
        for dev in on.blocks.values():
            self._deref(dev, ctx)
        self._oncache.pop((c, oid), None)
        self._removed.add((c, oid))
        self._om_dirty.pop((c, oid), None)
        self._om_cleared.add((c, oid))

    # -- replay / checkpoint --------------------------------------------------
    def _replay_op(self, d: dict) -> None:
        op, c = d["op"], d.get("c")
        oid = d.get("o")
        ctx = {"sync": False, "deferred": [], "to_release": []}
        if op == "mkcoll":
            if c not in self._coll_set:
                self._coll_set.add(c)
                self._coll_dirty[c] = True
        elif op == "rmcoll":
            for o in self._list_objects(c):
                self._free_object(c, o, ctx)
            self._coll_set.discard(c)
            self._coll_dirty[c] = False
        elif op == "touch":
            self._onode(c, oid, create=True)
        elif op == "write":
            on = self._onode(c, oid, create=True)
            assign = {int(k): v for k, v in d["assign"].items()}
            on.blocks.update(assign)
            on.size = max(on.size, d["size"])
            on.dirty = True
            for k, v in d["csums"].items():
                self._set_csum(int(k), v)
            for dev, hexdata in d["payloads"]:
                os.pwrite(self._block_fd, bytes.fromhex(hexdata),
                          dev * BLOCK)
        elif op == "truncate":
            on = self._onode(c, oid, create=True)
            keep = (d["size"] + BLOCK - 1) // BLOCK
            for lb in [b for b in on.blocks if b >= keep]:
                on.blocks.pop(lb)
            on.size = d["size"]
            on.dirty = True
        elif op == "remove":
            on = self._onode(c, oid)
            if on is not None:
                self._oncache.pop((c, oid), None)
                self._removed.add((c, oid))
                self._om_dirty.pop((c, oid), None)
                self._om_cleared.add((c, oid))
        elif op == "clone":
            # self-contained: the record's copied state, never the
            # source's current (possibly post-checkpoint) state
            don = self._onode(c, d["dst"], create=True)
            don.size = d["size"]
            don.blocks = {int(k): v for k, v in d["blocks"].items()}
            don.xattrs = {k: bytes.fromhex(v)
                          for k, v in d["xattrs"].items()}
            don.dirty = True
            self._om_cleared.add((c, d["dst"]))
            self._om_dirty[(c, d["dst"])] = {
                k: bytes.fromhex(v) for k, v in d["omap"].items()}
        elif op == "setattr":
            on = self._onode(c, oid, create=True)
            on.xattrs[d["n"]] = bytes.fromhex(d["v"])
            on.dirty = True
        elif op == "rmattr":
            on = self._onode(c, oid, create=True)
            on.xattrs.pop(d["n"], None)
            on.dirty = True
        elif op == "omap_setkeys":
            self._onode(c, oid, create=True)
            self._om_dirty.setdefault((c, oid), {}).update(
                {k: bytes.fromhex(v) for k, v in d["kv"].items()})
        elif op == "omap_rmkeys":
            self._onode(c, oid, create=True)
            od = self._om_dirty.setdefault((c, oid), {})
            for k in d["keys"]:
                od[k] = None
        elif op == "omap_clear":
            self._onode(c, oid, create=True)
            self._om_cleared.add((c, oid))
            self._om_dirty.pop((c, oid), None)

    def _replay_wal(self) -> int:
        """Apply intact records; returns the byte offset of the first
        torn/corrupt record (the good prefix length)."""
        try:
            with open(self._f("wal"), "rb") as f:
                raw = f.read()
        except FileNotFoundError:
            return 0
        pos = 0
        while pos + 12 <= len(raw):
            if raw[pos:pos + 4] != REC_MAGIC:
                break                   # torn tail: stop cleanly
            ln, want = struct.unpack_from("<II", raw, pos + 4)
            body = raw[pos + 12:pos + 12 + ln]
            if len(body) < ln or _crc(body) != want:
                break                   # torn/corrupt record: stop
            delta = json.loads(body)
            self._seq = max(self._seq, delta["seq"])
            for d in delta["ops"]:
                self._replay_op(d)
            pos += 12 + ln
        return pos

    def _all_onodes(self):
        """(key, onode) for every live object: KV rows shadowed by the
        cache/removed overlay, then dirty cache-only entries."""
        seen = set()
        if self.kv is not None:
            for kraw, blob in self.kv.get_range(P_ONODE):
                c, _, o = kraw.decode().partition("\x00")
                key = (c, o)
                if key in self._removed:
                    continue
                seen.add(key)
                on = self._oncache.get(key)
                yield key, (on if on is not None
                            else _Onode.decode(blob))
        for key, on in list(self._oncache.items()):
            if key not in seen and key not in self._removed:
                yield key, on

    def _rebuild_allocator(self) -> None:
        """Used-block census from the onode maps (mount-time fsck the
        way BlueStore rebuilds its freelist)."""
        used: dict[int, int] = {}
        for _, on in self._all_onodes():
            for dev in on.blocks.values():
                used[dev] = used.get(dev, 0) + 1
        self.refcnt = {b: n for b, n in used.items() if n > 1}
        high = max(used, default=-1) + 1
        self.alloc.high = high
        self.alloc.free = set(range(high)) - set(used)

    def _checkpoint(self) -> None:
        """Flush the dirty overlays -- and ONLY them -- to the KV in
        one atomic batch, then truncate the WAL (BlueStore's kv_sync
        commit; incremental where the old design rewrote everything)."""
        kvt = self.kv.transaction()
        nops = 1
        kvt.set(P_STATE, b"seq", struct.pack("<Q", self._seq))
        for c, exists in self._coll_dirty.items():
            nops += 1
            if exists:
                kvt.set(P_COLL, c.encode(), b"")
            else:
                kvt.rm(P_COLL, c.encode())
        for (c, o) in self._removed:
            nops += 1
            kvt.rm(P_ONODE, _okey(c, o))
        for (c, o) in self._om_cleared:
            nops += 1
            kvt.rm_range(P_OMAP, _mkey(c, o), _mkey(c, o) + b"\xff")
        for key, on in self._oncache.items():
            if on.dirty:
                nops += 1
                kvt.set(P_ONODE, _okey(*key), on.encode())
        for (c, o), od in self._om_dirty.items():
            for k, v in od.items():
                nops += 1
                if v is None:
                    kvt.rm(P_OMAP, _mkey(c, o, k))
                else:
                    kvt.set(P_OMAP, _mkey(c, o, k), v)
        for dev, crc in self._csum_dirty.items():
            nops += 1
            if crc is None:
                kvt.rm(P_CSUM, struct.pack(">Q", dev))
            else:
                kvt.set(P_CSUM, struct.pack(">Q", dev),
                        struct.pack("<I", crc))
        # data must be on disk before the metadata that references it
        os.fsync(self._block_fd)
        self.kv.submit(kvt, sync=True)
        self._last_ckpt_ops = nops
        for on in self._oncache.values():
            on.dirty = False
        self._removed.clear()
        self._om_dirty.clear()
        self._om_cleared.clear()
        self._csum_dirty.clear()
        self._coll_dirty.clear()
        if self._wal_fd >= 0:
            os.ftruncate(self._wal_fd, 0)
            os.fsync(self._wal_fd)
            self._wal_size = 0
        else:
            with open(self._f("wal"), "wb"):
                pass
        # the WAL no longer references any freed block: quarantined
        # frees are finally safe to hand back to the allocator
        if self._quarantine:
            self.alloc.release(self._quarantine)
            self._quarantine.clear()
        self._evict()

    # -- reads ----------------------------------------------------------------
    def read(self, coll, oid, offset=0, length=None):
        from ..common.throttle import injector
        injector.maybe_raise("objectstore_read")   # EIO injection site
        # reads mutate the shared LRU caches (move_to_end / insert /
        # evict), so they serialize with writers on the same lock the
        # txn path holds -- the pre-KV design's lock-free reads were
        # pure dict lookups, these are not
        with self._txn_lock:
            self._ensure()
            return self._read_locked(coll, oid, offset, length)

    def _read_locked(self, coll, oid, offset=0, length=None):
        on = self._onode(coll, oid)
        if coll not in self._coll_set or on is None:
            raise FileNotFoundError(f"{coll}/{oid}")
        if length is None:
            length = max(0, on.size - offset)
        length = max(0, min(length, on.size - offset))
        if length == 0:
            return b""
        import numpy as np
        lb0, lb1 = offset // BLOCK, (offset + length + BLOCK - 1) // BLOCK
        nblk = lb1 - lb0
        # ONE materialization for the whole extent: device blocks land
        # directly into a (nblk, BLOCK) buffer (contiguous device runs
        # collapse to single preads), and checksum-on-read verifies
        # row views of that SAME buffer in one batched crc32c_rows pass
        # -- the old path built a bytes object per 4 KiB block and
        # re-marshaled them all into the batched CRC call.  Pending-
        # overlay blocks carry this txn's in-memory content and are
        # exempt from verify, as before.
        out = np.zeros(nblk * BLOCK, np.uint8)
        fills: list[tuple[int, int]] = []        # (row, dev) to pread
        for lb in range(lb0, lb1):
            dev = on.blocks.get(lb)
            if dev is None:
                continue                         # hole: stays zeros
            row = lb - lb0
            pend = self._pending.get(dev)
            if pend is not None:
                out[row * BLOCK:(row + 1) * BLOCK] = \
                    np.frombuffer(pend, np.uint8)
                continue
            fills.append((row, dev))
        i = 0
        while i < len(fills):                    # coalesce device runs
            j = i + 1
            while j < len(fills) \
                    and fills[j][0] == fills[j - 1][0] + 1 \
                    and fills[j][1] == fills[j - 1][1] + 1:
                j += 1
            row0, dev0 = fills[i]
            buf = os.pread(self._block_fd, (j - i) * BLOCK,
                           dev0 * BLOCK)
            out[row0 * BLOCK:row0 * BLOCK + len(buf)] = \
                np.frombuffer(buf, np.uint8)     # short read: zeros
            i = j
        rows = out.reshape(nblk, BLOCK)
        verify: list[tuple[int, int, int]] = []  # (row, dev, want)
        for row, dev in fills:
            want = self._get_csum(dev)
            if want is not None:
                verify.append((row, dev, want))
        if verify:
            if len(verify) == nblk:
                crcs = crc32c_rows(rows)
            else:
                crcs = crc32c_rows(
                    rows[np.fromiter((r for r, _, _ in verify),
                                     np.intp, count=len(verify))])
            for (_, dev, want), got in zip(verify, crcs):
                if int(got) != want:
                    raise IOError(
                        f"checksum mismatch on device block {dev}")
        s = offset - lb0 * BLOCK
        return out[s:s + length].tobytes()

    def stat(self, coll, oid):
        with self._txn_lock:
            self._ensure()
            on = self._onode(coll, oid)
            if coll not in self._coll_set or on is None:
                return None
            return {"size": on.size}

    def getattr(self, coll, oid, name):
        with self._txn_lock:
            self._ensure()
            on = self._onode(coll, oid)
            return None if on is None else on.xattrs.get(name)

    def getattrs(self, coll, oid):
        with self._txn_lock:
            self._ensure()
            on = self._onode(coll, oid)
            return {} if on is None else dict(on.xattrs)

    def omap_get(self, coll, oid):
        with self._txn_lock:
            self._ensure()
            return self._omap_get(coll, oid)

    def _omap_get(self, coll, oid):
        key = (coll, oid)
        out: dict[str, bytes] = {}
        if key not in self._om_cleared and key not in self._removed \
                and self.kv is not None:
            base = _mkey(coll, oid)
            for kraw, v in self.kv.get_range(P_OMAP, base,
                                             base + b"\xff"):
                out[kraw[len(base):].decode()] = v
        for k, v in self._om_dirty.get(key, {}).items():
            if v is None:
                out.pop(k, None)
            else:
                out[k] = v
        return out

    def list_collections(self):
        with self._txn_lock:
            self._ensure()
            return sorted(self._coll_set)

    def list_objects(self, coll):
        with self._txn_lock:
            self._ensure()
            return self._list_objects(coll)

    def _list_objects(self, coll):
        names = set()
        if self.kv is not None:
            pref = f"{coll}\x00".encode()
            for kraw, _ in self.kv.get_range(P_ONODE, pref,
                                             pref + b"\xff"):
                names.add(kraw[len(pref):].decode())
        for (c, o), on in self._oncache.items():
            if c == coll and on.dirty:
                names.add(o)
        names -= {o for (c, o) in self._removed if c == coll}
        return sorted(names)

    def list_objects_range(self, coll, begin, limit):
        with self._txn_lock:
            self._ensure()
            names = [o for o in self._list_objects(coll) if o > begin]
            return names[:limit]

    def collection_exists(self, coll):
        with self._txn_lock:
            self._ensure()
            return coll in self._coll_set
