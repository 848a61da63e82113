"""ObjectStore backends: MemStore (RAM) and DBStore (SQLite WAL).

Port of ``ceph_tpu/os/store.py``, copied: host code with no device
hop.

DBStore plays BlueStore's role at this framework's scale: a single
transactional store with write-ahead logging gives the atomic
data+metadata commit the OSD relies on for log-based recovery
(the reference gets this from RocksDB WAL + deferred writes,
src/os/bluestore/BlueStore.cc:15334 queue_transactions).
"""

from __future__ import annotations

import os
import sqlite3
import threading
from typing import Iterable

from .transaction import Transaction


class ObjectStore:
    """Abstract store: collections of objects (data, xattrs, omap)."""

    # device-resident shard cache (os/device_cache.py), attached by the
    # OSD.  EVERY implementation must call _note_txn_for_cache() before
    # applying a transaction: the store boundary is where ALL mutation
    # paths (client writes, recovery pushes, scrub repair, test bit-rot
    # injection) converge, so invalidating here is what makes the cache
    # provably coherent with stored bytes.
    shard_cache = None

    def attach_shard_cache(self, cache) -> None:
        self.shard_cache = cache

    def _note_txn_for_cache(self, txn: Transaction) -> None:
        if self.shard_cache is not None:
            self.shard_cache.note_txn(txn)

    def mount(self) -> None: ...
    def umount(self) -> None: ...

    def queue_transaction(self, txn: Transaction) -> None:
        raise NotImplementedError

    # reads
    def read(self, coll: str, oid: str, offset: int = 0,
             length: int | None = None) -> bytes:
        raise NotImplementedError

    def stat(self, coll: str, oid: str) -> dict | None:
        raise NotImplementedError

    def exists(self, coll: str, oid: str) -> bool:
        return self.stat(coll, oid) is not None

    def getattr(self, coll: str, oid: str, name: str) -> bytes | None:
        raise NotImplementedError

    def getattrs(self, coll: str, oid: str) -> dict[str, bytes]:
        raise NotImplementedError

    def omap_get(self, coll: str, oid: str) -> dict[str, bytes]:
        raise NotImplementedError

    def omap_get_keys(self, coll: str, oid: str,
                      keys: Iterable[str]) -> dict[str, bytes]:
        omap = self.omap_get(coll, oid)
        return {k: omap[k] for k in keys if k in omap}

    def list_collections(self) -> list[str]:
        raise NotImplementedError

    def list_objects(self, coll: str) -> list[str]:
        raise NotImplementedError

    def list_objects_range(self, coll: str, begin: str,
                           limit: int) -> list[str]:
        """Up to ``limit`` object names > ``begin`` in name order.

        Backends override with an indexed scan; the fallback sorts the
        full listing (correct, O(N log N) per page)."""
        names = sorted(o for o in self.list_objects(coll) if o > begin)
        return names[:limit]

    def collection_exists(self, coll: str) -> bool:
        return coll in self.list_collections()


class _MemObject:
    __slots__ = ("data", "xattrs", "omap")

    def __init__(self) -> None:
        self.data = bytearray()
        self.xattrs: dict[str, bytes] = {}
        self.omap: dict[str, bytes] = {}

    def clone(self) -> "_MemObject":
        o = _MemObject()
        o.data = bytearray(self.data)
        o.xattrs = dict(self.xattrs)
        o.omap = dict(self.omap)
        return o


class MemStore(ObjectStore):
    def __init__(self) -> None:
        self._colls: dict[str, dict[str, _MemObject]] = {}
        self._lock = threading.Lock()

    def queue_transaction(self, txn: Transaction) -> None:
        with self._lock:
            # validate-then-apply gives all-or-nothing on the common
            # failure modes (missing collection); mkcolls earlier in the
            # same txn count
            pending = set(self._colls)
            for op in txn.ops:
                if op.op == "mkcoll":
                    pending.add(op.coll)
                elif op.coll not in pending:
                    raise KeyError(f"no collection {op.coll}")
            self._note_txn_for_cache(txn)
            for op in txn.ops:
                self._apply(op)

    def _obj(self, coll: str, oid: str) -> _MemObject:
        objs = self._colls[coll]
        if oid not in objs:
            objs[oid] = _MemObject()
        return objs[oid]

    def _apply(self, op) -> None:
        if op.op == "mkcoll":
            self._colls.setdefault(op.coll, {})
        elif op.op == "rmcoll":
            self._colls.pop(op.coll, None)
        elif op.op == "touch":
            self._obj(op.coll, op.oid)
        elif op.op == "write":
            o = self._obj(op.coll, op.oid)
            off, data = op.args["offset"], op.args["data"]
            if len(o.data) < off:
                o.data.extend(b"\x00" * (off - len(o.data)))
            o.data[off:off + len(data)] = data
        elif op.op == "zero":
            o = self._obj(op.coll, op.oid)
            off, ln = op.args["offset"], op.args["length"]
            if len(o.data) < off + ln:
                o.data.extend(b"\x00" * (off + ln - len(o.data)))
            o.data[off:off + ln] = b"\x00" * ln
        elif op.op == "truncate":
            o = self._obj(op.coll, op.oid)
            size = op.args["size"]
            if len(o.data) > size:
                del o.data[size:]
            else:
                o.data.extend(b"\x00" * (size - len(o.data)))
        elif op.op == "remove":
            self._colls[op.coll].pop(op.oid, None)
        elif op.op == "clone":
            src = self._colls[op.coll].get(op.oid)
            if src is not None:
                self._colls[op.coll][op.args["dst"]] = src.clone()
        elif op.op == "setattr":
            self._obj(op.coll, op.oid).xattrs[op.args["name"]] = \
                op.args["value"]
        elif op.op == "rmattr":
            self._obj(op.coll, op.oid).xattrs.pop(op.args["name"], None)
        elif op.op == "omap_setkeys":
            self._obj(op.coll, op.oid).omap.update(op.args["kv"])
        elif op.op == "omap_rmkeys":
            o = self._obj(op.coll, op.oid)
            for k in op.args["keys"]:
                o.omap.pop(k, None)
        elif op.op == "omap_clear":
            self._obj(op.coll, op.oid).omap.clear()
        else:
            raise ValueError(f"unknown op {op.op}")

    def read(self, coll, oid, offset=0, length=None):
        from ..common.throttle import injector
        injector.maybe_raise("objectstore_read")   # EIO injection site
        o = self._colls.get(coll, {}).get(oid)
        if o is None:
            raise FileNotFoundError(f"{coll}/{oid}")
        end = len(o.data) if length is None else offset + length
        return bytes(o.data[offset:end])

    def stat(self, coll, oid):
        o = self._colls.get(coll, {}).get(oid)
        if o is None:
            return None
        return {"size": len(o.data)}

    def getattr(self, coll, oid, name):
        o = self._colls.get(coll, {}).get(oid)
        return None if o is None else o.xattrs.get(name)

    def getattrs(self, coll, oid):
        o = self._colls.get(coll, {}).get(oid)
        return {} if o is None else dict(o.xattrs)

    def omap_get(self, coll, oid):
        o = self._colls.get(coll, {}).get(oid)
        return {} if o is None else dict(o.omap)

    def list_collections(self):
        return sorted(self._colls)

    def list_objects(self, coll):
        return sorted(self._colls.get(coll, {}))

    def list_objects_range(self, coll, begin, limit):
        import heapq
        return heapq.nsmallest(
            limit, (o for o in self._colls.get(coll, {}) if o > begin))


class DBStore(ObjectStore):
    """SQLite-WAL-backed store: one DB file per OSD.

    Schema: objects(coll, oid, data BLOB), xattrs, omap -- all mutations
    for one Transaction commit in one SQLite transaction (atomicity =
    crash consistency; WAL mode keeps commits sequential-write-friendly).
    """

    def __init__(self, path: str) -> None:
        self.path = path
        self._local = threading.local()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._init_schema()

    def _conn(self) -> sqlite3.Connection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = sqlite3.connect(self.path, timeout=30)
            conn.execute("PRAGMA journal_mode=WAL")
            conn.execute("PRAGMA synchronous=NORMAL")
            self._local.conn = conn
        return conn

    def _init_schema(self) -> None:
        conn = self._conn()
        with conn:
            conn.execute(
                "CREATE TABLE IF NOT EXISTS colls (coll TEXT PRIMARY KEY)")
            conn.execute(
                "CREATE TABLE IF NOT EXISTS objects ("
                "coll TEXT, oid TEXT, data BLOB NOT NULL DEFAULT x'', "
                "PRIMARY KEY (coll, oid))")
            conn.execute(
                "CREATE TABLE IF NOT EXISTS xattrs ("
                "coll TEXT, oid TEXT, name TEXT, value BLOB, "
                "PRIMARY KEY (coll, oid, name))")
            conn.execute(
                "CREATE TABLE IF NOT EXISTS omap ("
                "coll TEXT, oid TEXT, key TEXT, value BLOB, "
                "PRIMARY KEY (coll, oid, key))")

    def queue_transaction(self, txn: Transaction) -> None:
        self._note_txn_for_cache(txn)
        conn = self._conn()
        with conn:
            for op in txn.ops:
                self._apply(conn, op)

    def _get_data(self, conn, coll, oid) -> bytearray | None:
        row = conn.execute(
            "SELECT data FROM objects WHERE coll=? AND oid=?",
            (coll, oid)).fetchone()
        return None if row is None else bytearray(row[0])

    def _put_data(self, conn, coll, oid, data: bytes) -> None:
        conn.execute(
            "INSERT INTO objects (coll, oid, data) VALUES (?,?,?) "
            "ON CONFLICT(coll, oid) DO UPDATE SET data=excluded.data",
            (coll, oid, bytes(data)))

    def _apply(self, conn, op) -> None:
        if op.op == "mkcoll":
            conn.execute("INSERT OR IGNORE INTO colls VALUES (?)", (op.coll,))
            return
        if op.op == "rmcoll":
            conn.execute("DELETE FROM colls WHERE coll=?", (op.coll,))
            for t in ("objects", "xattrs", "omap"):
                conn.execute(f"DELETE FROM {t} WHERE coll=?", (op.coll,))
            return
        row = conn.execute("SELECT 1 FROM colls WHERE coll=?",
                           (op.coll,)).fetchone()
        if row is None:
            raise KeyError(f"no collection {op.coll}")
        if op.op == "touch":
            if self._get_data(conn, op.coll, op.oid) is None:
                self._put_data(conn, op.coll, op.oid, b"")
        elif op.op == "write":
            data = self._get_data(conn, op.coll, op.oid) or bytearray()
            off, buf = op.args["offset"], op.args["data"]
            if len(data) < off:
                data.extend(b"\x00" * (off - len(data)))
            data[off:off + len(buf)] = buf
            self._put_data(conn, op.coll, op.oid, data)
        elif op.op == "zero":
            data = self._get_data(conn, op.coll, op.oid) or bytearray()
            off, ln = op.args["offset"], op.args["length"]
            if len(data) < off + ln:
                data.extend(b"\x00" * (off + ln - len(data)))
            data[off:off + ln] = b"\x00" * ln
            self._put_data(conn, op.coll, op.oid, data)
        elif op.op == "truncate":
            data = self._get_data(conn, op.coll, op.oid) or bytearray()
            size = op.args["size"]
            if len(data) > size:
                del data[size:]
            else:
                data.extend(b"\x00" * (size - len(data)))
            self._put_data(conn, op.coll, op.oid, data)
        elif op.op == "remove":
            conn.execute("DELETE FROM objects WHERE coll=? AND oid=?",
                         (op.coll, op.oid))
            conn.execute("DELETE FROM xattrs WHERE coll=? AND oid=?",
                         (op.coll, op.oid))
            conn.execute("DELETE FROM omap WHERE coll=? AND oid=?",
                         (op.coll, op.oid))
        elif op.op == "clone":
            dst = op.args["dst"]
            data = self._get_data(conn, op.coll, op.oid)
            if data is not None:
                self._put_data(conn, op.coll, dst, data)
                for t in ("xattrs", "omap"):
                    conn.execute(
                        f"DELETE FROM {t} WHERE coll=? AND oid=?",
                        (op.coll, dst))
                conn.execute(
                    "INSERT INTO xattrs SELECT coll, ?, name, value "
                    "FROM xattrs WHERE coll=? AND oid=?",
                    (dst, op.coll, op.oid))
                conn.execute(
                    "INSERT INTO omap SELECT coll, ?, key, value "
                    "FROM omap WHERE coll=? AND oid=?",
                    (dst, op.coll, op.oid))
        elif op.op == "setattr":
            conn.execute(
                "INSERT INTO xattrs VALUES (?,?,?,?) "
                "ON CONFLICT(coll, oid, name) "
                "DO UPDATE SET value=excluded.value",
                (op.coll, op.oid, op.args["name"], op.args["value"]))
        elif op.op == "rmattr":
            conn.execute(
                "DELETE FROM xattrs WHERE coll=? AND oid=? AND name=?",
                (op.coll, op.oid, op.args["name"]))
        elif op.op == "omap_setkeys":
            for k, v in op.args["kv"].items():
                conn.execute(
                    "INSERT INTO omap VALUES (?,?,?,?) "
                    "ON CONFLICT(coll, oid, key) "
                    "DO UPDATE SET value=excluded.value",
                    (op.coll, op.oid, k, v))
        elif op.op == "omap_rmkeys":
            for k in op.args["keys"]:
                conn.execute(
                    "DELETE FROM omap WHERE coll=? AND oid=? AND key=?",
                    (op.coll, op.oid, k))
        elif op.op == "omap_clear":
            conn.execute("DELETE FROM omap WHERE coll=? AND oid=?",
                         (op.coll, op.oid))
        else:
            raise ValueError(f"unknown op {op.op}")

    def read(self, coll, oid, offset=0, length=None):
        from ..common.throttle import injector
        injector.maybe_raise("objectstore_read")   # EIO injection site
        data = self._get_data(self._conn(), coll, oid)
        if data is None:
            raise FileNotFoundError(f"{coll}/{oid}")
        end = len(data) if length is None else offset + length
        return bytes(data[offset:end])

    def stat(self, coll, oid):
        row = self._conn().execute(
            "SELECT length(data) FROM objects WHERE coll=? AND oid=?",
            (coll, oid)).fetchone()
        return None if row is None else {"size": row[0]}

    def getattr(self, coll, oid, name):
        row = self._conn().execute(
            "SELECT value FROM xattrs WHERE coll=? AND oid=? AND name=?",
            (coll, oid, name)).fetchone()
        return None if row is None else row[0]

    def getattrs(self, coll, oid):
        rows = self._conn().execute(
            "SELECT name, value FROM xattrs WHERE coll=? AND oid=?",
            (coll, oid)).fetchall()
        return {r[0]: r[1] for r in rows}

    def omap_get(self, coll, oid):
        rows = self._conn().execute(
            "SELECT key, value FROM omap WHERE coll=? AND oid=?",
            (coll, oid)).fetchall()
        return {r[0]: r[1] for r in rows}

    def list_collections(self):
        return [r[0] for r in self._conn().execute(
            "SELECT coll FROM colls ORDER BY coll")]

    def list_objects(self, coll):
        return [r[0] for r in self._conn().execute(
            "SELECT oid FROM objects WHERE coll=? ORDER BY oid", (coll,))]

    def list_objects_range(self, coll, begin, limit):
        return [r[0] for r in self._conn().execute(
            "SELECT oid FROM objects WHERE coll=? AND oid>? "
            "ORDER BY oid LIMIT ?", (coll, begin, limit))]


def make_default_store():
    """Store factory for daemons booted without an explicit store.

    CEPH_TPU_STORE selects the backend: "mem" (default),
    "block" (BlockStore in a fresh directory under
    $CEPH_TPU_STORE_DIR, else the temporary directory), or "block:<dir>"
    (that directory -- a restart on the same dir remounts the same
    data)."""
    import os as _os
    spec = _os.environ.get("CEPH_TPU_STORE", "mem")
    if spec == "mem":
        return MemStore()
    if spec == "block" or spec.startswith("block:"):
        from .blockstore import BlockStore
        _, _, path = spec.partition(":")
        if not path:
            import tempfile
            base = _os.environ.get("CEPH_TPU_STORE_DIR")
            path = tempfile.mkdtemp(prefix="ceph_tpu_bs_", dir=base)
        return BlockStore(path)
    raise ValueError(f"unknown CEPH_TPU_STORE {spec!r}")
