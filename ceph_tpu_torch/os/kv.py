"""KeyValueDB: the ordered-KV abstraction behind the object stores.

Port of ``ceph_tpu/os/kv.py``, copied: host code with no device
hop.

src/kv/KeyValueDB.h role: stores talk to an interface (get / ordered
iteration / atomic write batches over prefixed namespaces), never to a
concrete engine.  The reference ships RocksDB behind it; here the
default engine is sqlite (baked into the image) with an in-memory
engine for tests -- and the contract is narrow enough that a RocksDB
or LMDB engine drops in without touching the stores.

Prefixes partition the keyspace the way the reference's column-family
prefixes do (BlueStore's O/ M / C namespaces).  Keys are bytes and
iterate in lexicographic order within a prefix.
"""

from __future__ import annotations

import os
import sqlite3
import threading
from typing import Iterator


class KVTransaction:
    """An atomic write batch (KeyValueDB::Transaction).  Ops apply in
    order; the whole batch commits or none of it does."""

    def __init__(self) -> None:
        self.ops: list[tuple] = []

    def set(self, prefix: str, key: bytes, value: bytes) -> "KVTransaction":
        self.ops.append(("set", prefix, bytes(key), bytes(value)))
        return self

    def rm(self, prefix: str, key: bytes) -> "KVTransaction":
        self.ops.append(("rm", prefix, bytes(key)))
        return self

    def rm_range(self, prefix: str, start: bytes,
                 end: bytes | None) -> "KVTransaction":
        """Remove [start, end) within prefix; end=None means to the
        prefix's end."""
        self.ops.append(("rm_range", prefix, bytes(start),
                         None if end is None else bytes(end)))
        return self


class KeyValueDB:
    """Engine interface.  All methods are thread-safe per engine."""

    def get(self, prefix: str, key: bytes) -> bytes | None:
        raise NotImplementedError

    def get_range(self, prefix: str, start: bytes = b"",
                  end: bytes | None = None,
                  limit: int | None = None
                  ) -> Iterator[tuple[bytes, bytes]]:
        """Ordered iteration over [start, end) within prefix."""
        raise NotImplementedError

    def transaction(self) -> KVTransaction:
        return KVTransaction()

    def submit(self, txn: KVTransaction, sync: bool = True) -> None:
        """Apply the batch atomically; sync=True means durable on
        return (the kv_sync_thread contract)."""
        raise NotImplementedError

    def close(self) -> None:
        pass


class MemKVDB(KeyValueDB):
    """Ordered in-memory engine (tests / MemStore)."""

    def __init__(self) -> None:
        self._data: dict[str, dict[bytes, bytes]] = {}
        self._lock = threading.Lock()

    def get(self, prefix, key):
        with self._lock:
            return self._data.get(prefix, {}).get(bytes(key))

    def get_range(self, prefix, start=b"", end=None, limit=None):
        with self._lock:
            keys = sorted(k for k in self._data.get(prefix, {})
                          if k >= start and (end is None or k < end))
            if limit is not None:
                keys = keys[:limit]
            items = [(k, self._data[prefix][k]) for k in keys]
        yield from items

    def submit(self, txn, sync=True):
        with self._lock:
            for op in txn.ops:
                if op[0] == "set":
                    self._data.setdefault(op[1], {})[op[2]] = op[3]
                elif op[0] == "rm":
                    self._data.get(op[1], {}).pop(op[2], None)
                elif op[0] == "rm_range":
                    d = self._data.get(op[1], {})
                    for k in [k for k in d
                              if k >= op[2] and (op[3] is None
                                                 or k < op[3])]:
                        del d[k]


class SqliteKVDB(KeyValueDB):
    """sqlite engine: one table, (prefix, key) primary key, WAL mode.

    The BlueStore checkpoint path calls submit(sync=True) rarely and
    in large batches, which is exactly the shape sqlite's WAL likes.
    """

    def __init__(self, path: str) -> None:
        self.path = path
        if os.path.dirname(path):
            os.makedirs(os.path.dirname(path), exist_ok=True)
        self._local = threading.local()
        conn = self._conn()
        with conn:
            conn.execute(
                "CREATE TABLE IF NOT EXISTS kv ("
                "prefix TEXT NOT NULL, key BLOB NOT NULL, "
                "value BLOB NOT NULL, PRIMARY KEY (prefix, key)) "
                "WITHOUT ROWID")

    def _conn(self) -> sqlite3.Connection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = sqlite3.connect(self.path, timeout=30)
            conn.execute("PRAGMA journal_mode=WAL")
            conn.execute("PRAGMA synchronous=FULL")
            self._local.conn = conn
        return conn

    def get(self, prefix, key):
        row = self._conn().execute(
            "SELECT value FROM kv WHERE prefix=? AND key=?",
            (prefix, bytes(key))).fetchone()
        return None if row is None else row[0]

    def get_range(self, prefix, start=b"", end=None, limit=None):
        q = "SELECT key, value FROM kv WHERE prefix=? AND key>=?"
        args: list = [prefix, bytes(start)]
        if end is not None:
            q += " AND key<?"
            args.append(bytes(end))
        q += " ORDER BY key"
        if limit is not None:
            q += " LIMIT ?"
            args.append(limit)
        cur = self._conn().execute(q, args)
        while True:
            rows = cur.fetchmany(256)
            if not rows:
                return
            yield from rows

    def submit(self, txn, sync=True):
        conn = self._conn()
        with conn:
            for op in txn.ops:
                if op[0] == "set":
                    conn.execute(
                        "INSERT OR REPLACE INTO kv VALUES (?,?,?)",
                        (op[1], op[2], op[3]))
                elif op[0] == "rm":
                    conn.execute(
                        "DELETE FROM kv WHERE prefix=? AND key=?",
                        (op[1], op[2]))
                elif op[0] == "rm_range":
                    if op[3] is None:
                        conn.execute(
                            "DELETE FROM kv WHERE prefix=? AND key>=?",
                            (op[1], op[2]))
                    else:
                        conn.execute(
                            "DELETE FROM kv WHERE prefix=? AND "
                            "key>=? AND key<?", (op[1], op[2], op[3]))

    def close(self):
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            conn.close()
            self._local.conn = None
