"""KVStore: an ObjectStore kept entirely in a KeyValueDB.

Port of ``ceph_tpu/os/kvstore.py``, copied: host code with no device
hop.

The kstore analog (src/os/kstore/KStore.cc): every object -- data,
xattrs, omap -- lives as rows in the ordered KV behind the KeyValueDB
interface (os/kv.py), and each Transaction becomes ONE atomic KV batch
(atomicity = crash consistency, no separate WAL needed).  Not the
performance store (BlockStore is); it exists because a pure-KV engine
is the simplest correct store and exercises the same KeyValueDB
contract a RocksDB engine would.

Data layout: object payload is chunked into fixed KV rows so partial
writes rewrite only the touched stripes (KStore's stripe_size).
"""

from __future__ import annotations

import struct
import threading

from .kv import KeyValueDB, MemKVDB, SqliteKVDB
from .store import ObjectStore
from .transaction import Transaction

STRIPE = 65536            # kstore stripe_size: data row granularity

P_DATA = "D"              # c\0o\0u64be(stripe) -> bytes
P_META = "O"              # c\0o -> size u64le
P_XATTR = "X"             # c\0o\0name -> bytes
P_OMAP = "M"              # c\0o\0key -> bytes
P_COLL = "L"              # coll -> b""


def _k(c: str, o: str, tail: bytes = b"") -> bytes:
    base = f"{c}\x00{o}".encode()
    return base + (b"\x00" + tail if tail else b"")


def _stripe_key(c: str, o: str, idx: int) -> bytes:
    return _k(c, o, struct.pack(">Q", idx))


class KVStore(ObjectStore):
    def __init__(self, path: str | None = None,
                 kv: KeyValueDB | None = None) -> None:
        if kv is not None:
            self.kv = kv
        elif path is None or path == ":memory:":
            self.kv = MemKVDB()
        else:
            self.kv = SqliteKVDB(path)
        self._lock = threading.Lock()

    def mount(self) -> None:
        pass

    def umount(self) -> None:
        self.kv.close()

    # -- transactions --------------------------------------------------------
    def queue_transaction(self, txn: Transaction) -> None:
        with self._lock:
            colls = {k.decode()
                     for k, _ in self.kv.get_range(P_COLL)}
            for op in txn.ops:
                if op.op == "mkcoll":
                    colls.add(op.coll)
                elif op.coll not in colls:
                    raise KeyError(f"no collection {op.coll}")
            kvt = self.kv.transaction()
            for op in txn.ops:
                self._apply(kvt, op)
            self.kv.submit(kvt, sync=True)

    def _size(self, c: str, o: str) -> int | None:
        raw = self.kv.get(P_META, _k(c, o))
        return None if raw is None else struct.unpack("<Q", raw)[0]

    def _size_in(self, kvt, c: str, o: str) -> int | None:
        """Size as seen by the txn so far: later ops in one batch must
        observe earlier staged writes, not just the committed KV."""
        key = _k(c, o)
        for op in reversed(kvt.ops):
            if op[1] != P_META:
                continue
            if op[0] == "set" and op[2] == key:
                return struct.unpack("<Q", op[3])[0]
            if op[0] == "rm" and op[2] == key:
                return None
        return self._size(c, o)

    def _merged_range(self, kvt, prefix: str, start: bytes,
                      end: bytes) -> dict[bytes, bytes]:
        """Committed rows in [start, end) with the batch's staged ops
        applied in order (set/rm/rm_range)."""
        out = dict(self.kv.get_range(prefix, start, end))
        for op in kvt.ops:
            if op[1] != prefix:
                continue
            if op[0] == "set" and start <= op[2] < end:
                out[op[2]] = op[3]
            elif op[0] == "rm" and start <= op[2] < end:
                out.pop(op[2], None)
            elif op[0] == "rm_range":
                for k in [k for k in out
                          if k >= op[2] and (op[3] is None
                                             or k < op[3])]:
                    del out[k]
        return out

    def _set_size(self, kvt, c: str, o: str, size: int) -> None:
        kvt.set(P_META, _k(c, o), struct.pack("<Q", size))

    def _rm_object(self, kvt, c: str, o: str) -> None:
        kvt.rm(P_META, _k(c, o))
        for pref in (P_DATA, P_XATTR, P_OMAP):
            kvt.rm_range(pref, _k(c, o) + b"\x00",
                         _k(c, o) + b"\x00\xff")

    def _read_stripe(self, c: str, o: str, idx: int) -> bytes:
        raw = self.kv.get(P_DATA, _stripe_key(c, o, idx))
        return raw if raw is not None else b""

    def _apply(self, kvt, op) -> None:
        c, o, a = op.coll, op.oid, op.args
        if op.op == "mkcoll":
            kvt.set(P_COLL, c.encode(), b"")
        elif op.op == "rmcoll":
            pref = f"{c}\x00".encode()
            for k in self._merged_range(kvt, P_META, pref,
                                        pref + b"\xff"):
                self._rm_object(kvt, c, k[len(pref):].decode())
            kvt.rm(P_COLL, c.encode())
        elif op.op == "touch":
            if self._size_in(kvt, c, o) is None:
                self._set_size(kvt, c, o, 0)
        elif op.op == "write":
            self._write(kvt, c, o, a["offset"], a["data"])
        elif op.op == "zero":
            self._write(kvt, c, o, a["offset"],
                        b"\x00" * a["length"])
        elif op.op == "truncate":
            size = a["size"]
            old = self._size_in(kvt, c, o) or 0
            first_dead = (size + STRIPE - 1) // STRIPE
            kvt.rm_range(P_DATA, _stripe_key(c, o, first_dead),
                         _k(c, o) + b"\x00\xff")
            if size % STRIPE and size < old:
                idx = size // STRIPE
                key = _stripe_key(c, o, idx)
                st = self._merged_range(kvt, P_DATA, key,
                                        key + b"\x00").get(key, b"")
                kvt.set(P_DATA, key, st[:size % STRIPE])
            self._set_size(kvt, c, o, size)
        elif op.op == "remove":
            self._rm_object(kvt, c, o)
        elif op.op == "clone":
            dst = a["dst"]
            src_size = self._size_in(kvt, c, o)
            if src_size is None:
                return
            self._rm_object(kvt, c, dst)
            for pref in (P_DATA, P_XATTR, P_OMAP):
                base = _k(c, o) + b"\x00"
                for k, v in self._merged_range(
                        kvt, pref, base, base + b"\xff").items():
                    kvt.set(pref, _k(c, dst) + b"\x00"
                            + k[len(base):], v)
            self._set_size(kvt, c, dst, src_size)
        elif op.op == "setattr":
            if self._size_in(kvt, c, o) is None:
                self._set_size(kvt, c, o, 0)
            kvt.set(P_XATTR, _k(c, o, a["name"].encode()), a["value"])
        elif op.op == "rmattr":
            kvt.rm(P_XATTR, _k(c, o, a["name"].encode()))
        elif op.op == "omap_setkeys":
            if self._size_in(kvt, c, o) is None:
                self._set_size(kvt, c, o, 0)
            for k, v in a["kv"].items():
                kvt.set(P_OMAP, _k(c, o, k.encode()), v)
        elif op.op == "omap_rmkeys":
            for k in a["keys"]:
                kvt.rm(P_OMAP, _k(c, o, k.encode()))
        elif op.op == "omap_clear":
            kvt.rm_range(P_OMAP, _k(c, o) + b"\x00",
                         _k(c, o) + b"\x00\xff")
        else:
            raise ValueError(f"unknown op {op.op}")

    def _write(self, kvt, c: str, o: str, offset: int,
               data: bytes) -> None:
        end = offset + len(data)
        i0, i1 = offset // STRIPE, (end + STRIPE - 1) // STRIPE
        # batch-local overlay: two writes to one stripe in a single
        # txn must compose (the second reads the first's bytes, which
        # are not in the KV yet); bounded to the TOUCHED stripes, not
        # the whole object
        staged = self._merged_range(kvt, P_DATA,
                                    _stripe_key(c, o, i0),
                                    _stripe_key(c, o, i1))
        for i in range(i0, i1):
            base_off = i * STRIPE
            s = max(offset, base_off) - base_off
            e = min(end, base_off + STRIPE) - base_off
            key = _stripe_key(c, o, i)
            prev = staged.get(key)
            if prev is None:
                prev = self._read_stripe(c, o, i)
            st = bytearray(prev.ljust(e, b"\x00"))
            st[s:e] = data[max(offset, base_off) - offset:
                           min(end, base_off + STRIPE) - offset]
            kvt.set(P_DATA, key, bytes(st))
        old = self._size_in(kvt, c, o) or 0
        self._set_size(kvt, c, o, max(old, end))

    # -- reads ----------------------------------------------------------------
    def read(self, coll, oid, offset=0, length=None):
        from ..common.throttle import injector
        injector.maybe_raise("objectstore_read")   # EIO injection site
        size = self._size(coll, oid)
        if size is None:
            raise FileNotFoundError(f"{coll}/{oid}")
        if length is None:
            length = max(0, size - offset)
        length = max(0, min(length, size - offset))
        if length == 0:
            return b""
        out = bytearray()
        i0, i1 = offset // STRIPE, (offset + length + STRIPE - 1) // STRIPE
        for i in range(i0, i1):
            out += self._read_stripe(coll, oid, i).ljust(STRIPE, b"\x00")
        s = offset - i0 * STRIPE
        return bytes(out[s:s + length])

    def stat(self, coll, oid):
        size = self._size(coll, oid)
        return None if size is None else {"size": size}

    def getattr(self, coll, oid, name):
        return self.kv.get(P_XATTR, _k(coll, oid, name.encode()))

    def getattrs(self, coll, oid):
        base = _k(coll, oid) + b"\x00"
        return {k[len(base):].decode(): v
                for k, v in self.kv.get_range(P_XATTR, base,
                                              base + b"\xff")}

    def omap_get(self, coll, oid):
        base = _k(coll, oid) + b"\x00"
        return {k[len(base):].decode(): v
                for k, v in self.kv.get_range(P_OMAP, base,
                                              base + b"\xff")}

    def list_collections(self):
        return sorted(k.decode() for k, _ in self.kv.get_range(P_COLL))

    def list_objects(self, coll):
        pref = f"{coll}\x00".encode()
        return sorted(k[len(pref):].decode()
                      for k, _ in self.kv.get_range(P_META, pref,
                                                    pref + b"\xff"))

    def list_objects_range(self, coll, begin, limit):
        names = [o for o in self.list_objects(coll) if o > begin]
        return names[:limit]

    def collection_exists(self, coll):
        return self.kv.get(P_COLL, coll.encode()) is not None
