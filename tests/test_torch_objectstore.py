"""The port's object stores (``ceph_tpu_torch/os``) against ceph_tpu's.

Counterparts of ``tests/test_objectstore.py`` run on every port store
(MemStore, DBStore, BlockStore, KVStore on the in-memory and the sqlite
engine), and a seeded random transaction sequence -- writes at offsets,
zero, truncate, clone, remove, xattrs, omap, collections -- goes through
each reference store and its port side by side: after every transaction
the reads, stats, xattrs, omap and listings must be equal.
"""

import random

import pytest

from ceph_tpu.os import DBStore as RefDBStore
from ceph_tpu.os import KVStore as RefKVStore
from ceph_tpu.os import MemStore as RefMemStore
from ceph_tpu.os import Transaction as RefTransaction
from ceph_tpu.os.blockstore import BlockStore as RefBlockStore
from ceph_tpu_torch.common.throttle import injector
from ceph_tpu_torch.os import DBStore, KVStore, MemStore, Transaction
from ceph_tpu_torch.os.blockstore import BlockStore
from ceph_tpu_torch.os.store import make_default_store

KINDS = ["mem", "db", "block", "kv", "kv-sqlite"]


def _make(kind, tmp_path, port=True):
    mem, db, block, kv = ((MemStore, DBStore, BlockStore, KVStore) if port
                          else (RefMemStore, RefDBStore, RefBlockStore,
                                RefKVStore))
    side = "port" if port else "ref"
    if kind == "mem":
        return mem()
    if kind == "block":
        bs = block(str(tmp_path / f"bs-{side}"))
        bs.mount()
        return bs
    if kind == "kv":
        return kv()
    if kind == "kv-sqlite":
        return kv(str(tmp_path / f"kv-{side}.db"))
    return db(str(tmp_path / f"osd-{side}.db"))


@pytest.fixture(params=KINDS)
def store(request, tmp_path):
    st = _make(request.param, tmp_path)
    yield st
    if isinstance(st, BlockStore):
        st.umount()


def test_write_read_roundtrip(store):
    t = Transaction()
    t.create_collection("pg1")
    t.write("pg1", "obj", 0, b"hello world")
    store.queue_transaction(t)
    assert store.read("pg1", "obj") == b"hello world"
    assert store.stat("pg1", "obj")["size"] == 11


def test_write_offset_extends_with_zeros(store):
    t = Transaction().create_collection("c")
    t.write("c", "o", 5, b"abc")
    store.queue_transaction(t)
    assert store.read("c", "o") == b"\x00" * 5 + b"abc"


def test_partial_read(store):
    store.queue_transaction(
        Transaction().create_collection("c").write("c", "o", 0, b"0123456789"))
    assert store.read("c", "o", 2, 4) == b"2345"


def test_zero_and_truncate(store):
    store.queue_transaction(
        Transaction().create_collection("c").write("c", "o", 0, b"X" * 10)
        .zero("c", "o", 2, 3).truncate("c", "o", 8))
    assert store.read("c", "o") == b"XX\x00\x00\x00XXX"


def test_remove_and_exists(store):
    store.queue_transaction(
        Transaction().create_collection("c").touch("c", "o"))
    assert store.exists("c", "o")
    store.queue_transaction(Transaction().remove("c", "o"))
    assert not store.exists("c", "o")
    with pytest.raises(FileNotFoundError):
        store.read("c", "o")


def test_xattrs(store):
    store.queue_transaction(
        Transaction().create_collection("c").touch("c", "o")
        .setattr("c", "o", "version", b"1.2").setattr("c", "o", "x", b"y"))
    assert store.getattr("c", "o", "version") == b"1.2"
    assert store.getattrs("c", "o") == {"version": b"1.2", "x": b"y"}
    store.queue_transaction(Transaction().rmattr("c", "o", "x"))
    assert store.getattrs("c", "o") == {"version": b"1.2"}


def test_omap(store):
    store.queue_transaction(
        Transaction().create_collection("c").touch("c", "o")
        .omap_setkeys("c", "o", {"a": b"1", "b": b"2", "z": b"26"}))
    assert store.omap_get("c", "o") == {"a": b"1", "b": b"2", "z": b"26"}
    store.queue_transaction(Transaction().omap_rmkeys("c", "o", ["b"]))
    assert store.omap_get_keys("c", "o", ["a", "b"]) == {"a": b"1"}
    store.queue_transaction(Transaction().omap_clear("c", "o"))
    assert store.omap_get("c", "o") == {}


def test_clone(store):
    store.queue_transaction(
        Transaction().create_collection("c").write("c", "src", 0, b"data")
        .setattr("c", "src", "a", b"v")
        .omap_setkeys("c", "src", {"k": b"v"}))
    store.queue_transaction(Transaction().clone("c", "src", "dst"))
    assert store.read("c", "dst") == b"data"
    assert store.getattr("c", "dst", "a") == b"v"
    assert store.omap_get("c", "dst") == {"k": b"v"}
    # clone is a snapshot: mutating src doesn't touch dst
    store.queue_transaction(Transaction().write("c", "src", 0, b"DATA"))
    assert store.read("c", "dst") == b"data"


def test_missing_collection_rejected(store):
    with pytest.raises(KeyError):
        store.queue_transaction(Transaction().write("nope", "o", 0, b"x"))


def test_collections_listing(store):
    store.queue_transaction(Transaction().create_collection("pg2"))
    store.queue_transaction(Transaction().create_collection("pg1"))
    assert store.list_collections() == ["pg1", "pg2"]
    store.queue_transaction(
        Transaction().touch("pg1", "b").touch("pg1", "a"))
    assert store.list_objects("pg1") == ["a", "b"]
    assert store.list_objects_range("pg1", "a", 5) == ["b"]
    assert store.collection_exists("pg1")
    assert not store.collection_exists("pg9")


def test_read_eio_injection_site(store):
    store.queue_transaction(
        Transaction().create_collection("c").write("c", "o", 0, b"x"))
    injector.arm("objectstore_read", countdown=1, detail="EIO")
    try:
        with pytest.raises(IOError, match="EIO"):
            store.read("c", "o")
    finally:
        injector.disarm("objectstore_read")
    assert store.read("c", "o") == b"x"


def test_dbstore_persistence(tmp_path):
    path = str(tmp_path / "osd.db")
    s1 = DBStore(path)
    s1.queue_transaction(
        Transaction().create_collection("c").write("c", "o", 0, b"persist"))
    s2 = DBStore(path)
    assert s2.read("c", "o") == b"persist"


def test_default_store_factory(monkeypatch, tmp_path):
    monkeypatch.delenv("CEPH_TPU_STORE", raising=False)
    assert isinstance(make_default_store(), MemStore)
    monkeypatch.setenv("CEPH_TPU_STORE", "block")
    monkeypatch.setenv("CEPH_TPU_STORE_DIR", str(tmp_path))
    bs = make_default_store()
    assert isinstance(bs, BlockStore) and bs.path.startswith(str(tmp_path))
    monkeypatch.setenv("CEPH_TPU_STORE", "nope")
    with pytest.raises(ValueError):
        make_default_store()


# -- the same random transactions through the reference and the port --------

def _random_txn(rnd: random.Random, txn_cls, names: list[str]):
    """One seeded transaction of 1-4 ops over collections c0/c1 and
    ``names``; the same rnd state gives the same ops for either side's
    Transaction class."""
    t = txn_cls()
    for _ in range(rnd.randrange(1, 5)):
        c, o = rnd.choice(["c0", "c1"]), rnd.choice(names)
        kind = rnd.choice(["write", "write", "write", "zero", "truncate",
                           "remove", "clone", "setattr", "rmattr",
                           "omap_setkeys", "omap_rmkeys", "omap_clear",
                           "touch"])
        if kind == "write":
            size = rnd.choice([1, 100, 4095, 4096, 5000, 70000])
            data = bytes(rnd.getrandbits(8) for _ in range(min(size, 64)))
            t.write(c, o, rnd.choice([0, 1, 4096, 9000]),
                    (data * (size // len(data) + 1))[:size])
        elif kind == "zero":
            t.zero(c, o, rnd.randrange(0, 9000), rnd.randrange(1, 6000))
        elif kind == "truncate":
            t.truncate(c, o, rnd.choice([0, 10, 4096, 4100, 12000]))
        elif kind == "remove":
            t.remove(c, o)
        elif kind == "clone":
            t.clone(c, o, rnd.choice(names))
        elif kind == "setattr":
            t.setattr(c, o, rnd.choice(["a", "b"]),
                      str(rnd.random()).encode())
        elif kind == "rmattr":
            t.rmattr(c, o, rnd.choice(["a", "b"]))
        elif kind == "omap_setkeys":
            t.omap_setkeys(c, o, {rnd.choice("kxyz"): str(rnd.random())
                                  .encode()})
        elif kind == "omap_rmkeys":
            t.omap_rmkeys(c, o, [rnd.choice("kxyz")])
        elif kind == "omap_clear":
            t.omap_clear(c, o)
        else:
            t.touch(c, o)
    return t


def _view(st, names):
    out = {"colls": st.list_collections()}
    for c in out["colls"]:
        out[c] = st.list_objects(c)
        for o in names:
            stat = st.stat(c, o)
            out[(c, o)] = (stat, st.getattrs(c, o), st.omap_get(c, o),
                           st.read(c, o) if stat is not None else None)
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_random_transactions_match_reference(kind, tmp_path):
    names = ["o0", "o1", "o2"]
    ref, port = _make(kind, tmp_path, port=False), _make(kind, tmp_path)
    ref.queue_transaction(RefTransaction().create_collection("c0")
                          .create_collection("c1"))
    port.queue_transaction(Transaction().create_collection("c0")
                           .create_collection("c1"))
    for step in range(40):
        seed = 1000 * KINDS.index(kind) + step
        outcomes = []
        for st, txn_cls in ((ref, RefTransaction), (port, Transaction)):
            txn = _random_txn(random.Random(seed), txn_cls, names)
            try:
                st.queue_transaction(txn)
                outcomes.append("ok")
            except Exception as e:          # the same refusals on both
                outcomes.append(type(e).__name__)
        assert outcomes[0] == outcomes[1], (step, outcomes)
        if outcomes[0] != "ok" and kind == "block":
            break                           # a failed txn poisons both
        assert _view(port, names) == _view(ref, names), step
    if kind == "block":
        for st in (ref, port):
            st.umount()
