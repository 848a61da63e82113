"""The port's device-resident shard cache (``ceph_tpu_torch/os/
device_cache.py``) against ceph_tpu's.

Counterparts of the unit tests of ``tests/test_datapath_cache.py``: the
byte budget and per-entry cap, the entry's identity, one upload a
residency, store-boundary invalidation on every mutating transaction of
every store, clone invalidating only its destination, a BlockStore
remount dropping residency, and the batcher's RMW leaving the caller's
host arrays intact.  The same operations go through the reference's cache
where it has them, and the LRU's choices must agree.  The device copy
here lives on ``device="cpu"``; CUDA is the default and raises without a
card.  The four cluster tests of the reference file wait for the OSD
daemon layer.
"""

import asyncio

import numpy as np
import pytest
import torch

from ceph_tpu.ec import registry as ref_registry
from ceph_tpu.os.device_cache import DeviceShardCache as RefCache
from ceph_tpu_torch.ec.plugins.cuda import ErasureCodeCuda
from ceph_tpu_torch.os.blockstore import BlockStore
from ceph_tpu_torch.os.device_cache import DeviceShardCache, PERF
from ceph_tpu_torch.os.store import DBStore, MemStore
from ceph_tpu_torch.os.transaction import Transaction
from ceph_tpu_torch.osd.codec_batcher import CodecBatcher

torch.set_num_threads(1)


def _cache(**kw):
    return DeviceShardCache(device="cpu", **kw)


def _resident(c) -> list:
    return list(c._lru)


# -- unit: LRU / byte budget -------------------------------------------------

def test_byte_budget_eviction_under_pressure():
    for c in (_cache(max_bytes=3 * 1000), RefCache(max_bytes=3 * 1000)):
        for i in range(3):
            c.put("c", f"o{i}", bytes(1000), size=1000, ver=(1, i))
        assert c.used_bytes == 3000 and len(c) == 3
        assert c.get("c", "o0") is not None          # refresh o0
        c.put("c", "o3", bytes(1000), size=1000, ver=(1, 3))
        assert c.used_bytes <= 3000
        assert c.get("c", "o1") is None              # LRU victim
        assert c.get("c", "o0") is not None
        # an entry above the per-entry cap is never cached (and clears
        # any stale resident copy under the same key)
        c2 = type(c)(max_bytes=1 << 20, entry_max=100)
        c2.put("c", "big", bytes(50), size=50, ver=(1, 1))
        c2.put("c", "big", bytes(500), size=500, ver=(1, 2))
        assert ("c", "big") not in c2
        assert c2.used_bytes == 0


def test_oversize_entries_skip_whole_budget():
    c = _cache(max_bytes=10_000, entry_max=10_000)
    c.put("c", "a", bytes(9000), size=9000, ver=(1, 1))
    c.put("c", "b", bytes(9000), size=9000, ver=(1, 2))
    assert c.used_bytes <= 10_000
    assert len(c) == 1                           # a evicted for b
    assert c.get("c", "b") is not None


def test_entry_carries_identity_and_slices():
    c = _cache()
    buf = np.arange(256, dtype=np.uint8)
    c.put("c", "o", buf, size=1000, ver=(3, 7), shard=2, crc=123)
    e = c.get("c", "o")
    assert e.size == 1000 and e.ver == (3, 7)
    assert e.shard == 2 and e.crc == 123
    assert bytes(e.buf[10:20]) == bytes(buf[10:20])


def test_device_view_uploads_once():
    c = _cache()
    c.put("c", "o", bytes(range(64)), size=64, ver=(1, 1))
    n0 = PERF.get("device_uploads")
    b0 = PERF.get("device_upload_bytes")
    v1 = c.device_view("c", "o")
    v2 = c.device_view("c", "o")
    assert v1 is v2                              # memoized upload
    assert PERF.get("device_uploads") == n0 + 1
    assert PERF.get("device_upload_bytes") == b0 + 64
    assert isinstance(v1, torch.Tensor) and v1.dtype == torch.uint8
    assert bytes(v1.numpy()) == bytes(range(64))
    assert c.device_view("c", "absent") is None


def test_lru_matches_reference_on_a_seeded_mix():
    """put / get / invalidate / oversize in a seeded order: the port's
    resident keys, bytes and datapath counter deltas equal the
    reference's."""
    from ceph_tpu.os.device_cache import PERF as REF_PERF
    rng = np.random.default_rng(17)
    port, ref = _cache(max_bytes=5000, entry_max=3000), \
        RefCache(max_bytes=5000, entry_max=3000)
    keys = ("hits", "misses", "puts", "evictions", "invalidations",
            "put_oversize", "host_bytes_avoided", "evicted_bytes")
    before = [{k: p.get(k) for k in keys} for p in (PERF, REF_PERF)]
    for step in range(300):
        o = f"o{rng.integers(0, 8)}"
        op = rng.integers(0, 4)
        n = int(rng.integers(1, 3500))
        for c in (port, ref):
            if op == 0:
                c.put("c", o, bytes(n), size=n, ver=(1, step))
            elif op == 1:
                c.get("c", o)
            elif op == 2:
                c.invalidate("c", o)
            else:
                c.invalidate("c") if n < 200 else c.get("c", o)
        assert _resident(port) == _resident(ref), step
        assert port.used_bytes == ref.used_bytes
    after = [{k: p.get(k) for k in keys} for p in (PERF, REF_PERF)]
    assert {k: after[0][k] - before[0][k] for k in keys} == \
        {k: after[1][k] - before[1][k] for k in keys}


def test_device_copy_follows_invalidate_and_reput():
    """Coherence of the device copy: an invalidation drops it with its
    entry, a re-put with new bytes is a new residency, and the next view is
    a fresh upload of the new bytes (never the old copy)."""
    c = _cache()
    c.put("c", "o", b"old-bytes", size=9, ver=(1, 1))
    old = c.device_view("c", "o")
    n0 = PERF.get("device_uploads")
    c.invalidate("c", "o")
    assert c.device_view("c", "o") is None
    c.put("c", "o", b"NEW-BYTES", size=9, ver=(1, 2))
    new = c.device_view("c", "o")
    assert new is not old and bytes(new.numpy()) == b"NEW-BYTES"
    assert bytes(old.numpy()) == b"old-bytes"
    assert PERF.get("device_uploads") == n0 + 1
    # eviction and clear drop the device copy too
    c2 = _cache(max_bytes=20)
    c2.put("c", "a", b"a" * 10, size=10, ver=(1, 1))
    c2.device_view("c", "a")
    c2.put("c", "b", b"b" * 15, size=15, ver=(1, 1))    # evicts a
    assert c2.device_view("c", "a") is None
    c2.clear()
    assert c2.device_view("c", "b") is None and c2.used_bytes == 0


def test_cuda_is_the_default_and_raises_without_a_card(monkeypatch):
    """LRU, budget and coherence need no card; the first device_view
    resolves the device, and CUDA without a card raises instead of handing
    back the host buffer."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    c = DeviceShardCache()
    c.put("c", "o", b"payload", size=7, ver=(1, 1))
    assert c.get("c", "o") is not None
    c.invalidate("c", "o")
    c.put("c", "o", b"payload", size=7, ver=(1, 1))
    with pytest.raises(RuntimeError, match="CUDA"):
        c.device_view("c", "o")
    assert DeviceShardCache.from_config({}).device is None
    assert DeviceShardCache.from_config(
        {"osd_datapath_cache_enabled": False}) is None
    conf = {"osd_datapath_cache_bytes": 123, "osd_datapath_cache_entry_max": 7}
    fc = DeviceShardCache.from_config(conf, device="cpu")
    assert (fc.max_bytes, fc.entry_max, fc.device) == (123, 7, "cpu")


# -- unit: store-boundary invalidation ---------------------------------------

def _mutation_cases():
    return [
        ("write", lambda t: t.write("c", "o", 0, b"X")),
        ("zero", lambda t: t.zero("c", "o", 0, 4)),
        ("truncate", lambda t: t.truncate("c", "o", 1)),
        ("remove", lambda t: t.remove("c", "o")),
        ("setattr", lambda t: t.setattr("c", "o", "_crc", b"0")),
        ("rmattr", lambda t: t.rmattr("c", "o", "_crc")),
        ("rmcoll", lambda t: t.remove_collection("c")),
    ]


@pytest.mark.parametrize("store_kind", ["mem", "db", "block"])
def test_every_store_invalidates_on_mutating_txn(store_kind,
                                                 tmp_path):
    for name, mutate in _mutation_cases():
        if store_kind == "mem":
            store = MemStore()
        elif store_kind == "db":
            store = DBStore(str(tmp_path / f"{name}.db"))
        else:
            store = BlockStore(str(tmp_path / f"bs_{name}"))
            store.mount()
        cache = _cache()
        store.attach_shard_cache(cache)
        store.queue_transaction(
            Transaction().create_collection("c"))
        t = Transaction()
        t.write("c", "o", 0, b"original")
        store.queue_transaction(t)
        cache.put("c", "o", b"original", size=8, ver=(1, 1))
        cache.device_view("c", "o")
        assert ("c", "o") in cache
        t = Transaction()
        mutate(t)
        store.queue_transaction(t)
        assert ("c", "o") not in cache, \
            f"{store_kind}: {name} left a stale resident copy"
        assert cache.device_view("c", "o") is None
        if store_kind == "block":
            store.umount()


def test_clone_invalidates_destination_not_source():
    store = MemStore()
    cache = _cache()
    store.attach_shard_cache(cache)
    store.queue_transaction(Transaction().create_collection("c"))
    t = Transaction()
    t.write("c", "src", 0, b"src-bytes")
    t.write("c", "dst", 0, b"old-dst")
    store.queue_transaction(t)
    cache.put("c", "src", b"src-bytes", size=9, ver=(1, 1))
    cache.put("c", "dst", b"old-dst", size=7, ver=(1, 1))
    t = Transaction()
    t.clone("c", "src", "dst")
    store.queue_transaction(t)
    assert ("c", "src") in cache
    assert ("c", "dst") not in cache


def test_blockstore_remount_clears_residency(tmp_path):
    store = BlockStore(str(tmp_path / "bs"))
    cache = _cache()
    store.attach_shard_cache(cache)
    store.mount()
    store.queue_transaction(Transaction().create_collection("c"))
    t = Transaction()
    t.write("c", "o", 0, b"payload")
    store.queue_transaction(t)
    cache.put("c", "o", b"payload", size=7, ver=(1, 1))
    cache.device_view("c", "o")
    store.umount()
    store.mount()                                # revive on same dir
    assert len(cache) == 0, "remount must drop all residency"
    assert cache.device_view("c", "o") is None
    assert store.read("c", "o", 0, None) == b"payload"
    store.umount()


# -- write path: the batcher's RMW leaves the caller's arrays intact ---------

def test_batcher_rmw_leaves_host_inputs_intact():
    profile = {"k": "4", "m": "2", "technique": "reed_sol_van"}
    codec = ErasureCodeCuda("reed_sol_van", device="cpu")
    codec.init(dict(profile))
    ref_codec = ref_registry().factory("tpu", dict(profile))
    rng = np.random.default_rng(9)
    data = rng.integers(0, 256, (8, 4, 512), dtype=np.uint8)
    parity = np.asarray(codec.encode_batch(data, out_np=True))
    assert np.array_equal(parity, np.asarray(
        ref_codec.encode_batch(data, out_np=True)))
    delta = np.zeros_like(data)
    delta[:, 1, :100] = rng.integers(0, 256, (8, 100),
                                     dtype=np.uint8)
    old_copy, delta_copy = parity.copy(), delta.copy()
    batcher = CodecBatcher(max_batch=32, flush_timeout=0.05, device="cpu")

    async def drive():
        return await batcher.rmw(codec, parity, delta)

    new_parity = asyncio.new_event_loop().run_until_complete(drive())
    # byte-exact vs a full re-encode of the delta'd data
    want = np.asarray(ref_codec.encode_batch(data ^ delta, out_np=True))
    assert np.array_equal(new_parity, want)
    # the caller's host arrays are untouched
    assert np.array_equal(parity, old_copy)
    assert np.array_equal(delta, delta_copy)
