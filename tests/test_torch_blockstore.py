"""The port's BlockStore (``ceph_tpu_torch/os/blockstore.py``) against
ceph_tpu's.

Counterparts of ``tests/test_blockstore.py`` -- allocator reuse,
deferred-write WAL replay after a SIGKILL, checksum-on-read through the
host CRC engine, clone COW sharing, checkpoint compaction -- run on the
port; then state carries across: a store directory written by the
reference mounts in the port and reads the same bytes, xattrs, omap and
listings, and the reverse, WAL replay and checkpointed KV both.
"""

import os
import signal
import struct
import subprocess
import sys
import textwrap
import time

import pytest

from ceph_tpu.os.blockstore import BlockStore as RefBlockStore
from ceph_tpu.os.transaction import Transaction as RefTransaction
from ceph_tpu_torch.os.blockstore import BLOCK, BlockStore, DEFERRED_MAX
from ceph_tpu_torch.os.transaction import Transaction


def mk(path) -> BlockStore:
    bs = BlockStore(str(path))
    bs.mount()
    return bs


def w(bs, coll, oid, off, data):
    bs.queue_transaction(Transaction().write(coll, oid, off, data))


def test_basic_rw_and_remount(tmp_path):
    bs = mk(tmp_path / "s")
    bs.queue_transaction(Transaction().create_collection("c"))
    w(bs, "c", "a", 0, b"hello world")
    w(bs, "c", "a", 6, b"block")
    w(bs, "c", "big", 0, os.urandom(3 * BLOCK + 123))
    big = bs.read("c", "big")
    assert bs.read("c", "a") == b"hello block"
    assert bs.stat("c", "a")["size"] == 11
    bs.queue_transaction(
        Transaction().setattr("c", "a", "k", b"v")
        .omap_setkeys("c", "a", {"x": b"1"}))
    bs.umount()

    bs2 = mk(tmp_path / "s")
    assert bs2.read("c", "a") == b"hello block"
    assert bs2.read("c", "big") == big
    assert bs2.getattr("c", "a", "k") == b"v"
    assert bs2.omap_get("c", "a") == {"x": b"1"}
    bs2.umount()


def test_allocator_reuses_freed_blocks_after_checkpoint(tmp_path):
    """Freed blocks are quarantined while any WAL record could still
    reference them; once the WAL is checkpointed (truncated) they go
    back to the allocator and the device stops growing."""
    bs = mk(tmp_path / "s")
    bs.queue_transaction(Transaction().create_collection("c"))
    big = os.urandom(DEFERRED_MAX + BLOCK)     # forces redirect path
    w(bs, "c", "a", 0, big)
    high_after_first = bs.alloc.high
    bs.queue_transaction(Transaction().remove("c", "a"))
    assert bs._quarantine                      # held, not yet free
    bs._checkpoint()                           # WAL truncated -> safe
    assert not bs._quarantine
    w(bs, "c", "b", 0, big)
    # freed blocks were reused: the device did not grow
    assert bs.alloc.high == high_after_first
    assert bs.read("c", "b") == big
    bs.umount()


def test_truncate_and_zero(tmp_path):
    bs = mk(tmp_path / "s")
    bs.queue_transaction(Transaction().create_collection("c"))
    w(bs, "c", "a", 0, b"x" * (2 * BLOCK))
    bs.queue_transaction(Transaction().truncate("c", "a", BLOCK + 10))
    assert bs.stat("c", "a")["size"] == BLOCK + 10
    assert bs.read("c", "a") == b"x" * (BLOCK + 10)
    bs.queue_transaction(Transaction().truncate("c", "a", 2 * BLOCK))
    assert bs.read("c", "a") == \
        b"x" * (BLOCK + 10) + b"\x00" * (BLOCK - 10)
    bs.queue_transaction(Transaction().zero("c", "a", 5, 10))
    assert bs.read("c", "a", 0, 20) == \
        b"x" * 5 + b"\x00" * 10 + b"x" * 5
    bs.umount()


def test_clone_shares_then_cows(tmp_path):
    bs = mk(tmp_path / "s")
    bs.queue_transaction(Transaction().create_collection("c"))
    content = os.urandom(2 * BLOCK)
    w(bs, "c", "src", 0, content)
    bs.queue_transaction(Transaction().clone("c", "src", "dst"))
    src_blocks = set(bs._onode("c", "src").blocks.values())
    dst_blocks = set(bs._onode("c", "dst").blocks.values())
    assert src_blocks == dst_blocks          # shared, not copied
    # writing the source COWs away from the shared blocks
    w(bs, "c", "src", 0, b"Y" * 100)
    assert bs.read("c", "dst") == content
    assert bs.read("c", "src", 0, 100) == b"Y" * 100
    assert bs.read("c", "src", 100) == content[100:]
    bs.umount()
    bs2 = mk(tmp_path / "s")
    assert bs2.read("c", "dst") == content
    bs2.umount()


def test_checksum_detects_bitrot(tmp_path):
    bs = mk(tmp_path / "s")
    bs.queue_transaction(Transaction().create_collection("c"))
    w(bs, "c", "a", 0, b"precious-data" * 100)
    dev_blk = next(iter(bs._onode("c", "a").blocks.values()))
    # flip a byte on the raw device behind the store's back
    with open(bs._f("block"), "r+b") as f:
        f.seek(dev_blk * BLOCK + 7)
        b = f.read(1)
        f.seek(dev_blk * BLOCK + 7)
        f.write(bytes([b[0] ^ 0xFF]))
    with pytest.raises(IOError, match="checksum"):
        bs.read("c", "a")
    bs.umount()


def test_checkpoint_truncates_wal(tmp_path):
    bs = mk(tmp_path / "s")
    bs.queue_transaction(Transaction().create_collection("c"))
    for i in range(8):
        w(bs, "c", f"o{i}", 0, os.urandom(1000))
    assert os.path.getsize(bs._f("wal")) > 0
    bs._checkpoint()
    assert os.path.getsize(bs._f("wal")) == 0
    # state fully served from the checkpoint
    bs.umount()
    bs2 = mk(tmp_path / "s")
    assert len(bs2.list_objects("c")) == 8
    bs2.umount()


CRASH_CHILD = textwrap.dedent("""
    import os, sys
    sys.path.insert(0, {repo!r})
    from ceph_tpu_torch.os.blockstore import BlockStore, BLOCK
    from ceph_tpu_torch.os.transaction import Transaction
    bs = BlockStore({path!r})
    bs.mount()
    bs.queue_transaction(Transaction().create_collection("c"))
    i = 0
    while True:
        t = Transaction()
        # mix of deferred (small) and redirect (large) writes
        t.write("c", f"small-{{i}}", 0, (f"S{{i}}:".encode()) * 100)
        t.write("c", f"big-{{i}}", 0,
                bytes([i % 256]) * (BLOCK * 20))
        t.omap_setkeys("c", "small-" + str(i),
                       {{"seq": str(i).encode()}})
        bs.queue_transaction(t)
        print(i, flush=True)            # ACKED: i is durable
        i += 1
""")


def test_crash_replay_preserves_acked_writes(tmp_path):
    """SIGKILL mid-commit stream; remount must recover EVERY write
    acked before the kill (the WAL contract BlueStore's kv-sync
    provides), with checksums intact."""
    path = str(tmp_path / "s")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    child = subprocess.Popen(
        [sys.executable, "-c",
         CRASH_CHILD.format(repo=repo, path=path)],
        stdout=subprocess.PIPE, text=True,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    acked = -1
    t0 = time.time()
    while time.time() - t0 < 60:        # the child imports torch first
        line = child.stdout.readline()
        if line.strip().isdigit():
            acked = int(line)
        if acked >= 25:
            break
    child.send_signal(signal.SIGKILL)
    child.wait()
    assert acked >= 25, "child never made progress"

    bs = BlockStore(path)
    bs.mount()
    for i in range(acked + 1):
        got = bs.read("c", f"small-{i}")
        assert got == (f"S{i}:".encode()) * 100, f"small-{i} lost"
        assert bs.omap_get("c", f"small-{i}") == \
            {"seq": str(i).encode()}
        big = bs.read("c", f"big-{i}")
        assert big == bytes([i % 256]) * (BLOCK * 20), f"big-{i} lost"
    bs.umount()


def test_torn_wal_tail_is_dropped(tmp_path):
    """A torn final record (partial write at crash) must not poison
    replay: everything before it recovers, the tail is ignored."""
    bs = mk(tmp_path / "s")
    bs.queue_transaction(Transaction().create_collection("c"))
    w(bs, "c", "kept", 0, b"intact")
    bs.umount()
    # append garbage that looks like a truncated record
    with open(str(tmp_path / "s" / "wal"), "ab") as f:
        f.write(b"BSR1" + struct.pack("<II", 99999, 0) + b"half a rec")
    bs2 = mk(tmp_path / "s")
    assert bs2.read("c", "kept") == b"intact"
    w(bs2, "c", "more", 0, b"still writable")
    bs2.umount()


def test_deferred_overwrite_preserves_old_data_on_crash(tmp_path):
    """An in-place (deferred) overwrite must not touch the device
    before its WAL record is durable: a crash in that window has to
    leave the PREVIOUS committed content readable (BlueStore's
    deferred-write ordering)."""
    path = str(tmp_path / "s")
    bs = mk(path)
    bs.queue_transaction(Transaction().create_collection("c"))
    w(bs, "c", "a", 0, b"FIRST" * 100)      # committed, durable

    def boom(rec):
        raise RuntimeError("crash before log fsync")
    bs._wal_commit = boom
    with pytest.raises(RuntimeError):
        w(bs, "c", "a", 0, b"SECND" * 100)
    # simulate process death: reopen the directory cold
    os.close(bs._block_fd)
    bs2 = BlockStore(path)
    bs2.mount()
    assert bs2.read("c", "a") == b"FIRST" * 100
    bs2.umount()


def test_truncate_tail_zero_cows_shared_block(tmp_path):
    """Tail-zeroing on truncate must COW a block a clone still
    references, never zero it in place under the clone."""
    bs = mk(tmp_path / "s")
    bs.queue_transaction(Transaction().create_collection("c"))
    content = os.urandom(BLOCK + 500)
    w(bs, "c", "src", 0, content)
    bs.queue_transaction(Transaction().clone("c", "src", "dst"))
    bs.queue_transaction(Transaction().truncate("c", "src", BLOCK + 9))
    assert bs.read("c", "src") == content[:BLOCK + 9]
    assert bs.read("c", "dst") == content      # clone untouched
    bs.umount()


def test_torn_tail_truncated_at_mount_so_later_writes_survive(tmp_path):
    """After replay stops at a torn record, the WAL must be CUT there:
    records appended after the garbage would be unreachable by every
    future replay."""
    path = str(tmp_path / "s")
    bs = mk(path)
    bs.queue_transaction(Transaction().create_collection("c"))
    w(bs, "c", "kept", 0, b"intact")
    # crash without checkpoint: drop the store, garbage the tail
    os.close(bs._block_fd)
    with open(os.path.join(path, "wal"), "ab") as f:
        f.write(b"BSR1" + struct.pack("<II", 5000, 1) + b"torn")
    bs2 = BlockStore(path)
    bs2.mount()
    assert bs2.read("c", "kept") == b"intact"
    w(bs2, "c", "after", 0, b"post-tear write")
    # crash again (no umount/checkpoint): the new record must replay
    os.close(bs2._block_fd)
    bs3 = BlockStore(path)
    bs3.mount()
    assert bs3.read("c", "kept") == b"intact"
    assert bs3.read("c", "after") == b"post-tear write"
    bs3.umount()


def test_overwrite_crash_preserves_committed_multiblock_object(tmp_path):
    """Freed device blocks must not return to the allocator until the
    txn's WAL record is durable: during a large redirect-on-write
    overwrite, a block freed for logical block N could otherwise be
    re-allocated to logical block N+1 of the SAME txn and overwritten
    with new data before the record commits -- a crash then destroys
    the previously committed object (BlueStore defers release to txn
    finish for exactly this reason)."""
    path = str(tmp_path / "s")
    bs = mk(path)
    bs.queue_transaction(Transaction().create_collection("c"))
    old = os.urandom(DEFERRED_MAX + 4 * BLOCK)   # redirect, multi-block
    w(bs, "c", "victim", 0, old)                 # committed, durable

    def boom(rec):
        raise RuntimeError("crash before log fsync")
    bs._wal_commit = boom
    with pytest.raises(RuntimeError):
        w(bs, "c", "victim", 0, os.urandom(len(old)))
    os.close(bs._block_fd)

    bs2 = BlockStore(path)
    bs2.mount()
    assert bs2.read("c", "victim") == old        # csum-verified
    bs2.umount()


def test_remove_then_write_crash_preserves_removed_object(tmp_path):
    """Same hazard via remove: a txn that removes an object and writes
    a new one must not let the new data land on the removed object's
    blocks before the WAL record commits."""
    path = str(tmp_path / "s")
    bs = mk(path)
    bs.queue_transaction(Transaction().create_collection("c"))
    old = os.urandom(DEFERRED_MAX + 4 * BLOCK)
    w(bs, "c", "victim", 0, old)

    def boom(rec):
        raise RuntimeError("crash before log fsync")
    bs._wal_commit = boom
    t = Transaction().remove("c", "victim").write(
        "c", "fresh", 0, os.urandom(len(old)))
    with pytest.raises(RuntimeError):
        bs.queue_transaction(t)
    os.close(bs._block_fd)

    bs2 = BlockStore(path)
    bs2.mount()
    assert bs2.read("c", "victim") == old
    bs2.umount()


def test_stale_deferred_payload_never_replays_over_reallocated_block(
        tmp_path):
    """Cross-txn replay hazard: txn T1 leaves a deferred payload for
    block B in the WAL; T2 frees B; if B were reallocated to a later
    NON-deferred write (whose replay relies on device content), a
    crash-replay would smear T1's stale payload over it.  Quarantine
    must keep B out of the allocator until the WAL is truncated."""
    path = str(tmp_path / "s")
    bs = mk(path)
    bs.queue_transaction(Transaction().create_collection("c"))
    w(bs, "c", "small", 0, b"A" * 100)           # allocates B
    w(bs, "c", "small", 0, b"B" * 100)           # T1: deferred payload
    devs = set(bs._onode("c", "small").blocks.values())
    bs.queue_transaction(Transaction().remove("c", "small"))  # T2
    big = os.urandom(DEFERRED_MAX + BLOCK)
    w(bs, "c", "big", 0, big)                    # T3: redirect write
    assert not devs & set(bs._onode("c", "big").blocks.values()), \
        "freed block with a live WAL payload was reallocated"
    # crash (no checkpoint), remount: replay must leave big intact
    os.close(bs._block_fd)
    bs2 = BlockStore(path)
    bs2.mount()
    assert bs2.read("c", "big") == big
    bs2.umount()


def test_failed_txn_umount_remount_recovers_committed_state(tmp_path):
    """A txn that dies mid-commit poisons the store; a normal umount
    must NOT checkpoint the half-applied memory state, and remount
    must rebuild purely from ckpt+WAL (the failed txn never logged a
    record, so it simply never happened)."""
    path = str(tmp_path / "s")
    bs = mk(path)
    bs.queue_transaction(Transaction().create_collection("c"))
    w(bs, "c", "a", 0, b"GOOD" * 200)

    def boom(rec):
        raise RuntimeError("commit failure")
    bs._wal_commit = boom
    with pytest.raises(RuntimeError):
        w(bs, "c", "a", 0, b"EVIL" * 200)
    with pytest.raises(IOError, match="remount"):
        w(bs, "c", "a", 0, b"more")          # poisoned: refuses work
    bs._wal_commit = BlockStore._wal_commit.__get__(bs)
    bs.umount()                              # must not persist EVIL
    bs.mount()                               # same instance remount
    assert bs.read("c", "a") == b"GOOD" * 200
    w(bs, "c", "a", 0, b"NEXT" * 200)        # recovered: writable
    assert bs.read("c", "a") == b"NEXT" * 200
    bs.umount()


def test_metadata_memory_bounded_and_checkpoint_incremental(tmp_path):
    """Onodes live in the KV (md.db), not in RAM: after writing far
    more objects than the cache bound, the cache stays bounded, every
    object remains readable (served from the KV), and a checkpoint
    after ONE more write flushes a handful of KV ops -- not the whole
    store (BlueStore's incremental kv_sync, not a wholesale dump)."""
    from ceph_tpu_torch.os.blockstore import ONODE_CACHE_MAX
    bs = mk(tmp_path / "s")
    bs.queue_transaction(Transaction().create_collection("c"))
    n = ONODE_CACHE_MAX * 3
    for i in range(n):
        t = Transaction()
        t.write("c", f"obj-{i:05d}", 0, f"payload-{i}".encode())
        t.omap_setkeys("c", f"obj-{i:05d}", {"k": str(i).encode()})
        bs.queue_transaction(t)
    bs._checkpoint()
    assert len(bs._oncache) <= ONODE_CACHE_MAX + 1
    # all reachable though most onodes are NOT in memory
    assert len(bs.list_objects("c")) == n
    for i in (0, 7, n // 2, n - 1):
        assert bs.read("c", f"obj-{i:05d}") == f"payload-{i}".encode()
        assert bs.omap_get("c", f"obj-{i:05d}") == {"k": str(i).encode()}
    # incremental: one more write -> checkpoint touches O(1) KV rows
    w(bs, "c", "obj-extra", 0, b"tail write")
    bs._checkpoint()
    assert bs._last_ckpt_ops < 16, \
        f"checkpoint flushed {bs._last_ckpt_ops} ops for one write"
    bs.umount()
    # cold remount serves everything from the KV
    bs2 = mk(tmp_path / "s")
    assert len(bs2.list_objects("c")) == n + 1
    assert bs2.read("c", f"obj-{n//3:05d}") == f"payload-{n//3}".encode()
    bs2.umount()


def test_omap_clear_and_recreate_does_not_resurrect_old_rows(tmp_path):
    """A removed object's KV omap rows must not leak into a recreated
    object of the same name across checkpoints."""
    bs = mk(tmp_path / "s")
    bs.queue_transaction(Transaction().create_collection("c"))
    bs.queue_transaction(
        Transaction().touch("c", "x")
        .omap_setkeys("c", "x", {"old": b"1", "both": b"old"}))
    bs._checkpoint()                       # rows land in the KV
    bs.queue_transaction(Transaction().remove("c", "x"))
    bs.queue_transaction(
        Transaction().touch("c", "x")
        .omap_setkeys("c", "x", {"both": b"new"}))
    assert bs.omap_get("c", "x") == {"both": b"new"}
    bs._checkpoint()
    assert bs.omap_get("c", "x") == {"both": b"new"}
    bs.umount()
    bs2 = mk(tmp_path / "s")
    assert bs2.omap_get("c", "x") == {"both": b"new"}
    bs2.umount()


def test_clone_replay_idempotent_after_checkpoint_crash(tmp_path):
    """Crash BETWEEN the checkpoint's KV commit and the WAL truncate:
    remount replays the whole WAL over the already-checkpointed KV.
    The clone record must restore dst's clone-time state, not re-copy
    the source (which the checkpoint advanced past the clone point)."""
    path = str(tmp_path / "s")
    bs = mk(path)
    bs.queue_transaction(Transaction().create_collection("c"))
    a = b"A" * 900
    w(bs, "c", "src", 0, a)
    bs.queue_transaction(
        Transaction().clone("c", "src", "dst")
        .omap_setkeys("c", "src", {"k": b"at-clone"}))
    w(bs, "c", "src", 0, b"B" * 900)          # src moves on
    wal = open(os.path.join(path, "wal"), "rb").read()
    bs._checkpoint()                           # KV holds final state
    # simulate the crash window: WAL truncate never happened
    with open(os.path.join(path, "wal"), "wb") as f:
        f.write(wal)
    os.close(bs._block_fd)
    bs.kv.close()

    bs2 = BlockStore(path)
    bs2.mount()
    assert bs2.read("c", "dst") == a           # clone-time content
    assert bs2.read("c", "src") == b"B" * 900
    bs2.umount()


# -- state carried across: reference <-> port ---------------------------------

def _populate(bs, txn_cls, rnd_seed: int) -> dict:
    """Deferred and redirect writes, a clone sharing blocks, an overwrite
    that COWs it, a truncate, xattrs and omap; returns what each object
    must read back."""
    import numpy as np
    rng = np.random.default_rng(rnd_seed)
    big = rng.integers(0, 256, DEFERRED_MAX + 3 * BLOCK + 77,
                       dtype=np.uint8).tobytes()
    small = rng.integers(0, 256, 3000, dtype=np.uint8).tobytes()
    bs.queue_transaction(txn_cls().create_collection("c")
                         .create_collection("d"))
    bs.queue_transaction(
        txn_cls().write("c", "big", 0, big).write("c", "small", 0, small)
        .setattr("c", "big", "_size", str(len(big)).encode())
        .omap_setkeys("c", "small", {"k": b"v", "z": b"26"}))
    bs.queue_transaction(txn_cls().clone("c", "big", "snap"))
    bs.queue_transaction(txn_cls().write("c", "big", 100, b"P" * 5000)
                         .truncate("c", "small", 2500)
                         .touch("d", "empty"))
    patched = bytearray(big)
    patched[100:5100] = b"P" * 5000
    return {("c", "big"): bytes(patched), ("c", "snap"): big,
            ("c", "small"): small[:2500], ("d", "empty"): b""}


def _check(bs, want: dict) -> None:
    assert bs.list_collections() == ["c", "d"]
    assert bs.list_objects("c") == ["big", "small", "snap"]
    for (c, o), data in want.items():
        assert bs.read(c, o) == data, (c, o)
        assert bs.stat(c, o)["size"] == len(data)
    assert bs.getattr("c", "big", "_size") is not None
    assert bs.getattrs("c", "snap") == bs.getattrs("c", "big")
    assert bs.omap_get("c", "small") == {"k": b"v", "z": b"26"}


@pytest.mark.parametrize("checkpointed", [False, True],
                         ids=["wal-replay", "checkpointed"])
@pytest.mark.parametrize("direction", ["ref-to-port", "port-to-ref"])
def test_store_directory_carries_across(tmp_path, direction, checkpointed):
    """A directory written by one side mounts in the other: from the WAL
    alone (the writer never checkpointed: its process died) or from the
    checkpointed KV; the reader then writes on, and the writer's side
    reads that back too."""
    path = str(tmp_path / "s")
    writer, wtxn, reader, rtxn = (
        (RefBlockStore, RefTransaction, BlockStore, Transaction)
        if direction == "ref-to-port" else
        (BlockStore, Transaction, RefBlockStore, RefTransaction))
    bs = writer(path)
    bs.mount()
    want = _populate(bs, wtxn, 3)
    if checkpointed:
        bs.umount()
    else:                                   # crash: no checkpoint
        os.close(bs._block_fd)
        bs.kv.close()
    other = reader(path)
    other.mount()
    _check(other, want)
    other.queue_transaction(rtxn().write("c", "small", 0, b"again"))
    want[("c", "small")] = b"again" + want[("c", "small")][5:]
    other.umount()
    back = writer(path)
    back.mount()
    _check(back, want)
    back.umount()
