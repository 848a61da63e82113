"""librbd object-map + journaling features and journal-mode mirroring
(src/librbd/object_map/, src/librbd/journal/, rbd_mirror journal
replay).

The port's counterpart of ``tests/test_rbd_features.py``: its cases on
``ceph_tpu_torch``, the daemons and librados on ``device="cpu"``.
"""

import asyncio

import pytest

from torch_app_cases import Rados
from ceph_tpu_torch.rbd import rbd as rbdmod
from ceph_tpu_torch.rbd.features import (
    OBJ_EXISTS, OBJ_EXISTS_CLEAN, OBJ_NONEXISTENT, ImageJournal,
    disk_usage, fast_diff,
)

from torch_app_cases import make_cluster, run, teardown

FEATURES = ["layering", "exclusive-lock", "object-map", "journaling"]


async def boot_img(order=20, size=1 << 22, features=FEATURES):
    mon, osds = await make_cluster(3)
    rados = await Rados(mon.msgr.addr).connect()
    await rados.pool_create("rbd", pg_num=8)
    io = await rados.open_ioctx("rbd")
    await rbdmod.RBD().create(io, "img", size, order=order,
                              features=features)
    img = await rbdmod.Image.open(io, "img")
    return mon, osds, rados, io, img


def test_object_map_tracks_writes_and_fast_diff():
    async def main():
        mon, osds, rados, io, img = await boot_img()
        try:
            osz = 1 << 20
            await img.write(0, b"A" * 100)            # object 0
            await img.write(2 * osz, b"B" * 100)      # object 2
            states = await img.object_map.states()
            assert states[0] == OBJ_EXISTS
            assert states[2] == OBJ_EXISTS
            assert states[1] == OBJ_NONEXISTENT
            du = await disk_usage(img)
            assert du["used"] == 2 * osz
            assert du["provisioned"] == 1 << 22

            # snapshot freezes the map; post-snap writes are the diff
            await img.create_snap("s1")
            states = await img.object_map.states()
            assert states[0] == OBJ_EXISTS_CLEAN
            await img.write(3 * osz, b"C" * 100)      # object 3
            await img.write(0, b"D" * 10)             # redirty object 0
            changed = await fast_diff(img, "s1")
            assert changed == [0, 3]
            # full-object discard drops existence
            await img.discard(2 * osz, osz)
            changed = await fast_diff(img, "s1")
            assert changed == [0, 2, 3]               # 2: existence diff
            states = await img.object_map.states()
            assert states[2] == OBJ_NONEXISTENT
            await img.close()
        finally:
            await teardown(mon, osds, rados)
    run(main())


def test_journal_records_mutations_in_order():
    """Entries are retained for the slowest registered client (a
    mirror at position -1 pins everything); the image's own master
    client commits as it applies, so a solo master trims eagerly."""
    async def main():
        mon, osds, rados, io, img = await boot_img()
        try:
            jr = ImageJournal(io, img.id)
            await jr.register_client("mirror", position=-1)
            await img.write(0, b"first")
            await img.write(4096, b"second")
            await img.discard(0, 4096)
            await img.resize(1 << 21)
            entries = await jr.entries_after(-1, limit=100)
            ops = [(ev["op"]) for _, ev, _ in entries]
            assert ops == ["write", "write", "discard", "resize"]
            assert entries[0][2] == b"first"
            seqs = [s for s, _, _ in entries]
            assert seqs == sorted(seqs)
            # the mirror has consumed nothing: trim reclaims nothing
            assert await jr.trim() == 0
            assert len(await jr.entries_after(-1, limit=100)) == 4
            # once the mirror catches up, history is reclaimed
            await jr.commit("mirror", seqs[-1])
            assert await jr.trim() == 4
            await img.close()
        finally:
            await teardown(mon, osds, rados)
    run(main())


def test_journal_local_replay_after_writer_crash():
    """A writer that journals an event but dies before applying it
    locally must catch up on reopen (journal::Replay): the journal is
    authoritative, so primary and mirror cannot diverge."""
    async def main():
        mon, osds, rados, io, img = await boot_img()
        try:
            await img.write(0, b"applied")
            # simulate append-then-crash: event in the journal, data
            # op never issued
            jr = ImageJournal(io, img.id)
            await jr.append({"op": "write", "off": 8192,
                             "len": 7}, b"phantom")
            await img.close()
            img2 = await rbdmod.Image.open(io, "img")
            assert await img2.read(8192, 7) == b"phantom"
            await img2.close()
        finally:
            await teardown(mon, osds, rados)
    run(main())


def test_journal_mirror_replays_instead_of_snapshots():
    """The verdict's 'done' bar: a mirror test replaying a JOURNAL
    instead of snapshots."""
    async def main():
        from ceph_tpu_torch.rbd.mirror import (
            journal_bootstrap, journal_replay_once, mirror_enable)
        mon, osds = await make_cluster(3)
        rados = await Rados(mon.msgr.addr).connect()
        try:
            for pool in ("site-a", "site-b"):
                await rados.pool_create(pool, pg_num=8)
            src = await rados.open_ioctx("site-a")
            dst = await rados.open_ioctx("site-b")
            await rbdmod.RBD().create(src, "img", 1 << 22, order=20,
                                      features=FEATURES)
            img = await rbdmod.Image.open(src, "img")
            await img.write(0, b"pre-bootstrap" * 100)
            await mirror_enable(src, "img")
            out = await journal_bootstrap(src, dst, "img")
            assert out["position"] >= 0

            # post-bootstrap mutations arrive via REPLAY, no snapshots
            await img.write(1 << 20, b"replayed-write" * 50)
            await img.discard(0, 4096)
            await img.create_snap("mark")
            n = await journal_replay_once(src, dst, "img", limit=100)
            assert n >= 3
            dimg = await rbdmod.Image.open(dst, "img",
                                           read_only=True)
            try:
                assert await dimg.read(1 << 20, 14 * 50) == \
                    b"replayed-write" * 50
                assert await dimg.read(0, 4096) == b"\x00" * 4096
                got = await dimg.read(4096,
                                      len(b"pre-bootstrap" * 100) - 4096)
                want = (b"pre-bootstrap" * 100)[4096:]
                assert got == want
                assert [s["name"] for s in dimg.meta["snapshots"]] \
                    == ["mark"]
            finally:
                await dimg.close()
            # the journal trimmed what the (only) client consumed
            jr = ImageJournal(src, img.id)
            assert await jr.entries_after(-1, limit=100) == []

            # no snapshot-based sync ran: source has exactly the one
            # user snapshot, no mirror snapshots
            assert [s["name"] for s in img.meta["snapshots"]] \
                == ["mark"]
            await img.close()
        finally:
            await teardown(mon, osds, rados)
    run(main())


def test_plain_image_pays_no_feature_overhead():
    async def main():
        mon, osds, rados, io, img = await boot_img(
            features=["layering"])
        try:
            assert img.object_map is None and img.journal is None
            await img.write(0, b"x")
            objs = await io.list_objects()
            assert not [o for o in objs if "journal" in o
                        or "object_map" in o]
            await img.close()
        finally:
            await teardown(mon, osds, rados)
    run(main())
