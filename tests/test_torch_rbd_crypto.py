"""librbd image encryption: AES-256-XTS data path with LUKS-style
wrapped keys (src/librbd/crypto role).

The port's counterpart of ``tests/test_rbd_crypto.py``: its cases on
``ceph_tpu_torch``, the daemons and librados on ``device="cpu"``.
"""

import asyncio

import pytest

from ceph_tpu_torch.rbd import RBD, Image, RbdError
from torch_app_cases import OSD, Monitor, Rados, run


async def boot():
    mon = Monitor(rank=0, config={"mon_osd_min_down_reporters": 1})
    addr = await mon.start()
    mon.peer_addrs = [addr]
    osds = []
    for i in range(2):
        o = OSD(host=f"h{i}", whoami=i)
        await o.start(addr)
        osds.append(o)
    r = Rados(addr, name="client.crypt")
    await r.connect()
    await r.mon_command("osd pool create",
                        {"name": "p", "pg_num": 4, "size": 2})
    io = await r.open_ioctx("p")
    return mon, osds, r, io


async def shutdown(mon, osds, r):
    await r.shutdown()
    for o in osds:
        await o.stop()
    await mon.stop()


def test_encrypted_image_roundtrip_and_ciphertext_on_disk():
    async def main():
        mon, osds, r, io = await boot()
        try:
            await RBD().create(io, "vault", size=8 << 20)
            img = await Image.open(io, "vault")
            await img.encryption_format("s3cr3t")
            secret = b"top secret payload " * 400   # multi-sector
            await img.write(0, secret)
            await img.write(5000, b"unaligned overwrite")  # RMW sector
            assert (await img.read(0, 19)) == secret[:19]
            assert (await img.read(5000, 19)) == \
                b"unaligned overwrite"
            await img.close()

            # ciphertext on the wire/disk: a RAW object read must not
            # contain the plaintext
            raw = await io.read(f"rbd_data.{img.id}." + "0" * 16,
                                length=4096, offset=0)
            assert b"top secret" not in raw
            assert raw != secret[:4096]

            # reopen with the right passphrase: full roundtrip
            img2 = await Image.open(io, "vault", passphrase="s3cr3t")
            got = await img2.read(0, len(secret))
            want = bytearray(secret)
            want[5000:5019] = b"unaligned overwrite"
            assert got == bytes(want)
            await img2.close()
        finally:
            await shutdown(mon, osds, r)
    run(main())


def test_wrong_or_missing_passphrase_refused():
    async def main():
        mon, osds, r, io = await boot()
        try:
            await RBD().create(io, "vault", size=4 << 20)
            img = await Image.open(io, "vault")
            await img.encryption_format("correct horse")
            await img.write(0, b"locked away")
            await img.close()
            with pytest.raises(RbdError, match="EPERM"):
                await Image.open(io, "vault")          # no passphrase
            with pytest.raises(RbdError, match="EPERM"):
                await Image.open(io, "vault",
                                 passphrase="battery staple")
            with pytest.raises(RbdError, match="EEXIST"):
                img3 = await Image.open(io, "vault",
                                        passphrase="correct horse")
                await img3.encryption_format("again")
            await img3.close()
            # unencrypted image + passphrase is also an error
            await RBD().create(io, "plain", size=1 << 20)
            with pytest.raises(RbdError, match="EINVAL"):
                await Image.open(io, "plain", passphrase="x")
        finally:
            await shutdown(mon, osds, r)
    run(main())


def test_encrypted_image_with_cache_and_snapshots():
    async def main():
        mon, osds, r, io = await boot()
        try:
            await RBD().create(io, "ev", size=8 << 20)
            img = await Image.open(io, "ev")
            await img.encryption_format("pw")
            await img.close()
            img = await Image.open(io, "ev", passphrase="pw",
                                   cache=True)
            await img.write(0, b"cached+encrypted " * 100)
            assert (await img.read(0, 17)) == b"cached+encrypted "
            await img.create_snap("s1")
            await img.write(0, b"after the snap!!!")
            await img.flush()
            assert (await img.read(0, 17)) == b"after the snap!!!"
            await img.close()
            snap = await Image.open(io, "ev", snapshot="s1",
                                    passphrase="pw")
            assert (await snap.read(0, 17)) == b"cached+encrypted "
            await snap.close()
        finally:
            await shutdown(mon, osds, r)
    run(main())


def test_encrypted_discard_resize_and_admin_remove():
    async def main():
        mon, osds, r, io = await boot()
        try:
            await RBD().create(io, "d", size=4 << 20, order=20)
            img = await Image.open(io, "d")
            await img.encryption_format("pw")
            await img.write(0, b"A" * 10000)
            # unaligned discard: edge sectors re-encrypt zeros, middle
            # deallocates; reads see zeros
            await img.discard(1000, 6000)
            got = await img.read(0, 10000)
            assert got == b"A" * 1000 + b"\x00" * 6000 + b"A" * 3000
            # unaligned shrink then grow: no stale tail resurrection
            await img.resize(5000)
            await img.resize(20000)
            tail = await img.read(5000, 3000)
            assert tail == b"\x00" * 3000, "stale bytes after regrow"
            await img.close()
            # admin handle: remove works WITHOUT the passphrase, but
            # data I/O through such a handle is refused
            adm = await Image.open(io, "d", read_only=True, admin=True)
            with pytest.raises(RbdError, match="EPERM"):
                await adm.read(0, 10)
            await adm.close()
            await RBD().remove(io, "d")
            assert await RBD().list(io) == []
        finally:
            await shutdown(mon, osds, r)
    run(main())
