"""The port's mirror daemons' CLIs against the reference's, each between
two clusters of its own package on one event loop: ``cephfs_mirror``
(``add``, ``ls``, the replaying daemon in a process of its own,
``remove``) and ``rbd_mirror`` (the replaying daemon in a process of its
own, ``rbd_cli mirror enable`` on the primary).  Each runs the same argv on
each package and must print the same output, timings and ports masked;
the secondary must hold what the primary wrote."""

import asyncio

import torch

from torch_cli_cases import Site, mask, on_both

torch.set_num_threads(1)

FILES = {"/proj/readme": b"top doc", "/proj/src/main.py": b"print('hi')",
         "/proj/src/blob": bytes(range(256)) * 64}


async def files_equal(fs, files: dict) -> bool:
    try:
        return all([await fs.read_file(p) == d for p, d in files.items()])
    except Exception:
        return False


def test_cephfs_mirror():
    def script(pkg):
        a = Site(pkg, fs=True)
        b = Site(pkg, fs=True, loop=a.loop)
        try:
            async def fill():
                fs = await a.mount()
                await fs.mkdir("/proj")
                await fs.mkdir("/proj/src")
                for p, d in FILES.items():
                    await fs.write_file(p, d)
                await fs.unmount()
            a.run(fill())
            runs = [a.cli("cephfs_mirror", "--src-mon", a.mon, "add",
                          "/proj"),
                    a.cli("cephfs_mirror", "--src-mon", a.mon, "ls")]

            async def replay():
                proc = await a.spawn("cephfs_mirror", "--src-mon", a.mon,
                                     "--dst-mon", b.mon, "--interval", "0.5")
                banner = await Site.banner(proc)
                fs = await b.mount()
                ok = False
                for _ in range(120):
                    if await files_equal(fs, FILES):
                        ok = True
                        break
                    await asyncio.sleep(0.3)
                await fs.unmount()
                rc, rest = await Site.end(proc)
                return banner, ok, rc, rest
            banner, ok, rc, rest = a.run(replay())
            runs += [a.cli("cephfs_mirror", "--src-mon", a.mon, "remove",
                           "/proj"),
                     a.cli("cephfs_mirror", "--src-mon", a.mon, "ls")]
            return ok, rc, mask(banner + rest), [(r, mask(o))
                                                 for r, o in runs]
        finally:
            b.stop()
            a.stop()
    ref, port = on_both(script)
    assert port[0] and port[1] == 0
    assert port[3][1] == (0, "/proj\n") and port[3][3] == (0, "")
    assert "cephfs-mirror: replaying every" in port[2]
    assert port == ref


def test_rbd_mirror():
    def script(pkg):
        a = Site(pkg)
        b = Site(pkg, loop=a.loop)
        rbd = a.mod("rbd")
        data = bytes(range(256)) * 256

        async def make():
            await a.c.rados.pool_create("rbd", pg_num=4)
            io = await a.c.rados.open_ioctx("rbd")
            await rbd.RBD().create(io, "img", 1 << 18, order=16)
            img = await rbd.Image.open(io, "img")
            await img.write(4096, data)
            await img.close()
        try:
            a.run(make())
            runs = [a.cli("rbd_cli", "--mon", a.mon, "mirror", "enable",
                          "img")]

            async def mirrored() -> bool:
                try:
                    if "rbd" not in await b.c.rados.pool_list():
                        return False
                    io = await b.c.rados.open_ioctx("rbd")
                    if "img" not in await rbd.RBD().list(io):
                        return False
                    img = await rbd.Image.open(io, "img", read_only=True)
                    try:
                        return await img.read(4096, len(data)) == data
                    finally:
                        await img.close()
                except Exception:
                    return False

            async def replay():
                proc = await a.spawn("rbd_mirror", "--src-mon", a.mon,
                                     "--dst-mon", b.mon, "-p", "rbd",
                                     "--interval", "0.5")
                banner = await Site.banner(proc)
                ok = False
                for _ in range(120):
                    if await mirrored():
                        ok = True
                        break
                    await asyncio.sleep(0.3)
                rc, rest = await Site.end(proc)
                return banner, ok, rc, rest
            banner, ok, rc, rest = a.run(replay())
            return ok, rc, mask(banner + rest), [(r, mask(o))
                                                 for r, o in runs]
        finally:
            b.stop()
            a.stop()
    ref, port = on_both(script)
    assert port[0] and port[1] == 0
    assert "rbd-mirror: replaying pool 'rbd' every" in port[2]
    assert port == ref
