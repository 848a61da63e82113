"""CephFS over RS k=8,m=3, with its MDS pair and the mgr, on one cluster.

``FsDrive`` is a ``ClusterDrive`` (``tools/ec_osd_bench.py``: a monitor and
``n_osds`` OSDs, one a host, MemStore, through ``SimCluster`` on one
device; its kill, revive and scrub) whose EC pool is CephFS's data pool,
``cephfs_data`` (the ``cuda`` plugin, RS k=8,m=3 by default, the pool's
default 4 KiB stripe unit), with the metadata pool ``cephfs_metadata``
replicated (size 3) beside it: Ceph's documented deployment of CephFS on
erasure-coded pools (``doc/cephfs/createfs.rst``, "Using Erasure Coded
pools with CephFS"), at the default file layout of 4 MiB objects.  It
starts a mgr at vstart's configuration (the balancer active, the
prometheus module serving), MDS ``a`` and ``b`` and two mounts, and drives
what users run over them, one step a method:

- a small-file tree like an untar (``n_files`` files in ``n_dirs``
  directories, 16 creates in flight, sizes seeded lognormal around
  ``small_bytes``, clipped to a quarter of it and 16 times it), read back;
- ``big_files`` files of ``big_bytes`` written and read;
- ``overwrites`` random 4 KiB overwrites inside them, 16 in flight: each
  an EC read-modify-write of one chunk;
- both mounts' capabilities: appends to one file from both, a rename and
  an unlink whose purge goes through the striper;
- ``cephfs_cli`` put, get and ls in processes of their own;
- ``FsMirrorDaemon`` syncing one directory to a second cluster
  (``MIRROR_OSDS`` OSDs, replicated pools, one MDS);
- the active MDS stopped and the standby's takeover, every file read back
  after it and a new mutation;
- the mgr's prometheus scrape against the map and the OSDs' counters, and
  the balancer's moves.

A host dict of bytes is the oracle of every read; a mismatch is recorded in
``report["mismatches"]`` and a failed I/O in ``report["failed_ops"]``.
Each step records its host-clock seconds and rates in ``report``.  The
daemons run on the card unless ``device="cpu"``.
"""

from __future__ import annotations

import asyncio
import os
import re
import sys
import tempfile
import time

import numpy as np

from .apps_drive import http_request
from .ec_osd_bench import TIMEOUT, ClusterDrive, poll

KiB = 1 << 10
MiB = 1 << 20
SEED = 19
IO_SIZE = 4096          # the overwrites' size
MIRROR_OSDS = 3         # the mirror's second cluster
META_POOL = "cephfs_metadata"
MDS_NAMES = ("a", "b")


async def spawn_tool(tool: str, *argv: str, merge_errors: bool = False):
    """``python -m ceph_tpu_torch.tools.<tool>`` on ``argv`` started in a
    process of its own from the checkout's root: the process, its standard
    output piped (its errors too, into the same pipe if
    ``merge_errors``)."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return await asyncio.create_subprocess_exec(
        sys.executable, "-m", f"ceph_tpu_torch.tools.{tool}", *argv,
        stdout=asyncio.subprocess.PIPE,
        stderr=(asyncio.subprocess.STDOUT if merge_errors
                else asyncio.subprocess.PIPE),
        cwd=root, env={**os.environ, "PYTHONPATH": root})


async def run_tool(tool: str, *argv: str) -> str:
    """``spawn_tool`` run to its end: its standard output; a failure raises
    with its errors."""
    proc = await spawn_tool(tool, *argv)
    try:
        out, err = await asyncio.wait_for(proc.communicate(), TIMEOUT)
    finally:
        if proc.returncode is None:
            proc.kill()
            await proc.wait()
    if proc.returncode != 0:
        raise RuntimeError(f"{tool} {' '.join(argv)} exited "
                           f"{proc.returncode}: {err.decode()[-2000:]}")
    return out.decode()


def spans(before: dict, after: dict) -> dict:
    """The MDS's spans between two of its ``perf.dump()``s: {span: {"n",
    "s"}}, the samples and their seconds, largest first."""
    out = {}
    for key, v in after.items():
        if isinstance(v, dict) and "avgcount" in v:
            b = before.get(key, {"avgcount": 0, "sum": 0.0})
            n = v["avgcount"] - b["avgcount"]
            if n:
                out[key] = {"n": n, "s": v["sum"] - b["sum"]}
    return dict(sorted(out.items(), key=lambda kv: -kv[1]["s"]))


class FsDrive(ClusterDrive):
    """CephFS over one ``ClusterDrive`` cluster, one step a method.
    ``cluster`` takes ``ClusterDrive``'s arguments (12 OSDs, RS k=8,m=3,
    pg_num 32, 16 I/Os in flight by default); the defaults of the sizes are
    the card's.  The cuts, for the run's time: 32 small files in 8
    directories (an untar of a source tree makes thousands; a create costs
    two MDS mutations, which the MDS runs one at a time), 2 files of 16 MiB
    and 64 random 4 KiB overwrites."""

    pool = "cephfs_data"

    def __init__(self, *, rep_pg_num: int = 32, n_files: int = 32,
                 n_dirs: int = 8, small_bytes: int = 16 * KiB,
                 big_files: int = 2, big_bytes: int = 16 * MiB,
                 overwrites: int = 64, **cluster) -> None:
        super().__init__(n_objects=0, **cluster)
        self.rep_pg_num = rep_pg_num
        self.n_files, self.n_dirs = n_files, n_dirs
        self.small_bytes = small_bytes
        self.big_files, self.big_bytes = big_files, big_bytes
        self.overwrites = overwrites
        self.rng = np.random.default_rng(SEED)
        self.files: dict[str, bytes] = {}     # the oracle: path -> bytes
        self.mgr = None
        self.mdss: list = []
        self.mounts: list = []                # two CephFS mounts
        self.sites: list = []                 # the mirror's cluster
        self.site_mdss: list = []             # its MDS
        self.site_mounts: list = []           # its mount

    # -- plumbing -------------------------------------------------------------
    async def _read_all(self, fs, paths, label: str) -> None:
        """Each of ``paths`` read whole through ``fs``, ``concurrency`` in
        flight, against the oracle."""
        got = {}

        async def one(path):
            got[path] = await fs.read_file(path)
        t0 = time.perf_counter()
        await self._ops(one(p) for p in paths)
        self._rate(label, sum(len(self.files[p]) for p in paths),
                   time.perf_counter() - t0)
        self._check(label, all(got.get(p) == self.files[p] for p in paths))

    def _bytes(self, n: int) -> bytes:
        return self.rng.integers(0, 256, n, np.uint8).tobytes()

    @property
    def fs(self):
        return self.mounts[0]

    def active_mds(self):
        return next((m for m in self.mdss if m.state == "active"), None)

    async def _start_fs(self, cluster, names, mounts: int) -> tuple:
        """MDS daemons named ``names`` and ``mounts`` CephFS mounts on
        ``cluster``'s device, once one MDS is active."""
        from ..mds import MDS, CephFS
        dev = cluster.mon.device
        mdss = []
        for name in names:
            m = MDS(name=name, device=dev)
            await asyncio.wait_for(
                m.start(cluster.addr, create_pools=False), TIMEOUT)
            mdss.append(m)
        await poll(lambda: any(m.state == "active" for m in mdss), TIMEOUT,
                   "an active MDS")
        fss = []
        for i in range(mounts):
            fss.append(await asyncio.wait_for(CephFS(
                cluster.addr, name=f"client.fs{i}", device=dev).mount(),
                TIMEOUT))
        return mdss, fss

    async def boot(self) -> None:
        """``ClusterDrive``'s boot (``cephfs_data`` on EC), then
        ``cephfs_metadata`` replicated, the mgr, MDS a and b, two
        mounts."""
        from ..mgr import Mgr
        t0 = time.perf_counter()
        await super().boot()
        await self.rados.pool_create(META_POOL, pg_num=self.rep_pg_num,
                                     size=3)
        self.mgr = Mgr(config={"balancer_active": True},
                       device=self.cluster.mon.device)
        await self.mgr.start(self.cluster.addr)
        self.mdss, self.mounts = await self._start_fs(self.cluster,
                                                      MDS_NAMES, 2)
        prom = self.mgr.modules["prometheus"]
        await poll(lambda: prom.addr is not None, TIMEOUT,
                   "the prometheus module serving")
        self.report["boot_s"] = time.perf_counter() - t0

    async def stop(self) -> None:
        for fs in self.mounts + self.site_mounts:
            await fs.unmount()
        for m in self.mdss + self.site_mdss:
            if not m._stopped:
                await m.stop()
        if self.mgr is not None:
            await self.mgr.stop()
        for c in self.sites:
            await c.stop()
        await super().stop()

    # -- 13a step 1: a small-file tree ----------------------------------------
    def small_sizes(self) -> np.ndarray:
        """Seeded lognormal sizes around ``small_bytes``, clipped to a
        quarter of it and 16 times it."""
        sizes = self.rng.lognormal(np.log(self.small_bytes), 1.0,
                                   self.n_files)
        return np.clip(sizes, self.small_bytes // 4,
                       16 * self.small_bytes).astype(np.int64)

    async def small_files(self) -> None:
        """``n_files`` files in ``n_dirs`` directories, ``concurrency``
        creates in flight, then every file read back."""
        fs = self.fs
        await fs.mkdir("/tree")
        for d in range(self.n_dirs):
            await fs.mkdir(f"/tree/d{d:02d}")
        items = {f"/tree/d{i % self.n_dirs:02d}/f{i:04d}": self._bytes(int(n))
                 for i, n in enumerate(self.small_sizes())}
        mds = self.active_mds()
        before = mds.perf.dump()
        t0 = time.perf_counter()
        lat = await self._ops(fs.write_file(p, d) for p, d in items.items())
        self._iops("creates", lat, time.perf_counter() - t0)
        self.report["mds_spans"] = spans(before, mds.perf.dump())
        self.files.update(items)
        self.report["small_bytes_total"] = sum(map(len, items.values()))
        await self._read_all(fs, list(items), "small_read")

    # -- step 2: large files at the default layout ----------------------------
    def big_paths(self) -> list[str]:
        return [f"/big/f{i:02d}" for i in range(self.big_files)]

    async def big_write_read(self) -> None:
        """``big_files`` files of ``big_bytes`` written whole,
        ``concurrency`` in flight, then read."""
        fs = self.fs
        await fs.mkdir("/big")
        items = {p: self._bytes(self.big_bytes) for p in self.big_paths()}
        t0 = time.perf_counter()
        await self._ops(fs.write_file(p, d) for p, d in items.items())
        self._rate("big_write", self.big_files * self.big_bytes,
                   time.perf_counter() - t0)
        self.files.update(items)
        await self._read_all(fs, list(items), "big_read")

    # -- step 3: 4 KiB overwrites inside the large files ----------------------
    async def overwrite(self) -> None:
        """``overwrites`` random aligned 4 KiB overwrites inside the large
        files through open handles, ``concurrency`` in flight (each an EC
        read-modify-write), then the files read back."""
        fs = self.fs
        paths = self.big_paths()
        handles = {p: await fs.open(p, "r+") for p in paths}
        slots = self.big_bytes // IO_SIZE
        picks = self.rng.choice(len(paths) * slots, self.overwrites,
                                replace=False)
        blocks = [(paths[int(x) // slots], int(x) % slots * IO_SIZE,
                   self._bytes(IO_SIZE)) for x in picks]
        t0 = time.perf_counter()
        lat = await self._ops(handles[p].write(d, off) for p, off, d in blocks)
        self._iops("overwrite_4k", lat, time.perf_counter() - t0)
        for h in handles.values():
            await h.close()
        for p, off, d in blocks:
            buf = bytearray(self.files[p])
            buf[off:off + IO_SIZE] = d
            self.files[p] = bytes(buf)
        await self._read_all(fs, paths, "overwrite_read")

    # -- step 4: both mounts' capabilities ------------------------------------
    async def caps(self) -> None:
        """Appends to one file from both mounts in turn (each write
        revokes the other's write cap): every record and the size
        survive.  Then a rename, and an unlink whose purge removes the
        file's data objects through the striper."""
        fs, fs2 = self.mounts
        t0 = time.perf_counter()
        await fs.write_file("/shared.log", b"")
        f1 = await fs.open("/shared.log", "a")
        f2 = await fs2.open("/shared.log", "a")
        records = []
        for i in range(6):
            a, b = f"A{i}:".encode() * 10, f"B{i}:".encode() * 10
            await f1.write(a)
            await f2.write(b)
            records += [a, b]
        await f1.close()
        await f2.close()
        data = await fs.read_file("/shared.log")
        self._check("caps_appends", data == b"".join(records)
                    and (await fs2.stat("/shared.log"))["size"] == len(data))
        await fs2.rename("/shared.log", "/renamed.log")
        self._check("caps_rename", await fs.read_file("/renamed.log") == data
                    and not await fs.exists("/shared.log"))
        self.files["/renamed.log"] = data
        victim = self.big_paths()[-1]
        ino = (await fs.stat(victim))["ino"]
        before = await self._data_objects(ino)
        await fs2.unlink(victim)
        after = await self._data_objects(ino)
        del self.files[victim]
        self.report["purged_objects"] = len(before)
        self._check("caps_unlink_purge", len(before) > 0 and not after
                    and not await fs.exists(victim))
        self.report["caps_s"] = time.perf_counter() - t0

    async def _data_objects(self, ino: int) -> list[str]:
        return [o for o in await self.io.list_objects()
                if o.startswith(f"{ino:x}.")]

    # -- step 5: cephfs_cli in processes of their own -------------------------
    async def _cli(self, *argv: str) -> str:
        host, port = self.cluster.addr
        return await run_tool("cephfs_cli", "--mon", f"{host}:{port}",
                              "--device", self.cluster.mon.device.type,
                              *argv)

    async def cli(self) -> None:
        """``cephfs_cli put`` of a seeded file, then ``get`` of it and
        ``ls`` of its directory at once: the bytes equal the oracle's and
        ``ls`` lists it with its size."""
        data = self._bytes(3 * MiB + 12345)
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            src, dst = os.path.join(tmp, "in"), os.path.join(tmp, "out")
            with open(src, "wb") as f:
                f.write(data)
            await self._cli("put", src, "/tree/cli.bin")
            _, listing = await asyncio.gather(
                self._cli("get", "/tree/cli.bin", dst),
                self._cli("ls", "/tree"))
            with open(dst, "rb") as f:
                got = f.read()
        self.report["cli_s"] = time.perf_counter() - t0
        self.files["/tree/cli.bin"] = data
        line = f"- {len(data):>10} cli.bin"
        self._check("cli", got == data and line in listing.splitlines())

    # -- step 6: fs_mirror to a second cluster --------------------------------
    async def mirror(self) -> None:
        """``FsMirrorDaemon`` syncs one directory of the tree to a second
        cluster (``MIRROR_OSDS`` OSDs, replicated pools, one MDS on the
        same device): every file there equals its oracle."""
        from ..client.rados import Rados
        from ..loadgen.cluster import SimCluster
        from ..mds.fs_mirror import FsMirrorDaemon, fs_mirror_add
        t0 = time.perf_counter()
        site = await SimCluster.create(MIRROR_OSDS,
                                       device=self.cluster.mon.device)
        self.sites.append(site)
        r = await Rados(site.addr, device=site.mon.device).connect()
        try:
            for p in (META_POOL, self.pool):
                await r.pool_create(p, pg_num=8)
        finally:
            await r.shutdown()
        self.site_mdss, self.site_mounts = await self._start_fs(
            site, ("a",), 1)
        dst = self.site_mounts[0]
        src_dir = "/tree/d00"
        await dst.mkdir("/tree")          # the peer's parent directory
        await fs_mirror_add(self.fs.meta, src_dir)
        daemon = FsMirrorDaemon(self.fs, dst)
        stats = await asyncio.wait_for(daemon.sync_all(), TIMEOUT)
        paths = [p for p in self.files if p.startswith(src_dir + "/")]
        got = {p: await dst.read_file(p) for p in paths}
        self.report["mirror_s"] = time.perf_counter() - t0
        self.report["mirror_files"] = len(paths)
        self.report["mirror_stats"] = stats
        self._check("mirror", stats.get(src_dir, {}).get("copied")
                    == len(paths) and all(got[p] == self.files[p]
                                          for p in paths))

    # -- step 7: MDS failover -------------------------------------------------
    async def failover(self) -> None:
        """``stop()`` of the active MDS: seconds until the standby is
        active; every file then reads equal to its oracle through the
        second mount, and a new mutation succeeds."""
        active = self.active_mds()
        standby = next(m for m in self.mdss if m is not active)
        t0 = time.perf_counter()
        await active.stop()
        await poll(lambda: standby.state == "active", TIMEOUT,
                   "the standby MDS to take over")
        self.report["failover_s"] = time.perf_counter() - t0
        self.report["failover_from_to"] = [active.name, standby.name]
        await self._read_all(self.mounts[1], sorted(self.files),
                             "after_failover_read")
        await self.fs.mkdir("/post")
        await self.fs.write_file("/post/new", b"after failover")
        self.files["/post/new"] = b"after failover"
        self._check("after_failover_mutation",
                    await self.mounts[1].read_file("/post/new")
                    == b"after failover")

    # -- step 8: the mgr ------------------------------------------------------
    async def scrape(self) -> str:
        status, _, body = await http_request(
            self.mgr.modules["prometheus"].addr, "GET", "/metrics")
        if status != 200:
            raise RuntimeError(f"prometheus scrape: HTTP {status}")
        return body.decode()

    async def mgr_check(self) -> None:
        """The prometheus scrape shows every OSD up and in, both pools'
        pg_num and the map's epoch; each OSD's ``op_w`` equals the mgr's
        last report from it and is no more than the OSD's own counter
        read right after.  The balancer's moves are the map's upmap
        items."""
        t0 = time.perf_counter()
        epochs = [self.mgr.osdmap.epoch]
        text = await self.scrape()
        epochs.append(self.mgr.osdmap.epoch)
        reports = {k: dict(v.get("summary", {}))
                   for k, v in self.mgr.daemon_reports.items()}
        own = {f"osd.{o.whoami}": int(o.perf.dump()["osd"].get("op_w", 0))
               for o in self.cluster.osds}
        samples = dict(re.findall(r"^(\S+) (\S+)$", text, re.M))

        def sample(name, **labels):
            key = name + "{" + ",".join(f'{k}="{v}"' for k, v in
                                         labels.items()) + "}" \
                if labels else name
            return samples.get(key)

        osds = [f"osd.{o}" for o in sorted(self.cluster.mon.osdmap.osds)]
        self._check("mgr_osds", all(
            sample("ceph_osd_up", ceph_daemon=d) == "1"
            and sample("ceph_osd_in", ceph_daemon=d) == "1" for d in osds))
        mon = self.cluster.mon.osdmap
        self._check("mgr_pools", all(
            sample("ceph_pool_pg_num", pool=p) == str(
                mon.pools[mon.pool_names[p]].pg_num)
            for p in (self.pool, META_POOL)))
        epoch = int(sample("ceph_osdmap_epoch") or -1)
        self._check("mgr_epoch", epochs[0] <= epoch <= epochs[1])
        op_w = {d: sample("ceph_daemon_op_w", ceph_daemon=d) for d in osds}

        def agrees(d: str) -> bool:
            # an OSD that took no client write has no op_w yet: none in
            # its report, none in the scrape
            want = reports.get(d, {}).get("op_w")
            if want is None:
                return op_w[d] is None
            return op_w[d] is not None and \
                int(float(op_w[d])) == want <= own[d]
        self._check("mgr_op_w", all(agrees(d) for d in osds))
        moved = sum(len(v) for v in mon.pg_upmap_items.values())
        self.report["mgr"] = {
            "osds_up": sum(sample("ceph_osd_up", ceph_daemon=d) == "1"
                           for d in osds),
            "epoch": epoch,
            "op_w": {d: int(float(v)) for d, v in op_w.items()
                     if v is not None},
            "balancer_upmap_items": moved,
            "balancer_log": [ln for ln in self.mgr.log
                             if ln.startswith("balancer: moved")],
            "scrape_bytes": len(text)}
        self.report["mgr_s"] = time.perf_counter() - t0
