"""OSD-path EC benchmark: concurrent client writes through a cluster.

Port of ``ceph_tpu/tools/ec_osd_bench.py``.  The raw-codec bench measures
the kernel; this one measures the SYSTEM: a vstart-style in-process
cluster (mon + N OSDs, one a host, all on one device), an erasure-coded
pool on the `cuda` profile, and many concurrent librados writes -- the
shape where the CodecBatcher coalesces stripes across ops and PGs into
shared ``MeshCodec`` launches (K2 for the parity, the chunk CRCs fused
by K4).

``ClusterDrive`` drives the cluster's whole EC data path on one
cluster: timed write rounds, a read sweep, an OSD
killed (marked down, kept in), a degraded read sweep, a degraded write
round, the OSD revived and recovered from the PG logs, a last read
sweep and ``scrub_ec`` of every PG on its primary.  Every read is held
against its source.  ``run_osd_path_bench`` is the reference's bench on
a drive's boot and write rounds: client throughput AND batch occupancy
(stripes per launch, pad waste, flush reasons) from the per-OSD
"ec_batch" perf counters, in the reference's JSON fields.

    python -m ceph_tpu_torch.tools.ec_osd_bench --objects 64 --obj-kib 64
    python -m ceph_tpu_torch.tools.ec_osd_bench --drive --osds 12 --k 8 \\
        --m 3 --pg-num 32 --objects 128 --obj-kib 4096

Both run on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import time

import numpy as np

GiB = float(1 << 30)
SEED = 0            # the payloads' generator


def _sum_ec_batch(osds) -> tuple[dict, dict, dict]:
    """(ec_batch counters, flush reasons, ec_pipeline counters) summed
    over the live OSDs."""
    batch: dict[str, float] = {}
    flush: dict[str, float] = {}
    pipeline: dict[str, float] = {}
    for osd in osds:
        if osd.is_stopped():
            continue
        dump = osd.perf.dump()
        for key, v in dump.get("ec_batch", {}).items():
            if not isinstance(v, (int, float)):
                continue
            if key == "mesh_devices":
                batch[key] = max(batch.get(key, 0), v)
            else:
                batch[key] = batch.get(key, 0) + v
            if key.startswith("flush_"):
                flush[key] = flush.get(key, 0) + v
        for key, v in dump.get("ec_pipeline", {}).items():
            if isinstance(v, (int, float)):
                pipeline[key] = pipeline.get(key, 0) + v
    return batch, flush, pipeline


def _delta(after: dict, before: dict) -> dict:
    """Counter deltas; the ``mesh_devices`` gauge is kept as it stands."""
    return {k: v if k == "mesh_devices" else v - before.get(k, 0)
            for k, v in after.items()}


def occupancy(batch: dict, flush: dict, pipeline: dict) -> dict:
    """The reference bench's occupancy fields from summed counters."""
    batches = int(batch.get("batches", 0))
    stripes = int(batch.get("stripes", 0))
    mesh_launches = int(batch.get("mesh_launches", 0))
    n_devices = int(batch.get("mesh_devices", 0))
    return {
        "stripes_per_launch": round(stripes / batches, 2)
        if batches else 0.0,
        "batches": batches,
        "stripes": stripes,
        "pad_waste_bytes": int(batch.get("pad_waste_bytes", 0)),
        "fallback_ops": int(batch.get("fallback_ops", 0)),
        "mesh": {
            "launches": mesh_launches,
            "fallbacks": int(batch.get("mesh_fallbacks", 0)),
            "launches_per_batch": round(mesh_launches / batches, 3)
            if batches else 0.0,
            "n_devices": n_devices,
            "per_device_stripes": round(
                batch.get("mesh_padded_stripes", 0) / mesh_launches
                / n_devices, 2) if mesh_launches and n_devices else 0.0,
        },
        "xor_sched": {
            "launches": int(batch.get("xor_sched_launches", 0)),
            "fallbacks": int(batch.get("xor_sched_fallbacks", 0)),
            "terms_saved": int(batch.get("xor_terms_saved", 0)),
        },
        "ec_pipeline": {k: int(v) for k, v in pipeline.items()},
        "flush_reasons": {k: int(v) for k, v in flush.items()},
    }


async def poll(cond, timeout: float, what: str) -> None:
    """Wait until ``cond()`` holds, checking every 50 ms; raise
    RuntimeError naming ``what`` after ``timeout`` seconds."""
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise RuntimeError(f"timed out waiting for {what}")
        await asyncio.sleep(0.05)


async def scrub_pool(cluster, pool_id: int) -> tuple[int, list]:
    """``scrub_ec`` of every PG of the pool on its live primary: (objects
    scrubbed, [(pgid, inconsistent objects)])."""
    from ..osd.scrub import scrub_ec
    n, bad = 0, []
    for osd in cluster.osds:
        if osd.is_stopped():
            continue
        for pgid, pg in sorted(osd.pgs.items()):
            if pgid.startswith(f"{pool_id}.") and pg.is_primary():
                res = await scrub_ec(pg)
                n += res.objects_scrubbed
                if res.inconsistent:
                    bad.append((pgid, sorted(res.inconsistent)))
    return n, bad


async def run_osd_path_bench(*, n_osds: int = 3, k: int = 2, m: int = 1,
                             n_objects: int = 48,
                             obj_bytes: int = 64 * 1024,
                             concurrency: int = 16,
                             pg_num: int = 8,
                             rounds: int = 2,
                             mesh: bool | None = None,
                             device=None, plugin: str = "cuda") -> dict:
    """Drive N concurrent EC writes; return throughput + occupancy.

    A ``ClusterDrive`` boot and its write rounds (a warm round, then
    ``rounds`` timed ones); the occupancy counts every round, the warm
    one included, as the reference's does.  ``mesh`` forces the data
    plane on (True) or off (False); None keeps the config default.
    ``device`` is every daemon's (CUDA unless the caller names the CPU);
    ``plugin`` the EC profile's."""
    drive = ClusterDrive(
        n_osds=n_osds, k=k, m=m, pg_num=pg_num, n_objects=n_objects,
        obj_bytes=obj_bytes, concurrency=concurrency, rounds=rounds,
        plugin=plugin, device=device,
        osd_config=None if mesh is None
        else {"osd_ec_mesh_enabled": bool(mesh)})
    try:
        await drive.boot()
        await drive.write_rounds()
        rep = drive.report
        return {
            "osd_path_GiBps": round(rep["write_GiBps"], 3),
            "writes_per_s": round(rounds * n_objects / rep["write_s"], 1),
            **occupancy(*drive.counters()),
            "n_osds": n_osds, "k": k, "m": m,
            "objects": n_objects, "obj_bytes": obj_bytes,
            "concurrency": concurrency, "rounds": rounds,
        }
    finally:
        await drive.stop()


class ClusterDrive:
    """The cluster's EC data path, one step a method, on one cluster.

    ``boot`` starts a monitor and ``n_osds`` OSDs (one a host, MemStore,
    the shard cache and the batcher at their defaults) on ``device``
    through ``SimCluster``, connects a client, creates the pool (the
    default stripe unit) and makes the payloads from ``SEED``.  Each step
    records its host-clock seconds and rate in ``report``; every read is
    held against its source, a mismatch recorded in
    ``report["mismatches"]``."""

    pool = "ecdrive"            # the EC pool's name
    victim_oid = "obj-0"        # the kill takes a shard holder of this object

    def __init__(self, *, n_osds: int = 12, k: int = 8, m: int = 3,
                 pg_num: int = 32, n_objects: int = 128,
                 obj_bytes: int = 4 << 20, concurrency: int = 16,
                 rounds: int = 2, plugin: str = "cuda", device=None,
                 osd_config: dict | None = None) -> None:
        self.n_osds, self.k, self.m = n_osds, k, m
        self.pg_num, self.n_objects, self.obj_bytes = \
            pg_num, n_objects, obj_bytes
        self.concurrency, self.rounds = concurrency, rounds
        self.plugin, self.device = plugin, device
        self.osd_config = osd_config
        self.cluster = None
        self.rados = None
        self.io = None
        self.pool_id = None
        self.src: dict[str, bytes] = {}
        self.victim = None
        self._token = None
        self.report: dict = {"mismatches": []}

    @property
    def oids(self) -> list[str]:
        return [f"obj-{i}" for i in range(self.n_objects)]

    async def boot(self) -> None:
        from ..client.rados import Rados
        from ..loadgen.cluster import SimCluster
        t0 = time.perf_counter()
        self.cluster = await SimCluster.create(
            self.n_osds, device=self.device,
            mon_config={"mon_osd_down_out_interval": 3600.0},
            osd_config=self.osd_config)
        self.rados = await Rados(self.cluster.addr,
                                 device=self.cluster.mon.device).connect()
        await self.rados.mon_command(
            "osd erasure-code-profile set",
            {"name": "drive", "profile": {
                "plugin": self.plugin, "k": str(self.k), "m": str(self.m),
                "technique": "reed_sol_van"}})
        self.pool_id = await self.rados.pool_create(
            self.pool, pg_num=self.pg_num, pool_type="erasure",
            erasure_code_profile="drive")
        self.io = await self.rados.open_ioctx(self.pool)
        rng = np.random.default_rng(SEED)
        self.src = {oid: rng.integers(0, 256, self.obj_bytes,
                                      dtype=np.uint8).tobytes()
                    for oid in self.oids}
        self.report["boot_s"] = time.perf_counter() - t0

    async def stop(self) -> None:
        if self.rados is not None:
            await self.rados.shutdown()
        if self.cluster is not None:
            await self.cluster.stop()

    def counters(self) -> tuple[dict, dict, dict]:
        return _sum_ec_batch(self.cluster.osds)

    async def write(self, items: dict[str, bytes]) -> float:
        """write_full every item at the drive's concurrency; seconds."""
        sem = asyncio.Semaphore(self.concurrency)

        async def one(oid, data):
            async with sem:
                await self.io.write_full(oid, data)
        t0 = time.perf_counter()
        await asyncio.gather(*(one(o, d) for o, d in items.items()))
        return time.perf_counter() - t0

    async def write_rounds(self) -> None:
        """A warm round, then ``rounds`` timed rounds of every object."""
        self.report["warm_write_s"] = await self.write(self.src)
        before = self.counters()
        dt = 0.0
        for _ in range(self.rounds):
            dt += await self.write(self.src)
        after = self.counters()
        self.report["write_s"] = dt
        self.report["write_GiBps"] = \
            self.rounds * self.n_objects * self.obj_bytes / dt / GiB
        self.report["write_occupancy"] = occupancy(
            *(_delta(a, b) for a, b in zip(after, before)))

    async def read_sweep(self, label: str) -> float:
        """Read every object once (concurrency as the writes); seconds
        and GiB/s under ``label``; mismatches recorded."""
        sem = asyncio.Semaphore(self.concurrency)

        async def one(oid):
            async with sem:
                got = await self.io.read(oid)
            if got != self.src[oid]:
                self.report["mismatches"].append((label, oid))
        t0 = time.perf_counter()
        await asyncio.gather(*(one(o) for o in self.oids))
        dt = time.perf_counter() - t0
        self.report[f"{label}_s"] = dt
        self.report[f"{label}_GiBps"] = \
            self.n_objects * self.obj_bytes / dt / GiB
        return dt

    def pick_victim(self, oid: str) -> int:
        """A shard holder of ``oid`` that is not its primary."""
        omap = self.cluster.mon.osdmap
        _, ps = omap.object_to_pg(self.pool_id, oid)
        up, acting = omap.pg_to_up_acting(self.pool_id, ps)
        primary = omap.pg_primary(acting)
        return next(o for o in acting if o != primary)

    async def kill(self, timeout: float = 60.0) -> None:
        """Kill one OSD and wait until the monitor marks it down; it
        stays in (``mon_osd_down_out_interval`` long), so its PGs run
        degraded and are not remapped."""
        self.victim = self.pick_victim(self.victim_oid)
        index = next(i for i, o in enumerate(self.cluster.osds)
                     if o.whoami == self.victim)
        t0 = time.perf_counter()
        self._token = (index, await self.cluster.kill_osd(index))
        if not await self.cluster.wait_down(self.victim, timeout):
            raise RuntimeError(f"osd.{self.victim} never marked down")
        self.report["mark_down_s"] = time.perf_counter() - t0

    async def degraded_write(self) -> None:
        """New payloads for the first half of the objects while the
        victim is down: k+m-1 shards are up, min_size k+1."""
        rng = np.random.default_rng(SEED + 1)
        new = {oid: rng.integers(0, 256, self.obj_bytes,
                                 dtype=np.uint8).tobytes()
               for oid in self.oids[:self.n_objects // 2]}
        dt = await self.write(new)
        self.src.update(new)
        self.report["degraded_write_s"] = dt
        self.report["degraded_write_GiBps"] = \
            len(new) * self.obj_bytes / dt / GiB

    async def revive(self, timeout: float = 120.0) -> None:
        """Revive the victim on its store; log-based recovery rebuilds
        the shards it missed.  Seconds from the revive until no primary
        owes recovery."""
        index, token = self._token
        t0 = time.perf_counter()
        await self.cluster.revive_osd(index, token)
        if not await self.cluster.wait_up(self.victim, timeout):
            raise RuntimeError(f"osd.{self.victim} never came back up")
        epoch = self.cluster.mon.osdmap.epoch
        await poll(lambda: all(o.osdmap.epoch >= epoch
                               for o in self.cluster.osds), timeout,
                   "maps to settle after the revive")
        if not await self.cluster.wait_clean(timeout):
            raise RuntimeError("recovery never finished")
        self.report["recovery_s"] = time.perf_counter() - t0

    def revived_osd(self):
        return next(o for o in self.cluster.osds if o.whoami == self.victim)

    async def scrub(self, timeout: float = 120.0) -> None:
        """``scrub_pool`` of the pool: seconds, objects scrubbed and the
        inconsistent PGs in ``report``."""
        t0 = time.perf_counter()
        n, bad = await asyncio.wait_for(
            scrub_pool(self.cluster, self.pool_id), timeout)
        self.report["scrub_s"] = time.perf_counter() - t0
        self.report["scrub_objects"] = n
        self.report["scrub_inconsistent"] = bad

    async def run(self) -> dict:
        """Every step in order: write rounds, read sweep, kill, degraded
        read sweep, degraded write, revive and recovery, read sweep,
        scrub."""
        await self.write_rounds()
        await self.read_sweep("read")
        await self.kill()
        await self.read_sweep("degraded_read")
        await self.degraded_write()
        await self.revive()
        await self.read_sweep("read_after_recovery")
        await self.scrub()
        return self.report

    def summary(self) -> dict:
        r = self.report
        occ = r.get("write_occupancy", {})
        return {
            "osd_path_GiBps": round(r.get("write_GiBps", 0.0), 3),
            "writes_per_s": round(self.rounds * self.n_objects
                                  / r["write_s"], 1) if "write_s" in r
            else 0.0,
            **occ,
            "read_GiBps": round(r.get("read_GiBps", 0.0), 3),
            "degraded_read_GiBps": round(r.get("degraded_read_GiBps", 0.0),
                                         3),
            "degraded_write_GiBps": round(
                r.get("degraded_write_GiBps", 0.0), 3),
            "recovery_s": round(r.get("recovery_s", 0.0), 3),
            "scrub_s": round(r.get("scrub_s", 0.0), 3),
            "scrub_objects": r.get("scrub_objects", 0),
            "scrub_inconsistent": r.get("scrub_inconsistent", []),
            "mismatches": len(r["mismatches"]),
            "n_osds": self.n_osds, "k": self.k, "m": self.m,
            "pg_num": self.pg_num, "objects": self.n_objects,
            "obj_bytes": self.obj_bytes, "concurrency": self.concurrency,
            "rounds": self.rounds,
        }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ec_osd_bench")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the plain versions)")
    p.add_argument("--profile-plugin", default="cuda",
                   help="the EC profile's plugin (default cuda)")
    p.add_argument("--osds", type=int, default=3)
    p.add_argument("--k", type=int, default=2)
    p.add_argument("--m", type=int, default=1)
    p.add_argument("--objects", type=int, default=48)
    p.add_argument("--obj-kib", type=int, default=64)
    p.add_argument("--concurrency", type=int, default=16)
    p.add_argument("--pg-num", type=int, default=8)
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--mesh", dest="mesh", action="store_true",
                   default=None, help="force the batcher's data plane on")
    p.add_argument("--no-mesh", dest="mesh", action="store_false",
                   help="force the batcher's data plane off")
    p.add_argument("--drive", action="store_true",
                   help="the whole data path: writes, reads, kill, "
                        "degraded reads and write, revive, recovery, scrub")
    args = p.parse_args(argv)
    if args.drive:
        drive = ClusterDrive(
            n_osds=args.osds, k=args.k, m=args.m, pg_num=args.pg_num,
            n_objects=args.objects, obj_bytes=args.obj_kib * 1024,
            concurrency=args.concurrency, rounds=args.rounds,
            plugin=args.profile_plugin, device=args.device)

        async def go():
            try:
                await drive.boot()
                await drive.run()
            finally:
                await drive.stop()
        asyncio.run(go())
        res = drive.summary()
        print(json.dumps(res), flush=True)
        return 1 if res["mismatches"] or res["scrub_inconsistent"] else 0
    res = asyncio.run(run_osd_path_bench(
        n_osds=args.osds, k=args.k, m=args.m, n_objects=args.objects,
        obj_bytes=args.obj_kib * 1024, concurrency=args.concurrency,
        pg_num=args.pg_num, rounds=args.rounds, mesh=args.mesh,
        device=args.device, plugin=args.profile_plugin))
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
