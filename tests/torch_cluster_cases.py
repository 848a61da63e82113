"""Cluster scripts run on a ceph_tpu cluster and on a ceph_tpu_torch one.

A ``Side`` names one package's daemons; ``Cluster.boot`` starts a monitor,
N OSDs (one a host, booted in order so both packages number them alike)
and a librados client on loopback.  The port's side runs with
``device="cpu"`` and the ``cuda`` plugin (its wrappers then run the plain
PyTorch versions); the reference's side with its ``tpu`` plugin, as its
own tests run it.  The scripts return what the tests compare: the bytes
read, the stored shards and their tags, and the counters that do not
depend on timing.
"""

from __future__ import annotations

import asyncio
import importlib

import numpy as np

REF, PORT = "ceph_tpu", "ceph_tpu_torch"
HEARTBEAT = {"osd_heartbeat_interval": 0.2, "osd_heartbeat_grace": 3.0}


class Side:
    """One package's daemons and the helpers the scripts reach."""

    def __init__(self, pkg: str) -> None:
        self.pkg = pkg
        self.is_port = pkg == PORT

        def mod(name):
            return importlib.import_module(f"{pkg}.{name}")
        self.Monitor = mod("mon").Monitor
        self.OSD = mod("osd").OSD
        self.Rados = mod("client").Rados
        self.RadosError = mod("client").RadosError
        self.Transaction = mod("os.transaction").Transaction
        self.scrub = mod("osd.scrub")
        self.backend = mod("osd.backend")
        self.device_cache = mod("os.device_cache")
        self.plugin = "cuda" if self.is_port else "tpu"
        self.dev = {"device": "cpu"} if self.is_port else {}


async def wait_for(cond, timeout: float, what: str) -> None:
    """Poll ``cond`` every 0.1 s; TimeoutError after ``timeout`` s."""
    async def poll():
        while not cond():
            await asyncio.sleep(0.1)
    try:
        await asyncio.wait_for(poll(), timeout)
    except asyncio.TimeoutError:
        raise TimeoutError(f"timed out waiting for {what}") from None


class Cluster:
    def __init__(self, side: Side, mon, osds, rados) -> None:
        self.side = side
        self.mon = mon
        self.osds = osds
        self.rados = rados

    @classmethod
    async def boot(cls, side: Side, n_osds: int, osd_config=None,
                   mon_config=None) -> "Cluster":
        mon = side.Monitor(rank=0, config={
            "mon_osd_min_down_reporters": 1,
            "mon_osd_down_out_interval": 3600.0, **(mon_config or {})},
            **side.dev)
        addr = await asyncio.wait_for(mon.start(), 20)
        mon.peer_addrs = [addr]
        osds = []
        for i in range(n_osds):
            osd = side.OSD(host=f"host{i}", config=dict(osd_config or {}),
                           **side.dev)
            await asyncio.wait_for(osd.start(addr), 20)
            osds.append(osd)
        rados = await asyncio.wait_for(
            side.Rados(addr, **side.dev).connect(), 20)
        return cls(side, mon, osds, rados)

    async def stop(self) -> None:
        await self.rados.shutdown()
        for o in self.osds:
            if not o.is_stopped():
                await o.stop()
        await self.mon.stop()

    async def ec_pool(self, name: str, k: int, m: int, pg_num: int,
                      **extra) -> int:
        profile = {"plugin": self.side.plugin, "k": str(k), "m": str(m),
                   "technique": "reed_sol_van", **extra}
        await self.rados.mon_command("osd erasure-code-profile set",
                                     {"name": f"{name}-prof",
                                      "profile": profile})
        return await self.rados.pool_create(
            name, pg_num=pg_num, pool_type="erasure",
            erasure_code_profile=f"{name}-prof")

    def osd(self, whoami: int):
        return next(o for o in self.osds if o.whoami == whoami)

    def target(self, pool_id: int, oid: str):
        """(pgid, primary, acting) by the monitor's map."""
        omap = self.mon.osdmap
        _, ps = omap.object_to_pg(pool_id, oid)
        up, acting = omap.pg_to_up_acting(pool_id, ps)
        return omap.pg_name(pool_id, ps), omap.pg_primary(acting), acting

    async def kill(self, whoami: int) -> dict:
        """Stop an OSD and wait until the monitor marks it down."""
        osd = self.osd(whoami)
        token = osd.revive_token()
        await osd.stop()
        await wait_for(lambda: not self.mon.osdmap.is_up(whoami), 30,
                       f"osd.{whoami} marked down")
        return token

    async def revive(self, token: dict, index: int) -> None:
        """A fresh OSD on the killed one's store; waits until it is up and
        no primary owes recovery."""
        osd = self.side.OSD(uuid=token["uuid"], whoami=token["whoami"],
                            store=token["store"], host=token["host"],
                            config=token["config"], **self.side.dev)
        await asyncio.wait_for(osd.start(self.mon.msgr.addr), 20)
        self.osds[index] = osd
        await wait_for(lambda: self.mon.osdmap.is_up(token["whoami"]), 30,
                       f"osd.{token['whoami']} up")
        await self.wait_clean()

    async def wait_clean(self, timeout: float = 40.0) -> None:
        await wait_for(lambda: not any(
            o.has_pending_recovery() for o in self.osds
            if not o.is_stopped()), timeout, "recovery to finish")

    def counter(self, which: str, key: str) -> int:
        """One counter summed over the live OSDs."""
        return sum(int(o.perf.dump().get(which, {}).get(key, 0))
                   for o in self.osds if not o.is_stopped())

    def stored(self, pool_id: int, osds=None) -> dict:
        """(osd, oid, shard label) -> (bytes, CRC tag) of every object of
        the pool on the OSDs' stores (replicated pools: label None)."""
        b = self.side.backend
        out = {}
        for o in osds if osds is not None else self.osds:
            for coll in o.store.list_collections():
                if not coll.startswith(f"pg_{pool_id}."):
                    continue
                for oid in o.store.list_objects(coll):
                    if oid == b.META_OID or oid.startswith("_"):
                        continue
                    label = o.store.getattr(coll, oid, b.SHARD_XATTR)
                    crc = o.store.getattr(coll, oid, b.CRC_XATTR)
                    out[(o.whoami, oid,
                         None if label is None else int(label))] = (
                        bytes(o.store.read(coll, oid, 0, None)),
                        None if crc is None else int(crc))
        return out


def payloads(seed: int, n: int, size: int) -> dict[str, bytes]:
    rng = np.random.default_rng(seed)
    return {f"obj-{i}": rng.integers(0, 256, size + 37 * i,
                                     dtype=np.uint8).tobytes()
            for i in range(n)}


async def on_both(script, *args, **kw) -> tuple:
    """``script(side, *args, **kw)`` on the reference's side, then on the
    port's; returns the two results."""
    return (await script(Side(REF), *args, **kw),
            await script(Side(PORT), *args, **kw))


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


class RawCluster:
    """A monitor, N OSDs and a bare messenger client that sends
    ``osd_op`` to the current primary itself (``tests/test_osd_cluster.py``'s
    harness, on either package)."""

    def __init__(self, side: Side, mon, osds, client) -> None:
        self.side = side
        self.mon = mon
        self.osds = osds
        self.client = client
        self._op_serial = 0

    @classmethod
    async def boot(cls, side: Side, n_osds: int, osd_config=None,
                   mon_config=None) -> "RawCluster":
        c = await Cluster.boot(side, n_osds, osd_config, mon_config)
        await c.rados.shutdown()
        msg = importlib.import_module(f"{side.pkg}.msg")
        client = msg.Messenger("client.test")
        await client.bind()
        return cls(side, c.mon, c.osds, client)

    async def stop(self) -> None:
        for o in self.osds:
            if not o.is_stopped():
                await o.stop()
        await self.client.shutdown()
        await self.mon.stop()

    async def command(self, cmd: str, args=None):
        Message = importlib.import_module(f"{self.side.pkg}.msg").Message
        q: asyncio.Queue = asyncio.Queue()

        async def d(conn, msg):
            if msg.type == "mon_command_reply":
                await q.put(msg.data)

        self.client.add_dispatcher(d)
        try:
            await self.client.send(self.mon.msgr.addr, "mon.0", Message(
                "mon_command", {"cmd": cmd, "args": args or {}}))
            data = await asyncio.wait_for(q.get(), 10)
        finally:
            self.client.dispatchers.remove(d)
        if not data["ok"]:
            raise RuntimeError(data["error"])
        return data["result"]

    def target_for(self, pool_name: str, oid: str):
        omap = self.mon.osdmap
        pool_id = omap.pool_names[pool_name]
        _, ps = omap.object_to_pg(pool_id, oid)
        up = omap.pg_to_up_acting_osds(pool_id, ps)
        return omap.pg_name(pool_id, ps), omap.pg_primary(up), up

    async def osd_op(self, pool_name: str, oid: str, ops, timeout=15,
                     retries=40):
        """Send ops to the current primary, retrying through peering,
        with one reqid for every retry of the op."""
        Message = importlib.import_module(f"{self.side.pkg}.msg").Message
        q: asyncio.Queue = asyncio.Queue()
        self._op_serial += 1
        tid = self._op_serial
        reqid = [f"{self.client.name}:{self.client.incarnation}", tid]

        async def d(conn, msg):
            if msg.type == "osd_op_reply" and msg.data.get("tid") == tid:
                await q.put(msg)

        self.client.add_dispatcher(d)
        try:
            for _ in range(retries):
                pgid, primary, _ = self.target_for(pool_name, oid)
                if primary is None:
                    await asyncio.sleep(0.25)
                    continue
                addr = self.mon.osdmap.osds[primary].addr
                meta, segs = self.side.backend.pack_mutations(ops)
                try:
                    await self.client.send(
                        tuple(addr), f"osd.{primary}",
                        Message("osd_op", {"pgid": pgid, "oid": oid,
                                           "ops": meta, "reqid": reqid,
                                           "tid": tid}, segments=segs))
                    reply = await asyncio.wait_for(q.get(), timeout)
                except (ConnectionError, OSError, asyncio.TimeoutError):
                    await asyncio.sleep(0.25)
                    continue
                if reply.data.get("err") in ("ENOTPRIMARY", "EAGAIN",
                                             "ENXIO no such pg"):
                    await asyncio.sleep(0.25)
                    continue
                return reply
            raise TimeoutError(f"osd_op on {oid} never succeeded")
        finally:
            self.client.dispatchers.remove(d)


def read_result(reply, idx: int = 0):
    r = reply.data["results"][idx]
    if "seg" in r:
        return r, reply.segments[r["seg"]]
    return r, None
