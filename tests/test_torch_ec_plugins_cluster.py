"""The port's host EC plugins behind its daemons on the CPU: a monitor and 7
OSDs (``SimCluster``, ``device="cpu"``) with a jerasure ``cauchy_good`` pool
(the bitmatrix codec) and a clay pool, k=4,m=2 each.  The monitor accepts both
profiles, the OSDs encode through ``ECBackend`` on the host (no batcher: the
codecs have no batch entry points), and every object reads back equal to its
source before and after one OSD of its acting set is killed and marked down
(the degraded read decodes on the primary)."""

import asyncio

import numpy as np

from ceph_tpu_torch.client import Rados
from ceph_tpu_torch.loadgen.cluster import SimCluster
from ceph_tpu_torch.osd.codec_batcher import CodecBatcher

POOLS = {
    "jer": {"plugin": "jerasure", "technique": "cauchy_good", "k": "4",
            "m": "2", "packetsize": "64"},
    "clay": {"plugin": "clay", "k": "4", "m": "2", "d": "5"},
}
N_OBJECTS = 4
OBJ_BYTES = 48 << 10


def test_jerasure_and_clay_pools_write_read_and_read_degraded():
    async def main():
        cluster = await SimCluster.create(7, device="cpu")
        rados = await Rados(cluster.addr, name="client.admin",
                            device="cpu").connect()
        try:
            ios, sources = {}, {}
            for name, profile in POOLS.items():
                await rados.mon_command("osd erasure-code-profile set",
                                        {"name": f"{name}-prof",
                                         "profile": profile})
                await rados.pool_create(name, pg_num=4, pool_type="erasure",
                                        erasure_code_profile=f"{name}-prof")
                ios[name] = await rados.open_ioctx(name)
            rng = np.random.default_rng(3)
            for name, io in ios.items():
                for i in range(N_OBJECTS):
                    data = rng.integers(0, 256, OBJ_BYTES - 17 * i,
                                        dtype=np.uint8).tobytes()
                    sources[name, f"obj{i}"] = data
                    await io.write_full(f"obj{i}", data)
            for (name, oid), data in sources.items():
                assert await ios[name].read(oid) == data, (name, oid)
            # the codecs run on the host, as the reference's do
            for osd in cluster.osds:
                for pg in osd.pgs.values():
                    codec = getattr(pg.backend, "codec", None)
                    if codec is not None:
                        assert not CodecBatcher.supports(codec)
            omap = cluster.mon.osdmap
            pool_id = omap.pool_names["clay"]
            _, ps = omap.object_to_pg(pool_id, "obj0")
            acting = omap.pg_to_up_acting_osds(pool_id, ps)
            victim = next(o for o in acting[1:] if o >= 0)
            index = next(i for i, o in enumerate(cluster.osds)
                         if o.whoami == victim)
            await cluster.kill_osd(index)
            assert await cluster.wait_down(victim, timeout=30)
            for (name, oid), data in sources.items():
                got = await asyncio.wait_for(ios[name].read(oid), 30)
                assert got == data, (name, oid)
            degraded = cluster.perf_counters("ec_degraded")
            assert degraded.get("degraded_reads", 0) > 0, degraded
        finally:
            await rados.shutdown()
            await cluster.stop()

    loop = asyncio.new_event_loop()
    try:
        loop.run_until_complete(asyncio.wait_for(main(), 240))
    finally:
        loop.close()
