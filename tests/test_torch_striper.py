"""Client-side striping (Striper.cc / libradosstriper semantics):
layout math, parallel fan-out, boundary-crossing I/O.

The port's counterpart of ``tests/test_striper.py``: its cases on
``ceph_tpu_torch``, the daemons and librados on ``device="cpu"``.
"""

import asyncio

import numpy as np
import pytest

from torch_app_cases import Rados
from ceph_tpu_torch.client.striper import Layout, RadosStriper, map_extents

from torch_app_cases import make_cluster, run, teardown


def test_map_extents_round_robin():
    lo = Layout(stripe_unit=4, stripe_count=3, object_size=8)
    # 2 units per object column; stripe i -> object (i//3//2*3 + i%3)
    ext = map_extents(lo, 0, 36)
    # units 0..8: objs 0,1,2 get units (0,3),(1,4),(2,5) at offs 0,4
    assert ext == [(0, 0, 4), (1, 0, 4), (2, 0, 4),
                   (0, 4, 4), (1, 4, 4), (2, 4, 4),
                   (3, 0, 4), (4, 0, 4), (5, 0, 4)]
    # unaligned range crossing a unit boundary merges per object
    ext = map_extents(lo, 2, 4)
    assert ext == [(0, 2, 2), (1, 0, 2)]


def test_map_extents_single_object_layout():
    lo = Layout(stripe_unit=8, stripe_count=1, object_size=16)
    assert map_extents(lo, 0, 40) == [(0, 0, 16), (1, 0, 16), (2, 0, 8)]


@pytest.mark.parametrize("layout", [
    Layout(stripe_unit=512, stripe_count=1, object_size=2048),
    Layout(stripe_unit=512, stripe_count=4, object_size=1024),
    Layout(stripe_unit=256, stripe_count=3, object_size=1024),
])
def test_map_extents_cover_exactly(layout):
    rng = np.random.default_rng(0)
    for _ in range(40):
        off = int(rng.integers(0, 9000))
        ln = int(rng.integers(1, 5000))
        ext = map_extents(layout, off, ln)
        assert sum(e[2] for e in ext) == ln
        for _, obj_off, n in ext:
            assert obj_off + n <= layout.object_size


def test_striper_io_end_to_end():
    async def main():
        mon, osds = await make_cluster(3)
        rados = await Rados(mon.msgr.addr).connect()
        try:
            await rados.pool_create("rbd", pg_num=8)
            io = await rados.open_ioctx("rbd")
            st = RadosStriper(io, Layout(stripe_unit=1024,
                                         stripe_count=4,
                                         object_size=4096))
            rng = np.random.default_rng(1)
            shadow = bytearray()
            # big initial write: fans out across 4+ backing objects
            blob = rng.integers(0, 256, 40000, dtype=np.uint8).tobytes()
            await st.write("img", blob)
            shadow[:] = blob
            assert await st.size("img") == len(shadow)
            got = await st.read("img")
            assert got == bytes(shadow)
            # unaligned overwrites crossing stripe/object boundaries
            for _ in range(12):
                off = int(rng.integers(0, 45000))
                data = rng.integers(0, 256, int(rng.integers(1, 7000)),
                                    dtype=np.uint8).tobytes()
                await st.write("img", data, off)
                end = off + len(data)
                if len(shadow) < end:
                    shadow.extend(b"\0" * (end - len(shadow)))
                shadow[off:end] = data
            got = await st.read("img")
            assert got == bytes(shadow)
            # ranged reads
            for _ in range(10):
                off = int(rng.integers(0, len(shadow)))
                ln = int(rng.integers(1, 9000))
                got = await st.read("img", length=ln, off=off)
                assert got == bytes(shadow[off:off + ln])
            # really striped: multiple backing objects exist
            oids = set()
            for o in osds:
                for pg in o.pgs.values():
                    oids.update(x for x in o.store.list_objects(pg.coll)
                                if x.startswith("img."))
            assert len(oids) >= 8, oids
            # truncate + remove
            await st.truncate("img", 5000)
            assert await st.read("img") == bytes(shadow[:5000])
            await st.remove("img")
            assert await st.size("img") == 0
            assert await st.read("img") == b""
        finally:
            await teardown(mon, osds, rados)
    run(main())
