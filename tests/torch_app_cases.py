"""Helpers for the port's client-application tests: the reference tests'
cluster helpers (``tests/test_client.py``) on the port's daemons.

The port's daemons and librados resolve CUDA unless the caller names the
CPU, so ``Monitor``, ``OSD`` and ``Rados`` here are the port's classes
with ``device="cpu"`` bound; the tests use them where the reference's
tests use the plain classes.
"""

from __future__ import annotations

import asyncio
import functools

from ceph_tpu_torch.client.rados import Rados as _Rados
from ceph_tpu_torch.mon import Monitor as _Monitor
from ceph_tpu_torch.osd import OSD as _OSD

Monitor = functools.partial(_Monitor, device="cpu")
OSD = functools.partial(_OSD, device="cpu")
Rados = functools.partial(_Rados, device="cpu")


TIMEOUT = 120                   # seconds a test's scenario may take


def run(coro, timeout: float = TIMEOUT):
    """The scenario on a fresh loop, cut after ``timeout`` seconds."""
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(asyncio.wait_for(coro, timeout))
    finally:
        loop.close()


async def make_cluster(n_osds=3, mon_config=None, osd_config=None):
    mon = Monitor(rank=0, config={"mon_osd_min_down_reporters": 1,
                                  "mon_osd_down_out_interval": 3600.0,
                                  **(mon_config or {})})
    addr = await mon.start()
    mon.peer_addrs = [addr]
    osds = []
    for i in range(n_osds):
        osd = OSD(host=f"host{i}", config=osd_config)
        await osd.start(addr)
        osds.append(osd)
    return mon, osds


async def teardown(mon, osds, rados=None):
    if rados is not None:
        await rados.shutdown()
    for o in osds:
        await o.stop()
    await mon.stop()
