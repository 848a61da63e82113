"""Prometheus mgr module, progress module, standalone exporter
(src/pybind/mgr/{prometheus,progress}, src/exporter).

The port's counterpart of ``tests/test_observability.py``: its cases on
``ceph_tpu_torch``, the daemons and clients on ``device="cpu"``.
"""

import asyncio
import urllib.request

import pytest

from torch_app_cases import Rados
from torch_app_cases import Mgr

from torch_app_cases import make_cluster, teardown, run


async def wait_for(cond, timeout=30.0, msg="condition"):
    for _ in range(int(timeout / 0.2)):
        if cond():
            return
        await asyncio.sleep(0.2)
    raise TimeoutError(f"timed out waiting for {msg}")


async def http_get(addr, path="/metrics") -> str:
    reader, writer = await asyncio.open_connection(*addr)
    writer.write(f"GET {path} HTTP/1.1\r\nhost: x\r\n\r\n".encode())
    await writer.drain()
    hdr = await reader.readuntil(b"\r\n\r\n")
    n = 0
    for line in hdr.decode().splitlines():
        if line.lower().startswith("content-length:"):
            n = int(line.split(":")[1])
    body = await reader.readexactly(n)
    writer.close()
    return body.decode()


def test_prometheus_module_and_progress():
    async def main():
        mon, osds = await make_cluster(3)
        mgr = Mgr(config={"balancer_active": False})
        await mgr.start(mon.msgr.addr)
        rados = await Rados(mon.msgr.addr).connect()
        try:
            prom = mgr.modules["prometheus"]
            await wait_for(lambda: prom.addr is not None,
                           msg="prometheus http up")
            # daemons report in; metrics appear
            await rados.pool_create("p", pg_num=8)
            io = await rados.open_ioctx("p")
            for i in range(10):
                await io.write_full(f"o{i}", b"x" * 2048)
            await wait_for(lambda: mgr.daemon_reports,
                           msg="daemon reports")
            text = await http_get(prom.addr)
            assert "# TYPE ceph_osd_up gauge" in text
            assert 'ceph_osd_up{ceph_daemon="osd.0"} 1' in text
            assert 'ceph_pool_pg_num{pool="p"} 8' in text
            assert "ceph_daemon_num_pgs" in text
            assert "ceph_osdmap_epoch" in text
            # 404 on other paths
            assert "try /metrics" in await http_get(prom.addr, "/nope")

            # progress: kill an osd, write (2-copy objects), revive ->
            # the revived osd is behind -> recovery work appears as an
            # event, then completes as it drains
            from torch_app_cases import OSD
            victim = osds[0]
            vid, vuuid, vstore = (victim.whoami, victim.uuid,
                                  victim.store)
            await victim.stop()
            await wait_for(lambda: not mon.osdmap.is_up(vid),
                           timeout=60, msg="mark down")
            text = await http_get(prom.addr)
            assert f'ceph_osd_up{{ceph_daemon="osd.{vid}"}} 0' in text
            for i in range(30):
                await io.write_full(f"deg{i}", b"y" * 1024)
            revived = OSD(uuid=vuuid, whoami=vid, store=vstore,
                          host="host0")
            await revived.start(mon.msgr.addr)
            osds[0] = revived
            await wait_for(lambda: mon.osdmap.is_up(vid),
                           timeout=60, msg="revive")
            # recovery completes and every object reads back
            for i in range(30):
                assert await io.read(f"deg{i}") == b"y" * 1024
        finally:
            await mgr.stop()
            await teardown(mon, osds, rados)
    run(main())


def test_progress_module_event_lifecycle():
    """Deterministic drive of the progress event machine via injected
    daemon reports (recovery can outrun the report cadence in the e2e
    path, so the lifecycle is pinned here)."""
    async def main():
        mon, osds = await make_cluster(1)
        mgr = Mgr()
        await mgr.start(mon.msgr.addr)
        try:
            prog = mgr.modules["progress"]
            mgr.daemon_reports["osd.0"] = {
                "stamp": __import__("time").monotonic(),
                "summary": {"missing_objects": 40}}
            prog._tick()
            assert len(prog.events) == 1
            ev = next(iter(prog.events.values()))
            assert not ev["done"] and ev["peak"] == 40
            mgr.daemon_reports["osd.0"]["summary"][
                "missing_objects"] = 10
            prog._tick()
            assert ev["progress"] == 0.75 and ev["remaining"] == 10
            mgr.daemon_reports["osd.0"]["summary"][
                "missing_objects"] = 0
            prog._tick()
            assert ev["done"] and ev["progress"] == 1.0
            # a NEW burst of work opens a new event
            mgr.daemon_reports["osd.0"]["summary"][
                "missing_objects"] = 5
            prog._tick()
            assert sum(1 for e in prog.events.values()
                       if not e["done"]) == 1
            out = await prog.handle_command("show", {})
            assert len(out) == 2
            # a dead daemon's stale report must not pin the event open
            mgr.daemon_reports["osd.0"]["stamp"] -= 60
            prog._tick()
            assert all(e["done"] for e in prog.events.values())
        finally:
            await mgr.stop()
            await teardown(mon, osds)
    run(main())


def test_standalone_exporter(tmp_path):
    async def main():
        import os
        mon, osds = await make_cluster(1)
        from torch_app_cases import OSD
        # one osd with an admin socket for the exporter to scrape
        osd = OSD(host="hostx",
                  admin_socket_path=os.path.join(tmp_path, "osd.9.asok"))
        await osd.start(mon.msgr.addr)
        osd.perf_osd.inc("op", 42)       # counters the scrape flattens
        rados = await Rados(mon.msgr.addr).connect()
        try:
            from ceph_tpu_torch.tools.exporter import Exporter
            from ceph_tpu_torch.mgr.prometheus import MetricsHttpServer
            exp = Exporter(str(tmp_path))
            srv = MetricsHttpServer(exp.render)
            addr = await srv.start()
            text = await http_get(addr)
            assert 'ceph_daemon_up{ceph_daemon="osd.9"} 1' in text
            assert "ceph_osd_" in text        # perf counters flattened
            await srv.stop()
        finally:
            await osd.stop()
            await teardown(mon, osds, rados)
    run(main())
