"""Mgr daemon: beacon/MgrMap publication, daemon report aggregation,
module host with commands, active balancer loop (src/mgr semantics).

The port's counterpart of ``tests/test_mgr.py``: its cases on
``ceph_tpu_torch``, the daemons and clients on ``device="cpu"``.
"""

import asyncio
import json

import pytest

from torch_app_cases import Mgr
from ceph_tpu_torch.msg import Message, Messenger

from torch_app_cases import make_cluster, teardown, run


async def wait_for(cond, timeout=30.0, msg="condition"):
    for _ in range(int(timeout / 0.2)):
        if cond():
            return
        await asyncio.sleep(0.2)
    raise TimeoutError(f"timed out waiting for {msg}")


async def mgr_command(client, addr, prefix, args=None):
    q = asyncio.Queue()

    async def d(conn, msg):
        if msg.type == "mgr_command_reply":
            await q.put(msg.data)

    client.add_dispatcher(d)
    try:
        await client.send(addr, "mgr.x",
                          Message("mgr_command",
                                  {"prefix": prefix, "args": args or {}}))
        data = await asyncio.wait_for(q.get(), 10)
    finally:
        client.dispatchers.remove(d)
    if not data["ok"]:
        raise RuntimeError(data["error"])
    return data["result"]


def test_mgr_aggregates_daemon_reports_and_serves_modules():
    async def main():
        mon, osds = await make_cluster(3, osd_config={
            "osd_heartbeat_interval": 0.2})
        mgr = Mgr(config={"beacon_interval": 0.5})
        addr = await mgr.start(mon.msgr.addr)
        client = Messenger("client.mgr")
        await client.bind()
        try:
            # OSDs learn the mgr from the mon and start reporting
            await wait_for(lambda: len(mgr.daemon_reports) >= 3,
                           msg="all osd reports aggregated")
            assert {f"osd.{o.whoami}" for o in osds} <= \
                set(mgr.daemon_reports)
            st = await mgr_command(client, addr, "status show")
            assert len(st["daemons"]) >= 3
            # pg_autoscaler recommendations
            from torch_app_cases import Rados
            rados = await Rados(mon.msgr.addr).connect()
            await rados.pool_create("rbd", pg_num=4)
            await asyncio.sleep(0.5)
            recs = await mgr_command(client, addr,
                                     "pg_autoscaler status")
            assert any(r["pool"] == "rbd" for r in recs)
            bal = await mgr_command(client, addr, "balancer status")
            assert bal["active"] is False
            await rados.shutdown()
        finally:
            await client.shutdown()
            await mgr.stop()
            await teardown(mon, osds)
    run(main())


def test_mgr_active_balancer_flattens_skew():
    async def main():
        mon, osds = await make_cluster(5)
        mgr = Mgr(config={"beacon_interval": 0.5,
                          "balancer_interval": 0.5,
                          "balancer_max_moves": 30})
        addr = await mgr.start(mon.msgr.addr)
        client = Messenger("client.bal")
        await client.bind()
        try:
            from torch_app_cases import Rados
            rados = await Rados(mon.msgr.addr).connect()
            await rados.pool_create("rbd", pg_num=64)
            # skew manually, then switch the balancer ON
            m = mon.osdmap
            pool_id = m.pool_names["rbd"]
            skewed = 0
            for ps in range(64):
                if skewed >= 6:
                    break
                up, _ = m.pg_to_up_acting(pool_id, ps)
                if 0 in up:
                    continue
                await rados.mon_command(
                    "osd pg-upmap-items",
                    {"pgid": m.pg_name(pool_id, ps),
                     "mappings": [[up[-1], 0]]})
                skewed += 1
            from ceph_tpu_torch.mgr.balancer import pg_distribution
            before = pg_distribution(mon.osdmap)
            assert before["max"] - before["min"] > 1
            await mgr_command(client, addr, "balancer on")

            def balanced():
                d = pg_distribution(mon.osdmap)
                return d["max"] - d["min"] <= 1
            await wait_for(balanced, timeout=30,
                           msg="active balancer flattened the skew")
            await rados.shutdown()
        finally:
            await client.shutdown()
            await mgr.stop()
            await teardown(mon, osds)
    run(main())


def test_mgrmap_replicated_and_failover():
    """MgrMonitor: the first mgr to beacon goes active in the
    REPLICATED MgrMap, a second stands by, and when the active's
    beacons lapse the standby promotes (mgr failover)."""
    from torch_app_cases import Mgr

    async def main():
        mon, osds = await make_cluster(1)
        a = Mgr(name="a", config={"beacon_interval": 0.3})
        b = Mgr(name="b", config={"beacon_interval": 0.3})
        try:
            await a.start(mon.msgr.addr)
            await b.start(mon.msgr.addr)
            for _ in range(50):
                m = mon.services.mgrmap
                if m.get("active") == "a" and \
                        [x["name"] for x in m["standbys"]] == ["b"]:
                    break
                await asyncio.sleep(0.1)
            m = mon.services.mgrmap
            assert m["active"] == "a"
            assert [x["name"] for x in m["standbys"]] == ["b"]
            dump = await mon.handle_command("mgr dump", {})
            assert dump["active"] == "a"
            # the active dies; the standby must promote within grace
            await a.stop()
            mon.MGR_BEACON_GRACE = 1.0
            for _ in range(100):
                if mon.services.mgrmap.get("active") == "b":
                    break
                await asyncio.sleep(0.1)
            assert mon.services.mgrmap["active"] == "b"
            await b.stop()
        finally:
            await teardown(mon, osds)
    run(main())


def test_config_key_store_and_telemetry():
    from torch_app_cases import Mgr

    async def main():
        mon, osds = await make_cluster(1)
        try:
            # KVMonitor: durable cluster key/value stash
            await mon.handle_command(
                "config-key set", {"key": "mirror/peer", "value": "x"})
            assert await mon.handle_command(
                "config-key get", {"key": "mirror/peer"}) == "x"
            assert await mon.handle_command("config-key ls", {}) == \
                ["mirror/peer"]
            await mon.handle_command("config-key rm",
                                     {"key": "mirror/peer"})
            assert await mon.handle_command("config-key ls", {}) == []

            # telemetry report aggregates non-identifying facts
            mgr = Mgr(name="t")
            await mgr.start(mon.msgr.addr)
            rep = await mgr.modules["telemetry"].handle_command(
                "show", {})
            assert rep["osd"]["count"] == 1
            assert "report_version" in rep
            await mgr.stop()
        finally:
            await teardown(mon, osds)
    run(main())


def test_dashboard_serves_cluster_state():
    from torch_app_cases import Mgr

    async def http_get(addr, path):
        reader, writer = await asyncio.open_connection(*addr)
        writer.write(f"GET {path} HTTP/1.1\r\nhost: x\r\n\r\n".encode())
        await writer.drain()
        status = int((await reader.readline()).split()[1])
        hdrs = {}
        while True:
            ln = await reader.readline()
            if ln in (b"\r\n", b"\n", b""):
                break
            k, _, v = ln.decode().partition(":")
            hdrs[k.strip().lower()] = v.strip()
        body = await reader.readexactly(
            int(hdrs.get("content-length", "0")))
        writer.close()
        return status, body

    async def main():
        mon, osds = await make_cluster(2)
        mgr = Mgr(name="d")
        try:
            await mgr.start(mon.msgr.addr)
            for _ in range(50):
                if mgr.modules["dashboard"].addr:
                    break
                await asyncio.sleep(0.1)
            addr = mgr.modules["dashboard"].addr
            st, body = await http_get(addr, "/api/summary")
            assert st == 200
            s = json.loads(body)
            assert s["osds"] == {"total": 2, "up": 2, "in": 2}
            st, body = await http_get(addr, "/api/osds")
            assert [o["id"] for o in json.loads(body)] == [0, 1]
            st, body = await http_get(addr, "/")
            assert st == 200 and b"<h1>cluster" in body
            st, _ = await http_get(addr, "/api/nope")
            assert st == 404
            await mgr.stop()
        finally:
            await teardown(mon, osds)
    run(main())
