"""Manager daemon: module host + daemon metrics aggregation.

The src/mgr stack in miniature: the mgr beacons to the monitor (which
publishes the active mgr's address to its subscribers, the MgrMap
analog), receives periodic perf-counter reports from daemons
(DaemonServer / MgrClient report protocol), and hosts python modules
with a serve-loop + command surface (the ActivePyModules / MgrModule
shape).  Built-in modules:

  * balancer     -- periodic upmap optimization (mgr balancer upmap
                    mode); active when `balancer_active` config is on
  * pg_autoscaler-- recommends pg_num per pool from utilization
                    heuristics (report-only: pg splitting/merging is
                    not implemented)
  * status       -- cluster + daemon-report summary

Modules answer `mgr_command` messages ({"prefix": "<module> <cmd>"}),
the `ceph tell mgr` analog.

Port of ``ceph_tpu/mgr/mgr.py``.  ``Mgr(..., device=...)`` (CUDA unless
the caller names the CPU) hands its device to its OSDMap, so the
balancer's distribution and the progress module read the epoch
placement table built on the card.
"""

from __future__ import annotations

import asyncio
import json
import time

from ..common import make_task_tracker
from ..device import resolve_device
from ..msg import Message, Messenger
from ..mon.osdmap import OSDMap, Incremental


class MgrModule:
    """Module SPI (mgr_module.py analog): override serve/handle."""

    name = "module"

    def __init__(self, mgr: "Mgr") -> None:
        self.mgr = mgr

    async def serve(self) -> None:
        """Background loop; cancelled at shutdown."""

    async def handle_command(self, cmd: str, args: dict):
        raise ValueError(f"unknown command {cmd!r}")


class BalancerModule(MgrModule):
    name = "balancer"

    async def serve(self) -> None:
        while True:
            await asyncio.sleep(self.mgr.config["balancer_interval"])
            if not self.mgr.config["balancer_active"]:
                continue
            try:
                res = await self.mgr.mon_command(
                    "osd balancer run",
                    {"max": self.mgr.config["balancer_max_moves"]})
                if res.get("moved"):
                    self.mgr.log.append(
                        f"balancer: moved {res['moved']} pgs "
                        f"(stddev {res['before']['stddev']} -> "
                        f"{res['after']['stddev']})")
            except Exception as e:
                self.mgr.log.append(f"balancer: {e}")

    async def handle_command(self, cmd: str, args: dict):
        if cmd == "status":
            from .balancer import pg_distribution
            return {"active": self.mgr.config["balancer_active"],
                    "distribution": pg_distribution(self.mgr.osdmap)}
        if cmd == "on":
            self.mgr.config["balancer_active"] = True
            return "active"
        if cmd == "off":
            self.mgr.config["balancer_active"] = False
            return "inactive"
        if cmd == "execute":
            return await self.mgr.mon_command(
                "osd balancer run",
                {"max": args.get("max",
                                 self.mgr.config["balancer_max_moves"])})
        raise ValueError(f"unknown balancer command {cmd!r}")


class PgAutoscalerModule(MgrModule):
    name = "pg_autoscaler"

    async def handle_command(self, cmd: str, args: dict):
        if cmd != "status":
            raise ValueError(f"unknown pg_autoscaler command {cmd!r}")
        # the reference targets ~100 PGs/OSD scaled by pool bias;
        # recommendation only (pg splitting is future work)
        n_osd = sum(1 for i in self.mgr.osdmap.osds.values()
                    if i.up and i.in_cluster)
        out = []
        for pool in self.mgr.osdmap.pools.values():
            target = max(1, (100 * max(n_osd, 1)) // max(
                1, len(self.mgr.osdmap.pools)) // max(1, pool.size))
            # round to the next power of two, the pg_num discipline
            rec = 1 << max(0, (target - 1).bit_length())
            out.append({"pool": pool.name, "pg_num": pool.pg_num,
                        "recommended": rec,
                        "would_adjust": rec != pool.pg_num})
        return out


class PrometheusModule(MgrModule):
    """GET /metrics exposition (src/pybind/mgr/prometheus analog):
    cluster state from the osdmap + per-daemon perf counters from the
    DaemonServer reports."""

    name = "prometheus"

    def __init__(self, mgr: "Mgr") -> None:
        super().__init__(mgr)
        self.server = None
        self.addr: tuple[str, int] | None = None

    async def serve(self) -> None:
        from .prometheus import MetricsHttpServer
        self.server = MetricsHttpServer(self.render)
        self.addr = await self.server.start(
            port=self.mgr.config.get("prometheus_port", 0))
        try:
            await asyncio.Event().wait()      # serve until cancelled
        except asyncio.CancelledError:
            await self.server.stop()
            raise

    async def render(self) -> str:
        from .prometheus import (
            families_from_perf, merge_families, render_metrics,
        )
        m = self.mgr
        osd_up = {"help": "OSD up state", "type": "gauge",
                  "samples": [({"ceph_daemon": f"osd.{o}"},
                               1 if i.up else 0)
                              for o, i in m.osdmap.osds.items()]}
        osd_in = {"help": "OSD in state", "type": "gauge",
                  "samples": [({"ceph_daemon": f"osd.{o}"},
                               1 if i.in_cluster else 0)
                              for o, i in m.osdmap.osds.items()]}
        pools = {"help": "pool pg_num", "type": "gauge",
                 "samples": [({"pool": p.name}, p.pg_num)
                             for p in m.osdmap.pools.values()]}
        epoch = {"help": "osdmap epoch", "type": "counter",
                 "samples": [({}, m.osdmap.epoch)]}
        perf = [families_from_perf(name, rep.get("summary", {}),
                                   prefix="ceph_daemon")
                for name, rep in m.daemon_reports.items()]
        pg_states = {"help": "PG count by state per daemon",
                     "type": "gauge", "samples": []}
        for name, rep in m.daemon_reports.items():
            for state, n in rep.get("summary", {}).get(
                    "pg_states", {}).items():
                pg_states["samples"].append(
                    ({"ceph_daemon": name, "state": state}, n))
        return render_metrics(merge_families(
            {"ceph_osd_up": osd_up, "ceph_osd_in": osd_in,
             "ceph_pool_pg_num": pools, "ceph_osdmap_epoch": epoch,
             "ceph_pg_states": pg_states},
            *perf))

    async def handle_command(self, cmd: str, args: dict):
        if cmd == "status":
            return {"addr": list(self.addr) if self.addr else None}
        raise ValueError(f"unknown prometheus command {cmd!r}")


class ProgressModule(MgrModule):
    """Recovery/backfill progress events (src/pybind/mgr/progress):
    watches the missing-object counts daemons report; an event opens
    when recovery work appears, tracks the high-water mark, and
    completes when the count drains to zero."""

    name = "progress"

    def __init__(self, mgr: "Mgr") -> None:
        super().__init__(mgr)
        self.events: dict[str, dict] = {}
        self._serial = 0

    STALE_REPORT_S = 30.0

    def _total_missing(self) -> int:
        # a daemon that died mid-recovery leaves its last report behind
        # forever (nothing prunes daemon_reports); counting it would pin
        # an event open and block all future ones
        now = time.monotonic()
        return sum(rep.get("summary", {}).get("missing_objects", 0)
                   for rep in self.mgr.daemon_reports.values()
                   if now - rep.get("stamp", 0) < self.STALE_REPORT_S)

    async def serve(self) -> None:
        while True:
            await asyncio.sleep(1.0)
            try:
                self._tick()
            except Exception as e:
                self.mgr.log.append(f"progress: {type(e).__name__}: {e}")

    def _tick(self) -> None:
        missing = self._total_missing()
        open_ev = next((e for e in self.events.values()
                        if not e["done"]), None)
        if missing > 0 and open_ev is None:
            self._serial += 1
            self.events[f"ev{self._serial}"] = {
                "message": "Recovering degraded objects",
                "started": time.monotonic(), "peak": missing,
                "remaining": missing, "progress": 0.0, "done": False}
        elif open_ev is not None:
            open_ev["peak"] = max(open_ev["peak"], missing)
            open_ev["remaining"] = missing
            open_ev["progress"] = round(
                1.0 - missing / max(open_ev["peak"], 1), 3)
            if missing == 0:
                open_ev["done"] = True
                open_ev["progress"] = 1.0
                open_ev["finished"] = time.monotonic()
        # completed events linger for 5 minutes AFTER completion (aging
        # by start time would delete a long recovery's event instantly)
        now = time.monotonic()
        for key in [k for k, e in self.events.items()
                    if e["done"] and now - e.get("finished", now) > 300]:
            del self.events[key]

    async def handle_command(self, cmd: str, args: dict):
        if cmd == "show":
            return {k: {kk: vv for kk, vv in e.items()
                        if kk not in ("started", "finished")}
                    for k, e in self.events.items()}
        if cmd == "clear":
            self.events.clear()
            return ""
        raise ValueError(f"unknown progress command {cmd!r}")


class StatusModule(MgrModule):
    name = "status"

    async def handle_command(self, cmd: str, args: dict):
        if cmd != "show":
            raise ValueError(f"unknown status command {cmd!r}")
        now = time.monotonic()
        return {
            "epoch": self.mgr.osdmap.epoch,
            "daemons": {name: {"age": round(now - rep["stamp"], 1),
                               "counters": rep.get("summary", {})}
                        for name, rep in self.mgr.daemon_reports.items()},
            "log_tail": self.mgr.log[-10:],
        }


class DashboardModule(MgrModule):
    """Read-only web dashboard (src/pybind/mgr/dashboard, compressed
    to the observability core): an HTTP endpoint on the active mgr
    serving cluster health, OSD/pool/daemon state as JSON plus a
    minimal HTML overview -- riding the same hardened HTTP loop as
    the prometheus exporter."""

    name = "dashboard"

    def __init__(self, mgr: "Mgr") -> None:
        super().__init__(mgr)
        self._server = None
        self.addr: tuple[str, int] | None = None

    async def serve(self) -> None:
        if not self.mgr.config.get("dashboard_enabled", True):
            return
        from .prometheus import MetricsHttpServer
        self._server = MetricsHttpServer(self._route, router=True)
        try:
            self.addr = await self._server.start(
                port=int(self.mgr.config.get("dashboard_port", 0)))
        except OSError as e:
            # an operator must see WHY the dashboard is absent
            self.mgr.log.append(f"dashboard: bind failed: {e}")
            return
        try:
            await asyncio.Event().wait()       # serve until cancelled
        except asyncio.CancelledError:
            await self._server.stop()

    def _payload(self, path: str):
        m = self.mgr.osdmap
        if path == "/api/osds":
            return [{"id": o, "up": i.up, "in": i.in_cluster,
                     "host": i.host,
                     "weight": i.weight / 0x10000}
                    for o, i in sorted(m.osds.items())]
        if path == "/api/pools":
            return [{"id": pid, "name": p.name, "type": p.type,
                     "size": p.size, "pg_num": p.pg_num}
                    for pid, p in sorted(m.pools.items())]
        if path == "/api/daemons":
            return self.mgr.daemon_reports
        if path in ("/", "/api/summary"):
            osds = list(m.osds.values())
            return {"epoch": m.epoch,
                    "osds": {"total": len(osds),
                             "up": sum(1 for o in osds if o.up),
                             "in": sum(1 for o in osds
                                       if o.in_cluster)},
                    "pools": len(m.pools),
                    "daemons": sorted(self.mgr.daemon_reports)}
        return None

    async def _route(self, path: str):
        payload = self._payload(path)
        if payload is None:
            return "404 Not Found", "text/plain", b"not found"
        if path == "/":
            s = payload
            body = (
                "<html><head><title>ceph_tpu</title></head><body>"
                f"<h1>cluster @ epoch {s['epoch']}</h1>"
                f"<p>OSDs: {s['osds']['up']}/{s['osds']['total']}"
                f" up, {s['osds']['in']} in</p>"
                f"<p>pools: {s['pools']}</p>"
                f"<p>daemons: {', '.join(s['daemons']) or '-'}"
                "</p><p>JSON: <a href='/api/summary'>summary</a> "
                "<a href='/api/osds'>osds</a> "
                "<a href='/api/pools'>pools</a> "
                "<a href='/api/daemons'>daemons</a></p>"
                "</body></html>").encode()
            return "200 OK", "text/html", body
        return ("200 OK", "application/json",
                json.dumps(payload).encode())

    async def handle_command(self, cmd: str, args: dict):
        if cmd == "status":
            return {"addr": list(self.addr) if self.addr else None}
        raise ValueError(f"unknown dashboard command {cmd!r}")


class TelemetryModule(MgrModule):
    """Anonymized cluster report (src/pybind/mgr/telemetry): opt-in,
    aggregates non-identifying facts -- daemon counts, pool shapes,
    usage -- into the report a phone-home channel would send (no
    egress in this environment; the report is inspectable instead)."""

    name = "telemetry"

    def __init__(self, mgr: "Mgr") -> None:
        super().__init__(mgr)
        self.enabled = bool(mgr.config.get("telemetry_on", False))

    def report(self) -> dict:
        m = self.mgr.osdmap
        osds = list(m.osds.values())
        return {
            "report_version": 1,
            "osd": {"count": len(osds),
                    "up": sum(1 for o in osds if o.up),
                    "in": sum(1 for o in osds if o.in_cluster)},
            "pools": [{"type": p.type, "size": p.size,
                       "pg_num": p.pg_num,
                       "erasure_code_profile":
                           bool(p.erasure_code_profile)}
                      for p in m.pools.values()],
            "daemons": sorted(self.mgr.daemon_reports),
            "crush": {"buckets": len(m.crush.buckets),
                      "rules": len(m.crush.rules)},
        }

    async def handle_command(self, cmd: str, args: dict):
        if cmd == "status":
            return {"enabled": self.enabled}
        if cmd == "on":
            self.enabled = True
            return ""
        if cmd == "off":
            self.enabled = False
            return ""
        if cmd == "show":
            return self.report()
        raise ValueError(f"unknown telemetry command {cmd!r}")


class Mgr:
    def __init__(self, name: str = "x",
                 config: dict | None = None,
                 secret: bytes | None = None,
                 msgr_opts: dict | None = None, device=None) -> None:
        self.name = name
        self.device = resolve_device(device)
        self.msgr = Messenger(f"mgr.{name}", secret=secret,
                              **(msgr_opts or {}))
        self.osdmap = OSDMap(device=self.device)
        self.mon_addr: tuple[str, int] | None = None
        self.config = {
            "balancer_active": False,
            "balancer_interval": 5.0,
            "balancer_max_moves": 10,
            "beacon_interval": 2.0,
            **(config or {}),
        }
        # daemon name -> last report (DaemonStateIndex analog)
        self.daemon_reports: dict[str, dict] = {}
        self.log: list[str] = []
        self.modules: dict[str, MgrModule] = {}
        for cls in (BalancerModule, PgAutoscalerModule, StatusModule,
                    PrometheusModule, ProgressModule,
                    TelemetryModule, DashboardModule):
            mod = cls(self)
            self.modules[mod.name] = mod
        self._tasks: list[asyncio.Task] = []
        self._track = make_task_tracker(self._tasks)
        self._cmd_waiters: dict[int, asyncio.Future] = {}
        self._tid = 0
        self.msgr.add_dispatcher(self._dispatch)

    async def start(self, mon_addr: tuple[str, int],
                    host: str = "127.0.0.1", port: int = 0):
        self.mon_addr = tuple(mon_addr)
        addr = await self.msgr.bind(host, port)
        await self._beacon()
        await self._refresh_map()
        self._tasks += [asyncio.ensure_future(self._beacon_loop())]
        self._tasks += [asyncio.ensure_future(m.serve())
                        for m in self.modules.values()]
        return addr

    async def stop(self) -> None:
        pending = list(self._tasks)
        for t in pending:
            t.cancel()
        # let cancellations land before the messenger goes away, or a
        # module mid-send races the teardown
        await asyncio.gather(*pending, return_exceptions=True)
        await self.msgr.shutdown()

    # -- mon session --------------------------------------------------------
    async def _beacon(self) -> None:
        try:
            await self.msgr.send(self.mon_addr, "mon.0", Message(
                "mgr_beacon", {"name": self.name,
                               "addr": list(self.msgr.addr)}))
        except (ConnectionError, OSError):
            pass

    async def _beacon_loop(self) -> None:
        try:
            while True:
                await asyncio.sleep(self.config["beacon_interval"])
                await self._beacon()
        except asyncio.CancelledError:
            pass

    async def _refresh_map(self) -> None:
        q: asyncio.Queue = asyncio.Queue()

        async def d(conn, msg):
            if msg.type == "osdmap_full":
                await q.put(msg.data["map"])

        self.msgr.add_dispatcher(d)
        try:
            await self.msgr.send(self.mon_addr, "mon.0",
                                 Message("sub_osdmap", {}))
            self.osdmap = OSDMap.from_dict(
                await asyncio.wait_for(q.get(), 10), device=self.device)
        finally:
            self.msgr.dispatchers.remove(d)

    async def mon_command(self, cmd: str, args: dict | None = None):
        self._tid += 1
        tid = self._tid
        fut = asyncio.get_event_loop().create_future()
        self._cmd_waiters[tid] = fut
        try:
            await self.msgr.send(self.mon_addr, "mon.0", Message(
                "mon_command", {"cmd": cmd, "args": args or {},
                                "tid": tid}))
            data = await asyncio.wait_for(fut, 15)
        finally:
            self._cmd_waiters.pop(tid, None)
        if not data.get("ok"):
            raise RuntimeError(data.get("error"))
        return data["result"]

    # -- dispatch -----------------------------------------------------------
    async def _dispatch(self, conn, msg: Message) -> None:
        if msg.type == "osdmap_inc":
            inc = Incremental.from_dict(msg.data["inc"])
            if inc.epoch == self.osdmap.epoch + 1:
                self.osdmap.apply_incremental(inc)
            elif inc.epoch > self.osdmap.epoch:
                self._track(asyncio.ensure_future(self._refresh_map()))
        elif msg.type == "mon_command_reply":
            fut = self._cmd_waiters.get(msg.data.get("tid"))
            if fut is not None and not fut.done():
                fut.set_result(msg.data)
        elif msg.type == "mgr_report":
            # DaemonServer: daemons push perf summaries
            self.daemon_reports[msg.data["daemon"]] = {
                "stamp": time.monotonic(),
                "summary": msg.data.get("summary", {}),
            }
            await conn.send(Message("mgr_report_ack", {}))
        elif msg.type == "mgr_command":
            await self._handle_mgr_command(conn, msg)

    async def _handle_mgr_command(self, conn, msg: Message) -> None:
        prefix = msg.data.get("prefix", "")
        args = msg.data.get("args", {})
        parts = prefix.split(None, 1)
        try:
            mod = self.modules.get(parts[0]) if parts else None
            if mod is None:
                raise ValueError(f"no mgr module {parts[:1]}")
            result = await mod.handle_command(
                parts[1] if len(parts) > 1 else "", args)
            await conn.send(Message("mgr_command_reply",
                                    {"ok": True, "result": result,
                                     "tid": msg.data.get("tid")}))
        except Exception as e:
            await conn.send(Message("mgr_command_reply",
                                    {"ok": False, "error": str(e),
                                     "tid": msg.data.get("tid")}))
