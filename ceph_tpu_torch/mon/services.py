"""PaxosService breadth: auth, centralized config, cluster log, health.

The reference multiplexes every map service over ONE paxos instance
(PaxosService.cc propose batching); here the extra services ride the
osdmap Incremental's ``service_kv`` payload, so their state commits
and replays with the same quorum guarantees as the map itself:

  * AuthMonitor  (src/mon/AuthMonitor.cc): entity -> {key, caps}
    provisioning (auth get-or-create / get / ls / rm).
  * ConfigMonitor (src/mon/ConfigMonitor.cc): the central config DB
    (ceph config set/get/rm/dump), pushed to daemons on commit and at
    boot so runtime options flow through each daemon's ConfigProxy
    observers.
  * LogMonitor   (src/mon/LogMonitor.cc): the structured cluster log
    (ceph log / log last), fed by daemon clog messages and by the
    mon's own events (osd down, pool create...).
  * HealthMonitor (src/mon/health_check.h): derived health checks
    (OSD_DOWN, MON_DOWN, POOL_TOO_FEW_OSDS, MGR_DOWN) aggregated into
    HEALTH_OK/WARN/ERR for ``ceph health`` / ``ceph -s``.
"""

from __future__ import annotations

import json
import logging
import os
import time

LOG_CAP = 1000


def _surface_task_death(task) -> None:
    """Done-callback for fire-and-forget publish tasks: a task whose
    exception is never retrieved dies silently (and may be GC'd
    mid-flight) -- retrieve it and log instead."""
    if task.cancelled():
        return
    exc = task.exception()
    if exc is not None:
        logging.getLogger("ceph_tpu_torch.mon").warning(
            "mgr_map publish task died: %r", exc)


class UnknownCommand(Exception):
    """Not a service command -- the caller's table handles it.  A
    dedicated type: KeyError would also catch missing ARGUMENTS inside
    handlers and misreport them as unknown commands."""


class MonServices:
    def __init__(self, mon) -> None:
        self.mon = mon
        self.config_db: dict[str, str] = {}       # "who/name" -> value
        self.auth_db: dict[str, dict] = {}        # entity -> {key, caps}
        self.cluster_log: list[dict] = []         # ring of log entries
        self.log_seq = 0
        # FSMap (MDSMonitor): mon-owned MDS membership -- which daemon
        # is the active metadata server, who stands by, epoch per
        # change (src/mon/MDSMonitor.cc / FSMap).  Replicated through
        # paxos like every service; beacon liveness is in-memory on
        # the leader (mds_last_beacon on the Monitor).
        self.fsmap: dict = {"epoch": 0, "active": None, "standbys": []}
        # MgrMap (MgrMonitor): which mgr is active, who stands by --
        # replicated so a peon answers mgr_map and failover survives
        # mon leadership changes (src/mon/MgrMonitor.cc)
        self.mgrmap: dict = {"epoch": 0, "active": None,
                             "active_addr": None, "standbys": []}
        # KVMonitor (config-key store, src/mon/KVMonitor.cc): the
        # cluster-wide durable key/value stash ("ceph config-key ...")
        self.kv_db: dict[str, str] = {}
        # replicated cephx rotating service keys: service -> dict
        self.cephx_keys: dict[str, dict] = {}

    # -- replication hook ----------------------------------------------------
    def apply(self, service_kv: dict) -> None:
        """Apply a committed incremental's service payloads (also runs
        at replay, so state rebuilds from the paxos log)."""
        for key, val in service_kv.get("config", {}).items():
            if val is None:
                self.config_db.pop(key, None)
            else:
                self.config_db[key] = val
        for entity, val in service_kv.get("auth", {}).items():
            if val is None:
                self.auth_db.pop(entity, None)
            else:
                self.auth_db[entity] = json.loads(val) \
                    if isinstance(val, str) else val
        for svc, val in service_kv.get("cephx", {}).items():
            self.cephx_keys[svc] = (json.loads(val)
                                    if isinstance(val, str) else val)
            # a live authority must see replicated rotations too
            mon = self.mon
            if getattr(mon, "_cephx", None) is not None:
                from ..common.cephx import RotatingKeys
                mon._cephx.rotating[svc] = RotatingKeys.from_dict(
                    self.cephx_keys[svc], mon._cephx.ttl)
        fsval = service_kv.get("fsmap", {}).get("map")
        if fsval is not None:
            self.fsmap = (json.loads(fsval)
                          if isinstance(fsval, str) else fsval)
        mgrval = service_kv.get("mgrmap", {}).get("map")
        if mgrval is not None:
            self.mgrmap = (json.loads(mgrval)
                           if isinstance(mgrval, str) else mgrval)
            # EVERY mon pushes the new mgr_map to its own subscribers
            # (daemons may be sessioned to a peon)
            import asyncio as _asyncio
            try:
                t = _asyncio.ensure_future(self.mon._publish_mgr_map())
                t.add_done_callback(_surface_task_death)
            except RuntimeError:
                pass          # replay outside a loop (mon boot)
        for key, val in service_kv.get("kvstore", {}).items():
            if val is None:
                self.kv_db.pop(key, None)
            else:
                self.kv_db[key] = val
        for _, val in sorted(service_kv.get("log", {}).items()):
            entry = json.loads(val) if isinstance(val, str) else val
            self.cluster_log.append(entry)
            self.log_seq = max(self.log_seq, entry.get("seq", 0))
        del self.cluster_log[:-LOG_CAP]

    # -- LogMonitor ----------------------------------------------------------
    def log_entry(self, level: str, message: str,
                  who: str = "") -> dict:
        """Build a cluster-log service payload (caller folds it into an
        incremental; the mon's own events share the map's commit)."""
        self.log_seq += 1
        return {str(self.log_seq): {
            "seq": self.log_seq, "stamp": time.time(),
            "level": level, "who": who or f"mon.{self.mon.rank}",
            "message": message}}

    # -- ConfigMonitor -------------------------------------------------------
    def config_for(self, who: str) -> dict[str, str]:
        """Effective config for a daemon: global < type < id sections
        (ConfigMonitor's option masking)."""
        out: dict[str, str] = {}
        dtype = who.split(".")[0]
        for section in ("global", dtype, who):
            for key, val in self.config_db.items():
                sec, _, name = key.partition("/")
                if sec == section:
                    out[name] = val
        return out

    # -- AuthMonitor ---------------------------------------------------------
    def auth_get_or_create(self, entity: str,
                           caps: dict | None = None) -> dict:
        if entity not in self.auth_db:
            return {"entity": entity,
                    "key": os.urandom(16).hex(),
                    "caps": caps or {}}
        cur = dict(self.auth_db[entity])
        if caps:
            cur = {**cur, "caps": caps}
        return {"entity": entity, **cur}

    # -- HealthMonitor -------------------------------------------------------
    def health(self) -> dict:
        mon = self.mon
        checks: dict[str, dict] = {}
        down = [o for o, info in mon.osdmap.osds.items()
                if not info.up and info.in_cluster]
        if down:
            checks["OSD_DOWN"] = {
                "severity": "HEALTH_WARN",
                "summary": f"{len(down)} osds down",
                "detail": [f"osd.{o} is down" for o in sorted(down)]}
        n_mons = len([a for a in mon.peer_addrs if a is not None])
        if n_mons and len(mon.quorum) < n_mons:
            missing = sorted(set(range(n_mons)) - mon.quorum)
            checks["MON_DOWN"] = {
                "severity": "HEALTH_WARN",
                "summary": f"{len(missing)}/{n_mons} mons out of quorum",
                "detail": [f"mon.{r} not in quorum" for r in missing]}
        n_up = sum(1 for o in mon.osdmap.osds.values() if o.up)
        narrow = [p for p in mon.osdmap.pools.values()
                  if p.size > max(n_up, 0)]
        if narrow:
            checks["POOL_TOO_FEW_OSDS"] = {
                "severity": "HEALTH_ERR",
                "summary": f"{len(narrow)} pool(s) wider than the "
                           f"up OSD count",
                "detail": [f"pool {p.name} size {p.size} > "
                           f"{n_up} up osds" for p in narrow]}
        slow = {o: r for o, r in getattr(mon, "slow_ops_reports",
                                         {}).items()
                if r["count"] > 0
                and time.monotonic() - r["stamp"] < 60.0}
        if slow:
            total = sum(r["count"] for r in slow.values())
            oldest = max(r["oldest_age"] for r in slow.values())
            names = ",".join(f"osd.{o}" for o in sorted(slow))
            checks["SLOW_OPS"] = {
                "severity": "HEALTH_WARN",
                "summary": f"{total} slow ops, oldest one blocked for "
                           f"{oldest:.0f} sec, daemons [{names}] "
                           f"have slow ops.",
                "detail": [f"osd.{o}: {r['count']} ops, oldest "
                           f"{r['oldest_age']:.0f}s"
                           for o, r in sorted(slow.items())]}
        act = self.mgrmap.get("active")
        beats = getattr(mon, "mgr_last_beacon", None) or {}
        beat = beats.get(act) if act else None
        if act and beat is not None \
                and time.monotonic() - beat > 30.0:
            checks["MGR_DOWN"] = {
                "severity": "HEALTH_WARN",
                "summary": f"no beacon from active mgr {act} for 30s",
                "detail": []}
        status = "HEALTH_OK"
        for c in checks.values():
            if c["severity"] == "HEALTH_ERR":
                status = "HEALTH_ERR"
                break
            status = "HEALTH_WARN"
        return {"status": status, "checks": checks}

    # -- command surface -----------------------------------------------------
    async def handle_command(self, cmd: str, args: dict):
        """Returns the result, or raises UnknownCommand to fall through."""
        mon = self.mon
        if cmd == "fs dump":
            return dict(self.fsmap)
        if cmd == "config set":
            who = args.get("who", "global")
            await mon.propose_service_kv("config", {
                f"{who}/{args['name']}": str(args["value"])})
            return f"{who}/{args['name']} = {args['value']}"
        if cmd == "config rm":
            who = args.get("who", "global")
            await mon.propose_service_kv("config",
                                         {f"{who}/{args['name']}": None})
            return ""
        if cmd == "config get":
            return self.config_for(args.get("who", "global"))
        if cmd == "config dump":
            return dict(sorted(self.config_db.items()))
        if cmd == "config-key set":
            await mon.propose_service_kv(
                "kvstore", {args["key"]: str(args["value"])})
            return ""
        if cmd == "config-key get":
            if args["key"] not in self.kv_db:
                raise ValueError(f"no such key {args['key']}")
            return self.kv_db[args["key"]]
        if cmd == "config-key rm":
            await mon.propose_service_kv("kvstore",
                                         {args["key"]: None})
            return ""
        if cmd == "config-key ls":
            return sorted(self.kv_db)
        if cmd == "mgr dump":
            return dict(self.mgrmap)
        if cmd == "mgr fail":
            # depose the active and promote a standby NOW (not on the
            # next beacon race, which the deposed mgr usually wins)
            m = dict(self.mgrmap)
            if m.get("active"):
                m["epoch"] += 1
                stand = m.get("standbys", [])
                if stand:
                    nxt = stand[0]
                    m.update({"active": nxt["name"],
                              "active_addr": nxt["addr"],
                              "standbys": stand[1:]})
                else:
                    m.update({"active": None, "active_addr": None})
                await mon.propose_service_kv(
                    "mgrmap", {"map": json.dumps(m)})
                await mon._publish_mgr_map()
            return dict(m)
        if cmd == "auth get-or-create":
            entry = self.auth_get_or_create(args["entity"],
                                            args.get("caps"))
            entity = entry.pop("entity")
            if self.auth_db.get(entity) != entry:
                await mon.propose_service_kv("auth", {entity: entry})
            return {"entity": entity, **entry}
        if cmd == "auth get":
            if args["entity"] not in self.auth_db:
                raise ValueError(f"no such entity {args['entity']}")
            return {"entity": args["entity"],
                    **self.auth_db[args["entity"]]}
        if cmd == "auth ls":
            return {e: {"caps": v.get("caps", {})}
                    for e, v in sorted(self.auth_db.items())}
        if cmd == "auth rm":
            await mon.propose_service_kv("auth", {args["entity"]: None})
            return ""
        if cmd == "log":
            payload = self.log_entry(args.get("level", "INF"),
                                     args["message"],
                                     who=args.get("who", "client"))
            await mon.propose_service_kv("log", payload)
            return ""
        if cmd == "log last":
            n = int(args.get("n", 20))
            return self.cluster_log[-n:]
        if cmd == "health":
            h = self.health()
            if args.get("detail"):
                return h
            return {"status": h["status"],
                    "summary": {k: v["summary"]
                                for k, v in h["checks"].items()}}
        raise UnknownCommand(cmd)
