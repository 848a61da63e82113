"""vstart-style single-host cluster launcher (src/vstart.sh analog).

Boots one monitor + N OSDs in one asyncio process and serves until
SIGINT/SIGTERM.  With --store-dir, OSDs use SQLite-backed DBStores so
the cluster survives restarts (crash-recovery via WAL).

    python -m ceph_tpu_torch.tools.vstart --osds 3 --mon-port 6789

Multi-process deployments (the qa/standalone ceph-helpers.sh shape)
run one DAEMON per process instead:

    python -m ceph_tpu_torch.tools.vstart --role mon --mon-port 6789 \
        --store-dir /var/lib/c1
    python -m ceph_tpu_torch.tools.vstart --role osd \
        --mon-addr 127.0.0.1:6789 --osd-index 0 --store block \
        --store-dir /var/lib/c1

Port of ``ceph_tpu/tools/vstart.py``: every daemon (the monitor, each
OSD, the mgr and each MDS, in every role) runs on ``--device`` (CUDA
unless the caller names the CPU), so each daemon process holds its own
CUDA context.
"""

from __future__ import annotations

import argparse
import asyncio
import os
import signal
import sys

from ..device import launch_counts
from ..mon import Monitor
from ..os.store import DBStore, MemStore
from ..osd import OSD


def _make_store(args, name: str):
    if not args.store_dir or args.store == "mem":
        return MemStore()
    if args.store == "block":
        from ..os.blockstore import BlockStore
        return BlockStore(os.path.join(args.store_dir, name))
    if args.store == "kv":
        from ..os.kvstore import KVStore
        return KVStore(os.path.join(args.store_dir, f"{name}.kv.db"))
    return DBStore(os.path.join(args.store_dir, f"{name}.db"))


async def _serve_until_signal(banner: str) -> None:
    print(banner, flush=True)
    stop = asyncio.Event()
    loop = asyncio.get_event_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    await stop.wait()


def _serve_launches(admin_socket) -> None:
    """``kernel launches`` on a daemon's admin socket: this process's
    launches of each kernel, counted where the wrappers launch them (the
    port's own command: a process a daemon, each with its own counts)."""
    if admin_socket is None:
        return

    async def launches(req):
        return launch_counts()
    admin_socket.register("kernel launches",
                          "this process's launches of each kernel",
                          launches)


async def run_mon(args) -> None:
    """One monitor in THIS process (multi-process deployment role)."""
    mon = Monitor(rank=0,
                  store_path=(os.path.join(args.store_dir, "mon.db")
                              if args.store_dir else ":memory:"),
                  config={"mon_osd_min_down_reporters":
                          args.min_down_reporters},
                  admin_socket_path=(
                      os.path.join(args.asok_dir or args.store_dir,
                                   "mon.0.asok")
                      if (args.asok_dir or args.store_dir) else None),
                  device=args.device)
    addr = await mon.start(port=args.mon_port)
    _serve_launches(mon.admin_socket)
    await _serve_until_signal(f"mon.0 at {addr[0]}:{addr[1]}")
    await mon.stop()


async def run_osd(args) -> None:
    """One OSD in THIS process, booting to --mon-addr."""
    host, _, port = args.mon_addr.partition(":")
    store = _make_store(args, f"osd{args.osd_index}")
    asok = args.asok_dir or args.store_dir
    osd = OSD(host=f"host{args.osd_index % args.hosts}", store=store,
              whoami=args.osd_index if args.cephx_key else None,
              config={"osd_heartbeat_interval": 0.5,
                      "osd_heartbeat_grace": 4.0},
              cephx_key=args.cephx_key,
              require_ticket=bool(args.cephx_key),
              admin_socket_path=(
                  os.path.join(asok, f"osd.{args.osd_index}.asok")
                  if asok else None),
              device=args.device)
    wid = await osd.start((host, int(port)))
    _serve_launches(osd.admin_socket)
    await _serve_until_signal(
        f"osd.{wid} up ({args.store} store)")
    await osd.stop()


async def run_cluster(args) -> None:
    asok_dir = args.asok_dir or args.store_dir
    mon = Monitor(rank=0,
                  store_path=(os.path.join(args.store_dir, "mon.db")
                              if args.store_dir else ":memory:"),
                  config={"mon_osd_min_down_reporters":
                          args.min_down_reporters},
                  admin_socket_path=(
                      os.path.join(asok_dir, "mon.0.asok")
                      if asok_dir else None),
                  device=args.device)
    addr = await mon.start(port=args.mon_port)
    print(f"mon.0 at {addr[0]}:{addr[1]}", flush=True)
    osds = []
    for i in range(args.osds):
        store = _make_store(args, f"osd{i}")
        cephx_key = None
        if args.cephx:
            # register the OSD's entity at the mon and boot with
            # ticket enforcement (clients then need authenticate()).
            # whoami is pinned to i so the registered entity name
            # matches the identity the OSD authenticates as even when
            # a durable mon remembers earlier incarnations
            rec = await mon.handle_command(
                "auth get-or-create", {"entity": f"osd.{i}"})
            cephx_key = rec["key"]
        osd = OSD(host=f"host{i % args.hosts}", store=store,
                  whoami=i if args.cephx else None,
                  config={"osd_heartbeat_interval": 0.5,
                          "osd_heartbeat_grace": 4.0},
                  cephx_key=cephx_key,
                  require_ticket=bool(cephx_key),
                  admin_socket_path=(
                      os.path.join(asok_dir, f"osd.{i}.asok")
                      if asok_dir else None),
                  device=args.device)
        wid = await osd.start(addr)
        print(f"osd.{wid} up ({'db' if args.store_dir else 'mem'} store, "
              f"host{i % args.hosts})", flush=True)
        osds.append(osd)
    mgr = None
    if args.mgr:
        from ..mgr import Mgr
        mgr = Mgr(config={"balancer_active": True}, device=args.device)
        await mgr.start(addr)
        print("mgr.x active (balancer on)", flush=True)
    mdss = []
    for i in range(args.mds):
        from ..mds import MDS
        mds_key = None
        if args.cephx:
            rec = await mon.handle_command(
                "auth get-or-create",
                {"entity": f"mds.{chr(ord('a') + i)}"})
            mds_key = rec["key"]
        m = MDS(name=chr(ord("a") + i), cephx_key=mds_key,
                device=args.device)
        await m.start(addr)
        mdss.append(m)
        print(f"mds.{m.name} up (standby)", flush=True)
    if args.cephx:
        print("cephx REQUIRED on the osds: clients must "
              "`await rados.authenticate(entity, key)` after an "
              "`auth get-or-create` at the mon", flush=True)
    print(f"cluster ready: 1 mon, {len(osds)} osds"
          f"{', 1 mgr' if mgr else ''}"
          f"{f', {len(mdss)} mds' if mdss else ''} -- "
          f"rados -m {addr[0]}:{addr[1]} lspools", flush=True)

    stop = asyncio.Event()
    loop = asyncio.get_event_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    await stop.wait()
    print("shutting down...", flush=True)
    for m in mdss:
        await m.stop()
    if mgr is not None:
        await mgr.stop()
    for osd in osds:
        await osd.stop()
    await mon.stop()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="vstart")
    p.add_argument("--osds", type=int, default=3)
    p.add_argument("--hosts", type=int, default=3,
                   help="spread OSDs over N crush hosts")
    p.add_argument("--mon-port", type=int, default=6789)
    p.add_argument("--mds", type=int, default=0,
                   help="start N metadata servers (cephfs)")
    p.add_argument("--store-dir", default=None,
                   help="directory for durable SQLite stores")
    p.add_argument("--asok-dir", default=None,
                   help="directory for admin sockets (default store-dir)")
    p.add_argument("--min-down-reporters", type=int, default=2)
    p.add_argument("--mgr", action="store_true", default=True,
                   help="start a mgr daemon (balancer active; on by "
                        "default, disable with --no-mgr)")
    p.add_argument("--no-mgr", dest="mgr", action="store_false")
    p.add_argument("--role", choices=("all", "mon", "osd"),
                   default="all",
                   help="run the whole cluster in-process (all) or "
                        "ONE daemon per process (mon/osd)")
    p.add_argument("--mon-addr", default=None,
                   help="mon address for --role osd (host:port)")
    p.add_argument("--osd-index", type=int, default=0)
    p.add_argument("--cephx", action="store_true",
                   help="OSDs enforce cephx tickets (--role all)")
    p.add_argument("--cephx-key", default=None,
                   help="--role osd: this daemon's entity key from "
                        "`auth get-or-create entity=osd.<index>`")
    p.add_argument("--device", default="cuda",
                   help="the daemons' device: cuda (the card) or cpu "
                        "(the kernels' plain versions)")
    p.add_argument("--store", choices=("mem", "db", "block", "kv"),
                   default="db",
                   help="store backend when --store-dir is set")
    args = p.parse_args(argv)
    if args.store_dir:
        os.makedirs(args.store_dir, exist_ok=True)
    if args.role == "osd" and not args.mon_addr:
        p.error("--role osd requires --mon-addr host:port")
    if args.cephx and args.role != "all":
        p.error("--cephx applies to --role all; per-daemon roles "
                "take --cephx-key (from `auth get-or-create`)")
    runner = {"all": run_cluster, "mon": run_mon,
              "osd": run_osd}[args.role]
    try:
        asyncio.run(runner(args))
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
