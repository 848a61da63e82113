"""Standalone prometheus exporter (src/exporter analog).

Scrapes every daemon admin socket in a directory (``perf dump`` +
``status``) and serves the aggregate on GET /metrics -- the
node-local exporter deployment shape, no mgr required.

    python -m ceph_tpu_torch.tools.exporter --asok-dir /tmp/cluster \
        --port 9926

Port of ``ceph_tpu/tools/exporter.py``, copied: it reads admin sockets
only and builds no client.
"""

from __future__ import annotations

import argparse
import asyncio
import sys
from pathlib import Path

from ..common.admin_socket import admin_command
from ..mgr.prometheus import (
    MetricsHttpServer, families_from_perf, merge_families,
    render_metrics,
)


class Exporter:
    def __init__(self, asok_dir: str) -> None:
        self.asok_dir = Path(asok_dir)

    async def render(self) -> str:
        fams = []
        up = {"help": "admin socket reachable", "type": "gauge",
              "samples": []}
        for sock in sorted(self.asok_dir.glob("*.asok")):
            daemon = sock.name[:-len(".asok")]
            try:
                dump = await asyncio.wait_for(
                    admin_command(str(sock), "perf dump"), 5)
                up["samples"].append(({"ceph_daemon": daemon}, 1))
            except (OSError, asyncio.TimeoutError, ValueError):
                up["samples"].append(({"ceph_daemon": daemon}, 0))
                continue
            for subsys, counters in (dump or {}).items():
                flat = {}
                for key, val in counters.items():
                    if isinstance(val, dict) and "avgcount" in val:
                        flat[f"{subsys}_{key}_count"] = val["avgcount"]
                        flat[f"{subsys}_{key}_sum"] = val.get("sum", 0)
                    else:
                        flat[f"{subsys}_{key}"] = val
                fams.append(families_from_perf(daemon, flat,
                                               prefix="ceph"))
        return render_metrics(merge_families({"ceph_daemon_up": up},
                                             *fams))


async def amain(args) -> int:
    exp = Exporter(args.asok_dir)
    srv = MetricsHttpServer(exp.render)
    addr = await srv.start(host=args.host, port=args.port)
    print(f"exporter listening on http://{addr[0]}:{addr[1]}/metrics",
          flush=True)
    stop = asyncio.Event()
    import signal
    loop = asyncio.get_event_loop()
    for s in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(s, stop.set)
    await stop.wait()
    await srv.stop()
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ceph-exporter")
    p.add_argument("--asok-dir", required=True,
                   help="directory of daemon admin sockets")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=9926)
    args = p.parse_args(argv)
    return asyncio.run(amain(args))


if __name__ == "__main__":
    sys.exit(main())
