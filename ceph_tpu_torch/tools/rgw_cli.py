"""radosgw-admin + radosgw analog: user admin and gateway daemon.

    python -m ceph_tpu_torch.tools.rgw_cli --mon 127.0.0.1:6789 \
        user create --uid alice --display-name "Alice"
    python -m ceph_tpu_torch.tools.rgw_cli --mon 127.0.0.1:6789 \
        serve --port 7480

Port of ``ceph_tpu/tools/rgw_cli.py``; its librados client runs on
``--device`` (CUDA unless the caller names the CPU).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys

from ..client import Rados
from ..rgw import Gateway, RgwStore

POOL = ".rgw"


async def open_store(rados, pg_num=16):
    pools = await rados.pool_list()
    if POOL not in pools:
        await rados.pool_create(POOL, pg_num=pg_num)
    io = await rados.open_ioctx(POOL)
    return RgwStore(io)


async def amain(args) -> int:
    host, port = args.mon.rsplit(":", 1)
    rados = await Rados((host, int(port)), device=args.device).connect()
    try:
        store = await open_store(rados)
        if args.cmd == "user" and args.user_cmd == "create":
            user = await store.create_user(args.uid, args.display_name,
                                           access_key=args.access_key,
                                           secret=args.secret)
            print(json.dumps(user, indent=2))
        elif args.cmd == "bucket" and args.user_cmd == "list":
            for b in await store.list_buckets():
                print(b["name"])
        elif args.cmd == "serve":
            gw = Gateway(store)
            addr = await gw.start(port=args.port)
            print(f"rgw listening on {addr[0]}:{addr[1]}", flush=True)
            stop = asyncio.Event()
            loop = asyncio.get_event_loop()
            import signal
            for s in (signal.SIGINT, signal.SIGTERM):
                loop.add_signal_handler(s, stop.set)
            await stop.wait()
            await gw.stop()
        return 0
    finally:
        await rados.shutdown()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="rgw")
    p.add_argument("--mon", default="127.0.0.1:6789")
    p.add_argument("--device", default="cuda",
                   help="the client's device: cuda (the card) or cpu "
                        "(the kernels' plain versions)")
    sub = p.add_subparsers(dest="cmd", required=True)
    sp = sub.add_parser("user")
    sp.add_argument("user_cmd", choices=["create"])
    sp.add_argument("--uid", required=True)
    sp.add_argument("--display-name", default="")
    sp.add_argument("--access-key")
    sp.add_argument("--secret")
    sp = sub.add_parser("bucket")
    sp.add_argument("user_cmd", choices=["list"])
    sp = sub.add_parser("serve")
    sp.add_argument("--port", type=int, default=7480)
    args = p.parse_args(argv)
    return asyncio.run(amain(args))


if __name__ == "__main__":
    sys.exit(main())
