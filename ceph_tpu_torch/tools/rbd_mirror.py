"""rbd-mirror daemon launcher (src/tools/rbd_mirror analog).

Replays enabled images from a primary cluster's pool to a secondary:

    python -m ceph_tpu_torch.tools.rbd_mirror \
        --src-mon 127.0.0.1:6789 --dst-mon 127.0.0.1:6790 \
        -p rbd --interval 10

Enable images on the primary first:
    python -m ceph_tpu_torch.tools.rbd_cli --mon ... mirror enable <image>

Port of ``ceph_tpu/tools/rbd_mirror.py``; both librados clients run on
``--device`` (CUDA unless the caller names the CPU).
"""

from __future__ import annotations

import argparse
import asyncio
import signal
import sys

from ..client import Rados
from ..rbd.mirror import MirrorDaemon


async def amain(args) -> int:
    sh, sp = args.src_mon.rsplit(":", 1)
    dh, dp = args.dst_mon.rsplit(":", 1)
    src = dst = None
    try:
        # both connects INSIDE the try: a dst failure must still tear
        # down the already-connected src session
        src = await Rados((sh, int(sp)), name="client.rbd-mirror-src",
                          device=args.device).connect()
        dst = await Rados((dh, int(dp)), name="client.rbd-mirror-dst",
                          device=args.device).connect()
        if args.pool not in await dst.pool_list():
            await dst.pool_create(args.pool, pg_num=args.pg_num)
        sio = await src.open_ioctx(args.pool)
        dio = await dst.open_ioctx(args.pool)
        daemon = MirrorDaemon(sio, dio, interval=args.interval)
        daemon.start()
        print(f"rbd-mirror: replaying pool '{args.pool}' every "
              f"{args.interval}s", flush=True)
        stop = asyncio.Event()
        loop = asyncio.get_event_loop()
        for s in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(s, stop.set)
        await stop.wait()
        await daemon.stop()
        return 0
    finally:
        if src is not None:
            await src.shutdown()
        if dst is not None:
            await dst.shutdown()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="rbd-mirror")
    p.add_argument("--src-mon", required=True)
    p.add_argument("--dst-mon", required=True)
    p.add_argument("-p", "--pool", default="rbd")
    p.add_argument("--pg-num", type=int, default=16)
    p.add_argument("--interval", type=float, default=10.0)
    p.add_argument("--device", default="cuda",
                   help="the client's device: cuda (the card) or cpu "
                        "(the kernels' plain versions)")
    args = p.parse_args(argv)
    return asyncio.run(amain(args))


if __name__ == "__main__":
    sys.exit(main())
