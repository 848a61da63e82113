"""cephfs-mirror daemon launcher (src/tools/cephfs_mirror analog).

    python -m ceph_tpu_torch.tools.cephfs_mirror \
        --src-mon 127.0.0.1:6789 --dst-mon 127.0.0.1:6790 --interval 10

Configure trees on the primary first:
    python -m ceph_tpu_torch.tools.cephfs_cli --mon ... (then fs_mirror_add
    via the library, or the `mirror add` subcommand below)

Port of ``ceph_tpu/tools/cephfs_mirror.py``; both mounts run on
``--device`` (CUDA unless the caller names the CPU).
"""

from __future__ import annotations

import argparse
import asyncio
import signal
import sys

from ..mds import CephFS
from ..mds.fs_mirror import (
    FsMirrorDaemon, fs_mirror_add, fs_mirror_dirs, fs_mirror_remove,
)


async def amain(args) -> int:
    sh, sp = args.src_mon.rsplit(":", 1)
    src = dst = None
    try:
        src = await CephFS((sh, int(sp)), device=args.device).mount()
        if args.cmd == "add":
            await fs_mirror_add(src.meta, args.path)
            print(f"mirroring configured for {args.path}")
            return 0
        if args.cmd == "remove":
            await fs_mirror_remove(src.meta, args.path)
            print(f"mirroring removed for {args.path}")
            return 0
        if args.cmd == "ls":
            for d in await fs_mirror_dirs(src.meta):
                print(d)
            return 0
        dh, dp = args.dst_mon.rsplit(":", 1)
        dst = await CephFS((dh, int(dp)), device=args.device).mount()
        daemon = FsMirrorDaemon(src, dst, interval=args.interval)
        daemon.start()
        print(f"cephfs-mirror: replaying every {args.interval}s",
              flush=True)
        stop = asyncio.Event()
        loop = asyncio.get_event_loop()
        for s in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(s, stop.set)
        await stop.wait()
        await daemon.stop()
        return 0
    finally:
        if src is not None:
            await src.unmount()
        if dst is not None:
            await dst.unmount()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="cephfs-mirror")
    p.add_argument("--src-mon", required=True)
    p.add_argument("--dst-mon")
    p.add_argument("--interval", type=float, default=10.0)
    p.add_argument("--device", default="cuda",
                   help="the client's device: cuda (the card) or cpu "
                        "(the kernels' plain versions)")
    p.add_argument("cmd", nargs="?", default="run",
                   choices=["run", "add", "remove", "ls"])
    p.add_argument("path", nargs="?")
    args = p.parse_args(argv)
    if args.cmd == "run" and not args.dst_mon:
        p.error("run mode requires --dst-mon")
    if args.cmd in ("add", "remove") and not args.path:
        p.error(f"{args.cmd} requires a path")
    return asyncio.run(amain(args))


if __name__ == "__main__":
    sys.exit(main())
