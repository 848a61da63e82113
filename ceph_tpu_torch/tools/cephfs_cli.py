"""cephfs-shell analog: drive a CephFS namespace from the command line.

    python -m ceph_tpu_torch.tools.cephfs_cli --mon 127.0.0.1:6789 mkdir /a
    python -m ceph_tpu_torch.tools.cephfs_cli --mon 127.0.0.1:6789 put f.txt /a/f

Port of ``ceph_tpu/tools/cephfs_cli.py``; its mount runs on ``--device``
(CUDA unless the caller names the CPU).
"""

from __future__ import annotations

import argparse
import asyncio
import sys

from ..mds import CephFS


async def amain(args) -> int:
    host, port = args.mon.rsplit(":", 1)
    fs = await CephFS((host, int(port)), device=args.device).mount()
    try:
        if args.cmd == "ls":
            entries = await fs.readdir(args.path)
            for name in sorted(entries):
                d = entries[name]
                kind = "d" if d["type"] == "dir" else "-"
                print(f"{kind} {d.get('size', 0):>10} {name}")
        elif args.cmd == "mkdir":
            await fs.mkdir(args.path)
        elif args.cmd == "rmdir":
            await fs.rmdir(args.path)
        elif args.cmd == "rm":
            await fs.unlink(args.path)
        elif args.cmd == "mv":
            await fs.rename(args.path, args.dst)
        elif args.cmd == "stat":
            print(await fs.stat(args.path))
        elif args.cmd == "put":
            data = (sys.stdin.buffer.read() if args.local == "-"
                    else open(args.local, "rb").read())
            await fs.write_file(args.path, data)
            print(f"wrote {len(data)} bytes to {args.path}")
        elif args.cmd == "get":
            data = await fs.read_file(args.path)
            if args.local == "-":
                sys.stdout.buffer.write(data)
            else:
                open(args.local, "wb").write(data)
        elif args.cmd == "tree":
            async for dirpath, dirs, files in fs.walk(args.path):
                print(dirpath)
                for f in files:
                    print(f"  {f}")
        return 0
    finally:
        await fs.unmount()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="cephfs")
    p.add_argument("--mon", default="127.0.0.1:6789")
    p.add_argument("--device", default="cuda",
                   help="the client's device: cuda (the card) or cpu "
                        "(the kernels' plain versions)")
    sub = p.add_subparsers(dest="cmd", required=True)
    for c in ("ls", "mkdir", "rmdir", "rm", "stat", "tree"):
        sp = sub.add_parser(c)
        sp.add_argument("path", nargs="?" if c in ("ls", "tree")
                        else None, default="/")
    sp = sub.add_parser("mv")
    sp.add_argument("path"); sp.add_argument("dst")
    sp = sub.add_parser("put")
    sp.add_argument("local"); sp.add_argument("path")
    sp = sub.add_parser("get")
    sp.add_argument("path"); sp.add_argument("local")
    args = p.parse_args(argv)
    return asyncio.run(amain(args))


if __name__ == "__main__":
    sys.exit(main())
