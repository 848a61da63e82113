"""``rbd`` CLI analog (src/tools/rbd): image create/ls/info/rm/resize,
snapshots, clone/flatten, export/import, and a micro write bench.

Usage (against a vstart cluster):
    python -m ceph_tpu_torch.tools.rbd_cli --mon 127.0.0.1:6789 \
        create -p rbd --size 64M img1

Port of ``ceph_tpu/tools/rbd_cli.py``; its librados client runs on
``--device`` (CUDA unless the caller names the CPU).
"""

from __future__ import annotations

import argparse
import asyncio
import sys
import time

from ..client import Rados
from ..rbd import RBD, Image


def parse_size(s: str) -> int:
    s = s.strip().upper()
    mult = 1
    for suf, m in (("K", 1 << 10), ("M", 1 << 20), ("G", 1 << 30),
                   ("T", 1 << 40)):
        if s.endswith(suf):
            s, mult = s[:-1], m
            break
    return int(float(s) * mult)


async def amain(args) -> int:
    host, port = args.mon.rsplit(":", 1)
    rados = await Rados((host, int(port)), device=args.device).connect()
    try:
        io = await rados.open_ioctx(args.pool)
        rbd = RBD()
        if args.cmd == "create":
            await rbd.create(io, args.image, parse_size(args.size),
                             order=args.order)
            print(f"created {args.image} ({args.size})")
        elif args.cmd == "ls":
            for name in await rbd.list(io):
                print(name)
        elif args.cmd == "info":
            img = await Image.open(io, args.image, read_only=True)
            st = img.stat()
            await img.close()
            print(f"rbd image '{args.image}':")
            print(f"\tsize {st['size']} bytes in {st['num_objs']} objects")
            print(f"\torder {st['order']} "
                  f"({1 << st['order']} byte objects)")
            print(f"\tid: {st['id']}")
            print(f"\tblock_name_prefix: {st['object_prefix']}")
            if st["parent"]:
                print(f"\tparent: pool {st['parent']['pool_id']} "
                      f"image {st['parent']['image_id']} "
                      f"snap {st['parent']['snap_id']}")
            for s in st["snapshots"]:
                prot = " (protected)" if s.get("protected") else ""
                print(f"\tsnap {s['name']} id {s['id']} "
                      f"size {s['size']}{prot}")
        elif args.cmd == "rm":
            await rbd.remove(io, args.image)
            print(f"removed {args.image}")
        elif args.cmd == "resize":
            img = await Image.open(io, args.image)
            await img.resize(parse_size(args.size))
            await img.close()
            print(f"resized {args.image} to {args.size}")
        elif args.cmd == "snap":
            img = await Image.open(io, args.image,
                                   read_only=args.snap_cmd == "ls")
            try:
                if args.snap_cmd == "create":
                    sid = await img.create_snap(args.snap)
                    print(f"snap {args.snap} id {sid}")
                elif args.snap_cmd == "rm":
                    await img.remove_snap(args.snap)
                elif args.snap_cmd == "ls":
                    for s in img.list_snaps():
                        print(f"{s['id']}\t{s['name']}\t{s['size']}")
                elif args.snap_cmd == "protect":
                    await img.protect_snap(args.snap)
                elif args.snap_cmd == "unprotect":
                    await img.unprotect_snap(args.snap)
                elif args.snap_cmd == "rollback":
                    await img.rollback_snap(args.snap)
            finally:
                await img.close()
        elif args.cmd == "clone":
            ppool, rest = args.parent_spec.split("/", 1)
            pname, snap = rest.split("@", 1)
            pio = await rados.open_ioctx(ppool)
            await rbd.clone(pio, pname, snap, io, args.image)
            print(f"cloned {args.parent_spec} -> {args.image}")
        elif args.cmd == "flatten":
            img = await Image.open(io, args.image)
            await img.flatten()
            await img.close()
            print(f"flattened {args.image}")
        elif args.cmd == "export":
            img = await Image.open(io, args.image, read_only=True)
            out = (sys.stdout.buffer if args.path == "-"
                   else open(args.path, "wb"))
            try:
                async for _, chunk in img.export():
                    out.write(chunk)
            finally:
                if args.path != "-":
                    out.close()
                await img.close()
        elif args.cmd == "import":
            data = (sys.stdin.buffer.read() if args.path == "-"
                    else open(args.path, "rb").read())
            await rbd.create(io, args.image, len(data), order=args.order)
            img = await Image.open(io, args.image)
            step = 1 << 22
            for off in range(0, len(data), step):
                await img.write(off, data[off:off + step])
            await img.close()
            print(f"imported {len(data)} bytes into {args.image}")
        elif args.cmd == "mirror":
            from ..rbd.mirror import (
                mirror_disable, mirror_enable, mirror_enabled,
                mirror_status,
            )
            if args.mirror_cmd != "ls" and not args.image:
                print(f"error: mirror {args.mirror_cmd} requires an "
                      f"image name", file=sys.stderr)
                return 2
            if args.mirror_cmd == "enable":
                await mirror_enable(io, args.image)
                print(f"mirroring enabled for {args.image}")
            elif args.mirror_cmd == "disable":
                await mirror_disable(io, args.image)
                print(f"mirroring disabled for {args.image}")
            elif args.mirror_cmd == "ls":
                for name in await mirror_enabled(io):
                    print(name)
            elif args.mirror_cmd == "status":
                print(await mirror_status(io, args.image))
        elif args.cmd == "bench":
            img = await Image.open(io, args.image)
            size = await img.size()
            bs = parse_size(args.io_size)
            total = parse_size(args.io_total)
            if bs > size:
                await img.close()
                print(f"error: --io-size {args.io_size} exceeds image "
                      f"size {size}", file=sys.stderr)
                return 1
            slots = size // bs          # aligned, in-bounds positions
            buf = (bytes(range(256)) * (bs // 256 + 1))[:bs]
            t0 = time.perf_counter()
            done = i = 0
            while done < total:
                await img.write((i % slots) * bs, buf)
                i += 1
                done += bs
            dt = time.perf_counter() - t0
            await img.close()
            print(f"elapsed {dt:.2f}s  ops {total // bs}  "
                  f"bytes/sec {total / dt:.0f}")
        return 0
    finally:
        await rados.shutdown()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="rbd")
    p.add_argument("--mon", default="127.0.0.1:6789")
    p.add_argument("--device", default="cuda",
                   help="the client's device: cuda (the card) or cpu "
                        "(the kernels' plain versions)")
    p.add_argument("-p", "--pool", default="rbd")
    sub = p.add_subparsers(dest="cmd", required=True)
    sp = sub.add_parser("create")
    sp.add_argument("image")
    sp.add_argument("--size", required=True)
    sp.add_argument("--order", type=int, default=22)
    sub.add_parser("ls")
    sp = sub.add_parser("info"); sp.add_argument("image")
    sp = sub.add_parser("rm"); sp.add_argument("image")
    sp = sub.add_parser("resize")
    sp.add_argument("image"); sp.add_argument("--size", required=True)
    sp = sub.add_parser("snap")
    sp.add_argument("snap_cmd", choices=["create", "rm", "ls", "protect",
                                         "unprotect", "rollback"])
    sp.add_argument("image")
    sp.add_argument("snap", nargs="?")
    sp = sub.add_parser("clone")
    sp.add_argument("parent_spec", help="pool/image@snap")
    sp.add_argument("image")
    sp = sub.add_parser("flatten"); sp.add_argument("image")
    sp = sub.add_parser("export")
    sp.add_argument("image"); sp.add_argument("path")
    sp = sub.add_parser("import")
    sp.add_argument("path"); sp.add_argument("image")
    sp.add_argument("--order", type=int, default=22)
    sp = sub.add_parser("mirror")
    sp.add_argument("mirror_cmd",
                    choices=["enable", "disable", "ls", "status"])
    sp.add_argument("image", nargs="?")
    sp = sub.add_parser("bench")
    sp.add_argument("image")
    sp.add_argument("--io-size", default="4K")
    sp.add_argument("--io-total", default="4M")
    args = p.parse_args(argv)
    return asyncio.run(amain(args))


if __name__ == "__main__":
    sys.exit(main())
