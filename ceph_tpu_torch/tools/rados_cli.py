"""``rados``-style CLI over the librados-shaped client.

Subcommand surface mirrors the reference's src/tools/rados/rados.cc:
lspools/mkpool/rmpool, put/get/append/rm/stat/truncate, ls,
setxattr/getxattr/rmxattr/listxattr, setomapval/listomapvals/rmomapkey,
bench.  Usage: python -m ceph_tpu_torch.tools.rados_cli -m HOST:PORT <cmd> ...

Port of ``ceph_tpu/tools/rados_cli.py``; its librados client runs on
``--device`` (CUDA unless the caller names the CPU).
"""

from __future__ import annotations

import argparse
import asyncio
import sys
import time

from . import parse_addr
from ..client import Rados, RadosError


async def _run(args) -> int:
    rados = Rados(parse_addr(args.mon), name="client.rados-cli",
                  device=args.device)
    try:
        await rados.connect()
    except (ConnectionError, OSError, TimeoutError) as e:
        print(f"error: cannot reach monitor at {args.mon}: {e}",
              file=sys.stderr)
        return 1
    try:
        return await _dispatch(rados, args)
    except (RadosError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    finally:
        await rados.shutdown()


async def _dispatch(rados: Rados, args) -> int:
    cmd = args.cmd
    if cmd == "lspools":
        for name in await rados.pool_list():
            print(name)
        return 0
    if cmd == "mkpool":
        pid = await rados.pool_create(args.pool, pg_num=args.pg_num,
                                      pool_type=args.pool_type,
                                      erasure_code_profile=args.profile)
        print(f"pool {args.pool} created (id {pid})")
        return 0
    if cmd == "rmpool":
        await rados.pool_delete(args.pool)
        print(f"pool {args.pool} removed")
        return 0

    ioctx = await rados.open_ioctx(args.pool)
    if cmd == "put":
        data = (sys.stdin.buffer.read() if args.infile == "-"
                else open(args.infile, "rb").read())
        await ioctx.write_full(args.obj, data)
        return 0
    if cmd == "get":
        data = await ioctx.read(args.obj)
        if args.outfile == "-":
            sys.stdout.buffer.write(data)
        else:
            open(args.outfile, "wb").write(data)
        return 0
    if cmd == "append":
        data = (sys.stdin.buffer.read() if args.infile == "-"
                else open(args.infile, "rb").read())
        await ioctx.append(args.obj, data)
        return 0
    if cmd == "ls":
        for oid in await ioctx.list_objects():
            print(oid)
        return 0
    if cmd == "rm":
        await ioctx.remove(args.obj)
        return 0
    if cmd == "stat":
        st = await ioctx.stat(args.obj)
        print(f"{args.pool}/{args.obj} size {st['size']}")
        return 0
    if cmd == "truncate":
        await ioctx.truncate(args.obj, args.size)
        return 0
    if cmd == "setxattr":
        await ioctx.set_xattr(args.obj, args.name, args.value.encode())
        return 0
    if cmd == "getxattr":
        sys.stdout.buffer.write(await ioctx.get_xattr(args.obj, args.name))
        print()
        return 0
    if cmd == "rmxattr":
        await ioctx.rm_xattr(args.obj, args.name)
        return 0
    if cmd == "listxattr":
        for k in sorted(await ioctx.get_xattrs(args.obj)):
            print(k)
        return 0
    if cmd == "setomapval":
        await ioctx.set_omap(args.obj, {args.name: args.value.encode()})
        return 0
    if cmd == "listomapvals":
        for k, v in sorted((await ioctx.get_omap(args.obj)).items()):
            print(f"{k}\n value ({len(v)} bytes):\n{v!r}")
        return 0
    if cmd == "rmomapkey":
        await ioctx.rm_omap_keys(args.obj, [args.name])
        return 0
    if cmd == "bench":
        return await _bench(ioctx, args)
    print(f"unknown command {cmd}", file=sys.stderr)
    return 2


async def _bench(ioctx, args) -> int:
    """radosbench-style write-throughput loop (objects cleaned up
    afterwards)."""
    size = args.obj_size
    payload = b"\xa5" * size
    t0 = time.perf_counter()
    n = 0
    deadline = t0 + args.seconds
    while time.perf_counter() < deadline:
        await ioctx.write_full(f"bench_{n}", payload)
        n += 1
    dt = time.perf_counter() - t0
    mb = n * size / 1e6
    print(f"wrote {n} x {size}B in {dt:.2f}s = {mb/dt:.2f} MB/s "
          f"({n/dt:.1f} iops)")
    for i in range(n):
        await ioctx.remove(f"bench_{i}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="rados")
    p.add_argument("-m", "--mon", default="127.0.0.1:6789",
                   help="monitor host:port")
    p.add_argument("--device", default="cuda",
                   help="the client's device: cuda (the card) or cpu "
                        "(the kernels' plain versions)")
    sub = p.add_subparsers(dest="cmd", required=True)
    sub.add_parser("lspools")
    sp = sub.add_parser("mkpool")
    sp.add_argument("pool")
    sp.add_argument("--pg-num", type=int, default=32, dest="pg_num")
    sp.add_argument("--type", default="replicated", dest="pool_type",
                    choices=["replicated", "erasure"])
    sp.add_argument("--profile", default="default")
    sp = sub.add_parser("rmpool")
    sp.add_argument("pool")
    for name, extra in [
            ("put", ["obj", "infile"]), ("get", ["obj", "outfile"]),
            ("append", ["obj", "infile"]), ("ls", []), ("rm", ["obj"]),
            ("stat", ["obj"]), ("setxattr", ["obj", "name", "value"]),
            ("getxattr", ["obj", "name"]), ("rmxattr", ["obj", "name"]),
            ("listxattr", ["obj"]),
            ("setomapval", ["obj", "name", "value"]),
            ("listomapvals", ["obj"]), ("rmomapkey", ["obj", "name"])]:
        sp = sub.add_parser(name)
        sp.add_argument("pool")
        for a in extra:
            sp.add_argument(a)
    sp = sub.add_parser("truncate")
    sp.add_argument("pool")
    sp.add_argument("obj")
    sp.add_argument("size", type=int)
    sp = sub.add_parser("bench")
    sp.add_argument("pool")
    sp.add_argument("seconds", type=int)
    sp.add_argument("--obj-size", type=int, default=65536, dest="obj_size")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return asyncio.run(_run(args))


if __name__ == "__main__":
    sys.exit(main())
