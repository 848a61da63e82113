"""``ceph``-style admin CLI: status, osd tree/dump, pool and EC-profile
management — the monitor command surface (src/ceph.in + MonCommands.h
analog).  Usage: python -m ceph_tpu_torch.tools.ceph_cli -m HOST:PORT <cmd...>

Port of ``ceph_tpu/tools/ceph_cli.py``; its librados client runs on
``--device`` (CUDA unless the caller names the CPU).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys

from . import parse_addr
from ..client import Rados, RadosError


async def _run(args) -> int:
    rados = Rados(parse_addr(args.mon), name="client.ceph-cli",
                  device=args.device)
    try:
        await rados.connect()
    except (ConnectionError, OSError, TimeoutError) as e:
        print(f"error: cannot reach monitor at {args.mon}: {e}",
              file=sys.stderr)
        return 1
    try:
        words = args.words
        cmd, cargs = _parse_command(words)
        result = await rados.mon_command(cmd, cargs)
        if args.format == "json":
            print(json.dumps(result, indent=2, default=str))
        else:
            _render(cmd, result)
        return 0
    except (RadosError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    finally:
        await rados.shutdown()


def _want(words: list[str], n: int, usage: str) -> None:
    if len(words) < n:
        raise ValueError(f"usage: ceph {usage}")


def _parse_command(words: list[str]) -> tuple[str, dict]:
    """Map CLI words onto monitor commands (MonCommands.h style)."""
    joined = " ".join(words)
    if joined == "status":
        return "status", {}
    if joined == "osd tree":
        return "osd tree", {}
    if joined == "osd dump":
        return "osd dump", {}
    if joined == "osd pool ls":
        return "osd pool ls", {}
    if words[:3] == ["osd", "pool", "create"]:
        _want(words, 4, "osd pool create <name> [pg_num] "
                        "[replicated|erasure [profile]]")
        args = {"name": words[3]}
        if len(words) > 4:
            args["pg_num"] = int(words[4])
        rest = words[5:]
        if rest and rest[0] in ("replicated", "erasure"):
            args["type"] = rest[0]
            if rest[0] == "erasure" and len(rest) > 1:
                args["erasure_code_profile"] = rest[1]
        return "osd pool create", args
    if words[:3] == ["osd", "pool", "rm"]:
        _want(words, 4, "osd pool rm <name>")
        return "osd pool rm", {"name": words[3]}
    if words[:2] == ["osd", "out"]:
        _want(words, 3, "osd out <id>")
        return "osd out", {"osd_id": int(words[2])}
    if words[:2] == ["osd", "in"]:
        _want(words, 3, "osd in <id>")
        return "osd in", {"osd_id": int(words[2])}
    if words[:3] == ["osd", "erasure-code-profile", "ls"]:
        return "osd erasure-code-profile ls", {}
    if words[:3] == ["osd", "erasure-code-profile", "get"]:
        _want(words, 4, "osd erasure-code-profile get <name>")
        return "osd erasure-code-profile get", {"name": words[3]}
    if words[:3] == ["osd", "erasure-code-profile", "set"]:
        _want(words, 4, "osd erasure-code-profile set <name> [k=v ...]")
        profile = {}
        for kv in words[4:]:
            k, _, v = kv.partition("=")
            profile[k] = v
        return ("osd erasure-code-profile set",
                {"name": words[3], "profile": profile})
    if words[0] == "health":
        return "health", ({"detail": True} if "detail" in words[1:]
                          else {})
    if words[:2] == ["config", "set"]:
        _want(words, 5, "config set <who> <name> <value>")
        return "config set", {"who": words[2], "name": words[3],
                              "value": words[4]}
    if words[:2] == ["config", "get"]:
        _want(words, 3, "config get <who>")
        return "config get", {"who": words[2]}
    if words[:2] == ["config", "rm"]:
        _want(words, 4, "config rm <who> <name>")
        return "config rm", {"who": words[2], "name": words[3]}
    if words[:2] == ["config", "dump"]:
        return "config dump", {}
    if words[:2] == ["auth", "get-or-create"]:
        _want(words, 3, "auth get-or-create <entity> [type=cap ...]")
        caps = {}
        for kv in words[3:]:
            k, _, v = kv.partition("=")
            caps[k] = v
        return "auth get-or-create", {"entity": words[2], "caps": caps}
    if words[:2] == ["auth", "get"]:
        _want(words, 3, "auth get <entity>")
        return "auth get", {"entity": words[2]}
    if words[:2] == ["auth", "ls"]:
        return "auth ls", {}
    if words[:2] == ["auth", "rm"]:
        _want(words, 3, "auth rm <entity>")
        return "auth rm", {"entity": words[2]}
    if words[:2] == ["log", "last"]:
        return "log last", ({"n": int(words[2])}
                            if len(words) > 2 else {})
    if words[0] == "log":
        _want(words, 2, "log <message...>")
        return "log", {"message": " ".join(words[1:])}
    raise ValueError(f"unknown command: {joined}")


def _render(cmd: str, result) -> None:
    if cmd == "status":
        print(f"  cluster epoch {result['epoch']}")
        print(f"  health: {result['health']}")
        print(f"  osd: {result['num_osds']} osds: "
              f"{result['num_up']} up, {result['num_in']} in")
        print(f"  pools: {result['pools']}")
    elif cmd == "osd tree":
        print(f"{'ID':>4} {'TYPE':<6} {'NAME':<12} {'STATUS':<8} WEIGHT")
        for row in result:
            if row["type"] == "host":
                print(f"{'':>4} {'host':<6} {row['name']:<12}")
            else:
                status = "up" if row["up"] else "down"
                print(f"{row['id']:>4} {'osd':<6} osd.{row['id']:<8} "
                      f"{status:<8} {row['weight']/65536:.4f}")
    elif isinstance(result, (list, tuple)):
        for item in result:
            print(item)
    else:
        print(json.dumps(result, indent=2, default=str))


async def _run_daemon_command(sock_path: str, words: list[str]) -> int:
    """`ceph daemon <sock> <cmd...>` — admin-socket introspection."""
    from ..common.admin_socket import admin_command
    kwargs = {}
    if words[:2] == ["config", "get"] and len(words) >= 3:
        words, kwargs = words[:2], {"name": words[2]}
    elif words[:2] == ["config", "set"] and len(words) >= 4:
        words, kwargs = words[:2], {"name": words[2], "value": words[3]}
    elif words[:1] == ["scrub"] and len(words) >= 2:
        kwargs = {"pgid": words[1],
                  "repair": "repair" in words[2:]}
        words = words[:1]
    try:
        result = await admin_command(sock_path, " ".join(words), **kwargs)
        print(json.dumps(result, indent=2, default=str))
        return 0
    except (RuntimeError, ConnectionError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="ceph")
    p.add_argument("-m", "--mon", default="127.0.0.1:6789")
    p.add_argument("-f", "--format", default="plain",
                   choices=["plain", "json"])
    p.add_argument("--device", default="cuda",
                   help="the client's device: cuda (the card) or cpu "
                        "(the kernels' plain versions)")
    p.add_argument("words", nargs="+")
    args = p.parse_args(argv)
    if args.words[0] == "daemon":
        if len(args.words) < 3:
            print("usage: ceph daemon <socket-path> <command...>",
                  file=sys.stderr)
            return 2
        return asyncio.run(
            _run_daemon_command(args.words[1], args.words[2:]))
    return asyncio.run(_run(args))


if __name__ == "__main__":
    sys.exit(main())
