"""ceph-monstore-tool analog: offline monitor store inspection.

Operates on a MonStore SQLite file (mon down):

    python -m ceph_tpu_torch.tools.monstore_tool mon.db dump-versions
    python -m ceph_tpu_torch.tools.monstore_tool mon.db get-version 7
    python -m ceph_tpu_torch.tools.monstore_tool mon.db get-osdmap
    python -m ceph_tpu_torch.tools.monstore_tool mon.db show-kv

Port of ``ceph_tpu/tools/monstore_tool.py``, with the same commands and
output.  ``get-osdmap`` replays the log into an ``OSDMap`` and prints its
dict; it builds no placement table, so it needs no card: ``osdmaptool
--device`` maps the map it prints.
"""

from __future__ import annotations

import argparse
import json
import sqlite3
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ceph-monstore-tool")
    p.add_argument("store", help="MonStore sqlite file")
    p.add_argument("cmd", choices=["dump-versions", "get-version",
                                   "get-osdmap", "show-kv"])
    p.add_argument("arg", nargs="?")
    args = p.parse_args(argv)
    conn = sqlite3.connect(args.store)

    if args.cmd == "dump-versions":
        rows = conn.execute(
            "SELECT version, LENGTH(value) FROM log ORDER BY version"
        ).fetchall()
        for v, n in rows:
            print(f"version {v}\t{n} bytes")
        print(f"last_committed: {rows[-1][0] if rows else 0}")
        return 0

    if args.cmd == "get-version":
        if not args.arg:
            p.error("get-version requires a version number")
        row = conn.execute("SELECT value FROM log WHERE version=?",
                           (int(args.arg),)).fetchone()
        if row is None:
            print(f"no such version {args.arg}", file=sys.stderr)
            return 1
        print(json.dumps(json.loads(row[0]), indent=1))
        return 0

    if args.cmd == "get-osdmap":
        # replay the full committed log into the final map, exactly as
        # the mon does at boot (usable as osdmaptool input)
        from ..mon.osdmap import Incremental, OSDMap
        m = OSDMap()
        for (blob,) in conn.execute(
                "SELECT value FROM log ORDER BY version"):
            m.apply_incremental(Incremental.from_dict(json.loads(blob)))
        print(json.dumps(m.to_dict(), indent=1))
        return 0

    if args.cmd == "show-kv":
        for k, v in conn.execute("SELECT key, value FROM kv ORDER BY key"):
            print(f"{k}\t{len(v)} bytes")
        return 0
    return 2


if __name__ == "__main__":
    sys.exit(main())
