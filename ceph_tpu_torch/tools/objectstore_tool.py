"""ceph-objectstore-tool analog: offline surgery on an OSD's store.

Operates directly on a DBStore SQLite file (the OSD must be down, as
the reference requires):

    python -m ceph_tpu_torch.tools.objectstore_tool --data-path osd0.db \
        --op list [--pgid 1.2]
    ... --op info --pgid 1.2 --oid obj1       # size/attrs/omap summary
    ... --op dump --pgid 1.2 --oid obj1       # full object json (data hex)
    ... --op export --pgid 1.2 --file pg.export
    ... --op import --file pg.export          # restore a PG's objects
    ... --op remove --pgid 1.2 --oid obj1
    ... --op meta --pgid 1.2                  # decode the PG's denc meta

Port of ``ceph_tpu/tools/objectstore_tool.py``, with the same ops and
output over the port's ``DBStore``.
"""

from __future__ import annotations

import argparse
import json
import sys

from ..os.store import DBStore
from ..os.transaction import Transaction


def _coll(pgid: str) -> str:
    return f"pg_{pgid}"


def op_list(store, pgid: str | None) -> int:
    for coll in sorted(store.list_collections()):
        if pgid and coll != _coll(pgid):
            continue
        for oid in sorted(store.list_objects(coll)):
            print(json.dumps([coll.removeprefix("pg_"), oid]))
    return 0


def _object_record(store, coll: str, oid: str) -> dict:
    data = store.read(coll, oid)
    return {
        "oid": oid,
        "size": len(data),
        "data": data.hex(),
        "attrs": {k: v.hex() for k, v in store.getattrs(coll,
                                                        oid).items()},
        "omap": {k: v.hex() for k, v in store.omap_get(coll,
                                                       oid).items()},
    }


def op_info(store, pgid: str, oid: str, full: bool) -> int:
    rec = _object_record(store, _coll(pgid), oid)
    if not full:
        rec = {"oid": rec["oid"], "size": rec["size"],
               "attrs": sorted(rec["attrs"]),
               "omap_keys": sorted(rec["omap"])}
    print(json.dumps(rec, indent=1))
    return 0


def op_export(store, pgid: str, path: str) -> int:
    coll = _coll(pgid)
    out = {"pgid": pgid,
           "objects": [_object_record(store, coll, oid)
                       for oid in sorted(store.list_objects(coll))]}
    blob = json.dumps(out).encode()
    if path == "-":
        sys.stdout.buffer.write(blob)
    else:
        with open(path, "wb") as f:
            f.write(blob)
    print(f"exported {len(out['objects'])} objects from pg {pgid}",
          file=sys.stderr)
    return 0


def op_import(store, path: str) -> int:
    raw = sys.stdin.buffer.read() if path == "-" \
        else open(path, "rb").read()
    dump = json.loads(raw)
    coll = _coll(dump["pgid"])
    txn = Transaction()
    if not store.collection_exists(coll):
        txn.create_collection(coll)
    for rec in dump["objects"]:
        oid = rec["oid"]
        txn.remove(coll, oid)
        txn.touch(coll, oid)
        txn.write(coll, oid, 0, bytes.fromhex(rec["data"]))
        for k, v in rec["attrs"].items():
            txn.setattr(coll, oid, k, bytes.fromhex(v))
        omap = {k: bytes.fromhex(v) for k, v in rec["omap"].items()}
        if omap:
            txn.omap_setkeys(coll, oid, omap)
    store.queue_transaction(txn)
    print(f"imported {len(dump['objects'])} objects into "
          f"pg {dump['pgid']}", file=sys.stderr)
    return 0


def op_remove(store, pgid: str, oid: str) -> int:
    txn = Transaction()
    txn.remove(_coll(pgid), oid)
    store.queue_transaction(txn)
    print(f"removed {pgid}/{oid}", file=sys.stderr)
    return 0


def op_meta(store, pgid: str) -> int:
    from ..common.denc import Decoder
    from ..osd.backend import META_OID
    from ..osd.pg_log import PGLog
    from ..osd.types import MissingSet, PGInfo
    omap = store.omap_get(_coll(pgid), META_OID)
    out = {}
    if "info" in omap:
        out["info"] = PGInfo.dedenc(Decoder(omap["info"])).to_dict()
    entry_keys = sorted(k for k in omap if k.startswith("log."))
    if entry_keys:
        # per-entry format: one omap key per entry, bounds in
        # "logmeta" (tail/head as EVersion lists)
        head = tail = [0, 0]
        if "logmeta" in omap:
            tail, head = json.loads(omap["logmeta"])
        out["log"] = {"head": list(head), "tail": list(tail),
                      "entries": len(entry_keys)}
    elif "log" in omap:
        log = PGLog.dedenc(Decoder(omap["log"]))
        out["log"] = {"head": log.head.to_list(),
                      "tail": log.tail.to_list(),
                      "entries": len(log.entries)}
    if "missing" in omap:
        out["missing"] = MissingSet.dedenc(
            Decoder(omap["missing"])).to_dict()
    print(json.dumps(out, indent=1))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ceph-objectstore-tool")
    p.add_argument("--data-path", required=True,
                   help="DBStore sqlite file (daemon must be down)")
    p.add_argument("--op", required=True,
                   choices=["list", "info", "dump", "export", "import",
                            "remove", "meta"])
    p.add_argument("--pgid")
    p.add_argument("--oid")
    p.add_argument("--file", default="-")
    args = p.parse_args(argv)
    store = DBStore(args.data_path)
    store.mount()
    need_pg = {"info", "dump", "export", "remove", "meta"}
    if args.op in need_pg and not args.pgid:
        p.error(f"--op {args.op} requires --pgid")
    if args.op in ("info", "dump", "remove") and not args.oid:
        p.error(f"--op {args.op} requires --oid")
    if args.op == "list":
        return op_list(store, args.pgid)
    if args.op == "info":
        return op_info(store, args.pgid, args.oid, full=False)
    if args.op == "dump":
        return op_info(store, args.pgid, args.oid, full=True)
    if args.op == "export":
        return op_export(store, args.pgid, args.file)
    if args.op == "import":
        return op_import(store, args.file)
    if args.op == "remove":
        return op_remove(store, args.pgid, args.oid)
    if args.op == "meta":
        return op_meta(store, args.pgid)
    return 2


if __name__ == "__main__":
    sys.exit(main())
