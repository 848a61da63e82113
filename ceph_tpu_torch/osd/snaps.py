"""Self-managed snapshot machinery: SnapSets, clone naming, SnapMapper.

Semantics from the reference's snap stack: writes carry a SnapContext
(seq + existing snap ids, newest first); the first write to an object
after a newer snap clones the head (clone-on-write) and records the
clone in the object's SnapSet (PrimaryLogPG::make_writeable); snap
reads resolve through the SnapSet to the right clone; a reverse
snap->objects index (SnapMapper, src/osd/SnapMapper.h:339) drives
trimming when the mon marks a snap removed.

Clones are ordinary objects (replication, recovery and backfill move
them like any other), named with a reserved NUL-containing suffix no
client name can collide with.  SnapSets live in a per-PG omap object
rather than a head xattr so they survive head deletion (the reference
keeps a snapdir object for the same reason); both the SnapSet rows and
the SnapMapper rows are written via mutations inside the SAME log
entry as the data op, so replicas and recovery stay in lockstep.
"""

from __future__ import annotations

import json

SNAPSETS_OID = "_snapsets_"      # omap: head oid -> snapset json
SNAPMAPPER_OID = "_snapmapper_"  # omap: "<snap>/<head>" -> ""
CLONE_SEP = "\x00snap:"          # NUL cannot appear in client names
INTERNAL_OIDS = frozenset({SNAPSETS_OID, SNAPMAPPER_OID})


def clone_oid(oid: str, snapid: int) -> str:
    return f"{oid}{CLONE_SEP}{snapid:016x}"


def is_clone(oid: str) -> bool:
    return CLONE_SEP in oid


def clone_parent(oid: str) -> tuple[str, int]:
    head, _, sid = oid.rpartition(CLONE_SEP)
    return head, int(sid, 16)


def snapmapper_key(snapid: int, oid: str) -> str:
    return f"{snapid:016x}/{oid}"


def empty_snapset() -> dict:
    # seq: newest snap this object has seen (cloned for or created
    # under); clones: [[cloneid, [covered snap ids asc], size], ...]
    return {"seq": 0, "clones": []}


def load_snapset(store, coll: str, oid: str) -> dict:
    raw = store.omap_get(coll, SNAPSETS_OID).get(oid)
    if not raw:
        return empty_snapset()
    return json.loads(raw)


def resolve_read(ss: dict, snapid: int) -> int | None:
    """Which object serves a read at ``snapid``?

    Returns the clone id, 0 for the head, or None for "did not exist
    at that snap".  Clones ascend; the serving clone is the FIRST with
    cloneid >= snapid -- it froze the content that was live when the
    snap was taken.  A gap below the clone's covered range means the
    object was created after the snap (find_object_context snap
    resolution)."""
    for cid, covered, _size in sorted(ss.get("clones", [])):
        if cid >= snapid:
            return cid if covered and snapid >= min(covered) else None
    # head serves -- unless the object was born (or reborn) after the
    # snap was taken: born == seq at creation means every snap id <=
    # born predates the object
    return None if snapid <= ss.get("born", 0) else 0
