"""cls_rbd: RBD image header methods.

Mirrors src/cls/rbd/cls_rbd.cc: image metadata (size, order, features,
object_prefix), the snapshot table + snap context, parent/clone
linkage, and the rbd_directory / rbd_children registry objects.  All
state lives in the header object's omap, mutated server-side so
concurrent clients see atomic transitions (the reference's reason for
putting this in a class rather than client-side read-modify-write).

Encoding is JSON (this stack's wire idiom) rather than ceph denc.
"""

from __future__ import annotations

import json

from . import CLS_METHOD_RD, CLS_METHOD_WR, ClsError, register

# omap keys on the header object
K_META = "rbd_meta"                 # {size, order, object_prefix, features}
K_SNAPSEQ = "snap_seq"
K_SNAP = "snapshot_"                # snapshot_<id:016x> -> {name,size,protected}
K_PARENT = "parent"                 # {pool_id, image_id, snap_id, overlap}


def _meta(hctx) -> dict:
    try:
        return json.loads(hctx.map_get_val(K_META))
    except ClsError:
        raise ClsError("ENOENT", "not an rbd header")


def _snap_key(snap_id: int) -> str:
    return f"{K_SNAP}{int(snap_id):016x}"


def _snaps(hctx) -> list[tuple[int, dict]]:
    out = []
    for k, v in hctx.map_get_all().items():
        if k.startswith(K_SNAP):
            out.append((int(k[len(K_SNAP):], 16), json.loads(v)))
    return sorted(out)


@register("rbd", "create", CLS_METHOD_RD | CLS_METHOD_WR)
def create(hctx, indata: bytes) -> bytes:
    q = json.loads(indata)
    if hctx.exists():
        raise ClsError("EEXIST")
    order = int(q.get("order", 22))
    if not 12 <= order <= 26:
        raise ClsError("EINVAL", f"order {order} out of range")
    hctx.create(exclusive=True)
    hctx.map_set_vals({
        K_META: json.dumps({
            "size": int(q["size"]), "order": order,
            "object_prefix": q["object_prefix"],
            "features": q.get("features", ["layering"]),
            "stripe_unit": int(q.get("stripe_unit", 1 << order)),
            "stripe_count": int(q.get("stripe_count", 1)),
        }).encode(),
        K_SNAPSEQ: b"0",
    })
    return b""


@register("rbd", "copyup", CLS_METHOD_RD | CLS_METHOD_WR)
def copyup_op(hctx, indata: bytes) -> bytes:
    """Materialize an object ONLY if it does not exist yet
    (cls_rbd copyup): the atomic exists-check-and-write that lets a
    migration/flatten copier race live client writes safely -- whoever
    creates the object first wins, the loser no-ops."""
    if hctx.exists():
        return b""
    if indata:
        hctx.write_full(bytes(indata))
    else:
        hctx.create(exclusive=False)
    return b""


@register("rbd", "get_image_meta", CLS_METHOD_RD)
def get_image_meta(hctx, indata: bytes) -> bytes:
    meta = _meta(hctx)
    meta["snap_seq"] = int(hctx.map_get_val(K_SNAPSEQ))
    meta["snapshots"] = [
        {"id": sid, **s} for sid, s in _snaps(hctx)]
    try:
        meta["parent"] = json.loads(hctx.map_get_val(K_PARENT))
    except ClsError:
        meta["parent"] = None
    return json.dumps(meta).encode()


@register("rbd", "set_size", CLS_METHOD_RD | CLS_METHOD_WR)
def set_size(hctx, indata: bytes) -> bytes:
    q = json.loads(indata)
    meta = _meta(hctx)
    meta["size"] = int(q["size"])
    hctx.map_set_val(K_META, json.dumps(meta).encode())
    return b""


@register("rbd", "snapshot_add", CLS_METHOD_RD | CLS_METHOD_WR)
def snapshot_add(hctx, indata: bytes) -> bytes:
    q = json.loads(indata)
    sid = int(q["snap_id"])
    meta = _meta(hctx)
    seq = int(hctx.map_get_val(K_SNAPSEQ))
    if sid <= seq:
        raise ClsError("ESTALE", "snap id not newer than snap_seq")
    for _, s in _snaps(hctx):
        if s["name"] == q["name"]:
            raise ClsError("EEXIST", q["name"])
    hctx.map_set_vals({
        _snap_key(sid): json.dumps({
            "name": q["name"], "size": meta["size"],
            "protected": False}).encode(),
        K_SNAPSEQ: str(sid).encode(),
    })
    return b""


@register("rbd", "snapshot_remove", CLS_METHOD_RD | CLS_METHOD_WR)
def snapshot_remove(hctx, indata: bytes) -> bytes:
    q = json.loads(indata)
    sid = int(q["snap_id"])
    try:
        s = json.loads(hctx.map_get_val(_snap_key(sid)))
    except ClsError:
        raise ClsError("ENOENT", f"snap {sid}")
    if s.get("protected"):
        raise ClsError("EBUSY", "snap is protected")
    hctx.map_remove_key(_snap_key(sid))
    return b""


@register("rbd", "snapshot_protect", CLS_METHOD_RD | CLS_METHOD_WR)
def snapshot_protect(hctx, indata: bytes) -> bytes:
    return _set_protect(hctx, indata, True)


@register("rbd", "snapshot_unprotect", CLS_METHOD_RD | CLS_METHOD_WR)
def snapshot_unprotect(hctx, indata: bytes) -> bytes:
    return _set_protect(hctx, indata, False)


def _set_protect(hctx, indata: bytes, value: bool) -> bytes:
    q = json.loads(indata)
    key = _snap_key(int(q["snap_id"]))
    try:
        s = json.loads(hctx.map_get_val(key))
    except ClsError:
        raise ClsError("ENOENT")
    s["protected"] = value
    hctx.map_set_val(key, json.dumps(s).encode())
    return b""


@register("rbd", "get_snapcontext", CLS_METHOD_RD)
def get_snapcontext(hctx, indata: bytes) -> bytes:
    seq = int(hctx.map_get_val(K_SNAPSEQ))
    snaps = sorted((sid for sid, _ in _snaps(hctx)), reverse=True)
    return json.dumps({"seq": seq, "snaps": snaps}).encode()


@register("rbd", "set_parent", CLS_METHOD_RD | CLS_METHOD_WR)
def set_parent(hctx, indata: bytes) -> bytes:
    q = json.loads(indata)
    try:
        hctx.map_get_val(K_PARENT)
        raise ClsError("EEXIST", "parent already set")
    except ClsError as e:
        if e.errno_name == "EEXIST":
            raise
    hctx.map_set_val(K_PARENT, json.dumps({
        "pool_id": int(q["pool_id"]), "image_id": q["image_id"],
        "snap_id": int(q["snap_id"]),
        "overlap": int(q["overlap"])}).encode())
    return b""


@register("rbd", "get_parent", CLS_METHOD_RD)
def get_parent(hctx, indata: bytes) -> bytes:
    try:
        return hctx.map_get_val(K_PARENT)
    except ClsError:
        return json.dumps(None).encode()


@register("rbd", "remove_parent", CLS_METHOD_RD | CLS_METHOD_WR)
def remove_parent(hctx, indata: bytes) -> bytes:
    try:
        hctx.map_get_val(K_PARENT)
    except ClsError:
        raise ClsError("ENOENT", "no parent")
    hctx.map_remove_key(K_PARENT)
    return b""


# -- rbd_directory (name <-> id registry object) ----------------------------

@register("rbd", "dir_add_image", CLS_METHOD_RD | CLS_METHOD_WR)
def dir_add_image(hctx, indata: bytes) -> bytes:
    q = json.loads(indata)
    name, iid = q["name"], q["id"]
    if f"name_{name}" in hctx.map_get_all():
        raise ClsError("EEXIST", name)
    hctx.map_set_vals({f"name_{name}": iid.encode(),
                       f"id_{iid}": name.encode()})
    return b""


@register("rbd", "dir_remove_image", CLS_METHOD_RD | CLS_METHOD_WR)
def dir_remove_image(hctx, indata: bytes) -> bytes:
    q = json.loads(indata)
    name = q["name"]
    try:
        iid = hctx.map_get_val(f"name_{name}").decode()
    except ClsError:
        raise ClsError("ENOENT", name)
    hctx.map_remove_key(f"name_{name}")
    hctx.map_remove_key(f"id_{iid}")
    return b""


@register("rbd", "dir_get_id", CLS_METHOD_RD)
def dir_get_id(hctx, indata: bytes) -> bytes:
    q = json.loads(indata)
    try:
        return hctx.map_get_val(f"name_{q['name']}")
    except ClsError:
        raise ClsError("ENOENT", q["name"])


@register("rbd", "dir_list", CLS_METHOD_RD)
def dir_list(hctx, indata: bytes) -> bytes:
    if not hctx.exists():
        return json.dumps({}).encode()
    out = {k[5:]: v.decode() for k, v in hctx.map_get_all().items()
           if k.startswith("name_")}
    return json.dumps(out).encode()


# -- rbd_children (parent (pool,image,snap) -> child ids) -------------------

def _child_key(q: dict) -> str:
    return (f"{int(q['pool_id'])}_{q['image_id']}_"
            f"{int(q['snap_id']):016x}")


@register("rbd", "add_child", CLS_METHOD_RD | CLS_METHOD_WR)
def add_child(hctx, indata: bytes) -> bytes:
    q = json.loads(indata)
    key = _child_key(q)
    try:
        kids = json.loads(hctx.map_get_val(key))
    except ClsError:
        kids = []
    if q["child_id"] not in kids:
        kids.append(q["child_id"])
    if not hctx.exists():
        hctx.create(exclusive=False)
    hctx.map_set_val(key, json.dumps(kids).encode())
    return b""


@register("rbd", "remove_child", CLS_METHOD_RD | CLS_METHOD_WR)
def remove_child(hctx, indata: bytes) -> bytes:
    q = json.loads(indata)
    key = _child_key(q)
    try:
        kids = json.loads(hctx.map_get_val(key))
    except ClsError:
        raise ClsError("ENOENT")
    if q["child_id"] in kids:
        kids.remove(q["child_id"])
    if kids:
        hctx.map_set_val(key, json.dumps(kids).encode())
    else:
        hctx.map_remove_key(key)
    return b""


@register("rbd", "list_children", CLS_METHOD_RD)
def list_children(hctx, indata: bytes) -> bytes:
    q = json.loads(indata)
    if not hctx.exists():
        return json.dumps([]).encode()
    try:
        return hctx.map_get_val(_child_key(q))
    except ClsError:
        return json.dumps([]).encode()
