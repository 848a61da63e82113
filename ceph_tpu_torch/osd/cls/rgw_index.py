"""cls_rgw (bucket index subset): atomic bucket-index maintenance.

Mirrors the src/cls/rgw/cls_rgw.cc bucket-index ops the gateway's
write path uses: ``prepare`` marks an in-flight op on the key,
``complete`` commits the entry (or removes it for a delete) and drops
the pending marker, ``unlink`` removes an entry, ``list`` pages
entries.  Index entries live in the bucket index object's omap keyed
by object name, so concurrent gateway instances get atomic
read-modify-write through the OSD rather than racing client-side
(the reason the reference keeps the index in a class).
"""

from __future__ import annotations

import json

from . import CLS_METHOD_RD, CLS_METHOD_WR, ClsError, register

_ENTRY = "idx_"          # idx_<object key> -> entry json (current)
_PENDING = "pend_"       # pend_<tag> -> {key, op}
# versioned buckets (cls_rgw's bucket index versioning ops): every
# version of a key lives at vidx_<key>\x00<inverted stamp> so the
# omap's name order lists versions newest-first per key; the idx_
# entry stays the CURRENT pointer (possibly a delete marker)
_VENTRY = "vidx_"


def _vkey(key: str, version_id: str) -> str:
    return f"{_VENTRY}{key}\x00{version_id}"


@register("rgw_index", "prepare", CLS_METHOD_RD | CLS_METHOD_WR)
def prepare(hctx, indata: bytes) -> bytes:
    q = json.loads(indata)
    if not hctx.exists():
        hctx.create(exclusive=False)
    hctx.map_set_val(_PENDING + q["tag"], json.dumps(
        {"key": q["key"], "op": q.get("op", "put")}).encode())
    return b""


@register("rgw_index", "complete", CLS_METHOD_RD | CLS_METHOD_WR)
def complete(hctx, indata: bytes) -> bytes:
    q = json.loads(indata)
    tag = q.get("tag")
    if tag is not None:
        try:
            hctx.map_get_val(_PENDING + tag)
            hctx.map_remove_key(_PENDING + tag)
        except ClsError:
            raise ClsError("ECANCELED", "no pending op for tag")
    # the REPLACED entry is returned so the gateway can reclaim its
    # backing data: purging by a client-side pre-read races a
    # concurrent PUT (two writers each pre-read the same old entry and
    # the losing generation's data leaks); the swap must be decided by
    # the atomic op itself (cls_rgw.cc returns the existing dir entry
    # to the completing gateway for the same reason)
    try:
        replaced = hctx.map_get_val(_ENTRY + q["key"])
    except ClsError:
        replaced = b""
    if q.get("op") == "del":
        if not replaced:
            raise ClsError("ENOENT", q["key"])
        hctx.map_remove_key(_ENTRY + q["key"])
    else:
        hctx.map_set_val(_ENTRY + q["key"],
                         json.dumps(q["entry"]).encode())
    return replaced


@register("rgw_index", "unlink", CLS_METHOD_RD | CLS_METHOD_WR)
def unlink(hctx, indata: bytes) -> bytes:
    q = json.loads(indata)
    try:
        removed = hctx.map_get_val(_ENTRY + q["key"])
    except ClsError:
        raise ClsError("ENOENT", q["key"])
    hctx.map_remove_key(_ENTRY + q["key"])
    return removed          # caller reclaims exactly what was unlinked


@register("rgw_index", "get", CLS_METHOD_RD)
def get(hctx, indata: bytes) -> bytes:
    q = json.loads(indata)
    try:
        return hctx.map_get_val(_ENTRY + q["key"])
    except ClsError:
        raise ClsError("ENOENT", q["key"])


@register("rgw_index", "list", CLS_METHOD_RD)
def list_entries(hctx, indata: bytes) -> bytes:
    """Paged listing: {prefix, marker, max} ->
    {entries: [[key, entry], ...], truncated}."""
    q = json.loads(indata or b"{}")
    prefix = q.get("prefix", "")
    marker = q.get("marker", "")
    limit = int(q.get("max", 1000))
    if not hctx.exists():
        return json.dumps({"entries": [], "truncated": False}).encode()
    all_kv = hctx.map_get_all()
    entries = []
    truncated = False
    for k in sorted(all_kv):
        if not k.startswith(_ENTRY):
            continue
        name = k[len(_ENTRY):]
        if not name.startswith(prefix) or name <= marker:
            continue
        e = json.loads(all_kv[k])
        if e.get("delete_marker"):
            continue
        if len(entries) >= limit:
            truncated = True          # one survivor past the page
            break
        entries.append([name, e])
    return json.dumps({"entries": entries,
                       "truncated": truncated}).encode()


@register("rgw_index", "dir_link", CLS_METHOD_RD | CLS_METHOD_WR)
def dir_link(hctx, indata: bytes) -> bytes:
    """Atomic registry insert (bucket directory): fails EEXIST unless
    the existing value's owner matches (idempotent re-create).  The
    check and the write commit in one op -- client-side
    read-modify-write would let two gateways each claim the name."""
    q = json.loads(indata)
    if not hctx.exists():
        hctx.create(exclusive=False)
    try:
        cur = json.loads(hctx.map_get_val("dir_" + q["name"]))
        if cur.get("owner") != q["meta"].get("owner"):
            raise ClsError("EEXIST", q["name"])
        return json.dumps(cur).encode()
    except ClsError as e:
        if e.errno_name == "EEXIST":
            raise
    hctx.map_set_val("dir_" + q["name"],
                     json.dumps(q["meta"]).encode())
    return json.dumps(q["meta"]).encode()


@register("rgw_index", "dir_unlink", CLS_METHOD_RD | CLS_METHOD_WR)
def dir_unlink(hctx, indata: bytes) -> bytes:
    q = json.loads(indata)
    try:
        hctx.map_get_val("dir_" + q["name"])
    except ClsError:
        raise ClsError("ENOENT", q["name"])
    hctx.map_remove_key("dir_" + q["name"])
    return b""


@register("rgw_index", "dir_list", CLS_METHOD_RD)
def rgw_dir_list(hctx, indata: bytes) -> bytes:
    if not hctx.exists():
        return json.dumps({}).encode()
    out = {k[4:]: json.loads(v) for k, v in hctx.map_get_all().items()
           if k.startswith("dir_")}
    return json.dumps(out).encode()


@register("rgw_index", "stats", CLS_METHOD_RD)
def stats(hctx, indata: bytes) -> bytes:
    if not hctx.exists():
        return json.dumps({"count": 0, "bytes": 0}).encode()
    count = tot = 0
    for k, v in hctx.map_get_all().items():
        if k.startswith(_ENTRY):
            e = json.loads(v)
            if e.get("delete_marker"):
                continue
            count += 1
            tot += e.get("size", 0)
    return json.dumps({"count": count, "bytes": tot}).encode()


@register("rgw_index", "version_put", CLS_METHOD_RD | CLS_METHOD_WR)
def version_put(hctx, indata: bytes) -> bytes:
    """Link a NEW version of a key atomically: store the version
    entry, flip the current pointer.  versioning=suspended reuses the
    "null" version id and DISPLACES the previous null version (its
    entry is returned for data reclaim, as `complete` does); enabled
    displaces nothing (old versions stay readable)."""
    q = json.loads(indata)
    key = q["key"]
    entry = q["entry"]
    displaced = b""
    try:
        cur_raw = hctx.map_get_val(_ENTRY + key)
        cur = json.loads(cur_raw)
    except ClsError:
        cur_raw, cur = b"", None
    unversioned_cur = cur is not None and "version_id" not in cur
    if q.get("suspended"):
        entry["version_id"] = "null"
        try:
            displaced = hctx.map_get_val(_vkey(key, "null"))
        except ClsError:
            # only a true UNVERSIONED-era entry is displaced; an
            # enabled-era version must stay readable (its vidx_ row
            # still references the data)
            displaced = cur_raw if unversioned_cur else b""
    elif unversioned_cur:
        # enabling versioning over an unversioned object: S3 preserves
        # it as the "null" version, not as silent loss
        cur["version_id"] = "null"
        hctx.map_set_val(_vkey(key, "null"),
                         json.dumps(cur).encode())
    blob = json.dumps(entry).encode()
    hctx.map_set_val(_vkey(key, entry["version_id"]), blob)
    hctx.map_set_val(_ENTRY + key, blob)
    return displaced


@register("rgw_index", "version_rm", CLS_METHOD_RD | CLS_METHOD_WR)
def version_rm(hctx, indata: bytes) -> bytes:
    """Remove ONE version permanently; if it was the current pointer,
    the next-newest surviving version becomes current (or the key
    vanishes).  Returns the removed entry for data reclaim."""
    q = json.loads(indata)
    key, vid = q["key"], q["version_id"]
    try:
        removed = hctx.map_get_val(_vkey(key, vid))
    except ClsError:
        raise ClsError("ENOENT", f"{key}?versionId={vid}")
    hctx.map_remove_key(_vkey(key, vid))
    try:
        cur = json.loads(hctx.map_get_val(_ENTRY + key))
    except ClsError:
        cur = None
    if cur is not None and cur.get("version_id") == vid:
        pre = _VENTRY + key + "\x00"
        all_kv = hctx.map_get_all()
        survivors = [json.loads(v) for k, v in all_kv.items()
                     if k.startswith(pre)]
        if survivors:
            # next-newest survivor: mtime first (second granularity),
            # then the stamp INSIDE the version id (ids are inverted
            # ns stamps, so plain lexicographic order would resurrect
            # the OLDEST version); "null" ids sort oldest among ties
            def recency(e):
                vid = e.get("version_id", "")
                try:
                    ns = (1 << 64) - int(vid[:16], 16)
                except ValueError:
                    ns = -1
                return (e.get("mtime", ""), ns)
            best = max(survivors, key=recency)
            hctx.map_set_val(_ENTRY + key, json.dumps(best).encode())
        else:
            hctx.map_remove_key(_ENTRY + key)
    return removed


@register("rgw_index", "version_list", CLS_METHOD_RD)
def version_list(hctx, indata: bytes) -> bytes:
    """Paged listing of versions: {prefix, marker, max} ->
    {versions: [[key, version_id, entry, is_latest]...], truncated}."""
    q = json.loads(indata or b"{}")
    prefix = q.get("prefix", "")
    marker = q.get("marker", "")
    limit = int(q.get("max", 1000))
    if not hctx.exists():
        return json.dumps({"versions": [], "truncated": False}).encode()
    all_kv = hctx.map_get_all()
    currents = {}
    for k, v in all_kv.items():
        if k.startswith(_ENTRY):
            currents[k[len(_ENTRY):]] = json.loads(v).get("version_id")
    page = []
    truncated = False
    for k in sorted(all_kv):
        if not k.startswith(_VENTRY):
            continue
        name, _, vid = k[len(_VENTRY):].partition("\x00")
        if not name.startswith(prefix) or k[len(_VENTRY):] <= marker:
            continue
        if len(page) >= limit:
            truncated = True
            break
        entry = json.loads(all_kv[k])
        page.append([name, vid, entry, currents.get(name) == vid])
    return json.dumps({"versions": page,
                       "truncated": truncated,
                       "next_marker": (f"{page[-1][0]}\x00{page[-1][1]}"
                                       if page else "")}).encode()


@register("rgw_index", "get_version", CLS_METHOD_RD)
def get_version(hctx, indata: bytes) -> bytes:
    q = json.loads(indata)
    try:
        return hctx.map_get_val(_vkey(q["key"], q["version_id"]))
    except ClsError:
        raise ClsError("ENOENT", q["key"])


@register("rgw_index", "dir_set", CLS_METHOD_RD | CLS_METHOD_WR)
def dir_set(hctx, indata: bytes) -> bytes:
    """Merge fields into a directory entry's meta atomically (bucket
    versioning state, lifecycle config)."""
    q = json.loads(indata)
    try:
        cur = json.loads(hctx.map_get_val("dir_" + q["name"]))
    except ClsError:
        raise ClsError("ENOENT", q["name"])
    cur.update(q["patch"])
    hctx.map_set_val("dir_" + q["name"], json.dumps(cur).encode())
    return json.dumps(cur).encode()
