"""cls_user: per-user bucket registry + usage accounting.

src/cls/user/cls_user.cc: RGW keeps each user's bucket list and
aggregate stats (size/object counts) in a user object's omap, mutated
atomically at the OSD as buckets come, go, and grow.
"""

from __future__ import annotations

import json

from . import CLS_METHOD_RD, CLS_METHOD_WR, ClsError, register

_PREFIX = "bucket:"


def _get(hctx, bucket: str) -> dict | None:
    try:
        return json.loads(hctx.map_get_val(_PREFIX + bucket))
    except ClsError:
        return None


@register("user", "set_buckets_info", CLS_METHOD_RD | CLS_METHOD_WR)
def set_buckets_op(hctx, indata: bytes) -> bytes:
    q = json.loads(indata or b"{}")
    for e in q["entries"]:
        cur = _get(hctx, e["bucket"]) or {"bucket": e["bucket"],
                                          "size": 0, "count": 0,
                                          "creation_time": 0}
        if q.get("add"):
            cur["size"] += int(e.get("size", 0))
            cur["count"] += int(e.get("count", 0))
        else:
            cur["size"] = int(e.get("size", cur["size"]))
            cur["count"] = int(e.get("count", cur["count"]))
        if e.get("creation_time"):
            cur["creation_time"] = e["creation_time"]
        hctx.map_set_val(_PREFIX + e["bucket"],
                         json.dumps(cur).encode())
    return b""


@register("user", "remove_bucket", CLS_METHOD_RD | CLS_METHOD_WR)
def remove_bucket_op(hctx, indata: bytes) -> bytes:
    q = json.loads(indata or b"{}")
    if _get(hctx, q["bucket"]) is None:
        raise ClsError("ENOENT", q["bucket"])
    hctx.map_remove_key(_PREFIX + q["bucket"])
    return b""


@register("user", "list_buckets", CLS_METHOD_RD)
def list_buckets_op(hctx, indata: bytes) -> bytes:
    q = json.loads(indata or b"{}")
    max_n = int(q.get("max", 1000))
    marker = q.get("marker", "")
    out, last, truncated = [], "", False
    for k in hctx.map_get_keys(
            start_after=(_PREFIX + marker) if marker else "",
            max_return=1 << 62):
        if not k.startswith(_PREFIX):
            continue
        if len(out) >= max_n:
            truncated = True
            break
        out.append(json.loads(hctx.map_get_val(k)))
        last = k[len(_PREFIX):]
    return json.dumps({"entries": out, "marker": last,
                       "truncated": truncated}).encode()


@register("user", "get_header", CLS_METHOD_RD)
def get_header_op(hctx, indata: bytes) -> bytes:
    total_size = total_count = buckets = 0
    for k in hctx.map_get_keys(max_return=1 << 62):
        if k.startswith(_PREFIX):
            e = json.loads(hctx.map_get_val(k))
            total_size += e["size"]
            total_count += e["count"]
            buckets += 1
    return json.dumps({"stats": {"size": total_size,
                                 "count": total_count},
                       "buckets": buckets}).encode()
