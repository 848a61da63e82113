"""cls_timeindex: a time-keyed index over opaque values.

src/cls/timeindex/cls_timeindex.cc (rgw sync uses it for its error
repo): entries keyed by (timestamp, key_suffix), listable as a time
window with marker paging, trimmable by range or marker.
"""

from __future__ import annotations

import json

from . import CLS_METHOD_RD, CLS_METHOD_WR, ClsError, register


def _key(ts: float, suffix: str) -> str:
    return f"{int(ts * 1e6):020d}_{suffix}"


@register("timeindex", "add", CLS_METHOD_RD | CLS_METHOD_WR)
def add_op(hctx, indata: bytes) -> bytes:
    q = json.loads(indata or b"{}")
    for e in q["entries"]:
        ts = float(e.get("timestamp", hctx.current_time()))
        hctx.map_set_val(_key(ts, e["key_suffix"]),
                         json.dumps(e.get("value", "")).encode())
    return b""


@register("timeindex", "list", CLS_METHOD_RD)
def list_op(hctx, indata: bytes) -> bytes:
    q = json.loads(indata or b"{}")
    lo = _key(float(q.get("from", 0)), "")
    # 'to' exclusive: the empty suffix sorts before any real entry at
    # that timestamp
    hi = _key(float(q["to"]), "") if q.get("to") else "\x7f"
    max_n = int(q.get("max", 1000))
    out, last = [], ""
    for k in hctx.map_get_keys(start_after=q.get("marker", ""),
                              max_return=1 << 62):
        if k < lo or k >= hi:
            continue
        if len(out) >= max_n:
            return json.dumps({"entries": out, "marker": last,
                               "truncated": True}).encode()
        ts_us, _, suffix = k.partition("_")
        out.append({"timestamp": int(ts_us) / 1e6,
                    "key_suffix": suffix,
                    "value": json.loads(hctx.map_get_val(k))})
        last = k
    return json.dumps({"entries": out, "marker": last,
                       "truncated": False}).encode()


@register("timeindex", "trim", CLS_METHOD_RD | CLS_METHOD_WR)
def trim_op(hctx, indata: bytes) -> bytes:
    q = json.loads(indata or b"{}")
    lo = q.get("from_marker") or _key(float(q.get("from", 0)), "")
    hi = q.get("to_marker") or (
        _key(float(q["to"]), "") if q.get("to") else "\x7f")
    n = 0
    for k in list(hctx.map_get_keys(max_return=1 << 62)):
        if lo <= k < hi:
            hctx.map_remove_key(k)
            n += 1
    if n == 0:
        raise ClsError("ENODATA", "nothing to trim")
    return b""
