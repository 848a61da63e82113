"""cls_log: time-indexed log entries in an object's omap.

src/cls/log/cls_log.cc: RGW's metadata/data logs append timestamped
entries; readers page through a time window with a resumable marker,
and trim removes a consumed window.  Keys sort by (timestamp, seq) so
the omap's order IS the time order.
"""

from __future__ import annotations

import json

from . import CLS_METHOD_RD, CLS_METHOD_WR, ClsError, register

_SEQ_KEY = "\x01seq"     # sorts before every timestamp key


def _key(ts: float, seq: int) -> str:
    return f"{int(ts * 1e6):020d}.{seq:010d}"


@register("log", "add", CLS_METHOD_RD | CLS_METHOD_WR)
def add_op(hctx, indata: bytes) -> bytes:
    q = json.loads(indata or b"{}")
    try:
        seq = int(hctx.map_get_val(_SEQ_KEY))
    except ClsError:
        seq = 0
    for e in q["entries"]:
        seq += 1
        ts = float(e.get("timestamp", hctx.current_time()))
        hctx.map_set_val(_key(ts, seq), json.dumps({
            "timestamp": ts, "section": e.get("section", ""),
            "name": e.get("name", ""),
            "data": e.get("data", "")}).encode())
    hctx.map_set_val(_SEQ_KEY, str(seq).encode())
    return b""


@register("log", "list", CLS_METHOD_RD)
def list_op(hctx, indata: bytes) -> bytes:
    q = json.loads(indata or b"{}")
    lo = _key(float(q.get("from", 0)), 0)
    # 'to' is EXCLUSIVE (cls_log window semantics): seq 0 at the bound
    # timestamp sorts before every real entry at that timestamp
    hi = _key(float(q["to"]), 0) if q.get("to") else "\x7f"
    marker = q.get("marker", "")
    max_n = int(q.get("max", 1000))
    out, last = [], ""
    for k in hctx.map_get_keys(start_after=marker or "",
                              max_return=1 << 62):
        if k == _SEQ_KEY or k < lo or k >= hi:
            continue
        if len(out) >= max_n:
            return json.dumps({"entries": out, "marker": last,
                               "truncated": True}).encode()
        out.append(json.loads(hctx.map_get_val(k)))
        last = k
    return json.dumps({"entries": out, "marker": last,
                       "truncated": False}).encode()


@register("log", "trim", CLS_METHOD_RD | CLS_METHOD_WR)
def trim_op(hctx, indata: bytes) -> bytes:
    q = json.loads(indata or b"{}")
    lo = _key(float(q.get("from", 0)), 0)
    hi = _key(float(q["to"]), 0) if q.get("to") else \
        (q.get("to_marker") or "\x7f")
    n = 0
    for k in list(hctx.map_get_keys(max_return=1 << 62)):
        if k != _SEQ_KEY and lo <= k < hi:
            hctx.map_remove_key(k)
            n += 1
    if n == 0:
        raise ClsError("ENODATA", "nothing to trim")
    return b""
