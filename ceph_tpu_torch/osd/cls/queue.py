"""cls_queue: a durable FIFO inside one object.

src/cls/queue/cls_queue.cc (rgw's persistent notification queues ride
cls_2pc_queue on top of it): enqueue appends entries under a
monotonic sequence, list pages from a marker in order, remove acks a
consumed prefix.
"""

from __future__ import annotations

import json

from . import CLS_METHOD_RD, CLS_METHOD_WR, ClsError, register

_SEQ = "\x01seq"


def _key(seq: int) -> str:
    return f"e{seq:020d}"


@register("queue", "enqueue", CLS_METHOD_RD | CLS_METHOD_WR)
def enqueue_op(hctx, indata: bytes) -> bytes:
    q = json.loads(indata or b"{}")
    try:
        seq = int(hctx.map_get_val(_SEQ))
    except ClsError:
        seq = 0
    for e in q["entries"]:
        seq += 1
        hctx.map_set_val(_key(seq), json.dumps(e).encode())
    hctx.map_set_val(_SEQ, str(seq).encode())
    return json.dumps({"tail": seq}).encode()


@register("queue", "list", CLS_METHOD_RD)
def list_op(hctx, indata: bytes) -> bytes:
    q = json.loads(indata or b"{}")
    max_n = int(q.get("max", 1000))
    out, last, truncated = [], q.get("marker", ""), False
    for k in hctx.map_get_keys(start_after=q.get("marker", ""),
                              max_return=1 << 62):
        if not k.startswith("e"):
            continue
        if len(out) >= max_n:
            truncated = True
            break
        out.append(json.loads(hctx.map_get_val(k)))
        last = k
    return json.dumps({"entries": out, "marker": last,
                       "truncated": truncated}).encode()


@register("queue", "remove", CLS_METHOD_RD | CLS_METHOD_WR)
def remove_op(hctx, indata: bytes) -> bytes:
    """Ack everything up to AND INCLUDING end_marker."""
    q = json.loads(indata or b"{}")
    end = q["end_marker"]
    n = 0
    for k in list(hctx.map_get_keys(max_return=1 << 62)):
        if k.startswith("e") and k <= end:
            hctx.map_remove_key(k)
            n += 1
    return json.dumps({"removed": n}).encode()
