"""cls_journal: atomic append-only journal bookkeeping.

The src/cls/journal/cls_journal.cc subset librbd journaling needs:
sequence allocation + entry append commit atomically in the OSD
(two writers cannot claim one sequence), registered CLIENTS record
their replay positions, and trim may only reclaim entries every
client has consumed.  Entries live in the journal object's omap as
``entry.<seq>`` (zero-padded so omap name order is replay order);
clients as ``client.<id>`` -> {"position": seq}.
"""

from __future__ import annotations

import json

from . import CLS_METHOD_RD, CLS_METHOD_WR, ClsError, register

_SEQ = "seq"                   # next sequence number
_ENTRY = "entry."
_CLIENT = "client."


def _ekey(seq: int) -> str:
    return f"{_ENTRY}{seq:016d}"


@register("journal", "append", CLS_METHOD_RD | CLS_METHOD_WR)
def append(hctx, indata: bytes) -> bytes:
    """Allocate the next sequence and store the entry in ONE op.
    indata: raw entry payload.  Returns the allocated seq as text."""
    if not hctx.exists():
        hctx.create(exclusive=False)
    try:
        seq = int(hctx.map_get_val(_SEQ))
    except ClsError:
        seq = 0
    hctx.map_set_val(_ekey(seq), indata)
    hctx.map_set_val(_SEQ, str(seq + 1).encode())
    return str(seq).encode()


@register("journal", "get_entries", CLS_METHOD_RD)
def get_entries(hctx, indata: bytes) -> bytes:
    """{after, max} -> {"entries": [[seq, hex-payload]...]}."""
    q = json.loads(indata or b"{}")
    after = int(q.get("after", -1))
    limit = int(q.get("max", 64))
    if not hctx.exists():
        return json.dumps({"entries": []}).encode()
    out = []
    start = _ekey(after) if after >= 0 else _ENTRY
    for k in hctx.map_get_keys(start_after=start, max_return=10000):
        if not k.startswith(_ENTRY):
            continue
        out.append([int(k[len(_ENTRY):]),
                    hctx.map_get_val(k).hex()])
        if len(out) >= limit:
            break
    return json.dumps({"entries": out}).encode()


@register("journal", "client_register", CLS_METHOD_RD | CLS_METHOD_WR)
def client_register(hctx, indata: bytes) -> bytes:
    q = json.loads(indata)
    if not hctx.exists():
        hctx.create(exclusive=False)
    key = _CLIENT + q["id"]
    try:
        return hctx.map_get_val(key)      # idempotent re-register
    except ClsError:
        pass
    state = {"id": q["id"], "position": int(q.get("position", -1))}
    hctx.map_set_val(key, json.dumps(state).encode())
    return json.dumps(state).encode()


@register("journal", "client_commit", CLS_METHOD_RD | CLS_METHOD_WR)
def client_commit(hctx, indata: bytes) -> bytes:
    """Advance a client's replay position (monotone)."""
    q = json.loads(indata)
    key = _CLIENT + q["id"]
    try:
        state = json.loads(hctx.map_get_val(key))
    except ClsError:
        raise ClsError("ENOENT", q["id"])
    state["position"] = max(state["position"], int(q["position"]))
    hctx.map_set_val(key, json.dumps(state).encode())
    return json.dumps(state).encode()


@register("journal", "client_list", CLS_METHOD_RD)
def client_list(hctx, indata: bytes) -> bytes:
    if not hctx.exists():
        return json.dumps([]).encode()
    out = [json.loads(v) for k, v in hctx.map_get_all().items()
           if k.startswith(_CLIENT)]
    return json.dumps(out).encode()


@register("journal", "client_unregister", CLS_METHOD_RD | CLS_METHOD_WR)
def client_unregister(hctx, indata: bytes) -> bytes:
    q = json.loads(indata)
    hctx.map_remove_key(_CLIENT + q["id"])
    return b""


@register("journal", "trim", CLS_METHOD_RD | CLS_METHOD_WR)
def trim(hctx, indata: bytes) -> bytes:
    """Reclaim entries every registered client has consumed.  With no
    clients nothing trims (an unwatched journal keeps history until a
    client registers or the feature is disabled)."""
    if not hctx.exists():
        return b"0"
    clients = [json.loads(hctx.map_get_val(k))
               for k in hctx.map_get_keys(start_after=_CLIENT[:-1],
                                          max_return=10000)
               if k.startswith(_CLIENT)]
    if not clients:
        return b"0"
    floor = min(c["position"] for c in clients)
    n = 0
    for k in hctx.map_get_keys(start_after=_ENTRY[:-1],
                               max_return=100000):
        if k.startswith(_ENTRY) and int(k[len(_ENTRY):]) <= floor:
            hctx.map_remove_key(k)
            n += 1
    return str(n).encode()


@register("journal", "get_seq", CLS_METHOD_RD)
def get_seq(hctx, indata: bytes) -> bytes:
    """Next sequence to be allocated (head = this - 1); payload-free."""
    if not hctx.exists():
        return b"0"
    try:
        return hctx.map_get_val(_SEQ)
    except ClsError:
        return b"0"
