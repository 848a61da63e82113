"""cls_version: object-version conditional updates.

Mirrors src/cls/version/cls_version.cc: a (ver, tag) pair in xattr
"cls_version"; readers can assert equality so read-modify-write cycles
detect concurrent writers (RGW bucket-index and metadata objects use
this as their optimistic concurrency control).
"""

from __future__ import annotations

import json
import os

from . import CLS_METHOD_RD, CLS_METHOD_WR, ClsError, register

_ATTR = "cls_version"


def _load(hctx) -> dict:
    try:
        return json.loads(hctx.getxattr(_ATTR))
    except ClsError:
        return {"ver": 0, "tag": ""}


def _bump(hctx, ver: dict) -> None:
    ver["tag"] = os.urandom(6).hex()
    hctx.setxattr(_ATTR, json.dumps(ver).encode())


@register("version", "set", CLS_METHOD_RD | CLS_METHOD_WR)
def set_op(hctx, indata: bytes) -> bytes:
    q = json.loads(indata or b"{}")
    _bump(hctx, {"ver": int(q["ver"]), "tag": ""})
    return b""


@register("version", "inc", CLS_METHOD_RD | CLS_METHOD_WR)
def inc_op(hctx, indata: bytes) -> bytes:
    ver = _load(hctx)
    ver["ver"] += 1
    _bump(hctx, ver)
    return b""


@register("version", "inc_conds", CLS_METHOD_RD | CLS_METHOD_WR)
def inc_conds_op(hctx, indata: bytes) -> bytes:
    """Increment only if the caller's (ver, tag) still matches."""
    q = json.loads(indata or b"{}")
    ver = _load(hctx)
    if int(q.get("ver", -1)) != ver["ver"] or \
            q.get("tag", "") != ver["tag"]:
        raise ClsError("ECANCELED", "version changed")
    ver["ver"] += 1
    _bump(hctx, ver)
    return b""


@register("version", "read", CLS_METHOD_RD)
def read_op(hctx, indata: bytes) -> bytes:
    return json.dumps(_load(hctx)).encode()


@register("version", "check_conds", CLS_METHOD_RD)
def check_conds_op(hctx, indata: bytes) -> bytes:
    q = json.loads(indata or b"{}")
    ver = _load(hctx)
    if int(q.get("ver", -1)) != ver["ver"] or \
            q.get("tag", "") != ver["tag"]:
        raise ClsError("ECANCELED", "version changed")
    return b""
