"""cls_refcount: tag-based object refcounting.

Mirrors src/cls/refcount/cls_refcount.cc: a set of string tags lives
in xattr "refcount"; ``put`` on the last tag removes the object
(RGW uses this to share tail objects between copies).
"""

from __future__ import annotations

import json

from . import CLS_METHOD_RD, CLS_METHOD_WR, ClsError, register

_ATTR = "refcount"


def _load(hctx) -> list[str]:
    try:
        return json.loads(hctx.getxattr(_ATTR))
    except ClsError:
        return []


@register("refcount", "get", CLS_METHOD_RD | CLS_METHOD_WR)
def get_op(hctx, indata: bytes) -> bytes:
    q = json.loads(indata or b"{}")
    refs = _load(hctx)
    refs.append(q["tag"])
    hctx.setxattr(_ATTR, json.dumps(refs).encode())
    return b""


@register("refcount", "put", CLS_METHOD_RD | CLS_METHOD_WR)
def put_op(hctx, indata: bytes) -> bytes:
    q = json.loads(indata or b"{}")
    refs = _load(hctx)
    if not refs:
        # implicit ref: an object without the attr has one unnamed ref
        # (cls_refcount wildcard semantics); putting it removes it
        hctx.remove()
        return b""
    if q["tag"] not in refs:
        raise ClsError("ENOENT", q["tag"])
    refs.remove(q["tag"])
    if refs:
        hctx.setxattr(_ATTR, json.dumps(refs).encode())
    else:
        hctx.remove()
    return b""


@register("refcount", "list", CLS_METHOD_RD)
def list_op(hctx, indata: bytes) -> bytes:
    return json.dumps(_load(hctx)).encode()
