"""cls_striper: atomic striped-object size bookkeeping.

libradosstriper keeps the logical size in an xattr on the first rados
object; concurrent writers from DIFFERENT clients both read-modify-
write it, so the update must happen atomically at the OSD -- size
only ever grows to the max seen (RadosStriperImpl's size xlock,
rendered as a server-side max instead of a client lock dance).
"""

from __future__ import annotations

import json

from . import CLS_METHOD_RD, CLS_METHOD_WR, ClsError, register

SIZE_XATTR = "striper.size"


@register("striper", "grow_size", CLS_METHOD_RD | CLS_METHOD_WR)
def grow_size_op(hctx, indata: bytes) -> bytes:
    q = json.loads(indata or b"{}")
    try:
        cur = int(hctx.getxattr(SIZE_XATTR))
    except ClsError:
        cur = 0
    new = max(cur, int(q["size"]))
    hctx.setxattr(SIZE_XATTR, str(new).encode())
    return str(new).encode()


@register("striper", "set_size", CLS_METHOD_RD | CLS_METHOD_WR)
def set_size_op(hctx, indata: bytes) -> bytes:
    q = json.loads(indata or b"{}")
    hctx.setxattr(SIZE_XATTR, str(int(q["size"])).encode())
    return b""
