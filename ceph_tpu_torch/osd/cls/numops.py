"""cls_numops: atomic arithmetic on omap values.

src/cls/numops/cls_numops.cc: add/sub/mul/div a decimal value stored
under an omap key, atomically at the OSD -- the read-modify-write no
client-side sequence can make race-free.
"""

from __future__ import annotations

import json

from . import CLS_METHOD_RD, CLS_METHOD_WR, ClsError, register


def _cur(hctx, key: str) -> float:
    try:
        raw = hctx.map_get_val(key)
    except ClsError:
        return 0.0
    try:
        return float(raw.decode())
    except ValueError as e:
        raise ClsError("EBADMSG", f"non-numeric value under {key}") \
            from e


def _store(hctx, key: str, v: float) -> bytes:
    out = repr(int(v)) if float(v).is_integer() else repr(v)
    hctx.map_set_val(key, out.encode())
    return out.encode()


@register("numops", "add", CLS_METHOD_RD | CLS_METHOD_WR)
def add_op(hctx, indata: bytes) -> bytes:
    q = json.loads(indata or b"{}")
    return _store(hctx, q["key"], _cur(hctx, q["key"])
                  + float(q["value"]))


@register("numops", "sub", CLS_METHOD_RD | CLS_METHOD_WR)
def sub_op(hctx, indata: bytes) -> bytes:
    q = json.loads(indata or b"{}")
    return _store(hctx, q["key"], _cur(hctx, q["key"])
                  - float(q["value"]))


@register("numops", "mul", CLS_METHOD_RD | CLS_METHOD_WR)
def mul_op(hctx, indata: bytes) -> bytes:
    q = json.loads(indata or b"{}")
    return _store(hctx, q["key"], _cur(hctx, q["key"])
                  * float(q["value"]))


@register("numops", "div", CLS_METHOD_RD | CLS_METHOD_WR)
def div_op(hctx, indata: bytes) -> bytes:
    q = json.loads(indata or b"{}")
    d = float(q["value"])
    if d == 0:
        raise ClsError("EINVAL", "division by zero")
    return _store(hctx, q["key"], _cur(hctx, q["key"]) / d)
