"""cls_lock: advisory shared/exclusive object locks.

Mirrors src/cls/lock/cls_lock.cc: lock state lives in an object xattr
``lock.<name>`` (the reference keys attr "lock.<name>" the same way,
cls_lock.cc:121 lock_info_t), lockers are (entity, cookie) pairs with
optional expiration; methods lock/unlock/break_lock/get_info/
list_locks follow cls_lock_ops.h semantics.  librbd's exclusive lock
and RGW's reshard/lifecycle locks are the main reference customers.
"""

from __future__ import annotations

import json

from . import CLS_METHOD_RD, CLS_METHOD_WR, ClsError, register

LOCK_NONE = "none"
LOCK_EXCLUSIVE = "exclusive"
LOCK_SHARED = "shared"

_ATTR = "lock."


def _load(hctx, name: str) -> dict:
    try:
        info = json.loads(hctx.getxattr(_ATTR + name))
    except ClsError:
        info = {"type": LOCK_NONE, "tag": "", "lockers": {}}
    # purge expired lockers on every access (cls_lock does this lazily)
    now = hctx.current_time()
    info["lockers"] = {
        k: v for k, v in info["lockers"].items()
        if not v.get("expiration") or v["expiration"] > now}
    if not info["lockers"]:
        info["type"] = LOCK_NONE
    return info


def _store(hctx, name: str, info: dict) -> None:
    if info["lockers"]:
        hctx.setxattr(_ATTR + name, json.dumps(info).encode())
    else:
        try:
            hctx.getxattr(_ATTR + name)
            hctx.rmxattr(_ATTR + name)
        except ClsError:
            pass


def _locker_key(entity: str, cookie: str) -> str:
    return f"{entity}\0{cookie}"


@register("lock", "lock", CLS_METHOD_RD | CLS_METHOD_WR)
def lock_op(hctx, indata: bytes) -> bytes:
    q = json.loads(indata or b"{}")
    name = q["name"]
    ltype = q.get("type", LOCK_EXCLUSIVE)
    cookie = str(q.get("cookie", ""))
    tag = q.get("tag", "")
    desc = q.get("description", "")
    duration = float(q.get("duration", 0))
    renew = bool(q.get("flags", 0) & 1)     # LOCK_FLAG_MAY_RENEW
    if ltype not in (LOCK_EXCLUSIVE, LOCK_SHARED):
        raise ClsError("EINVAL", f"bad lock type {ltype}")
    info = _load(hctx, name)
    key = _locker_key(hctx.entity, cookie)
    if info["type"] != LOCK_NONE:
        if info["tag"] != tag:
            raise ClsError("EBUSY", "tag mismatch")
        if key in info["lockers"]:
            if not renew and info["type"] == ltype:
                raise ClsError("EEXIST", "already held")
        elif info["type"] == LOCK_EXCLUSIVE or ltype == LOCK_EXCLUSIVE:
            raise ClsError("EBUSY", "held by another locker")
    exp = hctx.current_time() + duration if duration else 0
    if key in info["lockers"] and info["type"] != ltype:
        raise ClsError("EBUSY", "would change lock type")
    info["type"] = ltype
    info["tag"] = tag
    info["lockers"][key] = {"description": desc, "expiration": exp}
    _store(hctx, name, info)
    return b""


@register("lock", "unlock", CLS_METHOD_RD | CLS_METHOD_WR)
def unlock_op(hctx, indata: bytes) -> bytes:
    q = json.loads(indata or b"{}")
    info = _load(hctx, q["name"])
    key = _locker_key(hctx.entity, str(q.get("cookie", "")))
    if key not in info["lockers"]:
        raise ClsError("ENOENT", "not held by caller")
    del info["lockers"][key]
    if not info["lockers"]:
        info["type"] = LOCK_NONE
    _store(hctx, q["name"], info)
    return b""


@register("lock", "break_lock", CLS_METHOD_RD | CLS_METHOD_WR)
def break_lock_op(hctx, indata: bytes) -> bytes:
    """Forcibly drop ANOTHER entity's lock (recovery after client death)."""
    q = json.loads(indata or b"{}")
    info = _load(hctx, q["name"])
    key = _locker_key(q["locker"], str(q.get("cookie", "")))
    if key not in info["lockers"]:
        raise ClsError("ENOENT", "no such locker")
    del info["lockers"][key]
    if not info["lockers"]:
        info["type"] = LOCK_NONE
    _store(hctx, q["name"], info)
    return b""


@register("lock", "get_info", CLS_METHOD_RD)
def get_info_op(hctx, indata: bytes) -> bytes:
    q = json.loads(indata or b"{}")
    info = _load(hctx, q["name"])
    return json.dumps({
        "type": info["type"], "tag": info["tag"],
        "lockers": [
            {"entity": k.split("\0")[0], "cookie": k.split("\0")[1],
             **v} for k, v in info["lockers"].items()],
    }).encode()


@register("lock", "list_locks", CLS_METHOD_RD)
def list_locks_op(hctx, indata: bytes) -> bytes:
    names = [k[len(_ATTR):] for k in hctx._ov["xattrs"]
             if k.startswith(_ATTR)]
    return json.dumps(sorted(names)).encode()


@register("lock", "assert_locked", CLS_METHOD_RD)
def assert_locked_op(hctx, indata: bytes) -> bytes:
    """Fails unless the CALLER holds the lock -- composed into op
    vectors so a write commits only while the lock is held
    (rados lock assert, cls_lock.cc assert_locked)."""
    q = json.loads(indata or b"{}")
    info = _load(hctx, q["name"])
    key = _locker_key(hctx.entity, str(q.get("cookie", "")))
    if q.get("type", info["type"]) != info["type"] \
            or key not in info["lockers"]:
        raise ClsError("EBUSY", "lock not held by caller")
    if q.get("tag") is not None and q.get("tag", "") != info["tag"]:
        raise ClsError("EBUSY", "tag mismatch")
    return b""
