"""Object classes (cls): server-side methods executed inside the OSD.

The reference loads classes as shared objects (ClassHandler::open_class,
src/osd/ClassHandler.cc:171) and runs their methods inside the PG op
vector via the CEPH_OSD_OP_CALL op (PrimaryLogPG::do_osd_ops "call"
case); methods mutate the object through the objclass API
(src/objclass/class_api.cc: cls_cxx_read/write/getxattr/map_set_val...)
so their effects commit atomically with the surrounding ops.

Here classes are python modules registered at import time (the dlopen
analog -- `ceph_tpu_torch.osd.cls.<name>` imports on first use) and methods
run against the PG's pending-write overlay: reads observe earlier ops
in the vector, writes append resolved logical mutations to the same
transaction the rest of the vector commits in.

Method contract: ``fn(hctx, indata: bytes) -> bytes | None``; raise
ClsError("ENOENT"/...) to fail the op (which aborts the whole write
vector, as a negative cls return does in the reference).
"""

from __future__ import annotations

import importlib
import time

CLS_METHOD_RD = 1
CLS_METHOD_WR = 2

_REGISTRY: dict[str, dict[str, tuple[int, object]]] = {}

# in-tree modules, loaded on first call (dlopen-on-demand analog)
_KNOWN = ("lock", "refcount", "version", "rbd", "rgw_index",
          "journal", "numops", "log", "timeindex", "user", "queue",
          "striper")


class ClsError(Exception):
    def __init__(self, errno_name: str, detail: str = "") -> None:
        super().__init__(f"{errno_name}{': ' + detail if detail else ''}")
        self.errno_name = errno_name
        self.detail = detail


def register(cls_name: str, method: str, flags: int):
    """Decorator: register ``fn`` as ``<cls>.<method>`` (cls_register_cxx_method)."""
    def deco(fn):
        _REGISTRY.setdefault(cls_name, {})[method] = (flags, fn)
        return fn
    return deco


def _load(cls_name: str) -> dict[str, tuple[int, object]]:
    if cls_name not in _REGISTRY and cls_name in _KNOWN:
        importlib.import_module(f"{__name__}.{cls_name}")
    if cls_name not in _REGISTRY:
        raise ClsError("EOPNOTSUPP", f"no such class {cls_name}")
    return _REGISTRY[cls_name]


class HCtx:
    """The objclass handle passed to methods (cls_method_context_t).

    Backed by the PG's pending-write overlay dict; every write both
    lands in ``sink`` (logical ops later resolved into the op vector's
    transaction) and is applied to the overlay so later reads -- by
    this method, later methods, or later ops in the vector -- see it.
    """

    def __init__(self, pg, oid: str, overlay: dict, sink: list[dict],
                 entity: str, writable: bool) -> None:
        self._pg = pg
        self.oid = oid
        self._ov = overlay
        self._sink = sink
        self.entity = entity
        self._writable = writable

    # -- helpers ------------------------------------------------------------
    def _emit(self, op: dict) -> None:
        if not self._writable:
            raise ClsError("EPERM", "write from RD-only method/context")
        self._sink.append(op)
        self._pg._apply_overlay(self._ov, [op])

    def exists(self) -> bool:
        return bool(self._ov["exists"])

    # -- data ---------------------------------------------------------------
    def read(self, off: int = 0, length: int | None = None) -> bytes:
        if not self._ov["exists"]:
            raise ClsError("ENOENT")
        d = self._ov["data"]
        return bytes(d[off:] if length is None else d[off:off + length])

    def stat(self) -> int:
        if not self._ov["exists"]:
            raise ClsError("ENOENT")
        return len(self._ov["data"])

    def create(self, exclusive: bool = True) -> None:
        if exclusive and self._ov["exists"]:
            raise ClsError("EEXIST")
        self._emit({"op": "create"})

    def write(self, off: int, data: bytes) -> None:
        self._emit({"op": "write", "off": int(off), "data": bytes(data)})

    def write_full(self, data: bytes) -> None:
        self._emit({"op": "writefull", "data": bytes(data)})

    def truncate(self, size: int) -> None:
        self._emit({"op": "truncate", "size": int(size)})

    def remove(self) -> None:
        if not self._ov["exists"]:
            raise ClsError("ENOENT")
        self._emit({"op": "remove"})

    # -- xattrs -------------------------------------------------------------
    def getxattr(self, name: str) -> bytes:
        v = self._ov["xattrs"].get(name)
        if v is None:
            raise ClsError("ENODATA", name)
        return bytes(v)

    def setxattr(self, name: str, value: bytes) -> None:
        self._emit({"op": "setxattr", "name": name, "value": bytes(value)})

    def rmxattr(self, name: str) -> None:
        self._emit({"op": "rmxattr", "name": name})

    # -- omap ---------------------------------------------------------------
    def map_get_val(self, key: str) -> bytes:
        v = self._ov["omap"].get(key)
        if v is None:
            raise ClsError("ENOENT", key)
        return bytes(v)

    def map_get_all(self) -> dict[str, bytes]:
        return {k: bytes(v) for k, v in self._ov["omap"].items()}

    def map_get_keys(self, start_after: str = "",
                     max_return: int = 1000) -> list[str]:
        return sorted(k for k in self._ov["omap"]
                      if k > start_after)[:max_return]

    def map_set_val(self, key: str, value: bytes) -> None:
        self.map_set_vals({key: value})

    def map_set_vals(self, kv: dict[str, bytes]) -> None:
        self._emit({"op": "omap_set",
                    "kv": {k: bytes(v) for k, v in kv.items()}})

    def map_remove_key(self, key: str) -> None:
        self._emit({"op": "omap_rm", "keys": [key]})

    def map_clear(self) -> None:
        self._emit({"op": "omap_clear"})

    # -- misc ---------------------------------------------------------------
    def current_time(self) -> float:
        return time.time()

    def gen_snap_id(self):
        """Pool-unique monotonically increasing id (cls_rbd snap ids
        come from the mon in the reference; here the PG primary's mon
        channel is not reachable from cls context, so rbd allocates
        snap ids client-side via selfmanaged snaps)."""
        raise ClsError("EOPNOTSUPP")


def call(pg, oid: str, overlay: dict, sink: list[dict], entity: str,
         cls_name: str, method: str, indata: bytes,
         read_only_ctx: bool = False) -> bytes:
    """Execute ``<cls>.<method>``; returns the method's output bytes.

    Raises ClsError on failure (caller aborts the op vector)."""
    methods = _load(cls_name)
    if method not in methods:
        raise ClsError("EOPNOTSUPP", f"{cls_name}.{method}")
    flags, fn = methods[method]
    writable = bool(flags & CLS_METHOD_WR) and not read_only_ctx
    if read_only_ctx and (flags & CLS_METHOD_WR):
        raise ClsError("EROFS", f"{cls_name}.{method} on snap read")
    hctx = HCtx(pg, oid, overlay, sink, entity, writable)
    out = fn(hctx, bytes(indata))
    return b"" if out is None else bytes(out)
