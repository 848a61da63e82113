"""librados-shaped client API: Rados (cluster handle) + IoCtx (pool I/O).

The surface mirrors the reference's C++ librados (src/librados/
librados_cxx.cc IoCtx::{write,append,read,remove,stat,...}) in
idiomatic asyncio; the op engine underneath is the Objecter, as in the
reference (IoCtxImpl -> Objecter::op_submit).

Port of ``ceph_tpu/client/rados.py``: ``Rados(addr, device=...)`` hands
its device (CUDA unless the caller names the CPU) to its Objecter.
"""

from __future__ import annotations

import asyncio

from .objecter import Objecter, ObjecterError
from ..osd.pg import CALL_OPS as _CALL_OPS, WRITE_OPS as _WRITE_OPS


class RadosError(Exception):
    def __init__(self, errno_name: str, detail: str = "") -> None:
        super().__init__(f"{errno_name}{': ' + detail if detail else ''}")
        self.errno_name = errno_name


def _check(results: list[dict], idx: int = 0) -> dict:
    r = results[idx]
    if "err" in r:
        raise RadosError(r["err"])
    return r


class Rados:
    """Cluster handle (librados ``rados_t`` analog)."""

    def __init__(self, mon_addr: tuple[str, int],
                 name: str | None = None,
                 secret: bytes | None = None,
                 msgr_opts: dict | None = None, device=None) -> None:
        self.mon_addr = tuple(mon_addr)
        if name is None:
            # entity names must be unique per client instance: two
            # messengers sharing a name evict each other's connections
            # at the peer (the reference gets unique client.<gid> ids
            # from the mon's auth handshake)
            import os
            name = f"client.{os.urandom(4).hex()}"
        self.objecter = Objecter(name=name, secret=secret,
                                 msgr_opts=msgr_opts, device=device)
        self.connected = False

    async def connect(self) -> "Rados":
        await self.objecter.start(self.mon_addr)
        self.connected = True
        return self

    async def authenticate(self, entity: str, key_hex: str,
                           services: tuple = ("osd",)) -> None:
        """cephx: hold live service tickets (see Objecter.authenticate)."""
        await self.objecter.authenticate(entity, key_hex, services)

    async def shutdown(self) -> None:
        await self.objecter.shutdown()
        self.connected = False

    async def mon_command(self, cmd: str, args: dict | None = None):
        """Monitor command with errors normalized to RadosError."""
        try:
            return await self.objecter.mon_command(cmd, args)
        except ObjecterError as e:
            raise RadosError("EINVAL", str(e)) from e
        except asyncio.TimeoutError as e:
            raise RadosError("ETIMEDOUT", "monitor unreachable") from e

    # -- pool ops -----------------------------------------------------------
    async def pool_create(self, name: str, pg_num: int = 32,
                          pool_type: str = "replicated",
                          size: int = 3, min_size: int = 2,
                          erasure_code_profile: str = "default") -> int:
        args = {"name": name, "pg_num": pg_num, "type": pool_type,
                "size": size, "min_size": min_size}
        if pool_type == "erasure":
            args["erasure_code_profile"] = erasure_code_profile
        return await self.mon_command("osd pool create", args)

    async def pool_delete(self, name: str) -> int:
        return await self.mon_command("osd pool rm", {"name": name})

    async def pool_list(self) -> list[str]:
        return await self.mon_command("osd pool ls")

    async def status(self) -> dict:
        return await self.mon_command("status")

    async def open_ioctx(self, pool_name: str) -> "IoCtx":
        await self.objecter._refresh_map()
        pool_id = self.objecter.osdmap.pool_names.get(pool_name)
        if pool_id is None:
            raise RadosError("ENOENT", f"no pool {pool_name}")
        return IoCtx(self, pool_name, pool_id)


class IoCtx:
    """Pool I/O context (librados ``IoCtx`` analog)."""

    def __init__(self, rados: Rados, pool_name: str, pool_id: int) -> None:
        self.rados = rados
        self.objecter = rados.objecter
        self.pool_name = pool_name
        self.pool_id = pool_id
        self.nspace = ""

    def set_namespace(self, nspace: str) -> None:
        self.nspace = nspace

    # -- self-managed snapshots (librados selfmanaged_snap_* API) -----------
    def set_snap_context(self, seq: int, snaps: list[int]) -> None:
        """Snap context stamped on subsequent writes (newest first)."""
        self._snapc = {"seq": int(seq),
                       "snaps": sorted((int(s) for s in snaps),
                                       reverse=True)}

    async def selfmanaged_snap_create(self) -> int:
        """Allocate a snap id from the mon and fold it into the io
        context (rados_ioctx_selfmanaged_snap_create)."""
        sid = await self.rados.mon_command(
            "osd pool selfmanaged-snap create", {"pool": self.pool_name})
        old = getattr(self, "_snapc", {"seq": 0, "snaps": []})
        self.set_snap_context(sid, [sid] + list(old["snaps"]))
        return sid

    async def selfmanaged_snap_remove(self, snapid: int) -> None:
        await self.rados.mon_command(
            "osd pool selfmanaged-snap rm",
            {"pool": self.pool_name, "snap": int(snapid)})
        old = getattr(self, "_snapc", {"seq": 0, "snaps": []})
        self.set_snap_context(
            old["seq"], [s for s in old["snaps"] if s != int(snapid)])

    async def _op(self, oid: str, ops: list[dict],
                  extra: dict | None = None,
                  timeout: float | None = None) -> tuple[dict, list]:
        snapc = getattr(self, "_snapc", None)
        if snapc and any(o["op"] in _WRITE_OPS or o["op"] in _CALL_OPS
                         for o in ops):
            extra = {**(extra or {}), "snapc": snapc}
        kwargs = {}
        if timeout is not None:
            kwargs = {"timeout": timeout + 5}
        try:
            reply = await self.objecter.op_submit(self.pool_id, oid, ops,
                                                  nspace=self.nspace,
                                                  extra=extra, **kwargs)
        except ObjecterError as e:
            raise RadosError("ETIMEDOUT", str(e)) from e
        if "err" in reply.data:
            raise RadosError(reply.data["err"],
                             reply.data.get("detail", ""))
        return reply.data, reply.segments

    # -- data ---------------------------------------------------------------
    async def write(self, oid: str, data: bytes, offset: int = 0) -> None:
        await self._op(oid, [{"op": "write", "off": offset, "data": data}])

    async def write_full(self, oid: str, data: bytes) -> None:
        await self._op(oid, [{"op": "writefull", "data": data}])

    async def append(self, oid: str, data: bytes) -> None:
        await self._op(oid, [{"op": "append", "data": data}])

    async def read(self, oid: str, length: int | None = None,
                   offset: int = 0, snap: int | None = None) -> bytes:
        extra = {"snapid": int(snap)} if snap else None
        data, segs = await self._op(oid, [{"op": "read", "off": offset,
                                           "len": length}], extra=extra)
        r = _check(data["results"])
        return segs[r["seg"]] if "seg" in r else b""

    async def list_snaps(self, oid: str) -> dict:
        data, _ = await self._op(oid, [{"op": "list_snaps"}])
        return _check(data["results"])["snapset"]

    # -- watch/notify (rados_watch3/rados_notify2) --------------------------
    async def watch(self, oid: str, callback) -> int:
        """Register a watch; ``callback(payload: bytes)`` fires on every
        notify.  Survives primary moves via the objecter's linger
        resend.  Returns the watch cookie."""
        # cookies must be unique across every ioctx of this client: the
        # PG keys watchers by (client entity, cookie)
        cookie = next(self.objecter._tid)
        await self._op(oid, [{"op": "watch", "cookie": cookie,
                              "addr": list(self.objecter.msgr.addr)}])
        self.objecter.register_watch(self.pool_id, oid, cookie, callback,
                                     nspace=self.nspace)
        return cookie

    async def unwatch(self, oid: str, cookie: int) -> None:
        self.objecter.unregister_watch(self.pool_id, oid, cookie)
        await self._op(oid, [{"op": "unwatch", "cookie": cookie}])

    async def notify(self, oid: str, payload: bytes = b"",
                     timeout: float = 5.0) -> dict:
        """Send ``payload`` to every watcher; returns {acks, timeouts}
        after all watchers answered or the timeout lapsed."""
        # the server waits up to `timeout` for watcher acks before
        # replying: the op attempt window must outlast it or the
        # objecter would resend and duplicate deliveries
        data, _ = await self._op(oid, [
            {"op": "notify", "data": payload, "timeout": timeout}],
            timeout=timeout)
        return _check(data["results"])

    async def list_watchers(self, oid: str) -> list:
        data, _ = await self._op(oid, [{"op": "list_watchers"}])
        return _check(data["results"])["watchers"]

    # -- object classes (rados_exec / IoCtx::exec) --------------------------
    async def exec(self, oid: str, cls: str, method: str,
                   data: bytes = b"") -> bytes:
        """Run a server-side cls method on the object; returns its
        output bytes (rados_exec, src/librados/librados_c.cc)."""
        reply, segs = await self._op(oid, [
            {"op": "call", "cls": cls, "method": method, "data": data}])
        r = _check(reply["results"])
        return segs[r["seg"]] if "seg" in r else b""

    def op_call(self, cls: str, method: str, data: bytes = b"") -> dict:
        """A call op for composing into operate() vectors."""
        return {"op": "call", "cls": cls, "method": method, "data": data}

    async def operate(self, oid: str,
                      ops: list[dict]) -> tuple[dict, list]:
        """Atomic multi-op vector on one object (ObjectWriteOperation)."""
        return await self._op(oid, ops)

    async def remove(self, oid: str) -> None:
        await self._op(oid, [{"op": "remove"}])

    async def truncate(self, oid: str, size: int) -> None:
        await self._op(oid, [{"op": "truncate", "size": size}])

    async def zero(self, oid: str, off: int, length: int) -> None:
        await self._op(oid, [{"op": "zero", "off": off, "len": length}])

    async def stat(self, oid: str) -> dict:
        data, _ = await self._op(oid, [{"op": "stat"}])
        return _check(data["results"])

    # -- xattrs -------------------------------------------------------------
    async def set_xattr(self, oid: str, name: str, value: bytes) -> None:
        await self._op(oid, [{"op": "setxattr", "name": name,
                              "value": value}])

    async def get_xattr(self, oid: str, name: str) -> bytes:
        data, segs = await self._op(oid, [{"op": "getxattr",
                                           "name": name}])
        r = _check(data["results"])
        return segs[r["seg"]] if "seg" in r else b""

    async def rm_xattr(self, oid: str, name: str) -> None:
        await self._op(oid, [{"op": "rmxattr", "name": name}])

    async def get_xattrs(self, oid: str) -> dict[str, bytes]:
        data, _ = await self._op(oid, [{"op": "getxattrs"}])
        r = _check(data["results"])
        return {k: bytes.fromhex(v) for k, v in r["attrs"].items()}

    # -- omap ---------------------------------------------------------------
    async def set_omap(self, oid: str, kv: dict[str, bytes]) -> None:
        await self._op(oid, [{"op": "omap_set", "kv": kv}])

    async def get_omap(self, oid: str) -> dict[str, bytes]:
        data, _ = await self._op(oid, [{"op": "omap_get"}])
        r = _check(data["results"])
        return {k: bytes.fromhex(v) for k, v in r["omap"].items()}

    async def rm_omap_keys(self, oid: str, keys: list[str]) -> None:
        await self._op(oid, [{"op": "omap_rm", "keys": keys}])

    # -- listing ------------------------------------------------------------
    async def list_objects(self) -> list[str]:
        """Union of per-PG listings across the pool (pgls analog)."""
        pool = self.objecter.osdmap.pools[self.pool_id]
        oids: set[str] = set()
        for ps in range(pool.pg_num):
            # the 'list' op addresses a PG, not an object
            reply = await self.objecter.op_submit(
                self.pool_id, "_pgls_", [{"op": "list"}], ps=ps)
            if "results" in reply.data:
                r = reply.data["results"][0]
                if r.get("ok"):
                    oids.update(r.get("oids", []))
        return sorted(oids)
