"""libradosstriper + SimpleRADOSStriper: locked striped-object APIs.

Two layers over the raw striping math (client/striper.py):

* ``RadosStriperCtx`` -- the libradosstriper analog
  (src/libradosstriper/RadosStriperImpl.cc): every op takes a cls_lock
  on the striped object's FIRST rados object -- SHARED for read/write
  (concurrent I/O from many clients is fine; what must be excluded is
  a concurrent remove/truncate yanking objects mid-op), EXCLUSIVE for
  remove/truncate.  Each op gets its OWN lock cookie (two concurrent
  ops on one handle must not release each other's lock), size updates
  go through the atomic cls grow_size op so concurrent growers never
  lose a read-modify-write race, and remove deletes the lock-bearing
  first object LAST so the exclusion holds for the whole teardown.

* ``SimpleRADOSStriper`` -- the src/SimpleRADOSStriper.cc analog (the
  libcephsqlite backing store): ONE writer holds a persistent
  exclusive lock on the striped file for the whole open (renewed in
  the background, fenced on loss); recovering a file from a previous
  holder BLOCKLISTS that holder first, so a wedged-but-alive previous
  writer's late I/O is refused at the OSDs instead of corrupting the
  new owner's data (exactly the reference's recover-with-blocklist).

Port of ``ceph_tpu/client/radosstriper.py``; runs unchanged over the
port's librados.
"""

from __future__ import annotations

import asyncio
import json
import os

from .rados import RadosError
from .striper import Layout, RadosStriper, map_extents

LOCK_NAME = "striper.lock"
OP_LOCK_DURATION = 60.0       # per-op lease; ops must finish inside
SRS_LOCK = "simplerados.lock"
SRS_OWNER_XATTR = "srs.owner"
SRS_LOCK_DURATION = 30.0
SRS_LOCK_RENEW = 10.0


class StriperError(Exception):
    def __init__(self, errno_name: str, detail: str = "") -> None:
        super().__init__(f"{errno_name}"
                         f"{': ' + detail if detail else ''}")
        self.errno_name = errno_name


class RadosStriperCtx:
    """Multi-client striped-object API with per-op locking."""

    def __init__(self, ioctx, layout: Layout | None = None) -> None:
        self.ioctx = ioctx
        self.striper = RadosStriper(ioctx, layout, atomic_size=True)

    def _first(self, soid: str) -> str:
        return self.striper._obj(soid, 0)

    async def _lock(self, soid: str, exclusive: bool) -> str:
        """Acquire; returns this op's cookie.  Waits out a crashed
        holder's full lease before giving up."""
        cookie = os.urandom(6).hex()
        deadline = (asyncio.get_event_loop().time()
                    + OP_LOCK_DURATION + 5.0)
        while True:
            try:
                await self.ioctx.exec(
                    self._first(soid), "lock", "lock", json.dumps({
                        "name": LOCK_NAME,
                        "type": "exclusive" if exclusive else "shared",
                        "cookie": cookie,
                        "duration": OP_LOCK_DURATION}).encode())
                return cookie
            except RadosError as e:
                if e.errno_name != "EBUSY":
                    raise StriperError(e.errno_name, str(e)) from e
                if asyncio.get_event_loop().time() > deadline:
                    raise StriperError(
                        "EBUSY", f"{soid} locked too long") from e
                await asyncio.sleep(0.05)

    async def _unlock(self, soid: str, cookie: str) -> None:
        try:
            await self.ioctx.exec(
                self._first(soid), "lock", "unlock", json.dumps({
                    "name": LOCK_NAME, "cookie": cookie}).encode())
        except RadosError:
            pass             # lease expiry already released it

    async def write(self, soid: str, data: bytes,
                    off: int = 0) -> None:
        cookie = await self._lock(soid, exclusive=False)
        try:
            await self.striper.write(soid, data, off)
        finally:
            await self._unlock(soid, cookie)

    async def read(self, soid: str, length: int | None = None,
                   off: int = 0) -> bytes:
        cookie = await self._lock(soid, exclusive=False)
        try:
            return await self.striper.read(soid, length, off)
        finally:
            await self._unlock(soid, cookie)

    async def stat(self, soid: str) -> dict:
        return {"size": await self.striper.size(soid)}

    async def truncate(self, soid: str, size: int) -> None:
        cookie = await self._lock(soid, exclusive=True)
        try:
            if size == 0:
                # striper.truncate(0) would remove the FIRST object --
                # the lock's home -- letting another client in while
                # we still run.  Keep object 0, drop the rest, zero
                # the size (object 0 keeps only lock/xattr state).
                await self._remove_tail(soid, keep_first=True)
                await self.ioctx.exec(
                    self._first(soid), "striper", "set_size",
                    json.dumps({"size": 0}).encode())
            else:
                await self.striper.truncate(soid, size)
        finally:
            await self._unlock(soid, cookie)

    async def _remove_tail(self, soid: str,
                           keep_first: bool) -> None:
        size = await self.striper.size(soid)
        n_objs = max((e[0] for e in map_extents(
            self.striper.layout, 0, max(size, 1))), default=0) + 1

        async def rm(objectno):
            try:
                await self.ioctx.remove(
                    self.striper._obj(soid, objectno))
            except RadosError as e:
                if e.errno_name != "ENOENT":
                    raise
        await asyncio.gather(*(rm(o)
                               for o in range(1, n_objs)))
        if not keep_first:
            await rm(0)

    async def remove(self, soid: str) -> None:
        # EXCLUSIVE: a reader/writer mid-op must finish first.  Data
        # objects go first; the lock-bearing FIRST object goes LAST,
        # so nobody can acquire a fresh lock and start writing while
        # our deletes are still in flight
        cookie = await self._lock(soid, exclusive=True)
        try:
            await self._remove_tail(soid, keep_first=False)
        finally:
            await self._unlock(soid, cookie)

    async def get_xattr(self, soid: str, name: str):
        return await self.ioctx.get_xattr(self._first(soid), name)

    async def set_xattr(self, soid: str, name: str,
                        value: bytes) -> None:
        await self.ioctx.set_xattr(self._first(soid), name, value)


class SimpleRADOSStriper:
    """Single-writer striped file under a persistent exclusive lock
    (the libcephsqlite backing-store contract)."""

    def __init__(self, ioctx, soid: str,
                 layout: Layout | None = None) -> None:
        self.ioctx = ioctx
        self.soid = soid
        self.striper = RadosStriper(ioctx, layout)
        self._cookie = os.urandom(4).hex()
        self._renew_task: asyncio.Task | None = None
        self._fenced = False
        self._opened = False

    def _first(self) -> str:
        return self.striper._obj(self.soid, 0)

    @property
    def _entity(self) -> str:
        return self.ioctx.objecter.msgr.name

    async def open(self) -> "SimpleRADOSStriper":
        """Take (or fail to take) the exclusive lock; holds until
        close(), renewing in the background.  Recovering the file
        from a DIFFERENT previous holder blocklists that holder: its
        lease lapsed, but it may be wedged with writes in flight
        (SimpleRADOSStriper::recover_lock + blocklist)."""
        try:
            await self.ioctx.exec(
                self._first(), "lock", "lock", json.dumps({
                    "name": SRS_LOCK, "type": "exclusive",
                    "cookie": self._cookie,
                    "duration": SRS_LOCK_DURATION,
                    "flags": 1}).encode())
        except RadosError as e:
            raise StriperError(e.errno_name,
                               "file is locked by another client") \
                from e
        try:
            prev = await self.ioctx.get_xattr(self._first(),
                                              SRS_OWNER_XATTR)
        except RadosError:
            prev = None
        # a CLEANLY closed file has no owner marker; one left behind
        # means the previous holder crashed or wedged mid-session
        if prev and prev.decode() != self._entity:
            try:
                await self.ioctx.rados.mon_command(
                    "osd blocklist", {"id": prev.decode(),
                                      "duration": 120})
            except Exception:
                pass         # mon unreachable: lease expiry gates
        await self.ioctx.set_xattr(self._first(), SRS_OWNER_XATTR,
                                   self._entity.encode())
        self._opened = True
        self._renew_task = asyncio.ensure_future(self._renew_loop())
        return self

    async def _renew_loop(self) -> None:
        try:
            while not self._fenced:
                await asyncio.sleep(SRS_LOCK_RENEW)
                try:
                    await self.ioctx.exec(
                        self._first(), "lock", "lock", json.dumps({
                            "name": SRS_LOCK, "type": "exclusive",
                            "cookie": self._cookie,
                            "duration": SRS_LOCK_DURATION,
                            "flags": 1}).encode())
                except RadosError as e:
                    if e.errno_name in ("EBUSY", "ENOENT"):
                        # lease lapsed and someone else owns the file:
                        # fence this handle (the new owner also
                        # blocklisted us, so late writes bounce at the
                        # OSDs too)
                        self._fenced = True
                except (ConnectionError, OSError):
                    pass
        except asyncio.CancelledError:
            pass

    def _ok(self) -> None:
        if not self._opened:
            raise StriperError("EBADF", "not open")
        if self._fenced:
            raise StriperError("EBLOCKLISTED",
                               "exclusive lock lost; handle fenced")

    async def write(self, data: bytes, off: int = 0) -> None:
        self._ok()
        await self.striper.write(self.soid, data, off)

    async def read(self, length: int | None = None,
                   off: int = 0) -> bytes:
        self._ok()
        return await self.striper.read(self.soid, length, off)

    async def truncate(self, size: int) -> None:
        self._ok()
        await self.striper.truncate(self.soid, size)

    async def size(self) -> int:
        self._ok()
        return await self.striper.size(self.soid)

    async def close(self) -> None:
        if self._renew_task:
            self._renew_task.cancel()
            try:
                await self._renew_task
            except asyncio.CancelledError:
                pass
        if self._opened and not self._fenced:
            try:
                # clean release: clear the owner marker FIRST so the
                # next opener does not fence an innocent holder, then
                # drop the lock
                await self.ioctx.set_xattr(self._first(),
                                           SRS_OWNER_XATTR, b"")
                await self.ioctx.exec(
                    self._first(), "lock", "unlock", json.dumps({
                        "name": SRS_LOCK,
                        "cookie": self._cookie}).encode())
            except RadosError:
                pass
        self._opened = False
