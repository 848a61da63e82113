"""CephFS client (libcephfs / src/client/Client.cc analog).

POSIX-ish surface: mkdir/rmdir/readdir/stat/open/read/write/truncate/
unlink/rename.  Metadata RPCs go to the active MDS (discovered from
the mds_map object, re-resolved on failure -- the FSMap subscription
analog); file DATA goes straight to the data pool through the striper
with the layout from the inode, never through the MDS.  File size is
write-back: the client tracks it per open file and flushes a setattr
on close/fsync (the Fw cap dirty-size flush).

Port of ``ceph_tpu/mds/client.py``.  ``CephFS(..., device=...)`` (CUDA
unless the caller names the CPU) hands its device to its librados
client, so file data goes through the port's striper and cache to
the card's codec.
"""

from __future__ import annotations

import asyncio
import itertools
import json

from ..client.rados import Rados, RadosError
from ..client.striper import Layout, RadosStriper
from ..device import resolve_device
from ..msg import Message
from .server import CAP_LEASE, DEFAULT_LAYOUT, MDSMAP_OID


class FsError(Exception):
    def __init__(self, errno_name: str, detail: str = "") -> None:
        super().__init__(f"{errno_name}{': ' + detail if detail else ''}")
        self.errno_name = errno_name


class FsFile:
    """An open file handle holding a capability.

    The cap ("r" or "w") is what makes cached state legal: a "w"
    holder may buffer its size and append position; when the MDS
    revokes (another client opened the file), the handle flushes and
    goes STALE -- the next write re-opens to re-acquire the cap and
    refresh the size, so two clients cannot clobber each other
    (Locker.cc cap revocation compressed to the Fr/Fw pair)."""

    def __init__(self, fs: "CephFS", path: str, dentry: dict,
                 append: bool = False, caps: str = "r",
                 snap_id: int | None = None,
                 snapc: dict | None = None) -> None:
        self.fs = fs
        self.path = path
        self.dentry = dentry
        self.ino = dentry["ino"]
        self.snap_id = snap_id          # frozen .snap view when set
        lay = dentry.get("layout") or DEFAULT_LAYOUT
        layout = Layout(stripe_unit=lay["su"], stripe_count=lay["sc"],
                        object_size=lay["os"])
        if snapc is not None:
            # a snapped realm: writes must stamp the realm's snapc so
            # the OSDs COW pre-snap data.  The snapc is per-file, so
            # the handle gets a PRIVATE ioctx (a shared one would leak
            # this context onto other files' writes) and bypasses the
            # shared write-back cache
            from ..client.rados import IoCtx
            dio = IoCtx(fs.rados, fs.data.pool_name, fs.data.pool_id)
            dio.set_snap_context(snapc["seq"], snapc["snaps"])
            self.striper = RadosStriper(dio, layout)
        elif snap_id is not None:
            self.striper = RadosStriper(fs.data, layout)
        else:
            self.striper = RadosStriper(fs._data_cache or fs.data,
                                        layout)
        self.size = dentry.get("size", 0)
        self.caps = caps
        self._stale = False
        self._append = append
        self._dirty = False
        self._closed = False
        fs._track_file(self)

    async def _reacquire(self, want: str) -> None:
        """Cap lost (revoked or lapsed): flush went out at revoke
        time; re-open to refresh size + regain the cap."""
        out = await self.fs._request({"op": "open", "path": self.path,
                                      "want": want})
        self.dentry = out["dentry"]
        self.size = self.dentry.get("size", 0)
        self.caps = out.get("caps", want)
        snapc = out.get("snapc")
        if snapc is not None:
            # the realm was snapped while we were revoked: subsequent
            # writes MUST stamp the new snapc or they overwrite data
            # the snapshot froze.  Rebuild the data path with it (a
            # private ioctx -- the shared one must not inherit it)
            from ..client.rados import IoCtx
            lay = self.dentry.get("layout") or DEFAULT_LAYOUT
            dio = IoCtx(self.fs.rados, self.fs.data.pool_name,
                        self.fs.data.pool_id)
            dio.set_snap_context(snapc["seq"], snapc["snaps"])
            self.striper = RadosStriper(dio, Layout(
                stripe_unit=lay["su"], stripe_count=lay["sc"],
                object_size=lay["os"]))
        self._stale = False
        self.fs._note_lease()

    async def write(self, data: bytes, offset: int | None = None) -> int:
        if self.snap_id is not None:
            raise FsError("EROFS", "snapshot view is read-only")
        if self._stale or "w" not in self.caps \
                or not self.fs._caps_fresh():
            await self._reacquire("w")
        # append mode: every write lands at EOF (O_APPEND); otherwise
        # an omitted offset means 0
        offset = self.size if self._append else (offset or 0)
        await self.striper.write(f"{self.ino:x}", data, offset)
        self.size = max(self.size, offset + len(data))
        self._dirty = True
        return len(data)

    async def read(self, length: int | None = None,
                   offset: int = 0) -> bytes:
        if self.snap_id is not None:
            # frozen view: data at the snap id, size from the frozen
            # dentry (the head's size xattr has moved on)
            return await self.striper.read(
                f"{self.ino:x}", length, offset, snap=self.snap_id,
                size_override=self.dentry.get("size", 0))
        if self._stale:
            await self._reacquire("r" if "w" not in self.caps else "w")
        return await self.striper.read(f"{self.ino:x}", length, offset)

    async def truncate(self, size: int) -> None:
        if self._stale or "w" not in self.caps \
                or not self.fs._caps_fresh():
            await self._reacquire("w")
        await self.striper.truncate(f"{self.ino:x}", size)
        self.size = size
        self._dirty = True

    async def fsync(self) -> None:
        if self.fs._data_cache is not None:
            # durability barrier: buffered data lands before the size
            # update is journaled (a crash can truncate, never corrupt)
            await self.fs._data_cache.flush()
        if self._dirty:
            await self.fs._request({"op": "setattr", "path": self.path,
                                    "attrs": {"size": self.size}})
            self._dirty = False

    async def close(self) -> None:
        if not self._closed:
            self._closed = True
            if self.snap_id is not None:
                self.fs._untrack_file(self)
                return                 # frozen view: nothing to flush
            await self.fsync()
            self.fs._untrack_file(self)
            try:
                await self.fs._send_to_mds(Message(
                    "cap_release", {"ino": self.ino}))
            except (ConnectionError, OSError):
                pass


class CephFS:
    """Mounted filesystem handle (ceph_mount analog)."""

    def __init__(self, mon_addr: tuple[str, int],
                 meta_pool: str = "cephfs_metadata",
                 data_pool: str = "cephfs_data",
                 name: str | None = None,
                 cache: bool = False, device=None) -> None:
        # write-back data cache (ObjectCacher): file writes ack from
        # cache; fsync/close/cap-revoke are the flush barriers
        self._cache_enabled = cache
        self._data_cache = None
        self.mon_addr = tuple(mon_addr)
        self.meta_pool = meta_pool
        self.data_pool = data_pool
        self.device = resolve_device(device)
        self.rados = Rados(mon_addr, name=name, device=self.device)
        self.meta = None
        self.data = None
        self.mds_addr: tuple[str, int] | None = None
        self._tid = itertools.count(1)
        self._waiters: dict[int, asyncio.Future] = {}
        self._files: dict[int, list[FsFile]] = {}     # ino -> handles
        self._renew_task: asyncio.Task | None = None
        # local lease clock: caps are only trusted while a renewal (or
        # grant) succeeded within the lease -- after a connectivity
        # gap the MDS may have expired and re-granted them, so the
        # client must treat its own copies as stale
        self._lease_valid_until = 0.0

    async def mount(self) -> "CephFS":
        await self.rados.connect()
        self.meta = await self.rados.open_ioctx(self.meta_pool)
        self.data = await self.rados.open_ioctx(self.data_pool)
        self.rados.objecter.msgr.add_dispatcher(self._on_reply)
        if self._cache_enabled:
            from ..client.object_cacher import CachingIoCtx
            self._data_cache = CachingIoCtx(self.data)
        await self._find_mds()
        # session heartbeat for the MOUNT's lifetime, not just while
        # files are open: an MDS successor fences write-cap holders
        # that stay silent through its reconnect window, and a cap
        # release journaled by a dying active may be lost -- the
        # heartbeat is how an innocent client proves it's alive
        # (the reference's Client::renew_caps runs per-session too)
        if self._renew_task is None or self._renew_task.done():
            self._renew_task = asyncio.ensure_future(self._renew_loop())
        return self

    async def unmount(self) -> None:
        if self._renew_task:
            self._renew_task.cancel()
        if self._data_cache is not None:
            # the final flush failing means acked writes did NOT land:
            # surface it (the mount is still usable for a retry)
            await self._data_cache.cacher.close()
        await self.rados.shutdown()

    # -- capability bookkeeping ---------------------------------------------
    def _track_file(self, f: FsFile) -> None:
        self._files.setdefault(f.ino, []).append(f)

    def _untrack_file(self, f: FsFile) -> None:
        handles = self._files.get(f.ino, [])
        if f in handles:
            handles.remove(f)
        if not handles:
            self._files.pop(f.ino, None)

    async def _send_to_mds(self, msg: Message) -> None:
        await self.rados.objecter.msgr.send(self.mds_addr, "mds", msg)

    def _caps_fresh(self) -> bool:
        loop = asyncio.get_event_loop()
        return loop.time() < self._lease_valid_until

    def _note_lease(self) -> None:
        self._lease_valid_until = (asyncio.get_event_loop().time()
                                   + CAP_LEASE)

    async def _renew_loop(self) -> None:
        """Session heartbeat: keeps held caps alive AND tracks whether
        they are still trustworthy locally (an unacked lease means the
        MDS may have expired + re-granted them to someone else)."""
        try:
            while True:
                await asyncio.sleep(CAP_LEASE / 3)
                loop = asyncio.get_event_loop()
                fut = loop.create_future()
                self._renew_waiter = fut
                try:
                    await self._send_to_mds(
                        Message("session_renew", {}))
                    await asyncio.wait_for(fut, 2.0)
                    self._note_lease()
                except (ConnectionError, OSError,
                        asyncio.TimeoutError):
                    # the active may have MOVED (failover): rediscover
                    # and renew at the new address NOW -- the new
                    # active fences write-cap holders that stay silent
                    # past its reconnect window
                    try:
                        await self._find_mds()
                        fut2 = loop.create_future()
                        self._renew_waiter = fut2
                        await self._send_to_mds(
                            Message("session_renew", {}))
                        await asyncio.wait_for(fut2, 2.0)
                        self._note_lease()
                    except (ConnectionError, OSError, RadosError,
                            asyncio.TimeoutError):
                        pass           # lease clock keeps draining
                finally:
                    self._renew_waiter = None
        except asyncio.CancelledError:
            pass

    async def _on_cap_revoke(self, msg: Message) -> None:
        """The MDS wants our cap back: flush every dirty handle on the
        ino, mark them stale, release."""
        ino = msg.data["ino"]
        for f in list(self._files.get(ino, [])):
            try:
                await f.fsync()
            except (FsError, ConnectionError, OSError):
                pass
            f._stale = True
            f.caps = ""
        if self._data_cache is not None:
            # the cap is leaving us: another client may write next, so
            # our CLEAN extents are about to go stale (cap coherence)
            try:
                await self._data_cache.cacher.invalidate()
            except Exception:
                pass
        try:
            await self._send_to_mds(Message("cap_release",
                                            {"ino": ino}))
        except (ConnectionError, OSError):
            pass

    async def _find_mds(self, timeout: float = 30.0) -> None:
        """Resolve the active MDS from the mon's FSMap (MDSMonitor);
        the legacy mds_map omap object is the fallback so old
        single-daemon deployments still mount."""
        loop = asyncio.get_event_loop()
        deadline = loop.time() + timeout
        while loop.time() < deadline:
            try:
                fsmap = await self.rados.mon_command("fs dump", {})
                active = (fsmap or {}).get("active")
                if active and active.get("addr"):
                    self.mds_addr = tuple(active["addr"])
                    return
            except (RadosError, ConnectionError, OSError,
                    asyncio.TimeoutError, KeyError, TypeError):
                pass
            try:
                omap = await self.meta.get_omap(MDSMAP_OID)
                raw = omap.get("addr")
                if raw:
                    self.mds_addr = tuple(json.loads(raw))
                    return
            except RadosError:
                pass
            await asyncio.sleep(0.5)
        raise FsError("ETIMEDOUT", "no active mds")

    async def _on_reply(self, conn, msg: Message) -> None:
        if msg.type == "cap_revoke":
            await self._on_cap_revoke(msg)
            return
        if msg.type == "session_renew_ack":
            fut = getattr(self, "_renew_waiter", None)
            if fut is not None and not fut.done():
                fut.set_result(True)
            return
        if msg.type != "mds_reply":
            return
        fut = self._waiters.pop(msg.data.get("tid"), None)
        if fut is not None and not fut.done():
            fut.set_result(msg.data)

    async def _request(self, q: dict, timeout: float = 30.0) -> dict:
        """RPC to the active MDS; re-resolves on failure (the client's
        session reconnect to the new active after failover)."""
        loop = asyncio.get_event_loop()
        deadline = loop.time() + timeout
        last: Exception | None = None
        # the reqid is STABLE across resends of this logical op (the
        # per-attempt tid is not): the MDS dedups a mutation whose
        # reply was lost instead of re-applying it (mkdir resent after
        # a failover must not surface EEXIST)
        reqid = f"{self.rados.objecter.msgr.name}:{next(self._tid)}"
        while loop.time() < deadline:
            tid = next(self._tid)
            fut = loop.create_future()
            self._waiters[tid] = fut
            try:
                await self.rados.objecter.msgr.send(
                    self.mds_addr, "mds", Message(
                        "mds_request",
                        {**q, "tid": tid, "reqid": reqid}))
                out = await asyncio.wait_for(fut, 5.0)
                if out.get("err") == "EAGAIN":       # standby answered
                    raise ConnectionError("mds not active")
                if "err" in out:
                    raise FsError(out["err"], out.get("detail", ""))
                return out
            except (ConnectionError, OSError, asyncio.TimeoutError) as e:
                last = e
                self._waiters.pop(tid, None)
                await asyncio.sleep(0.5)
                try:
                    await self._find_mds(timeout=5.0)
                except FsError:
                    pass
        raise FsError("ETIMEDOUT", f"mds unreachable: {last}")

    # -- namespace ops ------------------------------------------------------
    async def mkdir(self, path: str, mode: int = 0o755) -> None:
        await self._request({"op": "mkdir", "path": path, "mode": mode})

    async def rmdir(self, path: str) -> None:
        await self._request({"op": "rmdir", "path": path})

    async def readdir(self, path: str = "/") -> dict[str, dict]:
        out = await self._request({"op": "readdir", "path": path})
        return out["entries"]

    async def ls(self, path: str = "/") -> list[str]:
        return sorted(await self.readdir(path))

    async def stat(self, path: str) -> dict:
        out = await self._request({"op": "stat", "path": path})
        return out["dentry"]

    async def exists(self, path: str) -> bool:
        try:
            await self.stat(path)
            return True
        except FsError as e:
            if e.errno_name == "ENOENT":
                return False
            raise

    async def unlink(self, path: str) -> None:
        await self._request({"op": "unlink", "path": path})

    async def rename(self, src: str, dst: str) -> None:
        await self._request({"op": "rename", "path": src, "dst": dst})

    # -- snapshots ----------------------------------------------------------
    async def mksnap(self, path: str, name: str) -> int:
        """Snapshot a directory subtree (mkdir <path>/.snap/<name>);
        read the frozen view back via '<path>/.snap/<name>/...'."""
        out = await self._request({"op": "mksnap", "path": path,
                                   "name": name})
        return out["snapid"]

    async def rmsnap(self, path: str, name: str) -> None:
        await self._request({"op": "rmsnap", "path": path,
                             "name": name})

    async def lssnap(self, path: str) -> dict:
        return (await self._request({"op": "lssnap",
                                     "path": path}))["snaps"]

    async def open(self, path: str, flags: str = "r",
                   mode: int = 0o644) -> FsFile:
        create = "w" in flags or "a" in flags or "+" in flags
        want = "w" if create else "r"
        out = await self._request({"op": "open", "path": path,
                                   "create": create, "mode": mode,
                                   "want": want})
        self._note_lease()
        f = FsFile(self, path, out["dentry"], append="a" in flags,
                   caps=out.get("caps", want),
                   snap_id=out.get("snapid"),
                   snapc=out.get("snapc"))
        if "w" in flags:        # 'w' and 'w+' both truncate (fopen(3))
            await f.truncate(0)
        return f

    # -- convenience --------------------------------------------------------
    async def write_file(self, path: str, data: bytes) -> None:
        f = await self.open(path, "w")
        try:
            await f.write(data, 0)
        finally:
            await f.close()

    async def read_file(self, path: str) -> bytes:
        f = await self.open(path, "r")
        try:
            return await f.read()
        finally:
            await f.close()

    async def walk(self, path: str = "/"):
        """Yield (dirpath, dirnames, filenames) depth-first."""
        entries = await self.readdir(path)
        dirs = [n for n, d in entries.items() if d["type"] == "dir"]
        files = [n for n, d in entries.items() if d["type"] == "file"]
        yield path, sorted(dirs), sorted(files)
        for d in sorted(dirs):
            sub = f"{path.rstrip('/')}/{d}"
            async for x in self.walk(sub):
                yield x
