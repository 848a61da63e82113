"""Block images on RADOS (librbd analog).

Layout follows rbd format 2 (src/librbd/image/CreateRequest.cc):

    rbd_directory                  pool-wide name <-> id registry (omap)
    rbd_children                   parent(pool,image,snap) -> child ids
    rbd_header.<id>                image metadata omap (cls_rbd methods)
    rbd_data.<id>.<objectno:016x>  data objects, 2^order bytes each

The I/O path mirrors src/librbd/io/ImageRequest.cc: an image extent is
cut into per-object extents (the striper's map_extents with
su=2^order, sc=1 by default; fancy striping supported), object ops are
issued concurrently through the objecter, and clone reads fall back to
the parent snapshot within the overlap (ObjectReadRequest's copyup
path, src/librbd/io/CopyupRequest.cc does the write-side copyup).

Image snapshots ARE RADOS self-managed snapshots: snap ids come from
the pool (librbd takes them from the mon the same way), the header's
snap table (cls_rbd get_snapcontext) provides the write snap context,
and snap reads pass the snap id down the rados read
(src/librbd/Operations.cc snap_create -> cls_rbd snapshot_add).

Exclusive-lock feature: a cls_lock exclusive lock on the header with
periodic renewal (ManagedLock.cc semantics without the blacklist --
expiry substitutes for blocklisting a dead holder).

Port of ``ceph_tpu/rbd/rbd.py``; runs unchanged over the
port's librados.
"""

from __future__ import annotations

import asyncio
import json
import os

from ..client.rados import IoCtx, RadosError
from ..client.striper import Layout, map_extents

RBD_DIRECTORY = "rbd_directory"
RBD_CHILDREN = "rbd_children"
LOCK_NAME = "rbd_lock"
LOCK_RENEW_S = 10.0
LOCK_DURATION_S = 30.0


class RbdError(Exception):
    def __init__(self, errno_name: str, detail: str = "") -> None:
        super().__init__(f"{errno_name}{': ' + detail if detail else ''}")
        self.errno_name = errno_name


def _wrap(e: RadosError) -> RbdError:
    return RbdError(e.errno_name, str(e))


def _header(iid: str) -> str:
    return f"rbd_header.{iid}"


class RBD:
    """Image management entry points (librbd.h rbd_create/list/remove)."""

    async def create(self, ioctx, name: str, size: int, order: int = 22,
                     stripe_unit: int | None = None,
                     stripe_count: int = 1,
                     features: list[str] | None = None) -> str:
        iid = os.urandom(8).hex()
        try:
            await ioctx.exec(RBD_DIRECTORY, "rbd", "dir_add_image",
                             json.dumps({"name": name,
                                         "id": iid}).encode())
        except RadosError as e:
            raise _wrap(e) from e
        try:
            await ioctx.exec(_header(iid), "rbd", "create", json.dumps({
                "size": int(size), "order": order,
                "object_prefix": f"rbd_data.{iid}",
                "features": features or ["layering"],
                "stripe_unit": stripe_unit or (1 << order),
                "stripe_count": stripe_count}).encode())
        except RadosError as e:
            # roll the directory entry back so a failed create does not
            # leave a dangling name
            await ioctx.exec(RBD_DIRECTORY, "rbd", "dir_remove_image",
                             json.dumps({"name": name}).encode())
            raise _wrap(e) from e
        return iid

    async def list(self, ioctx) -> list[str]:
        try:
            out = await ioctx.exec(RBD_DIRECTORY, "rbd", "dir_list", b"")
        except RadosError as e:
            if e.errno_name == "ENOENT":
                return []
            raise _wrap(e) from e
        return sorted(json.loads(out))

    async def remove(self, ioctx, name: str) -> None:
        img = await Image.open(ioctx, name, read_only=True,
                               admin=True)
        try:
            from .migration import (MIG_DST_XATTR, MIG_SRC_XATTR,
                                    _get_marker)
            for xattr in (MIG_SRC_XATTR, MIG_DST_XATTR):
                if await _get_marker(ioctx, img.id, xattr):
                    raise RbdError(
                        "EBUSY", "image is migrating "
                                 "(commit or abort first)")
            if any(s.get("protected") for s in img.meta["snapshots"]):
                raise RbdError("EBUSY", "image has protected snapshots")
            if img.meta["snapshots"]:
                raise RbdError("ENOTEMPTY",
                               "image has snapshots (remove them first)")
            if img.meta.get("parent"):
                p = img.meta["parent"]
                await ioctx.exec(RBD_CHILDREN, "rbd", "remove_child",
                                 json.dumps({**p,
                                             "child_id": img.id}).encode())
            n_objs = img._object_count(img.meta["size"])
            await _gather_bounded(
                [img._remove_data_obj(i) for i in range(n_objs)])
        finally:
            await img.close()
        # feature sidecars die with the image (journal payloads and
        # object maps have no other owner)
        from .features import journal_oid, object_map_oid
        for oid in (journal_oid(img.id), object_map_oid(img.id)):
            try:
                await ioctx.remove(oid)
            except RadosError:
                pass
        try:
            await ioctx.remove(_header(img.id))
            await ioctx.exec(RBD_DIRECTORY, "rbd", "dir_remove_image",
                             json.dumps({"name": name}).encode())
        except RadosError as e:
            raise _wrap(e) from e

    async def clone(self, parent_ioctx, parent_name: str,
                    snap_name: str, child_ioctx, child_name: str,
                    order: int | None = None) -> str:
        """COW clone of a PROTECTED parent snapshot
        (librbd::clone, src/librbd/image/CloneRequest.cc)."""
        p = await Image.open(parent_ioctx, parent_name, read_only=True)
        try:
            snap = p._snap_by_name(snap_name)
            if not snap.get("protected"):
                raise RbdError("EINVAL", "parent snap is not protected")
            child_order = order or p.meta["order"]
            iid = await self.create(child_ioctx, child_name,
                                    snap["size"], order=child_order)
            await child_ioctx.exec(
                _header(iid), "rbd", "set_parent", json.dumps({
                    "pool_id": parent_ioctx.pool_id, "image_id": p.id,
                    "snap_id": snap["id"],
                    "overlap": snap["size"]}).encode())
            await parent_ioctx.exec(
                RBD_CHILDREN, "rbd", "add_child", json.dumps({
                    "pool_id": parent_ioctx.pool_id, "image_id": p.id,
                    "snap_id": snap["id"], "child_id": iid}).encode())
            return iid
        except RadosError as e:
            raise _wrap(e) from e
        finally:
            await p.close()


async def _gather_bounded(coros, limit: int = 16):
    """Bounded-concurrency gather: image-wide sweeps (remove, flatten,
    rollback) touch every object and would otherwise flood the cluster
    with one op per object at once."""
    sem = asyncio.Semaphore(limit)

    async def one(c):
        async with sem:
            return await c
    return await asyncio.gather(*(one(c) for c in coros))


class Image:
    """An open image handle (librbd::Image).

    Use ``await Image.open(ioctx, name)``; close() releases the
    exclusive lock and stops its renewal.
    """

    def __init__(self, ioctx, name: str, iid: str, meta: dict,
                 read_only: bool, snap_id: int | None) -> None:
        self.ioctx = ioctx
        self.name = name
        self.id = iid
        self.meta = meta
        self.read_only = read_only
        self.snap_id = snap_id
        self._cookie = os.urandom(4).hex()
        self._watch_cookie = None
        self._renew_task: asyncio.Task | None = None
        self._parent: Image | None = None
        self._closed = False
        self._fenced = False
        # write-back cache (ObjectCacher), bound at open(cache=True)
        self.cacher = None
        # DATA-path ioctx: plain, or a CryptoIoCtx when the image is
        # encrypted (crypto sits below the cache, above the wire)
        self._dio = ioctx
        self._no_data_key = False
        # live migration: destination images fall through to the
        # source for not-yet-copied data (librbd/migration)
        self._mig_marker: dict | None = None
        self._mig_src: "Image | None" = None
        # feature handles (object-map / journaling), bound at open
        from .features import (FEATURE_JOURNALING, FEATURE_OBJECT_MAP,
                               ImageJournal, ObjectMap)
        feats = set(meta.get("features", []))
        self.object_map = (ObjectMap(self)
                           if FEATURE_OBJECT_MAP in feats else None)
        self.journal = (ImageJournal(ioctx, iid)
                        if FEATURE_JOURNALING in feats else None)

    # -- open/close ---------------------------------------------------------
    @staticmethod
    async def open(ioctx, name: str, snapshot: str | None = None,
                   read_only: bool = False,
                   exclusive: bool = True,
                   cache: bool = False,
                   passphrase: str | None = None,
                   admin: bool = False) -> "Image":
        """``exclusive=False`` opens writable WITHOUT taking the image
        lock -- for snapshot-only administrative handles (rbd-mirror
        snapshots a live image without stealing the client's lock; the
        header mutations are atomic cls ops).  Data writes through a
        non-exclusive handle forgo single-writer protection.

        ``cache=True`` puts an ObjectCacher under the data path
        (rbd_cache): writes ack from cache and flush in the
        background or at barriers (flush/close/snap/lock-loss); safe
        only under the exclusive lock, which guarantees the single
        writer the cache assumes."""
        try:
            iid = (await ioctx.exec(
                RBD_DIRECTORY, "rbd", "dir_get_id",
                json.dumps({"name": name}).encode())).decode()
            meta = json.loads(await ioctx.exec(
                _header(iid), "rbd", "get_image_meta", b""))
        except RadosError as e:
            raise _wrap(e) from e
        # every image gets a PRIVATE ioctx: the snap context installed
        # by _refresh_snapc is per-ioctx state, and a second image
        # opened on a shared ioctx would clobber the first image's
        # write snapc (silently skipping COW for its snapshots)
        ioctx = IoCtx(ioctx.rados, ioctx.pool_name, ioctx.pool_id)
        snap_id = None
        img = Image(ioctx, name, iid, meta, read_only or bool(snapshot),
                    snap_id)
        # encryption gate BEFORE any data I/O: an encrypted image
        # without its passphrase must refuse, not serve ciphertext
        from .crypto import (CryptoIoCtx, ENVELOPE_XATTR,
                             WrongPassphrase, unwrap_key)
        try:
            env_raw = await ioctx.get_xattr(_header(iid),
                                            ENVELOPE_XATTR)
        except RadosError as e:
            # ONLY absence means unencrypted; a transient error must
            # not bypass the gate and serve ciphertext as plaintext
            if e.errno_name not in ("ENOENT", "ENODATA"):
                raise _wrap(e) from e
            env_raw = None
        if env_raw and passphrase is None:
            if not admin:
                raise RbdError(
                    "EPERM", "image is encrypted; passphrase required")
            # administrative handle (remove, status): may touch
            # metadata and delete objects, but data I/O is refused --
            # it would serve ciphertext as plaintext
            img._no_data_key = True
        if passphrase is not None:
            if not env_raw:
                raise RbdError("EINVAL", "image is not encrypted")
            try:
                key = unwrap_key(json.loads(env_raw), passphrase)
            except WrongPassphrase as e:
                raise RbdError("EPERM", str(e)) from e
            img._dio = CryptoIoCtx(img.ioctx, key)
        if snapshot is not None:
            img.snap_id = img._snap_by_name(snapshot)["id"]
        from .migration import (MIG_DST_XATTR, MIG_SRC_XATTR,
                                _get_marker)
        img._mig_marker, mig_dst = await asyncio.gather(
            _get_marker(ioctx, iid, MIG_SRC_XATTR),
            _get_marker(ioctx, iid, MIG_DST_XATTR))
        if not img.read_only and mig_dst:
            # this image is the SOURCE of a live migration: clients
            # must use the destination; the source serves reads only
            img.read_only = True
        if not img.read_only and exclusive:
            await img._acquire_lock()
            if img.journal is not None:
                # the journal is AUTHORITATIVE: events appended by a
                # writer that died before applying them locally replay
                # on the next open (librbd journal::Replay), so the
                # primary can never lag its own journal (and never
                # diverge from a mirror that already replayed them)
                await img._journal_local_replay()
            # header watch (librbd's ImageWatcher): another client's
            # snap/resize refreshes OUR snap context before their op
            # completes -- writing with a stale snapc would skip the
            # COW that keeps the new snapshot frozen
            img._watch_cookie = await img.ioctx.watch(
                _header(img.id), img._on_header_notify)
            if cache:
                from ..client.object_cacher import ObjectCacher
                img.cacher = ObjectCacher(img._dio)
        await img._refresh_snapc()
        return img

    async def encryption_format(self, passphrase: str) -> None:
        """Format THIS image for encryption (rbd encryption format):
        writes the LUKS-style envelope and switches the data path to
        AES-XTS.  Only valid on a fresh image -- existing plaintext
        data is not re-encrypted (the reference has the same rule)."""
        from .crypto import (CryptoIoCtx, ENVELOPE_XATTR,
                             format_encryption)
        self._writable_or_raise()
        try:
            existing = await self.ioctx.get_xattr(_header(self.id),
                                                  ENVELOPE_XATTR)
        except RadosError as e:
            if e.errno_name not in ("ENOENT", "ENODATA"):
                raise _wrap(e) from e
            existing = None
        if existing:
            raise RbdError("EEXIST", "image is already encrypted")
        key = await format_encryption(self.ioctx, _header(self.id),
                                      passphrase)
        self._dio = CryptoIoCtx(self.ioctx, key)
        if self.cacher is not None:
            self.cacher.ioctx = self._dio

    async def _on_header_notify(self, payload: bytes) -> None:
        try:
            if self.cacher is not None:
                # another client changed the header (snap/resize): our
                # buffered writes must land under the OLD snapc before
                # we refresh, and cached cleans may be stale
                await self.cacher.invalidate()
            await self._refresh_meta()
            await self._refresh_snapc()
        except RadosError:
            pass                   # next header op retries the refresh

    async def _notify_header(self) -> None:
        """Tell every open handle the header changed (snap created/
        removed, resized); waits for their refresh acks."""
        try:
            await self.ioctx.notify(_header(self.id), b"header-update",
                                    timeout=5.0)
        except RadosError:
            pass                   # no watchers / transient: best effort

    async def flush(self) -> None:
        """Durability barrier (rbd_flush): buffered writes are at the
        OSDs on return."""
        if self.cacher is not None:
            await self.cacher.flush()

    async def close(self) -> None:
        if self._closed:
            return
        flush_err = None
        if self.cacher is not None:
            if self._fenced:
                # a fenced handle's dirty data must DIE: the new lock
                # owner's view wins, and our writes would be refused
                # at the OSDs anyway
                self.cacher.discard_all()
            try:
                await self.cacher.close()
            except BaseException as e:
                # the final flush failed: STILL tear down (lock, watch,
                # renew task -- leaking them blocks other clients), but
                # surface the data loss to the caller
                flush_err = e
        self._closed = True
        if self._renew_task:
            self._renew_task.cancel()
            try:
                await self._renew_task
            except asyncio.CancelledError:
                pass
        if getattr(self, "_watch_cookie", None) is not None:
            try:
                await self.ioctx.unwatch(_header(self.id),
                                         self._watch_cookie)
            except RadosError:
                pass
        if not self.read_only:
            try:
                await self.ioctx.exec(
                    _header(self.id), "lock", "unlock", json.dumps({
                        "name": LOCK_NAME,
                        "cookie": self._cookie}).encode())
            except RadosError:
                pass
        if self._parent is not None:
            await self._parent.close()
            self._parent = None
        if self._mig_src is not None:
            await self._mig_src.close()
            self._mig_src = None
        if flush_err is not None:
            # teardown completed, but the final flush did not land:
            # the caller must know its last writes may be lost
            raise flush_err

    # -- exclusive lock (ManagedLock / cls_lock) ----------------------------
    async def _acquire_lock(self) -> None:
        try:
            await self.ioctx.exec(
                _header(self.id), "lock", "lock", json.dumps({
                    "name": LOCK_NAME, "type": "exclusive",
                    "cookie": self._cookie,
                    "duration": LOCK_DURATION_S,
                    "flags": 1}).encode())       # MAY_RENEW
        except RadosError as e:
            raise RbdError("EBUSY" if e.errno_name == "EBUSY"
                           else e.errno_name,
                           "image is locked by another client") from e
        self._renew_task = asyncio.ensure_future(self._renew_loop())

    JOURNAL_MASTER = "master"

    async def _journal_local_replay(self) -> None:
        await self.journal.register_client(self.JOURNAL_MASTER)
        clients = {c["id"]: c for c in await self.journal.clients()}
        pos = clients[self.JOURNAL_MASTER]["position"]
        entries = await self.journal.entries_after(pos, limit=10000)
        for seq, ev, payload in entries:
            await self._apply_journal_event(ev, payload)
            pos = seq
        if entries:
            await self.journal.commit(self.JOURNAL_MASTER, pos)
            await self.journal.trim()

    async def _apply_journal_event(self, ev: dict,
                                   payload: bytes) -> None:
        """Re-apply one journaled event WITHOUT re-journaling it."""
        jr, self.journal = self.journal, None
        try:
            op = ev.get("op")
            if op == "write":
                if ev["off"] + len(payload) > self.meta["size"]:
                    await self.resize(ev["off"] + len(payload))
                await self.write(ev["off"], payload)
            elif op == "discard":
                await self.discard(ev["off"], ev["len"])
            elif op == "resize":
                await self.resize(ev["size"])
            elif op == "snap_create":
                try:
                    await self.create_snap(ev["name"])
                except RbdError as e:
                    if e.errno_name != "EEXIST":
                        raise
        finally:
            self.journal = jr

    async def _journal_commit(self, seq: int) -> None:
        """The local apply landed: the master client is caught up."""
        try:
            await self.journal.commit(self.JOURNAL_MASTER, seq)
            await self.journal.trim()
        except RadosError:
            pass          # next open's replay re-applies idempotently

    def _writable_or_raise(self) -> None:
        if self.read_only:
            raise RbdError("EROFS")
        if self._fenced:
            raise RbdError("EBLOCKLISTED",
                           "exclusive lock lost; handle is fenced")

    async def _renew_once(self) -> None:
        try:
            await self.ioctx.exec(
                _header(self.id), "lock", "lock", json.dumps({
                    "name": LOCK_NAME, "type": "exclusive",
                    "cookie": self._cookie,
                    "duration": LOCK_DURATION_S,
                    "flags": 1}).encode())
        except RadosError as e:
            # EBUSY: our lease expired and ANOTHER client holds the
            # lock; ENOENT: the lock/header vanished.  Either way we
            # are no longer the single writer -- fence the handle so
            # no further data write can race the new owner (librbd
            # pairs lock loss with an OSD blocklist of the old client;
            # ManagedLock.cc / image_watcher).
            if e.errno_name in ("EBUSY", "ENOENT"):
                self._fenced = True
                if self.cacher is not None:
                    # lock lost: buffered writes must not land late
                    self.cacher.discard_all()
            # other errors (transient): retried next period
        except (ConnectionError, OSError):
            pass                      # retried next period; expiry wins

    async def _renew_loop(self) -> None:
        while not self._fenced:
            await asyncio.sleep(LOCK_RENEW_S)
            await self._renew_once()

    @staticmethod
    async def break_lock(ioctx, name: str,
                         blocklist: bool = True) -> None:
        """Evict a dead client's exclusive lock (rbd lock break).

        The deposed holder is BLOCKLISTED at the OSDs first: if it is
        wedged rather than dead, its delayed writes must not land on
        an image someone else now owns (rbd lock break pairs with
        'osd blocklist' exactly like this; ManagedLock.cc
        break_lock + blacklist)."""
        iid = (await ioctx.exec(RBD_DIRECTORY, "rbd", "dir_get_id",
                                json.dumps({"name": name}).encode())
               ).decode()
        info = json.loads(await ioctx.exec(
            _header(iid), "lock", "get_info",
            json.dumps({"name": LOCK_NAME}).encode()))
        for lk in info["lockers"]:
            if blocklist:
                await ioctx.rados.mon_command(
                    "osd blocklist", {"id": lk["entity"],
                                      "duration": 600})
            await ioctx.exec(_header(iid), "lock", "break_lock",
                             json.dumps({"name": LOCK_NAME,
                                         "locker": lk["entity"],
                                         "cookie": lk["cookie"]}).encode())

    # -- geometry -----------------------------------------------------------
    @property
    def _layout(self) -> Layout:
        osz = 1 << self.meta["order"]
        return Layout(stripe_unit=self.meta.get("stripe_unit", osz),
                      stripe_count=self.meta.get("stripe_count", 1),
                      object_size=osz)

    def _data_obj(self, objectno: int) -> str:
        return f"{self.meta['object_prefix']}.{objectno:016x}"

    def _object_count(self, size: int) -> int:
        if size == 0:
            return 0
        return max(e[0] for e in map_extents(self._layout, 0, size)) + 1

    def _snap_by_name(self, snap_name: str) -> dict:
        for s in self.meta["snapshots"]:
            if s["name"] == snap_name:
                return s
        raise RbdError("ENOENT", f"no snapshot {snap_name}")

    async def _refresh_meta(self) -> None:
        self.meta = json.loads(await self.ioctx.exec(
            _header(self.id), "rbd", "get_image_meta", b""))

    async def _refresh_snapc(self) -> None:
        """Install the image's snap context on the data ioctx so every
        write COWs against the image's snapshots."""
        snapc = json.loads(await self.ioctx.exec(
            _header(self.id), "rbd", "get_snapcontext", b""))
        self.ioctx.set_snap_context(snapc["seq"], snapc["snaps"])

    async def size(self) -> int:
        if self.snap_id is not None:
            for s in self.meta["snapshots"]:
                if s["id"] == self.snap_id:
                    return s["size"]
        return self.meta["size"]

    def stat(self) -> dict:
        return {"size": self.meta["size"], "order": self.meta["order"],
                "id": self.id, "object_prefix": self.meta["object_prefix"],
                "num_objs": self._object_count(self.meta["size"]),
                "parent": self.meta.get("parent"),
                "snapshots": self.meta["snapshots"]}

    # -- parent (clone) plumbing -------------------------------------------
    async def _get_parent(self) -> "Image | None":
        pref = self.meta.get("parent")
        if pref is None:
            return None
        if self._parent is None:
            pools = self.ioctx.objecter.osdmap.pool_names
            pname = next((n for n, i in pools.items()
                          if i == pref["pool_id"]), None)
            if pname is None:
                raise RbdError("ENOENT", "parent pool vanished")
            pioctx = await self.ioctx.rados.open_ioctx(pname)
            meta = json.loads(await pioctx.exec(
                _header(pref["image_id"]), "rbd", "get_image_meta", b""))
            self._parent = Image(pioctx, "", pref["image_id"], meta,
                                 True, pref["snap_id"])
        return self._parent

    async def _mig_source_img(self) -> "Image | None":
        if self._mig_marker is None:
            return None
        if self._mig_src is None:
            from .migration import _open_source
            self._mig_src = await _open_source(self)
        return self._mig_src

    async def _read_below(self, off: int, length: int) -> bytes:
        """Data for a hole: the live-migration source if one exists,
        else the clone parent, else zeros."""
        src = await self._mig_source_img()
        if src is not None:
            n = min(length, max(0, src.meta["size"] - off))
            buf = await src.read(off, n) if n else b""
            return buf + b"\0" * (length - len(buf))
        if self.meta.get("parent"):
            return await self._read_parent(off, length)
        return b"\0" * length

    async def _read_parent(self, off: int, length: int) -> bytes:
        """Read [off, off+length) from the parent snapshot, clipped to
        the overlap; beyond-overlap reads are zeros."""
        parent = await self._get_parent()
        # a shrink below the overlap implicitly truncates it (the
        # reference updates the overlap on resize; clipping reads the
        # same way keeps one source of truth -- the current size)
        overlap = min(self.meta["parent"]["overlap"], self.meta["size"])
        if parent is None or off >= overlap:
            return b"\0" * length
        n = min(length, overlap - off)
        buf = await parent.read(off, n)
        return buf + b"\0" * (length - len(buf))

    # -- data path ----------------------------------------------------------
    async def read(self, off: int, length: int) -> bytes:
        if self._no_data_key:
            raise RbdError("EPERM", "encrypted image opened without "
                                    "its passphrase (admin handle)")
        size = await self.size()
        if off >= size:
            return b""
        length = min(length, size - off)
        lay = self._layout
        extents = map_extents(lay, off, length)

        async def read_one(idx, objectno, obj_off, n):
            if self.cacher is not None and self.snap_id is None:
                logical0 = logical[idx]

                async def miss(o, ln):
                    # miss path inside the cacher: object read with
                    # hole -> parent/zero fallback (clone reads)
                    try:
                        got = await self._dio.read(
                            self._data_obj(objectno), length=ln,
                            offset=o)
                        return got
                    except RadosError as e:
                        if e.errno_name != "ENOENT":
                            raise
                    return await self._read_below(
                        logical0 + (o - obj_off), ln)

                buf = await self.cacher.read(
                    self._data_obj(objectno), obj_off, n, reader=miss)
                return idx, buf, False
            try:
                buf = await self._dio.read(
                    self._data_obj(objectno), length=n, offset=obj_off,
                    snap=self.snap_id)
                return idx, buf + b"\0" * (n - len(buf)), False
            except RadosError as e:
                if e.errno_name != "ENOENT":
                    raise
                return idx, None, True      # hole: maybe parent data

        jobs = []
        logical = []                        # per-extent image offset
        pos = off
        for i, (objectno, obj_off, n) in enumerate(extents):
            jobs.append(read_one(i, objectno, obj_off, n))
            logical.append(pos)
            pos += n
        done = await asyncio.gather(*jobs)
        pieces: list[bytes] = [b""] * len(extents)
        for idx, buf, hole in done:
            if hole:
                n = extents[idx][2]
                buf = await self._read_below(logical[idx], n)
            pieces[idx] = buf
        return b"".join(pieces)

    async def _copyup(self, objectno: int) -> None:
        """First write to a clone's missing object: materialize the
        parent's bytes for the whole object first (CopyupRequest)."""
        lay = self._layout
        obj_logical = objectno * lay.object_size   # sc==1 path
        if self._mig_marker is not None:
            bound = self.meta["size"]
        else:
            bound = min(self.meta["parent"]["overlap"],
                        self.meta["size"])
        if obj_logical >= bound:
            return
        n = min(lay.object_size, bound - obj_logical)
        buf = await self._read_below(obj_logical, n)
        if buf.strip(b"\0"):
            try:
                await self._copyup_atomic(self._data_obj(objectno),
                                          buf)
            except RadosError as e:
                raise _wrap(e) from e

    async def _copyup_atomic(self, oid: str, buf: bytes) -> None:
        """Materialize an object from below-data ONLY if still absent
        (cls rbd copyup): atomic at the OSD, so a migration copier and
        a live client writer can race -- first creator wins, the other
        no-ops and never clobbers newer data.  Encrypted images ship
        the payload pre-encrypted (the cls path bypasses CryptoIoCtx)."""
        if self._dio is not self.ioctx:
            buf = self._dio.encrypt_full(oid, buf)
        await self.ioctx.exec(oid, "rbd", "copyup", bytes(buf))

    async def write(self, off: int, data: bytes) -> int:
        if self._no_data_key:
            raise RbdError("EPERM", "encrypted image opened without "
                                    "its passphrase (admin handle)")
        self._writable_or_raise()
        size = self.meta["size"]
        if off + len(data) > size:
            raise RbdError("EINVAL", "write past end of image")
        lay = self._layout
        has_parent = bool(self.meta.get("parent")) \
            or self._mig_marker is not None
        jseq = None
        if self.journal is not None:
            # journal-safe ordering: the event is durable BEFORE the
            # image mutates; the master position commits after the
            # local apply, so a crash in between replays it on reopen
            jseq = await self.journal.append(
                {"op": "write", "off": off, "len": len(data)},
                bytes(data))

        async def write_one(objectno, obj_off, piece):
            if self.object_map is not None:
                await self.object_map.mark_written(objectno)
            if has_parent and lay.stripe_count == 1:
                try:
                    await self.ioctx.stat(self._data_obj(objectno))
                except RadosError as e:
                    if e.errno_name == "ENOENT":
                        await self._copyup(objectno)
                    else:
                        raise
            if self.cacher is not None:
                await self.cacher.write(self._data_obj(objectno),
                                        obj_off, piece)
            else:
                await self._dio.write(self._data_obj(objectno),
                                      piece, offset=obj_off)

        jobs = []
        pos = 0
        for objectno, obj_off, n in map_extents(lay, off, len(data)):
            jobs.append(write_one(objectno, obj_off,
                                  data[pos:pos + n]))
            pos += n
        try:
            await asyncio.gather(*jobs)
        except RadosError as e:
            raise _wrap(e) from e
        if jseq is not None:
            await self._journal_commit(jseq)
        return len(data)

    async def discard(self, off: int, length: int) -> None:
        """Deallocate a range: whole objects are removed, partial
        ranges zeroed (ImageRequest discard)."""
        self._writable_or_raise()
        if self.cacher is not None:
            # buffered writes ordered BEFORE the discard must land
            # first; cached extents in the range are then stale (the
            # flusher must never resurrect a discarded object)
            await self.cacher.flush()
            lay0 = self._layout
            for objectno, _, _ in map_extents(lay0, off, length):
                self.cacher.discard(self._data_obj(objectno))
        lay = self._layout
        has_parent = bool(self.meta.get("parent")) \
            or self._mig_marker is not None
        jseq = None
        if self.journal is not None:
            jseq = await self.journal.append(
                {"op": "discard", "off": off, "len": length})

        async def one(objectno, obj_off, n):
            oid = self._data_obj(objectno)
            try:
                if obj_off == 0 and n == lay.object_size \
                        and not has_parent:
                    await self.ioctx.remove(oid)
                    if self.object_map is not None:
                        await self.object_map.mark_removed(objectno)
                    return
                if has_parent and lay.stripe_count == 1:
                    # an absent clone object must copyup first: a bare
                    # zero() is a no-op on a missing object and reads
                    # would fall through to PARENT bytes, not zeros
                    try:
                        await self.ioctx.stat(oid)
                    except RadosError as e:
                        if e.errno_name != "ENOENT":
                            raise
                        await self._copyup(objectno)
                await self._dio.zero(oid, obj_off, n)
            except RadosError as e:
                if e.errno_name != "ENOENT":
                    raise
        try:
            await _gather_bounded(
                [one(*e) for e in map_extents(lay, off, length)])
        except RadosError as e:
            raise _wrap(e) from e
        if jseq is not None:
            await self._journal_commit(jseq)

    async def _remove_data_obj(self, objectno: int) -> None:
        try:
            await self.ioctx.remove(self._data_obj(objectno))
        except RadosError as e:
            if e.errno_name != "ENOENT":
                raise

    # -- resize -------------------------------------------------------------
    async def resize(self, new_size: int) -> None:
        self._writable_or_raise()
        if self.cacher is not None and new_size < self.meta["size"]:
            # flush buffered writes, then drop cached state for every
            # object past the new boundary (and the boundary object:
            # its cached tail is gone)
            await self.cacher.flush()
            for i in range(max(0, self._object_count(new_size) - 1),
                           self._object_count(self.meta["size"])):
                self.cacher.discard(self._data_obj(i))
        jseq = None
        if self.journal is not None:
            jseq = await self.journal.append(
                {"op": "resize", "size": int(new_size)})
        old = self.meta["size"]
        if new_size < old:
            lay = self._layout
            keep = self._object_count(new_size)
            total = self._object_count(old)
            # trim the boundary object, drop the rest
            if new_size % lay.object_size and keep:
                boundary = self._data_obj(keep - 1)
                try:
                    await self._dio.truncate(
                        boundary, new_size % lay.object_size)
                except RadosError as e:
                    if e.errno_name != "ENOENT":
                        raise _wrap(e) from e
            await _gather_bounded(
                [self._remove_data_obj(i) for i in range(keep, total)])
            if self.object_map is not None:
                await self.object_map.truncate(keep)
        await self.ioctx.exec(_header(self.id), "rbd", "set_size",
                              json.dumps({"size": new_size}).encode())
        if jseq is not None:
            await self._journal_commit(jseq)
        await self._refresh_meta()
        await self._notify_header()

    # -- snapshots -----------------------------------------------------------
    async def create_snap(self, snap_name: str) -> int:
        self._writable_or_raise()
        if self._mig_marker is not None:
            # a snap of a half-materialized destination would change
            # content after commit (holes fall through to the source
            # HEAD, which then disappears)
            raise RbdError("EBUSY",
                           "cannot snapshot a migrating image")
        if self.cacher is not None:
            # the snapshot must contain every write acked before it:
            # cached dirty data lands under the PRE-snap snapc first
            await self.cacher.flush()
        jseq = None
        if self.journal is not None:
            jseq = await self.journal.append(
                {"op": "snap_create", "name": snap_name})
        sid = await self.ioctx.selfmanaged_snap_create()
        try:
            await self.ioctx.exec(
                _header(self.id), "rbd", "snapshot_add",
                json.dumps({"snap_id": sid,
                            "name": snap_name}).encode())
        except RadosError as e:
            await self.ioctx.selfmanaged_snap_remove(sid)
            raise _wrap(e) from e
        if self.object_map is not None:
            # freeze the map under this snap id; head entries go CLEAN
            await self.object_map.snapshot(sid)
        if jseq is not None:
            await self._journal_commit(jseq)
        await self._refresh_meta()
        await self._refresh_snapc()
        await self._notify_header()
        return sid

    async def remove_snap(self, snap_name: str) -> None:
        self._writable_or_raise()
        snap = self._snap_by_name(snap_name)
        kids = json.loads(await self.ioctx.exec(
            RBD_CHILDREN, "rbd", "list_children", json.dumps({
                "pool_id": self.ioctx.pool_id, "image_id": self.id,
                "snap_id": snap["id"]}).encode()))
        if kids:
            raise RbdError("EBUSY", f"snap has {len(kids)} children")
        if self.object_map is not None:
            from .features import object_map_oid
            try:
                await self.ioctx.remove(
                    object_map_oid(self.id, snap["id"]))
            except RadosError:
                pass
        try:
            await self.ioctx.exec(
                _header(self.id), "rbd", "snapshot_remove",
                json.dumps({"snap_id": snap["id"]}).encode())
        except RadosError as e:
            raise _wrap(e) from e
        await self.ioctx.selfmanaged_snap_remove(snap["id"])
        await self._refresh_meta()
        await self._refresh_snapc()
        await self._notify_header()

    async def protect_snap(self, snap_name: str) -> None:
        snap = self._snap_by_name(snap_name)
        await self.ioctx.exec(_header(self.id), "rbd",
                              "snapshot_protect",
                              json.dumps({"snap_id": snap["id"]}).encode())
        await self._refresh_meta()

    async def unprotect_snap(self, snap_name: str) -> None:
        snap = self._snap_by_name(snap_name)
        kids = json.loads(await self.ioctx.exec(
            RBD_CHILDREN, "rbd", "list_children", json.dumps({
                "pool_id": self.ioctx.pool_id, "image_id": self.id,
                "snap_id": snap["id"]}).encode()))
        if kids:
            raise RbdError("EBUSY", f"snap has {len(kids)} children")
        await self.ioctx.exec(_header(self.id), "rbd",
                              "snapshot_unprotect",
                              json.dumps({"snap_id": snap["id"]}).encode())
        await self._refresh_meta()

    def list_snaps(self) -> list[dict]:
        return list(self.meta["snapshots"])

    async def rollback_snap(self, snap_name: str) -> None:
        """Rewrite head data from the snapshot (Operations::snap_rollback).
        Object-by-object copy of the snap content over the head."""
        self._writable_or_raise()
        snap = self._snap_by_name(snap_name)
        lay = self._layout
        await self.resize(snap["size"])
        n_objs = self._object_count(snap["size"])

        async def roll(objectno):
            oid = self._data_obj(objectno)
            try:
                buf = await self.ioctx.read(oid, snap=snap["id"])
                await self.ioctx.write_full(oid, buf)
            except RadosError as e:
                if e.errno_name != "ENOENT":
                    raise
                await self._remove_data_obj(objectno)
        try:
            await _gather_bounded([roll(i) for i in range(n_objs)])
        except RadosError as e:
            raise _wrap(e) from e

    # -- flatten -------------------------------------------------------------
    async def flatten(self) -> None:
        """Copy all parent data up, then sever the parent link
        (librbd::Operations::flatten)."""
        self._writable_or_raise()
        pref = self.meta.get("parent")
        if pref is None:
            raise RbdError("EINVAL", "image has no parent")
        n_objs = self._object_count(
            min(pref["overlap"], self.meta["size"]))

        async def up(objectno):
            try:
                await self.ioctx.stat(self._data_obj(objectno))
            except RadosError as e:
                if e.errno_name == "ENOENT":
                    await self._copyup(objectno)
                else:
                    raise
        try:
            await _gather_bounded([up(i) for i in range(n_objs)])
            await self.ioctx.exec(_header(self.id), "rbd",
                                  "remove_parent", b"")
            parent = await self._get_parent()
            await parent.ioctx.exec(
                RBD_CHILDREN, "rbd", "remove_child", json.dumps({
                    **pref, "child_id": self.id}).encode())
        except RadosError as e:
            raise _wrap(e) from e
        if self._parent is not None:
            await self._parent.close()
            self._parent = None
        await self._refresh_meta()

    # -- import/export helpers (rbd CLI) ------------------------------------
    async def export(self, chunk: int = 1 << 22):
        """Async iterator of (offset, bytes) over the whole image."""
        size = await self.size()
        off = 0
        while off < size:
            n = min(chunk, size - off)
            yield off, await self.read(off, n)
            off += n
