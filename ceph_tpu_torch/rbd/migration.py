"""rbd live migration: move an image while it stays usable.

src/librbd/migration role (prepare / execute / commit / abort):

  * prepare: create the DESTINATION image (same geometry) carrying a
    migration-source pointer; mark the SOURCE migrating (new opens of
    it are forced read-only).  From here clients use the destination:
    reads of not-yet-copied objects FALL THROUGH to the source (the
    same hole->source dispatch clone reads use), writes land on the
    destination after a copyup of the source object.
  * execute: background deep-copy of every remaining object (bounded
    concurrency) through the image APIs, atomic per object (cls
    copyup) so it races live client writes safely.  Encrypted images
    are refused at prepare (passphrase plumbing through the lazy
    source fall-through is future work).
  * commit: source is removed and the pointer dropped -- the
    destination stands alone.
  * abort: destination is removed and the source unmarked.

Markers ride header xattrs (like the encryption envelope):
``rbd.migration_source`` on the destination (JSON: pool/name/state),
``rbd.migration_target`` on the source.

Port of ``ceph_tpu/rbd/migration.py``; runs unchanged over the
port's librados.
"""

from __future__ import annotations

import json

from ..client.rados import RadosError
from .rbd import RBD, Image, RbdError, _gather_bounded, _header

MIG_SRC_XATTR = "rbd.migration_source"
MIG_DST_XATTR = "rbd.migration_target"


async def _get_marker(ioctx, iid: str, xattr: str) -> dict | None:
    try:
        raw = await ioctx.get_xattr(_header(iid), xattr)
    except RadosError as e:
        if e.errno_name not in ("ENOENT", "ENODATA"):
            raise
        return None
    return json.loads(raw) if raw else None


async def migration_prepare(src_ioctx, src_name: str,
                            dst_ioctx, dst_name: str) -> str:
    """Create the destination and link both ends.  The source must
    have no active writer (we take its exclusive lock transiently)."""
    # encrypted sources are refused BEFORE the open (whose passphrase
    # gate would otherwise answer EPERM and confuse the caller)
    from .crypto import ENVELOPE_XATTR
    sid = (await src_ioctx.exec(
        "rbd_directory", "rbd", "dir_get_id",
        json.dumps({"name": src_name}).encode())).decode()
    try:
        env = await src_ioctx.get_xattr(_header(sid), ENVELOPE_XATTR)
    except RadosError:
        env = None
    if env:
        raise RbdError("EOPNOTSUPP",
                       "encrypted image migration not supported")
    src = await Image.open(src_ioctx, src_name)   # excludes writers
    try:
        if await _get_marker(src_ioctx, src.id, MIG_DST_XATTR):
            raise RbdError("EBUSY", "already migrating")
        dst_id = await RBD().create(
            dst_ioctx, dst_name, src.meta["size"],
            order=src.meta["order"],
            features=src.meta.get("features"))
        await dst_ioctx.set_xattr(
            _header(dst_id), MIG_SRC_XATTR, json.dumps({
                "pool": src_ioctx.pool_name, "image": src_name,
                "image_id": src.id, "state": "prepared"}).encode())
        await src_ioctx.set_xattr(
            _header(src.id), MIG_DST_XATTR, json.dumps({
                "pool": dst_ioctx.pool_name, "image": dst_name,
                "image_id": dst_id, "state": "prepared"}).encode())
        return dst_id
    finally:
        await src.close()


async def _open_source(dst_img: Image) -> Image | None:
    marker = await _get_marker(dst_img.ioctx, dst_img.id,
                               MIG_SRC_XATTR)
    if marker is None:
        return None
    from ..client.rados import IoCtx
    sio = IoCtx(dst_img.ioctx.rados, marker["pool"],
                dst_img.ioctx.rados.objecter.osdmap.pool_names[
                    marker["pool"]])
    return await Image.open(sio, marker["image"], read_only=True,
                            exclusive=False)


async def migration_execute(dst_ioctx, dst_name: str) -> int:
    """Deep-copy all source data into the destination; returns bytes
    copied.  Safe to run while clients write to the destination: a
    client write that already landed wins (copy skips ranges the
    destination already has)."""
    # exclusive=False: the copier runs WHILE a client holds the
    # destination's lock and keeps writing (that is the "live" part);
    # per-object safety comes from the atomic cls copyup below
    dst = await Image.open(dst_ioctx, dst_name, exclusive=False)
    try:
        src = await _open_source(dst)
        if src is None:
            raise RbdError("EINVAL", f"{dst_name} is not migrating")
        try:
            size = src.meta["size"]
            lay = dst._layout
            copied = 0

            async def copy_object(objectno: int) -> int:
                obj_off = objectno * lay.object_size
                n = min(lay.object_size, size - obj_off)
                if n <= 0:
                    return 0
                oid = dst._data_obj(objectno)
                try:
                    await dst.ioctx.stat(oid)
                    return 0      # already materialized: skip the
                                  # source read entirely (re-runs,
                                  # client-written objects)
                except RadosError as e:
                    if e.errno_name != "ENOENT":
                        raise
                buf = await src.read(obj_off, n)
                if buf.strip(b"\0"):
                    # write-if-missing, atomic at the OSD: a racing
                    # client write (which copied up first) wins and
                    # this stale source copy no-ops
                    await dst._copyup_atomic(oid, buf)
                    return len(buf)
                return 0

            n_objs = dst._object_count(size)
            results = await _gather_bounded(
                [copy_object(i) for i in range(n_objs)])
            copied = sum(results)
            marker = await _get_marker(dst.ioctx, dst.id,
                                       MIG_SRC_XATTR)
            marker["state"] = "executed"
            await dst.ioctx.set_xattr(_header(dst.id), MIG_SRC_XATTR,
                                      json.dumps(marker).encode())
            return copied
        finally:
            await src.close()
    finally:
        await dst.close()


async def migration_commit(dst_ioctx, dst_name: str) -> None:
    """Drop the source; the destination stands alone."""
    dst = await Image.open(dst_ioctx, dst_name)
    try:
        marker = await _get_marker(dst.ioctx, dst.id, MIG_SRC_XATTR)
        if marker is None:
            raise RbdError("EINVAL", f"{dst_name} is not migrating")
        if marker.get("state") != "executed":
            raise RbdError("EBUSY", "execute the migration first")
        src = await _open_source(dst)
        sio = src.ioctx
        sname = marker["image"]
        # unmark the source FIRST so its removal is permitted
        await sio.rm_xattr(_header(src.id), MIG_DST_XATTR)
        await src.close()
        await RBD().remove(sio, sname)
        await dst.ioctx.rm_xattr(_header(dst.id), MIG_SRC_XATTR)
        dst._mig_marker = None
    finally:
        await dst.close()


async def migration_abort(dst_ioctx, dst_name: str) -> None:
    """Tear the destination down and free the source."""
    dst = await Image.open(dst_ioctx, dst_name)
    marker = await _get_marker(dst.ioctx, dst.id, MIG_SRC_XATTR)
    await dst.close()
    if marker is None:
        raise RbdError("EINVAL", f"{dst_name} is not migrating")
    from ..client.rados import IoCtx
    sio = IoCtx(dst_ioctx.rados, marker["pool"],
                dst_ioctx.rados.objecter.osdmap.pool_names[
                    marker["pool"]])
    # clear BOTH markers before the destination removal (remove
    # refuses images that still look mid-migration)
    await sio.rm_xattr(_header(marker["image_id"]), MIG_DST_XATTR)
    await dst_ioctx.rm_xattr(_header(dst.id), MIG_SRC_XATTR)
    await RBD().remove(dst_ioctx, dst_name)
