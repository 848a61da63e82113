"""cephfs-mirror analog: directory-tree replication between clusters.

The reference's cephfs-mirror (src/tools/cephfs_mirror) replays
configured directory trees from a primary filesystem to a secondary.
This renders the same shape over the CephFS client: a sync cycle
walks the source tree, copies files whose (size, mtime) changed,
creates missing directories, and prunes entries that vanished from
the source; FsMirrorDaemon loops cycles over every configured
directory (the PeerReplayer).

Like the reference's snapshot-diff mode this is eventually-consistent
per cycle; unlike rbd-mirror no point-in-time snapshots are taken
(dir snapshots are future work), so a cycle racing writers may copy a
torn file and repair it on the next cycle.

Port of ``ceph_tpu/mds/fs_mirror.py``, copied: runs over the port's
CephFS.
"""

from __future__ import annotations

import asyncio

from .client import CephFS, FsError

MIRROR_DIRS_OID = "cephfs_mirror_dirs"      # metadata-pool registry


async def fs_mirror_add(meta_ioctx, path: str) -> None:
    await meta_ioctx.set_omap(MIRROR_DIRS_OID, {path: b"enabled"})


async def fs_mirror_remove(meta_ioctx, path: str) -> None:
    from ..client.rados import RadosError
    try:
        await meta_ioctx.rm_omap_keys(MIRROR_DIRS_OID, [path])
    except RadosError as e:
        if e.errno_name != "ENOENT":
            raise


async def fs_mirror_dirs(meta_ioctx) -> list[str]:
    from ..client.rados import RadosError
    try:
        return sorted((await meta_ioctx.get_omap(MIRROR_DIRS_OID)))
    except RadosError as e:
        if e.errno_name == "ENOENT":
            return []
        raise


async def _ensure_dir(fs: CephFS, path: str) -> None:
    try:
        st = await fs.stat(path)
        if st["type"] == "dir":
            return
        await fs.unlink(path)          # file shadowing a dir: replace
    except FsError as e:
        if e.errno_name != "ENOENT":
            raise
    await fs.mkdir(path)


async def fs_mirror_sync(src: CephFS, dst: CephFS,
                         root: str) -> dict:
    """One cycle for one tree; returns {copied, removed, bytes}."""
    copied = removed = nbytes = 0
    await _ensure_dir(dst, root)
    async for dirpath, dirs, files in src.walk(root):
        src_entries = await src.readdir(dirpath)
        try:
            dst_entries = await dst.readdir(dirpath)
        except FsError as e:
            if e.errno_name != "ENOENT":
                raise
            await _ensure_dir(dst, dirpath)
            dst_entries = {}
        # prune entries gone from the source (dirs depth-first via
        # recursion would be costlier; a vanished dir prunes bottom-up
        # over successive cycles, which converges)
        for name, dent in dst_entries.items():
            if name not in src_entries:
                full = f"{dirpath.rstrip('/')}/{name}"
                try:
                    if dent["type"] == "dir":
                        await dst.rmdir(full)
                    else:
                        await dst.unlink(full)
                    removed += 1
                except FsError:
                    pass               # non-empty dir: next cycle
        for name in dirs:
            await _ensure_dir(dst, f"{dirpath.rstrip('/')}/{name}")
        for name in files:
            full = f"{dirpath.rstrip('/')}/{name}"
            sd = src_entries.get(name)
            if sd is None:
                continue      # deleted between walk and this listing
            dd = dst_entries.get(name)
            if dd is not None and dd["type"] == "file" \
                    and dd.get("size") == sd.get("size") \
                    and dd.get("mtime") == sd.get("mtime"):
                continue               # unchanged
            data = await src.read_file(full)
            f = await dst.open(full, "w")
            try:
                if data:
                    await f.write(data, 0)
            finally:
                await f.close()
            # carry the source mtime so the next cycle sees it as
            # unchanged (the reference preserves attrs the same way)
            await dst._request({"op": "setattr", "path": full,
                                "attrs": {"mtime": sd.get("mtime", 0),
                                          "size": len(data)}})
            copied += 1
            nbytes += len(data)
    return {"copied": copied, "removed": removed, "bytes": nbytes}


class FsMirrorDaemon:
    """PeerReplayer: primary fs -> secondary fs, all configured dirs."""

    def __init__(self, src: CephFS, dst: CephFS,
                 interval: float = 10.0) -> None:
        self.src = src
        self.dst = dst
        self.interval = interval
        self.stats: dict[str, dict] = {}
        self._task: asyncio.Task | None = None

    async def sync_all(self) -> dict:
        dirs = await fs_mirror_dirs(self.src.meta)
        for path in dirs:
            try:
                self.stats[path] = await fs_mirror_sync(
                    self.src, self.dst, path)
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 -- per-dir isolation
                self.stats[path] = {
                    "error": f"{type(e).__name__}: {e}"}
        self.stats = {k: v for k, v in self.stats.items() if k in dirs}
        return dict(self.stats)

    def start(self) -> None:
        if self._task is None or self._task.done():
            self._task = asyncio.ensure_future(self._loop())

    async def _loop(self) -> None:
        while True:
            try:
                await self.sync_all()
            except asyncio.CancelledError:
                return
            except Exception as e:  # noqa: BLE001 -- keep replaying
                self.stats["_daemon_error"] = {
                    "error": f"{type(e).__name__}: {e}"}
            try:
                await asyncio.sleep(self.interval)
            except asyncio.CancelledError:
                return

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
