"""rbd-mirror analog: snapshot-based async image replication.

The reference's rbd-mirror (src/tools/rbd_mirror) replays images
between clusters; in snapshot mode it creates mirror snapshots on the
primary and copies the delta between consecutive mirror snapshots to
the secondary.  This module renders that mode:

  * enablement lives in the pool's ``rbd_mirroring`` object omap
    (image name -> enabled), the mirroring config store analog;
  * each sync cycle snapshots the primary (``.mirror.<n>``), computes
    the per-object delta against the previous mirror snapshot by
    reading both snapshots, applies it to the secondary image, and
    snapshots the secondary at the same name -- so the secondary
    always holds a crash-consistent point-in-time copy;
  * MirrorDaemon loops sync cycles over every enabled image between
    two clusters (the per-pool replayer).

The secondary is not writable by clients during mirroring (the
reference enforces this with the NON_PRIMARY flag; here the operator
contract is the same).

Port of ``ceph_tpu/rbd/mirror.py``; runs unchanged over the
port's librados.
"""

from __future__ import annotations

import asyncio

from ..client.rados import RadosError
from .rbd import RBD, Image, RbdError

MIRROR_OID = "rbd_mirroring"
SNAP_PREFIX = ".mirror."
SNAP_RETENTION = 2      # mirror snaps kept per side after a sync


async def mirror_enable(ioctx, image_name: str,
                        mode: str = "snapshot") -> None:
    """mode: "snapshot" | "journal" (the reference's per-image mirror
    image mode); each daemon serves only its own mode."""
    if mode not in ("snapshot", "journal"):
        raise RbdError("EINVAL", f"mirror mode {mode!r}")
    await ioctx.set_omap(MIRROR_OID, {image_name: mode.encode()})


async def mirror_disable(ioctx, image_name: str) -> None:
    try:
        await ioctx.rm_omap_keys(MIRROR_OID, [image_name])
    except RadosError as e:
        if e.errno_name != "ENOENT":
            raise       # an unreachable cluster is not "already off"


async def mirror_images(ioctx) -> dict[str, str]:
    """{image_name: mode}; legacy b"enabled" entries read as
    snapshot mode."""
    try:
        omap = await ioctx.get_omap(MIRROR_OID)
    except RadosError as e:
        if e.errno_name == "ENOENT":
            return {}   # registry object not created yet
        raise           # unreachable cluster must not look like "none"
    out = {}
    for name, raw in omap.items():
        mode = raw.decode()
        out[name] = "snapshot" if mode == "enabled" else mode
    return out


async def mirror_enabled(ioctx, mode: str | None = None) -> list[str]:
    imgs = await mirror_images(ioctx)
    return sorted(n for n, m in imgs.items()
                  if mode is None or m == mode)


def _mirror_snaps(img: Image) -> list[tuple[int, str]]:
    out = []
    for s in img.list_snaps():
        if s["name"].startswith(SNAP_PREFIX):
            try:
                seq = int(s["name"][len(SNAP_PREFIX):])
            except ValueError:
                continue     # user snap that merely shares the prefix
            out.append((seq, s["name"]))
    return sorted(out)


async def mirror_sync(src_ioctx, dst_ioctx, image_name: str) -> dict:
    """One replication cycle; returns {snap, objects_copied, bytes}."""
    src = await Image.open(src_ioctx, image_name, read_only=True)
    try:
        prior = _mirror_snaps(src)
        # the delta BASE must be the newest snapshot present on BOTH
        # sides: a primary snap orphaned by a failed sync never reached
        # the secondary, and using it as base would silently lose the
        # un-replicated delta forever
        dst_names: set[str] = set()
        try:
            dimg = await Image.open(dst_ioctx, image_name,
                                    read_only=True)
            dst_names = {s["name"] for s in dimg.list_snaps()}
            await dimg.close()
        except RbdError as e:
            if e.errno_name != "ENOENT":
                raise
        common = [(n, name) for n, name in prior if name in dst_names]
        orphans = [(n, name) for n, name in prior
                   if name not in dst_names]
        prior = common
        seq = max((n for n, _ in common + orphans), default=0) + 1
        snap_name = f"{SNAP_PREFIX}{seq}"
        # snapshot the PRIMARY through a snap-only handle: taking
        # the exclusive lock would make in-use images unreplicable
        # (EBUSY forever while a client holds the image open)
        wsrc = await Image.open(src_ioctx, image_name, exclusive=False)
        try:
            for _, orphan in orphans:    # failed-sync leftovers
                await wsrc.remove_snap(orphan)
            await wsrc.create_snap(snap_name)
        finally:
            await wsrc.close()

        rbd = RBD()
        src_snap = await Image.open(src_ioctx, image_name,
                                    snapshot=snap_name)
        try:
            size = await src_snap.size()
            try:
                dst = await Image.open(dst_ioctx, image_name)
            except RbdError as e:
                if e.errno_name != "ENOENT":
                    raise
                await rbd.create(dst_ioctx, image_name, size,
                                 order=src.meta["order"])
                dst = await Image.open(dst_ioctx, image_name)
            try:
                if orphans and prior:
                    # a previous sync died mid-copy: the secondary HEAD
                    # may hold part of a delta that was never frozen;
                    # rewind it to the last common snapshot so the
                    # base-diff applies onto exactly-base content
                    await dst.rollback_snap(prior[-1][1])
                if await dst.size() != size:
                    await dst.resize(size)
                base = prior[-1][1] if prior else None
                base_img = None
                if base is not None:
                    base_img = await Image.open(src_ioctx, image_name,
                                                snapshot=base)
                copied = nbytes = 0
                step = 1 << src.meta["order"]
                try:
                    off = 0
                    while off < size:
                        n = min(step, size - off)
                        cur = await src_snap.read(off, n)
                        if base_img is not None:
                            old = await base_img.read(off, n)
                            if old == cur:
                                off += n
                                continue
                        await dst.write(off, cur)
                        copied += 1
                        nbytes += n
                        off += n
                finally:
                    if base_img is not None:
                        await base_img.close()
                # freeze the secondary at the same point in time
                await dst.create_snap(snap_name)
                # retention: unbounded mirror snaps would grow the
                # snap context (and COW cost) forever on both sides
                for _, old in _mirror_snaps(dst)[:-SNAP_RETENTION]:
                    await dst.remove_snap(old)
            finally:
                await dst.close()
        finally:
            await src_snap.close()
        wsrc = await Image.open(src_ioctx, image_name,
                                exclusive=False)
        try:
            for _, old in _mirror_snaps(wsrc)[:-SNAP_RETENTION]:
                await wsrc.remove_snap(old)
        finally:
            await wsrc.close()
        return {"snap": snap_name, "objects_copied": copied,
                "bytes": nbytes}
    finally:
        await src.close()


async def mirror_status(ioctx, image_name: str) -> dict:
    img = await Image.open(ioctx, image_name, read_only=True)
    try:
        snaps = _mirror_snaps(img)
        return {"image": image_name,
                "mirror_snaps": [n for _, n in snaps],
                "last_sync": snaps[-1][1] if snaps else None}
    finally:
        await img.close()


class MirrorDaemon:
    """Per-pool replayer: primary cluster -> secondary cluster."""

    def __init__(self, src_ioctx, dst_ioctx,
                 interval: float = 5.0) -> None:
        self.src = src_ioctx
        self.dst = dst_ioctx
        self.interval = interval
        self.stats: dict[str, dict] = {}
        self._task: asyncio.Task | None = None

    async def sync_all(self) -> dict:
        enabled = await mirror_enabled(self.src, mode="snapshot")
        for name in enabled:
            try:
                self.stats[name] = await mirror_sync(self.src, self.dst,
                                                     name)
            except (RbdError, RadosError) as e:
                self.stats[name] = {"error": str(e)}
        # stats for disabled images are not "being replicated"
        self.stats = {k: v for k, v in self.stats.items()
                      if k in enabled}
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
            except Exception as e:
                # replication must not die silently while the launcher
                # keeps running; record and keep cycling
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


# -- journal-based mirroring (src/tools/rbd_mirror journal mode) ------------
# Snapshot mode (above) ships periodic deltas; journal mode tails the
# primary image's event journal and REPLAYS it on the secondary, so
# replication lag is bounded by the tail loop, not the snapshot
# schedule.

async def journal_bootstrap(src_ioctx, dst_ioctx, image_name: str,
                            client_id: str = "mirror") -> dict:
    """Create the secondary image and register as a journal client at
    the CURRENT head: everything before the registration position is
    carried over by a full copy, everything after arrives via replay
    (rbd_mirror ImageReplayer bootstrap)."""
    from .features import ImageJournal
    src = await Image.open(src_ioctx, image_name, read_only=True)
    try:
        jr = ImageJournal(src_ioctx, src.id)
        head = await jr.head_seq()
        rbd = RBD()
        try:
            await rbd.create(dst_ioctx, image_name,
                             src.meta["size"],
                             order=src.meta["order"],
                             features=src.meta.get("features"))
        except RbdError as e:
            if e.errno_name != "EEXIST":
                raise
        dst = await Image.open(dst_ioctx, image_name,
                               exclusive=False)
        # replicated bytes must NOT re-journal on the secondary: its
        # journal has no consumers (untrimmable growth) and a later
        # promotion would replay the whole copy again
        dst.journal = None
        try:
            if dst.meta["size"] != src.meta["size"]:
                await dst.resize(src.meta["size"])
            step = 1 << src.meta["order"]
            for off in range(0, src.meta["size"], step):
                n = min(step, src.meta["size"] - off)
                buf = await src.read(off, n)
                if buf.strip(b"\x00"):
                    await dst.write(off, buf)
                else:
                    # a RE-bootstrap over an existing replica must
                    # clear ranges the primary has since zeroed --
                    # skipping them would leave stale secondary bytes
                    await dst.discard(off, n)
        finally:
            await dst.close()
        await jr.register_client(client_id, position=head)
        return {"position": head}
    finally:
        await src.close()


async def journal_replay_once(src_ioctx, dst_ioctx, image_name: str,
                              client_id: str = "mirror",
                              limit: int = 64) -> int:
    """Replay journal events past our committed position onto the
    secondary; commit + trim.  Returns events applied."""
    from .features import ImageJournal
    src = await Image.open(src_ioctx, image_name, read_only=True)
    try:
        jr = ImageJournal(src_ioctx, src.id)
        clients = {c["id"]: c for c in await jr.clients()}
        if client_id not in clients:
            raise RbdError("ENOENT",
                           f"journal client {client_id} not "
                           f"bootstrapped")
        pos = clients[client_id]["position"]
        entries = await jr.entries_after(pos, limit=limit)
        if not entries:
            return 0
        dst = await Image.open(dst_ioctx, image_name, exclusive=False)
        try:
            for seq, ev, payload in entries:
                # the image's own replay helper: one dispatch switch
                # for primary catch-up and mirror replay, and it masks
                # dst.journal so nothing re-journals on the secondary
                await dst._apply_journal_event(ev, payload)
                pos = seq
        finally:
            await dst.close()
        await jr.commit(client_id, pos)
        await jr.trim()
        return len(entries)
    finally:
        await src.close()


class JournalMirrorDaemon:
    """Tail-and-replay loop for journal-mode images."""

    def __init__(self, src_ioctx, dst_ioctx,
                 interval: float = 0.5) -> None:
        self.src = src_ioctx
        self.dst = dst_ioctx
        self.interval = interval
        self._task: asyncio.Task | None = None
        self._stopped = False

    async def replay_all(self) -> dict:
        out = {}
        for name in await mirror_enabled(self.src, mode="journal"):
            try:
                out[name] = await journal_replay_once(
                    self.src, self.dst, name)
            except (RbdError, RadosError, ConnectionError,
                    OSError) as e:
                out[name] = f"error: {e}"
        return out

    def start(self) -> None:
        if self._task is None or self._task.done():
            self._task = asyncio.ensure_future(self._loop())

    async def _loop(self) -> None:
        try:
            while not self._stopped:
                await self.replay_all()
                await asyncio.sleep(self.interval)
        except asyncio.CancelledError:
            pass

    async def stop(self) -> None:
        self._stopped = True
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
