"""librbd object-map and journaling features.

Object map (src/librbd/object_map/): one state byte per data object in
``rbd_object_map.<iid>`` (head) and ``rbd_object_map.<iid>.<snapid>``
(per snapshot) -- the reference packs 2 bits per object; a byte here
keeps the same state machine legible.  Writes mark objects EXISTS
(dirty) BEFORE touching data, whole-object discards mark NONEXISTENT,
and snap_create freezes a copy then downgrades head entries to
EXISTS_CLEAN -- which is exactly what fast-diff needs: an object
changed since a snapshot iff its head state is dirty EXISTS or its
existence differs from the snap map (DiffIterate's fast path).

Journaling (src/librbd/journal/): every image mutation appends an
event to ``rbd_journal.<iid>`` BEFORE it applies (the reference's
journal-safe ordering), through the cls journal class so sequence
allocation is atomic across writers.  rbd-mirror's journal mode tails
this: a registered client replays write/discard/resize/snap events
onto the secondary and commits its position; trim reclaims what every
client consumed.

Port of ``ceph_tpu/rbd/features.py`` over the port's librados, with one
repair: ``ObjectMap`` serializes its updates, so writes in flight together
no longer lose an object's EXISTS mark.
"""

from __future__ import annotations

import asyncio
import json

from ..client.rados import RadosError

OBJ_NONEXISTENT = 0
OBJ_EXISTS = 1            # written since the last snapshot (dirty)
OBJ_EXISTS_CLEAN = 3      # exists, unchanged since the last snapshot

FEATURE_EXCLUSIVE_LOCK = "exclusive-lock"
FEATURE_OBJECT_MAP = "object-map"
FEATURE_JOURNALING = "journaling"


def object_map_oid(iid: str, snap_id: int | None = None) -> str:
    base = f"rbd_object_map.{iid}"
    return f"{base}.{snap_id}" if snap_id is not None else base


def journal_oid(iid: str) -> str:
    return f"rbd_journal.{iid}"


class ObjectMap:
    """Head object-map handle for one open image.

    Updates are serialized (librbd's ObjectMap updates go through one
    queue): the image's writes run up to 16 at a time, and two first
    loads racing, or two read-modify-write saves interleaving, would
    otherwise lose an object's EXISTS mark."""

    def __init__(self, img) -> None:
        self.img = img
        self._map: bytearray | None = None
        self._lock = asyncio.Lock()

    async def _load(self) -> bytearray:
        if self._map is None:
            try:
                raw = await self.img.ioctx.read(
                    object_map_oid(self.img.id))
            except RadosError:
                raw = b""
            n = self.img._object_count(self.img.meta["size"])
            self._map = bytearray(raw.ljust(n, b"\x00"))
        return self._map

    async def load(self) -> bytearray:
        async with self._lock:
            return await self._load()

    async def _save(self) -> None:
        await self.img.ioctx.write_full(object_map_oid(self.img.id),
                                        bytes(self._map))

    async def set_state(self, objectno: int, state: int) -> None:
        async with self._lock:
            m = await self._load()
            if objectno >= len(m):
                m.extend(b"\x00" * (objectno + 1 - len(m)))
            if m[objectno] != state:
                m[objectno] = state
                await self._save()

    async def mark_written(self, objectno: int) -> None:
        """BEFORE the data write (a crash must err toward EXISTS --
        claiming NONEXISTENT for written data loses it on fast-diff
        copies; the reverse only costs a read)."""
        m = await self.load()
        if objectno >= len(m) or m[objectno] != OBJ_EXISTS:
            await self.set_state(objectno, OBJ_EXISTS)

    async def mark_removed(self, objectno: int) -> None:
        await self.set_state(objectno, OBJ_NONEXISTENT)

    async def truncate(self, n_objects: int) -> None:
        """Shrink the map (image resize down): dropped objects are
        gone, their states must not linger."""
        async with self._lock:
            m = await self._load()
            if len(m) > n_objects:
                del m[n_objects:]
                await self._save()

    async def snapshot(self, snap_id: int) -> None:
        """Freeze the map for a snapshot; head entries downgrade to
        CLEAN so future fast-diff sees exactly the post-snap dirt."""
        async with self._lock:
            m = await self._load()
            await self.img.ioctx.write_full(
                object_map_oid(self.img.id, snap_id), bytes(m))
            for i, st in enumerate(m):
                if st == OBJ_EXISTS:
                    m[i] = OBJ_EXISTS_CLEAN
            await self._save()

    async def states(self) -> bytes:
        return bytes(await self.load())


async def fast_diff(img, from_snap: str | None = None) -> list[int]:
    """Object numbers changed since ``from_snap`` (or since creation):
    DiffIterate's fast path -- object maps only, no data scans."""
    head = bytearray()
    try:
        head = bytearray(await img.ioctx.read(object_map_oid(img.id)))
    except RadosError:
        pass
    if from_snap is None:
        return [i for i, st in enumerate(head)
                if st in (OBJ_EXISTS, OBJ_EXISTS_CLEAN)]
    sid = img._snap_by_name(from_snap)["id"]
    try:
        base = await img.ioctx.read(object_map_oid(img.id, sid))
    except RadosError as e:
        raise RadosError("ENOENT",
                         f"no object map for snap {from_snap}") from e
    out = []
    n = max(len(head), len(base))
    for i in range(n):
        h = head[i] if i < len(head) else OBJ_NONEXISTENT
        b = base[i] if i < len(base) else OBJ_NONEXISTENT
        if h == OBJ_EXISTS or (h == OBJ_NONEXISTENT) != \
                (b == OBJ_NONEXISTENT):
            out.append(i)
    return out


async def disk_usage(img) -> dict:
    """rbd du via the object map: provisioned vs allocated bytes."""
    states = bytearray()
    try:
        states = bytearray(await img.ioctx.read(
            object_map_oid(img.id)))
    except RadosError:
        pass
    osz = 1 << img.meta["order"]
    used = sum(1 for st in states
               if st in (OBJ_EXISTS, OBJ_EXISTS_CLEAN))
    return {"provisioned": img.meta["size"], "used": used * osz}


class ImageJournal:
    """Append/replay handle for one image's journal."""

    def __init__(self, ioctx, iid: str) -> None:
        self.ioctx = ioctx
        self.oid = journal_oid(iid)

    async def append(self, event: dict, payload: bytes = b"") -> int:
        blob = json.dumps(event).encode() + b"\x00" + payload
        seq = await self.ioctx.exec(self.oid, "journal", "append", blob)
        return int(seq)

    async def entries_after(self, position: int,
                            limit: int = 64) -> list[tuple[int, dict,
                                                           bytes]]:
        raw = json.loads(await self.ioctx.exec(
            self.oid, "journal", "get_entries",
            json.dumps({"after": position, "max": limit}).encode()))
        out = []
        for seq, hexblob in raw["entries"]:
            blob = bytes.fromhex(hexblob)
            meta, _, payload = blob.partition(b"\x00")
            out.append((seq, json.loads(meta), payload))
        return out

    async def register_client(self, client_id: str,
                              position: int = -1) -> dict:
        return json.loads(await self.ioctx.exec(
            self.oid, "journal", "client_register",
            json.dumps({"id": client_id,
                        "position": position}).encode()))

    async def commit(self, client_id: str, position: int) -> None:
        await self.ioctx.exec(
            self.oid, "journal", "client_commit",
            json.dumps({"id": client_id,
                        "position": position}).encode())

    async def clients(self) -> list[dict]:
        return json.loads(await self.ioctx.exec(
            self.oid, "journal", "client_list", b""))

    async def trim(self) -> int:
        return int(await self.ioctx.exec(self.oid, "journal", "trim",
                                         b""))

    async def head_seq(self) -> int:
        """Sequence of the newest appended entry (-1 when empty);
        reads only the allocator key, never payloads."""
        nxt = int(await self.ioctx.exec(self.oid, "journal",
                                        "get_seq", b""))
        return nxt - 1
