"""Client-side striping: one logical object -> many RADOS objects.

The Striper (src/osdc/Striper.cc) + libradosstriper semantics: a
logical byte stream is cut into stripe units of ``stripe_unit`` bytes,
dealt round-robin across ``stripe_count`` backing objects, each capped
at ``object_size`` bytes; a full set of stripe_count objects is an
object set, and the stream continues into the next set.  Backing
objects are named ``<soid>.<objectno:016x>`` and the logical size is
stored on the first object (the SimpleRADOSStriper discipline,
src/SimpleRADOSStriper.cc).

This is the long-context scaling axis of the stack: a huge logical
object fans out across many PGs/OSDs, and reads/writes of a range
become PARALLEL per-object ops (asyncio.gather here; the reference
issues them concurrently through the Objecter the same way).

Port of ``ceph_tpu/client/striper.py``; runs unchanged over the
port's librados.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass

SIZE_XATTR = "striper.size"


@dataclass(frozen=True)
class Layout:
    """File layout (file_layout_t analog): su | os, sc >= 1."""
    stripe_unit: int = 1 << 22        # 4 MiB
    stripe_count: int = 1
    object_size: int = 1 << 22

    def __post_init__(self):
        if self.stripe_unit <= 0 or self.stripe_count <= 0 \
                or self.object_size <= 0:
            raise ValueError("layout fields must be positive")
        if self.object_size % self.stripe_unit:
            raise ValueError("stripe_unit must divide object_size")


def map_extents(layout: Layout, off: int,
                length: int) -> list[tuple[int, int, int]]:
    """[(objectno, object_off, len)] covering [off, off+length).

    Striper::file_to_extents: stripeno = off/su walks stripe units;
    the unit lands on object (set*sc + stripeno%sc) at offset
    ((stripeno/sc) % (os/su))*su + off%su."""
    su, sc, os_ = (layout.stripe_unit, layout.stripe_count,
                   layout.object_size)
    per_obj = os_ // su                 # stripe units per object column
    out: list[tuple[int, int, int]] = []
    pos = off
    end = off + length
    while pos < end:
        stripeno = pos // su
        within = pos % su
        n = min(su - within, end - pos)
        objectset = stripeno // (sc * per_obj)
        stripepos = stripeno % sc
        block = (stripeno // sc) % per_obj
        objectno = objectset * sc + stripepos
        obj_off = block * su + within
        if out and out[-1][0] == objectno \
                and out[-1][1] + out[-1][2] == obj_off:
            out[-1] = (objectno, out[-1][1], out[-1][2] + n)
        else:
            out.append((objectno, obj_off, n))
        pos += n
    return out


class RadosStriper:
    """Striped I/O over an IoCtx (libradosstriper analog)."""

    def __init__(self, ioctx, layout: Layout | None = None,
                 atomic_size: bool = False) -> None:
        self.ioctx = ioctx
        self.layout = layout or Layout()
        # atomic_size: size updates go through the cls striper
        # grow_size op (atomic at the OSD) so CONCURRENT CLIENTS never
        # lose a grow to a read-modify-write race; the default path is
        # cheaper and fine for single-writer users (cephfs, rbd)
        self.atomic_size = atomic_size
        # size-xattr updates are read-modify-write: serialize them per
        # logical object within this handle (SimpleRADOSStriper holds
        # an exclusive object lock for the same reason; cross-client
        # writers to ONE striped object need external coordination)
        self._size_locks: dict[str, asyncio.Lock] = {}

    def _size_lock(self, soid: str) -> asyncio.Lock:
        return self._size_locks.setdefault(soid, asyncio.Lock())

    def _obj(self, soid: str, objectno: int) -> str:
        return f"{soid}.{objectno:016x}"

    async def write(self, soid: str, data: bytes, off: int = 0) -> None:
        """Write a range; per-object pieces go out in parallel."""
        extents = map_extents(self.layout, off, len(data))
        pos = 0
        ops = []
        for objectno, obj_off, n in extents:
            piece = data[pos:pos + n]
            pos += n
            ops.append(self.ioctx.write(self._obj(soid, objectno),
                                        piece, offset=obj_off))
        await asyncio.gather(*ops)
        if self.atomic_size:
            import json as _json
            await self.ioctx.exec(
                self._obj(soid, 0), "striper", "grow_size",
                _json.dumps({"size": off + len(data)}).encode())
            return
        async with self._size_lock(soid):
            size = await self.size(soid)
            if off + len(data) > size:
                await self.ioctx.set_xattr(
                    self._obj(soid, 0), SIZE_XATTR,
                    str(off + len(data)).encode())

    async def read(self, soid: str, length: int | None = None,
                   off: int = 0, snap: int | None = None,
                   size_override: int | None = None) -> bytes:
        """``snap``/``size_override``: read a SNAPSHOT view -- data at
        the snap id, bounded by the frozen size (the head's size xattr
        moved on)."""
        size = (size_override if size_override is not None
                else await self.size(soid))
        if off >= size:
            return b""
        length = size - off if length is None else min(length,
                                                       size - off)
        extents = map_extents(self.layout, off, length)

        async def read_one(objectno, obj_off, n):
            from .rados import RadosError
            try:
                buf = await self.ioctx.read(self._obj(soid, objectno),
                                            length=n, offset=obj_off,
                                            snap=snap)
            except RadosError as e:
                if e.errno_name != "ENOENT":
                    raise             # timeouts etc. must surface,
                buf = b""             # only absence is a sparse hole
            return buf + b"\0" * (n - len(buf))

        pieces = await asyncio.gather(
            *(read_one(*e) for e in extents))
        return b"".join(pieces)

    async def size(self, soid: str) -> int:
        from .rados import RadosError
        try:
            raw = await self.ioctx.get_xattr(self._obj(soid, 0),
                                             SIZE_XATTR)
            return int(raw)
        except RadosError as e:
            if e.errno_name in ("ENOENT", "ENODATA"):
                return 0              # object absent = size 0
            raise                     # a timeout is NOT "empty"

    async def stat(self, soid: str) -> dict:
        return {"size": await self.size(soid),
                "layout": self.layout}

    async def truncate(self, soid: str, size: int) -> None:
        async with self._size_lock(soid):
            old = await self.size(soid)
            if size < old:
                # drop whole objects beyond the new end, trim boundary
                keep = map_extents(self.layout, 0, size) if size else []
                keep_max = max((e[0] for e in keep), default=-1)
                last = map_extents(self.layout, 0, old)
                n_objs = max((e[0] for e in last), default=-1) + 1
                from .rados import RadosError

                async def rm(objectno):
                    try:
                        await self.ioctx.remove(
                            self._obj(soid, objectno))
                    except RadosError as e:
                        if e.errno_name != "ENOENT":
                            raise
                await asyncio.gather(*(rm(o) for o in
                                       range(keep_max + 1, n_objs)))
                if size:
                    boundary = {}
                    for objectno, obj_off, n in keep:
                        boundary[objectno] = max(
                            boundary.get(objectno, 0), obj_off + n)

                    async def trunc(objectno, obj_end):
                        try:
                            await self.ioctx.truncate(
                                self._obj(soid, objectno), obj_end)
                        except RadosError as e:
                            if e.errno_name != "ENOENT":
                                raise
                    await asyncio.gather(*(trunc(o, e) for o, e in
                                           boundary.items()))
            await self.ioctx.set_xattr(self._obj(soid, 0), SIZE_XATTR,
                                       str(size).encode())

    async def remove(self, soid: str) -> None:
        size = await self.size(soid)
        n_objs = max((e[0] for e in map_extents(self.layout, 0,
                                                max(size, 1))),
                     default=0) + 1
        from .rados import RadosError

        async def rm(objectno):
            try:
                await self.ioctx.remove(self._obj(soid, objectno))
            except RadosError as e:
                if e.errno_name != "ENOENT":
                    raise
        await asyncio.gather(*(rm(o) for o in range(n_objs)))
