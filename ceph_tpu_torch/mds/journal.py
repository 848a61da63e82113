"""MDS metadata journal (MDLog/Journaler analog).

The reference journals every metadata mutation as an event appended
through the Journaler (src/osdc/Journaler.cc) before touching the
backing dirfrag objects, then trims segments once the dirty metadata
is flushed (src/mds/MDLog.cc).  Here the schema is:

    mds_journal_head      omap {write_seq, trim_seq}
    mds_journal.<seg>     JSON event lines, SEG_EVENTS per segment

Events carry absolute post-state (idempotent), so replay after a
crash -- re-applying every event in (trim_seq, write_seq] -- converges
regardless of where the crash hit.  The daemon is write-through (the
dir omap update follows the journal append immediately), so the
replay window is just the crash race, and trim advances cheaply.

Port of ``ceph_tpu/mds/journal.py``, copied: host code over the port's
librados.
"""

from __future__ import annotations

import json

from ..client.rados import RadosError

HEAD_OID = "mds_journal_head"
SEG_EVENTS = 128


def _seg_oid(seg: int) -> str:
    return f"mds_journal.{seg:08x}"


class Journal:
    def __init__(self, ioctx) -> None:
        self.ioctx = ioctx
        self.write_seq = 0
        self.trim_seq = 0

    async def load(self) -> None:
        try:
            omap = await self.ioctx.get_omap(HEAD_OID)
        except RadosError:
            omap = {}
        self.write_seq = int(omap.get("write_seq", b"0"))
        self.trim_seq = int(omap.get("trim_seq", b"0"))

    async def _save_head(self) -> None:
        await self.ioctx.set_omap(HEAD_OID, {
            "write_seq": str(self.write_seq).encode(),
            "trim_seq": str(self.trim_seq).encode()})

    async def append(self, event: dict) -> int:
        """Durably journal one event; returns its seq."""
        seq = self.write_seq + 1
        line = json.dumps({"seq": seq, **event}) + "\n"
        await self.ioctx.append(_seg_oid((seq - 1) // SEG_EVENTS),
                                line.encode())
        self.write_seq = seq
        await self._save_head()
        return seq

    async def replay(self):
        """Yield every event in (trim_seq, write_seq] in order."""
        if self.write_seq <= self.trim_seq:
            return
        first_seg = self.trim_seq // SEG_EVENTS
        last_seg = (self.write_seq - 1) // SEG_EVENTS
        for seg in range(first_seg, last_seg + 1):
            try:
                raw = await self.ioctx.read(_seg_oid(seg))
            except RadosError as e:
                if e.errno_name == "ENOENT":
                    continue
                raise
            for line in raw.decode().splitlines():
                if not line.strip():
                    continue
                ev = json.loads(line)
                if self.trim_seq < ev["seq"] <= self.write_seq:
                    yield ev

    async def trim(self, upto: int | None = None) -> None:
        """Advance trim_seq and drop wholly-trimmed segments."""
        upto = self.write_seq if upto is None else upto
        if upto <= self.trim_seq:
            return
        old_first = self.trim_seq // SEG_EVENTS
        self.trim_seq = upto
        await self._save_head()
        new_first = self.trim_seq // SEG_EVENTS
        for seg in range(old_first, new_first):
            try:
                await self.ioctx.remove(_seg_oid(seg))
            except RadosError:
                pass
