"""Per-PG op log: the substrate of log-based recovery.

Mirrors the semantics of src/osd/PGLog.h: an ordered list of LogEntry
bounded by (tail, head]; merge_log (:1247) folds an authoritative log
into ours, rewinding divergent local entries (:1241) and populating the
missing set; proc_replica_log (:933) computes what a replica is missing
from its own log vs the authoritative one.
"""

from __future__ import annotations

from .types import (
    EVersion, LogEntry, MissingSet, PGInfo, ZERO, DELETE,
)


class PGLog:
    def __init__(self, tail: EVersion = ZERO, head: EVersion = ZERO,
                 entries: list[LogEntry] | None = None) -> None:
        self.tail = tail
        self.head = head
        self.entries: list[LogEntry] = list(entries or [])

    # -- basic ops ----------------------------------------------------------
    def add(self, entry: LogEntry) -> None:
        assert entry.version > self.head, (entry.version, self.head)
        self.entries.append(entry)
        self.head = entry.version

    def trim(self, to: EVersion) -> None:
        """Drop entries ≤ `to` (they are durably applied everywhere)."""
        if to <= self.tail:
            return
        self.entries = [e for e in self.entries if e.version > to]
        self.tail = to
        if self.head < self.tail:
            self.head = self.tail

    def last_entry_of(self, oid: str) -> LogEntry | None:
        for e in reversed(self.entries):
            if e.oid == oid:
                return e
        return None

    def last_version_of(self, oid: str) -> EVersion | None:
        e = self.last_entry_of(oid)
        return None if e is None else e.version

    def objects(self) -> dict[str, LogEntry]:
        """oid -> newest entry touching it."""
        out: dict[str, LogEntry] = {}
        for e in self.entries:
            out[e.oid] = e
        return out

    def entries_after(self, v: EVersion) -> list[LogEntry]:
        return [e for e in self.entries if e.version > v]

    # -- merge machinery ----------------------------------------------------
    def rewind_divergent(self, newhead: EVersion,
                         missing: MissingSet) -> list[LogEntry]:
        """Throw away local entries > newhead (they never committed
        cluster-wide).  Objects they touched must be restored to their
        authoritative version — record them missing at prior_version.

        PGLog.h:1241 rewind_divergent_log.
        """
        divergent = [e for e in self.entries if e.version > newhead]
        self.entries = [e for e in self.entries if e.version <= newhead]
        self.head = newhead
        # oldest divergent entry per object tells us the version the
        # object must return to
        first_div: dict[str, LogEntry] = {}
        for e in divergent:
            first_div.setdefault(e.oid, e)
        for oid, e in first_div.items():
            if e.prior_version:
                # restore to the pre-divergence version (even if that
                # version predates our log tail — recovery pulls the
                # authoritative copy from a peer either way)
                missing.add(oid, need=e.prior_version, have=ZERO)
            else:
                # object was created by a divergent entry: simply gone
                missing.items.pop(oid, None)
        return divergent

    def _last_common(self, auth_entries: list[LogEntry],
                     auth_tail: EVersion) -> EVersion:
        """Newest local version the authoritative log agrees with.

        Local entries older than the auth tail were trimmed there and
        count as agreed; anything after the returned version that the
        auth log lacks is divergent (merge_log's splice-point scan).
        """
        auth_versions = {e.version for e in auth_entries}
        for e in reversed(self.entries):
            if e.version in auth_versions or e.version <= auth_tail:
                return e.version
        return self.tail

    def overlaps(self, auth_info: PGInfo) -> bool:
        """Can log-based recovery bridge us to this authoritative log?

        False when our head predates the auth log's tail: entries in
        the gap were trimmed there, so objects whose last modification
        fell inside it would silently stay stale.  The caller must fall
        back to whole-PG backfill (reference: last_backfill machinery,
        PeeringState.h:645-680 Backfilling)."""
        return self.head >= auth_info.log_tail

    def merge(self, auth_entries: list[LogEntry], auth_info: PGInfo,
              missing: MissingSet) -> list[LogEntry]:
        """Fold the authoritative log into ours (PGLog.h:1247 merge_log).

        Find the newest entry both logs agree on; local entries past it
        are divergent (they never committed cluster-wide) and are
        rewound; auth entries past it are appended and their objects
        marked missing until recovered.  Returns the divergent entries
        so the PG can clean up objects they created.

        When the logs do NOT overlap (see overlaps()), the local log is
        replaced wholesale: splicing across a gap would fabricate a
        continuous history that hides trimmed modifications.  The caller
        is responsible for scan-based backfill of the data.
        """
        if not self.overlaps(auth_info):
            self.entries = list(auth_entries)
            self.tail = auth_info.log_tail
            self.head = (auth_entries[-1].version if auth_entries
                         else auth_info.last_update)
            for e in auth_entries:
                if e.is_delete():
                    missing.items.pop(e.oid, None)
                else:
                    missing.add(e.oid, need=e.version, have=ZERO)
            return []
        lu = self._last_common(auth_entries, auth_info.log_tail)
        divergent: list[LogEntry] = []
        if lu < self.head:
            divergent = self.rewind_divergent(lu, missing)
        for e in auth_entries:
            if e.version <= self.head:
                continue
            self.add(e)
            if e.is_delete():
                missing.items.pop(e.oid, None)
            else:
                missing.add(e.oid, need=e.version, have=e.prior_version)
        if self.tail < auth_info.log_tail and not self.entries:
            self.tail = auth_info.log_tail
        return divergent

    @staticmethod
    def proc_replica_log(replica_info: PGInfo, replica_entries: list[LogEntry],
                         auth_log: "PGLog") -> MissingSet:
        """What is `replica` missing relative to the authoritative log?

        PGLog.h:933.  Two sources: (a) auth entries past the replica's
        last_update; (b) replica divergent entries past the auth head.
        """
        missing = MissingSet()
        for e in auth_log.entries_after(replica_info.last_update):
            if e.is_delete():
                missing.items.pop(e.oid, None)
            else:
                missing.add(e.oid, need=e.version, have=e.prior_version)
        replica_view = PGLog(tail=ZERO, head=replica_info.last_update,
                             entries=list(replica_entries))
        lu = replica_view._last_common(auth_log.entries, auth_log.tail)
        divergent = [e for e in replica_entries if e.version > lu]
        first_div: dict[str, LogEntry] = {}
        for e in divergent:
            first_div.setdefault(e.oid, e)
        for oid, e in first_div.items():
            auth_e = auth_log.last_entry_of(oid)
            if auth_e is not None:
                if auth_e.is_delete():
                    # authoritatively deleted: nothing to push, the
                    # replica just removes it (mirrors merge())
                    missing.items.pop(oid, None)
                else:
                    missing.add(oid, need=auth_e.version, have=ZERO)
            elif e.prior_version:
                missing.add(oid, need=e.prior_version, have=ZERO)
        return missing

    # -- (de)serialization --------------------------------------------------
    def to_dict(self) -> dict:
        return {"tail": self.tail.to_list(), "head": self.head.to_list(),
                "entries": [e.to_dict() for e in self.entries]}

    @classmethod
    def from_dict(cls, d: dict) -> "PGLog":
        return cls(tail=EVersion.from_list(d["tail"]),
                   head=EVersion.from_list(d["head"]),
                   entries=[LogEntry.from_dict(e) for e in d["entries"]])

    def denc(self, enc) -> None:
        enc.start(1, 1)
        self.tail.denc(enc)
        self.head.denc(enc)
        enc.list(self.entries, lambda e, le: le.denc(e))
        enc.finish()

    @classmethod
    def dedenc(cls, dec) -> "PGLog":
        dec.start(1)
        out = cls(tail=EVersion.dedenc(dec), head=EVersion.dedenc(dec),
                  entries=dec.list(lambda d: LogEntry.dedenc(d)))
        dec.finish()
        return out

