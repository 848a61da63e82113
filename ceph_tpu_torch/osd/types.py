"""PG-level value types: versions, log entries, pg_info, missing sets.

Modeled on src/osd/osd_types.h: eversion_t (epoch, version) total order,
pg_log_entry_t (:4325) with op/soid/version/prior_version, pg_info_t
(last_update/last_complete/log_tail + history), and pg_missing_t
(need/have per object, drives log-based recovery).

Each type carries BOTH a dict form (wire JSON) and a denc form
(versioned binary, common/denc.py) -- the persistent PG metadata uses
denc the way the reference encodes pg_info_t/pg_log_entry_t with
ENCODE_START envelopes; byte-stability is pinned by the committed
corpus (tests/fixtures/corpus, tools/dencoder.py).
"""

from __future__ import annotations

import json

from dataclasses import dataclass, field
from functools import total_ordering
from typing import Any

from ..common.denc import Decoder, Encoder


@total_ordering
@dataclass(frozen=True)
class EVersion:
    """(epoch, version) — totally ordered op version stamp."""

    epoch: int = 0
    version: int = 0

    def __lt__(self, other: "EVersion") -> bool:
        return (self.epoch, self.version) < (other.epoch, other.version)

    def __bool__(self) -> bool:
        return self.epoch != 0 or self.version != 0

    def to_list(self) -> list[int]:
        return [self.epoch, self.version]

    @classmethod
    def from_list(cls, v) -> "EVersion":
        return cls(int(v[0]), int(v[1]))

    def denc(self, enc: Encoder) -> None:
        # eversion_t is a fixed struct, no envelope (osd_types.h)
        enc.u32(self.epoch).u64(self.version)

    @classmethod
    def dedenc(cls, dec: Decoder) -> "EVersion":
        return cls(dec.u32(), dec.u64())


ZERO = EVersion()

# op kinds (pg_log_entry_t::Op subset the data path exercises)
MODIFY = "modify"
DELETE = "delete"
ERROR = "error"


@dataclass
class LogEntry:
    """One mutation in a PG's op log.

    ``reqid`` identifies the client request that produced the entry
    (osd_reqid_t analog) — the substrate of duplicate-op detection when
    a client resends a write whose reply was lost.
    """

    op: str
    oid: str
    version: EVersion
    prior_version: EVersion = ZERO
    mutations: list[dict[str, Any]] = field(default_factory=list)
    reqid: tuple[str, int] | None = None

    def is_delete(self) -> bool:
        return self.op == DELETE

    def to_dict(self) -> dict:
        return {"op": self.op, "oid": self.oid,
                "v": self.version.to_list(),
                "pv": self.prior_version.to_list(),
                "m": self.mutations,
                "rq": list(self.reqid) if self.reqid else None}

    @classmethod
    def from_dict(cls, d: dict) -> "LogEntry":
        rq = d.get("rq")
        return cls(op=d["op"], oid=d["oid"],
                   version=EVersion.from_list(d["v"]),
                   prior_version=EVersion.from_list(d["pv"]),
                   mutations=list(d.get("m", [])),
                   reqid=(rq[0], rq[1]) if rq else None)

    def denc(self, enc: Encoder) -> None:
        enc.start(1, 1)
        enc.string(self.op).string(self.oid)
        self.version.denc(enc)
        self.prior_version.denc(enc)
        # mutation payloads are free-form op descriptions; they ride as
        # an opaque blob the way pg_log_entry_t embeds op bufferlists
        enc.blob(json.dumps(self.mutations,
                            separators=(",", ":")).encode())
        enc.optional(self.reqid, lambda e, rq: (e.string(rq[0]),
                                                e.u64(rq[1])))
        enc.finish()

    @classmethod
    def dedenc(cls, dec: Decoder) -> "LogEntry":
        dec.start(1)
        op = dec.string()
        oid = dec.string()
        version = EVersion.dedenc(dec)
        prior = EVersion.dedenc(dec)
        mutations = json.loads(dec.blob() or b"[]")
        reqid = dec.optional(lambda d: (d.string(), d.u64()))
        dec.finish()
        return cls(op=op, oid=oid, version=version,
                   prior_version=prior, mutations=mutations,
                   reqid=reqid)


@dataclass
class PGInfo:
    """Summary of a PG replica's history (pg_info_t)."""

    pgid: str = ""
    last_update: EVersion = ZERO          # newest log entry applied
    last_complete: EVersion = ZERO        # all objects ≤ this recovered
    log_tail: EVersion = ZERO             # oldest entry still in log
    last_epoch_started: int = 0
    same_interval_since: int = 0
    # False while a scan-based whole-PG backfill is in flight: the log
    # was adopted wholesale across a trim gap, so last_update overstates
    # what the data actually holds (pg_info_t::last_backfill analog --
    # True plays the role of last_backfill == MAX)
    backfill_complete: bool = True
    # cursor while backfill_complete is False: every object with name
    # <= last_backfill (lexicographic; the reference walks hobject hash
    # order, PeeringState.h:1928) has been backfilled and receives
    # normal write traffic; "" = nothing backfilled yet.  Persisted so
    # an interrupted backfill RESUMES instead of restarting.
    last_backfill: str = ""

    def is_empty(self) -> bool:
        return not self.last_update

    def to_dict(self) -> dict:
        return {"pgid": self.pgid,
                "last_update": self.last_update.to_list(),
                "last_complete": self.last_complete.to_list(),
                "log_tail": self.log_tail.to_list(),
                "last_epoch_started": self.last_epoch_started,
                "same_interval_since": self.same_interval_since,
                "backfill_complete": self.backfill_complete,
                "last_backfill": self.last_backfill}

    @classmethod
    def from_dict(cls, d: dict) -> "PGInfo":
        return cls(pgid=d["pgid"],
                   last_update=EVersion.from_list(d["last_update"]),
                   last_complete=EVersion.from_list(d["last_complete"]),
                   log_tail=EVersion.from_list(d["log_tail"]),
                   last_epoch_started=d.get("last_epoch_started", 0),
                   same_interval_since=d.get("same_interval_since", 0),
                   backfill_complete=d.get("backfill_complete", True),
                   last_backfill=d.get("last_backfill", ""))

    def denc(self, enc: Encoder) -> None:
        enc.start(1, 1)
        enc.string(self.pgid)
        self.last_update.denc(enc)
        self.last_complete.denc(enc)
        self.log_tail.denc(enc)
        enc.u32(self.last_epoch_started)
        enc.u32(self.same_interval_since)
        enc.boolean(self.backfill_complete)
        enc.string(self.last_backfill)
        enc.finish()

    @classmethod
    def dedenc(cls, dec: Decoder) -> "PGInfo":
        dec.start(1)
        out = cls(pgid=dec.string(),
                  last_update=EVersion.dedenc(dec),
                  last_complete=EVersion.dedenc(dec),
                  log_tail=EVersion.dedenc(dec),
                  last_epoch_started=dec.u32(),
                  same_interval_since=dec.u32(),
                  backfill_complete=dec.boolean(),
                  last_backfill=dec.string())
        dec.finish()
        return out


class MissingSet:
    """Objects a replica lacks: oid -> (need, have) (pg_missing_t)."""

    def __init__(self) -> None:
        self.items: dict[str, tuple[EVersion, EVersion]] = {}

    def add(self, oid: str, need: EVersion, have: EVersion) -> None:
        prev = self.items.get(oid)
        if prev is not None:
            have = prev[1]      # keep the original on-disk version
        self.items[oid] = (need, have)

    def rm(self, oid: str, at: EVersion) -> None:
        cur = self.items.get(oid)
        if cur is not None and cur[0] <= at:
            del self.items[oid]

    def revise_need(self, oid: str, need: EVersion) -> None:
        have = self.items.get(oid, (ZERO, ZERO))[1]
        self.items[oid] = (need, have)

    def is_missing(self, oid: str) -> bool:
        return oid in self.items

    def __len__(self) -> int:
        return len(self.items)

    def __bool__(self) -> bool:
        return bool(self.items)

    def to_dict(self) -> dict:
        return {oid: [need.to_list(), have.to_list()]
                for oid, (need, have) in self.items.items()}

    @classmethod
    def from_dict(cls, d: dict) -> "MissingSet":
        ms = cls()
        for oid, (need, have) in d.items():
            ms.items[oid] = (EVersion.from_list(need),
                             EVersion.from_list(have))
        return ms

    def denc(self, enc: Encoder) -> None:
        enc.start(1, 1)
        enc.map(self.items, lambda e, k: e.string(k),
                lambda e, v: (v[0].denc(e), v[1].denc(e)))
        enc.finish()

    @classmethod
    def dedenc(cls, dec: Decoder) -> "MissingSet":
        dec.start(1)
        ms = cls()
        ms.items = dec.map(
            lambda d: d.string(),
            lambda d: (EVersion.dedenc(d), EVersion.dedenc(d)))
        dec.finish()
        return ms


class PastIntervals:
    """Acting-set history across map epochs (compact form).

    Enough to answer "may this peer have data we need?": the union of
    acting OSDs over intervals since last_epoch_started
    (src/osd/osd_types.h PastIntervals is the heavyweight original).
    """

    def __init__(self) -> None:
        self.intervals: list[dict] = []   # {first, last, acting, rw}

    def note_interval(self, first: int, last: int,
                      acting: list[int], rw: bool = True) -> None:
        """``rw=False`` marks an interval whose primary never got an
        up_thru bump: it provably never served writes (maybe_went_rw,
        osd_types.cc check_new_interval), so its members carry nothing
        recovery could need."""
        self.intervals.append({"first": first, "last": last,
                               "acting": list(acting), "rw": bool(rw)})

    def probe_targets(self, current_acting: list[int]) -> set[int]:
        osds = {o for o in current_acting if o >= 0}
        for iv in self.intervals:
            if not iv.get("rw", True):
                continue             # provably never went read-write
            osds.update(o for o in iv["acting"] if o >= 0)
        return osds

    def clear_to(self, epoch: int) -> None:
        self.intervals = [iv for iv in self.intervals
                          if iv["last"] >= epoch]

    def to_dict(self) -> dict:
        return {"intervals": self.intervals}

    @classmethod
    def from_dict(cls, d: dict) -> "PastIntervals":
        pi = cls()
        pi.intervals = list(d.get("intervals", []))
        return pi

    def denc(self, enc: Encoder) -> None:
        # v2 adds the per-interval maybe_went_rw byte MID-STREAM, so
        # v1 decoders cannot tail-skip it: compat=2 makes them fail
        # cleanly instead of misparsing
        enc.start(2, 2)
        enc.list(self.intervals, lambda e, iv: (
            e.u32(iv["first"]), e.u32(iv["last"]),
            e.list(iv["acting"], lambda e2, o: e2.i64(o)),
            e.u8(1 if iv.get("rw", True) else 0)))
        enc.finish()

    @classmethod
    def dedenc(cls, dec: Decoder) -> "PastIntervals":
        v = dec.start(2)
        pi = cls()

        def one(d):
            iv = {"first": d.u32(), "last": d.u32(),
                  "acting": d.list(lambda d2: d2.i64())}
            iv["rw"] = bool(d.u8()) if v >= 2 else True
            return iv
        pi.intervals = dec.list(one)
        dec.finish()
        return pi
