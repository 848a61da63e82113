"""PG scrubbing: cross-shard consistency checking and repair.

src/osd/scrubber analog (pg_scrubber.cc / scrub_backend.cc): the
primary collects a scrub map (per-object size + data crc + attr/omap
digests) from every acting shard, compares them, and flags
inconsistencies.  Replicated PGs majority-vote the authoritative copy
and can repair divergent replicas by pushing it.  EC PGs deep-scrub by
reconstructing the logical object from k shards, re-encoding, and
byte-comparing every stored shard against the re-encode (the parity
consistency check ECBackend gets from per-shard hashinfo crcs).

Port of ``ceph_tpu/osd/scrub.py``.  ``scrub_ec`` checks an object's
resident shards on the card: their ``device_view``s go through one K4
launch (``crc32c_resident_batch``), the same CRCs as the reference's
``crc32c_resident`` a shard.  The slow path's reconstruct and re-encode
go through the OSD's ``CodecBatcher`` (K2).
"""

from __future__ import annotations

import hashlib
import json
from typing import Any

from ..ops.crc32c_batch import crc32c_batch
from .backend import META_OID, ECBackend, SIZE_XATTR

# objects digested per batched CRC call: bounds the payload bytes held
# in RAM at once while keeping the per-call amortization (a collection
# of any size still makes O(n/256) library calls, not O(n))
_DIGEST_BATCH = 256


async def build_scrub_map(store, coll: str,
                          deep: bool = True) -> dict[str, dict]:
    """Digest every object in a PG collection (replica side).

    Async with periodic yields: digesting a whole PG synchronously
    would stall the event loop past the heartbeat grace and get the
    daemon falsely reported down.  Deep-scrub data digests gather the
    object payloads and go through ONE batched ``crc32c_batch`` call
    per chunk of the collection instead of a scalar host call per
    object (the last per-object CRC loop on the scrub path).  Objects
    resident in the store's device shard cache digest WITHOUT a store
    read: the write-time CRC tag (when carried) IS the digest, else
    the resident buffer joins the batched pass directly."""
    import asyncio
    cache = getattr(store, "shard_cache", None)
    out: dict[str, dict] = {}
    pending: list[tuple[str, bytes]] = []   # (oid, payload) awaiting CRC

    def flush_digests() -> None:
        if not pending:
            return
        crcs = crc32c_batch([p for _, p in pending])
        for (oid2, _), crc in zip(pending, crcs):
            out[oid2]["data_digest"] = int(crc)
        pending.clear()

    for i, oid in enumerate(store.list_objects(coll)):
        if i % 16 == 15:
            await asyncio.sleep(0)
        if oid == META_OID:
            continue
        st = store.stat(coll, oid)
        if st is None:
            continue
        entry: dict[str, Any] = {"size": st["size"]}
        attrs = {k: v for k, v in store.getattrs(coll, oid).items()}
        omap = store.omap_get(coll, oid)
        entry["attrs_digest"] = hashlib.sha1(
            json.dumps({k: v.hex() for k, v in sorted(attrs.items())})
            .encode()).hexdigest()
        entry["omap_digest"] = hashlib.sha1(
            json.dumps({k: v.hex() for k, v in sorted(omap.items())})
            .encode()).hexdigest()
        out[oid] = entry
        if deep:
            resident = cache.get(coll, oid) \
                if cache is not None and (coll, oid) in cache else None
            if resident is not None and resident.crc is not None:
                entry["data_digest"] = resident.crc
                from ..os.device_cache import PERF as DATAPATH_PERF
                DATAPATH_PERF.inc("scrub_cached_digests")
                continue
            if resident is not None:
                payload = resident.buf          # no store round trip
            else:
                payload = bytes(store.read(coll, oid, 0, None))
                if cache is not None:
                    cache.note_host_read(len(payload))
            pending.append((oid, payload))
            if len(pending) >= _DIGEST_BATCH:
                flush_digests()
    flush_digests()
    return out


class ScrubResult:
    def __init__(self, pgid: str) -> None:
        self.pgid = pgid
        self.objects_scrubbed = 0
        self.inconsistent: dict[str, dict] = {}   # oid -> detail
        self.repaired: list[str] = []

    @property
    def clean(self) -> bool:
        return not self.inconsistent

    def to_dict(self) -> dict:
        return {"pgid": self.pgid,
                "objects_scrubbed": self.objects_scrubbed,
                "inconsistent": self.inconsistent,
                "repaired": self.repaired,
                "clean": self.clean}


async def scrub_replicated(pg, repair: bool = False) -> ScrubResult:
    """Compare scrub maps across replicas; majority is authoritative."""
    res = ScrubResult(pg.pgid)
    local = await build_scrub_map(pg.osd.store, pg.coll)
    maps: dict[int, dict[str, dict]] = {pg.whoami: local}
    peers = [o for o in pg.acting_peers() if pg.osd.osd_is_up(o)]
    replies = await pg.osd.fanout_and_wait(
        [(o, "pg_scrub_map_req", {"pgid": pg.pgid}, []) for o in peers],
        collect=True, timeout=15)
    for rep in replies:
        maps[rep.data["from_osd"]] = rep.data["map"]
    all_oids = sorted(set().union(*[set(m) for m in maps.values()]))
    res.objects_scrubbed = len(all_oids)
    for oid in all_oids:
        versions: dict[str, list[int]] = {}
        for osd_id, m in maps.items():
            key = json.dumps(m.get(oid), sort_keys=True)
            versions.setdefault(key, []).append(osd_id)
        if len(versions) <= 1:
            continue
        # majority vote picks the authoritative digest set
        auth_key = max(versions, key=lambda k: len(versions[k]))
        bad = {k: v for k, v in versions.items() if k != auth_key}
        res.inconsistent[oid] = {
            "auth_osds": versions[auth_key],
            "bad": [{"osds": osds, "digests": json.loads(k)}
                    for k, osds in bad.items()],
        }
        if repair:
            await _repair_replicated(pg, oid, versions[auth_key], bad)
            res.repaired.append(oid)
    return res


async def _repair_replicated(pg, oid: str, auth_osds: list[int],
                             bad: dict) -> None:
    """Push the authoritative copy over divergent replicas."""
    from ..msg import Message
    if pg.whoami in auth_osds:
        payload = await pg.backend.read_recovery_payload(oid, 0)
    else:
        replies = await pg.osd.fanout_and_wait(
            [(auth_osds[0], "pg_pull",
              {"pgid": pg.pgid, "oid": oid, "shard": 0}, [])],
            collect=True, timeout=10)
        if not replies or replies[0].data.get("err"):
            return
        rep = replies[0]
        payload = {"data": rep.segments[0] if rep.segments else b"",
                   "xattrs": {k: bytes.fromhex(v) for k, v in
                              rep.data.get("xattrs", {}).items()},
                   "omap": {k: bytes.fromhex(v) for k, v in
                            rep.data.get("omap", {}).items()},
                   "absent": rep.data.get("absent", False)}
        pg._apply_recovery_payload(oid, {
            "absent": payload["absent"],
            "xattrs": {k: v.hex() for k, v in payload["xattrs"].items()},
            "omap": {k: v.hex() for k, v in payload["omap"].items()},
        }, [payload["data"]])
    # `bad` values are lists of osd ids keyed by digest json
    bad_osds = [o for osds in bad.values() for o in osds]
    for osd_id in bad_osds:
        if osd_id == pg.whoami:
            continue
        await pg.osd.fanout_and_wait(
            [(osd_id, "pg_push",
              {"pgid": pg.pgid, "oid": oid,
               "absent": payload.get("absent", False),
               "xattrs": {k: v.hex()
                          for k, v in payload["xattrs"].items()},
               "omap": {k: v.hex()
                        for k, v in payload["omap"].items()}},
              [payload["data"]])], collect=True, timeout=10)


async def scrub_ec(pg, repair: bool = False) -> ScrubResult:
    """Deep EC scrub: verify every stored shard against its write-time
    identity, re-encoding only when something disagrees.

    Shards whose bytes are device-cache-resident verify with ONE
    device CRC launch over their device views (``crc32c_resident_batch``)
    against the write-time tag -- zero store reads, zero host passes
    over the payload.  When EVERY acting shard verifies (label ==
    position, tag matches recomputed CRC, one version, consistent
    lengths) the parity relationship is attested transitively: the
    tags were computed IN the encode launch that produced the parity,
    so a fully-tag-verified object needs no reconstruct + re-encode.
    Anything off -- a missing tag, a mismatch, mixed versions --
    falls back to the canonical path: reconstruct from k shards,
    re-encode through the CodecBatcher, byte-compare every stored
    shard (bit rot injected under a shard's tag is caught there)."""
    import numpy as np
    from ..os.device_cache import PERF as DATAPATH_PERF
    res = ScrubResult(pg.pgid)
    backend: ECBackend = pg.backend
    oids = [o for o in pg.osd.store.list_objects(pg.coll)
            if o != META_OID]
    res.objects_scrubbed = len(oids)
    from .backend import (CRC_XATTR, SHARD_XATTR, VER_XATTR, shard_crc,
                          shard_crc_matches)
    for oid in oids:
        # fetch every stored shard + its write-time identity tags
        # (shard label / crc / version) -- scrub is where silent tag
        # rot gets caught.  Local shards ride the device cache; remote
        # shards arrive in ONE parallel gather through the hedged
        # sub-read machinery (the old loop paid one serial round trip
        # per shard), with every reply feeding the per-peer latency
        # EWMA.  A shard whose source outlives the read deadline just
        # falls out to the reconstruct path below.
        stored, n_acting = await backend.collect_shard_states(oid)
        if not stored:
            continue
        # resident buffers (the local shard's, when the cache holds it)
        # verify on the card from their device views; the rest in one
        # batched host pass
        views = {i: backend.dcache.device_view(pg.coll, oid)
                 for i, e in enumerate(stored) if e[5]}
        views = {i: v for i, v in views.items() if v is not None}
        have_crcs: dict[int, int] = {}
        host_idx = [i for i in range(len(stored)) if i not in views]
        if host_idx:
            crcs = crc32c_batch([stored[i][1] for i in host_idx])
            have_crcs = {i: int(c) for i, c in zip(host_idx, crcs)}
        if views:
            from ..ops.crc32c_batch import crc32c_resident_batch
            crcs = crc32c_resident_batch(list(views.values()))
            have_crcs.update((i, int(c)) for i, c in zip(views, crcs))
        vers = {e[4] for e in stored}
        lens = {len(e[1]) for e in stored}
        fast_ok = (len(stored) == n_acting and len(vers) == 1
                   and len(lens) == 1)
        if fast_ok:
            for i, (shard, raw, label, crc, over, _) in \
                    enumerate(stored):
                if label is None or int(label) != shard \
                        or crc is None \
                        or int(crc) != have_crcs[i]:
                    fast_ok = False
                    break
        if fast_ok:
            DATAPATH_PERF.inc("scrub_fast_verifies")
            continue
        # slow path: reconstruct, re-encode, byte-compare
        bufs, size, ver = await backend._gather_shards(
            oid, need_shards=set(range(backend.k)))
        if not bufs:
            continue
        logical = await backend.sinfo.reconstruct_logical_async(
            backend.codec, bufs, batcher=backend.batcher)
        pad = backend.sinfo.logical_to_next_stripe_offset(size)
        canonical = await backend.sinfo.encode_async(
            backend.codec, logical[:pad].ljust(pad, b"\0"),
            batcher=backend.batcher)
        bad_shards: list[int] = []
        bad_tags: list[int] = []
        for i, (shard, raw, label, crc, over, _) in enumerate(stored):
            raw = bytes(raw)
            want = canonical[shard].tobytes()
            if raw != want:
                bad_shards.append(shard)
            elif (label is not None and int(label) != shard) or \
                    not shard_crc_matches(raw, crc,
                                          precomputed=have_crcs[i]):
                bad_tags.append(shard)
        if bad_shards or bad_tags:
            res.inconsistent[oid] = {"bad_shards": bad_shards,
                                     "bad_tags": bad_tags}
            if repair:
                for shard in bad_shards + bad_tags:
                    osd_id = pg.acting[shard]
                    blob = canonical[shard].tobytes()
                    payload = {"pgid": pg.pgid, "oid": oid,
                               "absent": False,
                               "shard": shard,
                               "crc": shard_crc(blob),
                               "xattrs": {
                                   SIZE_XATTR:
                                       str(size).encode().hex(),
                                   VER_XATTR:
                                       f"{ver[0]},{ver[1]}"
                                       .encode().hex(),
                                   SHARD_XATTR:
                                       str(shard).encode().hex(),
                                   CRC_XATTR:
                                       str(shard_crc(blob))
                                       .encode().hex()},
                               "omap": {}}
                    if osd_id == pg.whoami:
                        pg._apply_recovery_payload(oid, payload,
                                                   [blob])
                    else:
                        await pg.osd.fanout_and_wait(
                            [(osd_id, "pg_push", payload, [blob])],
                            collect=True, timeout=10)
                res.repaired.append(oid)
    return res


async def scrub_pg(pg, repair: bool = False) -> ScrubResult:
    # quiesce the pipelined write spine first: a deferred commit still
    # in flight would make replica shard states legitimately lag the
    # primary's, which scrub would misread as inconsistency
    await pg.drain_commits()
    # lint: disable=await-under-lock -- scrub deliberately freezes the PG while it compares shard states; the drain above keeps in-flight commits out of the hold
    async with pg.lock:
        if isinstance(pg.backend, ECBackend):
            return await scrub_ec(pg, repair=repair)
        return await scrub_replicated(pg, repair=repair)
