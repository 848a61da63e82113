"""Datapath bench rig: the OSD shard data spine, cached vs host path.

Port of ``ceph_tpu/tools/datapath_bench.py``.  Drives write ->
read-verify -> scrub -> degraded-read over REAL BlockStores (one per
shard, checksum-on-read through the host CRC engine, WAL group commit)
with the production primitives -- StripeInfo/CodecBatcher encode+decode
launches on the card (the ``cuda`` plugin: K1 or K2, with the write-time
chunk CRCs fused by K4), and the DeviceShardCache (os/device_cache.py) --
twice over identical inputs:

* **baseline** (``cached=False``): every consumer round-trips the
  store -- shard reads pay pread + per-block checksum verify + extent
  assembly, every gathered shard is re-hashed against its tag, deep
  scrub reads every shard back, reconstructs and RE-ENCODES;
* **cached**: the write's encoded shards flow into residency, and the
  read-verify / scrub / degraded-decode phases serve from the cache --
  the ``datapath`` perf counters prove the steady phases move ZERO
  shard bytes through the store.

One deliberate difference from the reference: the cached scrub verifies
the resident shards ON THE CARD -- each shard's ``device_view`` (uploaded
once per residency), all of them in one K4 launch
(``crc32c_resident_batch``), against the write-time tags.  The reference
runs ``crc32c_rows`` on the host over the entries' buffers, which on its
CPU backend are the device buffers.  The CRCs are the same, and hits and
host bytes count as the reference counts them (``get``, then
``device_view``).  Every other phase keeps the reference's data movement:
host buffers into the batcher, the interleave on the host.

Byte-identity is asserted between the two runs (and against the source
data) before any number is reported.

    python -m ceph_tpu_torch.tools.datapath_bench [--device cuda] [--k 4]
        [--m 2] [--objects 24] [--obj-kib 256] [--passes 10] [--reads 5]
        [--max-batch 64] [--dir PATH] [--smoke]

prints one JSON line with the fields of the reference's ``bench.py
--datapath`` and exits non-zero when a gate fails.  ``--smoke`` takes
that mode's tier-1 sizes (RS k=2,m=1, 6 objects of 32 KiB, 2 passes of 2
reads).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import shutil
import sys
import tempfile
import time
import zlib

import numpy as np
import torch

from ..common.perf import PerfCounters
from ..device import resolve_device
from ..ec.plugins.cuda import ErasureCodeCuda
from ..ops.crc32c_batch import PERF as INTEGRITY_PERF
from ..ops.crc32c_batch import crc32c_batch, crc32c_resident_batch
from ..os.blockstore import BlockStore
from ..os.device_cache import DeviceShardCache, PERF as DATAPATH_PERF
from ..os.transaction import Transaction
from ..osd.codec_batcher import CodecBatcher
from ..osd.ec_util import StripeInfo

COLL = "pg_dp"
SIZE_XATTR = "_size"
CRC_XATTR = "_crc"

# the reference's per-phase counters, then the device hop's
COUNTERS = ("hits", "misses", "host_reads", "host_bytes_read",
            "host_bytes_avoided", "evictions", "device_uploads",
            "device_upload_bytes")
SMOKE = dict(k=2, m=1, n_objects=6, obj_bytes=32 << 10, passes=2,
             reads_per_pass=2)
# each shard store's cache budget (the reference rig's)
CACHE_BYTES = 256 << 20
# room a drive's stores take beyond their shard bytes (stripe padding,
# WAL, KV)
DISK_SLACK = 1.25


class _Rig:
    """k+m shard stores + a codec batcher + (optionally) shard caches:
    the single-process rendering of one EC PG's data plane, on
    ``device``."""

    def __init__(self, k: int, m: int, stripe_unit: int,
                 cached: bool, base_dir: str, device=None,
                 max_batch: int = 64) -> None:
        self.device = resolve_device(device)
        self.codec = ErasureCodeCuda("reed_sol_van", device=self.device)
        self.codec.init({"k": str(k), "m": str(m),
                         "technique": "reed_sol_van"})
        self.sinfo = StripeInfo.for_codec(self.codec,
                                          stripe_unit=stripe_unit)
        self.k, self.m = k, m
        self.batcher = CodecBatcher(max_batch=max_batch, flush_timeout=0.05,
                                    perf=PerfCounters("ec_batch"),
                                    device=self.device)
        self.cached = cached
        self.stores: list[BlockStore] = []
        for i in range(k + m):
            st = BlockStore(os.path.join(base_dir, f"shard{i}"))
            if cached:
                st.attach_shard_cache(DeviceShardCache(
                    max_bytes=CACHE_BYTES, device=self.device))
            st.mount()
            st.queue_transaction(
                Transaction().create_collection(COLL))
            self.stores.append(st)
        # oid -> (size, shard_len, per-shard crc tags)
        self.meta: dict[str, tuple[int, int, list[int]]] = {}
        # host clock of the last write (encode wait, store commit) and of
        # the last cached scrub (views gathered, the sweep)
        self.write_split: dict[str, float] = {}
        self.scrub_split: dict[str, float] = {}

    def close(self) -> None:
        self.batcher.close()
        for st in self.stores:
            st.umount()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- phases ---------------------------------------------------------------
    async def write(self, objects: dict[str, bytes]) -> None:
        """Encode (fused CRC) + commit every object; the encode output
        flows into residency when caching is on.  Commits coalesce into
        one transaction per shard store (the group-commit shape)."""
        async def enc(oid, data):
            padded = data + b"\0" * (
                self.sinfo.logical_to_next_stripe_offset(len(data))
                - len(data))
            shards, crcs = await self.sinfo.encode_async(
                self.codec, padded, batcher=self.batcher,
                with_crc=True)
            return oid, data, shards, crcs

        t0 = time.perf_counter()
        encoded = await asyncio.gather(
            *(enc(oid, data) for oid, data in objects.items()))
        t1 = time.perf_counter()
        txns = [Transaction() for _ in self.stores]
        puts = []
        for oid, data, shards, crcs in encoded:
            shard_len = self.sinfo.object_size_to_shard_size(len(data))
            self.meta[oid] = (len(data), shard_len,
                              [int(crcs[s]) for s in range(len(
                                  self.stores))])
            for s, txn in enumerate(txns):
                buf = shards[s].tobytes()
                txn.write(COLL, oid, 0, buf)
                txn.setattr(COLL, oid, SIZE_XATTR,
                            str(len(data)).encode())
                txn.setattr(COLL, oid, CRC_XATTR,
                            str(int(crcs[s])).encode())
                if self.cached:
                    puts.append((s, oid, shards[s], len(data),
                                 int(crcs[s])))
        for st, txn in zip(self.stores, txns):
            st.queue_transaction(txn)
        for s, oid, buf, size, crc in puts:
            self.stores[s].shard_cache.put(
                COLL, oid, buf, size=size, ver=(1, 1), shard=s,
                crc=crc)
        self.write_split = {"encode_s": t1 - t0,
                            "commit_s": time.perf_counter() - t1}

    def _read_through(self, s: int, oid: str) -> np.ndarray:
        """One shard through the store's checksum-on-read path (counted
        as a host round trip), with the identity-xattr lookups a resident
        entry carries for free."""
        st = self.stores[s]
        raw = st.read(COLL, oid, 0, None)
        st.getattr(COLL, oid, SIZE_XATTR)
        st.getattr(COLL, oid, CRC_XATTR)
        DATAPATH_PERF.inc("host_reads")
        DATAPATH_PERF.inc("host_bytes_read", len(raw))
        return np.frombuffer(raw, np.uint8)

    def _shard(self, s: int, oid: str) -> np.ndarray:
        """One shard's bytes on the host: residency first, else the
        store."""
        if self.cached:
            e = self.stores[s].shard_cache.get(COLL, oid)
            if e is not None:
                return e.buf
        return self._read_through(s, oid)

    def _resident(self, s: int, oid: str) -> torch.Tensor:
        """One shard's bytes on the card: its device view (uploaded once
        per residency), else the store's bytes copied up."""
        cache = self.stores[s].shard_cache
        if cache.get(COLL, oid) is not None:
            return cache.device_view(COLL, oid)
        return torch.from_numpy(self._read_through(s, oid).copy()).to(
            self.device)

    async def read_verify(self, oids: list[str]) -> dict[str, bytes]:
        """The client read path: gather the k data shards, verify tags
        (residency is trusted -- verified at write time), interleave
        logical bytes.  Objects submit CONCURRENTLY so their decode
        work coalesces in the batcher, as concurrent client ops do."""
        async def one(oid):
            bufs = {s: self._shard(s, oid) for s in range(self.k)}
            if not self.cached:
                tags = self.meta[oid][2]
                got = crc32c_batch([bufs[s] for s in range(self.k)])
                for s in range(self.k):
                    if int(got[s]) != tags[s]:
                        raise RuntimeError(f"tag mismatch {oid}/{s}")
            data = await self.sinfo.reconstruct_logical_async(
                self.codec, bufs, batcher=self.batcher)
            return oid, data[:self.meta[oid][0]]

        return dict(await asyncio.gather(*(one(o) for o in oids)))

    async def scrub(self, oids: list[str]) -> None:
        """Deep-scrub verify.

        Cached: the write-time tags were computed IN the encode launch
        that produced the parity, so verifying every resident shard's
        CRC against its tag attests the parity relationship
        transitively -- zero store reads, zero re-encode (the scrub_ec
        fast path), here one K4 launch over the shards' device views.
        Baseline: the pre-cache deep scrub -- read every shard back
        through the store, reconstruct the logical object, RE-ENCODE
        it, byte-compare every stored shard against the canonical
        encode."""
        if self.cached:
            t0 = time.perf_counter()
            views, want = [], []
            for oid in oids:
                tags = self.meta[oid][2]
                for s in range(len(self.stores)):
                    views.append(self._resident(s, oid))
                    want.append(tags[s])
            self._sync()
            t1 = time.perf_counter()
            got = crc32c_resident_batch(views)
            self.scrub_split = {"views_s": t1 - t0,
                                "sweep_s": time.perf_counter() - t1}
            bad = [i for i in range(len(views))
                   if int(got[i]) != want[i]]
            if bad:
                raise RuntimeError(f"scrub mismatch at {bad[:4]}")
            DATAPATH_PERF.inc("scrub_fast_verifies", len(oids))
            return

        async def one(oid):
            stored = {s: self._shard(s, oid)
                      for s in range(len(self.stores))}
            logical = await self.sinfo.reconstruct_logical_async(
                self.codec, {s: stored[s] for s in range(self.k)},
                batcher=self.batcher)
            canonical = await self.sinfo.encode_async(
                self.codec, logical, batcher=self.batcher)
            for s in range(len(self.stores)):
                if not np.array_equal(canonical[s], stored[s]):
                    raise RuntimeError(f"scrub mismatch {oid}/{s}")

        await asyncio.gather(*(one(o) for o in oids))

    async def degraded_read(self, oids: list[str],
                            down: int) -> dict[str, bytes]:
        """Reads with data shard ``down`` erased: decode from the k
        surviving shards minimum_to_decode picks (cache-resident when
        on) and rebuild the logical bytes.  Concurrent submission, so
        every object's reconstruction shares one decode launch."""
        keep = [s for s in range(len(self.stores)) if s != down][
            :self.k]

        async def one(oid):
            survivors = {s: self._shard(s, oid) for s in keep}
            if not self.cached:
                tags = self.meta[oid][2]
                got = crc32c_batch([survivors[s] for s in keep])
                for s, g in zip(keep, got):
                    if int(g) != tags[s]:
                        raise RuntimeError(f"tag mismatch {oid}/{s}")
            data = await self.sinfo.reconstruct_logical_async(
                self.codec, survivors, batcher=self.batcher)
            return oid, data[:self.meta[oid][0]]

        return dict(await asyncio.gather(*(one(o) for o in oids)))


def _stored_bytes(sinfo: StripeInfo, k: int, m: int, n_objects: int,
                  obj_bytes: int) -> int:
    return sinfo.object_size_to_shard_size(obj_bytes) * (k + m) * n_objects


def source_objects(n_objects: int, obj_bytes: int,
                   seed: int = 7) -> dict[str, bytes]:
    """The drive's objects, random bytes from ``seed``."""
    rng = np.random.default_rng(seed)
    return {f"obj-{i:04d}": rng.integers(0, 256, obj_bytes,
                                         dtype=np.uint8).tobytes()
            for i in range(n_objects)}


async def drive_phases(rig: _Rig, objects: dict[str, bytes], *, passes: int,
                       reads_per_pass: int) -> tuple[dict, dict]:
    """The timed phases on an open rig: the write, then ``passes`` of
    ``reads_per_pass`` read-verifies, a scrub and the degraded reads.
    Returns (phases, digests of the reads) once the reads and degraded
    reads equal the source bytes."""
    oids = sorted(objects)
    obj_bytes = len(objects[oids[0]])
    phases: dict[str, dict] = {}

    def snap():
        return {key: DATAPATH_PERF.get(key) for key in COUNTERS} | {
            "scalar_calls": INTEGRITY_PERF.get("scalar_calls")}

    async def timed(name, fn, nbytes):
        before = snap()
        t0 = time.perf_counter()
        res = fn()
        if asyncio.iscoroutine(res):
            res = await res
        dt = time.perf_counter() - t0
        after = snap()
        phases[name] = {
            "seconds": round(dt, 4),
            "GiBps": round(nbytes / dt / 2**30, 3),
            "bytes": nbytes,
            "counters": {key: after[key] - before[key] for key in after}}
        return res

    logical = len(oids) * obj_bytes
    stored = _stored_bytes(rig.sinfo, rig.k, rig.m, len(oids), obj_bytes)
    # degraded reads hit a subset: with one shard down, only the objects a
    # client actually touches during the recovery window pay the decode --
    # not the whole population every pass
    degr_oids = oids[:max(2, len(oids) // 12)]
    await timed("write", lambda: rig.write(objects), logical)
    phases["write"].update(rig.write_split)
    reads = degraded = {}
    for p in range(passes):
        # the steady-state serving mix: hot read-verifies, a deep-scrub
        # verify sweep, and degraded-read decodes
        for r in range(reads_per_pass):
            reads = await timed(f"read_verify_{p}_{r}",
                                lambda: rig.read_verify(oids), logical)
        await timed(f"scrub_{p}", lambda: rig.scrub(oids), stored)
        phases[f"scrub_{p}"].update(rig.scrub_split)
        degraded = await timed(
            f"degraded_read_{p}",
            lambda: rig.degraded_read(degr_oids, down=0),
            len(degr_oids) * obj_bytes)
    # byte-identity gates: reads and degraded reads must equal the source
    # bytes exactly
    for oid in oids:
        if reads[oid] != objects[oid]:
            raise RuntimeError(f"read parity failure {oid}")
    for oid in degr_oids:
        if degraded[oid] != objects[oid]:
            raise RuntimeError(f"degraded-read parity failure {oid}")
    digests = {oid: zlib.crc32(reads[oid]) for oid in oids}
    digests.update({f"{oid}@degraded": zlib.crc32(degraded[oid])
                    for oid in degr_oids})
    return phases, digests


def drive_report(cached: bool, phases: dict, ec_batch: dict,
                 digests: dict) -> dict:
    """One drive's report from its phases, its batcher's counters and its
    read digests."""
    total_s = sum(ph["seconds"] for ph in phases.values())
    total_b = sum(ph["bytes"] for ph in phases.values())
    steady = {key: sum(
        ph["counters"][key] for name, ph in phases.items()
        if not name.startswith("write"))
        for key in ("hits", "host_bytes_read", "host_reads",
                    "host_bytes_avoided", "scalar_calls")}
    return {"cached": cached,
            "end_to_end_GiBps": round(total_b / total_s / 2**30, 3),
            "seconds": round(total_s, 4),
            "bytes": total_b,
            "phases": phases,
            "steady_counters": steady,
            "ec_batch": ec_batch,
            "digests": digests}


async def _drive(cached: bool, *, k: int, m: int, n_objects: int,
                 obj_bytes: int, passes: int, reads_per_pass: int,
                 stripe_unit: int, base_dir: str, device=None,
                 max_batch: int = 64, keep_dirs: bool = False,
                 seed: int = 7) -> dict:
    """One drive in its own stores under ``base_dir``, removed when the
    drive ends unless ``keep_dirs``."""
    objects = source_objects(n_objects, obj_bytes, seed)
    try:
        rig = _Rig(k, m, stripe_unit, cached, base_dir, device=device,
                   max_batch=max_batch)
        try:
            phases, digests = await drive_phases(
                rig, objects, passes=passes, reads_per_pass=reads_per_pass)
            ec_batch = rig.batcher.perf.dump()
        finally:
            rig.close()
    finally:
        if not keep_dirs:
            shutil.rmtree(base_dir, ignore_errors=True)
    return drive_report(cached, phases, ec_batch, digests)


def drive_disk_bytes(k: int, m: int, n_objects: int, obj_bytes: int) -> int:
    """The room one drive's stores take: its shard bytes and
    ``DISK_SLACK``."""
    return int(DISK_SLACK * (k + m) / k * n_objects * obj_bytes)


def bench_dir(need_bytes: int, root: str | None = None) -> str:
    """A new directory for one drive's shard stores under ``root`` (the
    temporary directory, which follows ``TMPDIR``, unless given), after
    checking that it has room for the drive: a drive that filled its disk
    midway would fail in its write phase."""
    root = root or tempfile.gettempdir()
    free = shutil.disk_usage(root).free
    if free < need_bytes:
        raise RuntimeError(f"{root} has {free} bytes free; a drive's shard "
                           f"stores need {need_bytes}")
    return tempfile.mkdtemp(prefix="ceph_tpu_dp_", dir=root)


def compare(baseline: dict, cached: dict, *, k: int, m: int, n_objects: int,
            obj_bytes: int, passes: int, reads_per_pass: int,
            device) -> dict:
    """The comparison report of a baseline and a cached drive over the same
    objects; a RuntimeError if their reads differ.  Drops the drives'
    digests."""
    if baseline["digests"] != cached["digests"]:
        raise RuntimeError(
            "byte-identity failure: cached reads differ from the "
            "host-round-trip baseline")
    for run in (baseline, cached):
        run.pop("digests")
    steady = cached["steady_counters"]
    ratio = (cached["end_to_end_GiBps"]
             / max(baseline["end_to_end_GiBps"], 1e-9))
    return {
        "k": k, "m": m, "n_objects": n_objects,
        "obj_bytes": obj_bytes, "passes": passes,
        "reads_per_pass": reads_per_pass, "device": str(device),
        "datapath_GiBps": cached["end_to_end_GiBps"],
        "baseline_GiBps": baseline["end_to_end_GiBps"],
        "vs_host_roundtrip": round(ratio, 2),
        "cache_hits": steady["hits"],
        "steady_host_bytes_read": steady["host_bytes_read"],
        "steady_host_reads": steady["host_reads"],
        "host_bytes_avoided": steady["host_bytes_avoided"],
        "scalar_calls_on_batched_paths": steady["scalar_calls"],
        "parity": "ok",
        "cached_run": cached,
        "baseline_run": baseline,
    }


async def run_datapath_bench(*, k: int = 4, m: int = 2,
                             n_objects: int = 24,
                             obj_bytes: int = 256 << 10,
                             passes: int = 10,
                             reads_per_pass: int = 5,
                             stripe_unit: int = 4096,
                             keep_dirs: bool = False, device=None,
                             max_batch: int = 64,
                             root: str | None = None) -> dict:
    """Both drives over identical inputs + the comparison report, on
    ``device`` (CUDA unless ``device="cpu"``: the codec, the batcher and
    every shard cache), each drive's stores in a new directory under
    ``root`` (``bench_dir``).  ``max_batch`` is the batcher's stripes a
    launch.

    Gates (the caller turns violations into a non-zero exit):
    * byte identity: cached and baseline reads/degraded-reads return
      identical bytes (and both equal the source data);
    * cache effectiveness: hit-rate > 0 and the cached steady phases
      (read-verify / scrub / degraded-read) moved ZERO bytes through
      the store;
    * zero scalar CRC calls in the steady phases (the write phase's
      WAL record framing CRCs are metadata, not shard payload).
    """
    device = resolve_device(device)
    sizes = dict(k=k, m=m, n_objects=n_objects, obj_bytes=obj_bytes,
                 passes=passes, reads_per_pass=reads_per_pass)
    kwargs = dict(**sizes, stripe_unit=stripe_unit, device=device,
                  max_batch=max_batch, keep_dirs=keep_dirs)
    need = drive_disk_bytes(k, m, n_objects, obj_bytes)
    # warmup: one full-shape baseline drive builds every launch family
    # (write encode, scrub re-encode, degraded decode) at the SAME batch
    # buckets the timed drives use, so neither side pays first-use costs
    await _drive(False, base_dir=bench_dir(need, root),
                 **{**kwargs, "passes": 1, "reads_per_pass": 1})
    baseline = await _drive(False, base_dir=bench_dir(need, root), **kwargs)
    cached = await _drive(True, base_dir=bench_dir(need, root), **kwargs)
    return compare(baseline, cached, **sizes, device=device)


def agg_phases(phases: dict) -> dict:
    """Aggregate per-pass phase rows into one row per phase kind."""
    agg: dict = {}
    for name, d in phases.items():
        key = name.rstrip("0123456789_") or name
        cur = agg.setdefault(key, {"seconds": 0.0, "bytes": 0})
        cur["seconds"] = round(cur["seconds"] + d["seconds"], 4)
        cur["bytes"] += d["bytes"]
    for cur in agg.values():
        cur["GiBps"] = round(
            cur["bytes"] / max(cur["seconds"], 1e-9) / 2**30, 3)
    return agg


def gate_failures(res: dict) -> list[str]:
    """The gates the reference's ``bench.py --datapath`` exits non-zero
    on, as messages (empty when every gate holds)."""
    out = []
    if res["parity"] != "ok":
        out.append("datapath parity gate failed")
    if not res["cache_hits"]:
        out.append("the cached drive never hit the cache")
    if res["steady_host_bytes_read"] != 0:
        out.append("cache-hit steady phases moved shard bytes through the "
                   "store")
    if res["scalar_calls_on_batched_paths"] != 0:
        out.append("scalar CRC calls observed on the datapath steady phases")
    return out


def result_line(res: dict, smoke: bool) -> dict:
    """The reference's ``bench.py --datapath`` JSON fields."""
    return {
        "metric": "datapath_write_scrub_degraded_GiBps",
        "value": res["datapath_GiBps"],
        "unit": "GiB/s",
        "vs_baseline": res["vs_host_roundtrip"],
        "baseline_note": "identical drive with the shard cache "
                         "detached: every read re-materializes "
                         "through the store and deep scrub "
                         "reconstructs + re-encodes (the pre-cache "
                         "pipeline)",
        "smoke": smoke,
        **{key: res[key] for key in
           ("k", "m", "n_objects", "obj_bytes", "passes",
            "reads_per_pass", "baseline_GiBps", "cache_hits",
            "steady_host_bytes_read", "steady_host_reads",
            "host_bytes_avoided", "scalar_calls_on_batched_paths",
            "parity", "device")},
        "cached_phases": agg_phases(res["cached_run"]["phases"]),
        "baseline_phases": agg_phases(res["baseline_run"]["phases"]),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain versions)")
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--m", type=int, default=2)
    ap.add_argument("--objects", type=int, default=24)
    ap.add_argument("--obj-kib", type=int, default=256)
    ap.add_argument("--passes", type=int, default=10)
    ap.add_argument("--reads", type=int, default=5,
                    help="read-verify sweeps a pass")
    ap.add_argument("--stripe-unit", type=int, default=4096)
    ap.add_argument("--max-batch", type=int, default=64,
                    help="the batcher's stripes a launch")
    ap.add_argument("--smoke", action="store_true",
                    help="the reference's tier-1 sizes")
    ap.add_argument("--dir", default=None,
                    help="where the drives' shard stores go (default: the "
                         "temporary directory, $TMPDIR)")
    args = ap.parse_args(argv)
    if args.smoke:
        kwargs = dict(SMOKE)
    else:
        kwargs = dict(k=args.k, m=args.m, n_objects=args.objects,
                      obj_bytes=args.obj_kib << 10, passes=args.passes,
                      reads_per_pass=args.reads)
    res = asyncio.new_event_loop().run_until_complete(run_datapath_bench(
        **kwargs, stripe_unit=args.stripe_unit, device=args.device,
        max_batch=args.max_batch, root=args.dir))
    print(json.dumps(result_line(res, args.smoke)), flush=True)
    failed = gate_failures(res)
    for msg in failed:
        print(f"ERROR: {msg}", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
