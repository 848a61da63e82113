#!/usr/bin/env python3
"""Drive the port's main paths on one CUDA card and check them: the
erasure-code stripe codec, bulk CRUSH placement, the epoch placement table
(K5 and, for the map shapes K5 does not express, K6), the OSD shard data
spine, the sharded codec over ``torch.distributed``, the RADOS cluster
(monitor, OSDs and a librados client over the messenger), the traffic
and failure harness that drives it (loadgen, the recovery and straggler
benches, chaos), Ceph's client applications over it (RBD, the
ObjectCacher, radosstriper, the RGW S3 and Swift gateway), and the
deployment layer: CephFS with its MDS pair and the mgr, and a cluster that
``vstart`` starts with one daemon a process, driven through the CLIs.

    python3 chip_smoke.py
    python3 chip_smoke.py --harness       # phase 11 alone
    python3 chip_smoke.py --cut-seconds   # phases 8d-8f with and without
                                          # each cut of the run's time

Phases, one line each; any failure exits non-zero and prints no result:

 1. the card's name and power limit; compile the XOR schedules of every
    matrix the run uses, each in a worker process of its own, while nvcc
    builds ``ceph_tpu_torch/csrc/*.cu`` (one process per source, all at
    once), then one generated K3 source per schedule digest likewise (K3's
    design, and ptxas's registers, shared memory and spills per digest, from
    the kept log of a cached build too; nvcc seconds); once the fixed
    sources are built, phases 2 and 2b and phase 3's K4 checks (none needs
    a schedule) run on the card while nvcc builds the K3 digests;
 2. K1/K2 against their plain PyTorch versions and the host GF(2^8) oracle
    on seeded inputs at small shapes, byte-exact (for K2: one step, a whole
    block plus a ragged tail at g=2 and g=1, RS decode, Cauchy at k=10, the
    LRC parity and local-repair matrices; for K1: k-steps at k=42 and 72,
    the PMSR k=5 parity matrix, a partial last W word at k=13);
 2b. the tensor-core MMA rates K1 and K2 stand on (``tools/mma_rate.py``):
    b1 m16n8k256 and u8 m16n8k32, in MMAs a clock a SM; no data sheet gives
    the b1 rate, so K1's bounds take the measured one as its peak;
 3. K3 likewise, on the schedules of RS, LRC and PMSR matrices and of
    matrices with a unit, a zero and a repeated row, with ragged L, odd B
    and a misaligned base; the large-k digests (RS k=20,m=4 and k=32,m=4
    parity, PMSR k=5 parity and decode: 160 and 256 input planes, the tiled
    design) also at a partial last block, as is a tall 20x8 matrix (160
    output planes: two tiles, each fetching the input rows); K4 (CRC32C)
    against its plain version and the host numpy engine at l in {0, 1, 7,
    8, 9, 127, 4096, 4099, 131072}, one row and many, and a misaligned base,
    and at the edges of its braid: rows shorter than 512 bytes, l = 16 mod
    512, a ragged head on a misaligned base, spans of 8 rounds with masked
    ends, and the one-launch entry for two sets of rows;
 3b. the dense kernels past their old limits: PMSR k=7,m=6 at (1024, 7,
    131136) through the dense route (K1 at k=42: two k-steps in one launch),
    encode and a 2-erasure decode; K1 at B=70000 (two launches: the wrapper
    splits the batch into ranges of at most 65535 stripes) and one K2
    launch at B/g=70000; byte-exact against the plain versions and the host
    oracle;
 4. the RS main path at full width: the ``cuda`` plugin at RS k=8,m=3
    encodes (1024, 8, 131072) bytes (1 MiB stripes, 1 GiB) with
    ``encode_batch``, recovers erasures [1, 9] with ``decode_batch``, then
    encodes and decodes one 1 MiB object per op; it routes dense (K1/K2);
 5. Cauchy k=10,m=4 2-erasure decode on (128, 10, 131072);
 6. LRC k=8,m=4,l=3 on (1024, 8, 131072): ``encode_batch`` and the local
    repair of chunk 0 from (1, 2, 3), once through the scheduled engine
    (``CEPH_TPU_XOR_SCHED=1``, K3) and once dense (``=0``, K2);
 7. PMSR k=5,m=4 on (1024, 5, 131072) (sub-lane 32768): encode and a
    2-erasure decode through K3 and dense (K1);
 8. the engine sweep ``ceph_tpu_torch.tools.ec_autotune --codes lrc,pmsr``
    at batch 1024, chunk 131072, and its winners;
 8b. K4 at full width: the chunk CRCs of the RS (1024, 11, 131072) data and
    parity rows against the host engine on sampled rows, and
    ``crc32c_resident`` of a ragged buffer over 64 MiB against the host
    engine on the whole buffer;
 8c. the OSD path, ``CodecBatcher`` -> ``MeshCodec``: 64 concurrent RS
    k=8,m=3 ``encode(with_crc=True)`` submissions of (16, 8, 131072)
    coalesce into one (1024, 8, 131072) launch plus the K4 CRCs; then a
    coalesced ``decode([1, 9])``, an ``rmw`` (new parity == re-encode), an
    LRC k=8,m=4,l=3 encode with fused CRCs and local repair and a PMSR
    k=5,m=4 decode through the flat dialect; byte-exact against the codecs' own
    ``encode_batch`` / ``decode_batch`` and the host CRC engine, one mesh
    launch per batch and no fallback; the batcher's wall clock per batch
    (host clock: marshal, PCIe and launch) and ``MeshCodec.encode
    (with_crc=True)`` on a device-resident batch (CUDA events), split into
    the GF(2^8) launch and K4;
 8d. bulk placement (``BASELINE.md`` config 5, the 1000-OSD depth-4 map of
    ``tools/crush_bench.py``): K5 against its plain version on the card,
    exactly, on 65,536 seeds (values >= 2^31 included) and against the
    scalar ``crush_do_rule`` on 128, for rule 0 (chooseleaf firstn, 3
    replicas) and rule 1 (chooseleaf indep, 11 slots) on the config-5 map,
    the same map degraded (2% of the OSDs at weight 0, 5% at 0x8000, one
    host out), a small map with a choose_args weight-set and hash-id
    overrides, and a 16,000-OSD map too large for K5 to stage in shared
    memory; K5 at rule 1 with 10 slots over 12 hosts, where most lanes fill
    their slots over several rounds, against the plain version on 65,536
    seeds and the scalar engine on 64; then the path: 10M seeds resident,
    5 launches of 2M lanes a rule (CUDA events: mappings/s and ms a
    launch), the first launch's rows held against the plain version, and
    ``bulk_crush`` over all 10M from numpy to numpy (host clock: marshal,
    PCIe, launch, back), whose rows must equal the launches' and, on 256
    of them, the scalar engine's (no hole, one replica a host);
 8e. the epoch placement table, ``OSDMap`` -> ``PGMapping`` over K5, on
    config 5's map at two sizes.  A realistic cluster: pools rbd (x3,
    pg_num 16384, rule 0) and ec83 (x11, pg_num 4096, rule 1), 94 PG shards
    an OSD; 2% of the OSDs down, a host out, 5% reweighted; the balancer's
    ``compute_upmaps(max_moves=100)`` plans plus upmap items whose target is
    missing or already present; pg_temp on 0.5% of the PGs (longer than the
    size, with dead members, all dead).  It is built, then three
    incrementals: a host down, a reweight of 20 OSDs, a placement-neutral
    up_thru (no rebuild).  Then ``BASELINE.md`` config 5's 10,485,760 PGs:
    one build and one host-down epoch.  Every build is held against the
    scalar pipeline on its overridden PGs and 128 random raw ps a pool and
    against the same table on the CPU (a CPU build from ``to_dict()``; at
    10M, and for the epochs, a CPU ingest of K5's raw rows); every delta
    against a brute-force diff.  The realistic cluster also holds Ceph's
    one-PG ``.mgr`` pool, which the card maps with K5 too.  Printed: each
    build's host clock through ``placement_cache``, and the same build
    driven stage by stage (the card synchronized at each stage's ends):
    the seeds (the hash on the card for a new pool spec, the cache after),
    K5 (CUDA events), the filter on the card, the copy back and the Python
    left over; the seeds by the numpy hash and copied up against the hash
    on the card; recompute_pgs_per_s; each epoch's rebuild + delta and
    delta_pgs; lookups a second.  Then two maps that the reference's bulk
    mapper refuses, config 5's OSDs in straw buckets and config 5's map
    with chooseleaf_vary_r = 0 (pg_num 256, 64, 1): the card's table maps
    each pool with K5 (one launch a pool, every pool fused, K5 == its plain
    version) and must equal the scalar pipeline on every PG and the CPU's
    build.  Then the shapes K5 does not express (ROADMAP queue 3): a host
    holding an osd and a bucket; uniform, list and tree hierarchies; straw
    buckets with legacy straw values; argonaut tunables; a chooseleaf of
    racks; a plain choose of hosts; ``choose 2 racks, chooseleaf 2 hosts``
    (same pg_nums): K5 must refuse both rules, the card's build must launch
    K6 once a pool and K5 never, with the host sweep replaced by one that
    fails, and its table must equal the scalar pipeline on every PG and the
    CPU's build.  K6 called directly at config 5 (straw2, K5's shape) and
    on its tree and list variants, 2M lanes, rules 0 x3 and 1 x11: == K5
    on every lane (straw2), == the scalar engine on a sample, CUDA events;
 8f. the OSD shard data spine (``tools/datapath_bench.py``): RS k=8,m=3 at a
    4 KiB stripe unit over 64 objects of 4 MiB (352 MiB stored in 11
    BlockStores), write -> read-verify -> scrub -> degraded read (5
    objects, shard 0 down), a warm-up drive, then the host round-trip
    baseline and the drive through the device-resident shard cache, whose
    scrub checks every shard's device view with one K4 launch; writes
    coalesce 64 objects into a (8192, 8, 4096) launch.  Checked: byte
    identity of both drives' reads against the source, cache hits, no
    steady host bytes and no scalar CRC call, one upload a shard in the
    first cached scrub and none after, the scrub's K4 CRCs against the host
    engine on every shard and K4's plain version on a sample, every write
    tag against the host engine's CRC of the stored shard, K1/K2 and K4
    launched, K3 not, no fallback; the dense kernel at the path's encode
    and decode shapes against its plain version and the stored shards.
    Printed: each drive's phases (seconds, GiB/s), end-to-end GiB/s and
    their ratio, the write's encode wait and store commit, the device-view
    upload, K4's sweep (CUDA events) against its HBM bound, peak device
    memory;
 9. the sharded codec (``parallel/sharded_ec.py``): at world size 1 (an
    NCCL group, whose collectives return at once at one rank, so no NCCL
    operation runs) on phase 4's (1024, 8, 131072) data,
    ``sharded_ec_step`` with erasures [1, 9], ``sharded_rmw`` of a 48 B
    write a stripe and ``sharded_cross_recovery``, each against the plain
    version (in slices) and the host oracle, the checksum against a host
    sum, K1/K2/K3 counted, each timed beside ``MeshCodec.encode`` /
    ``decode``; then ``dryrun_multichip``'s checks on 4 ranks on the card
    over gloo with CUDA tensors (the only run whose collectives move
    data), LRC k=12,m=4,l=4 also at (64, 4, 3, 131072); then
    ``graft_entry.entry()`` against its plain version and the host oracle;
10. the RADOS cluster (``tools/ec_osd_bench.py``'s ``ClusterDrive``): a
    monitor, 12 OSDs (one a host, MemStore, the shard cache at 64 MiB) and a
    librados client in one process on the card, an EC pool on plugin=cuda RS
    k=8,m=3 at a 4 KiB stripe unit and pg_num 32, 64 objects of 4 MiB:
    write_full at concurrency 16 (a warm round, a timed round, one round of
    16 objects under ``torch.profiler``, one of 16 under cProfile), a read
    sweep, one OSD killed and marked down (kept in), a degraded read sweep,
    a degraded write of half the objects, the OSD revived and recovered from
    the PG logs, a read sweep, ``scrub_ec`` of every PG on its primary.
    Checked: every read equals its source; 8 sampled objects' shards on
    every OSD and every shard of the revived OSD equal the host encode (the
    ``isa`` plugin), each CRC tag the host engine's; K2, K4 and K5 launched,
    K4 in the scrub; stripes a launch above 1, no fallback; no scrub
    inconsistency; the dense kernel at the write's and the degraded read's
    launch shapes, K4 at the write's CRC rows and K5 at the pool against
    their plain versions. Printed: the rates (host clock), batching and
    flush reasons, boot, mark-down, recovery and scrub seconds, the card's
    busy share (the profiled round's kernels and copies over its wall time),
    the host split of the cProfile'd round, launches by stage;
11. the traffic and failure harness at the reference's own shapes (bench.py's
    non-smoke modes), every daemon on the card, launches counted by
    sub-phase (11a by stage), in a process of its own (``chip_smoke.py
    --harness``: a fresh interpreter, as a user starts the harness; phase
    1's XOR schedules passed across).  11a, loadgen (``run_workload`` at
    ``bench.py::_cluster_spec(smoke=False)``, depth cut: ``HARNESS_LOADGEN``):
    64 OSDs, an EC 2+1 pool on cuda at pg_num 256, objects lognormal around
    16 KiB, the 0.50/0.35/0.15 read/write/RMW mix, Zipf s=1.1, 32
    closed-loop clients, load, steady, one OSD killed (degraded), revived
    (backfill), SimCluster's own heartbeats; checked: ``cluster_gates``, no
    failed or wedged op, only the victim ever marked down, the degraded
    stage's longest loop stall under the 1 s heartbeat interval, the
    kill detected, the OSD revived, clean after, degraded reads and
    recovery dispatches seen, RMW runs through the EC backend's
    partial-write path, ``scrub_ec`` of every PG clean, 8 sampled objects
    read back with their stored shards and tags == the host encode of the
    bytes read, K2/K4/K5 launched, the kernels at the path's launch shapes
    and K5 at the pool against their plain versions; printed: ops/s, GiB/s
    and p50/p95/p99/p99.9 per phase and class, the p99 degradation ratios,
    down detection, the scheduler's dispatches, stripes a launch, tables
    built, map epochs and K5 launches by stage, the loop's longest stall
    and p99 and the collector's pauses by stage.  11b,
    ``recovery_bench`` at ``code_configs(smoke=False)`` (RS k=8,m=4 on cuda,
    LRC k=8,m=4,l=3, PMSR k=5,m=4; 8 objects of 128 KiB, pg_num 16), a
    cluster a code on the default routes (K1 serves PMSR, K2 RS and LRC),
    then LRC and PMSR again under ``CEPH_TPU_XOR_SCHED=1`` (K3, its digests
    built in phase 1): the bench's gates, equal repair counters on both
    routes, K1 in the PMSR drive and K3 in both scheduled drives, the
    kernels at each drive's launch shapes against their plain versions.
    11c, ``straggler_bench`` at bench.py's non-smoke sizes (6 OSDs, EC 2+1,
    pg_num 64, 48 objects of 16 KiB, 120 reads from 8 clients, lognormal
    stragglers mu=ln 0.5, sigma=0.35, capped at 2 s): its gates (hedged
    p99 at least 2x better, extra sub-reads at most 1.5x, nothing failed,
    wedged, leaked or mismatched, one straggler schedule).  11d,
    ``tools/chaos.py --smoke`` (one kill-last round at seed 7);
12. Ceph's client applications (``tools/apps_drive.py``'s ``AppsDrive`` at
    its defaults) on phase 10's cluster shape plus a replicated pool ``rbd``,
    in a process of its own (``chip_smoke.py --apps``), launches counted
    by sub-phase.  12a, an RBD image of 128 MiB (order 22) on the EC pool,
    16 I/Os in flight: written whole in 4 MiB writes and read back, 64
    sequential 4 KiB writes one at a time in ``rbd bench``'s shape, 64
    random 4 KiB writes (each an EC read-modify-write: a K2 delta launch),
    64 through the ObjectCacher and a flush, one shard holder of object 0
    killed (kept in), the image read degraded, the OSD revived and
    recovered, ``scrub_ec`` of every PG, and where the machine has
    ``cryptography`` an encrypted 32 MiB image written and read back and a
    wrong passphrase refused (else a line says it did not run).  12b,
    RBD's features on a 32 MiB image of the replicated pool (snapshots,
    protect, clone, copyup, flatten, rollback, resize, discard, export,
    the object map and ``fast_diff``), an exclusive lock broken by a second
    client whose blocklist refuses the deposed holder's next write at the
    OSDs, a live migration, and snapshot- and journal-mode mirroring to a
    second cluster of 3 OSDs on the card.  12c, radosstriper at
    ``Layout()``'s defaults: a 32 MiB file written, read, overwritten,
    truncated and removed, two clients writing one file at once,
    ``SimpleRADOSStriper`` taking over a lapsed holder's lock.  12d, RGW
    (4 MiB stripes) through ``Gateway`` and ``S3Client`` over loopback
    HTTP: 8 PUTs and GETs of 8 MiB, a 32 MiB multipart upload in 8 MiB
    parts, list, HEAD, a versioned bucket, a Swift PUT and GET, every
    object read again while the OSD is down, DELETE.  Checked: every read
    equals its host oracle, 0 failed ops, only the victim marked down, a
    clean scrub, 8 sampled image objects' shards and tags == the host
    encode and the host engine, K2, K4 and K5 launched, the dense kernel
    at the path's encode, RMW and decode launch shapes and K4 at the
    encode's fused CRC rows (an RMW's shard CRCs are the host engine's)
    against their plain versions, K5 at both pools.  Printed beside
    the card's name and power limit: GiB/s of each sweep, IOPS and p50/p99
    of the 4 KiB writes, flush, recovery and scrub seconds, stripes a
    launch and flush reasons, launches by sub-phase;
13. the deployment layer, in a process of its own (``chip_smoke.py
    --fs``).  13a, CephFS (``tools/fs_drive.py``'s ``FsDrive`` at its
    defaults) on phase 10's cluster shape: the data pool ``cephfs_data``
    on RS k=8,m=3 (cuda), ``cephfs_metadata`` replicated x3, a mgr at
    vstart's configuration (the balancer on, prometheus serving), MDS a
    and b, two mounts; 32 small files in 8 directories (16 creates in
    flight, lognormal around 16 KiB) read back, 2 files of 16 MiB at the
    default 4 MiB layout written and read, 64 random 4 KiB overwrites
    (EC read-modify-writes), both mounts appending to one file, a rename
    and an unlink's purge, ``cephfs_cli`` put/get/ls in processes of their
    own, fs_mirror of one directory to a second cluster of 3 OSDs, the
    active MDS stopped and the standby's takeover, the mgr's prometheus
    scrape.  Checked: every read equals its oracle, 0 failed ops, no
    mark-down, the scrape against the map and the OSDs' counters, K2, K4
    and K5 launched, the dense kernel at the path's launch shapes, K4 at
    the encode's CRC rows and K5 at both pools against their plain
    versions.  13b, ``python -m ceph_tpu_torch.tools.vstart`` with one
    daemon a process: a monitor and 12 OSDs on BlockStores (``--hosts
    12``), each process on the card; ``ceph_cli`` (an EC profile k=8 m=3
    plugin=cuda, pool ec83 pg_num 32, status, osd tree, pool rbd),
    ``rados_cli`` put/get and bench, ``rbd_cli`` create and bench of 64
    4 KiB writes, ``rgw_cli`` user create and serve with a PUT and GET of
    8 MiB, the exporter over the admin sockets, each a process; then this
    process's client writes 16 objects of 4 MiB, SIGKILLs a shard holder
    of object 0, writes 8 more, restarts it on its BlockStore and reads
    all 24 back.  Checked: the CLIs' bytes, every OSD process up in the
    exporter's scrape and K2 batches in every one that is primary of a PG
    that took a write, every read equals its oracle, HEALTH_OK, only the
    killed OSD marked down, every daemon exits 0 on SIGTERM, 8 sampled
    objects' shards on the BlockStores == the host encode.  Printed: the
    rates, IOPS and p50/p99 (host clock), the failover's seconds, the
    launches by step and by OSD process;
14. a ``kernels`` JSON line: per kernel its launches on its paths (phases
    4, 8f, 9, 10, 11, 12 and 13 for K1/K2, phases 6-7 and 11b for K3,
    phases 8c, 8f, 10, 11, 12 and 13 for K4, phases 8d, 8e, 10, 11, 12 and
    13a for K5, phase 8e for K6), its
    time at its headline shape, its bound, its plain version's time and its
    largest difference from the plain version; K1, K2, K3 and K5 also their
    times and bounds on the other paths they serve (``ms_by_path`` /
    ``bound_by_path``: each bound the larger of the bytes and the fewest
    operations known, of K3's XOR terms where the schedule is compiled, b1
    MMAs at the measured rate, int8 products and K5's straw2 draws without
    retries, 140 integer operations a draw of which 75 run only on the ALU
    pipe, at whichever of the ALU pipe's and the issue slots' rates takes
    longer; K3 also at the RS k=8,m=3 parity of phase 4's input), K1/K2/K4/K5 their registers, shared memory,
    blocks per SM and spill or local bytes as the CUDA runtime reports
    them (K5 also ptxas's registers and spill bytes), and K3 per digest
    its design, shared memory, and ptxas's registers and spill bytes;
15. the result line {"ok": true, "device": {...}}.

Each path's launch counts are set to 0 just before it is driven and read
just after; a kernel of the path that did not launch fails the run.

It needs one card; without one it exits with code 2 before doing anything.
"""

from __future__ import annotations

import collections
import contextlib
import io
import json
import os
import subprocess
import sys
import time
import types

import numpy as np
import torch

SEED = 0
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
INT8_OPS_PER_S = 1979e12         # H100 SXM dense int8 tensor-core peak
SMS = 132                        # H100 SXM
INT32_OPS_PER_CLOCK = 64 * SMS   # H100 SXM: 64 lanes of integer ALU per SM
INT_ISSUE_PER_CLOCK = 128 * SMS  # 4 schedulers x 32 lanes: ALU and FMA pipes
SMEM_LOOKUPS_PER_CLOCK = 32 * SMS  # H100: 32 shared-memory banks per SM
GiB = float(1 << 30)
# (stripes, k, m, chunk bytes): BASELINE.json configs 2 and 3, 1 MiB stripes
MAIN = (1024, 8, 3, 131072)
CAUCHY = (128, 10, 4, 131072)
# the recovery codes at full width: (stripes, chunk bytes) and profile
LRC = (1024, 131072, {"k": "8", "m": "4", "l": "3"})
PMSR = (1024, 131072, {"k": "5", "m": "4"})
PMSR_LOST = (1, 6)               # a data chunk and a coding chunk
# the engine sweep's (batch, chunk); it writes a table in the build
# directory, not the live one
SWEEP = (1024, 131072)
# PMSR k=7,m=6 through the dense route: chunk = the smallest multiple of the
# codec's alignment (192 = SIMD_ALIGN 32 x alpha 6) >= 131072
PMSR7 = (1024, 131136, {"k": "7", "m": "6"})
PMSR7_LOST = (1, 9)
# the dense kernels' old grid limit, passed: (B, k, L) at r=3 and K2's g
K1_WIDE = (70000, 8, 128)
K2_WIDE = (140000, 8, 128, 2)
# the OSD path: submissions x (stripes, k, chunk bytes), one batch of 1024
OSD = (64, 16, 131072)
# K4's ragged resident buffer: 64 MiB and a ragged tail
RESIDENT_BYTES = (64 << 20) + 12345
# BASELINE.md config 5: 10M pps seeds (default_rng(0)) over the 1000-OSD
# depth-4 map of ceph_tpu_torch/tools/crush_bench.py, launches of 2M lanes;
# rule 0 (replicated chooseleaf firstn) at 3 replicas, rule 1 (erasure
# chooseleaf indep) at 11, an RS k=8,m=3 PG
PLACEMENT = (10_000_000, 2_000_000, (5, 5, 4, 10))
PLACEMENT_RULES = ((0, 3), (1, 11))
# the checks' samples, cut for the run's time (the values before the cuts
# are CUTS_BEFORE's)
PLACEMENT_SAMPLE = 65536         # lanes K5 is held against its plain version
PLACEMENT_SCALAR = 128           # lanes held against the scalar engine
PLACEMENT_BULK_SCALAR = 256      # bulk_crush rows held against it
# a 16,000-OSD map: its tables (70,868 words) pass the 8,192 K5 stages in
# shared memory, so its launches read them from global memory
PLACEMENT_GLOBAL = (10, 10, 16, 10)
# few hosts under many slots (fanouts, numrep, lanes): rule 1 fills most
# lanes' slots over several rounds, K5's per-lane order of (round, slot)
PLACEMENT_ROUNDS = ((12, 4), 10, 65536)
# a straw2 draw at its fewest integer operations: one hash32_3 (5 rjenkins
# mixes of 9 lines: a three-input subtraction, a shift and an XOR each) and
# crush_ln, the quotient and the compare; of them the mixes' 45 XORs and 30
# right shifts run only on the ALU pipe (LOP3, SHF), the rest also on the
# FMA pipe (IMAD)
INT_OPS_PER_DRAW = 140
ALU_OPS_PER_DRAW = 75
# phase 8e, the epoch placement table on config 5's map: (pool id, name,
# erasure, size, rule) and pg_num at two sizes.  A realistic cluster puts 94
# PG shards on each of the 1000 OSDs, the PG autoscaler's target
# (mon_target_pg_per_osd = 100, src/common/options/global.yaml.in);
# beside them the mgr's own pool, .mgr, of one PG (Ceph creates it so), whose
# one lane the card maps with K5 as it does the others.  BASELINE.md config
# 5's scale is 10,485,760 PGs (rbd and ec83 only: zip stops at two).
TABLE_POOLS = ((1, "rbd", False, 3, 0), (2, "ec83", True, 11, 1),
               (3, ".mgr", False, 3, 0))
TABLE_PG_NUMS = {"realistic": (16384, 4096, 1), "10M": (1 << 23, 1 << 21)}
TABLE_DOWN, TABLE_REWEIGHTED = 0.02, 0.05   # shares of the OSDs
TABLE_TEMP = 0.005               # share of the realistic cluster's PGs
TABLE_TEMP_10M = 512             # pg_temps at 10M (each is held scalar)
TABLE_UPMAP_MOVES = 100          # compute_upmaps(max_moves=...)
TABLE_SAMPLE = 128               # random raw ps a pool held scalar
TABLE_LOOKUPS = 100_000
# map shapes the reference's bulk mapper refuses and K5 expresses (straw
# buckets; jewel's tunables with chooseleaf_vary_r = 0) on config 5's OSDs;
# pg_num cut so that the scalar pipeline can check every PG, and cut again
# for the run's time
TABLE_EXPRESSED_PG_NUMS = (256, 64, 1)
# phase 8e, K6: the map shapes K5 does not express (ROADMAP queue 3), each on
# config 5's OSDs at TABLE_EXPRESSED_PG_NUMS, built on the card with one K6
# launch a pool
K6_SHAPES = ("a host holding an osd and a bucket", "uniform buckets",
             "list buckets", "tree buckets", "straw with legacy straw values",
             "argonaut tunables", "chooseleaf of racks",
             "plain choose of hosts", "choose 2 racks, chooseleaf 2 hosts")
# K6 timed directly at config 5 (K5's straw2 map) and on its tree and list
# variants, rules 0 x3 and 1 x11, a launch of K6_LANES; its plain version,
# the scalar engine, on the first lanes of each rule's seeds
K6_LANES = 2_000_000
K6_PLAIN_SAMPLE = {0: 256, 1: 64}
K6_BULK_SCALAR = 128             # bulk_crush rows a shape held scalar
# phase 9, the sharded codec: LRC k=12,m=4,l=4 at full width on four ranks
# (B, groups, kg, L), beside the dry run's checks
SHARDED_LRC = (64, 4, 3, 131072)
SHARDED_RANKS = 4
# phase 8f, the OSD shard data spine (tools/datapath_bench.py): RS k=8,m=3
# (BASELINE.json's code) at Ceph's stripe unit (osd_pool_erasure_code_
# stripe_unit 4 KiB, src/common/options/global.yaml.in: 32 KiB stripes) over
# 64 objects of RBD's default 4 MiB (rbd_default_order 22,
# src/common/options/rbd.yaml.in): 256 MiB logical, 352 MiB stored, 32 MiB
# a shard store, under osd_datapath_cache_bytes' 64 MiB default; each
# store's cache keeps the rig's 256 MiB budget, the reference's.  The
# batcher takes 8192 stripes a launch, so the 64 objects' writes coalesce
# into one (8192, 8, 4096) launch.  Cut for the run's time limit: passes 2
# (reference 10), read-verify sweeps a pass 2 (reference 5), the objects
# 128 -> 64.  Degraded reads: 64 // 12 = 5 objects with shard 0 down (the
# reference rig's share).
DATAPATH = dict(k=8, m=3, n_objects=64, obj_bytes=4 << 20, passes=2,
                reads_per_pass=2, stripe_unit=4096, max_batch=8192)
DATAPATH_PLAIN_SAMPLE = 8        # device views held against K4's plain version
# ``--cut-seconds``: phases 8d-8f's cuts for the run's time, each with the
# constants it changed at their values before it, and the phase it times
CUT_FLAG = "--cut-seconds"
CUTS_BEFORE = {
    "8d samples": ("phase_placement", {"PLACEMENT_SAMPLE": 262144,
                                       "PLACEMENT_SCALAR": 512}),
    "8e pg_nums": ("phase_table", {"TABLE_EXPRESSED_PG_NUMS": (1024, 256, 1)}),
    "8e sample": ("phase_table", {"TABLE_SAMPLE": 512}),
    "8e K6 sample": ("phase_k6", {"K6_PLAIN_SAMPLE": {0: 1024, 1: 256}}),
    "8f objects": ("phase_datapath", {"DATAPATH": dict(DATAPATH,
                                                       n_objects=128)}),
}
# phase 10, the RADOS cluster (tools/ec_osd_bench.py's ClusterDrive): one
# monitor and 12 OSDs, one a host (RS k=8,m=3 needs 11 hosts for failure
# domain host; the 12th is where recovery can go), MemStore (the reference
# cluster's default store), the shard cache at its default 64 MiB an OSD; an
# EC pool on plugin=cuda k=8 m=3 reed_sol_van (BASELINE.json's code) at
# the pool's default stripe unit, Ceph's 4 KiB, and osd_pool_default_pg_num
# 32; 64 objects of RBD's default 4 MiB (256 MiB logical, 352 MiB stored).
# write_full at concurrency 16, a warm round and a timed round; a read
# sweep; one OSD killed and marked down (kept in: mon_osd_down_out_interval
# long); a degraded read sweep; a degraded write round over half of the
# objects; the OSD revived and recovered from the PG logs; a read sweep;
# scrub_ec of every PG on its primary.  Cut for the run's time: the timed
# rounds, 2 -> 1, and the objects, 128 -> 64.
CLUSTER = dict(n_osds=12, k=8, m=3, pg_num=32, n_objects=64,
               obj_bytes=4 << 20, concurrency=16, rounds=1)
CLUSTER_STRIPE_UNIT = 4096       # the pool's default; the host oracle's
CLUSTER_ORACLE_SAMPLE = 8        # objects whose every shard the host checks
CLUSTER_PROFILED_OBJECTS = 16    # objects of the torch.profiler write round
CLUSTER_HOST_OBJECTS = 16        # objects of the cProfile'd write round
# phase 11, the traffic and failure harness at the reference's own shapes
# (bench.py's non-smoke modes).  11a: bench.py::_cluster_spec(smoke=False),
# 64 OSDs (one a host), pg_num 256, an EC pool at k=2,m=1 on cuda
# reed_sol_van, objects lognormal around 16 KiB clamped to 4-64 KiB, the
# 0.50/0.35/0.15 read/write/RMW mix with 2 KiB RMW spans, Zipf s=1.1, 32
# closed-loop clients, one OSD killed under traffic, SimCluster's own
# heartbeats (1 s interval, 6 s grace at 64 OSDs) and the reference's
# settings throughout.  Cut: recovery_ops 1,200 -> 300 (the reference's own
# CPU capture, BENCH_cluster_cpu.json); n_objects 10,000 -> 5,000 for the
# run's time (phase 11 within 300 s: the load writes 60-90 objects a second,
# the scrub reads them all).
HARNESS_LOADGEN = dict(n_osds=64, pg_num=256, n_objects=5000,
                       obj_size=16 << 10, n_ops=6000, n_clients=32,
                       recovery_ops=300, kill_osds=1, size_dist="lognormal",
                       seed=1)
# the stage each of run_workload's stage ends opens (the loop's stalls and
# the collector's pauses are kept by the stage they fall in)
HARNESS_NEXT_STAGE = {"boot": "load", "load": "steady", "steady": "degraded",
                      "degraded": "backfill", "backfill": "settle",
                      "report": "scrub"}
# the degraded stage's longest loop stall must stay under SimCluster's
# heartbeat interval at 64 OSDs
HARNESS_STALL_LIMIT = 1.0
HARNESS_ORACLE_SAMPLE = 8
# phase 11 runs in a process of its own: its flag, and the tag of the line
# that carries its summary back
HARNESS_FLAG = "--harness"
HARNESS_TAG = "phase 11 summary: "        # 11a objects whose every shard the host checks
# 11b: recovery_bench.code_configs(smoke=False) at bench.py --recovery's
# sizes (objects of 128 KiB, pg_num 16); cut for the run's time: 16 objects
# -> 8
HARNESS_RECOVERY = dict(n_objects=8, obj_size=128 << 10, pg_num=16, seed=7)
# 11c: straggler_bench.FULL, its reads cut for the run's time (240 -> 120)
HARNESS_STRAGGLER_READS = 120
# phase 12, the client applications: tools/apps_drive.py's AppsDrive at its
# defaults, which hold the sizes and the cuts (the image, the 4 KiB rounds,
# the striper's file, RGW's objects)
APPS_ORACLE_SAMPLE = 8           # image objects whose every shard the host checks
APPS_FLAG = "--apps"
APPS_TAG = "phase 12 summary: "
# the sub-phase each of the drive's stages belongs to
FS_FLAG = "--fs"
FS_TAG = "phase 13 summary: "
# 13b: vstart's cluster, one daemon a process; the CLIs' and the client's
# sizes (rbd bench: 64 writes of 4 KiB; rados bench: 5 s of 4 MiB); cut for
# the run's time: the client's objects 64 + 32 -> 16 + 8, rados bench's
# seconds 10 -> 5, rbd bench's writes 128 -> 64
VSTART = dict(n_osds=12, k=8, m=3, pg_num=32, objects=16, more=8,
              obj_bytes=4 << 20, cli_bytes=(3 << 20) + 12345, bench_s=5,
              rbd_size="64M", rbd_total="256K", s3_bytes=8 << 20)
VSTART_ORACLE_SAMPLE = 8         # objects whose every shard the host checks
VSTART_TIMEOUT = 120.0           # seconds any one wait of 13b may take
VSTART_OFFLINE_S = 5.0           # 13b's offline replay and mapping, at most
APPS_SUBPHASE = {"boot": "12a", "12a write and read": "12a",
                 "12a sequential 4K": "12a", "12a random 4K": "12a",
                 "12a cached 4K": "12a", "12d put, get, multipart": "12d",
                 "12c striper": "12c", "kill": "12a",
                 "12a degraded read": "12a", "12d degraded get": "12d",
                 "revive and recovery": "12a", "scrub": "12a",
                 "12a crypto": "12a", "12b features": "12b",
                 "12d delete": "12d"}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 10) -> float:
    """Mean device time of ``fn`` over ``iters`` launches after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_once_ms(fn) -> float:
    """Device time of one call of ``fn``, without a warm-up (for a plain
    version whose one call takes seconds)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def host_ms(fn, iters: int = 10) -> float:
    """Mean host-clock time of a call that ends on the host (numpy out)."""
    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3


def host_stripes(matrix, x: torch.Tensor, idx) -> list[np.ndarray]:
    from ceph_tpu_torch.gf import gf_matmul
    return [gf_matmul(matrix, x[int(i)].cpu().numpy()) for i in idx]


def ptxas_summary(report: str) -> str:
    """Registers, shared memory, stack frame and spill bytes from an nvcc
    -Xptxas -v log."""
    from ceph_tpu_torch.ops._build import ptxas_counts
    c = ptxas_counts(report)
    if not c["kernels"]:
        return "no report"
    return (f"{c['kernels']} kernels, {c['min_registers']}-{c['registers']} "
            f"registers, {c['smem']} bytes smem, {c['stack']} bytes stack, "
            f"{c['spill_stores']}/{c['spill_loads']} bytes spill "
            f"stores/loads")


@contextlib.contextmanager
def xor_sched_env(value: str | None):
    """CEPH_TPU_XOR_SCHED for the block: "1" scheduled, "0" dense, None the
    cost model's own choice (dense on the card)."""
    old = os.environ.pop("CEPH_TPU_XOR_SCHED", None)
    if value is not None:
        os.environ["CEPH_TPU_XOR_SCHED"] = value
    try:
        yield
    finally:
        os.environ.pop("CEPH_TPU_XOR_SCHED", None)
        if old is not None:
            os.environ["CEPH_TPU_XOR_SCHED"] = old


def path_matrices() -> dict:
    """Every GF(2^8) matrix whose schedule this run launches, by label."""
    from ceph_tpu_torch.ec.plugins.lrc import ErasureCodeLrc
    from ceph_tpu_torch.ec.plugins.pmsr import ErasureCodePmsr
    from ceph_tpu_torch.gf import build_decode_matrix, gen_rs_matrix

    rs = gen_rs_matrix(11, 8)
    lrc = ErasureCodeLrc()
    lrc.init(dict(LRC[2]))
    pmsr3 = ErasureCodePmsr()
    pmsr3.init({"k": "3", "m": "2"})
    pmsr5 = ErasureCodePmsr()
    pmsr5.init(dict(PMSR[2]))
    n5 = pmsr5.get_chunk_count()
    plan = pmsr5.decode_plan(set(PMSR_LOST), set(range(n5)) - set(PMSR_LOST))
    return {
        "rs8/3 parity": rs[8:],
        "rs20/4 parity": gen_rs_matrix(24, 20)[20:],
        "rs32/4 parity": gen_rs_matrix(36, 32)[32:],
        "tall 20x8": gen_rs_matrix(28, 8)[8:],
        "rs8/3 decode[1,9]": build_decode_matrix(rs, 8, [1, 9])[0],
        "lrc8/4/3 parity": lrc.parity_matrix,
        "lrc8/4/3 local repair": lrc.repair_matrix((1, 2, 3), (0,)),
        "pmsr3/2 parity": pmsr3.parity_matrix,
        "pmsr3/2 aggregate": pmsr3.aggregate_matrix(0, (1, 2, 3, 4)),
        "unit, zero, repeated rows": np.array(
            [[1, 0, 0, 0], [0, 0, 0, 0], [5, 7, 0, 2], [5, 7, 0, 2],
             [0, 0, 1, 0]], np.uint8),
        "pmsr5/4 parity": pmsr5.parity_matrix,
        f"pmsr5/4 decode{list(PMSR_LOST)}": pmsr5.repair_matrix(*plan),
        "pmsr5/4 aggregate": pmsr5.aggregate_matrix(
            0, tuple(range(1, 1 + pmsr5.d))),
        # phase 11b's degraded reads under CEPH_TPU_XOR_SCHED=1: a PMSR
        # k=5,m=4 data chunk lost, repaired from the first k survivors
        **{f"pmsr5/4 decode[{q}]": pmsr5.repair_matrix(*pmsr5.decode_plan(
            {pmsr5.chunk_index(i) for i in range(5)},
            set(range(n5)) - {q})) for q in range(5)},
    }


def compile_schedules(mats: dict, workers: int | None = None) -> dict:
    """label -> the XOR schedule of each GF(2^8) matrix, each compiled in a
    spawned worker process (the largest first) and registered in
    ``xor_schedule``'s process-wide cache as ``schedule_for`` registers a
    serial compile: the same schedules, a matrix's digest its key."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    from ceph_tpu_torch.ops import gf2kernels as gk
    from ceph_tpu_torch.ops import xor_schedule as xs
    bits = {label: gk.bitmatrix_i8(mat) for label, mat in mats.items()}
    order = sorted(bits, key=lambda label: -int(bits[label].sum()))
    with ProcessPoolExecutor(
            min(len(order), workers or os.cpu_count() or 1),
            multiprocessing.get_context("spawn")) as pool:
        futs = {label: pool.submit(xs.compile_schedule, bits[label])
                for label in order}
        done = {label: f.result() for label, f in futs.items()}
    with xs._LOCK:
        return {label: xs._SCHEDULES.setdefault(done[label].digest,
                                                done[label])
                for label in mats}


def phase_build(beside) -> tuple[dict, float]:
    """Compile the schedules in worker processes while nvcc builds the
    fixed sources, then build each schedule's K3 source while ``beside``
    runs in this process once the fixed sources are built (the phases that
    need no schedule and no K3); returns (label -> (matrix, schedule, nvcc
    seconds, K3's design and ptxas counts), the host CSE's seconds)."""
    from concurrent.futures import ThreadPoolExecutor
    from ceph_tpu_torch.ops import _build
    from ceph_tpu_torch.ops import xor_sched_codegen as cg
    from ceph_tpu_torch.ops import xor_schedule as xs
    log(f"card: {card_label()}")
    sources = _build.all_sources()
    t0 = time.perf_counter()

    def build_host() -> float:
        # the host codecs the daemons' messages and stores run (g++)
        from ceph_tpu_torch import native
        from ceph_tpu_torch.common import denc_native
        native.load()
        denc_native.load()
        return time.perf_counter() - t0

    with ThreadPoolExecutor(3) as nvcc:
        host = nvcc.submit(build_host)
        fixed = nvcc.submit(_build.build, sources)
        with xor_sched_env("0"):        # the codecs build, not warm, them
            mats = path_matrices()
        scheds = compile_schedules(mats)
        cse_s = time.perf_counter() - t0
        log(f"schedules: {len(scheds)} compiled in {cse_s:.2f} s (host CSE, "
            f"a worker process a schedule, nvcc building the fixed sources "
            f"meanwhile)")
        k3 = {label: xs.k3_source(sched) for label, sched in scheds.items()}

        def build_k3() -> tuple[dict, float]:
            built = _build.build(sorted(set(k3.values())))
            return built, time.perf_counter() - t0
        digests = nvcc.submit(build_k3)
        reports = fixed.result()
        fixed_s = time.perf_counter() - t0
        with xor_sched_env("0"):
            beside()
        beside_s = time.perf_counter() - t0 - fixed_s
        built_k3, k3_s = digests.result()
        reports.update(built_k3)
        host_s = host.result()
    dt = time.perf_counter() - t0
    for name in sources:
        if name in reports:
            log(f"ptxas {name}: {ptxas_summary(reports[name].log)}")
    out = {}
    for label, name in k3.items():
        sched, built = scheds[label], reports.get(name)
        secs = built.seconds if built else None
        report = _build.report(name)
        counts = _build.ptxas_counts(report)
        info = {"design": cg.design_for(sched).tag,
                **{key: counts[key] if counts["kernels"] else None
                   for key in ("registers", "smem", "spill_stores",
                               "spill_loads")}}
        out[label] = (mats[label], sched, secs, info)
        log(f"K3 {label}: {sched.n_out}x{sched.n_in}, {sched.n_terms} XORs "
            f"(naive {sched.naive_terms}), peak {sched.peak_registers} "
            f"temporaries; design {info['design']}; ptxas "
            f"{ptxas_summary(report)}, "
            + (f"nvcc {secs:.2f} s" if built else "already built"))
    log(f"build: {len(sources)} sources + {len(set(k3.values()))} K3 digests "
        f"and phases 2, 2b and phase 3's K4 checks in {dt:.2f} s "
        f"({len(reports)} compiled, sm_90a, one nvcc a source): the fixed "
        f"sources built at {fixed_s:.2f} s beside the host CSE ({cse_s:.2f} "
        f"s), the K3 digests from {cse_s:.2f} s to {k3_s:.2f} s beside those "
        f"phases ({beside_s:.2f} s on the card); in turns, as before, "
        f"{max(cse_s, fixed_s) + k3_s - cse_s + beside_s:.2f} s")
    log(f"host build: the CRC32C engine and the denc value codec, done at "
        f"{host_s:.2f} s beside the rest")
    return out, cse_s


def phase_kernels(dev: torch.device) -> dict:
    """Small seeded shapes: kernel == plain == host oracle, byte for byte."""
    from ceph_tpu_torch.ec.plugins.lrc import ErasureCodeLrc
    from ceph_tpu_torch.gf import (gen_rs_matrix, gen_cauchy1_matrix,
                                   build_decode_matrix)
    from ceph_tpu_torch.ops import gf2kernels as gk

    rng = np.random.default_rng(SEED)
    cases = []                                  # (label, matrix, B, L)
    for k, m, n in [(8, 3, 512), (10, 4, 96), (4, 2, 8192), (8, 3, 1000)]:
        mat = gen_rs_matrix(k + m, k)[k:]
        cases.append((f"rs{k}/{m} flat n={n}", mat, 1, n))
        cases.append((f"rs{k}/{m} B=8 L={n}", mat, 8, n))
    gen83 = gen_rs_matrix(11, 8)
    cases.append(("rs8/3 ragged", gen83[8:], 3, 1001))
    cases.append(("rs8/3 decode[1,9]", build_decode_matrix(gen83, 8, [1, 9])[0],
                  4, 512))
    cases.append(("rs8/3 odd B", gen83[8:], 5, 256))
    cauchy = gen_cauchy1_matrix(14, 10)
    cases.append(("cauchy10/4 decode[2,11]",
                  build_decode_matrix(cauchy, 10, [2, 11])[0], 2, 256))
    cases.append(("rs5/3 g=1 k=5", gen_rs_matrix(8, 5)[5:], 2, 128))
    # K2's pipeline: one 128-column step; a whole block (64 steps, 8192
    # columns) plus a ragged tail, at g=2 and at g=1 (B=3); the LRC parity
    # (r=8, four n-tiles) and local-repair (k=3, r=1) matrices
    lrc = ErasureCodeLrc()
    lrc.init(dict(LRC[2]))
    cases.append(("rs8/3 one step", gen83[8:], 2, 128))
    cases.append(("rs8/3 block + ragged tail", gen83[8:], 4, 8192 + 384))
    cases.append(("rs8/3 g=1 block + ragged tail", gen83[8:], 3, 8192 + 384))
    cases.append(("lrc8/4/3 parity r=8", lrc.parity_matrix, 2, 640))
    cases.append(("lrc8/4/3 local repair k=3 r=1",
                  lrc.repair_matrix((1, 2, 3), (0,)), 4, 384))
    # K1's split-k: 42 chunks (32 + 10) at r=36, 72 chunks in three groups
    wide = np.random.default_rng(SEED + 8)
    cases.append(("k=42 r=36 split-k", wide.integers(0, 256, (36, 42),
                                                     dtype=np.uint8), 3, 1001))
    cases.append(("k=72 r=3 split-k", wide.integers(0, 256, (3, 72),
                                                    dtype=np.uint8), 2, 512))
    # K1's row groups at PMSR k=5 parity (16 x 20), a partial last W word
    from ceph_tpu_torch.ec.plugins.pmsr import ErasureCodePmsr
    pmsr = ErasureCodePmsr()
    pmsr.init(dict(PMSR[2]))
    cases.append(("pmsr5/4 parity 16x20", pmsr.parity_matrix, 3, 1001))
    # K1's staged tiles (L % 16 == 0) with a ragged last tile
    cases.append(("pmsr5/4 parity staged, ragged", pmsr.parity_matrix, 2, 4112))
    cases.append(("rs8/3 staged, ragged", gen83[8:], 3, 1008))
    cases.append(("k=13 r=5", wide.integers(0, 256, (5, 13), dtype=np.uint8),
                  2, 4100))

    err = {"gf2_matmul_popc": 0, "gf2_matmul_mma": 0}
    checked = {"gf2_matmul_popc": 0, "gf2_matmul_mma": 0}
    for label, mat, b, l in cases:
        mat = np.ascontiguousarray(mat, np.uint8)
        k = mat.shape[1]
        x = torch.from_numpy(
            rng.integers(0, 256, (b, k, l), dtype=np.uint8)).to(dev)
        want = np.stack(host_stripes(mat, x, range(b)))
        runs = [("gf2_matmul_popc", lambda: gk.gf2_matmul_popc(mat, x),
                 lambda: gk.gf2_matmul_plain(
                     torch.from_numpy(gk.bitmatrix_i8(mat)).to(dev), x))]
        g = gk.pick_group(k, b)
        if l % gk.MMA_COLS == 0 and 8 * k * g <= 128:
            runs.append(("gf2_matmul_mma", lambda: gk.gf2_matmul_mma(mat, x, g),
                         lambda: gk.gf2_matmul_grouped_plain(
                             torch.from_numpy(gk.w_gN_planemajor(mat, g)).to(dev),
                             x, g)))
        for name, kernel, plain in runs:
            got = kernel()
            ref = plain()
            torch.cuda.synchronize()
            diff = int((got.int() - ref.int()).abs().max())
            err[name] = max(err[name], diff)
            if diff or not np.array_equal(got.cpu().numpy(), want):
                raise RuntimeError(f"{name} differs on {label}: max |kernel - "
                                   f"plain| = {diff}")
            checked[name] += 1
    log(f"kernels vs plain and host oracle: {checked} shapes byte-exact")
    return err


def phase_k3_small(dev: torch.device, built: dict) -> int:
    """K3 == plain == host oracle, byte for byte, on small seeded shapes."""
    from ceph_tpu_torch.gf import gf_matmul
    from ceph_tpu_torch.ops import xor_schedule as xs

    pmsr_dec = next(label for label in built if "pmsr5/4 decode" in label)
    cases = [   # (label, B, L, misaligned base)
        ("rs8/3 parity", 2, 512, False), ("rs8/3 parity", 3, 1001, False),
        ("rs8/3 parity", 2, 512, True),
        ("rs8/3 decode[1,9]", 4, 512, False),
        ("lrc8/4/3 parity", 5, 4096, False),
        ("lrc8/4/3 local repair", 3, 1000, False),
        ("pmsr3/2 parity", 2, 777, False), ("pmsr3/2 aggregate", 1, 64, False),
        ("unit, zero, repeated rows", 7, 100, False),
        ("pmsr5/4 parity", 2, 2048, False), (pmsr_dec, 2, 1024, False),
        ("pmsr5/4 aggregate", 3, 96, False),
    ]
    # the tiled design at large k (160 and 256 input planes) and past one
    # tile: ragged L, odd B, a misaligned base, and a last block of 64
    # threads that is partly past the batch
    for label in ("rs20/4 parity", "rs32/4 parity", "pmsr5/4 parity",
                  pmsr_dec, "tall 20x8"):
        cases += [(label, 3, 1001, False), (label, 5, 4096, True),
                  (label, 1, 7, False), (label, 3, 32 * 45, False)]
    rng = np.random.default_rng(SEED + 4)
    err = 0
    for label, b, l, misaligned in cases:
        mat, sched, _, _ = built[label]
        k = mat.shape[1]
        host = rng.integers(0, 256, (b, k, l), dtype=np.uint8)
        if misaligned:
            buf = torch.empty(b * k * l + 1, dtype=torch.uint8, device=dev)
            x = buf[1:].view(b, k, l)
            x.copy_(torch.from_numpy(host))
        else:
            x = torch.from_numpy(host).to(dev)
        got = xs.xor_sched(sched, x)
        ref = xs.apply_bits_plain(sched, x)
        torch.cuda.synchronize()
        diff = int((got.int() - ref.int()).abs().max())
        err = max(err, diff)
        want = np.stack([gf_matmul(mat, host[i]) for i in range(b)])
        if diff or not np.array_equal(got.cpu().numpy(), want):
            raise RuntimeError(f"xor_sched differs on {label} B={b} L={l}: "
                               f"max |kernel - plain| = {diff}")
    log(f"K3 xor_sched vs plain and host oracle: {len(cases)} shapes over "
        f"{len({c[0] for c in cases})} digests byte-exact (ragged L, odd B, "
        f"misaligned base, a partial last block, two tiles included)")
    return err


def phase_mma_rate(dev: torch.device) -> dict:
    """The b1 and u8 mma.sync rates, MMAs a clock a SM."""
    from ceph_tpu_torch.tools import mma_rate
    rates = mma_rate.measure(dev)
    log("mma rates: " + "; ".join(
        f"{name} {r['mma_per_clock_per_sm']:.4f} a clock a SM ({r['mmas']} "
        f"MMAs in {r['ms']:.4f} ms at {r['sm_clock_mhz']:.0f} MHz)"
        for name, r in rates.items()))
    return {name: r["mma_per_clock_per_sm"] for name, r in rates.items()}


def reset_launches() -> None:
    """Set every kernel's launch count to 0 (K1-K3, K4, K5 and K6)."""
    from ceph_tpu_torch.crush import rule_lanes, vectorized
    from ceph_tpu_torch.ops import crc32c_batch, gf2kernels
    for counts in (gf2kernels.LAUNCHES, crc32c_batch.LAUNCHES,
                   vectorized.LAUNCHES, rule_lanes.LAUNCHES):
        for name in counts:
            counts[name] = 0


def launch_counts() -> dict:
    from ceph_tpu_torch.device import launch_counts as counts
    return counts()


def phase_k4_small(dev: torch.device) -> int:
    """K4 == plain == host numpy engine, bit for bit, on small seeded
    shapes: one row and many, ragged l, a misaligned base."""
    from ceph_tpu_torch.ops import crc32c_batch as crc

    cases = [(n, l, False) for l in (0, 1, 7, 8, 9, 127, 4096, 4099)
             for n in (1, 3000)]
    cases += [(64, 131072, False), (37, 4099, True), (3, 1001, True)]
    # the braid's edges: under one 512-byte round, l = 16 mod 512, a ragged
    # head on a misaligned base, spans of 8 rounds with masked ends
    cases += [(5, 300, False), (700, 512 * 5 + 16, False), (3, 2055, True),
              (4096, 16384 + 5, True)]
    rng = np.random.default_rng(SEED + 9)
    err = 0
    for n, l, misaligned in cases:
        host = rng.integers(0, 256, (n, l), dtype=np.uint8)
        if misaligned:
            buf = torch.empty(n * l + 1, dtype=torch.uint8, device=dev)
            x = buf[1:].view(n, l)
            x.copy_(torch.from_numpy(host))
        else:
            x = torch.from_numpy(host).to(dev)
        got = crc.crc32c_chunks(x)
        ref = crc.crc32c_chunks_plain(x)
        if n > 1 and l:   # the one-launch entry over the rows in two parts
            pair = torch.cat(crc.crc32c_chunks_pair(x[:n // 2], x[n // 2:]))
            if not torch.equal(pair, got):
                raise RuntimeError(f"crc32c_chunks_pair differs on N={n} l={l}")
        torch.cuda.synchronize()
        diff = int((got - ref).abs().max())
        err = max(err, diff)
        want = crc.crc32c_rows(host) if l else np.full(n, crc.SEED, np.uint32)
        if diff or not np.array_equal(crc.to_uint32(got), want):
            raise RuntimeError(f"crc32c_chunks differs on N={n} l={l}"
                               f"{' misaligned' if misaligned else ''}: max "
                               f"|kernel - plain| = {diff}")
    log(f"K4 crc32c_chunks vs plain and host engine: {len(cases)} shapes "
        f"bit-exact (l in 0..131072, N 1..4096, misaligned base included; "
        f"crc32c_chunks_pair == crc32c_chunks on every split)")
    return err


def phase_repair(dev: torch.device) -> dict:
    """The dense kernels past their old limits, byte-exact: PMSR k=7,m=6
    at full width through the dense route (K1 at k=42), one K1 launch at
    B > 65535 and one K2 launch at B/g > 65535."""
    from ceph_tpu_torch.ec import registry
    from ceph_tpu_torch.gf import gen_rs_matrix, gf_matmul
    from ceph_tpu_torch.ops import gf2kernels as gk

    b, l, profile = PMSR7
    codec = registry().factory("pmsr", dict(profile))
    k, m, n, a = codec.k, codec.m, codec.get_chunk_count(), codec.alpha
    if l % codec.get_alignment():
        raise RuntimeError(f"pmsr7/6 chunk {l} is not aligned to "
                           f"{codec.get_alignment()}")
    src, lost = codec.decode_plan(set(PMSR7_LOST),
                                  set(range(n)) - set(PMSR7_LOST))
    extra = codec.pack_decode_extra(src, lost)
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    data = torch.randint(0, 256, (b, k, l), dtype=torch.uint8, device=dev,
                         generator=gen)
    torch.cuda.synchronize()

    reset_launches()
    with xor_sched_env("0"):
        parity = codec.encode_batch(data)
        pos = {codec.chunk_index(i): data[:, i] for i in range(k)}
        pos.update({p: parity[:, r]
                    for r, p in enumerate(codec.coding_positions)})
        survivors = torch.stack([pos[p] for p in src], dim=1)
        recovered = codec.decode_batch(extra, survivors)
    torch.cuda.synchronize()
    launches = launch_counts()
    if parity.shape != (b, m, l) or recovered.shape != (b, len(lost), l):
        raise RuntimeError(f"pmsr7/6: bad shapes {parity.shape} "
                           f"{recovered.shape}")
    if not torch.equal(recovered, torch.stack([pos[p] for p in lost], 1)):
        raise RuntimeError("pmsr7/6: recovered chunks differ from the lost")
    for i in np.random.default_rng(SEED + 12).choice(b, 4, replace=False):
        sub = data[int(i)].cpu().numpy().reshape(k * a, l // a)
        want = gf_matmul(codec.parity_matrix, sub).reshape(m, l)
        if not np.array_equal(parity[int(i)].cpu().numpy(), want):
            raise RuntimeError(f"pmsr7/6: encode stripe {i} differs from host")
    want = len(gk.popc_stripes(b)) * (len(gk.popc_plan(m * a))
                                      + len(gk.popc_plan(len(lost) * a)))
    if launches["gf2_matmul_popc"] != want or launches["gf2_matmul_mma"] \
            or launches["xor_sched"]:
        raise RuntimeError(f"pmsr7/6 left K1's route ({want} launches): "
                           f"{launches}")
    with xor_sched_env("0"):
        enc_ms = time_ms(lambda: codec.encode_batch(data), iters=3)
        dec_ms = time_ms(lambda: codec.decode_batch(extra, survivors), iters=3)
    del data, parity, survivors, recovered, pos

    rs = gen_rs_matrix(11, 8)[8:]
    w_flat = torch.from_numpy(gk.bitmatrix_i8(rs)).to(dev)
    wide = {}
    for name, (bw, kw, lw, g) in (("gf2_matmul_popc", K1_WIDE + (1,)),
                                  ("gf2_matmul_mma", K2_WIDE)):
        x = torch.randint(0, 256, (bw, kw, lw), dtype=torch.uint8, device=dev,
                          generator=gen)
        reset_launches()
        if name == "gf2_matmul_popc":
            out = gk.gf2_matmul_popc(rs, x)
            plain = lambda t: gk.gf2_matmul_plain(w_flat, t)  # noqa: E731
        else:
            out = gk.gf2_matmul_mma(rs, x, g)
            w_group = torch.from_numpy(gk.w_gN_planemajor(rs, g)).to(dev)
            plain = lambda t: gk.gf2_matmul_grouped_plain(w_group, t, g)  # noqa: E731
        torch.cuda.synchronize()
        count = launch_counts()[name]
        _, diff = plain_in_slices(plain, x, out, slice_b=8192)
        pick = [0, 65535, 65536, bw - 1]
        for i, want in zip(pick, host_stripes(rs, x, pick)):
            if not np.array_equal(out[i].cpu().numpy(), want):
                raise RuntimeError(f"{name} at B={bw}: stripe {i} differs")
        want_count = len(gk.popc_stripes(bw)) if name == "gf2_matmul_popc" \
            else 1
        if diff or count != want_count:
            raise RuntimeError(f"{name} at B={bw}: max |kernel - plain| "
                               f"{diff}, {count} launches")
        wide[name] = {"shape": [bw, kw, lw], "g": g, "launches": count}
    log(f"repair: pmsr7/6 ({b}, {k}, {l}) -> flat ({b}, {k * a}, {l // a}) "
        f"dense: encode {enc_ms:.3f} ms, decode {list(src)} -> {list(lost)} "
        f"{dec_ms:.3f} ms, recovered == lost, 4 stripes == host, launches "
        f"{launches}; K1 at {list(K1_WIDE)} "
        f"({wide['gf2_matmul_popc']['launches']} launches, one per stripe "
        f"range) and K2 at {list(K2_WIDE[:3])} g={K2_WIDE[3]} (one launch): "
        f"== plain and host oracle (stripes 0, 65535, 65536, B-1)")
    return {"pmsr7_launches": launches, "pmsr7_ms": (enc_ms, dec_ms),
            "pmsr7_shapes": ((b, k * a, l // a, m * a),
                             (b, len(src) * a, l // a, len(lost) * a)),
            "wide": wide}


def phase_main_path(dev: torch.device) -> tuple[dict, dict]:
    from ceph_tpu_torch.ec import registry
    from ceph_tpu_torch.ops.gf2kernels import LAUNCHES

    b, k, m, l = MAIN
    codec = registry().factory("cuda", {"k": str(k), "m": str(m),
                                        "technique": "reed_sol_van"})
    isa = registry().factory("isa", {"k": str(k), "m": str(m),
                                     "technique": "reed_sol_van"})
    gen = torch.Generator(device=dev).manual_seed(SEED)
    data = torch.randint(0, 256, (b, k, l), dtype=torch.uint8, device=dev,
                         generator=gen)
    erasures = [1, 9]
    decode_index = codec.decode_entry(erasures)[1]
    obj = np.random.default_rng(SEED).integers(
        0, 256, 1 << 20, dtype=np.uint8).tobytes()
    torch.cuda.synchronize()

    for name in LAUNCHES:
        LAUNCHES[name] = 0
    parity = codec.encode_batch(data)
    full = torch.cat([data, parity], dim=1)
    survivors = full[:, decode_index].contiguous()
    lost = full[:, erasures].contiguous()
    del full
    recovered = codec.decode_batch(erasures, survivors)
    enc = codec.encode(set(range(k + m)), obj)
    dec = codec.decode(set(range(k + m)),
                       {i: enc[i] for i in range(k + m) if i not in erasures})
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)

    if parity.shape != (b, m, l) or recovered.shape != (b, 2, l):
        raise RuntimeError(f"bad shapes {parity.shape} {recovered.shape}")
    if not torch.equal(recovered, lost):
        raise RuntimeError("decode_batch: recovered chunks differ")
    pick = np.random.default_rng(SEED + 1).choice(b, 8, replace=False)
    for i, want in zip(pick, host_stripes(codec.encode_matrix[k:], data, pick)):
        if not np.array_equal(parity[int(i)].cpu().numpy(), want):
            raise RuntimeError(f"encode_batch: stripe {i} differs from host")
    enc_isa = isa.encode(set(range(k + m)), obj)
    for i in range(k + m):
        if not np.array_equal(enc[i], enc_isa[i]):
            raise RuntimeError(f"per-op encode: chunk {i} differs from isa")
    for e in erasures:
        if not np.array_equal(dec[e], enc_isa[e]):
            raise RuntimeError(f"per-op decode: chunk {e} differs from isa")
    for name in ("gf2_matmul_popc", "gf2_matmul_mma"):
        if launches[name] < 1:
            raise RuntimeError(f"{name} was not launched on the main path")
    if launches["xor_sched"]:
        raise RuntimeError("the RS main path left the dense kernels")

    enc_ms = time_ms(lambda: codec.encode_batch(data))
    dec_ms = time_ms(lambda: codec.decode_batch(erasures, survivors))
    avail = {i: enc[i] for i in range(k + m) if i not in erasures}
    op_enc_ms = host_ms(lambda: codec.encode(set(range(k + m)), obj))
    op_dec_ms = host_ms(lambda: codec.decode(set(range(k + m)), avail))
    log(f"main path rs8/3 ({b}, {k}, {l}): encode {b * k * l / GiB / enc_ms * 1e3:.2f} "
        f"GiB/s ({enc_ms:.3f} ms), decode[1,9] "
        f"{b * k * l / GiB / dec_ms * 1e3:.2f} GiB/s ({dec_ms:.3f} ms); "
        f"per-op 1 MiB encode {op_enc_ms:.3f} ms, decode {op_dec_ms:.3f} ms "
        f"(host clock); recovered == lost, 8 stripes == host, per-op 1 MiB "
        f"== isa; launches {launches}")
    return launches, {"data": data, "matrix": codec.encode_matrix[k:],
                      "decode_ms": dec_ms, "codec": codec}


def phase_cauchy(dev: torch.device) -> float:
    from ceph_tpu_torch.ec import registry

    b, k, m, l = CAUCHY
    codec = registry().factory("cuda", {"k": str(k), "m": str(m),
                                        "technique": "cauchy"})
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    data = torch.randint(0, 256, (b, k, l), dtype=torch.uint8, device=dev,
                         generator=gen)
    parity = codec.encode_batch(data)
    erasures = [2, 11]
    matrix, decode_index = codec.decode_entry(erasures)
    full = torch.cat([data, parity], dim=1)
    survivors = full[:, decode_index].contiguous()
    lost = full[:, erasures].contiguous()
    del full
    recovered = codec.decode_batch(erasures, survivors)
    torch.cuda.synchronize()
    if not torch.equal(recovered, lost):
        raise RuntimeError("cauchy decode_batch: recovered chunks differ")
    pick = np.random.default_rng(SEED + 3).choice(b, 4, replace=False)
    for i, want in zip(pick, host_stripes(codec.encode_matrix[k:], data, pick)):
        if not np.array_equal(parity[int(i)].cpu().numpy(), want):
            raise RuntimeError(f"cauchy encode_batch: stripe {i} differs")
    dec_ms = time_ms(lambda: codec.decode_batch(erasures, survivors))
    log(f"cauchy10/4 ({b}, {k}, {l}): decode[2,11] "
        f"{b * k * l / GiB / dec_ms * 1e3:.2f} GiB/s ({dec_ms:.3f} ms), "
        f"recovered == lost, 4 stripes == host")
    return dec_ms


def gibps(nbytes: int, ms: float) -> float:
    return nbytes / GiB / ms * 1e3


def phase_linear(dev: torch.device, plugin: str, spec: tuple, lost: tuple,
                 seed: int) -> dict:
    """A recovery code at full width through both engines: encode_batch and
    the decode_batch that decode_plan gives for ``lost``, once scheduled (K3)
    and once dense; launch counts over this drive alone."""
    from ceph_tpu_torch.ec import registry
    from ceph_tpu_torch.gf import gf_matmul
    from ceph_tpu_torch.ops import gf2kernels as gk
    from ceph_tpu_torch.ops import xor_schedule as xs

    b, l, profile = spec
    codec = registry().factory(plugin, dict(profile))
    k, m, n, a = codec.k, codec.m, codec.get_chunk_count(), codec.alpha
    src, lost = codec.decode_plan(set(lost), set(range(n)) - set(lost))
    extra = codec.pack_decode_extra(src, lost)
    gen = torch.Generator(device=dev).manual_seed(seed)
    data = torch.randint(0, 256, (b, k, l), dtype=torch.uint8, device=dev,
                         generator=gen)
    torch.cuda.synchronize()

    def by_position(parity):
        pos = {codec.chunk_index(i): data[:, i] for i in range(k)}
        pos.update({p: parity[:, r]
                    for r, p in enumerate(codec.coding_positions)})
        return pos

    for name in gk.LAUNCHES:
        gk.LAUNCHES[name] = 0
    with xor_sched_env("1"):
        parity = codec.encode_batch(data)
        pos = by_position(parity)
        survivors = torch.stack([pos[p] for p in src], dim=1)
        recovered = codec.decode_batch(extra, survivors)
    with xor_sched_env("0"):
        parity_dense = codec.encode_batch(data)
        recovered_dense = codec.decode_batch(extra, survivors)
    torch.cuda.synchronize()
    launches = dict(gk.LAUNCHES)

    tag = f"{plugin}{'/'.join(profile.values())}"
    if parity.shape != (b, m, l) or recovered.shape != (b, len(lost), l):
        raise RuntimeError(f"{tag}: bad shapes {parity.shape} "
                           f"{recovered.shape}")
    if not torch.equal(parity, parity_dense):
        raise RuntimeError(f"{tag}: scheduled and dense encode differ")
    if not torch.equal(recovered, recovered_dense):
        raise RuntimeError(f"{tag}: scheduled and dense decode differ")
    if not torch.equal(recovered, torch.stack([pos[p] for p in lost], 1)):
        raise RuntimeError(f"{tag}: recovered chunks differ from the lost")
    del parity_dense, recovered_dense
    pick = np.random.default_rng(seed + 1).choice(b, 8, replace=False)
    for i in pick:
        sub = data[int(i)].cpu().numpy().reshape(k * a, l // a)
        want = gf_matmul(codec.parity_matrix, sub).reshape(m, l)
        if not np.array_equal(parity[int(i)].cpu().numpy(), want):
            raise RuntimeError(f"{tag}: encode stripe {i} differs from host")
    sched = xs.schedule_for(gk.bitmatrix_i8(codec.parity_matrix))
    plain = xs.apply_bits_plain(sched, data[:4].reshape(4, k * a, l // a))
    if not torch.equal(plain.reshape(4, m, l), parity[:4]):
        raise RuntimeError(f"{tag}: K3 encode differs from its plain version")
    if launches["xor_sched"] < 2:
        raise RuntimeError(f"{tag}: xor_sched was not launched on the path")
    dense = launches["gf2_matmul_popc"] + launches["gf2_matmul_mma"]
    if dense < 2:
        raise RuntimeError(f"{tag}: the dense kernels were not launched")

    times = {}
    for engine in ("1", "0"):
        with xor_sched_env(engine):
            times[engine] = (
                time_ms(lambda: codec.encode_batch(data)),
                time_ms(lambda: codec.decode_batch(extra, survivors)))
    dense_name = "K2" if launches["gf2_matmul_mma"] else "K1"
    enc_bytes, dec_bytes = data.numel(), survivors.numel()
    log(f"{tag} ({b}, {k}, {l}), sub-lane {l // a}: encode K3 "
        f"{gibps(enc_bytes, times['1'][0]):.2f} GiB/s ({times['1'][0]:.3f} "
        f"ms) vs {dense_name} {gibps(enc_bytes, times['0'][0]):.2f} GiB/s "
        f"({times['0'][0]:.3f} ms); decode {list(src)} -> {list(lost)} "
        f"{tuple(survivors.shape)} K3 {gibps(dec_bytes, times['1'][1]):.2f} "
        f"GiB/s ({times['1'][1]:.3f} ms) vs {dense_name} "
        f"{gibps(dec_bytes, times['0'][1]):.2f} GiB/s ({times['0'][1]:.3f} "
        f"ms) [GiB/s of input read]; scheduled == dense, recovered == lost, "
        f"8 stripes == host, 4 stripes == plain; launches {launches}")
    dsched = xs.schedule_for(gk.bitmatrix_i8(codec.repair_matrix(src, lost)),
                             compile_missing=False)
    return {"launches": launches, "data": data, "sched": sched,
            "dsched": dsched, "matrix": codec.parity_matrix,
            "dense_name": dense_name, "dense_ms": times["0"],
            "sched_ms": times["1"],
            "shapes": ((b, k * a, l // a, m * a),
                       (b, len(src) * a, l // a, len(lost) * a))}


def phase_autotune() -> None:
    """The port's engine sweep on the card, written to a smoke table."""
    from ceph_tpu_torch.ops import _build
    from ceph_tpu_torch.tools import ec_autotune
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    table = _build.BUILD_DIR / "gf2_tuned.smoke.json"
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = ec_autotune.main(["--codes", "lrc,pmsr", "--batch",
                               str(SWEEP[0]), "--chunk", str(SWEEP[1]),
                               "--write", "--out", str(table)])
    if rc:
        raise RuntimeError(f"ec_autotune exited {rc}:\n{err.getvalue()}")
    report = json.loads(out.getvalue())
    rows = {"rs8/3_parity": report["xor_sched"]}
    rows.update({r["tag"]: r for r in report["xor_sched_codes"].values()})
    log(f"engine sweep (ec_autotune, batch {SWEEP[0]}, chunk {SWEEP[1]}): "
        + "; ".join(
        f"{tag} dense {r['dense_gibps']} vs scheduled {r['sched_gibps']} "
        f"GiB/s ({r['sched_terms']}/{r['naive_terms']} XORs) -> {r['engine']}"
        for tag, r in rows.items()) + f"; written to {table.name}")


def phase_k4_full(dev: torch.device, main: dict) -> dict:
    """K4 at full width: the chunk CRCs of the RS main path's data and
    parity rows (the fused encode's CRC work) against the host engine on
    sampled rows and against the plain version on every row; and
    ``crc32c_resident`` of a ragged buffer over 64 MiB against the host
    engine on the whole buffer."""
    from ceph_tpu_torch.ops import crc32c_batch as crc
    from ceph_tpu_torch.ops import gf2kernels as gk

    data = main["data"]
    b, k, l = data.shape
    parity = gk.gf_matmul_batch_device(main["matrix"], data)
    crc_d = crc.crc32c_device_chunks(data)
    crc_p = crc.crc32c_device_chunks(parity)
    crcs = torch.cat([crc_d, crc_p], dim=1)
    if not torch.equal(torch.cat(crc.crc32c_chunks_pair(data, parity), dim=1),
                       crcs):
        raise RuntimeError("crc32c_chunks_pair differs from crc32c_chunks at "
                           "full width")
    r = parity.shape[1]
    rng = np.random.default_rng(SEED + 14)
    pick = [(int(i), int(j)) for i, j in zip(rng.integers(0, b, 48),
                                              rng.integers(0, k + r, 48))]
    rows = np.stack([(data[i, j] if j < k else parity[i, j - k]).cpu().numpy()
                     for i, j in pick])
    got = crc.to_uint32(crcs)
    if not np.array_equal(np.array([got[i, j] for i, j in pick], np.uint32),
                          crc.crc32c_rows(rows)):
        raise RuntimeError("crc32c_chunks differs from the host engine at "
                           "full width")
    rows_d = torch.cat([data.reshape(-1, l), parity.reshape(-1, l)])
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    plain = crc.crc32c_chunks_plain(rows_d)
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    err = int((plain - torch.cat([crc_d.reshape(-1), crc_p.reshape(-1)]))
              .abs().max())
    del rows_d, plain
    if err:
        raise RuntimeError(f"crc32c_chunks differs from its plain version at "
                           f"full width: max {err}")

    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    buf = torch.randint(0, 256, (RESIDENT_BYTES,), dtype=torch.uint8,
                        device=dev, generator=gen)
    got_res = crc.crc32c_resident(buf)
    # K4 alone at the whole rows crc32c_resident cuts the buffer into
    chunk = max(64, crc._next_pow2(-(-RESIDENT_BYTES // 256)))
    res_rows = buf[:RESIDENT_BYTES // chunk * chunk].view(-1, chunk)
    resident_ms = time_ms(lambda: crc.crc32c_chunks(res_rows))
    want_res = int(crc.crc32c_rows(buf.cpu().numpy().reshape(1, -1))[0])
    if got_res != want_res:
        raise RuntimeError(f"crc32c_resident {got_res:#x} != host "
                           f"{want_res:#x} over {RESIDENT_BYTES} bytes")
    log(f"K4 full width: ({b}, {k}+{r}, {l}) chunk CRCs == host engine on 48 "
        f"sampled rows and == plain on all {b * (k + r)} rows (plain "
        f"{plain_ms:.1f} ms), == the one-launch pair; crc32c_resident over "
        f"{RESIDENT_BYTES} bytes "
        f"== host engine ({got_res:#010x})")
    return {"data": data, "parity": parity, "plain_ms": plain_ms, "err": err,
            "resident_ms": resident_ms, "resident_shape": list(res_rows.shape)}


def phase_osd(dev: torch.device) -> dict:
    """The OSD path at full width: CodecBatcher -> MeshCodec, one launch
    per coalesced batch, byte-exact against the codecs' own batch entry
    points and the host CRC engine."""
    import asyncio
    from ceph_tpu_torch.common.perf import PerfCounters
    from ceph_tpu_torch.ec import registry
    from ceph_tpu_torch.ops import crc32c_batch as crc
    from ceph_tpu_torch.ops.gf2kernels import gf_matmul_batch_device
    from ceph_tpu_torch.osd.codec_batcher import CodecBatcher
    from ceph_tpu_torch.parallel.mesh_codec import MeshCodec

    nsub, per, l = OSD
    total, k, m = nsub * per, 8, 3
    codec = registry().factory("cuda", {"k": "8", "m": "3",
                                        "technique": "reed_sol_van"})
    gen = torch.Generator(device=dev).manual_seed(SEED + 16)
    data_d = torch.randint(0, 256, (total, k, l), dtype=torch.uint8,
                           device=dev, generator=gen)
    data = data_d.cpu().numpy()
    parts = [slice(i * per, (i + 1) * per) for i in range(nsub)]
    perf = PerfCounters("ec_batch")
    batcher = CodecBatcher(max_batch=total, perf=perf, device=dev)
    loop = asyncio.new_event_loop()
    paths = {}

    def drive(tag, calls):
        """Submit concurrently; this path's launches, mesh launches and
        host seconds, from submission to the last result."""
        reset_launches()
        mesh0, fall0 = perf.get("mesh_launches"), perf.get("mesh_fallbacks")
        async def submit_all():
            return await asyncio.gather(*calls())
        t0 = time.perf_counter()
        out = loop.run_until_complete(submit_all())
        secs = time.perf_counter() - t0
        counts = {n: c for n, c in launch_counts().items() if c}
        mesh = perf.get("mesh_launches") - mesh0
        if mesh != 1 or perf.get("mesh_fallbacks") != fall0:
            raise RuntimeError(f"osd {tag}: {mesh} mesh launches, fallbacks "
                               f"{perf.get('mesh_fallbacks')}")
        paths[tag] = {"launches": counts, "mesh_launches": mesh,
                      "host_s": secs}
        return out

    def check(tag, got, want):
        if not np.array_equal(got, want):
            raise RuntimeError(f"osd {tag}: differs from the codec's own "
                               f"batch entry point")

    rng = np.random.default_rng(SEED + 17)

    def check_crcs(tag, kk, par, crcs):
        """64 sampled chunk CRCs == the host engine; K4 launched."""
        pick = [(int(i), int(j)) for i, j in zip(
            rng.integers(0, total, 64), rng.integers(0, crcs.shape[1], 64))]
        rows = np.stack([data[i, j] if j < kk else par[i, j - kk]
                         for i, j in pick])
        if crcs.dtype != np.uint32 or not np.array_equal(
                np.array([crcs[i, j] for i, j in pick], np.uint32),
                crc.crc32c_rows(rows)):
            raise RuntimeError(f"osd {tag}: chunk CRCs differ from the host "
                               f"engine")
        if paths[tag]["launches"].get("crc32c_chunks", 0) < 1:
            raise RuntimeError(f"osd {tag}: K4 was not launched")

    # RS encode with fused CRCs: 64 submissions -> one (1024, 8, L) launch
    def encodes():
        return [batcher.encode(codec, data[p], with_crc=True) for p in parts]
    res = drive("rs8/3 encode+crc", encodes)
    parity = np.concatenate([p for p, _ in res])
    crcs = np.concatenate([c for _, c in res])
    check("rs8/3 encode", parity, codec.encode_batch(data_d).cpu().numpy())
    check_crcs("rs8/3 encode+crc", k, parity, crcs)
    encode_s = []
    for _ in range(3):
        drive("rs8/3 encode+crc", encodes)
        encode_s.append(paths["rs8/3 encode+crc"]["host_s"])
    # the host-clock parts of that batch: the marshal's zeroed batch and
    # row copies, the batch to the card, the parity back
    t0 = time.perf_counter()
    staged = np.zeros_like(data)
    for p in parts:
        staged[p] = data[p]
    t1 = time.perf_counter()
    on_card = torch.from_numpy(staged).to(dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    parity_d = codec.encode_batch(on_card)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    parity_d.cpu().numpy()
    t4 = time.perf_counter()
    parts_ms = {"marshal": (t1 - t0) * 1e3, "to_card": (t2 - t1) * 1e3,
                "parity_back": (t4 - t3) * 1e3}
    del staged, on_card, parity_d

    # coalesced decode of [1, 9]
    erasures = [1, 9]
    full = np.concatenate([data, parity], axis=1)
    surv = np.ascontiguousarray(full[:, codec.decode_entry(erasures)[1]])
    res = drive("rs8/3 decode[1,9]", lambda: [
        batcher.decode(codec, erasures, surv[p]) for p in parts])
    rec = np.concatenate(res)
    check("rs8/3 decode", rec, codec.decode_batch(erasures, surv).cpu().numpy())
    if not np.array_equal(rec, full[:, erasures]):
        raise RuntimeError("osd rs8/3 decode: recovered chunks differ")
    del full, surv, rec

    # rmw: an overwrite of chunk 2's bytes l/32..l/16 (4 KiB) in every stripe
    delta = np.zeros_like(data)
    delta[:, 2, l // 32:l // 16] = rng.integers(0, 256, (total, l // 32),
                                                dtype=np.uint8)
    res = drive("rs8/3 rmw", lambda: [
        batcher.rmw(codec, parity[p], delta[p]) for p in parts])
    check("rs8/3 rmw", np.concatenate(res),
          codec.encode_batch(data ^ delta).cpu().numpy())
    del delta

    # LRC k=8,m=4,l=3 encode with fused CRCs and local repair of chunk 0,
    # flat dialect
    lrc = registry().factory("lrc", dict(LRC[2]))
    res = drive("lrc8/4/3 encode+crc", lambda: [
        batcher.encode(lrc, data[p], with_crc=True) for p in parts])
    lparity = np.concatenate([p for p, _ in res])
    check("lrc8/4/3 encode", lparity, lrc.encode_batch(data_d).cpu().numpy())
    check_crcs("lrc8/4/3 encode+crc", lrc.k, lparity,
               np.concatenate([c for _, c in res]))
    n = lrc.get_chunk_count()
    src, lost = lrc.decode_plan({0}, set(range(n)) - {0})
    extra = lrc.pack_decode_extra(src, lost)
    pos = {lrc.chunk_index(i): data[:, i] for i in range(lrc.k)}
    pos.update({p: lparity[:, r] for r, p in enumerate(lrc.coding_positions)})
    lsurv = np.ascontiguousarray(np.stack([pos[p] for p in src], 1))
    res = drive("lrc8/4/3 local repair", lambda: [
        batcher.decode(lrc, extra, lsurv[p]) for p in parts])
    rec = np.concatenate(res)
    check("lrc8/4/3 local repair", rec,
          lrc.decode_batch(extra, lsurv).cpu().numpy())
    if not np.array_equal(rec, np.stack([pos[p] for p in lost], 1)):
        raise RuntimeError("osd lrc local repair: recovered chunk differs")
    del lparity, lsurv, pos, rec

    # PMSR k=5,m=4 decode of chunks (1, 6), flat dialect
    pm = registry().factory("pmsr", dict(PMSR[2]))
    pdata = data_d[:, :pm.k].contiguous()
    pparity = pm.encode_batch(pdata).cpu().numpy()
    pdata = pdata.cpu().numpy()
    n = pm.get_chunk_count()
    src, lost = pm.decode_plan(set(PMSR_LOST), set(range(n)) - set(PMSR_LOST))
    extra = pm.pack_decode_extra(src, lost)
    pos = {pm.chunk_index(i): pdata[:, i] for i in range(pm.k)}
    pos.update({p: pparity[:, r] for r, p in enumerate(pm.coding_positions)})
    psurv = np.ascontiguousarray(np.stack([pos[p] for p in src], 1))
    res = drive(f"pmsr5/4 decode{list(PMSR_LOST)}", lambda: [
        batcher.decode(pm, extra, psurv[p]) for p in parts])
    rec = np.concatenate(res)
    check("pmsr5/4 decode", rec, pm.decode_batch(extra, psurv).cpu().numpy())
    if not np.array_equal(rec, np.stack([pos[p] for p in lost], 1)):
        raise RuntimeError("osd pmsr decode: recovered chunks differ")
    del pdata, pparity, psurv, pos, rec
    loop.close()

    # MeshCodec.encode(with_crc=True) on a device-resident batch, and its
    # two parts: the GF(2^8) launch and K4 over data + parity (one launch,
    # as the path runs it; beside it K4 as two launches)
    mesh = MeshCodec(device=dev)
    mat = codec.encode_matrix[k:]
    parity_d = gf_matmul_batch_device(mat, data_d)
    fused_ms = time_ms(lambda: mesh.encode(codec, data_d, with_crc=True,
                                           out_np=False), iters=5)
    gf_ms = time_ms(lambda: gf_matmul_batch_device(mat, data_d), iters=5)
    k4_ms = time_ms(lambda: crc.crc32c_chunks_pair(data_d, parity_d), iters=5)
    k4_two_ms = time_ms(lambda: (crc.crc32c_chunks(data_d),
                                 crc.crc32c_chunks(parity_d)), iters=5)
    del parity_d
    gib = data.nbytes / GiB
    batch_s = sum(encode_s) / len(encode_s)
    log(f"osd path rs8/3 ({total}, {k}, {l}) as {nsub} x {per} stripes: one "
        f"mesh launch per batch on every path, mesh_fallbacks "
        f"{perf.get('mesh_fallbacks')}; batcher encode+crc "
        f"{gib / batch_s:.2f} GiB/s ({batch_s * 1e3:.1f} ms per coalesced "
        f"batch, host clock: marshal, PCIe, launch and fan-out; of which "
        f"marshal {parts_ms['marshal']:.1f}, {gib:.2f} GiB to the card "
        f"{parts_ms['to_card']:.1f}, parity back {parts_ms['parity_back']:.1f} "
        f"ms); "
        f"MeshCodec.encode(with_crc) device-resident {fused_ms:.3f} ms "
        f"(CUDA events) = GF(2^8) {gf_ms:.3f} + K4 {k4_ms:.3f} (as two "
        f"launches {k4_two_ms:.3f}); all paths == "
        f"the codecs' own batch entry points, 64 CRC rows a path == host "
        f"engine; "
        + "; ".join(f"{tag}: {p['launches']}, {p['host_s'] * 1e3:.1f} ms"
                    for tag, p in paths.items()))
    return {"paths": paths, "batch_ms": batch_s * 1e3, "parts_ms": parts_ms,
            "batch_gibps": gib / batch_s, "fused_ms": fused_ms,
            "gf_ms": gf_ms, "k4_ms": k4_ms, "k4_two_ms": k4_two_ms,
            "k4_launches": paths["rs8/3 encode+crc"]["launches"][
                "crc32c_chunks"]}


def placement_maps() -> dict:
    """name -> (CrushMap, osd weights): the config-5 map; the same map
    degraded (2% of the OSDs at weight 0, 5% at 0x8000, one whole host
    out); a small map with a choose_args weight-set of 3 positions and
    hash-id overrides; the ``PLACEMENT_GLOBAL`` map, read from global
    memory."""
    from ceph_tpu_torch.crush.builder import build_hierarchy
    fanouts = list(PLACEMENT[2])
    n = int(np.prod(fanouts))
    cm = build_hierarchy(fanouts)
    rng = np.random.default_rng(SEED + 20)
    degraded = np.full(n, 0x10000, np.int64)
    pick = rng.permutation(n)
    degraded[pick[:n * 2 // 100]] = 0
    degraded[pick[n * 2 // 100:n * 7 // 100]] = 0x8000
    host = int(rng.integers(0, n // fanouts[-1]))
    degraded[host * fanouts[-1]:(host + 1) * fanouts[-1]] = 0
    ca = build_hierarchy([3, 4, 5])
    ca.create_choose_args(3)
    for arg in ca.choose_args.values():
        arg["weight_set"] = [[int(w * rng.uniform(0.3, 1.7)) for w in row]
                             for row in arg["weight_set"]]
    for bid in sorted(ca.choose_args)[:2]:
        ca.choose_args[bid]["ids"] = [i - 7919 if i < 0 else i + 5000
                                      for i in ca.buckets[bid].items]
    big = list(PLACEMENT_GLOBAL)
    return {"config5": (cm, [0x10000] * n),
            "config5 degraded": (cm, degraded.tolist()),
            "choose_args": (ca, [0x10000] * 60),
            "global": (build_hierarchy(big), [0x10000] * int(np.prod(big)))}


def scalar_mismatch(cm, rule: int, xs, rows: np.ndarray, numrep: int,
                    weights) -> str | None:
    """The first of ``rows`` (one a seed of ``xs``) that differs from the
    scalar ``crush_do_rule``, or None."""
    from ceph_tpu_torch.crush import CRUSH_ITEM_NONE, crush_do_rule
    for x, row in zip(xs, rows):
        want = crush_do_rule(cm, rule, int(x), numrep, weights)
        want += [CRUSH_ITEM_NONE] * (numrep - len(want))
        if list(row) != want:
            return f"x={int(x)}: {list(row)} vs {want}"
    return None


def phase_placement(dev: torch.device) -> dict:
    """Bulk placement (BASELINE.md config 5): K5 against its plain version
    on the card, exactly, on 65,536 seeds (values >= 2^31 included) and
    against the scalar engine on 128 of them, for both rules on the
    config-5, degraded, choose_args and global-memory maps; then the path
    at full width, its counts set to 0 just before: 10M seeds resident on
    the card, 5 launches of 2M lanes a rule (CUDA events), the first
    launch's rows held against the plain version (whose time at 2M lanes
    this is), and ``bulk_crush`` over all 10M from numpy to numpy (host
    clock), whose rows must equal the launches' and, on a sample, the
    scalar engine's."""
    from ceph_tpu_torch.crush import vectorized as vec
    from ceph_tpu_torch.mon.pg_mapping import bulk_crush
    from ceph_tpu_torch.ops import _build

    lanes, batch, fanouts = PLACEMENT
    maps = placement_maps()
    rng = np.random.default_rng(SEED + 21)
    sample = rng.integers(0, 2**32, PLACEMENT_SAMPLE, dtype=np.int64)
    sample_d = torch.from_numpy(sample.astype(np.uint32).view(np.int32)).to(dev)
    mappers, err, plain_ms, sample_ms = {}, 0, {}, {}
    for name, (cm, weights) in maps.items():
        for rule, numrep in PLACEMENT_RULES:
            key = (id(cm), rule)
            if key not in mappers:
                mappers[key] = vec.VectorCrush(cm, rule, device=dev)
            vc = mappers[key]
            w = vc.device_weights(weights)
            got = vc.map_device(sample_d, numrep, w)
            plain = vc.map_firstn if vc.firstn else vc.map_indep
            ref = plain(sample_d, numrep, w)
            diff = int((got.long() - ref.long()).abs().max())
            err = max(err, diff)
            if diff:
                raise RuntimeError(f"crush_map_rule differs from its plain "
                                   f"version on {name} rule {rule}: max {diff}")
            bad = scalar_mismatch(cm, rule, sample[:PLACEMENT_SCALAR],
                                  got[:PLACEMENT_SCALAR].cpu().numpy(),
                                  numrep, weights)
            if bad:
                raise RuntimeError(f"crush_map_rule differs from the scalar "
                                   f"engine on {name} rule {rule} at {bad}")
            if name in ("config5", "global"):
                sample_ms[name, rule] = time_ms(
                    lambda: vc.map_device(sample_d, numrep, w), iters=5)
    big = mappers[(id(maps["global"][0]), 0)]
    global_config = vec.kernel_config(big.map_words.shape[0], dev)
    rounds = placement_rounds(dev, sample, sample_d)
    err = max(err, rounds["err"])
    log(f"K5 crush_map_rule == plain on {PLACEMENT_SAMPLE} seeds (>= 2^31 "
        f"included) and == the scalar engine on {PLACEMENT_SCALAR}: "
        f"{', '.join(maps)} x rules {PLACEMENT_RULES} (rule, numrep); K5 on "
        f"the sample " + ", ".join(f"{n} rule {r} {v:.3f} ms"
                                   for (n, r), v in sample_ms.items())
        + f"; the global map "
        f"({int(np.prod(PLACEMENT_GLOBAL))} OSDs, {big.map_words.shape[0]} "
        f"words unstaged): {global_config}; rule 1 x{PLACEMENT_ROUNDS[1]} over "
        f"{PLACEMENT_ROUNDS[0][0]} hosts == plain on {PLACEMENT_ROUNDS[2]} "
        f"seeds and == the scalar engine on 64, {rounds['full']:.4f} of the "
        f"rows full (one round fills {rounds['one_round']:.4f})")

    cm, weights = maps["config5"]
    n_osds = len(weights)
    xs = np.random.default_rng(0).integers(0, 2**31 - 1, size=lanes,
                                           dtype=np.int64)
    seeds = torch.from_numpy(xs.astype(np.int32)).to(dev).view(-1, batch)
    pick = np.sort(rng.choice(lanes, PLACEMENT_BULK_SCALAR, replace=False))
    torch.cuda.synchronize()
    reset_launches()
    runs = {}
    for rule, numrep in PLACEMENT_RULES:
        vc = mappers[(id(cm), rule)]
        w = vc.device_weights(weights)
        plain = vc.map_firstn if vc.firstn else vc.map_indep
        held = {}

        def k5_batches():
            held["k5"] = [vc.map_device(b, numrep, w) for b in seeds]

        def plain_batch():
            held["plain"] = plain(seeds[0], numrep, w)

        ms = time_ms(k5_batches, iters=1)            # after a warm pass
        plain_ms[rule] = time_once_ms(plain_batch)
        diff = int((held["k5"][0].long() - held["plain"].long()).abs().max())
        err = max(err, diff)
        if diff:
            raise RuntimeError(f"crush_map_rule differs from its plain version "
                               f"at config 5 rule {rule}, {batch} lanes: max "
                               f"{diff}")
        t0 = time.perf_counter()
        rows, used = bulk_crush(cm, rule, xs, numrep, weights)
        host_s = time.perf_counter() - t0
        if not used:
            raise RuntimeError(f"bulk_crush took the scalar sweep at config 5 "
                               f"rule {rule}")
        if rows.shape != (lanes, numrep) or not np.array_equal(
                rows, torch.cat(held["k5"]).cpu().numpy()):
            raise RuntimeError(f"bulk_crush rows differ from K5's launches at "
                               f"config 5 rule {rule}")
        bad = scalar_mismatch(cm, rule, xs[pick], rows[pick], numrep, weights)
        if bad:
            raise RuntimeError(f"bulk_crush differs from the scalar engine at "
                               f"config 5 rule {rule} at {bad}")
        # every slot placed, on OSDs of the map, one per host
        head = rows[:200000]
        hosts = np.sort(head // fanouts[-1], axis=1)
        if not ((head >= 0) & (head < n_osds)).all() or \
                (np.diff(hosts, axis=1) == 0).any():
            raise RuntimeError(f"config 5 rule {rule}: a hole, an OSD off the "
                               f"map or two replicas on one host")
        runs[rule] = {"numrep": numrep, "ms": ms / seeds.shape[0],
                      "mappings_per_s": lanes / (ms / 1e3),
                      "bulk_host_s": host_s}
        del held, rows, head, hosts
    launches = launch_counts()["crush_map_rule"]
    if not launches:
        raise RuntimeError("crush_map_rule was not launched on the placement "
                           "path")
    config = vec.kernel_config(mappers[(id(cm), 0)].map_words.shape[0], dev)
    counts = _build.ptxas_counts(_build.report("crush"))
    ptxas = {f"ptxas_{key}": counts[key] if counts["kernels"] else None
             for key in ("registers", "spill_stores", "spill_loads")}
    log(f"placement config 5 ({n_osds} OSDs, fanouts {list(fanouts)}): "
        + "; ".join(f"rule {r} x{v['numrep']}: {lanes} mappings in "
                    f"{v['ms'] * seeds.shape[0]:.3f} ms ({seeds.shape[0]} "
                    f"launches of {batch}, {v['ms']:.3f} ms each, "
                    f"{v['mappings_per_s'] / 1e9:.4f}e9 mappings/s); first "
                    f"launch == plain ({plain_ms[r]:.1f} ms); bulk_crush "
                    f"numpy -> numpy {v['bulk_host_s']:.3f} s host clock, "
                    f"used_fused True, {PLACEMENT_BULK_SCALAR} rows == "
                    f"scalar engine"
                    for r, v in runs.items())
        + f"; K5 launches {launches}; {config}; {ptxas}")
    return {"err": err, "plain_ms": plain_ms, "sample_ms": sample_ms,
            "runs": runs, "launches": launches, "config": config,
            "ptxas": ptxas, "global_config": global_config}


def placement_rounds(dev: torch.device, sample: np.ndarray,
                     sample_d: torch.Tensor) -> dict:
    """K5 at rule 1 (chooseleaf indep) with more slots than a round fills:
    ``PLACEMENT_ROUNDS``' map, held against the plain version and, on 64
    seeds, the scalar engine.  Most lanes need several rounds, so the rows
    hold K5's per-lane order of (round, slot) steps against the reference's
    lockstep rounds."""
    from ceph_tpu_torch.crush import CRUSH_ITEM_NONE
    from ceph_tpu_torch.crush import vectorized as vec
    from ceph_tpu_torch.crush.builder import build_hierarchy
    fanouts, numrep, lanes = PLACEMENT_ROUNDS
    cm = build_hierarchy(list(fanouts))
    weights = [0x10000] * cm.max_devices
    vc = vec.VectorCrush(cm, 1, device=dev)
    w = vc.device_weights(weights)
    xs = sample_d[:lanes]
    got = vc.map_device(xs, numrep, w)
    diff = int((got.long() - vc.map_indep(xs, numrep, w).long()).abs().max())
    if diff:
        raise RuntimeError(f"crush_map_rule differs from its plain version at "
                           f"rule 1 x{numrep} over {fanouts[0]} hosts: max "
                           f"{diff}")
    bad = scalar_mismatch(cm, 1, sample[:64], got[:64].cpu().numpy(), numrep,
                          weights)
    if bad:
        raise RuntimeError(f"crush_map_rule differs from the scalar engine at "
                           f"rule 1 x{numrep} over {fanouts[0]} hosts at {bad}")
    full = float((got != CRUSH_ITEM_NONE).all(dim=1).float().mean())
    hosts = fanouts[0]
    one_round = float(np.prod([(hosts - k) / hosts for k in range(numrep)]))
    if full < 0.5:
        raise RuntimeError(f"rule 1 x{numrep} over {hosts} hosts: only "
                           f"{full:.4f} of the rows full")
    return {"err": diff, "full": full, "one_round": one_round}


def placement_bound(lanes: int, numrep: int, mhz: float,
                    fanouts: tuple = PLACEMENT[2]) -> dict:
    """The least time for one rule over ``lanes`` seeds on a map of
    ``fanouts``: the larger of its bytes (4 in and 4 * numrep out a lane)
    and its integer operations for the draws of a descent with no retry (a
    straw2 draw over every child at each level, the leaf's included; a
    floor, retries add draws).  The operations take the longer of
    ``ALU_OPS_PER_DRAW`` a draw on the ALU pipe and ``INT_OPS_PER_DRAW`` a
    draw through the issue slots.  ``int32_lanes_ms`` puts all of them on
    the ALU pipe, which is no floor: the FMA pipe runs IMADs beside it."""
    draws = lanes * numrep * sum(fanouts)
    clock = mhz * 1e6 / 1e3
    t_bytes = lanes * 4 * (1 + numrep) / HBM_BYTES_PER_S * 1e3
    t_alu = draws * ALU_OPS_PER_DRAW / (INT32_OPS_PER_CLOCK * clock)
    t_issue = draws * INT_OPS_PER_DRAW / (INT_ISSUE_PER_CLOCK * clock)
    t_ops = max(t_alu, t_issue)
    return {"bound_ms": round(max(t_bytes, t_ops), 4),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_ms": round(t_bytes, 4), "ops_ms": round(t_ops, 4),
            "ops_by": "ALU pipe" if t_alu >= t_issue else "issue",
            "int32_lanes_ms": round(
                draws * INT_OPS_PER_DRAW / (INT32_OPS_PER_CLOCK * clock), 4)}


def placement_row(placement: dict, mhz: float, table: dict) -> dict:
    """K5's row of the kernels line: its time a 2M-lane launch at rule 0,
    its bound, its plain version's time on the same launch's seeds, and its
    other paths: the sample and global-memory launches of phase 8d, and the
    epoch table's pools at the realistic cluster (phase 8e)."""
    batch = PLACEMENT[1]
    runs = placement["runs"]
    bounds = {r: placement_bound(batch, v["numrep"], mhz)
              for r, v in runs.items()}
    numreps = dict(PLACEMENT_RULES)
    sample_paths = {}           # path -> (K5's ms, bound) on the sample
    for (name, rule), ms in placement["sample_ms"].items():
        on, fan = "", PLACEMENT[2]
        if name == "global":
            fan = PLACEMENT_GLOBAL
            on = f", {int(np.prod(fan))}-OSD map in global memory"
        path = (f"rule {rule} {'firstn' if rule == 0 else 'indep'} "
                f"x{numreps[rule]}, {PLACEMENT_SAMPLE} lanes{on}")
        sample_paths[path] = (ms, placement_bound(PLACEMENT_SAMPLE,
                                                  numreps[rule], mhz, fan))
    for pool, ms in table["realistic"]["k5_ms"].values():
        path = (f"epoch table {pool.name}: rule {pool.crush_rule} "
                f"x{pool.size}, {pool.pg_num} lanes")
        sample_paths[path] = (ms, placement_bound(pool.pg_num, pool.size,
                                                  mhz))
    table_launches = sum(table["launches"].values())
    rule1 = f"rule 1 indep x11, {batch} lanes"
    return {
        "name": "crush_map_rule", "route": "cuda",
        "source": "ceph_tpu_torch/csrc/crush.cu",
        "replaces": "ceph_tpu/crush/vectorized.py:384, "
                    "ceph_tpu/crush/vectorized.py:449 (XLA programs, not "
                    "Pallas)",
        "launches": placement["launches"] + table_launches,
        "launches_by_path": {
            "bulk placement (phase 8d)": placement["launches"],
            **{f"epoch table {k} (phase 8e)": v
               for k, v in table["launches"].items()}},
        "max_abs_err": placement["err"],
        "ms": round(runs[0]["ms"], 4),
        "plain_ms": round(placement["plain_ms"][0], 4),
        "bound_ms": bounds[0]["bound_ms"], "bound_by": bounds[0]["bound_by"],
        "bound_int32_lanes_ms": bounds[0]["int32_lanes_ms"],
        "library_ms": None,
        "library_note": "no PyTorch call computes CRUSH",
        "shape": [batch, runs[0]["numrep"]], "sm_clock_mhz": mhz,
        "ms_by_path": {rule1: round(runs[1]["ms"], 4),
                       **{path: round(ms, 4)
                          for path, (ms, _) in sample_paths.items()}},
        "plain_ms_by_path": {rule1: round(placement["plain_ms"][1], 4)},
        "bound_by_path": {rule1: bounds[1],
                          **{path: bound
                             for path, (_, bound) in sample_paths.items()}},
        "mappings_per_s": {f"rule {r}": round(v["mappings_per_s"], 1)
                           for r, v in runs.items()},
        "bulk_crush_host_s": {f"rule {r}": round(v["bulk_host_s"], 4)
                              for r, v in runs.items()},
        **placement["config"],
        **placement["ptxas"],
        "global_map_config": placement["global_config"],
    }


def table_cluster(pg_nums: tuple, seed: int, temps: int | None = None,
                  upmaps: dict | None = None):
    """Config 5's 1000-OSD map as a cluster (``TABLE_POOLS`` at
    ``pg_nums``): 2% of the OSDs down but in, one host out, 5% reweighted to
    0x8000; pg_temp on ``temps`` PGs (0.5% if None), some longer than the
    pool's size, some with dead members, some all dead; ``upmaps`` and a
    few items whose target does not exist or is already in the row."""
    from ceph_tpu_torch.crush import crush_do_rule
    from ceph_tpu_torch.mon.osdmap import (
        POOL_TYPE_ERASURE, OSDMap, OsdInfo, PoolSpec)
    from ceph_tpu_torch.tools.crush_bench import config5_map
    rng = np.random.default_rng(seed)
    m = OSDMap()
    m.epoch = 1
    m.crush, n, fanouts = config5_map(1000)
    m.max_osd = n
    per_host = fanouts[-1]
    for o in range(n):
        m.osds[o] = OsdInfo(up=True, host=f"host{o // per_host}")
    pick = rng.permutation(n)
    down = pick[:int(n * TABLE_DOWN)]
    for o in down:
        # lint: disable=cross-daemon-state -- m: an OSDMap being built
        m.osds[int(o)].up = False
    for o in pick[int(n * TABLE_DOWN):int(n * (TABLE_DOWN + TABLE_REWEIGHTED))]:
        # lint: disable=cross-daemon-state -- m: an OSDMap being built
        m.osds[int(o)].weight = 0x8000
    out_host = int(rng.integers(0, n // per_host))
    for o in range(out_host * per_host, (out_host + 1) * per_host):
        # lint: disable=cross-daemon-state -- m: an OSDMap being built
        m.osds[o].in_cluster = False
    for (pid, name, erasure, size, rule), pg_num in zip(TABLE_POOLS, pg_nums):
        m.pools[pid] = PoolSpec(
            pool_id=pid, name=name, size=size, min_size=size - 1,
            pg_num=pg_num, pgp_num=pg_num, crush_rule=rule,
            type=POOL_TYPE_ERASURE if erasure else 1)
        m.pool_names[name] = pid
    total = sum(pg_nums)
    count = int(total * TABLE_TEMP) if temps is None else temps
    dead = [int(o) for o in down] + [n + 7]
    for i in range(count):
        pid = int(rng.choice(list(m.pools), p=np.asarray(pg_nums) / total))
        pool = m.pools[pid]
        pg = int(rng.integers(0, pool.pg_num))
        live = [int(o) for o in rng.choice(n, pool.size + 2, replace=False)]
        m.pg_temp[f"{pid}.{pg:x}"] = [
            live[:pool.size],                            # a backfill source
            live,                                        # longer than size
            live[:pool.size - 1] + dead[:2],             # dead members
            dead[:pool.size]][i % 4]                     # all dead
    m.pg_upmap_items = {k: v for k, v in (upmaps or {}).items()
                        if int(k.split(".", 1)[0]) in m.pools}
    weights = m.osd_weights()
    for pid, pool in m.pools.items():
        for i in range(4):
            pg = int(rng.integers(0, pool.pg_num))
            raw = crush_do_rule(m.crush, pool.crush_rule,
                                pool.raw_pg_to_pps(pg), pool.size, weights)
            m.pg_upmap_items[f"{pid}.{pg:x}"] = [
                (raw[0], n + 3 + i),                     # no such OSD
                (raw[0], raw[-1])]                       # already present
    m.invalidate_placement_cache()
    return m


def table_arrays_equal(ta: dict, tb: dict) -> str | None:
    """The first pool whose arrays differ between two tables' ``tables()``,
    or None."""
    if list(ta) != list(tb):
        return f"pools {list(ta)} vs {list(tb)}"
    for pid in ta:
        if not all(np.array_equal(x, y) for x, y in zip(ta[pid], tb[pid])):
            return f"pool {pid}"
    return None


def table_scalar_mismatch(m, pm, rng, sample: int) -> str | None:
    """Every PG that carries an upmap or a pg_temp, plus ``sample`` random
    raw ps a pool in [0, 2 pg_num): the table against the per-PG scalar
    pipeline (``OSDMap._pg_to_up_acting_scalar``).  The first mismatch, or
    None."""
    pgs = []
    for pgid in list(m.pg_upmap_items) + list(m.pg_temp):
        pid, pg = pgid.split(".", 1)
        pgs.append((int(pid), int(pg, 16)))
    for pid, pool in m.pools.items():
        pgs += [(pid, int(ps)) for ps in rng.integers(0, 2 * pool.pg_num,
                                                      sample)]
    for pid, ps in pgs:
        want = m._pg_to_up_acting_scalar(pid, ps)
        if pm.lookup(pid, ps) != want:
            return f"pool {pid} ps {ps}: {pm.lookup(pid, ps)} vs {want}"
    return None


def table_delta_brute(prev, cur) -> list:
    """A brute-force numpy diff of two tables of the same pools: every
    (pool, pg) whose up or acting row or length differs."""
    out = []
    for pid in sorted(cur.tables()):
        moved = None
        for a, b in ((0, 1), (2, 3)):
            x, y = prev.tables()[pid][a], cur.tables()[pid][a]
            width = max(x.shape[1], y.shape[1])
            x = np.pad(x, ((0, 0), (0, width - x.shape[1])), constant_values=-1)
            y = np.pad(y, ((0, 0), (0, width - y.shape[1])), constant_values=-1)
            diff = (x != y).any(axis=1) | (prev.tables()[pid][b]
                                           != cur.tables()[pid][b])
            moved = diff if moved is None else moved | diff
        out += [(pid, int(pg)) for pg in np.nonzero(moved)[0]]
    return out


def table_on_cpu(m, pps: dict, dev: torch.device):
    """The same table from the CUDA build's raw rows (K5 launched again on
    the same seeds and weights), ingested on the CPU."""
    from ceph_tpu_torch.crush.vectorized import seed_tensor
    from ceph_tpu_torch.mon.pg_mapping import (
        BuildInputs, PGMapping, bulk_crush_rows)
    cpu = PGMapping(m.epoch, "cpu")
    weights = m.osd_weights()
    inputs = BuildInputs(m, len(weights) + 1, torch.device("cpu"))
    for pid, pool in m.pools.items():
        rows, used = bulk_crush_rows(m.crush, pool.crush_rule,
                                     seed_tensor(pps[pid], dev), pool.size,
                                     weights)
        if not used:
            raise RuntimeError(f"pool {pid} took the scalar sweep")
        cpu._ingest_pool(pid, pool, rows.cpu(), inputs)
    cpu._copy_back()
    return cpu


def table_seeds(m, dev: torch.device, reps: int) -> tuple[dict, float, float]:
    """Each pool's seeds two ways, the fastest of ``reps`` each (host clock,
    the card synchronized): the numpy hash (``pool_pps``) and its copy up,
    and the hash as torch ops on the card (``pool_seeds``, what the build
    runs), held equal.  The build's seed cache is emptied after, so the next
    build makes its seeds anew."""
    from ceph_tpu_torch.crush.vectorized import seed_tensor
    from ceph_tpu_torch.mon import pg_mapping as pmod

    def best(fn):
        secs = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        return out, min(secs)
    def by_numpy():
        pps = {pid: pmod.pool_pps(pool) for pid, pool in m.pools.items()}
        for x in pps.values():
            seed_tensor(x, dev)
        return pps
    pps, numpy_s = best(by_numpy)
    seeds, card_s = best(lambda: {pid: pmod.pool_seeds(pool, dev)
                                  for pid, pool in m.pools.items()})
    for pid in m.pools:
        if not torch.equal(seeds[pid].cpu(), seed_tensor(pps[pid], "cpu")):
            raise RuntimeError(f"pool_seeds differs from pool_pps on pool "
                               f"{pid}")
    pmod._SEEDS.clear()
    return pps, numpy_s, card_s


def timed(fn):
    """(fn(), its host seconds)."""
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def staged_build(m, dev: torch.device) -> dict:
    """``PGMapping.build``'s stages driven one by one, the card synchronized
    at each stage's ends: each stage's host seconds (K5's device time by
    CUDA events beside crush), and the total.  Seeds come from the build's
    cache, so a rebuild of a known pool spec finds them there."""
    from ceph_tpu_torch.mon import pg_mapping as pmod
    split = {}

    def stage(name, fn, kernel=False):
        torch.cuda.synchronize()
        if kernel:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        out = fn()
        if kernel:
            end.record()
        torch.cuda.synchronize()
        split[name] = split.get(name, 0.0) + time.perf_counter() - t0
        if kernel:
            split["K5"] = split.get("K5", 0.0) + start.elapsed_time(end) / 1e3
        return out
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pm = pmod.PGMapping(m.epoch, dev)
    weights = m.osd_weights()
    inputs = stage("inputs", lambda: pmod.BuildInputs(
        m, len(weights) + 1, dev))
    for pid, pool in m.pools.items():
        seeds = stage("seeds", lambda: pmod.cached_pool_seeds(pool, dev))
        rows, used = stage("crush", lambda: pmod.bulk_crush_rows(
            m.crush, pool.crush_rule, seeds, pool.size, weights), kernel=True)
        if not used:
            raise RuntimeError(f"pool {pid} was not mapped by K5")
        stage("filter", lambda: pm._ingest_pool(pid, pool, rows, inputs))
    stage("copy back", pm._copy_back)
    split["total"] = time.perf_counter() - t0
    return split


def split_line(split: dict) -> str:
    """A staged build's host clock by stage, and the Python left over."""
    stages = ("inputs", "seeds", "crush", "filter", "copy back")
    left = split["total"] - sum(split[k] for k in stages)
    return (f"{split['total']:.4f} s = inputs (one copy up) "
            f"{split['inputs']:.4f}, seeds (pool_seeds on the card, or "
            f"the cache) {split['seeds']:.4f}, crush {split['crush']:.4f} "
            f"(K5 {split['K5']:.4f} by CUDA events), filter "
            f"{split['filter']:.4f}, copy back {split['copy back']:.4f}, "
            f"Python left over {left:.4f}")


def phase_table(dev: torch.device) -> dict:
    """The epoch placement table on the card (``OSDMap`` -> ``PGMapping``
    over K5) on config 5's map at two sizes.  The realistic cluster: the
    balancer's ``compute_upmaps`` reads the table, its plans go into the
    map, the table is built, then three incrementals (one host down, a
    reweight of 20 OSDs, a placement-neutral up_thru) each rebuild it (the
    last must not) and take its ``delta``.  Then 10,485,760 PGs: one build
    and one host-down epoch.  Each build is held against the scalar
    pipeline on its overridden PGs and a random sample, and against the same
    table on the CPU (a full CPU build from ``to_dict()`` for the realistic
    cluster's first; else an ingest of K5's raw rows on the CPU); each
    delta against a brute-force diff.  The counts are set to 0 before each
    driven step and read after it; checks launch outside them."""
    from ceph_tpu_torch.crush.vectorized import seed_tensor
    from ceph_tpu_torch.mgr.balancer import compute_upmaps
    from ceph_tpu_torch.mon import pg_mapping as pmod
    from ceph_tpu_torch.mon.osdmap import Incremental, OSDMap

    rng = np.random.default_rng(SEED + 30)
    launches = {}

    def driven(label, fn):
        torch.cuda.synchronize()
        reset_launches()
        out = fn()
        torch.cuda.synchronize()
        launches[label] = launch_counts()["crush_map_rule"]
        if not launches[label]:
            raise RuntimeError(f"crush_map_rule was not launched on the "
                               f"epoch table's {label}")
        return out

    def check(m, pm, label, full_cpu: bool, pps: dict):
        if pm.fused_pools != len(m.pools):
            raise RuntimeError(f"epoch table {label}: {pm.scalar_pools} "
                               f"pools took the scalar sweep")
        bad = table_scalar_mismatch(m, pm, rng, TABLE_SAMPLE)
        if bad:
            raise RuntimeError(f"epoch table {label} differs from the scalar "
                               f"pipeline at {bad}")
        if full_cpu:
            cpu = pmod.PGMapping.build(OSDMap.from_dict(m.to_dict(),
                                                        device="cpu"))
        else:
            cpu = table_on_cpu(m, pps, dev)
        bad = table_arrays_equal(pm.tables(), cpu.tables())
        if bad:
            raise RuntimeError(f"epoch table {label}: the card's table and "
                               f"the CPU's differ at {bad}")

    def epoch(m, label, inc, pps, full_cpu=False):
        prev = m.peek_placement_cache()
        recomputes = m.placement_perf.get("bulk_recomputes")
        split = {}

        def step():
            t0 = time.perf_counter()
            m.apply_incremental(inc)
            cur = m.placement_cache()
            d = cur.delta(prev, perf=m.placement_perf)
            return cur, d, time.perf_counter() - t0
        if inc.placement_neutral():
            reset_launches()
            cur, d, secs = step()
            if launch_counts()["crush_map_rule"]:
                raise RuntimeError(f"epoch table {label}: K5 launched on a "
                                   f"placement-neutral epoch")
            if cur is not prev or d or \
                    m.placement_perf.get("bulk_recomputes") != recomputes:
                raise RuntimeError(f"epoch table {label}: a placement-neutral "
                                   f"incremental rebuilt or moved the table")
        else:
            cur, d, secs = driven(label, step)
            if d != table_delta_brute(prev, cur):
                raise RuntimeError(f"epoch table {label}: delta differs from "
                                   f"the brute-force diff")
            check(m, cur, label, full_cpu, pps)
            split = staged_build(m, dev)
        log(f"epoch table {label}: rebuild + delta {secs:.4f} s, delta_pgs "
            f"{len(d)}" + (f"; the rebuild staged {split_line(split)}"
                           if split else "; no rebuild"))
        return {"s": secs, "delta_pgs": len(d), "split": split}

    def host_down(m, skip: int):
        per_host = 10
        hosts = [h for h in range(len(m.osds) // per_host) if h != skip and
                 all(m.osds[o].in_cluster for o in range(h * per_host,
                                                         (h + 1) * per_host))]
        h = int(rng.choice(hosts))
        return Incremental(epoch=m.epoch + 1, new_down=list(range(
            h * per_host, (h + 1) * per_host)))

    out = {}
    # the realistic cluster
    m = table_cluster(TABLE_PG_NUMS["realistic"], SEED + 31)
    m.device = dev
    pps, pps_s, seeds_s = table_seeds(m, dev, reps=5)
    t0 = time.perf_counter()
    plans = driven("balancer", lambda: compute_upmaps(
        m, max_moves=TABLE_UPMAP_MOVES))
    balancer_s = time.perf_counter() - t0
    m.pg_upmap_items.update({k: [tuple(i) for i in v]
                             for k, v in plans.items()})
    m.invalidate_placement_cache()
    pm, build_s = driven("build", lambda: timed(m.placement_cache))
    check(m, pm, "build", True, pps)
    pmod._SEEDS.clear()
    split = staged_build(m, dev)
    log(f"epoch table, realistic cluster ({len(m.osds)} OSDs, pools "
        + ", ".join(f"{p.name} x{p.size} pg_num {p.pg_num}"
                    for p in m.pools.values())
        + f"; {len(m.pg_upmap_items)} upmap items of which {len(plans)} from "
        f"compute_upmaps(max_moves={TABLE_UPMAP_MOVES}) in {balancer_s:.3f} "
        f"s, {len(m.pg_temp)} pg_temps): build {build_s:.4f} s, staged "
        f"{split_line(split)}; recompute_pgs_per_s "
        f"{m.placement_perf.dump()['recompute_pgs_per_s']}; == the scalar "
        f"pipeline on the overridden PGs + {TABLE_SAMPLE} a pool, == the CPU "
        f"build; the seeds by the numpy hash (pool_pps) and copied up "
        f"{pps_s:.6f} s, on the card (pool_seeds) {seeds_s:.6f} s, equal "
        f"(fastest of 5)")
    epochs = {"build": {"s": build_s, "split": split, "delta_pgs": None,
                        "seeds_numpy_s": pps_s, "seeds_card_s": seeds_s}}
    down_host = [h for h in range(100)
                 if not m.osds[h * 10].in_cluster][0]
    epochs["host down"] = epoch(m, "host down", host_down(m, down_host), pps)
    reweight = [int(o) for o in rng.choice(len(m.osds), 20, replace=False)]
    epochs["reweight 20"] = epoch(m, "reweight 20", Incremental(
        epoch=m.epoch + 1, new_weights={o: 0xC000 for o in reweight}), pps)
    epochs["up_thru"] = epoch(m, "up_thru", Incremental(
        epoch=m.epoch + 1, new_up_thru={o: m.epoch for o in range(50)}), pps)
    pids = rng.choice(list(m.pools), TABLE_LOOKUPS)
    span = np.array([2 * m.pools[int(p)].pg_num for p in pids])
    keys = list(zip(pids.tolist(), (rng.random(TABLE_LOOKUPS) * span)
                    .astype(np.int64).tolist()))
    t0 = time.perf_counter()
    for pid, ps in keys:
        m.pg_to_up_acting(pid, ps)
    lookups_per_s = TABLE_LOOKUPS / (time.perf_counter() - t0)
    log(f"epoch table lookups: {lookups_per_s:.0f} a second over "
        f"{TABLE_LOOKUPS} random (pool, ps) through OSDMap.pg_to_up_acting")
    # K5 a launch at the realistic cluster's pools (outside the counts)
    k5_ms = {}
    weights = m.osd_weights()
    for pid, pool in m.pools.items():
        vc = pmod._vector_crush_for(m.crush, pool.crush_rule, dev)
        seeds = seed_tensor(pps[pid], dev)
        w = vc.device_weights(weights)
        k5_ms[pid] = (pool, time_ms(lambda: vc.map_device(seeds, pool.size,
                                                          w)))
    out["realistic"] = {"epochs": epochs, "lookups_per_s": lookups_per_s,
                        "recompute_pgs_per_s": m.placement_perf.dump()[
                            "recompute_pgs_per_s"],
                        "k5_ms": k5_ms}
    del m, pm

    # BASELINE.md config 5's scale, arrays only
    m = table_cluster(TABLE_PG_NUMS["10M"], SEED + 32, temps=TABLE_TEMP_10M,
                      upmaps=plans)
    m.device = dev
    pps, pps_s, seeds_s = table_seeds(m, dev, reps=1)
    pm, build_s = driven("10M build", lambda: timed(m.placement_cache))
    check(m, pm, "10M build", False, pps)
    pmod._SEEDS.clear()
    split = staged_build(m, dev)
    log(f"epoch table at {pm.pg_count()} PGs ({len(m.pg_upmap_items)} upmap "
        f"items, {len(m.pg_temp)} pg_temps): build {build_s:.4f} s, staged "
        f"{split_line(split)}; "
        f"recompute_pgs_per_s "
        f"{m.placement_perf.dump()['recompute_pgs_per_s']}; == the scalar "
        f"pipeline on the overridden PGs + {TABLE_SAMPLE} a pool, == the "
        f"CPU ingest of K5's rows; the seeds by the numpy hash (pool_pps) "
        f"and copied up {pps_s:.4f} s, on the card (pool_seeds) "
        f"{seeds_s:.4f} s, equal")
    epochs = {"build": {"s": build_s, "split": split, "delta_pgs": None,
                        "seeds_numpy_s": pps_s, "seeds_card_s": seeds_s}}
    down_host = [h for h in range(100)
                 if not m.osds[h * 10].in_cluster][0]
    epochs["host down"] = epoch(m, "10M host down", host_down(m, down_host),
                                pps)
    out["10M"] = {"epochs": epochs, "pgs": pm.pg_count(),
                  "recompute_pgs_per_s": m.placement_perf.dump()[
                      "recompute_pgs_per_s"]}
    out["expressed"] = table_straw_vary_r(dev, launches)
    out["launches"] = launches
    return out


def table_straw_vary_r(dev: torch.device, launches: dict) -> dict:
    """Map shapes the reference's bulk mapper refuses, built on the card:
    config 5's OSDs in straw (not straw2) buckets, and config 5's map with
    jewel's chooseleaf_vary_r set to 0, which K5 expresses.  Each build is
    driven with the counts set to 0 and must launch K5 once a pool, every
    pool fused; its table must equal the scalar pipeline on every PG and
    the CPU's build entry for entry, and K5's rows its plain version's on
    every pool's seeds.  Then the shapes K5 does not express, which K6 maps
    (``table_k6_shapes``).  ``launches`` gains each build's K5 count."""
    from ceph_tpu_torch.crush.builder import build_hierarchy
    from ceph_tpu_torch.crush.types import CRUSH_BUCKET_STRAW
    from ceph_tpu_torch.mon import pg_mapping as pmod
    from ceph_tpu_torch.mon.osdmap import OSDMap
    from ceph_tpu_torch.tools.crush_bench import config5_map

    out = {}
    for kind in ("straw buckets", "chooseleaf_vary_r 0"):
        m = table_cluster(TABLE_EXPRESSED_PG_NUMS, SEED + 33)
        if kind == "straw buckets":
            m.crush = build_hierarchy(config5_map(1000)[2],
                                      alg=CRUSH_BUCKET_STRAW)
        else:
            m.crush.tunables.chooseleaf_vary_r = 0
        m.invalidate_placement_cache()
        m.device = dev
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        pm = m.placement_cache()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        k5 = launches[f"{kind} build"] = launch_counts()["crush_map_rule"]
        if k5 != len(m.pools) or pm.fused_pools != len(m.pools) \
                or pm.scalar_pools or pm.device.type != "cuda":
            raise RuntimeError(f"epoch table, {kind}: {k5} K5 launches, "
                               f"{pm.fused_pools} fused and {pm.scalar_pools} "
                               f"scalar pools on {pm.device}")
        weights = m.osd_weights()
        for pool in m.pools.values():
            vc = pmod._vector_crush_for(m.crush, pool.crush_rule, dev)
            seeds = pmod.pool_seeds(pool, dev)
            w = vc.device_weights(weights)
            plain = vc.map_firstn if vc.firstn else vc.map_indep
            if not torch.equal(vc.map_device(seeds, pool.size, w),
                               plain(seeds, pool.size, w)):
                raise RuntimeError(f"epoch table, {kind}: K5 differs from "
                                   f"its plain version on pool {pool.name}")
        for pid, pool in m.pools.items():
            for ps in range(pool.pg_num):
                want = m._pg_to_up_acting_scalar(pid, ps)
                if pm.lookup(pid, ps) != want:
                    raise RuntimeError(
                        f"epoch table, {kind}: pool {pid} ps {ps} "
                        f"{pm.lookup(pid, ps)} vs the scalar pipeline {want}")
        cpu = pmod.PGMapping.build(OSDMap.from_dict(m.to_dict(),
                                                    device="cpu"))
        bad = table_arrays_equal(pm.tables(), cpu.tables())
        if bad:
            raise RuntimeError(f"epoch table, {kind}: the card's table and "
                               f"the CPU's differ at {bad}")
        log(f"epoch table, {kind} ({pm.pg_count()} PGs): {k5} K5 launches, "
            f"every pool fused, the build on the card in {secs:.4f} s; K5 == "
            f"its plain version on every pool, the table == the scalar "
            f"pipeline on every PG, == the CPU build")
        out[kind] = {"s": secs, "pgs": pm.pg_count(), "launches": k5}
    out["k6"] = table_k6_shapes(dev)
    return out


def k6_shape(m, kind: str, rng) -> None:
    """Give the cluster ``m`` (config 5's map) the K6 shape ``kind``; the
    type ids are ``build_hierarchy``'s for depth 4: host 1, rack 2."""
    from ceph_tpu_torch.crush.builder import build_hierarchy
    from ceph_tpu_torch.crush.types import (
        CRUSH_BUCKET_LIST, CRUSH_BUCKET_STRAW, CRUSH_BUCKET_TREE,
        CRUSH_BUCKET_UNIFORM, CRUSH_RULE_CHOOSE_FIRSTN,
        CRUSH_RULE_CHOOSE_INDEP, CRUSH_RULE_CHOOSELEAF_FIRSTN,
        CRUSH_RULE_CHOOSELEAF_INDEP, CRUSH_RULE_EMIT, CRUSH_RULE_TAKE,
        RuleStep)
    from ceph_tpu_torch.tools.crush_bench import config5_map
    fanouts = config5_map(1000)[2]
    host, rack = 1, 2
    algs = {"uniform buckets": CRUSH_BUCKET_UNIFORM,
            "list buckets": CRUSH_BUCKET_LIST,
            "tree buckets": CRUSH_BUCKET_TREE}
    choose = [r.steps[-2] for r in (m.crush.rules[0], m.crush.rules[1])]
    if kind == "a host holding an osd and a bucket":
        crush = m.crush
        b = crush.buckets[crush.buckets[-1].items[0]]
        while b.items[0] < 0:
            b = crush.buckets[b.items[0]]
        b.items.append(crush.buckets[-1].items[1])
        b.item_weights.append(0x10000)
    elif kind in algs:
        m.crush = build_hierarchy(fanouts, alg=algs[kind])
    elif kind == "straw with legacy straw values":
        m.crush = build_hierarchy(fanouts, alg=CRUSH_BUCKET_STRAW)
        for b in m.crush.buckets.values():
            b.straws = [int(v) for v in rng.integers(0x8000, 0x30000,
                                                     b.size)]
    elif kind == "argonaut tunables":
        t = m.crush.tunables
        t.choose_local_tries, t.choose_local_fallback_tries = 2, 5
        t.choose_total_tries, t.chooseleaf_descend_once = 19, 0
        t.chooseleaf_vary_r, t.chooseleaf_stable = 0, 0
    elif kind == "chooseleaf of racks":
        for step in choose:
            step.arg2 = rack
    elif kind == "plain choose of hosts":
        choose[0].op, choose[1].op = (CRUSH_RULE_CHOOSE_FIRSTN,
                                      CRUSH_RULE_CHOOSE_INDEP)
    elif kind == "choose 2 racks, chooseleaf 2 hosts":
        for rule, (first, leaf, n_racks, n_hosts) in zip(
                (m.crush.rules[0], m.crush.rules[1]),
                ((CRUSH_RULE_CHOOSE_FIRSTN, CRUSH_RULE_CHOOSELEAF_FIRSTN,
                  2, 2),
                 (CRUSH_RULE_CHOOSE_INDEP, CRUSH_RULE_CHOOSELEAF_INDEP,
                  4, 3))):
            rule.steps[-3:] = [RuleStep(CRUSH_RULE_TAKE, -1),
                               RuleStep(first, n_racks, rack),
                               RuleStep(leaf, n_hosts, host),
                               RuleStep(CRUSH_RULE_EMIT)]
    else:
        raise ValueError(kind)
    m.invalidate_placement_cache()


def k6_host_tables(state: tuple) -> tuple[dict, dict]:
    """The host's answers for a cluster (its ``to_dict()`` and legacy straw
    values): the scalar pipeline on every PG, and the CPU build's arrays.
    Run in a worker process, one a shape, while the card builds."""
    from ceph_tpu_torch.mon.osdmap import OSDMap
    from ceph_tpu_torch.mon.pg_mapping import PGMapping
    d, straws = state
    m = OSDMap.from_dict(d, device="cpu")
    for bid, values in straws.items():
        m.crush.buckets[bid].straws = values
    scalar = {pid: [m._pg_to_up_acting_scalar(pid, ps)
                    for ps in range(pool.pg_num)]
              for pid, pool in m.pools.items()}
    return scalar, PGMapping.build(m).tables()


def table_k6_shapes(dev: torch.device) -> dict:
    """Each shape of ``K6_SHAPES`` (ROADMAP queue 3's list) on config 5's
    OSDs at ``TABLE_EXPRESSED_PG_NUMS``, built on the card with the counts
    set to 0 and the host sweep replaced by one that fails: K5 must refuse
    both rules, the build must launch K6 once a pool and K5 never, every
    pool mapped by a kernel; the table must equal the scalar pipeline on
    every PG and the CPU's build (the scalar sweep) entry for entry, both
    computed by worker processes while the card builds."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    from ceph_tpu_torch.crush import rule_lanes
    from ceph_tpu_torch.crush.vectorized import Unexpressed, VectorCrush
    from ceph_tpu_torch.mon import pg_mapping as pmod

    def no_sweep(*args, **kwargs):
        raise RuntimeError("a card's seeds were mapped on the host")
    rng = np.random.default_rng(SEED + 35)
    maps = {}
    for kind in K6_SHAPES:
        m = table_cluster(TABLE_EXPRESSED_PG_NUMS, SEED + 34)
        k6_shape(m, kind, rng)
        for rule in (0, 1):
            try:
                VectorCrush(m.crush, rule, device="cpu")
            except Unexpressed:
                continue
            raise RuntimeError(f"epoch table, {kind}: K5 expresses rule "
                               f"{rule}")
        maps[kind] = m
    t_host = time.perf_counter()
    workers = min(len(maps), os.cpu_count() or 1)
    with ProcessPoolExecutor(workers, multiprocessing.get_context(
            "spawn")) as pool:
        host = {kind: pool.submit(k6_host_tables, (m.to_dict(), {
            bid: list(b.straws) for bid, b in m.crush.buckets.items()
            if getattr(b, "straws", None) is not None}))
            for kind, m in maps.items()}
        out = {}
        for kind, m in maps.items():
            m.device = dev
            torch.cuda.synchronize()
            reset_launches()
            sweep, pmod._sweep = pmod._sweep, no_sweep
            try:
                t0 = time.perf_counter()
                pm = m.placement_cache()
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
            finally:
                pmod._sweep = sweep
            counts = launch_counts()
            k6, k5 = counts["crush_rule_lanes"], counts["crush_map_rule"]
            if k6 != len(m.pools) or k5 or pm.fused_pools != len(m.pools) \
                    or pm.scalar_pools or pm.device.type != "cuda":
                raise RuntimeError(f"epoch table, {kind}: {k6} K6 and {k5} "
                                   f"K5 launches, {pm.fused_pools} pools "
                                   f"mapped by a kernel, {pm.scalar_pools} "
                                   f"scalar, on {pm.device}")
            # bulk_crush numpy to numpy on the card takes the same route
            pool = m.pools[1]
            xs = pmod.pool_pps(pool)
            reset_launches()
            rows, used = pmod.bulk_crush(m.crush, pool.crush_rule, xs,
                                         pool.size, m.osd_weights(),
                                         min_lanes=1, device=dev)
            bulk = launch_counts()
            want = rule_lanes.plain_rows(m.crush, pool.crush_rule,
                                         xs[:K6_BULK_SCALAR], pool.size,
                                         m.osd_weights())
            if not used or bulk["crush_rule_lanes"] != 1 \
                    or bulk["crush_map_rule"] \
                    or not np.array_equal(rows[:K6_BULK_SCALAR], want):
                same = np.array_equal(rows[:K6_BULK_SCALAR], want)
                raise RuntimeError(f"bulk_crush, {kind}: launches {bulk}, "
                                   f"rows == the scalar engine: {same}")
            out[kind] = {"s": secs, "pgs": pm.pg_count(), "launches": k6,
                         "bulk_launches": 1, "table": pm}
        for kind, m in maps.items():
            scalar, cpu = host[kind].result()
            pm = out[kind].pop("table")
            for pid, rows in scalar.items():
                for ps, want in enumerate(rows):
                    if pm.lookup(pid, ps) != want:
                        raise RuntimeError(
                            f"epoch table, {kind}: pool {pid} ps {ps} "
                            f"{pm.lookup(pid, ps)} vs the scalar pipeline "
                            f"{want}")
            bad = table_arrays_equal(pm.tables(), cpu)
            if bad:
                raise RuntimeError(f"epoch table, {kind}: the card's table "
                                   f"and the CPU's differ at {bad}")
            log(f"epoch table, {kind} ({pm.pg_count()} PGs): K5 refuses both "
                f"rules; {out[kind]['launches']} K6 launches, no K5 launch, "
                f"nothing swept on the host, the build on the card in "
                f"{out[kind]['s']:.4f} s; == the scalar pipeline on every "
                f"PG, == the CPU build; bulk_crush numpy to numpy: one K6 "
                f"launch, {K6_BULK_SCALAR} rows == the scalar engine")
    log(f"epoch table, K6's shapes: the host's checks in "
        f"{time.perf_counter() - t_host:.1f} s ({workers} processes)")
    return out


def k6_bound(lanes: int, numrep: int, mhz: float, alg: str) -> dict:
    """K6's least time on config 5's hierarchy, as ``placement_bound``
    reckons K5's: ``INT_OPS_PER_DRAW`` a hash of a descent with no retry.
    straw2 draws every child of a bucket; a tree bucket hashes once a
    level of its node tree (ceil(log2(size)) a bucket); a list bucket at
    least once (its walk ends at the first accept): both floors."""
    fanouts = PLACEMENT[2]
    draws = {"straw2": fanouts,
             "tree": [int(np.ceil(np.log2(f))) for f in fanouts],
             "list": [1] * len(fanouts)}[alg]
    return placement_bound(lanes, numrep, mhz, tuple(draws))


def phase_k6(dev: torch.device) -> dict:
    """K6 called directly on config 5's map (straw2, the shape K5 maps) and
    on its tree and list variants at ``K6_LANES`` lanes, rules 0 x3 and 1
    x11: its rows held against K5's on every lane (straw2) and against the
    scalar engine, its plain version, on the first ``K6_PLAIN_SAMPLE``
    lanes; CUDA events for K6 (at the full launch and at the sample), the
    host clock for the scalar engine on the sample."""
    from ceph_tpu_torch.crush import rule_lanes
    from ceph_tpu_torch.crush.builder import build_hierarchy
    from ceph_tpu_torch.crush.types import (CRUSH_BUCKET_LIST,
                                            CRUSH_BUCKET_TREE)
    from ceph_tpu_torch.crush.vectorized import VectorCrush, seed_tensor
    from ceph_tpu_torch.ops import _build
    from ceph_tpu_torch.tools.crush_bench import config5_map

    cm, n, fanouts = config5_map(1000)
    maps = {"straw2": cm,
            "tree": build_hierarchy(fanouts, alg=CRUSH_BUCKET_TREE),
            "list": build_hierarchy(fanouts, alg=CRUSH_BUCKET_LIST)}
    xs = np.random.default_rng(SEED + 40).integers(0, 2**32, K6_LANES)
    seeds = seed_tensor(xs, dev)
    weights = [0x10000] * n
    w = torch.tensor(weights, dtype=torch.int32, device=dev)
    runs, err = {}, 0
    for alg, c in maps.items():
        for rule, numrep in PLACEMENT_RULES:
            rl = rule_lanes.RuleLanes(c, rule, dev)
            rows = rl.map_device(seeds, numrep, w)
            sample = K6_PLAIN_SAMPLE[rule]
            t0 = time.perf_counter()
            plain = rule_lanes.plain_rows(c, rule, xs[:sample], numrep,
                                          weights)
            plain_ms = (time.perf_counter() - t0) * 1e3
            diff = np.abs(rows[:sample].cpu().numpy().astype(np.int64)
                          - plain.astype(np.int64))
            err = max(err, int(diff.max()))
            k5_note = ""
            if alg == "straw2":
                k5 = VectorCrush(c, rule, device=dev).map_device(
                    seeds, numrep, w)
                if not torch.equal(rows, k5):
                    raise RuntimeError(f"K6 differs from K5 at config 5, "
                                       f"rule {rule}, on "
                                       f"{int((rows != k5).any(1).sum())} "
                                       f"lanes")
                k5_note = f", == K5 on all {K6_LANES} lanes"
                del k5
            if err:
                raise RuntimeError(f"K6 differs from the scalar engine on "
                                   f"{alg} rule {rule}: max {err}")
            ms = time_ms(lambda: rl.map_device(seeds, numrep, w), iters=3)
            sample_ms = time_ms(lambda: rl.map_device(seeds[:sample],
                                                      numrep, w))
            runs[(alg, rule)] = {"numrep": numrep, "ms": ms,
                                 "sample": sample, "sample_ms": sample_ms,
                                 "plain_ms": plain_ms}
            log(f"K6 crush_rule_lanes, config 5 {alg}, rule {rule} x{numrep}: "
                f"{K6_LANES} lanes {ms:.4f} ms ({K6_LANES / ms * 1e3:.4g} "
                f"mappings/s); on {sample} lanes {sample_ms:.4f} ms, the "
                f"scalar engine {plain_ms:.1f} ms (host clock), equal"
                + k5_note)
            del rows
    counts = _build.ptxas_counts(_build.report("crush_rule"))
    return {"runs": runs, "err": err, "config": rule_lanes.kernel_config(
        dev.index), "ptxas": {"ptxas_registers": counts["registers"],
                              "ptxas_stack": counts["stack"],
                              "ptxas_spill_stores": counts["spill_stores"],
                              "ptxas_spill_loads": counts["spill_loads"]}}


def k6_row(k6: dict, table: dict, mhz: float) -> dict:
    """K6's row of the kernels line: its time a 2M-lane launch at config 5,
    rule 0 x3 (the shape K5 maps, called directly), its bound, the scalar
    engine's time on the sample, its other rules and maps, and its launches
    on the epoch table's shapes (phase 8e)."""
    runs = k6["runs"]
    head = runs[("straw2", 0)]
    paths, bounds, plain = {}, {}, {}
    for (alg, rule), r in runs.items():
        label = (f"config 5 {alg}, rule {rule} "
                 f"{'firstn' if rule == 0 else 'indep'} x{r['numrep']}")
        paths[f"{label}, {K6_LANES} lanes"] = round(r["ms"], 4)
        bounds[f"{label}, {K6_LANES} lanes"] = k6_bound(K6_LANES,
                                                        r["numrep"], mhz, alg)
        paths[f"{label}, {r['sample']} lanes"] = round(r["sample_ms"], 4)
        plain[f"{label}, {r['sample']} lanes"] = round(r["plain_ms"], 4)
    shapes = table["expressed"]["k6"]
    bound = k6_bound(K6_LANES, head["numrep"], mhz, "straw2")
    return {
        "name": "crush_rule_lanes", "route": "cuda",
        "source": "ceph_tpu_torch/csrc/crush_rule.cu",
        "replaces": "no TPU kernel: ceph_tpu/mon/pg_mapping.py:118-133 sweeps "
                    "the shapes VectorCrush refuses on the host with "
                    "ceph_tpu/crush/mapper.py:426 crush_do_rule",
        "launches": sum(v["launches"] + v["bulk_launches"]
                        for v in shapes.values()),
        "launches_by_path": {
            **{f"epoch table {kind} (phase 8e)": v["launches"]
               for kind, v in shapes.items()},
            "bulk_crush numpy to numpy, one a shape (phase 8e)": sum(
                v["bulk_launches"] for v in shapes.values())},
        "max_abs_err": k6["err"],
        "ms": round(head["ms"], 4),
        "plain_ms": round(head["plain_ms"], 4),
        "plain_shape": [head["sample"], head["numrep"]],
        "plain_note": "the scalar engine (K6's plain version) on the first "
                      f"{head['sample']} lanes, host clock; K6 on the same "
                      "lanes under ms_by_path",
        "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
        "library_ms": None,
        "library_note": "no PyTorch call computes CRUSH",
        "shape": [K6_LANES, head["numrep"]], "sm_clock_mhz": mhz,
        "ms_by_path": paths, "plain_ms_by_path": plain,
        "bound_by_path": bounds,
        **k6["config"], **k6["ptxas"],
    }


def sharded_rank(rank: int, n: int, device: torch.device) -> dict:
    """One of phase 9's ranks on the card: ``dryrun_multichip``'s checks,
    then LRC k=12,m=4,l=4 encode and local repair of position 0 at
    ``SHARDED_LRC`` (from ``default_rng(1)``) over a (stripe, group) mesh,
    the repair against the encoded chunk and the encode against the host
    ``lrc`` plugin on sampled stripes.  Returns ``dryrun_rank``'s result,
    its launches counted over both."""
    from ceph_tpu_torch.ec.plugins.lrc import ErasureCodeLrc
    from ceph_tpu_torch.graft_entry import dryrun_rank
    from ceph_tpu_torch.ops import gf2kernels
    from ceph_tpu_torch.parallel import sharded_ec as se

    out = dryrun_rank(rank, n, device)
    k, m, l = 12, 4, 4
    b, lgc, kg, lane = SHARDED_LRC
    lmesh = se.lrc_make_mesh(n, lgc, device)
    groups = se.SPECS["groups"]
    data = np.random.default_rng(1).integers(0, 256, size=SHARDED_LRC,
                                             dtype=np.uint8)
    chunks = se.lrc_sharded_encode(lmesh, k, m, l,
                                   se.local_block(data, lmesh, groups))
    rec = se.lrc_sharded_local_repair(lmesh, k, m, l, 0, chunks)
    if not torch.equal(rec[:, :, 0], chunks[:, :, 0]):
        raise RuntimeError("LRC local repair differs from the encoded chunk")
    codec = ErasureCodeLrc(device="cpu")        # the host oracle
    codec.init({"k": str(k), "m": str(m), "l": str(l)})
    lo = se.local_block(np.arange(b), lmesh, ("stripe",))[0].item()
    g = lmesh.get_local_rank("group")
    for i in (0, chunks.shape[0] - 1):
        want = codec.encode(set(range(codec.get_chunk_count())),
                            data[lo + i].reshape(-1).tobytes())
        got = chunks[i, 0].cpu().numpy()
        for j in range(l + 1):
            if not np.array_equal(got[j], want[g * (l + 1) + j]):
                raise RuntimeError(f"LRC chunk {g * (l + 1) + j} of stripe "
                                   f"{lo + i} differs from the lrc plugin")
    if rank == 0:
        log(f"sharded LRC k={k} m={m} l={l} at {SHARDED_LRC} on mesh "
            f"{se.mesh_shape(lmesh)}: encode == the lrc plugin on sampled "
            f"stripes, local repair of position 0 byte-exact")
    out["launches"] = dict(gf2kernels.LAUNCHES)
    return out


def phase_sharded(dev: torch.device, main: dict) -> dict:
    """The sharded codec (``parallel/sharded_ec.py``) on the card.  World
    size 1 at full width (an NCCL group; at one rank every collective
    returns its input, so no NCCL operation runs), on the main path's
    (1024, 8, 131072) data: ``sharded_ec_step`` with erasures [1, 9],
    ``sharded_rmw`` of a 48 B write a stripe and
    ``sharded_cross_recovery``, driven with the counts set to 0; each
    output held against the plain version in slices and the host oracle
    on sampled stripes, the recovered chunks against
    the lost ones, the checksum against a host sum; each timed beside
    ``MeshCodec.encode`` / ``decode`` on the same input.  Then
    ``dryrun_multichip``'s checks on ``SHARDED_RANKS`` ranks on the one card
    over gloo with CUDA tensors (NCCL refuses two ranks on one card), the
    only run whose collectives move data, with LRC k=12,m=4,l=4 at
    ``SHARDED_LRC``; then ``entry()``."""
    import torch.distributed as dist
    from ceph_tpu_torch import graft_entry
    from ceph_tpu_torch.gf import build_decode_matrix, gen_rs_matrix
    from ceph_tpu_torch.ops import gf2kernels as gk
    from ceph_tpu_torch.parallel import MeshCodec
    from ceph_tpu_torch.parallel import sharded_ec as se

    b, k, m, l = MAIN
    data, codec = main["data"], main["codec"]
    gen = gen_rs_matrix(k + m, k)
    erasures = [1, 9]
    dec, idx = build_decode_matrix(gen, k, erasures)
    w_par = torch.from_numpy(gk.bitmatrix_i8(gen[k:])).to(dev)
    w_dec = torch.from_numpy(gk.bitmatrix_i8(dec)).to(dev)
    piece = torch.from_numpy(np.random.default_rng(SEED + 50).integers(
        0, 256, (b, 48), dtype=np.uint8)).to(dev)
    delta = torch.zeros_like(data)
    delta[:, 2, 40:88] = data[:, 2, 40:88] ^ piece
    newdata = data.clone()
    newdata[:, 2, 40:88] = piece

    def gather(src: list, pick) -> torch.Tensor:
        return torch.stack([src[0][:, i] if i < k else src[1][:, i - k]
                            for i in pick], dim=1)

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = se.make_mesh(1, device=dev)
        torch.cuda.synchronize()
        reset_launches()
        parity, rec, csum = se.sharded_ec_step(mesh, gen, dec, idx, erasures,
                                               k, data)
        new_parity = se.sharded_rmw(mesh, gen, k, parity.clone(), delta)
        rec2 = se.sharded_cross_recovery(mesh, dec, gather(
            [newdata, new_parity], idx))
        torch.cuda.synchronize()
        launches = launch_counts()
        dense = {n: launches[n] for n in gk.LAUNCHES}
        if sum(dense.values()) != 4 or any(
                v for n, v in launches.items() if n not in gk.LAUNCHES):
            raise RuntimeError(f"the sharded codec's launches {launches}: "
                               f"want 4 GF(2^8) kernel launches")
        survivors = gather([data, parity], idx)
        errs, plain_ms = {}, {}
        for label, plain_w, x, out in (
                ("encode", w_par, data, parity),
                ("decode", w_dec, survivors, rec),
                ("rmw", w_par, newdata, new_parity),
                ("cross recovery", w_dec, gather([newdata, new_parity], idx),
                 rec2)):
            plain_ms[label], errs[label] = plain_in_slices(
                lambda y, w=plain_w: gk.gf2_matmul_plain(w, y), x, out)
            for i, want in zip((0, b // 2, b - 1), host_stripes(
                    gen[k:] if plain_w is w_par else dec, x, (0, b // 2,
                                                              b - 1))):
                if not np.array_equal(out[i].cpu().numpy(), want):
                    raise RuntimeError(f"sharded {label}: stripe {i} differs "
                                       f"from the host oracle")
        if any(errs.values()):
            raise RuntimeError(f"the sharded codec differs from the plain "
                               f"version: {errs}")
        lost = torch.cat([data[:, 1:2], parity[:, 1:2]], dim=1)
        if not torch.equal(rec, lost) or not torch.equal(rec2, torch.cat(
                [newdata[:, 1:2], new_parity[:, 1:2]], dim=1)):
            raise RuntimeError("the sharded codec's recovered chunks differ "
                               "from the lost ones")
        host_sum = int(rec.cpu().numpy().astype(np.int64).sum())
        if int(csum) != host_sum & 0xFFFFFFFF or csum.shape != (1,):
            raise RuntimeError(f"sharded_ec_step's checksum {int(csum)} vs "
                               f"the host sum {host_sum} mod 2^32")
        old = parity.clone()
        mc = MeshCodec(device=dev)
        # the step's parts beyond its two products: the survivor gather
        # and the checksum's reduction (CUDA events)
        parts = {
            "survivor gather": time_ms(lambda: gather([data, parity], idx)),
            "checksum": time_ms(lambda: rec.sum(dtype=torch.int64)
                                & 0xFFFFFFFF)}
        ms = {
            "sharded_encode": time_ms(lambda: se.sharded_encode(
                mesh, gen, k, data)),
            "sharded_ec_step": time_ms(lambda: se.sharded_ec_step(
                mesh, gen, dec, idx, erasures, k, data)),
            "sharded_rmw": time_ms(lambda: se.sharded_rmw(
                mesh, gen, k, old, delta)),
            "sharded_cross_recovery": time_ms(
                lambda: se.sharded_cross_recovery(mesh, dec, survivors)),
            "MeshCodec.encode": time_ms(lambda: mc.encode(
                codec, data, out_np=False)),
            "MeshCodec.decode": time_ms(lambda: mc.decode(
                codec, erasures, survivors, out_np=False)),
        }
    finally:
        dist.destroy_process_group()
    log(f"sharded codec, world size 1 (no collective runs), rs8/3 "
        f"({b}, {k}, {l}): "
        + ", ".join(f"{n} {v:.4f} ms" for n, v in ms.items())
        + f" (CUDA events; the step's survivor gather "
        f"{parts['survivor gather']:.4f} ms, checksum "
        f"{parts['checksum']:.4f} ms); step, rmw and cross recovery == the "
        f"plain "
        f"version (in slices, {sum(plain_ms.values()):.1f} ms) and the host "
        f"oracle on 3 stripes, recovered == lost, checksum {int(csum)} == "
        f"the host sum {host_sum} mod 2^32; launches {dense}")
    del survivors, delta, newdata, parity, rec, new_parity, rec2, old

    t0 = time.perf_counter()
    ranks = graft_entry.spawn_ranks(sharded_rank, SHARDED_RANKS, "cuda",
                                    "gloo", timeout=300)
    ranks_s = time.perf_counter() - t0
    rank_launches = {n: sum(r["launches"][n] for r in ranks)
                     for n in gk.LAUNCHES}
    if not sum(rank_launches.values()):
        raise RuntimeError("the dry run's ranks launched no GF(2^8) kernel")
    log(f"sharded dry run, {SHARDED_RANKS} ranks on the card over gloo with "
        f"CUDA tensors (meshes {ranks[0]['mesh']}, {ranks[0]['lrc_mesh']}; "
        f"LRC at {SHARDED_LRC}): every check held in {ranks_s:.1f} s; "
        f"launches {rank_launches}")

    reset_launches()
    fn, (example,) = graft_entry.entry(device=dev)
    out = fn(example)
    torch.cuda.synchronize()
    entry_launches = {n: gk.LAUNCHES[n] for n in gk.LAUNCHES}
    plain = gk.gf2_matmul_plain(w_par, example[None])[0]
    from ceph_tpu_torch.gf import gf_matmul
    if not torch.equal(out, plain) or not np.array_equal(
            out.cpu().numpy(), gf_matmul(gen[k:], example.cpu().numpy())):
        raise RuntimeError("entry() differs from its plain version or the "
                           "host oracle")
    if not sum(entry_launches.values()):
        raise RuntimeError("entry() launched no GF(2^8) kernel")
    log(f"entry(): RS k=8,m=3 parity of {tuple(example.shape)} == the plain "
        f"version and the host oracle; launches {entry_launches}")
    return {"ms": ms, "parts": parts, "plain_ms": plain_ms, "errs": errs,
            "launches": dense, "rank_launches": rank_launches,
            "entry_launches": entry_launches, "ranks_s": ranks_s,
            "checksum": int(csum), "host_sum": host_sum}


def datapath_dense(rig, dev: torch.device) -> dict:
    """The dense kernels at the data spine's launch shapes, on the cached
    rig's resident shards: the write's encode at (max_batch, k, chunk) and
    the degraded read's decode of shard 0 at its padded batch, each against
    the parity or shard the path stored and against the kernel's plain
    version (in slices).  Times by CUDA events."""
    from ceph_tpu_torch.ops import gf2kernels as gk
    from ceph_tpu_torch.tools import datapath_bench as dp

    k, m, chunk = rig.k, rig.m, rig.sinfo.chunk_size
    oids = sorted(rig.meta)
    per = rig.sinfo.object_size_to_shard_size(DATAPATH["obj_bytes"]) // chunk

    def shards_of(ids, objs):
        """(objects x stripes, len(ids), chunk) from the device views."""
        return torch.cat([torch.stack([
            rig.stores[s].shard_cache.device_view(dp.COLL, oid).view(
                per, chunk) for s in ids], dim=1) for oid in objs])

    degraded = max(2, len(oids) // 12) * per
    erasures = [0]
    dmat, dindex = rig.codec.decode_entry(erasures)
    cases = {
        "encode": (rig.codec.encode_matrix[k:],
                   oids[:DATAPATH["max_batch"] // per], list(range(k)),
                   list(range(k, k + m))),
        f"decode{erasures}": (dmat, oids[:gk.bucket_batch(degraded) // per],
                              list(dindex), erasures)}
    out = {}
    for label, (mat, objs, src, dst) in cases.items():
        mat = np.ascontiguousarray(mat, np.uint8)
        data, want = shards_of(src, objs), shards_of(dst, objs)
        b, r = data.shape[0], mat.shape[0]
        name, g = gk.dense_kernel_for(b, k, r, chunk)
        if name == "gf2_matmul_mma":
            w = torch.from_numpy(gk.w_gN_planemajor(mat, g)).to(dev)
            kernel = lambda: gk.gf2_matmul_mma(mat, data, g)  # noqa: E731
            plain = lambda x: gk.gf2_matmul_grouped_plain(w, x, g)  # noqa: E731
        else:
            w = torch.from_numpy(gk.bitmatrix_i8(mat)).to(dev)
            kernel = lambda: gk.gf2_matmul_popc(mat, data)  # noqa: E731
            plain = lambda x: gk.gf2_matmul_plain(w, x)  # noqa: E731
        got = kernel()
        plain_ms, err = plain_in_slices(plain, data, got)
        if err or not torch.equal(got, want):
            raise RuntimeError(f"datapath {label}: {name} differs from its "
                               f"plain version ({err}) or the stored shards")
        ms = time_ms(kernel)
        out[label] = {"name": name, "g": g, "shape": [b, k, chunk], "r": r,
                      "ms": ms, "plain_ms": plain_ms}
        log(f"datapath {label} at the path's launch shape ({b}, {k}, "
            f"{chunk}) -> {r}: {name} {ms:.4f} ms (CUDA events), plain "
            f"{plain_ms:.2f} ms, == its plain version and the stored shards")
    return out


def phase_datapath(dev: torch.device) -> dict:
    """The OSD shard data spine on the card (``tools/datapath_bench.py`` at
    ``DATAPATH``): write -> read-verify -> scrub -> degraded read over 11
    BlockStores, a warm-up drive, then the host round-trip baseline drive
    and the drive through the shard cache, which this phase drives piece by
    piece (``_Rig``, ``drive_phases``) so that its checks see the open rig.
    The launch counts are set to 0 before each of the two drives and read
    at its end, before any check launches.  Checks: byte identity (the
    bench's gates), cache hits, no steady host bytes and no scalar CRC
    call, one upload a resident shard in the first cached scrub and none
    after, the scrub's K4 CRCs against the host engine on every shard and
    against K4's plain version on a sample, every write tag against the
    host engine's CRC of the stored shard, K1/K2 and K4 launched in each
    drive, no fallback."""
    import asyncio
    import shutil
    from ceph_tpu_torch.ops import crc32c_batch as crc
    from ceph_tpu_torch.os.device_cache import PERF as DATAPATH_PERF
    from ceph_tpu_torch.tools import datapath_bench as dp

    shards = (DATAPATH["k"] + DATAPATH["m"]) * DATAPATH["n_objects"]
    sizes = {key: DATAPATH[key] for key in ("k", "m", "n_objects", "obj_bytes",
                                           "passes", "reads_per_pass")}
    need = dp.drive_disk_bytes(DATAPATH["k"], DATAPATH["m"],
                               DATAPATH["n_objects"], DATAPATH["obj_bytes"])
    path = {}

    def inspect(rig):
        """The checks on the cached rig after its last pass."""
        uploads0 = DATAPATH_PERF.get("device_uploads")
        views, host, tags, stored = [], [], [], []
        for oid in sorted(rig.meta):
            for s, st in enumerate(rig.stores):
                host.append(st.shard_cache.get(dp.COLL, oid).buf)
                views.append(st.shard_cache.device_view(dp.COLL, oid))
                tags.append(rig.meta[oid][2][s])
                stored.append(st.read(dp.COLL, oid))
        if DATAPATH_PERF.get("device_uploads") != uploads0 \
                or len(views) != shards:
            raise RuntimeError("datapath: a shard was not resident on the "
                               "card after the cached scrubs")
        host_crcs = crc.crc32c_rows(np.stack(host))
        k4_crcs = crc.crc32c_resident_batch(views)
        if not np.array_equal(k4_crcs, host_crcs):
            raise RuntimeError("datapath: the scrub's K4 CRCs differ from the "
                               "host engine's")
        if not np.array_equal(np.asarray(tags, np.uint32),
                              crc.crc32c_batch(stored)):
            raise RuntimeError("datapath: a write tag differs from the host "
                               "engine's CRC of the stored shard")
        del stored
        stacked = torch.stack(views)
        # K4's plain version on a sample of the views, as 4 KiB chunk rows
        # whose CRCs the GF(2) fold joins (whole 512 KiB rows would take the
        # plain loop 65,536 steps)
        pick = np.random.default_rng(SEED + 40).choice(
            shards, DATAPATH_PLAIN_SAMPLE, replace=False)
        chunk = DATAPATH["stripe_unit"]
        sample = stacked[torch.from_numpy(pick).to(dev)]
        plain = crc.to_uint32(crc.crc32c_chunks_plain(
            sample.reshape(-1, chunk))).reshape(len(pick), -1)
        if not np.array_equal(crc.fold_chunk_crcs(plain.T, chunk),
                              k4_crcs[pick]):
            raise RuntimeError("datapath: K4 differs from its plain version "
                               "on the resident views")
        path["k4_ms"] = time_ms(lambda: crc.crc32c_chunks(stacked))
        path["k4_shape"] = tuple(stacked.shape)
        path["k4_bytes"] = stacked.numel()
        del stacked, sample
        path["dense"] = datapath_dense(rig, dev)

    async def drives():
        """The warm-up and baseline drives through ``_drive``, then the
        cached drive piece by piece; each timed drive's launches."""
        launches = {}
        await dp._drive(False, base_dir=dp.bench_dir(need), device=dev,
                        **{**DATAPATH, "passes": 1, "reads_per_pass": 1})
        torch.cuda.synchronize()
        reset_launches()
        baseline = await dp._drive(False, base_dir=dp.bench_dir(need),
                                   device=dev, **DATAPATH)
        torch.cuda.synchronize()
        launches["baseline"] = launch_counts()
        objects = dp.source_objects(DATAPATH["n_objects"],
                                    DATAPATH["obj_bytes"])
        base_dir = dp.bench_dir(need)
        reset_launches()
        try:
            rig = dp._Rig(DATAPATH["k"], DATAPATH["m"],
                          DATAPATH["stripe_unit"], True, base_dir,
                          device=dev, max_batch=DATAPATH["max_batch"])
            try:
                phases, digests = await dp.drive_phases(
                    rig, objects, passes=DATAPATH["passes"],
                    reads_per_pass=DATAPATH["reads_per_pass"])
                torch.cuda.synchronize()
                launches["cached"] = launch_counts()
                inspect(rig)
                ec_batch = rig.batcher.perf.dump()
            finally:
                rig.close()
        finally:
            shutil.rmtree(base_dir, ignore_errors=True)
        cached = dp.drive_report(True, phases, ec_batch, digests)
        return dp.compare(baseline, cached, **sizes, device=dev), launches

    torch.cuda.synchronize()
    run_peak = torch.cuda.max_memory_allocated()   # of the earlier phases
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()       # by the earlier phases
    t0 = time.perf_counter()
    res, launches = asyncio.new_event_loop().run_until_complete(drives())
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - held
    bad = dp.gate_failures(res)
    if bad:
        raise RuntimeError(f"datapath: {bad}")
    cached, base = res["cached_run"], res["baseline_run"]
    ups = {name: ph["counters"]["device_uploads"]
           for name, ph in cached["phases"].items()}
    if ups.pop("scrub_0") != shards or any(ups.values()):
        raise RuntimeError(f"datapath: device uploads by phase {ups}, want "
                           f"{shards} in scrub_0 and none after")
    batch = cached["ec_batch"]
    fallbacks = sum(b.get(key, 0) for b in (batch, base["ec_batch"]) for key in
                    ("fallback_ops", "mesh_fallbacks", "crc_host_batches"))
    for drive, counts in launches.items():
        dense = counts["gf2_matmul_popc"] + counts["gf2_matmul_mma"]
        if not dense or not counts["crc32c_chunks"] or counts["xor_sched"] \
                or fallbacks:
            raise RuntimeError(f"datapath {drive} drive: launches {counts}, "
                               f"fallbacks {fallbacks}")
    for run in (base, cached):
        log(f"datapath {'cached' if run['cached'] else 'baseline'} drive: "
            f"{run['end_to_end_GiBps']} GiB/s end to end over "
            f"{run['seconds']} s; by phase " + ", ".join(
                f"{name} {ph['seconds']} s {ph['GiBps']} GiB/s"
                for name, ph in dp.agg_phases(run["phases"]).items())
            + f"; write: encode wait {run['phases']['write']['encode_s']:.4f}"
            f" s, store commit {run['phases']['write']['commit_s']:.4f} s")
    up_bytes = cached["phases"]["scrub_0"]["counters"]["device_upload_bytes"]
    up_s = cached["phases"]["scrub_0"]["views_s"]
    bound_ms = path["k4_bytes"] / HBM_BYTES_PER_S * 1e3
    log(f"datapath (RS k={DATAPATH['k']},m={DATAPATH['m']}, "
        f"{DATAPATH['n_objects']} objects of {DATAPATH['obj_bytes'] >> 20} "
        f"MiB, {shards} shards; reduced: passes {DATAPATH['passes']} "
        f"(reference 10), reads_per_pass {DATAPATH['reads_per_pass']} "
        f"(reference 5)): "
        f"cached {res['datapath_GiBps']} GiB/s vs baseline "
        f"{res['baseline_GiBps']} GiB/s ({res['vs_host_roundtrip']}x); cache "
        f"hits {res['cache_hits']}, steady host bytes "
        f"{res['steady_host_bytes_read']}, scalar CRC calls "
        f"{res['scalar_calls_on_batched_paths']}; device-view upload "
        f"{up_bytes} B in {up_s * 1e3:.1f} ms ({up_bytes / up_s / 1e9:.2f} "
        f"GB/s, with the cache reads); the cached scrub's views gathered "
        f"{cached['phases']['scrub_1']['views_s'] * 1e3:.1f} ms, its sweep "
        f"{cached['phases']['scrub_1']['sweep_s'] * 1e3:.1f} ms (host "
        f"clock); K4 over {path['k4_shape']} {path['k4_ms']:.4f} ms (CUDA "
        f"events) vs HBM bound {bound_ms:.4f} ms; launches by drive "
        f"{launches}; peak "
        f"device memory {peak / GiB:.2f} GiB above the {held / GiB:.2f} GiB "
        f"the earlier phases hold; {secs:.1f} s")
    return {"res": res, "launches": launches, "dense": path["dense"],
            "k4_ms": path["k4_ms"],
            "k4_shape": path["k4_shape"], "k4_bound_ms": bound_ms,
            "upload_bytes": up_bytes, "upload_s": up_s, "peak_bytes": peak,
            "run_peak_bytes": run_peak,
            "seconds": secs}


@contextlib.contextmanager
def card_busy(out: dict):
    """The card's busy time over the block by ``torch.profiler`` (CUDA
    activity only): kernel and copy time over the block's wall time, into
    ``out``.  Where the profiler sees no device time, ``out["kernel_s"]``
    stays None ("not measured")."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CUDA])
    with prof:
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        out["wall_s"] = time.perf_counter() - t0
    kernel = copy = 0.0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        if e.key.startswith(("Memcpy", "Memset")):
            copy += e.self_device_time_total
        else:
            kernel += e.self_device_time_total
    out["kernel_s"] = kernel / 1e6 if kernel else None
    out["copy_s"] = copy / 1e6 if kernel else None


# where a host second of the cluster goes, by the file (or builtin) that
# spent it (cProfile's own time)
HOST_BUCKETS = (
    ("messenger (msg/)", ("/ceph_tpu_torch/msg/",)),
    ("host CRC engine (native.py)", ("/ceph_tpu_torch/native.py",)),
    ("store commit and reads (os/)", ("/ceph_tpu_torch/os/",)),
    ("batcher (marshal, fan-out)", ("/ceph_tpu_torch/osd/codec_batcher.py",)),
    ("codec wrappers (ops/, parallel/, ec/)",
     ("/ceph_tpu_torch/ops/", "/ceph_tpu_torch/parallel/",
      "/ceph_tpu_torch/ec/")),
    ("PG, backend, OSD (osd/)", ("/ceph_tpu_torch/osd/",)),
    ("client (client/)", ("/ceph_tpu_torch/client/",)),
    ("maps and placement (mon/, crush/)",
     ("/ceph_tpu_torch/mon/", "/ceph_tpu_torch/crush/")),
    ("common (denc, counters, config)", ("/ceph_tpu_torch/common/",)),
    ("event loop and sockets", ("/asyncio/", "selectors.py", "socket",
                                "select", "epoll")),
    ("torch (copies, launches)", ("/torch/", "torch.", "Tensor")),
    ("numpy", ("/numpy/", "numpy.")),
)
HOST_FUNCS = (   # (file suffix, function): cumulative seconds
    ("osd/codec_batcher.py", "_marshal"),
    ("osd/codec_batcher.py", "_dispatch"),
    ("osd/codec_batcher.py", "_complete"),
    ("os/store.py", "queue_transaction"),
    ("msg/message.py", "encode"),
    ("msg/message.py", "unwrap_frame"),
    ("msg/message.py", "_decode_meta"),
    ("ceph_tpu_torch/native.py", "crc32c"),
    ("ops/crc32c_batch.py", "crc32c_batch"),
)


def host_split(stats) -> dict:
    """cProfile's own time by ``HOST_BUCKETS``, and ``HOST_FUNCS``'
    cumulative seconds."""
    buckets: dict[str, float] = {}
    funcs: dict[str, float] = {}
    for (fname, _, func), (_, _, tt, ct, _) in stats.stats.items():
        where = f"{fname} {func}"
        name = next((label for label, keys in HOST_BUCKETS
                     if any(key in where for key in keys)), "other")
        buckets[name] = buckets.get(name, 0.0) + tt
        for suffix, fn in HOST_FUNCS:
            if fname.endswith(suffix) and func == fn:
                funcs[f"{suffix}:{fn}"] = funcs.get(f"{suffix}:{fn}", 0) + ct
    total = sum(buckets.values())
    top = sorted(stats.stats.items(), key=lambda kv: -kv[1][2])[:12]
    return {"total_s": total,
            "by_bucket": {k: v for k, v in sorted(
                buckets.items(), key=lambda kv: -kv[1])},
            "functions_cumulative_s": funcs,
            "top_own_s": {f"{fname.rsplit('/', 2)[-1]}:{func}": st[2]
                          for (fname, _, func), st in top}}


def cluster_shards(drive, oid: str) -> dict:
    """(osd, shard label) -> (bytes, CRC tag) of ``oid`` on every live
    OSD's store."""
    return pool_shards(drive.cluster, drive.pool_id, oid)


def pool_shards(cluster, pool_id: int, oid: str) -> dict:
    """(osd, shard label) -> (bytes, CRC tag) of ``oid`` of a pool on every
    live OSD's store of a ``SimCluster``."""
    from ceph_tpu_torch.osd.backend import CRC_XATTR, SHARD_XATTR
    # lint: disable=cross-daemon-state -- its own monitor, one process
    omap = cluster.mon.osdmap
    _, ps = omap.object_to_pg(pool_id, oid)
    coll = f"pg_{omap.pg_name(pool_id, ps)}"
    out = {}
    for osd in cluster.osds:
        # lint: disable=cross-daemon-state -- its own OSDs, one process
        store = osd.store
        if osd.is_stopped() or not store.exists(coll, oid):
            continue
        label = store.getattr(coll, oid, SHARD_XATTR)
        crc = store.getattr(coll, oid, CRC_XATTR)
        out[(osd.whoami, int(label))] = (
            bytes(store.read(coll, oid, 0, None)),
            None if crc is None else int(crc))
    return out


def cluster_oracle(drive) -> dict:
    """The host oracle: ``CLUSTER_ORACLE_SAMPLE`` objects' shards on every
    OSD, and every shard the revived OSD holds, against the port's host
    encode of the same object (``gf.gf_matmul`` through the ``isa`` plugin on
    the CPU, ``StripeInfo.encode``); each shard's CRC tag against
    ``native.crc32c`` of its bytes."""
    from ceph_tpu_torch import native
    from ceph_tpu_torch.ec import registry
    from ceph_tpu_torch.osd.ec_util import StripeInfo
    isa = registry().factory("isa", {"k": str(CLUSTER["k"]),
                                     "m": str(CLUSTER["m"]),
                                     "technique": "reed_sol_van"})
    sinfo = StripeInfo.for_codec(isa, stripe_unit=CLUSTER_STRIPE_UNIT)
    width = CLUSTER["k"] + CLUSTER["m"]
    rng = np.random.default_rng(SEED + 100)
    sample = sorted(rng.choice(drive.oids, CLUSTER_ORACLE_SAMPLE,
                               replace=False))
    checked = revived = 0
    for oid in drive.oids:
        shards = cluster_shards(drive, oid)
        mine = {k: v for k, v in shards.items() if k[0] == drive.victim}
        if oid not in sample and not mine:
            continue
        want = sinfo.encode(isa, drive.src[oid])
        todo = shards if oid in sample else mine
        if oid in sample and sorted(s for _, s in shards) != \
                list(range(width)):
            raise RuntimeError(f"cluster: {oid} has shards "
                               f"{sorted(shards)}, want one of each of "
                               f"{width}")
        for (whoami, label), (raw, tag) in todo.items():
            if raw != want[label].tobytes():
                raise RuntimeError(f"cluster: osd.{whoami}'s shard {label} "
                                   f"of {oid} differs from the host encode")
            if tag != native.crc32c(raw):
                raise RuntimeError(f"cluster: osd.{whoami}'s CRC tag of "
                                   f"shard {label} of {oid} differs from "
                                   f"the host engine's")
            checked += 1
            revived += whoami == drive.victim
    if revived == 0:
        raise RuntimeError(f"cluster: the revived osd.{drive.victim} holds no "
                           f"shard to check")
    return {"shards_checked": checked, "revived_shards_checked": revived,
            "sample": list(sample)}


def cluster_kernels(drive, launched: dict, dev: torch.device) -> dict:
    """The kernels at the cluster's launch shapes, on its stored shards:
    the dense kernel of the most frequent encode and decode launch against
    its plain version (in slices) and the stored parity or shard; K4 over
    that encode's data and parity rows against its plain version, the host
    engine and the stored tags (folded); K5 on the pool's seeds against its
    plain version.  Times by CUDA events."""
    from ceph_tpu_torch.ops import crc32c_batch as crc
    from ceph_tpu_torch.ops import gf2kernels as gk
    k, m, chunk = CLUSTER["k"], CLUSTER["m"], CLUSTER_STRIPE_UNIT
    per = CLUSTER["obj_bytes"] // (k * chunk)
    codec = next(pg.backend.codec for osd in drive.cluster.osds
                 # lint: disable=cross-daemon-state -- its own OSDs, one process
                 for pgid, pg in osd.pgs.items()
                 if pgid.startswith(f"{drive.pool_id}."))

    def by_label(oid):
        """shard label -> (bytes, CRC tag) of ``oid``."""
        return {lab: val for (_, lab), val in
                cluster_shards(drive, oid).items()}

    def rows_of(objs, labels, b):
        """(b, len(labels), chunk): the objects' shards at ``labels`` as
        stripes, zero rows past them (the batcher's padding)."""
        parts = []
        for oid in objs:
            sh = by_label(oid)
            parts.append(np.stack([np.frombuffer(sh[lab][0], np.uint8)
                                   .reshape(per, chunk) for lab in labels],
                                  axis=1))
        arr = np.concatenate(parts)[:b]
        if arr.shape[0] < b:
            arr = np.concatenate([arr, np.zeros(
                (b - arr.shape[0], len(labels), chunk), np.uint8)])
        return torch.from_numpy(arr).to(dev)

    def top(kind):
        keys = [key for key in launched if key[0] == kind]
        if not keys:
            raise RuntimeError(f"cluster: no {kind} launch through the "
                               f"OSDs' batchers")
        return max(keys, key=lambda key: launched[key])

    out = {}
    enc_key, dec_key = top("encode"), top("decode")
    for label, (kind, shape, erasures) in (("encode", enc_key),
                                           ("decode", dec_key)):
        b = shape[0]
        objs = drive.oids[:-(-b // per)]
        if kind == "encode":
            mat = codec.encode_matrix[k:]
            src, dst = list(range(k)), list(range(k, k + m))
        else:
            mat, index = codec.decode_entry(list(erasures))
            src, dst = list(index), list(erasures)
            label = f"decode{list(erasures)}"
        mat = np.ascontiguousarray(mat, np.uint8)
        data, want = rows_of(objs, src, b), rows_of(objs, dst, b)
        r = mat.shape[0]
        name, g = gk.dense_kernel_for(b, k, r, chunk)
        if name == "gf2_matmul_mma":
            w = torch.from_numpy(gk.w_gN_planemajor(mat, g)).to(dev)
            kernel = lambda: gk.gf2_matmul_mma(mat, data, g)  # noqa: E731
            plain = lambda x: gk.gf2_matmul_grouped_plain(w, x, g)  # noqa: E731
        else:
            w = torch.from_numpy(gk.bitmatrix_i8(mat)).to(dev)
            kernel = lambda: gk.gf2_matmul_popc(mat, data)  # noqa: E731
            plain = lambda x: gk.gf2_matmul_plain(w, x)  # noqa: E731
        got = kernel()
        plain_ms, err = plain_in_slices(plain, data, got)
        if err or not torch.equal(got, want):
            raise RuntimeError(f"cluster {label}: {name} differs from its "
                               f"plain version ({err}) or the stored shards")
        ms = time_ms(kernel)
        out[label] = {"name": name, "g": g, "shape": [b, k, chunk], "r": r,
                      "ms": ms, "plain_ms": plain_ms, "err": err,
                      "launches": launched[(kind, shape, erasures)]}
        log(f"cluster {label} at the path's launch shape ({b}, {k}, {chunk})"
            f" -> {r} ({launched[(kind, shape, erasures)]} launches): {name} "
            f"{ms:.4f} ms (CUDA events), plain {plain_ms:.2f} ms, == its "
            f"plain version and the stored shards")
        if kind == "encode":
            # K4 over the encode's data and parity rows, as the fused
            # write CRCs run it
            b_obj = len(objs) * per
            rows = torch.cat([data[:b_obj], want[:b_obj]], dim=1).reshape(
                -1, chunk)
            k4 = crc.to_uint32(crc.crc32c_chunks(rows))
            plain_t0 = time.perf_counter()
            k4_plain = crc.to_uint32(crc.crc32c_chunks_plain(rows))
            torch.cuda.synchronize()
            k4_plain_ms = (time.perf_counter() - plain_t0) * 1e3
            host = crc.crc32c_rows(rows.cpu().numpy())
            tags = np.asarray([by_label(oid)[lab][1] for oid in objs
                               for lab in range(k + m)], np.uint32)
            folded = np.asarray(crc.fold_chunk_crcs(
                k4.reshape(len(objs), per, k + m).transpose(1, 0, 2).reshape(
                    per, -1), chunk), np.uint32).reshape(-1)
            if not (np.array_equal(k4, k4_plain) and np.array_equal(k4, host)
                    and np.array_equal(folded, tags)):
                raise RuntimeError("cluster: K4 differs from its plain "
                                   "version, the host engine or the stored "
                                   "tags at the write's CRC rows")
            out["crc"] = {"shape": list(rows.shape), "err": 0,
                          "ms": time_ms(lambda: crc.crc32c_chunks(rows)),
                          "plain_ms": k4_plain_ms}
            log(f"cluster K4 over the write's {tuple(rows.shape)} CRC rows: "
                f"{out['crc']['ms']:.4f} ms (CUDA events), plain "
                f"{k4_plain_ms:.1f} ms (host clock), == its plain version, "
                f"the host engine and the stored tags")
    # K5 at the pool's table: rule 1, size k+m, pg_num lanes
    out["placement"] = pool_k5(drive.cluster, drive.pool_id, dev, "cluster")
    return out


def phase_cluster(dev: torch.device) -> dict:
    """The RADOS cluster on the card at ``CLUSTER``: ``ClusterDrive``
    (``tools/ec_osd_bench.py``) through the daemons' entry points, every
    daemon on ``dev``.  The launch counts are set to 0 just before the boot
    and read after the scrub, by stage.  Checks: every read equals its
    source; the host oracle on sampled objects and on the revived OSD;
    K2, K4 and K5 launched; stripes a launch above 1; no scrub
    inconsistency and K4 launched in the scrub; the kernels at the path's
    shapes against their plain versions."""
    import asyncio
    import cProfile
    import pstats
    from ceph_tpu_torch.tools.ec_osd_bench import ClusterDrive

    drive = ClusterDrive(**CLUSTER, device=dev)
    stages: dict[str, dict] = {}
    busy: dict = {}
    osds: list = []                  # every OSD of the phase, the killed one too
    loop = asyncio.new_event_loop()

    async def run():
        reset_launches()
        last = launch_counts()

        def mark(stage):
            nonlocal last
            torch.cuda.synchronize()
            now = launch_counts()
            stages[stage] = {k: now[k] - last[k] for k in now
                             if now[k] != last[k]}
            last = now

        await drive.boot()
        osds.extend(drive.cluster.osds)
        mark("boot")
        await drive.write_rounds()
        mark("write")
        objs = list(drive.src.items())
        with card_busy(busy):
            busy["objects"] = len(objs[:CLUSTER_PROFILED_OBJECTS])
            await drive.write(dict(objs[:CLUSTER_PROFILED_OBJECTS]))
        mark("torch.profiler write")
        prof = cProfile.Profile()
        prof.enable()
        host_s = await drive.write(dict(objs[:CLUSTER_HOST_OBJECTS]))
        prof.disable()
        mark("cProfile write")
        await drive.read_sweep("read")
        mark("read")
        await drive.kill()
        mark("kill")
        await drive.read_sweep("degraded_read")
        mark("degraded read")
        await drive.degraded_write()
        mark("degraded write")
        await drive.revive()
        osds.append(drive.revived_osd())
        mark("revive and recovery")
        await drive.read_sweep("read_after_recovery")
        mark("read after recovery")
        await drive.scrub()
        mark("scrub")
        return prof, host_s

    t0 = time.perf_counter()
    try:
        prof, host_s = loop.run_until_complete(run())
        launches = {}
        for counts in stages.values():
            for name, n in counts.items():
                launches[name] = launches.get(name, 0) + n
        secs = time.perf_counter() - t0
        rep = drive.report
        if rep["mismatches"]:
            raise RuntimeError(f"cluster: reads differ from their source: "
                               f"{rep['mismatches'][:5]}")
        if rep["scrub_inconsistent"] or \
                rep["scrub_objects"] != CLUSTER["n_objects"]:
            raise RuntimeError(f"cluster: scrub found "
                               f"{rep['scrub_inconsistent']} over "
                               f"{rep['scrub_objects']} objects")
        occ = rep["write_occupancy"]
        if occ["stripes_per_launch"] <= 1 or occ["fallback_ops"] \
                or occ["mesh"]["fallbacks"]:
            raise RuntimeError(f"cluster: write batching {occ}")
        for name in ("gf2_matmul_mma", "crc32c_chunks", "crush_map_rule"):
            if not launches.get(name):
                raise RuntimeError(f"cluster: {name} never launched; "
                                   f"launches by stage {stages}")
        if not stages.get("scrub", {}).get("crc32c_chunks"):
            raise RuntimeError(f"cluster: the scrub launched no K4 "
                               f"({stages.get('scrub')})")
        launched = sum((osd.codec_batcher.launch_shapes for osd in osds),
                       collections.Counter())
        oracle = cluster_oracle(drive)
        kernels = cluster_kernels(drive, launched, dev)
        split = host_split(pstats.Stats(prof))
    finally:
        loop.run_until_complete(drive.stop())
        loop.close()
    wall = busy["wall_s"]
    summary = drive.summary()
    log(f"cluster ({CLUSTER['n_osds']} OSDs, RS k={CLUSTER['k']},"
        f"m={CLUSTER['m']} on cuda, pg_num {CLUSTER['pg_num']}, "
        f"{CLUSTER['n_objects']} objects of {CLUSTER['obj_bytes'] >> 10} KiB, "
        f"MemStore; cut: the objects 128 -> {CLUSTER['n_objects']}, the "
        f"timed rounds 2 -> {CLUSTER['rounds']}): write "
        f"{rep['write_GiBps']:.4f} GiB/s over "
        f"{CLUSTER['rounds']} timed rounds ({rep['write_s']:.3f} s; warm "
        f"round {rep['warm_write_s']:.3f} s), read {rep['read_GiBps']:.4f}, "
        f"degraded read {rep['degraded_read_GiBps']:.4f}, degraded write "
        f"{rep['degraded_write_GiBps']:.4f}, read after recovery "
        f"{rep['read_after_recovery_GiBps']:.4f} GiB/s (host clock); boot "
        f"{rep['boot_s']:.2f} s, mark down {rep['mark_down_s']:.2f} s, "
        f"recovery {rep['recovery_s']:.3f} s, scrub {rep['scrub_s']:.3f} s "
        f"({rep['scrub_objects']} objects, clean)")
    log(f"cluster write batching (timed rounds): {occ['stripes_per_launch']} "
        f"stripes a launch over {occ['batches']} launches, flush reasons "
        f"{occ['flush_reasons']}, pad waste {occ['pad_waste_bytes']} B, "
        f"pipeline {occ['ec_pipeline']}")
    kern = busy.get("kernel_s")
    log(f"cluster card busy share of a write round of {busy['objects']} "
        f"objects under torch.profiler ({wall:.3f} s): " + (
            f"{(kern + busy['copy_s']) / wall:.4%} (kernels {kern:.4f} s, "
            f"{kern / wall:.4%}; copies {busy['copy_s']:.4f} s, "
            f"{busy['copy_s'] / wall:.4%})"
            if kern else "no device time seen (not measured)"))
    log(f"cluster host split of a cProfile'd write round of "
        f"{CLUSTER_HOST_OBJECTS} objects ({host_s:.3f} s wall, "
        f"{split['total_s']:.3f} s profiled, the main thread): "
        + ", ".join(f"{k} {v:.3f} s" for k, v in split["by_bucket"].items())
        + "; cumulative: " + ", ".join(
            f"{k} {v:.3f} s" for k, v in
            split["functions_cumulative_s"].items())
        + "; most own time: " + ", ".join(
            f"{k} {v:.3f} s" for k, v in split["top_own_s"].items()))
    log(f"cluster launches by stage {stages}; the batchers' launches by "
        f"(kind, shape, erasures) {dict(launched)}; host oracle: "
        f"{oracle['shards_checked']} shards ({oracle['revived_shards_checked']}"
        f" on the revived osd.{drive.victim}) == the host encode, tags == "
        f"the host engine; {secs:.1f} s")
    return {"report": rep, "summary": summary, "launches": launches,
            "stages": stages, "launched": launched, "busy": busy,
            "split": split, "oracle": oracle,
            "kernels": kernels, "seconds": secs}


class StageMarks:
    """Launch counts and seconds by stage of a harness drive: ``mark(stage)``
    at the end of each stage (``run_workload``'s ``on_stage``).  The counts
    are set to 0 when the marks start."""

    def __init__(self) -> None:
        self.stages: dict[str, dict] = {}
        self.seconds: dict[str, float] = {}
        reset_launches()
        self._last = launch_counts()
        self._t = time.perf_counter()

    def mark(self, stage: str) -> None:
        now, t = launch_counts(), time.perf_counter()
        self.stages[stage] = {k: now[k] - self._last[k] for k in now
                              if now[k] != self._last[k]}
        self.seconds[stage] = t - self._t
        self._last, self._t = now, t


def launch_matrix(codec, kind: str, extra) -> tuple[np.ndarray, int]:
    """The GF(2^8) matrix of a batcher launch and the sub-chunk rows a
    chunk, as ``MeshCodec`` picks them: the parity for an encode or an RMW
    delta, the repair or decode matrix of the erasures for a decode."""
    from ceph_tpu_torch.parallel.mesh_codec import MeshCodec
    alpha = MeshCodec._alpha(codec)
    if kind in ("encode", "rmw"):
        mat = MeshCodec._parity_matrix(codec)
    elif MeshCodec._flat(codec):
        mat = codec.decode_flat_matrix(list(extra))
    else:
        mat = codec.decode_matrix_for(list(extra))
    return np.ascontiguousarray(mat, np.uint8), alpha


def harness_kernel(label: str, codec, key: tuple, n: int, dev: torch.device,
                   seed: int, phase: str = "harness") -> dict:
    """The kernel that serves a batcher launch shape ``key`` (kind, (B, k,
    L), extra) on its route (the cost model's, under the caller's
    ``CEPH_TPU_XOR_SCHED``) against its plain version on seeded data of
    that shape, two stripes against the host oracle; CUDA events."""
    from ceph_tpu_torch.ops import gf2kernels as gk
    from ceph_tpu_torch.ops import xor_schedule as xs
    kind, (b, k, l), extra = key
    mat, alpha = launch_matrix(codec, kind, extra)
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randint(0, 256, (b, k * alpha, l // alpha), dtype=torch.uint8,
                      device=dev, generator=gen)
    r = mat.shape[0]
    shape = (b, k * alpha, l // alpha, r)
    sched = xs.want_scheduled(gk.bitmatrix_i8(mat), l // alpha, "cuda")
    if sched is not None:
        name, g = "xor_sched", None
        kernel = lambda: xs.xor_sched(sched, x)  # noqa: E731
        plain = lambda v: xs.apply_bits_plain(sched, v)  # noqa: E731
    else:
        name, g = gk.dense_kernel_for(b, k * alpha, r, l // alpha)
        if name == "gf2_matmul_mma":
            w = torch.from_numpy(gk.w_gN_planemajor(mat, g)).to(dev)
            kernel = lambda: gk.gf2_matmul_mma(mat, x, g)  # noqa: E731
            plain = lambda v: gk.gf2_matmul_grouped_plain(w, v, g)  # noqa: E731
        else:
            w = torch.from_numpy(gk.bitmatrix_i8(mat)).to(dev)
            kernel = lambda: gk.gf2_matmul_popc(mat, x)  # noqa: E731
            plain = lambda v: gk.gf2_matmul_plain(w, v)  # noqa: E731
    got = kernel()
    plain_ms, err = plain_in_slices(plain, x, got)
    pick = [0, b - 1]
    host = host_stripes(mat, x, pick)
    if err or not all(np.array_equal(got[i].cpu().numpy(), h)
                      for i, h in zip(pick, host)):
        raise RuntimeError(f"{phase} {label}: {name} differs from its plain "
                           f"version ({err}) or the host oracle at {key}")
    ms = time_ms(kernel)
    log(f"{phase} {label} {kind}{list(extra) if kind == 'decode' else ''} at"
        f" the path's launch shape ({b}, {k * alpha}, {l // alpha}) -> {r} "
        f"({n} launches): {name} {ms:.4f} ms (CUDA events), plain "
        f"{plain_ms:.2f} ms, == its plain version and the host oracle")
    return {"name": name, "g": g, "shape": list(shape), "ms": ms,
            "plain_ms": plain_ms, "err": err, "launches": n, "sched": sched,
            "path": path_label(f"{phase} {label} {kind}", shape)}


def top_launches(shapes: collections.Counter) -> list:
    """The most frequent launch shape of each kind, with its count."""
    out = []
    for kind in ("encode", "rmw", "decode"):
        keys = [key for key in shapes if key[0] == kind]
        if keys:
            key = max(keys, key=lambda key: shapes[key])
            out.append((key, shapes[key]))
    return out


def pool_codec(cluster, pool_id: int):
    return next(pg.backend.codec for osd in cluster.osds
                # lint: disable=cross-daemon-state -- its own OSDs, one process
                if not osd.is_stopped() for pgid, pg in osd.pgs.items()
                if pgid.startswith(f"{pool_id}."))


def batcher_shapes(osds) -> collections.Counter:
    return sum((osd.codec_batcher.launch_shapes for osd in osds
                if osd.codec_batcher is not None), collections.Counter())


async def harness_oracle(cluster, pool_id: int, oids: list, k: int, m: int,
                         dev: torch.device) -> int:
    """Each of ``oids`` read back through librados; its stored shards on
    every OSD against the port's host encode of the bytes read (the
    ``isa`` plugin on the CPU, ``StripeInfo.encode`` of the zero-padded
    object), each CRC tag against the host engine's.  Returns the shards
    checked."""
    from ceph_tpu_torch import native
    from ceph_tpu_torch.client import Rados
    from ceph_tpu_torch.ec import registry
    from ceph_tpu_torch.osd.ec_util import StripeInfo
    isa = registry().factory("isa", {"k": str(k), "m": str(m),
                                     "technique": "reed_sol_van"})
    sinfo = StripeInfo.for_codec(isa, stripe_unit=CLUSTER_STRIPE_UNIT)
    rados = await Rados(cluster.addr, name="client.oracle",
                        device=dev).connect()
    checked = 0
    try:
        io = await rados.open_ioctx(
            # lint: disable=cross-daemon-state -- its own monitor, one process
            cluster.mon.osdmap.pools[pool_id].name)
        for oid in oids:
            data = bytes(await io.read(oid))
            pad = sinfo.logical_to_next_stripe_offset(len(data)) - len(data)
            want = sinfo.encode(isa, data + b"\0" * pad)
            shards = pool_shards(cluster, pool_id, oid)
            if sorted(s for _, s in shards) != list(range(k + m)):
                raise RuntimeError(f"harness: {oid} has shards "
                                   f"{sorted(shards)}, want one of each "
                                   f"of {k + m}")
            for (whoami, label), (raw, tag) in shards.items():
                if raw != want[label].tobytes() or tag != native.crc32c(raw):
                    raise RuntimeError(
                        f"harness: osd.{whoami}'s shard {label} of {oid} "
                        f"differs from the host encode of the bytes read, "
                        f"or its tag from the host engine's CRC")
                checked += 1
    finally:
        await rados.shutdown()
    return checked


def harness_loadgen(dev: torch.device) -> dict:
    """11a: ``run_workload`` at ``HARNESS_LOADGEN`` through the daemons'
    entry points on ``dev``: launches, tables built and map epochs by
    stage, the loop's stalls and the collector's pauses by stage, then on
    the live cluster ``scrub_ec`` of every PG, the host oracle on
    ``HARNESS_ORACLE_SAMPLE`` objects, K5 at the pool and the kernels at
    the path's launch shapes.  No profiler runs under the live cluster:
    its processing stalls the loop (5.2 s after a profiled steady stage on
    an H100 machine), and phase 10 reads the card's busy share of the same
    path."""
    import asyncio
    from ceph_tpu_torch.common.config import ConfigProxy
    from ceph_tpu_torch.loadgen import (WorkloadSpec, cluster_gates,
                                        degradation_ratios, run_workload)
    from ceph_tpu_torch.tools.ec_osd_bench import scrub_pool
    from ceph_tpu_torch.tools.loop_sampler import (GCClock, LoopLag,
                                                   StageCounts, mark_downs)
    spec = WorkloadSpec(**HARNESS_LOADGEN).validate()
    conf = ConfigProxy()
    marks = StageMarks()
    by_stage = StageCounts()
    lag = LoopLag()
    collector = GCClock()
    out: dict = {}

    live: dict = {}
    wedged: list[dict] = []

    def on_wedged(op, io) -> None:
        """Log a wedged op at once, while its primary still holds it: the
        op's class, object, PG and primary, the client's attempts, the
        primary's OpTracker dump and the map epochs."""
        cluster = live["cluster"]
        pgid, primary = io.objecter.calc_target(io.pool_id, op.oid)
        tried = [a["attempts"] for a in reversed(io.objecter.abandoned)
                 if a["oid"] == op.oid][:1]
        osd = next((o for o in cluster.osds if o.whoami == primary
                    and not o.is_stopped()), None)
        # lint: disable=hole-sentinel -- osd: a daemon or None
        dump = osd.op_tracker.dump_ops_in_flight() if osd else None
        ops = (dump or {}).get("ops", [])
        mine = [o for o in ops if o.get("oid") == op.oid]
        info = {"class": op.kind, "oid": op.oid, "pgid": pgid,
                "primary": primary, "attempts": tried[0] if tried else None,
                "client_epoch": io.objecter.osdmap.epoch,
                # lint: disable=cross-daemon-state -- its own monitor, one process
                "mon_epoch": cluster.mon.osdmap.epoch,
                "primary_ops_in_flight": (dump or {}).get("num_ops"),
                "on_its_pg": sum(o.get("pgid") == pgid for o in ops),
                "its_ops_on_primary": mine, "oldest_on_primary": ops[:3]}
        wedged.append(info)
        log(f"harness 11a wedged op: {json.dumps(info, default=str)}")

    async def on_stage(stage, cluster, report):
        live["cluster"] = cluster
        by_stage.mark(stage, cluster)
        lag.mark(HARNESS_NEXT_STAGE[stage])
        collector.mark(HARNESS_NEXT_STAGE[stage])
        if stage != "report":
            marks.mark(stage)
            return
        marks.mark("settle")
        out["mark_downs"] = mark_downs(cluster)
        # lint: disable=cross-daemon-state -- its own monitor, one process
        pool_id = cluster.mon.osdmap.pool_names[spec.pool]
        t0 = time.perf_counter()
        out["scrub"] = await scrub_pool(cluster, pool_id)
        out["scrub_s"] = time.perf_counter() - t0
        marks.mark("scrub")
        rng = np.random.default_rng(SEED + 110)
        sample = sorted(spec.object_name(int(i)) for i in rng.choice(
            spec.n_objects, HARNESS_ORACLE_SAMPLE, replace=False))
        out["oracle_shards"] = await harness_oracle(
            cluster, pool_id, sample, spec.ec_k, spec.ec_m, dev)
        out["sample"] = sample
        codec = pool_codec(cluster, pool_id)
        shapes = batcher_shapes(cluster.osds)
        out["launched"] = shapes
        out["kernels"] = [harness_kernel("11a", codec, key, n, dev,
                                         SEED + 111 + i)
                          for i, (key, n) in enumerate(top_launches(shapes))]
        # K5 at the pool's table against its plain version; the card's
        # table against the CPU's
        out["placement"] = pool_k5(cluster, pool_id, dev, "harness 11a")

    async def drive():
        lag.start().mark("boot")
        collector.mark("boot")
        try:
            return await run_workload(
                spec, conf=conf, log=lambda msg: log(f"  {msg}"), device=dev,
                on_stage=on_stage, on_wedged=on_wedged)
        finally:
            lag.stop()

    t0 = time.perf_counter()
    loop = asyncio.new_event_loop()
    try:
        report = loop.run_until_complete(drive())
    finally:
        loop.close()
        collector.stop()
    secs = time.perf_counter() - t0
    stalls = lag.summary()
    pauses = collector.summary()
    stages = {k: v for k, v in marks.stages.items() if k != "scrub"}
    launches: dict[str, int] = {}
    for counts in stages.values():
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n
    errors = cluster_gates(report)
    inter = report.get("interference") or {}
    counters = report["counters"]
    batch = counters["ec_batch"]
    for key in ("down_detected", "revived", "clean_after_revive"):
        if not inter.get(key):
            errors.append(f"interference {key} is {inter.get(key)}")
    if not counters["ec_degraded"].get("degraded_reads"):
        errors.append("no degraded read recorded")
    if not report["qos"]["final"].get("dispatched_recovery"):
        errors.append("no recovery op dispatched")
    rmw_runs = batch.get("rmw_delta_runs", 0) + batch.get("rmw_full_runs", 0)
    if not rmw_runs:
        errors.append("no RMW op reached the EC backend's partial-write path")
    n_scrubbed, bad = out["scrub"]
    if bad or not n_scrubbed:
        errors.append(f"scrub_ec: {n_scrubbed} objects, inconsistent {bad}")
    for name in ("gf2_matmul_mma", "crc32c_chunks", "crush_map_rule"):
        if not launches.get(name):
            errors.append(f"{name} never launched")
    longest = stalls.get("degraded", {}).get("max_s")
    if longest is None or longest >= HARNESS_STALL_LIMIT:
        errors.append(f"the loop stalled {longest} s in the degraded stage "
                      f"(limit {HARNESS_STALL_LIMIT} s, the heartbeat "
                      f"interval)")
    victims = {f"osd.{v}" for v in inter.get("victims", [])}
    healthy = [m for m in out["mark_downs"] if m.split()[0] not in victims]
    if healthy or not out["mark_downs"]:
        errors.append(f"mark-downs beyond the victims {sorted(victims)}: "
                      f"{out['mark_downs']}")
    phases = report["phases"]
    for name, ph in phases.items():
        t = ph["timing"]
        log(f"harness 11a {name}: {ph['ops']} ops in {t['elapsed_s']} s, "
            f"{t['ops_per_s']} ops/s, {t['GiBps']} GiB/s (host clock); "
            + "; ".join(f"{kind} p50 {lat['p50_s']} p95 {lat['p95_s']} p99 "
                        f"{lat['p99_s']} p99.9 {lat['p99_9_s']} s"
                        for kind, lat in t["latency"].items()))
    degr = {p: degradation_ratios(report, p) for p in ("degraded", "backfill")
            if p in phases}
    stripes_a_launch = (batch.get("stripes", 0) / batch["batches"]
                        if batch.get("batches") else 0.0)
    log(f"harness 11a ({spec.n_osds} OSDs, EC k={spec.ec_k},m={spec.ec_m} on "
        f"cuda, pg_num {spec.pg_num}, {spec.n_objects} objects lognormal "
        f"around {spec.obj_size >> 10} KiB, {spec.n_clients} clients): p99 "
        f"degradation {degr}; down detected in {inter.get('down_detect_s')} "
        f"s; bring-up {report['timing']['bringup_s']} s, total "
        f"{report['timing']['total_s']} s; scheduler dispatches "
        f"{ {p: {k: v for k, v in q.items() if k.startswith('dispatched')} for p, q in report['qos'].items()} }; "
        f"ec_batch {stripes_a_launch:.2f} stripes a launch over "
        f"{batch.get('batches', 0)} launches, RMW runs {rmw_runs} "
        f"(delta {batch.get('rmw_delta_runs', 0)}); degraded reads "
        f"{counters['ec_degraded'].get('degraded_reads')}; mark-downs "
        f"{len(out['mark_downs'])} (the victim's and any healthy OSD's: "
        f"{out['mark_downs']}); scrub "
        f"{n_scrubbed} objects clean in {out['scrub_s']:.2f} s; host oracle "
        f"{out['oracle_shards']} shards of {len(out['sample'])} objects")
    log(f"harness 11a tables built / map epochs / K5 launches by stage "
        f"{by_stage.stages}; the loop's stalls by stage (wake-ups, longest, "
        f"p99 s) {stalls}; the collector's pauses by stage {pauses}")
    log(f"harness 11a launches by stage {marks.stages}; seconds by stage "
        f"{ {k: round(v, 2) for k, v in marks.seconds.items()} }; the "
        f"batchers' launches by (kind, shape, erasures) "
        f"{dict(out['launched'].most_common(8))}; {secs:.1f} s")
    resends = {stage: {k: v for k, v in counts.items()
                       if k.startswith(("resend_", "dup_"))}
               for stage, counts in by_stage.stages.items()}
    steady_ops_s = phases["steady"]["timing"]["ops_per_s"]
    log(f"harness 11a resends by cause and duplicate reqids the PGs saw, by "
        f"stage {resends}; steady {steady_ops_s} ops/s; wedged ops "
        f"{len(wedged)}")
    if errors:
        raise RuntimeError(f"harness 11a: {errors}")
    return {"report": report, "launches": launches, "stages": stages,
            "resends": resends, "steady_ops_s": steady_ops_s,
            "wedged": wedged,
            "stage_s": marks.seconds, "degradation": degr,
            "stripes_a_launch": stripes_a_launch, "rmw_runs": rmw_runs,
            "kernels": out["kernels"], "placement": out["placement"],
            "oracle_shards": out["oracle_shards"], "scrub": out["scrub"],
            "mark_downs": out["mark_downs"], "counts": by_stage.stages,
            "stalls": stalls, "gc": pauses, "seconds": secs}


def harness_recovery(dev: torch.device) -> dict:
    """11b: ``recovery_bench`` at ``code_configs(smoke=False)`` and bench.py
    --recovery's sizes, each code on a cluster of its own on ``dev`` on the
    default routes (K1 serves PMSR, K2 RS and LRC), then the LRC and PMSR
    drives again under ``CEPH_TPU_XOR_SCHED=1`` (K3).  Launches a drive;
    the bench's gates; equal repair counters on both routes; the kernels at
    each drive's launch shapes."""
    import asyncio
    from ceph_tpu_torch.tools import recovery_bench as rb
    drives: dict[str, dict] = {}

    def drive(spec: dict, tag: str, env: str | None, seed: int) -> None:
        seen: dict = {}

        async def on_stage(stage, c, result):
            # lint: disable=cross-daemon-state -- its own monitor, one process
            pool_id = c.mon.osdmap.pool_names["recpool"]
            seen["codec"] = pool_codec(c, pool_id)
            seen["shapes"] = batcher_shapes(c.osds)

        loop = asyncio.new_event_loop()
        try:
            with xor_sched_env(env):
                reset_launches()
                t0 = time.perf_counter()
                res = loop.run_until_complete(rb.drive_code(
                    spec, **HARNESS_RECOVERY, device=dev, on_stage=on_stage,
                    log=lambda msg: log(f"  {msg}")))
                counts = {k: v for k, v in launch_counts().items() if v}
                secs = time.perf_counter() - t0
                kernels = [harness_kernel(f"11b {tag}", seen["codec"], key,
                                          n, dev, seed + i)
                           for i, (key, n) in
                           enumerate(top_launches(seen["shapes"]))]
        finally:
            loop.close()
        drives[tag] = {"result": res, "launches": counts, "seconds": secs,
                       "kernels": kernels}
        log(f"harness 11b {tag}: read/shipped {res['read_per_shipped']}x, "
            f"recovery {res['recovery_wall_s']} s, drive {secs:.1f} s, "
            f"launches {counts}")

    for i, spec in enumerate(rb.code_configs(smoke=False)):
        drive(spec, spec["name"], None, SEED + 120 + 10 * i)
    for i, spec in enumerate(rb.code_configs(smoke=False)):
        if spec["name"] in ("lrc", "pmsr"):
            drive(spec, f"{spec['name']} sched", "1", SEED + 160 + 10 * i)
    res = rb.recovery_summary(
        {name: drives[name]["result"] for name in ("rs", "lrc", "pmsr")},
        dict(HARNESS_RECOVERY))
    errors = rb.recovery_gates(res)
    counters = ("repair_bytes_read", "repair_bytes_shipped", "repair_reads",
                "repair_local_repairs", "repair_global_decodes",
                "repair_fragment_pulls")
    for name in ("lrc", "pmsr"):
        dense, sched = (drives[t]["result"] for t in (name, f"{name} sched"))
        if {k: dense[k] for k in counters} != {k: sched[k] for k in counters}:
            errors.append(f"{name}: repair counters differ between the "
                          f"routes: {dense} vs {sched}")
        if sched["mismatched"] or sched["errors"] or \
                not sched["recovered_clean"]:
            errors.append(f"{name} sched: {sched['mismatched']} "
                          f"{sched['errors']}")
        if not drives[f"{name} sched"]["launches"].get("xor_sched"):
            errors.append(f"{name} sched: xor_sched never launched")
    if not drives["pmsr"]["launches"].get("gf2_matmul_popc"):
        errors.append("pmsr: gf2_matmul_popc never launched")
    for name in ("rs", "lrc"):
        if not drives[name]["launches"].get("gf2_matmul_mma"):
            errors.append(f"{name}: gf2_matmul_mma never launched")
    if errors:
        raise RuntimeError(f"harness 11b: {errors}")
    codes = res["codes"]
    log(f"harness 11b (RS k=8,m=4 on cuda, LRC k=8,m=4,l=3, PMSR k=5,m=4; "
        f"{HARNESS_RECOVERY['n_objects']} objects of "
        f"{HARNESS_RECOVERY['obj_size'] >> 10} KiB, pg_num "
        f"{HARNESS_RECOVERY['pg_num']}): read/shipped rs "
        f"{codes['rs']['read_per_shipped']}x lrc "
        f"{codes['lrc']['read_per_shipped']}x pmsr "
        f"{codes['pmsr']['read_per_shipped']}x (lrc vs rs "
        f"{res['lrc_vs_rs_read_ratio']}x, pmsr read chunks "
        f"{res['pmsr_read_chunks']}); recovery wall "
        + ", ".join(f"{t} {d['result']['recovery_wall_s']} s"
                    for t, d in drives.items())
        + "; repair counters equal on both routes, every object intact")
    return {"summary": res, "drives": drives,
            "seconds": sum(d["seconds"] for d in drives.values())}


def harness_straggler(dev: torch.device) -> dict:
    """11c: ``straggler_bench`` at bench.py --straggler's non-smoke sizes on
    ``dev``, unhedged then hedged under one straggler schedule; its gates."""
    import asyncio
    from ceph_tpu_torch.tools import straggler_bench as sb
    n_osds, pg_num, n_objects, obj_bytes, _, n_clients = sb.FULL
    n_reads = HARNESS_STRAGGLER_READS
    reset_launches()
    t0 = time.perf_counter()
    loop = asyncio.new_event_loop()
    try:
        res = loop.run_until_complete(sb.run_straggler_bench(
            n_osds=n_osds, pg_num=pg_num, n_objects=n_objects,
            obj_bytes=obj_bytes, n_reads=n_reads, n_clients=n_clients,
            device=dev, log=lambda msg: log(f"  {msg}")))
    finally:
        loop.close()
    launches = {k: v for k, v in launch_counts().items() if v}
    secs = time.perf_counter() - t0
    errors = sb.straggler_gates(res)
    if not launches.get("gf2_matmul_mma"):
        errors.append("gf2_matmul_mma never launched")
    if errors:
        raise RuntimeError(f"harness 11c: {errors}")
    un, he = res["unhedged"], res["hedged"]
    log(f"harness 11c ({n_osds} OSDs, EC 2+1 on cuda, pg_num {pg_num}, "
        f"{n_objects} objects of {obj_bytes >> 10} KiB, {n_reads} reads from "
        f"{n_clients} clients, lognormal stragglers on {un['victims']}): p99 "
        f"{res['p99_unhedged_s']} s unhedged -> {res['p99_hedged_s']} s "
        f"hedged ({res['p99_speedup']}x), extra sub-reads "
        f"{res['extra_subread_ratio']}x, bytes {res['extra_byte_ratio']}x; "
        f"hedges fired {he['hedges_fired']}, won {he['hedges_won']}; "
        f"{un['ops_per_s']} / {he['ops_per_s']} ops/s; straggler delays "
        f"{un['straggler_delays']} / {he['straggler_delays']}, one schedule; "
        f"launches {launches}; {secs:.1f} s")
    return {"result": res, "launches": launches, "seconds": secs}


def harness_chaos(dev: torch.device) -> dict:
    """11d: ``tools/chaos.py --smoke`` on ``dev`` (one kill-last round at
    seed 7: write, kill, read every object back, byte-compared)."""
    from ceph_tpu_torch.tools import chaos
    reset_launches()
    t0 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = chaos.main(["--smoke", "--device", str(dev)])
    launches = {k: v for k, v in launch_counts().items() if v}
    secs = time.perf_counter() - t0
    for line in out.getvalue().splitlines():
        log(f"  {line}")
    if rc != 0 or not launches.get("gf2_matmul_mma"):
        raise RuntimeError(f"harness 11d: chaos --smoke exited {rc}, "
                           f"launches {launches}")
    log(f"harness 11d chaos --smoke: PASS, launches {launches}; {secs:.1f} s")
    return {"rc": rc, "launches": launches, "seconds": secs}


def phase_harness(dev: torch.device) -> dict:
    """Phase 11, the traffic and failure harness: 11a loadgen, 11b the
    recovery bench, 11c the straggler bench, 11d chaos."""
    out = {}
    with xor_sched_env(None):          # the cluster keeps its routing
        out["loadgen"] = harness_loadgen(dev)
    out["recovery"] = harness_recovery(dev)
    with xor_sched_env(None):
        out["straggler"] = harness_straggler(dev)
        out["chaos"] = harness_chaos(dev)
    log("phase 11 seconds: " + ", ".join(
        f"{name} {v['seconds']:.1f}" for name, v in out.items()))
    return out


def harness_summary(out: dict) -> dict:
    """What the kernels line reads of ``phase_harness``'s result, as JSON: the
    launches by sub-phase, the kernels at the path's shapes (a schedule by
    its XOR terms), 11a's K5 at the pool, the seconds."""
    def kernels(checks: list) -> list:
        return [{**d, "sched": None if d["sched"] is None
                 else {"n_terms": d["sched"].n_terms}} for d in checks]
    return {
        "loadgen": {"launches": out["loadgen"]["launches"],
                    "kernels": kernels(out["loadgen"]["kernels"]),
                    "placement": out["loadgen"]["placement"],
                    "resends": out["loadgen"]["resends"],
                    "steady_ops_s": out["loadgen"]["steady_ops_s"],
                    "seconds": out["loadgen"]["seconds"]},
        "recovery": {"drives": {tag: {"launches": d["launches"],
                                      "kernels": kernels(d["kernels"])}
                                for tag, d in out["recovery"]["drives"].items()},
                     "seconds": out["recovery"]["seconds"]},
        **{name: {"launches": out[name]["launches"],
                  "seconds": out[name]["seconds"]}
           for name in ("straggler", "chaos")}}


def phase_harness_process(schedules: dict) -> dict:
    """Phase 11 in a process of its own (``chip_smoke.py --harness``), as a
    user starts the harness: a fresh interpreter and heap, not the one
    phases 1-10 filled (its one event loop carries 97 daemons and clients).
    The kernels and host codecs are already built; the XOR schedules phase 1
    compiled go across in a file, so 11b's scheduled drives find them.  Its
    log lines are passed through; its last line is ``harness_summary``'s
    JSON.  The process is stopped on any way out."""
    import pickle
    import tempfile
    with tempfile.NamedTemporaryFile(suffix=".pkl", delete=False) as fh:
        pickle.dump(schedules, fh)
        path = fh.name
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), HARNESS_FLAG, path],
        stdout=subprocess.PIPE, text=True, cwd=os.path.dirname(
            os.path.abspath(__file__)))
    result = None
    try:
        for line in proc.stdout:
            if line.startswith(HARNESS_TAG):
                result = json.loads(line[len(HARNESS_TAG):])
            else:
                print(line, end="", flush=True)
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        os.unlink(path)
    if rc != 0 or result is None:
        raise RuntimeError(f"phase 11's process exited {rc}")
    return result


def harness_main(schedules_path: str | None) -> int:
    """``--harness [SCHEDULES]``: phase 11 alone on the card, its summary
    last.  Without the pickled schedules of phase 1, 11b's scheduled drives
    compile theirs at first use (seconds of host CSE on the loop)."""
    import pickle
    from ceph_tpu_torch.ops import _build
    from ceph_tpu_torch.ops import xor_schedule as xs
    if not torch.cuda.is_available():
        print("chip_smoke --harness: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions: fp32
    _build.build(_build.all_sources())       # built by phase 1: found
    if schedules_path:
        with open(schedules_path, "rb") as fh:
            for digest, sched in pickle.load(fh).items():
                xs._SCHEDULES.setdefault(digest, sched)
    out = phase_harness(torch.device("cuda", 0))
    print(HARNESS_TAG + json.dumps(harness_summary(out)), flush=True)
    return 0


def harness_paths(rows: list, harness: dict, mhz: float,
                  b1_rate: float) -> None:
    """Phase 11's launches on each kernel's row by sub-phase (the totals
    included), and its launch shapes' times and bounds beside the kernel
    that served them."""
    by_name = {row["name"]: row for row in rows}
    subs = {"harness 11a loadgen (phase 11)": harness["loadgen"]["launches"]}
    for tag, d in harness["recovery"]["drives"].items():
        subs[f"harness 11b recovery, {tag} (phase 11)"] = d["launches"]
    subs["harness 11c straggler (phase 11)"] = \
        harness["straggler"]["launches"]
    subs["harness 11d chaos --smoke (phase 11)"] = harness["chaos"]["launches"]
    for name, row in by_name.items():
        for label, counts in subs.items():
            n = counts.get(name, 0)
            row["launches"] += n
            row.setdefault("launches_by_path", {})[label] = n
    checks = list(harness["loadgen"]["kernels"])
    for d in harness["recovery"]["drives"].values():
        checks += d["kernels"]
    for d in checks:
        row = by_name[d["name"]]
        b, k, l, r = d["shape"]
        sched = d["sched"] and types.SimpleNamespace(**d["sched"])
        row.setdefault("ms_by_path", {})[d["path"]] = round(d["ms"], 4)
        row.setdefault("plain_ms_by_path", {})[d["path"]] = round(
            d["plain_ms"], 4)
        row.setdefault("bound_by_path", {})[d["path"]] = path_bound(
            (b, k, l, r), mhz, b1_rate, sched)
        row["max_abs_err"] = max(row["max_abs_err"], d["err"])
    p = harness["loadgen"]["placement"]
    row = by_name["crush_map_rule"]
    path = (f"harness 11a epoch table: indep x{p['numrep']}, {p['lanes']} "
            f"lanes, {p['n_osds']} OSDs")
    row["ms_by_path"][path] = round(p["ms"], 4)
    row["bound_by_path"][path] = placement_bound(
        p["lanes"], p["numrep"], mhz, (p["n_osds"], 1))
    row["max_abs_err"] = max(row["max_abs_err"], p["err"])


def card_label() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def apps_crc(label: str, nrows: int, dev: torch.device, seed: int,
             phase: str = "apps") -> dict:
    """K4 over ``nrows`` seeded rows of a stripe unit, a shape of phase
    12's or 13's fused CRCs, against its plain version and the host engine;
    CUDA events, the plain version by the host clock."""
    from ceph_tpu_torch.ops import crc32c_batch as crc
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows = torch.randint(0, 256, (nrows, CLUSTER_STRIPE_UNIT),
                         dtype=torch.uint8, device=dev, generator=gen)
    got = crc.to_uint32(crc.crc32c_chunks(rows))
    t0 = time.perf_counter()
    plain = crc.to_uint32(crc.crc32c_chunks_plain(rows))
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    host = crc.crc32c_rows(rows.cpu().numpy())
    if not (np.array_equal(got, plain) and np.array_equal(got, host)):
        raise RuntimeError(f"{phase} {label}: K4 differs from its plain "
                           f"version or the host engine at "
                           f"{tuple(rows.shape)}")
    ms = time_ms(lambda: crc.crc32c_chunks(rows))
    log(f"{phase} {label} K4 over {tuple(rows.shape)} CRC rows: {ms:.4f} ms "
        f"(CUDA events), plain {plain_ms:.1f} ms (host clock), == its plain "
        f"version and the host engine")
    return {"shape": list(rows.shape), "ms": ms, "plain_ms": plain_ms,
            "err": 0, "path": f"{phase} {label} CRC rows {tuple(rows.shape)}"}


def pool_k5(cluster, pool_id: int, dev: torch.device, label: str) -> dict:
    """K5 at a pool's table against its plain version, and the card's
    table against the CPU's; CUDA events."""
    from ceph_tpu_torch.mon import pg_mapping as pgm
    # lint: disable=cross-daemon-state -- its own monitor, one process
    omap = cluster.mon.osdmap
    pool = omap.pools[pool_id]
    weights = omap.osd_weights()
    seeds = pgm.pool_seeds(pool, dev)
    vc = pgm._vector_crush_for(omap.crush, pool.crush_rule, dev)
    rows5 = vc.map_device(seeds, pool.size, weights)
    plain5 = pgm._vector_crush_for(omap.crush, pool.crush_rule,
                                   torch.device("cpu")).map_device(
        seeds.cpu(), pool.size, weights)
    err = int((rows5.cpu().long() - plain5.long()).abs().max())
    cpu_map = type(omap).from_dict(omap.to_dict(), device="cpu")
    card, host_tab = (omap.placement_cache().tables()[pool_id],
                      cpu_map.placement_cache().tables()[pool_id])
    if err or not all(np.array_equal(a, b) for a, b in zip(card, host_tab)):
        raise RuntimeError(f"{label}: K5 differs from its plain version, or "
                           f"the card's table from the CPU's, at {pool.name}")
    ms = time_ms(lambda: vc.map_device(seeds, pool.size, weights))
    log(f"{label} K5 at {pool.name}'s {pool.pg_num} lanes x{pool.size} on "
        f"{len(omap.osds)} OSDs: {ms:.4f} ms (CUDA events), == its plain "
        f"version; the card's table == the CPU's")
    return {"pool": pool.name, "lanes": pool.pg_num, "numrep": pool.size,
            "n_osds": len(omap.osds), "err": err, "ms": ms}


def phase_apps(dev: torch.device) -> dict:
    """Phase 12: ``AppsDrive`` at its defaults through the applications' entry
    points, every daemon on ``dev``; launch counts by stage, set to 0 at the
    boot.  Checks: every read equals its oracle, no failed op, only the
    victim marked down, the scrub clean, the host oracle on sampled image
    objects, K2, K4 and K5 launched, the kernels at the path's launch
    shapes against their plain versions."""
    import asyncio
    import importlib.util
    from ceph_tpu_torch.tools.apps_drive import MIRROR_OSDS, AppsDrive
    from ceph_tpu_torch.tools.ec_osd_bench import (_delta, _sum_ec_batch,
                                                   occupancy)
    from ceph_tpu_torch.tools.loop_sampler import mark_downs
    card = card_label()
    crypto = importlib.util.find_spec("cryptography") is not None
    drive = AppsDrive(device=dev)
    out: dict = {}
    osds: list = []

    async def run():
        marks = StageMarks()
        await drive.boot()
        osds.extend(drive.cluster.osds)
        marks.mark("boot")
        await drive.rbd_create()
        await drive.rbd_write_read()
        marks.mark("12a write and read")
        await drive.rbd_bench_seq()
        marks.mark("12a sequential 4K")
        before = _sum_ec_batch(drive.cluster.osds)
        await drive.rbd_random()
        after = _sum_ec_batch(drive.cluster.osds)
        out["random_occupancy"] = occupancy(*(
            _delta(a, b) for a, b in zip(after, before)))
        marks.mark("12a random 4K")
        await drive.rbd_cached()
        marks.mark("12a cached 4K")
        await drive.rgw_start()
        await drive.rgw_put_get()
        await drive.rgw_versioning()
        await drive.rgw_swift()
        marks.mark("12d put, get, multipart")
        await drive.striper()
        await drive.striper_takeover()
        marks.mark("12c striper")
        await drive.kill()
        marks.mark("kill")
        await drive.rbd_degraded_read()
        marks.mark("12a degraded read")
        await drive.rgw_degraded_get()
        marks.mark("12d degraded get")
        await drive.revive()
        osds.append(drive.revived_osd())
        marks.mark("revive and recovery")
        await drive.scrub()
        marks.mark("scrub")
        if crypto:
            await drive.rbd_crypto()
            marks.mark("12a crypto")
        await drive.rbd_features()
        await drive.rbd_lock_takeover()
        await drive.rbd_migration()
        await drive.rbd_mirror()
        marks.mark("12b features")
        await drive.rgw_delete()
        marks.mark("12d delete")
        # after the last stage: a mark-down anywhere in the phase counts
        out["mark_downs"] = mark_downs(drive.cluster)
        out["site_mark_downs"] = [d for c in drive.sites
                                  for d in mark_downs(c)]
        out["occupancy"] = occupancy(*_sum_ec_batch(drive.cluster.osds))
        return marks

    t0 = time.perf_counter()
    loop = asyncio.new_event_loop()
    try:
        marks = loop.run_until_complete(run())
        secs = time.perf_counter() - t0
        rep = drive.report
        errors = []
        if rep["mismatches"]:
            errors.append(f"reads differ from their oracle: "
                          f"{rep['mismatches']}")
        if rep["failed_ops"]:
            errors.append(f"{rep['failed_ops']} failed ops: "
                          f"{rep['errors'][:5]}")
        if rep["scrub_inconsistent"] or not rep["scrub_objects"]:
            errors.append(f"scrub: {rep['scrub_objects']} objects, "
                          f"inconsistent {rep['scrub_inconsistent']}")
        downs = out["mark_downs"]
        if len(downs) != 1 or not downs[0].startswith(f"osd.{drive.victim} "):
            errors.append(f"mark-downs other than osd.{drive.victim}'s one: "
                          f"{downs}")
        if out["site_mark_downs"]:
            errors.append(f"mark-downs in the mirror's cluster: "
                          f"{out['site_mark_downs']}")
        by_sub: dict[str, dict] = {}
        for stage, counts in marks.stages.items():
            sub = by_sub.setdefault(APPS_SUBPHASE[stage], {})
            for name, n in counts.items():
                sub[name] = sub.get(name, 0) + n
        launches: dict[str, int] = {}
        for counts in by_sub.values():
            for name, n in counts.items():
                launches[name] = launches.get(name, 0) + n
        for name in ("gf2_matmul_mma", "crc32c_chunks", "crush_map_rule"):
            if not launches.get(name):
                errors.append(f"{name} never launched")
        if errors:
            raise RuntimeError(f"apps: {errors}")
        rng = np.random.default_rng(SEED + 120)
        objnos = sorted(int(i) for i in rng.choice(
            drive.image_bytes >> drive.order, APPS_ORACLE_SAMPLE,
            replace=False))
        oracle_shards = loop.run_until_complete(harness_oracle(
            drive.cluster, drive.pool_id,
            [f"{drive.image_prefix}.{n:016x}" for n in objnos], drive.k,
            drive.m, dev))
        codec = pool_codec(drive.cluster, drive.pool_id)
        shapes = batcher_shapes(osds)
        kernels = [harness_kernel("12", codec, key, n, dev, SEED + 121 + i,
                                  "apps")
                   for i, (key, n) in enumerate(top_launches(shapes))]
        # K4 where the path launches it: the fused CRCs of the write's
        # encode (data and parity rows); an RMW's shard CRCs are the host
        # engine's
        (enc_key, _), = [kn for kn in top_launches(shapes)
                         if kn[0][0] == "encode"]
        crcs = [apps_crc("12 encode", enc_key[1][0] * (drive.k + drive.m),
                         dev, SEED + 130)]
        placement = [pool_k5(drive.cluster, drive.pool_id, dev, "apps"),
                     # lint: disable=cross-daemon-state -- its own monitor, one process
                     pool_k5(drive.cluster, drive.cluster.mon.osdmap
                             .pool_names["rbd"], dev, "apps")]
    finally:
        loop.run_until_complete(drive.stop())
        loop.close()
    occ = out["occupancy"]
    gb = lambda key: f"{rep[key + '_GiBps']:.4f}"  # noqa: E731
    log(f"[{card}] 12a RBD on ec83 ({drive.n_osds} OSDs, RS k={drive.k},"
        f"m={drive.m} on cuda, pg_num {drive.pg_num}, a "
        f"{drive.image_bytes >> 20} MiB image of {1 << drive.order >> 20}"
        f" MiB objects, {drive.concurrency} in flight): write "
        f"{gb('rbd_write')}"
        f", read {gb('rbd_read')}, degraded read {gb('rbd_degraded_read')} "
        f"GiB/s (host clock, 4 MiB I/O); boot {rep['boot_s']:.2f} s, mark "
        f"down {rep['mark_down_s']:.2f} s, recovery {rep['recovery_s']:.2f} "
        f"s, scrub {rep['scrub_s']:.2f} s ({rep['scrub_objects']} objects, "
        f"clean)")
    for key, what in (("rbd_seq_4k", "sequential 4 KiB writes, one at a "
                       "time (rbd bench)"),
                      ("rbd_random_4k", f"random 4 KiB writes, "
                       f"{drive.concurrency} in flight"),
                      ("rbd_cached_4k", f"random 4 KiB writes through the "
                       f"ObjectCacher, {drive.concurrency} in flight")):
        r = rep[key]
        log(f"[{card}] 12a {what}: {r['ios']} IOs in {r['s']:.3f} s, "
            f"{r['iops']:.1f} IOPS, p50 {r['p50_ms']:.3f} ms, p99 "
            f"{r['p99_ms']:.3f} ms (host clock)")
    log(f"[{card}] 12a cache flush {rep['rbd_flush_s']:.3f} s "
        f"({rep['rbd_cache_stats']}); random 4K batching: "
        f"{out['random_occupancy']['stripes_per_launch']} stripes a launch "
        f"over {out['random_occupancy']['batches']} launches, flush reasons "
        f"{out['random_occupancy']['flush_reasons']}; the whole phase: "
        f"{occ['stripes_per_launch']} stripes a launch over "
        f"{occ['batches']} launches, flush reasons {occ['flush_reasons']}")
    log(f"[{card}] 12a crypto: " + (
        f"write {gb('crypto_write')}, read {gb('crypto_read')} GiB/s "
        f"({drive.crypto_bytes >> 20} MiB, AES-XTS on the host), wrong "
        f"passphrase refused" if crypto else
        "not run (no cryptography module on this machine)"))
    log(f"[{card}] 12b RBD features on rbd ({drive.feature_bytes >> 20} "
        f"MiB): snapshots, clone, copyup, flatten, rollback, resize, "
        f"discard, export, object map and fast_diff in "
        f"{rep['features_s']:.2f} s; exclusive lock broken, the deposed "
        f"holder's write refused ({rep['lock_fence']}); migration "
        f"{rep['migration_s']:.2f} s ({rep['migration_bytes']} B copied); "
        f"mirroring to {MIRROR_OSDS} OSDs {rep['mirror_s']:.2f} s "
        f"(snapshot mode objects {rep['mirror_snapshot_objects']}, journal "
        f"events {rep['mirror_journal_events']})")
    log(f"[{card}] 12c radosstriper on ec83 ({drive.file_bytes >> 20} MiB, "
        f"Layout() 4 MiB units): write {gb('striper_write')}, read "
        f"{gb('striper_read')}, two clients {gb('striper_two_clients_write')}"
        f" GiB/s (host clock); takeover fenced the old holder "
        f"({rep['striper_fence']})")
    log(f"[{card}] 12d RGW on ec83 ({drive.s3_objects} objects of "
        f"{drive.s3_bytes >> 20} MiB, {drive.s3_stripe >> 20} MiB "
        f"stripes): PUT {gb('s3_put')}, GET {gb('s3_get')}, multipart "
        f"{gb('s3_multipart')} (GET {gb('s3_multipart_get')}), degraded GET "
        f"{gb('s3_degraded_get')} GiB/s (host clock, loopback HTTP)")
    log(f"[{card}] phase 12 launches by sub-phase {by_sub}; by stage "
        f"{marks.stages}; seconds by stage "
        f"{ {k: round(v, 2) for k, v in marks.seconds.items()} }; the "
        f"batchers' launches by (kind, shape, erasures) "
        f"{dict(shapes.most_common(8))}; mark-downs {downs}; host oracle "
        f"{oracle_shards} shards of image objects {objnos} == the host "
        f"encode of the bytes read, tags == the host engine; {secs:.1f} s")
    return {"launches": launches, "by_subphase": by_sub,
            "kernels": [{**d, "sched": None} for d in kernels],
            "crc": crcs, "placement": placement, "card": card,
            "crypto": crypto, "seconds": secs,
            "report": {k: v for k, v in rep.items()
                       if k not in ("errors", "rbd_cache_stats")}}


def apps_main() -> int:
    """``--apps``: phase 12 alone on the card, its summary last."""
    from ceph_tpu_torch.ops import _build
    if not torch.cuda.is_available():
        print("chip_smoke --apps: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions: fp32
    _build.build(_build.all_sources())       # built by phase 1: found
    with xor_sched_env(None):                # the cluster keeps its routing
        out = phase_apps(torch.device("cuda", 0))
    print(APPS_TAG + json.dumps(out, default=str), flush=True)
    return 0


def apps_paths(rows: list, apps: dict, mhz: float, b1_rate: float) -> None:
    """Phase 12's launches on each kernel's row by sub-phase (the totals
    included), and its launch shapes' times and bounds beside the kernel
    that served them: the dense kernel, K4 at the fused CRC rows, K5 at
    both pools' tables."""
    by_name = {row["name"]: row for row in rows}
    for name, row in by_name.items():
        for sub in ("12a", "12b", "12c", "12d"):
            n = apps["by_subphase"].get(sub, {}).get(name, 0)
            row["launches"] += n
            row.setdefault("launches_by_path", {})[
                f"apps {sub} (phase 12)"] = n
    add_paths(by_name, apps, mhz, b1_rate, "apps")


def add_paths(by_name: dict, summary: dict, mhz: float, b1_rate: float,
              phase: str) -> None:
    """A phase's launch shapes (``kernels``, ``crc``, ``placement`` of its
    ``summary``) on the rows of the kernels that served them: times, plain
    versions' times, bounds and differences."""
    for d in summary["kernels"]:
        row = by_name[d["name"]]
        row.setdefault("ms_by_path", {})[d["path"]] = round(d["ms"], 4)
        row.setdefault("plain_ms_by_path", {})[d["path"]] = round(
            d["plain_ms"], 4)
        row.setdefault("bound_by_path", {})[d["path"]] = path_bound(
            tuple(d["shape"]), mhz, b1_rate)
        row["max_abs_err"] = max(row["max_abs_err"], d["err"])
    row = by_name["crc32c_chunks"]
    for c in summary["crc"]:
        nrows, l = c["shape"]
        row["ms_by_path"][c["path"]] = round(c["ms"], 4)
        row.setdefault("plain_ms_by_path", {})[c["path"]] = round(
            c["plain_ms"], 4)
        t_bytes = (nrows * l + 4 * nrows) / HBM_BYTES_PER_S * 1e3
        t_ops = nrows * l / (SMEM_LOOKUPS_PER_CLOCK * mhz * 1e6) * 1e3
        row["bound_by_path"][c["path"]] = {
            "bound_ms": round(max(t_bytes, t_ops), 4),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    row = by_name["crush_map_rule"]
    for p in summary["placement"]:
        path = (f"{phase} epoch table: {p['pool']} x{p['numrep']}, "
                f"{p['lanes']} lanes")
        row["ms_by_path"][path] = round(p["ms"], 4)
        row["bound_by_path"][path] = placement_bound(
            p["lanes"], p["numrep"], mhz, (p["n_osds"], 1))
        row["max_abs_err"] = max(row["max_abs_err"], p["err"])


def phase_fs(dev: torch.device, loop, beside) -> dict:
    """13a: ``FsDrive`` at its defaults, every daemon on ``dev``: CephFS on
    the RS k=8,m=3 data pool, MDS a and b, two mounts, the mgr; launch
    counts by step, set to 0 at the boot.  The timed steps (the files, the
    overwrites, the failover) run first; then ``beside()`` starts 13b's
    boot, which runs beside the untimed-rate steps (``cephfs_cli``,
    fs_mirror).  Checks: every read equals its oracle, no failed op, no
    mark-down, K2, K4 and K5 launched, the kernels at the path's launch
    shapes against their plain versions."""
    from ceph_tpu_torch.tools.fs_drive import MIRROR_OSDS, FsDrive
    from ceph_tpu_torch.tools.loop_sampler import mark_downs
    card = card_label()
    drive = FsDrive(device=dev)
    out: dict = {}

    async def run():
        marks = StageMarks()
        for stage, step in (("boot", drive.boot),
                            ("small files", drive.small_files),
                            ("large files", drive.big_write_read),
                            ("4 KiB overwrites", drive.overwrite),
                            ("caps", drive.caps),
                            ("MDS failover", drive.failover),
                            ("mgr", drive.mgr_check)):
            await step()
            marks.mark(stage)
        beside()
        for stage, step in (("cephfs_cli", drive.cli),
                            ("fs_mirror", drive.mirror)):
            await step()
            marks.mark(stage)
        out["mark_downs"] = mark_downs(drive.cluster)
        out["site_mark_downs"] = [d for c in drive.sites
                                  for d in mark_downs(c)]
        return marks

    t0 = time.perf_counter()
    try:
        marks = loop.run_until_complete(run())
        secs = time.perf_counter() - t0
        rep = drive.report
        errors = []
        if rep["mismatches"]:
            errors.append(f"checks failed: {rep['mismatches']}")
        if rep["failed_ops"]:
            errors.append(f"{rep['failed_ops']} failed ops: "
                          f"{rep['errors'][:5]}")
        if out["mark_downs"] or out["site_mark_downs"]:
            errors.append(f"mark-downs: {out['mark_downs']} "
                          f"{out['site_mark_downs']}")
        launches: dict[str, int] = {}
        for counts in marks.stages.values():
            for name, n in counts.items():
                launches[name] = launches.get(name, 0) + n
        for name in ("gf2_matmul_mma", "crc32c_chunks", "crush_map_rule"):
            if not launches.get(name):
                errors.append(f"{name} never launched")
        if errors:
            raise RuntimeError(f"fs: {errors}")
        codec = pool_codec(drive.cluster, drive.pool_id)
        shapes = batcher_shapes(drive.cluster.osds)
        kernels = [harness_kernel("13a", codec, key, n, dev, SEED + 141 + i,
                                  "fs")
                   for i, (key, n) in enumerate(top_launches(shapes))]
        (enc_key, _), = [kn for kn in top_launches(shapes)
                         if kn[0][0] == "encode"]
        crcs = [apps_crc("13a encode", enc_key[1][0] * (drive.k + drive.m),
                         dev, SEED + 150, phase="fs")]
        # lint: disable=cross-daemon-state -- its own monitor, one process
        omap = drive.cluster.mon.osdmap
        placement = [pool_k5(drive.cluster, omap.pool_names[p], dev, "fs")
                     for p in (drive.pool, "cephfs_metadata")]
    finally:
        loop.run_until_complete(drive.stop())
    lat = lambda r: (f"p50 {r['p50_ms']:.3f} ms, p99 "  # noqa: E731
                     f"{r['p99_ms']:.3f} ms")
    gb = lambda key: f"{rep[key + '_GiBps']:.4f}"  # noqa: E731
    c, o = rep["creates"], rep["overwrite_4k"]
    log(f"[{card}] 13a CephFS on {drive.pool} ({drive.n_osds} OSDs, RS "
        f"k={drive.k},m={drive.m} on cuda, pg_num {drive.pg_num}; "
        f"cephfs_metadata x3 pg_num {drive.rep_pg_num}; MDS a and b, two "
        f"mounts, the mgr with the balancer on; {drive.concurrency} in "
        f"flight): boot {rep['boot_s']:.2f} s; {drive.n_files} small files "
        f"in {drive.n_dirs} directories ({rep['small_bytes_total']} B, "
        f"lognormal around {drive.small_bytes >> 10} KiB): {c['iops']:.1f}"
        f" creates/s over {c['s']:.3f} s, {lat(c)}, read back "
        f"{rep['small_read_s']:.3f} s (host clock)")
    held = sum(v["s"] for k, v in rep["mds_spans"].items()
               if k.startswith("hold_"))
    log(f"[{card}] 13a the active MDS over the small files: its one "
        f"mutation lock held {held:.3f} s of {c['s']:.3f} s; spans (n, s, "
        f"mean ms) " + ", ".join(
            f"{k} {v['n']} {v['s']:.3f} {v['s'] / v['n'] * 1e3:.1f}"
            for k, v in rep["mds_spans"].items()) + " (host clock)")
    log(f"[{card}] 13a {drive.big_files} files of {drive.big_bytes >> 20} "
        f"MiB (4 MiB objects): write {gb('big_write')}, read "
        f"{gb('big_read')} GiB/s; {drive.overwrites} random 4 KiB "
        f"overwrites: {o['iops']:.1f} IOPS over {o['s']:.3f} s, {lat(o)}; "
        f"read after {gb('overwrite_read')} GiB/s (host clock)")
    log(f"[{card}] 13a caps: two mounts' appends coherent, rename, unlink "
        f"purged {rep['purged_objects']} objects, {rep['caps_s']:.2f} s; "
        f"MDS failover {rep['failover_from_to'][0]} -> "
        f"{rep['failover_from_to'][1]} in {rep['failover_s']:.2f} s, then "
        f"every file == its oracle at {gb('after_failover_read')} GiB/s "
        f"and a new mutation; beside 13b's boot: cephfs_cli put/get/ls in "
        f"processes of their own {rep['cli_s']:.2f} s, bytes == the "
        f"oracle's; fs_mirror of {rep['mirror_files']} files to "
        f"{MIRROR_OSDS} OSDs {rep['mirror_s']:.2f} s; mgr: "
        f"{rep['mgr']['osds_up']} OSDs up and in in the "
        f"scrape, epoch {rep['mgr']['epoch']}, op_w == the mgr's reports "
        f"<= the OSDs' counters, balancer upmap items "
        f"{rep['mgr']['balancer_upmap_items']} "
        f"({rep['mgr']['balancer_log'][-1:]})")
    log(f"[{card}] 13a launches by step {marks.stages}; seconds by step "
        f"{ {k: round(v, 2) for k, v in marks.seconds.items()} }; the "
        f"batchers' launches by (kind, shape, erasures) "
        f"{dict(shapes.most_common(8))}; {secs:.1f} s")
    return {"launches": launches, "stages": marks.stages,
            "seconds_by_step": marks.seconds,
            "kernels": [{**d, "sched": None} for d in kernels],
            "crc": crcs, "placement": placement, "card": card,
            "seconds": secs,
            "report": {k: v for k, v in rep.items() if k != "errors"}}


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Daemon:
    """A daemon process of the port (``python -m ceph_tpu_torch.tools.X``)
    whose standard output is read line by line: ``banner`` waits for a line
    with a word in it; the lines after it are kept, the last few shown
    when the daemon fails."""

    def __init__(self, proc, name: str) -> None:
        self.proc, self.name = proc, name
        self.lines: collections.deque = collections.deque(maxlen=40)
        self._drain = None

    @classmethod
    async def spawn(cls, name: str, tool: str, *argv: str) -> "Daemon":
        from ceph_tpu_torch.tools.fs_drive import spawn_tool
        return cls(await spawn_tool(tool, *argv, merge_errors=True), name)

    async def banner(self, word: str, timeout: float = VSTART_TIMEOUT) -> str:
        import asyncio

        async def find():
            while True:
                line = (await self.proc.stdout.readline()).decode()
                if not line:
                    raise RuntimeError(
                        f"vstart: {self.name} exited {await self.proc.wait()}"
                        f": {''.join(self.lines)[-2000:]}")
                self.lines.append(line)
                if word in line:
                    return line
        line = await asyncio.wait_for(find(), timeout)
        self._drain = asyncio.ensure_future(self._keep())
        return line

    async def _keep(self) -> None:
        while line := await self.proc.stdout.readline():
            self.lines.append(line.decode())

    async def end(self, sig=None) -> int:
        """Send ``sig`` (if given) once; the exit code."""
        import asyncio
        if sig is not None and self.proc.returncode is None:
            self.proc.send_signal(sig)
        rc = await asyncio.wait_for(self.proc.wait(), VSTART_TIMEOUT)
        if self._drain is not None:
            await self._drain
        return rc


def scrape_samples(text: str) -> dict:
    """A prometheus exposition's samples: {name{labels}: value}."""
    import re
    return {k: float(v) for k, v in re.findall(r"^(\S+) (\S+)$", text, re.M)
            if not k.startswith("#")}


class VstartCluster:
    """13b's daemons, as ``vstart`` starts them with one daemon a process: a
    monitor and ``VSTART["n_osds"]`` OSDs on BlockStores (``--hosts`` one a
    host), each process on ``dev``, and the exporter over their admin
    sockets, in a new directory under the temporary directory.  ``boot``
    runs on 13a's loop once 13a's timed steps are done, beside its
    ``cephfs_cli`` and fs_mirror steps."""

    def __init__(self, dev: torch.device) -> None:
        import tempfile
        self.tmp = tempfile.mkdtemp(prefix="vstart-")
        self.store = os.path.join(self.tmp, "store")
        self.asok = os.path.join(self.tmp, "asok")
        self.port = free_port()
        self.mon_addr = f"127.0.0.1:{self.port}"
        self.devarg = ("--device", dev.type)
        self.daemons: dict = {}
        self.rep: dict = {}

    async def start_osd(self, i: int) -> int:
        """OSD index ``i``'s process, up: its id."""
        d = await Daemon.spawn(
            f"osd index {i}", "vstart", "--role", "osd", "--mon-addr",
            self.mon_addr, "--osd-index", str(i), "--store", "block",
            "--hosts", str(VSTART["n_osds"]), "--store-dir", self.store,
            "--asok-dir", self.asok, *self.devarg)
        self.daemons[i] = d
        line = await d.banner("up (block store)")
        return int(line.split()[0].split(".")[1])

    async def boot(self) -> None:
        import asyncio
        t0 = time.perf_counter()
        mon = await Daemon.spawn("mon", "vstart", "--role", "mon",
                                 "--mon-port", str(self.port), "--store-dir",
                                 self.store, "--asok-dir", self.asok,
                                 *self.devarg)
        self.daemons["mon"] = mon
        await mon.banner("mon.0 at")
        # the exporter reads the admin sockets at each scrape: started
        # beside the OSDs, scraped after the writes
        self.daemons["exporter"] = await Daemon.spawn(
            "exporter", "exporter", "--asok-dir", self.asok, "--port", "0")
        ids = await asyncio.gather(*(self.start_osd(i)
                                     for i in range(VSTART["n_osds"])))
        self.rep["exporter_url"] = (await self.daemons["exporter"].banner(
            "exporter listening")).split()[-1]
        self.rep["whoami_by_index"] = dict(enumerate(ids))
        self.rep["boot_s"] = time.perf_counter() - t0

    async def stop_all(self) -> dict:
        """SIGTERM to every daemon still running, once: the exit codes."""
        import asyncio
        import signal
        rcs = {}
        for d in self.daemons.values():
            if d.proc.returncode is None:
                d.proc.send_signal(signal.SIGTERM)
        for name, d in list(self.daemons.items()):
            try:
                rcs[name] = await d.end()
            except asyncio.TimeoutError:
                d.proc.kill()
                rcs[name] = await d.proc.wait()
        return rcs

    def close(self) -> None:
        import shutil
        shutil.rmtree(self.tmp, ignore_errors=True)


def phase_vstart(vc: VstartCluster, booting, loop) -> dict:
    """13b, on ``vc``'s daemons once ``booting`` (``vc.boot()``, a task on
    ``loop``) is done: the CLIs in processes of their own; this process's
    client writes with a host oracle through an OSD process's SIGKILL and
    restart.  Checks: every CLI exits 0 and what it reads equals what was
    written, the exporter sees every OSD process up and ``ec_batch``
    batches in every process that is primary of a PG that took a write,
    every read equals its oracle, ``health`` reaches HEALTH_OK, only the
    killed OSD marked down, every daemon exits 0 on SIGTERM, sampled
    objects' shards on the BlockStores == the host encode.  The launches:
    each daemon process's own counts (``kernel launches`` on its admin
    socket) after the last step, the killed OSD's also just before its
    SIGKILL, and this process's client's; K2, K4 and K5 must each have
    launched in the daemons."""
    import asyncio
    import signal
    from ceph_tpu_torch.client import Rados
    from ceph_tpu_torch.common.admin_socket import admin_command
    from ceph_tpu_torch.rgw.client import S3Client
    from ceph_tpu_torch.tools.fs_drive import run_tool
    v = VSTART
    card = card_label()
    tmp, store, port = vc.tmp, vc.store, vc.port
    mon_addr, devarg = vc.mon_addr, vc.devarg
    rep, daemons, start_osd = vc.rep, vc.daemons, vc.start_osd
    dev = torch.device(devarg[1])
    rng = np.random.default_rng(SEED + 160)

    async def ceph(*words: str) -> str:
        return await run_tool("ceph_cli", "-m", mon_addr, *devarg, *words)

    async def launches_of(name: str) -> dict:
        return await admin_command(os.path.join(vc.asok, f"{name}.asok"),
                                   "kernel launches")

    async def run() -> None:
        await booting
        before = launch_counts()
        rados = await Rados(("127.0.0.1", port), name="client.phase",
                            device=dev).connect()
        try:
            await vstart_client(rados,
                                list(rep["whoami_by_index"].values()))
        finally:
            await rados.shutdown()
        rep["client_launches"] = {k: n - before[k]
                                  for k, n in launch_counts().items()}

    async def vstart_client(rados, ids: list) -> None:
        omap = lambda: rados.objecter.osdmap  # noqa: E731
        await poll_until(lambda: sum(omap().is_up(o) for o in ids)
                         == v["n_osds"], "every OSD up in the map")
        t1 = time.perf_counter()
        payload = rng.integers(0, 256, v["cli_bytes"], np.uint8).tobytes()
        src, dst = os.path.join(tmp, "put.bin"), os.path.join(tmp, "got.bin")
        with open(src, "wb") as f:
            f.write(payload)

        async def status() -> None:
            rep["status"], rep["osd_tree"] = await asyncio.gather(
                ceph("status"), ceph("osd", "tree"))
            if f"{v['n_osds']} up" not in rep["status"] or \
                    rep["osd_tree"].count(" up ") != v["n_osds"]:
                raise RuntimeError(f"vstart: status / osd tree: "
                                   f"{rep['status']}{rep['osd_tree']}")

        async def ec83() -> None:
            await ceph("osd", "erasure-code-profile", "set", "ec83",
                       f"k={v['k']}", f"m={v['m']}", "plugin=cuda")
            await ceph("osd", "pool", "create", "ec83", str(v["pg_num"]),
                       "erasure", "ec83")
            await asyncio.gather(rados_put_get(), rados_bench())

        async def rados_put_get() -> None:
            rargs = ("-m", mon_addr, *devarg)
            await run_tool("rados_cli", *rargs, "put", "ec83", "cli-obj",
                             src)
            await run_tool("rados_cli", *rargs, "get", "ec83", "cli-obj",
                             dst)
            with open(dst, "rb") as f:
                if f.read() != payload:
                    raise RuntimeError("vstart: rados_cli get differs from "
                                       "what rados_cli put wrote")

        async def rados_bench() -> None:
            rep["rados_bench"] = (await run_tool(
                "rados_cli", "-m", mon_addr, *devarg, "bench", "ec83",
                str(v["bench_s"]), "--obj-size", str(v["obj_bytes"]))).strip()

        async def rbd() -> None:
            await ceph("osd", "pool", "create", "rbd", str(v["pg_num"]),
                       "replicated")
            rargs = ("--mon", mon_addr, *devarg, "-p", "rbd")
            await run_tool("rbd_cli", *rargs, "create", "img", "--size",
                             v["rbd_size"])
            rep["rbd_bench"] = (await run_tool(
                "rbd_cli", *rargs, "bench", "img", "--io-size", "4K",
                "--io-total", v["rbd_total"])).strip()

        async def rgw() -> None:
            gargs = ("--mon", mon_addr, *devarg)
            user = json.loads(await run_tool(
                "rgw_cli", *gargs, "user", "create", "--uid", "phase",
                "--display-name", "Phase 13b"))
            gport = free_port()
            gw = await Daemon.spawn("rgw", "rgw_cli", *gargs, "serve",
                                    "--port", str(gport))
            daemons["rgw"] = gw
            await gw.banner("rgw listening")
            s3 = S3Client(("127.0.0.1", gport), user["access_key"],
                          user["secret"])
            body = rng.integers(0, 256, v["s3_bytes"], np.uint8).tobytes()
            await s3.create_bucket("b")
            t = time.perf_counter()
            await s3.put_object("b", "k", body)
            rep["s3_put_GiBps"] = len(body) / (time.perf_counter() - t) / GiB
            t = time.perf_counter()
            got = await s3.get_object("b", "k")
            rep["s3_get_GiBps"] = len(body) / (time.perf_counter() - t) / GiB
            if got != body:
                raise RuntimeError("vstart: the S3 GET differs from the PUT")

        # the chains of CLI processes that do not wait for each other, at
        # once
        await asyncio.gather(status(), ec83(), rbd(), rgw())
        rep["clis_s"] = time.perf_counter() - t1

        # the phase's own client: objects with a host oracle
        io = await rados.open_ioctx("ec83")
        src_objs: dict[str, bytes] = {}

        async def write(names) -> float:
            sem = asyncio.Semaphore(16)
            items = {n: rng.integers(0, 256, v["obj_bytes"], np.uint8)
                     .tobytes() for n in names}

            async def one(n, d):
                async with sem:
                    await asyncio.wait_for(io.write_full(n, d),
                                           VSTART_TIMEOUT)
            t = time.perf_counter()
            await asyncio.gather(*(one(n, d) for n, d in items.items()))
            dt = time.perf_counter() - t
            src_objs.update(items)
            return len(items) * v["obj_bytes"] / dt / GiB

        first = [f"obj-{i}" for i in range(v["objects"])]
        rep["write_GiBps"] = await write(first)
        # the exporter's scrape, before any daemon restarts
        host, eport = rep.pop("exporter_url").split("//")[1].split(
            "/")[0].split(":")
        from ceph_tpu_torch.tools.apps_drive import http_request
        status, _, body = await http_request((host, int(eport)), "GET",
                                             "/metrics")
        samples = scrape_samples(body.decode())
        names = [f"osd.{i}" for i in range(v["n_osds"])]
        up = [n for n in names
              if samples.get(f'ceph_daemon_up{{ceph_daemon="{n}"}}') == 1]
        pool_id = omap().pool_names["ec83"]
        bench_n = int(rep["rados_bench"].split()[1])
        written = first + ["cli-obj"] + [f"bench_{i}" for i in range(bench_n)]
        primaries = sorted({omap().pg_primary(omap().pg_to_up_acting(
            pool_id, omap().object_to_pg(pool_id, o)[1])[1])
            for o in written})
        index_of = {w: i for i, w in rep["whoami_by_index"].items()}
        batches = {w: int(samples.get(
            f'ceph_ec_batch_batches{{ceph_daemon="osd.{i}"}}', 0.0))
            for i, w in rep["whoami_by_index"].items()}
        rep["exporter"] = {"status": status, "up": len(up),
                           "batches_by_osd": batches, "primaries": primaries}
        idle = [p for p in primaries if not batches[p]]
        if status != 200 or len(up) != v["n_osds"] or idle:
            raise RuntimeError(f"vstart: the exporter's scrape: HTTP "
                               f"{status}, {len(up)} of {v['n_osds']} up, "
                               f"primaries without an ec_batch batch "
                               f"{idle}")

        # SIGKILL a shard holder of obj-0 that is not its primary
        _, ps = omap().object_to_pg(pool_id, "obj-0")
        _, acting = omap().pg_to_up_acting(pool_id, ps)
        primary = omap().pg_primary(acting)
        victim = next(o for o in acting if o != primary)
        rep["victim"] = victim
        vd = daemons[index_of[victim]]
        by_process = {f"osd.{victim} until its SIGKILL":
                      await launches_of(f"osd.{index_of[victim]}")}
        t = time.perf_counter()
        await vd.end(signal.SIGKILL)
        await poll_until(lambda: not omap().is_up(victim),
                         f"osd.{victim} marked down")
        rep["mark_down_s"] = time.perf_counter() - t
        rep["degraded_write_GiBps"] = await write(
            [f"obj-{i}" for i in range(v["objects"],
                                       v["objects"] + v["more"])])
        t = time.perf_counter()
        await start_osd(index_of[victim])
        for _ in range(int(VSTART_TIMEOUT / 0.5)):
            health = await rados.mon_command("health", {})
            if health["status"] == "HEALTH_OK":
                break
            await asyncio.sleep(0.5)
        else:
            raise RuntimeError(f"vstart: health never reached HEALTH_OK: "
                               f"{health}")
        rep["recovery_s"] = time.perf_counter() - t
        health_cli = asyncio.ensure_future(ceph("health"))
        sem = asyncio.Semaphore(16)
        bad = []

        async def check(n):
            async with sem:
                if await asyncio.wait_for(io.read(n), VSTART_TIMEOUT) \
                        != src_objs[n]:
                    bad.append(n)
        t = time.perf_counter()
        await asyncio.gather(*(check(n) for n in src_objs))
        rep["read_GiBps"] = len(src_objs) * v["obj_bytes"] / (
            time.perf_counter() - t) / GiB
        if bad:
            raise RuntimeError(f"vstart: reads differ from the oracle: {bad}")
        rep["health"] = (await health_cli).strip()
        if "HEALTH_OK" not in rep["health"]:
            raise RuntimeError(f"vstart: ceph_cli health: {rep['health']}")
        log_tail = await rados.mon_command("log last", {"n": 10000})
        rep["mark_downs"] = [e["message"] for e in log_tail
                             if "marked down" in e.get("message", "")]
        if len(rep["mark_downs"]) != 1 or \
                not rep["mark_downs"][0].startswith(f"osd.{victim} "):
            raise RuntimeError(f"vstart: mark-downs other than "
                               f"osd.{victim}'s one: {rep['mark_downs']}")
        # every daemon's launches, after the last step (the OSDs' admin
        # sockets are named by index)
        by_process["mon.0"] = await launches_of("mon.0")
        for i, whoami in rep["whoami_by_index"].items():
            by_process[f"osd.{whoami}"] = await launches_of(f"osd.{i}")
        rep["launches_by_process"] = by_process
        rep["at_stop"] = await map_at_stop(rados, "ec83")
        rep["oracle"] = {"pool_id": pool_id, "objects": src_objs,
                         "pgs": {n: omap().pg_name(
                             pool_id, omap().object_to_pg(pool_id, n)[1])
                             for n in src_objs}}

    async def map_at_stop(rados, pool: str) -> dict:
        """The monitor's ``osd dump`` (epoch E) and the client's up set of
        every PG of ``pool`` in its own map at E, read once the two agree
        on E."""
        omap = lambda: rados.objecter.osdmap  # noqa: E731
        for _ in range(10):
            dump = await rados.mon_command("osd dump", {})
            await poll_until(lambda: omap().epoch >= dump["epoch"],
                             f"the client's map at epoch {dump['epoch']}")
            m = omap()
            if m.epoch == dump["epoch"]:
                pid = m.pool_names[pool]
                return {"dump": dump, "pool_id": pid, "up": [
                    m.pg_to_up_acting(pid, ps)[0]
                    for ps in range(m.pools[pid].pg_num)]}
        raise RuntimeError("vstart: the monitor's map kept moving past the "
                           "client's")

    async def poll_until(cond, what: str) -> None:
        deadline = time.monotonic() + VSTART_TIMEOUT
        while not cond():
            if time.monotonic() > deadline:
                raise RuntimeError(f"vstart: timed out waiting for {what}")
            await asyncio.sleep(0.1)

    t0 = time.perf_counter()
    try:
        loop.run_until_complete(run())
    finally:
        rcs = loop.run_until_complete(vc.stop_all())
    if any(rc != 0 for rc in rcs.values()):
        raise RuntimeError(f"vstart: daemons' exit codes on SIGTERM {rcs}")
    checked = vstart_shards(rep, store)
    offline = vstart_offline(rep.pop("at_stop"), store, tmp, dev)
    secs = time.perf_counter() - t0
    daemons_sum: dict[str, int] = {}
    for counts in rep["launches_by_process"].values():
        for name, n in counts.items():
            daemons_sum[name] = daemons_sum.get(name, 0) + n
    idle = [name for name in ("gf2_matmul_mma", "crc32c_chunks",
                              "crush_map_rule") if not daemons_sum.get(name)]
    if idle:
        raise RuntimeError(f"vstart: never launched in the daemons' "
                           f"processes: {idle}")
    launches = {name: n + rep["client_launches"].get(name, 0)
                for name, n in daemons_sum.items()}
    log(f"[{card}] 13b vstart, one daemon a process: a monitor and "
        f"{v['n_osds']} OSDs on BlockStores (--hosts {v['n_osds']}), each "
        f"on {dev.type}, up in {rep['boot_s']:.2f} s (beside 13a's "
        f"cephfs_cli and fs_mirror); then in "
        f"{secs:.1f} s: ceph_cli (EC profile "
        f"k={v['k']},m={v['m']} plugin=cuda, pool ec83 pg_num {v['pg_num']},"
        f" status, osd tree, pool rbd), rados_cli put/get and bench "
        f"({rep['rados_bench']}), rbd_cli create and bench "
        f"({rep['rbd_bench']}), rgw_cli user create and serve (PUT "
        f"{rep['s3_put_GiBps']:.4f}, GET {rep['s3_get_GiBps']:.4f} GiB/s of "
        f"{v['s3_bytes'] >> 20} MiB over loopback HTTP) in "
        f"{rep['clis_s']:.2f} s")
    nonzero = lambda d: {k: n for k, n in d.items() if n}  # noqa: E731
    log(f"[{card}] 13b exporter after the first {v['objects']} writes: "
        f"{rep['exporter']['up']} OSD processes up; ec_batch batches by OSD "
        f"{rep['exporter']['batches_by_osd']}; primaries that took a write "
        f"{rep['exporter']['primaries']}")
    log(f"[{card}] 13b kernel launches, each process's wrappers' counts "
        f"read from its admin socket after the last step: "
        f"{ {p: nonzero(c) for p, c in rep['launches_by_process'].items()} }"
        f"; this process's client {nonzero(rep['client_launches'])}; in "
        f"all {nonzero(launches)} (the CLIs' processes' are not read: "
        f"they exit first)")
    log(f"[{card}] 13b client: {v['objects']} objects of "
        f"{v['obj_bytes'] >> 20} MiB written at {rep['write_GiBps']:.4f} "
        f"GiB/s (phase 10, one process: 0.0246), osd.{rep['victim']}'s "
        f"process SIGKILLed, marked down in {rep['mark_down_s']:.2f} s, "
        f"{v['more']} more written at {rep['degraded_write_GiBps']:.4f} "
        f"GiB/s, restarted on its BlockStore and HEALTH_OK in "
        f"{rep['recovery_s']:.2f} s, all {v['objects'] + v['more']} read at "
        f"{rep['read_GiBps']:.4f} GiB/s == the oracle (host clock); "
        f"mark-downs {rep['mark_downs']}; every daemon exited 0 on SIGTERM;"
        f" {checked} shards of {VSTART_ORACLE_SAMPLE} sampled objects on "
        f"the BlockStores == the host encode, tags == the host engine")
    log(f"[{card}] 13b offline, the monitor's store after every daemon "
        f"exited: monstore_tool dump-versions ({offline['versions']} "
        f"versions) and get-osdmap (epoch {offline['final_epoch']}; epochs "
        f"the shutdown committed after the client's last "
        f"{offline['later_epochs']}); the incrementals replayed by "
        f"get-version up to epoch {offline['epoch']} == that epoch's osd "
        f"dump; osdmaptool --test-map-pgs --device {dev.type} on the "
        f"replayed map ({offline['pg_count']}) gave all "
        f"{offline['pool_pgs']} ec83 PGs the client's up set at that epoch, "
        f"K5 launches {offline['k5_launches']}; in "
        f"{offline['seconds']:.3f} s (host clock, at most "
        f"{VSTART_OFFLINE_S:.0f} s)")
    rep.pop("oracle")
    rep["offline"] = offline
    launches["crush_map_rule"] = launches.get("crush_map_rule", 0) + \
        offline["k5_launches"]
    return {"launches": launches, "seconds": secs, "card": card,
            "shards_checked": checked, "report": rep}


def tool_output(main, *args) -> str:
    """An offline tool's standard output (of ``main(*args)``); a non-zero
    exit raises."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(*args)
    if rc:
        raise RuntimeError(f"vstart: {main.__module__} {args} exited {rc}")
    return buf.getvalue()


def vstart_offline(at_stop: dict, store: str, tmp: str,
                   dev: torch.device) -> dict:
    """13b's offline hook, on the monitor's store once every daemon has
    exited: ``monstore_tool`` dumps its versions and replays its log
    (``get-osdmap``); the incrementals read one by one with
    ``get-version`` and applied up to the epoch E recorded before the stop
    must rebuild E's ``osd dump`` exactly; that map, written to a file and
    mapped by ``osdmaptool --test-map-pgs`` on ``dev`` (K5 on the card),
    must give every PG of the pool the up set the client held at E.  The
    final replayed map is compared with E's dump only when the shutdown
    committed no epoch after E.  A mismatch, no K5 launch on the card, or
    more than ``VSTART_OFFLINE_S`` seconds raises."""
    from ceph_tpu_torch.mon.osdmap import Incremental, OSDMap
    from ceph_tpu_torch.tools import monstore_tool, osdmaptool
    t0, before = time.perf_counter(), launch_counts()
    dump, epoch = at_stop["dump"], at_stop["dump"]["epoch"]
    plain = lambda d: json.loads(json.dumps(d))  # noqa: E731
    db = os.path.join(store, "mon.db")
    versions = [int(line.split()[1]) for line in tool_output(
        monstore_tool.main, [db, "dump-versions"]).splitlines()
        if line.startswith("version ")]
    final = json.loads(tool_output(monstore_tool.main, [db, "get-osdmap"]))
    m, later = OSDMap(device="cpu"), []
    for v in versions:
        inc = Incremental.from_dict(json.loads(tool_output(
            monstore_tool.main, [db, "get-version", str(v)])))
        if inc.epoch > epoch:
            later.append(inc.epoch)
        else:
            m.apply_incremental(inc)
    if m.epoch != epoch or plain(m.to_dict()) != plain(dump):
        raise RuntimeError(f"vstart: the monitor's store replayed to epoch "
                           f"{m.epoch} differs from epoch {epoch}'s osd dump")
    if final["epoch"] != (later[-1] if later else epoch) or (
            not later and plain(final) != plain(dump)):
        raise RuntimeError(f"vstart: get-osdmap gave epoch "
                           f"{final['epoch']}, the incrementals {epoch} "
                           f"then {later}")
    path = os.path.join(tmp, "replayed-osdmap.json")
    with open(path, "w") as f:
        json.dump(m.to_dict(), f)
    # osdmaptool --test-map-pgs --device DEV, its map kept to read the PGs
    mapped = osdmaptool.load_map(path, device=dev.type)
    printed = tool_output(osdmaptool.cmd_test_map_pgs, mapped, None)
    pid, want = at_stop["pool_id"], at_stop["up"]
    got = [mapped.pg_to_up_acting(pid, ps)[0] for ps in range(len(want))]
    wrong = [ps for ps, (g, w) in enumerate(zip(got, want)) if g != w]
    if wrong or len(want) != mapped.pools[pid].pg_num:
        raise RuntimeError(f"vstart: the replayed map maps PGs {wrong} of "
                           f"pool {pid} off the client's up sets")
    k5 = launch_counts()["crush_map_rule"] - before["crush_map_rule"]
    secs = time.perf_counter() - t0
    if (dev.type == "cuda" and k5 < 1) or secs > VSTART_OFFLINE_S:
        raise RuntimeError(f"vstart: the offline hook launched K5 {k5} "
                           f"times in {secs:.2f} s")
    return {"versions": len(versions), "epoch": epoch,
            "final_epoch": final["epoch"], "later_epochs": later,
            "pg_count": printed.splitlines()[0], "pool_pgs": len(want),
            "k5_launches": k5, "seconds": secs}


def vstart_shards(rep: dict, store: str) -> int:
    """``VSTART_ORACLE_SAMPLE`` of 13b's objects: their shards on every
    OSD's BlockStore, opened here after the daemons exited, against the
    port's host encode (the ``isa`` plugin, ``StripeInfo.encode``) and each
    CRC tag against the host engine's.  Returns the shards checked."""
    from ceph_tpu_torch import native
    from ceph_tpu_torch.ec import registry
    from ceph_tpu_torch.os.blockstore import BlockStore
    from ceph_tpu_torch.osd.backend import CRC_XATTR, SHARD_XATTR
    from ceph_tpu_torch.osd.ec_util import StripeInfo
    v, oracle = VSTART, rep["oracle"]
    isa = registry().factory("isa", {"k": str(v["k"]), "m": str(v["m"]),
                                     "technique": "reed_sol_van"})
    sinfo = StripeInfo.for_codec(isa, stripe_unit=CLUSTER_STRIPE_UNIT)
    rng = np.random.default_rng(SEED + 161)
    sample = sorted(rng.choice(sorted(oracle["objects"]),
                               VSTART_ORACLE_SAMPLE, replace=False))
    stores = []
    for i in range(v["n_osds"]):
        bs = BlockStore(os.path.join(store, f"osd{i}"))
        bs.mount()
        stores.append((rep["whoami_by_index"][i], bs))
    checked = 0
    try:
        for oid in sample:
            coll = f"pg_{oracle['pgs'][oid]}"
            data = oracle["objects"][oid]
            pad = sinfo.logical_to_next_stripe_offset(len(data)) - len(data)
            want = sinfo.encode(isa, data + b"\0" * pad)
            labels = []
            for whoami, bs in stores:
                if not bs.exists(coll, oid):
                    continue
                label = int(bs.getattr(coll, oid, SHARD_XATTR))
                raw = bytes(bs.read(coll, oid, 0, None))
                tag = bs.getattr(coll, oid, CRC_XATTR)
                if raw != want[label].tobytes() or \
                        int(tag) != native.crc32c(raw):
                    raise RuntimeError(
                        f"vstart: osd.{whoami}'s shard {label} of {oid} "
                        f"differs from the host encode, or its tag from "
                        f"the host engine's")
                labels.append(label)
                checked += 1
            if sorted(labels) != list(range(v["k"] + v["m"])):
                raise RuntimeError(f"vstart: {oid} has shards "
                                   f"{sorted(labels)} on the BlockStores")
    finally:
        for _, bs in stores:
            bs.umount()
    return checked


def phase_subprocess(flag: str, tag: str, number: int) -> dict:
    """Phase ``number`` in a process of its own (``chip_smoke.py FLAG``), as
    a user starts it: a fresh interpreter and heap.  The kernels are
    already built.  Its log lines are passed through; its last line is its
    summary as JSON (after ``tag``).  The process is stopped on any way
    out."""
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), flag],
        stdout=subprocess.PIPE, text=True, cwd=os.path.dirname(
            os.path.abspath(__file__)))
    result = None
    try:
        for line in proc.stdout:
            if line.startswith(tag):
                result = json.loads(line[len(tag):])
            else:
                print(line, end="", flush=True)
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if rc != 0 or result is None:
        raise RuntimeError(f"phase {number}'s process exited {rc}")
    return result


def fs_main() -> int:
    """``--fs``: phase 13 alone on the card, its summary last."""
    import asyncio
    from ceph_tpu_torch.ops import _build
    if not torch.cuda.is_available():
        print("chip_smoke --fs: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions: fp32
    _build.build(_build.all_sources())       # built by phase 1: found
    dev = torch.device("cuda", 0)
    loop = asyncio.new_event_loop()
    vc = VstartCluster(dev)
    booting = []                             # 13b's boot, once begun

    def begin() -> None:
        booting.append(loop.create_task(vc.boot()))
    try:
        with xor_sched_env(None):            # the clusters keep their routing
            fs = phase_fs(dev, loop, begin)
            vstart = phase_vstart(vc, booting[0], loop)
    finally:
        for task in booting:
            if not task.done():
                task.cancel()
        loop.run_until_complete(asyncio.gather(*booting, vc.stop_all(),
                                               return_exceptions=True))
        vc.close()
        loop.close()
    print(FS_TAG + json.dumps({"fs": fs, "vstart": vstart}, default=str),
          flush=True)
    return 0


def fs_paths(rows: list, fs: dict, mhz: float, b1_rate: float) -> None:
    """Phase 13's launches on each kernel's row by sub-phase (the totals
    included; 13b's are the daemon processes' own counts, read from their
    admin sockets, and its client's), and 13a's launch shapes' times and
    bounds beside the
    kernel that served them: the dense kernel, K4 at the fused CRC rows, K5
    at both pools' tables."""
    by_name = {row["name"]: row for row in rows}
    for sub, counts in (("13a", fs["fs"]["launches"]),
                        ("13b", fs["vstart"]["launches"])):
        for name, row in by_name.items():
            n = counts.get(name, 0)
            row["launches"] += n
            row.setdefault("launches_by_path", {})[
                f"fs {sub} (phase 13)"] = n
    add_paths(by_name, fs["fs"], mhz, b1_rate, "fs")


def sm_clock_mhz_under(fn, launches: int = 1500) -> tuple[float, str]:
    """The SM clock nvidia-smi reads while ``fn``'s launches run."""
    for _ in range(launches):
        fn()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    torch.cuda.synchronize()
    now, peak = (v.strip() for v in smi.stdout.splitlines()[0].split(","))
    return (float(now), "clocks.sm under load") if now.isdigit() \
        else (float(peak), "clocks.max.sm")


def plain_in_slices(plain, data: torch.Tensor, out: torch.Tensor,
                    slice_b: int = 64) -> tuple[float, int]:
    """A plain version over the whole input in slices of stripes (a full-size
    bit-plane tensor would not fit): its device time, and its largest
    difference from the kernel's ``out``."""
    plain(data[:slice_b])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    refs = [plain(data[i:i + slice_b]) for i in range(0, data.shape[0], slice_b)]
    end.record()
    end.synchronize()
    err = max(int((out[i:i + slice_b].int() - ref.int()).abs().max())
              for i, ref in zip(range(0, data.shape[0], slice_b), refs))
    return start.elapsed_time(end), err


def path_bound(shape: tuple, mhz: float, b1_rate: float, sched=None) -> dict:
    """The least time for a GF(2^8) product of shape (B, k, L) -> r rows:
    the larger of its bytes (each input read once, each output written once)
    and the fewest operations known for it, the least of: K3's XOR terms a
    32-byte column (where the schedule is compiled) on the INT32 lanes; the
    b1 m16n8k256 MMAs its 8r x 8k bits need, at the measured mma.sync b1
    rate (no data sheet gives one; one instruction's issue rate, not a peak,
    so this term may read high); its int8 products 2*8r*8k a byte column at
    the int8 peak."""
    b, k, l, r = shape
    t_bytes = b * (k + r) * l / HBM_BYTES_PER_S * 1e3
    ops = {"int8 products": 2 * (8 * r) * (8 * k) * b * l / INT8_OPS_PER_S * 1e3,
           "b1 MMAs at the mma.sync rate": b * l * (8 * r) * (8 * k) / (16 * 8 * 256)
           / (b1_rate * SMS * mhz * 1e6) * 1e3}
    if sched is not None:
        ops["XOR terms"] = sched.n_terms * b * -(-l // 32) / (
            INT32_OPS_PER_CLOCK * mhz * 1e6) * 1e3
    ops_by, t_ops = min(ops.items(), key=lambda kv: kv[1])
    return {"bound_ms": round(max(t_bytes, t_ops), 4),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_ms": round(t_bytes, 4), "ops_ms": round(t_ops, 4),
            "ops_by": ops_by}


def path_label(name: str, shape: tuple) -> str:
    b, k, l, r = shape
    return f"{name} ({b},{k},{l})->{r}"


def cluster_paths(rows: list, cluster: dict, mhz: float,
                  b1_rate: float) -> None:
    """Phase 10's launches on each kernel's row (the totals included), and
    its launch shapes' times and bounds beside the kernel that served
    them: the dense kernel at the write's encode and the degraded read's
    decode, K4 over the write's CRC rows, K5 at the pool's table."""
    by_name = {row["name"]: row for row in rows}
    label = (f"cluster, {CLUSTER['n_osds']} OSDs RS {CLUSTER['k']}/"
             f"{CLUSTER['m']} (phase 10)")
    for name, row in by_name.items():
        n = cluster["launches"].get(name, 0)
        row["launches"] += n
        row.setdefault("launches_by_path", {})[label] = n
    kern = cluster["kernels"]
    for key in [k for k in kern if k.startswith(("encode", "decode"))]:
        d = kern[key]
        row = by_name[d["name"]]
        shape = (*d["shape"], d["r"])
        path = path_label(f"cluster rs8/3 {key}", shape)
        row["ms_by_path"][path] = round(d["ms"], 4)
        row.setdefault("plain_ms_by_path", {})[path] = round(d["plain_ms"], 4)
        row["bound_by_path"][path] = path_bound(shape, mhz, b1_rate)
        row["max_abs_err"] = max(row["max_abs_err"], d["err"])
    c = kern["crc"]
    nrows, l = c["shape"]
    row = by_name["crc32c_chunks"]
    path = f"cluster write CRC rows ({nrows}, {l})"
    row["ms_by_path"][path] = round(c["ms"], 4)
    row.setdefault("plain_ms_by_path", {})[path] = round(c["plain_ms"], 4)
    t_bytes = (nrows * l + 4 * nrows) / HBM_BYTES_PER_S * 1e3
    t_ops = nrows * l / (SMEM_LOOKUPS_PER_CLOCK * mhz * 1e6) * 1e3
    row["bound_by_path"][path] = {
        "bound_ms": round(max(t_bytes, t_ops), 4),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    p = kern["placement"]
    row = by_name["crush_map_rule"]
    path = (f"cluster epoch table: rule 1 indep x{p['numrep']}, "
            f"{p['lanes']} lanes")
    row["ms_by_path"][path] = round(p["ms"], 4)
    row["bound_by_path"][path] = placement_bound(
        p["lanes"], p["numrep"], mhz, (CLUSTER["n_osds"], 1))
    row["max_abs_err"] = max(row["max_abs_err"], p["err"])


def phase_kernel_line(main: dict, launches: dict, small_err: dict,
                      lrc: dict, pmsr: dict, k3_small_err: int,
                      cauchy_ms: float, k4: dict, k4_small_err: int,
                      osd: dict, repair: dict, rates: dict,
                      built: dict, placement: dict, table: dict,
                      datapath: dict, k6: dict, sharded: dict,
                      cluster: dict, harness: dict, apps: dict,
                      fs: dict) -> dict:
    """Each kernel at its headline shape: time, bound, plain time, error;
    K1, K2, K3, K5 and K6 also with their other paths' times and bounds, K1,
    K2, K4, K5 and K6 with their launch configuration, K3 its design per
    digest; K1/K2 the sharded codec's paths (phase 9)."""
    from ceph_tpu_torch.ops import crc32c_batch as crc
    from ceph_tpu_torch.ops import gf2kernels as gk
    from ceph_tpu_torch.ops import xor_schedule as xs

    data, mat = main["data"], np.ascontiguousarray(main["matrix"], np.uint8)
    b, k, l = data.shape
    r = mat.shape[0]
    g = gk.pick_group(k, b)
    # K3 at the RS parity the main path computes, beside K1 and K2
    rs_sched = built["rs8/3 parity"][1]
    rs_out = xs.xor_sched(rs_sched, data)
    if not torch.equal(rs_out[:4], xs.apply_bits_plain(rs_sched, data[:4])):
        raise RuntimeError("xor_sched differs from its plain version at RS "
                           "parity")
    del rs_out
    rs_k3_ms = time_ms(lambda: xs.xor_sched(rs_sched, data))
    rs_shape = (b, k, l, r)
    dev = data.device
    w_flat = torch.from_numpy(gk.bitmatrix_i8(mat)).to(dev)
    w_group = torch.from_numpy(gk.w_gN_planemajor(mat, g)).to(dev)
    kernels = {
        "gf2_matmul_popc": (lambda: gk.gf2_matmul_popc(mat, data),
                            lambda x: gk.gf2_matmul_plain(w_flat, x),
                            "ceph_tpu/ops/gf2kernels.py:142, "
                            "ceph_tpu/ops/gf2kernels.py:165"),
        "gf2_matmul_mma": (lambda: gk.gf2_matmul_mma(mat, data, g),
                           lambda x: gk.gf2_matmul_grouped_plain(w_group, x, g),
                           "ceph_tpu/ops/gf2kernels.py:317"),
    }
    nbytes = data.numel() + b * r * l + 64 * r * k
    ops = 2 * (8 * r) * (8 * k) * b * l
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT8_OPS_PER_S * 1e3
    rows = []
    for name, (kernel, plain, replaces) in kernels.items():
        out = kernel()
        ms = time_ms(kernel)
        plain_ms, err = plain_in_slices(plain, data, out)
        del out
        rows.append({
            "name": name, "route": "cuda",
            "source": "ceph_tpu_torch/csrc/gf2_matmul.cu",
            "replaces": replaces,
            "launches": launches[name] + sum(
                drive[name] for drive in datapath["launches"].values())
            + sharded["launches"][name] + sharded["rank_launches"][name]
            + sharded["entry_launches"][name],
            "max_abs_err": max(err, small_err[name]),
            "ms": round(ms, 4), "plain_ms": round(plain_ms, 4),
            "bound_ms": round(max(t_bytes, t_ops), 4),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
            "library_note": "no single PyTorch call computes a GF(2^8) "
                            "matrix product",
            "shape": [b, k, l], "r": r,
        })
        if err:
            raise RuntimeError(f"{name} differs from its plain version at "
                               f"the headline shape: max {err}")
    k2 = rows[1]
    k2["ms_by_path"] = {
        "rs8/3 decode[1,9] (1024,8,131072)->2": round(main["decode_ms"], 4),
        "cauchy10/4 decode[2,11] (128,10,131072)->2": round(cauchy_ms, 4),
    }
    if lrc["dense_name"] == "K2":
        k2["ms_by_path"]["lrc8/4/3 dense encode (1024,8,131072)->8"] = round(
            lrc["dense_ms"][0], 4)
        k2["ms_by_path"]["lrc8/4/3 dense local repair (1024,3,131072)->1"] = \
            round(lrc["dense_ms"][1], 4)
    k2.update(gk.mma_config(k, r, g, dev))
    k2["u8_mma_per_clock_per_sm"] = round(rates["u8 m16n8k32"], 4)
    k1 = rows[0]
    k1.update(gk.popc_config(k, r, dev))
    b1_rate = rates["b1 m16n8k256 and.popc"]
    k1["b1_mma_per_clock_per_sm"] = round(b1_rate, 4)

    # K3 at LRC k=8,m=4,l=3 encode: n_terms XORs per 32 byte columns
    data, sched = lrc["data"], lrc["sched"]
    b, k, l = data.shape
    r = sched.n_out // 8
    kernel = lambda: xs.xor_sched(sched, data)  # noqa: E731
    out = kernel()
    ms = time_ms(kernel)
    mhz, clock_source = sm_clock_mhz_under(kernel)
    plain_ms, err = plain_in_slices(
        lambda x: xs.apply_bits_plain(sched, x), data, out)
    del out
    t_bytes = (b * k * l + b * r * l) / HBM_BYTES_PER_S * 1e3
    t_ops = sched.n_terms * b * -(-l // 32) / (INT32_OPS_PER_CLOCK * mhz * 1e6) * 1e3
    rows.append({
        "name": "xor_sched", "route": "cuda",
        "source": "ceph_tpu_torch/csrc/xor_sched.cuh",
        "generator": "ceph_tpu_torch/ops/xor_sched_codegen.py",
        "replaces": "ceph_tpu/ops/xor_schedule.py:529",
        "launches": lrc["launches"]["xor_sched"] + pmsr["launches"]["xor_sched"],
        "launches_by_path": {"lrc": lrc["launches"]["xor_sched"],
                             "pmsr": pmsr["launches"]["xor_sched"]},
        "max_abs_err": max(err, k3_small_err),
        "ms": round(ms, 4), "plain_ms": round(plain_ms, 4),
        "bound_ms": round(max(t_bytes, t_ops), 4),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
        "library_note": "no single PyTorch call computes a GF(2) XOR schedule",
        "shape": [b, k, l], "r": r, "n_terms": sched.n_terms,
        "sm_clock_mhz": mhz, "clock_source": clock_source,
    })
    if err:
        raise RuntimeError(f"xor_sched differs from its plain version at the "
                           f"headline shape: max {err}")

    # the other paths, as the flat (B, sub-rows, sub-lane) -> rows products
    # they launch; K1 (dense) and K3 compute the same function on a path,
    # so one bound for both
    enc5, dec5 = pmsr["shapes"]
    enc7, dec7 = repair["pmsr7_shapes"]
    lrc_rep = lrc["shapes"][1]
    k1_ms = pmsr["dense_ms"] if pmsr["dense_name"] == "K1" else (None, None)
    paths = {   # label: (shape, schedule or None, K3 ms, K1 ms)
        path_label("rs8/3 parity", rs_shape): (
            rs_shape, rs_sched, rs_k3_ms, None),
        path_label("pmsr5/4 parity", enc5): (
            enc5, pmsr["sched"], pmsr["sched_ms"][0], k1_ms[0]),
        path_label(f"pmsr5/4 decode{list(PMSR_LOST)}", dec5): (
            dec5, pmsr["dsched"], pmsr["sched_ms"][1], k1_ms[1]),
        path_label("pmsr7/6 dense encode", enc7): (
            enc7, None, None, repair["pmsr7_ms"][0]),
        path_label(f"pmsr7/6 dense decode{list(PMSR7_LOST)}", dec7): (
            dec7, None, None, repair["pmsr7_ms"][1]),
        path_label("lrc8/4/3 local repair", lrc_rep): (
            lrc_rep, lrc["dsched"], lrc["sched_ms"][1], None),
    }
    k3 = rows[-1]
    k3["ms_by_path"], k3["bound_by_path"] = {}, {}
    k3["design_by_digest"] = {label: built[label][3] for label in (
        "rs8/3 parity", "lrc8/4/3 parity", "lrc8/4/3 local repair",
        "pmsr5/4 parity", f"pmsr5/4 decode{list(PMSR_LOST)}",
        "rs20/4 parity")}
    k1["ms_by_path"], k1["bound_by_path"] = {}, {}
    for label, (shape, sch, k3_ms, k1_ms) in paths.items():
        bound = path_bound(shape, mhz, b1_rate, sch)
        for row, ms in ((k3, k3_ms), (k1, k1_ms)):
            if ms is not None:
                row["ms_by_path"][label] = round(ms, 4)
                row["bound_by_path"][label] = bound
    for label, d in datapath["dense"].items():
        row = k1 if d["name"] == "gf2_matmul_popc" else k2
        key = path_label(f"datapath rs8/3 {label}", (*d["shape"], d["r"]))
        row.setdefault("ms_by_path", {})[key] = round(d["ms"], 4)
        row.setdefault("bound_by_path", {})[key] = path_bound(
            (*d["shape"], d["r"]), mhz, b1_rate)
    dp_base, dp_cached = (datapath["launches"][d] for d in ("baseline",
                                                            "cached"))
    base_label = ("datapath baseline drive (write encode, scrub re-encode, "
                  "degraded decode)")
    cached_label = "datapath cached drive (write encode, degraded decode)"
    k2["launches_by_path"] = {
        "rs8/3 main path (encode_batch + decode_batch)":
            launches["gf2_matmul_mma"],
        base_label: dp_base["gf2_matmul_mma"],
        cached_label: dp_cached["gf2_matmul_mma"]}
    k1["launches_by_path"] = {
        "rs8/3 main path (per-op encode + decode)": launches["gf2_matmul_popc"],
        base_label: dp_base["gf2_matmul_popc"],
        cached_label: dp_cached["gf2_matmul_popc"],
        "pmsr5/4 dense encode + decode": pmsr["launches"]["gf2_matmul_popc"],
        "pmsr7/6 dense encode + decode":
            repair["pmsr7_launches"]["gf2_matmul_popc"]}
    k1["config_by_path"] = {path_label("pmsr7/6 dense encode", enc7):
                            gk.popc_config(enc7[1], enc7[3], dev)}
    # the sharded codec (phase 9): its launches on each kernel, and its
    # functions' times at world size 1 on the row of the kernel that served
    # them, beside MeshCodec's on the same input; bounds by bytes
    for row in (k1, k2):
        name = row["name"]
        row["launches_by_path"].update({
            "sharded codec, world size 1 (phase 9)":
                sharded["launches"][name],
            f"sharded dry run, {SHARDED_RANKS} gloo ranks on the card "
            f"(phase 9)": sharded["rank_launches"][name],
            "entry() (phase 9)": sharded["entry_launches"][name]})
    served = k1 if sharded["launches"]["gf2_matmul_popc"] > \
        sharded["launches"]["gf2_matmul_mma"] else k2
    mb = 1 << 20
    sb, sk, sm, sl = MAIN
    stripe, parity_b, lost_b = sb * sk * sl, sb * sm * sl, sb * 2 * sl
    sharded_bytes = {   # function: bytes in and out, world size 1
        "sharded_encode": stripe + parity_b,
        "sharded_ec_step": stripe + parity_b + lost_b + 8,
        "sharded_rmw": stripe + 2 * parity_b,
        "sharded_cross_recovery": stripe + lost_b,
        "MeshCodec.encode": stripe + parity_b,
        "MeshCodec.decode": stripe + lost_b}
    served["sharded_step_parts_ms"] = {
        name: round(v, 4) for name, v in sharded["parts"].items()}
    for fn_name, nbytes in sharded_bytes.items():
        key = f"{fn_name} rs8/3 ({sb},{sk},{sl}), world size 1"
        served.setdefault("ms_by_path", {})[key] = round(
            sharded["ms"][fn_name], 4)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        served.setdefault("bound_by_path", {})[key] = {
            "bound_ms": round(t_bytes, 4), "bound_by": "bytes",
            "bytes_mib": round(nbytes / mb, 1)}

    # K4 at the fused RS encode: the CRCs of (1024 x 11) rows of 131072 B in
    # one launch; the work's bound: each byte read once and each CRC written
    # once, or one shared-memory table lookup per byte at 32 a clock per SM
    # (the work's count, not the lookups a design makes)
    nrows = k4["data"].shape[0] * (k4["data"].shape[1] + k4["parity"].shape[1])
    l = k4["data"].shape[2]
    t_bytes = (nrows * l + 4 * nrows) / HBM_BYTES_PER_S * 1e3
    t_ops = nrows * l / (SMEM_LOOKUPS_PER_CLOCK * mhz * 1e6) * 1e3
    rows.append({
        "name": "crc32c_chunks", "route": "cuda",
        "source": "ceph_tpu_torch/csrc/crc32c.cu",
        "replaces": "ceph_tpu/ops/crc32c_batch.py:418 (XLA program, not "
                    "Pallas)",
        "launches": osd["k4_launches"] + dp_base["crc32c_chunks"]
        + dp_cached["crc32c_chunks"],
        "launches_by_path": {
            "osd encode+CRC batch": osd["k4_launches"],
            "datapath baseline drive (fused write CRCs)":
                dp_base["crc32c_chunks"],
            "datapath cached drive (fused write CRCs, scrub sweeps)":
                dp_cached["crc32c_chunks"]},
        "max_abs_err": max(k4["err"], k4_small_err),
        "ms": round(osd["k4_ms"], 4), "plain_ms": round(k4["plain_ms"], 4),
        "bound_ms": round(max(t_bytes, t_ops), 4),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
        "library_note": "no PyTorch call computes CRC32C",
        "shape": [nrows, l], "sm_clock_mhz": mhz,
        "ms_by_path": {
            "rs8/3 fused data + parity as two launches": round(
                osd["k4_two_ms"], 4),
            f"resident rows {tuple(k4['resident_shape'])}": round(
                k4["resident_ms"], 4),
            f"datapath scrub sweep {datapath['k4_shape']}": round(
                datapath["k4_ms"], 4)},
        "bound_by_path": {
            f"datapath scrub sweep {datapath['k4_shape']}": {
                "bound_ms": round(datapath["k4_bound_ms"], 4),
                "bound_by": "bytes"}},
        **crc.kernel_config(dev),
    })
    k5 = placement_row(placement, mhz, table)
    rows.append(k5)
    rows.append(k6_row(k6, table, mhz))
    cluster_paths(rows, cluster, mhz, b1_rate)
    harness_paths(rows, harness, mhz, b1_rate)
    apps_paths(rows, apps, mhz, b1_rate)
    fs_paths(rows, fs, mhz, b1_rate)
    r1 = f"rule 1 indep x11, {PLACEMENT[1]} lanes"
    log(f"K5 crush_map_rule at config 5, a {PLACEMENT[1]}-lane launch: rule 0 "
        f"x3 {k5['ms']:.4f} ms vs bound {k5['bound_ms']:.4f} ms, rule 1 x11 "
        f"{k5['ms_by_path'][r1]:.4f} ms vs bound "
        f"{k5['bound_by_path'][r1]['bound_ms']:.4f} ms (operations: straw2 "
        f"draws without retries, {ALU_OPS_PER_DRAW} of {INT_OPS_PER_DRAW} "
        f"integer operations each on the ALU pipe, at {mhz:.0f} MHz; all on "
        f"it {k5['bound_int32_lanes_ms']:.4f} / "
        f"{k5['bound_by_path'][r1]['int32_lanes_ms']:.4f} ms); mappings/s "
        f"{k5['mappings_per_s']}")
    return {"kernels": rows}


@contextlib.contextmanager
def constants(values: dict):
    """This module's constants set to ``values`` for the block."""
    kept = {name: globals()[name] for name in values}
    globals().update(values)
    try:
        yield
    finally:
        globals().update(kept)


def cut_seconds_main() -> int:
    """``--cut-seconds``: each cut of ``CUTS_BEFORE`` timed on the card, its
    phase run with the cut and then without it (the second run pays no
    first use, so a saving it shows is no effect of the order), on the
    fixed sources phase 1 builds."""
    from ceph_tpu_torch.ops import _build
    if not torch.cuda.is_available():
        print("chip_smoke --cut-seconds: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions: fp32
    log(f"card: {card_label()}")
    _build.build(_build.all_sources())
    dev = torch.device("cuda", 0)
    out = {}
    for cut, (phase, before) in CUTS_BEFORE.items():
        secs = {}
        for when, values in (("after", {}), ("before", before)):
            with constants(values), xor_sched_env(None):
                t0 = time.perf_counter()
                globals()[phase](dev)
                secs[when] = round(time.perf_counter() - t0, 2)
        out[cut] = secs
        log(f"cut {cut} ({phase}, {before} before): {secs['after']} s with "
            f"it, {secs['before']} s without")
    print(json.dumps({"cut_seconds": out, "card": card_label()}),
          flush=True)
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions: fp32
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    early: dict = {}

    def beside_cse():
        """Phases 2 and 2b and phase 3's K4 checks (K1, K2, the MMA rates,
        K4) need no XOR schedule: they run while the workers compile."""
        early["small_err"] = phase_kernels(dev)
        early["rates"] = phase_mma_rate(dev)
        early["k4_small_err"] = phase_k4_small(dev)

    secs: dict[str, float] = {}
    mark = [t0]

    def lap(name: str) -> None:
        now = time.perf_counter()
        secs[name] = now - mark[0]
        mark[0] = now

    built, cse_s = phase_build(beside_cse)
    lap("1-2b")
    small_err, rates, k4_small_err = (
        early[key] for key in ("small_err", "rates", "k4_small_err"))
    k3_small_err = phase_k3_small(dev, built)
    repair = phase_repair(dev)
    with xor_sched_env(None):          # the RS main path keeps its routing
        launches, main_inputs = phase_main_path(dev)
        cauchy_ms = phase_cauchy(dev)
    lrc = phase_linear(dev, "lrc", LRC, (0,), SEED + 5)
    pmsr = phase_linear(dev, "pmsr", PMSR, PMSR_LOST, SEED + 7)
    phase_autotune()
    os.environ.pop("CEPH_TPU_NO_FUSED_CRC", None)   # the fused CRC path
    with xor_sched_env(None):          # the OSD path keeps its routing
        k4 = phase_k4_full(dev, main_inputs)
        osd = phase_osd(dev)
    lap("3-8c")
    placement = phase_placement(dev)
    lap("8d")
    table = phase_table(dev)
    k6 = phase_k6(dev)
    lap("8e")
    log(f"phase 8e, the epoch table and K6: {secs['8e']:.1f} s")
    os.environ.pop("CEPH_TPU_NO_FUSED_CRC", None)   # the fused write CRCs
    with xor_sched_env(None):          # the data spine keeps its routing
        datapath = phase_datapath(dev)
    lap("8f")
    log(f"phase 8f, the data spine: {datapath['seconds']:.1f} s")
    with xor_sched_env(None):          # the sharded codec keeps its routing
        sharded = phase_sharded(dev, main_inputs)
    lap("9")
    log(f"phase 9, the sharded codec: {secs['9']:.1f} s")
    with xor_sched_env(None):          # the cluster keeps its routing
        cluster = phase_cluster(dev)
    lap("10")
    log(f"phase 10, the RADOS cluster: {cluster['seconds']:.1f} s")
    from ceph_tpu_torch.ops import xor_schedule as xs
    harness = phase_harness_process(dict(xs._SCHEDULES))
    lap("11")
    log(f"phase 11, the traffic and failure harness: {secs['11']:.1f} s")
    apps = phase_subprocess(APPS_FLAG, APPS_TAG, 12)
    lap("12")
    log(f"phase 12, the client applications: {secs['12']:.1f} s")
    fs = phase_subprocess(FS_FLAG, FS_TAG, 13)
    lap("13")
    log(f"phase 13, CephFS, the mgr, vstart and the CLIs: {secs['13']:.1f} s "
        f"(13a {fs['fs']['seconds']:.1f} s, 13b {fs['vstart']['seconds']:.1f} "
        f"s; phase 1's host CSE {cse_s:.1f} s)")
    line = phase_kernel_line(main_inputs, launches, small_err, lrc, pmsr,
                             k3_small_err, cauchy_ms, k4, k4_small_err, osd,
                             repair, rates, built, placement, table,
                             datapath, k6, sharded, cluster, harness, apps,
                             fs)
    log(json.dumps(line))
    peak = max(torch.cuda.max_memory_allocated(), datapath["run_peak_bytes"])
    log(f"peak device memory {peak / GiB:.2f} GiB")
    loadgen = harness["loadgen"]
    log(f"seconds by phase "
        f"{ {name: round(v, 1) for name, v in secs.items()} }; phase 1's "
        f"host CSE {cse_s:.1f} s; 11a steady "
        f"{loadgen['steady_ops_s']} ops/s, its resends "
        f"{loadgen['resends'].get('steady')}; card {card_label()}; total "
        f"{time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) in (2, 3) and sys.argv[1] == HARNESS_FLAG:
        sys.exit(harness_main(sys.argv[2] if len(sys.argv) == 3 else None))
    if sys.argv[1:] == [APPS_FLAG]:
        sys.exit(apps_main())
    if sys.argv[1:] == [FS_FLAG]:
        sys.exit(fs_main())
    if sys.argv[1:] == [CUT_FLAG]:
        sys.exit(cut_seconds_main())
    sys.exit(main())
