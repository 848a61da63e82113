#!/usr/bin/env python3
"""Drive the port's main paths on one CUDA card and check them: the
erasure-code stripe codec, bulk CRUSH placement, the epoch placement table
(K5 and, for the map shapes K5 does not express, K6), the OSD shard data
spine and the sharded codec over ``torch.distributed``.

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero and prints no result:

 1. the card's name and power limit; compile the XOR schedules of every
    matrix the run uses, then build every kernel with nvcc, one process per
    source, all at once: ``ceph_tpu_torch/csrc/*.cu`` and one generated K3
    source per schedule digest (K3's design, and ptxas's registers, shared
    memory and spills per digest, from the kept log of a cached build too;
    nvcc seconds);
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
    exactly, on 262,144 seeds (values >= 2^31 included) and against the
    scalar ``crush_do_rule`` on 512, for rule 0 (chooseleaf firstn, 3
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
    scalar pipeline on its overridden PGs and 512 random raw ps a pool and
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
    with chooseleaf_vary_r = 0 (pg_num 1024, 256, 1): the card's table maps
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
    4 KiB stripe unit over 128 objects of 4 MiB (704 MiB stored in 11
    BlockStores), write -> read-verify -> scrub -> degraded read (10
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
10. a ``kernels`` JSON line: per kernel its launches on its paths (phases
    4, 8f and 9 for K1/K2, phases 6-7 for K3, phases 8c and 8f for K4, phases
    8d-8e for K5, phase 8e for K6), its
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
11. the result line {"ok": true, "device": {...}}.

Each path's launch counts are set to 0 just before it is driven and read
just after; a kernel of the path that did not launch fails the run.

It needs one card; without one it exits with code 2 before doing anything.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import time

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
PLACEMENT_SAMPLE = 262144        # lanes K5 is held against its plain version
PLACEMENT_SCALAR = 512           # lanes held against the scalar engine
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
TABLE_SAMPLE = 512               # random raw ps a pool held scalar
TABLE_LOOKUPS = 100_000
# map shapes the reference's bulk mapper refuses and K5 expresses (straw
# buckets; jewel's tunables with chooseleaf_vary_r = 0) on config 5's OSDs;
# pg_num cut so that the scalar pipeline can check every PG
TABLE_EXPRESSED_PG_NUMS = (1024, 256, 1)
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
K6_PLAIN_SAMPLE = {0: 1024, 1: 256}
K6_BULK_SCALAR = 128             # bulk_crush rows a shape held scalar
# phase 9, the sharded codec: LRC k=12,m=4,l=4 at full width on four ranks
# (B, groups, kg, L), beside the dry run's checks
SHARDED_LRC = (64, 4, 3, 131072)
SHARDED_RANKS = 4
# phase 8f, the OSD shard data spine (tools/datapath_bench.py): RS k=8,m=3
# (BASELINE.json's code) at Ceph's stripe unit (osd_pool_erasure_code_
# stripe_unit 4 KiB, src/common/options/global.yaml.in: 32 KiB stripes) over
# 128 objects of RBD's default 4 MiB (rbd_default_order 22,
# src/common/options/rbd.yaml.in): 512 MiB logical, 704 MiB stored, 64 MiB a
# shard store (osd_datapath_cache_bytes' default); each store's cache keeps
# the rig's 256 MiB budget, the reference's.  The batcher takes 8192 stripes
# a launch, so 64 objects' writes coalesce into one (8192, 8, 4096) launch.
# Cut for the run's time limit: passes 2 (reference 10) and read-verify
# sweeps a pass 2 (reference 5).  Degraded reads: 128 // 12 = 10 objects
# with shard 0 down (the reference rig's share).
DATAPATH = dict(k=8, m=3, n_objects=128, obj_bytes=4 << 20, passes=2,
                reads_per_pass=2, stripe_unit=4096, max_batch=8192)
DATAPATH_PLAIN_SAMPLE = 8        # device views held against K4's plain version


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
    }


def phase_build() -> dict:
    """Compile the schedules, build every kernel; returns label -> (matrix,
    schedule, nvcc seconds, K3's design and ptxas counts)."""
    from ceph_tpu_torch.ops import _build
    from ceph_tpu_torch.ops import gf2kernels as gk
    from ceph_tpu_torch.ops import xor_sched_codegen as cg
    from ceph_tpu_torch.ops import xor_schedule as xs
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    log(f"card: {smi.stdout.strip().splitlines()[0]}")
    t0 = time.perf_counter()
    mats = path_matrices()
    scheds = {label: xs.schedule_for(gk.bitmatrix_i8(mat))
              for label, mat in mats.items()}
    log(f"schedules: {len(scheds)} compiled in "
        f"{time.perf_counter() - t0:.2f} s (host CSE)")
    sources = _build.all_sources()
    k3 = {label: xs.k3_source(sched) for label, sched in scheds.items()}
    t0 = time.perf_counter()
    reports = _build.build(sources + sorted(set(k3.values())))
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
        f"in {dt:.2f} s ({len(reports)} compiled, sm_90a, all at once)")
    return out


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
    from ceph_tpu_torch.crush import rule_lanes, vectorized
    from ceph_tpu_torch.ops import crc32c_batch, gf2kernels
    return {**gf2kernels.LAUNCHES, **crc32c_batch.LAUNCHES,
            **vectorized.LAUNCHES, **rule_lanes.LAUNCHES}


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
    on the card, exactly, on 262,144 seeds (values >= 2^31 included) and
    against the scalar engine on 512 of them, for both rules on the
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
        plain_ms[rule] = time_ms(plain_batch, iters=1)
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
        m.osds[int(o)].up = False
    for o in pick[int(n * TABLE_DOWN):int(n * (TABLE_DOWN + TABLE_REWEIGHTED))]:
        m.osds[int(o)].weight = 0x8000
    out_host = int(rng.integers(0, n // per_host))
    for o in range(out_host * per_host, (out_host + 1) * per_host):
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
        PGMapping, bulk_crush_rows, live_osds)
    cpu = PGMapping(m.epoch, "cpu")
    weights = m.osd_weights()
    live = live_osds(m, len(weights) + 1)
    for pid, pool in m.pools.items():
        rows, used = bulk_crush_rows(m.crush, pool.crush_rule,
                                     seed_tensor(pps[pid], dev), pool.size,
                                     weights)
        if not used:
            raise RuntimeError(f"pool {pid} took the scalar sweep")
        cpu._ingest_pool(m, pid, pool, rows.cpu(), live)
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
    live = pmod.live_osds(m, len(weights) + 1)
    for pid, pool in m.pools.items():
        seeds = stage("seeds", lambda: pmod.cached_pool_seeds(pool, dev))
        rows, used = stage("crush", lambda: pmod.bulk_crush_rows(
            m.crush, pool.crush_rule, seeds, pool.size, weights), kernel=True)
        if not used:
            raise RuntimeError(f"pool {pid} was not mapped by K5")
        stage("filter", lambda: pm._ingest_pool(m, pid, pool, rows, live))
    stage("copy back", pm._copy_back)
    split["total"] = time.perf_counter() - t0
    return split


def split_line(split: dict) -> str:
    """A staged build's host clock by stage, and the Python left over."""
    stages = ("seeds", "crush", "filter", "copy back")
    left = split["total"] - sum(split[k] for k in stages)
    return (f"{split['total']:.4f} s = seeds (pool_seeds on the card, or "
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


def phase_kernel_line(main: dict, launches: dict, small_err: dict,
                      lrc: dict, pmsr: dict, k3_small_err: int,
                      cauchy_ms: float, k4: dict, k4_small_err: int,
                      osd: dict, repair: dict, rates: dict,
                      built: dict, placement: dict, table: dict,
                      datapath: dict, k6: dict, sharded: dict) -> dict:
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions: fp32
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    built = phase_build()
    small_err = phase_kernels(dev)
    rates = phase_mma_rate(dev)
    k3_small_err = phase_k3_small(dev, built)
    k4_small_err = phase_k4_small(dev)
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
    placement = phase_placement(dev)
    t8e = time.perf_counter()
    table = phase_table(dev)
    k6 = phase_k6(dev)
    log(f"phase 8e, the epoch table and K6: {time.perf_counter() - t8e:.1f} "
        f"s")
    os.environ.pop("CEPH_TPU_NO_FUSED_CRC", None)   # the fused write CRCs
    with xor_sched_env(None):          # the data spine keeps its routing
        datapath = phase_datapath(dev)
    log(f"phase 8f, the data spine: {datapath['seconds']:.1f} s")
    t9 = time.perf_counter()
    with xor_sched_env(None):          # the sharded codec keeps its routing
        sharded = phase_sharded(dev, main_inputs)
    log(f"phase 9, the sharded codec: {time.perf_counter() - t9:.1f} s")
    line = phase_kernel_line(main_inputs, launches, small_err, lrc, pmsr,
                             k3_small_err, cauchy_ms, k4, k4_small_err, osd,
                             repair, rates, built, placement, table,
                             datapath, k6, sharded)
    log(json.dumps(line))
    peak = max(torch.cuda.max_memory_allocated(), datapath["run_peak_bytes"])
    log(f"peak device memory {peak / GiB:.2f} "
        f"GiB, total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
