"""Straggler bench rig: hedged vs unhedged EC reads under heavy tails.

A loadgen phase (SimCluster + ClientSwarm, the same spine as
``bench.py --cluster``) driven TWICE over an identical deterministic
workload and an identical per-peer heavy-tail delay schedule (the
fault injector's straggler mode draws each peer's delay sequence from
a (seed, peer)-keyed RNG stream, so both variants race the very same
stragglers):

* **unhedged** -- ``osd_ec_hedge_enabled=false``: every degraded
  gather awaits its fixed shard set, so a straggling source sets the
  op's latency (the behavior before hedging);
* **hedged** -- the HedgedGather engine arms the adaptive per-peer
  EWMA quantile, requests extra shards on fire, and decodes from the
  first sufficient set.

Reported per variant: the read latency histogram (log-bucketed, the
loadgen percentiles), total sub-reads issued + reply bytes (the
hedging cost), and the ``ec_hedge``/``ec_degraded`` counter deltas.
Gates (the hedging acceptance set, enforced by ``bench.py
--straggler``): p99 hedged >= 2x better, extra shard reads <= 1.5x,
zero failed/wedged ops, zero leaked sub-read tasks, and every object
byte-identical to the written ground truth in BOTH variants -- the
unhedged full-set gather IS the oracle the first-k decode must match.

``straggler_gates`` lists the gates a result fails (``bench.py
--straggler``'s, and the two variants' straggler schedules: the same
victims and fault seed, and delays drawn in both).  Port of
``ceph_tpu/tools/straggler_bench.py``: both clusters run on ``device``
(CUDA unless the caller names the CPU), and the module has a CLI:

    python -m ceph_tpu_torch.tools.straggler_bench           # bench.py's sizes
    python -m ceph_tpu_torch.tools.straggler_bench --smoke --device cpu

It prints the result as one JSON line and exits 1 when a gate fails.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import math
import sys
import time

from ..common.faults import RECV, MessageFaultInjector
from ..loadgen import ClientSwarm, SimCluster, WorkloadSpec
from ..loadgen.driver import _create_pool
from ..loadgen.spec import payload_for

# knobs shared by both variants: fast EWMA warm-up, a tight hedge
# ceiling (the straggler tail is far above it), snappy heartbeats
_OSD_CONFIG = {
    "osd_ec_hedge_delay_min": 0.005,
    "osd_ec_hedge_delay_max": 0.2,
    "osd_ec_hedge_min_samples": 2,
    "osd_ec_read_timeout": 8.0,
}


def _spec(n_osds, pg_num, n_objects, obj_bytes, n_reads, n_clients,
          seed) -> WorkloadSpec:
    return WorkloadSpec(
        n_osds=n_osds, pg_num=pg_num, pool="stragglerpool",
        pool_type="erasure", ec_k=2, ec_m=1,
        n_objects=n_objects, obj_size=obj_bytes,
        n_ops=n_reads, read_frac=1.0, write_frac=0.0, rmw_frac=0.0,
        popularity="uniform", n_clients=n_clients,
        seed=seed).validate()


def _counters(cluster, which: str) -> dict:
    return cluster.perf_counters(which)


async def _drive_variant(spec: WorkloadSpec, *, hedge: bool,
                         fault_seed: int, straggler_peers: int,
                         dist: str, dist_params: dict,
                         log=print, device=None) -> dict:
    """One full cluster lifetime: bring-up, preload, EWMA warm-up,
    straggler phase, byte verification, teardown."""
    inj = MessageFaultInjector(seed=fault_seed)
    cluster = await SimCluster.create(
        spec.n_osds,
        osd_config={**_OSD_CONFIG,
                    "osd_ec_hedge_enabled": hedge},
        faults=inj, log=log, device=device)
    device = cluster.mon.device
    swarm = None
    try:
        await _create_pool(cluster.addr, spec, device=device)
        swarm = ClientSwarm(spec, cluster.addr, device=device)
        await swarm.start()
        load = await swarm.preload()
        if load.failed or load.wedged:
            raise RuntimeError(
                f"preload failed ops: {load.errors[:4]}")
        # warm pass: healthy latencies feed every primary's per-peer
        # EWMA (and make the two variants start from identical state)
        warm = await swarm.run_phase(spec.schedule(salt="warm"),
                                     "warm")
        # arm the SAME deterministic straggler schedule either way:
        # the first `straggler_peers` OSDs' read replies go heavy-tail
        victims = sorted(o.whoami for o in cluster.osds
                         )[:straggler_peers]
        for v in victims:
            inj.straggler(f"osd.{v}", dist=dist,
                          mtype="ec_subop_read_reply",
                          direction=RECV, **dist_params)
        hedge0 = _counters(cluster, "ec_hedge")
        degr0 = _counters(cluster, "ec_degraded")
        t0 = time.perf_counter()
        phase = await swarm.run_phase(spec.schedule(salt="steady"),
                                      "straggler")
        elapsed = time.perf_counter() - t0
        hedge1 = _counters(cluster, "ec_hedge")
        degr1 = _counters(cluster, "ec_degraded")
        deltas = {k: hedge1.get(k, 0) - hedge0.get(k, 0)
                  for k in set(hedge0) | set(hedge1)}
        retries = degr1.get("gather_retries", 0) \
            - degr0.get("gather_retries", 0)
        # byte identity against the written ground truth (the payload
        # generator is pure in (spec, size)); the straggler schedule
        # stays armed -- a verify pass that only passes with the
        # faults healed would prove nothing
        io = swarm.ioctxs[0]
        mismatches = []
        for i in range(spec.n_objects):
            oid = spec.object_name(i)
            want = payload_for(spec, spec.object_size(i))
            got = await io.read(oid)
            if bytes(got) != want:
                mismatches.append(oid)
        # leak check: after the phase settles, no sub-read task
        # (OSD.start_request's ``_issue`` coroutine) may still be
        # pending -- a live one means a gather exited without
        # cancelling/reaping its stragglers
        await asyncio.sleep(0.05)
        leaked = sum(
            1 for t in asyncio.all_tasks()
            if not t.done()
            and getattr(t.get_coro(), "__name__", "") == "_issue")
        waiters = sum(o.inflight_ops() for o in cluster.osds)
        lat = phase.hists["read"].summary()
        return {
            "hedge": hedge,
            "victims": victims,
            "ops": phase.ops,
            "failed_ops": phase.failed,
            "wedged_ops": phase.wedged,
            "elapsed_s": round(elapsed, 3),
            "ops_per_s": round(phase.ops / elapsed, 1)
            if elapsed else 0.0,
            "latency": lat,
            "warm_p99_s": warm.hists["read"].summary().get("p99_s"),
            "subreads": deltas.get("subreads", 0),
            "subread_bytes": deltas.get("subread_bytes", 0),
            "hedge_subreads": deltas.get("hedge_subreads", 0),
            "hedge_bytes": deltas.get("hedge_bytes", 0),
            "hedges_armed": deltas.get("hedges_armed", 0),
            "hedges_fired": deltas.get("hedges_fired", 0),
            "hedges_won": deltas.get("hedges_won", 0),
            "hedges_wasted": deltas.get("hedges_wasted", 0),
            "cancelled_subreads": deltas.get("cancelled_subreads", 0),
            "first_set_completions":
                deltas.get("first_set_completions", 0),
            "gather_retries": retries,
            "fault_seed": fault_seed,
            "straggler_delays": inj.stats.get("straggler_delays", 0),
            "byte_mismatches": mismatches,
            "leaked_tasks": leaked,
            "pending_tid_waiters": waiters,
        }
    finally:
        if swarm is not None:
            await swarm.shutdown()
        await cluster.stop()


async def run_straggler_bench(*, n_osds: int = 5, pg_num: int = 32,
                              n_objects: int = 24,
                              obj_bytes: int = 12 << 10,
                              n_reads: int = 96, n_clients: int = 8,
                              seed: int = 7, fault_seed: int = 11,
                              straggler_peers: int = 1,
                              dist: str = "lognormal",
                              dist_params: dict | None = None,
                              log=print, device=None) -> dict:
    """The full comparison: one unhedged drive, one hedged drive,
    identical workload + identical per-peer straggler schedule."""
    if dist_params is None:
        # median ~0.5s, p99 ~1.1s, capped at 2s: a tail far above any
        # healthy sub-read but far below the read deadline, so the
        # unhedged variant measures pure straggler wait (no retries)
        dist_params = {"mu": math.log(0.5), "sigma": 0.35, "cap": 2.0}
    spec = _spec(n_osds, pg_num, n_objects, obj_bytes, n_reads,
                 n_clients, seed)
    log(f"straggler bench: {n_osds} osds, {n_objects} objects, "
        f"{n_reads} reads, {straggler_peers} straggler peer(s), "
        f"{dist} {dist_params}")
    unhedged = await _drive_variant(
        spec, hedge=False, fault_seed=fault_seed,
        straggler_peers=straggler_peers, dist=dist,
        dist_params=dist_params, log=log, device=device)
    log(f"unhedged: p99={unhedged['latency'].get('p99_s')}s "
        f"subreads={unhedged['subreads']}")
    hedged = await _drive_variant(
        spec, hedge=True, fault_seed=fault_seed,
        straggler_peers=straggler_peers, dist=dist,
        dist_params=dist_params, log=log, device=device)
    log(f"hedged:   p99={hedged['latency'].get('p99_s')}s "
        f"subreads={hedged['subreads']} "
        f"fired={hedged['hedges_fired']} won={hedged['hedges_won']}")
    p99_un = unhedged["latency"].get("p99_s") or 0.0
    p99_he = hedged["latency"].get("p99_s") or 0.0
    speedup = round(p99_un / p99_he, 2) if p99_he else 0.0
    extra = round(hedged["subreads"] / unhedged["subreads"], 3) \
        if unhedged["subreads"] else 0.0
    extra_bytes = round(
        hedged["subread_bytes"] / unhedged["subread_bytes"], 3) \
        if unhedged["subread_bytes"] else 0.0
    return {
        "spec": {"n_osds": n_osds, "pg_num": pg_num,
                 "n_objects": n_objects, "obj_bytes": obj_bytes,
                 "n_reads": n_reads, "n_clients": n_clients,
                 "seed": seed, "fault_seed": fault_seed,
                 "straggler_peers": straggler_peers,
                 "dist": dist, "dist_params": dist_params},
        "unhedged": unhedged,
        "hedged": hedged,
        "p99_unhedged_s": p99_un,
        "p99_hedged_s": p99_he,
        "p99_speedup": speedup,
        "extra_subread_ratio": extra,
        "extra_byte_ratio": extra_bytes,
        "failed_ops": unhedged["failed_ops"] + hedged["failed_ops"],
        "wedged_ops": unhedged["wedged_ops"] + hedged["wedged_ops"],
        "leaked_tasks": unhedged["leaked_tasks"]
        + hedged["leaked_tasks"],
        "byte_mismatches": unhedged["byte_mismatches"]
        + hedged["byte_mismatches"],
    }


def same_schedule(a: dict, b: dict) -> bool:
    """Whether two variants raced the same stragglers: the same victims
    and fault seed (the injector draws each peer's delays from its own
    (seed, peer) stream, so one seed is one schedule), and delays drawn
    in both."""
    return (a["victims"] == b["victims"]
            and a["fault_seed"] == b["fault_seed"]
            and a["straggler_delays"] > 0 and b["straggler_delays"] > 0)


def straggler_gates(res: dict) -> list[str]:
    """The gates of ``bench.py --straggler`` a result fails, one line
    each, and the straggler schedules of its two variants."""
    out = []
    if res["byte_mismatches"]:
        out.append(f"byte mismatches {res['byte_mismatches'][:4]}")
    if res["failed_ops"] or res["wedged_ops"]:
        out.append(f"{res['failed_ops']} failed / {res['wedged_ops']} "
                   f"wedged ops under stragglers")
    if res["leaked_tasks"]:
        out.append(f"{res['leaked_tasks']} leaked sub-read tasks")
    if not res["hedged"]["hedges_fired"]:
        out.append("the hedged drive never fired a hedge")
    if res["p99_speedup"] < 2.0:
        out.append(f"p99 speedup {res['p99_speedup']}x < 2x floor")
    ratio = res["extra_subread_ratio"]
    if not ratio or ratio > 1.5:
        out.append(f"extra sub-read ratio {ratio}x outside (0, 1.5]")
    if not same_schedule(res["unhedged"], res["hedged"]):
        out.append("the two variants raced different straggler "
                   "schedules")
    return out


# bench.py --straggler's sizes: (n_osds, pg_num, n_objects, obj_bytes,
# n_reads, n_clients)
FULL = (6, 64, 48, 16 << 10, 240, 8)
SMOKE = (5, 32, 16, 8 << 10, 72, 6)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ceph_tpu_torch.tools.straggler_bench",
        description="hedged vs unhedged EC reads under stragglers")
    p.add_argument("--smoke", action="store_true",
                   help="bench.py --straggler --smoke's sizes")
    p.add_argument("--device", default="cuda",
                   help="the daemons' device: cuda (the card) or cpu "
                        "(the kernels' plain versions)")
    p.add_argument("--quiet", action="store_true")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    n_osds, pg_num, n_objects, obj_bytes, n_reads, n_clients = (
        SMOKE if args.smoke else FULL)

    def log(msg: str) -> None:
        if not args.quiet:
            print(msg, file=sys.stderr, flush=True)

    res = asyncio.new_event_loop().run_until_complete(run_straggler_bench(
        n_osds=n_osds, pg_num=pg_num, n_objects=n_objects,
        obj_bytes=obj_bytes, n_reads=n_reads, n_clients=n_clients,
        log=log, device=args.device))
    print(json.dumps(res), flush=True)
    errors = straggler_gates(res)
    for err in errors:
        print(f"ERROR: {err}", file=sys.stderr, flush=True)
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
