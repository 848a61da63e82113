"""Closed-loop workload driver: bring-up -> load -> steady -> recovery.

``run_workload`` takes a ``WorkloadSpec``, boots a ``SimCluster``,
preloads the working set, drives the steady-state op mix through the
``ClientSwarm``, optionally kills OSDs mid-traffic (the
recovery-interference phase: client latency during backfill is THE
number online-EC papers show microbenches can't predict), and returns
a JSON-able report:

* per phase: ops/s, GiB/s, p50/p95/p99/p99.9 per op class, failures;
* interference: victim OSDs, detection time, p99 degradation ratios
  vs steady state, whether the cluster re-converged;
* QoS: per-class dmClock dispatch counts and queue depths from the
  OSDs' ``scheduler`` perf sets (client vs recovery reservation/limit
  behavior, observed rather than inferred);
* counter deltas: placement cache, integrity pipeline, EC batcher,
  and the process-wide ``workload`` set.

The deterministic half of the report (schedules, op/byte tallies) is
byte-identical for the same spec+seed — ``deterministic_view``
extracts it for comparison.  ``cluster_gates`` lists what a run must
not show (``bench.py --cluster``'s gates).

Port of ``ceph_tpu/loadgen/driver.py``: the cluster, the pool's admin
handle and the swarm run on ``device`` (CUDA unless the caller names the
CPU), the EC pool's profile names the ``cuda`` plugin, and the loaded
working set is moved out of the cyclic collector (``settle_heap``).
"""

from __future__ import annotations

import asyncio
import time

from ..client.rados import Rados
from ..common.config import ConfigProxy
from ..ops.crc32c_batch import PERF as INTEGRITY_PERF
from .cluster import SimCluster
from .spec import WorkloadSpec
from .stats import PERF as WORKLOAD_PERF, delta
from .swarm import ClientSwarm


def _noop_log(msg: str) -> None:
    pass


async def _create_pool(mon_addr, spec: WorkloadSpec,
                       device=None) -> None:
    rados = await Rados(mon_addr, name="client.loadgen-admin",
                        device=device).connect()
    try:
        if spec.pool_type == "erasure":
            profile = f"loadgen-k{spec.ec_k}m{spec.ec_m}"
            await rados.mon_command(
                "osd erasure-code-profile set",
                {"name": profile, "profile": {
                    "plugin": "cuda", "k": str(spec.ec_k),
                    "m": str(spec.ec_m),
                    "technique": "reed_sol_van"}})
            await rados.pool_create(
                spec.pool, pg_num=spec.pg_num, pool_type="erasure",
                erasure_code_profile=profile)
        else:
            await rados.pool_create(
                spec.pool, pg_num=spec.pg_num,
                pool_type="replicated", size=spec.replica_size,
                min_size=max(1, spec.replica_size - 1))
    finally:
        await rados.shutdown()


def _numeric(d: dict) -> dict:
    return {k: v for k, v in d.items() if isinstance(v, (int, float))}


async def run_workload(spec: WorkloadSpec, *,
                       conf: ConfigProxy | None = None,
                       log=_noop_log, device=None,
                       on_stage=None, on_wedged=None) -> dict:
    """Boot, load, steady, (kill, degraded, revive, backfill); the
    report.  ``on_stage``, when given, is awaited as ``on_stage(stage,
    cluster, report)`` on the live cluster at the end of each stage, with
    the report so far: ``"boot"``, ``"load"``, ``"steady"``, then
    ``"degraded"`` (the kill and the wait for its mark-down included) and
    ``"backfill"``; last as ``"report"`` once the report is complete and
    before the cluster stops.  ``on_wedged``, when given, is called as
    ``on_wedged(op, ioctx)`` when a client op passes its deadline."""
    spec.validate()
    conf = conf or ConfigProxy()
    t_start = time.perf_counter()
    log(f"cluster: booting mon + {spec.n_osds} osds")
    cluster = await SimCluster.create(
        spec.n_osds, log=log,
        osd_config=spec.extra.get("osd_config"), device=device)
    device = cluster.mon.device
    report: dict = {"spec": spec.to_dict()}

    async def stage(name: str) -> None:
        if on_stage is not None:
            await on_stage(name, cluster, report)
    try:
        await _create_pool(cluster.addr, spec, device=device)
        bringup_s = time.perf_counter() - t_start
        log(f"cluster up in {bringup_s:.1f}s; pool '{spec.pool}' "
            f"({spec.pool_type}, pg_num={spec.pg_num})")
        await stage("boot")

        swarm = ClientSwarm(spec, cluster.addr, conf=conf, device=device)
        swarm.on_wedged = on_wedged
        await swarm.start()
        workload_before = WORKLOAD_PERF.dump()
        integrity_before = INTEGRITY_PERF.dump()
        placement_before = cluster.perf_counters("placement_cache")
        try:
            # -- load: materialize the working set ------------------------
            log(f"load: writing {spec.n_objects} objects")
            load = await swarm.preload()
            log(f"load: {load.ops} ops in {load.elapsed:.1f}s "
                f"({load.ops / max(load.elapsed, 1e-9):.0f} ops/s, "
                f"{load.failed} failed)")
            cluster.settle_heap()        # the working set is the heap now
            await stage("load")

            # -- steady: the production-shaped mix ------------------------
            steady_ops = spec.schedule(salt="steady")
            sched_before = cluster.scheduler_counters()
            log(f"steady: {len(steady_ops)} ops, mode={spec.mode}, "
                f"qps={spec.target_qps or 'unthrottled'}")
            steady = await swarm.run_phase(steady_ops, "steady")
            sched_steady = cluster.scheduler_counters()
            log(f"steady: {steady.ops} ops in {steady.elapsed:.1f}s "
                f"({steady.ops / max(steady.elapsed, 1e-9):.0f} ops/s,"
                f" {steady.failed} failed)")
            await stage("steady")

            # -- recovery interference ------------------------------------
            interference: dict | None = None
            rec_phases: dict = {}
            rec_qos: dict = {}
            if spec.recovery_ops > 0 and spec.kill_osds > 0:
                interference, rec_phases, rec_qos = \
                    await _recovery_phase(cluster, swarm, spec, conf,
                                          log, stage)
        finally:
            await swarm.shutdown()

        report["schedule"] = {
            "steady_ops": len(steady_ops),
            "steady_digest": spec.schedule_digest(steady_ops),
        }
        report["cluster"] = {
            "osds": spec.n_osds,
            "pool_type": spec.pool_type,
            "pg_num": spec.pg_num,
            "ec_k": spec.ec_k if spec.pool_type == "erasure" else None,
            "ec_m": spec.ec_m if spec.pool_type == "erasure" else None,
            "pg_states": cluster.pg_states(),
        }
        report["phases"] = {"load": load.to_dict(),
                            "steady": steady.to_dict()}
        for name, ph in rec_phases.items():
            report["phases"][name] = ph.to_dict()
        if interference is not None:
            report["interference"] = interference
        report["qos"] = {
            "steady": delta(sched_before, sched_steady),
            **rec_qos,
            "final": cluster.scheduler_counters(),
        }
        report["counters"] = {
            "workload_delta": delta(workload_before,
                                    WORKLOAD_PERF.dump()),
            "integrity_delta": delta(_numeric(integrity_before),
                                     _numeric(INTEGRITY_PERF.dump())),
            "placement_cache_delta": delta(
                placement_before,
                cluster.perf_counters("placement_cache")),
            "ec_batch": cluster.perf_counters("ec_batch"),
            "ec_degraded": cluster.perf_counters("ec_degraded"),
            "ec_pipeline": cluster.perf_counters("ec_pipeline"),
        }
        report["timing"] = {
            "bringup_s": round(bringup_s, 3),
            "total_s": round(time.perf_counter() - t_start, 3),
        }
        await stage("report")
        return report
    finally:
        await cluster.stop()


async def _recovery_phase(cluster: SimCluster, swarm: ClientSwarm,
                          spec: WorkloadSpec, conf: ConfigProxy,
                          log, stage) -> tuple[dict, dict, dict]:
    """Kill OSDs under live traffic, measure the client's view twice:

    * ``degraded`` — victims down, reads reconstruct from survivors
      (the degraded-read stall regime);
    * ``backfill`` — victims revived, client ops contend with the
      recovery pushes catching them up (the client-vs-recovery
      reservation/limit regime the dmClock scheduler arbitrates).
    """
    n_kill = min(spec.kill_osds,
                 int(conf.get("loadgen_kill_osds")) or spec.kill_osds,
                 len(cluster.osds) - 1)
    victims = []
    t_kill = time.perf_counter()
    # deterministic victims: the highest-index OSDs (the chaos
    # --kill-last convention), which hold shards like any other
    for j in range(n_kill):
        idx = len(cluster.osds) - 1 - j
        victim_id = cluster.osds[idx].whoami
        token = await cluster.kill_osd(idx)
        victims.append({"index": idx, "osd": victim_id,
                        "token": token})
        log(f"recovery: killed osd.{victim_id}")
    settle = float(conf.get("loadgen_recovery_settle"))
    detected = True
    for v in victims:
        if not await cluster.wait_down(v["osd"], timeout=settle):
            detected = False
            log(f"recovery: osd.{v['osd']} NOT marked down in "
                f"{settle:.0f}s")
    down_detect_s = time.perf_counter() - t_kill

    deg_ops = spec.schedule(n_ops=spec.recovery_ops, salt="degraded")
    sched0 = cluster.scheduler_counters()
    log(f"degraded: driving {len(deg_ops)} ops with "
        f"{len(victims)} osd(s) down")
    degraded = await swarm.run_phase(deg_ops, "degraded")
    sched1 = cluster.scheduler_counters()
    log(f"degraded: {degraded.ops} ops in {degraded.elapsed:.1f}s "
        f"({degraded.failed} failed, {degraded.wedged} wedged)")
    await stage("degraded")

    revived = True
    for v in reversed(victims):
        await cluster.revive_osd(v["index"], v["token"])
        if not await cluster.wait_up(v["osd"], timeout=30.0):
            revived = False
    bf_ops = spec.schedule(n_ops=spec.recovery_ops, salt="backfill")
    log(f"backfill: driving {len(bf_ops)} ops while recovery "
        f"catches the revived osd(s) up")
    backfill = await swarm.run_phase(bf_ops, "backfill")
    sched2 = cluster.scheduler_counters()
    log(f"backfill: {backfill.ops} ops in {backfill.elapsed:.1f}s "
        f"({backfill.failed} failed)")
    await stage("backfill")
    clean = await cluster.wait_clean(timeout=30.0) if revived else False
    interference = {
        "victims": [v["osd"] for v in victims],
        "down_detected": detected,
        "down_detect_s": round(down_detect_s, 3),
        "revived": revived,
        "clean_after_revive": clean,
        "recovery_schedule_digest": spec.schedule_digest(deg_ops),
        "backfill_schedule_digest": spec.schedule_digest(bf_ops),
    }
    phases = {"degraded": degraded, "backfill": backfill}
    qos = {"degraded": delta(sched0, sched1),
           "backfill": delta(sched1, sched2)}
    return interference, phases, qos


def degradation_ratios(report: dict, phase: str = "degraded") -> dict:
    """p99 during an interference phase vs steady, per op class
    (>=1.0 means the kill made clients slower -- the macro number
    later perf PRs move)."""
    out: dict[str, float] = {}
    phases = report.get("phases", {})
    steady = phases.get("steady", {}).get("timing", {}) \
                   .get("latency", {})
    rec = phases.get(phase, {}).get("timing", {}) \
                .get("latency", {})
    for kind, lat in rec.items():
        base = steady.get(kind, {}).get("p99_s")
        if base and lat.get("p99_s"):
            out[kind] = round(lat["p99_s"] / base, 2)
    return out


def deterministic_view(report: dict) -> dict:
    """The seed-reproducible half of a report: spec, schedules, op and
    byte tallies — everything except wall-clock-dependent fields.
    Two runs with the same spec must agree on this byte-for-byte."""
    phases = {
        name: {k: v for k, v in ph.items() if k != "timing"}
        for name, ph in report.get("phases", {}).items()
    }
    view = {"spec": report.get("spec"),
            "schedule": report.get("schedule"),
            "phases": phases}
    interference = report.get("interference")
    if interference:
        view["interference"] = {
            "victims": interference.get("victims"),
            "recovery_schedule_digest":
                interference.get("recovery_schedule_digest"),
        }
    return view


def cluster_gates(report: dict) -> list[str]:
    """What a run of ``run_workload`` must not show, one line each
    (``bench.py --cluster``'s gates): failed or wedged client ops, a
    kill/revive the interference phase never saw, a degenerate latency
    distribution, no client dispatch in the scheduler, and, with the
    write pipeline on, pipeline counters that never moved."""
    spec = report["spec"]
    phases = report["phases"]
    failed = sum(ph.get("failed_ops", 0) for ph in phases.values())
    wedged = sum(ph.get("wedged_ops", 0) for ph in phases.values())
    out = []
    if failed or wedged:
        out.append(f"{failed} failed / {wedged} wedged client ops")
    interference = report.get("interference") or {}
    if spec["recovery_ops"] and spec["kill_osds"] and not (
            interference.get("down_detected")
            and interference.get("revived")):
        out.append("interference phase never saw the kill/revive")
    for kind, lat in phases["steady"]["timing"]["latency"].items():
        if lat["count"] and lat["p50_s"] > lat["max_s"]:
            out.append(f"degenerate {kind} latency distribution")
    if not report["qos"].get("steady", {}).get("dispatched_client"):
        out.append("scheduler perf set recorded no client dispatch")
    osd_config = (spec.get("extra") or {}).get("osd_config") or {}
    pipe = report["counters"].get("ec_pipeline", {})
    if spec["pool_type"] != "erasure":
        pass                     # the write pipeline is the EC backend's
    elif osd_config.get("osd_pipeline_enabled", True):
        for key in ("staged_batches", "overlapped_commits",
                    "commit_overlap_ms", "flush_windows"):
            if not pipe.get(key):
                out.append(f"pipeline on but ec_pipeline.{key} never "
                           f"moved (serial chain leaked through?)")
    elif pipe.get("staged_batches") or pipe.get("overlapped_commits"):
        out.append("kill switch off but the pipeline still staged")
    return out
