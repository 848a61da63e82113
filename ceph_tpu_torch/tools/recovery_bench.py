"""Recovery bench rig: repair I/O under RS vs LRC vs PMSR.

The same kill -> degraded-write -> revive -> recover drive
(``chaos.recovery_round``) run once per code family on identical
seeds and object sets, reporting what each code's recovery actually
MOVED (the ``ec_recovery`` counters: repair bytes read from surviving
shards vs bytes shipped to the rebuilt shard) and the recovery wall
clock.  RS repair reads k full chunks per lost shard; LRC reads the
local group (l chunks); product-matrix MSR gathers d beta-sized
fragments (d/alpha = 2 chunks' worth).  The measured read/shipped
ratios are the artifact -- ``bench.py --recovery`` gates on them:

  * zero failed/wedged ops and byte-identical read-back through every
    kill/recover drive (verified against a survivor kill, so reads
    MUST decode through the recovered shards);
  * LRC single-failure repair reads <= 0.5x the RS byte ratio at the
    k=8-class config (l=3 -> 3 reads vs 8);
  * PMSR helper traffic strictly under k full chunks per rebuilt
    shard (fragment pulls counted, not assumed).

``recovery_gates`` lists the gates a result fails.  Port of
``ceph_tpu/tools/recovery_bench.py``: every cluster runs on ``device``
(CUDA unless the caller names the CPU), the RS pools on the ``cuda``
plugin, and the module has a CLI:

    python -m ceph_tpu_torch.tools.recovery_bench            # bench.py's sizes
    python -m ceph_tpu_torch.tools.recovery_bench --smoke --device cpu

It prints the result as one JSON line and exits 1 when a gate fails.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import random
import sys
import time

from .chaos import ChaosCluster, recovery_round

# heartbeats tuned like the chaos driver: fast detection, no auto-out
_MON_CONFIG = {"mon_osd_down_out_interval": 3600.0}
_OSD_CONFIG = {"osd_heartbeat_interval": 0.2,
               "osd_heartbeat_grace": 3.0}


def code_configs(smoke: bool) -> list[dict]:
    """The comparison set.  Widths differ per code (that is the
    point); every drive gets width-many OSDs and the same seed.  The
    smoke set keeps the LRC shape in the k=8 class (l/k = 3/8 <= 0.5
    is the acceptance ratio) but trims objects/sizes to tier-1 cost;
    the full set grows the working set."""
    if smoke:
        # trimmed widths (25 OSDs total instead of 41) with the SAME
        # ratio contracts: l/k = 2/4 = 0.5 (the gate boundary -- the
        # counters are deterministic, so exact equality holds) and
        # d/alpha = 4/2 = 2 < k = 3
        lrc = {"name": "lrc", "plugin": "lrc", "k": 4, "m": 4,
               "extra": {"l": 2}, "expect_read_chunks": 2}
        pmsr = {"name": "pmsr", "plugin": "pmsr", "k": 3, "m": 2,
                "extra": {}, "expect_read_chunks": 2}
        rs = {"name": "rs", "plugin": "cuda", "k": 4, "m": 4,
              "extra": {}, "expect_read_chunks": 4}
        return [rs, lrc, pmsr]
    lrc = {"name": "lrc", "plugin": "lrc", "k": 8, "m": 4,
           "extra": {"l": 3}, "expect_read_chunks": 3}
    pmsr = {"name": "pmsr", "plugin": "pmsr", "k": 5, "m": 4,
            "extra": {}, "expect_read_chunks": 2}  # d/alpha = 8/4
    rs = {"name": "rs", "plugin": "cuda", "k": 8, "m": 4,
          "extra": {}, "expect_read_chunks": 8}
    return [rs, lrc, pmsr]


async def drive_code(code_spec: dict, *, n_objects: int, obj_size: int,
                     pg_num: int, seed: int, log, device=None,
                     on_stage=None) -> dict:
    """One code's drive on a cluster of its own, width-many OSDs on
    ``device``.  ``on_stage``, when given, is awaited as ``on_stage(
    "report", c, result)`` on the live cluster after the drive, before it
    stops (``run_workload``'s last stage)."""
    k, m = code_spec["k"], code_spec["m"]
    from ..device import resolve_device
    from ..ec import registry
    device = resolve_device(device)
    profile = {"k": str(k), "m": str(m),
               **{kk: str(vv) for kk, vv in code_spec["extra"].items()}}
    width = registry().factory(code_spec["plugin"], dict(profile),
                               device=device).get_chunk_count()
    n_osds = width
    log(f"  [{code_spec['name']}] {code_spec['plugin']} k={k} m={m} "
        f"{code_spec['extra']} width={width} ({n_osds} osds)")
    c = await ChaosCluster.create(n_osds, mon_config=dict(_MON_CONFIG),
                                  osd_config=dict(_OSD_CONFIG),
                                  device=device)
    try:
        await c.create_ec_pool("recpool", k, m, pg_num,
                               plugin=code_spec["plugin"],
                               profile_extra=code_spec["extra"])
        t0 = time.perf_counter()
        res = await recovery_round(
            c, rnd=random.Random(seed), pool="recpool",
            n_objects=n_objects, obj_size=obj_size,
            kill_indices=[n_osds - 1], log=log)
        rep = res.get("repair", {})
        read = rep.get("repair_bytes_read", 0)
        shipped = rep.get("repair_bytes_shipped", 0)
        out = {
            "code": code_spec["name"], "plugin": code_spec["plugin"],
            "k": k, "m": m, **code_spec["extra"], "width": width,
            "n_objects": res["n_objects"],
            "repair_bytes_read": read,
            "repair_bytes_shipped": shipped,
            "repair_GiB_read": round(read / 2**30, 6),
            "repair_GiB_shipped": round(shipped / 2**30, 6),
            "read_per_shipped": round(read / shipped, 3)
            if shipped else 0.0,
            "expect_read_chunks": code_spec["expect_read_chunks"],
            "repair_reads": rep.get("repair_reads", 0),
            "repair_local_repairs": rep.get("repair_local_repairs",
                                            0),
            "repair_global_decodes": rep.get("repair_global_decodes",
                                             0),
            "repair_fragment_pulls": rep.get("repair_fragment_pulls",
                                             0),
            "recovery_wall_s": res.get("recovery_wall_s", 0.0),
            "drive_wall_s": round(time.perf_counter() - t0, 3),
            "recovered_clean": res.get("recovered_clean", False),
            "mismatched": res["mismatched"],
            "errors": res["errors"],
        }
        log(f"  [{code_spec['name']}] read/shipped="
            f"{out['read_per_shipped']}x (expect ~"
            f"{code_spec['expect_read_chunks']}), wall="
            f"{out['recovery_wall_s']}s")
        if on_stage is not None:
            await on_stage("report", c, out)
        return out
    finally:
        await c.stop()


async def run_recovery_bench(*, n_objects: int = 8,
                             obj_size: int = 64 << 10,
                             pg_num: int = 8, seed: int = 7,
                             smoke: bool = False,
                             log=print, device=None) -> dict:
    codes = {}
    for code_spec in code_configs(smoke):
        codes[code_spec["name"]] = await drive_code(
            code_spec, n_objects=n_objects, obj_size=obj_size,
            pg_num=pg_num, seed=seed, log=log, device=device)
    return recovery_summary(codes, {"n_objects": n_objects,
                                    "obj_size": obj_size,
                                    "pg_num": pg_num, "seed": seed})


def recovery_summary(codes: dict, spec: dict) -> dict:
    """The bench's result from the three codes' drives."""
    rs, lrc, pmsr = codes["rs"], codes["lrc"], codes["pmsr"]
    ratio = (lrc["read_per_shipped"] / rs["read_per_shipped"]
             if rs["read_per_shipped"] else 0.0)
    return {
        "spec": spec,
        "codes": codes,
        "lrc_vs_rs_read_ratio": round(ratio, 3),
        "pmsr_read_chunks": pmsr["read_per_shipped"],
        "failed_objects": sum(len(c["mismatched"])
                              for c in codes.values()),
        "errors": sum(len(c["errors"]) for c in codes.values()),
    }


def recovery_gates(res: dict) -> list[str]:
    """The gates of ``bench.py --recovery`` a result fails, one line
    each."""
    codes = res["codes"]
    out = []
    if res["failed_objects"] or res["errors"]:
        out.append(f"{res['failed_objects']} corrupt/wedged objects, "
                   f"{res['errors']} drive errors")
    for name, c in codes.items():
        if not c["recovered_clean"]:
            out.append(f"{name} recovery never converged")
        if not c["repair_bytes_shipped"]:
            out.append(f"{name} recovery shipped no counted bytes")
    if res["lrc_vs_rs_read_ratio"] > 0.5 \
            or not res["lrc_vs_rs_read_ratio"]:
        out.append(f"lrc repair reads {res['lrc_vs_rs_read_ratio']}x "
                   f"of RS (gate: <= 0.5x)")
    if not (0 < res["pmsr_read_chunks"] < codes["pmsr"]["k"]):
        out.append(f"pmsr helper traffic {res['pmsr_read_chunks']} "
                   f"chunks not under k={codes['pmsr']['k']}")
    if not codes["pmsr"]["repair_fragment_pulls"]:
        out.append("pmsr recovery never took the fragment path")
    if not codes["lrc"]["repair_local_repairs"]:
        out.append("lrc recovery never repaired locally")
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ceph_tpu_torch.tools.recovery_bench",
        description="repair I/O under RS vs LRC vs PMSR")
    p.add_argument("--smoke", action="store_true",
                   help="the trimmed widths and bench.py --recovery "
                        "--smoke's sizes (4 objects of 32 KiB, pg_num 8)")
    p.add_argument("--objects", type=int, default=None,
                   help="objects a drive (default 16; 4 with --smoke)")
    p.add_argument("--obj-kib", type=int, default=None,
                   help="object size (default 128; 32 with --smoke)")
    p.add_argument("--pg-num", type=int, default=None,
                   help="the pool's pg_num (default 16; 8 with --smoke)")
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--device", default="cuda",
                   help="the daemons' device: cuda (the card) or cpu "
                        "(the kernels' plain versions)")
    p.add_argument("--quiet", action="store_true")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    objects, kib, pg_num = (4, 32, 8) if args.smoke else (16, 128, 16)

    def log(msg: str) -> None:
        if not args.quiet:
            print(msg, file=sys.stderr, flush=True)

    res = asyncio.new_event_loop().run_until_complete(run_recovery_bench(
        n_objects=args.objects or objects,
        obj_size=(args.obj_kib or kib) << 10,
        pg_num=args.pg_num or pg_num, seed=args.seed, smoke=args.smoke,
        log=log, device=args.device))
    print(json.dumps(res), flush=True)
    errors = recovery_gates(res)
    for err in errors:
        print(f"ERROR: {err}", file=sys.stderr, flush=True)
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
