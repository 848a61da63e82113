"""CLI: python -m ceph_tpu_torch.loadgen [--osds 8 --objects 1000 ...]

Runs one WorkloadSpec through the driver and prints the JSON report
(progress to stderr); exits 1 when a gate of ``cluster_gates`` fails.
The cluster runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys

from .driver import cluster_gates, degradation_ratios, run_workload
from .spec import WorkloadSpec


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="ceph_tpu_torch.loadgen")
    p.add_argument("--osds", type=int, default=8)
    p.add_argument("--pg-num", type=int, default=64)
    p.add_argument("--pool-type", default="erasure",
                   choices=["erasure", "replicated"])
    p.add_argument("--k", type=int, default=2)
    p.add_argument("--m", type=int, default=1)
    p.add_argument("--size", type=int, default=3,
                   help="replica count (replicated pools)")
    p.add_argument("--objects", type=int, default=1000)
    p.add_argument("--obj-kib", type=int, default=16)
    p.add_argument("--size-dist", default="fixed",
                   choices=["fixed", "uniform", "lognormal"])
    p.add_argument("--ops", type=int, default=2000)
    p.add_argument("--read-frac", type=float, default=0.5)
    p.add_argument("--write-frac", type=float, default=0.35)
    p.add_argument("--rmw-frac", type=float, default=0.15)
    p.add_argument("--popularity", default="zipf",
                   choices=["zipf", "uniform"])
    p.add_argument("--zipf-s", type=float, default=1.1)
    p.add_argument("--clients", type=int, default=16)
    p.add_argument("--mode", default="closed",
                   choices=["closed", "open"])
    p.add_argument("--qps", type=float, default=0.0)
    p.add_argument("--recovery-ops", type=int, default=0,
                   help="ops per interference sub-phase (0 = skip "
                        "the kill/revive phases)")
    p.add_argument("--kill-osds", type=int, default=1)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--device", default="cuda",
                   help="the daemons' device: cuda (the card) or cpu "
                        "(the kernels' plain versions)")
    p.add_argument("--quiet", action="store_true")
    return p


def spec_from_args(args) -> WorkloadSpec:
    return WorkloadSpec(
        n_osds=args.osds, pg_num=args.pg_num,
        pool_type=args.pool_type, ec_k=args.k, ec_m=args.m,
        replica_size=args.size,
        n_objects=args.objects, obj_size=args.obj_kib * 1024,
        size_dist=args.size_dist,
        n_ops=args.ops, read_frac=args.read_frac,
        write_frac=args.write_frac, rmw_frac=args.rmw_frac,
        popularity=args.popularity, zipf_s=args.zipf_s,
        n_clients=args.clients, mode=args.mode, target_qps=args.qps,
        recovery_ops=args.recovery_ops, kill_osds=args.kill_osds,
        seed=args.seed).validate()


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    def log(msg: str) -> None:
        if not args.quiet:
            print(msg, file=sys.stderr, flush=True)

    report = asyncio.new_event_loop().run_until_complete(
        run_workload(spec_from_args(args), log=log, device=args.device))
    report["p99_degradation"] = {
        phase: degradation_ratios(report, phase)
        for phase in ("degraded", "backfill")
        if phase in report.get("phases", {})}
    print(json.dumps(report, indent=1), flush=True)
    errors = cluster_gates(report)
    for err in errors:
        print(f"ERROR: {err}", file=sys.stderr, flush=True)
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
