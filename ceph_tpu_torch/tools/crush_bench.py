"""BASELINE config 5: bulk CRUSH placement throughput on the card.

Times kernel K5 (``crush/vectorized.py``, ``csrc/crush.cu``) computing
PG->OSD mappings for a large PG population over a 1000-OSD depth-4
crushmap (root -> 5 rows -> 5 racks -> 4 hosts -> 10 OSDs) -- the
OSDMapMapping / ParallelPGMapper job (src/osd/OSDMapMapping.h:175) the
reference spreads over a thread pool, here one launch per batch.  The
seeds are staged on the card once; CUDA events time the batches after a
warm launch.  ``--verify`` lanes are held against the scalar engine
first.  Prints ONE JSON line:

  {"metric": "crush_bulk_mappings_per_s", "value": ..., "unit": "pg/s",
   "n_mappings": ..., "n_osds": ..., "lane_exact_vs_scalar": true, ...}

Usage: python -m ceph_tpu_torch.tools.crush_bench [--pgs 10000000]
       [--osds 1000] [--replicas 3] [--rule {0,1}] [--verify 512]
       [--batch 2000000] [--device cuda]

``--rule 1`` is the erasure rule (chooseleaf indep, chooseleaf tries 5,
choose tries 100); give it ``--replicas 11`` for an RS k=8,m=3 PG.
``--device cpu`` runs the plain PyTorch version on the host clock (the
CPU tests' size); its rate is the CPU's, not the card's.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..crush import crush_do_rule
from ..crush.builder import build_hierarchy
from ..crush.types import CRUSH_ITEM_NONE
from ..crush.vectorized import VectorCrush
from ..device import resolve_device


def config5_map(osds: int):
    """The depth-4 map of ``osds`` OSDs (10 a host, 4 hosts a rack, 5 racks
    a row) and its OSD count."""
    osds_per_host = 10
    hosts = max(1, osds // osds_per_host)
    racks = max(1, hosts // 4)
    rows = max(1, racks // 5)
    fanouts = [rows, max(1, racks // rows), max(1, hosts // racks),
               osds_per_host]
    return build_hierarchy(fanouts), int(np.prod(fanouts)), fanouts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pgs", type=int, default=10_000_000)
    ap.add_argument("--osds", type=int, default=1000)
    ap.add_argument("--replicas", type=int, default=3)
    ap.add_argument("--rule", type=int, choices=(0, 1), default=0,
                    help="0: replicated chooseleaf firstn; 1: erasure "
                         "chooseleaf indep")
    ap.add_argument("--verify", type=int, default=512,
                    help="lanes cross-checked against the scalar engine")
    ap.add_argument("--batch", type=int, default=2_000_000,
                    help="lanes per launch")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain version)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cm, n_osds, fanouts = config5_map(args.osds)
    weights = [0x10000] * n_osds
    vc = VectorCrush(cm, args.rule, device=dev)
    rng = np.random.default_rng(0)
    # pps values as the balancer would feed them (hashed placement seeds)
    xs = rng.integers(0, 2**31 - 1, size=args.pgs, dtype=np.int64)

    # lane-exactness gate vs the scalar decision-level engine
    sample = xs[:args.verify]
    got = vc.map_pgs(sample, args.replicas, weights)
    for i, x in enumerate(sample):
        want = crush_do_rule(cm, args.rule, int(x), args.replicas, weights)
        want += [CRUSH_ITEM_NONE] * (args.replicas - len(want))
        if list(got[i]) != want:
            print(json.dumps({"metric": "crush_bulk_mappings_per_s",
                              "value": 0, "unit": "pg/s",
                              "error": f"lane {i} mismatch"}))
            return 1

    batch = min(args.batch, args.pgs)
    n_batches = args.pgs // batch
    # all seeds staged once (the pg population lives on the card); every
    # timed launch maps a different batch
    seeds = torch.from_numpy(xs[:batch * n_batches].astype(np.int32)).to(dev)
    batches = seeds.view(n_batches, batch)
    w = vc.device_weights(weights)
    vc.map_device(batches[0], args.replicas, w)          # build + warm
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for b in batches:
            vc.map_device(b, args.replicas, w)
        end.record()
        end.synchronize()
        dt = start.elapsed_time(end) / 1e3
        kind = torch.cuda.get_device_name(dev)
    else:
        t0 = time.perf_counter()
        for b in batches:
            vc.map_device(b, args.replicas, w)
        dt = time.perf_counter() - t0
        kind = "cpu"
    total = batch * n_batches
    print(json.dumps({
        "metric": "crush_bulk_mappings_per_s",
        "value": total / dt,
        "unit": "pg/s",
        "n_mappings": total,
        "n_osds": n_osds, "depth": len(fanouts), "fanouts": fanouts,
        "rule": args.rule, "replicas": args.replicas,
        "batch": batch,
        "launches": n_batches,
        "ms_per_launch": dt * 1e3 / n_batches,
        "elapsed_s": dt,
        "device": {"platform": "gpu" if dev.type == "cuda" else "cpu",
                   "kind": kind},
        "lane_exact_vs_scalar": True,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
