"""osdmaptool analog (src/tools/osdmaptool.cc): offline OSDMap
inspection and placement simulation.

    # a map as `osd dump` writes it (OSDMap.to_dict), then work offline
    python -m ceph_tpu_torch.tools.osdmaptool map.json --print
    python -m ceph_tpu_torch.tools.osdmaptool map.json --test-map-pgs
    python -m ceph_tpu_torch.tools.osdmaptool map.json --upmap out.txt

--test-map-pgs maps every PG of every pool through the placement
pipeline and prints the per-OSD distribution (the reference's
workload-simulation mode); --upmap computes balancer upmap items and
writes the equivalent CLI commands (osdmaptool --upmap).

Port of ``ceph_tpu/tools/osdmaptool.py``, with the same output: the table
is built on ``--device`` (cuda by default, or cpu), and --test-map-pgs
counts from its arrays.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from ..mon.osdmap import OSDMap


def load_map(path: str, device=None) -> OSDMap:
    with open(path) as f:
        return OSDMap.from_dict(json.load(f), device=device)


def cmd_print(m: OSDMap) -> None:
    print(f"epoch {m.epoch}")
    print(f"max_osd {m.max_osd}")
    for pid, pool in sorted(m.pools.items()):
        print(f"pool {pid} '{pool.name}' type {pool.type} "
              f"size {pool.size} min_size {pool.min_size} "
              f"pg_num {pool.pg_num}")
    for o, info in sorted(m.osds.items()):
        state = ("up" if info.up else "down") + \
                ("+in" if info.in_cluster else "+out")
        print(f"osd.{o} {state} weight "
              f"{info.weight / 0x10000:.5f} host {info.host}")
    if m.pg_temp:
        print(f"pg_temp entries: {len(m.pg_temp)}")
    if m.pg_upmap_items:
        print(f"pg_upmap_items entries: {len(m.pg_upmap_items)}")


def cmd_test_map_pgs(m: OSDMap, pool_filter: int | None) -> None:
    total = 0
    sizes = np.zeros(0, dtype=np.int64)
    seen = []                       # per pool: the live acting entries
    # one bulk table build, then array reads -- the exact cached
    # pipeline (upmap, pg_temp, down-filter) clients are routed by
    for pid, (_up, _up_len, acting, acting_len) in \
            m.placement_cache().tables().items():
        if pool_filter is not None and pid != pool_filter:
            continue
        keep = ((np.arange(acting.shape[1]) < acting_len[:, None])
                & (acting >= 0))
        total += acting.shape[0]
        per_pg = np.bincount(keep.sum(axis=1))
        sizes = np.pad(sizes, (0, max(0, per_pg.size - sizes.size)))
        sizes[:per_pg.size] += per_pg
        seen.append(acting[keep])
    print(f"pool pg count: {total}")
    for size in np.nonzero(sizes)[0]:
        print(f"size {size}\t{sizes[size]}")
    osds = np.concatenate(seen) if seen else np.zeros(0, np.int32)
    if osds.size:
        ids, first, n = np.unique(osds, return_index=True, return_counts=True)
        counts = dict(zip(ids.tolist(), n.tolist()))
        # the statistics sum in the order OSDs first appear, as a dict
        # filled row by row does
        vals = [counts[o] for o in ids[np.argsort(first)].tolist()]
        avg = sum(vals) / len(vals)
        dev = (sum((v - avg) ** 2 for v in vals) / len(vals)) ** 0.5
        for o in sorted(counts):
            print(f"osd.{o}\t{counts[o]}")
        print(f"avg {avg:.1f} stddev {dev:.2f} "
              f"min {min(vals)} max {max(vals)}")


def cmd_upmap(m: OSDMap, out_path: str, max_items: int) -> None:
    from ..mgr.balancer import compute_upmaps
    upmaps = compute_upmaps(m, max_moves=max_items)
    lines = []
    for pgid, items in sorted(upmaps.items()):
        pairs = " ".join(f"{a} {b}" for a, b in items)
        lines.append(f"ceph osd pg-upmap-items {pgid} {pairs}")
    out = "\n".join(lines) + ("\n" if lines else "")
    if out_path == "-":
        sys.stdout.write(out)
    else:
        with open(out_path, "w") as f:
            f.write(out)
    print(f"wrote {len(lines)} upmap item commands", file=sys.stderr)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="osdmaptool")
    p.add_argument("map", help="osdmap json (ceph osd dump output)")
    p.add_argument("--print", action="store_true", dest="do_print")
    p.add_argument("--test-map-pgs", action="store_true")
    p.add_argument("--pool", type=int)
    p.add_argument("--upmap", metavar="FILE")
    p.add_argument("--upmap-max", type=int, default=10)
    p.add_argument("--device", default="cuda",
                   help="where the placement table is built: cuda "
                        "(default) or cpu")
    args = p.parse_args(argv)
    m = load_map(args.map, device=args.device)
    did = False
    if args.do_print:
        cmd_print(m)
        did = True
    if args.test_map_pgs:
        cmd_test_map_pgs(m, args.pool)
        did = True
    if args.upmap:
        cmd_upmap(m, args.upmap, args.upmap_max)
        did = True
    if not did:
        cmd_print(m)
    return 0


if __name__ == "__main__":
    sys.exit(main())
