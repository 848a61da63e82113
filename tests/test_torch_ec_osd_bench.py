"""``ceph_tpu_torch.tools.ec_osd_bench`` against ``ceph_tpu``'s.

The port's OSD-path bench runs the reference's bench on the port's
cluster (``device="cpu"``, the ``cuda`` plugin): the same JSON fields, the
same stripes encoded; its ``ClusterDrive`` runs the whole EC data path
(writes, reads, kill, degraded reads and write, revive and recovery,
scrub) with every read equal to its source; the command line defaults to
the card.
"""

import asyncio
import json

import pytest
import torch

from ceph_tpu.tools import ec_osd_bench as ref_bench
from ceph_tpu_torch.tools import ec_osd_bench

torch.set_num_threads(1)

SMALL = dict(n_osds=3, k=2, m=1, n_objects=8, obj_bytes=20 << 10,
             concurrency=4, pg_num=4, rounds=1)


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def test_osd_path_bench_matches_the_reference():
    ref = run(ref_bench.run_osd_path_bench(**SMALL))
    port = run(ec_osd_bench.run_osd_path_bench(**SMALL, device="cpu"))
    assert set(port) == set(ref)
    assert set(port["mesh"]) == set(ref["mesh"])
    assert set(port["xor_sched"]) == set(ref["xor_sched"])
    # timing-free: every write's stripes are encoded once, no fallback
    per_obj = -(-SMALL["obj_bytes"] // (SMALL["k"] * 4096))
    want = (SMALL["rounds"] + 1) * SMALL["n_objects"] * per_obj
    assert port["stripes"] == ref["stripes"] == want
    for key in ("fallback_ops", "n_osds", "k", "m", "objects",
                "obj_bytes", "concurrency", "rounds"):
        assert port[key] == ref[key], key
    assert port["mesh"]["fallbacks"] == ref["mesh"]["fallbacks"] == 0
    assert port["mesh"]["launches"] == port["batches"] > 0
    assert port["writes_per_s"] > 0


def test_cluster_drive_runs_the_whole_path_on_the_cpu():
    drive = ec_osd_bench.ClusterDrive(
        n_osds=6, k=3, m=2, pg_num=4, n_objects=6, obj_bytes=40 << 10,
        concurrency=3, rounds=1, device="cpu",
        osd_config={"osd_heartbeat_interval": 0.2})

    async def main():
        try:
            await drive.boot()
            await asyncio.wait_for(drive.run(), 90)
            return drive.summary()
        finally:
            await drive.stop()
    res = run(main())
    assert res["mismatches"] == 0 and not res["scrub_inconsistent"]
    assert res["scrub_objects"] == 6
    assert res["stripes"] == 6 * -(-(40 << 10) // (3 * 4096))
    assert res["stripes_per_launch"] > 1
    assert res["recovery_s"] > 0 and res["degraded_read_GiBps"] > 0
    # the revived OSD holds the shards it missed, at their new bytes
    revived = drive.revived_osd()
    held = [(c, o) for c in revived.store.list_collections()
            if c.startswith(f"pg_{drive.pool_id}.")
            for o in revived.store.list_objects(c) if not o.startswith("_")]
    assert held


def test_cli_prints_the_reference_fields(capsys):
    rc = ec_osd_bench.main(["--device", "cpu", "--objects", "4",
                            "--obj-kib", "8", "--rounds", "1"])
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {"osd_path_GiBps", "stripes_per_launch", "flush_reasons",
            "mesh", "ec_pipeline"} <= set(line)
    assert line["stripes"] == 2 * 4 * 1


def test_cli_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ec_osd_bench.main(["--objects", "1"])
