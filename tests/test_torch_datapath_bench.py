"""The port's datapath bench (``ceph_tpu_torch/tools/datapath_bench.py``)
against ceph_tpu's at ``bench.py --datapath --smoke``'s sizes.

Both rigs drive write -> read-verify -> scrub -> degraded read over real
BlockStores, with the shard cache and without; the port's on
``device="cpu"`` (its cached scrub verifies the shards' device views with
K4's plain version).  The port's gates must hold, and its steady datapath
counters -- hits, misses, host reads and bytes, bytes avoided, evictions,
per drive -- must equal the reference's exactly.
"""

import asyncio
import json
import os

import pytest
import torch

from ceph_tpu.tools.datapath_bench import \
    run_datapath_bench as ref_run_datapath_bench
from ceph_tpu_torch.tools import datapath_bench as dp

torch.set_num_threads(1)

STEADY = ("hits", "misses", "host_reads", "host_bytes_read",
          "host_bytes_avoided", "evictions")


def run(coro):
    return asyncio.new_event_loop().run_until_complete(coro)


def _steady(drive: dict) -> dict:
    return {key: sum(ph["counters"][key] for name, ph in
                     drive["phases"].items() if not name.startswith("write"))
            for key in STEADY}


@pytest.fixture(scope="module")
def both():
    port = run(dp.run_datapath_bench(**dp.SMOKE, device="cpu"))
    ref = run(ref_run_datapath_bench(**dp.SMOKE))
    return port, ref


def test_gates_hold_and_steady_counters_equal_the_reference(both):
    port, ref = both
    assert dp.gate_failures(port) == []
    assert port["parity"] == "ok" and port["cache_hits"] > 0
    assert port["steady_host_bytes_read"] == 0
    assert port["scalar_calls_on_batched_paths"] == 0
    for run_key in ("cached_run", "baseline_run"):
        assert _steady(port[run_key]) == _steady(ref[run_key]), run_key
    for key in ("cache_hits", "steady_host_bytes_read", "steady_host_reads",
                "host_bytes_avoided", "scalar_calls_on_batched_paths"):
        assert port[key] == ref[key], key
    assert list(port["cached_run"]["phases"]) == \
        list(ref["cached_run"]["phases"])


def test_cached_scrub_uploads_each_shard_once(both):
    """The first cached scrub uploads every resident shard's device view;
    later scrubs and the other phases upload nothing."""
    port, _ = both
    phases = port["cached_run"]["phases"]
    shards = (dp.SMOKE["k"] + dp.SMOKE["m"]) * dp.SMOKE["n_objects"]
    uploads = {name: ph["counters"]["device_uploads"]
               for name, ph in phases.items()}
    assert uploads.pop("scrub_0") == shards
    assert set(uploads.values()) == {0}
    assert all(ph["counters"]["device_uploads"] == 0 for ph in
               port["baseline_run"]["phases"].values())
    assert {"encode_s", "commit_s"} <= set(phases["write"])
    assert {"views_s", "sweep_s"} <= set(phases["scrub_1"])
    batch = port["cached_run"]["ec_batch"]
    assert batch.get("fallback_ops", 0) == 0
    assert batch.get("crc_host_batches", 0) == 0
    assert batch["crc_fused_launches"] >= 1


def test_drives_live_under_the_temporary_directory_and_clean_up(
        monkeypatch, tmp_path):
    """Every drive's stores go to a new directory under the temporary
    directory (which follows TMPDIR) and are removed when the drive ends; a
    directory without room for a drive is refused before the drive
    starts."""
    made = []
    real = dp.bench_dir

    def bench_dir(need, root=None):
        made.append(real(need, root))
        return made[-1]
    monkeypatch.setattr(dp, "bench_dir", bench_dir)
    monkeypatch.setattr(dp.tempfile, "tempdir", str(tmp_path))
    res = run(dp.run_datapath_bench(**{**dp.SMOKE, "passes": 1,
                                       "reads_per_pass": 1}, device="cpu"))
    assert dp.gate_failures(res) == []
    assert len(made) == 3
    assert all(os.path.dirname(d) == str(tmp_path) for d in made)
    assert not any(os.path.exists(d) for d in made)

    class Full:
        free = 1 << 20
    monkeypatch.setattr(dp.shutil, "disk_usage", lambda path: Full)
    with pytest.raises(RuntimeError, match="need"):
        real(2 << 20)
    assert list(tmp_path.iterdir()) == []


def test_a_drive_in_pieces_is_the_drive(tmp_path):
    """``_Rig`` + ``drive_phases`` + ``drive_report``, as a caller that
    inspects the open rig drives them, give the drive's counters and
    reads; the rig still holds every shard resident before it closes."""
    sizes = {**dp.SMOKE, "passes": 1, "reads_per_pass": 1}
    whole = run(dp._drive(True, **sizes, stripe_unit=4096, device="cpu",
                          base_dir=str(tmp_path / "whole")))
    rig = dp._Rig(sizes["k"], sizes["m"], 4096, True, str(tmp_path / "parts"),
                  device="cpu")
    try:
        phases, digests = run(dp.drive_phases(
            rig, dp.source_objects(sizes["n_objects"], sizes["obj_bytes"]),
            passes=1, reads_per_pass=1))
        assert all(len(st.shard_cache) == sizes["n_objects"]
                   for st in rig.stores)
        ec_batch = rig.batcher.perf.dump()
    finally:
        rig.close()
    parts = dp.drive_report(True, phases, ec_batch, digests)
    assert parts["digests"] == whole["digests"]
    assert list(parts["phases"]) == list(whole["phases"])
    for name, ph in parts["phases"].items():
        assert ph["counters"] == whole["phases"][name]["counters"], name
    assert parts["steady_counters"] == whole["steady_counters"]


def test_cli_prints_the_reference_fields(capsys):
    assert dp.main(["--device", "cpu", "--smoke"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "datapath_write_scrub_degraded_GiBps"
    assert line["smoke"] is True and line["parity"] == "ok"
    for key in ("value", "vs_baseline", "baseline_GiBps", "cache_hits",
                "steady_host_bytes_read", "steady_host_reads",
                "host_bytes_avoided", "scalar_calls_on_batched_paths",
                "cached_phases", "baseline_phases", "k", "m", "n_objects",
                "obj_bytes", "passes", "reads_per_pass"):
        assert key in line, key
    assert set(line["cached_phases"]) == {"write", "read_verify", "scrub",
                                          "degraded_read"}


def test_cuda_is_the_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        run(dp.run_datapath_bench(**dp.SMOKE))
