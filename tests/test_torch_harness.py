"""The port's failure harness on the CPU: the straggler bench and the
chaos driver against ``ceph_tpu``'s, the gates, and the entry points'
device rule.

* ``run_straggler_bench`` at ``bench.py --straggler --smoke``'s sizes in
  both packages: no failed, wedged or leaked op and no byte mismatch in
  either; the unhedged variants (whose sub-reads are a function of the
  schedule and the placement alone) inject the same number of straggler
  delays; the port's two variants raced one straggler schedule.  A hedged
  run decodes from whichever shards answer first, so it is compared by
  tallies and bytes only, and no p99 ratio is asserted here;
* ``tools/chaos.py``: ``--smoke``'s overrides as the reference's, the
  injector's decisions replayed from a seed as the reference's, and one
  smoke round on ``--device cpu``;
* every new entry point resolves CUDA unless the caller names the CPU,
  and raises without a card.
"""

import asyncio
import copy
import io
import json
from contextlib import redirect_stdout

import pytest
import torch

from ceph_tpu.common import faults as ref_faults
from ceph_tpu.tools import chaos as ref_chaos
from ceph_tpu.tools import straggler_bench as ref_strag
from ceph_tpu_torch import loadgen
from ceph_tpu_torch.common import faults as port_faults
from ceph_tpu_torch.loadgen import __main__ as loadgen_cli
from ceph_tpu_torch.loadgen.cluster import SimCluster
from ceph_tpu_torch.tools import chaos, loop_sampler, recovery_bench
from ceph_tpu_torch.tools import straggler_bench as strag

SMOKE = dict(zip(("n_osds", "pg_num", "n_objects", "obj_bytes", "n_reads",
                  "n_clients"), strag.SMOKE))


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def _quiet(*_):
    pass


def test_straggler_bench_matches_reference_by_tallies():
    want = run(ref_strag.run_straggler_bench(**SMOKE, log=_quiet))
    got = run(strag.run_straggler_bench(**SMOKE, log=_quiet, device="cpu"))
    assert got["spec"] == want["spec"]
    for res in (want, got):
        assert res["failed_ops"] == 0 and res["wedged_ops"] == 0
        assert res["leaked_tasks"] == 0 and res["byte_mismatches"] == []
        for variant in ("unhedged", "hedged"):
            assert res[variant]["ops"] == SMOKE["n_reads"]
    assert got["unhedged"]["straggler_delays"] == \
        want["unhedged"]["straggler_delays"] > 0
    assert got["unhedged"]["victims"] == want["unhedged"]["victims"]
    assert got["unhedged"]["subread_bytes"] == \
        want["unhedged"]["subread_bytes"]
    assert strag.same_schedule(got["unhedged"], got["hedged"])
    assert not got["unhedged"]["hedges_fired"]


def _strag_result() -> dict:
    variant = {"victims": [0], "hedges_fired": 0, "subreads": 10,
               "fault_seed": 11, "straggler_delays": 3}
    return {"byte_mismatches": [], "failed_ops": 0, "wedged_ops": 0,
            "leaked_tasks": 0, "p99_speedup": 4.0,
            "extra_subread_ratio": 1.2,
            "unhedged": dict(variant),
            "hedged": {**variant, "hedges_fired": 3,
                       "straggler_delays": 4}}


def test_straggler_gates_name_each_failure():
    assert strag.straggler_gates(_strag_result()) == []
    cases = {
        "byte mismatches": lambda r: r.update(byte_mismatches=["lg-1"]),
        "wedged": lambda r: r.update(wedged_ops=1),
        "leaked": lambda r: r.update(leaked_tasks=2),
        "never fired": lambda r: r["hedged"].update(hedges_fired=0),
        "< 2x floor": lambda r: r.update(p99_speedup=1.5),
        "outside (0, 1.5]": lambda r: r.update(extra_subread_ratio=1.6),
        "different straggler": lambda r: r["hedged"].update(
            fault_seed=12),
    }
    for words, spoil in cases.items():
        r = copy.deepcopy(_strag_result())
        spoil(r)
        errs = strag.straggler_gates(r)
        assert len(errs) == 1 and words in errs[0], (words, errs)
    for spoil in ({"victims": [1]}, {"straggler_delays": 0}):
        r = copy.deepcopy(_strag_result())
        r["hedged"].update(spoil)
        assert not strag.same_schedule(r["unhedged"], r["hedged"])


def test_straggler_delays_are_one_stream_per_seed_and_peer():
    """What ``same_schedule`` rests on: one seed gives a peer the same
    delays whatever traffic to other peers interleaves, in both packages,
    and another seed gives other delays."""
    def drain(faults, seed, interleave):
        inj = faults.MessageFaultInjector(seed=seed)
        inj.straggler("osd.3", dist="lognormal", mu=-0.69, sigma=0.35,
                      cap=2.0)
        if interleave:
            inj.straggler("osd.9", dist="pareto", scale=0.01, alpha=1.1)
        out = []
        for _ in range(16):
            if interleave:
                inj.decide(port_faults.RECV, "osd.0", "osd.9", "noise")
            out.append(inj.decide(port_faults.RECV, "osd.0", "osd.3",
                                  "ec_subop_read_reply").delay)
        return out, inj.stats.get("straggler_delays", 0)

    want = drain(ref_faults, 11, False)
    assert drain(port_faults, 11, False) == want
    assert drain(port_faults, 11, True)[0] == want[0]
    assert want[1] == 16 and drain(port_faults, 12, False)[0] != want[0]


def test_chaos_smoke_overrides_match_reference():
    """--smoke pins one kill-last round at seed 7 and leaves the other
    knobs alone, as the reference's; the RS plugin is cuda, not tpu."""
    for argv in (["--smoke", "--objects", "5"], [], ["--seed", "4"]):
        want = vars(ref_chaos.apply_smoke_overrides(
            ref_chaos.build_parser().parse_args(argv)))
        got = vars(chaos.apply_smoke_overrides(
            chaos.build_parser().parse_args(argv)))
        assert (got.pop("device"), got.pop("plugin"), want.pop("plugin")) \
            == ("cuda", "cuda", "tpu")
        assert got == want
    ns = chaos.build_parser().parse_args(["--plugin", "pmsr"])
    assert ns.plugin == "pmsr"
    with pytest.raises(SystemExit):
        chaos.build_parser().parse_args(["--plugin", "tpu"])


def test_chaos_fault_schedule_replays_from_a_seed():
    """The same seeded rules make the same drop / delay / duplicate and
    straggler decisions in both packages, message by message."""
    def schedule(mod):
        inj = mod.MessageFaultInjector(seed=42)
        inj.drop(peer="osd.", probability=0.3)
        inj.delay(0.05, mtype="pg_push", probability=0.5)
        inj.duplicate(mtype="osd_ping", probability=0.2)
        inj.straggler("osd.2", dist="lognormal", mtype="ec_subop_read_reply",
                      direction=mod.RECV, mu=-0.7, sigma=0.35, cap=2.0)
        out = []
        for i in range(300):
            peer = f"osd.{i % 4}"
            mtype = ("osd_ping", "ec_subop_read_reply", "pg_push")[i % 3]
            d = inj.decide(mod.SEND if i % 2 else mod.RECV, "osd.9", peer,
                           mtype)
            out.append((d.drop, round(d.delay, 9), d.copies))
        return out, inj.stats
    want, got = schedule(ref_faults), schedule(port_faults)
    assert got == want
    assert got[1].get("dropped") and got[1].get("straggler_delays")


def test_chaos_smoke_round_on_the_cpu():
    out = io.StringIO()
    with redirect_stdout(out):
        rc = chaos.main(["--smoke", "--device", "cpu", "--objects", "12"])
    text = out.getvalue()
    assert rc == 0, text
    assert "12/12 clean" in text and "PASS: 0 failures" in text


def _spec():
    return loadgen.WorkloadSpec(n_osds=3, pg_num=8, n_objects=4,
                                n_ops=4).validate()


ENTRY_POINTS = {
    "run_workload": lambda: run(loadgen.run_workload(_spec())),
    "SimCluster.create": lambda: run(loadgen.SimCluster.create(3)),
    "ClientSwarm.start": lambda: run(
        loadgen.ClientSwarm(_spec(), ("127.0.0.1", 1)).start()),
    "ChaosCluster.create": lambda: run(chaos.ChaosCluster.create(3)),
    "drive_code": lambda: run(recovery_bench.drive_code(
        recovery_bench.code_configs(True)[0], n_objects=1, obj_size=4096,
        pg_num=4, seed=1, log=_quiet)),
    "run_recovery_bench": lambda: run(recovery_bench.run_recovery_bench(
        smoke=True, log=_quiet)),
    "run_straggler_bench": lambda: run(strag.run_straggler_bench(
        log=_quiet)),
    "loadgen CLI": lambda: loadgen_cli.main(["--quiet"]),
    "chaos CLI": lambda: chaos.main(["--smoke", "--quiet"]),
    "recovery CLI": lambda: recovery_bench.main(["--smoke", "--quiet"]),
    "straggler CLI": lambda: strag.main(["--smoke", "--quiet"]),
    "loop sampler CLI": lambda: loop_sampler.main(["--quiet"]),
}


def test_loop_sampler_on_a_small_cluster(capsys):
    """The sampler's CLI on a 6-OSD cluster on the CPU: every stage's ops
    done, the victim's mark-down in the cluster log, the loop sampled, busy
    in the port's functions some of the time, tables and stalls counted by
    stage."""
    argv = ["--device", "cpu", "--osds", "6", "--pg-num", "16",
            "--objects", "20", "--ops", "30", "--recovery-ops", "10",
            "--quiet"]
    settle = SimCluster.__dict__["settle_heap"]
    assert loop_sampler.main(argv) == 0
    assert SimCluster.__dict__["settle_heap"] is settle
    res = json.loads(capsys.readouterr().out)
    assert {n: s["ops"] for n, s in res["stages"].items()} == {
        "load": 20, "steady": 30, "degraded": 10, "backfill": 10}
    assert "osd.5 marked down" in res["mark_downs"][0]
    loop = res["loop"]
    assert loop["samples"] > loop["idle"] > 0 and loop["inclusive"]
    assert all(not name.startswith("ceph_tpu_torch/tools/loop_sampler")
               for name, _ in loop["inclusive"])
    stages = ["boot", "load", "steady", "degraded", "backfill", "report"]
    assert list(res["counts_by_stage"]) == stages
    assert res["counts_by_stage"]["boot"]["tables"] > 0
    assert all(res["stalls_by_stage"][f"after {s}"]["wakeups"] > 0
               for s in stages[:-2])


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_need_a_card_unless_told_cpu(name):
    with pytest.raises(RuntimeError, match="CUDA"):
        ENTRY_POINTS[name]()
