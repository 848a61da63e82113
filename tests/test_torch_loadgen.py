"""The port's traffic harness (``ceph_tpu_torch/loadgen/``) against
``ceph_tpu/loadgen/`` on the CPU.

* ``WorkloadSpec``: the same working set (object sizes), op schedule,
  schedule digest, popularity weights and payload bytes for a grid of
  specs, and the same refusals;
* ``LatencyHistogram``: the same buckets, percentiles, bounds and summary
  on the same samples, and a merge and a round trip across the packages;
* ``run_workload`` at ``tests/test_loadgen.py``'s tiny spec (and the same
  with lognormal sizes, whose partial overwrites take the EC backend's
  read-modify-write path): the same ``deterministic_view`` and no failed
  op, the port's cluster on ``device="cpu"``;
* ``cluster_gates`` names each failure of a report.

No test here gates on a latency or a rate.
"""

import asyncio
import copy
import io
import json
import math
import random
from contextlib import redirect_stdout

import pytest

from ceph_tpu import loadgen as ref
from ceph_tpu.loadgen import spec as ref_spec
from ceph_tpu_torch import loadgen as port
from ceph_tpu_torch.loadgen import __main__ as port_cli
from ceph_tpu_torch.loadgen import spec as port_spec


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


# -- spec -------------------------------------------------------------------

SPECS = {
    "default": {},
    "fixed-uniform-pop": {"popularity": "uniform", "seed": 3},
    "uniform-sizes": {"size_dist": "uniform", "seed": 9},
    "lognormal-zipf": {"size_dist": "lognormal", "zipf_s": 0.8, "seed": 5},
    "lognormal-read-heavy": {"size_dist": "lognormal", "read_frac": 0.9,
                             "write_frac": 0.05, "rmw_frac": 0.05,
                             "seed": 21},
    "rmw-only-small": {"read_frac": 0.0, "write_frac": 0.0,
                       "rmw_frac": 1.0, "obj_size": 1024,
                       "rmw_bytes": 4096, "seed": 2},
    "replicated-open": {"pool_type": "replicated", "mode": "open",
                        "target_qps": 50.0, "seed": 13},
    "bench-cluster-full": {"n_osds": 64, "pg_num": 256, "n_ops": 600,
                           "n_clients": 32, "recovery_ops": 120,
                           "size_dist": "lognormal", "seed": 1},
}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_spec_schedule_sizes_and_payloads_match(name):
    kw = {"n_objects": 300, "n_ops": 1500, **SPECS[name]}
    a = ref_spec.WorkloadSpec(**kw).validate()
    b = port_spec.WorkloadSpec(**kw).validate()
    assert a.to_dict() == b.to_dict()
    assert [a.object_size(i) for i in range(a.n_objects)] == \
        [b.object_size(i) for i in range(b.n_objects)]
    assert a._popularity_weights() == b._popularity_weights()
    for salt in ("steady", "degraded", "backfill", "warm"):
        sa, sb = a.schedule(salt=salt), b.schedule(salt=salt)
        assert [tuple(op) for op in sa] == [tuple(op) for op in sb]
        assert a.schedule_digest(sa) == b.schedule_digest(sb)
    assert [tuple(op) for op in a.preload_ops()] == \
        [tuple(op) for op in b.preload_ops()]
    assert a.schedule(n_ops=37, salt="x") != a.schedule(n_ops=37, salt="y")
    for size in (0, 1, 2048, a.object_size(0), 70000):
        assert ref_spec.payload_for(a, size) == port_spec.payload_for(b, size)


@pytest.mark.parametrize("bad", [
    {"pool_type": "bogus"}, {"size_dist": "pareto"},
    {"popularity": "hot"}, {"mode": "burst"},
    {"mode": "open", "target_qps": 0},
    {"read_frac": 0, "write_frac": 0, "rmw_frac": 0},
    {"n_osds": 2, "ec_k": 2, "ec_m": 1},
])
def test_spec_refusals_match(bad):
    for mod in (ref_spec, port_spec):
        with pytest.raises(ValueError):
            mod.WorkloadSpec(**bad).validate()


# -- histogram --------------------------------------------------------------

def _samples(dist: str) -> list[float]:
    rnd = random.Random(dist)
    if dist == "uniform":
        return [rnd.uniform(1e-4, 0.5) for _ in range(20000)]
    if dist == "lognormal":
        return [rnd.lognormvariate(math.log(5e-3), 1.0)
                for _ in range(20000)]
    out = [rnd.uniform(1e-3, 2e-3) for _ in range(10000)] + \
        [rnd.uniform(0.5, 1.0) for _ in range(200)] + [0.0, 1e-9]
    rnd.shuffle(out)
    return out


@pytest.mark.parametrize("dist", ["uniform", "lognormal", "bimodal"])
def test_histogram_percentiles_match(dist):
    samples = _samples(dist)
    a, b = ref.LatencyHistogram(), port.LatencyHistogram()
    for s in samples:
        a.record(s)
        b.record(s)
    assert a.counts == b.counts and (a.n, a.sum, a.min, a.max) == \
        (b.n, b.sum, b.min, b.max)
    for q in (0.1, 50.0, 95.0, 99.0, 99.9, 100.0):
        assert a.percentile(q) == b.percentile(q)
        assert a.percentile_bounds(q) == b.percentile_bounds(q)
    assert a.summary() == b.summary()
    assert a.to_dict() == b.to_dict()
    # the guarantee the reference's tests pin: the true percentile lies
    # in the reported bucket
    srt = sorted(samples)
    for q in (50.0, 95.0, 99.0, 99.9):
        oracle = srt[min(len(srt) - 1,
                         max(0, math.ceil(q / 100 * len(srt)) - 1))]
        lo, hi = b.percentile_bounds(q)
        assert lo <= oracle <= hi * (1 + 1e-9)


def test_histogram_merge_and_roundtrip_across_packages():
    rnd = random.Random(1)
    xs = [rnd.uniform(1e-4, 1.0) for _ in range(5000)]
    halves = []
    for mod in (ref, port):
        a, b = mod.LatencyHistogram(), mod.LatencyHistogram()
        for x in xs[:2500]:
            a.record(x)
        for x in xs[2500:]:
            b.record(x)
        a.merge(b)
        halves.append(a)
    assert halves[0].to_dict() == halves[1].to_dict()
    # each package reads the other's dump
    wire = json.loads(json.dumps(halves[1].to_dict()))
    back = ref.LatencyHistogram.from_dict(wire)
    assert back.counts == halves[0].counts
    assert back.percentile(99.0) == halves[0].percentile(99.0)
    fwd = port.LatencyHistogram.from_dict(
        json.loads(json.dumps(halves[0].to_dict())))
    assert fwd.summary() == halves[1].summary()
    with pytest.raises(ValueError):
        port.LatencyHistogram(growth=2.0).merge(port.LatencyHistogram())
    with pytest.raises(ValueError):
        port.LatencyHistogram(growth=1.0)
    empty = port.LatencyHistogram()
    assert empty.percentile(99.0) == 0.0 and empty.summary() == \
        ref.LatencyHistogram().summary()


# -- live runs --------------------------------------------------------------

TINY = dict(n_osds=4, pg_num=16, n_objects=24, obj_size=8 << 10,
            n_ops=80, n_clients=6, recovery_ops=0, seed=11)
TINY_CLI = ["--osds", "4", "--pg-num", "16", "--objects", "24",
            "--obj-kib", "8", "--ops", "80", "--clients", "6",
            "--recovery-ops", "0", "--seed", "11"]


def test_run_workload_view_matches_reference():
    """tests/test_loadgen.py's tiny spec: the reference's run_workload and
    the port's CLI (``--device cpu``) give the same deterministic view,
    with no failed or wedged op."""
    want = run(ref.run_workload(ref_spec.WorkloadSpec(**TINY).validate()))
    out = io.StringIO()
    with redirect_stdout(out):
        rc = port_cli.main(TINY_CLI + ["--device", "cpu", "--quiet"])
    got = json.loads(out.getvalue())
    for report in (want, got):
        for name, ph in report["phases"].items():
            assert ph["failed_ops"] == 0 and ph["wedged_ops"] == 0, \
                (name, ph["errors"])
    assert json.dumps(port.deterministic_view(got), sort_keys=True) == \
        json.dumps(ref.deterministic_view(want), sort_keys=True)
    assert got["schedule"] == want["schedule"]
    assert got["qos"]["steady"].get("dispatched_client", 0) > 0
    assert rc == (1 if port.cluster_gates(got) else 0)


def test_rmw_mix_takes_the_partial_write_path_as_the_reference():
    """Lognormal sizes span several stripes, so the mix's 2 KiB partial
    overwrites take the EC backend's delta read-modify-write; both
    packages count the same runs and report the same view."""
    spec = {**TINY, "size_dist": "lognormal", "obj_size": 16 << 10}
    want = run(ref.run_workload(ref_spec.WorkloadSpec(**spec).validate()))
    got = run(port.run_workload(port_spec.WorkloadSpec(**spec).validate(),
                                device="cpu"))
    assert json.dumps(port.deterministic_view(got), sort_keys=True) == \
        json.dumps(ref.deterministic_view(want), sort_keys=True)
    rmw = got["counters"]["ec_batch"].get("rmw_delta_runs", 0)
    assert rmw > 0
    assert rmw == want["counters"]["ec_batch"].get("rmw_delta_runs", 0)
    assert got["phases"]["steady"]["failed_ops"] == 0


def _good_report() -> dict:
    lat = {"count": 3, "p50_s": 0.01, "max_s": 0.02}
    return {
        "spec": {"recovery_ops": 10, "kill_osds": 1,
                 "pool_type": "erasure", "extra": {}},
        "phases": {"steady": {"failed_ops": 0, "wedged_ops": 0,
                              "timing": {"latency": {"read": lat}}},
                   "degraded": {"failed_ops": 0, "wedged_ops": 0}},
        "interference": {"down_detected": True, "revived": True},
        "qos": {"steady": {"dispatched_client": 5}},
        "counters": {"ec_pipeline": {"staged_batches": 1,
                                     "overlapped_commits": 1,
                                     "commit_overlap_ms": 1,
                                     "flush_windows": 1}},
    }


def test_cluster_gates_name_each_failure():
    assert port.cluster_gates(_good_report()) == []
    cases = {
        "wedged": lambda r: r["phases"]["degraded"].update(wedged_ops=2),
        "kill/revive": lambda r: r["interference"].update(revived=False),
        "degenerate": lambda r: r["phases"]["steady"]["timing"]["latency"][
            "read"].update(p50_s=1.0),
        "client dispatch": lambda r: r["qos"]["steady"].clear(),
        "ec_pipeline.flush_windows": lambda r: r["counters"][
            "ec_pipeline"].pop("flush_windows"),
    }
    for word, spoil in cases.items():
        r = copy.deepcopy(_good_report())
        spoil(r)
        errs = port.cluster_gates(r)
        assert len(errs) == 1 and word in errs[0], (word, errs)
    r = copy.deepcopy(_good_report())
    r["spec"]["extra"] = {"osd_config": {"osd_pipeline_enabled": False}}
    assert "kill switch" in port.cluster_gates(r)[0]
    r["spec"]["pool_type"] = "replicated"
    assert port.cluster_gates(r) == []
