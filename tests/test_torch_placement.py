"""The port's bulk placement (``ceph_tpu_torch.mon.pg_mapping``,
``tools/crush_bench``) against ceph_tpu on the CPU.

``bulk_crush`` keeps the reference's routing: the bulk mapper (here its
plain version, ``device="cpu"``) when the lanes clear the threshold or the
(map, rule) is warm, the scalar sweep for a map shape ``VectorCrush``
refuses (``Unexpressed``, raised before any launch), ``fused="never"``, or a
cold map below the threshold; a kernel failure (a RuntimeError) is not
swallowed.  Rows are held against the reference's scalar sweep, exactly.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ceph_tpu.crush import builder as ref_builder
from ceph_tpu.crush.types import CRUSH_BUCKET_STRAW
from ceph_tpu.mon.osdmap import PoolSpec
from ceph_tpu.mon import pg_mapping as ref_pm
from ceph_tpu_torch.crush.vectorized import Unexpressed, VectorCrush
from ceph_tpu_torch.mon import pg_mapping as pm
from test_torch_crush import MAPS, port_map

ROOT = Path(__file__).resolve().parent.parent
POOLS = [PoolSpec(pool_id=1, name="rbd", pg_num=256, pgp_num=256),
         PoolSpec(pool_id=7, name="ec", pg_num=200, pgp_num=150),
         PoolSpec(pool_id=2, name="legacy", pg_num=64, pgp_num=64, flags=0)]


@pytest.mark.parametrize("pool", POOLS, ids=[p.name for p in POOLS])
def test_pool_pps_matches_reference(pool):
    got = pm.pool_pps(pool)
    np.testing.assert_array_equal(got, ref_pm.pool_pps(pool))
    assert got.dtype == np.int64


@pytest.mark.parametrize("name", ["depth4", "choose_args"])
@pytest.mark.parametrize("rule", [0, 1], ids=["firstn", "indep"])
def test_bulk_crush_routes_agree_with_reference(name, rule):
    ref_map, weights, rules = MAPS[name]
    numrep = rules[rule]
    xs = np.concatenate([pm.pool_pps(p) for p in POOLS[:2]])
    want, used = ref_pm.bulk_crush(ref_map, rule, xs, numrep, weights,
                                   fused="never")
    assert not used
    cm = port_map(ref_map)
    rows = {}
    for fused, lanes in (("never", None), ("always", None), ("auto", 1)):
        rows[fused], rows[fused + " used"] = pm.bulk_crush(
            cm, rule, xs, numrep, weights, fused=fused, min_lanes=lanes,
            device="cpu")
        assert rows[fused].dtype == np.int64
        np.testing.assert_array_equal(rows[fused], want, err_msg=fused)
    assert (rows["never used"], rows["always used"], rows["auto used"]) == (
        False, True, True)


def test_auto_below_threshold_is_scalar_until_warm():
    ref_map, weights, _ = MAPS["two6x4"]
    cm = port_map(ref_map)
    cm.choose_args = {}
    xs = pm.pool_pps(POOLS[0])
    _, used = pm.bulk_crush(cm, 0, xs[:100], 3, weights, min_lanes=10**6,
                            device="cpu")
    assert not used                              # cold and small: scalar
    _, used = pm.bulk_crush(cm, 0, xs, 3, weights, fused="always",
                            device="cpu")
    assert used
    rows, used = pm.bulk_crush(cm, 0, xs[:100], 3, weights, min_lanes=10**6,
                               device="cpu")
    assert used                                  # warm: the bulk mapper
    np.testing.assert_array_equal(rows, pm.bulk_crush(
        cm, 0, xs[:100], 3, weights, fused="never", device="cpu")[0])


def _refused_maps():
    """Shapes K5 does not express: a straw bucket carrying legacy straw
    values (drawn as legacy straw, not straw2), a bucket mixing osds and
    buckets."""
    straw = ref_builder.build_two_level_map(4, 3)
    straw.buckets[-2].alg = CRUSH_BUCKET_STRAW
    straw.buckets[-2].straws = [0x10000 + 0x3000 * i for i in range(3)]
    mixed = ref_builder.build_two_level_map(4, 3)
    mixed.buckets[-1].items.append(11)
    mixed.buckets[-1].item_weights.append(0x10000)
    return {"straw": straw, "mixed": mixed}


@pytest.mark.parametrize("kind", ["straw", "mixed"])
def test_refused_shape_goes_to_the_scalar_sweep(kind):
    ref_map = _refused_maps()[kind]
    cm = port_map(ref_map)
    for bid, b in ref_map.buckets.items():
        if hasattr(b, "straws"):
            cm.buckets[bid].straws = list(b.straws)
    weights = [0x10000] * 12
    xs = pm.pool_pps(POOLS[1])
    rows, used = pm.bulk_crush(cm, 0, xs, 3, weights,
                               fused="auto", min_lanes=1, device="cpu")
    assert not used
    want, _ = ref_pm.bulk_crush(ref_map, 0, xs, 3, weights, fused="never")
    np.testing.assert_array_equal(rows, want)
    with pytest.raises(Unexpressed):
        pm.bulk_crush(cm, 0, xs, 3, weights, fused="always", device="cpu")


def test_a_malformed_map_is_not_swept():
    """A dangling bucket reference is a malformed map, not a shape K5 does
    not express: ``bulk_crush`` raises its ValueError on every route that
    builds the mapper instead of sweeping it."""
    cm = port_map(ref_builder.build_two_level_map(4, 3))
    cm.buckets[-1].items[1] = -77
    xs = pm.pool_pps(POOLS[1])
    for fused in ("auto", "always"):
        with pytest.raises(ValueError, match="dangling") as got:
            pm.bulk_crush(cm, 0, xs, 3, [0x10000] * 12, fused=fused,
                          min_lanes=1, device="cpu")
        assert not isinstance(got.value, Unexpressed)


def test_kernel_failure_is_not_swallowed(monkeypatch):
    def fail(self, xs, numrep, osd_weights):
        raise RuntimeError("crush_map_rule: kernel launch failed with CUDA "
                           "error 98")
    monkeypatch.setattr(VectorCrush, "map_device", fail)
    ref_map, weights, _ = MAPS["depth4"]
    xs = pm.pool_pps(POOLS[0])
    for fused in ("auto", "always"):
        with pytest.raises(RuntimeError, match="kernel launch failed"):
            pm.bulk_crush(port_map(ref_map), 0, xs, 3, weights, fused=fused,
                          min_lanes=1, device="cpu")


def test_cuda_is_the_default_and_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ref_map, weights, _ = MAPS["depth4"]
    with pytest.raises(RuntimeError, match="CUDA"):
        pm.bulk_crush(port_map(ref_map), 0, np.arange(8), 3, weights)


def test_structurally_equal_maps_share_one_mapper():
    ref_map, _, _ = MAPS["depth4"]
    a, b = port_map(ref_map), port_map(ref_map)
    assert pm._crush_digest(a) == pm._crush_digest(b)
    assert pm._vector_crush_for(a, 1, "cpu") is pm._vector_crush_for(b, 1, "cpu")


def _bench(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-m", "ceph_tpu_torch.tools.crush_bench", *args,
         "--device", "cpu"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1, proc.stdout
    return json.loads(lines[0])


@pytest.mark.parametrize("args", [
    ("--pgs", "4096", "--osds", "40", "--verify", "64"),
    ("--pgs", "2048", "--osds", "200", "--verify", "32", "--rule", "1",
     "--replicas", "11", "--batch", "1024")], ids=["firstn", "indep"])
def test_crush_bench_cpu_prints_one_exact_line(args):
    out = _bench(*args)
    assert out["metric"] == "crush_bulk_mappings_per_s"
    assert out["lane_exact_vs_scalar"] is True
    assert out["value"] > 0
    assert out["device"] == {"platform": "cpu", "kind": "cpu"}
    assert out["n_mappings"] == int(args[1])
