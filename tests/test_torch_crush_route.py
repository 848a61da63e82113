"""The card's placement route for every map shape K5 refuses: K6.

For each shape of ``test_torch_crush_rule_lanes.SHAPES`` that K5 does not
express, on the CPU:

* the card's route (``card_rows``, with ``meta`` tensors standing in for the
  card and counting stand-ins for both kernels) launches K6 once, K5 never,
  and maps nothing on the host; ``bulk_crush_rows`` and a whole
  ``PGMapping`` build on such seeds take the same route;
* a CPU build of ``PGMapping`` over the shape (the scalar sweep) equals the
  reference's ``PGMapping.build(fused="never")`` table entry for entry, and
  so does the card's route run on CPU seeds, where K6's wrapper takes its
  plain version.

A malformed map (a dangling bucket reference) still raises its own
``ValueError`` from the route.  Exactness is the tolerance.
"""

import copy

import numpy as np
import pytest
import torch

from ceph_tpu.mon.pg_mapping import PGMapping as RefPGMapping
from ceph_tpu_torch.crush import rule_lanes
from ceph_tpu_torch.crush.vectorized import (Unexpressed, VectorCrush,
                                             seed_tensor)
from ceph_tpu_torch.mon import pg_mapping as pm_mod
from ceph_tpu_torch.mon.pg_mapping import PGMapping
from test_torch_crush_rule_lanes import shape_maps
from test_torch_osdmap import (MGR_POOL, _Launches, _card_route,
                               assert_same_table, make_ref_map, port_of)

# the shapes K5 refuses (each listed in ROADMAP queue 3), rule 0 and rule 1
REFUSED = ["mixed", "uniform", "list", "tree", "legacy straw",
           "kinds mixed by level", "argonaut", "local tries",
           "bobtail choose_args", "chooseleaf above hosts",
           "plain choose of a bucket type", "rack then host", "set steps",
           "two takes"]


def refused_osdmaps(name: str):
    """(reference OSDMap, the port's) over shape ``name``'s CRUSH map: pools
    on rules 0 (x3) and 1 (EC x4), down, out and reweighted OSDs, upmaps and
    pg_temps, as ``make_ref_map`` makes them for its OSDs."""
    port_cm, ref_cm = shape_maps(name)
    ref = make_ref_map(len(name), [ref_cm.max_devices], pg_num=24)
    ref.crush = ref_cm
    m = port_of(ref)
    m.crush = port_cm
    return ref, m


@pytest.mark.parametrize("name", REFUSED)
def test_k5_refuses_the_shape(name):
    _, m = refused_osdmaps(name)
    for rule in (0, 1):
        with pytest.raises(Unexpressed):
            VectorCrush(m.crush, rule, device="cpu")


@pytest.mark.parametrize("name", REFUSED)
def test_card_route_sends_the_shape_to_k6(monkeypatch, name):
    """One K6 launch a pool on the card, no K5 launch, nothing on the
    host: for ``card_rows`` alone and for a whole table build."""
    launches = _Launches(monkeypatch)
    _, m = refused_osdmaps(name)
    seeds = pm_mod.pool_seeds(MGR_POOL, "meta")
    for rule, size in ((0, 3), (1, 4)):
        rows, used = pm_mod.card_rows(m.crush, rule, seeds, size,
                                      m.osd_weights())
        assert used and rows.shape == (1, size)
        assert rows.device.type == "meta"
    assert (launches.n, launches.k6) == (0, 2)
    monkeypatch.setattr(pm_mod, "resolve_device", torch.device)
    m.device = "meta"
    m.pg_upmap_items, m.pg_temp = {}, {}    # overrides read rows back
    monkeypatch.setattr(pm_mod.PGMapping, "_copy_back", lambda self: None)
    pm = PGMapping.build(m)
    assert (launches.n, launches.k6) == (0, 2 + len(m.pools))
    assert pm.fused_pools == len(m.pools) and pm.scalar_pools == 0


@pytest.mark.parametrize("name", REFUSED)
def test_cpu_build_and_card_route_equal_the_reference(monkeypatch, name):
    """The CPU build (scalar sweep) and the card's route on CPU seeds (K6's
    plain version) both equal the reference's scalar table."""
    ref, m = refused_osdmaps(name)
    want = RefPGMapping.build(ref, fused="never")
    cpu = PGMapping.build(m)
    assert cpu.scalar_pools == len(m.pools)
    assert_same_table(ref, want, cpu, scalar=False)
    routed = _card_route(monkeypatch)
    monkeypatch.setattr(pm_mod, "_sweep", None)
    m.invalidate_placement_cache()
    card = PGMapping.build(m)
    assert sorted(routed) == [0, 1] and card.fused_pools == len(m.pools)
    assert_same_table(ref, want, card, scalar=False)


def test_a_malformed_map_raises_on_the_route(monkeypatch):
    """A dangling reference in a shape K5 refuses: K6's flattener raises
    the malformed map's ValueError, and no launch is made."""
    launches = _Launches(monkeypatch)
    _, m = refused_osdmaps("uniform")
    m.crush.buckets[-1].items[0] = -77
    seeds = pm_mod.pool_seeds(MGR_POOL, "meta")
    with pytest.raises(ValueError, match="dangling") as got:
        pm_mod.card_rows(m.crush, 0, seeds, 3, m.osd_weights())
    assert not isinstance(got.value, Unexpressed)
    assert (launches.n, launches.k6) == (0, 0)


def test_k6_mappers_are_shared_by_structure():
    """Structurally equal maps share one K6 mapper; legacy straw values are
    part of the structure (a map that differs only in them does not)."""
    a, _ = shape_maps("legacy straw")
    b = copy.deepcopy(a)
    b.__dict__.pop("_structure_digest", None)
    assert pm_mod._rule_lanes_for(a, 0, "cpu") is \
        pm_mod._rule_lanes_for(b, 0, "cpu")
    c = copy.deepcopy(a)
    c.__dict__.pop("_structure_digest", None)
    c.buckets[-1].straws = [s + 1 for s in c.buckets[-1].straws]
    assert pm_mod._crush_digest(c) != pm_mod._crush_digest(a)
    assert pm_mod._rule_lanes_for(c, 0, "cpu") is not \
        pm_mod._rule_lanes_for(a, 0, "cpu")


def test_bulk_crush_on_the_card_takes_k6(monkeypatch):
    """``bulk_crush`` numpy to numpy on the card: a refused shape above the
    lane threshold goes to K6 (its rows copied back), not the host sweep;
    ``fused="always"`` still forces K5 and raises ``Unexpressed``.  A
    stand-in device whose type is "cuda" carries CPU tensors here."""
    _, m = refused_osdmaps("tree")
    calls = []

    class Card:
        def map_device(self, seeds, numrep, w):
            calls.append(seeds.shape[0])
            return torch.from_numpy(rule_lanes.plain_rows(
                m.crush, 0, seeds.numpy(), numrep, w))

    class CudaLike:
        type = "cuda"
    monkeypatch.setattr(pm_mod, "resolve_device", lambda device=None: CudaLike)
    monkeypatch.setattr(pm_mod, "seed_tensor",
                        lambda xs, device: seed_tensor(xs, "cpu"))
    monkeypatch.setattr(pm_mod, "_vector_crush_for",
                        lambda cm, r, d: VectorCrush(cm, r, device="cpu"))
    monkeypatch.setattr(pm_mod, "_rule_lanes_for", lambda *a: Card())
    monkeypatch.setattr(pm_mod, "_sweep", None)
    xs = pm_mod.pool_pps(m.pools[1])
    w = m.osd_weights()
    rows, used = pm_mod.bulk_crush(m.crush, 0, xs, 3, w, min_lanes=1)
    assert used and calls == [len(xs)] and rows.dtype == np.int64
    np.testing.assert_array_equal(
        rows, rule_lanes.plain_rows(m.crush, 0, xs, 3, w))
    with pytest.raises(Unexpressed):
        pm_mod.bulk_crush(m.crush, 0, xs, 3, w, fused="always")


def test_k5_refusal_is_paid_once_a_structure(monkeypatch):
    """A refused (map, rule) builds K5's mapper once: later pools and
    epochs over the same structure, another CrushMap object included, go
    to K6 without a new refusal."""
    monkeypatch.setattr(pm_mod, "_VC_REFUSED", {})
    built = []

    def counting(crush_map, ruleno, device=None):
        built.append(ruleno)
        return VectorCrush(crush_map, ruleno, device=device)
    monkeypatch.setattr(pm_mod, "VectorCrush", counting)
    _, m = refused_osdmaps("tree")
    seeds = pm_mod.pool_seeds(MGR_POOL, "cpu")
    for crush_map in (m.crush, copy.deepcopy(m.crush), m.crush):
        for rule in (0, 1):
            with pytest.raises(Unexpressed):
                pm_mod._vector_crush_for(crush_map, rule, "cpu")
            rows, used = pm_mod.card_rows(crush_map, rule, seeds, 3,
                                          m.osd_weights())
            assert used and rows.shape == (1, 3)
    assert built == [0, 1]


def test_a_k6_mapper_makes_the_map_warm(monkeypatch):
    """``bulk_crush``'s 'auto' counts K6's mapper as warm: below the lane
    threshold a (map, rule) that K6 already holds on a card-like device
    takes K6, not the host sweep."""
    _, m = refused_osdmaps("list")
    calls = []

    class Card:
        def map_device(self, seeds, numrep, w):
            calls.append(seeds.shape[0])
            return torch.from_numpy(rule_lanes.plain_rows(
                m.crush, 0, seeds.numpy(), numrep, w))

    class CudaLike:
        type = "cuda"

        def __str__(self):
            return "cuda:0"
    monkeypatch.setattr(pm_mod, "resolve_device",
                        lambda device=None: CudaLike())
    monkeypatch.setattr(pm_mod, "seed_tensor",
                        lambda xs, device: seed_tensor(xs, "cpu"))
    monkeypatch.setattr(pm_mod, "_vector_crush_for",
                        lambda cm, r, d: VectorCrush(cm, r, device="cpu"))
    monkeypatch.setattr(pm_mod, "_sweep", None)
    monkeypatch.setattr(pm_mod, "_RL_SHARED", {
        (pm_mod._crush_digest(m.crush), 0, "cuda:0"): Card()})
    monkeypatch.setattr(pm_mod, "_rule_lanes_for",
                        lambda cm, r, d: pm_mod._RL_SHARED[
                            (pm_mod._crush_digest(cm), r, str(d))])
    xs = pm_mod.pool_pps(m.pools[1])[:5]
    w = m.osd_weights()
    rows, used = pm_mod.bulk_crush(m.crush, 0, xs, 3, w, min_lanes=10**6)
    assert used and calls == [5]
    np.testing.assert_array_equal(
        rows, rule_lanes.plain_rows(m.crush, 0, xs, 3, w))
