"""The port's client applications against ceph_tpu's.

``map_extents`` (the striper's extent math under RBD, radosstriper, RGW
and CephFS) must give the same extents in both packages on seeded and
generated layouts.  Then one script (``tests/torch_apps_cases.py``) runs
RBD, radosstriper and RGW over an EC 2+1 pool of 3 OSDs on a cluster of
each package, through a kill, degraded reads, revive, recovery and
scrub: every read equals its oracle, and the stored shards and tags, the
ETags and the counters that do not depend on timing are equal, with no
differing byte.  ``tests/test_torch_client_apps_ec83.py`` runs it on the
RS k=8,m=3 pool of 12 OSDs.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as hs

from ceph_tpu.client import striper as ref_striper
from ceph_tpu_torch.client import striper as port_striper
from torch_apps_cases import apps_drive
from torch_app_cases import run
from torch_cluster_cases import on_both

torch.set_num_threads(1)


def _both(su, sc, os_, off, length):
    ref = ref_striper.map_extents(
        ref_striper.Layout(stripe_unit=su, stripe_count=sc,
                           object_size=os_), off, length)
    port = port_striper.map_extents(
        port_striper.Layout(stripe_unit=su, stripe_count=sc,
                            object_size=os_), off, length)
    return ref, port


@pytest.mark.parametrize("seed", range(6))
def test_map_extents_equal_on_seeded_layouts(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        su = int(2 ** rng.integers(9, 23))
        sc = int(rng.integers(1, 9))
        os_ = su * int(2 ** rng.integers(0, 4))
        off = int(rng.integers(0, 40 * os_))
        length = int(rng.integers(1, 6 * sc * os_))
        ref, port = _both(su, sc, os_, off, length)
        assert port == ref
        assert sum(n for _, _, n in port) == length


@settings(max_examples=200, deadline=None)
@given(su_log=hs.integers(0, 22), sc=hs.integers(1, 16),
       per_obj=hs.integers(1, 8), off=hs.integers(0, 1 << 34),
       units=hs.integers(0, 64), tail=hs.integers(0, 1 << 22))
def test_map_extents_equal_on_generated_layouts(su_log, sc, per_obj, off,
                                                units, tail):
    su = 1 << su_log
    ref, port = _both(su, sc, su * per_obj, off, units * su + tail % su)
    assert port == ref


def test_layout_refusals_match():
    for args in ((0, 1, 4096), (4096, 0, 4096), (3000, 1, 4096)):
        with pytest.raises(ValueError):
            ref_striper.Layout(*args)
        with pytest.raises(ValueError):
            port_striper.Layout(*args)


def test_apps_on_ec21_match():
    ref, port = run(on_both(apps_drive, 2, 1, n_osds=3, pg_num=8),
                    timeout=400)
    for side in (ref, port):
        for key in ("rbd_whole", "rbd_random", "file", "s3", "rbd_cached",
                    "rbd_degraded", "file_degraded", "s3_degraded",
                    "rbd_recovered", "victim_is_first_down"):
            assert side[key], key
        assert side["scrub"][0] > 0 and not side["scrub"][1]
        assert side["counters_rbd"]["rmw_delta_runs"] > 0
    assert port == ref
