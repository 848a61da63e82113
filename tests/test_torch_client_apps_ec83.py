"""The port's client applications against ceph_tpu's on RS k=8,m=3.

``tests/torch_apps_cases.py``'s script (RBD whole-object, 4 KiB
sub-stripe and cached writes, a radosstriper file, RGW PUT/GET/multipart,
a kill, degraded reads, revive, recovery and scrub) on 12 OSDs, one a
host, with the ``test_torch_cluster_ec.py`` pool: k=8, m=3, 4 KiB stripe
unit.  An RBD 4 KiB write there is an EC read-modify-write of one chunk of
a 32 KiB stripe.  The two clusters' reads, stored shards and tags, ETags
and timing-free counters must be equal, with no differing byte.
"""

import torch

from torch_apps_cases import apps_drive
from torch_app_cases import run
from torch_cluster_cases import on_both

torch.set_num_threads(1)


def test_apps_on_ec83_match():
    ref, port = run(on_both(apps_drive, 8, 3, n_osds=12, pg_num=8,
                            n_objects=2, n_random=16, n_cached=16,
                            file_bytes=100_000, s3_sizes=(40_000, 5)),
                    timeout=400)
    for side in (ref, port):
        for key in ("rbd_whole", "rbd_random", "file", "s3", "rbd_cached",
                    "rbd_degraded", "file_degraded", "s3_degraded",
                    "rbd_recovered", "victim_is_first_down"):
            assert side[key], key
        assert side["scrub"][0] > 0 and not side["scrub"][1]
    # every 4 KiB write took the delta path: one run, one stripe each
    assert port["counters_rbd"]["rmw_delta_runs"] == 16
    assert port["counters_rbd"]["rmw_full_runs"] == 0
    assert port == ref
