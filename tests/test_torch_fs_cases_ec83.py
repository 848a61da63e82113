"""The port's CephFS against ceph_tpu's on RS k=8,m=3.

``tests/torch_fs_cases.py``'s script (files, 4 KiB overwrites, two mounts'
appends, a rename and an unlink, an MDS failover, an OSD kill, degraded
reads, revive, scrub) on 12 OSDs, one a host, an RS k=8,m=3 data pool at the
default 4 KiB stripe unit.  The two clusters' reads, stored shards and
tags, purged objects and timing-free counters must be equal."""

import torch

from torch_app_cases import run
from torch_cluster_cases import on_both
from torch_fs_cases import fs_drive

torch.set_num_threads(1)


def test_fs_on_ec83_match():
    ref, port = run(on_both(fs_drive, 8, 3, n_osds=12, pg_num=8,
                            n_files=4),
                    timeout=300)
    for side in (ref, port):
        for key in ("files", "overwrites", "appends", "after_failover",
                    "degraded", "recovered", "victim_is_first_down"):
            assert side[key], key
        assert side["purged"] == []
        assert side["scrub"][0] > 0 and not side["scrub"][1]
    # each 4 KiB overwrite took the delta path: one run, one stripe
    assert port["counters"]["rmw_delta_runs"] >= 8
    assert port == ref
