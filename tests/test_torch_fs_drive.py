"""``ceph_tpu_torch.tools.fs_drive`` on the CPU at a small size: every step
``chip_smoke.py``'s phase 13a drives on the card, in its order (a
small-file tree, large files, 4 KiB overwrites, both mounts'
capabilities, the MDS failover, the mgr's prometheus scrape, ``cephfs_cli``
in processes of their own, fs_mirror to a second cluster), with no
mismatch and no failed op."""

import asyncio

import torch

from ceph_tpu_torch.tools.fs_drive import FsDrive
from ceph_tpu_torch.tools.loop_sampler import mark_downs

torch.set_num_threads(1)

KIB = 1 << 10


def small_drive() -> FsDrive:
    return FsDrive(n_osds=4, k=2, m=1, pg_num=8, rep_pg_num=8, n_files=24,
                   n_dirs=4, small_bytes=4 * KIB, big_files=3,
                   big_bytes=4608 * KIB, overwrites=24, device="cpu")


def test_fs_drive_on_the_cpu():
    d = small_drive()

    async def main():
        await d.boot()
        try:
            await d.small_files()
            await d.big_write_read()
            await d.overwrite()
            await d.caps()
            await d.failover()
            await d.mgr_check()
            await d.cli()
            await d.mirror()
            return (mark_downs(d.cluster),
                    [m for c in d.sites for m in mark_downs(c)])
        finally:
            await d.stop()

    loop = asyncio.new_event_loop()
    try:
        logged, site_logged = loop.run_until_complete(
            asyncio.wait_for(main(), 240))
    finally:
        loop.close()
    rep = d.report
    assert not rep["mismatches"], rep["mismatches"]
    assert rep["failed_ops"] == 0, rep["errors"]
    assert logged == [] and site_logged == []
    assert rep["creates"]["ios"] == 24 and rep["overwrite_4k"]["ios"] == 24
    # the MDS's spans over the creates: a create and a size at close a file
    assert rep["mds_spans"]["hold_create"]["n"] == 24
    assert rep["mds_spans"]["hold_setattr"]["n"] == 24
    # a file of 4.5 MiB at the default layout spans two objects
    assert rep["purged_objects"] == 2
    assert rep["mirror_files"] == 6
    assert rep["failover_from_to"] == ["a", "b"]
    assert rep["mgr"]["osds_up"] == 4
    assert sum(rep["mgr"]["op_w"].values()) > 0
