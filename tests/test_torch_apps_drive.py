"""``ceph_tpu_torch.tools.apps_drive`` on the CPU at a small size: every
step ``chip_smoke.py``'s phase 12 drives on the card (RBD on the EC pool
through a kill, degraded read, recovery and scrub; RBD's features,
exclusive-lock takeover, migration and mirroring on the replicated pool;
radosstriper; RGW), with no mismatch and no failed op."""

import asyncio
import importlib.util

import torch

from ceph_tpu_torch.tools.apps_drive import AppsDrive
from ceph_tpu_torch.tools.loop_sampler import mark_downs

torch.set_num_threads(1)

KIB = 1 << 10


def small_drive() -> AppsDrive:
    return AppsDrive(n_osds=4, k=2, m=1, pg_num=8, rep_pg_num=8,
                     image_bytes=512 * KIB, order=16, bench_ios=32,
                     crypto_bytes=128 * KIB, feature_bytes=256 * KIB,
                     file_bytes=256 * KIB, s3_objects=4,
                     s3_bytes=100 * KIB, multipart_bytes=192 * KIB,
                     part_bytes=64 * KIB, s3_stripe=64 * KIB,
                     device="cpu")


def test_apps_drive_on_the_cpu():
    d = small_drive()
    crypto = importlib.util.find_spec("cryptography") is not None

    async def main():
        await d.boot()
        try:
            await d.rbd_create()
            await d.rbd_write_read()
            await d.rbd_bench_seq()
            await d.rbd_random()
            await d.rbd_cached()
            await d.rgw_start()
            await d.rgw_put_get()
            await d.rgw_versioning()
            await d.rgw_swift()
            await d.striper()
            await d.striper_takeover()
            await d.kill()
            await d.rbd_degraded_read()
            await d.rgw_degraded_get()
            down = sorted(o for o in d.cluster.mon.osdmap.osds
                          if not d.cluster.mon.osd_is_up(o))
            await d.revive()
            await d.scrub()
            if crypto:
                await d.rbd_crypto()
            await d.rbd_features()
            await d.rbd_lock_takeover()
            await d.rbd_migration()
            await d.rbd_mirror()
            await d.rgw_delete()
            logged = (mark_downs(d.cluster),
                      [m for c in d.sites for m in mark_downs(c)])
            return down, logged
        finally:
            await d.stop()

    loop = asyncio.new_event_loop()
    try:
        down, (logged, site_logged) = loop.run_until_complete(
            asyncio.wait_for(main(), 240))
    finally:
        loop.close()
    rep = d.report
    assert not rep["mismatches"], rep["mismatches"]
    assert rep["failed_ops"] == 0, rep["errors"]
    assert down == [d.victim]
    # over the whole drive: the victim's one mark-down, none in the mirror
    assert len(logged) == 1 and logged[0].startswith(f"osd.{d.victim} ")
    assert site_logged == []
    assert rep["scrub_objects"] > 0 and not rep["scrub_inconsistent"]
    assert rep["rbd_seq_4k"]["ios"] == rep["rbd_random_4k"]["ios"] == 32
    assert "EBLOCKLISTED" in rep["lock_fence"]
    assert "BLOCKLISTED" in rep["striper_fence"]
    assert rep["mirror_snapshot_objects"][1] == 1
    assert rep.get("crypto_wrong_passphrase_refused") == (True if crypto
                                                          else None)
