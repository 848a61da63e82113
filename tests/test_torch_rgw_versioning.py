"""S3 versioning + lifecycle through the real HTTP gateway
(rgw_op.cc versioned PUT/GET/DELETE-marker semantics, rgw_lc.cc
expiration).

The port's counterpart of ``tests/test_rgw_versioning.py``: its cases on
``ceph_tpu_torch``, the daemons and librados on ``device="cpu"``.
"""

import time

import pytest

from ceph_tpu_torch.rgw.client import S3Error

from test_torch_rgw import boot
from torch_app_cases import run, teardown


def test_versioned_put_get_delete_marker_roundtrip():
    async def main():
        mon, osds, rados, gw, s3 = await boot()
        try:
            await s3.create_bucket("b")
            assert await s3.get_bucket_versioning("b") == ""
            await s3.put_bucket_versioning("b", "Enabled")
            assert await s3.get_bucket_versioning("b") == "Enabled"

            # three versions of one key; all readable by id
            vids = []
            for i in range(3):
                _, h, _ = await s3.request(
                    "PUT", "/b/k", body=f"v{i}".encode())
                vids.append(h["x-amz-version-id"])
            assert len(set(vids)) == 3
            assert await s3.get_object("b", "k") == b"v2"
            for i, vid in enumerate(vids):
                got = await s3.get_object_version("b", "k", vid)
                assert got == f"v{i}".encode()

            # plain DELETE writes a delete MARKER: GET 404s, versions
            # stay readable, listing hides the key
            out = await s3.delete_object("b", "k")
            assert out["delete_marker"] and out["version_id"]
            with pytest.raises(S3Error) as ei:
                await s3.get_object("b", "k")
            assert ei.value.code == "NoSuchKey"
            assert await s3.get_object_version("b", "k", vids[0]) \
                == b"v0"
            assert (await s3.list_objects("b"))["keys"] == []
            versions = await s3.list_object_versions("b")
            assert len(versions) == 4          # 3 data + 1 marker
            markers = [v for v in versions if v["delete_marker"]]
            assert len(markers) == 1 and markers[0]["is_latest"]

            # deleting the MARKER by id resurrects the key
            await s3.delete_object("b", "k",
                                   version_id=out["version_id"])
            assert await s3.get_object("b", "k") == b"v2"
            # deleting a specific data version removes just it
            await s3.delete_object("b", "k", version_id=vids[1])
            with pytest.raises(S3Error):
                await s3.get_object_version("b", "k", vids[1])
            assert await s3.get_object("b", "k") == b"v2"
            # removing the LATEST promotes the next-newest
            await s3.delete_object("b", "k", version_id=vids[2])
            assert await s3.get_object("b", "k") == b"v0"
        finally:
            await gw.stop()
            await teardown(mon, osds, rados)
    run(main())


def test_suspended_versioning_null_id():
    async def main():
        mon, osds, rados, gw, s3 = await boot()
        try:
            await s3.create_bucket("b")
            await s3.put_bucket_versioning("b", "Enabled")
            await s3.put_object("b", "k", b"kept-version")
            await s3.put_bucket_versioning("b", "Suspended")
            # suspended PUTs reuse the "null" id and displace only
            # the previous null version
            _, h, _ = await s3.request("PUT", "/b/k", body=b"null-1")
            assert h["x-amz-version-id"] == "null"
            await s3.request("PUT", "/b/k", body=b"null-2")
            assert await s3.get_object("b", "k") == b"null-2"
            versions = await s3.list_object_versions("b")
            nulls = [v for v in versions if v["version_id"] == "null"]
            assert len(nulls) == 1
            assert len(versions) == 2          # kept + null
        finally:
            await gw.stop()
            await teardown(mon, osds, rados)
    run(main())


def test_lifecycle_expiration_deletes():
    async def main():
        mon, osds, rados, gw, s3 = await boot()
        try:
            await s3.create_bucket("b")
            lc = (b'<LifecycleConfiguration>'
                  b'<Rule><ID>exp</ID><Prefix>logs/</Prefix>'
                  b'<Status>Enabled</Status>'
                  b'<Expiration><Days>7</Days></Expiration>'
                  b'</Rule></LifecycleConfiguration>')
            await s3.put_bucket_lifecycle("b", lc)
            got = await s3.get_bucket_lifecycle("b")
            assert b"<Days>7</Days>" in got and b"logs/" in got

            # backdate two objects 10 days via the store's clock
            import ceph_tpu_torch.rgw.store as store_mod
            orig_now = store_mod._now_iso
            old = time.gmtime(time.time() - 10 * 86400)
            store_mod._now_iso = lambda: time.strftime(
                "%Y-%m-%dT%H:%M:%S.000Z", old)
            try:
                await s3.put_object("b", "logs/old", b"ancient")
                await s3.put_object("b", "data/old",
                                    b"old but unmatched prefix")
            finally:
                store_mod._now_iso = orig_now
            await s3.put_object("b", "logs/new", b"recent")
            # LC now: only logs/old is both matched AND expired
            store = gw.store
            n = await store.lc_process("b")
            assert n == 1
            listing = await s3.list_objects("b")
            assert sorted(listing["keys"]) == ["data/old", "logs/new"]
        finally:
            await gw.stop()
            await teardown(mon, osds, rados)
    run(main())


def test_lifecycle_noncurrent_and_marker_reaping():
    async def main():
        mon, osds, rados, gw, s3 = await boot()
        try:
            await s3.create_bucket("b")
            await s3.put_bucket_versioning("b", "Enabled")
            lc = (b'<LifecycleConfiguration><Rule>'
                  b'<ID>nc</ID><Prefix></Prefix>'
                  b'<Status>Enabled</Status>'
                  b'<Expiration>'
                  b'<ExpiredObjectDeleteMarker>true'
                  b'</ExpiredObjectDeleteMarker></Expiration>'
                  b'<NoncurrentVersionExpiration><NoncurrentDays>3'
                  b'</NoncurrentDays></NoncurrentVersionExpiration>'
                  b'</Rule></LifecycleConfiguration>')
            await s3.put_bucket_lifecycle("b", lc)
            await s3.put_object("b", "k", b"old-version")
            await s3.put_object("b", "k", b"current")
            await s3.put_object("b", "gone", b"x")
            await s3.delete_object("b", "gone")   # marker on top
            vl = await s3.list_object_versions("b")
            # reap "gone"'s data version as noncurrent... first pass
            store = gw.store
            later = time.time() + 4 * 86400
            n1 = await store.lc_process("b", now=later)
            assert n1 >= 1
            # the noncurrent "k" version is gone; current survives
            assert await s3.get_object("b", "k") == b"current"
            vl = await s3.list_object_versions("b")
            k_versions = [v for v in vl if v["key"] == "k"]
            assert len(k_versions) == 1 and k_versions[0]["is_latest"]
            # second pass reaps the now-solo delete marker of "gone"
            await store.lc_process("b", now=later)
            vl = await s3.list_object_versions("b")
            assert not [v for v in vl if v["key"] == "gone"]
        finally:
            await gw.stop()
            await teardown(mon, osds, rados)
    run(main())


def test_suspend_preserves_enabled_versions_and_null_generations():
    """Regressions from review: suspending must never displace an
    ENABLED-era version's data; suspended re-PUTs must not corrupt the
    live null version on a failed index op; enabling versioning over
    an unversioned object preserves it as the null version."""
    async def main():
        mon, osds, rados, gw, s3 = await boot()
        try:
            await s3.create_bucket("b")
            # unversioned object, then versioning turned on
            await s3.put_object("b", "pre", b"pre-versioning")
            await s3.put_bucket_versioning("b", "Enabled")
            await s3.put_object("b", "pre", b"second")
            vl = [v for v in await s3.list_object_versions("b")
                  if v["key"] == "pre"]
            assert len(vl) == 2
            assert await s3.get_object_version("b", "pre", "null") \
                == b"pre-versioning"

            # enabled-era version survives a later suspended PUT
            _, h, _ = await s3.request("PUT", "/b/k", body=b"enabled-v")
            v1 = h["x-amz-version-id"]
            await s3.put_bucket_versioning("b", "Suspended")
            await s3.put_object("b", "k", b"null-a")
            await s3.put_object("b", "k", b"null-b")
            assert await s3.get_object_version("b", "k", v1) \
                == b"enabled-v"
            assert await s3.get_object("b", "k") == b"null-b"

            # versioned bucket with only markers/versions is NOT empty
            with pytest.raises(S3Error) as ei:
                await s3.delete_bucket("b")
            assert ei.value.code == "BucketNotEmpty"
        finally:
            await gw.stop()
            await teardown(mon, osds, rados)
    run(main())


def test_version_listing_pagination():
    async def main():
        mon, osds, rados, gw, s3 = await boot()
        try:
            await s3.create_bucket("b")
            await s3.put_bucket_versioning("b", "Enabled")
            for key in ("a", "b", "c"):
                for i in range(3):
                    await s3.put_object("b", key, f"{key}{i}".encode())
            seen = []
            q = {"versions": "", "max-keys": "4"}
            while True:
                _, _, body = await s3.request("GET", "/b", query=q)
                import xml.etree.ElementTree as ET
                root = ET.fromstring(body)
                ns = root.tag.partition("}")[0] + "}"
                for v in root.findall(f"{ns}Version"):
                    seen.append((v.findtext(f"{ns}Key"),
                                 v.findtext(f"{ns}VersionId")))
                if root.findtext(f"{ns}IsTruncated") != "true":
                    break
                q = {"versions": "", "max-keys": "4",
                     "key-marker": root.findtext(f"{ns}NextKeyMarker"),
                     "version-id-marker": root.findtext(
                         f"{ns}NextVersionIdMarker")}
            assert len(seen) == 9
            assert len(set(seen)) == 9         # no duplicates
        finally:
            await gw.stop()
            await teardown(mon, osds, rados)
    run(main())
