"""RGW analog: S3 REST over a live cluster through real HTTP + SigV4
(src/rgw/rgw_op.cc semantics; auth per rgw_auth_s3.cc).

The port's counterpart of ``tests/test_rgw.py``: its cases on
``ceph_tpu_torch``, the daemons and librados on ``device="cpu"``.
"""

import asyncio
import hashlib

import pytest

from torch_app_cases import Rados
from ceph_tpu_torch.rgw import Gateway, RgwStore
from ceph_tpu_torch.rgw.client import S3Client, S3Error

from torch_app_cases import make_cluster, run, teardown


async def boot():
    mon, osds = await make_cluster(3)
    rados = await Rados(mon.msgr.addr).connect()
    await rados.pool_create(".rgw", pg_num=8)
    io = await rados.open_ioctx(".rgw")
    store = RgwStore(io, stripe_unit=1 << 16)   # small stripes: test
    user = await store.create_user("alice", "Alice")  # multi-object paths
    gw = Gateway(store)
    addr = await gw.start()
    s3 = S3Client(addr, user["access_key"], user["secret"])
    return mon, osds, rados, gw, s3


def test_bucket_and_object_roundtrip():
    async def main():
        mon, osds, rados, gw, s3 = await boot()
        try:
            await s3.create_bucket("photos")
            assert await s3.list_buckets() == ["photos"]
            # bad signature is rejected
            bad = S3Client(s3.addr, s3.access_key, "wrong-secret")
            with pytest.raises(S3Error) as ei:
                await bad.create_bucket("x")
            assert ei.value.status == 403
            # put/get/head/delete with metadata and content type
            body = b"jpeg-bytes" * 1000
            etag = await s3.put_object(
                "photos", "cat.jpg", body,
                headers={"content-type": "image/jpeg",
                         "x-amz-meta-camera": "nikon"})
            assert etag == hashlib.md5(body).hexdigest()
            assert await s3.get_object("photos", "cat.jpg") == body
            h = await s3.head_object("photos", "cat.jpg")
            assert h["content-type"] == "image/jpeg"
            assert h["x-amz-meta-camera"] == "nikon"
            assert int(h["content-length"]) == len(body)
            # ranged read
            assert await s3.get_object("photos", "cat.jpg",
                                       range_="bytes=4-11") == body[4:12]
            assert await s3.get_object("photos", "cat.jpg",
                                       range_="bytes=-5") == body[-5:]
            # copy
            await s3.copy_object("photos", "cat.jpg", "photos", "copy.jpg")
            assert await s3.get_object("photos", "copy.jpg") == body
            # overwrite changes etag
            await s3.put_object("photos", "cat.jpg", b"v2")
            assert await s3.get_object("photos", "cat.jpg") == b"v2"
            # delete; bucket empties; bucket delete then succeeds
            with pytest.raises(S3Error):
                await s3.delete_bucket("photos")   # not empty: 409
            await s3.delete_object("photos", "cat.jpg")
            await s3.delete_object("photos", "copy.jpg")
            with pytest.raises(S3Error) as ei:
                await s3.get_object("photos", "cat.jpg")
            assert ei.value.code == "NoSuchKey"
            await s3.delete_bucket("photos")
            assert await s3.list_buckets() == []
        finally:
            await gw.stop()
            await teardown(mon, osds, rados)
    run(main())


def test_listing_prefix_delimiter_pagination():
    async def main():
        mon, osds, rados, gw, s3 = await boot()
        try:
            await s3.create_bucket("b")
            keys = (["docs/a.txt", "docs/b.txt", "docs/sub/c.txt",
                     "img/x.png", "top.txt"])
            for k in keys:
                await s3.put_object("b", k, k.encode())
            out = await s3.list_objects("b")
            assert out["keys"] == sorted(keys)
            # delimiter folds directories
            out = await s3.list_objects("b", delimiter="/")
            assert out["keys"] == ["top.txt"]
            assert out["prefixes"] == ["docs/", "img/"]
            out = await s3.list_objects("b", prefix="docs/",
                                        delimiter="/")
            assert out["keys"] == ["docs/a.txt", "docs/b.txt"]
            assert out["prefixes"] == ["docs/sub/"]
            # pagination
            seen = []
            token = ""
            while True:
                out = await s3.list_objects("b", max_keys=2,
                                            continuation=token)
                seen += out["keys"]
                if not out["truncated"]:
                    break
                token = out["next"]
            assert seen == sorted(keys)
        finally:
            await gw.stop()
            await teardown(mon, osds, rados)
    run(main())


def test_error_responses_and_copy_metadata():
    async def main():
        mon, osds, rados, gw, s3 = await boot()
        try:
            await s3.create_bucket("b")
            # malformed params produce an HTTP error, not a dead socket
            with pytest.raises(S3Error) as ei:
                await s3.request("GET", "/b",
                                 query={"list-type": "2",
                                        "max-keys": "abc"})
            assert ei.value.status == 400
            with pytest.raises(S3Error) as ei:
                await s3.request("POST", "/b/k",
                                 query={"uploadId": "xyz"},
                                 body=b"<not-xml")
            assert ei.value.status in (400, 404)
            # copy preserves source content-type and user metadata
            await s3.put_object("b", "src", b"data", headers={
                "content-type": "text/plain",
                "x-amz-meta-tag": "v1"})
            await s3.copy_object("b", "src", "b", "dst")
            h = await s3.head_object("b", "dst")
            assert h["content-type"] == "text/plain"
            assert h["x-amz-meta-tag"] == "v1"
        finally:
            await gw.stop()
            await teardown(mon, osds, rados)
    run(main())


def test_multipart_overwrite_and_abort_reclaim():
    """Overwriting a multipart object must reclaim the old manifest
    parts; abort must remove parts even across numbering gaps."""
    async def main():
        mon, osds, rados, gw, s3 = await boot()
        try:
            await s3.create_bucket("b")
            uid = await s3.initiate_multipart("b", "obj")
            await s3.upload_part("b", "obj", uid, 1, b"x" * (1 << 17))
            await s3.upload_part("b", "obj", uid, 2, b"y" * 1000)
            await s3.complete_multipart("b", "obj", uid, [1, 2])
            io = gw.store.ioctx
            before = len(await io.list_objects())
            # plain PUT over the multipart object: parts must die
            await s3.put_object("b", "obj", b"tiny")
            after = len(await io.list_objects())
            assert after < before, (before, after)
            assert await s3.get_object("b", "obj") == b"tiny"
            # abort with a numbering gap reclaims all recorded parts
            uid2 = await s3.initiate_multipart("b", "g")
            await s3.upload_part("b", "g", uid2, 1, b"a" * 500)
            await s3.upload_part("b", "g", uid2, 3, b"c" * 500)
            mid = len(await io.list_objects())
            await s3.abort_multipart("b", "g", uid2)
            assert len(await io.list_objects()) <= mid - 2
        finally:
            await gw.stop()
            await teardown(mon, osds, rados)
    run(main())


def test_multipart_upload():
    async def main():
        mon, osds, rados, gw, s3 = await boot()
        try:
            await s3.create_bucket("big")
            uid = await s3.initiate_multipart("big", "blob")
            p1 = b"A" * (1 << 17)          # 2 stripe units each
            p2 = b"B" * (1 << 17)
            p3 = b"C" * 1000
            await s3.upload_part("big", "blob", uid, 1, p1)
            await s3.upload_part("big", "blob", uid, 2, p2)
            await s3.upload_part("big", "blob", uid, 3, p3)
            etag = await s3.complete_multipart("big", "blob", uid,
                                               [1, 2, 3])
            assert etag.endswith("-3")
            whole = p1 + p2 + p3
            assert await s3.get_object("big", "blob") == whole
            # ranged read across part boundaries
            got = await s3.get_object(
                "big", "blob",
                range_=f"bytes={(1 << 17) - 10}-{(1 << 17) + 9}")
            assert got == whole[(1 << 17) - 10:(1 << 17) + 10]
            # delete removes manifest parts too
            await s3.delete_object("big", "blob")
            with pytest.raises(S3Error):
                await s3.get_object("big", "blob")
            # abort path
            uid2 = await s3.initiate_multipart("big", "tmp")
            await s3.upload_part("big", "tmp", uid2, 1, b"zzz")
            await s3.abort_multipart("big", "tmp", uid2)
            with pytest.raises(S3Error) as ei:
                await s3.complete_multipart("big", "tmp", uid2, [1])
            assert ei.value.code == "NoSuchUpload"
        finally:
            await gw.stop()
            await teardown(mon, osds, rados)
    run(main())
