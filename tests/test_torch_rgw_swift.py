"""RGW Swift dialect over the shared store: TempAuth, containers,
objects, S3 interop (src/rgw/rgw_rest_swift.cc role).

The port's counterpart of ``tests/test_rgw_swift.py``: its cases on
``ceph_tpu_torch``, the daemons and librados on ``device="cpu"``.
"""

import asyncio
import json

import pytest

from ceph_tpu_torch.rgw.gateway import Gateway
from ceph_tpu_torch.rgw.store import RgwStore
from torch_app_cases import OSD, Monitor, Rados, run


async def http(addr, method, path, headers=None, body=b""):
    reader, writer = await asyncio.open_connection(*addr)
    hdrs = {"content-length": str(len(body)), **(headers or {})}
    lines = [f"{method} {path} HTTP/1.1", "host: x"]
    lines += [f"{k}: {v}" for k, v in hdrs.items()]
    writer.write(("\r\n".join(lines) + "\r\n\r\n").encode() + body)
    await writer.drain()
    status_line = await reader.readline()
    status = int(status_line.split()[1])
    rhdrs = {}
    while True:
        ln = await reader.readline()
        if ln in (b"\r\n", b"\n", b""):
            break
        k, _, v = ln.decode().partition(":")
        rhdrs[k.strip().lower()] = v.strip()
    n = int(rhdrs.get("content-length", "0") or "0")
    rbody = await reader.readexactly(n) if n else b""
    writer.close()
    return status, rhdrs, rbody


def test_swift_auth_containers_objects_and_s3_interop():
    async def main():
        mon = Monitor(rank=0, config={"mon_osd_min_down_reporters": 1})
        addr = await mon.start()
        mon.peer_addrs = [addr]
        osds = []
        for i in range(2):
            o = OSD(host=f"h{i}", whoami=i)
            await o.start(addr)
            osds.append(o)
        r = await Rados(addr, name="client.rgw").connect()
        await r.mon_command("osd pool create",
                            {"name": "rgw", "pg_num": 4, "size": 2})
        store = RgwStore(await r.open_ioctx("rgw"))
        user = await store.create_user("alice", "Alice")
        gw = Gateway(store)
        gaddr = await gw.start()

        # TempAuth: bad creds bounce, good ones mint a token
        st, _, _ = await http(gaddr, "GET", "/auth/v1.0",
                              {"x-auth-user": f"{user['access_key']}:u",
                               "x-auth-key": "wrong"})
        assert st == 401
        st, h, _ = await http(gaddr, "GET", "/auth/v1.0",
                              {"x-auth-user": f"{user['access_key']}:u",
                               "x-auth-key": user["secret"]})
        assert st == 200
        tok = {"x-auth-token": h["x-auth-token"]}
        base = h["x-storage-url"]

        # container + object lifecycle
        st, _, _ = await http(gaddr, "PUT", f"{base}/photos", tok)
        assert st == 201
        st, _, _ = await http(
            gaddr, "PUT", f"{base}/photos/cat.jpg",
            {**tok, "content-type": "image/jpeg",
             "x-object-meta-mood": "grumpy"},
            b"definitely a cat")
        assert st == 201
        st, h2, body = await http(gaddr, "GET",
                                  f"{base}/photos/cat.jpg", tok)
        assert st == 200 and body == b"definitely a cat"
        assert h2["content-type"] == "image/jpeg"
        assert h2["x-object-meta-mood"] == "grumpy"

        # listing with prefix; account listing
        await http(gaddr, "PUT", f"{base}/photos/dog.jpg", tok, b"dog")
        st, _, body = await http(gaddr, "GET",
                                 f"{base}/photos?prefix=cat", tok)
        assert [e["name"] for e in json.loads(body)] == ["cat.jpg"]
        st, _, body = await http(gaddr, "GET", base, tok)
        assert [c["name"] for c in json.loads(body)] == ["photos"]

        # the SAME object is visible through the S3 dialect
        from ceph_tpu_torch.rgw.client import S3Client
        s3 = S3Client(gaddr, user["access_key"], user["secret"])
        assert (await s3.get_object("photos", "cat.jpg")) == \
            b"definitely a cat"
        # and an S3 PUT shows up in Swift
        await s3.put_object("photos", "from-s3.bin", b"crossover")
        st, _, body = await http(gaddr, "GET", f"{base}/photos", tok)
        names = [e["name"] for e in json.loads(body)]
        assert "from-s3.bin" in names

        # deletes + non-empty container conflict
        st, _, _ = await http(gaddr, "DELETE", f"{base}/photos", tok)
        assert st == 409
        for k in ("cat.jpg", "dog.jpg", "from-s3.bin"):
            st, _, _ = await http(gaddr, "DELETE",
                                  f"{base}/photos/{k}", tok)
            assert st == 204
        st, _, _ = await http(gaddr, "DELETE", f"{base}/photos", tok)
        assert st == 204
        st, _, _ = await http(gaddr, "GET",
                              f"{base}/photos/cat.jpg", tok)
        assert st == 404

        await gw.stop()
        await r.shutdown()
        for o in osds:
            await o.stop()
        await mon.stop()
    run(main())
