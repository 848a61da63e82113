"""The port's CLIs against the reference's, each on a cluster of its own
package: ``tests/test_client.py::test_cli_smoke`` (``rados_cli`` and
``ceph_cli``) on the port, then ``cephfs_cli``, ``rbd_cli`` and
``rgw_cli`` (its gateway served by a process of its own).  Each runs the
same argv on each package and must print the same output, timings, ids
and ports masked (``torch_cli_cases.mask``)."""

import asyncio
import json

import torch

from torch_cli_cases import Site, mask, on_both

torch.set_num_threads(1)


def test_cli_smoke(tmp_path):
    """rados + ceph CLI mains against a live cluster (in-process)."""
    def script(pkg):
        s = Site(pkg)
        try:
            f = tmp_path / f"{pkg}-payload.bin"
            f.write_bytes(b"cli-payload" * 100)
            out = tmp_path / f"{pkg}-out.bin"
            runs = [
                s.cli("ceph_cli", "-m", s.mon, "osd", "pool", "create",
                      "cli", "4"),
                s.cli("rados_cli", "-m", s.mon, "put", "cli", "obj1",
                      str(f)),
                s.cli("rados_cli", "-m", s.mon, "get", "cli", "obj1",
                      str(out)),
                s.cli("rados_cli", "-m", s.mon, "ls", "cli"),
                s.cli("rados_cli", "-m", s.mon, "stat", "cli", "obj1"),
                s.cli("ceph_cli", "-m", s.mon, "status"),
                s.cli("ceph_cli", "-m", s.mon, "osd", "tree"),
                s.cli("ceph_cli", "-m", s.mon, "osd", "pool", "ls")]
            return out.read_bytes(), [(rc, mask(o)) for rc, o in runs]
        finally:
            s.stop()
    ref, port = on_both(script)
    assert port[0] == b"cli-payload" * 100
    assert all(rc == 0 for rc, _ in port[1])
    assert "obj1" in port[1][3][1]
    assert "HEALTH_OK" in port[1][5][1] or "3 up" in port[1][5][1]
    assert port == ref


def test_cephfs_cli(tmp_path):
    def script(pkg):
        s = Site(pkg, fs=True)
        try:
            src = tmp_path / f"{pkg}-in.bin"
            src.write_bytes(bytes(range(256)) * 300)
            dst = tmp_path / f"{pkg}-out.bin"
            runs = [s.cli("cephfs_cli", "--mon", s.mon, *argv) for argv in (
                ("mkdir", "/a"), ("mkdir", "/a/b"),
                ("put", str(src), "/a/f"), ("ls", "/a"), ("stat", "/a/f"),
                ("get", "/a/f", str(dst)), ("mv", "/a/f", "/a/b/g"),
                ("tree", "/"), ("rm", "/a/b/g"), ("rmdir", "/a/b"),
                ("ls", "/a"))]
            return dst.read_bytes(), [(rc, mask(o)) for rc, o in runs]
        finally:
            s.stop()
    ref, port = on_both(script)
    assert port[0] == bytes(range(256)) * 300
    assert all(rc == 0 for rc, _ in port[1])
    assert "76800 f" in port[1][3][1]
    assert port == ref


def test_rbd_cli(tmp_path):
    def script(pkg):
        s = Site(pkg)
        try:
            s.run(s.c.rados.pool_create("rbd", pg_num=4))
            out = tmp_path / f"{pkg}-export.bin"
            runs = [s.cli("rbd_cli", "--mon", s.mon, *argv) for argv in (
                ("create", "img", "--size", "256K", "--order", "16"),
                ("ls",), ("info", "img"), ("snap", "create", "img", "s1"),
                ("snap", "ls", "img"),
                ("bench", "img", "--io-size", "4K", "--io-total", "64K"),
                ("resize", "img", "--size", "512K"),
                ("export", "img", str(out)),
                ("mirror", "enable", "img"), ("mirror", "ls"),
                ("info", "img"))]
            return out.read_bytes(), [(rc, mask(o)) for rc, o in runs]
        finally:
            s.stop()
    ref, port = on_both(script)
    # the bench's 16 writes of its repeating 4 KiB buffer, then zeros
    block = (bytes(range(256)) * 16) * 16
    assert port[0] == block + b"\0" * ((512 << 10) - len(block))
    assert all(rc == 0 for rc, _ in port[1])
    assert "ops 16" in port[1][5][1]
    assert port == ref


def test_rgw_cli():
    def script(pkg):
        s = Site(pkg)
        try:
            runs = [s.cli("rgw_cli", "--mon", s.mon, "user", "create",
                          "--uid", "alice", "--display-name", "Alice",
                          "--access-key", "AK", "--secret", "SK"),
                    s.cli("rgw_cli", "--mon", s.mon, "bucket", "list")]
            S3Client = s.mod("rgw.client").S3Client

            async def serve():
                proc = await s.spawn("rgw_cli", "--mon", s.mon, "serve",
                                     "--port", "0")
                banner = await Site.banner(proc)
                host, port = banner.split()[-1].split(":")
                s3 = S3Client((host, int(port)), "AK", "SK")
                await s3.create_bucket("bkt")
                await s3.put_object("bkt", "key", b"rgw-body" * 1000)
                got = await s3.get_object("bkt", "key")
                rc, rest = await Site.end(proc)
                return banner, got, rc, rest
            banner, got, rc, rest = s.run(serve())
            runs.append(s.cli("rgw_cli", "--mon", s.mon, "bucket", "list"))
            return (got, rc, mask(banner + rest),
                    [(r, mask(o)) for r, o in runs],
                    json.loads(runs[0][1])["uid"])
        finally:
            s.stop()
    ref, port = on_both(script)
    assert port[0] == b"rgw-body" * 1000 and port[1] == 0
    assert port[4] == "alice" and "bkt" in port[3][2][1]
    assert port == ref
