"""The port's offline tools (``ceph_tpu_torch/tools/{dencoder,monstore_tool,
objectstore_tool}.py``) against ``ceph_tpu``'s.

A durable port cluster on the CPU (a monitor and 3 OSDs on ``DBStore``)
writes, stops, and leaves its stores behind; the port's tools run the
reference's round trip on them, and the reference's tools read the same
files and print the same output.
"""

import asyncio
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from ceph_tpu.tools import dencoder as ref_dencoder
from ceph_tpu.tools import monstore_tool as ref_monstore
from ceph_tpu.tools import objectstore_tool as ref_objectstore
from ceph_tpu_torch.client import Rados
from ceph_tpu_torch.mon import Monitor
from ceph_tpu_torch.os.store import DBStore
from ceph_tpu_torch.osd import OSD
from ceph_tpu_torch.tools import (dencoder, monstore_tool, objectstore_tool,
                                  osdmaptool)

ROOT = Path(__file__).resolve().parent.parent
CORPUS = ROOT / "tests" / "fixtures" / "corpus"


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(asyncio.wait_for(coro, 120))
    finally:
        loop.close()


def out_of(main, argv) -> tuple[int, str]:
    """A tool's exit code and standard output."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


async def _durable_cluster(path: str):
    mon = Monitor(rank=0, store_path=os.path.join(path, "mon.db"),
                  config={"mon_osd_min_down_reporters": 1}, device="cpu")
    addr = await mon.start()
    mon.peer_addrs = [addr]
    osds = []
    for i in range(3):
        store = DBStore(os.path.join(path, f"osd{i}.db"))
        o = OSD(host=f"host{i}", store=store, device="cpu")
        await o.start(addr)
        osds.append(o)
    rados = await Rados(mon.msgr.addr, device="cpu").connect()
    try:
        await rados.pool_create("p", pg_num=4, size=3)
        ioctx = await rados.open_ioctx("p")
        for i in range(12):
            await ioctx.write_full(f"obj{i}", f"payload-{i}".encode())
        return await rados.mon_command("osd dump", {})
    finally:
        await rados.shutdown()
        for o in osds:
            await o.stop()
        await mon.stop()


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """The stores a stopped port cluster left, and its last `osd dump`."""
    path = tmp_path_factory.mktemp("port_cluster")
    mapdump = run(_durable_cluster(str(path)))
    return path, mapdump


def _copy(stores, tmp_path, name):
    """A copy of one store, with SQLite's write-ahead log beside it."""
    path, _ = stores
    for suffix in ("", "-wal", "-shm"):
        if (path / (name + suffix)).exists():
            shutil.copy(path / (name + suffix), tmp_path / (name + suffix))
    return str(tmp_path / name)


def _listing(main, db):
    rc, out = out_of(main, ["--data-path", db, "--op", "list"])
    assert rc == 0
    return out


def test_port_offline_tools_roundtrip(stores, tmp_path):
    """The reference's round trip (``tests/test_offline_tools.py``) with the
    port's tools on the port's stores, maps built on the CPU."""
    path, mapdump = stores
    map_path = str(tmp_path / "map.json")
    Path(map_path).write_text(json.dumps(mapdump))
    rc, out = out_of(osdmaptool.main, [map_path, "--print", "--device", "cpu"])
    assert rc == 0 and "pool 1 'p'" in out and "osd.0" in out
    rc, out = out_of(osdmaptool.main,
                     [map_path, "--test-map-pgs", "--device", "cpu"])
    assert rc == 0 and "pool pg count: 4" in out and "size 3\t4" in out

    db0 = _copy(stores, tmp_path, "osd0.db")
    listing = [json.loads(line) for line in
               _listing(objectstore_tool.main, db0).splitlines()]
    pg_objs = [(pg, oid) for pg, oid in listing if oid.startswith("obj")]
    assert pg_objs, "osd.0 holds no client objects"
    pgid, oid = pg_objs[0]
    rc, out = out_of(objectstore_tool.main, ["--data-path", db0, "--op",
                                             "dump", "--pgid", pgid,
                                             "--oid", oid])
    rec = json.loads(out)
    assert rc == 0 and bytes.fromhex(rec["data"]).startswith(b"payload-")
    rc, out = out_of(objectstore_tool.main, ["--data-path", db0, "--op",
                                             "meta", "--pgid", pgid])
    meta = json.loads(out)
    assert rc == 0 and meta["info"]["pgid"] == pgid
    assert meta["log"]["entries"] > 0
    export = str(tmp_path / "pg.export")
    assert objectstore_tool.main(["--data-path", db0, "--op", "export",
                                  "--pgid", pgid, "--file", export]) == 0
    assert objectstore_tool.main(["--data-path", db0, "--op", "remove",
                                  "--pgid", pgid, "--oid", oid]) == 0
    st = DBStore(db0)
    st.mount()
    assert oid not in st.list_objects(f"pg_{pgid}")
    del st
    assert objectstore_tool.main(["--data-path", db0, "--op", "import",
                                  "--file", export]) == 0
    st = DBStore(db0)
    st.mount()
    assert st.read(f"pg_{pgid}", oid) == bytes.fromhex(rec["data"])

    mon_db = str(path / "mon.db")
    rc, out = out_of(monstore_tool.main, [mon_db, "dump-versions"])
    assert rc == 0 and "last_committed:" in out and "version 1" in out
    rc, out = out_of(monstore_tool.main, [mon_db, "get-version", "1"])
    assert rc == 0
    json.loads(out)
    rc, out = out_of(monstore_tool.main, [mon_db, "get-osdmap"])
    final_map = json.loads(out)
    assert rc == 0 and final_map["epoch"] == mapdump["epoch"]
    assert [s["name"] for s in final_map["pools"].values()] == ["p"]
    replay_path = str(tmp_path / "replayed.json")
    Path(replay_path).write_text(json.dumps(final_map))
    rc, out = out_of(osdmaptool.main,
                     [replay_path, "--test-map-pgs", "--device", "cpu"])
    assert rc == 0 and "pool pg count: 4" in out


@pytest.mark.parametrize("argv", [["dump-versions"], ["get-version", "1"],
                                  ["get-version", "2"], ["get-osdmap"],
                                  ["show-kv"]])
def test_monstore_tool_output_matches_reference(stores, argv):
    """Over the same ``mon.db``, the two tools print the same text (for
    ``get-osdmap``: the same replayed map dict)."""
    path, mapdump = stores
    mon_db = str(path / "mon.db")
    rc, port = out_of(monstore_tool.main, [mon_db, *argv])
    rc_ref, ref = out_of(ref_monstore.main, [mon_db, *argv])
    assert rc == rc_ref == 0
    assert port == ref
    if argv == ["get-osdmap"]:
        assert json.loads(port) == json.loads(ref)
        assert json.loads(port)["epoch"] == mapdump["epoch"]


def test_monstore_tool_unknown_version_matches_reference(stores, capsys):
    path, _ = stores
    mon_db = str(path / "mon.db")
    assert monstore_tool.main([mon_db, "get-version", "99999"]) == 1
    port = capsys.readouterr().err
    assert ref_monstore.main([mon_db, "get-version", "99999"]) == 1
    assert capsys.readouterr().err == port


@pytest.mark.parametrize("osd", [0, 1, 2])
def test_objectstore_tool_list_matches_reference(stores, osd):
    path, _ = stores
    db = str(path / f"osd{osd}.db")
    port = _listing(objectstore_tool.main, db)
    assert port and port == _listing(ref_objectstore.main, db)


@pytest.mark.parametrize("op", ["dump", "info", "meta"])
def test_objectstore_tool_object_ops_match_reference(stores, op):
    """``dump`` / ``info`` of every object of osd.0 and ``meta`` of each of
    its PGs print the same JSON from both tools."""
    path, _ = stores
    db = str(path / "osd0.db")
    listing = [json.loads(line) for line in
               _listing(objectstore_tool.main, db).splitlines()]
    pgs = sorted({pg for pg, _ in listing})
    targets = ([["--pgid", pg] for pg in pgs] if op == "meta" else
               [["--pgid", pg, "--oid", oid] for pg, oid in listing
                if oid.startswith("obj")])
    assert targets
    for extra in targets:
        argv = ["--data-path", db, "--op", op, *extra]
        rc, port = out_of(objectstore_tool.main, argv)
        rc_ref, ref = out_of(ref_objectstore.main, argv)
        assert rc == rc_ref == 0 and port == ref, extra


def test_objectstore_tool_export_matches_reference(stores, tmp_path):
    path, _ = stores
    db = str(path / "osd0.db")
    pg = json.loads(_listing(objectstore_tool.main, db).splitlines()[0])[0]
    port, ref = str(tmp_path / "port.export"), str(tmp_path / "ref.export")
    assert objectstore_tool.main(["--data-path", db, "--op", "export",
                                  "--pgid", pg, "--file", port]) == 0
    assert ref_objectstore.main(["--data-path", db, "--op", "export",
                                 "--pgid", pg, "--file", ref]) == 0
    assert Path(port).read_bytes() == Path(ref).read_bytes()


def test_dencoder_passes_the_committed_corpus(capsys):
    assert dencoder.corpus_check(str(CORPUS)) == 0
    out = capsys.readouterr().out
    assert "0 failures" in out and "checked 0 " not in out


@pytest.mark.parametrize("name", sorted(ref_dencoder.TYPES))
def test_dencoder_samples_encode_alike(name):
    """Each registered type's samples encode to the same bytes in both
    packages, and decode to the same dump."""
    port, ref = dencoder.TYPES[name], ref_dencoder.TYPES[name]
    port_blobs = [port["enc"](o) for o in port["samples"]()]
    ref_blobs = [ref["enc"](o) for o in ref["samples"]()]
    assert port_blobs == ref_blobs and port_blobs
    for blob in ref_blobs:
        assert port["dump"](port["dec"](blob)) == ref["dump"](ref["dec"](blob))


def test_dencoder_lists_the_reference_types():
    assert set(dencoder.TYPES) == set(ref_dencoder.TYPES)
    rc, out = out_of(dencoder.main, ["list_types"])
    assert rc == 0 and out == out_of(ref_dencoder.main, ["list_types"])[1]


def test_dencoder_corpus_generate_writes_under_its_root(tmp_path, capsys):
    """A corpus generated by the port passes both tools' checks and equals
    the reference's, file by file; nothing is written outside the root."""
    port, ref = tmp_path / "port", tmp_path / "ref"
    assert dencoder.main(["corpus_generate", str(port)]) == 0
    assert ref_dencoder.main(["corpus_generate", str(ref)]) == 0
    files = sorted(p.relative_to(port) for p in port.rglob("*") if p.is_file())
    assert files and files == sorted(p.relative_to(ref)
                                     for p in ref.rglob("*") if p.is_file())
    for rel in files:
        assert (port / rel).read_bytes() == (ref / rel).read_bytes(), rel
    assert sorted(os.listdir(tmp_path)) == ["port", "ref"]
    assert dencoder.corpus_check(str(port)) == 0
    assert ref_dencoder.corpus_check(str(port)) == 0


def test_dencoder_cli_decodes_a_sample():
    """``type X encode_sample | type X decode`` through the module's CLI."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    cmd = [sys.executable, "-m", "ceph_tpu_torch.tools.dencoder", "type",
           "PGInfo"]
    blob = subprocess.run(cmd + ["encode_sample"], capture_output=True,
                          env=env, cwd=ROOT, timeout=120, check=True).stdout
    out = subprocess.run(cmd + ["decode"], input=blob, capture_output=True,
                         env=env, cwd=ROOT, timeout=120, check=True).stdout
    sample = next(ref_dencoder.TYPES["PGInfo"]["samples"]())
    assert json.loads(out) == sample.to_dict()


async def _cluster_until_stop(path: str):
    """A durable port cluster with an EC pool, stopped after its client
    recorded what phase 13b records before its stop: the monitor's `osd
    dump` and the client's up set of every PG of the pool at that epoch."""
    mon = Monitor(rank=0, store_path=os.path.join(path, "mon.db"),
                  config={"mon_osd_min_down_reporters": 1}, device="cpu")
    addr = await mon.start()
    mon.peer_addrs = [addr]
    osds = []
    for i in range(6):
        o = OSD(host=f"host{i}", store=DBStore(os.path.join(path,
                                                            f"osd{i}.db")),
                device="cpu")
        await o.start(addr)
        osds.append(o)
    rados = await Rados(mon.msgr.addr, device="cpu").connect()
    try:
        await rados.mon_command("osd erasure-code-profile set", {
            "name": "ec42", "profile": {"k": "4", "m": "2",
                                        "plugin": "cuda"}})
        await rados.pool_create("ec42", pg_num=8, pool_type="erasure",
                                erasure_code_profile="ec42")
        ioctx = await rados.open_ioctx("ec42")
        await ioctx.write_full("obj", b"x" * 8192)
        dump = await rados.mon_command("osd dump", {})
        m = rados.objecter.osdmap
        assert m.epoch == dump["epoch"]
        pid = m.pool_names["ec42"]
        return {"dump": dump, "pool_id": pid,
                "up": [m.pg_to_up_acting(pid, ps)[0] for ps in range(8)]}
    finally:
        await rados.shutdown()
        for o in osds:
            await o.stop()
        await mon.stop()


def test_chip_smoke_offline_hook_on_the_cpu(tmp_path, capsys):
    """Phase 13b's offline hook (``chip_smoke.vstart_offline``) on a CPU
    cluster's monitor store: the store replayed up to the recorded epoch
    equals its dump, and the replayed map maps every PG of the EC pool onto
    the client's up sets; a changed dump or up set fails it."""
    import torch
    import chip_smoke
    at_stop = run(_cluster_until_stop(str(tmp_path)))
    out = chip_smoke.vstart_offline(at_stop, str(tmp_path), str(tmp_path),
                                    torch.device("cpu"))
    assert out["epoch"] == at_stop["dump"]["epoch"]
    assert out["final_epoch"] >= out["epoch"]
    assert out["pool_pgs"] == 8 and out["versions"] >= out["epoch"]
    assert out["pg_count"].startswith("pool pg count: ")
    wrong = json.loads(json.dumps(at_stop))
    wrong["up"][3] = wrong["up"][3][::-1]
    with pytest.raises(RuntimeError, match="off the client's up sets"):
        chip_smoke.vstart_offline(wrong, str(tmp_path), str(tmp_path),
                                  torch.device("cpu"))
    wrong = json.loads(json.dumps(at_stop))
    wrong["dump"]["max_osd"] += 1
    with pytest.raises(RuntimeError, match="differs from epoch"):
        chip_smoke.vstart_offline(wrong, str(tmp_path), str(tmp_path),
                                  torch.device("cpu"))
