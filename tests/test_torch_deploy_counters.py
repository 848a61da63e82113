"""The port's own counters of the deployment layer: the MDS's spans of its
mutation path (``MDS.perf``) and ``kernel launches`` on a vstart daemon's
admin socket, each process's wrappers' launch counts."""

import asyncio
import os
import socket
import subprocess
import sys

from ceph_tpu_torch.common.admin_socket import AdminSocket, admin_command
from ceph_tpu_torch.device import launch_counts
from ceph_tpu_torch.ops import gf2kernels
from ceph_tpu_torch.tools.fs_drive import spans
from ceph_tpu_torch.tools.vstart import _serve_launches
from torch_app_cases import MDS, CephFS, Rados, make_cluster, run, teardown

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = {"gf2_matmul_popc", "gf2_matmul_mma", "xor_sched", "crc32c_chunks",
           "crush_map_rule", "crush_rule_lanes"}


def test_mds_spans_time_each_mutation_and_its_parts():
    async def main():
        mon, osds = await make_cluster(3)
        rados = await Rados(mon.msgr.addr).connect()
        for p in ("cephfs_metadata", "cephfs_data"):
            await rados.pool_create(p, pg_num=4)
        mds = MDS(name="a")
        await mds.start(mon.msgr.addr, create_pools=False)
        fs = None
        try:
            for _ in range(100):
                if mds.state == "active":
                    break
                await asyncio.sleep(0.1)
            fs = await CephFS(mon.msgr.addr).mount()
            before = mds.perf.dump()
            await fs.mkdir("/d")
            await asyncio.gather(*(fs.write_file(f"/d/f{i}", b"x" * 100)
                                   for i in range(3)))
            return spans(before, mds.perf.dump())
        finally:
            if fs is not None:
                await fs.unmount()
            await mds.stop()
            await teardown(mon, osds, rados)

    got = run(main(), timeout=120)
    # a mkdir, three creates and three sizes at close: each mutation
    # waited for the lock once and held it once, journaled and applied
    # once; a create or mkdir allocated an inode
    assert got["hold_mkdir"]["n"] == 1
    assert got["hold_create"]["n"] == 3 and got["hold_setattr"]["n"] == 3
    assert got["lock_wait"]["n"] == 7
    assert got["journal_append"]["n"] == 7
    assert got["dirfrag_apply"]["n"] == 7
    assert got["alloc_ino"]["n"] == 4
    # each file's write cap grant journaled outside the lock before its
    # open returns (a release may land after the close returns)
    assert got["wcap_journal"]["n"] >= 3
    held = sum(v["s"] for k, v in got.items() if k.startswith("hold_"))
    parts = sum(got[k]["s"] for k in ("journal_append", "dirfrag_apply",
                                      "alloc_ino"))
    assert 0 < parts <= held
    assert list(got) == sorted(got, key=lambda k: -got[k]["s"])


def test_kernel_launches_on_the_admin_socket_are_the_wrappers_counts(
        tmp_path):
    async def main():
        sock = AdminSocket(str(tmp_path / "osd.0.asok"))
        _serve_launches(sock)
        await sock.start()
        saved = gf2kernels.LAUNCHES["gf2_matmul_mma"]
        try:
            gf2kernels.LAUNCHES["gf2_matmul_mma"] = saved + 7
            return await admin_command(sock.path, "kernel launches")
        finally:
            gf2kernels.LAUNCHES["gf2_matmul_mma"] = saved
            await sock.stop()

    got = run(main(), timeout=30)
    assert set(got) == KERNELS
    assert got == {**launch_counts(),
                   "gf2_matmul_mma": launch_counts()["gf2_matmul_mma"] + 7}


def test_vstart_daemon_processes_serve_their_kernel_launches(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    store, asok = str(tmp_path / "store"), str(tmp_path / "asok")
    procs = []

    def spawn(*args):
        p = subprocess.Popen(
            [sys.executable, "-m", "ceph_tpu_torch.tools.vstart",
             "--device", "cpu", "--store-dir", store, "--asok-dir", asok,
             *args], cwd=REPO, env={**os.environ, "PYTHONPATH": REPO},
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        procs.append(p)
        return p

    def wait_line(p, needle):
        for line in p.stdout:
            if needle in line:
                return
        raise AssertionError(f"daemon exited {p.poll()} before {needle!r}")

    try:
        wait_line(spawn("--role", "mon", "--mon-port", str(port)), "mon.0 at")
        wait_line(spawn("--role", "osd", "--mon-addr", f"127.0.0.1:{port}",
                        "--osd-index", "0", "--store", "block"),
                  "up (block store)")
        got = {name: run(admin_command(os.path.join(asok, f"{name}.asok"),
                                       "kernel launches"), timeout=30)
               for name in ("mon.0", "osd.0")}
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            try:
                p.wait(timeout=20)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    # on the CPU every wrapper runs its plain version: no kernel launched
    for counts in got.values():
        assert counts == {name: 0 for name in KERNELS}
