"""The deployment layer's entry points run on the card unless the caller
names the CPU: without a card, ``Mgr``, ``MDS``, ``CephFS``, ``FsDrive``,
``vstart`` in each role and every CLI that builds a client raise instead
of carrying on on the CPU (the exporter reads admin sockets only)."""

import asyncio

import pytest
import torch

ADDR = ("127.0.0.1", 1)
MON = "127.0.0.1:1"


def _mgr():
    from ceph_tpu_torch.mgr import Mgr
    Mgr()


def _mds():
    from ceph_tpu_torch.mds import MDS
    MDS()


def _cephfs():
    from ceph_tpu_torch.mds import CephFS
    CephFS(ADDR)


def _fs_drive():
    from ceph_tpu_torch.tools.fs_drive import FsDrive
    asyncio.run(FsDrive(n_osds=3, k=2, m=1).boot())


def _cli(tool, *argv):
    def call():
        import importlib
        importlib.import_module(f"ceph_tpu_torch.tools.{tool}").main(
            list(argv))
    return call


ENTRY_POINTS = {
    "Mgr": _mgr, "MDS": _mds, "CephFS": _cephfs, "FsDrive": _fs_drive,
    "vstart mon": _cli("vstart", "--role", "mon", "--mon-port", "0"),
    "vstart osd": _cli("vstart", "--role", "osd", "--mon-addr", MON),
    "vstart all": _cli("vstart", "--mon-port", "0"),
    "ceph_cli": _cli("ceph_cli", "-m", MON, "status"),
    "rados_cli": _cli("rados_cli", "-m", MON, "lspools"),
    "cephfs_cli": _cli("cephfs_cli", "--mon", MON, "ls"),
    "cephfs_mirror": _cli("cephfs_mirror", "--src-mon", MON, "ls"),
    "rbd_cli": _cli("rbd_cli", "--mon", MON, "ls"),
    "rgw_cli": _cli("rgw_cli", "--mon", MON, "bucket", "list"),
    "rbd_mirror": _cli("rbd_mirror", "--src-mon", MON, "--dst-mon", MON),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_deployment_entry_points_need_a_card_unless_told_cpu(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        ENTRY_POINTS[name]()
