"""Manager-plane modules (the mgr module host analog, src/pybind/mgr):
the mgr daemon (``mgr``), its prometheus exposition (``prometheus``) and
the upmap balancer (``balancer``), which reads the epoch placement
table.

Port of ``ceph_tpu/mgr/__init__.py``.
"""

from .mgr import Mgr, MgrModule  # noqa: F401,E402
