"""Client layer: Objecter (op engine) + librados-shaped API.

Port of ``ceph_tpu/client/``.  The client computes placement locally from
its own OSDMap copy, whose epoch table is built on the client's device --
no central metadata service (doc/architecture.rst:53-55,
Objecter._calc_target src/osdc/Objecter.cc:2783).
"""

from .objecter import Objecter
from .rados import Rados, IoCtx, RadosError
from .striper import Layout, RadosStriper

__all__ = ["Objecter", "Rados", "IoCtx", "RadosError", "Layout",
           "RadosStriper"]
