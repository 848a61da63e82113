"""RGW analog: S3-style object gateway over RADOS.

Reference: src/rgw (op layer rgw_op.cc, request pump
rgw_process.cc:265, SAL driver abstraction driver/rados).  store.py is
the SAL layer; gateway.py the asio-frontend + auth + XML analog.

Port of ``ceph_tpu/rgw/__init__.py``; runs unchanged over the
port's librados.
"""

from .store import RgwStore, RgwError
from .gateway import Gateway

__all__ = ["RgwStore", "RgwError", "Gateway"]
