"""librbd analog: block images on RADOS.

Reference: src/librbd (io path ImageRequest.cc -> ObjectRequest ->
Objecter; metadata via cls_rbd).  See rbd.py.

Port of ``ceph_tpu/rbd/__init__.py``; runs unchanged over the
port's librados.
"""

from .rbd import RBD, Image, RbdError

__all__ = ["RBD", "Image", "RbdError"]
