"""MDS + CephFS analog: metadata daemon, journal, POSIX-ish client.

Reference: src/mds (Server.cc client RPC, MDLog/Journaler metadata
journal, MDCache dirfrag storage), src/client (libcephfs).

Port of ``ceph_tpu/mds/__init__.py``.
"""

from .server import MDS
from .client import CephFS, FsError

__all__ = ["MDS", "CephFS", "FsError"]
