"""Async messenger: the host-side control/data plane transport.

Port of ``ceph_tpu/msg/``, host code: everything the daemons send each
other (maps, peering, heartbeats, rep/EC sub-ops) rides this asyncio
messenger with v2-lite frames (length-prefixed, crc32c-checksummed by the
host engine of ``native.py``, HMAC-authenticated session setup -- the
ProtocolV2 crc-mode analog, src/msg/async/ProtocolV2.h:19-56).  Large
frames are checksummed, sealed and compressed in executor threads, which
make no CUDA call.
"""

from .message import Message  # noqa: F401
from .messenger import Messenger, Connection  # noqa: F401
