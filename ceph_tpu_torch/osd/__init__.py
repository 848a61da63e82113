"""OSD data plane: PGs, log-based recovery, replicated/EC backends.

Port of ``ceph_tpu/osd/``.  The PG op path, the logs, peering, the
scheduler and the object classes are host code, copied.  The device
reaches the OSD through its ``device``: the EC codec of every PG
(``backend.ECBackend``), the cross-PG ``codec_batcher.CodecBatcher``
(one ``MeshCodec`` launch a batch), the device-resident shard cache and
the epoch placement table of its ``OSDMap``.
"""

from .types import EVersion, LogEntry, PGInfo, MissingSet, PastIntervals
from .pg_log import PGLog
from .ec_util import StripeInfo
from .scheduler import MClockScheduler, OpClass
from .osd import OSD
from .pg import PG

__all__ = [
    "EVersion", "LogEntry", "PGInfo", "MissingSet", "PastIntervals",
    "PGLog", "StripeInfo", "MClockScheduler", "OpClass", "OSD", "PG",
]
