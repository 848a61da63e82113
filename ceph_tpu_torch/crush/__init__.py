"""CRUSH: deterministic pseudo-random placement.

Port of ``ceph_tpu/crush``.  The host modules (types, hashes, crush_ln and
its tables, the scalar mapper, the builders) are copies; the scalar mapper
mirrors the reference's pure-C core (src/crush/mapper.c) decision for
decision.  ``crush/vectorized.py`` computes bulk PG->OSD mappings on the
card with kernel K5 -- the job the reference parallelizes on thread pools
via ParallelPGMapper (src/osd/OSDMapMapping.h:18).
"""

from .hashes import (  # noqa: F401
    crush_hash32,
    crush_hash32_2,
    crush_hash32_3,
    crush_hash32_4,
    crush_hash32_5,
    ceph_str_hash_rjenkins,
)
from .ln import crush_ln  # noqa: F401
from .types import (  # noqa: F401
    CrushMap,
    Bucket,
    Rule,
    RuleStep,
    Tunables,
    CRUSH_BUCKET_UNIFORM,
    CRUSH_BUCKET_LIST,
    CRUSH_BUCKET_TREE,
    CRUSH_BUCKET_STRAW,
    CRUSH_BUCKET_STRAW2,
    CRUSH_ITEM_NONE,
    CRUSH_ITEM_UNDEF,
)
from .mapper import crush_do_rule  # noqa: F401
from .builder import build_flat_map, build_two_level_map  # noqa: F401
