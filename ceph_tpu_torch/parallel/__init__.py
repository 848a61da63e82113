"""The data plane's launch engines: ``MeshCodec``, a one-card stripe plane,
and the sharded codec over ``torch.distributed`` ranks (``sharded_ec``)."""

from .mesh_codec import MeshCodec  # noqa: F401
from .sharded_ec import (  # noqa: F401
    assemble,
    backend_for,
    gather_blocks,
    local_block,
    lrc_make_mesh,
    lrc_sharded_encode,
    lrc_sharded_local_repair,
    make_data_mesh,
    make_mesh,
    mesh_shape,
    sharded_cross_recovery,
    sharded_encode,
    sharded_ec_step,
    sharded_rmw,
)
