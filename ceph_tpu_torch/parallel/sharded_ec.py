"""Sharded erasure coding over ``torch.distributed``.

Port of ``ceph_tpu/parallel/sharded_ec.py``.  The reference maps the EC
write fan-out (src/osd/ECBackend.cc:1467 -> MOSDECSubOpWrite per shard) onto
a jax device ``Mesh``: stripes shard across a 'stripe' axis, the k data
chunks across a 'shard' axis, parity needs all k chunks (an all_gather over
'shard'), and each 'shard' row computes a slice of the parity rows.  Here
the mesh is a ``torch.distributed`` ``DeviceMesh`` of ranks, one process
a rank, and each rank holds its own block, as ``shard_map``'s block
functions do:

* the process group is the caller's (``init_process_group``): NCCL on the
  card, gloo on the CPU (``backend_for``); ``make_mesh`` /
  ``make_data_mesh`` / ``lrc_make_mesh`` lay it out as the reference's
  meshes, with the reference's shard-axis fallback;
* every function takes and returns rank-local blocks in the layout of the
  reference's ``PartitionSpec``s (``SPECS``); ``local_block`` cuts a global
  array into this rank's block and ``assemble`` puts the blocks of every
  rank back together;
* each product is ``ops.gf2kernels.gf_matmul_batch_device`` on the rank's
  (B_loc, k, L) block as it is: K3 where the port's routing says
  "scheduled", else K1/K2 -- no (k, B*L) transpose, which the reference
  needs only for its ``dot_general``;
* the collectives (all_gather, broadcast, all_reduce) and the checksum are
  torch calls outside any kernel.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from ..gf import build_decode_matrix, gen_rs_matrix
from ..ops.gf2kernels import gf_matmul_batch_device

# the reference's PartitionSpecs: tensor dim -> mesh axis (None replicated)
SPECS = {
    "chunks": ("stripe", "shard", None),     # (B, k|r, L) over (stripe, shard)
    "stripes": ("stripe", None, None),       # (B, n, L) over stripe only
    "checksum": ("stripe",),                 # (n_stripe,) one a stripe slice
    "groups": ("stripe", "group", None, None),   # (B, n_groups, n, L)
}


def backend_for(device) -> str:
    """The collective backend of a device: NCCL on the card, gloo on the
    CPU."""
    return "nccl" if resolve_device(device).type == "cuda" else "gloo"


def _mesh(shape: tuple, names: tuple, device):
    from torch.distributed.device_mesh import init_device_mesh
    dev = resolve_device(device)
    world = dist.get_world_size()
    if int(np.prod(shape)) != world:
        raise ValueError(f"a mesh of {shape} needs {int(np.prod(shape))} "
                         f"ranks; the process group has {world}")
    return init_device_mesh(dev.type, shape, mesh_dim_names=names)


def make_mesh(n_devices: int | None = None, shard_axis: int = 2,
              device=None):
    """(stripe, shard) mesh over the process group's n ranks (all of
    them); the shard axis is 1 when it does not divide n."""
    n = n_devices or dist.get_world_size()
    shard = shard_axis if n % shard_axis == 0 else 1
    return _mesh((n // shard, shard), ("stripe", "shard"), device)


def make_data_mesh(n_devices: int | None = None, device=None):
    """1-D ('stripe',) mesh: every stripe is independent, so a block needs
    no collective (the live data plane's layout, ``MeshCodec``'s)."""
    return _mesh((n_devices or dist.get_world_size(),), ("stripe",), device)


def lrc_make_mesh(n_devices: int, n_groups: int, device=None):
    """(stripe, group) mesh: the group axis carries the LRC local groups."""
    return _mesh((n_devices // n_groups, n_groups), ("stripe", "group"),
                 device)


def mesh_shape(mesh) -> dict:
    """{axis name: size}, as the reference's ``dict(mesh.shape)``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axis(mesh, name: str) -> tuple[int, int]:
    """(this rank's coordinate on axis ``name``, the axis' size)."""
    return mesh.get_local_rank(name), mesh.size(
        mesh.mesh_dim_names.index(name))


def _span(n: int, coord: int, size: int) -> tuple[int, int]:
    """Coordinate ``coord``'s part [lo, hi) of n entries split over an axis
    of ``size``: ceil(n / size) a coordinate, the last ones shorter (or
    empty) where size does not divide n, as the reference pads a row
    split."""
    per = -(-n // size)
    return min(coord * per, n), min((coord + 1) * per, n)


def local_block(x, mesh, spec: tuple) -> torch.Tensor:
    """This rank's block of the global array ``x`` under ``spec`` (one mesh
    axis name or None a dim; ``_span`` parts), a contiguous tensor on the
    mesh's device."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))
    for dim, name in enumerate(spec):
        if name is not None:
            lo, hi = _span(t.shape[dim], *_axis(mesh, name))
            t = t.narrow(dim, lo, hi - lo)
    return t.to(_device(mesh)).contiguous()


def assemble(blocks: list, mesh, spec: tuple) -> np.ndarray:
    """The global array from every rank's block (``blocks[rank]``, numpy or
    tensors), under ``spec``: blocks concatenated along the dims their axes
    shard, one block taken along the axes they are replicated over."""
    grid = mesh.mesh.cpu().numpy()
    names = mesh.mesh_dim_names

    def build(coord: tuple) -> np.ndarray:
        d = len(coord)
        if d == len(names):
            b = blocks[int(grid[coord])]
            return b.cpu().numpy() if isinstance(b, torch.Tensor) else b
        if names[d] not in spec:
            return build(coord + (0,))
        return np.concatenate([build(coord + (i,))
                               for i in range(grid.shape[d])],
                              axis=spec.index(names[d]))
    return build(())


def gather_blocks(block, mesh, spec: tuple) -> np.ndarray:
    """``assemble`` of every rank's ``block``, on every rank (one
    ``all_gather_object`` over the mesh's ranks)."""
    out = [None] * dist.get_world_size()
    local = block.cpu().numpy() if isinstance(block, torch.Tensor) else block
    dist.all_gather_object(out, local)
    return assemble(out, mesh, spec)


def _device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _on(mesh, x) -> torch.Tensor:
    """``x`` (a tensor or numpy block) as a contiguous uint8 tensor on the
    mesh's device; a tensor already there is used as it is."""
    if isinstance(x, torch.Tensor):
        return x.to(_device(mesh), torch.uint8).contiguous()
    return torch.from_numpy(np.ascontiguousarray(x, np.uint8)).to(
        _device(mesh))


def _all_gather(x: torch.Tensor, mesh, name: str, dim: int) -> torch.Tensor:
    """``jax.lax.all_gather(x, name, axis=dim, tiled=True)``: the blocks of
    axis ``name``'s ranks concatenated along ``dim`` in coordinate order."""
    _, size = _axis(mesh, name)
    if size == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x, group=mesh.get_group(name))
    return torch.cat(parts, dim=dim)


def _apply_gathered(mesh, matrix: np.ndarray,
                    x) -> tuple[torch.Tensor, torch.Tensor]:
    """(this rank's rows of matrix x chunks, the gathered chunks)."""
    gathered = _all_gather(_on(mesh, x), mesh, "shard", 1)
    lo, hi = _span(matrix.shape[0], *_axis(mesh, "shard"))
    rows = np.ascontiguousarray(matrix[lo:hi], np.uint8)
    if hi == lo:
        b, _, lane = gathered.shape
        return gathered.new_empty((b, 0, lane)), gathered
    return gf_matmul_batch_device(rows, gathered), gathered


def _sharded_gf_apply(mesh, matrix: np.ndarray, x) -> torch.Tensor:
    """A GF(2^8) matrix applied to (B_loc, k_loc, L) chunks scattered over
    'shard' (``SPECS["chunks"]``): the chunks all_gathered over 'shard',
    then this rank's slice of the output rows computed on the (B_loc, k, L)
    block.  The reference pads the rows to r_pad = ceil(r / n_shard) a rank
    with zero rows; here those are neither computed nor returned, so a
    rank's block holds its ``_span`` of the r rows and the blocks
    reassemble on the shard axis to the reference's ``out[:, :r]``."""
    return _apply_gathered(mesh, matrix, x)[0]


def sharded_encode(mesh, encode_matrix: np.ndarray, k: int,
                   data) -> torch.Tensor:
    """(B, k, L) -> (B, m, L), both ``SPECS["chunks"]``: B over 'stripe',
    k over 'shard'.  Requires B % stripe == 0 and k % shard == 0."""
    return _sharded_gf_apply(mesh, encode_matrix[k:], data)


def _gather_rows(block: torch.Tensor, mesh, r: int) -> torch.Tensor:
    """Every shard rank's rows (its ``_span`` of r) concatenated: one
    broadcast from each shard rank, each of its own row count."""
    coord, size = _axis(mesh, "shard")
    if size == 1:
        return block
    group = mesh.get_group("shard")
    ranks = dist.get_process_group_ranks(group)
    parts = []
    for i in range(size):
        lo, hi = _span(r, i, size)
        n = hi - lo
        part = block if i == coord else block.new_empty(
            (block.shape[0], n, block.shape[2]))
        if n:
            dist.broadcast(part, src=ranks[i], group=group)
        parts.append(part)
    return torch.cat(parts, dim=1)


def sharded_ec_step(mesh, encode_matrix: np.ndarray,
                    decode_matrix: np.ndarray, decode_index: list[int],
                    erasures: list[int], k: int, data):
    """One EC pipeline step: encode -> degrade -> recover.

    Returns (parity, recovered, checksum): parity ``SPECS["chunks"]``,
    recovered ``SPECS["stripes"]`` (every shard rank of a stripe slice
    holds it), checksum ``SPECS["checksum"]``: a (1,) int64 on every rank
    holding the reference's ``psum`` over 'stripe' of the uint32 sum of the
    recovered bytes, mod 2^32 as that sum wraps (the commit-ack reduction,
    ECCommon.cc:789).  The survivors are taken from the stripe slice's data
    (gathered by the encode) and parity (one broadcast a shard rank) by
    index, without building the full chunk set.
    """
    m = encode_matrix.shape[0] - k
    parity, data_all = _apply_gathered(mesh, encode_matrix[k:], data)
    parity_all = _gather_rows(parity, mesh, m)
    survivors = torch.stack([data_all[:, i] if i < k else
                             parity_all[:, i - k] for i in decode_index],
                            dim=1)
    recovered = gf_matmul_batch_device(
        np.ascontiguousarray(decode_matrix, np.uint8), survivors)
    del survivors
    csum = (recovered.sum(dtype=torch.int64) & 0xFFFFFFFF).reshape(1)
    coord, size = _axis(mesh, "stripe")
    if size > 1:
        dist.all_reduce(csum, group=mesh.get_group("stripe"))
    return parity, recovered, csum & 0xFFFFFFFF


def sharded_rmw(mesh, encode_matrix: np.ndarray, k: int, old_parity,
                delta) -> torch.Tensor:
    """Partial-stripe read-modify-write (ECCommon.cc:704-789): GF(2^8)
    codes are linear, so new parity = old parity XOR encode(delta), the
    delta (B, k, L) zero outside the written range and encoded over the
    same mesh as a full stripe.  Both blocks ``SPECS["chunks"]``.  The XOR
    is in place: a tensor ``old_parity`` on the mesh's device is updated and
    returned (a numpy block is copied first)."""
    pdelta = _sharded_gf_apply(mesh, encode_matrix[k:], delta)
    return _on(mesh, old_parity).bitwise_xor_(pdelta)


def sharded_cross_recovery(mesh, decode_matrix: np.ndarray,
                           survivors) -> torch.Tensor:
    """Rebuild erased shards from survivors scattered over 'shard'
    (``SPECS["chunks"]``, k divisible by the shard axis): an all_gather
    over 'shard' (the recovery reads' fan-in), then this rank's rows of the
    decode."""
    return _sharded_gf_apply(mesh, decode_matrix, survivors)


# -- LRC over mesh sub-axes -----------------------------------------------------
#
# Each local group lives on one slice of the 'group' axis: the global parity
# needs all k data chunks once (all_gather over 'group'); the local parity
# and single-shard repair stay inside the group's ranks with no collective.


def lrc_sharded_encode(mesh, k: int, m: int, l: int, data) -> torch.Tensor:
    """LRC k/m/l encode over a (stripe, group) mesh.  ``data`` is this
    rank's (B_loc, g_loc, kg, L) block of the group-major (B, n_groups, kg,
    L) data (``SPECS["groups"]``; g_loc is 1 when the group axis has a rank
    a group, as in the reference); returns its (B_loc, g_loc, kg+mg+1, L)
    block of the group-major chunks (data, global parity rows, local
    parity), byte-identical to the host ``lrc`` plugin's encode."""
    lgc = (k + m) // l
    kg, mg = k // lgc, m // lgc
    x = _on(mesh, data)
    b, g_loc, _, lane = x.shape
    gidx, _ = _axis(mesh, "group")
    gathered = _all_gather(x, mesh, "group", 1).reshape(b, k, lane)
    # the global parity rows of this rank's groups
    first = gidx * g_loc * mg
    rows = gen_rs_matrix(k + m, k)[k:][first:first + g_loc * mg]
    gp = gf_matmul_batch_device(np.ascontiguousarray(rows), gathered)
    lchunks = torch.cat([x, gp.reshape(b, g_loc, mg, lane)], dim=2)
    # the local parity of each group over its l chunks, no collective
    lp = gf_matmul_batch_device(gen_rs_matrix(l + 1, l)[l:],
                                lchunks.reshape(b * g_loc, l, lane))
    return torch.cat([lchunks, lp.reshape(b, g_loc, 1, lane)], dim=2)


def lrc_sharded_local_repair(mesh, k: int, m: int, l: int,
                             lost_local_pos: int, chunks) -> torch.Tensor:
    """Repair one lost chunk a group (the same local position in every
    group) from the group's surviving l chunks, with no collective.
    ``chunks``: this rank's (B_loc, g_loc, l+1, L) block of
    ``lrc_sharded_encode``'s output; returns its (B_loc, g_loc, 1, L)
    block."""
    dec, idx = build_decode_matrix(gen_rs_matrix(l + 1, l), l,
                                   [lost_local_pos])
    x = _on(mesh, chunks)
    b, g_loc, _, lane = x.shape
    srcs = x[:, :, idx].reshape(b * g_loc, l, lane)
    return gf_matmul_batch_device(dec, srcs).reshape(b, g_loc, 1, lane)
