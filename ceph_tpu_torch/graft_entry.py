"""Entry points of the port: a one-card encode and the multi-rank dry run.

Counterparts of the repository root's ``__graft_entry__.py`` (which stays the
JAX package's):

* ``entry(device="cuda")`` returns ``(fn, (example,))``: the RS k=8,m=3
  parity encode of an (8, 8192) uint8 tensor on the card through
  ``ops.gf2kernels.gf_matmul_device`` (K1/K2/K3), its example from
  ``np.random.default_rng(0)`` as the reference's;
* ``dryrun_multichip(n, device="cuda")`` starts n ranks (``spawn_ranks``:
  ``torch.multiprocessing`` spawn, a ``FileStore`` in a temporary directory,
  no network port) and runs the reference's four checks with its sizes,
  seeds and messages (``dryrun_rank``): the sharded RS step with erasures
  [1, 9], LRC k=12,m=4,l=4 over a (stripe, group) mesh when 4 divides n, a
  48 B partial-stripe write at offset 40 on shard 2, and cross recovery.
  With ``device="cpu"`` it rehearses on gloo, as the reference rehearses on
  a virtual CPU mesh; with the card it takes NCCL, a card a rank, and raises
  when n exceeds the cards.

    python -c "import ceph_tpu_torch.graft_entry as g; g.dryrun_multichip(8, device='cpu')"

BASELINE.md's config 4 names LRC l=3, but the (stripe, group) mesh needs
(k+m)/l groups, and 16/3 is not whole: the dry run follows the reference's
l=4.
"""

from __future__ import annotations

import os
import queue
import tempfile
import time
import traceback

import numpy as np
import torch

from .device import resolve_device


def entry(device="cuda"):
    """(fn, example_args): the one-card RS k=8,m=3 parity encode."""
    from .gf import gen_rs_matrix
    from .ops.gf2kernels import gf_matmul_device

    dev = resolve_device(device)
    k, m = 8, 3
    parity = np.ascontiguousarray(gen_rs_matrix(k + m, k)[k:])

    def encode_step(data_u8: torch.Tensor) -> torch.Tensor:
        return gf_matmul_device(parity, data_u8, out_np=False)

    rng = np.random.default_rng(0)
    example = torch.from_numpy(
        rng.integers(0, 256, size=(k, 8192), dtype=np.uint8)).to(dev)
    return encode_step, (example,)


def _rank_main(rank: int, n: int, store_path: str, backend: str,
               device_type: str, fn, args: tuple, results) -> None:
    """One rank: join the process group, run ``fn``, report its result."""
    import torch.distributed as dist
    try:
        if device_type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
            device = torch.device("cuda", torch.cuda.current_device())
        else:
            torch.set_num_threads(1)
            device = torch.device("cpu")
        dist.init_process_group(backend, store=dist.FileStore(store_path, n),
                                rank=rank, world_size=n)
        try:
            out = fn(rank, n, device, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn_ranks(fn, n: int, device_type: str, backend: str,
                args: tuple = (), timeout: float = 300.0) -> list:
    """Run ``fn(rank, n, device, *args)`` in n spawned processes joined into
    one process group over ``backend`` (a ``FileStore`` in a temporary
    directory); a rank on the card takes card ``rank % device_count``.
    Returns each rank's result in rank order.  A rank that fails, or a run
    past ``timeout`` seconds, raises RuntimeError; every process is ended
    before this returns."""
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_rank_main, daemon=True, args=(
            r, n, os.path.join(tmp, "store"), backend, device_type, fn,
            args, results)) for r in range(n)]
        for p in procs:
            p.start()
        got: dict[int, object] = {}
        deadline = time.monotonic() + timeout
        try:
            while len(got) < n:
                try:
                    rank, ok, out = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [p.exitcode for p in procs
                            if p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"a rank exited with {dead[0]} "
                                           f"before reporting")
                    if time.monotonic() > deadline:
                        raise RuntimeError(f"{n} ranks did not finish in "
                                           f"{timeout:.0f} s")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{out}")
                got[rank] = out
            for p in procs:
                p.join(max(1.0, deadline - time.monotonic()))
                if p.exitcode != 0:
                    raise RuntimeError(f"a rank exited with {p.exitcode}")
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(10)
    return [got[r] for r in range(n)]


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """The sharded EC step, LRC, RMW and cross recovery over n ranks, each
    checked byte for byte against the host codec; rank 0 prints the
    reference's "ok" lines."""
    dev = resolve_device(device)
    if dev.type == "cuda" and n_devices > torch.cuda.device_count():
        raise RuntimeError(f"dryrun_multichip({n_devices}) needs a card a "
                           f"rank; {torch.cuda.device_count()} visible")
    from .parallel.sharded_ec import backend_for
    spawn_ranks(dryrun_rank, n_devices, dev.type, backend_for(dev))


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"dryrun_multichip: {what}")


def dryrun_rank(rank: int, n: int, device: torch.device) -> dict:
    """One rank of ``dryrun_multichip``: the reference's four checks (its
    sizes, ``default_rng(0)`` draws in its order, its messages, printed by
    rank 0); a failed check raises.  Returns the rank's kernel launches,
    the checksum and the meshes' shapes."""
    from .gf import build_decode_matrix, gen_rs_matrix, gf_matmul
    from .ops import gf2kernels
    from .parallel import sharded_ec as se

    chunks, stripes, groups = (se.SPECS[s] for s in ("chunks", "stripes",
                                                     "groups"))
    say = print if rank == 0 else (lambda *a, **kw: None)
    for name in gf2kernels.LAUNCHES:
        gf2kernels.LAUNCHES[name] = 0
    k, m = 8, 3
    gen = gen_rs_matrix(k + m, k)
    erasures = [1, 9]
    dec, idx = build_decode_matrix(gen, k, erasures)
    mesh = se.make_mesh(n, shard_axis=2 if n % 2 == 0 else 1, device=device)
    shape = se.mesh_shape(mesh)
    b = shape["stripe"] * 2
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, size=(b, k, 128)).astype(np.uint8)
    parity, recovered, csum = se.sharded_ec_step(
        mesh, gen, dec, idx, erasures, k, se.local_block(data, mesh, chunks))
    parity_g = se.gather_blocks(parity, mesh, chunks)
    recovered_g = se.gather_blocks(recovered, mesh, stripes)
    full = np.concatenate(
        [data, np.stack([gf_matmul(gen[k:], data[i]) for i in range(b)])],
        axis=1)
    for p, e in enumerate(erasures):
        _check(np.array_equal(recovered_g[:, p], full[:, e]),
               f"recovered shard {e} differs")
    _check(np.array_equal(parity_g, full[:, k:]), "parity differs")
    want_csum = int(full[:, erasures].astype(np.int64).sum()) & 0xFFFFFFFF
    _check(int(csum) == want_csum, f"checksum {int(csum)} != {want_csum}")
    say(f"dryrun_multichip ok: mesh={shape} batch={b} recovered erasures "
        f"{erasures} byte-exact")

    # LRC over mesh sub-axes (BASELINE config 4's code at l=4, see above)
    lk, lm, ll_ = 12, 4, 4
    lgc = (lk + lm) // ll_
    lrc_shape = None
    if n % lgc == 0:
        lmesh = se.lrc_make_mesh(n, lgc, device)
        lrc_shape = se.mesh_shape(lmesh)
        lb = lrc_shape["stripe"] * 2
        ldata = rng.integers(0, 256, size=(lb, lgc, lk // lgc, 128)) \
                   .astype(np.uint8)
        lchunks = se.lrc_sharded_encode(lmesh, lk, lm, ll_,
                                        se.local_block(ldata, lmesh, groups))
        rec = se.lrc_sharded_local_repair(lmesh, lk, lm, ll_, 0, lchunks)
        _check(np.array_equal(
            se.gather_blocks(rec, lmesh, groups)[:, :, 0],
            se.gather_blocks(lchunks, lmesh, groups)[:, :, 0]),
            "LRC local repair differs")
        say(f"dryrun_multichip lrc ok: mesh={lrc_shape} k={lk} m={lm} "
            f"l={ll_}; local repair collective-free")

    # sharded RMW: new parity = old parity ^ encode(delta)
    off, ln, tgt = 40, 48, 2
    piece = rng.integers(0, 256, size=(b, ln)).astype(np.uint8)
    delta = np.zeros_like(data)
    delta[:, tgt, off:off + ln] = data[:, tgt, off:off + ln] ^ piece
    new_parity = se.gather_blocks(se.sharded_rmw(
        mesh, gen, k, parity, se.local_block(delta, mesh, chunks)),
        mesh, chunks)
    newdata = data.copy()
    newdata[:, tgt, off:off + ln] = piece
    want_parity = np.stack(
        [gf_matmul(gen[k:], newdata[i]) for i in range(b)])
    _check(np.array_equal(new_parity, want_parity), "RMW parity differs")
    say(f"dryrun_multichip rmw ok: {ln}B partial-stripe write on "
        f"shard {tgt}, delta-encoded parity byte-exact")

    # cross-shard recovery: survivors scattered over 'shard'
    newfull = np.concatenate([newdata, want_parity], axis=1)
    rec2 = se.gather_blocks(se.sharded_cross_recovery(
        mesh, dec, se.local_block(newfull[:, idx, :], mesh, chunks)),
        mesh, chunks)
    for p_i, e in enumerate(erasures):
        _check(np.array_equal(rec2[:, p_i], newfull[:, e]),
               f"cross-recovered shard {e} differs")
    say(f"dryrun_multichip cross-recovery ok: erasures {erasures} "
        f"rebuilt from shard-axis-scattered survivors byte-exact")
    return {"launches": dict(gf2kernels.LAUNCHES), "checksum": int(csum),
            "mesh": shape, "lrc_mesh": lrc_shape}
