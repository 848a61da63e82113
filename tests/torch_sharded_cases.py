"""The port's side of ``test_torch_sharded_ec.py``: the seeded inputs and
the function each gloo rank runs.  Kept apart from the test module so that a
spawned rank imports the port alone, not JAX and the reference."""

import numpy as np

RANK_TIMEOUT = 120
K, M = 8, 3
LK, LM, LL = 12, 4, 4
LGC = (LK + LM) // LL
# a step whose recovered bytes (8 x 2,359,296 of values in [240, 256)) sum
# past 2^32: RS k=1,m=1, erasure [0], over (stripe, 1)
WRAP = (8, 9 << 18)


def inputs() -> dict:
    """Every case's global input, from numpy seeds (test_parallel.py's)."""
    rng = np.random.default_rng
    rmw = rng(7).integers(0, 256, size=(8, K, 64)).astype(np.uint8)
    piece = rng(8).integers(0, 256, size=(8, 24)).astype(np.uint8)
    delta = np.zeros_like(rmw)
    delta[:, 5, 8:32] = rmw[:, 5, 8:32] ^ piece
    return {
        "encode": rng(0).integers(0, 256, size=(16, K, 256)).astype(np.uint8),
        "step": rng(1).integers(0, 256, size=(8, K, 128)).astype(np.uint8),
        "lrc": rng(3).integers(0, 256, size=(4, LK, 128)).astype(np.uint8),
        "rmw": rmw, "piece": piece, "delta": delta,
        "wrap": rng(9).integers(240, 256, size=(WRAP[0], 1, WRAP[1]),
                                dtype=np.uint8),
    }


def port_cases(rank: int, n: int, device, lrc_groups: int) -> dict:
    """One rank of the port: every case on this world's meshes; the global
    results (``gather_blocks``) from rank 0."""
    from ceph_tpu_torch.gf import build_decode_matrix as dm
    from ceph_tpu_torch.gf import gen_rs_matrix as gen_rs
    from ceph_tpu_torch.parallel import sharded_ec as se

    chunks, stripes, groups = (se.SPECS[s] for s in ("chunks", "stripes",
                                                     "groups"))
    x = inputs()
    out = {}
    mesh = se.make_mesh(n, shard_axis=2, device=device)
    out["mesh"] = se.mesh_shape(mesh)
    out["mesh shard 3"] = se.mesh_shape(se.make_mesh(n, shard_axis=3,
                                                     device=device))
    gen = gen_rs(K + M, K)
    out["encode"] = se.gather_blocks(se.sharded_encode(
        mesh, gen, K, se.local_block(x["encode"], mesh, chunks)),
        mesh, chunks)
    dec, idx = dm(gen, K, [1, 9])
    parity, rec, csum = se.sharded_ec_step(
        mesh, gen, dec, idx, [1, 9], K, se.local_block(x["step"], mesh,
                                                       chunks))
    out["step"] = (se.gather_blocks(parity, mesh, chunks),
                   se.gather_blocks(rec, mesh, stripes),
                   se.gather_blocks(csum, mesh, se.SPECS["checksum"]))
    lmesh = se.lrc_make_mesh(n, lrc_groups, device=device)
    gm = x["lrc"].reshape(4, LGC, LK // LGC, 128)
    full = se.lrc_sharded_encode(lmesh, LK, LM, LL,
                                 se.local_block(gm, lmesh, groups))
    out["lrc encode"] = se.gather_blocks(full, lmesh, groups)
    for lost in (0, LK // LGC, LL):
        out[f"lrc repair {lost}"] = se.gather_blocks(
            se.lrc_sharded_local_repair(lmesh, LK, LM, LL, lost, full),
            lmesh, groups)
    old = se.sharded_encode(mesh, gen, K, se.local_block(x["rmw"], mesh,
                                                         chunks))
    new = se.sharded_rmw(mesh, gen, K, old,
                         se.local_block(x["delta"], mesh, chunks))
    out["rmw in place"] = new is old
    out["rmw"] = se.gather_blocks(new, mesh, chunks)
    newdata = x["rmw"].copy()
    newdata[:, 5, 8:32] = x["piece"]
    fullset = np.concatenate([newdata, out["rmw"]], axis=1)
    dec2, idx2 = dm(gen, K, [0, 10])
    out["cross recovery"] = se.gather_blocks(se.sharded_cross_recovery(
        mesh, dec2, se.local_block(fullset[:, idx2], mesh, chunks)),
        mesh, chunks)
    wmesh = se.make_mesh(n, shard_axis=1, device=device)
    gen1 = gen_rs(2, 1)
    dec1, idx1 = dm(gen1, 1, [0])
    _, _, wsum = se.sharded_ec_step(wmesh, gen1, dec1, idx1, [0], 1,
                                    se.local_block(x["wrap"], wmesh, chunks))
    out["wrap"] = se.gather_blocks(wsum, wmesh, se.SPECS["checksum"])
    return out if rank == 0 else None


def three_ranks(rank: int, n: int, device) -> dict:
    """The dry run's checks on three ranks; the mesh it ran on."""
    from ceph_tpu_torch.graft_entry import dryrun_rank
    return dryrun_rank(rank, n, device)["mesh"]
