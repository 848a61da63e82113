"""The port's sharded codec (``ceph_tpu_torch.parallel.sharded_ec``) against
``ceph_tpu.parallel`` on the CPU.

The same numpy-seeded inputs go through the reference on the conftest's
8-device CPU mesh and through the port on gloo ranks: 8 (a (4, 2) stripe x
shard mesh, a (2, 4) stripe x group mesh), 1 (every axis 1; the LRC groups
all on the one rank) and 3 (the shard-axis fallback: shard 1).  Each rank
computes its block; the blocks are put back together with ``assemble`` and
must equal the reference's global arrays byte for byte: the mesh shapes,
the encode, the step (parity, recovered shards, checksum), LRC encode
(also against the host ``lrc`` plugin) and local repair, RMW and cross
recovery, and a step whose checksum passes 2^32 and wraps.  The ranks are
spawned once a world size (``graft_entry.spawn_ranks``, one thread each)
and joined with a timeout that fails the test instead of hanging it.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ceph_tpu.ec import ErasureCodePluginRegistry
from ceph_tpu.gf import build_decode_matrix, gen_rs_matrix, gf_matmul
from ceph_tpu.parallel import (lrc_make_mesh, lrc_sharded_encode,
                               lrc_sharded_local_repair, make_mesh,
                               sharded_cross_recovery, sharded_ec_step,
                               sharded_encode, sharded_rmw)
from ceph_tpu_torch.graft_entry import spawn_ranks
from torch_sharded_cases import (K, LGC, LK, LL, LM, M, RANK_TIMEOUT,
                                 inputs, port_cases, three_ranks)


def run_port(n: int, lrc_groups: int) -> dict:
    return spawn_ranks(port_cases, n, "cpu", "gloo", args=(lrc_groups,),
                       timeout=RANK_TIMEOUT)[0]


@pytest.fixture(scope="module")
def port8():
    return run_port(8, LGC)


@pytest.fixture(scope="module")
def port1():
    return run_port(1, 1)


@pytest.fixture(scope="module", params=[8, 1], ids=["8 ranks", "1 rank"])
def port(request, port8, port1):
    return port8 if request.param == 8 else port1


@pytest.fixture(scope="module")
def ref() -> dict:
    """The reference's global results on the 8-device CPU mesh."""
    x = inputs()
    mesh = make_mesh(8, shard_axis=2)
    gen = gen_rs_matrix(K + M, K)
    out = {"encode": np.asarray(sharded_encode(mesh, gen, K,
                                               jnp.asarray(x["encode"])))}
    dec, idx = build_decode_matrix(gen, K, [1, 9])
    out["step"] = tuple(np.asarray(a) for a in jax.jit(
        lambda d: sharded_ec_step(mesh, gen, dec, idx, [1, 9], K, d))(
            jnp.asarray(x["step"])))
    lmesh = lrc_make_mesh(8, LGC)
    gm = jnp.asarray(x["lrc"].reshape(4, LGC, LK // LGC, 128))
    full = lrc_sharded_encode(lmesh, LK, LM, LL, gm)
    out["lrc encode"] = np.asarray(full)
    for lost in (0, LK // LGC, LL):
        out[f"lrc repair {lost}"] = np.asarray(
            lrc_sharded_local_repair(lmesh, LK, LM, LL, lost, full))
    old = sharded_encode(mesh, gen, K, jnp.asarray(x["rmw"]))
    out["rmw"] = np.asarray(sharded_rmw(mesh, gen, K, old,
                                        jnp.asarray(x["delta"])))
    newdata = x["rmw"].copy()
    newdata[:, 5, 8:32] = x["piece"]
    fullset = np.concatenate([newdata, out["rmw"]], axis=1)
    dec2, idx2 = build_decode_matrix(gen, K, [0, 10])
    out["cross recovery"] = np.asarray(sharded_cross_recovery(
        mesh, dec2, jnp.asarray(fullset[:, idx2])))
    wmesh = make_mesh(8, shard_axis=1)
    gen1 = gen_rs_matrix(2, 1)
    dec1, idx1 = build_decode_matrix(gen1, 1, [0])
    out["wrap"] = np.asarray(jax.jit(
        lambda d: sharded_ec_step(wmesh, gen1, dec1, idx1, [0], 1, d))(
            jnp.asarray(x["wrap"]))[2])
    return out


def test_mesh_shapes(port8, port1):
    """make_mesh over 8 ranks is (4, 2) as the reference's; the shard axis
    falls back to 1 where it does not divide n."""
    ref = make_mesh(8, shard_axis=2)
    assert port8["mesh"] == dict(ref.shape) == {"stripe": 4, "shard": 2}
    assert port8["mesh shard 3"] == dict(make_mesh(8, shard_axis=3).shape)
    assert port1["mesh"] == port1["mesh shard 3"] == {"stripe": 1,
                                                      "shard": 1}


def test_shard_axis_falls_back_on_three_ranks():
    """n=3: shard 1, as the reference's make_mesh(3); the dry run's checks
    pass on that mesh."""
    got = spawn_ranks(three_ranks, 3, "cpu", "gloo", timeout=RANK_TIMEOUT)[0]
    assert got == dict(make_mesh(3).shape) == {"stripe": 3, "shard": 1}


def test_encode(port, ref):
    np.testing.assert_array_equal(port["encode"], ref["encode"])
    data = inputs()["encode"]
    for b in range(0, 16, 5):
        assert np.array_equal(port["encode"][b], gf_matmul(
            gen_rs_matrix(K + M, K)[K:], data[b]))


def test_step_and_checksum(port, ref):
    """Parity, the recovered shards and the psum'd checksum, one a stripe
    slice, equal the reference's."""
    parity, rec, csum = port["step"]
    np.testing.assert_array_equal(parity, ref["step"][0])
    np.testing.assert_array_equal(rec, ref["step"][1])
    ref_csum = ref["step"][2].astype(np.int64)
    assert (ref_csum == ref_csum[0]).all()
    assert (csum == ref_csum[0]).all() and len(csum) == port["mesh"]["stripe"]


def test_checksum_wraps_past_2_32(port, ref):
    """The recovered bytes sum past 2^32; the port's int64 sum reduced mod
    2^32 equals the reference's wrapping uint32 psum."""
    total = int(inputs()["wrap"].astype(np.int64).sum())
    assert total >= 1 << 32
    assert (ref["wrap"].astype(np.int64) == total % (1 << 32)).all()
    assert (port["wrap"] == total % (1 << 32)).all()


def test_lrc_encode_matches_reference_and_host_plugin(port, ref):
    np.testing.assert_array_equal(port["lrc encode"], ref["lrc encode"])
    codec = ErasureCodePluginRegistry().factory(
        "lrc", {"k": str(LK), "m": str(LM), "l": str(LL)})
    data = inputs()["lrc"]
    for b in range(4):
        got = codec.encode(set(range(codec.get_chunk_count())),
                           data[b].reshape(-1).tobytes())
        want = np.stack([np.stack([got[g * (LL + 1) + i]
                                   for i in range(LL + 1)])
                         for g in range(LGC)])
        np.testing.assert_array_equal(port["lrc encode"][b], want)


@pytest.mark.parametrize("lost", [0, LK // LGC, LL],
                         ids=["data", "global parity", "local parity"])
def test_lrc_local_repair(port, ref, lost):
    got = port[f"lrc repair {lost}"]
    np.testing.assert_array_equal(got, ref[f"lrc repair {lost}"])
    np.testing.assert_array_equal(got[:, :, 0],
                                  port["lrc encode"][:, :, lost])


def test_rmw_in_place_and_cross_recovery(port, ref):
    """RMW updates the caller's old-parity tensor in place and equals a
    re-encode of the new data; cross recovery rebuilds erasures [0, 10]."""
    assert port["rmw in place"]
    np.testing.assert_array_equal(port["rmw"], ref["rmw"])
    x = inputs()
    newdata = x["rmw"].copy()
    newdata[:, 5, 8:32] = x["piece"]
    gen = gen_rs_matrix(K + M, K)
    want = np.stack([gf_matmul(gen[K:], newdata[i]) for i in range(8)])
    np.testing.assert_array_equal(port["rmw"], want)
    np.testing.assert_array_equal(port["cross recovery"],
                                  ref["cross recovery"])
    full = np.concatenate([newdata, want], axis=1)
    np.testing.assert_array_equal(port["cross recovery"][:, 0], full[:, 0])
    np.testing.assert_array_equal(port["cross recovery"][:, 1], full[:, 10])
