"""The dense kernels' shape rules take every shape the reference's dense
ladder takes.

``ceph_tpu``'s dense ladder ends in an XLA program that takes any k and any
batch.  K1 (``gf2_matmul_popc``) contracts any k in one launch, splits more
than ``POPC_MAX_ROWS`` output rows into row tiles and a batch of more than
65535 stripes into launches of at most that many; K2 (``gf2_matmul_mma``) folds
its batch into grid.x.  The rules are pure functions, asked before the CPU/CUDA split, so they are
checked here without a card.
"""

import itertools

import numpy as np
import pytest
import torch

from ceph_tpu_torch.ec.plugins.pmsr import ErasureCodePmsr
from ceph_tpu_torch.ops import gf2kernels as gk

torch.set_num_threads(1)


def _pmsr7_launch_shapes(b=1024, chunk=131136):
    """(B, k, r, L) of the PMSR k=7,m=6 flat launches: encode and a
    2-erasure decode."""
    codec = ErasureCodePmsr(device="cpu")
    codec.init({"k": "7", "m": "6"})
    a, n = codec.alpha, codec.get_chunk_count()
    src, lost = codec.decode_plan({1, 9}, set(range(n)) - {1, 9})
    rep = codec.repair_matrix(src, lost)
    return [(b, codec.parity_matrix.shape[1], codec.parity_matrix.shape[0],
             chunk // a),
            (b, rep.shape[1], rep.shape[0], chunk // a)]


SHAPES = (
    [(b, k, 3, l) for k, b, l in itertools.product(
        (33, 42, 72), (1, 65536, 140000), (128, 1001, 131072))]
    + [(b, 8, 3, 128) for b in (65535, 65536, 70000, 140000)]
    + _pmsr7_launch_shapes())


@pytest.mark.parametrize("b,k,r,l", SHAPES)
def test_dense_route_accepts_every_shape(b, k, r, l):
    assert gk.popc_accepts(b, k, r, l)
    name, g = gk.dense_kernel_for(b, k, r, l)
    if name == "gf2_matmul_mma":
        assert gk.mma_accepts(b, k, r, g, l)
        assert b % g == 0 and 8 * g * k <= 128
    else:
        assert name == "gf2_matmul_popc" and g == 1
    # every output row is in exactly one K1 row tile, over all k chunks
    cover = np.zeros(r, np.int64)
    for i0, rg in gk.popc_plan(r):
        assert 1 <= rg <= gk.POPC_MAX_ROWS
        cover[i0:i0 + rg] += 1
    assert (cover == 1).all()


def test_k2_takes_batches_past_the_old_grid_limit():
    assert gk.mma_accepts(140000, 8, 3, 2, 128)
    assert gk.dense_kernel_for(140000, 8, 3, 128) == ("gf2_matmul_mma", 2)
    assert gk.dense_kernel_for(70001, 8, 3, 128) == ("gf2_matmul_mma", 1)
    # what K2 cannot take goes to K1 rather than raising
    assert gk.dense_kernel_for(8, 8, 3, 128, aligned=False)[0] == \
        "gf2_matmul_popc"
    assert gk.dense_kernel_for(4, 17, 3, 128)[0] == "gf2_matmul_popc"
    assert not gk.mma_accepts(3, 8, 3, 2, 128)
    assert not gk.mma_accepts(4, 8, 3, 2, 100)


def test_popc_plan_splits_rows_and_chunks():
    # chunks are not split: every k-step is a loop inside one launch
    assert gk.popc_plan(3) == [(0, 3)]
    assert gk.popc_plan(36) == [(0, 36)]          # PMSR k=7,m=6: one launch
    assert gk.popc_plan(600) == [(0, 256), (256, 256), (512, 88)]


@pytest.mark.parametrize("b", [1, 65535, 65536, 140000])
def test_popc_stripes_cover_the_batch_in_grid_sized_ranges(b):
    ranges = gk.popc_stripes(b)
    assert len(ranges) == -(-b // gk.POPC_MAX_STRIPES)
    assert all(1 <= nb <= gk.POPC_MAX_STRIPES for _, nb in ranges)
    assert [b0 for b0, _ in ranges] == list(
        np.cumsum([0] + [nb for _, nb in ranges])[:-1])
    assert sum(nb for _, nb in ranges) == b


def test_wide_products_on_the_plain_versions_match_the_oracle(monkeypatch):
    from ceph_tpu.gf import gf_matmul
    monkeypatch.setenv("CEPH_TPU_XOR_SCHED", "0")      # the dense route
    rng = np.random.default_rng(0)
    for k, r in ((33, 2), (42, 36), (72, 3)):
        mat = rng.integers(0, 256, (r, k), dtype=np.uint8)
        x = rng.integers(0, 256, (3, k, 40), dtype=np.uint8)
        got = gk.gf_matmul_batch_device(mat, torch.from_numpy(x))
        want = np.stack([gf_matmul(mat, x[i]) for i in range(3)])
        assert np.array_equal(got.numpy(), want)

