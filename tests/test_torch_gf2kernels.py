"""The port's GF(2^8) math and GF(2) bit-matmul layer held against ceph_tpu.

Same seeded numpy inputs through both packages; every comparison is exact
(byte-identical parity).  The CUDA kernels themselves run only on the card
(chip_smoke.py); here the wrappers take their plain PyTorch versions because
the tensors lie on the CPU, and the JAX side runs its Pallas kernels in
interpret mode.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ceph_tpu.gf as ref_gf
import ceph_tpu.ops.gf2kernels as ref_k
import ceph_tpu_torch.gf as gf
import ceph_tpu_torch.ops.gf2kernels as gk


# one intra-op thread: the suite runs in several worker processes at once,
# some of which time CPU work
torch.set_num_threads(1)

def _data(seed, *shape):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


# -- GF(2^8) host math ------------------------------------------------------

def test_gf_tables_match_reference():
    for name in ("GF_EXP", "GF_LOG", "GF_INV"):
        assert np.array_equal(getattr(gf, name), getattr(ref_gf, name)), name
    assert gf.GF_POLY == ref_gf.GF_POLY
    assert np.array_equal(gf.GF_MUL_TABLE, ref_gf.gf8.GF_MUL_TABLE)
    for a, b in itertools.product(range(0, 256, 7), range(1, 256, 11)):
        assert gf.gf_mul(a, b) == ref_gf.gf_mul(a, b)
        assert gf.gf_div(a, b) == ref_gf.gf_div(a, b)
        assert gf.gf_pow(b, a) == ref_gf.gf_pow(b, a)
    for c in range(256):
        assert np.array_equal(gf.coeff_to_bitmatrix(c),
                              ref_gf.coeff_to_bitmatrix(c)), c
        if c:
            assert gf.gf_inv(c) == ref_gf.gf_inv(c)


def test_gf_matmul_and_inverse_match_reference():
    rng = np.random.default_rng(1)
    mat = rng.integers(0, 256, (5, 7), dtype=np.uint8)
    data = _data(2, 7, 300)
    assert np.array_equal(gf.gf_matmul(mat, data), ref_gf.gf_matmul(mat, data))
    assert np.array_equal(gf.matrix_to_bitmatrix(mat),
                          ref_gf.matrix_to_bitmatrix(mat))
    sq = gf.gen_cauchy1_matrix(12, 6)[3:9]
    assert np.array_equal(gf.gf_invert_matrix(sq), ref_gf.gf_invert_matrix(sq))
    with pytest.raises(ValueError):
        gf.gf_invert_matrix(np.zeros((3, 3), np.uint8))


@pytest.mark.parametrize("k,m", [(2, 1), (4, 2), (8, 3), (10, 4), (12, 4),
                                 (21, 4), (32, 3)])
def test_generator_matrices_match_reference(k, m):
    assert np.array_equal(gf.gen_rs_matrix(k + m, k),
                          ref_gf.gen_rs_matrix(k + m, k))
    assert np.array_equal(gf.gen_cauchy1_matrix(k + m, k),
                          ref_gf.gen_cauchy1_matrix(k + m, k))


@pytest.mark.parametrize("technique", ["reed_sol_van", "cauchy"])
def test_decode_matrices_match_reference_every_pattern(technique):
    """Every 1- and 2-erasure pattern at k=8, m=3."""
    from ceph_tpu.gf.matrices import decode_index_for as ref_index
    k, m = 8, 3
    build = gf.gen_rs_matrix if technique == "reed_sol_van" \
        else gf.gen_cauchy1_matrix
    gen = build(k + m, k)
    patterns = [list(p) for n in (1, 2)
                for p in itertools.combinations(range(k + m), n)]
    assert len(patterns) == 66
    for erasures in patterns:
        mat, index = gf.build_decode_matrix(gen, k, erasures)
        want_mat, want_index = ref_gf.build_decode_matrix(gen, k, erasures)
        assert np.array_equal(mat, want_mat), erasures
        assert index == want_index == ref_index(k, set(erasures))
        assert gf.erasure_signature(index, erasures) == \
            ref_gf.erasure_signature(want_index, erasures)


# -- bit-matrix layouts and shape rules ---------------------------------------

@pytest.mark.parametrize("k,m,b", [(8, 3, 1024), (8, 3, 5), (10, 4, 128),
                                   (4, 2, 8), (5, 3, 6), (16, 2, 4)])
def test_bitmatrix_and_w_gN_match_reference(k, m, b):
    gen = gf.gen_rs_matrix(k + m, k)
    for mat in (gen[k:], gf.build_decode_matrix(gen, k, [0, k])[0]):
        mat = np.ascontiguousarray(mat)
        assert np.array_equal(gk.bitmatrix_i8(mat), ref_k.bitmatrix_i8(mat))
        g = gk.pick_group(k, b)
        assert g == ref_k.pick_group(k, b)
        assert np.array_equal(
            gk.w_gN_planemajor(mat, g),
            ref_k._w_gN_planemajor(mat.tobytes(), mat.shape[0], k, g))


def test_shape_rules_match_reference():
    for l in (1, 96, 127, 128, 512, 1000, 8192, 8320, 16384, 131072):
        assert gk._pick_tile(l) == ref_k._pick_tile(l), l
    for b in range(0, 70):
        assert gk.bucket_batch(b) == ref_k.bucket_batch(b), b
    for k, b in itertools.product(range(1, 34), (1, 2, 3, 4, 6, 8, 1024)):
        assert gk.pick_group(k, b) == ref_k.pick_group(k, b), (k, b)


def test_kernel_weight_layouts_unpack_to_w():
    """The device-side W of each kernel carries exactly the reference W:
    K1's packed 32-bit rows and K2's zero-padded tile-major W_gN."""
    cpu = torch.device("cpu")
    for k, m, g in [(8, 3, 2), (10, 4, 1), (4, 2, 4), (5, 2, 1), (32, 3, 1)]:
        mat = np.ascontiguousarray(gf.gen_cauchy1_matrix(k + m, k)[k:])
        w = ref_k.bitmatrix_i8(mat)
        words = gk._w_popc_device(mat.tobytes(), m, k, cpu).numpy()
        assert words.shape == (8 * m, (k + 3) // 4)
        bits = np.unpackbits(words.view(np.uint8), axis=1, bitorder="little")
        assert np.array_equal(bits[:, :8 * k], w)
        assert not bits[:, 8 * k:].any()
        if 8 * g * k > 128:
            continue
        tiles = gk._w_mma_device(mat.tobytes(), m, k, g, cpu).numpy()
        mt, kt = tiles.shape[:2]
        flat = tiles.transpose(0, 2, 1, 3).reshape(16 * mt, 16 * kt)
        wn = ref_k._w_gN_planemajor(mat.tobytes(), m, k, g)
        assert np.array_equal(flat[:wn.shape[0], :wn.shape[1]], wn)
        assert not flat[wn.shape[0]:].any() and not flat[:, wn.shape[1]:].any()


# -- plain versions against the Pallas kernels (interpret mode) ---------------

def test_plain_matches_pallas_flat_kernel():
    k, m, n, tile = 8, 3, 1024, 512
    mat = gf.gen_rs_matrix(k + m, k)[k:]
    w = ref_k.bitmatrix_i8(mat)
    data = _data(9, k, n)
    fn = ref_k._make_pallas_fn(8 * m, k, n, tile, interpret=True)
    want = np.asarray(fn(jnp.asarray(w), jnp.asarray(data)))
    got = gk.gf2_matmul_plain(torch.from_numpy(w), torch.from_numpy(data)[None])
    assert np.array_equal(got[0].numpy(), want)
    assert np.array_equal(want, gf.gf_matmul(mat, data))


def test_plain_matches_pallas_batch_kernel():
    k, m, b, l, tile = 10, 4, 3, 512, 256
    gen = gf.gen_cauchy1_matrix(k + m, k)
    mat = gf.build_decode_matrix(gen, k, [1, k])[0]
    w = ref_k.bitmatrix_i8(mat)
    data = _data(10, b, k, l)
    fn = ref_k._make_pallas_batch_fn(16, k, b, l, tile, interpret=True)
    want = np.asarray(fn(jnp.asarray(w), jnp.asarray(data)))
    got = gk.gf2_matmul_plain(torch.from_numpy(w), torch.from_numpy(data))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("technique,k,m,b,erasures", [
    ("reed_sol_van", 8, 3, 4, None),
    ("reed_sol_van", 8, 3, 4, [1, 9]),
    ("reed_sol_van", 4, 2, 8, None),
    ("cauchy", 10, 4, 2, [2, 11]),
])
def test_grouped_plain_matches_pallas_gN_kernel(technique, k, m, b, erasures):
    build = gf.gen_rs_matrix if technique == "reed_sol_van" \
        else gf.gen_cauchy1_matrix
    gen = build(k + m, k)
    mat = gen[k:] if erasures is None else \
        gf.build_decode_matrix(gen, k, erasures)[0]
    mat = np.ascontiguousarray(mat)
    r, l = mat.shape[0], 256
    g = gk.pick_group(k, b)
    wn = gk.w_gN_planemajor(mat, g)
    data = _data(11, b, k, l)
    fn = ref_k._make_pallas_batch_fn_gN(8 * r, k, b, l, g, 256, "concat",
                                        "int8", "vpu", interpret=True)
    want = np.asarray(fn(jnp.asarray(wn), jnp.asarray(data)))
    got = gk.gf2_matmul_grouped_plain(torch.from_numpy(wn),
                                      torch.from_numpy(data), g)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(gk.gf2_matmul_mma(mat, torch.from_numpy(data),
                                            g).numpy(), want)


# -- entry points and routing ---------------------------------------------

@pytest.mark.parametrize("k,m,n", [(8, 3, 512), (10, 4, 96), (4, 2, 8192),
                                   (8, 3, 1000)])
def test_gf_matmul_device_matches_reference(k, m, n):
    gen = gf.gen_rs_matrix(k + m, k)
    data = _data(7, k, n)
    want = ref_k.gf_matmul_device(gen[k:], data)
    got = gk.gf_matmul_device(gen[k:], data, device="cpu")
    assert isinstance(got, np.ndarray) and np.array_equal(got, want)


@pytest.mark.parametrize("k,m,b,l,kernel", [
    (8, 3, 16, 256, "gf2_matmul_mma"),      # packed: _pick_tile(256) = 256
    (8, 3, 6, 8192, "gf2_matmul_mma"),
    (8, 3, 5, 1000, "gf2_matmul_popc"),     # ragged L
    (10, 4, 4, 96, "gf2_matmul_popc"),      # L % 128 != 0
    (20, 4, 2, 256, "gf2_matmul_popc"),     # 8*k*g > 128
])
def test_batch_routing_and_parity(monkeypatch, k, m, b, l, kernel):
    # the dense ladder's shape routing: the XOR-schedule cost model, which
    # the CPU heuristic would consult first, is switched off
    monkeypatch.setenv("CEPH_TPU_XOR_SCHED", "0")
    calls = []
    for name in ("gf2_matmul_popc", "gf2_matmul_mma"):
        real = getattr(gk, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(*a, **kw)
        monkeypatch.setattr(gk, name, spy)
    gen = gf.gen_cauchy1_matrix(k + m, k)
    data = _data(8, b, k, l)
    want = ref_k.gf_matmul_batch_device(gen[k:], data, out_np=True)
    got = gk.gf_matmul_batch_device(gen[k:], data, out_np=True, device="cpu")
    assert np.array_equal(got, want)
    assert calls == [kernel]
    out = gk.gf_matmul_batch_device(gen[k:], torch.from_numpy(data))
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"


def test_cpu_path_launches_no_kernel():
    before = dict(gk.LAUNCHES)
    gen = gf.gen_rs_matrix(11, 8)
    gk.gf_matmul_batch_device(gen[8:], _data(3, 4, 8, 512), device="cpu")
    gk.gf_matmul_device(gen[8:], _data(4, 8, 100), device="cpu")
    assert gk.LAUNCHES == before


def test_wrappers_reject_bad_inputs():
    mat = gf.gen_rs_matrix(11, 8)[8:]
    x = torch.from_numpy(_data(5, 4, 8, 256))
    with pytest.raises(ValueError):
        gk.gf2_matmul_popc(mat, x.to(torch.int16))
    with pytest.raises(ValueError):
        gk.gf2_matmul_popc(mat, x[:, :7])
    with pytest.raises(ValueError):
        gk.gf2_matmul_popc(mat, x[:, :, ::2])
    with pytest.raises(ValueError):
        gk.gf2_matmul_mma(mat, x, 3)                 # B % g != 0
    with pytest.raises(ValueError):
        gk.gf2_matmul_mma(mat, x[:, :, :200].contiguous(), 2)   # L % 128
    with pytest.raises(TypeError):
        gk.gf2_matmul_popc(mat, x.numpy())
