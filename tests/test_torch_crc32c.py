"""The port's CRC32C module held against ceph_tpu's ``ops/crc32c_batch.py``.

Seeded numpy inputs go through the reference (its jitted device program on
the CPU, its numpy engine and its GF(2) register algebra) and through the
port with tensors on the CPU, where ``crc32c_chunks`` runs its plain
version.  Every CRC must be equal bit for bit (tolerance 0).
"""

import numpy as np
import pytest
import torch

from ceph_tpu.ec import registry as ref_registry
from ceph_tpu.ops import crc32c_batch as ref
from ceph_tpu_torch.ec.plugins.cuda import ErasureCodeCuda
from ceph_tpu_torch.ops import crc32c_batch as crc
from ceph_tpu_torch.ops.torch_backend import TorchBackend

torch.set_num_threads(1)

LENGTHS = [0, 1, 7, 8, 9, 127, 4096, 4099]


@pytest.mark.parametrize("n", [1, 6])
@pytest.mark.parametrize("l", LENGTHS)
def test_chunks_plain_matches_reference(n, l):
    x = np.random.default_rng(l * 7 + n).integers(0, 256, (n, l),
                                                  dtype=np.uint8)
    got = crc.crc32c_chunks(torch.from_numpy(x))
    assert got.dtype == torch.int64 and got.shape == (n,)
    got = crc.to_uint32(got)
    assert np.array_equal(got, np.asarray(ref.crc32c_device_chunks(x)))
    assert np.array_equal(got, ref.crc32c_rows(x, backend="numpy"))
    assert np.array_equal(crc.to_uint32(crc.crc32c_chunks_plain(
        torch.from_numpy(x))), got)


def test_chunks_keep_leading_dims_and_take_a_seed():
    x = np.random.default_rng(1).integers(0, 256, (2, 3, 77), dtype=np.uint8)
    got = crc.to_uint32(crc.crc32c_chunks(torch.from_numpy(x)))
    assert got.shape == (2, 3)
    assert np.array_equal(got, np.asarray(ref.crc32c_device_chunks(x)))
    seeded = crc.to_uint32(crc.crc32c_chunks(torch.from_numpy(x[0]), 0x1234))
    assert np.array_equal(seeded, ref.crc32c_rows(x[0], seed=0x1234,
                                                  backend="numpy"))
    empty = crc.crc32c_chunks(torch.zeros((4, 0), dtype=torch.uint8))
    assert crc.to_uint32(empty).tolist() == [crc.SEED] * 4
    with pytest.raises(TypeError):
        crc.crc32c_chunks(torch.zeros((2, 8), dtype=torch.int32))


def test_host_engines_match_reference():
    rng = np.random.default_rng(2)
    arr = rng.integers(0, 256, (9, 300), dtype=np.uint8)
    lens = rng.integers(0, 301, 9)
    for kw in ({}, {"lengths": lens}, {"seed": 0xDEADBEEF}):
        assert np.array_equal(crc.crc32c_rows(arr, **kw),
                              ref.crc32c_rows(arr, backend="numpy", **kw))
    bufs = [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes()
            for n in (0, 1, 63, 64, 65, 1000, 5000)]
    want = ref.crc32c_batch(bufs, backend="numpy")
    assert np.array_equal(crc.crc32c_batch(bufs), want)
    assert np.array_equal(crc.crc32c_batch(
        [np.frombuffer(b, np.uint8) for b in bufs]), want)
    for b in bufs:
        assert crc.crc32c_numpy_one(b) == ref.crc32c_numpy_one(b)
    assert crc.crc32c_batch([]).shape == (0,)


def test_register_algebra_matches_reference():
    assert np.array_equal(crc._tables(), ref._tables())
    assert np.array_equal(crc._zero_byte_matrix(), ref._zero_byte_matrix())
    m = crc._zeros_matrix(12345)
    assert np.array_equal(m, ref._zeros_matrix(12345))
    assert np.array_equal(crc._mat_inv(m), ref._mat_inv(m))
    for b in (0, 1, 5, 17):
        assert np.array_equal(crc._zeros_pow2(b), ref._zeros_pow2(b))
        assert np.array_equal(crc._inv_zeros_pow2(b), ref._inv_zeros_pow2(b))
    rng = np.random.default_rng(3)
    regs = rng.integers(0, 1 << 32, 16, dtype=np.uint64).astype(np.uint32)
    for n in (0, 1, 8, 1000, 131072):
        assert np.array_equal(crc.crc32c_zeros(regs, n),
                              ref.crc32c_zeros(regs, n))
        assert crc.crc32c_zeros(int(regs[0]), n) == \
            ref.crc32c_zeros(int(regs[0]), n)
    assert np.array_equal(crc.crc32c_combine(regs, regs[::-1], 777),
                          ref.crc32c_combine(regs, regs[::-1], 777))
    nz = rng.integers(0, 5000, 16)
    assert np.array_equal(crc.crc32c_strip_zeros(regs, nz),
                          ref.crc32c_strip_zeros(regs, nz))
    chunks = regs.reshape(4, 4)
    assert np.array_equal(crc.fold_chunk_crcs(chunks, 4096),
                          ref.fold_chunk_crcs(chunks, 4096))
    assert np.array_equal(crc.fold_chunk_crcs(chunks[:0], 64),
                          ref.fold_chunk_crcs(chunks[:0], 64))


@pytest.mark.parametrize("n", [0, 1, 63, 64, 4097, 100003])
def test_resident_matches_reference(n):
    buf = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8)
    want = ref.crc32c_resident(buf)
    assert crc.crc32c_resident(buf.tobytes(), device="cpu") == want
    assert crc.crc32c_resident(torch.from_numpy(buf.copy())) == want
    assert crc.crc32c_resident(buf, device="cpu") == want


def test_device_chunks_count_and_stay_on_the_device():
    x = np.random.default_rng(4).integers(0, 256, (3, 5, 40), dtype=np.uint8)
    before = crc.PERF.get("fused_launches"), crc.PERF.get("fused_crcs")
    out = crc.crc32c_device_chunks(x, device="cpu")
    assert isinstance(out, torch.Tensor) and out.shape == (3, 5)
    assert np.array_equal(crc.to_uint32(out),
                          np.asarray(ref.crc32c_device_chunks(x)))
    assert crc.PERF.get("fused_launches") == before[0] + 1
    assert crc.PERF.get("fused_crcs") == before[1] + 15
    assert crc.LAUNCHES["crc32c_chunks"] == 0     # the CPU runs no kernel


def test_crc_plan_splits_rows_for_the_card():
    for n, l in [(11264, 131072), (256, 262144), (129, 524288), (1, 1),
                 (3, 4099), (70000, 128), (1, 65541), (3072, 131072)]:
        for aligned in (True, False):
            rounds, spans = crc.crc_plan(n, l, aligned)
            reach = l if aligned else l + crc._EDGE_SLACK
            span = 512 * rounds
            assert 1 <= rounds <= crc._MAX_ROUNDS
            assert rounds & (rounds - 1) == 0
            assert spans * span >= reach > (spans - 1) * span
            # fewer items than the card's warps want only at the shortest span
            assert rounds == 1 or n * spans >= crc._TARGET_ITEMS
            # no span is twice what the row needs
            assert rounds == 1 or span // 2 < reach
    # the fused encode's data, parity and both: 16 KiB spans
    assert crc.crc_plan(8192, 131072) == (32, 8)
    assert crc.crc_plan(3072, 131072) == (32, 8)
    assert crc.crc_plan(11264, 131072) == (32, 8)
    # crc32c_resident's 64 MiB in 256 rows: 4 KiB spans for the warps
    assert crc.crc_plan(256, 262144) == (8, 64)


def test_k4_constants_hold_the_register_algebra():
    """The seed term and the step, fold and tail constants K4 reads, held
    against the reference's register algebra."""
    rng = np.random.default_rng(6)
    for l in (1, 7, 4096, 131072):
        assert crc._seed_term(l, crc.SEED) == ref.crc32c_zeros(crc.SEED, l)
    words = crc._fixed_consts()
    assert words.dtype == np.uint32
    step = words[:1024].reshape(4, 256)
    # T'_m[v]: byte v, then m + 508 zero bytes, from register 0
    for m in range(4):
        for v in rng.integers(0, 256, 4):
            buf = np.zeros(1 + m + 508, np.uint8)
            buf[0] = v
            assert int(step[m, v]) == int(ref.crc32c_rows(
                buf[None], seed=0, backend="numpy")[0])
    regs = rng.integers(0, 1 << 32, 8, dtype=np.uint64).astype(np.uint32)
    for i, shift in enumerate(crc._FOLD_SHIFTS):
        t = words[1024 * (1 + i):1024 * (2 + i)].reshape(4, 256)
        got = t[0][regs & 0xFF] ^ t[1][(regs >> 8) & 0xFF] \
            ^ t[2][(regs >> 16) & 0xFF] ^ t[3][regs >> 24]
        assert np.array_equal(got, ref.crc32c_zeros(regs, shift))
    tails = words[1024 * 7:].reshape(16, 32)
    for z in (0, 5, 15):
        back = crc._mat_apply(tails[z], ref.crc32c_zeros(regs, 508 + z))
        assert np.array_equal(back, regs)
    ladder = crc._consts(4, 3, torch.device("cpu")).numpy().view(np.uint32)
    assert np.array_equal(ladder[:words.size], words)
    for i in range(3):
        m = ladder[words.size + 32 * i:words.size + 32 * (i + 1)]
        assert np.array_equal(crc._mat_apply(m, regs),
                              ref.crc32c_zeros(regs, 2048 << i))


@pytest.mark.parametrize("l", [0, 9, 4099])
def test_chunks_pair_matches_reference(l):
    rng = np.random.default_rng(l + 11)
    x = rng.integers(0, 256, (2, 3, l), dtype=np.uint8)
    y = rng.integers(0, 256, (2, 1, l), dtype=np.uint8)
    cx, cy = crc.crc32c_chunks_pair(torch.from_numpy(x), torch.from_numpy(y))
    assert cx.shape == (2, 3) and cy.shape == (2, 1)
    assert np.array_equal(crc.to_uint32(cx),
                          np.asarray(ref.crc32c_device_chunks(x)))
    assert np.array_equal(crc.to_uint32(cy),
                          np.asarray(ref.crc32c_device_chunks(y)))
    with pytest.raises(ValueError):
        crc.crc32c_chunks_pair(torch.from_numpy(x),
                               torch.zeros((1, l + 1), dtype=torch.uint8))


def test_fused_crc_env_gate(monkeypatch):
    monkeypatch.delenv("CEPH_TPU_NO_FUSED_CRC", raising=False)
    assert crc.fused_enabled() and ref.fused_enabled()
    monkeypatch.setenv("CEPH_TPU_NO_FUSED_CRC", "1")
    assert not crc.fused_enabled() and not ref.fused_enabled()


def test_device_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.zeros((2, 16), np.uint8)
    with pytest.raises(RuntimeError, match="CUDA"):
        crc.crc32c_device_chunks(x)
    with pytest.raises(RuntimeError, match="CUDA"):
        crc.crc32c_resident(x.tobytes())


@pytest.mark.parametrize("k,m", [(4, 2), (8, 3)])
def test_encode_batch_crc_matches_reference(k, m):
    profile = {"k": str(k), "m": str(m), "technique": "reed_sol_van"}
    tpu = ref_registry().factory("tpu", dict(profile))
    port = ErasureCodeCuda("reed_sol_van", device="cpu")
    port.init(dict(profile))
    data = np.random.default_rng(k).integers(0, 256, (5, k, 200),
                                             dtype=np.uint8)
    want_parity, want_crcs = tpu.encode_batch_crc(data)
    parity, crcs = port.encode_batch_crc(data)
    assert crcs.dtype == np.uint32 and crcs.shape == (5, k + m)
    assert np.array_equal(parity, want_parity)
    assert np.array_equal(crcs, want_crcs)
    tparity, tcrcs = TorchBackend("cpu").matmul_batch_crc(
        port.encode_matrix[k:], torch.from_numpy(data))
    assert np.array_equal(tparity, want_parity)
    assert np.array_equal(tcrcs, want_crcs)
