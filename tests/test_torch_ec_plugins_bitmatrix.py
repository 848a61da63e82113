"""The bitmatrix cases of ``tests/test_xor_schedule.py`` on the port: the
XOR schedule's host executor (``apply_host``) against ``gf.gf2w``'s naive
XOR and a scalar oracle on random, Cauchy and liberation bit-matrices, and
the ``BitMatrixCodec`` repair path (one launch for every missing chunk, a
schedule warmed when the repair matrix is built), through
``ceph_tpu_torch``'s jerasure plugin on the host.
"""

import numpy as np
import pytest

from ceph_tpu_torch.gf.gf2w import (
    cauchy_improve_coding_matrix, cauchy_original_coding_matrix,
    liberation_coding_bitmatrix, matrix_to_bitmatrix, xor_matmul,
)
from ceph_tpu_torch.ops import xor_schedule as XS
from torch_ec_plugin_cases import registry


def scalar_oracle(bm: np.ndarray, planes: np.ndarray) -> np.ndarray:
    """From-scratch row-by-row XOR: the independent third opinion."""
    out = np.zeros((bm.shape[0], planes.shape[1]), np.uint8)
    for r in range(bm.shape[0]):
        acc = np.zeros(planes.shape[1], np.uint8)
        for c in np.flatnonzero(bm[r]):
            acc = acc ^ planes[c]
        out[r] = acc
    return out


def cauchy_bm(k: int, m: int, w: int, improve: bool) -> np.ndarray:
    mat = cauchy_original_coding_matrix(k, m, w)
    if improve:
        mat = cauchy_improve_coding_matrix(mat, k, m, w)
    return matrix_to_bitmatrix(mat, k, m, w)


# -- property-based byte parity ---------------------------------------------

@pytest.mark.parametrize("seed", range(8))
def test_random_matrix_three_way_parity(seed):
    """Random 0/1 matrices (random shape/density, zero rows, and
    duplicate rows injected) x ragged plane widths: scheduled == naive
    == scalar oracle, and the register bound holds."""
    rng = np.random.default_rng(seed)
    r = int(rng.integers(1, 24))
    c = int(rng.integers(1, 56))
    bm = (rng.random((r, c)) < rng.uniform(0.08, 0.9)).astype(np.uint8)
    if r >= 3:
        bm[r - 1] = 0                      # zero row -> zero output
        bm[r - 2] = bm[0]                  # duplicate row
    sched = XS.compile_schedule(bm)
    n = int(rng.integers(1, 700))          # ragged tail widths
    planes = rng.integers(0, 256, size=(c, n), dtype=np.uint8)
    got = XS.apply_host(sched, planes)
    assert np.array_equal(got, xor_matmul(bm, planes))
    assert np.array_equal(got, scalar_oracle(bm, planes))
    assert sched.peak_registers <= sched.max_registers


@pytest.mark.parametrize("k,m,w,improve", [
    (8, 3, 8, True), (8, 3, 8, False), (4, 2, 8, True),
    (10, 4, 4, True), (3, 3, 4, False),
])
def test_cauchy_parity(k, m, w, improve):
    bm = cauchy_bm(k, m, w, improve)
    sched = XS.compile_schedule(bm)
    rng = np.random.default_rng(k * m * w)
    planes = rng.integers(0, 256, size=(k * w, 333), dtype=np.uint8)
    got = XS.apply_host(sched, planes)
    assert np.array_equal(got, xor_matmul(bm, planes))
    assert np.array_equal(got, scalar_oracle(bm, planes))


@pytest.mark.parametrize("k,w", [(5, 5), (7, 7), (3, 11)])
def test_liberation_parity(k, w):
    bm = liberation_coding_bitmatrix(k, w)
    sched = XS.compile_schedule(bm)
    rng = np.random.default_rng(k * w)
    planes = rng.integers(0, 256, size=(k * w, 257), dtype=np.uint8)
    got = XS.apply_host(sched, planes)
    assert np.array_equal(got, xor_matmul(bm, planes))


# -- BitMatrixCodec repair path ---------------------------------------------

def _jerasure(technique, **profile):
    prof = {"technique": technique, **{k: str(v)
                                       for k, v in profile.items()}}
    return registry().factory("jerasure", prof)


def test_bitmatrix_decode_is_one_launch(monkeypatch):
    """All missing chunks -- data AND coding -- come back from ONE
    xor launch (the per-lost-chunk loop is gone)."""
    import ceph_tpu_torch.ec.bitmatrix_codec as BMC
    codec = _jerasure("cauchy_good", k=4, m=2, w=8, packetsize=8)
    csize = codec.get_alignment() // codec.k
    rng = np.random.default_rng(6)
    chunks = {i: rng.integers(0, 256, csize, dtype=np.uint8)
              if i < 4 else np.zeros(csize, np.uint8)
              for i in range(6)}
    codec.encode_chunks(chunks)
    full = {i: chunks[i].copy() for i in range(6)}
    calls = []
    real = BMC.scheduled_xor_matmul

    def counting(matrix, planes, **kw):
        calls.append(matrix.shape)
        return real(matrix, planes, **kw)

    monkeypatch.setattr(BMC, "scheduled_xor_matmul", counting)
    have = {i: full[i] for i in (0, 2, 3, 5)}      # lose data 1 + parity 4
    decoded = {i: (full[i].copy() if i in have
                   else np.zeros(csize, np.uint8)) for i in range(6)}
    codec.decode_chunks(set(range(4)), have, decoded)
    assert len(calls) == 1                         # ONE launch
    assert calls[0] == (2 * codec.w, 4 * codec.w)  # both chunks stacked
    for e in (1, 4):
        assert np.array_equal(decoded[e], full[e])


def test_repair_rides_schedule_warmed_at_build(monkeypatch):
    """The repair matrix's schedule is compiled when the decode matrix
    is built, so the read path (allow_compile=False) finds it cached
    and launches scheduled."""
    monkeypatch.setenv("CEPH_TPU_XOR_SCHED", "1")
    codec = _jerasure("cauchy_good", k=4, m=2, w=8, packetsize=8)
    csize = codec.get_alignment() // codec.k
    rng = np.random.default_rng(7)
    chunks = {i: rng.integers(0, 256, csize, dtype=np.uint8)
              if i < 4 else np.zeros(csize, np.uint8)
              for i in range(6)}
    codec.encode_chunks(chunks)
    full = {i: chunks[i].copy() for i in range(6)}

    def repair():
        have = {i: full[i] for i in range(6) if i not in (0, 1)}
        decoded = {i: (full[i].copy() if i in have
                       else np.zeros(csize, np.uint8))
                   for i in range(6)}
        codec.decode_chunks(set(range(4)), have, decoded)
        assert np.array_equal(decoded[0], full[0])
        assert np.array_equal(decoded[1], full[1])

    repair()                     # builds + warms the repair matrix
    before = XS.STATS.snapshot()
    repair()                     # cached schedule serves, no compile
    after = XS.STATS.snapshot()
    assert after[0] > before[0]
    assert after[1] == before[1]
