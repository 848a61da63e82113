"""jerasure word techniques at w=16/32: GF(2^16)/GF(2^32) word-region
coding (ErasureCodeJerasure.h:81-240, galois.c region mults).

External anchors (not mere self-roundtrip): the distinguished
Vandermonde's first parity row is all ones, so parity0 must equal the
XOR of the data chunks at every w; the RAID6 rows are [1,1,..] and
[1,2,4,..], so parity1 must match an independent scalar GF(2^w)
word-by-word evaluation.

The port's counterpart of ``tests/test_jerasure_w16.py``: its cases on
``ceph_tpu_torch``'s jerasure plugin.
"""

import numpy as np
import pytest

from torch_ec_plugin_cases import CpuRegistry
from ceph_tpu_torch.gf.gf2w import gf2w_mult


@pytest.fixture()
def registry():
    return CpuRegistry()


def _roundtrip(codec, k, m, data):
    enc = codec.encode(set(range(k + m)), data)
    # every single and double erasure recovers byte-exact
    import itertools
    for erasures in itertools.combinations(range(k + m), min(2, m)):
        avail = {i: enc[i] for i in range(k + m) if i not in erasures}
        dec = codec.decode(set(range(k + m)), avail)
        for e in erasures:
            assert np.array_equal(dec[e], enc[e]), (erasures, e)
    return enc


@pytest.mark.parametrize("w", [16, 32])
@pytest.mark.parametrize("technique", ["reed_sol_van", "reed_sol_r6_op"])
def test_word_technique_roundtrip(registry, technique, w):
    rng = np.random.default_rng(w)
    k, m = 5, 3 if technique == "reed_sol_van" else 2
    codec = registry.factory("jerasure", {
        "k": str(k), "m": str(m), "technique": technique, "w": str(w)})
    assert codec.w == w
    data = rng.integers(0, 256, size=4096 * k + 13,
                        dtype=np.uint8).tobytes()
    _roundtrip(codec, k, codec.m, data)


@pytest.mark.parametrize("w", [16, 32])
def test_vandermonde_parity0_is_xor(registry, w):
    """jerasure's distinguished matrix has an all-ones first parity
    row at every w: parity0 == XOR of the data chunks (reed_sol.c
    reed_sol_big_vandermonde_distribution_matrix)."""
    rng = np.random.default_rng(w + 1)
    k, m = 4, 2
    codec = registry.factory("jerasure", {
        "k": str(k), "m": str(m), "technique": "reed_sol_van",
        "w": str(w)})
    data = rng.integers(0, 256, size=k * 1024, dtype=np.uint8).tobytes()
    enc = codec.encode(set(range(k + m)), data)
    want = np.zeros_like(np.asarray(enc[0]))
    for i in range(k):
        want ^= np.asarray(enc[i])
    assert np.array_equal(np.asarray(enc[k]), want)


@pytest.mark.parametrize("w", [16, 32])
def test_raid6_parity_matches_scalar_field_eval(registry, w):
    """reed_sol_r6_op parity1 = sum_j 2^j * d_j over GF(2^w):
    independently re-evaluated word-by-word with the scalar field
    multiply (no region tables)."""
    rng = np.random.default_rng(w + 2)
    k = 4
    codec = registry.factory("jerasure", {
        "k": str(k), "m": "2", "technique": "reed_sol_r6_op",
        "w": str(w)})
    data = rng.integers(0, 256, size=k * 512, dtype=np.uint8).tobytes()
    enc = codec.encode(set(range(k + 2)), data)
    dt = np.uint16 if w == 16 else np.uint32
    words = [np.asarray(enc[j]).view(dt) for j in range(k)]
    p1 = np.asarray(enc[k + 1]).view(dt)
    coeff = 1
    want = np.zeros_like(words[0])
    for j in range(k):
        want ^= np.array([gf2w_mult(coeff, int(x), w)
                          for x in words[j]], dtype=dt)
        coeff = gf2w_mult(coeff, 2, w)
    assert np.array_equal(p1, want)


def test_region_mult_matches_scalar():
    """The split-table region multiply equals the scalar field product
    on every word, for random constants at both widths."""
    from ceph_tpu_torch.ec.gf2w_region import region_mult
    rng = np.random.default_rng(9)
    for w, dt in ((16, np.uint16), (32, np.uint32)):
        words = rng.integers(0, 2**w, size=256).astype(dt)
        for c in [1, 2, 0x8009, int(rng.integers(2, 2**w))]:
            got = region_mult(c, words.view(np.uint8), w)
            want = np.array([gf2w_mult(c, int(x), w) for x in words],
                            dtype=dt)
            assert np.array_equal(got, want), (w, c)


def test_shec_rejects_wide_w(registry):
    with pytest.raises(Exception, match="w=16"):
        registry.factory("shec", {"k": "4", "m": "3", "c": "2",
                                  "w": "16"})
