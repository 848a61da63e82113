"""SHEC, Clay, and jerasure bitmatrix techniques
(src/erasure-code/{shec,clay,jerasure} semantics).

The port's counterpart of ``tests/test_ec_advanced.py``: its cases on
``ceph_tpu_torch``'s shec, clay and jerasure plugins.
"""

from itertools import combinations

import numpy as np
import pytest

from torch_ec_plugin_cases import registry


def roundtrip_all_patterns(codec, k, m, data, max_err=None):
    enc = codec.encode(set(range(k + m)), data)
    for nerr in range(1, (max_err or m) + 1):
        for erased in combinations(range(k + m), nerr):
            avail = {i: enc[i] for i in range(k + m) if i not in erased}
            dec = codec.decode(set(erased), avail)
            for e in erased:
                assert np.array_equal(dec[e], enc[e]), (erased, e)
    return enc


@pytest.mark.parametrize("tech,k,m,w,ps", [
    ("cauchy_orig", 5, 3, 8, 8),
    ("cauchy_good", 5, 3, 8, 8),
    ("cauchy_good", 7, 3, 4, 16),
    ("liberation", 5, 2, 7, 8),
    ("blaum_roth", 5, 2, 6, 8),
])
def test_jerasure_bitmatrix_techniques(tech, k, m, w, ps):
    codec = registry().factory("jerasure", {
        "technique": tech, "k": str(k), "m": str(m), "w": str(w),
        "packetsize": str(ps)})
    rng = np.random.default_rng(1)
    data = rng.integers(0, 256, size=k * w * ps * 3 - 17,
                        dtype=np.uint8).tobytes()
    enc = roundtrip_all_patterns(codec, k, m, data)
    out = codec.decode_concat({i: enc[i] for i in range(m, k + m)})
    assert out[:len(data)] == data


def test_jerasure_bitmatrix_validation():
    with pytest.raises(ValueError):        # liberation needs prime w
        registry().factory("jerasure", {"technique": "liberation",
                                        "k": "4", "w": "8"})
    with pytest.raises(ValueError):        # blaum_roth needs w+1 prime
        registry().factory("jerasure", {"technique": "blaum_roth",
                                        "k": "4", "w": "7"})
    with pytest.raises(ValueError):        # cauchy needs k+m <= 2^w
        registry().factory("jerasure", {"technique": "cauchy_orig",
                                        "k": "14", "m": "3", "w": "4"})


@pytest.mark.parametrize("tech,k,m,c", [
    ("multiple", 6, 3, 2), ("single", 4, 3, 2), ("multiple", 8, 4, 3),
])
def test_shec_guarantees(tech, k, m, c):
    codec = registry().factory("shec", {
        "technique": tech, "k": str(k), "m": str(m), "c": str(c)})
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, size=k * 1024 + 37,
                        dtype=np.uint8).tobytes()
    enc = codec.encode(set(range(k + m)), data)
    # single failures recover from FEWER than k chunks (locality win)
    fewer = 0
    for e in range(k + m):
        avail = set(range(k + m)) - {e}
        minimum = codec.minimum_to_decode({e}, avail)
        if e < k and len(minimum) < k:
            fewer += 1
        dec = codec.decode({e}, {i: enc[i] for i in minimum})
        assert np.array_equal(dec[e], enc[e])
    assert fewer == k, "every single data-chunk repair should be local"
    # the durability guarantee: any c simultaneous failures recover
    for erased in combinations(range(k + m), c):
        avail = {i: enc[i] for i in range(k + m) if i not in erased}
        dec = codec.decode(set(erased), avail)
        for e in erased:
            assert np.array_equal(dec[e], enc[e])
    # the trade-off is real: some m-failure pattern is unrecoverable
    if m > c:
        def recoverable(erased):
            avail = {i: enc[i] for i in range(k + m)
                     if i not in erased}
            try:
                codec.decode(set(erased), avail)
                return True
            except IOError:
                return False
        assert not all(recoverable(e)
                       for e in combinations(range(k + m), m))


@pytest.mark.parametrize("k,m,d", [
    (4, 2, 5),      # q=2 t=3, canonical
    (6, 3, 8),      # q=3 t=3
    (5, 2, 6),      # nu=1 shortened
    (4, 2, 4),      # d=k degenerate (q=1, no sub-chunking)
])
def test_clay_decode_and_repair(k, m, d):
    codec = registry().factory("clay", {"k": str(k), "m": str(m),
                                        "d": str(d)})
    scn = codec.get_sub_chunk_count()
    assert scn == codec.q ** codec.t
    rng = np.random.default_rng(2)
    data = rng.integers(0, 256, size=codec.get_chunk_size(1) * k * 2 - 5,
                        dtype=np.uint8).tobytes()
    enc = roundtrip_all_patterns(codec, k, m, data)
    csize = len(enc[0])
    sc = csize // scn
    # repair-bandwidth path: one lost chunk needs only 1/q of each of
    # d helper chunks (the Clay selling point; sub-chunk read plans
    # come from minimum_to_decode as (offset, count) ranges)
    for lost in range(k + m):
        minimum = codec.minimum_to_decode({lost},
                                          set(range(k + m)) - {lost})
        assert len(minimum) == d
        ranges = next(iter(minimum.values()))
        assert sum(cnt for _, cnt in ranges) == scn // codec.q
        helpers = {
            h: np.concatenate([enc[h][o * sc:(o + cnt) * sc]
                               for o, cnt in r])
            for h, r in minimum.items()}
        out = codec.decode({lost}, helpers, chunk_size=csize)
        assert np.array_equal(out[lost], enc[lost])


def test_clay_profile_validation():
    with pytest.raises(ValueError):
        registry().factory("clay", {"k": "4", "m": "2", "d": "7"})
    with pytest.raises(ValueError):
        registry().factory("clay", {"k": "4", "m": "2", "d": "3"})
