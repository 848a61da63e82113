"""The port's host EC plugins held against ``ceph_tpu``'s on the same seeded
data: for every plugin and technique, the chunks of an encode are byte-equal,
and so is every decode of up to m erasures (a pattern the reference cannot
decode, the port refuses too), and Clay's sub-chunk repair of each lost chunk
from its d helpers.  Each package's codec comes from its own registry; the
port's on ``device="cpu"`` (host codecs ignore it).
"""

from itertools import combinations

import numpy as np
import pytest

from ceph_tpu.ec import ErasureCodePluginRegistry as RefRegistry
from torch_ec_plugin_cases import CpuRegistry

PROFILES = [
    *[("jerasure", {"technique": t, "k": "4", "m": "2"})
      for t in ("reed_sol_van", "reed_sol_r6_op", "cauchy_orig",
                "cauchy_good", "liberation", "blaum_roth")],
    ("jerasure", {"technique": "reed_sol_van", "k": "5", "m": "3"}),
    ("jerasure", {"technique": "cauchy_good", "k": "5", "m": "3", "w": "4",
                  "packetsize": "16"}),
    ("jerasure", {"technique": "liberation", "k": "5", "m": "2", "w": "7",
                  "packetsize": "8"}),
    *[("jerasure", {"technique": t, "k": "4", "m": "2", "w": w})
      for t in ("reed_sol_van", "reed_sol_r6_op") for w in ("16", "32")],
    ("jerasure", {"technique": "reed_sol_van", "k": "4", "m": "2",
                  "jerasure-per-chunk-alignment": "true"}),
    ("shec", {"technique": "multiple", "k": "4", "m": "3", "c": "2"}),
    ("shec", {"technique": "single", "k": "4", "m": "3", "c": "2"}),
    ("shec", {"technique": "multiple", "k": "6", "m": "3", "c": "2"}),
    *[("clay", {"k": "4", "m": "2", "d": "5", "scalar_mds": mds,
                "technique": tech})
      for mds, tech in (("jerasure", "reed_sol_van"),
                        ("isa", "reed_sol_van"), ("shec", "multiple"))],
    ("clay", {"k": "5", "m": "2", "d": "6"}),
    ("clay", {"k": "4", "m": "2", "d": "4"}),
    ("example", {}),
]


def _id(case) -> str:
    plugin, profile = case
    return plugin + "-" + ",".join(f"{k}={v}" for k, v in profile.items())


def _both(plugin: str, profile: dict):
    return (RefRegistry().factory(plugin, dict(profile)),
            CpuRegistry().factory(plugin, dict(profile)))


@pytest.mark.parametrize("case", PROFILES, ids=_id)
def test_encode_and_every_decode_equal_the_reference(case):
    plugin, profile = case
    ref, port = _both(plugin, profile)
    n, k = ref.get_chunk_count(), ref.get_data_chunk_count()
    assert (port.get_chunk_count(), port.get_data_chunk_count()) == (n, k)
    assert port.get_chunk_size(4096) == ref.get_chunk_size(4096)
    rng = np.random.default_rng(len(_id(case)))
    data = rng.integers(0, 256, size=port.get_chunk_size(1) * k * 2 - 7,
                        dtype=np.uint8).tobytes()
    want = ref.encode(set(range(n)), data)
    got = port.encode(set(range(n)), data)
    for i in range(n):
        assert np.array_equal(got[i], want[i]), i
    for nerr in range(1, n - k + 1):
        for erased in combinations(range(n), nerr):
            try:
                dec_ref = ref.decode(
                    set(erased), {i: want[i] for i in range(n)
                                  if i not in erased})
            except IOError:
                with pytest.raises(IOError):
                    port.decode(set(erased), {i: got[i] for i in range(n)
                                              if i not in erased})
                continue
            dec = port.decode(set(erased), {i: got[i] for i in range(n)
                                            if i not in erased})
            for e in erased:
                assert np.array_equal(dec[e], dec_ref[e]), (erased, e)
                assert np.array_equal(dec[e], want[e]), (erased, e)


@pytest.mark.parametrize("case", [c for c in PROFILES if c[0] == "clay"],
                         ids=_id)
def test_clay_sub_chunk_repair_equals_the_reference(case):
    plugin, profile = case
    ref, port = _both(plugin, profile)
    n, k = ref.get_chunk_count(), ref.get_data_chunk_count()
    rng = np.random.default_rng(5)
    data = rng.integers(0, 256, size=port.get_chunk_size(1) * k,
                        dtype=np.uint8).tobytes()
    enc = port.encode(set(range(n)), data)
    csize = len(enc[0])
    sc = csize // port.get_sub_chunk_count()
    for lost in range(n):
        plan = port.minimum_to_decode({lost}, set(range(n)) - {lost})
        assert plan == ref.minimum_to_decode({lost}, set(range(n)) - {lost})
        helpers = {h: np.concatenate([enc[h][o * sc:(o + c) * sc]
                                      for o, c in r])
                   for h, r in plan.items()}
        got = port.decode({lost}, helpers, chunk_size=csize)
        want = ref.decode({lost}, helpers, chunk_size=csize)
        assert np.array_equal(got[lost], want[lost]), lost
        assert np.array_equal(got[lost], enc[lost]), lost
