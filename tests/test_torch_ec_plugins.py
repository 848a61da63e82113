"""The port's counterpart of ``tests/test_ec_plugins.py``: its cases on
``ceph_tpu_torch``'s registry, every codec on ``device="cpu"``.
"""

import numpy as np
import pytest

from torch_ec_plugin_cases import CpuRegistry
from ceph_tpu_torch.ec.base import SIMD_ALIGN


@pytest.fixture()
def registry():
    return CpuRegistry()


def rand_bytes(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, size=n,
                                                dtype=np.uint8).tobytes()


def test_registry_load_and_factory(registry):
    codec = registry.factory("isa", {"k": "8", "m": "3",
                                     "technique": "reed_sol_van"})
    assert codec.get_chunk_count() == 11
    assert codec.get_data_chunk_count() == 8


def test_registry_unknown_plugin(registry):
    with pytest.raises(FileNotFoundError):
        registry.factory("doesnotexist", {})


def test_registry_profile_echo(registry):
    profile = {"k": "4", "m": "2", "technique": "cauchy"}
    codec = registry.factory("isa", profile)
    for key in profile:
        assert key in codec.get_profile()


def test_isa_chunk_size(registry):
    codec = registry.factory("isa", {"k": "8", "m": "3"})
    # ceil(stripe/k) rounded up to 32 (ErasureCodeIsa.cc:66-79)
    assert codec.get_chunk_size(4096) == 512
    assert codec.get_chunk_size(4097) == 544
    assert codec.get_chunk_size(100) == 32
    assert codec.get_chunk_size(8 * 32) == 32


def test_isa_vandermonde_parity0_is_xor(registry):
    """The first Vandermonde parity row is all ones => parity0 == XOR of
    the data chunks.  Independent structural check of byte parity."""
    codec = registry.factory("isa", {"k": "8", "m": "3"})
    data = rand_bytes(8 * 512)
    encoded = codec.encode(set(range(11)), data)
    arr = np.frombuffer(data, dtype=np.uint8).reshape(8, 512)
    want = np.zeros(512, dtype=np.uint8)
    for row in arr:
        want ^= row
    assert np.array_equal(encoded[8], want)


def test_isa_encode_padding(registry):
    codec = registry.factory("isa", {"k": "4", "m": "2"})
    raw = rand_bytes(100)
    encoded = codec.encode(set(range(6)), raw)
    bs = codec.get_chunk_size(100)
    assert bs == 32
    got = b"".join(bytes(encoded[i]) for i in range(4))
    assert got[:100] == raw
    assert got[100:] == b"\x00" * (4 * bs - 100)


@pytest.mark.parametrize("plugin,profile", [
    ("isa", {"k": "8", "m": "3", "technique": "reed_sol_van"}),
    ("isa", {"k": "10", "m": "4", "technique": "cauchy"}),
    ("jerasure", {"k": "7", "m": "3", "technique": "reed_sol_van"}),
    ("jerasure", {"k": "6", "m": "2", "technique": "reed_sol_r6_op"}),
    ("example", {}),
])
def test_roundtrip_all_single_and_double_erasures(registry, plugin, profile):
    codec = registry.factory(plugin, profile)
    k = codec.get_data_chunk_count()
    n = codec.get_chunk_count()
    m = n - k
    data = rand_bytes(k * 128 + 17, seed=42)
    encoded = codec.encode(set(range(n)), data)
    assert len(encoded) == n

    patterns = [[e] for e in range(n)]
    if m >= 2:
        patterns += [[a, b] for a in range(n) for b in range(a + 1, n)]
    for erased in patterns:
        avail = {i: encoded[i] for i in range(n) if i not in erased}
        decoded = codec.decode(set(range(n)), avail)
        for e in erased:
            assert np.array_equal(decoded[e], encoded[e]), (plugin, erased)


def test_decode_concat_roundtrip(registry):
    codec = registry.factory("isa", {"k": "8", "m": "3"})
    data = rand_bytes(8 * 512)
    encoded = codec.encode(set(range(11)), data)
    avail = {i: encoded[i] for i in range(11) if i not in (0, 9)}
    assert codec.decode_concat(avail)[:len(data)] == data


def test_minimum_to_decode(registry):
    codec = registry.factory("isa", {"k": "4", "m": "2"})
    # all wanted available -> identity
    got = codec.minimum_to_decode({0, 1}, {0, 1, 2, 3, 4, 5})
    assert set(got) == {0, 1}
    # one lost -> first k of the available
    got = codec.minimum_to_decode({0, 1, 2, 3}, {1, 2, 3, 4, 5})
    assert set(got) == {1, 2, 3, 4}
    # too few -> error
    with pytest.raises(IOError):
        codec.minimum_to_decode({0}, {1, 2, 3})


def test_decode_table_cache(registry):
    codec = registry.factory("isa", {"k": "4", "m": "2"})
    data = rand_bytes(4 * 64)
    encoded = codec.encode(set(range(6)), data)
    avail = {i: encoded[i] for i in range(6) if i != 1}
    codec.decode(set(range(6)), avail)
    codec.decode(set(range(6)), avail)
    assert codec.tcache.hits >= 1
    assert codec.tcache.misses == 1


def test_jerasure_raid6_forces_m2(registry):
    codec = registry.factory("jerasure",
                             {"k": "5", "m": "7",
                              "technique": "reed_sol_r6_op"})
    assert codec.get_chunk_count() - codec.get_data_chunk_count() == 2


def test_chunk_mapping_profile(registry):
    codec = registry.factory("isa", {"k": "2", "m": "1", "mapping": "_DD"})
    # data chunks land at positions 1,2; coding at 0
    assert codec.get_chunk_mapping() == [1, 2, 0]
    data = rand_bytes(2 * 32)
    encoded = codec.encode({0, 1, 2}, data)
    arr = np.frombuffer(data, dtype=np.uint8).reshape(2, 32)
    assert np.array_equal(encoded[1], arr[0])
    assert np.array_equal(encoded[2], arr[1])
    assert np.array_equal(encoded[0], arr[0] ^ arr[1])


# -- LRC ---------------------------------------------------------------------

def test_lrc_kml_layout(registry):
    """Canonical doc example k=4 m=2 l=3: two local groups of DD+gp+lp,
    generated mapping/layers per ErasureCodeLrc::parse_kml."""
    codec = registry.factory("lrc", {"k": "4", "m": "2", "l": "3"})
    # lgc=2 groups: mapping per group = DD + _ + _ -> "DD__DD__"
    assert codec.get_profile()["mapping"] == "DD__DD__"
    assert codec.get_chunk_count() == 8     # 4 data + 2 global + 2 local
    assert codec.get_data_chunk_count() == 4


def test_lrc_kml_validation(registry):
    with pytest.raises(ValueError):
        registry.factory("lrc", {"k": "4", "m": "2", "l": "4"})  # (k+m)%l
    with pytest.raises(ValueError):
        registry.factory("lrc", {"k": "4", "m": "2"})  # all-or-nothing
    with pytest.raises(ValueError):
        registry.factory("lrc", {"k": "5", "m": "1", "l": "3"})  # k%lgc


def test_lrc_roundtrip_all_single_erasures(registry):
    codec = registry.factory("lrc", {"k": "4", "m": "2", "l": "3"})
    n = codec.get_chunk_count()
    data = rand_bytes(4 * 96, seed=7)
    chunks = codec.encode(set(range(n)), data)
    for lost in range(n):
        have = {i: chunks[i] for i in range(n) if i != lost}
        dec = codec.decode({lost}, have)
        assert np.array_equal(dec[lost], chunks[lost]), lost


def test_lrc_single_loss_repairs_locally(registry):
    """The locality property: one lost chunk is repaired from its own
    group's l chunks, NOT from k chunks (ErasureCodeLrc.h:47-134)."""
    codec = registry.factory("lrc", {"k": "4", "m": "2", "l": "3"})
    n = codec.get_chunk_count()
    # groups on positions: [0,1,2,3] and [4,5,6,7] (DD c local | DD c local)
    for lost in range(n):
        avail = set(range(n)) - {lost}
        plan = codec.minimum_to_decode({lost}, avail)
        group = 0 if lost < 4 else 1
        group_pos = set(range(4 * group, 4 * group + 4))
        assert set(plan) <= group_pos - {lost}, (lost, plan)
        assert len(plan) == 3  # l chunks, not k+... reads
       

def test_lrc_double_loss_same_group_uses_global(registry):
    codec = registry.factory("lrc", {"k": "4", "m": "2", "l": "3"})
    n = codec.get_chunk_count()
    data = rand_bytes(4 * 96, seed=9)
    chunks = codec.encode(set(range(n)), data)
    # two data chunks in group 0 lost: local parity (m=1) can't fix;
    # the global layer must engage
    for lost in ([0, 1], [0, 4], [1, 5], [2, 6]):
        have = {i: chunks[i] for i in range(n) if i not in lost}
        dec = codec.decode(set(lost), have)
        for p in lost:
            assert np.array_equal(dec[p], chunks[p]), (lost, p)


def test_lrc_triple_loss_mixed(registry):
    """Local repair in one group + global repair across groups."""
    codec = registry.factory("lrc", {"k": "4", "m": "2", "l": "3"})
    n = codec.get_chunk_count()
    data = rand_bytes(4 * 96, seed=11)
    chunks = codec.encode(set(range(n)), data)
    lost = [0, 1, 4]      # 2 in group 0 (needs global), 1 in group 1
    have = {i: chunks[i] for i in range(n) if i not in lost}
    dec = codec.decode(set(lost), have)
    for p in lost:
        assert np.array_equal(dec[p], chunks[p]), p


def test_lrc_beyond_capability_raises(registry):
    codec = registry.factory("lrc", {"k": "4", "m": "2", "l": "3"})
    n = codec.get_chunk_count()
    # 3 losses inside one 4-chunk group: local m=1 + global m=2 on the
    # group's 3 affected global positions -> unrecoverable
    avail = set(range(n)) - {0, 1, 2}
    with pytest.raises(IOError):
        codec.minimum_to_decode({0, 1, 2}, avail)


def test_lrc_validation_messages_and_layer_order(registry):
    """Profile validation EINVALs fire at parse time with actionable
    messages (the monitor instantiates the plugin at profile-set AND
    pool-create, so both gates reject), and an ill-ordered layers
    profile -- a layer reading a position nothing computed yet, which
    the old per-layer encode silently zero-filled -- is refused."""
    with pytest.raises(ValueError, match="all of k, m, l"):
        registry.factory("lrc", {"k": "4", "l": "3"})
    with pytest.raises(ValueError, match="l=0 must be >= 1"):
        registry.factory("lrc", {"k": "4", "m": "2", "l": "0"})
    with pytest.raises(ValueError, match="mapping cannot be set"):
        registry.factory("lrc", {"k": "4", "m": "2", "l": "3",
                                 "mapping": "DD__"})
    import json
    with pytest.raises(ValueError, match="before any layer computes"):
        # the FIRST layer reads position 2, which only the SECOND
        # layer computes: the old per-layer encode silently used zeros
        registry.factory("lrc", {
            "mapping": "DD__",
            "layers": json.dumps([["DDDc", ""], ["DDc_", ""]])})


def test_lrc_flat_generator_matches_layered_encode(registry):
    """The flat generator composition is byte-identical to driving
    the layer stack explicitly (the pre-flat implementation's
    semantics): each coding position's bytes equal its layer's RS
    parity over the layer inputs."""
    from ceph_tpu_torch.gf import gf_matmul
    codec = registry.factory("lrc", {"k": "4", "m": "2", "l": "3"})
    n = codec.get_chunk_count()
    data = rand_bytes(4 * 96, seed=21)
    chunks = codec.encode(set(range(n)), data)
    for layer in codec.layers:
        src = np.stack([chunks[p] for p in layer.data_pos])
        parity = gf_matmul(layer.matrix[layer.k:], src)
        for r, p in enumerate(layer.coding_pos):
            assert np.array_equal(chunks[p], parity[r]), (
                layer.mapping, p)


def test_lrc_batched_launches_match_host(registry):
    """The mapped layout rides the CodecBatcher (padding buckets +
    scheduled/dense kernels): encode_async/decode_async byte-parity
    vs the per-stripe host driver, including a LOCAL batched repair
    (sources fewer than k, inexpressible in the positional
    decode-index dialect)."""
    import asyncio
    from ceph_tpu_torch.osd.codec_batcher import CodecBatcher
    from ceph_tpu_torch.osd.ec_util import StripeInfo
    codec = registry.factory("lrc", {"k": "4", "m": "2", "l": "3"})
    assert CodecBatcher.supports(codec)
    sinfo = StripeInfo.for_codec(codec, 1024)
    data = rand_bytes(sinfo.stripe_width * 3, seed=23)
    host = sinfo.encode(codec, data)

    async def drive():
        batcher = CodecBatcher(max_batch=8, mesh=None)
        shards = await sinfo.encode_async(codec, data,
                                          batcher=batcher)
        for i in host:
            assert np.array_equal(host[i], shards[i]), i
        n = codec.get_chunk_count()
        for lost in range(n):
            have = {i: shards[i] for i in range(n) if i != lost}
            got = await sinfo.decode_async(codec, have, want={lost},
                                           batcher=batcher)
            assert np.array_equal(got[lost], shards[lost]), lost
        out = await sinfo.reconstruct_logical_async(
            codec, {i: shards[i] for i in range(n) if i != 0},
            batcher=batcher)
        assert out == data
        batcher.close()

    asyncio.new_event_loop().run_until_complete(drive())


def test_lrc_local_repair_bytes_equal_global_decode(registry):
    """The same failure decoded two ways -- from the local group only
    and from a k-wide global set -- produces identical bytes (both
    are exact solutions of the generator identity)."""
    codec = registry.factory("lrc", {"k": "4", "m": "2", "l": "3"})
    n = codec.get_chunk_count()
    data = rand_bytes(4 * 96, seed=25)
    chunks = codec.encode(set(range(n)), data)
    lost = 1
    local = set(codec.minimum_to_decode({lost},
                                        set(range(n)) - {lost}))
    assert len(local) == 3                       # the group, not k
    dec_local = codec.decode({lost},
                             {i: chunks[i] for i in local})
    glob = {i: chunks[i] for i in range(n) if i != lost}
    dec_global = codec.decode({lost}, glob)
    assert np.array_equal(dec_local[lost], dec_global[lost])
    assert np.array_equal(dec_local[lost], chunks[lost])


def test_lrc_baseline_config_k12_m4_l4(registry):
    """The multi-chip BASELINE shape: 4 local groups mapping onto a
    4-way mesh axis (parallel/sharded_ec.py lrc_local_repair)."""
    codec = registry.factory("lrc", {"k": "12", "m": "4", "l": "4"})
    n = codec.get_chunk_count()
    assert n == 12 + 4 + 4
    data = rand_bytes(12 * 64, seed=13)
    chunks = codec.encode(set(range(n)), data)
    # single loss in each group repairs group-locally (l=4 reads)
    for lost in (0, 5, 12, 19):
        avail = set(range(n)) - {lost}
        plan = codec.minimum_to_decode({lost}, avail)
        group = lost // 5
        group_pos = set(range(5 * group, 5 * group + 5))
        assert set(plan) <= group_pos - {lost}
        assert len(plan) == 4
        dec = codec.decode({lost}, {i: chunks[i] for i in avail})
        assert np.array_equal(dec[lost], chunks[lost])
