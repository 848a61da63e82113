"""The port's LRC and PMSR codecs held against ceph_tpu's lrc / pmsr plugins.

Codecs built with ``device="cpu"`` run the plain PyTorch versions of the
kernels: the scheduled engine's ``apply_bits_plain`` under
``CEPH_TPU_XOR_SCHED=1`` and the dense ladder's under ``=0``.  Every matrix
and every byte must equal the reference's on the same seeded inputs.
"""

import itertools

import numpy as np
import pytest
import torch

from ceph_tpu.ec import ErasureCodePluginRegistry as RefRegistry
import ceph_tpu_torch.ops.gf2kernels as gk
import ceph_tpu_torch.ops.xor_schedule as xs
from ceph_tpu_torch.ec import registry
from ceph_tpu_torch.ec.plugins.lrc import ErasureCodeLrc
from ceph_tpu_torch.ec.plugins.pmsr import ErasureCodePmsr
from ceph_tpu_torch.ec.state import linear_codec_from_reference


# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

PROFILES = [
    ("lrc", {"k": "4", "m": "2", "l": "3"}),     # Ceph's documented example
    ("lrc", {"k": "8", "m": "4", "l": "3"}),
    ("pmsr", {"k": "3", "m": "2"}),
]
IDS = ["lrc4/2/3", "lrc8/4/3", "pmsr3/2"]
CLASSES = {"lrc": ErasureCodeLrc, "pmsr": ErasureCodePmsr}


def _pair(plugin, profile):
    ref = RefRegistry().factory(plugin, dict(profile))
    port = CLASSES[plugin](device="cpu")
    port.init(dict(profile))
    return ref, port


def _patterns(n):
    return [(e,) for e in range(n)] + list(itertools.combinations(range(n), 2))


def _by_position(codec, data, parity):
    """Position -> (B, L) chunk of a batch."""
    full = {codec.chunk_index(i): data[:, i] for i in range(codec.k)}
    full.update({p: parity[:, r]
                 for r, p in enumerate(codec.coding_positions)})
    return full


@pytest.mark.parametrize("plugin,profile", PROFILES, ids=IDS)
def test_geometry_and_matrices_match_reference(plugin, profile):
    ref, port = _pair(plugin, profile)
    assert port.get_profile() == ref.get_profile()
    assert (port.k, port.m, port.alpha, port.get_chunk_count(),
            port.get_alignment(), port.get_chunk_size(1 << 20)) == \
        (ref.k, ref.m, ref.alpha, ref.get_chunk_count(),
         ref.get_alignment(), ref.get_chunk_size(1 << 20))
    assert port.get_chunk_mapping() == ref.get_chunk_mapping()
    assert port.coding_positions == ref.coding_positions
    assert np.array_equal(port.generator, ref.generator)
    assert np.array_equal(port.parity_matrix, ref.parity_matrix)


@pytest.mark.parametrize("plugin,profile", PROFILES, ids=IDS)
def test_repair_plans_and_matrices_match_reference(plugin, profile):
    ref, port = _pair(plugin, profile)
    n = port.get_chunk_count()
    for lost in _patterns(n):
        have = set(range(n)) - set(lost)
        plan = port.decode_plan(set(lost), have)
        assert plan == ref.decode_plan(set(lost), have), lost
        want = set(lost) | {0}
        assert port.minimum_to_decode(want, have) == \
            ref.minimum_to_decode(want, have)
        costs = {p: (3 if p % 2 else 1) for p in have}
        assert port.minimum_to_decode_with_cost(want, costs) == \
            ref.minimum_to_decode_with_cost(want, costs)
        if plan is None:
            continue
        assert np.array_equal(port.repair_matrix(*plan),
                              ref.repair_matrix(*plan)), lost
    with pytest.raises(IOError):
        port.repair_matrix((1,), (0,))


def test_pmsr_fragment_repair_matches_reference():
    ref, port = _pair("pmsr", {"k": "3", "m": "2"})
    n, a = port.get_chunk_count(), port.alpha
    rng = np.random.default_rng(3)
    raw = rng.integers(0, 256, 3 * 2 * a * 40 + 17, dtype=np.uint8).tobytes()
    chunks = port.encode(set(range(n)), raw)
    assert all(np.array_equal(chunks[i], c) for i, c in
               ref.encode(set(range(n)), raw).items())
    for lost in range(n):
        spec = port.minimum_to_repair(lost, set(range(n)) - {lost})
        assert spec == ref.minimum_to_repair(lost, set(range(n)) - {lost})
        helpers = tuple(sorted(spec))
        assert np.array_equal(port.fragment_row(lost), ref.fragment_row(lost))
        assert np.array_equal(port.aggregate_matrix(lost, helpers),
                              ref.aggregate_matrix(lost, helpers))
        frags = {h: port.fragment_for(lost, chunks[h]) for h in helpers}
        for h in helpers:
            assert np.array_equal(frags[h], ref.fragment_for(lost, chunks[h]))
        rebuilt = port.aggregate_fragments(lost, frags)
        assert np.array_equal(rebuilt, ref.aggregate_fragments(lost, frags))
        assert np.array_equal(rebuilt, chunks[lost])
    assert port.minimum_to_repair(0, {1, 2}) is None
    with pytest.raises(IOError):
        port.aggregate_matrix(0, (1, 2))


@pytest.mark.parametrize("engine", ["0", "1"], ids=["dense", "scheduled"])
@pytest.mark.parametrize("plugin,profile", PROFILES, ids=IDS)
def test_batched_encode_decode_match_reference(monkeypatch, plugin, profile,
                                               engine):
    monkeypatch.setenv("CEPH_TPU_XOR_SCHED", engine)
    ref, port = _pair(plugin, profile)
    n, k = port.get_chunk_count(), port.k
    data = np.random.default_rng(4).integers(
        0, 256, (5, k, 96 * port.alpha), dtype=np.uint8)
    before = xs.STATS.snapshot()[0]
    parity = port.encode_batch(data, out_np=True)
    assert np.array_equal(parity, np.asarray(ref.encode_batch(data,
                                                              out_np=True)))
    tparity = port.encode_batch(torch.from_numpy(data))
    assert isinstance(tparity, torch.Tensor) and tparity.device.type == "cpu"
    assert np.array_equal(tparity.numpy(), parity)
    full = _by_position(port, data, parity)
    for lost in _patterns(n)[::3]:
        plan = port.decode_plan(set(lost), set(range(n)) - set(lost))
        if plan is None:
            continue
        src, lost = plan
        extra = port.pack_decode_extra(src, lost)
        survivors = np.ascontiguousarray(np.stack([full[p] for p in src], 1))
        rec = port.decode_batch(extra, torch.from_numpy(survivors))
        assert np.array_equal(rec.numpy(), np.stack([full[p] for p in lost],
                                                    1)), lost
        assert np.array_equal(rec.numpy(), np.asarray(
            ref.decode_batch(extra, survivors, out_np=True)))
        assert port.decode_signature(extra) == ref.decode_signature(extra)
    served = xs.STATS.snapshot()[0] - before
    assert served > 0 if engine == "1" else served == 0


@pytest.mark.parametrize("plugin,profile", PROFILES, ids=IDS)
def test_per_op_encode_decode_match_reference(plugin, profile):
    ref, port = _pair(plugin, profile)
    n = port.get_chunk_count()
    raw = np.random.default_rng(5).integers(
        0, 256, port.k * 200 + 13, dtype=np.uint8).tobytes()
    enc = port.encode(set(range(n)), raw)
    want = ref.encode(set(range(n)), raw)
    assert set(enc) == set(want)
    for i in want:
        assert np.array_equal(enc[i], want[i]), i
    for lost in _patterns(n)[::4]:
        avail = {i: enc[i] for i in range(n) if i not in lost}
        try:
            expect = ref.decode(set(range(n)), avail)
        except IOError:
            with pytest.raises(IOError):
                port.decode(set(range(n)), avail)
            continue
        got = port.decode(set(range(n)), avail)
        for i in range(n):
            assert np.array_equal(got[i], expect[i]), (lost, i)
            assert np.array_equal(got[i], enc[i]), (lost, i)
    assert port.decode_concat(
        {i: enc[i] for i in range(n) if i != 0})[:len(raw)] == raw


@pytest.mark.parametrize("plugin,profile", PROFILES, ids=IDS)
def test_linear_codec_from_reference(plugin, profile):
    ref = RefRegistry().factory(plugin, dict(profile))
    extra = {}
    if plugin == "pmsr":
        extra = {"phi": ref.phi, "lambdas": ref.lambdas, "psi": ref.psi}
    port = linear_codec_from_reference(plugin, profile, ref.generator,
                                       device="cpu", **extra)
    assert np.array_equal(port.generator, ref.generator)
    assert np.array_equal(port.parity_matrix, ref.parity_matrix)
    if plugin == "pmsr":
        for name in ("phi", "lambdas", "psi"):
            assert np.array_equal(getattr(port, name), getattr(ref, name))
    data = np.random.default_rng(6).integers(
        0, 256, (3, port.k, 64 * port.alpha), dtype=np.uint8)
    assert np.array_equal(port.encode_batch(data, out_np=True),
                          np.asarray(ref.encode_batch(data, out_np=True)))
    with pytest.raises(ValueError):
        linear_codec_from_reference(plugin, profile, ref.generator[1:],
                                    device="cpu", **extra)
    with pytest.raises(ValueError):
        linear_codec_from_reference("rs", profile, ref.generator)


@pytest.mark.parametrize("plugin,profile", [
    ("lrc", {"k": "4", "m": "2"}),                        # not all of k/m/l
    ("lrc", {"k": "4", "m": "2", "l": "0"}),
    ("lrc", {"k": "4", "m": "2", "l": "4"}),              # k+m % l
    ("lrc", {"k": "3", "m": "3", "l": "3"}),              # k % groups
    ("lrc", {"k": "4", "m": "2", "l": "3", "mapping": "DD_DD_"}),
    ("lrc", {"k": "1", "m": "2", "l": "3"}),
    ("pmsr", {"k": "2", "m": "2"}),
    ("pmsr", {"k": "4", "m": "2"}),
    ("pmsr", {"k": "3", "m": "2", "d": "5"}),
    ("pmsr", {"k": "40", "m": "300"}),
])
def test_profile_checks_match_reference(plugin, profile):
    with pytest.raises(ValueError) as want:
        RefRegistry().factory(plugin, dict(profile))
    with pytest.raises(ValueError) as got:
        CLASSES[plugin](device="cpu").init(dict(profile))
    assert str(got.value) == str(want.value)


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for plugin, profile in PROFILES:
        with pytest.raises(RuntimeError, match="CUDA"):
            registry().factory(plugin, dict(profile))
        with pytest.raises(RuntimeError, match="CUDA"):
            CLASSES[plugin]()
        codec = CLASSES[plugin](device="cpu")
        codec.init(dict(profile))
        assert codec.device == torch.device("cpu")


def test_codec_init_skips_speculative_compile_of_dense_parity():
    port = ErasureCodePmsr(device="cpu")
    port.init({"k": "5", "m": "4"})
    bm = gk.bitmatrix_i8(port.parity_matrix)
    assert bm.size > xs.SPECULATIVE_MAX_CELLS
    assert xs.cached_schedule(bm) is None
    lrc = ErasureCodeLrc(device="cpu")
    lrc.init({"k": "8", "m": "4", "l": "3"})
    assert xs.cached_schedule(gk.bitmatrix_i8(lrc.parity_matrix)) is not None
