"""The port's erasure-code layer held against ceph_tpu's plugins.

``ErasureCodeCuda(device="cpu")`` runs the plain PyTorch versions of the
kernels; every output must equal the ``ceph_tpu`` ``tpu`` and ``isa``
plugins' byte for byte on the same seeded inputs.
"""

import re

import numpy as np
import pytest
import torch

from ceph_tpu.ec import ErasureCodePluginRegistry as RefRegistry
from ceph_tpu_torch.device import resolve_device
from ceph_tpu_torch.ec import ErasureCodePluginRegistry, registry
from ceph_tpu_torch.ec.plugins.cuda import ErasureCodeCuda
from ceph_tpu_torch.ec.state import codec_from_reference
from ceph_tpu_torch.ops.torch_backend import TorchBackend
from ceph_tpu_torch.tools import ec_bench


# one intra-op thread: the suite runs in several worker processes at once,
# some of which time CPU work
torch.set_num_threads(1)

def _cuda_codec(profile):
    codec = ErasureCodeCuda(profile.get("technique", "reed_sol_van"),
                            device="cpu")
    codec.init(dict(profile))
    return codec


@pytest.mark.parametrize("technique,k,m", [("reed_sol_van", 8, 3),
                                           ("cauchy", 10, 4)])
def test_cuda_plugin_matches_tpu_and_isa(technique, k, m):
    profile = {"k": str(k), "m": str(m), "technique": technique}
    ref = RefRegistry()
    tpu = ref.factory("tpu", dict(profile))
    isa = ref.factory("isa", dict(profile))
    port = _cuda_codec(profile)
    port_isa = ErasureCodePluginRegistry().factory("isa", dict(profile))
    assert np.array_equal(port.encode_matrix, tpu.encode_matrix)
    rng = np.random.default_rng(10)
    data = rng.integers(0, 256, size=k * 512 + 31, dtype=np.uint8).tobytes()
    n = k + m
    enc = port.encode(set(range(n)), data)
    for other in (tpu.encode(set(range(n)), data),
                  isa.encode(set(range(n)), data),
                  port_isa.encode(set(range(n)), data)):
        assert set(enc) == set(other)
        for i in other:
            assert np.array_equal(enc[i], other[i]), i
    avail = {i: enc[i] for i in range(n) if i not in (1, k)}
    dec = port.decode(set(range(n)), avail)
    dec_tpu = tpu.decode(set(range(n)), avail)
    for i in range(n):
        assert np.array_equal(dec[i], enc[i]) and np.array_equal(dec[i],
                                                                 dec_tpu[i])
    assert port.decode_concat(avail)[:len(data)] == data


@pytest.mark.parametrize("technique,k,m,b,l,erasures", [
    ("reed_sol_van", 8, 3, 32, 128, [0, 9]),
    ("reed_sol_van", 8, 3, 6, 100, [1, 9]),
    ("cauchy", 10, 4, 4, 256, [2, 11]),
])
def test_batch_roundtrip_through_codec_from_reference(technique, k, m, b, l,
                                                      erasures):
    profile = {"k": str(k), "m": str(m), "technique": technique}
    tpu = RefRegistry().factory("tpu", profile)
    tpu.decode_matrix_for(erasures)
    tables = {sig: (np.asarray(mat), list(idx))
              for sig, (mat, idx) in tpu.tcache._lru.items()}
    port = codec_from_reference(np.asarray(tpu.encode_matrix), k, m,
                                technique, decode_tables=tables,
                                device="cpu")
    data = np.random.default_rng(11).integers(0, 256, (b, k, l),
                                              dtype=np.uint8)
    parity = port.encode_batch(data, out_np=True)
    assert np.array_equal(parity, np.asarray(tpu.encode_batch(data,
                                                              out_np=True)))
    full = np.concatenate([data, parity], axis=1)
    decode_index = [i for i in range(k + m) if i not in erasures][:k]
    survivors = torch.from_numpy(np.ascontiguousarray(full[:, decode_index]))
    hits = port.tcache.hits
    rec = port.decode_batch(erasures, survivors)
    assert port.tcache.hits == hits + 1          # served from the handed-over table
    assert isinstance(rec, torch.Tensor)
    assert np.array_equal(rec.numpy(), full[:, erasures])
    assert np.array_equal(
        rec.numpy(), np.asarray(tpu.decode_batch(erasures, survivors.numpy(),
                                                 out_np=True)))
    assert port.decode_signature(erasures) == tpu.decode_signature(erasures)
    assert np.array_equal(port.decode_matrix_for(erasures),
                          tpu.decode_matrix_for(erasures))


def test_codec_from_reference_checks_shape():
    with pytest.raises(ValueError):
        codec_from_reference(np.zeros((10, 8), np.uint8), 8, 3,
                             "reed_sol_van", device="cpu")


@pytest.mark.parametrize("size", [1, 31, 255, 256, 4096 + 7, 8 * 1024])
def test_encode_prepare_and_chunking_match_reference(size):
    profile = {"k": "8", "m": "3"}
    ref = RefRegistry().factory("isa", dict(profile))
    port = ErasureCodePluginRegistry().factory("isa", dict(profile))
    raw = np.random.default_rng(size).integers(0, 256, size,
                                               dtype=np.uint8).tobytes()
    assert port.get_chunk_size(size) == ref.get_chunk_size(size)
    want = ref.encode_prepare(raw)
    got = port.encode_prepare(raw)
    assert set(got) == set(want)
    for i in want:
        assert np.array_equal(got[i], want[i]), i
    for want_read, avail in [({0, 1}, {0, 1, 2}), ({3}, {0, 1, 2, 4, 5, 6, 7,
                                                         8, 9, 10})]:
        assert port.minimum_to_decode(want_read, avail) == \
            ref.minimum_to_decode(want_read, avail)
    with pytest.raises(IOError):
        port.minimum_to_decode({0}, {1, 2, 3})


def test_registry_loads_plugins_and_checks_profiles():
    reg = ErasureCodePluginRegistry()
    codec = reg.factory("isa", {"k": "4", "m": "2", "technique": "cauchy"})
    assert codec.get_profile()["technique"] == "cauchy"
    assert codec.get_chunk_count() == 6
    with pytest.raises(FileNotFoundError):
        reg.factory("no_such_plugin", {})
    with pytest.raises(ValueError):
        reg.factory("isa", {"k": "33", "m": "2"})
    with pytest.raises(ValueError):
        reg.factory("isa", {"technique": "liberation"})
    with pytest.raises(ValueError):
        reg.add("isa", reg.get("isa"))
    assert registry() is registry()


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: TorchBackend(), lambda: ErasureCodeCuda(),
                 lambda: ErasureCodePluginRegistry().factory(
                     "cuda", {"k": "8", "m": "3"}),
                 lambda: codec_from_reference(np.zeros((11, 8), np.uint8),
                                              8, 3, "reed_sol_van")):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    assert resolve_device("cpu") == torch.device("cpu")
    assert TorchBackend("cpu").device == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


@pytest.mark.parametrize("argv", [
    ["--plugin", "isa", "-P", "k=8", "-P", "m=3", "-s", "65536", "-i", "2"],
    ["--plugin", "isa", "-k", "4", "-m", "2", "-s", "4096", "-i", "3",
     "-w", "decode", "-e", "2", "--erasures-generation", "exhaustive"],
])
def test_ec_bench_cli_prints_seconds_and_kib(capsys, argv):
    assert ec_bench.main(argv) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and re.fullmatch(r"\d+\.\d{6}\t\d+", out[0]), out
    size, iters = int(argv[argv.index("-s") + 1]), int(argv[argv.index("-i") + 1])
    assert int(out[0].split("\t")[1]) == size * iters // 1024


def test_ec_bench_batch_mode_on_cpu():
    codec = _cuda_codec({"k": "8", "m": "3"})
    elapsed, kib = ec_bench.run_encode(codec, 8 * 1024, 2, batch=4)
    assert elapsed > 0 and kib == 4 * 8 * 1024 * 2 // 1024
    ec_bench._block(torch.zeros(3))          # CPU tensor: nothing to wait for
