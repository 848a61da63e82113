"""The port's MeshCodec held against ceph_tpu's ``parallel/mesh_codec.py``.

The reference runs its real 8-way SPMD program on the conftest's forced
8-device CPU mesh; the port's one-card plane runs with ``device="cpu"``,
where the kernels' plain versions serve.  Encode, fused CRC, decode
(parity erasures included), RMW and the flat LRC / PMSR dialect must give
the same bytes on the same seeded inputs (tolerance 0).  The reference's
flat dialect has no fused CRC; the port's flat CRCs are held against the
reference's host CRC engine.
"""

import asyncio

import numpy as np
import pytest
import torch

from ceph_tpu.common.perf import PerfCounters as RefPerf
from ceph_tpu.ec import registry as ref_registry
from ceph_tpu.ops import crc32c_batch as ref_crc
from ceph_tpu.osd.codec_batcher import CodecBatcher as RefBatcher
from ceph_tpu.parallel.mesh_codec import MeshCodec as RefMesh
from ceph_tpu_torch.common.perf import PerfCounters
from ceph_tpu_torch.ec.plugins.cuda import ErasureCodeCuda
from ceph_tpu_torch.ec.plugins.lrc import ErasureCodeLrc
from ceph_tpu_torch.ec.plugins.pmsr import ErasureCodePmsr
from ceph_tpu_torch.ops import crc32c_batch as crc
from ceph_tpu_torch.osd.codec_batcher import CodecBatcher
from ceph_tpu_torch.parallel.mesh_codec import MeshCodec

torch.set_num_threads(1)


def run(coro):
    return asyncio.new_event_loop().run_until_complete(coro)


def _pair(k=4, m=2):
    profile = {"k": str(k), "m": str(m), "technique": "reed_sol_van"}
    port = ErasureCodeCuda("reed_sol_van", device="cpu")
    port.init(dict(profile))
    return ref_registry().factory("tpu", dict(profile)), port


def _data(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def test_pad_batch_matches_a_one_device_reference_mesh():
    mesh, one = MeshCodec(device="cpu"), RefMesh(n_devices=1)
    assert mesh.n_devices == one.n_devices == 1
    for total in (0, 1, 2, 3, 7, 8, 9, 17, 63, 64, 65, 1000):
        assert mesh.pad_batch(total) == one.pad_batch(total), total


@pytest.mark.parametrize("k,m", [(2, 1), (4, 2), (8, 3)])
def test_encode_matches_reference_mesh(k, m):
    ref, port = _pair(k, m)
    data = _data(k, (16, k, 256))
    parity = MeshCodec(device="cpu").encode(port, data)
    assert parity.shape == (16, m, 256)
    assert np.array_equal(parity, RefMesh().encode(ref, data))
    assert np.array_equal(parity, np.asarray(ref.encode_batch(data,
                                                              out_np=True)))


def test_encode_with_crc_matches_reference_mesh():
    ref, port = _pair()
    data = _data(2, (8, 4, 520))
    before = crc.PERF.get("fused_launches")
    parity, crcs = MeshCodec(device="cpu").encode(port, data, with_crc=True)
    want_parity, want_crcs = RefMesh().encode(ref, data, with_crc=True)
    assert crcs.dtype == np.uint32 and crcs.shape == (8, 6)
    assert np.array_equal(parity, want_parity)
    assert np.array_equal(crcs, np.asarray(want_crcs))
    assert crc.PERF.get("fused_launches") == before + 1
    dev_parity, dev_crcs = MeshCodec(device="cpu").encode(
        port, torch.from_numpy(data), with_crc=True, out_np=False)
    assert isinstance(dev_parity, torch.Tensor)
    assert np.array_equal(crc.to_uint32(dev_crcs), crcs)


def test_decode_matches_reference_incl_parity_erasures():
    ref, port = _pair()
    data = _data(3, (8, 4, 256))
    mesh, rmesh = MeshCodec(device="cpu"), RefMesh()
    full = np.concatenate([data, mesh.encode(port, data)], axis=1)
    for erasures in ([0, 1], [4, 5], [2, 4]):
        didx = [i for i in range(6) if i not in erasures][:4]
        rec = mesh.decode(port, erasures, full[:, didx])
        assert np.array_equal(rec, full[:, erasures]), erasures
        assert np.array_equal(rec, rmesh.decode(ref, erasures, full[:, didx]))


def test_decode_without_a_decode_table_builds_the_same_matrix():
    ref, port = _pair()

    class Bare:                        # a codec without decode_matrix_for
        k, m, device = port.k, port.m, port.device
        encode_matrix = port.encode_matrix

    data = _data(4, (4, 4, 128))
    mesh = MeshCodec(device="cpu")
    full = np.concatenate([data, mesh.encode(port, data)], axis=1)
    rec = mesh.decode(Bare(), [1, 5], full[:, [0, 2, 3, 4]])
    assert np.array_equal(rec, full[:, [1, 5]])


def test_rmw_matches_full_reencode_and_updates_in_place():
    ref, port = _pair()
    data = _data(5, (8, 4, 128))
    mesh = MeshCodec(device="cpu")
    parity = mesh.encode(port, data)
    piece = _data(6, (8, 32))
    delta = np.zeros_like(data)
    delta[:, 1, 16:48] = data[:, 1, 16:48] ^ piece
    newdata = data.copy()
    newdata[:, 1, 16:48] = piece
    kept = parity.copy()
    got = mesh.rmw(port, parity, delta)
    assert np.array_equal(parity, kept)           # host input not written
    assert np.array_equal(got, mesh.encode(port, newdata))
    assert np.array_equal(got, RefMesh().rmw(ref, parity, delta))
    old = torch.from_numpy(parity.copy())
    out = mesh.rmw(port, old, torch.from_numpy(delta), out_np=False)
    assert out.data_ptr() == old.data_ptr()       # the old parity, in place
    assert np.array_equal(old.numpy(), got)
    kept = torch.from_numpy(parity.copy())        # not donated: a copy
    out = MeshCodec(donate=False, device="cpu").rmw(
        port, kept, torch.from_numpy(delta), out_np=False)
    assert out.data_ptr() != kept.data_ptr()
    assert np.array_equal(kept.numpy(), parity)
    assert np.array_equal(out.numpy(), got)


FLAT = [("lrc", {"k": "4", "m": "2", "l": "3"}, ErasureCodeLrc),
        ("pmsr", {"k": "3", "m": "2"}, ErasureCodePmsr)]


@pytest.mark.parametrize("plugin,profile,cls", FLAT, ids=["lrc", "pmsr"])
def test_flat_dialect_matches_reference(plugin, profile, cls):
    ref = ref_registry().factory(plugin, dict(profile))
    port = cls(device="cpu")
    port.init(dict(profile))
    assert MeshCodec.supports(port) and RefMesh.supports(ref)
    mesh, rmesh = MeshCodec(device="cpu"), RefMesh()
    n, a = port.get_chunk_count(), port.alpha
    data = _data(7, (8, port.k, 32 * a))
    parity = mesh.encode(port, data)
    assert np.array_equal(parity, rmesh.encode(ref, data))
    pos = {port.chunk_index(i): data[:, i] for i in range(port.k)}
    pos.update({p: parity[:, r] for r, p in enumerate(port.coding_positions)})
    src, lost = port.decode_plan({0, n - 1}, set(range(1, n - 1)))
    extra = port.pack_decode_extra(src, lost)
    assert np.array_equal(port.decode_flat_matrix(extra),
                          ref.decode_flat_matrix(extra))
    survivors = np.ascontiguousarray(np.stack([pos[p] for p in src], 1))
    rec = mesh.decode(port, extra, survivors)
    assert np.array_equal(rec, np.stack([pos[p] for p in lost], 1))
    assert np.array_equal(rec, rmesh.decode(ref, extra, survivors))
    delta = np.zeros_like(data)
    delta[:, 0, :8] = 0x5A
    assert np.array_equal(mesh.rmw(port, parity, delta),
                          mesh.encode(port, data ^ delta))
    assert np.array_equal(mesh.rmw(port, parity, delta),
                          rmesh.rmw(ref, parity, delta))
    # the fused chunk CRCs: the reference's flat dialect has none, so they
    # are held against its host engine over the same data and coding chunks
    before = crc.PERF.get("fused_launches")
    fused_parity, crcs = mesh.encode(port, data, with_crc=True)
    assert np.array_equal(fused_parity, parity)
    want = ref_crc.crc32c_rows(np.concatenate([data, parity], 1).reshape(
        -1, data.shape[2]), backend="numpy").reshape(8, n)
    assert crcs.dtype == np.uint32 and np.array_equal(crcs, want)
    assert crc.PERF.get("fused_launches") == before + 1
    codec_parity, codec_crcs = port.encode_batch_crc(data)
    assert np.array_equal(codec_parity, parity)
    assert np.array_equal(codec_crcs, want)


def test_one_launch_per_coalesced_batch_like_the_reference():
    ref, port = _pair()
    perf, rperf = PerfCounters("ec_batch"), RefPerf("ec_batch")
    batcher = CodecBatcher(max_batch=4096, perf=perf, device="cpu")
    rbatcher = RefBatcher(max_batch=4096, perf=rperf)
    subs = [_data(10 + i, (3, 4, 64 + 32 * i)) for i in range(5)]

    async def drive(b, codec):
        return await asyncio.gather(*[b.encode(codec, s, with_crc=True)
                                      for s in subs])

    got, want = run(drive(batcher, port)), run(drive(rbatcher, ref))
    for (p, c), (rp, rc) in zip(got, want):
        assert np.array_equal(p, rp) and np.array_equal(c, np.asarray(rc))
    assert perf.get("mesh_launches") == rperf.get("mesh_launches") == 1
    assert perf.get("batches") == 1 and perf.get("mesh_fallbacks") == 0
    assert perf.get("mesh_padded_stripes") == rperf.get(
        "mesh_padded_stripes")


def test_mesh_codec_refuses_what_one_card_cannot_serve(monkeypatch):
    with pytest.raises(NotImplementedError, match="queue 1, item 5"):
        MeshCodec(n_devices=4, device="cpu")
    assert MeshCodec(n_devices=1, device="cpu").n_devices == 1

    class OnCard:
        device = torch.device("cuda", 0)

    with pytest.raises(ValueError, match="codec runs on"):
        MeshCodec(device="cpu").encode(OnCard(), np.zeros((1, 1, 8), np.uint8))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        MeshCodec()
