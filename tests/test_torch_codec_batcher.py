"""The port's CodecBatcher held against ceph_tpu's ``osd/codec_batcher.py``.

Both batchers get the same seeded submissions, concurrently; the port's
runs with ``device="cpu"`` (plain versions of the kernels), the
reference's on its CPU mesh.  Results, CRCs of ragged lanes included, must
be equal byte for byte.  Where the port differs on purpose: a mesh launch
that raises fails that batch's waiters, with no fallback.
"""

import asyncio

import numpy as np
import pytest
import torch

from ceph_tpu.ec import registry as ref_registry
from ceph_tpu.osd.codec_batcher import CodecBatcher as RefBatcher
from ceph_tpu_torch.common.perf import PerfCounters
from ceph_tpu_torch.ec.plugins.cuda import ErasureCodeCuda
from ceph_tpu_torch.ec.plugins.lrc import ErasureCodeLrc
from ceph_tpu_torch.ops.crc32c_batch import crc32c_rows
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


async def _gather(batcher, calls):
    return await asyncio.gather(*[fn(batcher) for fn in calls])


def _same(got, want):
    if isinstance(want, tuple):
        return all(_same(g, w) for g, w in zip(got, want))
    return np.array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("pipeline", [True, False], ids=["pipelined", "serial"])
def test_ragged_tails_with_stripped_crcs_match_reference(pipeline):
    ref, port = _pair()
    subs = [_data(i, (1 + i % 3, 4, 96 + 40 * i)) for i in range(6)]
    calls = [lambda b, s=s: b.encode(port if isinstance(b, CodecBatcher)
                                     else ref, s, with_crc=True) for s in subs]
    perf = PerfCounters("ec_batch")
    got = run(_gather(CodecBatcher(perf=perf, pipeline=pipeline,
                                   device="cpu"), calls))
    want = run(_gather(RefBatcher(pipeline=pipeline), calls))
    for s, (parity, crcs), w in zip(subs, got, want):
        assert parity.shape == (s.shape[0], 2, s.shape[2])
        assert crcs.dtype == np.uint32
        assert _same((parity, crcs), w)
        full = np.concatenate([s, parity], axis=1)
        host = crc32c_rows(full.reshape(-1, s.shape[2])).reshape(crcs.shape)
        assert np.array_equal(crcs, host)
    assert perf.get("batches") == 1 and perf.get("crc_fused_launches") == 1


def test_decode_and_rmw_coalesce_and_match_reference():
    ref, port = _pair()
    rng = np.random.default_rng(7)
    data = rng.integers(0, 256, (6, 4, 128), dtype=np.uint8)
    parity = np.asarray(ref.encode_batch(data, out_np=True))
    full = np.concatenate([data, parity], axis=1)
    delta = np.zeros_like(data)
    delta[:, 2, 32:64] = rng.integers(0, 256, (6, 32), dtype=np.uint8)

    def codec(b):
        return port if isinstance(b, CodecBatcher) else ref

    calls = []
    for erasures in ([0, 1], [4, 5], [1, 4]):
        didx = [i for i in range(6) if i not in erasures][:4]
        for s in (slice(0, 2), slice(2, 6)):
            calls.append(lambda b, e=erasures, x=full[s][:, didx]:
                         b.decode(codec(b), e, x))
    calls += [lambda b, s=s: b.rmw(codec(b), parity[s], delta[s])
              for s in (slice(0, 3), slice(3, 6))]
    perf = PerfCounters("ec_batch")
    got = run(_gather(CodecBatcher(perf=perf, device="cpu"), calls))
    want = run(_gather(RefBatcher(), calls))
    for g, w in zip(got, want):
        assert _same(g, w)
    for i, erasures in enumerate(([0, 1], [4, 5], [1, 4])):
        assert np.array_equal(got[2 * i], full[0:2][:, erasures])
    new_parity = np.asarray(ref.encode_batch(data ^ delta, out_np=True))
    assert np.array_equal(np.concatenate(got[-2:]), new_parity)
    # one launch per signature group: three decodes and one rmw
    assert perf.get("mesh_launches") == 4 and perf.get("mesh_rmw_launches") == 1


def test_flat_codec_crcs_take_the_host_pass():
    """The reference's flat codecs take its host CRC pass; the port's
    fuse their chunk CRCs into the one mesh launch (kernel K4 on the card)
    and must give the same CRCs, ragged tails included."""
    profile = {"k": "4", "m": "2", "l": "3"}
    ref = ref_registry().factory("lrc", dict(profile))
    port = ErasureCodeLrc(device="cpu")
    port.init(dict(profile))
    subs = [_data(20 + i, (2, 4, 64 + 32 * i)) for i in range(3)]
    calls = [lambda b, s=s: b.encode(port if isinstance(b, CodecBatcher)
                                     else ref, s, with_crc=True) for s in subs]
    perf = PerfCounters("ec_batch")
    got = run(_gather(CodecBatcher(perf=perf, device="cpu"), calls))
    want = run(_gather(RefBatcher(), calls))
    assert all(_same(g, w) for g, w in zip(got, want))
    # the reference's flat codecs take its host CRC pass; the port fuses
    # them into the mesh launch, with the same CRCs
    assert perf.get("crc_fused_launches") == 1 and perf.get("mesh_launches") == 1
    assert perf.get("crc_host_batches") == 0


def test_without_the_mesh_the_codecs_fused_crc_serves():
    ref, port = _pair()
    subs = [_data(30 + i, (2, 4, 80)) for i in range(3)]
    calls = [lambda b, s=s: b.encode(port if isinstance(b, CodecBatcher)
                                     else ref, s, with_crc=True) for s in subs]
    perf = PerfCounters("ec_batch")
    got = run(_gather(CodecBatcher(perf=perf, mesh=None, device="cpu"), calls))
    want = run(_gather(RefBatcher(mesh=None), calls))
    assert all(_same(g, w) for g, w in zip(got, want))
    assert perf.get("crc_fused_launches") == 1 and perf.get("mesh_launches") == 0


def test_a_failing_mesh_launch_fails_its_waiters_without_fallback():
    ref, port = _pair()

    class BoomMesh(MeshCodec):
        def encode(self, *a, **kw):
            raise RuntimeError("kernel launch failed")

    perf = PerfCounters("ec_batch")
    batcher = CodecBatcher(perf=perf, mesh=BoomMesh(device="cpu"),
                           device="cpu")
    subs = [_data(40 + i, (2, 4, 64)) for i in range(3)]

    async def drive():
        return await asyncio.gather(*[batcher.encode(port, s) for s in subs],
                                    return_exceptions=True)

    results = run(drive())
    assert all(isinstance(r, RuntimeError) for r in results)
    assert perf.get("mesh_fallbacks") == 0 and perf.get("batches") == 0


def test_from_config_hands_its_device_to_the_mesh():
    conf = {"osd_ec_batch_max": 8, "osd_ec_mesh_devices": 1}
    batcher = CodecBatcher.from_config(conf, device="cpu")
    assert batcher.max_batch == 8 and batcher.device == "cpu"
    ref, port = _pair()
    mesh = batcher._mesh_for(port)
    assert mesh.device == torch.device("cpu") and mesh.n_devices == 1
    assert CodecBatcher.from_config({"osd_ec_batch_enabled": False}) is None


def test_closed_batcher_launches_stragglers_solo():
    ref, port = _pair()
    batcher = CodecBatcher(device="cpu")
    batcher.close()
    s = _data(50, (2, 4, 64))
    parity, crcs = run(batcher.encode(port, s, with_crc=True))
    want_parity, want_crcs = run(RefBatcher().encode(ref, s, with_crc=True))
    assert np.array_equal(parity, want_parity)
    assert np.array_equal(crcs, np.asarray(want_crcs))
