"""The port's ``StripeInfo`` (``ceph_tpu_torch/osd/ec_util.py``) against
ceph_tpu's on the same seeded objects.

The reference runs its ``tpu`` / ``lrc`` codecs through its CodecBatcher
on the JAX CPU backend; the port runs the ``cuda`` / ``lrc`` plugins with
``device="cpu"`` (the kernels' plain versions) through its batcher.  The
stripe maps, ``encode_async(with_crc=True)`` (shards and whole-shard CRCs
folded from the launch's chunk CRCs), the per-stripe drivers,
``decode_async`` for each erasure pattern and
``reconstruct_logical_async`` must agree byte for byte (tolerance 0).
"""

import asyncio

import numpy as np
import pytest
import torch

from ceph_tpu.ec import registry as ref_registry
from ceph_tpu.osd.codec_batcher import CodecBatcher as RefBatcher
from ceph_tpu.osd.ec_util import StripeInfo as RefStripeInfo
from ceph_tpu.osd.ec_util import parse_stripe_unit as ref_parse_stripe_unit
from ceph_tpu_torch.ec.plugins.cuda import ErasureCodeCuda
from ceph_tpu_torch.ec.plugins.lrc import ErasureCodeLrc
from ceph_tpu_torch.ops.crc32c_batch import crc32c_batch
from ceph_tpu_torch.osd.codec_batcher import CodecBatcher
from ceph_tpu_torch.osd.ec_util import StripeInfo, parse_stripe_unit

torch.set_num_threads(1)

RS = {"k": "4", "m": "2", "technique": "reed_sol_van"}
LRC = {"k": "4", "m": "2", "l": "3"}


def run(coro):
    return asyncio.new_event_loop().run_until_complete(coro)


def _pair(kind: str):
    if kind == "rs":
        port = ErasureCodeCuda("reed_sol_van", device="cpu")
        port.init(dict(RS))
        return ref_registry().factory("tpu", dict(RS)), port
    port = ErasureCodeLrc(device="cpu")
    port.init(dict(LRC))
    return ref_registry().factory("lrc", dict(LRC)), port


def _object(seed: int, sinfo, stripes: float) -> bytes:
    n = int(sinfo.stripe_width * stripes)
    return np.random.default_rng(seed).integers(0, 256, n,
                                                dtype=np.uint8).tobytes()


def _same_shards(got: dict, want: dict) -> bool:
    return sorted(got) == sorted(want) and all(
        np.array_equal(np.asarray(got[i]), np.asarray(want[i])) for i in want)


@pytest.mark.parametrize("kind", ["rs", "lrc"])
def test_stripe_maps_match_reference(kind):
    ref_codec, codec = _pair(kind)
    for su in (4096, 1000):
        ref_si = RefStripeInfo.for_codec(ref_codec, stripe_unit=su)
        si = StripeInfo.for_codec(codec, stripe_unit=su)
        assert (si.k, si.m, si.stripe_width, si.chunk_size) == \
            (ref_si.k, ref_si.m, ref_si.stripe_width, ref_si.chunk_size)
        for off in (0, 1, si.chunk_size, si.stripe_width - 1,
                    si.stripe_width, 5 * si.stripe_width + 17):
            for fn in ("logical_to_prev_stripe_offset",
                       "logical_to_next_stripe_offset",
                       "chunk_aligned_logical_offset_to_chunk_offset",
                       "object_size_to_shard_size"):
                assert getattr(si, fn)(off) == getattr(ref_si, fn)(off)
            assert si.offset_len_to_stripe_bounds(off, 333) == \
                ref_si.offset_len_to_stripe_bounds(off, 333)
        assert StripeInfo.data_positions(codec) == \
            RefStripeInfo.data_positions(ref_codec)
        assert StripeInfo.coding_positions(codec) == \
            RefStripeInfo.coding_positions(ref_codec)
    for value in ("4096", 4096):
        assert parse_stripe_unit(codec, value) == \
            ref_parse_stripe_unit(ref_codec, value)
    for bad in ("x", 0, -4096):
        with pytest.raises(ValueError):
            parse_stripe_unit(codec, bad)


@pytest.mark.parametrize("kind", ["rs", "lrc"])
def test_encode_with_crcs_matches_reference(kind):
    """Concurrent objects through each side's batcher: the shards, and the
    whole-shard CRCs folded from the launch's chunk CRCs, equal the
    reference's and the host engine's CRC of each shard; the per-stripe
    driver and the batcher-less path give the same bytes."""
    ref_codec, codec = _pair(kind)
    ref_si = RefStripeInfo.for_codec(ref_codec, stripe_unit=256)
    si = StripeInfo.for_codec(codec, stripe_unit=256)
    objs = [_object(i, si, s) for i, s in enumerate((1, 3, 8, 0))]

    async def drive(sinfo, codec_, batcher):
        return await asyncio.gather(*(sinfo.encode_async(
            codec_, o, batcher=batcher, with_crc=True) for o in objs))
    got = run(drive(si, codec, CodecBatcher(device="cpu")))
    want = run(drive(ref_si, ref_codec, RefBatcher()))
    for (shards, crcs), (ref_shards, ref_crcs) in zip(got, want):
        assert _same_shards(shards, ref_shards)
        assert crcs == {i: int(c) for i, c in ref_crcs.items()}
        ids = sorted(shards)
        assert [crcs[i] for i in ids] == [
            int(c) for c in crc32c_batch([shards[i] for i in ids])]
    # the per-stripe driver and the path without a batcher
    for o, (shards, crcs) in zip(objs[:2], got[:2]):
        assert _same_shards(si.encode(codec, o), shards)
        plain, plain_crcs = run(si.encode_async(codec, o, with_crc=True))
        assert _same_shards(plain, shards) and plain_crcs == crcs
        assert _same_shards(run(si.encode_async(
            codec, o, batcher=CodecBatcher(device="cpu"))), shards)


ERASURES = {"rs": [(0,), (3,), (1, 4), (0, 5)],
            "lrc": [(0,), (2,), (1, 7)]}


@pytest.mark.parametrize("kind", ["rs", "lrc"])
def test_decode_and_reconstruct_match_reference(kind):
    """Every erasure pattern, objects submitted concurrently so their
    decodes share launches: the decoded shards equal the reference's and
    the originals, and the logical bytes equal the source."""
    ref_codec, codec = _pair(kind)
    ref_si = RefStripeInfo.for_codec(ref_codec, stripe_unit=256)
    si = StripeInfo.for_codec(codec, stripe_unit=256)
    objs = [_object(10 + i, si, s) for i, s in enumerate((2, 5))]
    encoded = [si.encode(codec, o) for o in objs]
    n = si.k + si.m
    for erasures in ERASURES[kind]:
        avail = [{i: s for i, s in sh.items() if i not in erasures}
                 for sh in encoded]
        want_ids = set(range(n))

        async def drive(sinfo, codec_, batcher):
            dec = await asyncio.gather(*(sinfo.decode_async(
                codec_, a, want=want_ids, batcher=batcher) for a in avail))
            logical = await asyncio.gather(*(
                sinfo.reconstruct_logical_async(codec_, a, batcher=batcher)
                for a in avail))
            return dec, logical
        dec, logical = run(drive(si, codec, CodecBatcher(device="cpu")))
        ref_dec, ref_logical = run(drive(ref_si, ref_codec, RefBatcher()))
        for d, rd, sh in zip(dec, ref_dec, encoded):
            assert _same_shards(d, rd) and _same_shards(d, sh), erasures
        assert logical == ref_logical == objs, erasures
        assert si.reconstruct_logical(codec, avail[0]) == objs[0]
