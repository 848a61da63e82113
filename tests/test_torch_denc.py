"""The port's C tagged-value codec (``csrc/host/denc_value.cc``, built by
``common/denc_native.py``) against the Python bodies of the port and of
``ceph_tpu`` on the same seeded values: byte-identical encodings, equal
decodes, the same refusals.  Exactness is the tolerance."""

import random

import pytest

from ceph_tpu.common import denc as ref_denc
from ceph_tpu_torch.common import denc, denc_native


def random_value(rnd: random.Random, depth: int = 0):
    kinds = ["none", "bool", "int", "float", "str", "bytes"]
    if depth < 4:
        kinds += ["list", "dict"] * 2
    kind = rnd.choice(kinds)
    if kind == "none":
        return None
    if kind == "bool":
        return rnd.random() < 0.5
    if kind == "int":
        return rnd.choice([0, -1, 2**63 - 1, -2**63, 2**63, -2**64 - 5,
                           rnd.randrange(-2**40, 2**40)])
    if kind == "float":
        return rnd.choice([0.0, -1.5, 1e300, rnd.random()])
    if kind == "str":
        return "".join(rnd.choice("abcé€\u0000z") for _ in range(
            rnd.randrange(12)))
    if kind == "bytes":
        return bytes(rnd.randrange(256) for _ in range(rnd.randrange(40)))
    if kind == "list":
        return [random_value(rnd, depth + 1)
                for _ in range(rnd.randrange(5))]
    return {f"k{rnd.randrange(100)}": random_value(rnd, depth + 1)
            for _ in range(rnd.randrange(5))}


def python_bytes(module, v) -> bytes:
    enc = module.Encoder()
    enc._value_py(v)
    return bytes(enc.buf)


@pytest.mark.parametrize("seed", range(4))
def test_c_codec_equals_the_python_bodies(seed):
    rnd = random.Random(seed)
    for _ in range(200):
        v = random_value(rnd)
        enc = denc.Encoder()
        enc.value(v)
        got = bytes(enc.buf)
        assert got == python_bytes(denc, v) == python_bytes(ref_denc, v)
        dec = denc.Decoder(got + b"tail")
        assert dec.value() == v and dec.pos == len(got)
        assert ref_denc.Decoder(got)._value_py() == v
    # tuples become lists and int keys strings, as JSON would have it
    enc = denc.Encoder()
    enc.value({1: (2, 3)})
    assert denc.Decoder(bytes(enc.buf)).value() == {"1": [2, 3]}


def test_c_codec_refusals():
    """Too deep, a bad tag, a value past its envelope: DencError, as the
    Python body raises; a type JSON cannot carry raises either way."""
    deep = []
    for _ in range(205):
        deep = [deep]
    with pytest.raises(denc.DencError, match="deep"):
        denc.Encoder().value(deep)
    with pytest.raises(denc.DencError):
        denc.Decoder(b"\x63").value()
    enc = denc.Encoder()
    enc.value("abcdef")
    dec = denc.Decoder(bytes(enc.buf))
    dec._ends.append(4)
    with pytest.raises(denc.DencError, match="envelope"):
        dec.value()
    with pytest.raises(denc.DencError):
        denc.Encoder().value({"x": object()})
    with pytest.raises(denc.DencError):
        denc.Encoder()._value_py({"x": object()})


def test_the_codec_is_built_once_and_named_by_its_source():
    mod = denc_native.load()
    assert denc_native.load() is mod
    path = denc_native.library_path()
    assert path.exists() and path.parent == denc_native.BUILD_DIR
    assert mod.encode_value(None) == b"\x00"
