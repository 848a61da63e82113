"""The port's host CRC32C engine (``ceph_tpu_torch/native.py``, built from
``csrc/host/crc32c.cc``) and the ladder of ``crc32c_rows`` /
``crc32c_batch`` held against ceph_tpu's native and numpy engines.

The same seeded buffers -- lengths at the 4 KiB block's edges, views that
start off an 8-byte boundary, ragged batches of bytes and of arrays, rows
cut short by ``lengths`` -- go through the reference's ``native.crc32c``
and ``crc32c_rows`` / ``crc32c_batch`` on its native and numpy backends
and through the port's on both of its.  Every CRC must be equal bit for
bit (tolerance 0).
"""

import numpy as np
import pytest

from ceph_tpu import native as ref_native
from ceph_tpu.ops import crc32c_batch as ref
from ceph_tpu_torch import native
from ceph_tpu_torch.ops import crc32c_batch as crc

LENGTHS = [0, 1, 4095, 4096, 4097]
BACKENDS = ["native", "numpy"]


def _bytes(seed: int, n: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)


@pytest.mark.parametrize("offset", [0, 3])
@pytest.mark.parametrize("length", LENGTHS)
def test_scalar_call_matches_reference(length, offset):
    buf = _bytes(length + offset, length + offset)[offset:]
    for seed in (0xFFFFFFFF, 0, 0x1234ABCD):
        want = ref_native.crc32c(buf.tobytes(), seed)
        assert native.crc32c(buf.tobytes(), seed) == want
        assert native.crc32c(memoryview(buf), seed) == want


def test_scalar_calls_are_counted():
    before = (crc.PERF.get("scalar_calls"), crc.PERF.get("scalar_bytes"))
    native.crc32c(b"x" * 100)
    assert crc.PERF.get("scalar_calls") == before[0] + 1
    assert crc.PERF.get("scalar_bytes") == before[1] + 100


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("length", LENGTHS)
def test_rows_match_reference(length, backend):
    arr = _bytes(7 + length, 5 * length).reshape(5, length)
    want = ref.crc32c_rows(arr, backend="native")
    assert np.array_equal(ref.crc32c_rows(arr, backend="numpy"), want)
    got = crc.crc32c_rows(arr, backend=backend)
    assert got.dtype == np.uint32 and np.array_equal(got, want)


@pytest.mark.parametrize("backend", BACKENDS)
def test_rows_on_a_misaligned_view_with_lengths(backend):
    base = _bytes(11, 6 * 4097 + 5)
    arr = base[5:].reshape(6, 4097)            # starts 5 bytes off
    lengths = np.array([0, 1, 4095, 4096, 4097, 2000])
    want = ref.crc32c_rows(arr, lengths=lengths, backend="native")
    got = crc.crc32c_rows(arr, lengths=lengths, backend=backend)
    assert np.array_equal(got, want)
    assert np.array_equal(got, ref.crc32c_rows(arr, lengths=lengths,
                                               backend="numpy"))
    seeded = crc.crc32c_rows(arr, lengths=lengths, seed=0, backend=backend)
    assert np.array_equal(seeded, ref.crc32c_rows(arr, lengths=lengths,
                                                  seed=0))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("kind", ["bytes", "arrays", "mixed"])
def test_ragged_batches_match_reference(kind, backend):
    """Bytes objects take the pointer table when they are big and one join
    when small; arrays and misaligned views one concatenation."""
    rng = np.random.default_rng(13)
    lens = [0, 1, 4095, 4096, 4097, 17, 3, 9000]
    arrays = [_bytes(i, n) for i, n in enumerate(lens)]
    arrays[6] = _bytes(99, 10)[1:4]             # a misaligned view
    if kind == "bytes":
        bufs = [a.tobytes() for a in arrays]
    elif kind == "arrays":
        bufs = arrays
    else:
        bufs = [a.tobytes() if rng.random() < 0.5 else a for a in arrays]
    want = ref.crc32c_batch(bufs, backend="native")
    assert np.array_equal(ref.crc32c_batch(bufs, backend="numpy"), want)
    assert np.array_equal(crc.crc32c_batch(bufs, backend=backend), want)
    small = [b"ab", b"", b"xyz" * 5]            # under 768 B a buffer
    assert np.array_equal(crc.crc32c_batch(small, backend=backend),
                          ref.crc32c_batch(small))


def test_native_counts_its_batches_and_unknown_backends_raise():
    arr = _bytes(3, 2 * 64).reshape(2, 64)
    n0, p0 = crc.PERF.get("native_batches"), crc.PERF.get("numpy_batches")
    crc.crc32c_rows(arr)
    crc.crc32c_batch([arr[0], arr[1]])
    crc.crc32c_rows(arr, backend="numpy")
    assert crc.PERF.get("native_batches") == n0 + 2
    assert crc.PERF.get("numpy_batches") == p0 + 1
    with pytest.raises(ValueError, match="backend"):
        crc.crc32c_rows(arr, backend="jax")


def test_library_is_built_once_and_a_failed_build_raises(monkeypatch,
                                                         tmp_path):
    """The library is named by its source's hash; a build that fails raises
    with the compiler's output instead of falling back to numpy."""
    path = native.library_path()
    assert native.load() is native.load() and path.exists()
    bad = tmp_path / "crc32c.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    assert native.library_path() != path
    with pytest.raises(RuntimeError, match="crc32c.cc failed"):
        native.load()
    with pytest.raises(RuntimeError, match="crc32c.cc failed"):
        crc.crc32c_rows(np.zeros((1, 8), np.uint8))
    assert np.array_equal(crc.crc32c_rows(np.zeros((1, 8), np.uint8),
                                          backend="numpy"),
                          ref.crc32c_rows(np.zeros((1, 8), np.uint8)))
