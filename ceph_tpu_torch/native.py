"""The host CRC32C engine: ``csrc/host/crc32c.cc`` through ctypes.

Port of the CRC half of ``ceph_tpu/native.py``.  The source (SSE4.2
``crc32`` instructions where the CPU has them, sliced tables otherwise) is
compiled with the host C++ compiler (``$CXX``, else ``g++``) at first use
into ``ceph_tpu_torch/build/`` (git-ignored), named by a hash of its text
and the flags, so an edited source never loads a stale library.  Nothing is
built when the module is imported.  A failed build raises: there is no
silent fallback; only an explicit ``backend="numpy"`` in
``ops/crc32c_batch.py`` takes the numpy engine.

This is host code, not a device kernel.  BlockStore checksums every 4 KiB
block it writes and verifies each on every read through it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG / "csrc" / "host" / "crc32c.cc"
BUILD_DIR = _PKG / "build"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def host_compiler() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise RuntimeError("no host C++ compiler: set CXX or put g++ on PATH")
    return cxx


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libcrc32c_host-{digest.hexdigest()[:12]}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run(
        [host_compiler(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SOURCE.name} failed "
                           f"({proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, out)


def load() -> ctypes.CDLL:
    """The host engine's library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            u8p, u32p = ctypes.POINTER(ctypes.c_uint8), \
                ctypes.POINTER(ctypes.c_uint32)
            u64p = ctypes.POINTER(ctypes.c_uint64)
            lib.ceph_crc32c.restype = ctypes.c_uint32
            lib.ceph_crc32c.argtypes = [ctypes.c_uint32, u8p, ctypes.c_size_t]
            lib.ceph_crc32c_batch.restype = None
            lib.ceph_crc32c_batch.argtypes = [u32p, u8p, u64p, u64p,
                                              ctypes.c_int]
            lib.ceph_crc32c_batch_ptrs.restype = None
            lib.ceph_crc32c_batch_ptrs.argtypes = [
                u32p, ctypes.POINTER(ctypes.c_char_p), u64p, ctypes.c_int]
            _lib = lib
        return _lib


def _count_scalar(nbytes: int) -> None:
    """Every per-buffer call counts against the batched pipeline's
    "integrity" set, so a perf dump shows which paths skip the batched
    API."""
    from .ops.crc32c_batch import PERF
    PERF.inc("scalar_calls")
    PERF.inc("scalar_bytes", nbytes)


def crc32c(data, crc: int = 0xFFFFFFFF) -> int:
    """CRC32-C of one buffer from ``crc`` (default the common -1 seed),
    raw register (no final XOR)."""
    buf = np.frombuffer(data, dtype=np.uint8)
    _count_scalar(buf.size)
    lib = load()
    if buf.size == 0:
        return crc
    return int(lib.ceph_crc32c(
        ctypes.c_uint32(crc),
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), buf.size))


def crc32c_batch_native(crcs: np.ndarray, flat: np.ndarray,
                        offsets: np.ndarray, lens: np.ndarray) -> None:
    """One library call checksumming ``len(crcs)`` buffers laid out in
    ``flat`` (buffer i at ``offsets[i]``, ``lens[i]`` bytes); ``crcs``
    carries seeds in and results out, in place."""
    assert crcs.dtype == np.uint32 and crcs.flags.c_contiguous
    assert flat.dtype == np.uint8 and flat.flags.c_contiguous
    u64p = ctypes.POINTER(ctypes.c_uint64)
    offsets = np.ascontiguousarray(offsets, np.uint64)
    lens = np.ascontiguousarray(lens, np.uint64)
    load().ceph_crc32c_batch(
        crcs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        offsets.ctypes.data_as(u64p), lens.ctypes.data_as(u64p), len(crcs))


def crc32c_batch_native_ptrs(crcs: np.ndarray, bufs: list,
                             lens: np.ndarray) -> None:
    """Scattered-buffer variant of :func:`crc32c_batch_native`: one
    library call over a pointer table built straight from the ``bytes``
    objects in ``bufs`` (borrowed for the call), with no concatenation."""
    assert crcs.dtype == np.uint32 and crcs.flags.c_contiguous
    ptrs = (ctypes.c_char_p * len(bufs))(*bufs)
    lens = np.ascontiguousarray(lens, np.uint64)
    load().ceph_crc32c_batch_ptrs(
        crcs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), ptrs,
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), len(bufs))
