"""The denc tagged-value codec in C: ``csrc/host/denc_value.cc``.

The wire meta of every message goes through ``Encoder.value`` /
``Decoder.value`` (``msg/message.py``), so an in-process cluster of 64
OSDs and 32 clients spends most of its one event loop there.  The
reference runs this hot path in C (its ``native/denc_value.cc``); the port
carries the same source, byte-identical in format to the Python codec in
``common/denc.py``.  It is a CPython extension: built with the host C++
compiler (``$CXX``, else ``g++``) against this interpreter's headers at
first use into ``ceph_tpu_torch/build/`` (git-ignored), named by a hash of
its text, the flags and the interpreter's version, so an edited source
never loads a stale module.  Nothing is built when the module is imported.
A failed build raises: there is no silent fallback.

This is host code, not a device kernel.
"""

from __future__ import annotations

import hashlib
import importlib.machinery
import importlib.util
import os
import subprocess
import sys
import sysconfig
import threading
from pathlib import Path

from ..native import BUILD_DIR, host_compiler

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "host" / \
    "denc_value.cc"
MODULE = "ceph_tpu_torch_denc"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

_lock = threading.Lock()
_mod = None


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    digest.update(sys.version.encode())
    return BUILD_DIR / f"{MODULE}-{digest.hexdigest()[:12]}.so"


def _build(out: Path) -> None:
    include = sysconfig.get_paths()["include"]
    if not os.path.exists(os.path.join(include, "Python.h")):
        raise RuntimeError(f"building {SOURCE.name} needs Python.h, which "
                           f"is not in {include}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run(
        [host_compiler(), *CXX_FLAGS, f"-I{include}", "-o", str(tmp),
         str(SOURCE)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SOURCE.name} failed "
                           f"({proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, out)


def load():
    """The C codec's module (``encode_value(obj) -> bytes``,
    ``decode_value(buf, offset) -> (obj, end)``), built on first use."""
    global _mod
    if _mod is not None:
        return _mod
    with _lock:
        if _mod is None:
            path = library_path()
            if not path.exists():
                _build(path)
            loader = importlib.machinery.ExtensionFileLoader(MODULE,
                                                             str(path))
            spec = importlib.util.spec_from_file_location(MODULE, path,
                                                          loader=loader)
            mod = importlib.util.module_from_spec(spec)
            loader.exec_module(mod)
            _mod = mod
    return _mod
