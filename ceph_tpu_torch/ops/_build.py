"""Build the CUDA sources with nvcc and load them with ctypes.

A source is either ``csrc/<name>.cu`` or a generated text registered with
``add_generated`` (kernel K3 has one per XOR-schedule digest).  Each compiles,
at first use, into a shared library with a plain C interface under
``ceph_tpu_torch/build/`` (git-ignored), named by a hash of the source text,
the headers in ``csrc/`` and ``ARCH_FLAGS``, so an edited source never loads a
stale library.  Nothing is built when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import NamedTuple

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
ARCH_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_generated: dict[str, str] = {}


class Built(NamedTuple):
    log: str          # nvcc's output, with ptxas's per-kernel report
    seconds: float    # wall time of this source's nvcc


def nvcc_path() -> str:
    """The CUDA compiler under PyTorch's CUDA_HOME (from $CUDA_HOME or
    $CUDA_PATH, else nvcc on PATH, else /usr/local/cuda)."""
    from torch.utils.cpp_extension import CUDA_HOME
    nvcc = Path(CUDA_HOME or "", "bin", "nvcc")
    if CUDA_HOME is None or not nvcc.exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return str(nvcc)


def add_generated(name: str, text: str) -> None:
    """Register generated source text; ``build`` and ``library`` then take
    ``name`` like the stem of a file in ``csrc/``."""
    with _lock:
        _generated[name] = text


def _source_text(name: str) -> bytes:
    text = _generated.get(name)
    return text.encode() if text is not None else (CSRC / f"{name}.cu").read_bytes()


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256(_source_text(name))
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(ARCH_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def _source_path(name: str, lib: Path) -> Path:
    """The file nvcc compiles; a generated text is written beside its library."""
    if name not in _generated:
        return CSRC / f"{name}.cu"
    path = lib.with_suffix(".cu")
    tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    tmp.write_bytes(_source_text(name))
    os.replace(tmp, path)
    return path


def _compile(name: str) -> tuple[str, Built | str]:
    """nvcc one source into its library; (name, Built) or (name, error)."""
    out = _lib_path(name)
    src = _source_path(name, out)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [nvcc_path(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(CSRC),
           "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return name, f"nvcc {src.name} failed ({proc.returncode}):\n{proc.stdout}"
    os.replace(tmp, out)
    return name, Built(proc.stdout, seconds)


def build(names: list[str]) -> dict[str, Built]:
    """Compile the named sources that are not built yet, one nvcc each, all
    at once.

    Returns {name: Built} for the sources compiled by this call.  Raises
    RuntimeError with the compiler's output when one fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in dict.fromkeys(names) if not _lib_path(n).exists()]
    if not todo:
        return {}
    with ThreadPoolExecutor(max_workers=len(todo)) as pool:
        results = dict(pool.map(_compile, todo))
    failed = [r for r in results.values() if isinstance(r, str)]
    if failed:
        raise RuntimeError("\n".join(failed))
    return results


def library(name: str) -> ctypes.CDLL:
    """The loaded library of source ``name``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = _libs[name] = ctypes.CDLL(str(_lib_path(name)))
        return lib


def all_sources() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))
