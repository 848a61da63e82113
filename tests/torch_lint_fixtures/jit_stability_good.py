import ctypes
import functools

import torch

from ops import _build

_LIBS = {}


def _load(name):
    lib = _build.library(name)
    lib.gf2_matmul_popc.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=1)
def _lib():
    return _load("gf2_matmul")


def library(path):
    lib = _LIBS.get(path)
    if lib is None:
        lib = _LIBS[path] = ctypes.CDLL(path)
    return lib


def gf_matmul_batch_device(matrix, data: torch.Tensor):
    return _lib().gf2_matmul_popc(matrix, data.data_ptr())


def build_variants(texts):
    for name, text in texts.items():
        _build.add_generated(name, text)   # registers text only
    _build.build(list(texts))              # one build for all
