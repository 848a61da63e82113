import ctypes

import torch

from ops import _build


def load_all(names):
    return [ctypes.CDLL(f"lib{n}.so") for n in names]


def _load(name):
    lib = _build.library(name)
    lib.gf2_matmul_popc.restype = ctypes.c_int
    return lib


def gf_matmul_batch_device(matrix, data: torch.Tensor):
    lib = _load("gf2_matmul")              # a load per launch
    return lib.gf2_matmul_popc(matrix, data.data_ptr())


def build_each(names):
    for n in names:
        _build.build([n])                  # one nvcc step per source
