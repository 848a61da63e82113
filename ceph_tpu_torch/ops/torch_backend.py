"""RSMatrixCodec backend that runs the GF(2) bit-matmul kernels on a device."""

from __future__ import annotations

import numpy as np

from ..device import resolve_device
from .gf2kernels import gf_matmul_device, gf_matmul_batch_device


class TorchBackend:
    """Per-op and batched GF(2^8) matmuls on ``device`` (default CUDA).

    Constructing it for CUDA on a machine without a card raises; only an
    explicit ``device="cpu"`` runs the plain PyTorch versions.
    """

    name = "torch"

    def __init__(self, device=None) -> None:
        self.device = resolve_device(device)

    def matmul(self, matrix: np.ndarray, data: np.ndarray) -> np.ndarray:
        """(r,k) matrix x (k,N) bytes -> (r,N) bytes as numpy (per-op path)."""
        return gf_matmul_device(matrix, data, out_np=True, device=self.device)

    def matmul_batch(self, matrix: np.ndarray, data, out_np: bool = False):
        """(B,k,L) -> (B,r,L) in one launch; a device tensor unless out_np."""
        return gf_matmul_batch_device(matrix, data, out_np=out_np,
                                      device=self.device)
