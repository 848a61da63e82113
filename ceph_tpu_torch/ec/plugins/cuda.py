"""The ``cuda`` erasure-code plugin: ISA-semantics RS/Cauchy on the CUDA card.

Parity bytes are identical to the ``isa`` plugin (same generator matrices,
same GF(2^8) field); only the execution engine differs: the per-op path and
the batched entry points run the GF(2) bit-matmul kernels of
``ceph_tpu_torch/ops/gf2kernels.py``.
"""

from __future__ import annotations

import numpy as np

from .isa import ErasureCodeIsa, K_VANDERMONDE
from ..registry import ErasureCodePlugin
from ...ops.torch_backend import TorchBackend


class ErasureCodeCuda(ErasureCodeIsa):
    def __init__(self, technique: str = K_VANDERMONDE, device=None) -> None:
        super().__init__(technique=technique, backend=TorchBackend(device))

    @property
    def device(self):
        return self.backend.device

    def encode_batch(self, data, out_np: bool = False):
        """(B, k, L) data chunks -> (B, m, L) parity chunks, one launch."""
        return self.backend.matmul_batch(
            self.encode_matrix[self.k:], data, out_np=out_np)

    def encode_batch_crc(self, data):
        """encode_batch plus device-fused integrity: ((B, m, L) parity,
        (B, k+m) chunk CRC32Cs) from one device round trip, the CRCs by
        K4 over the data and the fresh parity on the card."""
        return self.backend.matmul_batch_crc(
            self.encode_matrix[self.k:], data)

    def decode_batch(self, erasures: list[int], chunks, out_np: bool = False):
        """Recover ``erasures`` for a batch.

        ``chunks`` is (B, k, L): for every stripe, the k surviving chunks in
        decode_index order (first k surviving shard ids ascending).
        """
        matrix = self.decode_matrix_for(erasures)
        return self.backend.matmul_batch(matrix, chunks, out_np=out_np)

    def decode_matrix_for(self, erasures) -> np.ndarray:
        """The decode matrix an erasure pattern selects, through the
        DecodeTableCache shared with the per-op decode path."""
        return self.decode_entry(erasures)[0]


def _factory(profile, device=None):
    return ErasureCodeCuda(profile.get("technique", K_VANDERMONDE), device)


def __erasure_code_init__(registry, name: str) -> None:
    registry.add(name, ErasureCodePlugin(_factory))
