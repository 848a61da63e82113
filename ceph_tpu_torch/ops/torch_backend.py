"""RSMatrixCodec backend that runs the GF(2) bit-matmul kernels on a device."""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .crc32c_batch import PERF, crc32c_chunks_pair, to_uint32
from .gf2kernels import _to_device, gf_matmul_device, gf_matmul_batch_device


def gf_matmul_chunks(matrix: np.ndarray, x: torch.Tensor,
                     alpha: int = 1) -> torch.Tensor:
    """(B, k, L) chunks -> (B, r, L) chunks in one launch, on x's device:
    ``matrix`` applied to ``alpha`` sub-chunk rows of L/alpha bytes a
    chunk (the flat sub-chunk codecs; alpha=1 is the chunks
    themselves).  The reshapes are views, so a chunk and its sub-chunk
    rows are the same bytes."""
    b, k, lane = x.shape
    out = gf_matmul_batch_device(matrix,
                                 x.reshape(b, k * alpha, lane // alpha))
    return out.reshape(b, -1, lane)


def gf_matmul_chunks_crc(matrix: np.ndarray, x: torch.Tensor,
                         alpha: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """``gf_matmul_chunks`` and the (B, k+r) CRC32C registers (int64) of
    x's chunks and the result's, computed before anything crosses back
    to the host: one K4 launch over the data chunks and the fresh parity,
    on the same device tensors.  Counted once in the CRC module's
    ``PERF`` (``fused_launches``, ``fused_crcs``)."""
    out = gf_matmul_chunks(matrix, x, alpha)
    crcs = torch.cat(crc32c_chunks_pair(x, out), dim=1)
    PERF.inc("fused_launches")
    PERF.inc("fused_crcs", int(crcs.numel()))
    return out, crcs


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

    def matmul_batch_crc(self, matrix: np.ndarray, data):
        """Batched stripes (B, k, L) -> ((B, r, L) parity, (B, k+r) chunk
        CRC32Cs as np.uint32): ``gf_matmul_chunks_crc`` on the device,
        then the results to the host."""
        parity, crcs = gf_matmul_chunks_crc(matrix,
                                            _to_device(data, self.device))
        # lint: disable=device-path-host-sync -- numpy API: one post-launch hop
        return parity.cpu().numpy(), to_uint32(crcs)
