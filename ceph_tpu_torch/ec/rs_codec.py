"""Reed-Solomon matrix codec shared by the isa and cuda plugins.

The codec owns the generator matrix and the decode-matrix LRU cache; the
byte crunching is delegated to a backend:

  * ``NumpyBackend`` -- host path and parity oracle,
  * ``ceph_tpu_torch.ops.torch_backend.TorchBackend`` -- the CUDA kernels.

Both produce byte-identical chunks.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Mapping

import numpy as np

from ..gf import gf_matmul, build_decode_matrix, erasure_signature
from ..gf.matrices import decode_index_for
from .base import ErasureCode


class NumpyBackend:
    """Plain host GF(2^8) matmul backend."""

    name = "numpy"

    def matmul(self, matrix: np.ndarray, data: np.ndarray) -> np.ndarray:
        """(r,k) GF coeff matrix x (k,n) byte rows -> (r,n) byte rows."""
        return gf_matmul(matrix, data)


class DecodeTableCache:
    """LRU of decode matrices keyed by erasure signature."""

    def __init__(self, maxsize: int = 256) -> None:
        self.maxsize = maxsize
        self._lru: OrderedDict[str, tuple[np.ndarray, list[int]]] = OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, signature: str):
        entry = self._lru.get(signature)
        if entry is not None:
            self.hits += 1
            self._lru.move_to_end(signature)
        else:
            self.misses += 1
        return entry

    def put(self, signature: str, matrix: np.ndarray,
            decode_index: list[int]) -> None:
        self._lru[signature] = (matrix, decode_index)
        self._lru.move_to_end(signature)
        while len(self._lru) > self.maxsize:
            self._lru.popitem(last=False)


class RSMatrixCodec(ErasureCode):
    """Systematic (k+m, k) matrix code over GF(2^8).

    Subclasses set self.k, self.m, and build self.encode_matrix in
    prepare(); encode/decode flow through the backend.
    """

    def __init__(self, backend=None) -> None:
        super().__init__()
        self.k = 0
        self.m = 0
        self.encode_matrix: np.ndarray | None = None
        self.backend = backend or NumpyBackend()
        self.tcache = DecodeTableCache()

    def get_chunk_count(self) -> int:
        return self.k + self.m

    def get_data_chunk_count(self) -> int:
        return self.k

    def encode_chunks(self, chunks: dict[int, np.ndarray]) -> None:
        k, m = self.k, self.m
        data = np.stack([chunks[self.chunk_index(i)] for i in range(k)])
        parity = self.backend.matmul(self.encode_matrix[k:], data)
        for r in range(m):
            chunks[self.chunk_index(k + r)][:] = parity[r]

    def decode_signature(self, erasures) -> str:
        """DecodeTableCache key for an erasure pattern."""
        return erasure_signature(
            decode_index_for(self.k, set(erasures)), list(erasures))

    def decode_entry(self, erasures) -> tuple[np.ndarray, list[int]]:
        """(decode matrix, decode_index) for an erasure pattern, cached."""
        signature = self.decode_signature(erasures)
        entry = self.tcache.get(signature)
        if entry is None:
            entry = self._build_decode_matrix(list(erasures))
            self.tcache.put(signature, *entry)
        return entry

    def _build_decode_matrix(self, erasures: list[int]):
        """Decode-matrix construction hook: wider-field codecs (the
        jerasure w=16/32 word techniques) override the field while the
        driver above stays shared."""
        return build_decode_matrix(self.encode_matrix, self.k, erasures)

    def decode_chunks(
        self, want_to_read: set[int], chunks: Mapping[int, np.ndarray],
        decoded: dict[int, np.ndarray],
    ) -> None:
        k, m = self.k, self.m
        erasures = [i for i in range(k + m) if i not in chunks]
        if len(erasures) > m:
            raise IOError(f"{len(erasures)} erasures exceed m={m}")
        if not erasures:
            return
        matrix, decode_index = self.decode_entry(erasures)
        sources = np.stack([decoded[i] for i in decode_index])
        recovered = self.backend.matmul(matrix, sources)
        for p, e in enumerate(erasures):
            decoded[e][:] = recovered[p]
