"""Carry a codec's state across from another implementation.

A codec's state is its generator matrix and its cached decode tables.  Given
those as numpy arrays (from ``ceph_tpu`` or anywhere else), the ``cuda``
codec built here computes with the identical matrices.
"""

from __future__ import annotations

import numpy as np

from .plugins.cuda import ErasureCodeCuda


def codec_from_reference(encode_matrix: np.ndarray, k: int, m: int,
                         technique: str,
                         decode_tables: dict | None = None,
                         device=None) -> ErasureCodeCuda:
    """An initialised ``ErasureCodeCuda`` using the given matrices.

    ``encode_matrix`` is the (k+m, k) generator; ``decode_tables`` maps an
    erasure signature to ``(decode_matrix, decode_index)``.
    """
    encode_matrix = np.array(encode_matrix, dtype=np.uint8)
    if encode_matrix.shape != (k + m, k):
        raise ValueError(f"encode_matrix {encode_matrix.shape} is not "
                         f"({k + m}, {k})")
    codec = ErasureCodeCuda(technique, device=device)
    codec.init({"k": str(k), "m": str(m), "technique": technique})
    codec.encode_matrix = encode_matrix
    for signature, (matrix, decode_index) in (decode_tables or {}).items():
        codec.tcache.put(signature, np.array(matrix, dtype=np.uint8),
                         list(decode_index))
    return codec
