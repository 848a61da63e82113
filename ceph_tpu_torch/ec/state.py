"""Carry a codec's state across from another implementation.

A codec's state is its generator matrix (plus, for PMSR, the repair
multipliers) and its cached decode tables.  Given those as numpy arrays
(from ``ceph_tpu`` or anywhere else), the codecs built here compute with the
identical matrices.
"""

from __future__ import annotations

import numpy as np

from .linear_codec import LinearSubchunkCodec
from .plugins.cuda import ErasureCodeCuda
from .plugins.lrc import ErasureCodeLrc
from .plugins.pmsr import ErasureCodePmsr


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


def linear_codec_from_reference(plugin: str, profile: dict,
                                generator: np.ndarray, *,
                                phi: np.ndarray | None = None,
                                lambdas: np.ndarray | None = None,
                                psi: np.ndarray | None = None,
                                device=None) -> LinearSubchunkCodec:
    """An initialised ``lrc`` or ``pmsr`` codec computing with the given
    flat ``generator`` ((k+m)*alpha, k*alpha), and for ``pmsr`` with the
    given ``phi`` / ``lambdas`` / ``psi`` of its fragment algebra.

    The profile sets the geometry (k, m, l or layers, mapping); the matrices
    replace the ones the codec built, and every repair matrix is then
    derived from them.
    """
    cls = {"lrc": ErasureCodeLrc, "pmsr": ErasureCodePmsr}.get(plugin)
    if cls is None:
        raise ValueError(f"no linear codec plugin {plugin!r}")
    codec = cls(device=device)
    codec.init(dict(profile))
    generator = np.array(generator, dtype=np.uint8)
    if generator.shape != codec.generator.shape:
        raise ValueError(f"generator {generator.shape} is not "
                         f"{codec.generator.shape} for profile {profile}")
    codec.generator = generator
    codec._repair_cache.clear()
    codec.finish_setup()
    if plugin == "pmsr":
        if phi is None or lambdas is None or psi is None:
            raise ValueError("pmsr needs phi, lambdas and psi")
        codec.phi = np.array(phi, dtype=np.uint8)
        codec.lambdas = np.array(lambdas, dtype=np.uint8)
        codec.psi = np.array(psi, dtype=np.uint8)
    return codec
