"""Abstract erasure-code codec contract.

Systematic codes split an object into k data chunks + m coding chunks;
chunk i of a stripe lives on shard i.  Buffers are ``bytes``/``numpy.uint8``
arrays; chunk maps are ``dict[int, np.ndarray]``.  The batched entry points
of the ``cuda`` plugin take and return torch tensors.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Mapping

import numpy as np

# profile: str -> str mapping
ErasureCodeProfile = dict


class ErasureCodeInterface(ABC):
    """Codec contract.  All chunk indices are *shard* ids in [0, k+m)."""

    @abstractmethod
    def init(self, profile: ErasureCodeProfile) -> None:
        """Initialize from a profile; raises ValueError on bad profiles.

        Implementations must record the profile so get_profile() echoes it
        (the registry verifies the echo).
        """

    @abstractmethod
    def get_profile(self) -> ErasureCodeProfile:
        ...

    @abstractmethod
    def get_chunk_count(self) -> int:
        """k + m."""

    @abstractmethod
    def get_data_chunk_count(self) -> int:
        """k."""

    def get_coding_chunk_count(self) -> int:
        return self.get_chunk_count() - self.get_data_chunk_count()

    def get_sub_chunk_count(self) -> int:
        return 1

    @abstractmethod
    def get_chunk_size(self, stripe_width: int) -> int:
        """Chunk size for an object of ``stripe_width`` bytes (incl. padding)."""

    @abstractmethod
    def minimum_to_decode(
        self, want_to_read: set[int], available: set[int],
    ) -> dict[int, list[tuple[int, int]]]:
        """Chunks (and sub-chunk ranges) to retrieve to read want_to_read.

        Returns {shard: [(offset, count), ...]} in sub-chunk units.
        Raises IOError if decoding is impossible.
        """

    @abstractmethod
    def encode(
        self, want_to_encode: set[int], data: bytes,
    ) -> dict[int, np.ndarray]:
        """Split+pad ``data`` into k chunks, compute m parity chunks, return
        the requested subset."""

    @abstractmethod
    def encode_chunks(self, chunks: dict[int, np.ndarray]) -> None:
        """Compute parity in place over prepared, equal-size chunks."""

    @abstractmethod
    def decode(
        self, want_to_read: set[int], chunks: Mapping[int, np.ndarray],
        chunk_size: int = 0,
    ) -> dict[int, np.ndarray]:
        """Reconstruct the requested chunks from the available ones."""

    @abstractmethod
    def decode_chunks(
        self, want_to_read: set[int], chunks: Mapping[int, np.ndarray],
        decoded: dict[int, np.ndarray],
    ) -> None:
        ...
