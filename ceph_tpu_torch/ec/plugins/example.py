"""Trivial XOR example plugin: k=2, m=1.

Analog of the reference's in-tree example/teaching plugin
(src/test/erasure-code/ErasureCodeExample.h): parity = XOR of the two data
chunks; any single lost chunk is recoverable.  Used by registry tests.

Port of ``ceph_tpu/ec/plugins/example.py``: host code.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

from ..base import ErasureCode
from ..registry import ErasureCodePlugin


class ErasureCodeExample(ErasureCode):
    k = 2
    m = 1

    def init(self, profile) -> None:
        super().init(profile)

    def get_chunk_count(self) -> int:
        return self.k + self.m

    def get_data_chunk_count(self) -> int:
        return self.k

    def get_chunk_size(self, stripe_width: int) -> int:
        alignment = self.get_alignment()
        chunk_size = (stripe_width + self.k - 1) // self.k
        modulo = chunk_size % alignment
        if modulo:
            chunk_size += alignment - modulo
        return chunk_size

    def minimum_to_decode_with_cost(
        self, want_to_read: set[int], available: Mapping[int, int],
    ) -> set[int]:
        # prefer the cheapest 2 of the 3 chunks
        if want_to_read <= set(available):
            candidates = sorted(available, key=lambda i: (available[i], i))
            return set(candidates[:self.k])
        return self._minimum_to_decode(want_to_read, set(available))

    def encode_chunks(self, chunks: dict[int, np.ndarray]) -> None:
        chunks[2][:] = chunks[0] ^ chunks[1]

    def decode_chunks(
        self, want_to_read: set[int], chunks: Mapping[int, np.ndarray],
        decoded: dict[int, np.ndarray],
    ) -> None:
        missing = [i for i in range(3) if i not in chunks]
        if len(missing) > 1:
            raise IOError("example XOR code cannot recover >1 chunk")
        for i in missing:
            others = [j for j in range(3) if j != i]
            decoded[i][:] = decoded[others[0]] ^ decoded[others[1]]


def _factory(profile, device=None):
    # host codec: runs on the CPU whatever the caller's device
    return ErasureCodeExample()


def __erasure_code_init__(registry, name: str) -> None:
    registry.add(name, ErasureCodePlugin(_factory))
