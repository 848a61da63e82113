"""Shared erasure-code implementation: profile parsing, chunk preparation.

``encode_prepare``'s zero-pad + aligned chunking and the default
minimum_to_decode are part of the byte-parity contract with ``ceph_tpu``.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

from .interface import ErasureCodeInterface, ErasureCodeProfile

SIMD_ALIGN = 32


class ErasureCode(ErasureCodeInterface):
    def __init__(self) -> None:
        self._profile: ErasureCodeProfile = {}
        self.chunk_mapping: list[int] = []

    # -- profile helpers ----------------------------------------------------
    def to_int(self, name: str, profile: Mapping[str, str], default: str) -> int:
        v = profile.get(name, default)
        if v == "":
            v = default
        try:
            return int(v)
        except (TypeError, ValueError):
            raise ValueError(f"{name}={v!r} is not an integer")

    def to_string(self, name: str, profile: Mapping[str, str], default: str) -> str:
        return str(profile.get(name, default))

    def parse(self, profile: ErasureCodeProfile) -> None:
        self._to_mapping(profile)

    def _to_mapping(self, profile: ErasureCodeProfile) -> None:
        # "mapping" remaps pseudo-chunks: 'D' positions host data chunks in
        # order, the rest host coding chunks
        mapping = profile.get("mapping")
        if mapping:
            data_pos = [i for i, c in enumerate(mapping) if c == "D"]
            coding_pos = [i for i, c in enumerate(mapping) if c != "D"]
            self.chunk_mapping = data_pos + coding_pos

    def init(self, profile: ErasureCodeProfile) -> None:
        self._profile = dict(profile)

    def get_profile(self) -> ErasureCodeProfile:
        return self._profile

    @staticmethod
    def sanity_check_k_m(k: int, m: int) -> None:
        if k < 2:
            raise ValueError(f"k={k} must be >= 2")
        if m < 1:
            raise ValueError(f"m={m} must be >= 1")

    def chunk_index(self, i: int) -> int:
        return self.chunk_mapping[i] if len(self.chunk_mapping) > i else i

    def get_chunk_mapping(self) -> list[int]:
        return self.chunk_mapping

    # -- minimum_to_decode --------------------------------------------------
    def _minimum_to_decode(
        self, want_to_read: set[int], available_chunks: set[int],
    ) -> set[int]:
        if want_to_read <= available_chunks:
            return set(want_to_read)
        k = self.get_data_chunk_count()
        if len(available_chunks) < k:
            raise IOError(
                f"cannot decode: {len(available_chunks)} < k={k} available")
        return set(sorted(available_chunks)[:k])

    def minimum_to_decode(
        self, want_to_read: set[int], available: set[int],
    ) -> dict[int, list[tuple[int, int]]]:
        minimum = self._minimum_to_decode(want_to_read, available)
        sub = [(0, self.get_sub_chunk_count())]
        return {shard: list(sub) for shard in sorted(minimum)}

    def minimum_to_decode_with_cost(
        self, want_to_read: set[int], available: Mapping[int, int],
    ) -> set[int]:
        """Cheapest feasible read set under per-chunk retrieval costs.

        Costs are grown tier by tier (cheapest first) and the first feasible
        candidate set wins; ``_minimum_to_decode`` picks the reads within it,
        so a subclass's selection policy (LRC's locality preference) composes
        with the cost order.  With uniform costs this is
        ``_minimum_to_decode`` over everything available.
        """
        want = set(want_to_read)
        order = sorted(available, key=lambda s: (available[s], s))
        cand: set[int] = set()
        i = 0
        while i < len(order):
            cost = available[order[i]]
            while i < len(order) and available[order[i]] == cost:
                cand.add(order[i])
                i += 1
            if i < len(order):      # more tiers left: probe this one
                try:
                    return self._minimum_to_decode(want, set(cand))
                except (IOError, OSError, ValueError):
                    continue
        # last tier = everything available; let its error propagate
        return self._minimum_to_decode(want, set(available))

    # -- encode/decode ------------------------------------------------------
    def get_chunk_size(self, stripe_width: int) -> int:
        # ceil(stripe / k) rounded up to the alignment
        k = self.get_data_chunk_count()
        alignment = self.get_alignment()
        chunk_size = (stripe_width + k - 1) // k
        modulo = chunk_size % alignment
        if modulo:
            chunk_size += alignment - modulo
        return chunk_size

    def get_alignment(self) -> int:
        return SIMD_ALIGN

    def encode_prepare(self, raw: bytes) -> dict[int, np.ndarray]:
        """Slice ``raw`` into k zero-padded chunks + m zeroed parity chunks.

        Chunks k - padded_chunks .. k-1 are zero-filled beyond the data;
        parity buffers are allocated at blocksize.
        """
        k = self.get_data_chunk_count()
        m = self.get_coding_chunk_count()
        raw = np.frombuffer(raw, dtype=np.uint8) if not isinstance(
            raw, np.ndarray) else raw.view(np.uint8)
        blocksize = self.get_chunk_size(len(raw))
        padded_chunks = k - len(raw) // blocksize
        encoded: dict[int, np.ndarray] = {}
        for i in range(k - padded_chunks):
            encoded[self.chunk_index(i)] = np.array(
                raw[i * blocksize:(i + 1) * blocksize], dtype=np.uint8)
        if padded_chunks:
            remainder = len(raw) - (k - padded_chunks) * blocksize
            buf = np.zeros(blocksize, dtype=np.uint8)
            buf[:remainder] = raw[(k - padded_chunks) * blocksize:]
            encoded[self.chunk_index(k - padded_chunks)] = buf
            for i in range(k - padded_chunks + 1, k):
                encoded[self.chunk_index(i)] = np.zeros(blocksize, np.uint8)
        for i in range(k, k + m):
            encoded[self.chunk_index(i)] = np.zeros(blocksize, np.uint8)
        return encoded

    def encode(
        self, want_to_encode: set[int], data: bytes,
    ) -> dict[int, np.ndarray]:
        encoded = self.encode_prepare(data)
        self.encode_chunks(encoded)
        return {i: buf for i, buf in encoded.items() if i in want_to_encode}

    def _decode(
        self, want_to_read: set[int], chunks: Mapping[int, np.ndarray],
    ) -> dict[int, np.ndarray]:
        have = set(chunks)
        if want_to_read <= have:
            return {i: np.asarray(chunks[i], dtype=np.uint8)
                    for i in want_to_read}
        k = self.get_data_chunk_count()
        m = self.get_coding_chunk_count()
        blocksize = len(next(iter(chunks.values())))
        decoded: dict[int, np.ndarray] = {}
        for i in range(k + m):
            if i in chunks:
                decoded[i] = np.array(chunks[i], dtype=np.uint8)
            else:
                decoded[i] = np.zeros(blocksize, dtype=np.uint8)
        self.decode_chunks(want_to_read, chunks, decoded)
        return {i: decoded[i] for i in want_to_read}

    def decode(
        self, want_to_read: set[int], chunks: Mapping[int, np.ndarray],
        chunk_size: int = 0,
    ) -> dict[int, np.ndarray]:
        return self._decode(want_to_read, chunks)

    def decode_concat(self, chunks: Mapping[int, np.ndarray]) -> bytes:
        """Reconstruct the object: data chunk i lives at shard chunk_index(i)."""
        k = self.get_data_chunk_count()
        want = {self.chunk_index(i) for i in range(k)}
        decoded = self.decode(want, chunks)
        return b"".join(bytes(decoded[self.chunk_index(i)])
                        for i in range(k))
