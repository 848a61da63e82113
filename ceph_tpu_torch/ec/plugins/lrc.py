"""LRC (locally repairable / layered) erasure-code plugin.

A copy of ``ceph_tpu``'s lrc plugin (after the reference's
src/erasure-code/lrc/ErasureCodeLrc): the code is a stack of layers, each a
systematic RS sub-codec over a subset of the chunk positions.  A ``k/m/l``
profile generates the canonical layered layout:

  local_group_count = (k + m) / l          # (k+m) % l == 0 required
  per group: k/lgc data chunks, m/lgc global parities, 1 local parity

The global layer computes the m global parities from all k data chunks;
each local layer computes its group's local parity over the group's l
chunks (data + global parities).  A single lost chunk is repaired from its
local group's other l chunks only -- ``minimum_to_decode`` returns l shards,
not k.

Execution rides the flat linear spine (ec/linear_codec.py): the layer stack
composes into ONE systematic generator over the data chunks, so local repair
and global decode are the same ``gf_solve_rows`` repair-matrix build over
different source sets, and the batched encode/decode run through the
scheduled (K3) or dense (K1/K2) kernels on the codec's device.  The
local-parity rows -- all-ones XOR combinations, the sparsest matrices the
CSE compiler sees -- have their schedules warmed at build time.

Arbitrary layerings are accepted via ``mapping`` + ``layers`` profile keys
(layers as JSON ``[[mapping, profile], ...]``).
"""

from __future__ import annotations

import json

import numpy as np

from ...gf.gf8 import GF_MUL_TABLE
from ...gf.matrices import gen_rs_matrix, gen_cauchy1_matrix
from ..linear_codec import LinearSubchunkCodec
from ..registry import ErasureCodePlugin

DEFAULT_KML = -1


class _Layer:
    """One layer: a systematic RS code over a subset of positions."""

    def __init__(self, mapping: str, technique: str = "reed_sol_van"):
        self.mapping = mapping
        self.data_pos = [i for i, c in enumerate(mapping) if c == "D"]
        self.coding_pos = [i for i, c in enumerate(mapping) if c == "c"]
        self.positions = self.data_pos + self.coding_pos
        self.k = len(self.data_pos)
        self.m = len(self.coding_pos)
        if self.k < 1 or self.m < 1:
            raise ValueError(f"layer {mapping!r} needs >=1 D and >=1 c")
        gen = (gen_cauchy1_matrix if technique == "cauchy"
               else gen_rs_matrix)
        self.matrix = gen(self.k + self.m, self.k)


class ErasureCodeLrc(LinearSubchunkCodec):
    def __init__(self, device=None) -> None:
        super().__init__(device)
        self.l = 0
        self.m_global = 0          # the profile's m (global parities)
        self.mapping = ""
        self.layers: list[_Layer] = []
        self.chunk_count_ = 0

    # -- profile ------------------------------------------------------------
    def _parse_kml(self, profile) -> None:
        k = self.to_int("k", profile, str(DEFAULT_KML))
        m = self.to_int("m", profile, str(DEFAULT_KML))
        l = self.to_int("l", profile, str(DEFAULT_KML))
        present = [v != DEFAULT_KML for v in (k, m, l)]
        if not any(present):
            return
        if not all(present):
            raise ValueError(
                "lrc: all of k, m, l must be set or none (EINVAL)")
        for key in ("mapping", "layers"):
            if profile.get(key):
                raise ValueError(
                    f"lrc: {key} cannot be set when k/m/l are set "
                    f"(EINVAL)")
        self.sanity_check_k_m(k, m)
        if l < 1:
            raise ValueError(
                f"lrc: l={l} must be >= 1: each local group needs at "
                f"least one chunk beside its local parity (EINVAL)")
        if (k + m) % l:
            raise ValueError(
                f"lrc: k+m={k + m} must be a multiple of l={l} "
                f"(EINVAL)")
        lgc = (k + m) // l
        if k % lgc:
            raise ValueError(
                f"lrc: k={k} must be a multiple of (k+m)/l={lgc} "
                f"(EINVAL)")
        if m % lgc:
            raise ValueError(
                f"lrc: m={m} must be a multiple of (k+m)/l={lgc} "
                f"(EINVAL)")
        self.k, self.m_global, self.l = k, m, l
        kg, mg = k // lgc, m // lgc
        # mapping: per group D*kg + _*mg (global parities) + _ (local)
        profile["mapping"] = ("D" * kg + "_" * mg + "_") * lgc
        layers = [["".join(("D" * kg + "c" * mg + "_")
                           for _ in range(lgc)), ""]]
        for i in range(lgc):
            row = []
            for j in range(lgc):
                row.append("D" * (kg + mg) + "c" if i == j
                           else "_" * (kg + mg + 1))
            layers.append(["".join(row), ""])
        profile["layers"] = json.dumps(layers)

    def _parse_layers(self, profile) -> None:
        raw = profile.get("layers", "")
        if not raw:
            raise ValueError("lrc: profile needs layers or k/m/l")
        try:
            spec = json.loads(raw)
        except json.JSONDecodeError as e:
            raise ValueError(f"lrc: layers is not valid JSON: {e}")
        mapping = profile.get("mapping", "")
        if not mapping:
            raise ValueError("lrc: mapping is required with layers")
        self.mapping = mapping
        self.chunk_count_ = len(mapping)
        self.layers = []
        for entry in spec:
            lmap = entry[0] if isinstance(entry, list) else str(entry)
            lprofile = (entry[1] if isinstance(entry, list)
                        and len(entry) > 1 else "")
            technique = "reed_sol_van"
            if isinstance(lprofile, dict):
                technique = lprofile.get("technique", technique)
            elif "cauchy" in str(lprofile):
                technique = "cauchy"
            if len(lmap) != len(mapping):
                raise ValueError(
                    f"lrc: layer {lmap!r} length != mapping length "
                    f"{len(mapping)}")
            self.layers.append(_Layer(lmap, technique))
        data_pos = [i for i, c in enumerate(mapping) if c == "D"]
        if self.k == 0:
            self.k = len(data_pos)
        # sanity: every non-data position is computed by some layer
        computed = set()
        for layer in self.layers:
            computed |= set(layer.coding_pos)
        uncovered = (set(range(self.chunk_count_)) - set(data_pos)
                     - computed)
        if uncovered:
            raise ValueError(
                f"lrc: positions {sorted(uncovered)} are neither data "
                f"nor computed by any layer")
        self.m = self.chunk_count_ - self.k

    def _build_generator(self) -> None:
        """Compose the layer stack into the flat systematic generator:
        each coding position's row over the data chunks, by GF(2^8)
        linearity of the layers (layer order matters: a layer may read
        positions an earlier layer computed, e.g. local parities over
        global parities in the canonical k/m/l layout)."""
        n, k = self.chunk_count_, self.k
        gen = np.zeros((n, k), dtype=np.uint8)
        defined = [False] * n
        for i in range(k):
            p = self.chunk_index(i)
            gen[p, i] = 1
            defined[p] = True
        for layer in self.layers:
            for dp in layer.data_pos:
                if not defined[dp]:
                    raise ValueError(
                        f"lrc: layer {layer.mapping!r} reads position "
                        f"{dp} before any layer computes it (reorder "
                        f"the layers)")
            for r, p in enumerate(layer.coding_pos):
                row = np.zeros(k, dtype=np.uint8)
                for j, dp in enumerate(layer.data_pos):
                    c = int(layer.matrix[layer.k + r, j])
                    if c:
                        row ^= GF_MUL_TABLE[c][gen[dp]]
                gen[p] = row
                defined[p] = True
        self.generator = gen

    def init(self, profile) -> None:
        self._parse_kml(profile)
        self._parse_layers(profile)
        self.parse(profile)        # builds chunk_mapping from mapping
        self.alpha = 1
        self._build_generator()
        self.finish_setup()
        super().init(profile)

    # -- interface ----------------------------------------------------------
    def get_chunk_count(self) -> int:
        return self.chunk_count_

    def get_data_chunk_count(self) -> int:
        return self.k

    # -- locality-aware minimum_to_decode -----------------------------------
    def _repair_plan(self, want_to_read: set[int],
                     available: set[int]) -> tuple[set[int], list[int]]:
        """Greedy layered-repair closure.

        Returns (chunks to read, layer application order).  Prefers the
        layer that recovers a missing chunk with the FEWEST reads (the
        local group before the global layer), mirroring
        ErasureCodeLrc::_minimum_to_decode's locality preference.
        """
        wanted_missing = set(want_to_read) - set(available)
        if not wanted_missing:
            return set(want_to_read), []
        virtual_avail = set(available)
        reads: set[int] = set()
        order: list[int] = []

        def apply_layer(li: int) -> None:
            layer = self.layers[li]
            mine = set(layer.positions)
            have = virtual_avail & mine
            # the sub-decode reads the first k surviving chunks in the
            # layer's position order
            pos_index = {p: i for i, p in enumerate(layer.positions)}
            erasures = {pos_index[p] for p in mine - have}
            surviving = [p for p in layer.positions
                         if pos_index[p] not in erasures][:layer.k]
            reads.update(p for p in surviving if p in available)
            virtual_avail.update(mine - have)
            order.append(li)

        def feasible(li: int, need: set[int]) -> bool:
            layer = self.layers[li]
            mine = set(layer.positions)
            if not (need & mine):
                return False
            have = virtual_avail & mine
            return len(mine - have) <= layer.m and len(have) >= layer.k

        # smallest layer first = locality preference (a local group
        # beats the global layer when both can repair)
        by_size = sorted(range(len(self.layers)),
                         key=lambda i: len(self.layers[i].positions))
        for _ in range(len(self.layers) * (self.chunk_count_ + 1)):
            still = wanted_missing - virtual_avail
            if not still:
                break
            li = next((i for i in by_size if feasible(i, still)), None)
            if li is None:
                # no layer reaches a WANTED chunk directly: repairing
                # some other missing chunk may unlock one (e.g. a local
                # group fixing its loss lowers the global layer's
                # erasure count)
                other = set(range(self.chunk_count_)) - virtual_avail
                li = next((i for i in by_size if feasible(i, other)),
                          None)
            if li is None:
                raise IOError(
                    f"lrc: cannot repair {sorted(still)} from "
                    f"{sorted(available)}")
            apply_layer(li)
        wanted_reads = {p for p in want_to_read if p in available}
        return reads | wanted_reads, order

    def _minimum_to_decode(self, want_to_read: set[int],
                           available_chunks: set[int]) -> set[int]:
        reads, _ = self._repair_plan(want_to_read, available_chunks)
        return reads

    def _decode_sources(self, lost: tuple[int, ...],
                        available: set[int]) -> tuple[int, ...]:
        """The layered plan's read set: the local group for a single
        loss, the global closure otherwise.  The flat repair matrix
        over these sources reproduces the layer-by-layer recovery
        byte-for-byte (both compute the unique combination of the
        sources that equals the lost rows)."""
        reads, _ = self._repair_plan(set(lost), set(available))
        return tuple(sorted(reads))

    def get_alignment(self) -> int:
        return 32


def _factory(profile, device=None):
    return ErasureCodeLrc(device)


def __erasure_code_init__(registry, name: str) -> None:
    registry.add(name, ErasureCodePlugin(_factory))
