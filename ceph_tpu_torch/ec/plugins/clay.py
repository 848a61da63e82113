"""Clay: Coupled-LAYer MSR regenerating code with sub-chunking.

Decision-level rendering of src/erasure-code/clay/ErasureCodeClay.cc
(Myna Vajha et al., FAST'18 construction):

  * geometry (parse, :188-302): q = d-k+1, nu shortens to q | (k+m+nu),
    t = (k+m+nu)/q, sub_chunk_no = q^t.  Nodes sit on a q x t grid;
    chunk x of column y is node y*q+x; sub-chunks are indexed by plane
    vectors z = (z_0..z_{t-1}) in [0,q)^t.
  * two scalar MDS codecs: ``mds`` (k+nu, m) decodes whole uncoupled
    planes; ``pft`` (2, 2) is the pairwise transform between coupled
    chunk bytes C and uncoupled U across a node pair (x,y,z) <->
    (z_y, y, z') -- positions (0,1)=coupled pair, (2,3)=uncoupled pair.
  * encode/decode (decode_layered, :650-715): planes are processed in
    increasing "intersection score" order; known nodes convert C->U,
    the mds codec decodes erased U planes, then U->C conversions
    recover the erased chunks.
  * single-failure repair (repair_one_lost_chunk, :469-647) reads only
    sub_chunk_no/q sub-chunks from each of d helpers instead of whole
    chunks -- the repair-bandwidth win sub-chunking exists for
    (minimum_to_repair / get_repair_subchunks, :332-400).

Port of ``ceph_tpu/ec/plugins/clay.py``: host code.  Its scalar MDS codecs
(``scalar_mds``: jerasure, isa or shec) come from the port's registry, host
codecs all; the factory takes the registry's ``device`` and ignores it.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

from ..base import ErasureCode
from ..registry import ErasureCodePlugin


def pow_int(a: int, x: int) -> int:
    return a ** x


class ErasureCodeClay(ErasureCode):
    def __init__(self) -> None:
        super().__init__()
        self.k = 0
        self.m = 0
        self.d = 0
        self.q = 0
        self.t = 0
        self.nu = 0
        self.sub_chunk_no = 0
        self.mds = None
        self.pft = None

    # -- profile ------------------------------------------------------------
    def init(self, profile) -> None:
        from ..registry import instance as _registry
        self.parse(profile)
        self.k = self.to_int("k", profile, "4")
        self.m = self.to_int("m", profile, "2")
        self.sanity_check_k_m(self.k, self.m)
        self.d = self.to_int("d", profile, str(self.k + self.m - 1))
        if not self.k <= self.d <= self.k + self.m - 1:
            raise ValueError(
                f"clay: d={self.d} must be in [{self.k}, "
                f"{self.k + self.m - 1}]")
        scalar_mds = profile.get("scalar_mds", "jerasure")
        technique = profile.get("technique", "reed_sol_van")
        self.q = self.d - self.k + 1
        self.nu = (self.q - (self.k + self.m) % self.q) \
            if (self.k + self.m) % self.q else 0
        if self.k + self.m + self.nu > 254:
            raise ValueError("clay: k+m+nu > 254")
        self.t = (self.k + self.m + self.nu) // self.q
        self.sub_chunk_no = pow_int(self.q, self.t)
        reg = _registry()
        self.mds = reg.factory(scalar_mds, {
            "k": str(self.k + self.nu), "m": str(self.m), "w": "8",
            "technique": technique})
        self.pft = reg.factory(scalar_mds, {
            "k": "2", "m": "2", "w": "8", "technique": technique})
        super().init(profile)

    # -- geometry -----------------------------------------------------------
    def get_chunk_count(self) -> int:
        return self.k + self.m

    def get_data_chunk_count(self) -> int:
        return self.k

    def get_sub_chunk_count(self) -> int:
        return self.sub_chunk_no

    def get_chunk_size(self, stripe_width: int) -> int:
        # round_up_to(stripe, sub_chunk_no * k * pft_align) / k
        # (ErasureCodeClay.cc:90-96)
        align = self.sub_chunk_no * self.k * self.pft.get_chunk_size(1)
        padded = ((stripe_width + align - 1) // align) * align
        return padded // self.k

    def _plane_vector(self, z: int) -> list[int]:
        z_vec = [0] * self.t
        for i in range(self.t):
            z_vec[self.t - 1 - i] = z % self.q
            z = z // self.q
        return z_vec

    # -- pairwise transform plumbing ----------------------------------------
    def _pft_call(self, erased: set[int], known: dict[int, np.ndarray],
                  out: dict[int, np.ndarray]) -> None:
        """Run the (2,2) pairwise transform: positions 0,1 = coupled,
        2,3 = uncoupled; recover ``erased`` from ``known`` writing
        through the views in ``out``."""
        self.pft.decode_chunks(erased, known, out)

    # -- layered decode (decode_layered) ------------------------------------
    def _decode_layered(self, erased_chunks: set[int],
                        chunks: dict[int, np.ndarray]) -> None:
        q, t, nu = self.q, self.t, self.nu
        size = len(chunks[0])
        assert size % self.sub_chunk_no == 0
        sc = size // self.sub_chunk_no
        erased = set(erased_chunks)
        i = self.k + nu
        while len(erased) < self.m and i < q * t:
            erased.add(i)
            i += 1
        assert len(erased) == self.m
        U = {i: np.zeros(size, dtype=np.uint8) for i in range(q * t)}
        order = self._plane_order(erased)
        max_score = max(order.values(), default=0)
        for score in range(max_score + 1):
            for z in range(self.sub_chunk_no):
                if order[z] == score:
                    self._decode_erasures(erased, z, chunks, U, sc)
            for z in range(self.sub_chunk_no):
                if order[z] != score:
                    continue
                z_vec = self._plane_vector(z)
                for node_xy in erased:
                    x, y = node_xy % q, node_xy // q
                    node_sw = y * q + z_vec[y]
                    if z_vec[y] != x:
                        if node_sw not in erased:
                            self._recover_type1(chunks, U, x, y, z,
                                                z_vec, sc)
                        elif z_vec[y] < x:
                            self._coupled_from_uncoupled(
                                chunks, U, x, y, z, z_vec, sc)
                    else:
                        chunks[node_xy][z * sc:(z + 1) * sc] = \
                            U[node_xy][z * sc:(z + 1) * sc]

    def _plane_order(self, erased: set[int]) -> dict[int, int]:
        order = {}
        for z in range(self.sub_chunk_no):
            z_vec = self._plane_vector(z)
            order[z] = sum(1 for i in erased
                           if i % self.q == z_vec[i // self.q])
        return order

    def _decode_erasures(self, erased: set[int], z: int,
                         chunks: dict[int, np.ndarray],
                         U: dict[int, np.ndarray], sc: int) -> None:
        q, t = self.q, self.t
        z_vec = self._plane_vector(z)
        for x in range(q):
            for y in range(t):
                node_xy = q * y + x
                node_sw = q * y + z_vec[y]
                if node_xy in erased:
                    continue
                if z_vec[y] < x:
                    self._uncoupled_from_coupled(chunks, U, x, y, z,
                                                 z_vec, sc)
                elif z_vec[y] == x:
                    U[node_xy][z * sc:(z + 1) * sc] = \
                        chunks[node_xy][z * sc:(z + 1) * sc]
                elif node_sw in erased:
                    self._uncoupled_from_coupled(chunks, U, x, y, z,
                                                 z_vec, sc)
        self._decode_uncoupled(erased, z, U, sc)

    def _decode_uncoupled(self, erased: set[int], z: int,
                          U: dict[int, np.ndarray], sc: int) -> None:
        known = {}
        out = {}
        for i in range(self.q * self.t):
            view = U[i][z * sc:(z + 1) * sc]
            out[i] = view
            if i not in erased:
                known[i] = view
        self.mds.decode_chunks(erased, known, out)

    # -- the four C<->U conversions (views write through) -------------------
    def _pair(self, x: int, y: int, z: int,
              z_vec: list[int], sc: int):
        q, t = self.q, self.t
        node_xy = y * q + x
        node_sw = y * q + z_vec[y]
        z_sw = z + (x - z_vec[y]) * pow_int(q, t - 1 - y)
        swap = z_vec[y] > x
        return node_xy, node_sw, z_sw, swap

    def _uncoupled_from_coupled(self, chunks, U, x, y, z, z_vec,
                                sc) -> None:
        node_xy, node_sw, z_sw, swap = self._pair(x, y, z, z_vec, sc)
        i0, i1, i2, i3 = (1, 0, 3, 2) if swap else (0, 1, 2, 3)
        known = {i0: chunks[node_xy][z * sc:(z + 1) * sc],
                 i1: chunks[node_sw][z_sw * sc:(z_sw + 1) * sc]}
        out = {i0: known[i0], i1: known[i1],
               i2: U[node_xy][z * sc:(z + 1) * sc],
               i3: U[node_sw][z_sw * sc:(z_sw + 1) * sc]}
        self._pft_call({2, 3}, known, out)

    def _coupled_from_uncoupled(self, chunks, U, x, y, z, z_vec,
                                sc) -> None:
        node_xy, node_sw, z_sw, swap = self._pair(x, y, z, z_vec, sc)
        assert z_vec[y] < x
        known = {2: U[node_xy][z * sc:(z + 1) * sc],
                 3: U[node_sw][z_sw * sc:(z_sw + 1) * sc]}
        out = {0: chunks[node_xy][z * sc:(z + 1) * sc],
               1: chunks[node_sw][z_sw * sc:(z_sw + 1) * sc],
               2: known[2], 3: known[3]}
        self._pft_call({0, 1}, known, out)

    def _recover_type1(self, chunks, U, x, y, z, z_vec, sc) -> None:
        """node_xy erased, its pair node_sw known: C_xy from
        (C_sw, U_xy) via the pft (recover_type1_erasure)."""
        node_xy, node_sw, z_sw, swap = self._pair(x, y, z, z_vec, sc)
        i0, i1, i2, i3 = (1, 0, 3, 2) if swap else (0, 1, 2, 3)
        known = {i1: chunks[node_sw][z_sw * sc:(z_sw + 1) * sc],
                 i2: U[node_xy][z * sc:(z + 1) * sc]}
        out = {i0: chunks[node_xy][z * sc:(z + 1) * sc],
               i1: known[i1], i2: known[i2],
               i3: np.zeros(sc, dtype=np.uint8)}
        self._pft_call({i0, i3}, known, out)

    # -- interface: encode/decode -------------------------------------------
    def _grid_chunks(self, encoded: dict[int, np.ndarray],
                     size: int) -> dict[int, np.ndarray]:
        """Map interface chunk ids (0..k+m) onto grid node ids
        (0..q*t), inserting zeroed shortened nodes k..k+nu."""
        grid: dict[int, np.ndarray] = {}
        for i in range(self.k):
            grid[i] = encoded[i]
        for i in range(self.k, self.k + self.nu):
            grid[i] = np.zeros(size, dtype=np.uint8)
        for i in range(self.k, self.k + self.m):
            grid[i + self.nu] = encoded[i]
        return grid

    def encode_chunks(self, chunks: dict[int, np.ndarray]) -> None:
        size = len(chunks[0])
        grid = self._grid_chunks(chunks, size)
        parity = {i + self.nu for i in range(self.k, self.k + self.m)}
        self._decode_layered(parity, grid)

    def decode_chunks(
        self, want_to_read: set[int], chunks: Mapping[int, np.ndarray],
        decoded: dict[int, np.ndarray],
    ) -> None:
        size = len(next(iter(decoded.values())))
        grid = self._grid_chunks(decoded, size)
        erased = set()
        for i in range(self.k + self.m):
            if i not in chunks:
                erased.add(i if i < self.k else i + self.nu)
        if not erased:
            return
        if len(erased) > self.m:
            raise IOError(
                f"clay: {len(erased)} erasures exceed m={self.m}")
        self._decode_layered(erased, grid)

    # -- repair-optimal single-failure path ---------------------------------
    def is_repair(self, want_to_read: set[int],
                  available: set[int]) -> bool:
        """Single lost chunk whose whole y-column (its local group) is
        available, with >= d helpers total (ErasureCodeClay::is_repair)."""
        if len(want_to_read) != 1:
            return False
        if set(want_to_read) <= set(available):
            return False
        lost = next(iter(want_to_read))
        lost_node = lost if lost < self.k else lost + self.nu
        for x in range(self.q):
            node = (lost_node // self.q) * self.q + x
            if self.k <= node < self.k + self.nu:
                continue                   # shortened node: always zero
            iface = node if node < self.k else node - self.nu
            if iface != lost and iface not in available:
                return False
        return len(available) >= self.d

    def get_repair_subchunks(self, lost_node: int) -> list[tuple[int, int]]:
        q, t = self.q, self.t
        y_lost, x_lost = lost_node // q, lost_node % q
        seq_sc = pow_int(q, t - 1 - y_lost)
        num_seq = pow_int(q, y_lost)
        out = []
        index = x_lost * seq_sc
        for _ in range(num_seq):
            out.append((index, seq_sc))
            index += q * seq_sc
        return out

    def minimum_to_decode(self, want_to_read, available):
        want = set(want_to_read)
        avail = set(available)
        if self.is_repair(want, avail):
            lost = next(iter(want))
            lost_node = lost if lost < self.k else lost + self.nu
            sub = self.get_repair_subchunks(lost_node)
            minimum: dict[int, list] = {}
            for j in range(self.q):
                rep = (lost_node // self.q) * self.q + j
                if j == lost_node % self.q:
                    continue
                if rep < self.k:
                    minimum[rep] = list(sub)
                elif rep >= self.k + self.nu:
                    minimum[rep - self.nu] = list(sub)
            for chunk in sorted(avail):
                if len(minimum) >= self.d:
                    break
                minimum.setdefault(chunk, list(sub))
            return minimum
        return super().minimum_to_decode(want, avail)

    def decode(self, want_to_read, chunks, chunk_size: int = 0):
        avail = set(chunks)
        if self.is_repair(set(want_to_read), avail) and chunk_size \
                and len(next(iter(chunks.values()))) < chunk_size:
            return self.repair(set(want_to_read), chunks)
        return self._decode(set(want_to_read), chunks)

    def repair(self, want_to_read: set[int],
               chunks: Mapping[int, np.ndarray]) -> dict[int, np.ndarray]:
        """Repair ONE lost chunk from d helpers' repair sub-chunks.

        ``chunks`` holds each helper's CONCATENATED repair sub-chunks
        (the ranges minimum_to_decode returned), len = chunk_size / q.
        """
        assert len(want_to_read) == 1 and len(chunks) == self.d
        q, t, nu = self.q, self.t, self.nu
        lost = next(iter(want_to_read))
        lost_node = lost if lost < self.k else lost + nu
        repair_blocksize = len(next(iter(chunks.values())))
        repair_subchunks = self.sub_chunk_no // q
        sc = repair_blocksize // repair_subchunks
        chunk_size = self.sub_chunk_no * sc

        helper = {}
        aloof = set()
        for i in range(self.k + self.m):
            node = i if i < self.k else i + nu
            if i in chunks:
                helper[node] = np.asarray(chunks[i], dtype=np.uint8)
            elif i != lost:
                aloof.add(node)
        for i in range(self.k, self.k + nu):
            helper[i] = np.zeros(repair_blocksize, dtype=np.uint8)
        recovered = np.zeros(chunk_size, dtype=np.uint8)

        sub_ind = self.get_repair_subchunks(lost_node)
        plane_to_ind = {}
        ordered: dict[int, set[int]] = {}
        ind = 0
        for index, count in sub_ind:
            for z in range(index, index + count):
                z_vec = self._plane_vector(z)
                score = (1 if lost_node % q == z_vec[lost_node // q]
                         else 0)
                score += sum(1 for nd in aloof
                             if nd % q == z_vec[nd // q])
                assert score > 0
                ordered.setdefault(score, set()).add(z)
                plane_to_ind[z] = ind
                ind += 1

        U = {i: np.zeros(chunk_size, dtype=np.uint8)
             for i in range(q * t)}
        erasures = {lost_node - lost_node % q + i for i in range(q)}
        erasures |= aloof

        for score in sorted(ordered):
            for z in ordered[score]:
                z_vec = self._plane_vector(z)
                for y in range(t):
                    for x in range(q):
                        node_xy = y * q + x
                        if node_xy in erasures:
                            continue
                        z_sw = z + (x - z_vec[y]) * pow_int(q, t - 1 - y)
                        node_sw = y * q + z_vec[y]
                        i0, i1, i2, i3 = ((1, 0, 3, 2)
                                          if z_vec[y] > x
                                          else (0, 1, 2, 3))
                        hxy = helper[node_xy][
                            plane_to_ind[z] * sc:
                            (plane_to_ind[z] + 1) * sc]
                        if node_sw in aloof:
                            known = {i0: hxy,
                                     i3: U[node_sw][z_sw * sc:
                                                    (z_sw + 1) * sc]}
                            out = {i0: known[i0],
                                   i1: np.zeros(sc, np.uint8),
                                   i2: U[node_xy][z * sc:(z + 1) * sc],
                                   i3: known[i3]}
                            self._pft_call({i2}, known, out)
                        elif z_vec[y] != x:
                            known = {i0: hxy,
                                     i1: helper[node_sw][
                                         plane_to_ind[z_sw] * sc:
                                         (plane_to_ind[z_sw] + 1) * sc]}
                            out = {i0: known[i0], i1: known[i1],
                                   i2: U[node_xy][z * sc:(z + 1) * sc],
                                   i3: np.zeros(sc, np.uint8)}
                            self._pft_call({i2}, known, out)
                        else:
                            U[node_xy][z * sc:(z + 1) * sc] = hxy
                self._decode_uncoupled(erasures, z, U, sc)
                for node in erasures:
                    x, y = node % q, node // q
                    node_sw = y * q + z_vec[y]
                    z_sw = z + (x - z_vec[y]) * pow_int(q, t - 1 - y)
                    i0, i1, i2, i3 = ((1, 0, 3, 2) if z_vec[y] > x
                                      else (0, 1, 2, 3))
                    if node in aloof:
                        continue
                    if x == z_vec[y]:     # hole-dot pair
                        recovered[z * sc:(z + 1) * sc] = \
                            U[node][z * sc:(z + 1) * sc]
                    else:
                        assert node_sw == lost_node
                        known = {i0: helper[node][
                            plane_to_ind[z] * sc:
                            (plane_to_ind[z] + 1) * sc],
                            i2: U[node][z * sc:(z + 1) * sc]}
                        out = {i0: known[i0],
                               i1: recovered[z_sw * sc:(z_sw + 1) * sc],
                               i2: known[i2],
                               i3: np.zeros(sc, np.uint8)}
                        self._pft_call({i1}, known, out)
        return {lost: recovered}


def _factory(profile, device=None):
    # host codec: runs on the CPU whatever the caller's device
    return ErasureCodeClay()


def __erasure_code_init__(registry, name: str) -> None:
    registry.add(name, ErasureCodePlugin(_factory))
