"""Bulk CRUSH placement on the card: kernel K5 ``crush_map_rule``.

Port of ``ceph_tpu/crush/vectorized.py``.  The reference recomputes the
whole PG->OSD table as one XLA program per map epoch (two jitted
``lax.while_loop`` programs, ``VectorCrush.map_firstn`` / ``map_indep``);
here the same job is kernel K5 (``csrc/crush.cu``), one thread per lane,
one descent of its retry loops a pass.  ``kernel_map_words`` lays out the
map as K5 reads it, each straw2 weight as the multiplier ``straw2_magic``
that replaces the draw's division.

* Host half, copied: ``CompiledMap.from_map`` flattens a uniform-depth
  hierarchy of buckets drawn as straw2 into padded per-level tables (child
  ids to hash, child rows in the next level, weights and the choose_args
  weight-sets per position), and ``_rule_shape`` parses a rule.  Beyond the
  reference, the bulk mapper also takes straw buckets without legacy straw
  values (the scalar engine draws them as straw2 on their own weights,
  ignoring choose_args) and any ``chooseleaf_vary_r``, from the tunables
  or a rule step.  A shape it does not express raises ``Unexpressed``, a
  ``ValueError`` with the reference's message where the reference refuses
  it too: other bucket kinds, buckets mixing osds and buckets, a chooseleaf
  above the osds' parent, a plain choose of a bucket type,
  ``chooseleaf_stable`` 0 or local retries, and rules of more than one take
  or choose step or with an explicit replica count (which the reference's
  mapper maps wrongly).  ``bulk_crush`` sends such a (map, rule) to the
  scalar engine (``crush/mapper.py``) on the host; on the card it is an
  error.  Two shapes that map nothing at all -- a rule the map lacks, a
  chooseleaf straight from the osds' own parent -- raise ``MapsNothing``,
  a ``ValueError`` whose answer is rows of ``CRUSH_ITEM_NONE`` (the
  reference's mapper accepts the second and maps a replica there).  A
  malformed map (a dangling bucket reference) raises a plain
  ``ValueError``.

* The plain PyTorch version: ``hash32_2`` / ``hash32_3`` (rjenkins over the
  uint32 bit patterns, carried in int64 tensors and masked with
  0xFFFFFFFF, as K4's wrapper carries the CRC register: ``torch.uint32``
  has few operations), ``crush_ln``, ``straw2_draws``, ``is_out`` and
  ``VectorCrush.map_firstn`` / ``map_indep``, lockstep over the lane axis
  as the reference's programs are.

* ``VectorCrush.map_device`` is K5's wrapper: the plain version for a CPU
  tensor, K5 for a CUDA tensor (a launch failure raises; there is no
  fallback).  ``map_pgs`` takes and returns numpy, as the reference's does.
  ``osd_weights`` shorter than the map's ``max_devices`` is padded with 0:
  an item past its end is out, as in the scalar engine (mapper.c
  is_out); the reference's gather clamps the index instead.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..ops import _build
from .hashes import CRUSH_HASH_SEED
from .ln import LL_TBL, RH_LH_TBL, S64_MIN
from .types import (
    CRUSH_BUCKET_STRAW,
    CRUSH_BUCKET_STRAW2,
    CRUSH_ITEM_NONE,
    CRUSH_ITEM_UNDEF,
    CRUSH_RULE_CHOOSE_FIRSTN,
    CRUSH_RULE_CHOOSE_INDEP,
    CRUSH_RULE_CHOOSELEAF_FIRSTN,
    CRUSH_RULE_CHOOSELEAF_INDEP,
    CRUSH_RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES,
    CRUSH_RULE_SET_CHOOSE_LOCAL_TRIES,
    CRUSH_RULE_SET_CHOOSE_TRIES,
    CRUSH_RULE_SET_CHOOSELEAF_STABLE,
    CRUSH_RULE_SET_CHOOSELEAF_TRIES,
    CRUSH_RULE_SET_CHOOSELEAF_VARY_R,
    CRUSH_RULE_TAKE,
    CrushMap,
)

_M32 = 0xFFFFFFFF
_NO_SEL = 2**31 - 1          # firstn's selection of an exhausted slot

# launches of K5, counted where the wrapper launches it
LAUNCHES = {"crush_map_rule": 0}
# weight vectors a mapper made on its device (``device_weights``): one for
# each distinct vector it was given, whatever the number of launches
WEIGHT_UPLOADS = {"crush_map_rule": 0}
# distinct weight vectors a mapper keeps on its device (the oldest go)
_WEIGHTS_KEPT = 8


# -- plain PyTorch version: hashes, crush_ln, straw2 ------------------------

def _mix(a, b, c):
    a = (a - b - c) & _M32; a = a ^ (c >> 13)
    b = (b - c - a) & _M32; b = b ^ ((a << 8) & _M32)
    c = (c - a - b) & _M32; c = c ^ (b >> 13)
    a = (a - b - c) & _M32; a = a ^ (c >> 12)
    b = (b - c - a) & _M32; b = b ^ ((a << 16) & _M32)
    c = (c - a - b) & _M32; c = c ^ (b >> 5)
    a = (a - b - c) & _M32; a = a ^ (c >> 3)
    b = (b - c - a) & _M32; b = b ^ ((a << 10) & _M32)
    c = (c - a - b) & _M32; c = c ^ (b >> 15)
    return a, b, c


def hash32_2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """rjenkins hash of two uint32 bit patterns (int64 tensors, any sign:
    only the low 32 bits count) -> int64 in [0, 2^32)."""
    a, b = torch.broadcast_tensors(a.long() & _M32, b.long() & _M32)
    h = a ^ b ^ CRUSH_HASH_SEED
    x = torch.full_like(h, 231232)
    y = torch.full_like(h, 1232)
    a, b, h = _mix(a, b, h)
    x, a, h = _mix(x, a, h)
    b, y, h = _mix(b, y, h)
    return h


def hash32_3(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """rjenkins hash of three uint32 bit patterns -> int64 in [0, 2^32)."""
    a, b, c = torch.broadcast_tensors(a.long() & _M32, b.long() & _M32,
                                      c.long() & _M32)
    h = a ^ b ^ c ^ CRUSH_HASH_SEED
    x = torch.full_like(h, 231232)
    y = torch.full_like(h, 1232)
    a, b, h = _mix(a, b, h)
    c, x, h = _mix(c, x, h)
    y, a, h = _mix(y, a, h)
    b, x, h = _mix(b, x, h)
    y, c, h = _mix(y, c, h)
    return h


@functools.lru_cache(maxsize=8)
def _ln_tables(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    return (torch.from_numpy(np.asarray(RH_LH_TBL, np.int64)).to(device),
            torch.from_numpy(np.asarray(LL_TBL, np.int64)).to(device))


@functools.lru_cache(maxsize=8)
def ln_words(device: torch.device) -> torch.Tensor:
    """K5's crush_ln tables: RH_LH (258) then LL (256), int64."""
    return torch.cat(_ln_tables(device))


def crush_ln(u: torch.Tensor) -> torch.Tensor:
    """2^44 * log2(u + 1) in fixed point for u in [0, 0xffff] (mapper.c
    crush_ln) -> int64.  x * rh wraps for x = 0x10000 (2^16 * 2^47); only
    bits 48..55 of the product are read, and they are the unsigned
    product's."""
    rh_lh, ll = _ln_tables(u.device)
    x = u.long() + 1
    # bit length of x (1 <= x <= 0x10000), exact: x = m * 2^e, 0.5 <= m < 1
    bl = torch.frexp(x.double()).exponent.long()
    bits = torch.where((x & 0x18000) == 0, 16 - bl, 0)
    x = x << bits
    iexpon = 15 - bits
    index1 = (x >> 8) << 1
    rh = rh_lh[index1 - 256]
    lh = rh_lh[index1 + 1 - 256]
    xl64 = (x * rh) >> 48
    return (iexpon << 44) + ((lh + ll[xl64 & 0xFF]) >> 4)


def straw2_draws(x: torch.Tensor, item_ids: torch.Tensor, r: torch.Tensor,
                 weights: torch.Tensor) -> torch.Tensor:
    """Draws of one bucket per lane: x, r (L,); item_ids, weights (L, n)
    -> (L, n) int64, ln / weight truncated toward zero, S64_MIN where the
    weight is not positive."""
    u = hash32_3(x[..., None], item_ids, r[..., None]) & 0xFFFF
    ln = crush_ln(u) - 0x1000000000000
    w = weights.long()
    draws = torch.div(ln, w.clamp(min=1), rounding_mode="trunc")
    return torch.where(w > 0, draws, S64_MIN)


def is_out(osd_weights: torch.Tensor, item: torch.Tensor,
           x: torch.Tensor) -> torch.Tensor:
    """mapper.c is_out: the 16.16 reweight of ``item`` rejects it with
    probability 1 - w (hash of (x, item)); 0 is out, >= 0x10000 is in."""
    w = osd_weights[item]
    h = hash32_2(x, item) & 0xFFFF
    return torch.where(w >= 0x10000, False, (w == 0) | (h >= w))


# -- host half, copied ------------------------------------------------------

class Unexpressed(ValueError):
    """A (map, rule) whose shape the bulk mapper does not express: the
    scalar engine maps it on the host, and on the card it is an error."""


def _drawn_as_straw2(b) -> bool:
    """Whether the scalar engine draws bucket ``b`` as straw2: a straw2
    bucket, or a straw bucket without legacy straw values
    (``mapper._bucket_straw_choose``), which ignores choose_args."""
    return b.alg == CRUSH_BUCKET_STRAW2 or (
        b.alg == CRUSH_BUCKET_STRAW and getattr(b, "straws", None) is None)


@dataclass
class CompiledMap:
    """Flattened uniform-depth straw2 hierarchy for the bulk mapper.

    Level l holds every bucket at distance l from the take root as padded
    tables; a lane descends them one straw2 draw + argmax per level, the
    recursive descent of mapper.c crush_choose_firstn/indep.  Non-uniform
    leaf depth or buckets not drawn as straw2 are refused (the scalar
    engine serves them).  A straw bucket without straw values takes its
    own weights at every position and its own ids.

    child_ids carry the CRUSH item ids (what straw2 hashes); child_idx the
    row index into the NEXT level's tables (or the osd id at the last
    level).  weights are the bucket item weights, 0-padded; cw holds the
    choose_args weight-set per output position when the map has one
    (mapper.c get_choose_arg_weights).
    """

    n_levels: int                       # bucket levels (root = level 0)
    child_ids: list                     # [(B_l, N_l) int32]
    child_idx: list                     # [(B_l, N_l) int32]
    weights: list                       # [(B_l, N_l) int32]
    cw: list | None                     # [(P, B_l, N_l)] or None
    bucket_ids: list                    # [(B_l,) int32] crush ids per level
    max_devices: int
    leaf_parent_types: frozenset = frozenset()

    @classmethod
    def from_map(cls, crush_map: CrushMap, root_id: int,
                 choose_args: dict | None = None) -> "CompiledMap":
        levels: list[list] = [[crush_map.buckets[root_id]]]
        while True:
            cur = levels[-1]
            kinds = set()
            for b in cur:
                if not _drawn_as_straw2(b):
                    raise Unexpressed("fused path requires straw2")
                for i in b.items:
                    kinds.add(i < 0)
            if kinds == {True}:
                levels.append([crush_map.buckets.get(i)
                               for b in cur for i in b.items])
                if any(b is None for b in levels[-1]):
                    raise ValueError("dangling bucket reference")
            elif kinds == {False}:
                break                   # this level's items are osds
            else:
                raise Unexpressed("mixed osd/bucket children "
                                  "unsupported by the fused path")
        idx_of = [{b.id: j for j, b in enumerate(lv)} for lv in levels]
        child_ids, child_idx, weights, cw, bids = [], [], [], [], []
        ca = choose_args if choose_args is not None else \
            getattr(crush_map, "choose_args", None)
        positions = 1
        if ca:
            for arg in ca.values():
                if arg.get("weight_set"):
                    positions = max(positions, len(arg["weight_set"]))
        for l, lv in enumerate(levels):
            maxn = max(b.size for b in lv)
            ids = np.zeros((len(lv), maxn), np.int32)
            idx = np.zeros((len(lv), maxn), np.int32)
            w = np.zeros((len(lv), maxn), np.int32)
            cwl = np.zeros((positions, len(lv), maxn), np.int32)
            for j, b in enumerate(lv):
                arg = ((ca or {}).get(b.id) or {}
                       if b.alg == CRUSH_BUCKET_STRAW2 else {})
                hash_ids = arg.get("ids") or b.items
                ids[j, :b.size] = hash_ids
                ids[j, b.size:] = hash_ids[0] if b.size else 0
                w[j, :b.size] = b.item_weights
                ws = arg.get("weight_set")
                for pos in range(positions):
                    src = (ws[min(pos, len(ws) - 1)] if ws
                           else b.item_weights)
                    cwl[pos, j, :b.size] = src
                if l + 1 < len(levels):
                    idx[j, :b.size] = [idx_of[l + 1][i] for i in b.items]
                    idx[j, b.size:] = idx[j, 0] if b.size else 0
                else:
                    idx[j, :b.size] = b.items
                    idx[j, b.size:] = b.items[0] if b.size else 0
            child_ids.append(ids)
            child_idx.append(idx)
            weights.append(w)
            cw.append(cwl)
            bids.append(np.asarray([b.id for b in lv], np.int32))
        has_ca = bool(ca) and any(
            a.get("weight_set") or a.get("ids") for a in ca.values())
        return cls(len(levels), child_ids, child_idx, weights,
                   cw if has_ca else None, bids,
                   crush_map.max_devices,
                   frozenset(b.type for b in levels[-1]))


class MapsNothing(ValueError):
    """A (map, rule) under which ``crush_do_rule`` maps no seed to anything:
    every row is CRUSH_ITEM_NONE, and no mapper is needed to say so."""


_CHOOSE_OPS = (CRUSH_RULE_CHOOSE_FIRSTN, CRUSH_RULE_CHOOSELEAF_FIRSTN,
               CRUSH_RULE_CHOOSE_INDEP, CRUSH_RULE_CHOOSELEAF_INDEP)
# the rule steps that set a tunable (crush_do_rule takes arg1 >= 0)
_TUNABLE_STEPS = {
    CRUSH_RULE_SET_CHOOSELEAF_VARY_R: "chooseleaf_vary_r",
    CRUSH_RULE_SET_CHOOSELEAF_STABLE: "chooseleaf_stable",
    CRUSH_RULE_SET_CHOOSE_LOCAL_TRIES: "choose_local_tries",
    CRUSH_RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES: "choose_local_fallback_tries",
}


def _rule_shape(crush_map: CrushMap, ruleno: int):
    """Parse a rule into (root_id, firstn, leaf, choose_tries, leaf_tries,
    choose_type, tunables), ``tunables`` the values of ``_TUNABLE_STEPS``'
    names its choose step runs under.  A rule of more than one take or
    choose step, or whose choose step names a replica count, is
    ``Unexpressed``."""
    rule = crush_map.rules.get(ruleno)
    if rule is None:
        raise MapsNothing(f"no rule {ruleno} in the map")
    t = crush_map.tunables
    tunables = {name: getattr(t, name) for name in _TUNABLE_STEPS.values()}
    choose_tries = t.choose_total_tries + 1
    leaf_tries = 0
    root_id = None
    mode = None
    choose_type = 0
    takes = chooses = 0
    for step in rule.steps:
        if step.op == CRUSH_RULE_SET_CHOOSE_TRIES:
            choose_tries = step.arg1
        elif step.op == CRUSH_RULE_SET_CHOOSELEAF_TRIES:
            leaf_tries = step.arg1
        elif step.op in _TUNABLE_STEPS and mode is None and step.arg1 >= 0:
            tunables[_TUNABLE_STEPS[step.op]] = step.arg1
        elif step.op == CRUSH_RULE_TAKE:
            root_id = step.arg1
            takes += 1
        elif step.op in _CHOOSE_OPS:
            if step.arg1 != 0:
                raise Unexpressed("a choose step with a replica count needs "
                                  "the scalar engine")
            mode = step.op
            choose_type = step.arg2
            chooses += 1
    if takes > 1 or chooses > 1:
        raise Unexpressed("a rule of more than one take or choose step "
                          "needs the scalar engine")
    firstn = mode in (CRUSH_RULE_CHOOSE_FIRSTN, CRUSH_RULE_CHOOSELEAF_FIRSTN)
    leaf = mode in (CRUSH_RULE_CHOOSELEAF_FIRSTN, CRUSH_RULE_CHOOSELEAF_INDEP)
    return (root_id, firstn, leaf, choose_tries, leaf_tries, choose_type,
            tunables)


# -- kernel K5 --------------------------------------------------------------

# K5's map words (csrc/crush.cu): a header, then per level (N, ids offset,
# idx offset, multipliers offset, B), then the tables, all int32
_HEADER_WORDS = 8
_LEVEL_WORDS = 5
# n // w == (n * m) >> (49 + b) for every n below 2^_MAGIC_BITS
_MAGIC_BITS = 49


def straw2_magic(weights) -> np.ndarray:
    """K5's multiplier for each straw2 weight, uint64 of the weights' shape:
    ``m | b << 56`` with ``2^b >= w`` and ``m = ceil(2^(49+b) / w)``, so that
    ``n // w == (n * m) >> (49 + b)`` for every ``0 <= n < 2^49``
    (Granlund-Montgomery; ``m < 2^51``); 0 for a weight <= 0, whose draw is
    S64_MIN.  A draw divides ``2^48 - crush_ln(u) <= 2^48``."""
    w = np.asarray(weights, np.int64)
    flat = np.zeros(w.size, np.uint64)
    for i, wi in enumerate(w.ravel().tolist()):
        if wi > 0:
            b = (wi - 1).bit_length()
            flat[i] = -(-(1 << (_MAGIC_BITS + b)) // wi) | (b << 56)
    return flat.reshape(w.shape)


def leaf_shift(vary_r: int) -> int:
    """The shift s of firstn's leaf recursion, sub_r = r >> s (mapper.c:
    ``r >> (vary_r - 1)``, 0 for vary_r 0): vary_r - 1, and 32 (every r
    below 2^32 shifts to 0) for vary_r 0 or above 32."""
    return min(vary_r - 1, 32) if vary_r > 0 else 32


def kernel_map_words(cm: CompiledMap, firstn: bool, leaf: bool,
                     choose_tries: int, recurse_tries: int,
                     vary_r: int = 1) -> np.ndarray:
    """One rule over one compiled map as K5 reads it: header {levels, levels
    the choose phase descends, weight-set positions P, firstn, leaf (0 for
    a plain choose, else 1 + ``leaf_shift(vary_r)``), choose_tries,
    recurse_tries, total words}, then per level {N, offsets of child_ids
    (B, N), child_idx (B, N) and the weights' ``straw2_magic`` multipliers
    (P, B, N) as int64 at an even offset, B}, then the tables."""
    w = cm.cw if cm.cw is not None else [t[None] for t in cm.weights]
    p = w[0].shape[0]
    off = _HEADER_WORDS + _LEVEL_WORDS * cm.n_levels
    levels, tables = [], []
    for ids, idx, wl in zip(cm.child_ids, cm.child_idx, w):
        b, n = ids.shape
        pad = (off + 2 * b * n) % 2
        magic = off + 2 * b * n + pad
        levels += [n, off, off + b * n, magic, b]
        tables += [ids.ravel(), idx.ravel(), np.zeros(pad, np.int32),
                   straw2_magic(wl).ravel().astype("<u8").view("<i4")]
        off = magic + 2 * p * b * n
    bucket_levels = cm.n_levels - 1 if leaf else cm.n_levels
    header = [cm.n_levels, bucket_levels, p, int(firstn),
              1 + leaf_shift(vary_r) if leaf else 0, choose_tries,
              recurse_tries, off]
    return np.concatenate([np.asarray(header + levels, np.int32),
                           *[t.astype(np.int32) for t in tables]])


def _load(name: str) -> ctypes.CDLL:
    """The built library of K5's source ``name`` (``crush``, or a variant
    registered with ``_build.add_generated``), its entries typed."""
    lib = _build.library(name)
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.crush_map_rule.argtypes = [vp, ll, i, vp, vp, i, vp, vp, vp, i, i, vp]
    lib.crush_map_rule.restype = i
    lib.crush_config.argtypes = [i, i, vp]
    lib.crush_config.restype = i
    return lib


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    return _load("crush")


@functools.lru_cache(maxsize=None)
def _config(device_index: int, map_words: int) -> tuple[int, ...]:
    """``crush_config``'s info for a map of ``map_words`` on a device, asked
    once: the launches read their grid from it."""
    info = (ctypes.c_int * 5)()
    err = _lib().crush_config(device_index, map_words, info)
    if err:
        raise RuntimeError(f"crush_config failed with CUDA error {err}")
    return tuple(info)


def kernel_config(map_words: int, device: torch.device) -> dict:
    """K5's registers, shared memory, resident blocks a SM and local memory
    bytes for a map of ``map_words``, as the CUDA runtime reports them."""
    return dict(zip(("registers", "smem_bytes", "blocks_per_sm",
                     "local_bytes"), _config(device.index, map_words)))


def crush_map_rule(map_words: torch.Tensor, xs: torch.Tensor, numrep: int,
                   osd_weights: torch.Tensor) -> torch.Tensor:
    """One K5 launch: (L,) int32 seeds on a CUDA device -> (L, numrep) int32
    OSDs with CRUSH_ITEM_NONE holes.  ``map_words`` is
    ``kernel_map_words``'s array on the device, ``osd_weights`` int32
    covering every OSD of the map."""
    dev = xs.device
    n, words = xs.shape[0], map_words.shape[0]
    max_blocks = _config(dev.index, words)[4]
    out = torch.empty((n, numrep), dtype=torch.int32, device=dev)
    sel = torch.empty((n, numrep), dtype=torch.int32, device=dev)
    err = _lib().crush_map_rule(
        xs.data_ptr(), n, numrep, osd_weights.data_ptr(), map_words.data_ptr(),
        words, ln_words(dev).data_ptr(), out.data_ptr(), sel.data_ptr(),
        max_blocks, dev.index,
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err:
        raise RuntimeError(f"crush_map_rule: kernel launch failed with CUDA "
                           f"error {err}")
    LAUNCHES["crush_map_rule"] += 1
    return out


# -- the bulk mapper --------------------------------------------------------

class VectorCrush:
    """Bulk mapper for one (map, rule) pair, any uniform depth, on the card
    unless ``device="cpu"``."""

    def __init__(self, crush_map: CrushMap, ruleno: int,
                 choose_args: dict | None = None, device=None) -> None:
        (root_id, firstn, leaf, choose_tries, leaf_tries,
         choose_type, tunables) = _rule_shape(crush_map, ruleno)
        self.cm = CompiledMap.from_map(crush_map, root_id, choose_args)
        # chooseleaf picks buckets at the LAST bucket level then recurses
        # to an osd; plain choose must name the device level
        self.leaf = leaf
        if leaf:
            # the take root is never the chosen bucket (mapper.c skips a
            # rep whose draw from it is an osd), so a chooseleaf of a bucket
            # type straight from the osds' parent maps nothing
            if self.cm.n_levels < 2 and choose_type != 0:
                raise MapsNothing("chooseleaf from the osds' own parent "
                                  "maps nothing")
            # only the tree under THIS rule's take root matters
            if self.cm.leaf_parent_types != {choose_type}:
                raise Unexpressed(
                    "chooseleaf type must be the osd-parent level for "
                    "the fused path")
        elif choose_type != 0:
            raise Unexpressed("plain choose of a bucket type needs the "
                              "scalar engine")
        self.firstn = firstn
        self.choose_tries = choose_tries
        self.leaf_tries = leaf_tries
        self.vary_r = tunables["chooseleaf_vary_r"]
        self.stable = tunables["chooseleaf_stable"]
        self.descend_once = crush_map.tunables.chooseleaf_descend_once
        if firstn:
            self.recurse_tries = (leaf_tries if leaf_tries
                                  else (1 if self.descend_once
                                        else choose_tries))
        else:
            self.recurse_tries = leaf_tries if leaf_tries else 1
        if not self.stable or tunables["choose_local_tries"] \
                or tunables["choose_local_fallback_tries"]:
            raise Unexpressed("fused path implements jewel tunables "
                              "(chooseleaf_stable 1, no local retries; "
                              "any chooseleaf_vary_r)")
        self.device = resolve_device(device)
        cm, dev = self.cm, self.device
        self._ids = [torch.from_numpy(t.astype(np.int64)).to(dev)
                     for t in cm.child_ids]
        self._idx = [torch.from_numpy(t.astype(np.int64)).to(dev)
                     for t in cm.child_idx]
        w = cm.cw if cm.cw is not None else [t[None] for t in cm.weights]
        self._w = [torch.from_numpy(t.astype(np.int64)).to(dev) for t in w]
        self.map_words = torch.from_numpy(kernel_map_words(
            cm, firstn, leaf, choose_tries, self.recurse_tries,
            self.vary_r)).to(dev)
        # weight vectors on ``dev`` by their content (``device_weights``)
        self._weights: dict[bytes, torch.Tensor] = {}

    # -- plain PyTorch version ----------------------------------------------
    def _descend(self, x, r, pos, upto: int):
        """Lockstep descent of levels 0..upto-1, one draw per level; row
        indices into level ``upto``'s tables (osd ids when upto ==
        n_levels).  ``pos`` is the choose_args position: an int, or a
        per-lane tensor (firstn's placed count)."""
        cur = torch.zeros_like(x)
        for l in range(upto):
            wl = self._w[l]
            p = torch.clamp(torch.as_tensor(pos, device=x.device), 0,
                            wl.shape[0] - 1)
            draws = straw2_draws(x, self._ids[l][cur], r, wl[p, cur])
            cur = self._idx[l][cur, draws.argmax(dim=-1)]
        return cur

    def _leaf_descend(self, x, host, sub_r, rep, numrep, weights, taken, pos):
        """chooseleaf recursion into the chosen last-level bucket: up to
        recurse_tries draws, rejecting out osds and (firstn) the osds already
        placed."""
        lvl = self.cm.n_levels - 1
        wl = self._w[lvl]
        p = torch.clamp(torch.as_tensor(pos, device=x.device), 0,
                        wl.shape[0] - 1)
        found = torch.zeros_like(x, dtype=torch.bool)
        osd = torch.full_like(x, CRUSH_ITEM_NONE)
        for ft in range(self.recurse_tries):
            if bool(found.all()):
                break
            r_leaf = (sub_r + ft if self.firstn
                      else rep + sub_r + numrep * ft)
            draws = straw2_draws(x, self._ids[lvl][host], r_leaf,
                                 wl[p, host])
            cand = self._idx[lvl][host, draws.argmax(dim=-1)]
            bad = is_out(weights, cand, x)
            for t in taken:
                bad |= t == cand
            ok = ~found & ~bad
            osd = torch.where(ok, cand, osd)
            found |= ok
        return osd, found

    def map_firstn(self, xs: torch.Tensor, numrep: int,
                   osd_weights: torch.Tensor) -> torch.Tensor:
        """Plain firstn: (L,) int32 seeds -> (L, numrep) int32, placed OSDs
        first, CRUSH_ITEM_NONE after (the scalar engine compacts)."""
        x = xs.long() & _M32
        weights = osd_weights.long()
        levels = self.cm.n_levels - 1 if self.leaf else self.cm.n_levels
        out = torch.full((x.shape[0], numrep), CRUSH_ITEM_NONE,
                         dtype=torch.long, device=x.device)
        out_sel = torch.full_like(out, _NO_SEL)
        # per-lane count of placed replicas: the scalar engine's outpos, the
        # choose_args position of every draw
        placed = torch.zeros_like(x)
        for rep in range(numrep):
            ftotal = torch.zeros_like(x)
            done = torch.zeros_like(x, dtype=torch.bool)
            sel = torch.full_like(x, _NO_SEL)
            osd = torch.full_like(x, CRUSH_ITEM_NONE)
            while bool((~done & (ftotal < self.choose_tries)).any()):
                r = rep + ftotal
                cand_sel = self._descend(x, r, placed, levels)
                collide = (out_sel[:, :rep] == cand_sel[:, None]).any(dim=1)
                if self.leaf:
                    shift = leaf_shift(self.vary_r)
                    sub_r = r >> shift if shift < 32 else torch.zeros_like(r)
                    cand_osd, found = self._leaf_descend(
                        x, cand_sel, sub_r, rep, numrep, weights,
                        [out[:, j] for j in range(rep)], placed)
                    reject = ~found
                else:
                    cand_osd = cand_sel
                    reject = is_out(weights, cand_osd, x) | (
                        out[:, :rep] == cand_osd[:, None]).any(dim=1)
                ok = ~done & ~collide & ~reject
                sel = torch.where(ok, cand_sel, sel)
                osd = torch.where(ok, cand_osd, osd)
                done = done | ok
                ftotal = torch.where(done, ftotal, ftotal + 1)
            out[:, rep] = torch.where(done, osd, CRUSH_ITEM_NONE)
            out_sel[:, rep] = torch.where(done, sel, _NO_SEL)
            placed = placed + done.long()
        # an exhausted slot leaves no hole: placed entries first, in order
        order = torch.sort((out == CRUSH_ITEM_NONE).to(torch.int8), dim=1,
                           stable=True).indices
        return out.gather(1, order).to(torch.int32)

    def map_indep(self, xs: torch.Tensor, numrep: int,
                  osd_weights: torch.Tensor) -> torch.Tensor:
        """Plain indep: (L,) int32 seeds -> (L, numrep) int32, a slot that
        found nothing is CRUSH_ITEM_NONE in place."""
        x = xs.long() & _M32
        weights = osd_weights.long()
        levels = self.cm.n_levels - 1 if self.leaf else self.cm.n_levels
        out_h = torch.full((x.shape[0], numrep), CRUSH_ITEM_UNDEF,
                           dtype=torch.long, device=x.device)
        out_o = out_h.clone()
        for ftotal in range(self.choose_tries):
            if not bool((out_h == CRUSH_ITEM_UNDEF).any()):
                break
            for rep in range(numrep):
                slot_undef = out_h[:, rep] == CRUSH_ITEM_UNDEF
                r = torch.full_like(x, rep + numrep * ftotal)
                # the weight-set position is the top call's outpos (0); the
                # leaf recursion's outpos is the slot
                cand_sel = self._descend(x, r, 0, levels)
                collide = (out_h == cand_sel[:, None]).any(dim=1)
                if self.leaf:
                    osd, found = self._leaf_descend(
                        x, cand_sel, r, rep, numrep, weights, (), rep)
                else:
                    osd = cand_sel
                    found = ~is_out(weights, osd, x)
                ok = slot_undef & ~collide & found
                out_h[:, rep] = torch.where(ok, cand_sel, out_h[:, rep])
                out_o[:, rep] = torch.where(ok, osd, out_o[:, rep])
        return torch.where(out_o == CRUSH_ITEM_UNDEF, CRUSH_ITEM_NONE,
                           out_o).to(torch.int32)

    # -- K5's wrapper -------------------------------------------------------
    def device_weights(self, osd_weights) -> torch.Tensor:
        """``osd_weights`` as an int32 tensor on this mapper's device, padded
        with 0 (out) to the map's max_devices.  A tensor already on the
        device is used as it is; any other vector is made on the device
        once for each distinct content and kept (the newest
        ``_WEIGHTS_KEPT``), so the epochs and pools that map with the same
        weights upload them once.  The kept tensor is shared: callers do
        not write to it."""
        if isinstance(osd_weights, torch.Tensor) \
                and osd_weights.device == self.device:
            w = osd_weights.to(torch.int32).contiguous()
            short = self.cm.max_devices - w.shape[0]
            return torch.cat([w, w.new_zeros(short)]) if short > 0 else w
        if isinstance(osd_weights, torch.Tensor):
            # lint: disable=device-path-host-sync -- other-device weights: cached by bytes
            osd_weights = osd_weights.cpu().numpy()
        host = np.asarray(osd_weights, np.int64).astype(np.int32)
        short = self.cm.max_devices - host.shape[0]
        if short > 0:
            host = np.concatenate([host, np.zeros(short, np.int32)])
        key = host.tobytes()
        w = self._weights.get(key)
        if w is None:
            w = torch.from_numpy(host).to(self.device)
            WEIGHT_UPLOADS["crush_map_rule"] += 1
            while len(self._weights) >= _WEIGHTS_KEPT:
                self._weights.pop(next(iter(self._weights)))
            self._weights[key] = w
        return w

    def map_device(self, xs: torch.Tensor, numrep: int,
                   osd_weights) -> torch.Tensor:
        """(L,) int32 seeds on this mapper's device -> (L, numrep) int32 on
        it: K5 for a CUDA tensor, the plain version for a CPU tensor."""
        if not isinstance(xs, torch.Tensor) or xs.dtype != torch.int32 \
                or xs.dim() != 1:
            raise TypeError("map_device takes a 1-D int32 torch.Tensor")
        if xs.device != self.device:
            raise ValueError(f"seeds on {xs.device}, mapper on {self.device}")
        weights = self.device_weights(osd_weights)
        if numrep < 1 or xs.shape[0] == 0:
            return torch.full((xs.shape[0], max(numrep, 0)), CRUSH_ITEM_NONE,
                              dtype=torch.int32, device=xs.device)
        if xs.device.type == "cpu":
            plain = self.map_firstn if self.firstn else self.map_indep
            return plain(xs, numrep, weights)
        return crush_map_rule(self.map_words, xs.contiguous(), numrep,
                              weights)

    def map_pgs(self, xs, numrep: int, osd_weights) -> np.ndarray:
        """numpy seeds -> (L, numrep) int32 numpy rows (``seed_tensor``'s
        wrap)."""
        x = seed_tensor(xs, self.device)
        # lint: disable=device-path-host-sync -- numpy API: one post-launch hop
        return self.map_device(x, numrep, osd_weights).cpu().numpy()


def seed_tensor(xs, device) -> torch.Tensor:
    """numpy seeds -> the (L,) int32 tensor on ``device`` that
    ``VectorCrush.map_device`` takes.  Seeds are taken as their low 32 bits
    (pps values >= 2^31 wrap to int32, as the reference's
    ``jnp.asarray(xs, jnp.int32)`` does)."""
    seeds = (np.asarray(xs, np.int64) & _M32).astype(np.uint32)
    return torch.from_numpy(seeds.view(np.int32)).to(device)
