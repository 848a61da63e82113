"""General CRUSH on the card: kernel K6 ``crush_rule_lanes``.

K5 (``crush/vectorized.py``, ``csrc/crush.cu``) maps the shape nearly every
cluster runs -- a uniform-depth straw2 hierarchy under jewel tunables, one
take and one choose step -- and refuses every other shape with
``Unexpressed`` before any launch.  The reference sweeps such a (map, rule)
on the host with its scalar engine (``ceph_tpu/mon/pg_mapping.py:118-133``);
here kernel K6 (``csrc/crush_rule.cu``) runs that engine, ``crush_do_rule``
(``crush/mapper.py``), on the card, one thread a lane, so that the card maps
every shape:

* ``flatten_rule`` lays out the whole map and one rule as K6 reads it: int64
  words, a header with the tunables, a bucket slot table indexed by ``-1 -
  id``, a record a bucket with its items and the kind's own arrays (list
  weights and prefix sums, tree node weights built as ``mapper.py`` builds
  them, legacy straw values, straw2 weight rows per choose_args position and
  hash ids), then the rule's steps.  A straw bucket without straw values is
  written as the straw2 bucket the scalar engine draws it as.  A bucket
  item naming no bucket is a malformed map: ``ValueError``, on every route.
  A rule mapping more than ``MAX_RESULT`` replicas, K6's working vectors,
  raises ``ValueError`` too.
* ``crush_rule_lanes`` is one K6 launch; ``RuleLanes.map_device`` its
  wrapper: K6 for a CUDA tensor (a launch failure raises), the plain
  version for a CPU tensor.
* The plain version is the scalar engine swept over the lanes
  (``plain_rows``), the route a CPU build already takes.  It is not a
  lane-masked torch copy of five bucket kinds and a rule interpreter: such a
  copy would be a second large program that nothing else uses, and the
  scalar engine is the authority both K6 and any copy would answer to.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..device import resolve_device
from ..ops import _build
from .mapper import _build_tree_weights, crush_do_rule
from .types import (
    CRUSH_BUCKET_LIST,
    CRUSH_BUCKET_STRAW,
    CRUSH_BUCKET_STRAW2,
    CRUSH_BUCKET_TREE,
    CRUSH_ITEM_NONE,
    CrushMap,
)
from .vectorized import ln_words

# launches of K6, counted where the wrapper launches it
LAUNCHES = {"crush_rule_lanes": 0}

# the most replicas a rule may map: K6's working vectors w, o, c hold this
# many entries (kMaxResult in csrc/crush_rule.cu)
MAX_RESULT = 32

_HEADER_WORDS = 12
_RECORD_WORDS = 8


def _malformed(crush_map: CrushMap) -> None:
    for b in crush_map.buckets.values():
        for item in b.items:
            if item < 0 and item not in crush_map.buckets:
                raise ValueError(f"dangling bucket reference {item} in "
                                 f"bucket {b.id}")


def _tunable(t, name: str) -> int:
    value = int(getattr(t, name))
    if value < 0:
        raise ValueError(f"tunable {name} = {value} is negative")
    return value


def flatten_rule(crush_map: CrushMap, ruleno: int) -> np.ndarray:
    """The map and rule ``ruleno`` as K6's int64 words (the layout at the
    top of ``csrc/crush_rule.cu``), with the map's own choose_args, as
    ``crush_do_rule`` takes them.  Raises ``ValueError`` for a bucket item
    that names no bucket and ``KeyError`` for a rule the map lacks."""
    _malformed(crush_map)
    rule = crush_map.rules[ruleno]
    choose_args = getattr(crush_map, "choose_args", None) or {}
    t = crush_map.tunables
    slots = max((-1 - bid for bid in crush_map.buckets), default=-1) + 1
    words: list[int] = [0] * _HEADER_WORDS
    slot_off = len(words)
    words += [0] * slots
    for bid in sorted(crush_map.buckets, reverse=True):
        b = crush_map.buckets[bid]
        rec = len(words)
        words[slot_off - 1 - bid] = rec
        words += [0] * _RECORD_WORDS
        size = b.size
        alg, extra = b.alg, [0, 0, 0]

        def table(values) -> int:
            off = len(words)
            words.extend(int(v) for v in values)
            return off
        items = table(b.items)
        straws = getattr(b, "straws", None)
        if b.alg == CRUSH_BUCKET_LIST:
            sums = b._list_sum_weights
            if sums is None:
                sums = np.cumsum(np.asarray(b.item_weights, np.int64)).tolist()
            extra = [table(b.item_weights), table(sums), 0]
        elif b.alg == CRUSH_BUCKET_TREE:
            nodes = b._tree_node_weights
            if nodes is None:
                nodes = _build_tree_weights(b)
            extra = [len(nodes), table(nodes), 0]
        elif b.alg == CRUSH_BUCKET_STRAW and straws is not None:
            extra = [table(straws), 0, 0]
        elif b.alg in (CRUSH_BUCKET_STRAW, CRUSH_BUCKET_STRAW2):
            # straw without straw values: straw2 on its own weights and ids
            arg = (choose_args.get(b.id)
                   if b.alg == CRUSH_BUCKET_STRAW2 else None) or {}
            rows = arg.get("weight_set") or [b.item_weights]
            ids = arg.get("ids") or b.items
            if any(len(row) != size for row in rows) or len(ids) != size:
                raise ValueError(f"choose_args of bucket {b.id} do not "
                                 f"match its {size} items")
            alg = CRUSH_BUCKET_STRAW2
            extra = [len(rows), table(v for row in rows for v in row),
                     table(ids)]
        words[rec:rec + _RECORD_WORDS] = [b.id, b.type, alg, size, items,
                                          *extra]
    steps = len(words)
    for s in rule.steps:
        words += [s.op, s.arg1, s.arg2]
    words[:_HEADER_WORDS] = [
        crush_map.max_devices, slots, slot_off, len(rule.steps), steps,
        _tunable(t, "choose_total_tries") + 1,
        _tunable(t, "choose_local_tries"),
        _tunable(t, "choose_local_fallback_tries"),
        _tunable(t, "chooseleaf_descend_once"),
        _tunable(t, "chooseleaf_vary_r"),
        _tunable(t, "chooseleaf_stable"), len(words)]
    return np.asarray(words, np.int64)


def plain_rows(crush_map: CrushMap, ruleno: int, xs, numrep: int,
               weights) -> np.ndarray:
    """K6's plain version, and the host sweep of a CPU build: the scalar
    engine over every seed (low 32 bits), (L, numrep) int32 rows with
    CRUSH_ITEM_NONE holes."""
    xs = np.asarray(xs, np.int64) & 0xFFFFFFFF
    weights = [int(w) for w in weights]
    rows = np.full((len(xs), numrep), CRUSH_ITEM_NONE, dtype=np.int32)
    for i, x in enumerate(xs.tolist()):
        got = crush_do_rule(crush_map, ruleno, x, numrep, weights)[:numrep]
        rows[i, :len(got)] = got
    return rows


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    """K6's library (``csrc/crush_rule.cu``, built at first use), its
    entries typed."""
    lib = _build.library("crush_rule")
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.crush_rule_lanes.argtypes = [vp, ll, i, vp, i, vp, vp, vp, i, vp]
    lib.crush_rule_lanes.restype = i
    lib.crush_rule_config.argtypes = [i, vp]
    lib.crush_rule_config.restype = i
    lib.crush_rule_max_result.argtypes = []
    lib.crush_rule_max_result.restype = i
    if lib.crush_rule_max_result() != MAX_RESULT:
        raise RuntimeError("csrc/crush_rule.cu's kMaxResult differs from "
                           "rule_lanes.MAX_RESULT")
    return lib


@functools.lru_cache(maxsize=None)
def kernel_config(device_index: int) -> dict:
    """K6's registers, local memory bytes a thread and resident blocks a
    SM, as the CUDA runtime reports them."""
    info = (ctypes.c_int * 3)()
    err = _lib().crush_rule_config(device_index, info)
    if err:
        raise RuntimeError(f"crush_rule_config failed with CUDA error {err}")
    return dict(zip(("registers", "local_bytes", "blocks_per_sm"), info))


def crush_rule_lanes(words: torch.Tensor, xs: torch.Tensor, numrep: int,
                     osd_weights: torch.Tensor) -> torch.Tensor:
    """One K6 launch: (L,) int32 seeds on a CUDA device -> (L, numrep) int32
    items with CRUSH_ITEM_NONE holes.  ``words`` is ``flatten_rule``'s array
    on the device, ``osd_weights`` int32 16.16 reweights (an item past its
    end is out)."""
    dev = xs.device
    n = xs.shape[0]
    out = torch.empty((n, numrep), dtype=torch.int32, device=dev)
    n_w = osd_weights.shape[0]
    err = _lib().crush_rule_lanes(
        xs.data_ptr(), n, numrep, osd_weights.data_ptr() if n_w else None,
        n_w, words.data_ptr(), ln_words(dev).data_ptr(), out.data_ptr(),
        dev.index, ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err:
        raise RuntimeError(f"crush_rule_lanes: kernel launch failed with "
                           f"CUDA error {err}")
    LAUNCHES["crush_rule_lanes"] += 1
    return out


class RuleLanes:
    """One (map, rule) flattened for K6, its words on ``device`` (the card
    unless ``device="cpu"``)."""

    def __init__(self, crush_map: CrushMap, ruleno: int,
                 device=None) -> None:
        self.crush_map = crush_map
        self.ruleno = ruleno
        self.device = resolve_device(device)
        self.words = torch.from_numpy(flatten_rule(crush_map,
                                                   ruleno)).to(self.device)

    def map_device(self, xs: torch.Tensor, numrep: int,
                   osd_weights) -> torch.Tensor:
        """(L,) int32 seeds on this mapper's device -> (L, numrep) int32 on
        it: K6 for a CUDA tensor, the scalar engine for a CPU tensor."""
        if not isinstance(xs, torch.Tensor) or xs.dtype != torch.int32 \
                or xs.dim() != 1:
            raise TypeError("map_device takes a 1-D int32 torch.Tensor")
        if xs.device != self.device:
            raise ValueError(f"seeds on {xs.device}, mapper on {self.device}")
        if numrep > MAX_RESULT:
            raise ValueError(f"K6 maps at most {MAX_RESULT} replicas a rule, "
                             f"not {numrep}")
        if numrep < 1 or xs.shape[0] == 0:
            return torch.full((xs.shape[0], max(numrep, 0)), CRUSH_ITEM_NONE,
                              dtype=torch.int32, device=xs.device)
        if not isinstance(osd_weights, torch.Tensor):
            osd_weights = torch.from_numpy(np.asarray(osd_weights, np.int64))
        if xs.device.type == "cpu":
            return torch.from_numpy(plain_rows(
                self.crush_map, self.ruleno, xs.numpy(), numrep,
                osd_weights.tolist()))
        w = osd_weights.to(self.device, torch.int32).contiguous()
        return crush_rule_lanes(self.words, xs.contiguous(), numrep, w)
