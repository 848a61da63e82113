"""CRUSH map model: buckets, rules, tunables.

Data-model rendering of src/crush/crush.h: bucket algorithms
(crush.h:141-191), rule steps (crush.h:54-74), rule types (crush.h:97-100),
tunables (crush.h:374-395).  Weights are 16.16 fixed point throughout.
"""

from __future__ import annotations

from dataclasses import dataclass, field

CRUSH_BUCKET_UNIFORM = 1
CRUSH_BUCKET_LIST = 2
CRUSH_BUCKET_TREE = 3
CRUSH_BUCKET_STRAW = 4
CRUSH_BUCKET_STRAW2 = 5

CRUSH_ITEM_UNDEF = 0x7FFFFFFE
CRUSH_ITEM_NONE = 0x7FFFFFFF

CRUSH_HASH_RJENKINS1 = 0

# rule step ops
CRUSH_RULE_NOOP = 0
CRUSH_RULE_TAKE = 1
CRUSH_RULE_CHOOSE_FIRSTN = 2
CRUSH_RULE_CHOOSE_INDEP = 3
CRUSH_RULE_EMIT = 4
CRUSH_RULE_CHOOSELEAF_FIRSTN = 6
CRUSH_RULE_CHOOSELEAF_INDEP = 7
CRUSH_RULE_SET_CHOOSE_TRIES = 8
CRUSH_RULE_SET_CHOOSELEAF_TRIES = 9
CRUSH_RULE_SET_CHOOSE_LOCAL_TRIES = 10
CRUSH_RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES = 11
CRUSH_RULE_SET_CHOOSELEAF_VARY_R = 12
CRUSH_RULE_SET_CHOOSELEAF_STABLE = 13

# rule types
CRUSH_RULE_TYPE_REPLICATED = 1
CRUSH_RULE_TYPE_ERASURE = 3


@dataclass
class Tunables:
    """Default == "jewel" profile (CrushWrapper.h set_tunables_jewel)."""

    choose_local_tries: int = 0
    choose_local_fallback_tries: int = 0
    choose_total_tries: int = 50
    chooseleaf_descend_once: int = 1
    chooseleaf_vary_r: int = 1
    chooseleaf_stable: int = 1
    straw_calc_version: int = 1


@dataclass
class Bucket:
    id: int                      # negative
    type: int                    # bucket type id (host=1, rack=2, ... by map)
    alg: int = CRUSH_BUCKET_STRAW2
    hash: int = CRUSH_HASH_RJENKINS1
    items: list[int] = field(default_factory=list)
    item_weights: list[int] = field(default_factory=list)  # 16.16 fixed
    # tree/list buckets carry derived node/sum weights, built lazily
    _tree_node_weights: list[int] | None = None
    _list_sum_weights: list[int] | None = None

    @property
    def size(self) -> int:
        return len(self.items)

    @property
    def weight(self) -> int:
        return sum(self.item_weights)


@dataclass
class RuleStep:
    op: int
    arg1: int = 0
    arg2: int = 0


@dataclass
class Rule:
    rule_id: int
    type: int = CRUSH_RULE_TYPE_REPLICATED
    steps: list[RuleStep] = field(default_factory=list)


class CrushMap:
    def __init__(self, tunables: Tunables | None = None) -> None:
        self.buckets: dict[int, Bucket] = {}    # id (negative) -> bucket
        self.rules: dict[int, Rule] = {}
        self.tunables = tunables or Tunables()
        self.max_devices = 0
        self.type_names: dict[int, str] = {0: "osd", 1: "host", 2: "rack",
                                           10: "root"}
        self.bucket_names: dict[int, str] = {}
        self.device_classes: dict[int, str] = {}
        # choose_args (CrushWrapper.h choose_args_map_t): bucket id ->
        # {"weight_set": [[w per item] per position], "ids": [...]}.
        # The balancer's crush-compat mode steers placement by writing
        # position-specific weight overrides here instead of touching
        # the real hierarchy weights (mapper.c:289-306).
        self.choose_args: dict[int, dict] = {}

    def add_bucket(self, bucket: Bucket, name: str | None = None) -> None:
        assert bucket.id < 0, "bucket ids are negative"
        self.buckets[bucket.id] = bucket
        if name:
            self.bucket_names[bucket.id] = name
        for item in bucket.items:
            if item >= 0:
                self.max_devices = max(self.max_devices, item + 1)

    def add_rule(self, rule: Rule) -> None:
        self.rules[rule.rule_id] = rule

    def bucket(self, item_id: int) -> Bucket | None:
        return self.buckets.get(item_id)

    def create_choose_args(self, positions: int) -> None:
        """Seed a weight-set for every straw2 bucket with its current
        weights at every position (CrushWrapper::create_choose_args) --
        the starting point the balancer then adjusts."""
        for bid, b in self.buckets.items():
            self.choose_args[bid] = {
                "weight_set": [list(b.item_weights)
                               for _ in range(positions)]}

    def choose_args_adjust_item_weight(self, item: int,
                                       weight: int | list[int]) -> None:
        """Set ``item``'s weight-set weight in every bucket that holds
        it, one value per position (CrushWrapper::
        choose_args_adjust_item_weight)."""
        for bid, b in self.buckets.items():
            if item not in b.items:
                continue
            arg = self.choose_args.get(bid)
            if arg is None:
                continue
            i = b.items.index(item)
            ws = arg["weight_set"]
            for pos, row in enumerate(ws):
                row[i] = (weight[min(pos, len(weight) - 1)]
                          if isinstance(weight, list) else weight)

    def name_to_id(self, name: str) -> int | None:
        for bid, n in self.bucket_names.items():
            if n == name:
                return bid
        return None

    def is_device(self, item_id: int) -> bool:
        return item_id >= 0

    def item_type(self, item_id: int) -> int:
        if item_id >= 0:
            return 0
        b = self.buckets.get(item_id)
        return b.type if b else -1
