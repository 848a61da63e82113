"""Carry a CRUSH map across from another implementation.

A placement engine has no weights: the map is its state.  ``crush_to_dict``
and ``crush_map_from_dict`` are the counterparts of ``ceph_tpu/mon/
osdmap.py``'s ``crush_to_dict`` / ``crush_from_dict`` (the same dict), and
``choose_args`` travel beside the dict as plain ``{bucket id: {"weight_set":
[[...], ...], "ids": [...]}}`` dicts, so a map built anywhere maps the same
seeds here.
"""

from __future__ import annotations

from dataclasses import asdict

from .types import Bucket, CrushMap, Rule, RuleStep, Tunables


def crush_to_dict(cm: CrushMap) -> dict:
    return {
        "buckets": [
            {"id": b.id, "type": b.type, "alg": b.alg, "hash": b.hash,
             "items": list(b.items), "item_weights": list(b.item_weights),
             "name": cm.bucket_names.get(b.id, "")}
            for b in cm.buckets.values()
        ],
        "rules": [
            {"rule_id": r.rule_id, "type": r.type,
             "steps": [[s.op, s.arg1, s.arg2] for s in r.steps]}
            for r in cm.rules.values()
        ],
        "tunables": asdict(cm.tunables),
        "max_devices": cm.max_devices,
    }


def crush_map_from_dict(d: dict, choose_args: dict | None = None) -> CrushMap:
    """A ``CrushMap`` from ``crush_to_dict``'s dict, with ``choose_args``
    (bucket id -> {"weight_set", "ids"}) copied in as plain lists."""
    cm = CrushMap(tunables=Tunables(**d.get("tunables", {})))
    for bd in d.get("buckets", []):
        b = Bucket(id=bd["id"], type=bd["type"], alg=bd["alg"],
                   hash=bd.get("hash", 0), items=list(bd["items"]),
                   item_weights=list(bd["item_weights"]))
        cm.add_bucket(b, bd.get("name") or None)
    for rd in d.get("rules", []):
        cm.add_rule(Rule(rule_id=rd["rule_id"], type=rd["type"],
                         steps=[RuleStep(*s) for s in rd["steps"]]))
    cm.max_devices = max(cm.max_devices, d.get("max_devices", 0))
    for bid, arg in (choose_args or {}).items():
        cm.choose_args[int(bid)] = {
            key: ([[int(w) for w in row] for row in val]
                  if key == "weight_set" else [int(v) for v in val])
            for key, val in arg.items() if val is not None}
    return cm
