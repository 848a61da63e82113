"""ObjectStore transactions: ordered op lists applied atomically.

Port of ``ceph_tpu/os/transaction.py``, copied: host code with no device
hop.

Op vocabulary follows src/os/Transaction.h (the subset the OSD data path
exercises): touch/write/zero/truncate/remove, xattr set/rm, omap
set/rmkeys/clear, clone, collection create/remove.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any


@dataclass
class Op:
    op: str
    coll: str
    oid: str = ""
    args: dict[str, Any] = field(default_factory=dict)


class Transaction:
    def __init__(self) -> None:
        self.ops: list[Op] = []

    # -- collections --------------------------------------------------------
    def create_collection(self, coll: str) -> "Transaction":
        self.ops.append(Op("mkcoll", coll))
        return self

    def remove_collection(self, coll: str) -> "Transaction":
        self.ops.append(Op("rmcoll", coll))
        return self

    # -- object data --------------------------------------------------------
    def touch(self, coll: str, oid: str) -> "Transaction":
        self.ops.append(Op("touch", coll, oid))
        return self

    def write(self, coll: str, oid: str, offset: int,
              data: bytes) -> "Transaction":
        self.ops.append(Op("write", coll, oid,
                           {"offset": offset, "data": bytes(data)}))
        return self

    def zero(self, coll: str, oid: str, offset: int,
             length: int) -> "Transaction":
        self.ops.append(Op("zero", coll, oid,
                           {"offset": offset, "length": length}))
        return self

    def truncate(self, coll: str, oid: str, size: int) -> "Transaction":
        self.ops.append(Op("truncate", coll, oid, {"size": size}))
        return self

    def remove(self, coll: str, oid: str) -> "Transaction":
        self.ops.append(Op("remove", coll, oid))
        return self

    def clone(self, coll: str, src: str, dst: str) -> "Transaction":
        self.ops.append(Op("clone", coll, src, {"dst": dst}))
        return self

    # -- xattrs -------------------------------------------------------------
    def setattr(self, coll: str, oid: str, name: str,
                value: bytes) -> "Transaction":
        self.ops.append(Op("setattr", coll, oid,
                           {"name": name, "value": bytes(value)}))
        return self

    def rmattr(self, coll: str, oid: str, name: str) -> "Transaction":
        self.ops.append(Op("rmattr", coll, oid, {"name": name}))
        return self

    # -- omap ---------------------------------------------------------------
    def omap_setkeys(self, coll: str, oid: str,
                     kv: dict[str, bytes]) -> "Transaction":
        self.ops.append(Op("omap_setkeys", coll, oid,
                           {"kv": {k: bytes(v) for k, v in kv.items()}}))
        return self

    def omap_rmkeys(self, coll: str, oid: str,
                    keys: list[str]) -> "Transaction":
        self.ops.append(Op("omap_rmkeys", coll, oid, {"keys": list(keys)}))
        return self

    def omap_clear(self, coll: str, oid: str) -> "Transaction":
        self.ops.append(Op("omap_clear", coll, oid))
        return self

    def append(self, other: "Transaction") -> "Transaction":
        self.ops.extend(other.ops)
        return self

    def __len__(self) -> int:
        return len(self.ops)
