"""Object stores: transactional local storage under PGs.

Port of ``ceph_tpu/os/``: the stores are copied; ``device_cache.py`` keeps
its resident shard copies as torch tensors on the card.

API rendering of the reference's ObjectStore contract
(src/os/ObjectStore.h:63: queue_transactions :239, read :484, omap :708):
collections (one per PG) of objects, each with byte data, xattrs, and an
omap; all mutations batched in atomic Transactions.

Backends: MemStore (RAM, tests/dev -- the reference has src/os/memstore);
DBStore (SQLite WAL, relational schema); KVStore (everything through
the KeyValueDB abstraction -- the kstore role, os/kv.py holding the
KeyValueDB.h contract); BlockStore (raw-block BlueStore analog with
KV-backed metadata -- the performance store).
"""

from .transaction import Transaction  # noqa: F401
from .store import ObjectStore, MemStore, DBStore  # noqa: F401
from .kv import KeyValueDB, KVTransaction, MemKVDB, SqliteKVDB  # noqa: F401
from .kvstore import KVStore  # noqa: F401
