"""RGW bucket notifications: topics + reliable (persistent) delivery.

src/rgw/rgw_notify.cc role: buckets carry notification configurations
naming a TOPIC; object mutations (PUT/DELETE/multipart
complete/lifecycle expiration) that match a config's event types and
prefix/suffix filter become S3-shaped event records.  Reliable
("persistent") delivery is a per-topic QUEUE in RADOS: the event is
committed to the queue omap BEFORE the data op acks (the reference's
2-phase reserve/commit), and a delivery loop drains it to the topic's
endpoint, removing entries only after the endpoint acks -- so a
gateway crash mid-delivery redelivers from the durable queue instead
of losing the event (at-least-once; consumers dedup on the event id).

Endpoints: ``inproc://<name>`` dispatches to a handler registered in
this process (tests, embedded consumers); ``log://`` records to the
cluster log only.  An HTTP endpoint type would slot beside them (no
egress in this environment).

Port of ``ceph_tpu/rgw/notify.py``; runs unchanged over the
port's librados.
"""

from __future__ import annotations

import asyncio
import json
import os
import time

TOPICS_OID = "notify.topics"
QUEUE_FMT = "notify.queue.{topic}"

# handler registry for inproc:// endpoints: name -> async fn(event)
_INPROC: dict[str, object] = {}


def register_inproc_endpoint(name: str, handler) -> None:
    _INPROC[name] = handler


def _match(config: dict, event_type: str, key: str) -> bool:
    evs = [e for e in config.get("events", ["s3:ObjectCreated:*",
                                            "s3:ObjectRemoved:*"])
           if isinstance(e, str)]
    ok = any(event_type == e
             or (e.endswith("*") and event_type.startswith(e[:-1]))
             for e in evs)
    if not ok:
        return False
    f = config.get("filter", {})
    if f.get("prefix") and not key.startswith(f["prefix"]):
        return False
    if f.get("suffix") and not key.endswith(f["suffix"]):
        return False
    return True


class NotificationManager:
    def __init__(self, store) -> None:
        self.store = store
        self.ioctx = store.ioctx
        self._deliver_task: asyncio.Task | None = None
        self._seq = 0
        # per-manager entropy in queue keys: two gateways emitting in
        # the same millisecond with equal counters must not collide
        # (an omap overwrite would silently DROP an event)
        self._token = os.urandom(4).hex()
        self.stats = {"published": 0, "delivered": 0, "failed": 0}

    # -- topics ---------------------------------------------------------------
    async def create_topic(self, name: str, endpoint: str) -> dict:
        topic = {"name": name, "endpoint": endpoint,
                 "created": time.time()}
        await self.ioctx.set_omap(TOPICS_OID, {
            name: json.dumps(topic).encode()})
        return topic

    async def delete_topic(self, name: str) -> None:
        """Deleting a topic DROPS its undelivered events (S3
        semantics) -- and must reclaim the durable queue object, not
        orphan it."""
        from ..client.rados import RadosError
        try:
            await self.ioctx.rm_omap_keys(TOPICS_OID, [name])
        except RadosError:
            pass
        try:
            await self.ioctx.remove(QUEUE_FMT.format(topic=name))
        except RadosError:
            pass

    async def list_topics(self) -> dict[str, dict]:
        from ..client.rados import RadosError
        try:
            omap = await self.ioctx.get_omap(TOPICS_OID)
        except RadosError:
            return {}
        return {k: json.loads(v) for k, v in omap.items()}

    # -- bucket configuration -------------------------------------------------
    async def put_bucket_notification(self, bucket_name: str,
                                      configs: list[dict]) -> None:
        """configs: [{"id", "topic", "events": [...],
        "filter": {"prefix", "suffix"}}]"""
        topics = await self.list_topics()
        for c in configs:
            if c["topic"] not in topics:
                from .store import RgwError
                raise RgwError("NoSuchTopic", 404, c["topic"])
        bucket = await self.store.get_bucket(bucket_name)
        bucket["notifications"] = configs
        await self.store._save_bucket(bucket)

    async def get_bucket_notification(self,
                                      bucket_name: str) -> list[dict]:
        bucket = await self.store.get_bucket(bucket_name)
        return bucket.get("notifications", [])

    # -- event publication (called by the store BEFORE the op acks) ----------
    async def emit(self, bucket: dict, event_type: str, key: str,
                   size: int = 0, etag: str = "",
                   version_id: str = "") -> None:
        configs = bucket.get("notifications") or []
        matched = [c for c in configs if _match(c, event_type, key)]
        if not matched:
            return
        topics = await self.list_topics()
        for c in matched:
            topic = topics.get(c["topic"])
            if topic is None:
                continue              # topic deleted after config
            self._seq += 1
            eid = f"{int(time.time() * 1000):x}-{os.urandom(4).hex()}"
            event = {
                "eventVersion": "2.2",
                "eventName": event_type,
                "eventTime": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                           time.gmtime()),
                "eventId": eid,
                "configurationId": c.get("id", ""),
                "s3": {"bucket": {"name": bucket["name"]},
                       "object": {"key": key, "size": size,
                                  "eTag": etag,
                                  "versionId": version_id}},
            }
            # durable BEFORE the data op acks: the queue IS the
            # delivery guarantee (rgw_notify's reserve/commit)
            qoid = QUEUE_FMT.format(topic=c["topic"])
            qkey = (f"{int(time.time() * 1000):016d}"
                    f".{self._seq:08d}.{self._token}")
            await self.ioctx.set_omap(qoid, {
                qkey: json.dumps(event).encode()})
            self.stats["published"] += 1

    # -- delivery -------------------------------------------------------------
    async def deliver_once(self) -> int:
        """Drain every topic queue once; returns events delivered.
        Entries are removed only AFTER the endpoint acks -- a crash
        in between redelivers (at-least-once)."""
        from ..client.rados import RadosError
        n = 0
        for name, topic in (await self.list_topics()).items():
            qoid = QUEUE_FMT.format(topic=name)
            try:
                queue = await self.ioctx.get_omap(qoid)
            except RadosError:
                continue
            for qkey in sorted(queue):
                event = json.loads(queue[qkey])
                try:
                    await self._deliver(topic, event)
                except Exception:
                    self.stats["failed"] += 1
                    break             # keep order: retry next round
                await self.ioctx.rm_omap_keys(qoid, [qkey])
                self.stats["delivered"] += 1
                n += 1
        return n

    async def _deliver(self, topic: dict, event: dict) -> None:
        ep = topic["endpoint"]
        if ep.startswith("inproc://"):
            handler = _INPROC.get(ep[len("inproc://"):])
            if handler is None:
                raise RuntimeError(f"no inproc handler for {ep}")
            await handler(event)
        elif ep.startswith("log://"):
            pass                      # observability-only endpoint
        else:
            raise RuntimeError(f"unsupported endpoint {ep}")

    def start(self, interval: float = 0.5) -> None:
        if self._deliver_task is None or self._deliver_task.done():
            self._deliver_task = asyncio.ensure_future(
                self._loop(interval))

    async def stop(self) -> None:
        if self._deliver_task is not None:
            self._deliver_task.cancel()
            try:
                await self._deliver_task
            except (asyncio.CancelledError, Exception):
                pass
            self._deliver_task = None

    async def _loop(self, interval: float) -> None:
        try:
            while True:
                try:
                    await self.deliver_once()
                except Exception:
                    pass
                await asyncio.sleep(interval)
        except asyncio.CancelledError:
            pass
