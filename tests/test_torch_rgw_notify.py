"""RGW bucket notifications: topics, event matching, persistent-queue
delivery surviving a gateway restart mid-delivery, lifecycle events.

Role analog: src/rgw/rgw_notify.cc (reserve/commit persistent queues),
rgw_pubsub topic + notification configuration.

The port's counterpart of ``tests/test_rgw_notify.py``: its cases on
``ceph_tpu_torch``, the daemons and librados on ``device="cpu"``.
"""

import asyncio

import pytest

from ceph_tpu_torch.rgw.notify import register_inproc_endpoint
from ceph_tpu_torch.rgw.store import RgwError, RgwStore
from torch_app_cases import OSD, Monitor, Rados, run


async def boot():
    mon = Monitor(rank=0, config={"mon_osd_min_down_reporters": 1})
    addr = await mon.start()
    mon.peer_addrs = [addr]
    osds = []
    for i in range(2):
        o = OSD(host=f"h{i}", whoami=i)
        await o.start(addr)
        osds.append(o)
    r = Rados(addr, name="client.rgw")
    await r.connect()
    await r.mon_command("osd pool create",
                        {"name": "rgw", "pg_num": 4, "size": 2})
    store = RgwStore(await r.open_ioctx("rgw"))
    return mon, addr, osds, r, store


async def shutdown(mon, osds, r):
    await r.shutdown()
    for o in osds:
        await o.stop()
    await mon.stop()


def test_events_published_filtered_and_delivered():
    async def main():
        mon, addr, osds, r, store = await boot()
        got: list[dict] = []

        async def sink(event):
            got.append(event)
        register_inproc_endpoint("sink1", sink)
        try:
            await store.create_bucket("b", "alice")
            await store.notify.create_topic("t1", "inproc://sink1")
            with pytest.raises(RgwError, match="NoSuchTopic"):
                await store.notify.put_bucket_notification(
                    "b", [{"id": "bad", "topic": "missing"}])
            await store.notify.put_bucket_notification("b", [
                {"id": "creates", "topic": "t1",
                 "events": ["s3:ObjectCreated:*"],
                 "filter": {"prefix": "logs/"}},
                {"id": "deletes", "topic": "t1",
                 "events": ["s3:ObjectRemoved:*"]}])
            await store.put_object("b", "logs/a.log", b"x" * 10,
                                   owner="alice")
            await store.put_object("b", "data/skip.bin", b"y",
                                   owner="alice")       # filtered out
            await store.delete_object("b", "data/skip.bin")
            assert await store.notify.deliver_once() == 2
            names = [(e["eventName"], e["s3"]["object"]["key"])
                     for e in got]
            assert names == [
                ("s3:ObjectCreated:Put", "logs/a.log"),
                ("s3:ObjectRemoved:Delete", "data/skip.bin")]
            assert got[0]["s3"]["object"]["size"] == 10
            assert got[0]["s3"]["bucket"]["name"] == "b"
        finally:
            await shutdown(mon, osds, r)
    run(main())


def test_delivery_survives_gateway_restart_mid_delivery():
    """The queue is durable in RADOS and entries are removed only
    after the endpoint acks: a gateway dying mid-delivery redelivers
    from the queue when a NEW gateway instance takes over."""
    async def main():
        mon, addr, osds, r, store = await boot()
        delivered: list[str] = []
        fail_once = {"armed": True}

        async def flaky(event):
            if fail_once["armed"]:
                fail_once["armed"] = False
                raise RuntimeError("endpoint down (gateway dies here)")
            delivered.append(event["eventId"])
        register_inproc_endpoint("flaky", flaky)
        try:
            await store.create_bucket("b", "alice")
            await store.notify.create_topic("t", "inproc://flaky")
            await store.notify.put_bucket_notification("b", [
                {"id": "all", "topic": "t",
                 "events": ["s3:ObjectCreated:*"]}])
            await store.put_object("b", "k1", b"one", owner="alice")
            await store.put_object("b", "k2", b"two", owner="alice")
            # first gateway: delivery fails on the first event and the
            # "gateway" dies -- nothing removed from the queue
            assert await store.notify.deliver_once() == 0
            assert delivered == []

            # a brand-new gateway instance over the same pool resumes
            # from the durable queue
            store2 = RgwStore(await r.open_ioctx("rgw"))
            n = await store2.notify.deliver_once()
            assert n == 2
            assert len(delivered) == 2
            # queue drained: nothing redelivers
            assert await store2.notify.deliver_once() == 0
            assert len(delivered) == 2
        finally:
            await shutdown(mon, osds, r)
    run(main())


def test_lifecycle_expiration_events():
    async def main():
        mon, addr, osds, r, store = await boot()
        got: list[dict] = []

        async def sink(event):
            got.append(event)
        register_inproc_endpoint("lc-sink", sink)
        try:
            await store.create_bucket("b", "alice")
            await store.notify.create_topic("lc", "inproc://lc-sink")
            await store.notify.put_bucket_notification("b", [
                {"id": "exp", "topic": "lc",
                 "events": ["s3:ObjectLifecycle:Expiration:*"]}])
            await store.set_bucket_lifecycle("b", [
                {"id": "r", "prefix": "", "days": 1,
                 "enabled": True}])
            await store.put_object("b", "old", b"stale", owner="alice")
            import time
            assert await store.lc_process(
                "b", now=time.time() + 3 * 86400) == 1
            await store.notify.deliver_once()
            assert [e["eventName"] for e in got] == \
                ["s3:ObjectLifecycle:Expiration:Current"]
            assert got[0]["s3"]["object"]["key"] == "old"
        finally:
            await shutdown(mon, osds, r)
    run(main())


def test_ordered_delivery_and_background_loop():
    async def main():
        mon, addr, osds, r, store = await boot()
        got: list[str] = []

        async def sink(event):
            got.append(event["s3"]["object"]["key"])
        register_inproc_endpoint("ordered", sink)
        try:
            await store.create_bucket("b", "alice")
            await store.notify.create_topic("t", "inproc://ordered")
            await store.notify.put_bucket_notification("b", [
                {"id": "all", "topic": "t",
                 "events": ["s3:ObjectCreated:*"]}])
            store.notify.start(interval=0.05)
            for i in range(8):
                await store.put_object("b", f"k{i}", b"v",
                                       owner="alice")
            for _ in range(100):
                if len(got) == 8:
                    break
                await asyncio.sleep(0.05)
            assert got == [f"k{i}" for i in range(8)], got
            await store.notify.stop()
        finally:
            await shutdown(mon, osds, r)
    run(main())


def test_gateway_notification_subresource():
    """S3 Put/GetBucketNotificationConfiguration over the real HTTP
    gateway + signed client."""
    from ceph_tpu_torch.rgw.client import S3Client
    from ceph_tpu_torch.rgw.gateway import Gateway

    async def main():
        mon, addr, osds, r, store = await boot()
        got = []

        async def sink(event):
            got.append(event["s3"]["object"]["key"])
        register_inproc_endpoint("gw-sink", sink)
        try:
            user = await store.create_user("alice", "Alice")
            gw = Gateway(store)
            gaddr = await gw.start()
            c = S3Client(gaddr, user["access_key"], user["secret"])
            await c.create_bucket("nb")
            await store.notify.create_topic("gw-t", "inproc://gw-sink")
            body = (
                '<NotificationConfiguration>'
                '<TopicConfiguration><Id>c1</Id>'
                '<Topic>arn:aws:sns:::gw-t</Topic>'
                '<Event>s3:ObjectCreated:*</Event>'
                '</TopicConfiguration></NotificationConfiguration>')
            st, _, _ = await c.request(
                "PUT", "/nb", query={"notification": ""},
                body=body.encode())
            assert st == 200
            st, _, out = await c.request(
                "GET", "/nb", query={"notification": ""})
            assert st == 200 and b"gw-t" in out
            await c.put_object("nb", "via-http", b"hello")
            await store.notify.deliver_once()
            assert got == ["via-http"]
            await gw.stop()
        finally:
            await shutdown(mon, osds, r)
    run(main())
