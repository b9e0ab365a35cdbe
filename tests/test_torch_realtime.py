"""The port's realtime event system (the cases of
``tests/test_realtime.py``): subscriptions, manager replay, event bus,
observable collection.  Parity: the same event serialises to the same JSON
in both packages, and the same mutations of an observed collection emit
the same event stream."""

import asyncio
import time

import numpy as np
import pytest

from fastpyvectordb_tpu_torch import Collection, CollectionConfig
from fastpyvectordb_tpu_torch.realtime import (
    AsyncConnectionManager,
    Event,
    EventBus,
    EventType,
    ObservableCollection,
    Subscription,
)


class FakeSocket:
    def __init__(self, fail=False):
        self.messages = []
        self.fail = fail

    async def send_str(self, text):
        if self.fail:
            raise ConnectionError("gone")
        self.messages.append(text)


def test_event_roundtrip():
    e = Event(EventType.INSERT, "c", {"id": "x"})
    d = e.to_dict()
    e2 = Event.from_dict(d)
    assert e2.type == EventType.INSERT and e2.collection == "c"
    assert e2.data == {"id": "x"} and e2.id == e.id


def test_subscription_matching():
    e = Event(EventType.INSERT, "docs", {"metadata": {"team": "a"}})
    assert Subscription().matches(e)
    assert Subscription(collection="docs").matches(e)
    assert not Subscription(collection="other").matches(e)
    assert Subscription(event_types=[EventType.INSERT]).matches(e)
    assert not Subscription(event_types=[EventType.DELETE]).matches(e)
    assert Subscription(metadata_filter={"team": "a"}).matches(e)
    assert not Subscription(metadata_filter={"team": "b"}).matches(e)


def test_manager_broadcast_and_prune():
    async def run():
        mgr = AsyncConnectionManager()
        good, bad = FakeSocket(), FakeSocket(fail=True)
        await mgr.connect(good)
        await mgr.connect(bad, Subscription(collection="docs"))
        n = await mgr.broadcast(Event(EventType.INSERT, "docs", {"id": "1"}))
        assert n == 1  # bad socket failed
        assert mgr.connection_count == 1  # pruned
        assert len(good.messages) == 1
    asyncio.run(run())


def test_manager_replays_history():
    async def run():
        mgr = AsyncConnectionManager(replay=2)
        for i in range(5):
            await mgr.broadcast(Event(EventType.INSERT, "docs", {"i": i}))
        late = FakeSocket()
        await mgr.connect(late, Subscription(collection="docs"))
        assert len(late.messages) == 2  # last-N replay
        assert '"i": 4' in late.messages[-1]
    asyncio.run(run())


def test_event_bus_dispatch_and_overflow():
    bus = EventBus(max_queue=4)
    got = []
    bus.subscribe(got.append)
    # publish before starting the dispatcher: overflow must drop oldest
    for i in range(10):
        bus.publish(Event(EventType.INSERT, "c", {"i": i}))
    bus.start()
    deadline = time.time() + 5
    while len(got) < 4 and time.time() < deadline:
        time.sleep(0.01)
    bus.stop()
    assert [e.data["i"] for e in got] == [6, 7, 8, 9]  # last 4 survive
    assert bus.stats()["dropped"] == 6
    assert bus.stats()["running"] is False


def test_observable_collection_emits():
    events = []
    base = Collection(CollectionConfig(name="o", dimensions=4), device="cpu")
    col = ObservableCollection(base, events.append)
    rng = np.random.default_rng(0)
    col.insert(rng.standard_normal(4), "a", {"k": 1})
    col.insert_batch(rng.standard_normal((3, 4)), ["b", "c", "d"])
    col.upsert(rng.standard_normal(4), "a")   # update
    col.upsert(rng.standard_normal(4), "new")  # insert
    col.delete("a")
    col.delete("missing")
    types = [e.type for e in events]
    assert types == [EventType.INSERT, EventType.BATCH_INSERT,
                     EventType.UPDATE, EventType.INSERT, EventType.DELETE]
    # pass-through of non-mutating methods
    assert col.count() == 4
    assert col.search(rng.standard_normal(4), k=1)


def test_eventbus_stop_start_cycle_delivers():
    """A restarted bus must keep delivering (stale stop-sentinels in the
    queue must not kill the new dispatcher thread)."""
    import time
    from fastpyvectordb_tpu_torch.realtime import Event, EventBus, EventType
    bus = EventBus()
    seen = []
    bus.subscribe(lambda e: seen.append(e.data["i"]))
    bus.start()
    bus.publish(Event(EventType.INSERT, "c", {"i": 1}))
    time.sleep(0.2)
    bus.stop()
    bus.start()  # may race a stale None sentinel
    bus.publish(Event(EventType.INSERT, "c", {"i": 2}))
    time.sleep(0.3)
    bus.stop()
    assert 1 in seen and 2 in seen, seen


def test_observable_update_metadata_emits():
    import numpy as np
    from fastpyvectordb_tpu_torch import Collection, CollectionConfig
    from fastpyvectordb_tpu_torch.realtime import EventType, ObservableCollection
    events = []
    col = ObservableCollection(
        Collection(CollectionConfig(name="om", dimensions=4), device="cpu"),
        events.append)
    col.insert(np.ones(4, np.float32), "a", {"x": 1})
    col.update_metadata("a", {"x": 2})
    kinds = [e.type for e in events]
    assert EventType.UPDATE in kinds, kinds


def test_event_json_equals_the_jax_packages():
    from fastpyvectordb_tpu import realtime as jrt
    e = Event(EventType.BATCH_INSERT, "docs", {"count": 3, "ids": ["a"]})
    je = jrt.Event(jrt.EventType.BATCH_INSERT, "docs",
                   {"count": 3, "ids": ["a"]}, timestamp=e.timestamp,
                   id=e.id)
    assert e.to_json() == je.to_json()
    assert Event.from_dict(je.to_dict()).to_dict() == e.to_dict()
    assert [t.value for t in EventType] == [t.value for t in jrt.EventType]


def test_observed_mutations_emit_the_jax_packages_stream():
    from fastpyvectordb_tpu import Collection as JCollection
    from fastpyvectordb_tpu import CollectionConfig as JConfig
    from fastpyvectordb_tpu import realtime as jrt
    rng = np.random.default_rng(3)
    v = rng.standard_normal((6, 4)).astype(np.float32)
    streams = []
    for obs, col in ((ObservableCollection, Collection(
            CollectionConfig(name="p", dimensions=4), device="cpu")),
            (jrt.ObservableCollection,
             JCollection(JConfig(name="p", dimensions=4)))):
        got = []
        c = obs(col, got.append)
        c.insert(v[0], "a", {"k": 1})
        c.insert_batch(v[1:4], ["b", "c", "d"], [{"k": 2}] * 3)
        c.upsert(v[4], "a", {"k": 3})
        c.upsert(v[5], "e")
        c.update_metadata("b", {"k": 9})
        c.delete("c")
        c.delete("missing")
        streams.append([(e.type.value, e.collection, e.data) for e in got])
    assert streams[0] == streams[1]
