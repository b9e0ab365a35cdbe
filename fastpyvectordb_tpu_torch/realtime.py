"""Realtime change-feed events.

Parity with the reference's realtime layer (realtime.py:58-510): typed
events with ns-timestamp ids, wildcard subscriptions with event-type and
metadata-equality filters, an async connection manager with bounded history
replay, a thread-safe EventBus for sync producers, and an
ObservableCollection decorator that emits on every mutation.

Transport-agnostic by design: the connection manager talks to any object
with an async ``send_str(text)`` (aiohttp WebSocketResponse, the websockets
package, or the in-memory fake used in tests) — the reference hard-binds to
FastAPI WebSockets (realtime.py:125-235).
"""

from __future__ import annotations

import asyncio
import dataclasses
import enum
import json
import queue
import threading
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence


class EventType(str, enum.Enum):
    INSERT = "insert"
    UPDATE = "update"
    DELETE = "delete"
    SEARCH = "search"
    BATCH_INSERT = "batch_insert"
    COLLECTION_CREATED = "collection_created"
    COLLECTION_DELETED = "collection_deleted"


@dataclasses.dataclass
class Event:
    type: EventType
    collection: str
    data: dict = dataclasses.field(default_factory=dict)
    id: str = dataclasses.field(
        default_factory=lambda: f"evt_{time.time_ns()}")
    timestamp: float = dataclasses.field(default_factory=time.time)

    def to_dict(self) -> dict:
        return {"id": self.id, "type": self.type.value,
                "collection": self.collection, "timestamp": self.timestamp,
                "data": self.data}

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), default=str)

    @classmethod
    def from_dict(cls, d: dict) -> "Event":
        return cls(type=EventType(d["type"]), collection=d["collection"],
                   data=d.get("data", {}), id=d.get("id", ""),
                   timestamp=d.get("timestamp", 0.0))


@dataclasses.dataclass
class Subscription:
    """Match events by collection ("*" wildcard), type list, and
    metadata-equality filter (reference: realtime.py:91-118)."""
    collection: str = "*"
    event_types: Optional[Sequence[EventType]] = None
    metadata_filter: Optional[dict] = None

    def matches(self, event: Event) -> bool:
        if self.collection != "*" and self.collection != event.collection:
            return False
        if self.event_types is not None and \
                event.type not in tuple(self.event_types):
            return False
        if self.metadata_filter:
            meta = event.data.get("metadata") or {}
            for k, v in self.metadata_filter.items():
                if meta.get(k) != v:
                    return False
        return True


class AsyncConnectionManager:
    """WebSocket fan-out with per-socket subscriptions and replay.

    New connections replay the last matching events from a bounded history
    (reference: realtime.py:154-160); dead sockets are pruned on broadcast.
    """

    def __init__(self, history_size: int = 100, replay: int = 10):
        self._subs: Dict[Any, Subscription] = {}
        self._history: Deque[Event] = deque(maxlen=history_size)
        self._replay = replay
        self._lock = asyncio.Lock()
        self._lock_loop = None

    def _locked(self) -> asyncio.Lock:
        """The manager lock, rebound if the running loop changed: an
        asyncio.Lock binds to the first loop that awaits it, and emit()
        may legitimately route broadcasts onto a later loop (server
        restart, asyncio.run fallback) — awaiting the stale lock raises
        and silently drops the event inside the fire-and-forget task."""
        loop = asyncio.get_running_loop()
        if self._lock_loop is not loop:
            self._lock = asyncio.Lock()
            self._lock_loop = loop
        return self._lock

    @property
    def connection_count(self) -> int:
        return len(self._subs)

    async def connect(self, socket: Any,
                      subscription: Optional[Subscription] = None) -> None:
        sub = subscription or Subscription()
        self._loop = asyncio.get_running_loop()  # emit() routes here
        async with self._locked():
            self._subs[socket] = sub
            matching = [e for e in self._history if sub.matches(e)]
        for e in matching[-self._replay:]:
            try:
                await socket.send_str(e.to_json())
            except Exception:
                break

    async def disconnect(self, socket: Any) -> None:
        async with self._locked():
            self._subs.pop(socket, None)

    async def update_subscription(self, socket: Any,
                                  subscription: Subscription) -> None:
        async with self._locked():
            if socket in self._subs:
                self._subs[socket] = subscription

    async def broadcast(self, event: Event) -> int:
        """Send to matching live sockets; returns delivery count."""
        async with self._locked():
            self._history.append(event)
            targets = [(s, sub) for s, sub in self._subs.items()
                       if sub.matches(event)]
        sent, dead = 0, []
        payload = event.to_json()
        for sock, _ in targets:
            try:
                await sock.send_str(payload)
                sent += 1
            except Exception:
                dead.append(sock)
        if dead:
            async with self._locked():
                for s in dead:
                    self._subs.pop(s, None)
        return sent

    def emit(self, event: Event,
             loop: Optional[asyncio.AbstractEventLoop] = None) -> None:
        """Sync-context fire-and-forget (reference: realtime.py:217-230)."""
        try:
            running = asyncio.get_running_loop()
        except RuntimeError:
            running = None
        if running is not None:
            self._loop = running
            # keep a strong reference: asyncio only weakly references
            # scheduled tasks, so a fire-and-forget broadcast could be
            # garbage-collected before it runs (silently dropped event)
            tasks = getattr(self, "_bg_tasks", None)
            if tasks is None:
                tasks = self._bg_tasks = set()
            t = running.create_task(self.broadcast(event))
            tasks.add(t)
            t.add_done_callback(tasks.discard)
            return
        loop = loop or getattr(self, "_loop", None)
        if loop is not None and loop.is_running():
            # route to the loop the manager's lock/sockets live on — a
            # fresh asyncio.run loop would trip "lock bound to a
            # different event loop" once connect()/broadcast() ever ran
            asyncio.run_coroutine_threadsafe(self.broadcast(event), loop)
        else:
            asyncio.run(self.broadcast(event))


class EventBus:
    """Thread-safe bounded queue + daemon dispatcher for sync producers
    (reference: realtime.py:242-318).  Drop-oldest on overflow."""

    def __init__(self, max_queue: int = 10_000):
        self._q: "queue.Queue[Optional[Event]]" = queue.Queue(max_queue)
        self._subscribers: List[Callable[[Event], None]] = []
        self._lock = threading.Lock()
        self._dropped = 0
        self._thread: Optional[threading.Thread] = None
        self._running = False

    def subscribe(self, handler: Callable[[Event], None]) -> None:
        with self._lock:
            self._subscribers.append(handler)

    def unsubscribe(self, handler: Callable[[Event], None]) -> None:
        with self._lock:
            if handler in self._subscribers:
                self._subscribers.remove(handler)

    def start(self) -> None:
        if self._running:
            return
        self._running = True
        self._thread = threading.Thread(target=self._dispatch_loop,
                                        daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 2.0) -> None:
        if not self._running:
            return
        self._running = False
        try:
            # non-blocking: on a FULL queue the dispatcher may already
            # have observed _running=False and exited — a blocking put
            # would hang stop() forever; the join below suffices then
            self._q.put_nowait(None)
        except queue.Full:
            pass
        if self._thread:
            self._thread.join(timeout)

    def publish(self, event: Event) -> None:
        try:
            self._q.put_nowait(event)
        except queue.Full:
            try:
                self._q.get_nowait()  # drop oldest
            except queue.Empty:
                pass
            try:
                self._q.put_nowait(event)
            except queue.Full:
                # concurrent producers refilled the slot: drop THIS event
                # (bounded-queue semantics) rather than raise into a sync
                # mutation path that treats publish as never-failing
                pass
            self._dropped += 1

    def _dispatch_loop(self) -> None:
        while self._running:
            event = self._q.get()
            if event is None:
                # a sentinel from a PREVIOUS stop() may still sit in the
                # queue after a restart (stop's loop can exit on the
                # running flag without consuming it); only honor the
                # sentinel when we are actually shutting down
                if self._running:
                    continue
                break
            with self._lock:
                handlers = list(self._subscribers)
            for h in handlers:
                try:
                    h(event)
                except Exception:
                    pass

    def stats(self) -> dict:
        return {"queued": self._q.qsize(), "dropped": self._dropped,
                "subscribers": len(self._subscribers),
                "running": self._running}


class ObservableCollection:
    """Decorator emitting events on every mutation (reference:
    realtime.py:325-442).  ``sink`` is any callable taking an Event —
    an EventBus.publish, a connection manager's emit, or a test list."""

    def __init__(self, collection, sink: Callable[[Event], None],
                 name: Optional[str] = None):
        self._c = collection
        self._sink = sink
        self.name = name or collection.config.name

    def __getattr__(self, attr):
        return getattr(self._c, attr)

    def _emit(self, type: EventType, data: dict) -> None:
        try:
            self._sink(Event(type=type, collection=self.name, data=data))
        except Exception:
            pass

    def insert(self, vector, id=None, metadata=None) -> str:
        out = self._c.insert(vector, id, metadata)
        self._emit(EventType.INSERT, {"id": out, "metadata": metadata or {}})
        return out

    def insert_batch(self, vectors, ids=None, metadatas=None) -> List[str]:
        out = self._c.insert_batch(vectors, ids, metadatas)
        self._emit(EventType.BATCH_INSERT, {"ids": out, "count": len(out)})
        return out

    def upsert(self, vector, id, metadata=None) -> str:
        existed = self._c.get(id) is not None
        out = self._c.upsert(vector, id, metadata)
        self._emit(EventType.UPDATE if existed else EventType.INSERT,
                   {"id": out, "metadata": metadata or {}})
        return out

    def delete(self, id) -> bool:
        ok = self._c.delete(id)
        if ok:
            self._emit(EventType.DELETE, {"id": id})
        return ok

    def delete_batch(self, ids) -> int:
        n = self._c.delete_batch(ids)
        if n:
            self._emit(EventType.DELETE, {"ids": list(ids), "count": n})
        return n

    def update_metadata(self, id, metadata, merge: bool = True):
        out = self._c.update_metadata(id, metadata, merge)
        self._emit(EventType.UPDATE, {"id": id, "metadata": metadata or {},
                                      "merge": merge})
        return out

    def compact(self) -> int:
        n = self._c.compact()
        if n:
            self._emit(EventType.UPDATE, {"compacted": n})
        return n


def install_websocket_routes(app, manager: AsyncConnectionManager,
                             prefix: str = "/ws") -> None:
    """Reusable aiohttp WS route installer (reference parity:
    realtime.py:449-510 installs FastAPI routes).  Adds ``{prefix}`` and
    ``{prefix}/{collection}`` endpoints with subscribe/filter messages to
    any aiohttp application."""
    import json as _json

    from aiohttp import web, WSMsgType

    async def handler(request):
        ws = web.WebSocketResponse(heartbeat=30)
        await ws.prepare(request)
        collection = request.match_info.get("collection", "*")
        await manager.connect(ws, Subscription(collection=collection))
        try:
            async for msg in ws:
                if msg.type == WSMsgType.TEXT:
                    try:
                        payload = _json.loads(msg.data)
                    except _json.JSONDecodeError:
                        continue
                    if payload.get("action") == "subscribe":
                        types = payload.get("event_types")
                        try:
                            etypes = ([EventType(t) for t in types]
                                      if types else None)
                        except ValueError as e:
                            # a typo'd event type must not tear down an
                            # otherwise healthy realtime connection
                            await ws.send_str(_json.dumps(
                                {"subscribed": False, "error": str(e)}))
                            continue
                        await manager.update_subscription(ws, Subscription(
                            collection=payload.get("collection", collection),
                            event_types=etypes,
                            metadata_filter=payload.get("metadata_filter")))
                        await ws.send_str(_json.dumps({"subscribed": True}))
                elif msg.type in (WSMsgType.CLOSE, WSMsgType.ERROR):
                    break
        finally:
            await manager.disconnect(ws)
        return ws

    app.router.add_get(prefix, handler)
    app.router.add_get(prefix + "/{collection}", handler)
