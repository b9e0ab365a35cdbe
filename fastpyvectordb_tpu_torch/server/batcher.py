"""Query coalescing: batch concurrent single-query requests into one device
dispatch.

The reference's batch path is 3-6x faster per query than its single path
(vectordb_optimized.py:577-644 vs :507) but servers only reach it when the
*client* batches.  On the card the gap is far larger (one scan amortizes
launches + HBM streaming over the whole batch), so the server coalesces
transparently.  Requests with different (collection, k, filter) land in
separate buckets so the fused mask stays per-bucket.

Coalescing is CONTINUOUS, not fixed-window: while a dispatch for a bucket
is in flight, new arrivals accumulate and flush as ONE batch the moment it
completes.  A fixed window only coalesces requests that
arrive within ~2 ms of each other — under concurrent load against a longer
dispatch the workers desynchronize and every request flushes alone,
serializing on the device.  In-flight-aware flushing batches at exactly the
rate the device can serve: one wave computes while the next accumulates.
"""

from __future__ import annotations

import asyncio
from typing import Dict, List, Optional, Tuple

import numpy as np


class QueueFull(RuntimeError):
    """Raised by admission control when a bucket's backlog exceeds
    ``max_queue``.  The server maps this to HTTP 503 + Retry-After so an
    open-loop overload degrades to fast rejections instead of unbounded
    queue growth."""


class QueryBatcher:
    def __init__(self, window_ms: float = 2.0, max_batch: int = 256,
                 max_queue: Optional[int] = None):
        self.window = window_ms / 1000.0
        self.max_batch = max_batch
        # admission bound per bucket: backlog beyond ~4 waves means every
        # new arrival already faces multi-second service lag — reject it
        # NOW (cheap) rather than park it (expensive for everyone)
        self.max_queue = max_queue if max_queue is not None else 4 * max_batch
        self._buckets: Dict[Tuple, List] = {}
        self._lock = asyncio.Lock()
        self._flusher: Dict[Tuple, asyncio.Task] = {}
        self._busy: Dict[Tuple, int] = {}  # in-flight dispatches per key
        # strong refs: the event loop only weak-refs scheduled tasks, so a
        # full-bucket flush task could be garbage-collected mid-flight and
        # every caller in the bucket would hang on its future
        self._inflight: set = set()

    async def search(self, collection, vector: np.ndarray, k: int,
                     filter=None, exact: Optional[bool] = None,
                     quantized: bool = False):
        """Await one query's results (List[SearchResult]), transparently
        batched."""
        return await self._enqueue(collection, vector, k, filter, exact,
                                   raw=False, quantized=quantized)

    async def search_raw(self, collection, vector: np.ndarray, k: int,
                         filter=None, exact: Optional[bool] = None,
                         quantized: bool = False):
        """Array-shaped variant for the binary wire path: resolves to
        ``(ids_row, scores_row, rows_row)`` from Collection.search_arrays
        — no SearchResult objects anywhere in the pipeline.  With
        ``quantized=True`` the wave dispatches through
        ``search_quantized_arrays`` instead (its own bucket): quantized
        singles coalesce exactly like exact ones, so concurrent quantized
        singles do not serialize on the device."""
        return await self._enqueue(collection, vector, k, filter, exact,
                                   raw=True, quantized=quantized)

    async def _enqueue(self, collection, vector, k, filter, exact, raw,
                       quantized=False):
        key = (id(collection), k,
               filter.fingerprint() if filter is not None else None,
               exact, raw, quantized)
        fut = asyncio.get_running_loop().create_future()
        async with self._lock:
            bucket = self._buckets.setdefault(key, [])
            if len(bucket) >= self.max_queue:
                raise QueueFull(
                    f"search backlog full ({len(bucket)} queued, "
                    f"limit {self.max_queue}); retry shortly")
            bucket.append((vector, fut, collection, filter))
            if self._busy.get(key):
                # a dispatch is computing right now: this request rides the
                # next wave, launched from _flush_loop the moment the
                # current one completes — no timer, no extra latency
                pass
            elif len(bucket) >= self.max_batch:
                self._spawn_flush(key)
            elif key not in self._flusher:
                self._flusher[key] = asyncio.get_running_loop().create_task(
                    self._delayed_flush(key))
        return await fut

    def _spawn_flush(self, key):
        """Start a flush loop for ``key``.  Caller holds the lock and has
        checked no other loop is active for the key."""
        self._busy[key] = self._busy.get(key, 0) + 1
        t = self._flusher.pop(key, None)
        if t:
            t.cancel()
        t = asyncio.get_running_loop().create_task(self._flush_loop(key))
        self._inflight.add(t)
        t.add_done_callback(self._inflight.discard)

    async def _delayed_flush(self, key):
        await asyncio.sleep(self.window)
        async with self._lock:
            self._flusher.pop(key, None)
            if self._buckets.get(key) and not self._busy.get(key):
                self._spawn_flush(key)

    async def _flush_loop(self, key):
        """Dispatch waves for ``key`` until its bucket drains.  Only one
        loop runs per key (guarded by _busy), so waves serialize on the
        device while arrivals accumulate behind them."""
        drained = False
        try:
            while True:
                async with self._lock:
                    bucket = self._buckets.get(key, [])
                    wave, rest = (bucket[:self.max_batch],
                                  bucket[self.max_batch:])
                    if rest:
                        self._buckets[key] = rest
                    else:
                        self._buckets.pop(key, None)
                    if not wave:
                        self._busy.pop(key, None)
                        drained = True
                        return
                await self._flush(wave, key[1], key[3], key[4], key[5])
        finally:
            # exception path ONLY: drop the busy marker so the key isn't
            # wedged.  The normal path already popped it under the lock —
            # and releasing that lock (the async __aexit__ before this
            # finally runs) is a suspension point where another task may
            # have legitimately spawned the NEXT loop; touching _busy here
            # would break that loop's single-owner guard.
            if not drained:
                async with self._lock:
                    self._busy.pop(key, None)
                    if self._buckets.get(key):
                        self._spawn_flush(key)

    async def _flush(self, bucket, k, exact, raw, quantized=False):
        # EVERYTHING inside the try: np.stack raises on inconsistent query
        # shapes (e.g. one wrong-dims query coalesced with good ones), and
        # an exception before set_exception would strand every future in
        # the bucket forever
        try:
            vectors = np.stack([b[0] for b in bucket])
            collection = bucket[0][2]
            filt = bucket[0][3]
            loop = asyncio.get_running_loop()
            if raw:
                if quantized:
                    ids, scores, rows = await loop.run_in_executor(
                        None, lambda: collection.search_quantized_arrays(
                            vectors, k, filter=filt))
                else:
                    ids, scores, rows = await loop.run_in_executor(
                        None, lambda: collection.search_arrays(
                            vectors, k, filt, exact))
                for i, (_, fut, _, _) in enumerate(bucket):
                    if not fut.done():
                        fut.set_result((ids[i], scores[i], rows[i]))
            else:
                if quantized:
                    results = await loop.run_in_executor(
                        None, lambda: collection.search_quantized(
                            vectors, k, filter=filt))
                else:
                    results = await loop.run_in_executor(
                        None, lambda: collection.search_batch(
                            vectors, k, filt, False, exact))
                for (_, fut, _, _), hits in zip(bucket, results):
                    if not fut.done():
                        fut.set_result(hits)
        except Exception as e:
            for _, fut, _, _ in bucket:
                if not fut.done():
                    fut.set_exception(e)
