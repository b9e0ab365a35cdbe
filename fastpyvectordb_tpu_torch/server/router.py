"""Shard router — one HTTP front over N single-chip engine servers.

A card is owned by exactly one process, so scale-out runs one engine
server per card with the corpus row-sharded across them.
This router is the stateless front: writes hash-route by id to their home
shard, searches fan out to every shard concurrently and merge top-k by
score (all metrics are lower-is-closer, core/types.py:24-28), so the
merged result is exactly what a single server over the union corpus would
return.  The reference has no multi-node story at all; its closest analog
is a plain HTTP load balancer, which cannot shard a corpus.

Run: ``python -m fastpyvectordb_tpu_torch.server.router --shard http://h1:8000
--shard http://h2:8000 --port 9000``.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import time
import uuid
import zlib
from typing import List, Optional

try:
    import aiohttp
    from aiohttp import web
except ImportError:  # pragma: no cover - aiohttp is in the base env
    aiohttp = None
    web = None

import numpy as np

from . import wire

JSON = "application/json"
MSGPACK = "application/msgpack"


def _shard_of(id: str, n: int) -> int:
    return zlib.crc32(str(id).encode("utf-8")) % n


def create_router_app(shards: List[str],
                      request_timeout: float = 120.0) -> "web.Application":
    """aiohttp application routing over ``shards`` (base URLs)."""
    if web is None:
        raise RuntimeError("aiohttp is required for the shard router")
    if not shards:
        raise ValueError("at least one shard URL is required")
    shards = [s.rstrip("/") for s in shards]
    n = len(shards)
    app = web.Application(client_max_size=1024 * 2**20)
    state = app["state"] = {"shards": shards}
    from .metrics import Metrics, install as install_metrics
    state["metrics"] = Metrics(namespace="fpvt_router")
    install_metrics(app, state["metrics"])

    async def session() -> aiohttp.ClientSession:
        if "session" not in state:
            state["session"] = aiohttp.ClientSession(
                timeout=aiohttp.ClientTimeout(total=request_timeout))
        return state["session"]

    async def _close(app):
        if "session" in state:
            await state["session"].close()

    app.on_cleanup.append(_close)

    async def _json_body(request):
        """Parse the JSON body or raise a clean 400 (app.py _body parity:
        malformed JSON / non-dict bodies must not surface as 500s)."""
        try:
            body = await request.json()
        except Exception:
            raise web.HTTPBadRequest(
                text='{"detail": "invalid JSON body"}',
                content_type="application/json")
        if not isinstance(body, dict):
            raise web.HTTPBadRequest(
                text='{"detail": "JSON body must be an object"}',
                content_type="application/json")
        return body

    def _err(status: int, detail: str):
        return web.json_response({"detail": detail}, status=status)

    async def _call(method: str, url: str, *, body=None, params=None):
        """One shard call; an unreachable shard is a 503 result, not a
        raised exception — fan-out callers must see partial failures so
        their degraded-coverage branches actually run, and single-shard
        handlers return a clean 503 instead of an opaque 500."""
        s = await session()
        try:
            async with s.request(method, url, json=body,
                                 params=params) as r:
                return r.status, await r.json(content_type=None)
        except Exception as e:
            return 503, {"detail": f"shard unreachable: {e}"}

    async def _post(url: str, body: dict):
        return await _call("POST", url, body=body)

    async def _post_binary(url: str, payload: bytes):
        """One msgpack shard call → (status, unpacked dict)."""
        s = await session()
        try:
            async with s.post(url, data=payload,
                              headers={"Content-Type": MSGPACK}) as r:
                raw = await r.read()
                try:
                    return r.status, wire.unpack(raw)
                except Exception:
                    return r.status, {"detail": raw[:200].decode(
                        "utf-8", "replace")}
        except Exception as e:
            return 503, {"detail": f"shard unreachable: {e}"}

    def _bin_resp(obj: dict, status: int = 200):
        return web.Response(body=wire.pack(obj), status=status,
                            content_type=MSGPACK)

    async def _fanout_post(path: str, body: dict):
        return await asyncio.gather(
            *[_post(u + path, body) for u in shards])

    # -- health / collections ------------------------------------------
    async def health(request):
        s = await session()

        async def one(u):
            try:
                async with s.get(u + "/health") as r:
                    return {"shard": u, "ok": r.status == 200,
                            **(await r.json(content_type=None))}
            except Exception as e:  # unreachable shard must not 500 the front
                return {"shard": u, "ok": False, "error": str(e)}

        per = await asyncio.gather(*[one(u) for u in shards])
        return web.json_response(
            {"status": "ok" if all(p["ok"] for p in per) else "degraded",
             "role": "shard-router", "n_shards": n, "shards": per})

    async def create_collection(request):
        body = await _json_body(request)
        outs = await _fanout_post("/collections", body)
        worst = max(outs, key=lambda o: o[0])
        # report the worst shard's own body with its status (success body
        # + error status would contradict); note partial DDL so the
        # operator can retry the failed shards
        payload = dict(worst[1]) if isinstance(worst[1], dict) else worst[1]
        if worst[0] >= 400 and any(o[0] < 400 for o in outs) \
                and isinstance(payload, dict):
            payload["partial"] = {u: o[0] for u, o in zip(shards, outs)}
        return web.json_response(payload, status=worst[0])

    async def delete_collection(request):
        # all shards in parallel; a down shard must not abort the loop
        # mid-way (silent partial DDL) — report it instead
        name = request.match_info["name"]
        outs = await asyncio.gather(
            *[_call("DELETE", f"{u}/collections/{name}") for u in shards])
        worst = max(o[0] for o in outs)
        payload = {"deleted": name}
        if worst >= 400 and any(o[0] < 400 for o in outs):
            payload["partial"] = {u: o[0] for u, o in zip(shards, outs)}
        return web.json_response(payload, status=worst)

    async def list_collections(request):
        """Aggregate per-shard counts (a single shard's local counts
        would understate every collection by ~n_shards and contradict
        GET /collections/{name})."""
        outs = await asyncio.gather(
            *[_call("GET", u + "/collections") for u in shards])
        oks = [o[1] for o in outs if o[0] == 200]
        if not oks:
            return _err(503, "no shard reachable")
        per_name = {}
        for out in oks:
            items = out.get("collections", out) if isinstance(out, dict)                 else out
            for info in items:
                name = info.get("name")
                cur = per_name.get(name)
                if cur is None:
                    per_name[name] = dict(info)  # first shard's count as-is
                elif "count" in cur:
                    cur["count"] = (cur.get("count", 0)
                                    + info.get("count", 0))
        listing = sorted(per_name.values(),
                         key=lambda i: i.get("name") or "")
        shaped = ({"collections": listing}
                  if isinstance(oks[0], dict) and "collections" in oks[0]
                  else listing)
        return web.json_response(shaped)

    async def get_collection(request):
        """Aggregate per-shard counts into one logical collection view."""
        name = request.match_info["name"]
        outs = await asyncio.gather(
            *[_call("GET", f"{u}/collections/{name}") for u in shards])
        infos = [o[1] for o in outs if o[0] == 200]
        if not infos:
            if any(o[0] == 503 for o in outs):
                return _err(503, "no shard reachable")
            return _err(404, f"collection {name!r} not found")
        agg = dict(infos[0])
        if "count" in agg:
            agg["count"] = sum(i.get("count", 0) for i in infos)
        agg["n_shards"] = n
        agg["shards_ok"] = len(infos)
        return web.json_response(agg, status=200)

    # -- writes: hash-route by id --------------------------------------
    async def insert(request):
        name = request.match_info["name"]
        body = await _json_body(request)
        if not body.get("id"):
            # assign the id here so routing stays deterministic
            body["id"] = str(uuid.uuid4())
        st, out = await _post(
            f"{shards[_shard_of(body['id'], n)]}/collections/{name}/vectors",
            body)
        return web.json_response(out, status=st)

    async def upsert(request):
        name = request.match_info["name"]
        body = await _json_body(request)
        if not body.get("id"):
            return _err(400, "upsert requires an id")
        u = shards[_shard_of(body["id"], n)]
        st, out = await _call("PUT", f"{u}/collections/{name}/vectors",
                              body=body)
        return web.json_response(out, status=st)

    async def insert_batch(request):
        name = request.match_info["name"]
        if request.content_type in wire.MSGPACK_TYPES:
            return await _insert_batch_binary(request, name)
        body = await _json_body(request)
        vectors = body.get("vectors") or []
        ids = body.get("ids") or [str(uuid.uuid4()) for _ in vectors]
        metas = body.get("metadatas")
        if len(ids) != len(vectors):
            return _err(400, "ids/vectors length mismatch")
        if metas is not None and len(metas) != len(vectors):
            return _err(400, "metadatas/vectors length mismatch")
        parts = {i: ([], [], []) for i in range(n)}
        for j, (v, rid) in enumerate(zip(vectors, ids)):
            sv, si, sm = parts[_shard_of(rid, n)]
            sv.append(v)
            si.append(rid)
            sm.append(metas[j] if metas else None)
        calls = []
        for i, (sv, si, sm) in parts.items():
            if not sv:
                continue
            calls.append(_post(
                f"{shards[i]}/collections/{name}/vectors/batch",
                {"vectors": sv, "ids": si,
                 "metadatas": sm if metas else None}))
        outs = await asyncio.gather(*calls)
        bad = [o for o in outs if o[0] >= 400]
        if bad:
            return web.json_response(bad[0][1], status=bad[0][0])
        return web.json_response({"ids": ids}, status=201)

    async def _insert_batch_binary(request, name: str):
        """Raw-f32 ingest split by id hash; row dims are inferred from the
        id count (the router doesn't know collection dims)."""
        try:
            body = wire.unpack(await request.read())
            raw = body.get("vectors")
            if not isinstance(raw, (bytes, bytearray, memoryview)):
                return _bin_resp(
                    {"detail": "binary insert requires raw-f32 vectors"}, 400)
            buf = np.frombuffer(raw, dtype="<f4")
            ids = body.get("ids")
            if not ids:
                return _bin_resp(
                    {"detail": "binary insert_batch requires ids (vector "
                     "count is inferred from them)"}, 400)
            if buf.size % len(ids):
                return _bin_resp(
                    {"detail": f"{buf.size * 4} bytes is not a whole "
                     f"number of rows for {len(ids)} ids"}, 400)
            vecs = buf.reshape(len(ids), -1)
            metas = body.get("metadatas")
            if metas is not None and len(metas) != len(ids):
                return _bin_resp(
                    {"detail": "metadatas/ids length mismatch"}, 400)
        except ValueError as e:
            return _bin_resp({"detail": str(e)}, 400)
        parts = {i: ([], [], []) for i in range(n)}
        for j, rid in enumerate(ids):
            sv, si, sm = parts[_shard_of(rid, n)]
            sv.append(j)
            si.append(rid)
            sm.append(metas[j] if metas else None)
        calls = []
        for i, (sv, si, sm) in parts.items():
            if not sv:
                continue
            calls.append(_post_binary(
                f"{shards[i]}/collections/{name}/vectors/batch",
                wire.pack({"vectors": np.ascontiguousarray(
                               vecs[sv]).tobytes(),
                           "ids": si,
                           "metadatas": sm if metas else None})))
        outs = await asyncio.gather(*calls)
        bad = [o for o in outs if o[0] >= 400]
        if bad:
            return _bin_resp(bad[0][1], bad[0][0])
        return _bin_resp({"ids": list(ids), "count": len(ids)}, 201)

    async def get_vector(request):
        name, rid = request.match_info["name"], request.match_info["id"]
        u = shards[_shard_of(rid, n)]
        st, out = await _call("GET", f"{u}/collections/{name}/vectors/{rid}",
                              params=dict(request.rel_url.query))
        return web.json_response(out, status=st)

    async def delete_vector(request):
        name, rid = request.match_info["name"], request.match_info["id"]
        u = shards[_shard_of(rid, n)]
        st, out = await _call(
            "DELETE", f"{u}/collections/{name}/vectors/{rid}")
        return web.json_response(out, status=st)

    async def list_ids(request):
        """Stable global pagination: shard order x per-shard insertion
        order.  A page at (offset, limit) needs at most offset+limit ids
        from each shard (not every id from every shard), and the shard's
        own count field supplies the exact global total."""
        name = request.match_info["name"]
        q = request.rel_url.query
        try:
            off = int(q.get("offset", 0))
            lim = int(q.get("limit", 100))
        except ValueError:
            return _err(400, "limit/offset must be integers")
        window = off + lim
        outs = await asyncio.gather(
            *[_call("GET", f"{u}/collections/{name}/ids",
                    params={"limit": str(window), "offset": "0"})
              for u in shards])
        ids: List[str] = []
        total = 0
        ok = 0
        for st, out in outs:
            if st == 200:
                ok += 1
                ids.extend(out["ids"])
                total += int(out.get("count", len(out["ids"])))
        if ok == 0:
            if any(st == 503 for st, _ in outs):
                return _err(503, "no shard reachable")
            return _err(404, f"collection {name!r} not found")
        resp = {"ids": ids[off: off + lim], "total": total}
        if ok < n:
            resp["shards_ok"] = ok
        return web.json_response(resp)

    # -- search: fan out + merge ---------------------------------------
    def _merge_hits(per_shard: List[List[dict]], k: int) -> List[dict]:
        flat = [h for hits in per_shard for h in hits]
        flat.sort(key=lambda h: h["score"])
        return flat[:k]

    def _merge_binary_rows(outs, k: int, single: bool, with_meta: bool):
        """Merge per-shard binary responses: per query, concatenate every
        shard's (ids, scores[, metadata]) top-k and keep the k smallest
        scores (empty slots carry +inf so they lose automatically).
        Returns (merged_ids, merged_scores (nq, k) f32, merged_md|None,
        shards_ok)."""
        oks = [o[1] for o in outs if o[0] == 200]
        id_grids, sc_grids, md_grids = [], [], []
        for out in oks:
            ids = [out["ids"]] if single else out["ids"]
            sc = np.frombuffer(out["scores"],
                               dtype="<f4").reshape(len(ids), -1)
            id_grids.append(ids)
            sc_grids.append(sc)
            if with_meta:
                md = out.get("metadata")
                if md is None:
                    # a shard without the metadata field still occupies
                    # score/id columns: substitute per-query None rows or
                    # every later shard's metadata lands on the wrong ids
                    md_grids.append([[None] * len(r) for r in ids])
                else:
                    md_grids.append([md] if single else md)
        nq = len(id_grids[0])
        all_sc = np.concatenate(sc_grids, axis=1)  # (nq, shards*k)
        order = np.argsort(all_sc, axis=1, kind="stable")[:, :k]
        merged_scores = np.take_along_axis(all_sc, order, axis=1)
        merged_ids, merged_md = [], []
        for qi in range(nq):
            flat_ids = [i for grid in id_grids for i in grid[qi]]
            merged_ids.append([flat_ids[j] for j in order[qi]])
            if with_meta:
                # alignment truth is the id grid: pad/trim each shard's
                # metadata row to its id row so column j always refers
                # to the same hit in flat_ids and flat_md
                flat_md = []
                for si, grid in enumerate(md_grids):
                    ids_row = id_grids[si][qi]
                    row = grid[qi] if grid[qi] is not None else []
                    row = (list(row) + [None] * len(ids_row))[:len(ids_row)]
                    flat_md.extend(row)
                merged_md.append([flat_md[j] if j < len(flat_md) else None
                                  for j in order[qi]])
        return (merged_ids, merged_scores,
                merged_md if with_meta else None, len(oks))

    def _merge_binary(outs, k: int, single: bool, with_meta: bool):
        merged_ids, merged_scores, merged_md, n_ok = _merge_binary_rows(
            outs, k, single, with_meta)
        resp = {"ids": merged_ids[0] if single else merged_ids,
                "scores": wire.encode_scores(
                    merged_scores[0] if single else merged_scores),
                "shards_ok": n_ok}
        if merged_md is not None:
            resp["metadata"] = merged_md[0] if single else merged_md
        return resp

    # -- router-level coalescing of single-query searches ---------------
    # Same continuous in-flight-aware design as server/batcher.py, but the
    # contended resource is the shard fleet: N concurrent singles collapse
    # into ONE binary /search/batch per shard per wave (N x shards HTTP
    # calls -> shards), and the engines see an already-batched dispatch.
    # No window: a lone request in a quiet period flushes immediately;
    # under load the next wave accumulates behind the in-flight one.
    coalesce_state = {"buckets": {}, "busy": {}, "lock": asyncio.Lock(),
                      "inflight": set()}

    async def _coalesce_submit(key, qbytes):
        cs = coalesce_state
        fut = asyncio.get_running_loop().create_future()
        async with cs["lock"]:
            cs["buckets"].setdefault(key, []).append((qbytes, fut))
            if not cs["busy"].get(key):
                cs["busy"][key] = 1
                t = asyncio.get_running_loop().create_task(
                    _coalesce_loop(key))
                cs["inflight"].add(t)
                t.add_done_callback(cs["inflight"].discard)
        return await fut

    async def _coalesce_loop(key):
        cs = coalesce_state
        try:
            while True:
                async with cs["lock"]:
                    bucket = cs["buckets"].get(key, [])
                    wave, rest = bucket[:256], bucket[256:]
                    if rest:
                        cs["buckets"][key] = rest
                    else:
                        cs["buckets"].pop(key, None)
                    if not wave:
                        cs["busy"].pop(key, None)
                        return
                await _coalesce_flush(key, wave)
        except BaseException:
            # cancellation path: drop the busy marker and hand any waiting
            # bucket to a fresh loop so its futures can't strand
            async with cs["lock"]:
                cs["busy"].pop(key, None)
                if cs["buckets"].get(key):
                    cs["busy"][key] = 1
                    t = asyncio.get_running_loop().create_task(
                        _coalesce_loop(key))
                    cs["inflight"].add(t)
                    t.add_done_callback(cs["inflight"].discard)
            raise

    async def _coalesce_flush(key, wave):
        name, k, mode, fjson, with_meta, _qlen = key
        try:
            body = {"vectors": b"".join(q for q, _ in wave), "k": k,
                    "include_metadata": with_meta}
            if mode and mode != "auto":
                body["mode"] = mode
            body.update(json.loads(fjson))
            payload = wire.pack(body)
            path = f"/collections/{name}/search/batch"
            outs = await asyncio.gather(
                *[_post_binary(u + path, payload) for u in shards])
            bad = [o for o in outs if o[0] >= 400]
            if len(bad) == len(outs):
                err = RuntimeError(
                    str(bad[0][1].get("detail", "all shards failed")))
                err.status = bad[0][0]
                err.body = bad[0][1]
                raise err
            ids, scores, md, n_ok = _merge_binary_rows(
                outs, k, single=False, with_meta=with_meta)
            for i, (_, fut) in enumerate(wave):
                if not fut.done():
                    fut.set_result((ids[i], scores[i],
                                    md[i] if md is not None else None,
                                    n_ok))
        except Exception as e:
            for _, fut in wave:
                if not fut.done():
                    fut.set_exception(e)

    def _filter_json(body: dict) -> str:
        """Canonical JSON of the request's filter fields: the coalescing
        bucket key AND the source the flush rebuilds the batch body from."""
        f = {}
        if body.get("where") is not None:
            f["where"] = body["where"]
        if body.get("filter_tree") is not None:
            f["filter_tree"] = body["filter_tree"]
        return json.dumps(f, sort_keys=True)

    async def _search_binary(request, single: bool):
        name = request.match_info["name"]
        payload = await request.read()
        try:
            body = wire.unpack(payload)
            k = int(body.get("k", 10))
        except (ValueError, TypeError) as e:
            return _bin_resp({"detail": f"bad msgpack body: {e}"}, 400)
        path = (f"/collections/{name}/search" if single
                else f"/collections/{name}/search/batch")
        t0 = time.perf_counter()
        outs = await asyncio.gather(
            *[_post_binary(u + path, payload) for u in shards])
        bad = [o for o in outs if o[0] >= 400]
        if len(bad) == len(outs):
            return _bin_resp(bad[0][1], bad[0][0])
        resp = _merge_binary(outs, k, single,
                             bool(body.get("include_metadata")))
        resp["took_ms"] = round((time.perf_counter() - t0) * 1e3, 3)
        return _bin_resp(resp)

    async def search(request):
        name = request.match_info["name"]
        t0 = time.perf_counter()
        if request.content_type in wire.MSGPACK_TYPES:
            try:
                body = wire.unpack(await request.read())
                k = int(body.get("k", 10))
            except (ValueError, TypeError) as e:
                return _bin_resp({"detail": f"bad msgpack body: {e}"}, 400)
            v = body.get("vector")
            if v is None:
                return _bin_resp({"detail": "vector required"}, 400)
            if not isinstance(v, (bytes, bytearray)):
                v = np.asarray(v, dtype=np.float32).tobytes()
            with_meta = bool(body.get("include_metadata"))
            key = (name, k, body.get("mode", "auto"), _filter_json(body),
                   with_meta, len(v))
            try:
                ids, scores, md, n_ok = await _coalesce_submit(key, bytes(v))
            except Exception as e:
                return _bin_resp(
                    getattr(e, "body", {"detail": str(e)}),
                    getattr(e, "status", 503))
            resp = {"ids": ids, "scores": wire.encode_scores(scores),
                    "shards_ok": n_ok,
                    "took_ms": round((time.perf_counter() - t0) * 1e3, 3)}
            if with_meta:
                resp["metadata"] = md
            return _bin_resp(resp)
        body = await _json_body(request)
        k = int(body.get("k", 10))
        if body.get("vector") is not None and not body.get("include_vectors"):
            # coalesce JSON singles through the binary shard path too:
            # metadata rides along so the response keeps its hit shape
            # an explicit boolean `exact` must survive even when mode is
            # the (truthy) default string "auto" — `or` short-circuited
            # on it and silently downgraded exact:true to an auto search
            mode = body.get("mode")
            if mode in (None, "auto"):
                mode = ("exact" if body.get("exact") is True
                        else "ann" if body.get("exact") is False else "auto")
            v = np.asarray(body["vector"], dtype=np.float32).tobytes()
            key = (name, k, mode, _filter_json(body), True, len(v))
            try:
                ids, scores, md, n_ok = await _coalesce_submit(key, v)
            except Exception as e:
                return web.json_response(
                    getattr(e, "body", {"detail": str(e)}),
                    status=getattr(e, "status", 503))
            hits = [{"id": i, "score": float(s),
                     "metadata": (md[j] if md else None) or {}}
                    for j, (i, s) in enumerate(zip(ids, scores))
                    if i is not None]
            return web.json_response(
                {"results": hits,
                 "took_ms": round((time.perf_counter() - t0) * 1e3, 3),
                 "shards_ok": n_ok})
        # text queries / vector-bearing responses: direct per-request
        # fan-out (the binary batch path cannot carry them)
        outs = await _fanout_post(f"/collections/{name}/search", body)
        bad = [o for o in outs if o[0] >= 400]
        if len(bad) == len(outs):
            return web.json_response(bad[0][1], status=bad[0][0])
        merged = _merge_hits(
            [o[1]["results"] for o in outs if o[0] == 200], k)
        return web.json_response(
            {"results": merged,
             "took_ms": round((time.perf_counter() - t0) * 1e3, 3),
             "shards_ok": sum(1 for o in outs if o[0] == 200)})

    async def search_batch(request):
        name = request.match_info["name"]
        if request.content_type in wire.MSGPACK_TYPES:
            return await _search_binary(request, single=False)
        body = await _json_body(request)
        k = int(body.get("k", 10))
        t0 = time.perf_counter()
        outs = await _fanout_post(f"/collections/{name}/search/batch", body)
        bad = [o for o in outs if o[0] >= 400]
        if len(bad) == len(outs):
            return web.json_response(bad[0][1], status=bad[0][0])
        oks = [o[1]["results"] for o in outs if o[0] == 200]
        nq = len(oks[0]) if oks else 0
        merged = [_merge_hits([res[i] for res in oks], k)
                  for i in range(nq)]
        return web.json_response(
            {"results": merged,
             "took_ms": round((time.perf_counter() - t0) * 1e3, 3),
             "shards_ok": len(oks)})

    async def build_index(request):
        name = request.match_info["name"]
        body = await _json_body(request)
        outs = await _fanout_post(f"/collections/{name}/index", body)
        worst = max(o[0] for o in outs)
        return web.json_response(
            {"built": body.get("kind"), "per_shard": [o[1] for o in outs]},
            status=worst)

    async def optimize_collection(request):
        """Fan optimize out to every shard; each picks its own serving
        mode (shards may differ — e.g. uneven row counts straddle the
        quantizer-build floor), which is correct because search fan-out
        merges exact-unit distances regardless of per-shard mode."""
        name = request.match_info["name"]
        body = await _json_body(request)
        outs = await _fanout_post(f"/collections/{name}/optimize", body)
        worst = max(o[0] for o in outs)
        return web.json_response({"per_shard": [o[1] for o in outs]},
                                 status=worst)

    async def admin_save(request):
        outs = await _fanout_post("/admin/save", {})
        return web.json_response({"saved": all(o[0] == 200 for o in outs)})

    r = app.router
    r.add_get("/health", health)
    r.add_get("/collections", list_collections)
    r.add_post("/collections", create_collection)
    r.add_get("/collections/{name}", get_collection)
    r.add_delete("/collections/{name}", delete_collection)
    r.add_post("/collections/{name}/vectors", insert)
    r.add_put("/collections/{name}/vectors", upsert)
    r.add_post("/collections/{name}/vectors/batch", insert_batch)
    r.add_get("/collections/{name}/vectors/{id}", get_vector)
    r.add_delete("/collections/{name}/vectors/{id}", delete_vector)
    r.add_get("/collections/{name}/ids", list_ids)
    r.add_post("/collections/{name}/search", search)
    r.add_post("/collections/{name}/search/batch", search_batch)
    r.add_post("/collections/{name}/index", build_index)
    r.add_post("/collections/{name}/optimize", optimize_collection)
    r.add_post("/admin/save", admin_save)
    return app


def main(argv: Optional[List[str]] = None) -> None:  # pragma: no cover
    ap = argparse.ArgumentParser(description="fastpyvectordb_tpu_torch shard router")
    ap.add_argument("--shard", action="append", required=True,
                    help="base URL of an engine server (repeatable)")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=9000)
    args = ap.parse_args(argv)
    web.run_app(create_router_app(args.shard), host=args.host,
                port=args.port, print=lambda *a: print(json.dumps(
                    {"router": True, "port": args.port,
                     "shards": args.shard})))


if __name__ == "__main__":  # pragma: no cover
    main()
