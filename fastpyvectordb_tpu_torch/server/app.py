"""REST + WebSocket server (aiohttp).

Parity with both reference server tiers — vector-only (server.py:136-449)
and full (server_full.py: graph REST, text auto-embed, embeddings
endpoints, WebSocket change feeds) — as one application factory with
feature flags.  FastAPI/uvicorn are not available in this environment, so
the app is built on aiohttp with pydantic request validation
(server/schemas.py).

Single-query search requests are transparently coalesced into batched
device dispatches (server/batcher.py).  The database, and the ``jax``
(transformer) embedder, live on ``device``: the card unless the caller
passes ``device="cpu"``.

Endpoints (vector tier):
  GET  /health
  GET/POST /collections ; GET/DELETE /collections/{name}
  POST /collections/{name}/vectors[/batch] ; PUT .../vectors (upsert)
  GET/DELETE /collections/{name}/vectors/{id}
  POST /collections/{name}/search[/batch]      (vector or text)
  GET  /collections/{name}/ids
  POST /admin/save
Full tier adds:
  POST /collections/{name}/texts
  /graph/nodes|edges|hyperedges CRUD, /graph/query, /graph/traverse,
  /graph/shortest-path, /graph/neighbors/{id}
  POST /embeddings/embed[-batch]
  WS   /ws , /ws/{collection}
"""

from __future__ import annotations

import asyncio
import json
import time
from typing import Optional

import numpy as np

try:
    from aiohttp import web, WSMsgType
    HAS_AIOHTTP = True
except ImportError:  # pragma: no cover
    HAS_AIOHTTP = False
    web = None

from pydantic import ValidationError

from ..ann import KINDS as ANN_KINDS
from ..core.filters import Filter, filter_from_tree
from ..core.vectordb import VectorDB
from ..embeddings import get_embedder
from ..graphdb import GraphDB
from ..realtime import AsyncConnectionManager, Event, EventType, Subscription
from . import schemas as S
from . import wire
from .batcher import QueryBatcher, QueueFull

JSON = "application/json"
MSGPACK = "application/msgpack"


def _json_error(status: int, message: str):
    return web.json_response({"detail": message}, status=status)


def _parse(model, payload: dict):
    try:
        return model.model_validate(payload or {})
    except ValidationError as e:
        raise web.HTTPUnprocessableEntity(
            text=json.dumps({"detail": json.loads(e.json())}),
            content_type=JSON)


async def _body(request) -> dict:
    try:
        return await request.json()
    except json.JSONDecodeError:
        raise web.HTTPBadRequest(
            text=json.dumps({"detail": "invalid JSON body"}),
            content_type=JSON)


def _filter_of(req) -> Optional[Filter]:
    if getattr(req, "filter_tree", None):
        return filter_from_tree(req.filter_tree)
    return Filter.from_dict(getattr(req, "where", None))


def _hit_dict(h, include_vector=False) -> dict:
    d = {"id": h.id, "score": h.score, "metadata": h.metadata}
    if include_vector and h.vector is not None:
        d["vector"] = np.asarray(h.vector).tolist()
    return d


def create_app(db_path: str = "./vectordb_data", *, full: bool = True,
               embedding_provider: str = "auto",
               graph_path: Optional[str] = None,
               batch_window_ms: float = 2.0, batch_max: int = 256,
               cors: bool = True, prewarm: int = 0,
               device=None) -> "web.Application":
    if not HAS_AIOHTTP:
        raise RuntimeError("aiohttp is required for the server")

    app = web.Application(client_max_size=256 * 1024 * 1024)
    vdb = VectorDB(db_path, device=device)
    state = app["state"] = {
        "db": vdb,
        "graph": GraphDB(graph_path or f"{db_path}/_graph") if full else None,
        "embedder": None,
        "embedding_provider": embedding_provider,
        "ws": AsyncConnectionManager(),
        "batcher": QueryBatcher(window_ms=batch_window_ms,
                                max_batch=batch_max),
        "started": time.time(),
        "full": full,
    }

    from .metrics import Metrics, install as install_metrics
    metrics = state["metrics"] = Metrics()

    def _refresh_gauges(m: Metrics) -> None:
        names = state["db"].list_collections()
        m.set_gauge("collections", len(names))
        rows = 0
        for n in names:  # a concurrent delete between list and read is ok
            try:
                rows += state["db"][n].count()
            except KeyError:
                pass
        m.set_gauge("rows_total", rows)
        m.set_gauge("websocket_connections",
                    state["ws"].connection_count)

    install_metrics(app, metrics, gauge_hook=_refresh_gauges)

    def embedder():
        if state["embedder"] is None:
            state["embedder"] = get_embedder(state["embedding_provider"],
                                             device=vdb.device)
        return state["embedder"]

    def db() -> VectorDB:
        return state["db"]

    def collection_or_404(name: str):
        try:
            return db().get_collection(name)
        except KeyError:
            raise web.HTTPNotFound(
                text=json.dumps({"detail": f"collection {name!r} not found"}),
                content_type=JSON)

    _bg_tasks = set()  # strong refs: bare create_task results can be GC'd

    async def broadcast(event: Event):
        # fire-and-forget: the manager sends to subscribers serially, so
        # awaiting here would hold every insert/delete HTTP response
        # hostage to the slowest websocket consumer's TCP buffer
        t = asyncio.get_running_loop().create_task(
            state["ws"].broadcast(event))
        _bg_tasks.add(t)
        t.add_done_callback(_bg_tasks.discard)

    # ------------------------------------------------------------------
    # health / collections
    # ------------------------------------------------------------------
    async def health(request):
        info = {
            "status": "ok",
            "uptime_s": round(time.time() - state["started"], 3),
            "collections": len(db().list_collections()),
            "websocket_connections": state["ws"].connection_count,
        }
        rebuilding = [n for n in db().list_collections()
                      if (t := db()[n]._rebuild_thread) is not None
                      and t.is_alive()]
        if rebuilding:  # background index rebuilds in flight (observable
            info["rebuilding"] = rebuilding  # so ops can defer compaction)
        if state["graph"] is not None:
            info["graph"] = state["graph"].stats()
        if state["embedder"] is not None:
            info["embedder"] = state["embedder"].model_name
        return web.json_response(info)

    async def list_collections(request):
        out = []
        for name in db().list_collections():
            c = db()[name]
            out.append(S.CollectionInfo(
                name=name, dimensions=c.config.dimensions,
                metric=c.config.metric.value, count=c.count(),
                index=c.config.index).model_dump())
        return web.json_response({"collections": out})

    async def create_collection(request):
        req = _parse(S.CreateCollectionRequest, await _body(request))
        try:
            c = db().create_collection(req.name, req.dimensions,
                                       metric=req.metric, index=req.index,
                                       compute_dtype=req.compute_dtype,
                                       storage_dtype=req.storage_dtype,
                                       topk=req.topk)
        except ValueError as e:
            # only duplicate names are a Conflict; validation errors (bad
            # metric/index/dtype) are 400 — a client treating 409 as
            # "already exists" would skip creation and fail downstream
            status = 409 if "already exists" in str(e) else 400
            return _json_error(status, str(e))
        await broadcast(Event(EventType.COLLECTION_CREATED, req.name))
        return web.json_response(
            {"name": req.name, "dimensions": c.config.dimensions}, status=201)

    async def get_collection(request):
        c = collection_or_404(request.match_info["name"])
        return web.json_response(S.CollectionInfo(
            name=c.config.name, dimensions=c.config.dimensions,
            metric=c.config.metric.value, count=c.count(),
            index=c.config.index).model_dump())

    async def delete_collection(request):
        name = request.match_info["name"]
        if not db().delete_collection(name):
            return _json_error(404, f"collection {name!r} not found")
        await broadcast(Event(EventType.COLLECTION_DELETED, name))
        return web.json_response({"deleted": name})

    # ------------------------------------------------------------------
    # vectors
    # ------------------------------------------------------------------
    async def insert_vector(request):
        name = request.match_info["name"]
        c = collection_or_404(name)
        req = _parse(S.InsertVectorRequest, await _body(request))
        try:
            rid = await _off(c.insert,
                             np.asarray(req.vector, dtype=np.float32),
                             req.id, req.metadata)
        except ValueError as e:
            return _json_error(400, str(e))
        await broadcast(Event(EventType.INSERT, name,
                              {"id": rid, "metadata": req.metadata or {}}))
        return web.json_response({"id": rid}, status=201)

    async def insert_batch(request):
        name = request.match_info["name"]
        c = collection_or_404(name)
        if wire.is_binary(request):
            # raw-f32 ingest (see server/wire.py): no JSON decode of
            # 768-d rows
            try:
                body = wire.unpack(await request.read())
                vectors = wire.decode_matrix(body.get("vectors"),
                                             c.config.dimensions)
                ids = await asyncio.get_running_loop().run_in_executor(
                    None, lambda: c.insert_batch(
                        vectors, body.get("ids"), body.get("metadatas")))
            except ValueError as e:
                return web.Response(body=wire.pack({"detail": str(e)}),
                                    status=400, content_type=MSGPACK)
            await broadcast(Event(EventType.BATCH_INSERT, name,
                                  {"count": len(ids)}))
            return web.Response(
                body=wire.pack({"ids": ids, "count": len(ids)}),
                status=201, content_type=MSGPACK)
        req = _parse(S.InsertBatchRequest, await _body(request))
        try:
            ids = await _off(
                c.insert_batch, np.asarray(req.vectors, dtype=np.float32),
                req.ids, req.metadatas)
        except ValueError as e:
            return _json_error(400, str(e))
        await broadcast(Event(EventType.BATCH_INSERT, name,
                              {"count": len(ids)}))
        return web.json_response({"ids": ids, "count": len(ids)}, status=201)

    async def upsert_vector(request):
        name = request.match_info["name"]
        c = collection_or_404(name)
        req = _parse(S.InsertVectorRequest, await _body(request))
        if req.id is None:
            return _json_error(400, "upsert requires an id")
        try:
            # upsert2 reports existence atomically under the collection
            # lock — a separate pre-read races concurrent upserts and can
            # broadcast the wrong event type
            rid, existed = await _off(
                c.upsert2, np.asarray(req.vector, dtype=np.float32),
                req.id, req.metadata)
        except ValueError as e:  # dims mismatch etc. -> 400 like insert
            return _json_error(400, str(e))
        await broadcast(Event(
            EventType.UPDATE if existed else EventType.INSERT, name,
            {"id": rid, "metadata": req.metadata or {}}))
        return web.json_response({"id": rid, "updated": existed})

    async def get_vector(request):
        c = collection_or_404(request.match_info["name"])
        rid = request.match_info["id"]
        include = request.query.get("include_vector", "false") == "true"
        row = await _off(c.get, rid, include_vector=include)
        if row is None:
            return _json_error(404, f"id {rid!r} not found")
        if include:
            row["vector"] = np.asarray(row["vector"]).tolist()
        return web.json_response(row)

    async def delete_vector(request):
        name = request.match_info["name"]
        c = collection_or_404(name)
        rid = request.match_info["id"]
        if not await _off(c.delete, rid):
            return _json_error(404, f"id {rid!r} not found")
        await broadcast(Event(EventType.DELETE, name, {"id": rid}))
        return web.json_response({"deleted": rid})

    async def list_ids(request):
        c = collection_or_404(request.match_info["name"])
        try:
            limit = int(request.query.get("limit", 100))
            offset = int(request.query.get("offset", 0))
        except ValueError:
            return _json_error(400, "limit/offset must be integers")
        return web.json_response({"ids": c.list_ids(limit, offset),
                                  "count": c.count()})

    # ------------------------------------------------------------------
    # search
    # ------------------------------------------------------------------
    async def _off(fn, *args, **kwargs):
        """Run a blocking call on an executor thread.  Collection methods
        acquire the collection RLock, which batcher executor threads hold
        across whole device dispatches (a wave; a first call also builds
        the kernels) — taking it on the event-loop thread
        stalls every request, websocket, and the batcher's own flush
        scheduling.  Embedder calls block similarly (lazy first-use model
        load)."""
        return await asyncio.get_running_loop().run_in_executor(
            None, lambda: fn(*args, **kwargs))

    _embed_off = _off

    async def _query_vector(req, c):
        if req.vector is not None:
            v = np.asarray(req.vector, dtype=np.float32)
            if v.shape != (c.config.dimensions,):
                # reject before the batcher coalesces it: a wrong-dims
                # query np.stack'ed with good ones would fail the whole
                # bucket instead of 400-ing this request
                raise web.HTTPBadRequest(
                    text=json.dumps({"detail":
                                     f"expected {c.config.dimensions} "
                                     f"dims, got {v.shape}"}),
                    content_type=JSON)
            return v
        if req.text is not None:
            if not state["full"]:
                raise web.HTTPBadRequest(
                    text=json.dumps(
                        {"detail": "text search requires the full server"}),
                    content_type=JSON)
            v = np.asarray(await _embed_off(embedder().embed, req.text),
                           dtype=np.float32)
            if v.shape != (c.config.dimensions,):
                # same guard as the vector path: a wrong-dims embedding
                # np.stack'ed into a coalesced batcher bucket would fail
                # every rider request in the wave, not just this one
                raise web.HTTPBadRequest(
                    text=json.dumps({"detail":
                                     f"embedder produced {v.shape[0]}-d "
                                     f"vectors but collection is "
                                     f"{c.config.dimensions}-d"}),
                    content_type=JSON)
            return v
        raise web.HTTPBadRequest(
            text=json.dumps({"detail": "vector or text required"}),
            content_type=JSON)

    def _binary_filter(body: dict) -> Optional[Filter]:
        if body.get("filter_tree"):
            return filter_from_tree(body["filter_tree"])
        return Filter.from_dict(body.get("where"))

    def _binary_mode_exact(body: dict):
        mode = body.get("mode", "auto")
        if mode not in ("auto", "exact", "ann", "quantized"):
            raise ValueError(f"unknown mode {mode!r}")
        exact = (None if mode == "auto"
                 else mode == "exact" if mode != "quantized" else None)
        return mode, exact

    async def _search_binary(request, c, single: bool):
        """msgpack + raw-f32 fast path (see server/wire.py): no pydantic,
        no JSON, no SearchResult objects — parse bytes, dispatch arrays,
        pack bytes."""
        try:
            body = wire.unpack(await request.read())
            k = int(body.get("k", 10))
            if not 1 <= k <= 16_384:
                raise ValueError(f"k={k} out of range")
            mode, exact = _binary_mode_exact(body)
            filt = _binary_filter(body)
            if single:
                q = wire.decode_vector(body.get("vector"),
                                       c.config.dimensions)
            else:
                q = wire.decode_matrix(body.get("vectors"),
                                       c.config.dimensions)
            t0 = time.perf_counter()
            loop = asyncio.get_running_loop()
            metadata = None
            if single:
                # singles — exact AND quantized — coalesce through the
                # batcher: one wave per in-flight dispatch
                i_row, s_row, r_row = await state["batcher"].search_raw(
                    c, q, k, filt, exact, quantized=(mode == "quantized"))
                ids, scores, rows = i_row[None], s_row[None], r_row[None]
            elif mode == "quantized":
                ids, scores, rows = await loop.run_in_executor(
                    None, lambda: c.search_quantized_arrays(q, k,
                                                            filter=filt))
            else:
                ids, scores, rows = await loop.run_in_executor(
                    None, lambda: c.search_arrays(q, k, filt, exact))
            if body.get("include_metadata"):
                metadata = await _off(c.metadata_for_rows, rows)
            took = (time.perf_counter() - t0) * 1000
        except QueueFull as e:
            return web.Response(
                body=wire.pack({"detail": str(e)}), status=503,
                headers={"Retry-After": "1"}, content_type=MSGPACK)
        except ValueError as e:
            return web.Response(
                body=wire.pack({"detail": str(e)}), status=400,
                content_type=MSGPACK)
        return web.Response(
            body=wire.search_response(ids, scores, took, metadata, single),
            content_type=MSGPACK)

    async def search(request):
        name = request.match_info["name"]
        c = collection_or_404(name)
        if wire.is_binary(request):
            return await _search_binary(request, c, single=True)
        req = _parse(S.SearchRequest, await _body(request))
        t0 = time.perf_counter()
        try:
            q = await _query_vector(req, c)
            if req.mode == "quantized":
                filt = _filter_of(req)
                if req.include_vectors:
                    loop = asyncio.get_running_loop()
                    hits = (await loop.run_in_executor(
                        None, lambda: c.search_quantized(
                            q[None, :], req.k, filter=filt,
                            include_vectors=True)))[0]
                else:
                    hits = await state["batcher"].search(
                        c, q, req.k, filt, None, quantized=True)
            else:
                exact = (req.exact if req.mode == "auto"
                         else req.mode == "exact")
                if req.include_vectors:
                    # the batcher's coalesced path never gathers vectors;
                    # a vector-bearing response runs its own batch-of-one
                    loop = asyncio.get_running_loop()
                    filt = _filter_of(req)
                    hits = (await loop.run_in_executor(
                        None, lambda: c.search_batch(
                            q[None, :], req.k, filt, True, exact)))[0]
                else:
                    hits = await state["batcher"].search(
                        c, q, req.k, _filter_of(req), exact)
        except QueueFull as e:
            return web.json_response({"detail": str(e)}, status=503,
                                     headers={"Retry-After": "1"})
        except ValueError as e:  # e.g. query dimension mismatch -> 400
            return _json_error(400, str(e))
        took = (time.perf_counter() - t0) * 1000
        return web.json_response(
            {"results": [_hit_dict(h, req.include_vectors) for h in hits],
             "took_ms": round(took, 3)})

    async def build_index(request):
        name = request.match_info["name"]
        c = collection_or_404(name)
        req = _parse(S.BuildIndexRequest, await _body(request))
        loop = asyncio.get_running_loop()
        try:
            if req.kind in ANN_KINDS:
                await loop.run_in_executor(
                    None, lambda: c.build_ann(kind=req.kind, **req.params))
                info = c._ann.stats()
            elif req.kind in ("int8", "binary", "pq"):
                scan = await loop.run_in_executor(
                    None, lambda: c.enable_quantized_scan(req.kind,
                                                          **req.params))
                info = scan.memory_usage()
            else:
                return _json_error(400, f"unknown index kind {req.kind!r}")
        except (ValueError, RuntimeError) as e:
            return _json_error(400, str(e))
        return web.json_response({"built": req.kind, "info": info},
                                 status=201)

    async def optimize_collection(request):
        """POST /collections/{name}/optimize — measure serving modes vs
        the exact oracle and install the cheapest eligible one as the
        collection's search() default (Collection.optimize)."""
        c = collection_or_404(request.match_info["name"])
        body = await _body(request) if request.can_read_body else {}
        target = float(body.get("target_recall", 0.95))
        k = int(body.get("k", 10))
        build = bool(body.get("build", True))
        install = bool(body.get("install", True))
        try:
            report = await _off(c.optimize, target_recall=target, k=k,
                                build=build, install=install)
        except (ValueError, RuntimeError) as e:
            return _json_error(400, str(e))
        return web.json_response(report)

    async def search_batch(request):
        name = request.match_info["name"]
        c = collection_or_404(name)
        if wire.is_binary(request):
            return await _search_binary(request, c, single=False)
        req = _parse(S.SearchBatchRequest, await _body(request))
        if req.vectors is not None:
            q = np.asarray(req.vectors, dtype=np.float32)
        elif req.texts is not None and state["full"]:
            q = await _embed_off(embedder().embed_batch, req.texts)
        else:
            return _json_error(400, "vectors or texts required")
        t0 = time.perf_counter()
        try:
            filt = _filter_of(req)
            if req.mode == "quantized":
                batches = await _off(
                    c.search_quantized, q, req.k, filter=filt)
            else:
                exact = (req.exact if req.mode == "auto"
                         else req.mode == "exact")
                batches = await _off(c.search_batch, q, req.k, filt,
                                     False, exact)
        except ValueError as e:  # e.g. query dimension mismatch -> 400
            return _json_error(400, str(e))
        took = (time.perf_counter() - t0) * 1000
        return web.json_response(
            {"results": [[_hit_dict(h) for h in hits] for hits in batches],
             "took_ms": round(took, 3)})

    async def insert_text(request):
        name = request.match_info["name"]
        c = collection_or_404(name)
        req = _parse(S.InsertTextRequest, await _body(request))
        vec = await _embed_off(embedder().embed, req.text)
        meta = dict(req.metadata or {})
        meta["_text"] = req.text
        try:
            rid = c.insert(vec, req.id, meta)
        except ValueError as e:
            return _json_error(400, str(e))
        await broadcast(Event(EventType.INSERT, name,
                              {"id": rid, "metadata": meta}))
        return web.json_response({"id": rid}, status=201)

    async def admin_save(request):
        db().save()
        if state["graph"] is not None and state["graph"].path is not None:
            state["graph"].save()
        return web.json_response({"saved": True})

    # ------------------------------------------------------------------
    # graph REST (full tier)
    # ------------------------------------------------------------------
    def graph() -> GraphDB:
        return state["graph"]

    async def create_node(request):
        req = _parse(S.CreateNodeRequest, await _body(request))
        try:
            n = graph().create_node(req.labels, req.properties, req.id)
        except ValueError as e:
            return _json_error(409, str(e))
        return web.json_response(n.to_dict(), status=201)

    async def get_node(request):
        n = graph().get_node(request.match_info["id"])
        if n is None:
            return _json_error(404, "node not found")
        return web.json_response(n.to_dict())

    async def update_node(request):
        req = _parse(S.UpdateNodeRequest, await _body(request))
        n = graph().update_node(request.match_info["id"], req.properties,
                                req.add_labels, req.remove_labels, req.merge)
        if n is None:
            return _json_error(404, "node not found")
        return web.json_response(n.to_dict())

    async def delete_node(request):
        if not graph().delete_node(request.match_info["id"]):
            return _json_error(404, "node not found")
        return web.json_response({"deleted": request.match_info["id"]})

    async def find_nodes(request):
        label = request.query.get("label")
        props = None
        if "properties" in request.query:
            try:
                props = json.loads(request.query["properties"])
            except json.JSONDecodeError:
                return _json_error(400, "properties must be valid JSON")
        nodes = graph().find_nodes(label, props)
        return web.json_response({"nodes": [n.to_dict() for n in nodes]})

    async def create_edge(request):
        req = _parse(S.CreateEdgeRequest, await _body(request))
        try:
            e = graph().create_edge(req.source, req.target, req.type,
                                    req.properties, req.id)
        except ValueError as err:
            return _json_error(400, str(err))
        return web.json_response(e.to_dict(), status=201)

    async def get_edge(request):
        e = graph().get_edge(request.match_info["id"])
        if e is None:
            return _json_error(404, "edge not found")
        return web.json_response(e.to_dict())

    async def delete_edge(request):
        if not graph().delete_edge(request.match_info["id"]):
            return _json_error(404, "edge not found")
        return web.json_response({"deleted": request.match_info["id"]})

    async def create_hyperedge(request):
        req = _parse(S.CreateHyperedgeRequest, await _body(request))
        try:
            h = graph().create_hyperedge(req.nodes, req.type, req.properties,
                                         req.id)
        except ValueError as e:
            return _json_error(400, str(e))
        return web.json_response(h.to_dict(), status=201)

    async def get_hyperedge(request):
        h = graph().get_hyperedge(request.match_info["id"])
        if h is None:
            return _json_error(404, "hyperedge not found")
        return web.json_response(h.to_dict())

    async def delete_hyperedge(request):
        if not graph().delete_hyperedge(request.match_info["id"]):
            return _json_error(404, "hyperedge not found")
        return web.json_response({"deleted": request.match_info["id"]})

    async def hyperedges_of_node(request):
        nid = request.match_info["id"]
        mode = request.query.get("mode", "any")
        out = graph().hyperedges_of_nodes([nid], mode)
        return web.json_response({"hyperedges": [h.to_dict() for h in out]})

    async def graph_query(request):
        req = _parse(S.GraphQueryRequest, await _body(request))
        try:
            rows = graph().query(req.query)
        except ValueError as e:
            return _json_error(400, str(e))
        return web.json_response({"rows": rows})

    async def graph_traverse(request):
        req = _parse(S.TraverseRequest, await _body(request))
        paths = graph().traverse(req.start, req.max_depth, req.edge_type,
                                 req.direction)
        return web.json_response({"paths": paths})

    async def graph_shortest_path(request):
        req = _parse(S.ShortestPathRequest, await _body(request))
        path = graph().shortest_path(req.source, req.target, req.edge_type)
        return web.json_response({"path": path})

    async def graph_neighbors(request):
        nid = request.match_info["id"]
        direction = request.query.get("direction", "both")
        edge_type = request.query.get("edge_type")
        if graph().get_node(nid) is None:
            return _json_error(404, "node not found")
        out = graph().neighbors(nid, direction, edge_type)
        return web.json_response({"neighbors": [n.to_dict() for n in out]})

    async def graph_stats(request):
        return web.json_response(graph().stats())

    # ------------------------------------------------------------------
    # embeddings (full tier)
    # ------------------------------------------------------------------
    async def embed_one(request):
        req = _parse(S.EmbedRequest, await _body(request))
        vec = await _embed_off(embedder().embed, req.text)
        return web.json_response({"embedding": vec.tolist(),
                                  "model": embedder().model_name,
                                  "dimensions": embedder().dimensions})

    async def embed_batch(request):
        req = _parse(S.EmbedBatchRequest, await _body(request))
        vecs = await _embed_off(embedder().embed_batch, req.texts)
        return web.json_response({"embeddings": vecs.tolist(),
                                  "model": embedder().model_name})

    # ------------------------------------------------------------------
    # websockets (full tier)
    # ------------------------------------------------------------------
    async def ws_handler(request):
        ws = web.WebSocketResponse(heartbeat=30)
        await ws.prepare(request)
        collection = request.match_info.get("collection", "*")
        await state["ws"].connect(ws, Subscription(collection=collection))
        try:
            async for msg in ws:
                if msg.type == WSMsgType.TEXT:
                    try:
                        payload = json.loads(msg.data)
                    except json.JSONDecodeError:
                        continue
                    if payload.get("action") == "subscribe":
                        types = payload.get("event_types")
                        try:
                            etypes = ([EventType(t) for t in types]
                                      if types else None)
                        except ValueError:
                            # bad event type: reply with an error instead of
                            # tearing down the connection
                            await ws.send_str(json.dumps(
                                {"error": f"unknown event type in {types}"}))
                            continue
                        await state["ws"].update_subscription(ws, Subscription(
                            collection=payload.get("collection", collection),
                            event_types=etypes,
                            metadata_filter=payload.get("metadata_filter")))
                        await ws.send_str(json.dumps({"subscribed": True}))
                elif msg.type in (WSMsgType.CLOSE, WSMsgType.ERROR):
                    break
        finally:
            await state["ws"].disconnect(ws)
        return ws

    # ------------------------------------------------------------------
    # routes
    # ------------------------------------------------------------------
    r = app.router
    r.add_get("/health", health)
    r.add_get("/collections", list_collections)
    r.add_post("/collections", create_collection)
    r.add_get("/collections/{name}", get_collection)
    r.add_delete("/collections/{name}", delete_collection)
    r.add_post("/collections/{name}/vectors", insert_vector)
    r.add_post("/collections/{name}/vectors/batch", insert_batch)
    r.add_put("/collections/{name}/vectors", upsert_vector)
    r.add_get("/collections/{name}/vectors/{id}", get_vector)
    r.add_delete("/collections/{name}/vectors/{id}", delete_vector)
    r.add_get("/collections/{name}/ids", list_ids)
    r.add_post("/collections/{name}/search", search)
    r.add_post("/collections/{name}/search/batch", search_batch)
    r.add_post("/collections/{name}/index", build_index)
    r.add_post("/collections/{name}/optimize", optimize_collection)
    r.add_post("/admin/save", admin_save)
    if full:
        r.add_post("/collections/{name}/texts", insert_text)
        r.add_post("/graph/nodes", create_node)
        r.add_get("/graph/nodes", find_nodes)
        r.add_get("/graph/nodes/{id}", get_node)
        r.add_put("/graph/nodes/{id}", update_node)
        r.add_delete("/graph/nodes/{id}", delete_node)
        r.add_get("/graph/neighbors/{id}", graph_neighbors)
        r.add_post("/graph/edges", create_edge)
        r.add_get("/graph/edges/{id}", get_edge)
        r.add_delete("/graph/edges/{id}", delete_edge)
        r.add_post("/graph/hyperedges", create_hyperedge)
        r.add_get("/graph/hyperedges/{id}", get_hyperedge)
        r.add_delete("/graph/hyperedges/{id}", delete_hyperedge)
        r.add_get("/graph/nodes/{id}/hyperedges", hyperedges_of_node)
        r.add_post("/graph/query", graph_query)
        r.add_post("/graph/traverse", graph_traverse)
        r.add_post("/graph/shortest-path", graph_shortest_path)
        r.add_get("/graph/stats", graph_stats)
        r.add_post("/embeddings/embed", embed_one)
        r.add_post("/embeddings/embed-batch", embed_batch)
        r.add_get("/ws", ws_handler)
        r.add_get("/ws/{collection}", ws_handler)

    if cors:
        @web.middleware
        async def cors_mw(request, handler):
            if request.method == "OPTIONS":
                resp = web.Response()
            else:
                try:
                    resp = await handler(request)
                except web.HTTPException as exc:
                    # raised errors (422/400/404) must carry CORS headers
                    # too, or browsers surface an opaque network error
                    # instead of the JSON detail
                    resp = exc
                except Exception as exc:  # noqa: BLE001
                    # uncaught bugs: synthesize the 500 HERE so it still
                    # carries CORS headers — aiohttp's protocol-layer 500
                    # has none and browsers see an opaque failure
                    resp = web.json_response(
                        {"detail": f"{type(exc).__name__}: {exc}"},
                        status=500)
            resp.headers["Access-Control-Allow-Origin"] = "*"
            resp.headers["Access-Control-Allow-Methods"] = "*"
            resp.headers["Access-Control-Allow-Headers"] = "*"
            if isinstance(resp, web.HTTPException):
                raise resp
            return resp
        app.middlewares.append(cors_mw)

    if prewarm:
        async def on_startup(app):
            # build the kernels and run the serving dispatch at every pow2
            # batch size up to `prewarm` BEFORE the first request, so that
            # no request pays the first nvcc build (Collection.prewarm)
            loop = asyncio.get_running_loop()
            for name in db().list_collections():
                col = db().get_collection(name)
                t = await loop.run_in_executor(
                    None, lambda c=col: c.prewarm(max_batch=prewarm))
                if t:
                    print(f"prewarmed {name}: {sum(t.values()):.1f}s "
                          f"over {len(t)} shapes", flush=True)

        app.on_startup.append(on_startup)

    async def on_shutdown(app):
        db().save()
        g = state.get("graph")
        if g is not None and getattr(g, "path", None) is not None:
            g.save()  # graph keeps everything in memory until save()

    app.on_shutdown.append(on_shutdown)
    return app


def run_server(host: str = "0.0.0.0", port: int = 8000, **kwargs) -> None:
    web.run_app(create_app(**kwargs), host=host, port=port)


if __name__ == "__main__":
    run_server()
