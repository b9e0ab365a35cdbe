"""HTTP client for the REST server.

Parity with the reference's httpx client (client.py:32-281): mirrors every
endpoint, context-manager lifecycle, 404 -> None on gets.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import httpx
import numpy as np

from urllib.parse import quote


def _seg(value) -> str:
    """Percent-encode one URL path segment: ids like 'doc/1' or 'a#1'
    would otherwise break route matching (404 for an existing row) or be
    truncated at the fragment and hit the WRONG id."""
    return quote(str(value), safe="")


class VectorDBClient:
    def __init__(self, base_url: str = "http://localhost:8000",
                 timeout: float = 30.0):
        self.base_url = base_url.rstrip("/")
        self._client = httpx.Client(base_url=self.base_url, timeout=timeout)

    # ------------------------------------------------------------------
    def health(self) -> dict:
        return self._get("/health")

    # collections ------------------------------------------------------
    def list_collections(self) -> List[dict]:
        return self._get("/collections")["collections"]

    def create_collection(self, name: str, dimensions: int,
                          metric: str = "cosine", index: str = "flat") -> dict:
        return self._post("/collections", {
            "name": name, "dimensions": dimensions, "metric": metric,
            "index": index})

    def get_collection(self, name: str) -> Optional[dict]:
        return self._get(f"/collections/{_seg(name)}", none_on_404=True)

    def delete_collection(self, name: str) -> bool:
        r = self._client.delete(f"/collections/{_seg(name)}")
        if r.status_code not in (200, 404):
            r.raise_for_status()
        return r.status_code == 200

    # vectors ----------------------------------------------------------
    def insert(self, collection: str, vector, id: Optional[str] = None,
               metadata: Optional[dict] = None) -> str:
        return self._post(f"/collections/{_seg(collection)}/vectors", {
            "vector": np.asarray(vector, dtype=float).tolist(),
            "id": id, "metadata": metadata})["id"]

    def insert_batch(self, collection: str, vectors,
                     ids: Optional[Sequence[str]] = None,
                     metadatas: Optional[Sequence[dict]] = None) -> List[str]:
        return self._post(f"/collections/{_seg(collection)}/vectors/batch", {
            "vectors": np.asarray(vectors, dtype=float).tolist(),
            "ids": list(ids) if ids else None,
            "metadatas": list(metadatas) if metadatas else None})["ids"]

    def upsert(self, collection: str, vector, id: str,
               metadata: Optional[dict] = None) -> dict:
        return self._put(f"/collections/{_seg(collection)}/vectors", {
            "vector": np.asarray(vector, dtype=float).tolist(),
            "id": id, "metadata": metadata})

    def insert_text(self, collection: str, text: str,
                    id: Optional[str] = None,
                    metadata: Optional[dict] = None) -> str:
        return self._post(f"/collections/{_seg(collection)}/texts", {
            "text": text, "id": id, "metadata": metadata})["id"]

    def get(self, collection: str, id: str,
            include_vector: bool = False) -> Optional[dict]:
        return self._get(
            f"/collections/{_seg(collection)}/vectors/{_seg(id)}"
            f"?include_vector={'true' if include_vector else 'false'}",
            none_on_404=True)

    def delete(self, collection: str, id: str) -> bool:
        r = self._client.delete(
            f"/collections/{_seg(collection)}/vectors/{_seg(id)}")
        if r.status_code not in (200, 404):
            r.raise_for_status()  # a 500 is not "already deleted"
        return r.status_code == 200

    def list_ids(self, collection: str, limit: int = 100,
                 offset: int = 0) -> List[str]:
        return self._get(f"/collections/{_seg(collection)}/ids"
                         f"?limit={limit}&offset={offset}")["ids"]

    # search -----------------------------------------------------------
    def build_index(self, collection: str, kind: str = "ivf",
                    **params) -> dict:
        """Build an ANN index (ivf/graph) or enable a quantized scan
        (int8/binary/pq) server-side."""
        return self._post(f"/collections/{_seg(collection)}/index",
                          {"kind": kind, "params": params})

    def optimize(self, collection: str, target_recall: float = 0.95,
                 k: int = 10, build: bool = True,
                 install: bool = True) -> dict:
        """Server-side Collection.optimize(): measure serving modes and
        install the cheapest one clearing the recall target."""
        return self._post(f"/collections/{_seg(collection)}/optimize",
                          {"target_recall": target_recall, "k": k,
                           "build": build, "install": install})

    def search(self, collection: str, vector=None, text: Optional[str] = None,
               k: int = 10, where: Optional[dict] = None,
               filter_tree: Optional[dict] = None,
               exact: Optional[bool] = None, mode: str = "auto") -> dict:
        body: Dict[str, Any] = {"k": k, "where": where,
                                "filter_tree": filter_tree, "exact": exact,
                                "mode": mode}
        if vector is not None:
            body["vector"] = np.asarray(vector, dtype=float).tolist()
        if text is not None:
            body["text"] = text
        return self._post(f"/collections/{_seg(collection)}/search", body)

    def search_batch(self, collection: str, vectors=None,
                     texts: Optional[Sequence[str]] = None, k: int = 10,
                     where: Optional[dict] = None,
                     filter_tree: Optional[dict] = None,
                     mode: str = "auto",
                     exact: Optional[bool] = None) -> dict:
        body: Dict[str, Any] = {"k": k, "where": where, "mode": mode,
                                "exact": exact}
        if filter_tree is not None:
            body["filter_tree"] = filter_tree
        if vectors is not None:
            body["vectors"] = np.asarray(vectors, dtype=float).tolist()
        if texts is not None:
            body["texts"] = list(texts)
        return self._post(f"/collections/{_seg(collection)}/search/batch", body)

    # binary (msgpack + raw f32) fast path -----------------------------
    # Wire format: server/wire.py.  ~8x smaller requests and no JSON
    # number parsing on either side; scores come back as one raw f32
    # buffer reshaped to (B, k).
    def search_binary(self, collection: str, vector, k: int = 10,
                      where: Optional[dict] = None, mode: str = "auto",
                      include_metadata: bool = False) -> dict:
        v = np.ascontiguousarray(vector, dtype="<f4")
        out = self._post_binary(
            f"/collections/{_seg(collection)}/search",
            {"vector": v.tobytes(), "k": k, "where": where, "mode": mode,
             "include_metadata": include_metadata})
        out["scores"] = np.frombuffer(out["scores"], dtype="<f4")
        return out

    def search_batch_binary(self, collection: str, vectors, k: int = 10,
                            where: Optional[dict] = None, mode: str = "auto",
                            include_metadata: bool = False) -> dict:
        v = np.ascontiguousarray(vectors, dtype="<f4")
        out = self._post_binary(
            f"/collections/{_seg(collection)}/search/batch",
            {"vectors": v.tobytes(), "k": k, "where": where, "mode": mode,
             "include_metadata": include_metadata})
        out["scores"] = np.frombuffer(out["scores"],
                                      dtype="<f4").reshape(len(out["ids"]), -1)
        return out

    def insert_batch_binary(self, collection: str, vectors,
                            ids: Optional[Sequence[str]] = None,
                            metadatas: Optional[Sequence[dict]] = None
                            ) -> List[str]:
        v = np.ascontiguousarray(vectors, dtype="<f4")
        return self._post_binary(
            f"/collections/{_seg(collection)}/vectors/batch",
            {"vectors": v.tobytes(),
             "ids": list(ids) if ids else None,
             "metadatas": list(metadatas) if metadatas else None})["ids"]

    # graph ------------------------------------------------------------
    def create_node(self, labels=None, properties=None,
                    id: Optional[str] = None) -> dict:
        return self._post("/graph/nodes", {"labels": labels,
                                           "properties": properties, "id": id})

    def get_node(self, id: str) -> Optional[dict]:
        return self._get(f"/graph/nodes/{_seg(id)}", none_on_404=True)

    def update_node(self, id: str, properties=None, add_labels=None,
                    remove_labels=None, merge: bool = True) -> Optional[dict]:
        r = self._client.put(f"/graph/nodes/{_seg(id)}", json={
            "properties": properties, "add_labels": add_labels,
            "remove_labels": remove_labels, "merge": merge})
        if r.status_code == 404:
            return None
        r.raise_for_status()
        return r.json()

    def delete_node(self, id: str) -> bool:
        r = self._client.delete(f"/graph/nodes/{_seg(id)}")
        if r.status_code not in (200, 404):
            r.raise_for_status()
        return r.status_code == 200

    def find_nodes(self, label: Optional[str] = None,
                   properties: Optional[dict] = None) -> List[dict]:
        import json as _json
        params = {}
        if label:
            params["label"] = label
        if properties:
            params["properties"] = _json.dumps(properties)
        r = self._client.get("/graph/nodes", params=params)
        r.raise_for_status()
        return r.json()["nodes"]

    def create_edge(self, source: str, target: str, type: str,
                    properties=None) -> dict:
        return self._post("/graph/edges", {
            "source": source, "target": target, "type": type,
            "properties": properties})

    def neighbors(self, id: str, direction: str = "both",
                  edge_type: Optional[str] = None) -> List[dict]:
        params = {"direction": direction}
        if edge_type:
            params["edge_type"] = edge_type
        r = self._client.get(f"/graph/neighbors/{_seg(id)}", params=params)
        r.raise_for_status()
        return r.json()["neighbors"]

    def graph_query(self, query: str) -> List[dict]:
        return self._post("/graph/query", {"query": query})["rows"]

    def traverse(self, start: str, max_depth: int = 3,
                 edge_type: Optional[str] = None,
                 direction: str = "out") -> List[List[str]]:
        return self._post("/graph/traverse", {
            "start": start, "max_depth": max_depth, "edge_type": edge_type,
            "direction": direction})["paths"]

    def shortest_path(self, source: str, target: str,
                      edge_type: Optional[str] = None) -> Optional[List[str]]:
        return self._post("/graph/shortest-path", {
            "source": source, "target": target,
            "edge_type": edge_type})["path"]

    # embeddings -------------------------------------------------------
    def embed(self, text: str) -> np.ndarray:
        return np.asarray(self._post("/embeddings/embed",
                                     {"text": text})["embedding"],
                          dtype=np.float32)

    def embed_batch(self, texts: Sequence[str]) -> np.ndarray:
        return np.asarray(self._post("/embeddings/embed-batch",
                                     {"texts": list(texts)})["embeddings"],
                          dtype=np.float32)

    # admin ------------------------------------------------------------
    def save(self) -> bool:
        return self._post("/admin/save", {})["saved"]

    # ------------------------------------------------------------------
    def _get(self, path: str, none_on_404: bool = False):
        r = self._client.get(path)
        if none_on_404 and r.status_code == 404:
            return None
        r.raise_for_status()
        return r.json()

    def _post(self, path: str, body: dict):
        r = self._client.post(path, json=body)
        if r.status_code == 503 and "Retry-After" in r.headers:
            # server admission control (batcher backlog full): one polite
            # retry after the hinted delay — overload sheds as fast 503s
            # by design, and a single retry rides the next wave; callers
            # needing richer policies should wrap the client
            import time as _t
            _t.sleep(min(float(r.headers["Retry-After"]), 5.0))
            r = self._client.post(path, json=body)
        r.raise_for_status()
        return r.json()

    def _post_binary(self, path: str, body: dict):
        import msgpack
        payload = msgpack.packb(body, use_bin_type=True)
        r = self._client.post(
            path, content=payload,
            headers={"Content-Type": "application/msgpack"})
        if r.status_code == 503 and "Retry-After" in r.headers:
            # same one-retry admission-control courtesy as _post
            import time as _t
            _t.sleep(min(float(r.headers["Retry-After"]), 5.0))
            r = self._client.post(
                path, content=payload,
                headers={"Content-Type": "application/msgpack"})
        if r.status_code >= 400 and r.headers.get(
                "Content-Type", "").startswith("application/msgpack"):
            detail = msgpack.unpackb(r.content, raw=False).get("detail")
            raise httpx.HTTPStatusError(
                f"{r.status_code}: {detail}", request=r.request, response=r)
        r.raise_for_status()
        return msgpack.unpackb(r.content, raw=False)

    def _put(self, path: str, body: dict):
        r = self._client.put(path, json=body)
        r.raise_for_status()
        return r.json()

    def close(self) -> None:
        self._client.close()

    def __enter__(self) -> "VectorDBClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
