"""GraphDB: property graph storage, CRUD, traversal, persistence.

Parity with the reference GraphDB (graph.py:495-926): dict element storage
with five maintained indexes (indexes.py), label+property intersection
queries with smallest-set-first early exit, numeric range queries,
neighbors / DFS path traversal / BFS shortest path, JSON-shaped persistence
(index rebuild on load), and stats.  Thread safety via one RLock.
"""

from __future__ import annotations

import threading
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set

from ..persist.format import load_container, save_container
from .indexes import (
    AdjacencyIndex,
    EdgeTypeIndex,
    HyperedgeNodeIndex,
    LabelIndex,
    PropertyIndex,
)
from .model import (
    Edge,
    Hyperedge,
    HyperedgeBuilder,
    Node,
    NodeBuilder,
    EdgeBuilder,
)

GRAPH_FILE = "graph.fpvt"

# graphs past this edge count traverse a native CSR snapshot
# (native/graph.cpp) instead of the Python dict adjacency
NATIVE_TRAVERSAL_THRESHOLD = 10_000


class GraphDB:
    def __init__(self, path: Optional[str] = None):
        self.path = Path(path) if path else None
        self._lock = threading.RLock()
        self._nodes: Dict[str, Node] = {}
        self._edges: Dict[str, Edge] = {}
        self._hyperedges: Dict[str, Hyperedge] = {}
        self._labels = LabelIndex()
        self._adjacency = AdjacencyIndex()
        self._edge_types = EdgeTypeIndex()
        self._properties = PropertyIndex()
        self._hyper_nodes = HyperedgeNodeIndex()
        self._version = 0
        self._csr_cache: dict = {}
        if self.path is not None and (self.path / GRAPH_FILE).exists():
            self.load()

    # ------------------------------------------------------------------
    # Builders
    # ------------------------------------------------------------------
    def node(self) -> NodeBuilder:
        return NodeBuilder(self)

    def edge(self) -> EdgeBuilder:
        return EdgeBuilder(self)

    def hyperedge(self) -> HyperedgeBuilder:
        return HyperedgeBuilder(self)

    # ------------------------------------------------------------------
    # Node CRUD
    # ------------------------------------------------------------------
    def create_node(self, labels: Optional[Iterable[str]] = None,
                    properties: Optional[dict] = None,
                    id: Optional[str] = None) -> Node:
        with self._lock:
            node = Node(id, labels, properties)
            if node.id in self._nodes:
                raise ValueError(f"node {node.id!r} already exists")
            self._nodes[node.id] = node
            self._version += 1
            self._labels.add(node.id, node.labels)
            self._properties.add(node.id, node.properties)
            return node

    def get_node(self, node_id: str) -> Optional[Node]:
        return self._nodes.get(node_id)

    def update_node(self, node_id: str,
                    properties: Optional[dict] = None,
                    add_labels: Optional[Iterable[str]] = None,
                    remove_labels: Optional[Iterable[str]] = None,
                    merge: bool = True) -> Optional[Node]:
        with self._lock:
            node = self._nodes.get(node_id)
            if node is None:
                return None
            # re-index properties (reference: graph.py:603-623)
            if properties is not None:
                self._properties.remove(node_id, node.properties)
                node.properties = ({**node.properties, **properties}
                                   if merge else dict(properties))
                self._properties.add(node_id, node.properties)
            if add_labels:
                new = set(add_labels) - node.labels
                node.labels |= new
                self._labels.add(node_id, new)
            if remove_labels:
                gone = set(remove_labels) & node.labels
                node.labels -= gone
                self._labels.remove(node_id, gone)
            return node

    def delete_node(self, node_id: str) -> bool:
        """Cascades: removes connected edges and hyperedge membership
        (reference: graph.py:625-658)."""
        with self._lock:
            node = self._nodes.pop(node_id, None)
            if node is None:
                return False
            self._version += 1
            for eid in list(self._adjacency.all_edges(node_id)):
                self.delete_edge(eid)
            for hid in list(self._hyper_nodes.get(node_id)):
                h = self._hyperedges.get(hid)
                if h is None:
                    continue
                if len(h.nodes) <= 2:
                    self.delete_hyperedge(hid)
                else:
                    self._hyper_nodes.remove(hid, [node_id])
                    h.nodes = [n for n in h.nodes if n != node_id]
            self._labels.remove(node_id, node.labels)
            self._properties.remove(node_id, node.properties)
            return True

    # ------------------------------------------------------------------
    # Edge CRUD
    # ------------------------------------------------------------------
    def create_edge(self, source: str, target: str, type: str,
                    properties: Optional[dict] = None,
                    id: Optional[str] = None) -> Edge:
        with self._lock:
            if source not in self._nodes:
                raise ValueError(f"source node {source!r} does not exist")
            if target not in self._nodes:
                raise ValueError(f"target node {target!r} does not exist")
            edge = Edge(source, target, type, id, properties)
            if edge.id in self._edges:
                raise ValueError(f"edge {edge.id!r} already exists")
            self._edges[edge.id] = edge
            self._version += 1
            self._adjacency.add(edge.id, source, target)
            self._edge_types.add(edge.id, type)
            return edge

    def get_edge(self, edge_id: str) -> Optional[Edge]:
        return self._edges.get(edge_id)

    def update_edge(self, edge_id: str, properties: dict,
                    merge: bool = True) -> Optional[Edge]:
        with self._lock:
            edge = self._edges.get(edge_id)
            if edge is None:
                return None
            edge.properties = ({**edge.properties, **properties}
                               if merge else dict(properties))
            return edge

    def delete_edge(self, edge_id: str) -> bool:
        with self._lock:
            edge = self._edges.pop(edge_id, None)
            if edge is None:
                return False
            self._version += 1
            self._adjacency.remove(edge_id, edge.source, edge.target)
            self._edge_types.remove(edge_id, edge.type)
            return True

    def edges_of_type(self, type: str) -> List[Edge]:
        return [self._edges[e] for e in self._edge_types.get(type)
                if e in self._edges]

    # ------------------------------------------------------------------
    # Hyperedge CRUD
    # ------------------------------------------------------------------
    def create_hyperedge(self, nodes: Sequence[str], type: str,
                         properties: Optional[dict] = None,
                         id: Optional[str] = None) -> Hyperedge:
        with self._lock:
            missing = [n for n in nodes if n not in self._nodes]
            if missing:
                raise ValueError(f"nodes do not exist: {missing}")
            h = Hyperedge(nodes, type, id, properties)
            if h.id in self._hyperedges:
                raise ValueError(f"hyperedge {h.id!r} already exists")
            self._hyperedges[h.id] = h
            self._hyper_nodes.add(h.id, h.nodes)
            return h

    def get_hyperedge(self, hyperedge_id: str) -> Optional[Hyperedge]:
        return self._hyperedges.get(hyperedge_id)

    def delete_hyperedge(self, hyperedge_id: str) -> bool:
        with self._lock:
            h = self._hyperedges.pop(hyperedge_id, None)
            if h is None:
                return False
            self._hyper_nodes.remove(hyperedge_id, h.nodes)
            return True

    def hyperedges_of_nodes(self, node_ids: Sequence[str],
                            mode: str = "any") -> List[Hyperedge]:
        return [self._hyperedges[h]
                for h in self._hyper_nodes.get_by_nodes(node_ids, mode)
                if h in self._hyperedges]

    # ------------------------------------------------------------------
    # Queries
    # ------------------------------------------------------------------
    def find_nodes(self, label: Optional[str] = None,
                   properties: Optional[dict] = None) -> List[Node]:
        """Index-intersection lookup with smallest-set-first early exit
        (reference: graph.py:665-686)."""
        with self._lock:
            candidate_sets: List[Set[str]] = []
            if label is not None:
                candidate_sets.append(self._labels.get(label))
            for k, v in (properties or {}).items():
                candidate_sets.append(self._properties.get(k, v))
            if not candidate_sets:
                return list(self._nodes.values())
            candidate_sets.sort(key=len)
            out = candidate_sets[0]
            for s in candidate_sets[1:]:
                out &= s
                if not out:
                    return []
            return [self._nodes[n] for n in out]

    def find_nodes_in_range(self, key: str,
                            min_value: Optional[float] = None,
                            max_value: Optional[float] = None,
                            label: Optional[str] = None) -> List[Node]:
        with self._lock:
            ids = self._properties.range(key, min_value, max_value)
            if label is not None:
                ids &= self._labels.get(label)
            return [self._nodes[n] for n in ids]

    # ------------------------------------------------------------------
    # Traversal
    # ------------------------------------------------------------------
    def neighbors(self, node_id: str, direction: str = "both",
                  edge_type: Optional[str] = None) -> List[Node]:
        """Adjacent nodes (reference: graph.py:818-842)."""
        with self._lock:
            out: List[Node] = []
            seen: Set[str] = set()
            if direction in ("out", "both"):
                for eid in self._adjacency.outgoing(node_id):
                    e = self._edges[eid]
                    if edge_type and e.type != edge_type:
                        continue
                    if e.target not in seen and e.target in self._nodes:
                        seen.add(e.target)
                        out.append(self._nodes[e.target])
            if direction in ("in", "both"):
                for eid in self._adjacency.incoming(node_id):
                    e = self._edges[eid]
                    if edge_type and e.type != edge_type:
                        continue
                    if e.source not in seen and e.source in self._nodes:
                        seen.add(e.source)
                        out.append(self._nodes[e.source])
            return out

    def traverse(self, start_id: str, max_depth: int = 3,
                 edge_type: Optional[str] = None,
                 direction: str = "out") -> List[List[str]]:
        """All simple paths of length 1..max_depth from start
        (reference DFS: graph.py:844-869)."""
        with self._lock:
            if start_id not in self._nodes:
                return []
            paths: List[List[str]] = []

            def dfs(path: List[str]) -> None:
                if len(path) - 1 >= max_depth:
                    return
                for nb in self.neighbors(path[-1], direction, edge_type):
                    if nb.id in path:  # cycle avoidance by path membership
                        continue
                    new_path = path + [nb.id]
                    paths.append(new_path)
                    dfs(new_path)

            dfs([start_id])
            return paths

    def shortest_path(self, source: str, target: str,
                      edge_type: Optional[str] = None,
                      direction: str = "both") -> Optional[List[str]]:
        """BFS shortest path (reference: graph.py:871-902)."""
        with self._lock:
            if source not in self._nodes or target not in self._nodes:
                return None
            if source == target:
                return [source]
            if len(self._edges) >= NATIVE_TRAVERSAL_THRESHOLD:
                snap = self._csr(direction, edge_type)
                if snap is not None:
                    csr, node_ids, idx = snap
                    path = csr.shortest_path(idx[source], idx[target])
                    return ([node_ids[int(i)] for i in path]
                            if path is not None else None)
            prev: Dict[str, str] = {}
            frontier = [source]
            visited = {source}
            while frontier:
                nxt: List[str] = []
                for cur in frontier:
                    for nb in self.neighbors(cur, direction, edge_type):
                        if nb.id in visited:
                            continue
                        visited.add(nb.id)
                        prev[nb.id] = cur
                        if nb.id == target:
                            path = [target]
                            while path[-1] != source:
                                path.append(prev[path[-1]])
                            return path[::-1]
                        nxt.append(nb.id)
                frontier = nxt
            return None

    # ------------------------------------------------------------------
    # Persistence & stats
    # ------------------------------------------------------------------
    def save(self, path: Optional[str] = None) -> None:
        target = Path(path) if path else self.path
        if target is None:
            raise ValueError("GraphDB has no path; pass one to save()")
        with self._lock:
            target.mkdir(parents=True, exist_ok=True)
            save_container(target / GRAPH_FILE, {
                "nodes": [n.to_dict() for n in self._nodes.values()],
                "edges": [e.to_dict() for e in self._edges.values()],
                "hyperedges": [h.to_dict()
                               for h in self._hyperedges.values()],
            }, meta={"kind": "graph"})

    def _reset_state(self) -> None:
        """Clear all storage and indexes in place (keeps self._lock)."""
        fresh = type(self)(path=None)
        for k, v in fresh.__dict__.items():
            if k not in ("_lock", "path"):
                setattr(self, k, v)

    def load(self, path: Optional[str] = None) -> None:
        target = Path(path) if path else self.path
        c = load_container(target / GRAPH_FILE)
        with self._lock:
            # reset storage + indexes WITHOUT self.__init__: that would
            # rebind self._lock to a fresh unlocked RLock while we hold
            # the old one, letting other threads interleave mid-rebuild
            self._reset_state()
            self.path = target
            for d in c.read("nodes"):
                self.create_node(d.get("labels"), d.get("properties"), d["id"])
            for d in c.read("edges"):
                self.create_edge(d["source"], d["target"], d["type"],
                                 d.get("properties"), d["id"])
            for d in c.read("hyperedges"):
                self.create_hyperedge(d["nodes"], d["type"],
                                      d.get("properties"), d["id"])

    def stats(self) -> dict:
        return {
            "nodes": len(self._nodes),
            "edges": len(self._edges),
            "hyperedges": len(self._hyperedges),
            "labels": len(list(self._labels.labels())),
            "indexed_properties": len(list(self._properties.keys())),
        }

    # ------------------------------------------------------------------
    # Native CSR traversal (native/graph.cpp)
    # ------------------------------------------------------------------
    def _csr(self, direction: str = "both",
             edge_type: Optional[str] = None):
        """Cached (NativeCSRGraph, node_ids, id->idx) snapshot, rebuilt when
        the graph's structural version changes."""
        from .. import native
        if not native.graph_available():
            return None
        key = (direction, edge_type)
        cached = self._csr_cache.get(key)
        if cached is not None and cached[0] == self._version:
            return cached[1:]
        import numpy as np
        node_ids = list(self._nodes.keys())
        idx = {nid: i for i, nid in enumerate(node_ids)}
        adj: List[List[int]] = [[] for _ in node_ids]
        for e in self._edges.values():
            if edge_type is not None and e.type != edge_type:
                continue
            s, t = idx.get(e.source), idx.get(e.target)
            if s is None or t is None:
                continue
            if direction in ("out", "both"):
                adj[s].append(t)
            if direction in ("in", "both"):
                adj[t].append(s)
        indptr = np.zeros(len(node_ids) + 1, dtype=np.int64)
        for i, lst in enumerate(adj):
            indptr[i + 1] = indptr[i] + len(lst)
        indices = np.empty(int(indptr[-1]), dtype=np.int32)
        for i, lst in enumerate(adj):
            indices[indptr[i]: indptr[i + 1]] = lst
        csr = native.NativeCSRGraph(indptr, indices)
        if len(self._csr_cache) > 8:  # bound: variants are few in practice
            self._csr_cache.clear()
        self._csr_cache[key] = (self._version, csr, node_ids, idx)
        return csr, node_ids, idx

    def khop_nodes(self, start_ids: List[str], max_hops: int = 2,
                   direction: str = "both",
                   edge_type: Optional[str] = None,
                   use_native: Optional[bool] = None
                   ) -> List[tuple]:
        """All nodes within ``max_hops`` of the seeds with their hop
        distance: [(node_id, hop), ...].  Large graphs traverse the native
        CSR snapshot; small ones BFS the Python adjacency."""
        with self._lock:
            if use_native is None:
                use_native = len(self._edges) >= NATIVE_TRAVERSAL_THRESHOLD
            if use_native:
                snap = self._csr(direction, edge_type)
                if snap is not None:
                    csr, node_ids, idx = snap
                    seeds = [idx[s] for s in start_ids if s in idx]
                    if not seeds:
                        return []
                    nodes, hops = csr.bfs(seeds, max_hops)
                    return [(node_ids[int(n)], int(h))
                            for n, h in zip(nodes, hops)]
            # Python BFS fallback
            out, seen = [], set()
            frontier = [s for s in start_ids if s in self._nodes]
            for s in frontier:
                if s not in seen:
                    seen.add(s)
                    out.append((s, 0))
            for h in range(1, max_hops + 1):
                nxt = []
                for nid in frontier:
                    for nb in self.neighbors(nid, direction, edge_type):
                        if nb.id in seen:
                            continue
                        seen.add(nb.id)
                        out.append((nb.id, h))
                        nxt.append(nb.id)
                frontier = nxt
            return out

    # query() is attached by graphdb.cypher (mirrors the reference's
    # monkey-patched GraphDB.query, graph.py:1120)
