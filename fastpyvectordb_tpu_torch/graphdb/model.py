"""Property-graph elements and fluent builders.

Parity with the reference's graph element model (graph.py:57-246):
``Node`` (labels set + properties), ``Edge`` (typed, directed),
``Hyperedge`` (typed, connecting any number of nodes), dict round-trips,
and fluent builders.
"""

from __future__ import annotations

import itertools
import uuid
from typing import Any, Dict, Iterable, List, Optional, Set

_counter = itertools.count()


def _new_id(prefix: str) -> str:
    return f"{prefix}_{uuid.uuid4().hex[:12]}"


class Node:
    __slots__ = ("id", "labels", "properties")

    def __init__(self, id: Optional[str] = None,
                 labels: Optional[Iterable[str]] = None,
                 properties: Optional[dict] = None):
        self.id = id or _new_id("node")
        self.labels: Set[str] = set(labels or ())
        self.properties: Dict[str, Any] = dict(properties or {})

    def to_dict(self) -> dict:
        return {"id": self.id, "labels": sorted(self.labels),
                "properties": self.properties}

    @classmethod
    def from_dict(cls, d: dict) -> "Node":
        return cls(d["id"], d.get("labels"), d.get("properties"))

    def __repr__(self) -> str:
        return f"Node({self.id}, labels={sorted(self.labels)})"


class Edge:
    __slots__ = ("id", "source", "target", "type", "properties")

    def __init__(self, source: str, target: str, type: str,
                 id: Optional[str] = None, properties: Optional[dict] = None):
        self.id = id or _new_id("edge")
        self.source = source
        self.target = target
        self.type = type
        self.properties: Dict[str, Any] = dict(properties or {})

    def to_dict(self) -> dict:
        return {"id": self.id, "source": self.source, "target": self.target,
                "type": self.type, "properties": self.properties}

    @classmethod
    def from_dict(cls, d: dict) -> "Edge":
        return cls(d["source"], d["target"], d["type"], d["id"],
                   d.get("properties"))

    def __repr__(self) -> str:
        return f"Edge({self.source}-[:{self.type}]->{self.target})"


class Hyperedge:
    __slots__ = ("id", "nodes", "type", "properties")

    def __init__(self, nodes: Iterable[str], type: str,
                 id: Optional[str] = None, properties: Optional[dict] = None):
        self.id = id or _new_id("hyper")
        self.nodes: List[str] = list(nodes)
        self.type = type
        self.properties: Dict[str, Any] = dict(properties or {})

    def to_dict(self) -> dict:
        return {"id": self.id, "nodes": self.nodes, "type": self.type,
                "properties": self.properties}

    @classmethod
    def from_dict(cls, d: dict) -> "Hyperedge":
        return cls(d["nodes"], d["type"], d["id"], d.get("properties"))


# ---------------------------------------------------------------------------
# Fluent builders (reference: graph.py:155-246)
# ---------------------------------------------------------------------------

class NodeBuilder:
    def __init__(self, graph):
        self._graph = graph
        self._id: Optional[str] = None
        self._labels: Set[str] = set()
        self._props: Dict[str, Any] = {}

    def id(self, id: str) -> "NodeBuilder":
        self._id = id
        return self

    def label(self, *labels: str) -> "NodeBuilder":
        self._labels.update(labels)
        return self

    def property(self, key: str, value: Any) -> "NodeBuilder":
        self._props[key] = value
        return self

    def properties(self, **props) -> "NodeBuilder":
        self._props.update(props)
        return self

    def create(self) -> Node:
        return self._graph.create_node(labels=self._labels,
                                       properties=self._props, id=self._id)


class EdgeBuilder:
    def __init__(self, graph):
        self._graph = graph
        self._source: Optional[str] = None
        self._target: Optional[str] = None
        self._type: Optional[str] = None
        self._props: Dict[str, Any] = {}

    def from_node(self, node_id: str) -> "EdgeBuilder":
        self._source = node_id
        return self

    def to_node(self, node_id: str) -> "EdgeBuilder":
        self._target = node_id
        return self

    def type(self, t: str) -> "EdgeBuilder":
        self._type = t
        return self

    def property(self, key: str, value: Any) -> "EdgeBuilder":
        self._props[key] = value
        return self

    def create(self) -> Edge:
        if not (self._source and self._target and self._type):
            raise ValueError("edge builder needs from_node, to_node, and type")
        return self._graph.create_edge(self._source, self._target, self._type,
                                       properties=self._props)


class HyperedgeBuilder:
    def __init__(self, graph):
        self._graph = graph
        self._nodes: List[str] = []
        self._type: Optional[str] = None
        self._props: Dict[str, Any] = {}

    def nodes(self, *node_ids: str) -> "HyperedgeBuilder":
        self._nodes.extend(node_ids)
        return self

    def type(self, t: str) -> "HyperedgeBuilder":
        self._type = t
        return self

    def property(self, key: str, value: Any) -> "HyperedgeBuilder":
        self._props[key] = value
        return self

    def create(self) -> Hyperedge:
        if not self._nodes or not self._type:
            raise ValueError("hyperedge builder needs nodes and type")
        return self._graph.create_hyperedge(self._nodes, self._type,
                                            properties=self._props)
