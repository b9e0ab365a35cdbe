"""Secondary indexes for the property graph.

The reference maintains five index structures (graph.py:253-488); here the
same five, kept as small focused classes with add/remove maintenance hooks:

  LabelIndex          label -> node ids
  AdjacencyIndex      node -> outgoing / incoming edge ids
  EdgeTypeIndex       type -> edge ids
  PropertyIndex       key -> value -> node ids (O(1) exact, range via scan
                      of numeric values)
  HyperedgeNodeIndex  node -> hyperedge ids (any/all membership queries)
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Dict, Iterable, Optional, Set


class LabelIndex:
    def __init__(self):
        self._by_label: Dict[str, Set[str]] = defaultdict(set)

    def add(self, node_id: str, labels: Iterable[str]) -> None:
        for lab in labels:
            self._by_label[lab].add(node_id)

    def remove(self, node_id: str, labels: Iterable[str]) -> None:
        for lab in labels:
            s = self._by_label.get(lab)
            if s:
                s.discard(node_id)
                if not s:
                    del self._by_label[lab]

    def get(self, label: str) -> Set[str]:
        return set(self._by_label.get(label, ()))

    def labels(self):
        return self._by_label.keys()


class AdjacencyIndex:
    def __init__(self):
        self._out: Dict[str, Set[str]] = defaultdict(set)
        self._in: Dict[str, Set[str]] = defaultdict(set)

    def add(self, edge_id: str, source: str, target: str) -> None:
        self._out[source].add(edge_id)
        self._in[target].add(edge_id)

    def remove(self, edge_id: str, source: str, target: str) -> None:
        self._out.get(source, set()).discard(edge_id)
        self._in.get(target, set()).discard(edge_id)

    def outgoing(self, node_id: str) -> Set[str]:
        return set(self._out.get(node_id, ()))

    def incoming(self, node_id: str) -> Set[str]:
        return set(self._in.get(node_id, ()))

    def all_edges(self, node_id: str) -> Set[str]:
        return self.outgoing(node_id) | self.incoming(node_id)


class EdgeTypeIndex:
    def __init__(self):
        self._by_type: Dict[str, Set[str]] = defaultdict(set)

    def add(self, edge_id: str, type: str) -> None:
        self._by_type[type].add(edge_id)

    def remove(self, edge_id: str, type: str) -> None:
        s = self._by_type.get(type)
        if s:
            s.discard(edge_id)
            if not s:
                del self._by_type[type]

    def get(self, type: str) -> Set[str]:
        return set(self._by_type.get(type, ()))


def _pkey(v: Any) -> str:
    """Index key for a property value, disambiguated by type class: a
    bare str(v) collides the string '30' with the number 30, so numeric
    range queries would return string-valued nodes and deleting one
    value's last node could strand the other's numeric entry."""
    if isinstance(v, bool):
        return f"b:{v}"
    if isinstance(v, (int, float)):
        return f"n:{float(v)!r}"
    return f"s:{v}"


class PropertyIndex:
    """key -> typed-value-key -> node ids.  Exact lookups are O(1);
    numeric range queries scan the key's distinct values (reference:
    graph.py:347-426)."""

    def __init__(self):
        self._by_kv: Dict[str, Dict[str, Set[str]]] = defaultdict(
            lambda: defaultdict(set))
        self._numeric: Dict[str, Dict[str, float]] = defaultdict(dict)

    def add(self, node_id: str, properties: dict) -> None:
        for k, v in properties.items():
            sv = _pkey(v)
            self._by_kv[k][sv].add(node_id)
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                self._numeric[k][sv] = float(v)

    def remove(self, node_id: str, properties: dict) -> None:
        for k, v in properties.items():
            sv = _pkey(v)
            vals = self._by_kv.get(k)
            if not vals:
                continue
            s = vals.get(sv)
            if s:
                s.discard(node_id)
                if not s:
                    del vals[sv]
                    self._numeric.get(k, {}).pop(sv, None)

    def get(self, key: str, value: Any) -> Set[str]:
        return set(self._by_kv.get(key, {}).get(_pkey(value), ()))

    def range(self, key: str, min_value: Optional[float] = None,
              max_value: Optional[float] = None) -> Set[str]:
        out: Set[str] = set()
        for sv, num in self._numeric.get(key, {}).items():
            if min_value is not None and num < min_value:
                continue
            if max_value is not None and num > max_value:
                continue
            out |= self._by_kv[key].get(sv, set())
        return out

    def keys(self):
        return self._by_kv.keys()


class HyperedgeNodeIndex:
    def __init__(self):
        self._by_node: Dict[str, Set[str]] = defaultdict(set)

    def add(self, hyperedge_id: str, nodes: Iterable[str]) -> None:
        for n in nodes:
            self._by_node[n].add(hyperedge_id)

    def remove(self, hyperedge_id: str, nodes: Iterable[str]) -> None:
        for n in nodes:
            s = self._by_node.get(n)
            if s:
                s.discard(hyperedge_id)
                if not s:
                    del self._by_node[n]

    def get(self, node_id: str) -> Set[str]:
        return set(self._by_node.get(node_id, ()))

    def get_by_nodes(self, node_ids: Iterable[str], mode: str = "any"
                     ) -> Set[str]:
        sets = [self.get(n) for n in node_ids]
        if not sets:
            return set()
        if mode == "any":
            out = set()
            for s in sets:
                out |= s
            return out
        if mode == "all":
            out = sets[0]
            for s in sets[1:]:
                out &= s
            return out
        raise ValueError(f"mode must be 'any' or 'all', got {mode!r}")
