"""Mini-Cypher query language for GraphDB.

Parity with the reference's SimpleQueryParser (graph.py:950-1120): a
regex-parsed subset of Cypher —

    MATCH (n:Label {prop: value})
    MATCH (a:L)-[:TYPE]->(b)            # one hop, any direction arrows
    MATCH (a)-[:TYPE*1..3]->(b)         # variable-length via traversal
    WHERE n.prop <op> value             # = <> < > <= >=, AND-combined
    RETURN n, n.prop [LIMIT k]

Executes against the GraphDB indexes (find_nodes for the anchor pattern,
adjacency expansion for hops).  Attached as ``GraphDB.query`` at import,
mirroring the reference's monkey-patch (graph.py:1120).
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Tuple

from .graph import GraphDB
from .model import Node

_NODE_RE = re.compile(
    r"\(\s*(?P<var>\w+)?\s*(?::(?P<label>\w+))?\s*(?:\{(?P<props>[^}]*)\})?\s*\)")
_REL_RE = re.compile(
    r"(?P<larrow><)?-\[\s*:(?P<type>\w+)\s*(?:\*(?P<min>\d+)\.\.(?P<max>\d+))?\s*\]-(?P<rarrow>>)?")


def _parse_value(tok: str) -> Any:
    tok = tok.strip()
    if (tok.startswith("'") and tok.endswith("'")) or \
       (tok.startswith('"') and tok.endswith('"')):
        return tok[1:-1]
    low = tok.lower()
    if low == "true":
        return True
    if low == "false":
        return False
    if low == "null":
        return None
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        return float(tok)
    except ValueError:
        return tok


def _split_outside_quotes(s: str, sep_re: str, flags: int = 0) -> List[str]:
    """Split on ``sep_re`` matches that fall outside '...' and "..."
    string literals (a plain re.split breaks values like "x, y" or
    'Rock AND Roll')."""
    parts, buf, quote = [], [], None
    i, n = 0, len(s)
    sep = re.compile(sep_re, flags)
    while i < n:
        ch = s[i]
        if quote is not None:
            buf.append(ch)
            if ch == quote:
                quote = None
            i += 1
            continue
        if ch in ("'", '"'):
            quote = ch
            buf.append(ch)
            i += 1
            continue
        m = sep.match(s, i)
        if m and m.end() > i:
            parts.append("".join(buf))
            buf = []
            i = m.end()
        else:
            buf.append(ch)
            i += 1
    parts.append("".join(buf))
    return parts


def _parse_props(s: Optional[str]) -> dict:
    if not s or not s.strip():
        return {}
    out = {}
    for part in _split_outside_quotes(s, r","):
        if ":" not in part:
            continue
        k, v = part.split(":", 1)
        out[k.strip()] = _parse_value(v)
    return out


_OPS = {
    "=": lambda a, b: a == b,
    "<>": lambda a, b: a != b,
    "<": lambda a, b: a < b,
    ">": lambda a, b: a > b,
    "<=": lambda a, b: a <= b,
    ">=": lambda a, b: a >= b,
}


class CypherError(ValueError):
    pass


class CypherQuery:
    """Parsed representation of one MATCH ... [WHERE ...] RETURN ... query."""

    def __init__(self, text: str):
        self.text = text.strip()
        m = re.match(
            r"MATCH\s+(?P<pattern>.+?)\s*(?:WHERE\s+(?P<where>.+?))?\s*"
            r"RETURN\s+(?P<ret>.+?)\s*(?:LIMIT\s+(?P<limit>\d+))?\s*$",
            self.text, re.IGNORECASE | re.DOTALL)
        if not m:
            raise CypherError(f"cannot parse query: {text!r}")
        self._parse_pattern(m.group("pattern"))
        self._parse_where(m.group("where"))
        self.returns = [r.strip() for r in m.group("ret").split(",")]
        self.limit = int(m.group("limit")) if m.group("limit") else None

    def _parse_pattern(self, pattern: str) -> None:
        nodes = list(_NODE_RE.finditer(pattern))
        if not nodes:
            raise CypherError(f"no node pattern in {pattern!r}")
        if len(nodes) > 2:
            # the mini-Cypher supports ONE hop (reference parity,
            # graph.py:950-1120); silently binding only the first two
            # nodes returned wrong rows for (a)-[..]->(b)-[..]->(c)
            raise CypherError(
                "patterns with more than two nodes are not supported "
                f"(got {len(nodes)} in {pattern!r}); use variable-length "
                "[:T*1..n] for multi-hop reachability")
        self.anchor = {
            "var": nodes[0].group("var") or "_a",
            "label": nodes[0].group("label"),
            "props": _parse_props(nodes[0].group("props")),
        }
        self.rel = None
        self.other = None
        if len(nodes) >= 2:
            between = pattern[nodes[0].end(): nodes[1].start()]
            rm = _REL_RE.search(between)
            if not rm:
                raise CypherError(
                    f"two node patterns but no relationship in {pattern!r}")
            if rm.group("rarrow"):
                direction = "out"
            elif rm.group("larrow"):
                direction = "in"
            else:
                direction = "both"
            self.rel = {
                "type": rm.group("type"),
                "direction": direction,
                "min": int(rm.group("min")) if rm.group("min") else 1,
                "max": int(rm.group("max")) if rm.group("max") else 1,
            }
            self.other = {
                "var": nodes[1].group("var") or "_b",
                "label": nodes[1].group("label"),
                "props": _parse_props(nodes[1].group("props")),
            }

    def _parse_where(self, where: Optional[str]) -> None:
        self.conditions: List[Tuple[str, str, str, Any]] = []
        if not where:
            return
        for clause in _split_outside_quotes(where, r"\s+AND\s+",
                                            re.IGNORECASE):
            cm = re.match(
                r"\s*(?P<var>\w+)\.(?P<prop>\w+)\s*(?P<op><=|>=|<>|=|<|>)"
                r"\s*(?P<value>.+?)\s*$", clause)
            if not cm:
                raise CypherError(f"cannot parse WHERE clause {clause!r}")
            self.conditions.append((cm.group("var"), cm.group("prop"),
                                    cm.group("op"),
                                    _parse_value(cm.group("value"))))


def _node_matches(node: Node, label: Optional[str], props: dict) -> bool:
    if label and label not in node.labels:
        return False
    return all(node.properties.get(k) == v for k, v in props.items())


def _check_where(binding: Dict[str, Node], conditions) -> bool:
    for var, prop, op, value in conditions:
        node = binding.get(var)
        if node is None:
            return False
        actual = node.properties.get(prop)
        if actual is None:
            return False
        try:
            if not _OPS[op](actual, value):
                return False
        except TypeError:
            return False
    return True


def _project(binding: Dict[str, Node], returns: List[str]) -> dict:
    row = {}
    for expr in returns:
        if "." in expr:
            var, prop = expr.split(".", 1)
            node = binding.get(var)
            row[expr] = node.properties.get(prop) if node else None
        else:
            node = binding.get(expr)
            row[expr] = node.to_dict() if node else None
    return row


def execute(graph: GraphDB, query_text: str) -> List[dict]:
    q = CypherQuery(query_text)
    anchors = graph.find_nodes(q.anchor["label"], q.anchor["props"] or None)
    rows: List[dict] = []
    full = (q.limit is None)

    def add(binding) -> bool:  # returns False once the limit is reached
        if _check_where(binding, q.conditions):
            rows.append(_project(binding, q.returns))
        return full or len(rows) < q.limit

    for a in anchors:
        if not full and len(rows) >= q.limit:
            break  # LIMIT terminates expansion, not just the final slice
        if q.rel is None:
            if not add({q.anchor["var"]: a}):
                break
            continue
        # expand hops
        targets = []
        if q.rel["min"] == 0:
            targets.append(a)  # Cypher *0..: the anchor itself binds
        if q.rel["max"] <= 1:
            targets.extend(graph.neighbors(a.id, q.rel["direction"],
                                           q.rel["type"]))
        else:
            paths = graph.traverse(a.id, max_depth=q.rel["max"],
                                   edge_type=q.rel["type"],
                                   direction=q.rel["direction"])
            seen = {}
            for p in paths:
                hops = len(p) - 1
                if hops >= max(q.rel["min"], 1):
                    seen.setdefault(p[-1], hops)
            targets.extend(graph.get_node(t) for t in seen)
        for b in targets:
            if b is None or not _node_matches(b, q.other["label"],
                                              q.other["props"]):
                continue
            if not add({q.anchor["var"]: a, q.other["var"]: b}):
                break
    if q.limit is not None:
        rows = rows[: q.limit]
    return rows


def _query(self: GraphDB, query_text: str) -> List[dict]:
    return execute(self, query_text)


GraphDB.query = _query
