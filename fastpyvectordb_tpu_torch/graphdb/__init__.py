from .model import (  # noqa: F401
    Edge,
    EdgeBuilder,
    Hyperedge,
    HyperedgeBuilder,
    Node,
    NodeBuilder,
)
from .graph import GraphDB  # noqa: F401
from . import cypher  # noqa: F401  (attaches GraphDB.query)
from .cypher import CypherError, CypherQuery, execute  # noqa: F401

__all__ = ["Node", "Edge", "Hyperedge", "NodeBuilder", "EdgeBuilder",
           "HyperedgeBuilder", "GraphDB", "CypherError", "CypherQuery",
           "execute"]
