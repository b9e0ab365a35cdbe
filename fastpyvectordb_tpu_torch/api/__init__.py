from .client import Client, Collection, GetResult, QueryResult  # noqa: F401

__all__ = ["Client", "Collection", "GetResult", "QueryResult"]
