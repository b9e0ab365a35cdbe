"""Multi-card sharded search: meshes, collectives, sharded exact / IVF / IVF-PQ / int8 searchers, the multi-process runtime."""
