"""The port's GraphDB (the cases of ``tests/test_graph.py``: CRUD + index
maintenance + traversal + Cypher + persistence), then parity with the JAX
package: one seeded operation sequence gives the same answers in both, on
a graph each side of ``NATIVE_TRAVERSAL_THRESHOLD`` (Python adjacency and
the native CSR traversal), and graph files load across the packages."""

import numpy as np
import pytest

from fastpyvectordb_tpu_torch.graphdb import GraphDB


@pytest.fixture()
def g():
    g = GraphDB()
    alice = g.create_node(["Person"], {"name": "Alice", "age": 34}, id="alice")
    bob = g.create_node(["Person"], {"name": "Bob", "age": 28}, id="bob")
    carol = g.create_node(["Person", "Admin"], {"name": "Carol", "age": 45},
                          id="carol")
    acme = g.create_node(["Company"], {"name": "Acme"}, id="acme")
    g.create_edge("alice", "bob", "KNOWS", {"since": 2019})
    g.create_edge("bob", "carol", "KNOWS")
    g.create_edge("alice", "acme", "WORKS_AT", {"role": "eng"})
    g.create_edge("carol", "acme", "WORKS_AT")
    return g


class TestCRUD:
    def test_create_and_get(self, g):
        n = g.get_node("alice")
        assert n.properties["name"] == "Alice" and "Person" in n.labels
        assert g.stats()["nodes"] == 4 and g.stats()["edges"] == 4

    def test_duplicate_node_rejected(self, g):
        with pytest.raises(ValueError):
            g.create_node(id="alice")

    def test_edge_requires_nodes(self, g):
        with pytest.raises(ValueError):
            g.create_edge("alice", "ghost", "KNOWS")

    def test_update_node_reindexes(self, g):
        g.update_node("bob", {"age": 29})
        assert [n.id for n in g.find_nodes(properties={"age": 29})] == ["bob"]
        assert g.find_nodes(properties={"age": 28}) == []

    def test_label_add_remove(self, g):
        g.update_node("bob", add_labels=["Admin"])
        assert {n.id for n in g.find_nodes(label="Admin")} == {"bob", "carol"}
        g.update_node("bob", remove_labels=["Admin"])
        assert {n.id for n in g.find_nodes(label="Admin")} == {"carol"}

    def test_delete_node_cascades(self, g):
        g.create_hyperedge(["alice", "bob", "carol"], "TEAM")
        assert g.delete_node("bob")
        assert g.get_edge_count() == 2 if hasattr(g, "get_edge_count") else True
        assert g.stats()["edges"] == 2  # bob's two KNOWS edges removed
        h = g.hyperedges_of_nodes(["alice"])
        assert len(h) == 1 and "bob" not in h[0].nodes

    def test_delete_node_with_small_hyperedge(self, g):
        g.create_hyperedge(["alice", "bob"], "PAIR")
        g.delete_node("bob")
        assert g.hyperedges_of_nodes(["alice"]) == []


class TestQueries:
    def test_find_by_label(self, g):
        assert {n.id for n in g.find_nodes(label="Person")} == \
            {"alice", "bob", "carol"}

    def test_find_by_label_and_property(self, g):
        out = g.find_nodes(label="Person", properties={"name": "Carol"})
        assert [n.id for n in out] == ["carol"]

    def test_find_no_criteria_returns_all(self, g):
        assert len(g.find_nodes()) == 4

    def test_range_query(self, g):
        out = g.find_nodes_in_range("age", min_value=30, max_value=50)
        assert {n.id for n in out} == {"alice", "carol"}
        out = g.find_nodes_in_range("age", min_value=30, label="Admin")
        assert {n.id for n in out} == {"carol"}

    def test_edges_of_type(self, g):
        assert len(g.edges_of_type("WORKS_AT")) == 2

    def test_hyperedge_any_all(self, g):
        g.create_hyperedge(["alice", "bob"], "T1")
        g.create_hyperedge(["bob", "carol"], "T2")
        assert len(g.hyperedges_of_nodes(["alice", "carol"], "any")) == 2
        assert len(g.hyperedges_of_nodes(["alice", "bob"], "all")) == 1


class TestTraversal:
    def test_neighbors_direction(self, g):
        assert {n.id for n in g.neighbors("alice", "out")} == {"bob", "acme"}
        assert {n.id for n in g.neighbors("bob", "in")} == {"alice"}
        assert {n.id for n in g.neighbors("bob", "both")} == {"alice", "carol"}

    def test_neighbors_edge_type(self, g):
        assert {n.id for n in g.neighbors("alice", "out", "WORKS_AT")} == \
            {"acme"}

    def test_traverse_paths(self, g):
        paths = g.traverse("alice", max_depth=2, edge_type="KNOWS")
        assert ["alice", "bob"] in paths
        assert ["alice", "bob", "carol"] in paths

    def test_shortest_path(self, g):
        assert g.shortest_path("alice", "carol", edge_type="KNOWS") == \
            ["alice", "bob", "carol"]
        assert g.shortest_path("alice", "alice") == ["alice"]
        g2 = GraphDB()
        g2.create_node(id="x")
        g2.create_node(id="y")
        assert g2.shortest_path("x", "y") is None


class TestCypher:
    def test_match_label(self, g):
        rows = g.query("MATCH (n:Person) RETURN n.name")
        assert sorted(r["n.name"] for r in rows) == ["Alice", "Bob", "Carol"]

    def test_match_props_inline(self, g):
        rows = g.query("MATCH (n:Person {name: 'Alice'}) RETURN n")
        assert len(rows) == 1 and rows[0]["n"]["id"] == "alice"

    def test_where_ops(self, g):
        rows = g.query("MATCH (n:Person) WHERE n.age > 30 RETURN n.name")
        assert sorted(r["n.name"] for r in rows) == ["Alice", "Carol"]
        rows = g.query(
            "MATCH (n:Person) WHERE n.age >= 28 AND n.age <> 45 RETURN n.name")
        assert sorted(r["n.name"] for r in rows) == ["Alice", "Bob"]

    def test_one_hop(self, g):
        rows = g.query("MATCH (a:Person)-[:WORKS_AT]->(c:Company) "
                       "RETURN a.name, c.name")
        assert sorted((r["a.name"], r["c.name"]) for r in rows) == \
            [("Alice", "Acme"), ("Carol", "Acme")]

    def test_incoming_hop(self, g):
        rows = g.query("MATCH (c:Company)<-[:WORKS_AT]-(a:Person) "
                       "RETURN a.name")
        assert sorted(r["a.name"] for r in rows) == ["Alice", "Carol"]

    def test_variable_length(self, g):
        rows = g.query("MATCH (a:Person {name: 'Alice'})-[:KNOWS*1..2]->(b) "
                       "RETURN b.name")
        assert sorted(r["b.name"] for r in rows) == ["Bob", "Carol"]

    def test_limit(self, g):
        rows = g.query("MATCH (n:Person) RETURN n.name LIMIT 2")
        assert len(rows) == 2

    def test_parse_error(self, g):
        from fastpyvectordb_tpu_torch.graphdb import CypherError
        with pytest.raises(CypherError):
            g.query("SELECT * FROM nodes")


def test_persistence_roundtrip(tmp_path):
    g = GraphDB(str(tmp_path))
    g.create_node(["A"], {"x": 1}, id="n1")
    g.create_node(["B"], {"x": 2}, id="n2")
    g.create_edge("n1", "n2", "REL", {"w": 0.5})
    g.create_hyperedge(["n1", "n2"], "H")
    g.save()

    g2 = GraphDB(str(tmp_path))
    assert g2.stats() == g.stats()
    assert g2.get_node("n1").properties == {"x": 1}
    assert [n.id for n in g2.find_nodes(label="B")] == ["n2"]
    assert [n.id for n in g2.neighbors("n1", "out")] == ["n2"]
    assert len(g2.hyperedges_of_nodes(["n1"])) == 1


def test_builders():
    g = GraphDB()
    n = g.node().id("x").label("L1", "L2").property("a", 1).create()
    m = g.node().properties(b=2).create()
    e = g.edge().from_node(n.id).to_node(m.id).type("R").property(
        "w", 1.0).create()
    h = g.hyperedge().nodes(n.id, m.id).type("H").create()
    assert n.labels == {"L1", "L2"} and e.properties["w"] == 1.0
    assert len(h.nodes) == 2
    with pytest.raises(ValueError):
        g.edge().from_node(n.id).create()


class TestNativeTraversal:
    def test_khop_native_matches_python(self, g):
        from fastpyvectordb_tpu_torch import native
        if not native.graph_available():
            pytest.skip("no C++ toolchain")
        py = sorted(g.khop_nodes(["alice"], 2, use_native=False))
        nat = sorted(g.khop_nodes(["alice"], 2, use_native=True))
        assert py == nat
        assert ("alice", 0) in nat and any(h == 2 for _, h in nat)
        # direction + edge-type filters
        py = sorted(g.khop_nodes(["alice"], 2, direction="out",
                                 edge_type="KNOWS", use_native=False))
        nat = sorted(g.khop_nodes(["alice"], 2, direction="out",
                                  edge_type="KNOWS", use_native=True))
        assert py == nat == [("alice", 0), ("bob", 1), ("carol", 2)]

    def test_native_shortest_path_on_large_graph(self):
        from fastpyvectordb_tpu_torch import native
        import fastpyvectordb_tpu_torch.graphdb.graph as gmod
        if not native.graph_available():
            pytest.skip("no C++ toolchain")
        g = GraphDB()
        # chain of 500 nodes -> force the native path via threshold patch
        for i in range(500):
            g.create_node(id=f"n{i}")
        for i in range(499):
            g.create_edge(f"n{i}", f"n{i+1}", "NEXT")
        old = gmod.NATIVE_TRAVERSAL_THRESHOLD
        gmod.NATIVE_TRAVERSAL_THRESHOLD = 1
        try:
            path = g.shortest_path("n0", "n499")
            assert path[0] == "n0" and path[-1] == "n499"
            assert len(path) == 500
            # mutation invalidates the CSR snapshot
            g.create_edge("n0", "n499", "SHORTCUT")
            assert g.shortest_path("n0", "n499") == ["n0", "n499"]
        finally:
            gmod.NATIVE_TRAVERSAL_THRESHOLD = old


def test_cypher_quoted_commas_and_and():
    from fastpyvectordb_tpu_torch.graphdb import GraphDB
    g = GraphDB()
    g.create_node(["Song"], {"title": "Rock AND Roll", "tag": "x, y"},
                  id="s1")
    g.create_node(["Song"], {"title": "Quiet", "tag": "z"}, id="s2")
    rows = g.query('MATCH (n:Song {tag: "x, y"}) RETURN n.title')
    assert [r["n.title"] for r in rows] == ["Rock AND Roll"]
    rows = g.query(
        "MATCH (n:Song) WHERE n.title = 'Rock AND Roll' RETURN n.title")
    assert [r["n.title"] for r in rows] == ["Rock AND Roll"]


def test_cypher_zero_hop_var_length():
    from fastpyvectordb_tpu_torch.graphdb import GraphDB
    g = GraphDB()
    g.create_node(["X"], {}, id="a")
    g.create_node(["X"], {}, id="b")
    g.create_edge("a", "b", "T")
    rows = g.query("MATCH (n:X)-[:T*0..2]->(m) RETURN m")
    ids = {r["m"]["id"] for r in rows}
    assert "a" in ids and "b" in ids  # zero-hop binds the anchor itself


def test_cypher_limit_early():
    from fastpyvectordb_tpu_torch.graphdb import GraphDB
    g = GraphDB()
    for i in range(50):
        g.create_node(["U"], {"i": i}, id=f"u{i}")
    rows = g.query("MATCH (n:U) RETURN n LIMIT 3")
    assert len(rows) == 3


def test_property_index_numeric_string_distinct():
    from fastpyvectordb_tpu_torch.graphdb import GraphDB
    g = GraphDB()
    g.create_node(["P"], {"age": 30}, id="num")
    g.create_node(["P"], {"age": "30"}, id="strv")
    hits = {n.id for n in g.find_nodes_in_range("age", 25, 35)}
    assert hits == {"num"}, hits  # the string '30' is not in a numeric range
    assert {n.id for n in g.find_nodes("P", {"age": 30})} == {"num"}
    assert {n.id for n in g.find_nodes("P", {"age": "30"})} == {"strv"}
    g.delete_node("num")
    assert g.find_nodes_in_range("age", 25, 35) == []


# ----------------------------------------------------------------------
# Parity with the JAX package
# ----------------------------------------------------------------------
def _build_pair(n_nodes, n_edges, seed):
    """The same seeded graph in both packages' GraphDB."""
    from fastpyvectordb_tpu.graphdb import GraphDB as JGraphDB
    rng = np.random.default_rng(seed)
    graphs = (GraphDB(), JGraphDB())
    labels = ["Person", "Company", "Paper"]
    for i in range(n_nodes):
        lab = [labels[i % 3]] + (["Admin"] if i % 7 == 0 else [])
        props = {"i": i, "age": int(rng.integers(18, 80)),
                 "name": f"n{i % 50}"}
        for g in graphs:
            g.create_node(lab, dict(props), id=f"v{i}")
    src = rng.integers(0, n_nodes, n_edges)
    dst = rng.integers(0, n_nodes, n_edges)
    types = np.array(["KNOWS", "CITES", "WORKS_AT"])[rng.integers(0, 3,
                                                                 n_edges)]
    for e, (a, b, t) in enumerate(zip(src.tolist(), dst.tolist(),
                                      types.tolist())):
        for g in graphs:
            g.create_edge(f"v{a}", f"v{b}", t, {"w": e % 5}, id=f"e{e}")
    for h in range(5):
        members = [f"v{int(x)}" for x in rng.choice(n_nodes, 3,
                                                    replace=False)]
        for g in graphs:
            g.create_hyperedge(members, "TEAM", {"h": h}, id=f"h{h}")
    return graphs, rng


def _answers(g, rng_seed, n_nodes):
    rng = np.random.default_rng(rng_seed)
    starts = [f"v{int(x)}" for x in rng.integers(0, n_nodes, 6)]
    ends = [f"v{int(x)}" for x in rng.integers(0, n_nodes, 6)]
    out = {"stats": g.stats(),
           "find": [n.id for n in g.find_nodes("Person", {"name": "n3"})],
           "range": sorted(n.id for n in g.find_nodes_in_range("age", 30,
                                                               40)),
           "hyper": sorted(h.id for h in g.hyperedges_of_nodes(
               starts[:2], "any"))}
    for s in starts:
        out[f"nb_{s}"] = [n.id for n in g.neighbors(s, "both")]
        out[f"nbk_{s}"] = [n.id for n in g.neighbors(s, "out", "KNOWS")]
        out[f"trav_{s}"] = g.traverse(s, 2, "KNOWS", "out")
        for direction in ("both", "out"):
            out[f"khop_{s}_{direction}"] = sorted(
                g.khop_nodes([s], 3, direction=direction))
    for s, t in zip(starts, ends):
        out[f"sp_{s}_{t}"] = g.shortest_path(s, t)
    for q in ("MATCH (n:Admin) WHERE n.age > 50 RETURN n.name, n.i",
              "MATCH (a:Person)-[:KNOWS]->(b) RETURN a.i, b.i LIMIT 20",
              "MATCH (a:Person {name: 'n7'})-[:CITES*1..2]->(b) "
              "RETURN b.i",
              "MATCH (n:Company) WHERE n.i < 30 RETURN n"):
        out[q] = g.query(q)
    return out


def _same_path(g, a, b, src, dst):
    """Two shortest paths are both valid and of the same length (ties in
    the BFS order may pick different equal-length paths)."""
    assert (a is None) == (b is None)
    if a is None:
        return
    assert len(a) == len(b) and a[0] == b[0] == src and a[-1] == b[-1] == dst
    for path in (a, b):
        for u, v in zip(path, path[1:]):
            assert v in {n.id for n in g.neighbors(u, "both")}


@pytest.mark.parametrize("n_nodes,n_edges", [(300, 900), (3000, 10_500)],
                         ids=["python_adjacency", "native_csr"])
def test_same_answers_as_the_jax_package(n_nodes, n_edges):
    from fastpyvectordb_tpu_torch import native
    import fastpyvectordb_tpu_torch.graphdb.graph as gmod
    (ours, theirs), _ = _build_pair(n_nodes, n_edges, seed=n_nodes)
    native_side = n_edges >= gmod.NATIVE_TRAVERSAL_THRESHOLD
    if native_side and not native.graph_available():
        pytest.skip("no C++ toolchain")
    a = _answers(ours, 5, n_nodes)
    b = _answers(theirs, 5, n_nodes)
    assert a.keys() == b.keys()
    for key in a:
        if key.startswith("sp_"):
            _, s, t = key.split("_")
            _same_path(ours, a[key], b[key], s, t)
        else:
            assert a[key] == b[key], key
    if native_side:
        # the port's CSR snapshot served them, with the Python BFS's answer
        assert ours._csr_cache
        s = next(k for k in a if k.startswith("khop_")).split("_")[1]
        assert sorted(ours.khop_nodes([s], 3, use_native=False)) == \
            a[f"khop_{s}_both"]


def test_graph_files_load_across_packages(tmp_path):
    from fastpyvectordb_tpu.graphdb import GraphDB as JGraphDB
    (ours, theirs), _ = _build_pair(120, 400, seed=9)
    ours.delete_node("v5")
    theirs.delete_node("v5")
    ours.update_node("v6", {"x": [1, 2]}, add_labels=["Tagged"])
    theirs.update_node("v6", {"x": [1, 2]}, add_labels=["Tagged"])
    ours.save(str(tmp_path / "t"))
    theirs.save(str(tmp_path / "j"))
    # the JAX package's save is deterministic: the files are equal
    assert (tmp_path / "t" / "graph.fpvt").read_bytes() == \
        (tmp_path / "j" / "graph.fpvt").read_bytes()
    from_jax = GraphDB(str(tmp_path / "j"))
    from_port = JGraphDB(str(tmp_path / "t"))
    assert _answers(from_jax, 2, 120) == _answers(theirs, 2, 120)
    assert _answers(from_port, 2, 120) == _answers(ours, 2, 120)
