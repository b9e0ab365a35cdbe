// Native CSR graph traversal.
//
// The property graph's Python BFS over dict-based adjacency
// (graph.py:818-902 in the reference; graphdb/graph.py here) is fine at
// thousands of nodes but dominates hybrid graph+vector queries at millions
// of edges.  This module walks an immutable CSR snapshot (built once per
// graph version) in C++: multi-source BFS with hop distances, bounded-depth
// expansion, and shortest-path extraction.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC graph.cpp -o libfvdb_graph.so

#include <cstdint>
#include <cstring>
#include <queue>
#include <vector>

extern "C" {

// Multi-source BFS over CSR.  Returns the number of visited nodes
// (excluding unreached).  out_nodes/out_hops must have capacity n_nodes.
int64_t csr_bfs(
    int64_t n_nodes,
    const int64_t* indptr,      // (n_nodes + 1)
    const int32_t* indices,     // (n_edges)
    const int32_t* seeds, int64_t n_seeds,
    int32_t max_hops,
    int32_t* out_nodes, int32_t* out_hops) {
    std::vector<int32_t> hop(n_nodes, -1);
    std::vector<int32_t> frontier, next;
    int64_t count = 0;
    for (int64_t i = 0; i < n_seeds; ++i) {
        int32_t s = seeds[i];
        if (s < 0 || s >= n_nodes || hop[s] != -1) continue;
        hop[s] = 0;
        out_nodes[count] = s;
        out_hops[count] = 0;
        ++count;
        frontier.push_back(s);
    }
    for (int32_t h = 1; h <= max_hops && !frontier.empty(); ++h) {
        next.clear();
        for (int32_t u : frontier) {
            for (int64_t e = indptr[u]; e < indptr[u + 1]; ++e) {
                int32_t v = indices[e];
                if (hop[v] != -1) continue;
                hop[v] = h;
                out_nodes[count] = v;
                out_hops[count] = h;
                ++count;
                next.push_back(v);
            }
        }
        frontier.swap(next);
    }
    return count;
}

// BFS shortest path from src to dst.  Writes the path (src..dst) into
// out_path (capacity n_nodes); returns its length, or 0 if unreachable.
int64_t csr_shortest_path(
    int64_t n_nodes,
    const int64_t* indptr,
    const int32_t* indices,
    int32_t src, int32_t dst,
    int32_t* out_path) {
    if (src < 0 || dst < 0 || src >= n_nodes || dst >= n_nodes) return 0;
    if (src == dst) {
        out_path[0] = src;
        return 1;
    }
    std::vector<int32_t> prev(n_nodes, -2);
    std::queue<int32_t> q;
    prev[src] = -1;
    q.push(src);
    while (!q.empty()) {
        int32_t u = q.front();
        q.pop();
        for (int64_t e = indptr[u]; e < indptr[u + 1]; ++e) {
            int32_t v = indices[e];
            if (prev[v] != -2) continue;
            prev[v] = u;
            if (v == dst) {
                // reconstruct
                std::vector<int32_t> rev;
                for (int32_t x = dst; x != -1; x = prev[x]) rev.push_back(x);
                int64_t len = static_cast<int64_t>(rev.size());
                for (int64_t i = 0; i < len; ++i)
                    out_path[i] = rev[len - 1 - i];
                return len;
            }
            q.push(v);
        }
    }
    return 0;
}

// Per-seed bounded BFS used by semantic graph search: for every visited
// node record (node, hop, seed_index-of-first-reach).  out_* capacity:
// n_nodes.  Returns visited count.
int64_t csr_bfs_attributed(
    int64_t n_nodes,
    const int64_t* indptr,
    const int32_t* indices,
    const int32_t* seeds, int64_t n_seeds,
    int32_t max_hops,
    int32_t* out_nodes, int32_t* out_hops, int32_t* out_seed_idx) {
    std::vector<int32_t> hop(n_nodes, -1);
    std::vector<int32_t> attributed(n_nodes, -1);
    std::vector<int32_t> frontier, next;
    int64_t count = 0;
    for (int64_t i = 0; i < n_seeds; ++i) {
        int32_t s = seeds[i];
        if (s < 0 || s >= n_nodes || hop[s] != -1) continue;
        hop[s] = 0;
        attributed[s] = static_cast<int32_t>(i);
        out_nodes[count] = s;
        out_hops[count] = 0;
        out_seed_idx[count] = static_cast<int32_t>(i);
        ++count;
        frontier.push_back(s);
    }
    for (int32_t h = 1; h <= max_hops && !frontier.empty(); ++h) {
        next.clear();
        for (int32_t u : frontier) {
            for (int64_t e = indptr[u]; e < indptr[u + 1]; ++e) {
                int32_t v = indices[e];
                if (hop[v] != -1) continue;
                hop[v] = h;
                attributed[v] = attributed[u];
                out_nodes[count] = v;
                out_hops[count] = h;
                out_seed_idx[count] = attributed[u];
                ++count;
                next.push_back(v);
            }
        }
        frontier.swap(next);
    }
    return count;
}

}  // extern "C"
