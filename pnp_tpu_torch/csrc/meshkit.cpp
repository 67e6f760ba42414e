// meshkit: native mesh ingestion + preprocessing for pnp_tpu_torch (the
// port's own copy of the reference package's mesh kit, line for line in
// every function, so that both give the same arrays and partitions).
//
// The host-side runtime around the device work: parsing large Gmsh v2
// ASCII meshes, building boundary-edge adjacency, fixing orientation,
// enumerating unique edges (P2/P3 dof numbering), and computing a
// locality-preserving element partition (BFS greedy growth over the
// element adjacency graph; the reference's loadBalance() analogue,
// src/pnp_solver_main.cc:77-114).
//
// Exposed as a small C ABI consumed through ctypes
// (pnp_tpu_torch/meshio/native.py, which builds this file with the host
// C++ compiler at first use), with a pure-Python fallback.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <string>
#include <vector>
#include <unordered_map>
#include <queue>
#include <algorithm>

namespace {

struct Mesh {
  std::vector<double> nodes;       // N*2
  std::vector<int32_t> tris;       // E*3 (CCW)
  std::vector<int32_t> tri_phys;   // E
  std::vector<int32_t> edges;      // B*2
  std::vector<int32_t> edge_phys;  // B
  std::vector<int32_t> edge_tri;   // B
  std::vector<int32_t> edge_local; // B
  std::string error;
};

inline uint64_t ekey(int32_t a, int32_t b) {
  uint32_t lo = static_cast<uint32_t>(std::min(a, b));
  uint32_t hi = static_cast<uint32_t>(std::max(a, b));
  return (static_cast<uint64_t>(lo) << 32) | hi;
}

// local edge k of triangle (v0,v1,v2) connects vertices (k, (k+1)%3)
const int LOCAL_EDGE[3][2] = {{0, 1}, {1, 2}, {2, 0}};

bool parse(const char* path, Mesh& m) {
  FILE* f = std::fopen(path, "rb");
  if (!f) { m.error = "cannot open file"; return false; }
  char line[1 << 16];
  std::vector<int64_t> node_ids;
  std::vector<double> raw_nodes;
  struct RawElem { int type; int phys; int32_t v[3]; };
  std::vector<RawElem> elems;
  while (std::fgets(line, sizeof line, f)) {
    if (std::strncmp(line, "$MeshFormat", 11) == 0) {
      if (!std::fgets(line, sizeof line, f)) break;
      if (line[0] != '2') { m.error = "only Gmsh v2.x supported"; std::fclose(f); return false; }
    } else if (std::strncmp(line, "$Nodes", 6) == 0) {
      if (!std::fgets(line, sizeof line, f)) break;
      long n = std::strtol(line, nullptr, 10);
      node_ids.reserve(n); raw_nodes.reserve(2 * n);
      for (long i = 0; i < n; i++) {
        if (!std::fgets(line, sizeof line, f)) break;
        char* p = line;
        long id = std::strtol(p, &p, 10);
        double x = std::strtod(p, &p);
        double y = std::strtod(p, &p);
        (void)std::strtod(p, &p);  // z ignored (2-D)
        node_ids.push_back(id);
        raw_nodes.push_back(x);
        raw_nodes.push_back(y);
      }
    } else if (std::strncmp(line, "$Elements", 9) == 0) {
      if (!std::fgets(line, sizeof line, f)) break;
      long n = std::strtol(line, nullptr, 10);
      elems.reserve(n);
      for (long i = 0; i < n; i++) {
        if (!std::fgets(line, sizeof line, f)) break;
        char* p = line;
        (void)std::strtol(p, &p, 10);            // element id
        long type = std::strtol(p, &p, 10);
        long ntags = std::strtol(p, &p, 10);
        long phys = 0;
        for (long t = 0; t < ntags; t++) {
          long tag = std::strtol(p, &p, 10);
          if (t == 0) phys = tag;
        }
        if (type == 1 || type == 2) {
          RawElem e; e.type = (int)type; e.phys = (int)phys;
          int nv = (type == 1) ? 2 : 3;
          for (int v = 0; v < nv; v++) e.v[v] = (int32_t)std::strtol(p, &p, 10);
          elems.push_back(e);
        }
      }
    }
  }
  std::fclose(f);
  if (node_ids.empty()) { m.error = "no $Nodes section"; return false; }

  // remap (possibly sparse) gmsh ids to dense 0-based indices
  int64_t max_id = 0;
  for (int64_t id : node_ids) max_id = std::max(max_id, id);
  std::vector<int32_t> id2idx(max_id + 1, -1);
  for (size_t i = 0; i < node_ids.size(); i++) id2idx[node_ids[i]] = (int32_t)i;
  m.nodes = std::move(raw_nodes);

  for (const auto& e : elems) {
    if (e.type == 2) {
      int32_t a = id2idx[e.v[0]], b = id2idx[e.v[1]], c = id2idx[e.v[2]];
      // orient counter-clockwise
      double ax = m.nodes[2 * a], ay = m.nodes[2 * a + 1];
      double bx = m.nodes[2 * b], by = m.nodes[2 * b + 1];
      double cx = m.nodes[2 * c], cy = m.nodes[2 * c + 1];
      double det = (bx - ax) * (cy - ay) - (cx - ax) * (by - ay);
      if (det < 0) std::swap(b, c);
      m.tris.push_back(a); m.tris.push_back(b); m.tris.push_back(c);
      m.tri_phys.push_back(e.phys);
    } else {
      m.edges.push_back(id2idx[e.v[0]]);
      m.edges.push_back(id2idx[e.v[1]]);
      m.edge_phys.push_back(e.phys);
    }
  }

  // boundary edge -> adjacent triangle + local edge index
  const size_t E = m.tris.size() / 3;
  std::unordered_map<uint64_t, int64_t> edge_map;
  edge_map.reserve(3 * E * 2);
  for (size_t e = 0; e < E; e++) {
    for (int k = 0; k < 3; k++) {
      int32_t a = m.tris[3 * e + LOCAL_EDGE[k][0]];
      int32_t b = m.tris[3 * e + LOCAL_EDGE[k][1]];
      edge_map[ekey(a, b)] = (int64_t)(e * 3 + k);
    }
  }
  const size_t B = m.edge_phys.size();
  m.edge_tri.resize(B);
  m.edge_local.resize(B);
  for (size_t i = 0; i < B; i++) {
    auto it = edge_map.find(ekey(m.edges[2 * i], m.edges[2 * i + 1]));
    if (it == edge_map.end()) { m.error = "boundary edge not in any triangle"; return false; }
    m.edge_tri[i] = (int32_t)(it->second / 3);
    m.edge_local[i] = (int32_t)(it->second % 3);
  }
  return true;
}

// BFS greedy growth partition over the element adjacency graph: contiguous
// locality-preserving blocks of near-equal size (loadBalance analogue).
void partition(const Mesh& m, int nparts, int32_t* perm, int32_t* offsets) {
  const size_t E = m.tris.size() / 3;
  // element adjacency via shared edges
  std::unordered_map<uint64_t, int64_t> first;
  first.reserve(3 * E);
  std::vector<std::vector<int32_t>> adj(E);
  for (size_t e = 0; e < E; e++) {
    for (int k = 0; k < 3; k++) {
      uint64_t key = ekey(m.tris[3 * e + LOCAL_EDGE[k][0]],
                          m.tris[3 * e + LOCAL_EDGE[k][1]]);
      auto it = first.find(key);
      if (it == first.end()) first[key] = (int64_t)e;
      else if (it->second >= 0) {
        adj[e].push_back((int32_t)it->second);
        adj[it->second].push_back((int32_t)e);
        it->second = -1;
      }
    }
  }
  std::vector<char> used(E, 0);
  size_t out = 0;
  size_t target = (E + nparts - 1) / nparts;
  size_t scan = 0;
  offsets[0] = 0;
  for (int p = 0; p < nparts; p++) {
    size_t count = 0;
    std::queue<int32_t> q;
    while (count < target && out < E) {
      if (q.empty()) {
        while (scan < E && used[scan]) scan++;
        if (scan >= E) break;
        q.push((int32_t)scan);
        used[scan] = 1;
      }
      int32_t e = q.front(); q.pop();
      perm[out++] = e;
      count++;
      for (int32_t nb : adj[e]) {
        if (!used[nb] && count + q.size() < target) { used[nb] = 1; q.push(nb); }
      }
    }
    offsets[p + 1] = (int32_t)out;
  }
  // sweep up any stragglers into the last part
  for (size_t e = 0; e < E; e++) if (!used[e]) perm[out++] = (int32_t)e;
  offsets[nparts] = (int32_t)out;
}

}  // namespace

extern "C" {

void* mk_read(const char* path) {
  Mesh* m = new Mesh();
  if (!parse(path, *m)) {
    // keep the object so mk_error can report; caller checks mk_num_nodes>0
  }
  return m;
}

void mk_free(void* h) { delete static_cast<Mesh*>(h); }

const char* mk_error(void* h) { return static_cast<Mesh*>(h)->error.c_str(); }

int64_t mk_num_nodes(void* h) { return (int64_t)(static_cast<Mesh*>(h)->nodes.size() / 2); }
int64_t mk_num_tris(void* h) { return (int64_t)(static_cast<Mesh*>(h)->tris.size() / 3); }
int64_t mk_num_edges(void* h) { return (int64_t)(static_cast<Mesh*>(h)->edge_phys.size()); }

void mk_copy_nodes(void* h, double* out) {
  auto& v = static_cast<Mesh*>(h)->nodes;
  std::memcpy(out, v.data(), v.size() * sizeof(double));
}
void mk_copy_tris(void* h, int32_t* out) {
  auto& v = static_cast<Mesh*>(h)->tris;
  std::memcpy(out, v.data(), v.size() * sizeof(int32_t));
}
void mk_copy_tri_phys(void* h, int32_t* out) {
  auto& v = static_cast<Mesh*>(h)->tri_phys;
  std::memcpy(out, v.data(), v.size() * sizeof(int32_t));
}
void mk_copy_edges(void* h, int32_t* out) {
  auto& v = static_cast<Mesh*>(h)->edges;
  std::memcpy(out, v.data(), v.size() * sizeof(int32_t));
}
void mk_copy_edge_phys(void* h, int32_t* out) {
  auto& v = static_cast<Mesh*>(h)->edge_phys;
  std::memcpy(out, v.data(), v.size() * sizeof(int32_t));
}
void mk_copy_edge_tri(void* h, int32_t* out) {
  auto& v = static_cast<Mesh*>(h)->edge_tri;
  std::memcpy(out, v.data(), v.size() * sizeof(int32_t));
}
void mk_copy_edge_local(void* h, int32_t* out) {
  auto& v = static_cast<Mesh*>(h)->edge_local;
  std::memcpy(out, v.data(), v.size() * sizeof(int32_t));
}

void mk_partition(void* h, int nparts, int32_t* perm, int32_t* offsets) {
  partition(*static_cast<Mesh*>(h), nparts, perm, offsets);
}

}  // extern "C"
