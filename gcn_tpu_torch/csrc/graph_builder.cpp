// Host-side dependency-graph builder: path-centric pruning → edge lists.
//
// The C++ counterpart of gcn_tpu_torch/graph/prune.py's `prune_graph`,
// with its semantics (the reference's model/tree.py:81-162): the last root
// wins when the whole tree is kept, unreachable distances are kInfDist,
// prune_k < 0 keeps the whole tree, and a row with a cycle or no common
// ancestor reports num_edges < 0.  Held to the Python walker, bit for bit,
// by tests/test_torch_port_native.py.
//
// Exposed as a C ABI for ctypes (gcn_tpu_torch/graph/native.py):
//   prune_graph_batch(...): prunes a whole padded batch in one call;
//   graph_builder_abi_version(): 1.
//
// Built at first use by gcn_tpu_torch/ops/_cuda.py (`HostLibrary`) with
// the host compiler, `-O3 -std=c++17 -fPIC -shared` and no -march flag,
// into gcn_tpu_torch/_build/.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int32_t kInfDist = 10000;  // reference model/tree.py:144

// Per-example pruning.  Arrays are the caller's row slices (length >= len).
// Returns the number of edges written, or -1 on malformed input (a cycle,
// or entity chains with no common ancestor).
int32_t prune_one(const int32_t* head, const int32_t* deprel,
                  const int32_t* subj_pos, const int32_t* obj_pos,
                  int32_t len, int32_t prune_k, int32_t max_edges,
                  int32_t* edge_parent, int32_t* edge_child,
                  int32_t* edge_deprel, uint8_t* edge_mask, uint8_t* keep,
                  int32_t* root_out) {
  if (len <= 0) return 0;

  if (prune_k < 0) {
    // no pruning: the whole tree, every tree edge (head > 0)
    int32_t ne = 0;
    int32_t root = 0;
    for (int32_t i = 0; i < len; ++i) {
      keep[i] = 1;
      if (head[i] == 0) root = i;  // the last root wins (model/tree.py:76-77)
    }
    for (int32_t i = 0; i < len && ne < max_edges; ++i) {
      if (head[i] > 0) {
        edge_parent[ne] = head[i] - 1;
        edge_child[ne] = i;
        edge_deprel[ne] = deprel[i];
        edge_mask[ne] = 1;
        ++ne;
      }
    }
    *root_out = root;
    return ne;
  }

  std::vector<uint8_t> subj_anc(len, 0), obj_anc(len, 0);
  std::vector<int32_t> cas_count(len, 0);
  int32_t n_entity_chains = 0;

  // Walk one token's ancestor chain (the token included), marking `anc`
  // and counting each chain member once in cas_count.
  auto walk = [&](int32_t start, std::vector<uint8_t>& anc) -> bool {
    std::vector<uint8_t> in_chain(len, 0);
    int32_t cur = start;
    int32_t hops = 0;
    while (true) {
      if (!in_chain[cur]) {
        in_chain[cur] = 1;
        anc[cur] = 1;
      }
      int32_t h = head[cur];
      if (h <= 0) break;
      cur = h - 1;
      if (++hops > len + 1) return false;  // cycle guard
    }
    for (int32_t i = 0; i < len; ++i)
      if (in_chain[i]) ++cas_count[i];
    return true;
  };

  for (int32_t i = 0; i < len; ++i) {
    if (subj_pos[i] == 0) {
      ++n_entity_chains;
      if (!walk(i, subj_anc)) return -1;
    }
  }
  for (int32_t i = 0; i < len; ++i) {
    if (obj_pos[i] == 0) {
      ++n_entity_chains;
      if (!walk(i, obj_anc)) return -1;
    }
  }

  // cas = the nodes on every chain
  std::vector<uint8_t> cas(len, 0);
  for (int32_t i = 0; i < len; ++i)
    cas[i] = (cas_count[i] == n_entity_chains && n_entity_chains > 0);

  // LCA: the cas member with no child in cas (model/tree.py:111-124)
  std::vector<int32_t> child_count(len, 0);
  for (int32_t i = 0; i < len; ++i)
    if (cas[i] && head[i] > 0 && cas[head[i] - 1]) ++child_count[head[i] - 1];
  int32_t lca = -1;
  for (int32_t i = 0; i < len; ++i)
    if (cas[i] && child_count[i] == 0) { lca = i; break; }
  if (lca < 0) return -1;

  std::vector<uint8_t> path(len, 0);
  for (int32_t i = 0; i < len; ++i)
    path[i] = (subj_anc[i] || obj_anc[i]) && !cas[i];
  path[lca] = 1;

  // hops along the ancestor chain to the nearest path node
  // (model/tree.py:129-144)
  std::vector<int32_t> dist(len, -1);
  for (int32_t i = 0; i < len; ++i)
    if (path[i]) dist[i] = 0;
  std::vector<int32_t> stack;
  for (int32_t i = 0; i < len; ++i) {
    if (dist[i] >= 0) continue;
    stack.clear();
    stack.push_back(i);
    while (stack.back() >= 0 && !path[stack.back()]) {
      stack.push_back(head[stack.back()] - 1);
      if ((int32_t)stack.size() > len + 1) return -1;
    }
    if (stack.back() >= 0 && path[stack.back()]) {
      int32_t d = 0;
      for (auto it = stack.rbegin(); it != stack.rend(); ++it, ++d)
        dist[*it] = d;
    } else {
      for (int32_t j : stack)
        if (j >= 0 && dist[j] < 0) dist[j] = kInfDist;
    }
  }

  int32_t ne = 0;
  for (int32_t i = 0; i < len; ++i) keep[i] = (dist[i] <= prune_k);
  for (int32_t i = 0; i < len && ne < max_edges; ++i) {
    if (keep[i] && head[i] > 0 && i != lca) {
      if (!keep[head[i] - 1]) return -1;  // pruning invariant
      edge_parent[ne] = head[i] - 1;
      edge_child[ne] = i;
      edge_deprel[ne] = deprel[i];
      edge_mask[ne] = 1;
      ++ne;
    }
  }
  *root_out = lca;
  return ne;
}

}  // namespace

extern "C" {

// Batched pruning.  All arrays are row-major [batch, max_len]; the caller
// zero-fills the outputs.  num_edges[b] receives the row's edge count, or
// -1 when the row is malformed.  Returns 0 on success (even if some rows
// failed), nonzero only for invalid arguments.
int32_t prune_graph_batch(const int32_t* heads, const int32_t* deprels,
                          const int32_t* subj_pos, const int32_t* obj_pos,
                          const int32_t* lengths, int32_t batch,
                          int32_t max_len, int32_t prune_k,
                          int32_t* edge_parent, int32_t* edge_child,
                          int32_t* edge_deprel, uint8_t* edge_mask,
                          uint8_t* keep, int32_t* num_edges,
                          int32_t* roots) {
  if (batch < 0 || max_len <= 0) return 1;
  for (int32_t b = 0; b < batch; ++b) {
    const int64_t off = (int64_t)b * max_len;
    int32_t len = lengths[b];
    if (len > max_len) len = max_len;
    roots[b] = 0;
    num_edges[b] = prune_one(
        heads + off, deprels + off, subj_pos + off, obj_pos + off, len,
        prune_k, max_len, edge_parent + off, edge_child + off,
        edge_deprel + off, edge_mask + off, keep + off, roots + b);
  }
  return 0;
}

int32_t graph_builder_abi_version() { return 1; }

}  // extern "C"
