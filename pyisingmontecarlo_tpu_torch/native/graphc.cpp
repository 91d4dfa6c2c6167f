// Native graph-compilation passes of the PyTorch port.
//
// The irregular host-side passes that are slow in Python on graphs of many
// thousands of edges, which every engine consumes before its first sweep:
//   - ELL adjacency packing (neighbors/couplings with per-vertex slots)
//   - vertex coloring (exact bipartite 2-coloring via DFS, else greedy
//     largest-degree-first)  -> conflict-free parallel sweep classes
//   - greedy proper edge coloring -> conflict-free parallel edge moves
//   - greedy strong (distance-2) edge coloring -> parallel pair-flip moves
//
// Each pass gives the arrays of the python pass of the same name in
// pyisingmontecarlo_tpu_torch/graph.py, element for element: the order of
// the color classes fixes the classical engine's random stream.
//
// Exposed as a plain C ABI consumed via ctypes (pyisingmontecarlo_tpu_torch/
// _native_graph.py). All outputs are caller-allocated numpy buffers.

#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>

extern "C" {

// Compute per-vertex degree. Returns max degree.
int32_t graphc_degrees(int64_t nvars, int64_t nedges, const int32_t* ea,
                       const int32_t* eb, int32_t* degree_out) {
  std::memset(degree_out, 0, sizeof(int32_t) * nvars);
  for (int64_t k = 0; k < nedges; ++k) {
    degree_out[ea[k]]++;
    degree_out[eb[k]]++;
  }
  int32_t mx = 1;
  for (int64_t v = 0; v < nvars; ++v) mx = std::max(mx, degree_out[v]);
  return mx;
}

// ELL packing. neighbors/jmat are [nvars * max_deg] zero-initialized by the
// caller; slot_a/slot_b are [nedges].
void graphc_build_ell(int64_t nvars, int64_t nedges, int32_t max_deg,
                      const int32_t* ea, const int32_t* eb, const double* ej,
                      int32_t* neighbors, double* jmat, int32_t* slot_a,
                      int32_t* slot_b) {
  std::vector<int32_t> fill(nvars, 0);
  for (int64_t k = 0; k < nedges; ++k) {
    const int32_t a = ea[k], b = eb[k];
    const int32_t sa = fill[a]++, sb = fill[b]++;
    neighbors[(int64_t)a * max_deg + sa] = b;
    jmat[(int64_t)a * max_deg + sa] = ej[k];
    neighbors[(int64_t)b * max_deg + sb] = a;
    jmat[(int64_t)b * max_deg + sb] = ej[k];
    slot_a[k] = sa;
    slot_b[k] = sb;
  }
}

namespace {
// CSR adjacency scratch built from the edge list.
struct Csr {
  std::vector<int64_t> start;  // [nvars + 1]
  std::vector<int32_t> adj;    // [2 * nedges]
  Csr(int64_t nvars, int64_t nedges, const int32_t* ea, const int32_t* eb) {
    start.assign(nvars + 1, 0);
    for (int64_t k = 0; k < nedges; ++k) {
      start[ea[k] + 1]++;
      start[eb[k] + 1]++;
    }
    for (int64_t v = 0; v < nvars; ++v) start[v + 1] += start[v];
    adj.resize(2 * nedges);
    std::vector<int64_t> fill(start.begin(), start.end() - 1);
    for (int64_t k = 0; k < nedges; ++k) {
      adj[fill[ea[k]]++] = eb[k];
      adj[fill[eb[k]]++] = ea[k];
    }
  }
};
}  // namespace

// Vertex coloring into colors_out [nvars]. Returns the number of colors.
int32_t graphc_color_sites(int64_t nvars, int64_t nedges, const int32_t* ea,
                           const int32_t* eb, int32_t* colors_out) {
  Csr csr(nvars, nedges, ea, eb);
  std::fill(colors_out, colors_out + nvars, -1);
  // bipartite attempt: depth first from each uncolored vertex in index order
  bool bipartite = true;
  std::vector<int32_t> stack;
  for (int64_t s = 0; s < nvars && bipartite; ++s) {
    if (colors_out[s] >= 0) continue;
    colors_out[s] = 0;
    stack.push_back((int32_t)s);
    while (!stack.empty() && bipartite) {
      const int32_t v = stack.back();
      stack.pop_back();
      for (int64_t i = csr.start[v]; i < csr.start[v + 1]; ++i) {
        const int32_t w = csr.adj[i];
        if (colors_out[w] < 0) {
          colors_out[w] = 1 - colors_out[v];
          stack.push_back(w);
        } else if (colors_out[w] == colors_out[v]) {
          bipartite = false;
          break;
        }
      }
    }
  }
  if (bipartite) {
    int32_t nc = 1;
    for (int64_t v = 0; v < nvars; ++v) nc = std::max(nc, colors_out[v] + 1);
    return nc;
  }
  // greedy largest-degree-first
  std::fill(colors_out, colors_out + nvars, -1);
  std::vector<int32_t> order(nvars);
  for (int64_t v = 0; v < nvars; ++v) order[v] = (int32_t)v;
  std::stable_sort(order.begin(), order.end(), [&](int32_t x, int32_t y) {
    return (csr.start[x + 1] - csr.start[x]) > (csr.start[y + 1] - csr.start[y]);
  });
  std::vector<int32_t> used;  // color -> last vertex that marked it
  used.assign(64, -1);
  int32_t ncolors = 0;
  for (const int32_t v : order) {
    for (int64_t i = csr.start[v]; i < csr.start[v + 1]; ++i) {
      const int32_t cw = colors_out[csr.adj[i]];
      if (cw >= 0) {
        if ((size_t)cw >= used.size()) used.resize(cw + 1, -1);
        used[cw] = v;
      }
    }
    int32_t c = 0;
    while ((size_t)c < used.size() && used[c] == v) ++c;
    colors_out[v] = c;
    ncolors = std::max(ncolors, c + 1);
  }
  return ncolors;
}

// Greedy proper edge coloring into ecolors_out [nedges]. Returns #colors.
int32_t graphc_color_edges(int64_t nvars, int64_t nedges, const int32_t* ea,
                           const int32_t* eb, int32_t* ecolors_out) {
  // incidence CSR: vertex -> edge ids
  std::vector<int64_t> start(nvars + 1, 0);
  for (int64_t k = 0; k < nedges; ++k) {
    start[ea[k] + 1]++;
    start[eb[k] + 1]++;
  }
  for (int64_t v = 0; v < nvars; ++v) start[v + 1] += start[v];
  std::vector<int32_t> inc(2 * nedges);
  {
    std::vector<int64_t> fill(start.begin(), start.end() - 1);
    for (int64_t k = 0; k < nedges; ++k) {
      inc[fill[ea[k]]++] = (int32_t)k;
      inc[fill[eb[k]]++] = (int32_t)k;
    }
  }
  std::fill(ecolors_out, ecolors_out + nedges, -1);
  std::vector<int32_t> used(64, -1);
  int32_t ncolors = 0;
  for (int64_t k = 0; k < nedges; ++k) {
    const int32_t vs[2] = {ea[k], eb[k]};
    for (const int32_t v : vs) {
      for (int64_t i = start[v]; i < start[v + 1]; ++i) {
        const int32_t c = ecolors_out[inc[i]];
        if (c >= 0) {
          if ((size_t)c >= used.size()) used.resize(c + 1, -1);
          used[c] = (int32_t)k;
        }
      }
    }
    int32_t c = 0;
    while ((size_t)c < used.size() && used[c] == (int32_t)k) ++c;
    ecolors_out[k] = c;
    ncolors = std::max(ncolors, c + 1);
  }
  return ncolors;
}

// Greedy STRONG (distance-2) edge coloring into ecolors_out [nedges]: two
// edges conflict if they share a vertex OR are joined by a bond (any endpoint
// of one adjacent to any endpoint of the other). Within a class, flipping any
// endpoint pair leaves every other same-class pair's local field unchanged —
// the independence the parallel pair-flip move families require. Returns
// #colors.
int32_t graphc_strong_color_edges(int64_t nvars, int64_t nedges,
                                  const int32_t* ea, const int32_t* eb,
                                  int32_t* ecolors_out) {
  // incidence CSR: vertex -> edge ids
  std::vector<int64_t> start(nvars + 1, 0);
  for (int64_t k = 0; k < nedges; ++k) {
    start[ea[k] + 1]++;
    start[eb[k] + 1]++;
  }
  for (int64_t v = 0; v < nvars; ++v) start[v + 1] += start[v];
  std::vector<int32_t> inc(2 * nedges);
  {
    std::vector<int64_t> fill(start.begin(), start.end() - 1);
    for (int64_t k = 0; k < nedges; ++k) {
      inc[fill[ea[k]]++] = (int32_t)k;
      inc[fill[eb[k]]++] = (int32_t)k;
    }
  }
  Csr csr(nvars, nedges, ea, eb);
  std::fill(ecolors_out, ecolors_out + nedges, -1);
  std::vector<int32_t> used(64, -1);
  std::vector<int32_t> close;
  for (int64_t k = 0; k < nedges; ++k) {
    close.clear();
    const int32_t vs[2] = {ea[k], eb[k]};
    for (const int32_t v : vs) {
      close.push_back(v);
      for (int64_t i = csr.start[v]; i < csr.start[v + 1]; ++i)
        close.push_back(csr.adj[i]);
    }
    for (const int32_t v : close) {
      for (int64_t i = start[v]; i < start[v + 1]; ++i) {
        const int32_t c = ecolors_out[inc[i]];
        if (c >= 0) {
          if ((size_t)c >= used.size()) used.resize(c + 1, -1);
          used[c] = (int32_t)k;
        }
      }
    }
    int32_t c = 0;
    while ((size_t)c < used.size() && used[c] == (int32_t)k) ++c;
    ecolors_out[k] = c;
  }
  int32_t ncolors = 0;
  for (int64_t k = 0; k < nedges; ++k)
    ncolors = std::max(ncolors, ecolors_out[k] + 1);
  return ncolors;
}

}  // extern "C"
