"""Edge lists -> compiled graph arrays: ELL adjacency, colorings, detectors.

Counterpart of ``pyisingmontecarlo_tpu/graph.py``, carried over (numpy only)
rather than imported, because importing any module of the JAX package imports
jax. Compilation products are lazy, as there: the uniform square torus runs
its own kernel and never pays for a coloring. The ELL adjacency and the three
colorings come from the port's native library (``_native_graph.py``, built
from ``native/graphc.cpp`` at first use) where a C++ compiler is on ``PATH``,
else from the python passes below, the plain version: both give the JAX
package's arrays, array for array. The order of the color classes decides the
random stream of the classical engine, so the two packages must agree on it.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np

from . import _native_graph

__all__ = [
    "CompiledGraph",
    "parse_edges",
    "compile_graph",
    "compile_graph_arrays",
    "grid_2d_edges",
    "detect_square_torus",
    "detect_dense",
    "detect_topology",
]


def parse_edges(edges: Sequence) -> Tuple[int, np.ndarray, np.ndarray, np.ndarray]:
    """Parse ``[((a, b), J), ...]`` into ``(nvars, edge_a, edge_b, edge_j)``.

    Raises ``ValueError`` for an empty edge list, non-integer or negative
    indices, or self-loops (the JAX package's checks)."""
    if len(edges) == 0:
        raise ValueError("Must supply some edges for graph")
    arr = np.array([(a, b, j) for (a, b), j in edges], dtype=np.float64)
    ea = arr[:, 0].astype(np.int64)
    eb = arr[:, 1].astype(np.int64)
    if np.any(arr[:, 0] != ea) or np.any(arr[:, 1] != eb):
        raise ValueError("Edge vertex indices must be integers")
    if (ea < 0).any() or (eb < 0).any():
        raise ValueError("Edge vertex indices must be non-negative")
    if (ea == eb).any():
        k = int(np.nonzero(ea == eb)[0][0])
        raise ValueError(f"Edge ({ea[k]}, {eb[k]}) is a self-loop")
    nvars = int(max(ea.max(), eb.max())) + 1
    return nvars, ea.astype(np.int32), eb.astype(np.int32), arr[:, 2].copy()


def _build_ell_numpy(nvars, ea, eb, ej):
    """ELL packing (O(E log E)): both edge directions sorted by source vertex;
    the position within each vertex group is the ELL slot. Endpoints are
    interleaved (a0, b0, a1, b1, ...), so a vertex's slots follow edge order.
    Returns ``(neighbors, jmat, degree, max_deg, slot_a, slot_b)``."""
    E = len(ea)
    src = np.column_stack([ea, eb]).reshape(-1)
    dst = np.column_stack([eb, ea]).reshape(-1)
    js = np.repeat(ej, 2)
    order = np.argsort(src, kind="stable")
    ssrc = src[order]
    degree = np.bincount(src, minlength=nvars).astype(np.int32)
    max_deg = max(int(degree.max()), 1)
    starts = np.zeros(nvars + 1, dtype=np.int64)
    np.cumsum(degree, out=starts[1:])
    pos = np.arange(2 * E, dtype=np.int64) - starts[ssrc]
    neighbors = np.zeros((nvars, max_deg), dtype=np.int32)
    jmat = np.zeros((nvars, max_deg), dtype=np.float64)
    neighbors[ssrc, pos] = dst[order]
    jmat[ssrc, pos] = js[order]
    slots = np.empty(2 * E, dtype=np.int32)
    slots[order] = pos.astype(np.int32)
    return neighbors, jmat, degree, max_deg, slots[0::2].copy(), slots[1::2].copy()


def _adjacency_lists(nvars, ea, eb):
    adj = [[] for _ in range(nvars)]
    for a, b in zip(ea.tolist(), eb.tolist()):
        adj[a].append(b)
        adj[b].append(a)
    return adj


def _incident_lists(nvars, ea, eb):
    incident = [[] for _ in range(nvars)]
    for k, (a, b) in enumerate(zip(ea.tolist(), eb.tolist())):
        incident[a].append(k)
        incident[b].append(k)
    return incident


def _color_sites_python(nvars: int, ea: np.ndarray, eb: np.ndarray) -> np.ndarray:
    """Proper vertex coloring: the exact 2-coloring of a bipartite graph (DFS
    from each uncolored vertex in index order), else greedy largest degree
    first (smallest free color, ties by index)."""
    adj = _adjacency_lists(nvars, ea, eb)
    colors = np.full(nvars, -1, dtype=np.int32)
    bipartite = True
    for s in range(nvars):
        if colors[s] >= 0:
            continue
        colors[s] = 0
        stack = [s]
        while stack and bipartite:
            v = stack.pop()
            for w in adj[v]:
                if colors[w] < 0:
                    colors[w] = 1 - colors[v]
                    stack.append(w)
                elif colors[w] == colors[v]:
                    bipartite = False
                    break
        if not bipartite:
            break
    if bipartite:
        return colors
    colors[:] = -1
    order = np.argsort(-np.array([len(a) for a in adj]), kind="stable")
    for v in order:
        used = {colors[w] for w in adj[v] if colors[w] >= 0}
        c = 0
        while c in used:
            c += 1
        colors[v] = c
    return colors


def _strong_color_edges_python(nvars: int, ea: np.ndarray, eb: np.ndarray) -> np.ndarray:
    """Greedy STRONG (distance-2) edge coloring in edge order: two edges get
    distinct colors if they share a vertex or are joined by a bond. Within a
    class, flipping one edge's endpoint pair leaves every other same-class
    pair's local field unchanged, so simultaneous pair flips are a product of
    independent reversible kernels; a merely proper edge coloring biases the
    sampled distribution."""
    incident = _incident_lists(nvars, ea, eb)
    adj = _adjacency_lists(nvars, ea, eb)
    colors = np.full(len(ea), -1, dtype=np.int32)
    for k, (a, b) in enumerate(zip(ea.tolist(), eb.tolist())):
        close = {a, b}
        close.update(adj[a])
        close.update(adj[b])
        used = set()
        for v in close:
            for e2 in incident[v]:
                if colors[e2] >= 0:
                    used.add(int(colors[e2]))
        c = 0
        while c in used:
            c += 1
        colors[k] = c
    return colors


def _color_edges_python(nvars: int, ea: np.ndarray, eb: np.ndarray) -> np.ndarray:
    """Greedy proper edge coloring in edge order (<= 2 max_deg - 1 classes)."""
    incident = _incident_lists(nvars, ea, eb)
    ecolors = np.full(len(ea), -1, dtype=np.int32)
    for k, (a, b) in enumerate(zip(ea.tolist(), eb.tolist())):
        used = set()
        for v in (a, b):
            for e2 in incident[v]:
                if ecolors[e2] >= 0:
                    used.add(int(ecolors[e2]))
        c = 0
        while c in used:
            c += 1
        ecolors[k] = c
    return ecolors


def _classes(colors: np.ndarray) -> Tuple[np.ndarray, ...]:
    return tuple(np.nonzero(colors == k)[0].astype(np.int32) for k in range(int(colors.max()) + 1))


def _native():
    """The native passes (``_native_graph``) where a C++ compiler is on
    ``PATH``, else None: then the python passes run."""
    return _native_graph if _native_graph.available() else None


class CompiledGraph:
    """The compiled form of an edge list: the edge arrays ``nvars``,
    ``edge_a``, ``edge_b``, ``edge_j`` at once; the ELL adjacency and the
    three colorings (sites, edges, strong edges) on first access."""

    def __init__(self, nvars: int, edge_a: np.ndarray, edge_b: np.ndarray, edge_j: np.ndarray):
        self.nvars = int(nvars)
        self.edge_a = np.asarray(edge_a, np.int32)
        self.edge_b = np.asarray(edge_b, np.int32)
        self.edge_j = np.asarray(edge_j, np.float64)
        self.nedges = len(self.edge_a)
        self._ell = None
        self._colors: Optional[np.ndarray] = None
        self._ecolors: Optional[np.ndarray] = None
        self._strong_ecolors: Optional[np.ndarray] = None

    def _ensure_ell(self):
        if self._ell is None:
            ng = _native()
            self._ell = (ng.build_ell if ng else _build_ell_numpy)(self.nvars, self.edge_a, self.edge_b, self.edge_j)
        return self._ell

    @property
    def neighbors(self) -> np.ndarray:
        """``[nvars, max_deg]`` int32 neighbor ids (0 on padding slots)."""
        return self._ensure_ell()[0]

    @property
    def jmat(self) -> np.ndarray:
        """``[nvars, max_deg]`` f64 couplings (0 on padding slots)."""
        return self._ensure_ell()[1]

    @property
    def degree(self) -> np.ndarray:
        return self._ensure_ell()[2]

    @property
    def max_deg(self) -> int:
        return self._ensure_ell()[3]

    @property
    def edge_slot_a(self) -> np.ndarray:
        """ELL slot of edge e in the row of its ``a`` endpoint."""
        return self._ensure_ell()[4]

    @property
    def edge_slot_b(self) -> np.ndarray:
        return self._ensure_ell()[5]

    @property
    def colors(self) -> np.ndarray:
        if self._colors is None:
            ng = _native()
            self._colors = (ng.color_sites if ng else _color_sites_python)(self.nvars, self.edge_a, self.edge_b)
        return self._colors

    @property
    def ncolors(self) -> int:
        return int(self.colors.max()) + 1

    @property
    def color_sites(self) -> Tuple[np.ndarray, ...]:
        return _classes(self.colors)

    @property
    def edge_colors(self) -> np.ndarray:
        if self._ecolors is None:
            ng = _native()
            self._ecolors = (ng.color_edges if ng else _color_edges_python)(self.nvars, self.edge_a, self.edge_b)
        return self._ecolors

    @property
    def necolors(self) -> int:
        return int(self.edge_colors.max()) + 1

    @property
    def ecolor_edges(self) -> Tuple[np.ndarray, ...]:
        return _classes(self.edge_colors)

    @property
    def strong_edge_colors(self) -> np.ndarray:
        """The strong (distance-2) edge coloring, the one the parallel
        pair-flip moves use."""
        if self._strong_ecolors is None:
            ng = _native()
            color = ng.strong_color_edges if ng else _strong_color_edges_python
            self._strong_ecolors = color(self.nvars, self.edge_a, self.edge_b)
        return self._strong_ecolors

    @property
    def strong_ecolor_edges(self) -> Tuple[np.ndarray, ...]:
        return _classes(self.strong_edge_colors)

    def validate(self) -> None:
        """Raise ``AssertionError`` unless the site coloring is proper, the
        edge coloring is proper and no two edges of a strong class share a
        vertex or are joined by a bond."""
        if np.any(self.colors[self.edge_a] == self.colors[self.edge_b]):
            raise AssertionError("site coloring is not proper")
        for eids in self.ecolor_edges:
            verts = np.concatenate([self.edge_a[eids], self.edge_b[eids]])
            if len(np.unique(verts)) != len(verts):
                raise AssertionError("edge coloring is not proper")
        adj = {(int(a), int(b)) for a, b in zip(self.edge_a, self.edge_b)}
        adj |= {(b, a) for a, b in adj}
        for eids in self.strong_ecolor_edges:
            verts = np.concatenate([self.edge_a[eids], self.edge_b[eids]])
            if len(np.unique(verts)) != len(verts):
                raise AssertionError("strong edge class shares a vertex")
            pts = list(zip(self.edge_a[eids].tolist(), self.edge_b[eids].tolist()))
            for i in range(len(pts)):
                for k in range(i + 1, len(pts)):
                    if any((x, y) in adj for x in pts[i] for y in pts[k]):
                        raise AssertionError("strong edge class joined by a bond")


def compile_graph(edges: Sequence) -> CompiledGraph:
    """``parse_edges`` into a ``CompiledGraph``; with ``PMC_DEBUG_VALIDATE``
    set, the colorings are built and checked at once."""
    cg = CompiledGraph(*parse_edges(edges))
    if os.environ.get("PMC_DEBUG_VALIDATE"):
        cg.validate()
    return cg


def compile_graph_arrays(nvars: int, ea: np.ndarray, eb: np.ndarray, ej: np.ndarray) -> CompiledGraph:
    return CompiledGraph(nvars, ea, eb, ej)


def grid_2d_edges(lx: int, ly: int, j: float = -1.0, periodic: bool = True):
    """Square-lattice edge list (vertex id = x * ly + y)."""
    edges = []
    for x in range(lx):
        for y in range(ly):
            v = x * ly + y
            if periodic or x + 1 < lx:
                edges.append(((v, ((x + 1) % lx) * ly + y), j))
            if periodic or y + 1 < ly:
                edges.append(((v, x * ly + (y + 1) % ly), j))
    return edges


def detect_square_torus(cg: CompiledGraph):
    """``(L, J)`` when the graph is exactly an L x L periodic square lattice
    (L even, L >= 4) with uniform coupling J, else None."""
    n = cg.nvars
    L = int(round(np.sqrt(n)))
    if L * L != n or L < 4 or L % 2 != 0:
        return None
    if cg.nedges != 2 * n:
        return None
    j0 = cg.edge_j[0]
    if not np.all(cg.edge_j == j0):
        return None
    a = cg.edge_a.astype(np.int64)
    b = cg.edge_b.astype(np.int64)
    have = np.sort(np.minimum(a, b) * n + np.maximum(a, b))
    x = np.arange(n, dtype=np.int64) // L
    y = np.arange(n, dtype=np.int64) % L
    right = ((x + 1) % L) * L + y
    down = x * L + (y + 1) % L
    v = np.arange(n, dtype=np.int64)
    want = np.sort(
        np.concatenate(
            [np.minimum(v, right) * n + np.maximum(v, right),
             np.minimum(v, down) * n + np.maximum(v, down)]
        )
    )
    if not np.array_equal(have, want):
        return None
    return L, float(j0)


def detect_dense(cg: CompiledGraph):
    """``("torus", L, J)`` for a uniform even square torus, ``("ring", n, J)``
    for a uniform even periodic chain (n >= 4), else None: the lattices the
    worldline kernel runs on (the JAX package's ``worldline.detect_dense``)."""
    tor = detect_square_torus(cg)
    if tor is not None:
        return ("torus", tor[0], tor[1])
    n = cg.nvars
    if n < 4 or n % 2 or cg.nedges != n:
        return None
    j0 = cg.edge_j[0]
    if not np.all(cg.edge_j == j0):
        return None
    a = np.minimum(cg.edge_a, cg.edge_b).astype(np.int64)
    b = np.maximum(cg.edge_a, cg.edge_b).astype(np.int64)
    v = np.arange(n, dtype=np.int64)
    w = (v + 1) % n
    want = np.unique(np.minimum(v, w) * n + np.maximum(v, w))
    have = np.unique(a * n + b)
    return ("ring", n, float(j0)) if np.array_equal(have, want) else None


def detect_topology(nvars: int, edge_a, edge_b):
    """``("ring", nvars)`` or ``("torus", side)`` from the edge structure alone,
    whatever the couplings (the tempering ladder's kernel takes quenched
    disorder), else None: a ring of n >= 4 sites, n even, or a side x side
    periodic square lattice, side >= 2 and even (vertex x * side + y). The JAX
    package's ``wl_ladder_pallas.detect_topology``."""
    n = int(nvars)
    a = np.asarray(edge_a, np.int64)
    b = np.asarray(edge_b, np.int64)
    have = np.unique(np.minimum(a, b) * n + np.maximum(a, b))

    def same(u, v):
        return np.array_equal(have, np.unique(np.minimum(u, v) * n + np.maximum(u, v)))

    v = np.arange(n, dtype=np.int64)
    if n >= 4 and n % 2 == 0 and same(v, (v + 1) % n):
        return ("ring", n)
    side = int(round(np.sqrt(n)))
    if side * side == n and side >= 2 and side % 2 == 0:
        x, y = v // side, v % side
        nb = np.concatenate([x * side + (y + 1) % side, ((x + 1) % side) * side + y])
        if same(np.concatenate([v, v]), nb):
            return ("torus", side)
    return None
