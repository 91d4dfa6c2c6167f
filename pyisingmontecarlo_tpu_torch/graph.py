"""Edge lists -> compiled graph arrays, and the ring and torus detectors.

Counterpart of ``pyisingmontecarlo_tpu/graph.py``, carried over (numpy only)
rather than imported, because importing any module of the JAX package imports
jax. The ported paths need only the edge arrays: colorings, ELL adjacency and the
native graph library serve the arbitrary-graph engines, which are not ported
yet (ROADMAP.md, modules to port, item 4).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

__all__ = [
    "CompiledGraph",
    "parse_edges",
    "compile_graph",
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


class CompiledGraph:
    """The edge arrays of a graph: ``nvars``, ``edge_a``, ``edge_b``, ``edge_j``."""

    def __init__(self, nvars: int, edge_a: np.ndarray, edge_b: np.ndarray, edge_j: np.ndarray):
        self.nvars = int(nvars)
        self.edge_a = np.asarray(edge_a, np.int32)
        self.edge_b = np.asarray(edge_b, np.int32)
        self.edge_j = np.asarray(edge_j, np.float64)
        self.nedges = len(self.edge_a)


def compile_graph(edges: Sequence) -> CompiledGraph:
    return CompiledGraph(*parse_edges(edges))


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
