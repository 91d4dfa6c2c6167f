"""The inputs the benchmark makes from a seed, in NumPy: the torus's edges,
a +-J glass's couplings and a tempering ladder's betas. Both the program and
the reference are handed these same arrays."""

from __future__ import annotations

import numpy as np

__all__ = ["torus_edges", "pm_j", "beta_ladder", "edge_list"]


def torus_edges(side: int):
    """``(a, b)`` int64 of a periodic side x side square lattice, site
    ``x * side + y``, in the order x, then y, then the bond to (x + 1, y)
    before the bond to (x, y + 1)."""
    v = np.arange(side * side, dtype=np.int64)
    x, y = v // side, v % side
    a = np.repeat(v, 2)
    b = np.stack([((x + 1) % side) * side + y, x * side + (y + 1) % side], 1).reshape(-1)
    return a, b


def pm_j(seed: int, nedges: int) -> np.ndarray:
    """Couplings +-1, each sign with probability 1/2, from ``seed``."""
    return np.where(np.random.default_rng(int(seed)).integers(0, 2, size=int(nedges)) == 1, 1.0, -1.0)


def beta_ladder(lo: float, hi: float, n: int) -> np.ndarray:
    """``n`` betas spaced evenly in log from ``lo`` to ``hi``."""
    return np.geomspace(float(lo), float(hi), int(n))


def edge_list(a, b, j):
    """``[((a, b), J), ...]`` as Python numbers, the form the entry points take."""
    return list(zip(zip(np.asarray(a).tolist(), np.asarray(b).tolist()), np.broadcast_to(j, len(a)).tolist()))
