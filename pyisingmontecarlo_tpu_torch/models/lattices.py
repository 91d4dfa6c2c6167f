"""Edge lists of standard lattice families.

A copy of ``pyisingmontecarlo_tpu/models/lattices.py`` (importing the JAX
package would import jax). Every function returns a ``[((a, b), J), ...]``
list, the edge format of every public class (positive J antiferromagnetic),
with vertices numbered row-major over the coordinate grid; the same arguments
give the same list as the JAX package's function.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

Edge = Tuple[Tuple[int, int], float]


def chain_edges(n: int, j: float = -1.0, periodic: bool = True) -> List[Edge]:
    """1D chain of n sites. A periodic 2-chain has a single bond (the wrap
    edge would duplicate it); n < 2 has no valid edges."""
    n = int(n)
    if n < 2:
        raise ValueError("chain_edges requires n >= 2")
    last = n if (periodic and n > 2) else n - 1
    return [((i, (i + 1) % n), float(j)) for i in range(last)]


def square_edges(lx: int, ly: Optional[int] = None, j: float = -1.0, periodic: bool = True) -> List[Edge]:
    """2D square lattice (vertex id = x * ly + y)."""
    from ..graph import grid_2d_edges

    return grid_2d_edges(lx, ly if ly is not None else lx, j=j, periodic=periodic)


def triangular_edges(lx: int, ly: Optional[int] = None, j: float = 1.0, periodic: bool = True) -> List[Edge]:
    """2D triangular lattice: square lattice + one diagonal per plaquette.
    With j > 0 (AFM) this is the canonical frustrated model."""
    ly = ly if ly is not None else lx
    edges = []
    for x in range(lx):
        for y in range(ly):
            v = x * ly + y
            nbrs = []
            if periodic or x + 1 < lx:
                nbrs.append(((x + 1) % lx) * ly + y)
            if periodic or y + 1 < ly:
                nbrs.append(x * ly + (y + 1) % ly)
            if (periodic or (x + 1 < lx and y + 1 < ly)):
                nbrs.append(((x + 1) % lx) * ly + (y + 1) % ly)
            for w in nbrs:
                edges.append(((v, w), float(j)))
    return edges


def cubic_edges(lx: int, ly: Optional[int] = None, lz: Optional[int] = None,
                j: float = -1.0, periodic: bool = True) -> List[Edge]:
    """3D cubic lattice (vertex id = (x * ly + y) * lz + z)."""
    ly = ly if ly is not None else lx
    lz = lz if lz is not None else lx
    edges = []
    for x in range(lx):
        for y in range(ly):
            for z in range(lz):
                v = (x * ly + y) * lz + z
                if periodic or x + 1 < lx:
                    edges.append(((v, (((x + 1) % lx) * ly + y) * lz + z), float(j)))
                if periodic or y + 1 < ly:
                    edges.append(((v, (x * ly + (y + 1) % ly) * lz + z), float(j)))
                if periodic or z + 1 < lz:
                    edges.append(((v, (x * ly + y) * lz + (z + 1) % lz), float(j)))
    return edges


def pm_j_spin_glass_edges(lx: int, ly: Optional[int] = None, seed: int = 0,
                          periodic: bool = True) -> List[Edge]:
    """2D Edwards-Anderson +-J spin glass: square-lattice topology with iid
    random couplings J in {-1, +1} (numpy ``default_rng(seed)``)."""
    base = square_edges(lx, ly, j=1.0, periodic=periodic)
    rng = np.random.default_rng(seed)
    signs = rng.choice([-1.0, 1.0], size=len(base))
    return [((a, b), float(s)) for ((a, b), _), s in zip(base, signs)]


def gaussian_spin_glass_edges(lx: int, ly: Optional[int] = None, seed: int = 0,
                              sigma: float = 1.0, periodic: bool = True) -> List[Edge]:
    """2D Edwards-Anderson Gaussian spin glass: J ~ N(0, sigma^2)."""
    base = square_edges(lx, ly, j=1.0, periodic=periodic)
    rng = np.random.default_rng(seed)
    js = rng.normal(0.0, sigma, size=len(base))
    return [((a, b), float(v)) for ((a, b), _), v in zip(base, js)]
