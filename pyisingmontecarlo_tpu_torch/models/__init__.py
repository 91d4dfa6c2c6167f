"""Standard model families: the edge lists of common lattices and
disorder ensembles (square ferromagnet, frustrated triangular AFM, +-J and
Gaussian spin glasses, chains), as in the JAX package's ``models``."""

from .lattices import (
    chain_edges,
    cubic_edges,
    gaussian_spin_glass_edges,
    pm_j_spin_glass_edges,
    square_edges,
    triangular_edges,
)

__all__ = [
    "chain_edges",
    "square_edges",
    "triangular_edges",
    "cubic_edges",
    "pm_j_spin_glass_edges",
    "gaussian_spin_glass_edges",
]
