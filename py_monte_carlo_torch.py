"""Drop-in module for the reference's extension module name, on the PyTorch port.

The twin of ``py_monte_carlo.py``: the same five classes under the same
names, from ``pyisingmontecarlo_tpu_torch``. Scripts written against the
reference switch by importing ``py_monte_carlo_torch as py_monte_carlo``. The
classes run on the card (``device="cuda"``, the default) unless given
``device="cpu"``.
"""

from pyisingmontecarlo_tpu_torch import (  # noqa: F401
    ClassicIsing,
    Lattice,
    LatticeTempering,
    QmcIsing,
    QmcRunner,
)

__all__ = ["Lattice", "ClassicIsing", "QmcIsing", "QmcRunner", "LatticeTempering"]
