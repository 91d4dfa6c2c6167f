"""PyTorch and CUDA port of the Ising Monte Carlo framework.

The second package beside ``pyisingmontecarlo_tpu`` (the JAX reference): the
same names, on torch, with hand-written CUDA kernels for Hopper (``csrc/``).
It never imports jax. Ported so far: :class:`Lattice`'s classical methods
on any graph (the square-torus kernel of ``ops/sq2d.py``, else the graph
engine of ``engines/classical.py``) and its quantum (transverse-field)
methods on a uniform periodic ring or square torus (``engines/worldline.py``
on ``ops/wl.py``); :class:`ClassicIsing`; :class:`LatticeTempering` on ring
and torus ladders (``ops/ladder.py``). The other public classes of the JAX
package are listed in ROADMAP.md as still to port.
"""

from .classicising import ClassicIsing
from .lattice import Lattice
from .tempering import LatticeTempering

__version__ = "0.1.0"

__all__ = ["Lattice", "ClassicIsing", "LatticeTempering"]

_NOT_PORTED = {
    "QmcIsing": "item 5",
    "QmcRunner": "item 7",
}


def __getattr__(name):
    if name in _NOT_PORTED:
        raise AttributeError(
            f"{name} is not ported to torch yet: ROADMAP.md, modules to port, {_NOT_PORTED[name]}"
        )
    raise AttributeError(name)
