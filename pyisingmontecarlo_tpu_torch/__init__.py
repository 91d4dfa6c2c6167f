"""PyTorch and CUDA port of the Ising Monte Carlo framework.

The second package beside ``pyisingmontecarlo_tpu`` (the JAX reference): the
same names, on torch, with hand-written CUDA kernels for Hopper (``csrc/``).
It never imports jax. Ported so far: :class:`Lattice`'s classical methods
on any graph (the square-torus kernel of ``ops/sq2d.py``, else the graph
engine of ``engines/classical.py``) and its quantum (transverse-field)
methods on any graph (``engines/worldline.py``: the kernels of ``ops/wl.py``
on a uniform periodic ring or square torus, else the generic colored
worldline engine); :class:`ClassicIsing`; :class:`QmcIsing`;
:class:`LatticeTempering` on any ladder (``ops/ladder.py`` on ring and torus
ladders, else the generic engine); :class:`QmcRunner` over arbitrary k-local
interactions (``engines/generic.py`` and its group-major route
``engines/generic_gm.py``); the multi-device paths on ``torch.distributed``
(``parallel/``: replica-sharded ensembles, the sharded tempering ladder,
spatial and tau-sharded sweeps; ``entry.py``'s dry run and launcher).
"""

from .classicising import ClassicIsing
from .lattice import Lattice
from .qmcising import QmcIsing
from .qmcrunner import QmcRunner
from .tempering import LatticeTempering

__version__ = "0.1.0"

__all__ = ["Lattice", "ClassicIsing", "QmcIsing", "QmcRunner", "LatticeTempering"]
