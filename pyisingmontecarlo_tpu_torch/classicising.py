"""``ClassicIsing`` — a persistent ensemble of classical Ising simulators, on torch.

Counterpart of ``pyisingmontecarlo_tpu/classicising.py``: the same
constructor, methods and return types. Unlike ``Lattice`` it keeps its state
between calls: spins ``[R, nvars]`` int8 on the run's device and each graph's
threefry key data ``[R, 2]`` (uint32, on the host). The per-move knobs
(``nspinupdates``, ``nedgeupdates``, ``nwormupdates``) become sweep and worm
counts of the graph engine (``engines/classical.py``), as in the JAX package.

On the uniform periodic square lattice, runs whose edge and worm counts are
left at their defaults (or zero) and without cluster updates take the torus
kernel of ``ops/sq2d.py``, as the JAX package's Pallas route does: each
graph's kernel seed comes from its key, and after a call of T sweeps its key
becomes ``fold_in(key, T)``, so successive calls never reuse a draw.

The device is explicit: ``device="cuda"`` (the default) raises where there is
no CUDA; ``device="cpu"`` runs the plain versions.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from ._kernels import resolve_device
from .engines import classical as ce
from .graph import compile_graph, detect_square_torus
from .ops import lattice2d as l2d
from .rng import MasterRng, fold_all, key_data_from_seeds, key_data_of, key_tensor, seeds_from_key_data

__all__ = ["ClassicIsing"]


class ClassicIsing:
    """Persistent ensemble of classical Ising simulators on one shared graph.

    ``ClassicIsing(edges, longitudinal=0.0, num_experiments=1, seed=None,
    use_basic_moves=False, *, device="cuda")``; the ``num_experiments``
    initial graphs start from random states seeded from the container's
    master stream."""

    def __init__(
        self,
        edges: Sequence,
        longitudinal: float = 0.0,
        num_experiments: int = 1,
        seed: Optional[int] = None,
        use_basic_moves: bool = False,
        *,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.edges = [((int(a), int(b)), float(j)) for (a, b), j in edges]
        self.cg = compile_graph(self.edges)
        self.nvars = self.cg.nvars
        self.longitudinal = float(longitudinal)
        self.rng = MasterRng(seed)
        self.use_basic_moves = bool(use_basic_moves)
        self.enable_cluster = False
        self._ga = None  # built at first use (torus runs may never need colorings)
        self._torus = detect_square_torus(self.cg)
        self._bias = torch.full((self.nvars,), self.longitudinal, dtype=torch.float32, device=self.device)
        self._spins = torch.zeros((0, self.nvars), dtype=torch.int8, device=self.device)
        self._keys = np.zeros((0, 2), np.uint32)
        self._imp_flags = []  # per-graph edge_move_importance_sampling
        for _ in range(int(num_experiments)):
            self.add_graph()

    # ------------------------------------------------------------------ state

    @property
    def num_graphs(self) -> int:
        return int(self._spins.shape[0])

    def add_graph(
        self,
        initial_state: Optional[Sequence[bool]] = None,
        edge_move_importance_sampling: Optional[bool] = None,
    ) -> None:
        """Append one graph, seeded from the container's master stream.
        ``edge_move_importance_sampling`` weighs this graph's edge-move
        attempts by |J_e| (``engines/classical._edge_color_update``)."""
        self._imp_flags.append(bool(edge_move_importance_sampling))
        key = key_data_from_seeds(self.rng.make_seeds(1))
        if initial_state is not None:
            state = list(initial_state)
            if len(state) != self.nvars:
                raise ValueError(f"Initial state must have length {self.nvars}, got {len(state)}")
            s = torch.from_numpy(np.where(np.array(state, bool), 1, -1).astype(np.int8))[None].to(self.device)
        else:
            s = ce.random_states(key, self.nvars, self.device)
        self._spins = torch.cat([self._spins, s])
        self._keys = np.concatenate([self._keys, key])

    def set_enable_cluster_updates(self, enable: bool) -> None:
        """Include one Swendsen-Wang cluster update per time step."""
        self.enable_cluster = bool(enable)

    def get_states(self) -> np.ndarray:
        """Current spin configurations as bool[ngraphs, nvars]."""
        return (self._spins == 1).cpu().numpy()

    def get_energies(self) -> np.ndarray:
        return ce.energy(self._graph_arrays(), self._bias, self._spins).cpu().numpy().astype(np.float64)

    # ------------------------------------------------------------------- runs

    def _graph_arrays(self):
        if self._ga is None:
            self._ga = ce.device_graph_sorted(self.cg, device=self.device)
        return self._ga

    def _fast2d(self, margs) -> bool:
        """The torus kernel takes a uniform periodic square lattice when the
        edge and worm counts are defaulted (or zero) and no clusters run: on
        an unfrustrated uniform torus the extra families do not change the
        stationary distribution. Pops ``extras_defaulted`` from ``margs``."""
        defaulted = margs.pop("extras_defaulted")
        return (
            self._torus is not None
            and (defaulted or (margs["nedge_sweeps"] == 0 and margs["nworms"] == 0))
            and margs["nclusters"] == 0
        )

    def _move_args(self, nspin, nedge, nworm, only_basic):
        only = self.use_basic_moves if only_basic is None else bool(only_basic)
        nspin_sweeps = 1 if nspin is None else max(1, math.ceil(int(nspin) / max(self.nvars, 1)))
        nedge_sweeps = 1 if nedge is None else max(0, math.ceil(int(nedge) / max(self.cg.nedges, 1)))
        nworms = 1 if nworm is None else int(nworm)
        if only:
            nedge_sweeps, nworms = 0, 0
        return dict(
            nspin_sweeps=nspin_sweeps,
            nedge_sweeps=nedge_sweeps,
            nworms=nworms,
            only_basic=only,
            heatbath=False,
            wlen=min(self.nvars, ce.DEFAULT_WLEN),
            nclusters=1 if (self.enable_cluster and not only) else 0,
            extras_defaulted=nedge is None and nworm is None,
            iw=self._iw() if not only else None,
        )

    def _iw(self):
        """Per-class ``[R, Ec]`` edge attempt probabilities, or None when no
        graph asks for importance sampling: flagged rows get |J_e| / max |J|
        weights, the others 1 (the plain sweep)."""
        if not any(self._imp_flags):
            return None
        mask = torch.tensor(self._imp_flags, dtype=torch.bool, device=self.device)
        return tuple(torch.where(mask[:, None], w[None], 1.0)
                     for w in ce.importance_weights(self.cg, self.device))

    def _run_torus(self, nsweeps: int, beta: float):
        """``nsweeps`` torus-kernel sweeps of every graph; keys folded with ``nsweeps``."""
        L, J = self._torus
        seeds = torch.from_numpy(seeds_from_key_data(self._keys)).to(self.device)
        s = l2d.run_steps_2d(self._spins.reshape(-1, L, L), seeds, np.full(nsweeps, beta, np.float32), J,
                             self.longitudinal)
        self._spins = s.reshape(-1, self.nvars)
        self._keys = fold_all(self._keys, nsweeps)

    def run_monte_carlo(
        self,
        beta: float,
        timesteps: int,
        nspinupdates: Optional[int] = None,
        nedgeupdates: Optional[int] = None,
        nwormupdates: Optional[int] = None,
        only_basic_moves: Optional[bool] = None,
    ) -> None:
        """Advance the ensemble in place; returns None."""
        margs = self._move_args(nspinupdates, nedgeupdates, nwormupdates, only_basic_moves)
        if self._fast2d(margs):
            self._run_torus(int(timesteps) * margs["nspin_sweeps"], beta)
            return
        s, keys = ce.run_steps_chunked(self._graph_arrays(), self._bias, self._spins,
                                       key_tensor(self._keys, self.device),
                                       np.full(int(timesteps), beta, np.float32), **margs)
        self._spins, self._keys = s, key_data_of(keys)

    def run_monte_carlo_sampling(
        self,
        beta: float,
        timesteps: int,
        nspinupdates: Optional[int] = None,
        nedgeupdates: Optional[int] = None,
        nwormupdates: Optional[int] = None,
        only_basic_moves: Optional[bool] = None,
        thermalization_time: Optional[int] = None,
        sampling_freq: Optional[int] = None,
    ):
        """-> (energies[n, t/freq] f64, states[n, t/freq, nvars] bool)."""
        margs = self._move_args(nspinupdates, nedgeupdates, nwormupdates, only_basic_moves)
        therm = int(thermalization_time or 0)
        freq = int(sampling_freq) if sampling_freq else 1
        if self._fast2d(margs):
            L, J = self._torus
            k = margs["nspin_sweeps"]
            if therm:
                self._run_torus(therm * k, beta)
            T = int(timesteps) * k
            seeds = torch.from_numpy(seeds_from_key_data(self._keys)).to(self.device)
            s, es, ss = l2d.run_sampling_2d(self._spins.reshape(-1, L, L), seeds, float(beta), J,
                                            self.longitudinal, T, freq * k)
            self._spins = s.reshape(-1, self.nvars)
            if T:
                self._keys = fold_all(self._keys, T)
            return es.cpu().numpy().astype(np.float64), (ss.reshape(*ss.shape[:2], self.nvars) == 1).cpu().numpy()
        ga = self._graph_arrays()
        keys = key_tensor(self._keys, self.device)
        if therm:
            self._spins, keys = ce.run_steps_chunked(ga, self._bias, self._spins, keys,
                                                     np.full(therm, beta, np.float32), **margs)
        self._spins, keys, es, ss = ce.run_sampling(ga, self._bias, self._spins, keys, float(np.float32(beta)),
                                                    int(timesteps), freq, **margs)
        self._keys = key_data_of(keys)
        return es.cpu().numpy().astype(np.float64), (ss == 1).cpu().numpy()
