"""``Lattice`` — the stateless launcher class, on torch.

Counterpart of ``pyisingmontecarlo_tpu/lattice.py``: the same constructor,
setters and classical methods, returning the same numpy types. Ported so far is
the uniform periodic square lattice with a global bias (the JAX package's
``_fast2d`` dispatch): every classical method runs there on the sweep kernel of
``ops/sq2d.py``. Every other branch raises ``NotImplementedError`` naming its
item of ROADMAP.md.

The device is explicit: ``device="cuda"`` (the default) runs the kernel and
raises where there is no CUDA; ``device="cpu"`` runs the kernel's plain version.
"""

from __future__ import annotations

import copy
from typing import Optional, Sequence

import numpy as np
import torch

from .graph import compile_graph, detect_square_torus
from .ops import lattice2d as l2d
from .rng import MasterRng, replica_seeds_i32

__all__ = ["Lattice"]

_CLASSICAL_ITEM = "ROADMAP.md, modules to port, item 4 (engines/classical.py)"
_QUANTUM_ITEM = "ROADMAP.md, modules to port, item 5 (engines/worldline.py)"


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to torch yet: {item}")


def _resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' but torch.cuda.is_available() is False; pass device='cpu' "
            "to run the kernels' plain versions"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {dev}")
    return dev


class Lattice:
    """Stateless Monte Carlo launcher over an edge-list Ising graph.

    ``Lattice(edges, seed_gen=None, use_allocator=True, *, dtau=None,
    device="cuda")``; ``use_allocator`` and ``dtau`` are kept for the JAX
    package's signature and are not used by the classical torus path."""

    def __init__(
        self,
        edges: Sequence,
        seed_gen: Optional[int] = None,
        use_allocator: bool = True,
        *,
        dtau: Optional[float] = None,
        device="cuda",
    ):
        self.device = _resolve_device(device)
        self.edges = [((int(a), int(b)), float(j)) for (a, b), j in edges]
        self.cg = compile_graph(self.edges)
        self.nvars = self.cg.nvars
        self.rng = MasterRng(seed_gen)
        self.use_allocator = bool(use_allocator)
        self.dtau = dtau
        # ("global", x) or ("individual", np.ndarray)
        self.bias = ("global", 0.0)
        self.transverse: Optional[float] = None
        self.initial_state: Optional[np.ndarray] = None
        self.enable_rvb = False
        self.enable_heatbath = False
        self.enable_cluster = False
        # (L, J) for a uniform-J periodic square lattice, else None
        self._torus = detect_square_torus(self.cg)

    # ------------------------------------------------------------------ config

    def set_seed_gen(self, seed_gen: Optional[int] = None) -> None:
        self.rng.reset(seed_gen)

    def make_seeds(self, num_experiments: int):
        """One u64 per experiment, advancing the master stream."""
        return [int(x) for x in self.rng.make_seeds(num_experiments)]

    def set_enable_rvb_update(self, enable: bool) -> None:
        self.enable_rvb = bool(enable)

    def set_enable_heatbath_update(self, enable: bool) -> None:
        self.enable_heatbath = bool(enable)

    def set_enable_cluster_updates(self, enable: bool) -> None:
        self.enable_cluster = bool(enable)

    def set_individual_bias(self, var: int, bias: float) -> None:
        """Promotes the global bias to a per-variable vector; OOB ValueError."""
        var = int(var)
        if var < 0 or var >= self.nvars:
            raise ValueError(f"Variable {var} out of bounds (nvars={self.nvars})")
        if self.bias[0] == "global":
            vec = np.full(self.nvars, float(self.bias[1]), dtype=np.float64)
        else:
            vec = np.array(self.bias[1], dtype=np.float64, copy=True)
        vec[var] = float(bias)
        self.bias = ("individual", vec)

    def set_global_bias(self, bias: float) -> None:
        self.bias = ("global", float(bias))

    def set_transverse_field(self, gamma: float) -> None:
        """gamma > 0 sets, gamma == 0 clears, gamma < 0 ValueError."""
        gamma = float(gamma)
        if gamma > 0:
            self.transverse = gamma
        elif gamma == 0:
            self.transverse = None
        else:
            raise ValueError("Transverse field must be non-negative")

    def set_initial_state(self, state: Sequence[bool]) -> None:
        """Length must be nvars or 0 (0 clears)."""
        state = list(state)
        if len(state) == 0:
            self.initial_state = None
        elif len(state) == self.nvars:
            self.initial_state = np.array(state, dtype=bool)
        else:
            raise ValueError(
                f"Initial state must have length 0 or {self.nvars}, got {len(state)}"
            )

    def clone(self) -> "Lattice":
        other = copy.copy(self)
        other.edges = list(self.edges)
        other.rng = self.rng.clone()
        other.bias = copy.deepcopy(self.bias)
        other.initial_state = None if self.initial_state is None else self.initial_state.copy()
        return other

    # ------------------------------------------------------------- internals

    def _fast2d(self) -> bool:
        """The uniform square torus with a global bias and single-spin updates:
        the only classical path ported so far."""
        return (
            self._torus is not None
            and self.bias[0] == "global"
            and not self.enable_heatbath
            and not self.enable_cluster
        )

    def _torus_args(self, num_experiments: int):
        """Fresh per-experiment seeds and initial states, and (J, h)."""
        self._check_classical()
        if not self._fast2d():
            raise _not_ported(
                "Classical runs other than single-spin updates on a uniform periodic "
                "square lattice with a global bias", _CLASSICAL_ITEM,
            )
        L, J = self._torus
        n = int(num_experiments)
        seeds = torch.from_numpy(replica_seeds_i32(self.rng.make_seeds(n))).to(self.device)
        if self.initial_state is not None:
            s0 = torch.from_numpy(np.where(self.initial_state, 1, -1).astype(np.int8))
            s0 = s0.reshape(1, L, L).to(self.device).expand(n, L, L).contiguous()
        else:
            s0 = l2d.random_states_2d(seeds, L)
        return s0, seeds, J, float(self.bias[1])

    def _check_classical(self):
        """Classical runs reject a set transverse field."""
        if self.transverse is not None:
            raise ValueError("Cannot run classic monte carlo with transverse field set")

    def _anneal_schedule(self, betas, timesteps: int) -> np.ndarray:
        """Piecewise-linear beta(t): schedule sorted, padded to t=0 and t=T,
        linear in between; empty schedule -> constant beta=1.0."""
        pts = sorted((int(t), float(b)) for t, b in betas)
        if not pts:
            return np.full(timesteps, 1.0)
        ts = np.array([p[0] for p in pts], dtype=np.float64)
        bs = np.array([p[1] for p in pts], dtype=np.float64)
        return np.interp(np.arange(timesteps, dtype=np.float64), ts, bs)

    def _states(self, s: torch.Tensor, *lead) -> np.ndarray:
        return (s.reshape(*lead, self.nvars) == 1).cpu().numpy()

    # -------------------------------------------------------- classical runs

    def run_monte_carlo(
        self,
        beta: float,
        timesteps: int,
        num_experiments: int,
        only_basic_moves: Optional[bool] = None,
        edge_move_importance_sampling: Optional[bool] = None,
    ):
        """-> (energies[n] f64, states[n, nvars] bool). The move flags are
        no-ops on the torus (single-spin updates, uniform weights)."""
        s0, seeds, J, h = self._torus_args(num_experiments)
        s = l2d.run_steps_2d(s0, seeds, np.full(int(timesteps), beta, np.float32), J, h)
        es = l2d.energy_2d(s, J, h)
        return es.cpu().numpy().astype(np.float64), self._states(s, s.shape[0])

    def run_monte_carlo_sampling(
        self,
        beta: float,
        timesteps: int,
        num_experiments: int,
        only_basic_moves: Optional[bool] = None,
        thermalization_time: Optional[int] = None,
        sampling_freq: Optional[int] = None,
        edge_move_importance_sampling: Optional[bool] = None,
    ):
        """-> (energies[n, t/freq] f64, states[n, t/freq, nvars] bool)."""
        s0, seeds, J, h = self._torus_args(num_experiments)
        therm = int(thermalization_time or 0)
        freq = int(sampling_freq) if sampling_freq else 1
        if therm:
            s0 = l2d.run_steps_2d(s0, seeds, np.full(therm, beta, np.float32), J, h)
        # the sampling sweeps continue the thermalization's counter stream
        _, es, ss = l2d.run_sampling_2d(s0, seeds, float(beta), J, h, int(timesteps), freq, ctr0=therm)
        return es.cpu().numpy().astype(np.float64), self._states(ss, *ss.shape[:2])

    def run_monte_carlo_annealing(
        self,
        betas: Sequence,
        timesteps: int,
        num_experiments: int,
        only_basic_moves: Optional[bool] = None,
        edge_move_importance_sampling: Optional[bool] = None,
    ):
        """-> (energies[n] f64, states[n, nvars] bool)."""
        s0, seeds, J, h = self._torus_args(num_experiments)
        beta_arr = self._anneal_schedule(betas, int(timesteps)).astype(np.float32)
        s = l2d.run_steps_2d(s0, seeds, beta_arr, J, h)
        es = l2d.energy_2d(s, J, h)
        return es.cpu().numpy().astype(np.float64), self._states(s, s.shape[0])

    def run_monte_carlo_annealing_and_get_energies(
        self,
        betas: Sequence,
        timesteps: int,
        num_experiments: int,
        only_basic_moves: Optional[bool] = None,
        edge_move_importance_sampling: Optional[bool] = None,
    ):
        """-> (energies[n, timesteps] f64, states[n, nvars] bool)."""
        s0, seeds, J, h = self._torus_args(num_experiments)
        beta_arr = self._anneal_schedule(betas, int(timesteps)).astype(np.float32)
        s, es = l2d.run_steps_2d(s0, seeds, beta_arr, J, h, collect_energies=True)
        return es.cpu().numpy().astype(np.float64), self._states(s, s.shape[0])


def _quantum_stub(name: str):
    def method(self, *args, **kwargs):
        raise _not_ported(f"Lattice.{name}", _QUANTUM_ITEM)

    method.__name__ = name
    method.__doc__ = f"Not ported yet: {_QUANTUM_ITEM}."
    return method


for _name in (
    "run_quantum_monte_carlo",
    "run_quantum_monte_carlo_sampling",
    "run_quantum_monte_carlo_and_measure_variable_autocorrelation",
    "run_quantum_monte_carlo_and_measure_spin_product_autocorrelation",
    "run_quantum_monte_carlo_and_measure_bond_autocorrelation",
    "run_quantum_monte_carlo_and_measure_spins",
    "get_offset",
    "average_on_and_off_diagonal_and_consts",
):
    setattr(Lattice, _name, _quantum_stub(_name))
del _name
