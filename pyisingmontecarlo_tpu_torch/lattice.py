"""``Lattice`` — the stateless launcher class, on torch.

Counterpart of ``pyisingmontecarlo_tpu/lattice.py``: the same constructor,
setters and methods, returning the same numpy types. Ported:

- the four classical methods: on the uniform periodic square lattice with a
  global bias and single-spin updates (the JAX package's ``_fast2d``
  dispatch) on the sweep kernel of ``ops/sq2d.py``; on any other graph, or
  with individual biases, heat-bath or cluster updates, on the graph engine
  of ``engines/classical.py`` (bit for bit the JAX package's on the CPU,
  wherever couplings and biases are integer or dyadic);
- the quantum (transverse-field) methods on any graph, with or without the
  RVB move (``engines/worldline.py``): on the worldline kernel of
  ``ops/wl.py`` for a uniform periodic ring or square torus that its gate
  admits with RVB off, else on the generic colored worldline engine (bit for
  bit the JAX package's on the CPU, wherever couplings, fields and dtau are
  integer or dyadic).

The device is explicit: ``device="cuda"`` (the default) runs the kernel and
raises where there is no CUDA; ``device="cpu"`` runs the kernel's plain version.
"""

from __future__ import annotations

import copy
from typing import Optional, Sequence

import numpy as np
import torch

from ._kernels import resolve_device
from .engines import classical as ce
from .graph import compile_graph, detect_square_torus
from .ops import lattice2d as l2d
from .rng import MasterRng, key_data_from_seeds, key_tensor, replica_seeds_i32
from .utils.profiling import span

__all__ = ["Lattice"]


class Lattice:
    """Stateless Monte Carlo launcher over an edge-list Ising graph.

    ``Lattice(edges, seed_gen=None, use_allocator=True, *, dtau=None,
    device="cuda")``; ``use_allocator`` is kept for the JAX package's
    signature and is not used; ``dtau`` is the quantum methods' Trotter-step
    target (default 0.05, or the PMC_DTAU environment variable)."""

    def __init__(
        self,
        edges: Sequence,
        seed_gen: Optional[int] = None,
        use_allocator: bool = True,
        *,
        dtau: Optional[float] = None,
        device="cuda",
    ):
        self.device = resolve_device(device)
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
        self._ga = None  # the graph engine's tensors, built at first use
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
        """The uniform square torus with a global bias and single-spin
        updates, which runs the torus kernel; everything else runs the graph
        engine."""
        return (
            self._torus is not None
            and self.bias[0] == "global"
            and not self.enable_heatbath
            and not self.enable_cluster
        )

    def _torus_args(self, num_experiments: int):
        """Fresh per-experiment seeds and initial states, and (J, h)."""
        L, J = self._torus
        n = int(num_experiments)
        seeds = torch.from_numpy(replica_seeds_i32(self.rng.make_seeds(n))).to(self.device)
        if self.initial_state is not None:
            s0 = torch.from_numpy(np.where(self.initial_state, 1, -1).astype(np.int8))
            s0 = s0.reshape(1, L, L).to(self.device).expand(n, L, L).contiguous()
        else:
            s0 = l2d.random_states_2d(seeds, L)
        return s0, seeds, J, float(self.bias[1])

    def _graph_arrays(self):
        if self._ga is None:
            self._ga = ce.device_graph_sorted(self.cg, device=self.device)
        return self._ga

    def _bias_vector(self) -> np.ndarray:
        if self.bias[0] == "global":
            return np.full(self.nvars, float(self.bias[1]), dtype=np.float64)
        return np.asarray(self.bias[1], dtype=np.float64)

    def _classical_setup(self, num_experiments: int):
        """The graph engine's tensors, the f32 bias, and fresh per-experiment
        keys and initial states (``[R, nvars]`` int8)."""
        n = int(num_experiments)
        key_data = key_data_from_seeds(self.rng.make_seeds(n))
        if self.initial_state is not None:
            s0 = torch.from_numpy(np.where(self.initial_state, 1, -1).astype(np.int8))
            s0 = s0[None].to(self.device).expand(n, self.nvars).contiguous()
        else:
            s0 = ce.random_states(key_data, self.nvars, self.device)
        bias = torch.from_numpy(self._bias_vector().astype(np.float32)).to(self.device)
        return self._graph_arrays(), bias, s0, key_tensor(key_data, self.device)

    def _move_args(self, only_basic_moves, importance=None):
        only_basic = bool(only_basic_moves) if only_basic_moves is not None else False
        return dict(
            nspin_sweeps=1,
            nedge_sweeps=0 if only_basic else 1,
            nworms=0 if only_basic else 1,
            only_basic=only_basic,
            heatbath=self.enable_heatbath,
            wlen=min(self.nvars, ce.DEFAULT_WLEN),
            nclusters=1 if (self.enable_cluster and not only_basic) else 0,
            # importance-sampled edge attempts, probability |J_e| / max |J| (ce.importance_weights)
            iw=ce.importance_weights(self.cg, self.device) if (importance and not only_basic) else None,
        )

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
        with span("lattice.run_monte_carlo"):
            self._check_classical()
            beta_arr = np.full(int(timesteps), beta, np.float32)
            if self._fast2d():
                with span("lattice.setup"):
                    s0, seeds, J, h = self._torus_args(num_experiments)
                s = l2d.run_steps_2d(s0, seeds, beta_arr, J, h)
                # the energies' copy waits for the sweeps, outside the states' span
                es = l2d.energy_2d(s, J, h).cpu().numpy().astype(np.float64)
                with span("lattice.states"):
                    return es, self._states(s, s.shape[0])
            ga, bias, s0, keys = self._classical_setup(num_experiments)
            s, _ = ce.run_steps_chunked(ga, bias, s0, keys, beta_arr,
                                        **self._move_args(only_basic_moves, edge_move_importance_sampling))
            es = ce.energy(ga, bias, s)
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
        self._check_classical()
        therm = int(thermalization_time or 0)
        freq = int(sampling_freq) if sampling_freq else 1
        if self._fast2d():
            s0, seeds, J, h = self._torus_args(num_experiments)
            if therm:
                s0 = l2d.run_steps_2d(s0, seeds, np.full(therm, beta, np.float32), J, h)
            # the sampling sweeps continue the thermalization's counter stream
            _, es, ss = l2d.run_sampling_2d(s0, seeds, float(beta), J, h, int(timesteps), freq, ctr0=therm)
            return es.cpu().numpy().astype(np.float64), self._states(ss, *ss.shape[:2])
        ga, bias, s0, keys = self._classical_setup(num_experiments)
        margs = self._move_args(only_basic_moves, edge_move_importance_sampling)
        if therm:
            s0, keys = ce.run_steps_chunked(ga, bias, s0, keys, np.full(therm, beta, np.float32), **margs)
        _, _, es, ss = ce.run_sampling(ga, bias, s0, keys, float(np.float32(beta)), int(timesteps), freq, **margs)
        return es.cpu().numpy().astype(np.float64), (ss == 1).cpu().numpy()

    def run_monte_carlo_annealing(
        self,
        betas: Sequence,
        timesteps: int,
        num_experiments: int,
        only_basic_moves: Optional[bool] = None,
        edge_move_importance_sampling: Optional[bool] = None,
    ):
        """-> (energies[n] f64, states[n, nvars] bool)."""
        self._check_classical()
        beta_arr = self._anneal_schedule(betas, int(timesteps)).astype(np.float32)
        if self._fast2d():
            s0, seeds, J, h = self._torus_args(num_experiments)
            s = l2d.run_steps_2d(s0, seeds, beta_arr, J, h)
            es = l2d.energy_2d(s, J, h)
            return es.cpu().numpy().astype(np.float64), self._states(s, s.shape[0])
        ga, bias, s0, keys = self._classical_setup(num_experiments)
        s, _ = ce.run_steps_chunked(ga, bias, s0, keys, beta_arr,
                                    **self._move_args(only_basic_moves, edge_move_importance_sampling))
        es = ce.energy(ga, bias, s)
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
        self._check_classical()
        beta_arr = self._anneal_schedule(betas, int(timesteps)).astype(np.float32)
        if self._fast2d():
            s0, seeds, J, h = self._torus_args(num_experiments)
            s, es = l2d.run_steps_2d(s0, seeds, beta_arr, J, h, collect_energies=True)
            return es.cpu().numpy().astype(np.float64), self._states(s, s.shape[0])
        ga, bias, s0, keys = self._classical_setup(num_experiments)
        s, _, es = ce.run_steps_chunked(ga, bias, s0, keys, beta_arr, collect_energies=True,
                                        **self._move_args(only_basic_moves, edge_move_importance_sampling))
        return es.cpu().numpy().astype(np.float64), self._states(s, s.shape[0])

    # ---------------------------------------------------------- quantum runs

    def _check_quantum(self):
        """Quantum runs need a global (not individual) bias and a transverse field."""
        if self.bias[0] != "global":
            raise ValueError("Cannot run quantum monte carlo with individual biases")
        if self.transverse is None:
            raise ValueError("Cannot run quantum monte carlo without transverse field")

    def _worldline(self, num_experiments: int, beta: float):
        """Fresh per-experiment keys and worldlines (a new ensemble per call)."""
        self._check_quantum()
        from .engines import worldline as wl

        key_data = key_data_from_seeds(self.rng.make_seeds(num_experiments))
        init = None
        if self.initial_state is not None:
            init = np.where(self.initial_state, 1, -1).astype(np.int8)
        return wl.WorldlineEnsemble(
            cg=self.cg,
            transverse=float(self.transverse),
            longitudinal=float(self.bias[1]),
            beta=float(beta),
            key_data=key_data,
            num_experiments=num_experiments,
            initial_state=init,
            enable_rvb=self.enable_rvb,
            enable_heatbath=self.enable_heatbath,
            dtau=self.dtau,
            device=self.device,
        )

    def run_quantum_monte_carlo(self, beta: float, timesteps: int, num_experiments: int):
        """-> (avg_energies[n] f64, states[n, nvars] bool)."""
        with span("lattice.run_quantum_monte_carlo"):
            with span("worldline.setup"):
                w = self._worldline(num_experiments, beta)
            # the energies' sums reach the host inside timesteps, which waits for the sweeps
            es = np.asarray(w.timesteps(int(timesteps)), np.float64)
            with span("worldline.states"):
                return es, w.states_bool()

    def run_quantum_monte_carlo_sampling(
        self,
        beta: float,
        timesteps: int,
        num_experiments: int,
        sampling_wait_buffer: Optional[int] = None,
        sampling_freq: Optional[int] = None,
    ):
        """-> (avg_energies[n] f64, states[n, t/freq, nvars] bool). The wait
        buffer is clamped to ``timesteps``."""
        w = self._worldline(num_experiments, beta)
        wait = min(int(sampling_wait_buffer or 0), int(timesteps))
        freq = int(sampling_freq) if sampling_freq else 1
        if wait:
            w.timesteps(wait)
        es, ss = w.timesteps_sample(int(timesteps), freq)
        return np.asarray(es, np.float64), np.asarray(ss)

    def _autocorr_run(self, num_experiments, beta, sampling_wait_buffer, sampling_freq):
        """Ensemble after the wait buffer (not clamped), and the sampling period."""
        w = self._worldline(num_experiments, beta)
        if sampling_wait_buffer:
            w.timesteps(int(sampling_wait_buffer))
        return w, int(sampling_freq) if sampling_freq else 1

    def run_quantum_monte_carlo_and_measure_variable_autocorrelation(
        self,
        beta: float,
        timesteps: int,
        num_experiments: int,
        sampling_wait_buffer: Optional[int] = None,
        sampling_freq: Optional[int] = None,
    ):
        """-> corrs[n, t/freq] f64."""
        w, freq = self._autocorr_run(num_experiments, beta, sampling_wait_buffer, sampling_freq)
        return np.asarray(w.variable_autocorrelation(int(timesteps), freq), np.float64)

    def run_quantum_monte_carlo_and_measure_spin_product_autocorrelation(
        self,
        beta: float,
        timesteps: int,
        num_experiments: int,
        spin_products: Sequence[Sequence[int]],
        sampling_wait_buffer: Optional[int] = None,
        sampling_freq: Optional[int] = None,
    ):
        """-> corrs[n, t/freq] f64."""
        w, freq = self._autocorr_run(num_experiments, beta, sampling_wait_buffer, sampling_freq)
        return np.asarray(w.spin_product_autocorrelation(int(timesteps), freq, spin_products), np.float64)

    def run_quantum_monte_carlo_and_measure_bond_autocorrelation(
        self,
        beta: float,
        timesteps: int,
        num_experiments: int,
        sampling_wait_buffer: Optional[int] = None,
        sampling_freq: Optional[int] = None,
    ):
        """-> corrs[n, t/freq] f64."""
        w, freq = self._autocorr_run(num_experiments, beta, sampling_wait_buffer, sampling_freq)
        return np.asarray(w.bond_autocorrelation(int(timesteps), freq), np.float64)

    def run_quantum_monte_carlo_and_measure_spins(
        self,
        beta: float,
        timesteps: int,
        num_experiments: int,
        sampling_freq: Optional[int] = None,
        sampling_wait_buffer: Optional[int] = None,
        spin_measurement=None,
        exponent: Optional[int] = None,
    ):
        """-> (measures[n], energies[n]) f64: per sample ``(sum_i m(s_i)) **
        exponent`` with m mapping down/up to ``spin_measurement`` (default
        (-1.0, 1.0)), averaged over the samples. The wait buffer is clamped."""
        w = self._worldline(num_experiments, beta)
        wait = min(int(sampling_wait_buffer or 0), int(timesteps))
        freq = int(sampling_freq) if sampling_freq else 1
        if wait:
            w.timesteps(wait)
        down, up = spin_measurement if spin_measurement is not None else (-1.0, 1.0)
        exp_ = int(exponent) if exponent is not None else 1
        meas, es = w.measure_spins(int(timesteps), freq, float(down), float(up), exp_)
        return np.asarray(meas, np.float64), np.asarray(es, np.float64)

    def get_offset(self) -> float:
        """The constant energy offset with E = offset - <n_ops>/beta:
        sum_b |J_b| + nvars * |h| + nvars * Gamma."""
        self._check_quantum()
        h = abs(float(self.bias[1]))
        return float(
            np.abs(self.cg.edge_j).sum() + self.nvars * h + self.nvars * float(self.transverse)
        )

    def average_on_and_off_diagonal_and_consts(
        self,
        beta: float,
        timesteps: int,
        num_experiments: int,
        sampling_freq: Optional[int] = None,
        sampling_wait_buffer: Optional[int] = None,
    ):
        """-> (diag, offdiag, consts): mean SSE operator counts, reinterpreted
        for worldlines (``WorldlineEnsemble.op_count_estimates``). The wait
        buffer is not clamped."""
        w = self._worldline(num_experiments, beta)
        wait = int(sampling_wait_buffer or 0)
        freq = int(sampling_freq) if sampling_freq else 1
        if wait:
            w.timesteps(wait)
        d, o, c = w.op_count_estimates(int(timesteps), freq)
        return float(d), float(o), float(c)
