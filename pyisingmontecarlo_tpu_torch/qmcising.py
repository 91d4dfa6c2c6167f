"""``QmcIsing`` — a stateful ensemble of transverse-field Ising QMC simulators, on torch.

Counterpart of ``pyisingmontecarlo_tpu/qmcising.py``: the same constructor,
methods and numpy results. The ensemble is one batched worldline array
(``engines/worldline.WorldlineEnsemble``), and the move families map as:

- ``run_qmc``      -> full sweeps (site phases + FK time clusters [+ RVB]);
- ``run_diagonal`` -> the colored single-site phases only;
- ``run_cluster``  -> one FK time-line cluster per experiment, returning its size;
- ``run_rvb``      -> whole-worldline pair-flip sweeps, returning success ratios.

``run_qmc``, ``run_sampling`` and the autocorrelations take the worldline
kernel on a uniform ring or torus that its gate admits with RVB off; every
other run takes the generic colored engine (see ``engines/worldline.py``).

``beta`` enters only at run time: the worldline grid is materialized at the
first run and regridded (nearest slice) when a later beta changes the slice
count. Checkpoints are the JAX package's CBOR files; the random state is not
saved, so a reload reseeds.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ._kernels import resolve_device
from .engines import worldline as wl
from .engines.observables import pad_autocorr
from .graph import compile_graph
from .rng import MasterRng, key_data_from_seeds, random_states
from .utils import cbor

__all__ = ["QmcIsing"]


class QmcIsing:
    """Persistent ensemble of transverse-field Ising QMC simulators.

    ``QmcIsing(edges, transverse, longitudinal=0.0, num_experiments=1,
    seed=None, use_allocator=True, do_heatbath_updates=False,
    do_rvb_updates=False, *, dtau=None, device="cuda")``: the JAX package's
    constructor, with the device explicit (``"cuda"`` raises where there is no
    CUDA; ``"cpu"`` runs the kernels' plain versions). ``use_allocator`` is
    kept for the signature and not used; ``do_heatbath_updates`` is accepted
    and has no effect (every parallel phase accepts by Glauber)."""

    def __init__(
        self,
        edges: Sequence,
        transverse: float,
        longitudinal: float = 0.0,
        num_experiments: int = 1,
        seed: Optional[int] = None,
        use_allocator: bool = True,
        do_heatbath_updates: bool = False,
        do_rvb_updates: bool = False,
        *,
        dtau: Optional[float] = None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.edges = [((int(a), int(b)), float(j)) for (a, b), j in edges]
        self.cg = compile_graph(self.edges)
        self.nvars = self.cg.nvars
        self.transverse = float(transverse)
        if self.transverse <= 0:
            raise ValueError("Transverse field must be positive for QMC")
        self.longitudinal = float(longitudinal)
        self.seed = seed
        self.rng = MasterRng(seed)
        self.use_allocator = bool(use_allocator)
        self.enable_heatbath = bool(do_heatbath_updates)
        self.enable_rvb = bool(do_rvb_updates)
        self.dtau = dtau  # Trotter-step target (None: PMC_DTAU, else 0.05)
        self._keys: Optional[np.ndarray] = None  # [R, 2] uint32 key data before materialization
        self._init_states: Optional[np.ndarray] = None  # [R, nvars] int8
        self._w: Optional[wl.WorldlineEnsemble] = None
        for _ in range(int(num_experiments)):
            self.add_qmc()

    # ------------------------------------------------------------------ state

    @property
    def num_graphs(self) -> int:
        if self._w is not None:
            return self._w.R
        return 0 if self._keys is None else int(self._keys.shape[0])

    def add_qmc(self, use_allocator: Optional[bool] = None) -> None:
        """Append one simulator seeded from the container's seed stream, with
        a random initial spin state (constant along tau once materialized)."""
        if self._w is not None and self._w.shard is not None:
            raise ValueError("add simulators before sharding the replicas (parallel.replica.shard_qmcising)")
        key = key_data_from_seeds(self.rng.make_seeds(1))
        s0 = random_states(key, self.nvars)  # [1, nvars] int8
        if self._w is not None:
            sw = torch.from_numpy(s0)[:, :, None].expand(1, self.nvars, self._w.L)
            self._w.append(sw, key)
        elif self._keys is None:
            self._keys, self._init_states = key, s0
        else:
            self._keys = np.concatenate([self._keys, key])
            self._init_states = np.concatenate([self._init_states, s0])

    def set_enable_heatbath(self, enable: bool) -> None:
        self.enable_heatbath = bool(enable)
        if self._w is not None:
            self._w.enable_heatbath = self.enable_heatbath

    def set_enable_rvb(self, enable: bool) -> None:
        self.enable_rvb = bool(enable)
        if self._w is not None:
            self._w.enable_rvb = self.enable_rvb

    def _ensemble(self, beta: float, states, key_data, ltau: int, params=None) -> wl.WorldlineEnsemble:
        return wl.WorldlineEnsemble(
            cg=self.cg, transverse=self.transverse, longitudinal=self.longitudinal, beta=beta,
            key_data=key_data, num_experiments=states.shape[0], enable_rvb=self.enable_rvb,
            enable_heatbath=self.enable_heatbath, states=states, ltau=ltau, params=params, device=self.device)

    def _ensure(self, beta: Optional[float]) -> wl.WorldlineEnsemble:
        """Materialize or regrid the worldline ensemble for ``beta``; None
        keeps the current grid (beta 1.0 at first use). A replica shard stays
        through a regrid, on the generic route."""
        if self._w is None:
            b = 1.0 if beta is None else float(beta)
            L = wl.choose_ltau(b, self.transverse, self.dtau)
            s = torch.from_numpy(self._init_states)[:, :, None].expand(-1, self.nvars, L)
            self._w = self._ensemble(b, s, self._keys, L)
            self._keys = self._init_states = None
        elif beta is not None and float(beta) != self._w.beta:
            b = float(beta)
            L = wl.choose_ltau(b, self.transverse, self.dtau)
            old, s = self._w, self._w.s
            if L != old.L:  # nearest-slice resampling along tau
                s = s[:, :, torch.from_numpy(np.arange(L) * old.L // L).to(s.device)]
            self._w = self._ensemble(b, s, old.key_data, L)
            self._w.keep_shard(old)
        else:
            self._w.enable_rvb = self.enable_rvb
            self._w.enable_heatbath = self.enable_heatbath
        return self._w

    # ------------------------------------------------------------------- runs

    def run_qmc(self, beta: float, timesteps: int) -> None:
        """Full sweeps of every simulator; no result. A no-op with no simulators."""
        if self.num_graphs == 0:
            return
        self._ensure(beta).timesteps(int(timesteps))

    def run_diagonal(self, beta: float, timesteps: Optional[int] = None) -> None:
        """Single-site sweeps only (default one)."""
        if self.num_graphs == 0:
            return
        self._ensure(beta).diagonal_sweeps(int(timesteps or 1))

    def run_cluster(self) -> np.ndarray:
        """One single-cluster update each -> cluster sizes [n] int64."""
        if self.num_graphs == 0:
            return np.zeros(0, np.int64)
        return self._ensure(None).cluster_step()

    def run_rvb(self, timesteps: Optional[int] = None, updates_per_sweep: Optional[int] = None):
        """Pair-flip sweeps (default one, of nedges attempts each) -> success
        ratios [n, timesteps] f64."""
        if self.num_graphs == 0:
            return np.zeros((0, int(timesteps or 1)), np.float64)
        return self._ensure(None).rvb_sweeps(int(timesteps or 1), updates_per_sweep)

    def run_sampling(self, beta: float, timesteps: int, sampling_wait_buffer: Optional[int] = None,
                     sampling_freq: Optional[int] = None):
        """-> (avg energies [n] f64, states [n, t/freq, nvars] bool). The wait
        buffer is clamped to ``timesteps``."""
        wait = min(int(sampling_wait_buffer or 0), int(timesteps))
        freq = int(sampling_freq) if sampling_freq else 1
        if self.num_graphs == 0:
            return np.zeros(0, np.float64), np.zeros((0, int(timesteps) // freq, self.nvars), bool)
        w = self._ensure(beta)
        if wait:
            w.timesteps(wait)
        es, ss = w.timesteps_sample(int(timesteps), freq)
        return np.asarray(es, np.float64), ss

    def run_bond_sampling(self, beta: float, timesteps: int, sampling_wait_buffer: Optional[int] = None,
                          sampling_freq: Optional[int] = None):
        """-> bond counts [n, t/freq, nbonds] int64: the SSE diagonal operator
        count per bond, as the worldline estimator ``bond_op_counts`` gives it."""
        wait = min(int(sampling_wait_buffer or 0), int(timesteps))
        freq = int(sampling_freq) if sampling_freq else 1
        if self.num_graphs == 0:
            return np.zeros((0, int(timesteps) // freq, self.cg.nedges), np.int64)
        w = self._ensure(beta)
        if wait:
            w.timesteps(wait)
        _, counts = w.bond_sample(int(timesteps), freq)
        return counts

    # ---------------------------------------------------------- correlations

    def _autocorr(self, beta, timesteps, wait, freq, measure):
        """``measure(ensemble, t, freq)`` after the wait buffer (not clamped),
        zero-padded into ``[n, timesteps]``."""
        freq = int(freq) if freq else 1
        if self.num_graphs == 0:
            return np.zeros((0, int(timesteps)), np.float64)
        w = self._ensure(beta)
        if wait:
            w.timesteps(int(wait))
        return pad_autocorr(measure(w, int(timesteps), freq), int(timesteps))

    def run_quantum_monte_carlo_and_measure_variable_autocorrelation(
            self, beta: float, timesteps: int, sampling_wait_buffer: Optional[int] = None,
            sampling_freq: Optional[int] = None):
        """-> corrs [n, timesteps]: the t/freq-long autocorrelation of the
        freq-sampled series in the leading columns of a zero-filled array."""
        return self._autocorr(beta, timesteps, sampling_wait_buffer, sampling_freq,
                              lambda w, t, f: w.variable_autocorrelation(t, f))

    def run_quantum_monte_carlo_and_measure_spin_product_autocorrelation(
            self, beta: float, timesteps: int, spin_products: Sequence[Sequence[int]],
            sampling_wait_buffer: Optional[int] = None, sampling_freq: Optional[int] = None):
        """-> corrs [n, timesteps]."""
        for sub in spin_products:
            for v in sub:
                if int(v) < 0 or int(v) >= self.nvars:
                    raise ValueError(f"Spin product variable {v} out of bounds")
        return self._autocorr(beta, timesteps, sampling_wait_buffer, sampling_freq,
                              lambda w, t, f: w.spin_product_autocorrelation(t, f, spin_products))

    def run_quantum_monte_carlo_and_measure_bond_autocorrelation(
            self, beta: float, timesteps: int, sampling_wait_buffer: Optional[int] = None,
            sampling_freq: Optional[int] = None):
        """-> corrs [n, timesteps]."""
        return self._autocorr(beta, timesteps, sampling_wait_buffer, sampling_freq,
                              lambda w, t, f: w.bond_autocorrelation(t, f))

    # ------------------------------------------------------------ inspection

    def get_offset(self) -> float:
        """0.0 with no simulators, else sum_b |J_b| + nvars |h| + nvars Gamma."""
        if self.num_graphs == 0:
            return 0.0
        return float(np.abs(self.cg.edge_j).sum() + self.nvars * abs(self.longitudinal)
                     + self.nvars * self.transverse)

    def get_graph_itime(self, g: int) -> np.ndarray:
        """-> bool [L_tau, nvars]: the spins of simulator g at every slice."""
        g = int(g)
        if g < 0 or g >= self.num_graphs:
            raise ValueError(f"Graph index {g} out of bounds")
        return self._ensure(None).itime_states(g)

    def clone(self) -> "QmcIsing":
        """An independent copy with the same state, keys and seed stream."""
        other = QmcIsing.__new__(QmcIsing)
        other.__dict__.update(self.__dict__)
        other.rng = self.rng.clone()
        if self._keys is not None:
            other._keys, other._init_states = self._keys.copy(), self._init_states.copy()
        if self._w is not None:
            w = self._w
            other._w = self._ensemble(w.beta, w.s.clone(), w.key_data.copy(), w.L, params=[x.cpu() for x in w.p])
            other._w.keep_shard(w)
        return other

    # ----------------------------------------------------------- persistence

    def save_to_file(self, path: str) -> None:
        """The JAX package's CBOR file: (nvars, edges, transverse,
        longitudinal, heatbath, rvb, seed, use_allocator, graphs), each graph
        its full worldline. The random state is not saved."""
        graphs = []
        if self._w is not None:
            s = self._w._global(self._w.s).cpu().numpy()
            graphs = [{"L": self._w.L, "beta": self._w.beta, "worldline": s[g] == 1} for g in range(self._w.R)]
        elif self._keys is not None:
            graphs = [{"L": 0, "beta": 0.0, "worldline": (x == 1)[:, None]} for x in self._init_states]
        cbor.dump([self.nvars, [[list(ab), j] for ab, j in self.edges], self.transverse, self.longitudinal,
                   self.enable_heatbath, self.enable_rvb, None if self.seed is None else int(self.seed),
                   self.use_allocator, graphs], path)

    @staticmethod
    def read_from_file(path: str, reseed: Optional[int] = None, *, device="cuda") -> "QmcIsing":
        """Reload a checkpoint; the keys are drawn anew from ``reseed`` (or
        entropy), never restored."""
        nvars, edges, transverse, longitudinal, heatbath, rvb, seed, use_alloc, graphs = cbor.load(path)
        out = QmcIsing([((int(a), int(b)), float(j)) for (a, b), j in edges], transverse, longitudinal,
                       num_experiments=0, seed=reseed, use_allocator=use_alloc, do_heatbath_updates=heatbath,
                       do_rvb_updates=rvb, device=device)
        if graphs:
            keys = key_data_from_seeds(out.rng.make_seeds(len(graphs)))
            L = int(graphs[0]["L"])
            if L == 0:  # saved before materialization
                out._keys = keys
                out._init_states = np.stack([np.where(g["worldline"][:, 0], 1, -1).astype(np.int8) for g in graphs])
            else:
                s = np.stack([np.where(g["worldline"], 1, -1).astype(np.int8) for g in graphs])
                out._w = out._ensemble(float(graphs[0]["beta"]), torch.from_numpy(s), keys, L)
        return out
