"""``QmcRunner`` — a stateful QMC ensemble over arbitrary k-local interactions, on torch.

Counterpart of ``pyisingmontecarlo_tpu/qmcrunner.py``: the same constructor,
methods and numpy results. The Hamiltonian is a sum of k-local terms, each a
flattened 2^k x 2^k matrix (or its 2^k diagonal) over a list of variables;
the ``_and_offset`` variants shift a matrix to non-negative weights and
accumulate the constant. The backend is the Trotterized generic worldline
engine (``engines/generic.GenericWorldline``; its group-major route of
``engines/generic_gm.py`` where the term set admits it).

- ``nvars`` is explicit and the initial states are random, one simulator a
  seed of the container's seed stream (``rng.MasterRng``, as in the JAX
  package, so the same ``seed`` gives the same keys and states);
- interactions may be added at any time, also between runs: the worldline
  grid is recompiled from the new term set and the configuration regridded
  onto it (``generic.regrid_worldline``);
- a new ``beta`` regrids every worldline to its nearest slice on the new grid;
- no checkpointing, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ._kernels import resolve_device
from .engines import generic as ge
from .engines.observables import autocorrelation_device, pad_autocorr
from .rng import MasterRng, key_data_from_seeds, random_states

__all__ = ["QmcRunner"]


class QmcRunner:
    """Persistent ensemble of generic k-local-interaction QMC simulators.

    ``QmcRunner(nvars, num_experiments, seed=None, use_allocator=True,
    do_loop_updates=False, do_heatbath_updates=False, *, dtau=None,
    device="cuda")``: the JAX package's constructor, with the device explicit
    (``"cuda"`` raises where there is no CUDA; ``"cpu"`` runs every kernel's
    plain version). ``use_allocator`` is kept for the signature and not used;
    ``do_heatbath_updates`` is kept as a flag and does not change the
    sampled distribution (every parallel phase accepts by Glauber)."""

    def __init__(
        self,
        nvars: int,
        num_experiments: int,
        seed: Optional[int] = None,
        use_allocator: bool = True,
        do_loop_updates: bool = False,
        do_heatbath_updates: bool = False,
        *,
        dtau: Optional[float] = None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.nvars = int(nvars)
        if self.nvars <= 0:
            raise ValueError("nvars must be positive")
        self.rng = MasterRng(seed)
        self.use_allocator = bool(use_allocator)
        self.do_loop_updates = bool(do_loop_updates)
        self.do_heatbath_updates = bool(do_heatbath_updates)
        self.dtau = dtau  # Trotter-step target (None: PMC_DTAU, else the engine's 0.1)
        self.terms = ge.TermSet(self.nvars)
        self._keys: Optional[np.ndarray] = None  # [R, 2] uint32 key data before materialization
        self._init_states: Optional[np.ndarray] = None  # [R, nvars] int8
        self._w: Optional[ge.GenericWorldline] = None
        for _ in range(int(num_experiments)):
            self.add_qmc()

    # ------------------------------------------------------------------ build

    @property
    def num_graphs(self) -> int:
        if self._w is not None:
            return self._w.R
        return 0 if self._keys is None else int(self._keys.shape[0])

    def add_qmc(self, use_allocator: Optional[bool] = None) -> None:
        """Append one simulator with a random initial spin state, seeded from
        the container's seed stream."""
        if self._w is not None and self._w.shard is not None:
            raise ValueError("add simulators before sharding the replicas (parallel.replica.shard_runner)")
        key = key_data_from_seeds(self.rng.make_seeds(1))
        s0 = random_states(key, self.nvars)  # [1, nvars] int8
        if self._w is not None:
            sw = torch.from_numpy(s0).to(self.device)[:, :, None].expand(1, self.nvars, self._w.Lt)
            self._w.s = torch.cat([self._w.s, sw])
            self._w.key_data = np.concatenate([self._w.key_data, key])
        elif self._keys is None:
            self._keys, self._init_states = key, s0
        else:
            self._keys = np.concatenate([self._keys, key])
            self._init_states = np.concatenate([self._init_states, s0])

    def _worldline(self, beta: float, key_data, states0) -> ge.GenericWorldline:
        return ge.GenericWorldline(self.terms, beta, key_data, states0, self.do_loop_updates,
                                   dtau_target=self.dtau, device=self.device)

    def _recompile(self) -> None:
        """Apply a term-set change to materialized simulators: recompile the
        grid from the new term set and regrid the current configuration onto
        it (``generic.regrid_worldline``)."""
        old = self._w
        if old is None:
            return
        s_old = old.s.cpu().numpy()
        self._w = self._worldline(old.beta, old.key_data, s_old[:, :, 0])
        self._w.s = torch.from_numpy(ge.regrid_worldline(s_old, self._w.comp, self._w.Lt)).to(self.device)
        self._w.shard = old.shard

    def add_interaction(self, mat: Sequence[float], vars: Sequence[int]) -> None:
        """A flattened 2^k x 2^k matrix over k variables."""
        self.terms.add(mat, vars, diagonal=False, with_offset=False)
        self._recompile()

    def add_interaction_and_offset(self, mat: Sequence[float], vars: Sequence[int]) -> None:
        """As ``add_interaction``, shifted to non-negative weights; the offset is tracked."""
        self.terms.add(mat, vars, diagonal=False, with_offset=True)
        self._recompile()

    def add_diagonal_interaction(self, mat: Sequence[float], vars: Sequence[int]) -> None:
        """The 2^k diagonal of a k-variable interaction."""
        self.terms.add(mat, vars, diagonal=True, with_offset=False)
        self._recompile()

    def add_diagonal_interaction_and_offset(self, mat: Sequence[float], vars: Sequence[int]) -> None:
        """As ``add_diagonal_interaction``, shifted; the offset is tracked."""
        self.terms.add(mat, vars, diagonal=True, with_offset=True)
        self._recompile()

    def set_do_heatbath(self, enable: bool) -> None:
        self.do_heatbath_updates = bool(enable)

    def set_do_loop_updates(self, enable: bool) -> None:
        self.do_loop_updates = bool(enable)
        if self._w is not None:
            self._w.do_loop = self.do_loop_updates

    def _ensure(self, beta: float) -> ge.GenericWorldline:
        """Materialize the worldlines at ``beta``, or regrid them to their
        nearest slices when ``beta`` changes the grid (a replica shard stays)."""
        if self._w is None:
            self._w = self._worldline(float(beta), self._keys, self._init_states)
            self._keys = self._init_states = None
        elif float(beta) != self._w.beta:
            old = self._w
            self._w = self._worldline(float(beta), old.key_data, old.s[:, :, 0].cpu().numpy())
            if self._w.Lt == old.Lt:
                self._w.s = old.s
            else:
                idx = torch.from_numpy(np.arange(self._w.Lt) * old.Lt // self._w.Lt).to(old.s.device)
                self._w.s = old.s.index_select(2, idx)
            self._w.shard = old.shard
        self._w.do_loop = self.do_loop_updates
        return self._w

    # ------------------------------------------------------------------- runs

    def run_sampling(self, beta: float, timesteps: int, sampling_wait_buffer: Optional[int] = None,
                     sampling_freq: Optional[int] = None):
        """-> (energies [n] f64, states [n, t/freq, nvars] bool). The wait
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
        """-> counts [n, t/freq, nterms] int64, one column per added interaction."""
        wait = min(int(sampling_wait_buffer or 0), int(timesteps))
        freq = int(sampling_freq) if sampling_freq else 1
        if self.num_graphs == 0:
            return np.zeros((0, int(timesteps) // freq, len(self.terms.terms)), np.int64)
        w = self._ensure(beta)
        if wait:
            w.timesteps(wait)
        _, counts = w.bond_sample(int(timesteps), freq)
        return counts

    def _autocorr(self, beta, timesteps, wait, freq, series_fn):
        """Autocorrelation of the freq-sampled slice-0 series (the wait buffer
        not clamped), zero-padded into ``[n, timesteps]``; the series stays on
        the device and only rho crosses to the host."""
        if self.num_graphs == 0:
            return np.zeros((0, int(timesteps)), np.float64)
        w = self._ensure(beta)
        if wait:
            w.timesteps(int(wait))
        _, samples = w.timesteps_sample_dev(int(timesteps), int(freq))
        return pad_autocorr(autocorrelation_device(series_fn(samples.to(torch.float32))), int(timesteps))

    def run_quantum_monte_carlo_and_measure_variable_autocorrelation(
            self, beta: float, timesteps: int, sampling_wait_buffer: Optional[int] = None,
            sampling_freq: Optional[int] = None):
        """-> corrs [n, timesteps]."""
        freq = int(sampling_freq) if sampling_freq else 1
        return self._autocorr(beta, timesteps, sampling_wait_buffer, freq, lambda x: x)

    def run_quantum_monte_carlo_and_measure_spin_product_autocorrelation(
            self, beta: float, timesteps: int, spin_products: Sequence[Sequence[int]],
            sampling_wait_buffer: Optional[int] = None, sampling_freq: Optional[int] = None):
        """-> corrs [n, timesteps]."""
        for sub in spin_products:
            for v in sub:
                if int(v) < 0 or int(v) >= self.nvars:
                    raise ValueError(f"Spin product variable {v} out of bounds")
        freq = int(sampling_freq) if sampling_freq else 1
        return self._autocorr(beta, timesteps, sampling_wait_buffer, freq, lambda x: torch.stack(
            [torch.prod(x[:, :, list(sub)], dim=2) for sub in spin_products], dim=2))

    def run_quantum_monte_carlo_and_measure_bond_autocorrelation(
            self, beta: float, timesteps: int, sampling_wait_buffer: Optional[int] = None,
            sampling_freq: Optional[int] = None):
        """-> corrs [n, timesteps] over the per-interaction op-count series,
        rounded and clamped at 0 as ``run_bond_sampling``'s counts are."""
        freq = int(sampling_freq) if sampling_freq else 1
        if self.num_graphs == 0:
            return np.zeros((0, int(timesteps)), np.float64)
        w = self._ensure(beta)
        if sampling_wait_buffer:
            w.timesteps(int(sampling_wait_buffer))
        _, counts = w.bond_sample_dev(int(timesteps), freq)
        series = torch.clamp(torch.round(counts.to(torch.float32)), min=0.0)
        return pad_autocorr(autocorrelation_device(series), int(timesteps))

    # ------------------------------------------------------------ inspection

    def get_offset(self) -> float:
        """The accumulated constant offset of the ``_and_offset`` variants."""
        return float(self.terms.offset)

    def get_graph_itime(self, g: int) -> np.ndarray:
        """-> bool [Lt, nvars]: the worldline of simulator g (materialized at
        beta 1.0 when no run has been made)."""
        g = int(g)
        if g < 0 or g >= self.num_graphs:
            raise ValueError(f"Graph index {g} out of bounds")
        if self._w is None:
            self._ensure(1.0)
        return self._w.itime_states(g)

    def clone(self) -> "QmcRunner":
        """An independent copy with the same terms, state, keys and seed stream."""
        other = QmcRunner.__new__(QmcRunner)
        other.__dict__.update(self.__dict__)
        other.rng = self.rng.clone()
        other.terms = self.terms.clone()
        if self._keys is not None:
            other._keys, other._init_states = self._keys.copy(), self._init_states.copy()
        if self._w is not None:
            w = ge.GenericWorldline.__new__(ge.GenericWorldline)
            w.__dict__.update(self._w.__dict__)
            w.s, w.key_data = self._w.s.clone(), self._w.key_data.copy()
            other._w = w
        return other
