"""Trotterized worldline QMC for the transverse-field Ising model, on torch.

Counterpart of ``pyisingmontecarlo_tpu/engines/worldline.py``, on the path that
the JAX package sends to its fused kernel: a uniform periodic ring or square
torus (``graph.detect_dense``). The TFIM at (beta, Gamma, h) is the classical
Ising model on the space-time lattice ``[nvars, L_tau]`` with time-like
coupling ``K_tau = -1/2 ln tanh(dtau * Gamma)``; one sweep is four colored
site phases and two Fortuin-Kasteleyn time-ring cluster phases
(``ops/wl.py``). Estimators: the diagonal energy, the off-diagonal energy
``-Gamma * mean_tau [tanh(a) if aligned else coth(a)]`` per site, and the SSE
operator-count analogues (``op_count_estimates``).

Each ensemble keeps its replicas' threefry key data on the host: a call's
kernel seeds are derived from the keys, and the keys are then folded with the
call's sweep count, as the JAX package does, so a sequence of calls gives the
JAX package's trajectories bit for bit.

The JAX package's other engine (the generic colored worldline sweeps with RVB
and single-cluster moves, for any graph) is not ported: an ensemble the
kernel does not take raises ``NotImplementedError``. ``enable_heatbath`` is
accepted and has no effect, as on the JAX kernel path (always Glauber).
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..graph import CompiledGraph, detect_dense
from ..ops import wl
from ..rng import fold_all, random_states, seeds_from_key_data
from .observables import autocorrelation_device

__all__ = ["WorldlineEnsemble", "WlParams", "make_params", "choose_ltau", "resolve_dtau", "total_energy",
           "DEFAULT_DTAU"]

# Default Trotter step target; the bias in <E> is O((dtau * Gamma)^2 * beta)
DEFAULT_DTAU = 0.05
GENERIC_ITEM = "ROADMAP.md, modules to port, item 5 (the generic colored worldline engine)"


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to torch yet: {GENERIC_ITEM}")


def resolve_dtau(dtau_target=None, default: float = DEFAULT_DTAU) -> float:
    """Trotter-step target: explicit argument, else the PMC_DTAU environment
    variable, else ``default``; read at call time."""
    if dtau_target is not None:
        d = float(dtau_target)
    else:
        d = float(os.environ.get("PMC_DTAU") or default)
    if d <= 0:
        raise ValueError("dtau must be positive")
    return d


def choose_ltau(beta: float, gamma: float, dtau_target=None) -> int:
    """Even number of Trotter slices (even for the time-parity site phases)."""
    dtau_target = resolve_dtau(dtau_target)
    scale = max(1.0, float(gamma))
    L = int(math.ceil(float(beta) * scale / dtau_target))
    L = max(L, 4)
    return L + (L % 2)


class WlParams(NamedTuple):
    """Per-replica worldline parameters, each ``[R]`` f32."""

    dtau: torch.Tensor  # beta / L
    ktau: torch.Tensor  # -1/2 log tanh(dtau * gamma)
    gamma: torch.Tensor
    h: torch.Tensor
    beta: torch.Tensor


def make_params(betas, gammas, hs, L: int, device="cpu") -> WlParams:
    """The JAX package's ``make_params``, in f32 as there: ``dtau = beta / L``,
    ``a = dtau * gamma``, ``ktau = -1/2 log tanh(a)``. (The ladder kernel's own
    dtau, Ktau and p_bond are f64 math cast once, ``ops/ladder.build_planes``.)"""
    beta = torch.from_numpy(np.atleast_1d(np.asarray(betas, np.float32))).to(device)
    gamma = torch.from_numpy(np.asarray(gammas, np.float32)).to(device).expand(beta.shape).contiguous()
    h = torch.from_numpy(np.asarray(hs, np.float32)).to(device).expand(beta.shape).contiguous()
    dtau = beta / L
    ktau = -0.5 * torch.log(torch.tanh(dtau * gamma))
    return WlParams(dtau=dtau, ktau=ktau, gamma=gamma, h=h, beta=beta)


def total_energy(dense, s: torch.Tensor, beta: float, gamma: float, h: float) -> torch.Tensor:
    """Energy estimator of the state ``s[R, nvars, L]`` -> ``[R]`` f32: the
    slice-averaged diagonal energy plus ``-Gamma * sum_i mean_tau w``, with
    ``w = tanh(a)`` on aligned time bonds and ``coth(a)`` elsewhere."""
    kind, size, j = dense
    R, nvars, L = s.shape
    _, _, partners = wl.lattice_fns(kind, size, nvars, s.device)
    x = s.to(torch.int32)
    bonds = sum((x * nb).sum((1, 2)) for nb in partners(x))
    spins = x.sum((1, 2))
    aligned = (x == x.roll(-1, 2)).sum((1, 2))
    f32 = dict(dtype=torch.float32, device=s.device)
    g = torch.tensor(gamma, **f32)
    a = torch.tensor(beta, **f32) / L * g
    ta = torch.tanh(a)
    ediag = (torch.tensor(j, **f32) * bonds.float() + torch.tensor(h, **f32) * spins.float()) / L
    w = aligned.float() * ta + (nvars * L - aligned).float() * (1.0 / ta)
    return ediag - g * w / L


class WorldlineEnsemble:
    """A batch of worldline simulators sharing one lattice and one
    (beta, Gamma, h), on one device; used by ``Lattice``'s quantum methods.

    ``key_data`` is ``[R, 2]`` uint32 threefry key data (``rng.key_data_from_seeds``).
    The start is ``states`` (``[R, nvars, L]``) when given, else
    ``initial_state`` (+-1 ``[nvars]``) constant along tau, else a random
    classical state per replica (``rng.random_states``) constant along tau."""

    def __init__(
        self,
        cg: CompiledGraph,
        transverse: float,
        longitudinal: float,
        beta: float,
        key_data,
        num_experiments: int,
        initial_state: Optional[np.ndarray] = None,
        enable_rvb: bool = False,
        enable_heatbath: bool = False,
        ltau: Optional[int] = None,
        states: Optional[torch.Tensor] = None,
        dtau: Optional[float] = None,
        device="cuda",
    ):
        self.cg = cg
        self.gamma = float(transverse)
        self.h = float(longitudinal)
        self.beta = float(beta)
        self.L = int(ltau) if ltau else choose_ltau(beta, self.gamma, dtau)
        self.key_data = np.asarray(key_data, np.uint32).reshape(-1, 2)
        self.R = int(num_experiments)
        self.device = torch.device(device)
        if enable_rvb:
            raise _not_ported("The RVB (worldline pair-flip) move")
        self.dense = detect_dense(cg)
        why = wl.gate(self.dense, cg.nvars, self.L, self.R)
        if why:
            raise _not_ported(f"Quantum runs off the worldline kernel's path ({why})")
        shape = (self.R, cg.nvars, self.L)
        if states is not None:
            s = torch.as_tensor(states).to(self.device, torch.int8)
        elif initial_state is not None:
            s = torch.as_tensor(np.asarray(initial_state, np.int8)).to(self.device)[None, :, None]
        else:
            s = torch.from_numpy(random_states(self.key_data, cg.nvars)).to(self.device)[:, :, None]
        self.s = s.expand(shape).contiguous()

    # ------------------------------------------------------------------ runs

    def _seeds(self) -> np.ndarray:
        return seeds_from_key_data(self.key_data)

    def _run(self, sweeps: int, freq: Optional[int] = None, nsamples: int = 0):
        """``sweeps`` sweeps from the current keys, which are then folded with
        ``sweeps``. Returns ``(esum [R] f64, stats)``, or with ``freq`` given
        ``(esum, samples [R, nsamples, nvars])`` of slice 0 after every
        ``freq``-th sweep."""
        args = (self.dense, self.beta, self.gamma, self.h, self.L)
        if freq is None:
            self.s, esum, out = wl.run_wl_sweeps(self.s, self._seeds(), sweeps, *args)
        else:
            self.s, esum, out = wl.run_wl_sample(self.s, self._seeds(), freq, nsamples,
                                                 sweeps - freq * nsamples, *args)
        self.key_data = fold_all(self.key_data, sweeps)
        return esum, out

    def timesteps(self, t: int) -> np.ndarray:
        """t sweeps; returns the time-averaged energy estimator [R]."""
        t = int(t)
        if t == 0:
            return total_energy(self.dense, self.s, self.beta, self.gamma, self.h).cpu().numpy().astype(np.float64)
        esum, _ = self._run(t)
        return esum / t

    def _timesteps_sample_dev(self, t: int, freq: int):
        """t sweeps with slice 0 recorded after every ``freq``-th; returns
        ``(energies [R], samples [R, t // freq, nvars] int8 on the device)``."""
        t, freq = int(t), int(freq)
        esum, samples = self._run(t, freq, t // freq)
        return esum / max(t, 1), samples

    def timesteps_sample(self, t: int, freq: int):
        es, samples = self._timesteps_sample_dev(t, freq)
        return es, (samples == 1).cpu().numpy()

    def measure_spins(self, t: int, freq: int, down: float, up: float, exponent: int):
        """``(sum_i m(s_i))^exponent`` averaged over the samples taken after
        every ``freq``-th sweep (m maps down/up spins to ``down``/``up``), and
        the energies. As on the JAX kernel path, the samples are one sweep
        later than the JAX package's XLA path takes them; a run shorter than
        ``freq`` takes its one sample after the first sweep, as that path."""
        t, freq = int(t), max(int(freq), 1)
        if t == 0:
            return np.zeros(self.R), np.zeros(self.R)
        nsamples = t // freq
        if not nsamples:
            freq, nsamples = 1, 1
        esum, samples = self._run(t, freq, nsamples)
        m = np.where(samples.cpu().numpy() == 1, up, down).sum(-1) ** exponent
        return m.mean(1), esum / max(t, 1)

    def op_count_estimates(self, t: int, freq: int):
        """(diag, offdiag, const) mean operator counts (the SSE
        ``average_on_and_off_diagonal_and_consts`` analogue): diag =
        beta * (sum_b |J_b| + sum_i |h| - E_diag), offdiag = the kink count,
        const = beta * Gamma * nvars. Averaged over every sweep, as on the JAX
        kernel path; ``freq`` is not used there."""
        cmax = float(np.abs(self.cg.edge_j).sum() + self.cg.nvars * abs(self.h))
        const = self.beta * self.gamma * self.cg.nvars
        _, stats = self._run(int(t))
        diag = self.beta * (cmax - float(stats["diag_mean"].mean()))
        off = float(stats["kinks_mean"].mean())
        return float(diag), off, const

    # ----------------------------------------------------------- observables

    def states_bool(self) -> np.ndarray:
        """Slice-0 spin configuration as bool[R, nvars]."""
        return (self.s[:, :, 0] == 1).cpu().numpy()

    def itime_states(self, g: int) -> np.ndarray:
        """``[L, nvars]`` bool: the worldline of replica g."""
        return (self.s[g].T == 1).cpu().numpy()

    def _sample_series(self, t: int, freq: int) -> torch.Tensor:
        """Slice-0 spin series ``[R, t // freq, nvars]`` (+-1 f32), on the device."""
        _, samples = self._timesteps_sample_dev(t, freq)
        return samples.to(torch.float32)

    def variable_autocorrelation(self, t: int, freq: int) -> np.ndarray:
        return autocorrelation_device(self._sample_series(t, freq))

    def spin_product_autocorrelation(self, t: int, freq: int, spin_products) -> np.ndarray:
        x = self._sample_series(t, freq)
        series = torch.stack([torch.prod(x[:, :, list(sub)], dim=2) for sub in spin_products], dim=2)
        return autocorrelation_device(series)

    def bond_autocorrelation(self, t: int, freq: int) -> np.ndarray:
        x = self._sample_series(t, freq)
        a = torch.from_numpy(self.cg.edge_a.astype(np.int64)).to(x.device)
        b = torch.from_numpy(self.cg.edge_b.astype(np.int64)).to(x.device)
        return autocorrelation_device(x[:, :, a] * x[:, :, b])
