"""Trotterized worldline QMC for the transverse-field Ising model, on torch.

Counterpart of ``pyisingmontecarlo_tpu/engines/worldline.py``. The TFIM at
(beta, Gamma, h) is the classical Ising model on the space-time lattice
``[nvars, L_tau]`` with time-like coupling ``K_tau = -1/2 ln tanh(dtau *
Gamma)``. Estimators: the diagonal energy, the off-diagonal energy ``-Gamma *
mean_tau [tanh(a) if aligned else coth(a)]`` per site, and the SSE
operator-count analogues.

Two routes, chosen per call by ``WorldlineEnsemble``:

- the **kernel route**, for a uniform periodic ring or square torus that
  ``ops/wl.gate`` admits, with RVB off: four colored site phases and two
  Fortuin-Kasteleyn time-ring cluster phases a sweep in the kernels of
  ``ops/wl.py``. Its kernel seeds come from the replicas' threefry keys, which
  are then folded with the call's sweep count, as the JAX package's Pallas
  route does;
- the **generic route**, for every other graph, with RVB, and for the move
  families the JAX package runs only there (bond sampling, diagonal sweeps,
  single clusters, RVB sweeps): the JAX package's generic colored engine in
  plain torch, on ``engines/classical.device_graph`` (the user's numbering).
  A sweep is ``2C`` colored site phases (each color, both tau parities), then
  ``C`` FK time-ring cluster phases (one per color), then, with RVB, one
  whole-worldline pair-flip phase per strong edge class. Every phase takes
  ``keys, sub = split(keys)`` and draws ``lane_draw31(seed(sub), pos, 0)`` at
  the flat index of the draw in its ``(Cc, L[, 2])`` or ``(Ec,)`` array
  (``classical._uniform_per_replica``); ``rng.threefry_chain`` walks the
  chain of a whole call (on the card in one launch of ``csrc/keychain.cu``).
  So on the CPU the generic route equals the JAX engine bit for bit in states
  and keys wherever couplings, fields and ``dtau`` are integer or dyadic, and
  the energy sums agree to f32 rounding.

Left out of the JAX engine: the dense roll formulation (``PMC_WORLDLINE_DENSE``),
an opt-in cross-check of the generic path there. ``enable_heatbath`` is
accepted and has no effect on either route (every parallel phase accepts by
Glauber, as in the JAX package).
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..graph import CompiledGraph, detect_dense
from ..ops import wl
from ..ops.wl import fk_flips, xla_sum_last
from ..rng import (
    KEY_PLAIN,
    fold_all,
    key_data_of,
    key_tensor,
    randint,
    random_states,
    seeds_from_key_data,
    split_all,
    uniform_f32,
)
from ..utils.accum import kadd, kfinal, kzero
from . import classical as ce
from .classical import _accept, _uniform_per_replica
from .observables import autocorrelation_device

__all__ = ["WorldlineEnsemble", "WlParams", "make_params", "choose_ltau", "resolve_dtau",
           "sweep", "sweep_slots", "diagonal_energy", "offdiagonal_energy", "total_energy", "kink_count",
           "bond_op_counts", "log_weight", "run_sweeps", "run_sweeps_sample", "run_sweeps_bond_sample",
           "run_sweeps_measure", "run_diagonal_sweeps", "run_single_cluster", "run_rvb_sweeps",
           "run_sweeps_opcounts", "DEFAULT_DTAU"]

_F = torch.float32

# Default Trotter step target; the bias in <E> is O((dtau * Gamma)^2 * beta)
DEFAULT_DTAU = 0.05


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
    """Per-replica worldline parameters, each ``[R]`` f32: the JAX package's
    five, and the FK bond probability its cluster phases compute from ktau."""

    dtau: torch.Tensor  # beta / L
    ktau: torch.Tensor  # -1/2 log tanh(dtau * gamma)
    gamma: torch.Tensor
    h: torch.Tensor
    beta: torch.Tensor
    pbond: torch.Tensor  # 1 - exp(-2 ktau)


def params_from_arrays(arrays, device) -> WlParams:
    """``WlParams`` on ``device`` from the five ``[R]`` arrays (dtau, ktau,
    gamma, h, beta), e.g. the JAX ensemble's, taken as f32 bit for bit;
    ``pbond = 1 - exp(-2 ktau)`` in f32 on the CPU, so that an ensemble's
    bond probabilities are the same bits on the card and on the CPU."""
    cpu = [torch.from_numpy(np.array(a, dtype=np.float32).reshape(-1)) for a in list(arrays)[:5]]
    pbond = 1.0 - torch.exp(-2.0 * cpu[1])
    return WlParams(*(x.to(device) for x in (*cpu, pbond)))


def make_params(betas, gammas, hs, L: int, device="cpu") -> WlParams:
    """The JAX package's ``make_params``, in f32 as there (computed on the
    CPU, then moved to ``device``): ``dtau = beta / L``, ``a = dtau * gamma``,
    ``ktau = -1/2 log tanh(a)``. torch's and XLA's f32 ``tanh`` and ``log``
    can differ in the last ulps, so ``ktau`` can too (``dtau`` is one
    correctly rounded division in both). (The ladder kernel's own dtau, Ktau
    and p_bond are f64 math cast once, ``ops/ladder.build_planes``.)"""
    beta = torch.from_numpy(np.atleast_1d(np.asarray(betas, np.float32)))
    gamma = torch.from_numpy(np.asarray(gammas, np.float32)).expand(beta.shape)
    h = torch.from_numpy(np.asarray(hs, np.float32)).expand(beta.shape)
    dtau = beta / L
    ktau = -0.5 * torch.log(torch.tanh(dtau * gamma))
    return params_from_arrays([x.numpy() for x in (dtau, ktau, gamma, h, beta)], device)


# --------------------------------------------------------------------- sweeps
#
# The moves update ``s[R, nvars, L]`` int8 in place and return it. Coupling
# tensors (ga.c_j, ga.e_*_j, ga.edge_j, ga.jmat) may carry a leading replica
# axis ([R, ...]) for a tempering ladder's per-replica couplings; the _b*
# helpers broadcast either layout against [R, ..., L] spin tensors.


def _b2(j):  # [E] or [R, E] -> broadcastable to [R, E]
    return j if j.dim() == 2 else j[None]


def _b3(j):  # [E] or [R, E] -> broadcastable to [R, E, L]
    return j[..., None] if j.dim() == 2 else j[None, :, None]


def _b4(j):  # [C, D] or [R, C, D] -> broadcastable to [R, C, D, L]
    return j[..., None] if j.dim() == 3 else j[None, :, :, None]


def _rows(s: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``s[:, idx]`` for an index tensor of any shape -> ``[R, *idx.shape, L]``."""
    return s.index_select(1, idx.reshape(-1)).reshape(s.shape[0], *idx.shape, s.shape[2])


def _spatial_field(nbrs, jrow, s) -> torch.Tensor:
    """``B[r, k, L] = sum_d J[k, d] * s[r, nbrs[k, d], L]`` (f32). Padding slots
    hold neighbour 0 with J = 0."""
    return (_b4(jrow) * _rows(s, nbrs).to(_F)).sum(2)


def _inv(n: int) -> float:
    """The f32 reciprocal of ``n`` (a Python float that an f32 tensor takes
    exactly): XLA turns a division by a constant into a product with its f32
    reciprocal, so the port does too where the JAX engine divides by a static
    count."""
    return float(np.float32(1.0) / np.float32(n))


def _col(x: torch.Tensor, nd: int) -> torch.Tensor:
    """A per-replica ``[R]`` tensor shaped to broadcast against ``nd`` dims."""
    return x.reshape(-1, *([1] * (nd - 1)))


def _site_color_update(ga, p: WlParams, s, seeds, c: int, parity: int):
    """Glauber on all (site of color c, tau of the given parity) points:
    ``dE = -2 s (dtau (B + h) - Ktau (s_up + s_dn))``, in the JAX engine's
    operation order. Glauber always: parallel Metropolis phases are reducible
    on near-frozen time rings."""
    sites = ga.c_sites[c]
    B = _spatial_field(ga.c_nbrs[c], ga.c_j[c], s)  # [R, Cc, L]
    si = s.index_select(1, sites)
    up = si.roll(-1, 2).to(_F)
    dn = si.roll(1, 2).to(_F)
    dt, kt = _col(p.dtau, 3), _col(p.ktau, 3)
    dE = -2.0 * si.to(_F) * (dt * (B + _col(p.h, 3)) - kt * (up + dn))
    u = _uniform_per_replica(seeds, (sites.shape[0], s.shape[2]))
    tpar = (torch.arange(s.shape[2], device=s.device) % 2) == parity
    acc = _accept(u, dE, 1.0, True) & tpar
    s[:, sites] = torch.where(acc, -si, si)
    return s


def _time_cluster_update(ga, p: WlParams, s, seeds, c: int):
    """Fortuin-Kasteleyn update along the imaginary-time rings of all sites of
    color c: a bond (tau, tau+1) freezes when aligned and its draw is below
    ``1 - exp(-2 Ktau)``; each cluster flips by Metropolis on its spatial and
    longitudinal dE (``ops/wl.fk_flips``, the pointer-doubling ring scan).
    Lines of one color share no bond, so the decisions are independent."""
    sites = ga.c_sites[c]
    L = s.shape[2]
    si = s.index_select(1, sites)
    u = _uniform_per_replica(seeds, (sites.shape[0], L, 2))
    active = (si == si.roll(-1, 2)) & (u[..., 0] < _col(p.pbond, 3))
    B = _spatial_field(ga.c_nbrs[c], ga.c_j[c], s)
    dE_site = -2.0 * si.to(_F) * _col(p.dtau, 3) * (B + _col(p.h, 3))
    flip = fk_flips(active.to(torch.int32), dE_site, torch.log(u[..., 1]))
    s[:, sites] = torch.where(flip, -si, si)
    return s


def _ring_cluster_ids(active: torch.Tensor) -> torch.Tensor:
    """Cluster labels on periodic rings from the active-bond mask ``[..., L]``
    (bond tau -> tau+1): int32 ids in [0, L), constant on each cluster; a
    cluster wrapping the ring takes its tail segment's id."""
    heads = ~active.roll(1, -1)
    ids = torch.cumsum(heads.to(torch.int32), -1, dtype=torch.int32) - 1
    wrap_id = torch.clamp(ids[..., -1], min=0)[..., None]  # nclust - 1
    return torch.where(ids < 0, wrap_id, ids)


def _single_cluster_step(ga, p: WlParams, s, i0, t0, u):
    """One Wolff-style cluster per replica: the FK time-cluster of the seed
    ``(i0[r], t0[r])`` flips by Metropolis on the spatial field (``u [R, L, 2]``:
    bond draws at slot 0, the acceptance draw at ``u[:, 0, 1]``). Returns
    ``(s, cluster sizes [R])``."""
    R, _, L = s.shape
    r = torch.arange(R, device=s.device)
    line = s[r, i0]  # [R, L]
    active = (line == line.roll(-1, 1)) & (u[..., 0] < p.pbond[:, None])
    ids = _ring_cluster_ids(active)
    member = ids == ids[r, t0][:, None]
    size = member.sum(-1)
    nbrs = ga.neighbors[i0]  # [R, D]
    jrow = ga.jmat[i0] if ga.jmat.dim() == 2 else ga.jmat[r, i0]
    sj = s[r[:, None], nbrs].to(_F)  # [R, D, L]
    B = (jrow[:, :, None] * sj).sum(1)
    dE = xla_sum_last(-2.0 * line.to(_F) * p.dtau[:, None] * (B + p.h[:, None]) * member)
    flip = member & (torch.log(u[:, 0, 1]) < -dE)[:, None]
    s[r, i0] = torch.where(flip, -line, line)
    return s, size


def _edge_worldline_update(ga, p: WlParams, s, seeds, c: int, active=None, replicas=None):
    """Whole-worldline pair flips over each edge of strong class c (Glauber on
    the pair's dE; a move that keeps every time kink). ``active`` (bool [Ec]
    tensor or None) masks edges beyond an attempt budget, ``replicas`` (bool
    [R] or None) the replicas that make the move. Returns ``(s, successes [R])``."""
    a, b = ga.e_a[c], ga.e_b[c]
    sia, sib = s.index_select(1, a), s.index_select(1, b)
    sa, sb = sia.to(_F), sib.to(_F)
    Ba = _spatial_field(ga.e_a_nbrs[c], ga.e_a_j[c], s)
    Bb = _spatial_field(ga.e_b_nbrs[c], ga.e_b_j[c], s)
    dt, h = _col(p.dtau, 3), _col(p.h, 3)
    dE = xla_sum_last(dt * (-2.0 * sa * (Ba + h) - 2.0 * sb * (Bb + h) + 4.0 * _b3(ga.e_j[c]) * sa * sb))
    u = _uniform_per_replica(seeds, (a.shape[0],))
    acc = _accept(u, dE, 1.0, True)
    if active is not None:
        acc = acc & active[None]
    if replicas is not None:
        acc = acc & replicas[:, None]
    s[:, a] = torch.where(acc[..., None], -sia, sia)
    s[:, b] = torch.where(acc[..., None], -sib, sib)
    return s, acc.sum(-1)


def sweep_slots(ga, do_cluster: bool, do_rvb: bool) -> int:
    """The key-chain slots of one sweep: 2C site phases, C cluster phases,
    one phase per strong edge class with RVB (all ``rng.KEY_PLAIN``)."""
    C = len(ga.c_sites)
    return 2 * C + (C if do_cluster else 0) + (len(ga.e_a) if do_rvb else 0)


def sweep(ga, p: WlParams, s, seeds, do_cluster: bool, do_rvb: bool, rvb_replicas=None):
    """One full sweep from its row ``seeds [sweep_slots, R]`` of the key table:
    colored site phases (both time parities), FK time-cluster phases per
    color, then the optional pair flips (``rvb_replicas``: bool [R] or None)."""
    col = 0
    for c in range(len(ga.c_sites)):
        for parity in (0, 1):
            s = _site_color_update(ga, p, s, seeds[col], c, parity)
            col += 1
    if do_cluster:
        for c in range(len(ga.c_sites)):
            s = _time_cluster_update(ga, p, s, seeds[col], c)
            col += 1
    if do_rvb:
        for c in range(len(ga.e_a)):
            s, _ = _edge_worldline_update(ga, p, s, seeds[col], c, replicas=rvb_replicas)
            col += 1
    return s


def walk(s, keys, T: int, slots: int, step):
    """``T`` sweeps of ``slots`` plain key-chain slots each on a copy of
    ``s``: ``step(t, s, seeds [slots, R]) -> s``, the chain walked in pieces
    by ``classical.walk``. ``keys`` is ``[R, 2]`` int32 key data on the
    device. Returns ``(s, keys)``."""
    return ce.walk(s.clone(), keys, T, [KEY_PLAIN] * slots, lambda t, x, seeds, v0: step(t, x, seeds))


# ----------------------------------------------------------------- estimators


def diagonal_energy(ga, p: WlParams, s) -> torch.Tensor:
    """Slice-averaged diagonal energy ``sum_b J <s s> + h sum_i <s>`` -> [R]."""
    sf = s.to(_F)
    eb = (_b3(ga.edge_j) * sf.index_select(1, ga.edge_a) * sf.index_select(1, ga.edge_b)).sum((1, 2))
    eh = p.h * sf.sum((1, 2))
    return (eb + eh) / s.shape[2]


def offdiagonal_energy(p: WlParams, s) -> torch.Tensor:
    """``E_x[r] = -Gamma * sum_i mean_tau [tanh(a) if aligned else coth(a)]``,
    from the exact count of aligned time bonds."""
    R, nvars, L = s.shape
    ta = torch.tanh(p.dtau * p.gamma)
    aligned = (s == s.roll(-1, 2)).sum((1, 2)).to(_F)
    return -p.gamma * (aligned * ta + (nvars * L - aligned) * (1.0 / ta)) / L


def total_energy(ga, p: WlParams, s) -> torch.Tensor:
    return diagonal_energy(ga, p, s) + offdiagonal_energy(p, s)


def kink_count(s) -> torch.Tensor:
    """Imaginary-time kinks per replica (the SSE off-diagonal operator count
    analogue; converges to <n_offdiag> as dtau -> 0)."""
    return (s != s.roll(-1, 2)).sum((1, 2))


def bond_op_counts(ga, p: WlParams, s) -> torch.Tensor:
    """SSE diagonal bond-operator count analogue per bond, ``beta (|J_b| -
    J_b <s_a s_b>)`` -> ``[R, nbonds]`` f32, in the JAX engine's CPU
    arithmetic: XLA takes the mean over tau as the exact sum times the f32
    reciprocal of L and fuses the product into the subtraction, so
    ``|J| - (J / L) sum`` is rounded once (exact in f64 for dyadic J)."""
    x = s.to(torch.int32)
    ssum = (x.index_select(1, ga.edge_a) * x.index_select(1, ga.edge_b)).sum(2).double()
    J = _b2(ga.edge_j)
    diff = (J.abs().double() - (J * _inv(s.shape[2])).double() * ssum).to(_F)
    return p.beta[:, None] * diff


def log_weight(ga, p: WlParams, s) -> torch.Tensor:
    """log W(s) under the parameters p -> [R]."""
    sf = s.to(_F)
    eb = (_b3(ga.edge_j) * sf.index_select(1, ga.edge_a) * sf.index_select(1, ga.edge_b)).sum((1, 2))
    eh = p.h[:, None] * sf.sum(1)  # [R, L]
    diag = -p.dtau * (eb + eh.sum(-1))
    a = p.dtau * p.gamma
    nalign = (s == s.roll(-1, 2)).sum((1, 2)).to(_F)
    ntot = s.shape[1] * s.shape[2]
    return diag + nalign * torch.log(torch.cosh(a)) + (ntot - nalign) * torch.log(torch.sinh(a))


# ---------------------------------------------------------------- run functions
#
# ``keys`` is ``[R, 2]`` int32 key data on s's device (``rng.key_tensor``).
# Every run function works on a copy of ``s`` and returns the new state and keys.


def run_sweeps(ga, p, s, keys, timesteps, do_cluster=True, do_rvb=False):
    """``timesteps`` sweeps, accumulating the total-energy estimator after
    each -> ``(s, keys, esum)`` with ``esum`` a compensated pair (``kfinal``)."""
    esum = kzero(s.shape[0], s.device)

    def step(t, x, seeds):
        nonlocal esum
        x = sweep(ga, p, x, seeds, do_cluster, do_rvb)
        esum = kadd(esum, total_energy(ga, p, x))
        return x

    s, keys = walk(s, keys, timesteps, sweep_slots(ga, do_cluster, do_rvb), step)
    return s, keys, esum


def run_sweeps_sample(ga, p, s, keys, timesteps, sampling_freq, do_cluster=True, do_rvb=False):
    """``run_sweeps`` that records slice 0 after every ``sampling_freq``-th
    sweep (``timesteps // sampling_freq`` samples; the remainder sweeps run
    after the last) -> ``(s, keys, esum, samples [R, nsamples, nvars] int8)``."""
    T, freq = int(timesteps), int(sampling_freq)
    nsamples = T // freq
    esum = kzero(s.shape[0], s.device)
    samples = []

    def step(t, x, seeds):
        nonlocal esum
        x = sweep(ga, p, x, seeds, do_cluster, do_rvb)
        esum = kadd(esum, total_energy(ga, p, x))
        if (t + 1) % freq == 0 and t < nsamples * freq:
            samples.append(x[:, :, 0].clone())
        return x

    s, keys = walk(s, keys, T, sweep_slots(ga, do_cluster, do_rvb), step)
    out = torch.stack(samples, 1) if samples else s.new_empty((s.shape[0], 0, s.shape[1]))
    return s, keys, esum, out


def run_sweeps_bond_sample(ga, p, s, keys, timesteps, sampling_freq, do_cluster=True, do_rvb=False):
    """``timesteps // sampling_freq`` blocks of ``sampling_freq`` sweeps (the
    remainder is not run, as in the JAX engine), the bond-operator counts
    recorded after each -> ``(s, keys, esum, counts [R, nsamples, nbonds] f32)``."""
    freq = int(sampling_freq)
    nsamples = int(timesteps) // freq
    esum = kzero(s.shape[0], s.device)
    samples = []

    def step(t, x, seeds):
        nonlocal esum
        x = sweep(ga, p, x, seeds, do_cluster, do_rvb)
        esum = kadd(esum, total_energy(ga, p, x))
        if (t + 1) % freq == 0:
            samples.append(bond_op_counts(ga, p, x))
        return x

    s, keys = walk(s, keys, nsamples * freq, sweep_slots(ga, do_cluster, do_rvb), step)
    out = torch.stack(samples, 1) if samples else torch.zeros((s.shape[0], 0, int(ga.edge_a.shape[0])),
                                                               dtype=_F, device=s.device)
    return s, keys, esum, out


def _integer_pow(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x ** n`` by XLA's binary exponentiation (``lax.integer_pow``), n >= 0."""
    if n == 0:
        return torch.ones_like(x)
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n:
            x = x * x
    return acc


def run_sweeps_measure(ga, p, s, keys, timesteps, sampling_freq, down, up, exponent, do_cluster=True, do_rvb=False):
    """Every sweep computes ``(sum_i m(s_i0)) ** exponent`` at slice 0 (m maps
    down/up spins to ``down``/``up``); sweeps whose index is a multiple of
    ``sampling_freq`` are averaged -> ``(s, keys, esum, msum, mcnt [R] f32 >= 1)``."""
    R = s.shape[0]
    esum, msum = kzero(R, s.device), kzero(R, s.device)
    mcnt = 0
    freq = max(int(sampling_freq), 1)
    lo, hi = float(np.float32(down)), float(np.float32(up))

    def step(t, x, seeds):
        nonlocal esum, msum, mcnt
        x = sweep(ga, p, x, seeds, do_cluster, do_rvb)
        esum = kadd(esum, total_energy(ga, p, x))
        if t % freq == 0:
            m = torch.where(x[:, :, 0] > 0, hi, lo).sum(-1)
            msum = kadd(msum, _integer_pow(m, int(exponent)))
            mcnt += 1
        return x

    s, keys = walk(s, keys, timesteps, sweep_slots(ga, do_cluster, do_rvb), step)
    return s, keys, esum, msum, torch.full((R,), float(max(mcnt, 1)), dtype=_F)


def run_diagonal_sweeps(ga, p, s, keys, timesteps):
    """Single-site sweeps only: the 2C colored site phases -> ``(s, keys)``."""
    def step(t, x, seeds):
        col = 0
        for c in range(len(ga.c_sites)):
            for parity in (0, 1):
                x = _site_color_update(ga, p, x, seeds[col], c, parity)
                col += 1
        return x

    return walk(s, keys, timesteps, 2 * len(ga.c_sites), step)


def run_single_cluster(ga, p, s, keys):
    """One single-cluster step per replica -> ``(s, keys, sizes [R])``. The
    replica's key is split once; its sub-key is split three times into the
    seed site (``randint(k1, nvars)``), the seed slice (``randint(k2, L)``) and
    the ``[L, 2]`` uniforms (threefry ``uniform(k3)``), on the host."""
    R, nvars, L = s.shape
    kd, sub = split_all(key_data_of(keys))
    rest, k1 = split_all(sub)
    rest, k2 = split_all(rest)
    _, k3 = split_all(rest)
    dev = s.device
    i0 = torch.from_numpy(randint(k1, nvars).astype(np.int64)).to(dev)
    t0 = torch.from_numpy(randint(k2, L).astype(np.int64)).to(dev)
    u = torch.from_numpy(uniform_f32(k3, 2 * L).reshape(R, L, 2)).to(dev)
    s, sizes = _single_cluster_step(ga, p, s.clone(), i0, t0, u)
    return s, key_tensor(kd, dev), sizes


def rvb_masks(ga, updates_per_sweep: int):
    """``(reps, masks)`` of an RVB sweep of exactly ``updates_per_sweep``
    attempts: ``reps`` passes over the strong edge classes, and for each
    (pass, class) None (every edge) or a bool mask of the first edges of the
    cut pass."""
    sizes = [int(x.shape[0]) for x in ga.e_a]
    ups = max(1, int(updates_per_sweep))
    reps = -(-ups // max(1, sum(sizes)))
    masks, remaining = [], ups
    for _ in range(reps):
        for n in sizes:
            k = min(n, remaining)
            m = None
            if k != n:
                m = torch.zeros(n, dtype=torch.bool, device=ga.edge_a.device)
                m[:k] = True
            masks.append(m)
            remaining -= k
    return reps, masks


def run_rvb_sweeps(ga, p, s, keys, timesteps, updates_per_sweep):
    """Worldline pair-flip sweeps of exactly ``updates_per_sweep`` attempts
    each (passes beyond the count masked) -> ``(s, keys, ratios [R, t] f32)``,
    the per-sweep success ratios."""
    reps, masks = rvb_masks(ga, updates_per_sweep)
    ups = max(1, int(updates_per_sweep))
    ne = len(ga.e_a)
    ratios = []

    def step(t, x, seeds):
        succ = torch.zeros(x.shape[0], dtype=_F, device=x.device)
        for k in range(reps * ne):
            x, ns = _edge_worldline_update(ga, p, x, seeds[k], k % ne, active=masks[k])
            succ = succ + ns.to(_F)
        ratios.append(succ * _inv(ups))
        return x

    s, keys = walk(s, keys, timesteps, reps * ne, step)
    out = torch.stack(ratios, 1) if ratios else torch.zeros((s.shape[0], 0), dtype=_F, device=s.device)
    return s, keys, out


def run_sweeps_opcounts(ga, p, s, keys, timesteps, sampling_freq, do_cluster=True, do_rvb=False):
    """``max(timesteps // sampling_freq, 1)`` blocks of ``sampling_freq``
    sweeps, the diagonal energy and the kink count recorded after each ->
    ``(s, keys, mean diagonal energy [R], mean kinks [R])`` (f32 means)."""
    freq = int(sampling_freq)
    nsamples = max(int(timesteps) // freq, 1)
    eds, kks = [], []

    def step(t, x, seeds):
        x = sweep(ga, p, x, seeds, do_cluster, do_rvb)
        if (t + 1) % freq == 0:
            eds.append(diagonal_energy(ga, p, x))
            kks.append(kink_count(x).to(_F))
        return x

    s, keys = walk(s, keys, nsamples * freq, sweep_slots(ga, do_cluster, do_rvb), step)
    inv = _inv(nsamples)
    return s, keys, torch.stack(eds).sum(0) * inv, torch.stack(kks).sum(0) * inv


# ---------------------------------------------------------------- host wrapper


class WorldlineEnsemble:
    """A batch of worldline simulators sharing one graph and one
    (beta, Gamma, h), on one device; used by ``Lattice``'s quantum methods and
    by ``QmcIsing``.

    ``key_data`` is ``[R, 2]`` uint32 threefry key data
    (``rng.key_data_from_seeds``), kept on the host between calls. The start
    is ``states`` (``[R, nvars, L]``) when given, else ``initial_state`` (+-1
    ``[nvars]``) constant along tau, else a random classical state per replica
    (``rng.random_states``) constant along tau. ``params`` (five ``[R]``
    arrays: dtau, ktau, gamma, h, beta) replaces ``make_params``'s f32
    parameters of the generic route, e.g. with the JAX ensemble's.

    Each call takes the kernel route where ``ops/wl.gate`` admits the lattice
    and RVB is off, else the generic route (see the module docstring); bond
    sampling, diagonal sweeps, single clusters and RVB sweeps always take the
    generic route. ``enable_rvb``, ``enable_heatbath`` and the replicas may
    change between calls."""

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
        params=None,
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
        self.enable_rvb = bool(enable_rvb)
        self.enable_heatbath = bool(enable_heatbath)
        self.dense = detect_dense(cg)
        self._ga = None
        self.p = (make_params(np.full(self.R, self.beta), self.gamma, self.h, self.L, self.device)
                  if params is None else params_from_arrays(params, self.device))
        shape = (self.R, cg.nvars, self.L)
        if states is not None:
            s = torch.as_tensor(states).to(self.device, torch.int8)
        elif initial_state is not None:
            s = torch.as_tensor(np.asarray(initial_state, np.int8)).to(self.device)[None, :, None]
        else:
            s = torch.from_numpy(random_states(self.key_data, cg.nvars)).to(self.device)[:, :, None]
        self.s = s.expand(shape).contiguous()
        # a parallel.comm.ReplicaShard: s, key_data and p then hold this rank's block (R stays the total)
        self.shard = None

    @property
    def ga(self) -> ce.GraphArrays:
        """The graph's tensors in the user's numbering (built at first use)."""
        if self._ga is None:
            self._ga = ce.device_graph(self.cg, self.device)
        return self._ga

    def on_kernel(self) -> bool:
        """Whether the sweeps take the kernel route."""
        return self.dense is not None and not self.enable_rvb and wl.gate(self.dense, self.cg.nvars, self.L) is None

    def append(self, states: torch.Tensor, key_data: np.ndarray) -> None:
        """Append replicas: ``states [k, nvars, L]`` and their key data
        ``[k, 2]``; their parameters are the first replica's."""
        k = states.shape[0]
        self.s = torch.cat([self.s, states.to(self.device, torch.int8)])
        self.key_data = np.concatenate([self.key_data, np.asarray(key_data, np.uint32).reshape(-1, 2)])
        self.R += k
        self.p = WlParams(*(torch.cat([x, x[:1].expand(k)]) for x in self.p))

    # ------------------------------------------------------------------ runs

    def _keys(self) -> torch.Tensor:
        return key_tensor(self.key_data, self.device)

    def _flags(self):
        return dict(do_cluster=True, do_rvb=self.enable_rvb)

    def _run(self, sweeps: int, freq: Optional[int] = None, nsamples: int = 0):
        """The kernel route: ``sweeps`` sweeps from the current keys, which are
        then folded with ``sweeps``. Returns ``(esum [R] f64, stats)``, or
        with ``freq`` given ``(esum, samples [R, nsamples, nvars])`` of slice 0
        after every ``freq``-th sweep."""
        args = (self.dense, self.beta, self.gamma, self.h, self.L)
        seeds = seeds_from_key_data(self.key_data)
        if freq is None:
            self.s, esum, out = wl.run_wl_sweeps(self.s, seeds, sweeps, *args)
        else:
            self.s, esum, out = wl.run_wl_sample(self.s, seeds, freq, nsamples, sweeps - freq * nsamples, *args)
        self.key_data = fold_all(self.key_data, sweeps)
        return esum, out

    def _global(self, x):
        return x if self.shard is None else self.shard.gather(x)

    def keep_shard(self, other: "WorldlineEnsemble") -> None:
        """Take ``other``'s replica shard, if any, for an ensemble made from its
        block (a regrid or a clone): the generic route, ``R`` the total."""
        if other.shard is not None:
            self.shard, self.dense, self.R = other.shard, None, other.R

    def _generic(self, run, *args, **kw):
        """Call a generic-route run function from the current keys; keep its
        state and keys. Under a replica shard the run is this rank's block and
        the results are gathered."""
        out = run(self.ga, self.p, self.s, self._keys(), *args, **kw)
        self.s, keys = out[0], out[1]
        self.key_data = key_data_of(keys)
        return self._global(out[2:])

    def timesteps(self, t: int) -> np.ndarray:
        """t sweeps; returns the time-averaged energy estimator [R]."""
        t = int(t)
        if t == 0:
            return self._global(total_energy(self.ga, self.p, self.s)).cpu().numpy().astype(np.float64)
        if self.on_kernel():
            esum, _ = self._run(t)
            return esum / t
        (esum,) = self._generic(run_sweeps, t, **self._flags())
        return kfinal(esum) / t

    def _timesteps_sample_dev(self, t: int, freq: int):
        """t sweeps with slice 0 recorded after every ``freq``-th; returns
        ``(energies [R], samples [R, t // freq, nvars] int8 on the device)``."""
        t, freq = int(t), int(freq)
        if self.on_kernel():
            esum, samples = self._run(t, freq, t // freq)
            return esum / max(t, 1), samples
        esum, samples = self._generic(run_sweeps_sample, t, freq, **self._flags())
        return kfinal(esum) / max(t, 1), samples

    def timesteps_sample(self, t: int, freq: int):
        es, samples = self._timesteps_sample_dev(t, freq)
        return es, (samples == 1).cpu().numpy()

    def bond_sample(self, t: int, freq: int):
        """``t // freq`` blocks of ``freq`` sweeps (generic route) ->
        ``(energies [R], bond counts [R, t // freq, nbonds] int64)``, the
        counts the rounded f32 estimates."""
        esum, samples = self._generic(run_sweeps_bond_sample, int(t), int(freq), **self._flags())
        counts = np.maximum(np.rint(samples.cpu().numpy().astype(np.float64)), 0).astype(np.int64)
        return kfinal(esum) / max(int(t), 1), counts

    def measure_spins(self, t: int, freq: int, down: float, up: float, exponent: int):
        """``(sum_i m(s_i))^exponent`` averaged over samples (m maps down/up
        spins to ``down``/``up``), and the energies. On the kernel route the
        samples are slice 0 after every ``freq``-th sweep (one sweep later than
        the generic route, which samples sweeps whose index is a multiple of
        ``freq``, as the JAX package's two paths do); a run shorter than
        ``freq`` takes its one sample after the first sweep."""
        t, freq = int(t), max(int(freq), 1)
        if not self.on_kernel():
            esum, msum, mcnt = self._generic(run_sweeps_measure, t, freq, down, up, exponent, **self._flags())
            return kfinal(msum) / mcnt.cpu().numpy().astype(np.float64), kfinal(esum) / max(t, 1)
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
        const = beta * Gamma * nvars. The kernel route averages every sweep;
        the generic route the samples after every ``freq``-th."""
        cmax = float(np.abs(self.cg.edge_j).sum() + self.cg.nvars * abs(self.h))
        const = self.beta * self.gamma * self.cg.nvars
        if self.on_kernel():
            _, stats = self._run(int(t))
            diag = self.beta * (cmax - float(stats["diag_mean"].mean()))
            return float(diag), float(stats["kinks_mean"].mean()), const
        eds, kks = self._generic(run_sweeps_opcounts, int(t), int(freq), **self._flags())
        diag = self.beta * (cmax - float(eds.cpu().numpy().astype(np.float64).mean()))
        return float(diag), float(kks.cpu().numpy().astype(np.float64).mean()), const

    def diagonal_sweeps(self, t: int) -> None:
        self._generic(run_diagonal_sweeps, int(t))

    def cluster_step(self) -> np.ndarray:
        (sizes,) = self._generic(run_single_cluster)
        return sizes.cpu().numpy().astype(np.int64)

    def rvb_sweeps(self, t: int, updates_per_sweep: Optional[int]) -> np.ndarray:
        ups = int(updates_per_sweep) if updates_per_sweep else self.cg.nedges
        (ratios,) = self._generic(run_rvb_sweeps, int(t), ups)
        return ratios.cpu().numpy().astype(np.float64)

    # ----------------------------------------------------------- observables

    def states_bool(self) -> np.ndarray:
        """Slice-0 spin configuration as bool[R, nvars]."""
        return (self._global(self.s[:, :, 0]) == 1).cpu().numpy()

    def itime_states(self, g: int) -> np.ndarray:
        """``[L, nvars]`` bool: the worldline of replica g."""
        return (self._global(self.s)[g].T == 1).cpu().numpy()

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
