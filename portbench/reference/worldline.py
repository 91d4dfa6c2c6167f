"""Trotterized transverse-field Ising worldlines on a uniform periodic square
torus, in plain torch: what ``Lattice.run_quantum_monte_carlo`` computes on
such a torus, worked out again from the rule.

Spins are +-1 on ``[n, nvars, L]`` (site ``i = x * side + y`` at slice
``tau``). A call of R replicas takes the next R u64 seeds of the master
stream; replica r's key is its seed's ``[hi, lo]``, its kernel seed
``k0 ^ 0x9E3779B9 ^ (k1 << 1)`` and its initial worldline
``bernoulli_states(key)`` on every slice (``threefry.py``).

Tables, f64 math cast once: ``dtau = beta / L``, ``a = dtau Gamma``,
``Ktau = -log(tanh a) / 2``;

- the site phase's Glauber threshold ``thr[15 (s > 0) + 3 (B + 4) / 2 +
  (ud + 2) / 2] = int32((2^31 - 1) / (1 + exp(min(dE, 60))))`` for ``dE =
  -2 s (dtau (J B + h) - Ktau ud)``, B the spatial neighbour sum and ``ud =
  s_up + s_dn`` the time neighbours';
- the cluster phase's per-site ``cde[5 (s > 0) + (B + 4) / 2] = -2 s dtau
  (J B + h)``, f32;
- the bond threshold ``int32((1 - exp(-2 Ktau)) (2^31 - 1))``.

Sweep t of a call (from 0), its draws ``draw31(seed, tau nvars + i, 8 t +
d)``:

1. four site phases ``d = 2 color + parity``: a site of the color (``x + y``
   even for color 0) at a slice of the parity flips when its draw is at most
   its threshold;
2. two Fortuin-Kasteleyn phases, one a color: a bond (tau, tau + 1) freezes
   when its slices align and its draw ``8 t + 4 + 2 c`` is below the bond
   threshold; a cluster's dE is the sum of its slices' ``cde`` by forward
   pointer doubling (a line frozen whole: XLA's CPU sum order), and its head
   flips it when ``log((u31 + 0.5) 2^-31) < -dE``, ``u31`` the head's draw
   ``8 t + 5 + 2 c`` (``tempering.fk_flips``, the same rule);
3. the sums after the sweep, int64: the bond products of each site's
   outgoing bonds (to ``(x, y + 1)`` and ``(x + 1, y)``), the spins, and the
   aligned time bonds.

The energy of a call is the estimator of the summed sums, f64 on the host:
``((J Sb + h Ss) / L - Gamma (tanh(a) A + coth(a) (nvars L T - A)) / L) / T``.
The program re-keys its draws past ``2^23 // (2 L)`` sweeps of a call; no
call followed here is that long, and ``run`` refuses one that is.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import threefry as tf
from .lanehash import draw31, pos_words
from .tempering import fk_flips

__all__ = ["tables", "initial", "sweeps", "energies", "run"]

_I31 = 2147483647.0
_SCALE = 1.0 / 2147483648.0


def _couplings(beta: float, gamma: float, ltau: int):
    """``(dtau, a, Ktau)`` in f64."""
    dtau = float(beta) / ltau
    a = dtau * float(gamma)
    return dtau, a, -0.5 * math.log(math.tanh(a))


def tables(j: float, h: float, beta: float, gamma: float, ltau: int, ftype=torch.float32):
    """``(thr [30] int32, cde [10] ftype, bond threshold)``: f64 math, the
    per-site dE cast once to ``ftype`` (float32 as the rule states)."""
    dtau, _, ktau = _couplings(beta, gamma, ltau)
    thr, cde = [], []
    for s in (-1.0, 1.0):
        for bsum in (-4.0, -2.0, 0.0, 2.0, 4.0):
            for ud in (-2.0, 0.0, 2.0):
                dE = -2.0 * s * (dtau * (j * bsum + h) - ktau * ud)
                thr.append(int(1.0 / (1.0 + math.exp(min(dE, 60.0))) * _I31))
            cde.append(-2.0 * s * dtau * (j * bsum + h))
    pb = int((1.0 - math.exp(-2.0 * ktau)) * _I31)
    return (torch.tensor(thr, dtype=torch.int32), torch.tensor(cde, dtype=torch.float64).to(ftype), pb)


def initial(keys: np.ndarray, nvars: int, ltau: int, device) -> torch.Tensor:
    """``[n, nvars, L]`` int8 initial worldlines of ``[n, 2]`` keys."""
    s0 = torch.from_numpy(tf.bernoulli_states(keys, nvars)).to(device)
    return s0[:, :, None].expand(-1, -1, ltau).contiguous()


def _neighbours(side: int, sites: torch.Tensor) -> torch.Tensor:
    """``[m, 4]``: the sites at (x + 1, y), (x - 1, y), (x, y + 1), (x, y - 1) of each site ``x side + y``."""
    x, y = sites // side, sites % side
    return torch.stack([((x + 1) % side) * side + y, ((x - 1) % side) * side + y, x * side + (y + 1) % side,
                        x * side + (y - 1) % side], 1)


def sweeps(x: torch.Tensor, seeds_i32: torch.Tensor, side: int, thr, cde, pb: int, T: int):
    """``T`` sweeps of the worldlines ``x [n, nvars, L]`` (int8) with kernel
    seeds ``seeds_i32 [n]`` from counter 0: ``(x, sums [n, 3] int64)``, the
    sums over the sweeps of the bond products, spins and aligned time bonds.

    A phase reads and writes only its own points: a site phase the (site,
    slice) points of its color and parity, as flat indices ``i L + tau`` of
    ``x``, with their spatial and time neighbours; a cluster phase the lines
    of its color. Neither changes a point the phase reads as a neighbour."""
    n, nvars, L = x.shape
    dev, ft = x.device, cde.dtype
    x = x.clone()
    xf = x.view(n, nvars * L)
    thr, cde = thr.to(dev), cde.to(dev)
    seed = seeds_i32[:, None]
    site, tau = torch.arange(nvars, device=dev), torch.arange(L, device=dev)
    color = (site // side + site % side) % 2
    phases, lines = [], []
    for c in (0, 1):
        for parity in (0, 1):
            i = site[color == c][:, None].expand(-1, L // 2).reshape(-1)
            t = tau[tau % 2 == parity][None, :].expand(nvars // 2, -1).reshape(-1)
            phases.append((i * L + t, _neighbours(side, i) * L + t[:, None],
                           torch.stack([i * L + (t + 1) % L, i * L + (t - 1) % L], 1), pos_words(t * nvars + i)))
    for c in (0, 1):
        i = site[color == c]
        lines.append((i, _neighbours(side, i), pos_words(tau[None, :] * nvars + i[:, None])))

    sums = torch.zeros((n, 3), dtype=torch.int64, device=dev)
    for t in range(T):
        d = 8 * t
        for f, space, time, (pw1, pw2) in phases:
            s = xf[:, f]
            B, ud = xf[:, space].sum(-1), xf[:, time].sum(-1)
            tv = thr[15 * (s > 0) + 3 * ((B + 4) // 2) + (ud + 2) // 2]
            xf[:, f] = torch.where(draw31(seed, pw1, pw2, d) <= tv, -s, s)
            d += 1
        for i, space, (pw1, pw2) in lines:
            s = x[:, i]
            frozen = ((s == s.roll(-1, 2)) & (draw31(seed[:, :, None], pw1, pw2, d) < pb)).to(torch.int32)
            de = cde[5 * (s > 0) + (x[:, space].sum(2) + 4) // 2]
            log_u = torch.log((draw31(seed[:, :, None], pw1, pw2, d + 1).to(ft) + 0.5) * _SCALE)
            x[:, i] = torch.where(fk_flips(frozen, de, log_u), -s, s)
            d += 2
        q = x.view(n, side, side, L)
        bonds = (q * q.roll(-1, 2)).sum((1, 2, 3)) + (q * q.roll(-1, 1)).sum((1, 2, 3))
        sums += torch.stack([bonds, x.sum((1, 2)), (x == x.roll(-1, 2)).sum((1, 2))], 1)
    return x, sums


def energies(sums: torch.Tensor, T: int, nvars: int, ltau: int, j: float, h: float, beta: float,
             gamma: float) -> np.ndarray:
    """f64 energies ``[n]`` of a call of ``T`` sweeps from its sums, in the
    host's operation order."""
    sb, ss, al = (v.astype(np.float64) for v in sums.cpu().numpy().T)
    _, a, _ = _couplings(beta, gamma, ltau)
    t = float(T)
    tanh_a, coth_a = math.tanh(a), 1.0 / math.tanh(a)
    ediag = (float(j) * sb + float(h) * ss) / ltau
    eoff = -float(gamma) * (tanh_a * al + coth_a * (nvars * ltau * t - al)) / ltau
    return (ediag + eoff) / T


def run(seeds_u64, side: int, j: float, h: float, gamma: float, beta: float, ltau: int, T: int, device,
        ftype=torch.float32):
    """``(states [n, nvars] bool, energies [n] f64)``: slice 0 after ``T``
    sweeps and the call's energy, for each u64 master seed of ``seeds_u64``."""
    if T > 2**23 // (2 * ltau):
        raise ValueError(f"{T} sweeps reach the program's re-keying at {2**23 // (2 * ltau)}")
    nvars = side * side
    keys = tf.keys_of(seeds_u64)
    x = initial(keys, nvars, ltau, device)
    thr, cde, pb = tables(j, h, beta, gamma, ltau, ftype)
    x, sums = sweeps(x, torch.from_numpy(tf.kernel_seeds(keys)).to(device), side, thr, cde, pb, T)
    return (x[:, :, 0] == 1).cpu().numpy(), energies(sums, T, nvars, ltau, j, h, beta, gamma)
