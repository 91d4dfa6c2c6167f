"""Parallel tempering of transverse-field Ising worldlines on a periodic
square lattice, in plain torch: what ``LatticeTempering.qmc_timesteps_sample``
computes on a ladder whose union graph is such a torus, worked out again from
the rule.

Set-up. The master stream of the ladder's seed gives one u64 per rung, in
the order the rungs are added, then one for the swap key. Rung r's key is
its u64's ``[hi, lo]``; its initial worldline is ``bernoulli_states(key_r)``
on every slice. Parameters (f64, cast once to f32): ``dtau = beta / L``,
``Ktau = -log(tanh(dtau Gamma)) / 2``, ``p_bond = 1 - exp(-2 Ktau)``; the
swap weights use ``make_params``' f32 ``dtau`` (beta / L in f32) and
``log cosh``, ``log sinh`` of ``dtau Gamma`` in f32 on the device.

A call of T sweeps splits each rung's key T times (sweep t's kernel seed
from the t-th sub-key) and the swap key once a swap step (its sub-key's
``uniform_f32(R)``). Each sweep:

1. four site phases (color, tau parity), draw ``d``: Glauber in logit form,
   ``log u - log(1 - u) < -dE``, ``dE = (-2 s) (dt (F + h) - kt (s_up +
   s_dn))``, F the spatial field ``((J(y+) s(y+) + J(y-) s(y-)) + J(x+)
   s(x+)) + J(x-) s(x-)``; ``u = min(f32(u31) 2^-31 + 2^-32, 1 - 2^-23)``
   with ``u31 = draw31(seed, tau nvars + i, d)``;
2. two Fortuin-Kasteleyn phases, one a color: a bond (tau, tau + 1) freezes
   when aligned and ``u < p_bond`` (draw 4 + 2c); a cluster's dE is the sum
   of its slices' ``((-2 s) dt) (F + h)`` by forward pointer doubling (a line
   frozen whole: XLA's CPU sum order, windows of 32), and its head flips it
   when ``log u < -dE`` (draw 5 + 2c);
3. the features of the new state: bond products per edge summed over tau,
   the spin sum, the aligned time bonds (int64);
4. the swap step: pair (r, r + 1), r of the step's parity (0 first, then
   alternating from call to call), exchanges its worldlines when ``log u_r <
   log W_r(x_{r+1}) + log W_{r+1}(x_r) - log W_r(x_r) - log W_{r+1}(x_{r+1})``,
   ``log W(P, S, A) = -dtau (sum_e J_e P_e + h S) + A log cosh + (nvars L - A)
   log sinh`` in f32;
5. slice 0 of every rung is the sweep's sample.

The energy of a call is the estimator of the summed features (f64 on the
host): ``((J . P) + h S) / L - Gamma (tanh(a) A + (T nvars L - A) / tanh(a)) / L``
over T, with ``a = dtau Gamma``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import threefry as tf
from .lanehash import draw31, pos_words

__all__ = ["Ladder", "fk_flips", "xla_sum_last"]

_SCALE = 1.0 / 2147483648.0
_HALF = 0.5 / 2147483648.0
_U_MAX = float(np.float32(1.0 - 1.2e-7))


def xla_sum_last(x: torch.Tensor) -> torch.Tensor:
    """f32 sum over the last axis in XLA's CPU order: up to 32 terms one by
    one from 0; more zero-padded evenly on both sides to a multiple of 32,
    each window of 32 summed so, and the window sums again by this rule."""
    L = x.shape[-1]
    if L > 32:
        n = -(-L // 32)
        lo = (32 * n - L) // 2
        z = x.new_zeros(x.shape[:-1] + (1,))
        x = torch.cat([z.expand(*x.shape[:-1], lo), x, z.expand(*x.shape[:-1], 32 * n - L - lo)], -1)
        return xla_sum_last(_in_order(x.reshape(*x.shape[:-1], n, 32)))
    return _in_order(x)


def _in_order(x: torch.Tensor) -> torch.Tensor:
    acc = torch.zeros_like(x[..., 0])
    for t in range(x.shape[-1]):
        acc = acc + x[..., t]
    return acc


def fk_flips(active: torch.Tensor, de: torch.Tensor, log_u: torch.Tensor) -> torch.Tensor:
    """Which slices a Fortuin-Kasteleyn phase flips: ``active`` (int32) the
    frozen bonds (tau, tau + 1), ``de`` each slice's dE, ``log_u`` each
    slice's log-uniform; run sums by forward pointer doubling, a head's
    decision carried forward by pointer doubling."""
    L = active.shape[-1]
    ksteps = max(1, int(math.ceil(math.log2(L))))
    tau = torch.arange(L, device=active.device)
    acc, reach, k = de, active, 1
    for _ in range(ksteps):
        acc = acc + torch.where(reach == 1, acc.roll(-k, 2), 0.0)
        reach = reach & reach.roll(-k, 2)
        k *= 2
    whole = active.amin(2, keepdim=True) == 1
    heads = torch.where(whole, tau == 0, active.roll(1, 2) == 0)
    acc = torch.where(whole, xla_sum_last(de)[..., None], acc)
    prop = (heads & (log_u < -acc)).to(torch.int32)
    cb, k = active.roll(1, 2), 1
    for _ in range(ksteps):
        prop = prop | (prop.roll(k, 2) & cb)
        cb = cb & cb.roll(k, 2)
        k *= 2
    return prop == 1


class Ladder:
    """A tempering ladder on a ``side`` x ``side`` torus with couplings
    ``edge_j`` on the edges ``(edge_a, edge_b)`` (site ``x * side + y``),
    rungs at ``betas`` with field ``gamma`` and longitudinal field ``h``,
    ``ltau`` slices, from ``seed``. ``ftype`` is the type of every float
    operation of a sweep and a swap step (float32 as the rule states; a lower
    one for a control)."""

    def __init__(self, side, edge_a, edge_b, edge_j, betas, gamma, h, ltau, seed, device, ftype=torch.float32):
        R, nvars, L = len(betas), side * side, int(ltau)
        self.side, self.nvars, self.L, self.R, self.dev, self.ft = side, nvars, L, R, device, ftype
        gen = np.random.Generator(np.random.PCG64(int(seed)))
        self.keys = tf.keys_of(np.array([tf.master_seeds(gen, 1)[0] for _ in range(R)], np.uint64))
        self.swapkey = tf.keys_of(tf.master_seeds(gen, 1))[0]
        s0 = torch.from_numpy(tf.bernoulli_states(self.keys, nvars)).to(device)
        self.x = s0[:, :, None].expand(R, nvars, L).to(torch.int32).contiguous()
        self.ea = torch.from_numpy(np.asarray(edge_a, np.int64)).to(device)
        self.eb = torch.from_numpy(np.asarray(edge_b, np.int64)).to(device)
        ej = np.asarray(edge_j, np.float64)
        self.jv = torch.from_numpy(np.broadcast_to(ej, (R, len(ej))).astype(np.float32)).to(device)
        # the sweep's planes: each site's couplings to (x, y + 1) and (x + 1, y), f64 parameters cast once
        jsite = np.zeros((2, nvars))
        lookup = {}
        for k, (a, b) in enumerate(zip(np.asarray(edge_a).tolist(), np.asarray(edge_b).tolist())):
            lookup[(a, b)] = lookup[(b, a)] = k
        for i in range(nvars):
            x, y = divmod(i, side)
            for d, nb in enumerate((x * side + (y + 1) % side, ((x + 1) % side) * side + y)):
                jsite[d, i] = ej[lookup[(i, nb)]]
        b64 = np.asarray(betas, np.float64)
        dt = b64 / L
        kt = -0.5 * np.log(np.tanh(dt * float(gamma)))
        pb = 1.0 - np.exp(-2.0 * kt)

        def f32(v):
            return torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(device)

        jp = f32(np.broadcast_to(jsite, (R, 2, nvars))).to(ftype)
        self.j1 = jp[:, 0].reshape(R, side, side, 1)
        self.j2 = jp[:, 1].reshape(R, side, side, 1)
        self.dt, self.kt, self.h, self.pb = (f32(np.broadcast_to(v, (R,)))[:, None, None].to(ftype)
                                             for v in (dt, kt, float(h), pb))
        # the swap step's f32 parameters: beta / L in f32, and a = dtau * gamma on the device
        beta32 = torch.from_numpy(np.asarray(betas, np.float32))
        self.dtau = (beta32 / L).to(device)
        self.gamma = torch.full((R,), float(gamma), dtype=torch.float32, device=device)
        self.h32 = torch.full((R,), float(h), dtype=torch.float32, device=device)
        a = self.dtau * self.gamma
        self.log_cosh, self.log_sinh = torch.log(torch.cosh(a)), torch.log(torch.sinh(a))
        i = torch.arange(nvars, device=device)
        self.color0 = ((i // side + i % side) % 2 == 0)[:, None]
        tau = torch.arange(L, device=device)[None, :]
        self.tmask = (tau % 2 == 0, tau % 2 == 1)
        self.pw1, self.pw2 = pos_words(tau * nvars + i[:, None])
        self.phase = 0
        self.total_swaps = 0

    def _field(self, sf):
        m = self.side
        q = sf.view(sf.shape[0], m, m, -1)
        yp, ym = self.j1 * q.roll(-1, 2), (self.j1 * q).roll(1, 2)
        xp, xm = self.j2 * q.roll(-1, 1), (self.j2 * q).roll(1, 1)
        return (((yp + ym) + xp) + xm).view(sf.shape)

    def _uniform(self, seed, d):
        u31 = draw31(seed, self.pw1, self.pw2, d)
        return (u31.to(self.ft) * _SCALE + _HALF).clamp(max=_U_MAX)

    def sweep(self, seed_i32: torch.Tensor):
        """One sweep of every rung with kernel seeds ``seed_i32 [R]``."""
        x, ft = self.x, self.ft
        seed = seed_i32[:, None, None]
        cmask = (self.color0, ~self.color0)
        d = 0
        for color in (0, 1):
            for parity in (0, 1):
                sf = x.to(ft)
                ud = (x.roll(-1, 2) + x.roll(1, 2)).to(ft)
                dE = (-2.0 * sf) * (self.dt * (self._field(sf) + self.h) - self.kt * ud)
                u = self._uniform(seed, d)
                acc = (torch.log(u) - torch.log(1.0 - u) < -dE) & cmask[color] & self.tmask[parity]
                x = torch.where(acc, -x, x)
                d += 1
        for color in (0, 1):
            sf = x.to(ft)
            active = ((x == x.roll(-1, 2)) & (self._uniform(seed, d) < self.pb)).to(torch.int32)
            de = ((-2.0 * sf) * self.dt) * (self._field(sf) + self.h)
            x = torch.where(fk_flips(active, de, torch.log(self._uniform(seed, d + 1))) & cmask[color], -x, x)
            d += 2
        self.x = x

    def features(self):
        s = self.x.to(torch.int8)
        P = (s[:, self.ea] * s[:, self.eb]).sum(2)
        return P, s.sum((1, 2)), (s == s.roll(-1, 2)).sum((1, 2))

    def _log_weight(self, P, S, A):
        ft = self.ft
        A = A.to(ft)
        diag = -self.dtau.to(ft) * ((self.jv.to(ft) * P.to(ft)).sum(-1) + self.h32.to(ft) * S.to(ft))
        return diag + A * self.log_cosh.to(ft) + (self.nvars * self.L - A) * self.log_sinh.to(ft)

    def swap(self, feats, u: torch.Tensor) -> int:
        R = self.R
        lw = self._log_weight(*feats)
        up = self._log_weight(*(f.roll(-1, 0) for f in feats))
        dn = self._log_weight(*(f.roll(1, 0) for f in feats))
        delta = up + dn.roll(-1, 0) - lw - lw.roll(-1, 0)
        idx = torch.arange(R, device=self.dev)
        leader = ((idx % 2) == self.phase) & (idx + 1 < R)
        acc = leader & (torch.log(u.to(self.ft)) < delta)
        follower = acc.roll(1, 0) & (idx > 0)
        perm = torch.where(acc, idx + 1, torch.where(follower, idx - 1, idx))
        self.x = self.x[perm]
        self.phase = 1 - self.phase
        return int(acc.sum())

    def call(self, T: int, upto: int = None):
        """A call of ``T`` sweeps with a swap after each, followed for its
        first ``upto`` sweeps (all by default): ``(samples [R, upto, nvars]
        bool, energies [R] f64 or None when cut short, accepted swaps)``."""
        T = int(T)
        n = T if upto is None else min(int(upto), T)
        seeds = np.empty((T, self.R), np.int32)
        keys = self.keys
        for t in range(T):
            keys, sub = tf.split(keys)
            seeds[t] = tf.kernel_seeds(sub)
        self.keys = keys
        sk = self.swapkey.reshape(1, 2)
        uniforms = np.empty((T, self.R), np.float32)
        for t in range(T):
            sk, sub = tf.split(sk)
            uniforms[t] = tf.uniform_f32(sub, self.R)[0]
        self.swapkey = sk[0]
        seeds_t = torch.from_numpy(seeds).to(self.dev)
        uni_t = torch.from_numpy(uniforms).to(self.dev)
        sums = None
        samples, accepted = [], 0
        for t in range(n):
            self.sweep(seeds_t[t])
            feats = self.features()
            sums = feats if sums is None else tuple(a + f for a, f in zip(sums, feats))
            accepted += self.swap(feats, uni_t[t])
            samples.append((self.x[:, :, 0] == 1).cpu())
        self.total_swaps += accepted
        out = torch.stack(samples, 1).numpy() if samples else np.zeros((self.R, 0, self.nvars), bool)
        return out, (self.energy(sums, T) / T if n == T and T else None), accepted

    def energy(self, sums, T: int) -> np.ndarray:
        P, S, A = (v.cpu().numpy().astype(np.float64) for v in sums)
        jv, h, gamma = (v.cpu().numpy().astype(np.float64) for v in (self.jv, self.h32, self.gamma))
        tanh_a = np.tanh((self.dtau * self.gamma).cpu().numpy().astype(np.float64))
        L = self.L
        ediag = ((jv * P).sum(1) + h * S) / L
        eoff = -gamma * (tanh_a * A + (T * self.nvars * L - A) / tanh_a) / L
        return ediag + eoff

    def worldlines(self) -> np.ndarray:
        """``[R, L, nvars]`` bool: each rung's worldline, slice by slice."""
        return (self.x.transpose(1, 2) == 1).cpu().numpy()
