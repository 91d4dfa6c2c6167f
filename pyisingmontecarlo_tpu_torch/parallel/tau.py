"""Imaginary-time (tau) sharded worldline sweeps: the worldline split into tau slabs over a mesh dimension.

Counterpart of ``pyisingmontecarlo_tpu/parallel/tau.py``, bit for bit. Each
rank owns a slab ``[R, nvars, L / n]`` of a uniform ring or square torus
TFIM worldline and fetches the neighbouring slabs' boundary slices with
``ring_shift`` before every phase. A sweep is:

- four site phases (color, tau parity), the tau parity taken from global
  slice indices (so a slab has an even number of slices), Glauber on
  ``dE = -2 s (dtau (B + h) - Ktau (s_up + s_dn))``;
- four Fortuin-Kasteleyn cluster phases (color, shard parity): clusters are
  built on the open local tau window (the two cross-slab time bonds stay
  unfrozen and enter each boundary cluster's dE as ``2 Ktau s s_halo``), and
  only slabs of the phase's parity move, so the two ends of an unfrozen bond
  never flip together; that needs an even shard count. The flips are
  ``ops/wl.fk_flips``, the twin of the JAX package's ring-cluster scan.

Randomness: the key is folded with the tau-shard index, then with the
replica index (no offset, unlike the spatial sweep) when the replicas are
sharded too; one split a phase, and a cluster phase splits its subkey again
into (bond, acceptance) keys. The keys of a call are one host table; the
uniforms come from ``rng.threefry_bits``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from ..ops.wl import fk_flips
from ..rng import fold_all, key_tensor, random_bits, split_all, threefry_bits
from .comm import MeshAxis, gather_axis, ring_shift
from .mesh import mesh_device

__all__ = ["sharded_wl_sweeps", "bernoulli_states", "dryrun_tau", "dryrun_tau2d"]

_F = torch.float32
KEYS_PER_SWEEP = 12  # four site phases, four cluster phases of two keys each


def _spatial(kind: str, size: int, nvars: int, device):
    """(field, cmask): the neighbour field ``j * B`` (f32) of the dense shape,
    and its checkerboard color-0 mask (a torus site is x * size + y)."""
    idx = torch.arange(nvars, device=device)
    if kind == "ring":
        def field(s, j):
            return j * (s.roll(1, 1) + s.roll(-1, 1)).to(_F)

        return field, idx % 2 == 0

    def field(s, j):
        R, n, Ll = s.shape
        s4 = s.view(R, size, size, Ll)
        B = s4.roll(1, 1) + s4.roll(-1, 1) + s4.roll(1, 2) + s4.roll(-1, 2)
        return j * B.reshape(R, n, Ll).to(_F)

    return field, (idx // size + idx % size) % 2 == 0


def _halos(s, axis: Optional[MeshAxis]):
    """(dn, up): the slice just below and just above this slab (periodic)."""
    return ring_shift(s[:, :, -1:], axis, 1), ring_shift(s[:, :, :1], axis, -1)


def _sweep_keys(kd: np.ndarray, sweeps: int) -> np.ndarray:
    """``[sweeps, 12, 2]`` uint32: per sweep the four site phases' subkeys,
    then each cluster phase's (bond, acceptance) keys."""
    kd = np.asarray(kd, np.uint32).reshape(1, 2)
    out = np.empty((sweeps, KEYS_PER_SWEEP, 2), np.uint32)
    for t in range(sweeps):
        for k in range(4):
            kd, sub = split_all(kd)
            out[t, k] = sub[0]
        for k in range(4):
            kd, sub = split_all(kd)
            kb, ka = split_all(sub)
            out[t, 4 + 2 * k], out[t, 5 + 2 * k] = kb[0], ka[0]
    return out


def _uniform(keys, k: int, shape):
    return threefry_bits(keys[k:k + 1], int(np.prod(shape)), uniform=True).view(shape)


def _sweeps_local(s, kd, dtau: float, ktau: float, kind: str, size: int, j: float, h: float, sweeps: int,
                  t0: int, axis: Optional[MeshAxis]):
    """``sweeps`` sweeps of this rank's slab ``s[R, nvars, Ll]`` from the key
    data ``kd`` [2] (already folded); ``axis`` is the tau dimension (None: one
    shard, no collectives), ``t0`` the slab's first global slice."""
    dev = s.device
    R, nvars, Ll = s.shape
    field, cmask0 = _spatial(kind, size, nvars, dev)
    keys = key_tensor(_sweep_keys(kd, int(sweeps)).reshape(-1, 2), dev)
    tpar = (t0 + torch.arange(Ll, device=dev)) % 2
    p_bond = 1.0 - torch.exp(torch.tensor(-2.0 * ktau, dtype=_F, device=dev))
    shard_parity = 0 if axis is None else axis.index % 2
    for t in range(int(sweeps)):
        base = t * KEYS_PER_SWEEP
        for k, (color, parity) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
            dn, up = _halos(s, axis)
            ext = torch.cat([dn, s, up], 2).to(_F)
            ud = ext[:, :, :-2] + ext[:, :, 2:]
            dE = (-2.0 * s.to(_F)) * (dtau * (field(s, j) + h) - ktau * ud)
            u = _uniform(keys, base + k, s.shape)
            cmask = cmask0 == (color == 0)
            acc = (u < torch.sigmoid(-dE)) & cmask[None, :, None] & (tpar == parity)[None, None, :]
            s = torch.where(acc, -s, s)
        for k, (color, sphase) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
            u_bond = _uniform(keys, base + 4 + 2 * k, (R, nvars, max(Ll - 1, 1)))
            u_acc = _uniform(keys, base + 5 + 2 * k, (R, nvars, Ll))
            sf = s.to(_F)
            active = (s[:, :, :-1] == s[:, :, 1:]) & (u_bond[:, :, :Ll - 1] < p_bond)
            act = torch.cat([active, active.new_zeros((R, nvars, 1))], 2).to(torch.int32)
            dn, up = _halos(s, axis)
            dE_site = -2.0 * sf * dtau * (field(s, j) + h)
            edge = torch.zeros_like(dE_site)
            edge[:, :, 0] += 2.0 * ktau * sf[:, :, 0] * dn[:, :, 0].to(_F)
            edge[:, :, -1] += 2.0 * ktau * sf[:, :, -1] * up[:, :, 0].to(_F)
            flip = fk_flips(act, dE_site + edge, torch.log(u_acc))
            if shard_parity == sphase:
                s = torch.where(flip & (cmask0 == (color == 0))[None, :, None], -s, s)
    return s


def sharded_wl_sweeps(s, key, mesh: DeviceMesh, beta: float, gamma: float, j: float, h: float, sweeps: int,
                      tau_axis: str = "tau", replica_axis: Optional[str] = None, kind: str = "ring",
                      size: int = 0) -> torch.Tensor:
    """``sweeps`` worldline sweeps of ``s[R, nvars, L_tau]`` (+-1 int8, the same
    on every rank) with tau sharded over ``tau_axis`` (and R over
    ``replica_axis`` when given); ``key`` is ``[2]`` uint32 threefry key data.
    ``kind``/``size`` pick the shape: 'ring' (nvars sites) or 'torus' (side
    ``size``). Returns the global state, the same on every rank, on the
    mesh's device. ``ValueError`` unless L_tau splits into even slabs over
    an even number of shards (or one shard)."""
    L = s.shape[2]
    tau = MeshAxis(mesh, tau_axis)
    n = tau.size
    if L % n or (L // n) % 2:
        raise ValueError(f"L_tau ({L}) must split into even slabs over {n} shards")
    if n > 1 and n % 2:
        raise ValueError("tau sharding needs an even shard count (cluster phases alternate by slab parity so "
                         "unfrozen cross-shard bonds never see both endpoints move at once); a single shard has "
                         "no cross-shard bonds")
    rep = MeshAxis(mesh, replica_axis) if replica_axis else None
    dtau = float(beta) / L
    ktau = -0.5 * float(np.log(np.tanh(dtau * float(gamma))))
    x = torch.as_tensor(s).to(mesh_device(mesh), torch.int8)
    if rep is not None:
        x = rep.block(x, 0)
    x = tau.block(x, 2).contiguous()
    kd = fold_all(np.asarray(key, np.uint32).reshape(1, 2), tau.index)
    if rep is not None:
        kd = fold_all(kd, rep.index)
    x = _sweeps_local(x, kd[0], dtau, ktau, kind, int(size) or x.shape[1], float(j), float(h), sweeps,
                      tau.index * (L // n), tau)
    return gather_axis(gather_axis(x, tau, 2), rep, 0)


def bernoulli_states(key, shape):
    """+-1 int8 ``shape``: +1 where ``jax.random.bernoulli(key, 0.5, shape)``."""
    bits = random_bits(np.asarray(key, np.uint32).reshape(1, 2), int(np.prod(shape)))[0]
    return torch.from_numpy(np.where(bits < np.uint32(1 << 31), 1, -1).astype(np.int8).reshape(shape))


def dryrun_tau(mesh: DeviceMesh, nvars: int, ltau: int, replicas: int, sweeps: int) -> np.ndarray:
    """One tau-sharded run on tiny shapes: a uniform ferromagnetic TFIM ring
    (beta = Gamma = 1, J = -1) from a random start (key 0), swept from key 1
    over the mesh's last dimension. Returns the global state."""
    s = bernoulli_states([0, 0], (replicas, nvars, ltau))
    out = sharded_wl_sweeps(s, np.array([0, 1], np.uint32), mesh, beta=1.0, gamma=1.0, j=-1.0, h=0.0,
                            sweeps=sweeps, tau_axis=mesh.mesh_dim_names[-1])
    return out.cpu().numpy()


def dryrun_tau2d(mesh: DeviceMesh, nvars: int, ltau: int, replicas: int, sweeps: int):
    """The same ring on a (replica x tau) mesh and on one shard (every rank
    runs that one alone, as the JAX package runs it on one device), and the
    parity of the two parts of the <E> estimator, the diagonal bond energy and
    the kink density, within 6 sigma of the replica spread. Returns
    ``(obs_mesh, obs_one)``, each (mean bond energy, mean kink density)."""
    s0 = bernoulli_states([0, 0], (replicas, nvars, ltau))
    key = np.array([0, 1], np.uint32)

    def observables(s):
        sf = s.cpu().numpy().astype(np.float64)
        ej = (-(sf * np.roll(sf, -1, axis=1))).sum(axis=1).mean(axis=1)  # J = -1 ring, averaged over tau
        kinks = (sf != np.roll(sf, -1, axis=2)).mean(axis=(1, 2))
        return ej, kinks

    names = mesh.mesh_dim_names
    ej2, kk2 = observables(sharded_wl_sweeps(s0, key, mesh, 1.0, 1.0, -1.0, 0.0, sweeps, tau_axis=names[-1],
                                             replica_axis=names[0] if len(names) > 1 else None))
    dtau = 1.0 / ltau
    ktau = -0.5 * float(np.log(np.tanh(dtau)))
    one = _sweeps_local(s0.to(mesh_device(mesh)), fold_all(fold_all(key.reshape(1, 2), 0), 0)[0], dtau, ktau,
                        "ring", nvars, -1.0, 0.0, sweeps, 0, None)
    ej1, kk1 = observables(one)
    for a, b in ((ej2, ej1), (kk2, kk1)):
        se = float(np.hypot(a.std(ddof=1), b.std(ddof=1)) / np.sqrt(len(a)))
        if not abs(a.mean() - b.mean()) < 6 * se + 1e-6:
            raise RuntimeError(f"dryrun_tau2d: mesh {a.mean()} against one shard {b.mean()} (se {se})")
    return (float(ej2.mean()), float(kk2.mean())), (float(ej1.mean()), float(kk1.mean()))
