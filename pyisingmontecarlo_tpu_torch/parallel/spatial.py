"""Spatially sharded classical sweeps: one lattice split into column slabs over a mesh dimension.

Counterpart of ``pyisingmontecarlo_tpu/parallel/spatial.py``. Each rank owns
a slab ``[R, Lx, Ly / n]`` of the torus, fetches the neighbouring slabs'
boundary columns with ``ring_shift`` before each checkerboard phase, and
updates its slab with the Glauber test ``u < sigmoid(-beta dE)`` on the
phase's parity. Randomness is the JAX program's, bit for bit: the key is
folded with the shard index (then with the replica index + 1000 when the
replicas are sharded too), split once per phase, and the subkey gives
``uniform(sub, slab shape)``. The subkeys of a call are made on the host in
one table; the uniforms come from ``rng.threefry_bits`` (one kernel launch a
phase on the card).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from ..rng import fold_all, key_tensor, split_all, threefry_bits
from .comm import MeshAxis, gather_axis, ring_shift
from .mesh import mesh_device

__all__ = ["sharded_sweeps_2d", "dryrun_spatial"]

_F = torch.float32


def _phase_keys(key_data: np.ndarray, nphases: int) -> np.ndarray:
    """``[nphases, 2]`` uint32: the subkeys of ``key, sub = split(key)`` taken
    ``nphases`` times from ``key_data`` ``[2]``."""
    kd = np.asarray(key_data, np.uint32).reshape(1, 2)
    out = np.empty((nphases, 2), np.uint32)
    for k in range(nphases):
        kd, sub = split_all(kd)
        out[k] = sub[0]
    return out


def _phase_update(s, u, beta: float, j: float, h: float, mask, space: Optional[MeshAxis]):
    left = ring_shift(s[:, :, -1:], space, 1)  # the column left of this slab
    right = ring_shift(s[:, :, :1], space, -1)  # the column right of it
    ext = torch.cat([left, s, right], 2)
    B = (s.roll(1, 1) + s.roll(-1, 1) + ext[:, :, :-2] + ext[:, :, 2:]).to(_F)
    dE = (-2.0 * s.to(_F)) * (j * B + h)
    acc = (u < torch.sigmoid(-beta * dE)) & mask
    return torch.where(acc, -s, s)


def sharded_sweeps_2d(mesh: DeviceMesh, s, key, beta: float, j: float, h: float, sweeps: int,
                      space_axis: str = "space", replica_axis: Optional[str] = None) -> torch.Tensor:
    """``sweeps`` checkerboard sweeps of ``s[R, Lx, Ly]`` (+-1 int8, the same on
    every rank) with Ly sharded over ``space_axis`` (and R over
    ``replica_axis`` when the mesh has it); ``key`` is ``[2]`` uint32 threefry
    key data (``jax.random.key_data`` of the JAX key). Returns the global
    state, the same on every rank, on the mesh's device."""
    space = MeshAxis(mesh, space_axis)
    rep = MeshAxis(mesh, replica_axis) if replica_axis in (mesh.mesh_dim_names or ()) else None
    dev = mesh_device(mesh)
    x = torch.as_tensor(s).to(dev, torch.int8)
    if rep is not None:
        x = rep.block(x, 0)
    x = space.block(x, 2).contiguous()
    kd = fold_all(np.asarray(key, np.uint32).reshape(1, 2), space.index)
    if rep is not None:
        kd = fold_all(kd, rep.index + 1000)
    x = _sweeps_local(x, kd[0], float(beta), float(j), float(h), int(sweeps), space.index * x.shape[2], space)
    return gather_axis(gather_axis(x, space, 2), rep, 0)


def _sweeps_local(x, kd, beta: float, j: float, h: float, sweeps: int, y0: int, space: Optional[MeshAxis]):
    """``sweeps`` sweeps of this rank's slab ``x[R, Lx, Ly_local]`` from the
    key data ``kd`` [2] (already folded); ``y0`` is the slab's first global
    column, ``space`` the sharded dimension (None: one shard, no collectives)."""
    dev = x.device
    keys = key_tensor(_phase_keys(kd, 2 * sweeps), dev)
    _, Lx, Lyl = x.shape
    par = (torch.arange(Lx, device=dev)[:, None] + torch.arange(Lyl, device=dev)[None, :] + y0) % 2
    masks = (par == 0, par == 1)
    for k in range(2 * sweeps):
        u = threefry_bits(keys[k:k + 1], x.numel(), uniform=True).view(x.shape)
        x = _phase_update(x, u, beta, j, h, masks[k % 2], space)
    return x


def dryrun_spatial(mesh: DeviceMesh, L: int, replicas: int, sweeps: int) -> np.ndarray:
    """The halo-exchange sweep on tiny shapes on the given mesh (``space``, or
    its last dimension; ``replica`` when it has one): a random start from
    numpy seed 0, key 0, beta 0.5, J = -1. Returns the global state."""
    names = mesh.mesh_dim_names
    space_axis = "space" if "space" in names else names[-1]
    replica_axis = "replica" if "replica" in names else None
    rng = np.random.default_rng(0)
    s = torch.from_numpy(rng.integers(0, 2, (replicas, L, L)).astype(np.int8) * 2 - 1)
    out = sharded_sweeps_2d(mesh, s, np.zeros(2, np.uint32), beta=0.5, j=-1.0, h=0.0, sweeps=sweeps,
                            space_axis=space_axis, replica_axis=replica_axis).cpu().numpy()
    if out.shape != (replicas, L, L) or not set(np.unique(out)) <= {-1, 1}:
        raise RuntimeError(f"dryrun_spatial: state {out.shape} with values {np.unique(out)}")
    return out
