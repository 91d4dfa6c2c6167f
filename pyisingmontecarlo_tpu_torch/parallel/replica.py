"""Replica sharding of ``QmcRunner`` and ``QmcIsing`` over a mesh dimension.

Counterpart of ``pyisingmontecarlo_tpu/parallel/replica.py``. Replicas never
communicate, and every replica draws from its own threefry key, so each rank
runs the same drivers on its block of the replicas (state, keys and, for
``QmcIsing``, the per-replica parameters; the term tables are the same on
every rank) with no collective inside a run, and the results are gathered
at the end of each call: the sharded run equals the unsharded one bit for bit.

As in the JAX package, a sharded ``QmcIsing`` takes the generic colored
route, never the worldline kernel route (the JAX package turns its Pallas
path off when it shards). The shard stays through later runs and through a
beta change's regrid.
"""

from __future__ import annotations

import numpy as np
from torch.distributed.device_mesh import DeviceMesh

from ..engines.worldline import WlParams
from .comm import ReplicaShard
from .mesh import mesh_device

__all__ = ["shard_runner", "shard_qmcising", "dryrun_runner"]


def _check_device(obj, mesh: DeviceMesh):
    if obj.device.type != mesh.device_type:
        raise ValueError(f"the ensemble is on {obj.device}, the mesh on {mesh.device_type}")


def shard_runner(q, mesh: DeviceMesh, beta: float = 1.0, axis: str = "replica") -> None:
    """Shard a ``QmcRunner``'s replicas over the mesh dimension ``axis``:
    materialize the worldlines at ``beta`` if needed and keep this rank's
    block of the state and keys. Later ``run_sampling``, ``run_bond_sampling``
    and autocorrelation calls run the block and gather their results (the
    same on every rank). ``ValueError`` unless the dimension divides R."""
    _check_device(q, mesh)
    w = q._ensure(float(beta))
    shard = ReplicaShard(mesh, axis, w.R)
    w.s = shard.block(w.s).contiguous()
    w.key_data = shard.block(w.key_data).copy()
    w.shard = shard


def shard_qmcising(q, mesh: DeviceMesh, beta=None, axis: str = "replica") -> None:
    """Shard a ``QmcIsing``'s replicas over the mesh dimension ``axis``: this
    rank keeps its block of the state, keys and per-replica parameters, and
    the ensemble takes the generic colored route. ``ValueError`` unless the
    dimension divides R."""
    _check_device(q, mesh)
    w = q._ensure(beta)
    shard = ReplicaShard(mesh, axis, w.R)
    w.s = shard.block(w.s).contiguous()
    w.key_data = shard.block(w.key_data).copy()
    w.p = WlParams(*(shard.block(x) for x in w.p))
    w.dense = None
    w.shard = shard


def dryrun_runner(mesh: DeviceMesh, replicas_per_device: int = 2, nvars: int = 6, timesteps: int = 2) -> np.ndarray:
    """One replica-sharded ``QmcRunner`` sampling step on tiny shapes: a TFIM
    chain with an XX bond (an off-diagonal 2-local term) through the public
    API, on the mesh's first dimension. Returns the energies (global)."""
    from ..qmcrunner import QmcRunner

    axis = mesh.mesh_dim_names[0]
    R = replicas_per_device * mesh.size(0)
    q = QmcRunner(nvars, R, seed=3, device=mesh_device(mesh))
    zz = np.zeros(4)
    for idx in range(4):
        zz[idx] = -1.0 * (1.0 if idx & 1 else -1.0) * (1.0 if idx & 2 else -1.0)
    xx = np.zeros((4, 4))
    for a in range(4):
        xx[a, a ^ 3] = -0.4
    for i in range(nvars):
        q.add_diagonal_interaction(zz, [i, (i + 1) % nvars])
        q.add_interaction(np.array([0.0, -0.8, -0.8, 0.0]), [i])
        q.add_interaction(xx.reshape(-1), [i, (i + 1) % nvars])
    shard_runner(q, mesh, beta=1.0, axis=axis)
    es, _ = q.run_sampling(1.0, timesteps)
    if not np.isfinite(es).all():
        raise RuntimeError(f"dryrun_runner: non-finite energies {es}")
    return es
