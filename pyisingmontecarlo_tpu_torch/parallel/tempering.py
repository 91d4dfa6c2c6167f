"""Parallel tempering with the ladder's replicas sharded over a mesh dimension.

Counterpart of ``pyisingmontecarlo_tpu/parallel/tempering.py``. The JAX
package keeps its fused ladder kernel under sharding by issuing it inside
``shard_map``, one kernel call per device on its replica shard; here each
rank calls ``ops/ladder.ladder_sweeps`` on its block of the replicas (so the
resident kernel's gate is asked at R / n), or the generic sweep on the block
off the ladder kernel's gate. A swap step gathers the per-replica swap
features, a few integers a replica; every rank then takes the same decisions
from the same swap uniforms, and a pair (r, r + 1) that straddles two blocks
trades its two planes with ``ring_shift`` (``LatticeTempering._swap``).
"""

from __future__ import annotations

import numpy as np
from torch.distributed.device_mesh import DeviceMesh

from ..graph import compile_graph_arrays
from ..tempering import LatticeTempering, batched_graph_arrays
from .comm import ReplicaShard
from .mesh import mesh_device

__all__ = ["shard_ladder", "dryrun_ladder"]


def shard_ladder(lt: LatticeTempering, mesh: DeviceMesh, axis: str = "replica") -> None:
    """Shard a ladder's replicas over the mesh dimension ``axis``: this rank
    keeps its block of the state, keys, ladder planes (or per-replica
    couplings and RVB mask of the generic route), and the ladder records the
    shard; later ``qmc_timesteps*`` calls run SPMD. ``ValueError`` unless the
    dimension divides the number of graphs."""
    if lt.device.type != mesh.device_type:
        raise ValueError(f"the ladder is on {lt.device}, the mesh on {mesh.device_type}")
    m = lt._materialize()
    R = len(lt.graphs)
    if m["s"].shape[0] != R or "shard" in m:
        raise ValueError("the ladder is sharded already")
    shard = ReplicaShard(mesh, axis, R)
    m["s"] = shard.block(m["s"]).contiguous()
    m["key_data"] = shard.block(m["key_data"]).copy()
    if "planes" in m:
        pl = m["planes"]
        m["planes"] = pl._replace(**{k: shard.block(getattr(pl, k)).contiguous() for k in ("j", "dt", "kt", "h", "pb")})
    else:
        ea, eb = m["ea"].cpu().numpy().astype(np.int64), m["eb"].cpu().numpy().astype(np.int64)
        cg = compile_graph_arrays(lt.nvars, ea, eb, np.ones(len(ea)))
        m["ga"] = batched_graph_arrays(cg, shard.block(lt._union_jvals()), lt.device)
        m["rvb"] = shard.block(m["rvb"])
    m["shard"] = shard


def dryrun_ladder(mesh: DeviceMesh, replicas_per_device: int, nvars: int, ltau: int, timesteps: int) -> np.ndarray:
    """One sharded tempering run on tiny shapes: a ring ladder at betas
    linspace(0.5, 1.5, R), R = replicas_per_device times the mesh's ranks,
    on ``ltau`` slices, sharded over the mesh's first dimension; sweeps and
    swap steps; returns the per-replica energy sums (global)."""
    n = mesh.mesh.numel()
    R = replicas_per_device * n
    edges = [((i, (i + 1) % nvars), -1.0) for i in range(nvars)]
    lt = LatticeTempering(edges, seed=0, device=mesh_device(mesh))
    for b in np.linspace(0.5, 1.5, R):
        lt.add_graph(1.0, 0.0, float(b))
    lt._materialize(ltau)
    shard_ladder(lt, mesh, axis=mesh.mesh_dim_names[0])
    esum, _ = lt._run(timesteps, swap_freq=1)
    return esum
