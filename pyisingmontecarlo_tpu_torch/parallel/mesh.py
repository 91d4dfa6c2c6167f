"""Device meshes over ``torch.distributed``.

Counterpart of ``pyisingmontecarlo_tpu/parallel/mesh.py``. JAX is
single-controller: one process owns a ``Mesh`` of devices. The port is SPMD,
PyTorch's idiom: one process (a rank) per device, every rank building the
same ``DeviceMesh`` with named dimensions and keeping its own block of each
sharded array. NCCL is the backend for CUDA, gloo for the CPU; a rank on a
CUDA device needs a GPU of its own (NCCL refuses two ranks on one device, and
the port does not switch backend or device for it).
"""

from __future__ import annotations

import math
import os
from datetime import timedelta
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

__all__ = ["DEFAULT_TIMEOUT", "make_mesh", "replica_sharding", "init_distributed", "global_mesh", "mesh_device"]

DEFAULT_TIMEOUT = 120.0  # seconds: the process group's set-up and each collective


def init_distributed(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, backend: Optional[str] = None, *, device="cuda",
                     timeout: float = DEFAULT_TIMEOUT) -> None:
    """One call per process: ``torch.distributed.init_process_group``; a no-op
    when the group is already up.

    With no arguments it reads torchrun's environment (``WORLD_SIZE``,
    ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``); with none of
    that either, it starts a world of one process on an in-memory store.
    ``coordinator_address`` is ``host:port`` (TCP) or a URL such as
    ``file:///path``. ``backend`` defaults to NCCL for a CUDA ``device`` and
    gloo for the CPU. On CUDA the rank takes GPU ``LOCAL_RANK`` (or its rank)
    and raises where the host has no such GPU. ``timeout`` bounds every
    collective of the group."""
    if dist.is_initialized():
        return
    env = os.environ
    world = int(num_processes if num_processes is not None else env.get("WORLD_SIZE", 1))
    rank = int(process_id if process_id is not None else env.get("RANK", 0))
    dev = torch.device(device)
    if dev.type == "cuda":
        local = int(env.get("LOCAL_RANK", rank))
        have = torch.cuda.device_count()
        if local >= have:
            raise ValueError(f"rank {rank} (local rank {local}) needs a GPU of its own; this host has {have}")
        torch.cuda.set_device(local)
    kw = dict(backend=backend or ("nccl" if dev.type == "cuda" else "gloo"), world_size=world, rank=rank,
              timeout=timedelta(seconds=timeout))
    if coordinator_address is not None:
        kw["init_method"] = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    elif "MASTER_ADDR" in env:
        kw["init_method"] = "env://"
    elif world == 1:
        kw["store"] = dist.HashStore()
    else:
        raise ValueError(f"a world of {world} processes needs a coordinator_address or torchrun's environment")
    dist.init_process_group(**kw)


def make_mesh(shape: Tuple[int, ...], axis_names: Tuple[str, ...], device="cuda") -> DeviceMesh:
    """A ``DeviceMesh`` of the first ``prod(shape)`` ranks with the named
    dimensions, on ``device``'s type; raises ``ValueError`` when the world is
    smaller. Every rank of the world calls it (ranks past the mesh take no
    part in its runs). Starts a world of one process when none is up."""
    n = math.prod(shape)
    if not dist.is_initialized():
        init_distributed(device=device)
    world = dist.get_world_size()
    if world < n:
        raise ValueError(f"mesh {tuple(shape)} needs {n} ranks, have {world}")
    return DeviceMesh(torch.device(device).type, torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axis_names))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's blocks live on: its current GPU, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def replica_sharding(mesh: DeviceMesh, length: int, axis: str = "replica") -> slice:
    """This rank's ``[lo, hi)`` block of an array axis of ``length`` split over
    the mesh dimension ``axis`` (the port's form of the JAX package's
    ``NamedSharding(mesh, P(axis))``); ``ValueError`` unless it divides."""
    from .comm import MeshAxis

    return MeshAxis(mesh, axis).block_slice(int(length))


def global_mesh(replica_axis: str = "replica", per_host_axes: Tuple[Tuple[str, int], ...] = (),
                device="cuda") -> DeviceMesh:
    """A mesh over the whole world: the leading ``replica_axis`` takes what the
    trailing ``per_host_axes`` ((name, size) pairs) leave, e.g. 32 ranks with
    ``(("x", 2),)`` give a (16, 2) mesh; ``ValueError`` unless they divide the
    world."""
    if not dist.is_initialized():
        init_distributed(device=device)
    world = dist.get_world_size()
    inner = math.prod(s for _, s in per_host_axes)
    if world % inner:
        raise ValueError(f"{world} ranks not divisible by inner axes product {inner}")
    shape = (world // inner, *(s for _, s in per_host_axes))
    return make_mesh(shape, (replica_axis, *(n for n, _ in per_host_axes)), device=device)
