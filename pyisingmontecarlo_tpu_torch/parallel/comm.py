"""The collectives of the sharded paths: ring shifts and gathers along one mesh dimension.

The JAX modules move data with ``lax.ppermute`` (halo columns and slices,
ladder planes across a shard boundary) and let GSPMD gather a sharded array
into the global one (``np.asarray``). Here that is ``ring_shift``
(``dist.batch_isend_irecv`` with the dimension's ring neighbours) and
``gather_axis`` (``dist.all_gather``), both on the dimension's process group
of a ``DeviceMesh``. On a dimension of one rank neither issues a collective:
a shift returns the tensor itself, as ``ppermute`` does on one device (torch's
``isend`` to its own rank raises), and a gather returns the block, which is
then the global tensor, as GSPMD's gather of a one-device array is. On gloo each collective waits at most ``timeout``
seconds, so a hung rank fails instead of blocking; on NCCL the wait stays on
the stream and the group's own timeout applies.
"""

from __future__ import annotations

from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .mesh import DEFAULT_TIMEOUT, mesh_device

__all__ = ["MeshAxis", "ReplicaShard", "ring_shift", "gather_axis", "gather_tree"]


class MeshAxis:
    """One named dimension of a ``DeviceMesh`` as this rank sees it: its
    process group, its ``size``, this rank's ``index`` along it, the global
    ranks of its ring neighbours (``next`` at index + 1, ``prev`` at index -
    1, periodic) and the collectives' ``timeout``."""

    def __init__(self, mesh: DeviceMesh, name: str, timeout: float = DEFAULT_TIMEOUT):
        names = mesh.mesh_dim_names or ()
        if name not in names:
            raise ValueError(f"the mesh has no dimension {name!r} (it has {names})")
        coord = mesh.get_coordinate()
        if coord is None:
            raise ValueError("this rank is not in the mesh")
        d = names.index(name)
        self.name = name
        self.size = int(mesh.mesh.shape[d])
        self.index = int(coord[d])
        self.group = mesh.get_group(d)
        self.device = mesh_device(mesh)
        self.timeout = timedelta(seconds=timeout)

        def rank_at(i):
            c = list(coord)
            c[d] = i % self.size
            return int(mesh.mesh[tuple(c)])

        self.next, self.prev = rank_at(self.index + 1), rank_at(self.index - 1)

    def block_slice(self, length: int) -> slice:
        """This rank's ``[lo, hi)`` of ``length`` items split evenly; ``ValueError`` unless it divides."""
        if length % self.size:
            raise ValueError(f"{length} must be divisible by mesh axis '{self.name}' ({self.size})")
        n = length // self.size
        return slice(self.index * n, (self.index + 1) * n)

    def block(self, x, dim: int = 0):
        """This rank's block of ``x`` (a tensor or numpy array) along ``dim``."""
        sl = self.block_slice(x.shape[dim])
        return x[(slice(None),) * dim + (sl,)]


def _wait(work, axis: MeshAxis, timeout: Optional[float]):
    if dist.get_backend(axis.group) == "gloo":
        work.wait(timedelta(seconds=timeout) if timeout is not None else axis.timeout)
    else:
        work.wait()


def ring_shift(x: torch.Tensor, axis: Optional[MeshAxis], direction: int = 1,
               timeout: Optional[float] = None) -> torch.Tensor:
    """Send ``x`` to the neighbour at ``index + direction`` (periodic) and
    return what the neighbour at ``index - direction`` sent: ``ppermute`` with
    the pairs ``(i, i + direction)``. With no axis, or one rank on it, ``x``
    itself."""
    if axis is None or axis.size == 1:
        return x
    to, frm = (axis.next, axis.prev) if direction > 0 else (axis.prev, axis.next)
    x = x.contiguous()
    out = torch.empty_like(x)
    works = dist.batch_isend_irecv([dist.P2POp(dist.isend, x, to, axis.group),
                                    dist.P2POp(dist.irecv, out, frm, axis.group)])
    for w in works:
        _wait(w, axis, timeout)
    return out


def gather_axis(x: torch.Tensor, axis: Optional[MeshAxis], dim: int = 0,
                timeout: Optional[float] = None) -> torch.Tensor:
    """The global tensor from every rank's block ``x`` along ``dim``, in
    index order (``all_gather``), the same on every rank; with no axis, or one
    rank on it, ``x``."""
    if axis is None or axis.size == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(axis.size)]
    _wait(dist.all_gather(parts, x, group=axis.group, async_op=True), axis, timeout)
    return torch.cat(parts, dim)


def gather_tree(x, axis: Optional[MeshAxis], dim: int = 0):
    """``gather_axis`` on every tensor of a nested tuple or list; other leaves unchanged."""
    if isinstance(x, torch.Tensor):
        return gather_axis(x, axis, dim)
    if isinstance(x, (tuple, list)):
        return type(x)(gather_tree(v, axis, dim) for v in x)
    return x


class ReplicaShard:
    """The replica sharding of an ensemble: ``R`` replicas split in even
    blocks over the mesh dimension ``axis``; this rank keeps ``[lo, hi)``.
    ``ValueError`` unless the dimension divides R."""

    def __init__(self, mesh: DeviceMesh, axis: str, R: int):
        self.axis = MeshAxis(mesh, axis)
        self.R = int(R)
        if self.R % self.axis.size:
            raise ValueError(f"num_experiments ({self.R}) must be divisible by mesh axis '{axis}' "
                             f"({self.axis.size})")
        self.rows = self.axis.block_slice(self.R)

    def block(self, x):
        """This rank's replicas of a per-replica tensor or array (leading axis R)."""
        return x[self.rows]

    def gather(self, x):
        """The global per-replica results (tensors, nested) from this rank's block of them."""
        return gather_tree(x, self.axis)

    def take(self, x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
        """This rank's rows of ``x_global[perm]``, where ``x`` is this rank's
        block and ``perm`` a global permutation that moves no row by more
        than one: the rows that cross a block boundary come by ``ring_shift``."""
        lo = self.rows.start
        below = ring_shift(x[-1:], self.axis, 1)  # the last row of the block before
        above = ring_shift(x[:1], self.axis, -1)  # the first row of the block after
        ext = torch.cat([below, x, above])
        return ext[perm[self.rows] - (lo - 1)]
