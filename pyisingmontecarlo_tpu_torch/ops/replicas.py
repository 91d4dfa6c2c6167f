"""The replica axis of the kernel wrappers: the most replicas one launch of
each route takes, and the split of a call's replicas into launches below it.

The JAX package's kernels put the replicas on a grid of programs and take
any count. The port's launches put them on a CUDA grid axis, whose y and z
extents stop at 65,535 and whose x extent stops at 2^31 - 1, and a few
kernels index a per-replica array with a 32-bit int. A wrapper therefore
chooses its route and plan once, from the whole shape, and then launches that
route on contiguous views of replicas ``[a, b)`` for each chunk of
``replica_chunks``. A replica's draws depend only on its own seed and on
replica-local positions and counters, so a chunk launched alone gives the
bits it gives among the rest; under the limits there is one chunk and the
launches are those of an unsplit call.

The limits, read from ``csrc/``:

- ``GRID_MAX``: replicas on a grid's y or z axis: ``sq2d_tiled`` (y,
  ``sq2d.cu``), ``wl_site``, ``wl_cluster``, ``wl_accumulate``,
  ``ladder_site``, ``ladder_cluster`` and ``fk_long_*`` (z; ``site_grid``,
  ``fk_grid``, ``fk_long_grid`` in ``worldline.cuh``, ``acc_grid`` in
  ``wl.cu``).
- ``GRID_X_MAX``: grid x, which holds the replicas of the resident kernels
  and ``tiles * R`` blocks of ``wl_tiled``.
- ``ACC_MAX``: ``wl_resident`` and ``wl_tiled`` add to ``acc + 3 * r + k``
  with an int ``r`` (``wl.cu``).
- ``LONG_SPINS``: a launch of ``fk_long_*`` keeps its lines in scratch of
  about 2.3 bytes a spin (``fk_long_bytes``, ``worldline.cuh``); fewer than
  2^31 spins a launch keep it to about 5 GB, beside a state of twice 2 GiB.

Every other offset over the replica axis is 64-bit (``size_t``) in the
kernels; none of them counts spins in an int.
"""

from __future__ import annotations

import torch

__all__ = ["GRID_MAX", "GRID_X_MAX", "ACC_MAX", "LONG_SPINS", "ROUTES", "launch_replicas", "replica_chunks",
           "gather_chunks", "rows"]

GRID_MAX = 65535
GRID_X_MAX = 2**31 - 1
ACC_MAX = 2**31 // 3
LONG_SPINS = 2**31
# sq2d: sq2d_tiled; wl_resident, ladder_resident, wl_tiled: those kernels;
# multi: the multi-launch kernels with the cluster phase in one block; long:
# the multi-launch kernels with fk_long_*, the strictest, which the plain
# versions on the CPU take
ROUTES = ("sq2d", "wl_resident", "ladder_resident", "wl_tiled", "multi", "long")


def launch_replicas(route: str, per_replica: int, tiles: int = 1) -> int:
    """The most replicas of ``per_replica`` spins that one launch of
    ``route`` takes (``tiles``: the blocks a replica of ``wl_tiled``)."""
    if route in ("sq2d", "multi"):
        return GRID_MAX
    if route == "long":
        return max(1, min(GRID_MAX, (LONG_SPINS - 1) // per_replica))
    if route == "wl_resident":
        return min(GRID_X_MAX, ACC_MAX)
    if route == "ladder_resident":
        return GRID_X_MAX
    if route == "wl_tiled":
        return max(1, min(GRID_X_MAX // tiles, ACC_MAX))
    raise ValueError(f"unknown route {route!r}; one of {ROUTES}")


def replica_chunks(R: int, per_replica: int, route: str, tiles: int = 1) -> list:
    """``[(a, b), ...]``: the fewest chunks of ``[0, R)``, in order, whose
    launches on ``route`` keep its limits (``launch_replicas``), their sizes
    within one of each other (the larger first); none for ``R = 0``."""
    most = launch_replicas(route, per_replica, tiles)
    n = -(-R // most)
    out, a = [], 0
    for c in range(n):
        b = a + R // n + (c < R % n)
        out.append((a, b))
        a = b
    return out


def rows(t, a: int, b: int):
    """The address of rows ``[a, b)`` of ``t`` for a launch (None for None)."""
    return None if t is None else t[a:b].data_ptr()


def gather_chunks(R: int, chunks: list, run):
    """``run(a, b)`` for each chunk: a tuple of tensors with a leading axis of
    ``b - a`` replicas, written into rows ``[a, b)`` of one tensor each of
    ``R`` rows (their dtype and device those of the first chunk's); returns
    the tuple. One chunk or none: ``run(0, R)`` itself."""
    if len(chunks) < 2:
        return run(0, R)
    out = None
    for a, b in chunks:
        got = run(a, b)
        if out is None:
            out = tuple(torch.empty((R, *x.shape[1:]), dtype=x.dtype, device=x.device) for x in got)
        for o, x in zip(out, got):
            o[a:b] = x
    return out
