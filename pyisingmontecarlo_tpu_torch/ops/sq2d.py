"""Checkerboard Glauber sweeps on a uniform square torus: the kernel wrapper
and its plain PyTorch version.

Counterpart of ``pyisingmontecarlo_tpu/ops/sq2d_pallas.py``. The kernel is
``sq2d_tiled`` in ``csrc/sq2d.cu``; ``sweeps_2d`` launches it for a CUDA tensor
(or raises) and runs ``sweeps_2d_reference`` for a CPU tensor. Both take and
return spins as ``[R, L, L]`` int8 in {-1, +1}, L even and >= 4.

The kernel blocks in time: a launch runs up to K sweeps on each B x B tile
of each replica, held with a halo of ``HALO_PER_SWEEP * K`` sites in shared
memory, and phase j of a launch (j = 0 .. 2K-1) updates its color only where
a site is at least ``j + 1`` sites from the box's edge (``phase_margin``).
``sq2d_plan`` picks (B, K) by shape alone; the launches are ``ceil(T / K)``.

One sweep is two phases: phase 0 updates the sites with x+y even, phase 1
those with x+y odd. A site with spin s and neighbour sum B in {-4, ..., 4}
flips when its 31-bit draw u satisfies ``u <= thr[t, 5*(s > 0) + (B+4)/2]``,
where row t of the ``[T, 10]`` int32 table (``thresholds``) holds
``sigmoid(-beta_t * dE) * (2^31 - 1)`` for the ten values of
``dE = -2 s (J B + h)`` (Glauber acceptance; ``dE_values`` gives the order).

Randomness contract (replaces the TPU hardware PRNG of the JAX kernel):

- The draw for site (x, y) in sweep t, phase p is
  ``lane_draw31(seed_r, *make_pos_mix(0, x*(L/2) + y//2, 0), 2*(ctr0+t) + p)``:
  plane ``2t+p`` at packed column ``k = y//2`` in the layout that the JAX
  package's ``run_steps_2d_testbits`` consumes, so explicit random planes
  ``rb[2T, L, L/2]`` and hashed draws are interchangeable.
- ``ctr0`` counts the sweeps already run on these replicas within one
  ``run_*`` call, so thermalization followed by sampling continues the stream
  and never repeats it. ``ctr0 + T`` must stay below 2^30, which keeps every
  sweep counter below the one reserved for initial states
  (``lattice2d.random_states_2d``, counter ``0x7FFFFFFF``).
- A replica's trajectory therefore depends only on its own seed, and the
  kernel and the plain version give the same trajectory at any batch size.

The replicas are the kernel's grid y: a call of more than
``replicas.GRID_MAX`` runs in chunks of replicas (``replicas.replica_chunks``),
each on views of the same tensors, with the plan of the whole shape.
"""

from __future__ import annotations

from typing import Optional

import functools

import numpy as np
import torch

from .. import _kernels
from .lanerng import lane_draw31, make_pos_mix
from .replicas import gather_chunks, replica_chunks, rows

__all__ = [
    "dE_values",
    "thresholds",
    "pack_checkerboard",
    "unpack_checkerboard",
    "sweeps_2d",
    "sweeps_2d_reference",
    "sq2d_plan",
    "tiled_bytes",
    "phase_margin",
]

_I31_MAX = 2**31 - 1
_CTR_LIMIT = 2**30
_L_MAX = 65535  # L at most this keeps x * L/2 an int32

# The tiled kernel's schedule and the plan's choices (csrc/sq2d.cu)
TILED_THREADS = 256
HALO_PER_SWEEP = 2  # a launch of K sweeps reads a halo of 2K sites around its tile
TILE_STEP = 8  # tile sides are multiples of 8 (and the box's side w = B + 4K too)
TILE_MAX = 256
SWEEPS_PER_LAUNCH = (2, 4, 8)  # the K the plan takes; even, so that 2K is a multiple of 4
# The plan's rule, read off (B, K) grids timed on an H100 (1024^2 x 1 and x 8, 1000^2 x 8,
# 2048^2 x 8, 256^2 x 64, and 1024^2 x 8 with random planes): the largest tiles whose blocks fill the
# card, where one block an SM keeps it busy and the card counts as full at PLAN_FILL of its SMs; draws
# read from random planes in HBM need PLAN_RB_BLOCKS_PER_SM blocks an SM to hide their loads. A launch
# runs 8 sweeps on tiles of PLAN_K8_TILE or more (a halo of 16 adds 27% to such a tile's updates, as a
# halo of 8 does to a tile of 128), and with random planes (a cheaper row loop, so the launches weigh
# more); else 4.
PLAN_FILL = 0.9
PLAN_RB_BLOCKS_PER_SM = 4
PLAN_K8_TILE = 256


def phase_margin(j: int) -> int:
    """Phase j of a launch (0 .. 2K-1) updates its color at the box sites at
    least this far from the box's edge: their neighbours were exact after
    phase j - 1, so after 2K phases the tile, ``HALO_PER_SWEEP * K`` sites in,
    is exact."""
    return j + 1


def tiled_bytes(B: int, K: int) -> int:
    """Shared memory of a block of the tiled kernel (``tiled_bytes`` of
    ``csrc/sq2d.cu``): the E and O planes of the box, ``w`` rows of ``w/2``
    bytes padded to 16; ``K`` threshold rows; the box's packed-column and row
    keys (int32)."""
    w = B + 2 * HALO_PER_SWEEP * K
    pitch = -(-(w // 2) // 16) * 16
    return 2 * w * pitch + 4 * (-(-10 * K // 4) * 4) + 4 * (-(-(w // 2) // 4) * 4) + 4 * w


@functools.lru_cache(maxsize=256)
def sq2d_plan(L: int, R: int, limit: int, sms: int, rb: bool = False) -> Optional[tuple]:
    """``(B, K, w, bytes)`` of the tiled kernel for ``R`` replicas of an
    ``L x L`` torus on a card of ``sms`` SMs with ``limit`` bytes of opt-in
    shared memory per block: tile side B (a multiple of ``TILE_STEP`` up to
    ``TILE_MAX``), sweeps per launch K, box side ``w = B + 4K`` and the
    block's shared memory; None when nothing fits. The fewest tiles a side,
    n, whose ``R * n^2`` blocks fill the card (``PLAN_FILL``; ``rb``: the
    draws read from random planes), each tile the least multiple of
    ``TILE_STEP`` that n of cover L; else the smallest tile, which makes the
    most blocks. K is 8 with ``rb`` or from ``PLAN_K8_TILE`` up, else 4, or
    less where that box does not fit. Shape and mode only, cached; the
    wrapper never falls back from a failed launch."""
    want = PLAN_FILL * sms * (PLAN_RB_BLOCKS_PER_SM if rb else 1)
    last = None
    for n in range(1, -(-L // TILE_STEP) + 1):
        B = -(-(-(-L // n)) // TILE_STEP) * TILE_STEP  # ceil(L / n), rounded up to a multiple of TILE_STEP
        if B > TILE_MAX or (last and B == last[0]):
            continue
        for K in (8, 4, 2) if rb or B >= PLAN_K8_TILE else (4, 2):
            w = B + 2 * HALO_PER_SWEEP * K
            nbytes = tiled_bytes(B, K)
            if nbytes <= limit and w // 8 + 1 <= TILED_THREADS:
                last = (B, K, w, nbytes)
                if R * (-(-L // B)) ** 2 >= want:
                    return last
                break
    return last


def dE_values(j: float, h: float) -> np.ndarray:
    """dE for flipping spin s with neighbour sum B: dE = -2 s (J B + h), as
    f32. Order: s=-1 with B in (-4,-2,0,2,4), then s=+1 with the same B."""
    out = np.empty(10, np.float32)
    for si, s in enumerate((-1.0, 1.0)):
        for bi, B in enumerate((-4.0, -2.0, 0.0, 2.0, 4.0)):
            out[si * 5 + bi] = -2.0 * s * (j * B + h)
    return out


def thresholds(beta_arr, j: float, h: float) -> torch.Tensor:
    """Per-sweep betas ``[T]`` -> ``[T, 10]`` int32 Glauber thresholds, on the CPU.

    Computed in f32 as the JAX kernel does (``sigmoid(-beta * dE) * 2147483647.0``),
    then clamped to [0, 2^31 - 1] before the int32 cast: the product reaches 2^31
    where the sigmoid saturates, which JAX's cast saturates but torch's does not.
    ``torch.sigmoid`` differs from ``jax.nn.sigmoid`` by a few ulps on a small share
    of inputs, so rows can differ from JAX's by a few hundred. Each distinct beta
    is evaluated once."""
    b = np.asarray(beta_arr, np.float32).reshape(-1)
    ub, inv = np.unique(b, return_inverse=True)
    x = torch.from_numpy(-ub)[:, None] * torch.from_numpy(dE_values(j, h))[None, :]
    p = torch.sigmoid(x) * 2147483647.0
    table = p.to(torch.float64).clamp_(0, _I31_MAX).to(torch.int32)
    return table[torch.from_numpy(inv.astype(np.int64))].contiguous()


def pack_checkerboard(s: torch.Tensor):
    """``s[R, L, L]`` -> ``(E, O)``, each ``[R, L, L/2]``: E holds the x+y even
    sites at column ``k = y//2``, O the x+y odd ones."""
    R, L, _ = s.shape
    pairs = s.reshape(R, L, L // 2, 2)
    row_even = (torch.arange(L, device=s.device) % 2 == 0)[None, :, None]
    E = torch.where(row_even, pairs[..., 0], pairs[..., 1])
    O = torch.where(row_even, pairs[..., 1], pairs[..., 0])
    return E, O


def unpack_checkerboard(E: torch.Tensor, O: torch.Tensor) -> torch.Tensor:
    """Inverse of ``pack_checkerboard`` over the trailing ``[L, W]`` dims."""
    L, W = E.shape[-2], E.shape[-1]
    row_even = (torch.arange(L, device=E.device) % 2 == 0)[:, None]
    p0 = torch.where(row_even, E, O)
    p1 = torch.where(row_even, O, E)
    return torch.stack([p0, p1], dim=-1).reshape(*E.shape[:-1], 2 * W)


def _check(s, seeds_i32, thr, ctr0, rb, samples):
    """Validate the arguments shared by the kernel and the plain version;
    returns (R, L, T)."""
    if s.dtype != torch.int8 or s.dim() != 3 or s.shape[1] != s.shape[2]:
        raise ValueError(f"s must be [R, L, L] int8, got {tuple(s.shape)} {s.dtype}")
    R, L, _ = s.shape
    if L < 4 or L % 2:
        raise ValueError(f"L must be even and >= 4, got {L}")
    if L > _L_MAX:
        raise ValueError(f"L must be <= {_L_MAX}, got L={L}")
    if seeds_i32.dtype != torch.int32 or tuple(seeds_i32.shape) != (R,):
        raise ValueError(f"seeds_i32 must be [{R}] int32, got {tuple(seeds_i32.shape)} {seeds_i32.dtype}")
    if thr.dtype != torch.int32 or thr.dim() != 2 or thr.shape[1] != 10:
        raise ValueError(f"thr must be [T, 10] int32, got {tuple(thr.shape)} {thr.dtype}")
    T = thr.shape[0]
    ctr0 = int(ctr0)
    if ctr0 < 0 or ctr0 + T >= _CTR_LIMIT:
        raise ValueError(f"sweep counters ctr0={ctr0} .. ctr0+T={ctr0 + T} must lie in [0, 2^30)")
    if rb is not None and (rb.dtype != torch.int32 or tuple(rb.shape) != (2 * T, L, L // 2)):
        raise ValueError(f"rb must be [{2 * T}, {L}, {L // 2}] int32, got {tuple(rb.shape)} {rb.dtype}")
    if samples is not None and int(samples) < 1:
        raise ValueError(f"samples (the sampling period in sweeps) must be >= 1, got {samples}")
    for name, t in (("s", s), ("seeds_i32", seeds_i32), ("thr", thr), ("rb", rb)):
        if t is None:
            continue
        if t.device != s.device:
            raise ValueError(f"{name} is on {t.device}, s on {s.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return R, L, T


def sweeps_2d_reference(s, seeds_i32, thr, ctr0, rb=None, samples=None):
    """Plain PyTorch version of ``sweeps_2d``: same arguments, same result."""
    R, L, T = _check(s, seeds_i32, thr, ctr0, rb, samples)
    W = L // 2
    dev = s.device
    s = s.clone()
    flat = s.view(R, L * L)
    x = torch.arange(L, device=dev)[:, None]
    k = torch.arange(W, device=dev)[None, :]
    # flat site index of packed column k of row x, for each phase; the packed
    # index x*W + k is the draw position
    sites = [(x * L + 2 * k + (x + p) % 2).reshape(-1) for p in (0, 1)]
    pos1, pos2 = make_pos_mix(torch.zeros(1, dtype=torch.int64, device=dev), torch.arange(L * W, device=dev), 0)
    seed = seeds_i32[:, None]
    stack = torch.empty((R, T // samples, L, L), dtype=torch.int8, device=dev) if samples else None
    for t in range(T):
        row = thr[t]
        for p in (0, 1):
            s32 = s.to(torch.int32)
            B = s32.roll(1, 1) + s32.roll(-1, 1) + s32.roll(1, 2) + s32.roll(-1, 2)
            sv = s32.view(R, L * L)[:, sites[p]]
            Bv = B.view(R, L * L)[:, sites[p]]
            tv = row[5 * (sv > 0) + (Bv + 4) // 2]
            if rb is not None:
                u = rb[2 * t + p].reshape(1, -1)
            else:
                u = lane_draw31(seed, pos1, pos2, 2 * (ctr0 + t) + p)
            flat[:, sites[p]] = torch.where(u <= tv, -sv, sv).to(torch.int8)
        if samples and (t + 1) % samples == 0:
            stack[:, (t + 1) // samples - 1] = s
    return (s, stack) if samples else s


def _run_tiled(s, seeds_i32, thr, ctr0, rb, samples, plan):
    """The tiled kernel on CUDA tensors (``ceil(T / K)`` launches a chunk of
    replicas, ``replica_chunks``, counted in ``sweeps_2d.launches``) with
    ``plan = (B, K, ...)`` from ``sq2d_plan``; returns ``(state, stack or
    None)``. The launches alternate between two new buffers, and the last
    writes the one returned; ``s`` is only read."""
    R, L, _ = s.shape
    T = thr.shape[0]
    stack = torch.empty((R, T // samples, L, L), dtype=torch.int8, device=s.device) if samples else None
    if not (R and T):
        return s.clone(), stack
    B, K = plan[0], plan[1]
    n = -(-T // K)
    out = torch.empty_like(s)
    tmp = torch.empty_like(s) if n > 1 else None
    with torch.cuda.device(s.device):
        for a, b in replica_chunks(R, L * L, "sq2d"):
            _kernels.call("sq2d tiled kernel", lambda lib: lib.sq2d_tiled_sweeps(
                rows(s, a, b), rows(out, a, b), rows(tmp, a, b), rows(seeds_i32, a, b), thr.data_ptr(),
                None if rb is None else rb.data_ptr(), rows(stack, a, b), b - a, L, T, int(ctr0), int(samples or 0),
                0 if stack is None else stack.shape[1], B, K, _kernels.stream(s)))
            sweeps_2d.launches += n
    return out, stack


def sweeps_2d(
    s: torch.Tensor,
    seeds_i32: torch.Tensor,
    thr: torch.Tensor,
    ctr0: int,
    rb: Optional[torch.Tensor] = None,
    samples: Optional[int] = None,
):
    """Run ``T = thr.shape[0]`` sweeps on ``s[R, L, L]`` int8; returns the new
    state (``s`` itself is not modified).

    ``seeds_i32[R]`` int32 keys each replica's draws and ``ctr0`` is the sweep
    offset of the randomness contract above. ``rb[2T, L, L/2]`` int32, when
    given, supplies the draws of every replica instead (plane ``2t+p`` for
    sweep t, phase p, packed layout; hashed draws lie in [0, 2^31), but the
    kernel compares any int32 draw with any int32 threshold exactly).
    ``samples``, when given, is a sampling period: the state after every
    ``samples`` sweeps is staged into a ``[R, T // samples, L, L]`` int8
    stack, and ``(state, stack)`` is returned.

    A CUDA tensor launches the tiled kernel of ``csrc/sq2d.cu`` with
    ``sq2d_plan``'s (B, K) for the shape and mode (``ceil(T / K)`` launches a
    chunk of at most ``replicas.GRID_MAX`` replicas, counted in
    ``sweeps_2d.launches``) or raises; a CPU tensor runs the plain version,
    in the same chunks."""
    R, L, T = _check(s, seeds_i32, thr, ctr0, rb, samples)
    if s.device.type == "cpu":
        def run(a, b):
            got = sweeps_2d_reference(s[a:b], seeds_i32[a:b], thr, ctr0, rb, samples)
            return got if samples else (got,)

        got = gather_chunks(R, replica_chunks(R, L * L, "sq2d"), run)
        return got if samples else got[0]
    if s.device.type != "cuda":
        raise ValueError(f"sweeps_2d runs on cuda or cpu tensors, got {s.device}")
    plan = sq2d_plan(L, R, *_kernels.device_limits(s.device), rb is not None)
    if plan is None:
        raise ValueError(f"no tile of the sq2d kernel fits L={L} on {s.device}")
    out, stack = _run_tiled(s, seeds_i32, thr, ctr0, rb, samples, plan)
    return (out, stack) if samples else out


sweeps_2d.launches = 0
