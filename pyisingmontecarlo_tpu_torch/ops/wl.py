"""Trotterized TFIM worldline sweeps on a uniform periodic ring or square
torus: the kernel wrapper, its plain PyTorch version, and the host side
around them.

Counterpart of ``pyisingmontecarlo_tpu/ops/wl_pallas.py``. The kernel is
``csrc/wl.cu``; ``wl_sweeps`` launches it for a CUDA tensor (or raises) and
runs ``wl_sweeps_reference`` for a CPU tensor. Spins are ``s[R, nvars, L]``
int8 in {-1, +1} (site i of replica r at Trotter slice tau is ``s[r, i, tau]``),
as at the JAX package's public functions.

One sweep, for sweep index t (counting from 0 within one dispatch chunk):

1. four site phases, one per (site color, tau parity), draw ``d = 0..3``
   (``2*color + parity``; the multi-launch kernels run both parities of a
   color in one launch, the odd slices after the even ones):
   Glauber acceptance ``u <= thr[15*(s > 0) + 3*(B/2 + 2) + (s_up + s_dn)/2 + 1]``,
   with B the spatial neighbour sum and ``thr`` the 30-entry int31 table of
   ``site_tables``;
2. two Fortuin-Kasteleyn cluster phases along the tau rings of each color,
   draws ``d = 4, 5`` (color 0) and ``6, 7`` (color 1): bond (tau, tau+1) is
   frozen when aligned and its draw ``u < pb``; a forward segmented sum of the
   f32 diagonal dE by pointer doubling gives each cluster's dE at its head;
   the head flips its cluster when ``log((u + 0.5) / 2^31) < -dE``; the decision
   propagates forward by pointer doubling. A fully frozen ring is one cluster
   headed at tau = 0, whose dE is the sum of the whole line in the order of
   ``xla_sum_last``;
3. accumulation of three exact integer statistics: bond products over the
   outgoing bonds, spins, and aligned time bonds.

Three routes on the card, chosen by shape alone (``choose_route``): the
resident kernel (one launch per call, one block per replica with its plane in
shared memory) where the plane and a cluster tile fit the card's opt-in
shared memory per block and the SMs its last wave leaves idle cost less than
the tiled route's redundant halo work (``resident_plan``,
``RESIDENT_IDLE_SITES_TILED``); else the tiled kernel (one launch per sweep,
one block per spatial tile of a replica with the tile and its halo in shared
memory) where a tile of at least ``TILE_MIN`` sites a side fits
(``tiled_plan``); else the multi-launch kernels (five launches a sweep: both
tau parities of a color in one site launch; a line too long for one block's
shared memory, ``cluster_long``, takes the two ``fk_long_*`` launches a
color, ``fk_long_sums`` and ``fk_long_apply``, in place of its cluster
launch). The resident and tiled routes take
lines up to ``MAX_LTAU`` slices, the multi-launch route every line the gate
admits, as the JAX kernel does (up to 2^22 spins a replica). All three equal
the plain version bit for bit. Each takes any replica count: the route and
its plan are chosen from the whole shape, and its launches run on chunks of
replicas below the route's limits (``replicas.replica_chunks``).

Randomness: the draw ``d`` of sweep t at (tau, i) is
``lane_draw31(seed_r, pos = tau*nvars + i, ctr = 8*t + d)``. A run longer than
the JAX kernel's exactness bound is split into dispatch chunks
(``chunk_plan``); chunk c > 0 re-keys each replica with
``seed ^ (0x9E3779B9 * c)`` and restarts t at 0. The port's accumulators are
int64 and need no such bound; it keeps the schedule so that its trajectories
are the JAX kernel's at any run length.

Numerics that must match the JAX kernel bit for bit: the thresholds, the
cluster dE table and pb are f64 math cast once on the host (``site_tables``,
``bond_threshold``), never redone on the device; the f32 additions of the
pointer doubling and of a frozen ring's total keep the JAX order; the log is
f32 ``log``. The one known source of rare differences is the last ulp of f32
``log``, which can differ between libraries and moves a decision only when
``-dE`` falls between the two results.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import _kernels
from .lanerng import lane_draw31, make_pos_mix
from .replicas import gather_chunks, replica_chunks, rows

__all__ = [
    "WlTables",
    "site_tables",
    "bond_threshold",
    "coupling_params",
    "make_tables",
    "lattice_fns",
    "gate",
    "fk_line_bytes",
    "cluster_long",
    "resident_bytes",
    "resident_plan",
    "tiled_bytes",
    "tiled_plan",
    "choose_route",
    "dispatch_bound",
    "chunk_plan",
    "chunk_seeds",
    "xla_sum_last",
    "fk_flips",
    "wl_sweeps",
    "wl_sweeps_reference",
    "run_wl_sweeps",
    "run_wl_sample",
]

DRAWS_PER_SWEEP = 8
LAUNCHES_PER_SWEEP = 5  # multi-launch route: 2 site launches (both parities of a color each), 2 cluster, 1 accumulation
# and where the line takes fk_long_* (cluster_long): 3 of those launches a
# sweep (2 site, 1 accumulation), counted in wl_sweeps.launches, and
# LONG_LAUNCHES_PER_SWEEP fk_long_* launches (2 a color: fk_long_sums,
# fk_long_apply), in wl_sweeps.long_launches
LONG_LAUNCHES_PER_SWEEP = 4
MAX_LTAU = 4096  # the resident and tiled routes' longest line (csrc/worldline.cuh, kMaxL)
# the JAX kernel's gate (wl_pallas._MAX_PLANE_BYTES_LARGE): one replica's
# int32 plane of nvars * L_tau
MAX_PLANE_BYTES = 16 * 1024 * 1024
RESIDENT_THREADS = 1024  # threads of a resident block (csrc/resident.cuh, kResThreads)
WL_PARAM_BYTES = 30 * 4 + 10 * 4  # the resident block's thr and cde
# The resident route runs one replica per SM (a block of 1024 threads, one
# per SM by registers), so a launch takes ceil(R / SMs) waves and leaves the
# SMs of its last wave that hold no replica idle. The multi-launch route
# spreads every replica's lines over all SMs, and has a floor set by its
# serial cluster walk. On an H100 a resident site costs about what 132
# replicas' sites cost the multi-launch route, and the floor is worth about
# 1150 resident sites (the gate's edges timed on the card, tori of
# 24^2 to 48^2 at L_tau = 40 and R = 16, 64, 264; PERF.md). So the resident
# route is the faster while the sites its idle SMs could have swept,
# ``nvars * (ceil(R / SMs) - R / SMs)``, stay within this many.
RESIDENT_IDLE_SITES = 1150
# Against the tiled route, which fills the SMs whatever R is, the resident
# route wins only with fewer idle sites: the gate's edges on an H100 (tori of
# 24^2 to 48^2 at L_tau = 40 and R = 16, 64, 132, 264, and the 256-chain;
# PERF.md) had it faster at 297 idle sites and below (a 24^2 torus at R = 64)
# and slower at 506 to 528 (24^2 at R = 16, 32^2 at R = 64). choose_route
# takes this threshold for the worldline; every shape whose plane fits a
# resident block but no tile does has a side under 17 sites, so fewer idle
# sites than either threshold. The ladder, which has no tiled route, keeps
# RESIDENT_IDLE_SITES.
RESIDENT_IDLE_SITES_TILED = 400
# The tiled route (csrc/tiled.cuh): blocks of TILE_THREADS threads, each
# holding a tile of B x B sites (a ring: B sites) and a halo of TILE_HALO =
# (below, above) sites in each direction; phase p of a sweep (four site
# phases by (color, parity), then the cluster phases of colors 0 and 1)
# updates the sites of its color whose rank is at most TILE_RANKS[p], the rank
# of a box site being the larger over the directions of 0 inside the tile, 1
# in the first ring above it, and r + 1 in the r-th ring below and in the
# (r + 1)-th above. The tile side is a multiple of TILE_STEP, TILE_MIN at
# least, and the box fits the side (no site twice in one box) and the card's
# opt-in shared memory per block.
TILE_THREADS = 512
TILE_HALO = (4, 5)
TILE_RANKS = (4, 4, 3, 3, 2, 1)
TILE_MIN = TILE_STEP = 8
TILE_QUEUE = 6  # clusters per line walk whose decisions wait for the walk's end (csrc/tiled.cuh)
TILE_BLOCKS_PER_SM = 2  # csrc/wl.cu: __launch_bounds__(TILE_THREADS, 2)
_SMEM_RESERVED = 1024  # shared memory the card reserves per block
_INT_LIMIT = 2**31
# the JAX kernel's dispatch plan: planes of more than 2 MiB (int32) use its
# row accumulators, whose exactness bound is 2^23 / (2 L) sweeps per dispatch
_ROW_PLANE_BYTES = 2 * 1024 * 1024
_EXACT = 1 << 23
_CHUNK_SEED_STEP = 0x9E3779B9
_LOG_SCALE = 1.0 / 2147483648.0


class WlTables(NamedTuple):
    """What a sweep needs besides the state and the seeds: the lattice
    (``kind`` "ring" or "torus", ``size`` = ring length or torus side,
    ``nvars``, ``ltau``) and the acceptance tables, on the state's device."""

    kind: str
    size: int
    nvars: int
    ltau: int
    thr: torch.Tensor  # [30] int32 site-phase Glauber thresholds
    cde: torch.Tensor  # [10] f32 cluster-phase diagonal dE per site
    pb: int  # int31 bond-freezing threshold


def coupling_params(beta: float, gamma: float, ltau: int):
    """``(dtau, a, ktau)``: the Trotter step, ``dtau * gamma`` and the
    time-like coupling ``-1/2 log tanh(a)``, in f64 as the JAX kernel's host."""
    dtau = float(beta) / ltau
    a = dtau * float(gamma)
    ktau = -0.5 * math.log(math.tanh(a))
    return dtau, a, ktau


def site_tables(j: float, h: float, dtau: float, ktau: float):
    """``(thr [30] int32, cde [10] f32)``: Glauber thresholds of the site
    phase, indexed ``[s > 0][B/2 + 2][ud/2 + 1]`` (B the +-1 spatial neighbour
    sum, ud = s_up + s_down), and the cluster phase's per-site dE, indexed
    ``[s > 0][B/2 + 2]``. f64 math then one cast, as ``_site_tables``."""
    thr = np.empty(30, np.int32)
    for si, s in enumerate((-1.0, 1.0)):
        for bi, bsum in enumerate((-4.0, -2.0, 0.0, 2.0, 4.0)):
            for ui, ud in enumerate((-2.0, 0.0, 2.0)):
                dE = -2.0 * s * (dtau * (j * bsum + h) - ktau * ud)
                pacc = 1.0 / (1.0 + math.exp(min(dE, 60.0)))
                thr[si * 15 + bi * 3 + ui] = np.int32(pacc * 2147483647.0)
    cde = np.empty(10, np.float32)
    for si, s in enumerate((-1.0, 1.0)):
        for bi, bsum in enumerate((-4.0, -2.0, 0.0, 2.0, 4.0)):
            cde[si * 5 + bi] = -2.0 * s * dtau * (j * bsum + h)
    return thr, cde


def bond_threshold(ktau: float) -> int:
    """int31 threshold of ``p_bond = 1 - exp(-2 ktau)``: a bond freezes when its draw is below it."""
    return int(np.int32((1.0 - math.exp(-2.0 * ktau)) * 2147483647.0))


def make_tables(dense, nvars: int, beta: float, gamma: float, h: float, ltau: int,
                device="cpu") -> WlTables:
    """The tables of one (lattice, beta, gamma, h, L_tau) on ``device``."""
    kind, size, j = dense
    dtau, _, ktau = coupling_params(beta, gamma, ltau)
    thr, cde = site_tables(float(j), float(h), dtau, ktau)
    return WlTables(kind, int(size), int(nvars), int(ltau), torch.from_numpy(thr).to(device),
                    torch.from_numpy(cde).to(device), bond_threshold(ktau))


def gate(dense, nvars: int, ltau: int, R: int = 1) -> Optional[str]:
    """None when the kernel takes this shape, else the reason it does not:
    a uniform ring or torus (``dense``), L_tau even and at least 4, an even
    number of sites (an even torus side), and a replica's int32 plane of
    ``nvars * L_tau`` within ``MAX_PLANE_BYTES``: the JAX kernel's gate,
    which reads no replica count. ``R`` is not read either: the wrapper
    splits any R into launches (``replicas.replica_chunks``)."""
    if dense is None:
        return "the graph is not a uniform periodic ring or square torus"
    kind, size, _ = dense
    if kind not in ("ring", "torus"):
        return f"unknown lattice kind {kind!r}"
    if ltau < 4 or ltau % 2:
        return f"L_tau={ltau} is not even and at least 4"
    if nvars % 2 or nvars < 4 or (kind == "torus" and (size % 2 or size * size != nvars)):
        return f"{kind} of {nvars} sites (size {size}) is not even"
    if kind == "ring" and size != nvars:
        return f"ring size {size} != nvars {nvars}"
    if nvars * ltau * 4 > MAX_PLANE_BYTES:
        return f"a replica's int32 plane of {nvars} x {ltau} exceeds {MAX_PLANE_BYTES} bytes"
    return None


def fk_line_bytes(ltau: int) -> int:
    """Shared memory of one line of the multi-launch cluster phase's group
    (``csrc/worldline.cuh``, ``fk_line_bytes``): about 8.6 bytes a slice."""
    return (276 * (-(-ltau // 32)) + 4 + 15) & ~15


def cluster_long(ltau: int, limit: int) -> bool:
    """Whether the multi-launch cluster phase takes ``fk_long_*`` (the line in
    global memory, two launches a color) at ``ltau`` on a card of ``limit``
    bytes of opt-in shared memory per block (``csrc/worldline.cuh``,
    ``fk_long``): where one line's buffers pass one block, or its frozen sum
    would pass two levels of XLA's windows (32,768 slices); past 26,944
    slices on an H100."""
    return fk_line_bytes(ltau) > limit or ltau > 32 * 32 * 32


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


def resident_bytes(nvars: int, ltau: int, param_bytes: int, tile: int) -> int:
    """Shared memory of a resident block (``csrc/resident.cuh``, ``res_layout``):
    the int8 plane, the neighbour and site tables, ``param_bytes`` of the
    kernel's parameters, reductions, and a cluster tile of ``tile`` lines
    (11 bytes per (line, tau); per line 5 bytes and two masks of
    ``ceil(L_tau / 32)`` words), each region 16-byte aligned."""
    a, P = _align16, tile * ltau
    return (a(nvars * ltau) + a(8 * nvars) + a(2 * nvars) + a(param_bytes) + 16 + a(4 * tile) + a(tile)
            + a(8 * tile * (-(-ltau // 32))) + 2 * a(4 * P) + 3 * a(P))


@functools.lru_cache(maxsize=256)
def resident_plan(nvars: int, ltau: int, R: int, param_bytes: int, limit: int, sms: int,
                  idle_sites: Optional[int] = RESIDENT_IDLE_SITES) -> Optional[tuple]:
    """``(tile, bytes)`` of the resident kernel for ``R`` replicas of
    ``[nvars, ltau]`` on a card of ``sms`` SMs, or None: the shape takes it
    when ``nvars * (ceil(R / sms) - R / sms)``, the sites its last wave's idle
    SMs could have swept, is at most ``idle_sites`` (None: any), and the
    plane and a cluster tile of at least one line per thread (or every line
    of a color) fit in ``limit`` bytes, the card's opt-in shared memory per
    block. The tile is the most lines that fit, split evenly over the color's
    lines; no line longer than ``MAX_LTAU``. Shape only (cached per shape:
    the tempering loop asks once a sweep); the wrappers never fall back from a
    failed launch."""
    if ltau > MAX_LTAU:
        return None
    if idle_sites is not None and nvars * (-(-R // sms) * sms - R) > idle_sites * sms:
        return None
    lines = nvars // 2
    least = min(lines, -(-RESIDENT_THREADS // ltau))
    if lines < 1 or resident_bytes(nvars, ltau, param_bytes, least) > limit:
        return None
    lo, hi = least, lines  # the largest tile that fits
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if resident_bytes(nvars, ltau, param_bytes, mid) <= limit:
            lo = mid
        else:
            hi = mid - 1
    tiles = -(-lines // lo)
    tile = -(-lines // tiles)
    return tile, resident_bytes(nvars, ltau, param_bytes, tile)


def tiled_bytes(kind: str, B: int, ltau: int, param_bytes: int = WL_PARAM_BYTES) -> int:
    """Shared memory of a tiled block (``csrc/tiled.cuh``, ``tile_layout``) for
    tiles of side ``B``: the box's int8 plane, its sites' global indices
    (int32) and their list by (color, rank) (uint16), the list builder's
    bucket offsets and per-warp counts, ``param_bytes`` of the kernel's
    parameters, reductions, the cluster phase's scratch for its most lines
    (half the sites of rank 2 at most: an int32 and two counters, a uint16,
    and two masks of ``ceil(L_tau / 32)`` words each) and its queue of
    ``TILE_QUEUE`` clusters (f32 dE, uint16 head) per thread, each region
    16-byte aligned."""
    a = _align16
    w, w2 = B + sum(TILE_HALO), B + 3
    sites = w * w if kind == "torus" else w
    lines = ((w2 * w2 if kind == "torus" else w2) + 1) // 2
    buckets = 2 * (max(TILE_RANKS) + 2)
    return (a(sites * ltau) + a(4 * sites) + a(2 * sites) + a(4 * (2 * buckets + 1)) + a(param_bytes)
            + a(4 * (TILE_THREADS // 32) * buckets) + 16 + a(4 * lines) + 16 + a(2 * lines)
            + a(8 * (-(-ltau // 32)) * lines) + a(4 * TILE_QUEUE * TILE_THREADS) + a(2 * TILE_QUEUE * TILE_THREADS))


@functools.lru_cache(maxsize=256)
def tiled_plan(kind: str, size: int, nvars: int, ltau: int, R: int, limit: int, sms: int) -> Optional[tuple]:
    """``(B, box sites, bytes)`` of the tiled kernel for ``R`` replicas of a
    ``kind`` lattice of side ``size`` (a ring's is ``nvars``) at ``ltau`` on a
    card of ``sms`` SMs with ``limit`` bytes of opt-in shared memory per
    block, or None when no tile side fits or the line is longer than
    ``MAX_LTAU``. Of the sides that fit, the one whose launch is least in
    ``waves * blocks per SM * box sites`` (a wave of blocks shares an SM's
    issue; a block's work grows with its box). Shape only, cached per shape;
    the wrappers never fall back from a failed launch."""
    if ltau > MAX_LTAU:
        return None
    side = size if kind == "torus" else nvars
    best = None
    for B in range(TILE_MIN, side - sum(TILE_HALO) + 1, TILE_STEP):
        w = B + sum(TILE_HALO)
        sites = w * w if kind == "torus" else w
        nbytes = tiled_bytes(kind, B, ltau)
        if sites > 65535 or nbytes > limit:
            break  # larger tiles only grow
        tiles = (-(-side // B)) ** (2 if kind == "torus" else 1)
        per_sm = min(TILE_BLOCKS_PER_SM, (limit + _SMEM_RESERVED) // (nbytes + _SMEM_RESERVED))
        cost = -(-(R * tiles) // (sms * per_sm)) * per_sm * sites
        if best is None or cost <= best[0]:
            best = (cost, (B, sites, nbytes))
    return best and best[1]


def choose_route(kind: str, size: int, nvars: int, ltau: int, R: int, limit: int, sms: int):
    """``("resident", resident_plan)``, ``("tiled", tiled_plan)`` or
    ``("multi", None)``: the route ``wl_sweeps`` takes on a card of ``sms``
    SMs and ``limit`` bytes of opt-in shared memory per block, by shape alone
    (resident up to ``RESIDENT_IDLE_SITES_TILED`` idle sites)."""
    plan = resident_plan(nvars, ltau, R, WL_PARAM_BYTES, limit, sms, RESIDENT_IDLE_SITES_TILED)
    if plan:
        return "resident", plan
    plan = tiled_plan(kind, size, nvars, ltau, R, limit, sms)
    if plan:
        return "tiled", plan
    return "multi", None


def dispatch_bound(nvars: int, ltau: int) -> int:
    """Sweeps per dispatch chunk of the JAX kernel: 2^23, or 2^23 // (2 L_tau)
    when its plane (``nvars * L_tau`` int32) exceeds 2 MiB."""
    if nvars * ltau * 4 > _ROW_PLANE_BYTES:
        return max(1, _EXACT // max(2 * ltau, 1))
    return _EXACT


def chunk_plan(total: int, nvars: int, ltau: int):
    """``[(chunk index, sweeps), ...]`` covering ``total`` sweeps."""
    bound = dispatch_bound(nvars, ltau)
    plan, done = [], 0
    while done < total:
        step = min(total - done, bound)
        plan.append((done // bound, step))
        done += step
    return plan


def chunk_seeds(seeds_u32, index: int) -> np.ndarray:
    """The replicas' seeds for dispatch chunk ``index`` (uint32)."""
    seeds = np.asarray(seeds_u32).astype(np.uint32)
    if index == 0:
        return seeds
    return seeds ^ np.uint32((_CHUNK_SEED_STEP * index) & 0xFFFFFFFF)


def xla_sum_last(x: torch.Tensor) -> torch.Tensor:
    """f32 sum over the last axis in XLA's CPU order, which the JAX kernel's
    ``jnp.sum`` of a fully frozen ring follows: up to 32 terms are added one
    by one to 0; more are zero-padded evenly on both sides to a multiple of 32,
    each window of 32 is summed so, and the window sums are summed again by
    the same rule. ``csrc/wl.cu`` sums in this order too."""
    L = x.shape[-1]
    if L > 32:
        n = -(-L // 32)
        lo = (32 * n - L) // 2
        z = x.new_zeros(x.shape[:-1] + (1,))
        x = torch.cat([z.expand(*x.shape[:-1], lo), x, z.expand(*x.shape[:-1], 32 * n - L - lo)], -1)
        return xla_sum_last(_sum_in_order(x.reshape(*x.shape[:-1], n, 32)))
    return _sum_in_order(x)


def _sum_in_order(x: torch.Tensor) -> torch.Tensor:
    acc = torch.zeros_like(x[..., 0])
    for t in range(x.shape[-1]):
        acc = acc + x[..., t]
    return acc


def fk_flips(active: torch.Tensor, de: torch.Tensor, log_u: torch.Tensor) -> torch.Tensor:
    """Which spins of ``[R, nvars, L]`` a Fortuin-Kasteleyn time-line phase
    flips, in the JAX kernels' arithmetic: ``active`` (int32) marks the frozen
    bonds (tau, tau + 1), ``de`` (f32) is each slice's diagonal dE and
    ``log_u`` (f32) each slice's log-uniform. A forward segmented sum of
    ``de`` by pointer doubling gives each cluster's dE at its head (a fully
    frozen line is one cluster headed at tau = 0, summed by ``xla_sum_last``);
    the head flips its cluster when ``log_u < -dE``; the decisions propagate
    forward by pointer doubling."""
    L = active.shape[-1]
    ksteps = max(1, int(math.ceil(math.log2(L))))
    tau = torch.arange(L, device=active.device)
    acc, reach, k = de, active, 1
    for _ in range(ksteps):  # forward segmented run-sum
        acc = acc + torch.where(reach == 1, acc.roll(-k, 2), 0.0)
        reach = reach & reach.roll(-k, 2)
        k *= 2
    allact = active.amin(2, keepdim=True) == 1  # fully frozen line
    heads = torch.where(allact, tau == 0, active.roll(1, 2) == 0)
    acc = torch.where(allact, xla_sum_last(de)[..., None], acc)
    prop = (heads & (log_u < -acc)).to(torch.int32)
    cb, k = active.roll(1, 2), 1  # cb[tau]: tau joined to tau - 1
    for _ in range(ksteps):  # propagate the head decisions forward
        prop = prop | (prop.roll(k, 2) & cb)
        cb = cb & cb.roll(k, 2)
        k *= 2
    return prop == 1


def _check(s, seeds_i32, tables: WlTables, T: int, freq: int, nsamples: int):
    """Validate the arguments shared by the kernel and the plain version;
    returns R."""
    if s.dtype != torch.int8 or s.dim() != 3:
        raise ValueError(f"s must be [R, nvars, L] int8, got {tuple(s.shape)} {s.dtype}")
    R, nvars, L = s.shape
    if (nvars, L) != (tables.nvars, tables.ltau):
        raise ValueError(f"s is [R, {nvars}, {L}], the tables are for [R, {tables.nvars}, {tables.ltau}]")
    why = gate((tables.kind, tables.size, 0.0), nvars, L, R)
    if why:
        raise ValueError(f"the worldline kernel does not take this shape: {why}")
    if seeds_i32.dtype != torch.int32 or tuple(seeds_i32.shape) != (R,):
        raise ValueError(f"seeds_i32 must be [{R}] int32, got {tuple(seeds_i32.shape)} {seeds_i32.dtype}")
    if tables.thr.dtype != torch.int32 or tuple(tables.thr.shape) != (30,):
        raise ValueError("tables.thr must be [30] int32")
    if tables.cde.dtype != torch.float32 or tuple(tables.cde.shape) != (10,):
        raise ValueError("tables.cde must be [10] float32")
    if not 0 <= int(tables.pb) < _INT_LIMIT:
        raise ValueError(f"tables.pb={tables.pb} is not an int31 threshold")
    if T < 0 or 8 * T >= 2**32:
        raise ValueError(f"T={T} sweeps: the draw counter 8*T must stay below 2^32")
    if nsamples < 0 or (nsamples and (freq < 1 or freq * nsamples > T)):
        raise ValueError(f"nsamples={nsamples} samples every freq={freq} sweeps do not fit T={T}")
    for name, t in (("seeds_i32", seeds_i32), ("tables.thr", tables.thr), ("tables.cde", tables.cde)):
        if t.device != s.device:
            raise ValueError(f"{name} is on {t.device}, s on {s.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not s.is_contiguous():
        raise ValueError("s must be contiguous")
    return R


def lattice_fns(kind: str, size: int, nvars: int, dev):
    """Per-site color-0 mask ``[nvars, 1]`` and the functions giving the
    spatial neighbour sum and the outgoing bonds' partners of ``s[R, nvars, L]``."""
    i = torch.arange(nvars, device=dev)
    if kind == "ring":
        color0 = i % 2 == 0

        def nsum(s):
            return s.roll(1, 1) + s.roll(-1, 1)

        def partners(s):  # (i + 1)
            return (s.roll(-1, 1),)
    else:  # torus, i = x * size + y
        color0 = (i // size + i % size) % 2 == 0

        def nsum(s):
            q = s.view(s.shape[0], size, size, -1)
            return (q.roll(1, 1) + q.roll(-1, 1) + q.roll(1, 2) + q.roll(-1, 2)).view(s.shape)

        def partners(s):  # (x, y + 1) and (x + 1, y)
            q = s.view(s.shape[0], size, size, -1)
            return (q.roll(-1, 2).reshape(s.shape), q.roll(-1, 1).reshape(s.shape))

    return color0[:, None], nsum, partners


def wl_sweeps_reference(s, seeds_i32, tables: WlTables, T: int, freq: int = 0, nsamples: int = 0):
    """Plain PyTorch version of ``wl_sweeps``: same arguments, same result."""
    R = _check(s, seeds_i32, tables, T, freq, nsamples)
    _, nvars, L = s.shape
    dev = s.device
    color0, nsum, partners = lattice_fns(tables.kind, tables.size, nvars, dev)
    cmask = (color0, ~color0)
    tau = torch.arange(L, device=dev)[None, :]
    tmask = (tau % 2 == 0, tau % 2 == 1)
    pos1, pos2 = make_pos_mix(tau, torch.arange(nvars, device=dev)[:, None], nvars)
    seed = seeds_i32[:, None, None]
    thr, cde, pb = tables.thr, tables.cde, int(tables.pb)
    x = s.to(torch.int32)
    stats = torch.zeros((R, 3), dtype=torch.int64, device=dev)
    samples = torch.empty((R, nsamples, nvars), dtype=torch.int8, device=dev)

    def draw(ctr):
        return lane_draw31(seed, pos1, pos2, ctr)

    for t in range(T):
        d = DRAWS_PER_SWEEP * t
        for color in (0, 1):
            for parity in (0, 1):
                B = nsum(x)
                ud = x.roll(-1, 2) + x.roll(1, 2)
                tv = thr[15 * (x > 0) + 3 * ((B + 4) // 2) + (ud + 2) // 2]
                acc = (draw(d) <= tv) & cmask[color] & tmask[parity]
                x = torch.where(acc, -x, x)
                d += 1
        for color in (0, 1):
            active = ((x == x.roll(-1, 2)) & (draw(d) < pb)).to(torch.int32)
            de = cde[5 * (x > 0) + (nsum(x) + 4) // 2]
            log_u = torch.log((draw(d + 1).to(torch.float32) + 0.5) * _LOG_SCALE)
            x = torch.where(fk_flips(active, de, log_u) & cmask[color], -x, x)
            d += 2
        sb = sum(x * nb for nb in partners(x))
        stats += torch.stack([sb.sum((1, 2)), x.sum((1, 2)), (x == x.roll(-1, 2)).sum((1, 2))], 1)
        if nsamples and (t + 1) % freq == 0 and (t + 1) // freq <= nsamples:
            samples[:, (t + 1) // freq - 1] = x[:, :, 0].to(torch.int8)
    return x.to(torch.int8), stats, samples


def long_scratch(x):
    """The device scratch the multi-launch kernels take for the state
    ``x[R, nvars, L]`` on its CUDA device where the line is too long for one
    block (``pmc_long_scratch_bytes``, about 4.6 bytes a slice of a color's
    lines; from torch's caching allocator; the kernel library zeroes its
    status words once a call), else None; the chunks of a call share that of
    the largest. Call it with that device current."""
    R, nvars, L = x.shape
    n = _kernels.load().pmc_long_scratch_bytes(R, nvars, L)
    return torch.empty(n, dtype=torch.uint8, device=x.device) if n else None


def _run_multi(s, seeds_i32, tables: WlTables, T: int, freq: int = 0, nsamples: int = 0):
    """The multi-launch route on a CUDA tensor (``LAUNCHES_PER_SWEEP`` launches
    a sweep and chunk of replicas, counted in ``wl_sweeps.launches``; where
    ``cluster_long``, 3 of them and ``LONG_LAUNCHES_PER_SWEEP`` in
    ``wl_sweeps.long_launches``); ``wl_sweeps``' result."""
    R, nvars, L = s.shape
    x = s.clone()
    acc = torch.zeros((R, 3, nvars), dtype=torch.int64, device=s.device)
    samples = torch.empty((R, nsamples, nvars), dtype=torch.int8, device=s.device)
    if R and T:
        with torch.cuda.device(x.device):
            long = cluster_long(L, _kernels.device_limits(x.device)[0])
            chunks = replica_chunks(R, nvars * L, "long" if long else "multi")
            scratch = long_scratch(x[:chunks[0][1]])
            for a, b in chunks:
                _kernels.call("wl kernel", lambda lib: lib.wl_sweeps(
                    rows(x, a, b), rows(seeds_i32, a, b), tables.thr.data_ptr(), tables.cde.data_ptr(),
                    int(tables.pb), rows(acc, a, b), rows(samples, a, b) if nsamples else None,
                    None if scratch is None else scratch.data_ptr(), b - a, nvars, L, int(tables.kind == "torus"),
                    tables.size, T, freq, nsamples, _kernels.stream(x)))
                if scratch is not None:  # the library's route: fk_long_*
                    wl_sweeps.launches += 3 * T
                    wl_sweeps.long_launches += LONG_LAUNCHES_PER_SWEEP * T
                else:
                    wl_sweeps.launches += LAUNCHES_PER_SWEEP * T
    return x, acc.sum(2), samples


def _run_resident(s, seeds_i32, tables: WlTables, T: int, freq: int, nsamples: int, plan):
    """The resident route on a CUDA tensor (one launch a chunk of replicas,
    counted in ``wl_sweeps.resident_launches``), with ``plan = (tile, bytes)``
    from ``resident_plan``; ``wl_sweeps``' result."""
    R, nvars, L = s.shape
    x = s.clone()
    acc = torch.zeros((R, 3), dtype=torch.int64, device=s.device)
    samples = torch.empty((R, nsamples, nvars), dtype=torch.int8, device=s.device)
    if R and T:
        tile, nbytes = plan
        with torch.cuda.device(x.device):
            for a, b in replica_chunks(R, nvars * L, "wl_resident"):
                _kernels.call("wl resident kernel", lambda lib: lib.wl_resident_sweeps(
                    rows(x, a, b), rows(seeds_i32, a, b), tables.thr.data_ptr(), tables.cde.data_ptr(),
                    int(tables.pb), rows(acc, a, b), rows(samples, a, b) if nsamples else None, b - a, nvars, L,
                    int(tables.kind == "torus"), tables.size, T, freq, nsamples, tile, nbytes, _kernels.stream(x)))
                wl_sweeps.resident_launches += 1
    return x, acc, samples


def _run_tiled(s, seeds_i32, tables: WlTables, T: int, freq: int, nsamples: int, plan):
    """The tiled route on a CUDA tensor (one launch a sweep and chunk of
    replicas, counted in ``wl_sweeps.tiled_launches``), with ``plan = (B, box
    sites, bytes)`` from ``tiled_plan``; ``wl_sweeps``' result. The sweeps
    alternate between two new buffers; ``s`` is read by the first (through a
    copy if it is not 16-byte aligned, as the kernel's vector loads need)."""
    R, nvars, L = s.shape
    acc = torch.zeros((R, 3), dtype=torch.int64, device=s.device)
    samples = torch.empty((R, nsamples, nvars), dtype=torch.int8, device=s.device)
    if not (R and T):
        return s.clone(), acc, samples
    src = s if s.data_ptr() % 16 == 0 else s.clone()
    even = torch.empty_like(s)
    odd = torch.empty_like(s) if T > 1 else even
    B, _, nbytes = plan
    torus = tables.kind == "torus"
    tiles = (-(-(tables.size if torus else nvars) // B)) ** (2 if torus else 1)
    with torch.cuda.device(s.device):
        for a, b in replica_chunks(R, nvars * L, "wl_tiled", tiles):
            _kernels.call("wl tiled kernel", lambda lib: lib.wl_tiled_sweeps(
                rows(src, a, b), rows(even, a, b), rows(odd, a, b), rows(seeds_i32, a, b), tables.thr.data_ptr(),
                tables.cde.data_ptr(), int(tables.pb), rows(acc, a, b), rows(samples, a, b) if nsamples else None,
                b - a, nvars, L, int(torus), tables.size, T, freq, nsamples, B, nbytes, _kernels.stream(s)))
            wl_sweeps.tiled_launches += T
    return (even if T % 2 else odd), acc, samples


def wl_sweeps(s: torch.Tensor, seeds_i32: torch.Tensor, tables: WlTables, T: int,
              freq: int = 0, nsamples: int = 0):
    """Run ``T`` full sweeps on ``s[R, nvars, L]`` int8 (not modified).

    Returns ``(state, stats [R, 3] int64, samples [R, nsamples, nvars] int8)``:
    ``stats`` sums, over the T sweeps and the lattice, the bond products of
    the outgoing bonds, the spins and the aligned time bonds after each sweep;
    ``samples[:, k]`` is slice 0 after sweep ``(k + 1) * freq``. ``seeds_i32[R]``
    keys each replica's draws (counter ``8t + d`` for sweep t of this call).

    A CUDA tensor launches ``csrc/wl.cu`` or raises, on the route
    ``choose_route`` gives: the resident kernel (one launch, counted in
    ``wl_sweeps.resident_launches``), the tiled kernel (one launch a sweep,
    counted in ``wl_sweeps.tiled_launches``) or the multi-launch kernels
    (``LAUNCHES_PER_SWEEP`` a sweep, counted in ``wl_sweeps.launches``; for a
    line past one block, ``cluster_long``, 3 there and
    ``LONG_LAUNCHES_PER_SWEEP`` in ``wl_sweeps.long_launches``), each on
    chunks of replicas below its limits (``replicas.replica_chunks``). A CPU
    tensor runs the plain version, in the chunks of the strictest route,
    ``"long"``."""
    T, freq, nsamples = int(T), int(freq), int(nsamples)
    R = _check(s, seeds_i32, tables, T, freq, nsamples)
    if s.device.type == "cpu":
        return gather_chunks(R, replica_chunks(R, tables.nvars * tables.ltau, "long"), lambda a, b: wl_sweeps_reference(
            s[a:b], seeds_i32[a:b], tables, T, freq, nsamples))
    if s.device.type != "cuda":
        raise ValueError(f"wl_sweeps runs on cuda or cpu tensors, got {s.device}")
    _, nvars, L = s.shape
    route, plan = choose_route(tables.kind, tables.size, nvars, L, R, *_kernels.device_limits(s.device))
    if route == "resident":
        return _run_resident(s, seeds_i32, tables, T, freq, nsamples, plan)
    if route == "tiled":
        return _run_tiled(s, seeds_i32, tables, T, freq, nsamples, plan)
    return _run_multi(s, seeds_i32, tables, T, freq, nsamples)


def _seeds_tensor(seeds_u32, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(seeds_u32).astype(np.uint32).view(np.int32))).to(device)


def _estimator(sums: np.ndarray, t: float, nvars: int, L: int, j: float, h: float, gamma: float, a: float):
    """``(ediag, eoff, ntb, al)`` from the exact sums ``[R, 3]`` (f64), written
    as the JAX kernel's host code writes it so that energies agree bit for bit."""
    sb, sh, al = sums[:, 0], sums[:, 1], sums[:, 2]
    ntb = nvars * L * t  # time bonds summed over all sweeps
    tanh_a, coth_a = math.tanh(a), 1.0 / math.tanh(a)
    ediag = (float(j) * sb + float(h) * sh) / L
    eoff = -float(gamma) * (tanh_a * al + coth_a * (ntb - al)) / L
    return ediag, eoff, ntb, al


def run_wl_sweeps(s, seeds_u32, nsweeps: int, dense, beta: float, gamma: float, h: float, ltau: int):
    """``nsweeps`` sweeps on ``s[R, nvars, L]``, in the dispatch chunks of
    ``chunk_plan``. Returns ``(s, esum [R] f64, stats)``: ``esum`` is the total
    energy estimator summed over the sweeps and ``stats`` holds the per-sweep
    means ``diag_mean`` (diagonal energy) and ``kinks_mean`` (kink count), as
    ``run_wl_sweeps_pallas``."""
    R, nvars, L = s.shape
    _, a, _ = coupling_params(beta, gamma, ltau)
    tables = make_tables(dense, nvars, beta, gamma, h, ltau, s.device)
    total = int(nsweeps)
    sums = torch.zeros((R, 3), dtype=torch.int64, device=s.device)
    for index, step in chunk_plan(total, nvars, L):
        s, st, _ = wl_sweeps(s, _seeds_tensor(chunk_seeds(seeds_u32, index), s.device), tables, step)
        sums += st
    t = float(total)
    ediag, eoff, ntb, al = _estimator(sums.cpu().numpy().astype(np.float64), t, nvars, L,
                                      dense[2], h, gamma, a)
    stats = dict(diag_mean=ediag / max(t, 1.0), kinks_mean=(ntb - al) / max(t, 1.0))
    return s, ediag + eoff, stats


def run_wl_sample(s, seeds_u32, freq: int, nsamples: int, rem: int, dense, beta: float,
                  gamma: float, h: float, ltau: int):
    """``nsamples`` blocks of ``freq`` sweeps, slice 0 recorded after each,
    then ``rem`` sweeps, in one dispatch. Returns ``(s, esum [R] f64,
    samples [R, nsamples, nvars] int8)``, as ``run_wl_sample_pallas``."""
    R, nvars, L = s.shape
    _, a, _ = coupling_params(beta, gamma, ltau)
    tables = make_tables(dense, nvars, beta, gamma, h, ltau, s.device)
    total = int(freq) * int(nsamples) + int(rem)
    s, sums, samples = wl_sweeps(s, _seeds_tensor(seeds_u32, s.device), tables, total, freq, nsamples)
    ediag, eoff, _, _ = _estimator(sums.cpu().numpy().astype(np.float64), float(total), nvars, L,
                                   dense[2], h, gamma, a)
    return s, ediag + eoff, samples


wl_sweeps.launches = 0
wl_sweeps.long_launches = 0
wl_sweeps.resident_launches = 0
wl_sweeps.tiled_launches = 0
