"""Classical Ising Monte Carlo on an arbitrary graph: colored parallel sweeps,
the replicas a batch axis.

Counterpart of ``pyisingmontecarlo_tpu/engines/classical.py``, in plain torch
on either device (the JAX engine is plain XLA: no Pallas kernel lies on this
path). Its moves and their order are the JAX engine's:

- the state is site-major, ``s[nvars, R]`` int8, in the color-sorted numbering
  of ``device_graph_sorted`` inside a run, and replica-major ``[R, nvars]`` in
  the user's numbering at the public boundary;
- a time step is ``nspin_sweeps`` colored sweeps (all sites of a color class
  flip at once by Glauber acceptance on their local fields), then, unless
  ``only_basic``, ``nedge_sweeps`` sweeps of endpoint-pair flips over the
  strong edge classes, ``nworms`` home-biased closed-walk worms (one
  Metropolis move each) and ``nclusters`` Swendsen-Wang cluster updates;
- local fields come from the dense coupling matrix (``nvars <=
  PMC_DENSE_MAX``) or from ELL row gathers. The dense planes are the JAX
  package's hi/lo bf16 split, held as f32 matrices whose values are the bf16
  values, and the field is an f32 ``torch.matmul`` with TF32 off (set for the
  run by ``exact_f32_matmul``). For integer couplings (the JAX package's int8
  matrix) every partial sum is an integer below 2^24, so the product is exact
  in any order.

Randomness. Every uniform is the JAX engine's: ``lane_draw31(seed, pos, 0)``
of ``ops/lanerng.py`` at the position of the draw, keyed by the lane seed of
the replica's threefry sub-key for that move. The keys are split on the
JAX engine's plan (``step_plan``); ``rng.threefry_chain`` walks the chain
for a whole run at once (on the card in one kernel launch), and each move
reads its step's row of the table. So on the CPU the port equals the JAX
engine bit for bit wherever the couplings and biases are integer or dyadic;
otherwise sums taken in another order can differ in the last bit.

Left out of the JAX engine: the opt-in ``PMC_EDGE_B0`` edge variant, and the
timing probe of ``run_steps_chunked`` that sizes chunks for a TPU front end's
watchdog (a call's pieces come from ``PMC_STEPS_PER_DISPATCH`` alone, each
cut further by a bound on the key table's bytes).

Energy convention: H = sum_e J_e s_a s_b + sum_i h_i s_i, positive J
antiferromagnetic. The move functions update ``s`` in place and return it.
"""

from __future__ import annotations

import contextlib
import functools
import os
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .._kernels import resolve_device
from ..graph import CompiledGraph
from ..ops.lanerng import lane_draw31, make_pos_mix
from ..rng import (
    KEY_CLUSTER,
    KEY_PLAIN,
    KEY_WORM,
    chain_columns,
    key_data_from_seeds,
    randint,
    seeds_from_key_data,
    split_all,
    threefry_chain,
)
from ..rng import random_states as _random_states_np

__all__ = [
    "GraphArrays",
    "device_graph",
    "device_graph_sorted",
    "importance_weights",
    "energy",
    "random_states",
    "step_plan",
    "time_step",
    "run_steps",
    "run_steps_energies",
    "run_steps_chunked",
    "run_sampling",
    "sw_cluster_update",
    "worm_closure_fraction",
    "exact_f32_matmul",
    "walk",
]

_F = torch.float32
_S = torch.int8
_L = torch.int64

# the dense coupling path applies up to this nvars (4 n^2 bytes for each f32 plane)
_DENSE_MAX = int(os.environ.get("PMC_DENSE_MAX", "8192"))

# default worm-walk step bound (Lattice and ClassicIsing take min(nvars, this))
DEFAULT_WLEN = 32

# Swendsen-Wang label propagation: a pointer-doubling jump every this many
# min rounds; convergence is tested once per such block of rounds
_SW_JUMP_EVERY = int(os.environ.get("PMC_SW_JUMP_EVERY", "16"))

# probability that the worm steps home whenever its start site is adjacent
_WORM_P_HOME = 0.5

# bound on a run's key table (lane seeds and worm starts) on the device
_TABLE_BYTES = 1 << 28


class GraphArrays(NamedTuple):
    """A compiled graph as tensors on one device.

    Built by ``device_graph_sorted`` the numbering is color-sorted (each site
    color class a contiguous row range) and ``perm``/``iperm`` map it to the
    user's; index tensors are int64, couplings f32."""

    neighbors: torch.Tensor  # [nvars, D]
    jmat: torch.Tensor  # [nvars, D]
    degree: torch.Tensor  # [nvars]
    edge_a: torch.Tensor  # [E]
    edge_b: torch.Tensor  # [E]
    edge_j: torch.Tensor  # [E]
    # per site color
    c_sites: Tuple[torch.Tensor, ...]  # [Cc]
    c_nbrs: Tuple[torch.Tensor, ...]  # [Cc, D]
    c_j: Tuple[torch.Tensor, ...]  # [Cc, D]
    # per strong edge color
    e_a: Tuple[torch.Tensor, ...]  # [Ec]
    e_b: Tuple[torch.Tensor, ...]
    e_j: Tuple[torch.Tensor, ...]
    e_a_nbrs: Tuple[torch.Tensor, ...]  # [Ec, D]
    e_a_j: Tuple[torch.Tensor, ...]
    e_b_nbrs: Tuple[torch.Tensor, ...]
    e_b_j: Tuple[torch.Tensor, ...]
    slot_eid: Optional[torch.Tensor] = None  # [nvars, D] edge id of each ELL slot, -1 on padding
    perm: Optional[torch.Tensor] = None  # [nvars] original id at sorted slot
    iperm: Optional[torch.Tensor] = None  # [nvars] sorted slot of original id
    # dense couplings: A = A_hi + A_lo, each plane's values bf16 values, held in f32
    A_hi: Optional[torch.Tensor] = None  # [nvars, nvars]
    A_lo: Optional[torch.Tensor] = None
    # the JAX package's int8 matrix (every J an integer, |J| <= 127): here the
    # same tensor as A_hi, whose values are then those integers (A_lo is None)
    A_i8: Optional[torch.Tensor] = None


def _slot_eid_np(cg: CompiledGraph) -> np.ndarray:
    out = np.full((cg.nvars, cg.max_deg), -1, np.int32)
    eids = np.arange(cg.nedges, dtype=np.int32)
    out[cg.edge_a, cg.edge_slot_a] = eids
    out[cg.edge_b, cg.edge_slot_b] = eids
    return out


def _t(a, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a)).to(device=device, dtype=dtype)


def _assemble(nbrs, jm, deg, ea, eb, ej, c_sites, strong, slot_eid, device, **extra) -> GraphArrays:
    """GraphArrays from numpy arrays in one numbering (``strong``: edge ids per
    class). The couplings ``jm [nvars, D]`` and ``ej [E]`` may carry a leading
    replica axis (``[R, nvars, D]``, ``[R, E]``), which every coupling field keeps."""
    ix = functools.partial(_t, dtype=_L, device=device)
    fl = functools.partial(_t, dtype=_F, device=device)
    return GraphArrays(
        neighbors=ix(nbrs), jmat=fl(jm), degree=ix(deg), edge_a=ix(ea), edge_b=ix(eb), edge_j=fl(ej),
        c_sites=tuple(ix(s) for s in c_sites),
        c_nbrs=tuple(ix(nbrs[s]) for s in c_sites),
        c_j=tuple(fl(jm[..., s, :]) for s in c_sites),
        e_a=tuple(ix(ea[e]) for e in strong),
        e_b=tuple(ix(eb[e]) for e in strong),
        e_j=tuple(fl(ej[..., e]) for e in strong),
        e_a_nbrs=tuple(ix(nbrs[ea[e]]) for e in strong),
        e_a_j=tuple(fl(jm[..., ea[e], :]) for e in strong),
        e_b_nbrs=tuple(ix(nbrs[eb[e]]) for e in strong),
        e_b_j=tuple(fl(jm[..., eb[e], :]) for e in strong),
        slot_eid=ix(slot_eid),
        **extra,
    )


def device_graph(cg: CompiledGraph, device="cpu") -> GraphArrays:
    """The graph in the user's numbering, ELL fields only. The pair-flip
    tables use the strong (distance-2) edge classes: within a class no two
    pairs share a vertex or a bond, so simultaneous flips with locally
    computed dE are a product of independent reversible kernels."""
    return _assemble(cg.neighbors, cg.jmat, cg.degree, cg.edge_a, cg.edge_b, cg.edge_j, cg.color_sites,
                     cg.strong_ecolor_edges, _slot_eid_np(cg), device)


def _bf16_values(a: np.ndarray) -> np.ndarray:
    """f64 -> the nearest bf16 values (through f32, as the JAX package's
    ``ml_dtypes`` cast rounds), returned as f64."""
    return torch.from_numpy(np.asarray(a, np.float64)).float().to(torch.bfloat16).double().numpy()


def _split_hi_lo(a: np.ndarray):
    """f64 matrix -> ``(hi, lo)`` planes of bf16 values with hi + lo ~ a to
    ~2^-16 relative; ``lo`` is None when ``a`` is exactly bf16 (every integer
    or small dyadic coupling), so the sweeps run one product a color."""
    hi = _bf16_values(a)
    res = a - hi
    return hi, (None if not res.any() else _bf16_values(res))


def device_graph_sorted(cg: CompiledGraph, dense: Optional[bool] = None, device="cpu") -> GraphArrays:
    """``device_graph`` in color-sorted numbering, with the dense coupling
    planes when ``dense`` (default: ``nvars <= PMC_DENSE_MAX``).

    Sites are renumbered by a stable sort of their colors, so each class is a
    contiguous row range and keeps its site order (and so its random stream);
    ``perm``/``iperm`` translate at the boundary."""
    n = cg.nvars
    colors = cg.colors
    perm = np.argsort(colors, kind="stable").astype(np.int32)
    iperm = np.empty_like(perm)
    iperm[perm] = np.arange(n, dtype=np.int32)
    ea, eb = iperm[cg.edge_a], iperm[cg.edge_b]
    nbrs = iperm[cg.neighbors][perm]  # remap values, then reorder rows
    jm = cg.jmat[perm]
    csizes = np.bincount(colors, minlength=int(colors.max()) + 1)
    offs = np.concatenate([[0], np.cumsum(csizes)]).astype(np.int64)
    c_sites = tuple(np.arange(offs[k], offs[k + 1], dtype=np.int32) for k in range(len(csizes)))

    if dense is None:
        dense = n <= _DENSE_MAX
    planes = {}
    if dense:
        A = np.zeros((n, n), np.float64)
        np.add.at(A, (ea, eb), cg.edge_j)
        np.add.at(A, (eb, ea), cg.edge_j)
        hi, lo = _split_hi_lo(A)
        planes["A_hi"] = _t(hi, _F, device)
        planes["A_lo"] = None if lo is None else _t(lo, _F, device)
        if np.array_equal(A, np.round(A)) and np.abs(A).max() <= 127:
            planes["A_i8"] = planes["A_hi"]
    return _assemble(nbrs, jm, cg.degree[perm], ea, eb, cg.edge_j, c_sites, cg.strong_ecolor_edges,
                     _slot_eid_np(cg)[perm], device, perm=_t(perm, _L, device), iperm=_t(iperm, _L, device),
                     **planes)


def importance_weights(cg: CompiledGraph, device="cpu"):
    """Per-strong-class edge attempt probabilities for importance-sampled
    edge moves: w_e = |J_e| / max|J| clamped to [0.05, 1], so zero-coupling
    edges are still tried now and then. A tuple of [Ec] f32 tensors aligned
    with ``GraphArrays.e_a``."""
    mj = np.abs(np.asarray(cg.edge_j, np.float64))
    top = float(mj.max()) if mj.size else 1.0
    w = np.clip(mj / top, 0.05, 1.0) if top > 0 else np.ones_like(mj)
    return tuple(_t(w[e], _F, device) for e in cg.strong_ecolor_edges)


@contextlib.contextmanager
def exact_f32_matmul():
    """f32 matrix products in full f32 (no TF32) for the duration."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def energy(ga: GraphArrays, bias: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """E[r] = sum_e J_e s_a s_b + sum_i h_i s_i, f32. ``s`` ``[R, nvars]`` and
    ``bias`` are in the user's numbering; ``ga`` may be color-sorted."""
    sf = s.to(_F)
    sp = sf if ga.perm is None else sf[:, ga.perm]
    eb = (ga.edge_j[None, :] * sp[:, ga.edge_a] * sp[:, ga.edge_b]).sum(-1)
    return eb + sf @ bias.to(_F)


def _energy_T(ga: GraphArrays, bias: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``energy`` of a site-major ``[nvars, R]`` state in ``ga``'s numbering."""
    sf = s.to(_F)
    eb = (ga.edge_j[:, None] * sf[ga.edge_a] * sf[ga.edge_b]).sum(0)
    return eb + bias.to(_F) @ sf


def random_states(key_data: np.ndarray, nvars: int, device="cpu") -> torch.Tensor:
    """Random +-1 states ``[R, nvars]`` int8 from ``[R, 2]`` key data, the JAX
    package's ``random_states`` bit for bit (``rng.random_states``)."""
    return torch.from_numpy(_random_states_np(key_data, nvars)).to(device)


def _accept(u: torch.Tensor, dE: torch.Tensor, beta: float, heatbath: bool) -> torch.Tensor:
    """Glauber (``u < sigmoid(-beta dE)``) when ``heatbath``, else log-space
    Metropolis (``log u < -beta dE``, which accepts every dE <= 0)."""
    if heatbath:
        return u < torch.sigmoid(dE * -beta)
    return torch.log(u) < dE * -beta


@functools.lru_cache(maxsize=256)
def _pos_words(m: int, device: torch.device):
    """Position words of draw positions 0..m-1 (replica-local, ``nvars = 1``)."""
    pos = torch.arange(m, dtype=_L, device=device)
    return make_pos_mix(pos, torch.zeros((), dtype=_L, device=device), 1)


def _u31_to_f32(u31: torch.Tensor) -> torch.Tensor:
    return u31.to(_F) * (2.0**-31)


def _uniform_per_replica(seeds: torch.Tensor, shape_tail) -> torch.Tensor:
    """Uniforms ``[R, *tail]`` in [0, 1) from per-replica lane seeds ``[R]``
    int32: ``lane_draw31(seed, pos, 0) * 2^-31`` at pos = the flat index in
    ``tail``."""
    m = int(np.prod(shape_tail)) if len(shape_tail) else 1
    p1, p2 = _pos_words(m, seeds.device)
    u = _u31_to_f32(lane_draw31(seeds[:, None], p1[None, :], p2[None, :], 0))
    return u.reshape((seeds.shape[0],) + tuple(shape_tail))


def _uniform_lanes(seeds: torch.Tensor, shape_tail) -> torch.Tensor:
    """The draws of ``_uniform_per_replica`` with the replica axis last,
    ``[*tail, R]``, for the site-major moves."""
    m = int(np.prod(shape_tail)) if len(shape_tail) else 1
    p1, p2 = _pos_words(m, seeds.device)
    u = _u31_to_f32(lane_draw31(seeds[None, :], p1[:, None], p2[:, None], 0))
    return u.reshape(tuple(shape_tail) + (seeds.shape[0],))


def _color_bounds(ga: GraphArrays) -> Tuple[int, ...]:
    """Row offsets of the (contiguous) color classes in sorted numbering."""
    offs = [0]
    for x in ga.c_sites:
        offs.append(offs[-1] + int(x.shape[0]))
    return tuple(offs)


def _dense_field(ga: GraphArrays, s: torch.Tensor, lo=None, hi=None) -> torch.Tensor:
    """Local-field rows ``(A @ s)[lo:hi]``, ``[rows, R]`` f32: the hi plane's
    product plus the lo plane's, where there is one (never in the integer
    case, whose one product is exact)."""
    sf = s.to(_F)
    rows = slice(lo, hi)
    B = ga.A_hi[rows] @ sf
    if ga.A_lo is not None:
        B = B + ga.A_lo[rows] @ sf
    return B


def _spin_color_update(ga, bias, s, seeds, beta, c: int, heatbath: bool):
    """Glauber flips of color class ``c`` on a site-major state. Glauber for
    every parallel colored move: simultaneous Metropolis flips keep detailed
    balance but lose irreducibility (downhill flips fire with probability 1).
    ``heatbath`` is the JAX engine's argument and does not change the move."""
    if ga.A_hi is not None:
        offs = _color_bounds(ga)
        lo, hi = offs[c], offs[c + 1]
        B = _dense_field(ga, s, lo, hi)
        si = s[lo:hi]
        dE = -2.0 * si.to(_F) * (B + bias[lo:hi, None])
        u = _uniform_lanes(seeds, (hi - lo,))
        s[lo:hi] = torch.where(_accept(u, dE, beta, True), -si, si)
        return s
    sites, nbrs, jrow = ga.c_sites[c], ga.c_nbrs[c], ga.c_j[c]
    sj = s[nbrs.reshape(-1)].reshape(*nbrs.shape, -1).to(_F)
    B = (jrow[:, :, None] * sj).sum(1)  # [Cc, R]
    si = s[sites]
    dE = -2.0 * si.to(_F) * (B + bias[sites][:, None])
    u = _uniform_lanes(seeds, (sites.shape[0],))
    s[sites] = torch.where(_accept(u, dE, beta, True), -si, si)
    return s


def _ell_field_rows(ga, x, c: int, end: str) -> torch.Tensor:
    """sum_d J[v, d] x[nbr[v, d]] for the class-c edge endpoints of side
    ``end`` ("a" or "b"), ``[Ec, R]`` f32."""
    nb, jr = (ga.e_a_nbrs[c], ga.e_a_j[c]) if end == "a" else (ga.e_b_nbrs[c], ga.e_b_j[c])
    xv = x[nb.reshape(-1)].reshape(*nb.shape, -1).to(_F)
    return (jr[:, :, None] * xv).sum(1)


def _edge_color_update(ga, bias, s, seeds, beta, c: int, heatbath: bool, iw=None):
    """Pair flips over each edge of strong class ``c`` (Glauber on the pair's
    dE). ``iw`` (None, [Ec], or [R, Ec] f32 in (0, 1]) importance-samples the
    attempts: edge e is tried with probability iw_e, a state-independent and
    so symmetric proposal. The draws are ``[Ec, 2, R]``: the Glauber coin at
    slot 0 and the attempt coin at slot 1 (``[Ec, R]`` without ``iw``)."""
    a, b, j = ga.e_a[c], ga.e_b[c], ga.e_j[c]
    sa = s[a].to(_F)
    sb = s[b].to(_F)
    if ga.A_hi is not None:
        B_all = _dense_field(ga, s)
        Ba, Bb = B_all[a], B_all[b]
    else:
        Ba = _ell_field_rows(ga, s, c, "a")
        Bb = _ell_field_rows(ga, s, c, "b")
    # flip both endpoints: the bond ab keeps its sign, so add back its double-counted change
    dE = -2.0 * sa * (Ba + bias[a][:, None]) - 2.0 * sb * (Bb + bias[b][:, None]) + 4.0 * j[:, None] * sa * sb
    if iw is None:
        u = _uniform_lanes(seeds, (a.shape[0],))
    else:
        u2 = _uniform_lanes(seeds, (a.shape[0], 2))
        u = u2[:, 0]
    acc = _accept(u, dE, beta, True)
    if iw is not None:
        acc = acc & (u2[:, 1] < (iw.T if iw.dim() == 2 else iw[:, None]))
    sia, sib = s[a], s[b]
    s[a] = torch.where(acc, -sia, sia)
    s[b] = torch.where(acc, -sib, sib)
    return s


def _worm_walk(ga, seeds, v0, wlen: int, nvars: int, R: int):
    """The home-biased first-return walk from ``v0`` [R]: returns (odd-visit
    set ``f [nvars, R]`` bool, ``closed [R]``, ``u_acc [R]`` Metropolis coins).

    Draws ``[wlen, 3, R]``: slot 1 picks the neighbor of each step, slot 2 is
    the home coin, slot 0 of the first row the acceptance coin. The walk's
    visits are recorded per step and their parity taken at the end."""
    u_all = _uniform_lanes(seeds, (wlen, 3))
    u_acc, u_mov, u_home = u_all[0, 0], u_all[:, 1], u_all[:, 2]
    v0 = v0.to(_L)
    slot = torch.arange(ga.neighbors.shape[1], device=v0.device)
    r_idx = torch.arange(R, device=v0.device)
    v, closed = v0, torch.zeros(R, dtype=torch.bool, device=v0.device)
    heads, live = [], []
    for t in range(wlen):
        heads.append(v)
        live.append(~closed)
        nbrs = ga.neighbors[v]  # [R, D]
        deg = torch.clamp(ga.degree[v], min=1)
        pick = torch.minimum((u_mov[t] * deg.to(_F)).to(_L), deg - 1)
        vn = nbrs[r_idx, pick]
        # step home with probability _WORM_P_HOME whenever home is adjacent (valid slots only)
        home_adj = ((nbrs == v0[:, None]) & (slot[None, :] < deg[:, None])).any(1)
        vn = torch.where(home_adj & (u_home[t] < _WORM_P_HOME), v0, vn)
        closed = closed | (vn == v0)  # arrival at v0 closes (and is not counted)
        v = torch.where(closed, v0, vn)
    visits = torch.zeros((nvars, R), dtype=torch.int32, device=v0.device)
    if wlen:
        visits.scatter_add_(0, torch.stack(heads), torch.stack(live).to(torch.int32))
    return (visits & 1).bool(), closed, u_acc


def _worm_update(ga, bias, s, seeds, v0, beta, wlen: int, heatbath: bool):
    """One loop-building worm per replica: the sites an odd number of times on
    a closed walk (at most ``wlen`` steps; an open walk proposes nothing) flip
    together as one Metropolis move (Glauber when ``heatbath``). The walk does
    not depend on the state, so the proposal is symmetric."""
    nvars, R = s.shape
    f, closed, u_acc = _worm_walk(ga, seeds, v0, wlen, nvars, R)
    sf = s.to(_F)
    cut = (f[ga.edge_a] ^ f[ga.edge_b]).to(_F)  # [E, R]: bonds the set's boundary cuts
    j = ga.edge_j[:, None] if ga.edge_j.dim() == 1 else ga.edge_j.T
    ebond = j * sf[ga.edge_a] * sf[ga.edge_b]
    dE = -2.0 * (ebond * cut).sum(0) - 2.0 * (bias[:, None] * sf * f).sum(0)
    acc = closed & _accept(u_acc, dE, beta, heatbath)
    return torch.where(f & acc[None, :], -s, s)


def worm_closure_fraction(cg: CompiledGraph, wlen: Optional[int] = None, trials: int = 4096, seed: int = 0, *,
                          device="cuda") -> float:
    """The fraction of worm proposals that close on this graph (the walk does
    not depend on the state, so this is exact for any run); the keys of
    ``trials`` replicas seeded ``seed, seed + 1, ...``. ``wlen`` defaults to
    ``min(nvars, DEFAULT_WLEN)``."""
    dev = resolve_device(device)
    ga = device_graph(cg, dev)
    wl = int(wlen) if wlen else min(cg.nvars, DEFAULT_WLEN)
    kd = key_data_from_seeds(np.arange(seed, seed + trials, dtype=np.uint64))
    ku, k0 = split_all(kd)
    seeds = torch.from_numpy(seeds_from_key_data(ku)).to(dev)
    v0 = torch.from_numpy(randint(k0, cg.nvars)).to(dev)
    _, closed, _ = _worm_walk(ga, seeds, v0, wl, cg.nvars, trials)
    return float(closed.float().mean())


def _double(x: torch.Tensor, nvars: int) -> torch.Tensor:
    """Pointer doubling: follow each label's own label (ghost -1 stays)."""
    link = torch.gather(x, 0, torch.clamp(x, 0, nvars - 1))
    return torch.where(x >= 0, torch.minimum(x, link), x)


def sw_cluster_update(ga: GraphArrays, bias, s, seeds_e, seeds_g, seeds_f, beta):
    """One Swendsen-Wang update per replica (Fortuin-Kasteleyn), on any
    signed couplings: a satisfied bond (J s_a s_b < 0) freezes with
    probability 1 - exp(-2 beta |J|); a site freezes to the +1 ghost spin with
    probability 1 - exp(-2 beta |h|) when h s < 0. Clusters are components of
    frozen bonds; those frozen to the ghost stay, the others flip with
    probability 1/2 (the coin of the cluster's least site). ``seeds_e``,
    ``seeds_g``, ``seeds_f`` key the bond, ghost and flip draws.

    Labels start at each site's index (-1 on ghost-frozen sites) and take the
    least label over frozen bonds, with a pointer-doubling jump every
    ``PMC_SW_JUMP_EVERY``-th round; they reach each cluster's least index (or
    -1) whatever the schedule, and a round that changes nothing means they have.
    The JAX engine tests for that after every round; here it is tested once a
    block of ``PMC_SW_JUMP_EVERY`` rounds (one host sync on the card), and the
    extra rounds change nothing, so the result is the same."""
    nvars, R = s.shape
    ea, eb = ga.edge_a, ga.edge_b
    E = int(ea.shape[0])
    sf = s.to(_F)
    sa, sb = sf[ea], sf[eb]  # [E, R]
    p_e = (1.0 - torch.exp(-2.0 * beta * ga.edge_j.abs()))[:, None]
    frozen = ((ga.edge_j[:, None] * sa * sb) < 0) & (_uniform_lanes(seeds_e, (E,)) < p_e)
    p_g = (1.0 - torch.exp(-2.0 * beta * bias.abs()))[:, None]
    ghost = ((bias[:, None] * sf) < 0) & (_uniform_lanes(seeds_g, (nvars,)) < p_g)

    # bond decisions -> ELL slots by the static slot -> edge map (padding reads the appended False row)
    slot = torch.where(ga.slot_eid >= 0, ga.slot_eid, E)
    frozen_pad = torch.cat([frozen, torch.zeros((1, R), dtype=torch.bool, device=s.device)])
    slot_frozen = frozen_pad[slot.reshape(-1)].reshape(nvars, -1, R)
    nbr = ga.neighbors.reshape(-1)
    iota = torch.arange(nvars, dtype=_L, device=s.device)[:, None]
    lab = torch.where(ghost, torch.full_like(iota, -1), iota)
    big = torch.full((), nvars, dtype=_L, device=s.device)
    r = 0
    while True:
        before = lab
        for _ in range(_SW_JUMP_EVERY):
            nb_lab = lab[nbr].reshape(nvars, -1, R)
            lab = torch.minimum(lab, torch.where(slot_frozen, nb_lab, big).amin(1))
            if r % _SW_JUMP_EVERY == _SW_JUMP_EVERY - 1:
                lab = _double(lab, nvars)
            r += 1
        if not bool((lab != before).any()):
            break

    coin = torch.gather(_uniform_lanes(seeds_f, (nvars,)), 0, torch.clamp(lab, 0, nvars - 1))
    return torch.where((lab >= 0) & (coin < 0.5), -s, s)


def step_plan(ga: GraphArrays, nspin_sweeps: int, nedge_sweeps: int, nworms: int, only_basic: bool,
              nclusters: int = 0) -> list:
    """The key-chain slot kinds of one time step, in the order the moves split
    the replica's key (``rng.threefry_chain``)."""
    kinds = [KEY_PLAIN] * (nspin_sweeps * len(ga.c_sites))
    if not only_basic:
        kinds += [KEY_PLAIN] * (nedge_sweeps * len(ga.e_a)) + [KEY_WORM] * nworms + [KEY_CLUSTER] * nclusters
    return kinds


def time_step(ga, bias, s, seeds, v0, beta, nspin_sweeps: int, nedge_sweeps: int, nworms: int,
              only_basic: bool, heatbath: bool, wlen: int, nclusters: int = 0, iw=None):
    """One time step on a site-major state, from its row of the key table:
    ``seeds [C, R]`` lane seeds and ``v0 [W, R]`` worm starts in
    ``step_plan``'s order. ``iw`` (None or one attempt-probability tensor per
    strong class) importance-samples the edge moves."""
    col = 0
    for _ in range(nspin_sweeps):
        for c in range(len(ga.c_sites)):
            s = _spin_color_update(ga, bias, s, seeds[col], beta, c, heatbath)
            col += 1
    if not only_basic:
        for _ in range(nedge_sweeps):
            for c in range(len(ga.e_a)):
                s = _edge_color_update(ga, bias, s, seeds[col], beta, c, heatbath,
                                       iw=None if iw is None else iw[c])
                col += 1
        for w in range(nworms):
            s = _worm_update(ga, bias, s, seeds[col], v0[w], beta, wlen, heatbath)
            col += 1
        for _ in range(nclusters):
            s = sw_cluster_update(ga, bias, s, seeds[col], seeds[col + 1], seeds[col + 2], beta)
            col += 3
    return s


def _to_internal(ga, s, bias):
    """Public ``[R, nvars]`` user-numbered state -> a site-major copy in ``ga``'s numbering."""
    st = s.T
    if ga.perm is not None:
        st = st[ga.perm]
        bias = bias[ga.perm]
    return st.contiguous(), bias


def _from_internal(ga, st):
    if ga.perm is not None:
        st = st[ga.iperm]
    return st.T.contiguous()


def _dispatch_chunk() -> int:
    try:
        return max(0, int(os.environ.get("PMC_STEPS_PER_DISPATCH", "0")))
    except ValueError:
        return 0


def walk(s, keys, T: int, plan: list, step, nvars: int = 1):
    """``T`` steps of the key plan ``plan`` (``rng.threefry_chain``) on the
    state ``s``, of any layout: ``step(t, s, seeds [C, R], v0 [W, R]) -> s``.
    The chain is walked in pieces of ``PMC_STEPS_PER_DISPATCH`` steps (all at
    once when unset or 0), each cut further so that its tables stay under
    ``_TABLE_BYTES``; it continues from piece to piece, so any cut gives the
    same trajectory bit for bit. ``keys`` is ``[R, 2]`` int32 key data on the
    device, ``nvars`` the worm slots' span. Returns ``(s, keys)``."""
    C, W = chain_columns(plan)
    piece = max(1, _TABLE_BYTES // max(1, 4 * (C + W) * keys.shape[0]))
    piece = min(piece, _dispatch_chunk() or piece)
    for t0 in range(0, int(T), piece):
        n = min(piece, int(T) - t0)
        seeds, v0, keys = threefry_chain(keys, plan, n, nvars)
        seeds, v0 = seeds.to(s.device), v0.to(s.device)
        for t in range(n):
            s = step(t0 + t, s, seeds[t], v0[t])
    return s, keys


def _steps(ga, bias_s, st, keys, beta_arr, moves: dict, on_step=None):
    """``len(beta_arr)`` time steps on a site-major state, the key chain walked
    by ``walk``; ``on_step(t, st)`` after step t. Returns ``(st, keys)``."""
    betas = np.asarray(beta_arr, np.float32).reshape(-1).tolist()
    kinds = step_plan(ga, moves["nspin_sweeps"], moves["nedge_sweeps"], moves["nworms"], moves["only_basic"],
                      moves.get("nclusters", 0))

    def one(t, x, seeds, v0):
        x = time_step(ga, bias_s, x, seeds, v0, betas[t], **moves)
        if on_step is not None:
            on_step(t, x)
        return x

    with exact_f32_matmul():
        return walk(st, keys, len(betas), kinds, one, st.shape[0])


def run_steps(ga, bias, s, keys, beta_arr, nspin_sweeps, nedge_sweeps, nworms, only_basic, heatbath, wlen,
              nclusters=0, iw=None):
    """``len(beta_arr)`` time steps, step t at ``beta_arr[t]`` (f32). ``s`` is
    replica-major ``[R, nvars]`` in the user's numbering, ``keys`` ``[R, 2]``
    int32 key data (``rng.key_tensor``) on ``s``'s device. Returns ``(s, keys)``."""
    moves = dict(nspin_sweeps=nspin_sweeps, nedge_sweeps=nedge_sweeps, nworms=nworms, only_basic=only_basic,
                 heatbath=heatbath, wlen=wlen, nclusters=nclusters, iw=iw)
    st, bias_s = _to_internal(ga, s, bias)
    st, keys = _steps(ga, bias_s, st, keys, beta_arr, moves)
    return _from_internal(ga, st), keys


def run_steps_energies(ga, bias, s, keys, beta_arr, nspin_sweeps, nedge_sweeps, nworms, only_basic, heatbath,
                       wlen, nclusters=0, iw=None):
    """``run_steps`` that also records the energy after every step: ``(s,
    keys, energies [R, T] f32)``."""
    moves = dict(nspin_sweeps=nspin_sweeps, nedge_sweeps=nedge_sweeps, nworms=nworms, only_basic=only_basic,
                 heatbath=heatbath, wlen=wlen, nclusters=nclusters, iw=iw)
    st, bias_s = _to_internal(ga, s, bias)
    es = []
    st, keys = _steps(ga, bias_s, st, keys, beta_arr, moves,
                      on_step=lambda t, x: es.append(_energy_T(ga, bias_s, x)))
    out = torch.stack(es, 1) if es else torch.zeros((st.shape[1], 0), dtype=_F, device=st.device)
    return _from_internal(ga, st), keys, out


def run_steps_chunked(ga, bias, s, keys, beta_arr, *, collect_energies=False, **kw):
    """``run_steps_energies`` when ``collect_energies``, else ``run_steps``;
    both split the call by ``PMC_STEPS_PER_DISPATCH`` (``_steps``)."""
    if collect_energies:
        return run_steps_energies(ga, bias, s, keys, beta_arr, **kw)
    return run_steps(ga, bias, s, keys, beta_arr, **kw)


def run_sampling(ga, bias, s, keys, beta, timesteps, sampling_freq, nspin_sweeps, nedge_sweeps, nworms,
                 only_basic, heatbath, wlen, nclusters=0, iw=None):
    """``timesteps`` steps at fixed ``beta`` (rounded to f32), recording the
    energy and state after every ``sampling_freq``-th step; the remainder
    steps run after the last sample. Returns ``(s, keys, energies [R, n],
    states [R, n, nvars])``, ``n = timesteps // sampling_freq``, in the user's
    numbering."""
    moves = dict(nspin_sweeps=nspin_sweeps, nedge_sweeps=nedge_sweeps, nworms=nworms, only_basic=only_basic,
                 heatbath=heatbath, wlen=wlen, nclusters=nclusters, iw=iw)
    timesteps, freq = int(timesteps), int(sampling_freq)
    nsamples = timesteps // freq
    st, bias_s = _to_internal(ga, s, bias)
    es, ss = [], []

    def sample(t, x):
        if (t + 1) % freq == 0 and t < nsamples * freq:
            es.append(_energy_T(ga, bias_s, x))
            ss.append(x.clone())

    st, keys = _steps(ga, bias_s, st, keys, np.full(timesteps, beta, np.float32), moves, on_step=sample)
    n, R = st.shape
    if not ss:
        return (_from_internal(ga, st), keys, torch.zeros((R, 0), dtype=_F, device=st.device),
                torch.zeros((R, 0, n), dtype=_S, device=st.device))
    stack = torch.stack(ss)  # [nsamples, nvars, R]
    if ga.perm is not None:
        stack = stack[:, ga.iperm]
    return _from_internal(ga, st), keys, torch.stack(es, 1), stack.permute(2, 0, 1).contiguous()
