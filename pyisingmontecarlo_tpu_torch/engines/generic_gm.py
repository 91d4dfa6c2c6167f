"""Group-major matmul formulation of the generic k-local worldline engine, on torch.

Counterpart of ``pyisingmontecarlo_tpu/engines/generic_gm.py``: the same
update families as ``engines/generic.py``, restructured around a few matrix
products per family.

**Layout.** The worldline ``s`` [R, n, Lt] (Lt = G * ltau sub-slices, group
``g = l % G`` active at sub-slice l) is held as one *group-major plane* of bits

    gm[(g * n + v), (c * R + r)] = (s[r, v, l = g + G*c] + 1) / 2,

rows (group, variable), columns (Trotter slab, replica): term t of group g
reads variables only from row block g.

**Weights: one product and one lookup.** With the block-diagonal bit-weight
matrix W [G*n, TT] (W[g*n + v, t] = 2^slot iff term t of group g has v at
slot), the packed indices of all terms at all of their transfers are
``W^T @ gm`` and ``W^T @ out(gm)``, where ``out`` shifts the group axis by one
block (block G-1 wraps to block 0 one slab on). The products are exact (small
integers). Each term's log-weight (or estimator) is then a lookup of ``in *
2^kmax + out`` in its row of a table that holds the JAX engine's column
values at the union's allowed pairs and the floor elsewhere: the same values
as its select chain over the union pairs.

**Flip deltas: attribution products.** A flip of (v, l') changes transfers l'
and l'-1; with conflict coloring the per-proposer delta is linear in the
per-term deltas: ``[Pm | Pw]`` for per-(variable, sub-slice) deltas (site
family), ``A`` for whole-proposal totals (segment, line, slice), and each
term-kink color's own attribution matrix. In a color's update only the terms
touching that color can change weight, so every product runs on that color's
column subset (``GmColorSub``).

Matmul precision: every product runs in f32 with TF32 off (the drivers hold
``classical.exact_f32_matmul``): the bit-weight products are exact integers,
the attribution products carry real log-weights. The attribution sums are
taken in the BLAS's order, not XLA's, so a Glauber decision whose delta lies
within f32 rounding of its threshold can differ from the JAX engine's; every
other decision agrees.

Randomness is the classic route's (``generic.sweep_plan`` with ``gm=True``:
the free-variable slot draws n bits and reads the free rows). The JAX module's
``detach_tables``/``rebind_tables`` work around jit's embedding of closed-over
constants; the port keeps its tables as device tensors and needs neither.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import classical as ce
from .classical import _uniform_per_replica, walk
from .generic import _NEG, N_SEGMENT_PASSES, N_TERMKINK_PASSES, Compiled, glauber, sweep_plan
from ..utils.accum import kadd, kzero

__all__ = ["GmHost", "GmColorSub", "GmStructs", "GmKinkPhase", "compile_gm", "compile_gm_kinks", "to_gm", "from_gm",
           "out_plane", "lw_plane", "site_deltas", "total_deltas", "sweep_gm", "energy_gm", "term_op_counts_gm",
           "run_sweeps_gm", "run_sweeps_sample_gm", "run_sweeps_bond_sample_gm", "gm_eligible"]

_F = torch.float32
_L = torch.int64


class GmHost(NamedTuple):
    """Host-side (numpy) compile of the group-major structures."""

    n: int
    G: int
    TT: int
    rows: tuple  # (class_idx, within-class term idx) per stacked row
    W: np.ndarray  # [G*n, TT] bit weights (block-diag by group)
    pairs: np.ndarray  # [P, 2] union allowed (in, out) pairs
    tabs: np.ndarray  # [TT, P] log-weight columns (_NEG off-class)
    etabs: np.ndarray  # [TT, P] energy-estimator columns (0 off-class)
    Pm: np.ndarray  # [G*n, TT] site attribution (transfer l' + l'-1, g'>0)
    Pw: np.ndarray  # [G*n, TT] site attribution wrap (l'-1 when g'=0)
    A: np.ndarray  # [n, TT] var-term incidence (whole-proposal totals)
    urow: np.ndarray  # [G*n, 1] 1.0 where variable untouched by row's group
    color_rows: tuple  # per color: [n] 0/1 f32
    # segment draw tables, padded to all n vars (0-count for other colors)
    seg_offs: tuple  # per color: [n, maxoff] int32
    seg_cnt: tuple  # per color: [n] int32
    term_rows: np.ndarray  # [nterms] stacked row of each original term id


class GmColorSub(NamedTuple):
    """A static term-column subset (device tables): the terms a color's
    update (or a term-kink color's) can change."""

    Tc: int  # number of subset terms
    cols: np.ndarray  # [Tc] stacked rows of the subset
    WT: Optional[torch.Tensor]  # [Tc, G*n] bit weights, transposed
    lut: Optional[torch.Tensor]  # [Tc, 4^kmax] log-weight lookup
    PmPw: Optional[torch.Tensor]  # [G*n, 2*Tc] site attribution [Pm_c | Pw_c]
    A: Optional[torch.Tensor]  # [n, Tc] incidence (whole-proposal totals)


class GmStructs(NamedTuple):
    """The host compile and its device tables."""

    host: GmHost
    D: int  # 2^kmax: the packed index is in * D + out
    WT: torch.Tensor  # [TT, G*n]
    lut: torch.Tensor  # [TT, D*D] log-weights (floor _NEG)
    elut: torch.Tensor  # [TT, D*D] estimator (floor 0)
    Pm: torch.Tensor
    Pw: torch.Tensor
    A: torch.Tensor
    urow: torch.Tensor  # [G*n, 1]
    color_rows: Tuple[torch.Tensor, ...]  # per color [n, 1] f32
    seg_offs: Tuple[torch.Tensor, ...]  # per color [n, maxoff] long
    seg_cnt: Tuple[torch.Tensor, ...]  # per color [n, 1] long (at least 1)
    seg_valid: Tuple[torch.Tensor, ...]  # per color [n, 1] f32: the variable has capable boundaries
    term_rows: torch.Tensor  # [nterms] long
    free_rows: torch.Tensor  # [n, 1] f32: 1.0 on variables in no term
    csub: Tuple[GmColorSub, ...] = ()


def _luts(tabs: np.ndarray, etabs: np.ndarray, pairs: np.ndarray, D: int):
    """Per-row lookups ``[rows, D*D]`` of the union-pair columns: the column
    value at ``a * D + b`` for each union pair (a, b), the floor elsewhere."""
    lut = np.full((tabs.shape[0], D * D), _NEG, np.float32)
    elut = np.zeros((tabs.shape[0], D * D), np.float32)
    code = pairs[:, 0] * D + pairs[:, 1]
    lut[:, code] = tabs
    elut[:, code] = etabs
    return lut, elut


def _sub(h: GmHost, cols: np.ndarray, lut: np.ndarray, device, attribution: bool = True) -> GmColorSub:
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)  # noqa: E731
    return GmColorSub(
        Tc=int(cols.size), cols=cols, WT=t(h.W[:, cols].T), lut=t(lut[cols]),
        PmPw=t(np.concatenate([h.Pm[:, cols], h.Pw[:, cols]], axis=1)) if attribution else None,
        A=t(h.A[:, cols]) if attribution else None)


def compile_gm(comp: Compiled, n: int, device="cpu") -> GmStructs:
    """The group-major tables of ``comp`` (the JAX module's host arrays, array
    for array, in ``.host``) and their device tensors on ``device``."""
    G = comp.G
    rows = []
    for ci, cls in enumerate(comp.classes):
        order = np.argsort(cls.group, kind="stable")
        for j in order:
            rows.append((ci, int(j)))
    TT = len(rows)
    W = np.zeros((G * n, TT), np.float32)
    for tt, (ci, j) in enumerate(rows):
        cls = comp.classes[ci]
        g = int(cls.group[j])
        for slot in range(cls.k):
            W[g * n + int(cls.vars[j, slot]), tt] = float(1 << slot)
    pairset = set()
    for cls in comp.classes:
        for a, b in cls.pairs:
            pairset.add((int(a), int(b)))
    pairs = np.asarray(sorted(pairset), np.int32)
    tabs = np.full((TT, len(pairs)), _NEG, np.float32)
    etabs = np.zeros((TT, len(pairs)), np.float32)
    for tt, (ci, j) in enumerate(rows):
        cls = comp.classes[ci]
        lt_np = np.asarray(cls.logT[j])
        et_np = np.asarray(cls.esti[j])
        cls_pairs = {(int(a), int(b)) for a, b in cls.pairs}
        for p, (a, b) in enumerate(pairs):
            # only the term's own class pairs carry table values: a pair
            # allowed by ANOTHER class keeps the _NEG floor
            if (int(a), int(b)) in cls_pairs:
                tabs[tt, p] = lt_np[a, b]
                etabs[tt, p] = et_np[a, b]
    A = np.zeros((n, TT), np.float32)
    gterm = np.zeros(TT, np.int32)
    for tt, (ci, j) in enumerate(rows):
        cls = comp.classes[ci]
        gterm[tt] = int(cls.group[j])
        for slot in range(cls.k):
            A[int(cls.vars[j, slot]), tt] = 1.0
    Pm = np.zeros((G * n, TT), np.float32)
    Pw = np.zeros((G * n, TT), np.float32)
    for gp in range(G):
        block = slice(gp * n, (gp + 1) * n)
        Pm[block] += A * (gterm == gp)[None, :]
        if gp > 0:
            Pm[block] += A * (gterm == gp - 1)[None, :]
        else:
            Pw[block] += A * (gterm == G - 1)[None, :]
    urow = (~comp.touched).T.reshape(G * n, 1).astype(np.float32)
    color_rows, seg_offs, seg_cnt = [], [], []
    for c, sites in enumerate(comp.color_sites):
        cr = np.zeros(n, np.float32)
        cr[sites] = 1.0
        color_rows.append(cr)
        offs_c = comp.kink_offs[c]
        cnt_c = comp.kink_cnt[c]
        offs = np.zeros((n, max(1, offs_c.shape[1])), np.int32)
        cnt = np.zeros(n, np.int32)
        offs[sites, : offs_c.shape[1]] = offs_c
        cnt[sites] = cnt_c
        seg_offs.append(offs)
        seg_cnt.append(cnt)
    term_rows = np.zeros(comp.nterms, np.int32)
    for tt, (ci, j) in enumerate(rows):
        term_rows[int(comp.classes[ci].term_ids[j])] = tt
    host = GmHost(
        n=n, G=G, TT=TT, rows=tuple(rows), W=W, pairs=pairs, tabs=tabs,
        etabs=etabs, Pm=Pm, Pw=Pw, A=A, urow=urow,
        color_rows=tuple(color_rows), seg_offs=tuple(seg_offs),
        seg_cnt=tuple(seg_cnt), term_rows=term_rows,
    )
    D = 2 ** max(cls.k for cls in comp.classes)
    lut, elut = _luts(tabs, etabs, pairs, D)
    # per-color term-column subsets: in a color-c update only terms containing
    # a color-c variable can change weight (conflict coloring)
    var_terms = [set() for _ in range(n)]
    for tt, (ci, j) in enumerate(rows):
        cls = comp.classes[ci]
        for slot in range(cls.k):
            var_terms[int(cls.vars[j, slot])].add(tt)
    csub = []
    for sites in comp.color_sites:
        cols_set = set()
        for v in sites:
            cols_set |= var_terms[int(v)]
        cols = np.asarray(sorted(cols_set), np.int64)
        csub.append(GmColorSub(0, cols, None, None, None, None) if cols.size == 0 else _sub(host, cols, lut, device))
    t = lambda a, dt=_F: torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dt)  # noqa: E731
    frow = np.zeros((n, 1), np.float32)
    frow[comp.free_vars] = 1.0
    return GmStructs(
        host=host, D=D, WT=t(W.T), lut=t(lut), elut=t(elut), Pm=t(Pm), Pw=t(Pw), A=t(A), urow=t(urow),
        color_rows=tuple(t(cr[:, None]) for cr in color_rows),
        seg_offs=tuple(t(o, _L) for o in seg_offs),
        seg_cnt=tuple(t(np.maximum(c, 1)[:, None], _L) for c in seg_cnt),
        seg_valid=tuple(t((c > 0).astype(np.float32)[:, None]) for c in seg_cnt),
        term_rows=t(term_rows, _L), free_rows=t(frow), csub=tuple(csub),
    )


# ------------------------------------------------------------- layout


def to_gm(s: torch.Tensor, G: int) -> torch.Tensor:
    """[R, n, Lt] +-1 int8 -> bit plane [(G, n), (lt, R)] f32."""
    R, n, Lt = s.shape
    b4 = (s > 0).to(_F).reshape(R, n, Lt // G, G)
    return b4.permute(3, 1, 2, 0).reshape(G * n, (Lt // G) * R)


def from_gm(gm: torch.Tensor, G: int, n: int, R: int) -> torch.Tensor:
    """Bit plane [(G, n), (lt, R)] -> [R, n, Lt] +-1 int8."""
    lt = gm.shape[1] // R
    b4 = gm.reshape(G, n, lt, R).permute(3, 1, 2, 0)  # [R, n, lt, G]
    return (b4.reshape(R, n, lt * G) * 2 - 1).to(torch.int8)


def _roll_slabs(x, R: int, shift: int):
    """Roll the Trotter-slab axis of the (slab-major, replica-minor) columns by
    ``shift`` slabs: a column roll by shift*R."""
    return torch.roll(x, shift * R, 1)


def out_plane(gm, G: int, n: int, R: int):
    """Out-states of every transfer: block g+1's rows; block G-1 wraps to
    block 0 advanced one Trotter slab."""
    return torch.cat([gm[n:], _roll_slabs(gm[:n], R, -1)], 0)


def _tile_rows(x, G: int):
    """[n, L] -> [G*n, L] (the variable rows repeated for every group block)."""
    return x.repeat(G, 1)


def _tile_lanes(x, lt: int):
    """[rows, R] -> [rows, lt*R] (the replica columns repeated for every slab)."""
    return x.repeat(1, lt)


def _sum_slabs(x, R: int):
    """[rows, lt*R] -> [rows, R]: sum over the Trotter-slab column blocks, slab
    by slab in order (XLA's order; torch's own reduction order here depends on
    R, and a block of the replicas must sum as the whole batch does). On CUDA
    that is the last row of one ``cumsum``, whose scan along a middle axis adds
    in order in f32; the CPU's ``cumsum`` accumulates f32 in f64, so there the
    slabs are added one by one."""
    x = x.reshape(x.shape[0], -1, R)
    if x.is_cuda:
        return x.cumsum(1)[:, -1]
    acc = x[:, 0]
    for t in range(1, x.shape[1]):
        acc = acc + x[:, t]
    return acc


def _sum_group_blocks(x, G: int, n: int):
    """[G*n, L] -> [n, L]: sum over the group row blocks."""
    return x.reshape(G, n, x.shape[1]).sum(0)


# ------------------------------------------------------------- weights


def _lookup(gs: GmStructs, lut, idx_in, idx_out):
    """The table value of every (term, transfer) at its packed index."""
    return torch.gather(lut, 1, (idx_in * gs.D + idx_out).to(_L))


def lw_plane(gs: GmStructs, gm, R: int):
    """Log-weights of every term at its active transfers [TT, lt*R]."""
    h = gs.host
    gmo = out_plane(gm, h.G, h.n, R)
    return _lookup(gs, gs.lut, gs.WT @ gm, gs.WT @ gmo)


def _lw01_sub(gs: GmStructs, sub: GmColorSub, gm, gmn, R: int):
    """(lw0, lw1, o0, o1) over a column subset, by ONE weight product on the
    column-batched 4-block plane [gm | gmn | out(gm) | out(gmn)] and one
    lookup; the out-planes are returned for ``_delta_plane``."""
    h = gs.host
    L = gm.shape[1]
    o0 = out_plane(gm, h.G, h.n, R)
    o1 = out_plane(gmn, h.G, h.n, R)
    idx = sub.WT @ torch.cat([gm, gmn, o0, o1], 1)  # [Tc, 4L]
    lw = _lookup(gs, sub.lut, idx[:, : 2 * L], idx[:, 2 * L:])
    return lw[:, :L], lw[:, L:], o0, o1


def _delta_plane(gs: GmStructs, gm, gmn, R: int, outs=None):
    """Per-(variable-row, transfer) delta-constraint change [G*n, lt*R]:
    _NEG * (viol_new - viol_old), nonzero only where the row's group leaves
    the variable untouched."""
    h = gs.host
    o0, o1 = outs if outs is not None else (out_plane(gm, h.G, h.n, R), out_plane(gmn, h.G, h.n, R))
    dd = ((gm == o0).to(_F) - (gmn == o1).to(_F)) * _NEG  # viol_new - viol_old
    return dd * gs.urow


def _prev_rows(x, G: int, n: int, R: int):
    """Attribute per-transfer values to the *following* sub-slice: transfer
    l'-1 lives at row block g'-1 (block G-1 wraps, one slab back)."""
    return torch.cat([_roll_slabs(x[(G - 1) * n:], R, +1), x[: (G - 1) * n]], 0)


def flip_bits(gm, m):
    """XOR of a {0,1} f32 bit plane with a {0,1} f32 mask plane."""
    return gm + m * (1.0 - 2.0 * gm)


def _site_deltas_sub(gs: GmStructs, sub: GmColorSub, gm, m, R: int):
    """Per-(variable, sub-slice) deltas over a column subset with the combined
    [Pm_c | Pw_c] attribution product. Returns (D, gmn)."""
    h = gs.host
    gmn = flip_bits(gm, m)
    outs = None
    if sub.Tc:
        lw0, lw1, o0, o1 = _lw01_sub(gs, sub, gm, gmn, R)
        outs = (o0, o1)
        dlw = lw1 - lw0
        D = sub.PmPw @ torch.cat([dlw, _roll_slabs(dlw, R, +1)], 0)
    else:
        D = torch.zeros_like(gm)
    dd = _delta_plane(gs, gm, gmn, R, outs)
    return D + dd + _prev_rows(dd, h.G, h.n, R), gmn


def _total_deltas_sub(gs: GmStructs, sub: GmColorSub, gm, m, R: int):
    """Whole-proposal deltas [n, R] over a column subset. Returns (D, gmn)."""
    h = gs.host
    gmn = flip_bits(gm, m)
    outs = None
    if sub.Tc:
        lw0, lw1, o0, o1 = _lw01_sub(gs, sub, gm, gmn, R)
        outs = (o0, o1)
        dterm = sub.A @ (lw1 - lw0)  # [n, lt*R]
    else:
        dterm = gm.new_zeros((h.n, gm.shape[1]))
    dv = _sum_group_blocks(_delta_plane(gs, gm, gmn, R, outs), h.G, h.n)
    return _sum_slabs(dterm + dv, R), gmn


def site_deltas(gs: GmStructs, gm, m, R: int, lw0=None):
    """Per-(variable, sub-slice) deltas [G*n, lt*R] for the flip mask ``m``
    over all terms (at most one flipped variable per term per transfer).
    Valid at rows/columns where m=1. Returns (D, gmn, lw_new)."""
    h = gs.host
    if lw0 is None:
        lw0 = lw_plane(gs, gm, R)
    gmn = flip_bits(gm, m)
    lw1 = lw_plane(gs, gmn, R)
    dlw = lw1 - lw0
    D = gs.Pm @ dlw + gs.Pw @ _roll_slabs(dlw, R, +1)
    dd = _delta_plane(gs, gm, gmn, R)
    return D + dd + _prev_rows(dd, h.G, h.n, R), gmn, lw1


def total_deltas(gs: GmStructs, gm, m, R: int, lw0=None):
    """Whole-proposal deltas per (variable, replica) [n, R] for flip mask
    ``m`` over all terms. Returns (D, gmn, lw_new)."""
    h = gs.host
    if lw0 is None:
        lw0 = lw_plane(gs, gm, R)
    gmn = flip_bits(gm, m)
    lw1 = lw_plane(gs, gmn, R)
    dterm = gs.A @ (lw1 - lw0)  # [n, lt*R]
    dv = _sum_group_blocks(_delta_plane(gs, gm, gmn, R), h.G, h.n)
    return _sum_slabs(dterm + dv, R), gmn, lw1


# ------------------------------------------------------------- draws


def _plane_uniform(seeds, rows: int, lt: int, R: int):
    """[rows, lt*R] uniforms with per-replica streams."""
    u = _uniform_per_replica(seeds, (rows, lt))  # [R, rows, lt]
    return u.permute(1, 2, 0).reshape(rows, lt * R)


def _rows_uniform(seeds, rows: int):
    """[rows, R] uniforms with per-replica streams."""
    return _uniform_per_replica(seeds, (rows,)).T


# ------------------------------------------------------------- families


def _lsub_plane(gs: GmStructs, lt: int, R: int, device):
    """Sub-slice index l' = g' + G*c' per (row, column), [G*n, lt*R] long."""
    h = gs.host
    row_g = torch.arange(h.G * h.n, device=device) // h.n
    col_c = torch.arange(lt * R, device=device) // R
    return row_g[:, None] + h.G * col_c[None, :]


def _parity_plane(gs: GmStructs, lt: int, R: int, parity: int, device):
    """1.0 where sub-slice l' = g' + G*c' has the given parity, [G*n, lt*R]."""
    return (_lsub_plane(gs, lt, R, device) % 2 == parity).to(_F)


def site_update_gm(gs: GmStructs, gm, seeds, c: int, parity: int, R: int):
    """Glauber on (color-c variable, parity-p sub-slice) positions."""
    h = gs.host
    lt = gm.shape[1] // R
    m = _parity_plane(gs, lt, R, parity, gm.device) * _tile_rows(gs.color_rows[c], h.G)
    D, gmn = _site_deltas_sub(gs, gs.csub[c], gm, m, R)
    u = _plane_uniform(seeds, h.G * h.n, lt, R)
    acc = glauber(u, D) & (m > 0)
    return torch.where(acc, gmn, gm)


def _draw_boundary(u, offs, cnt, G: int, lt: int):
    """Map uniforms [rows, R] to kink-capable sub-slice boundaries: j ~ U[0,
    cnt*lt); l = offs[j % cnt] + G * (j // cnt) (``cnt`` [rows, 1] at least 1,
    ``offs`` [rows, maxoff]), as f32."""
    cap = cnt.to(_F) * lt
    j = torch.minimum(torch.floor(u * cap).to(torch.int32).to(_L), cap.to(torch.int32).to(_L) - 1)
    base = torch.gather(offs, 1, j % cnt)
    return (base + G * (j // cnt)).to(_F)


def _interval_mask(gs: GmStructs, l1, ln, lt: int, R: int):
    """Flip mask [G*n, lt*R] for per-(variable, replica) intervals
    [l1, l1+ln) in sub-slice space (cyclic)."""
    h = gs.host
    Lt = float(h.G * lt)
    lplane = _lsub_plane(gs, lt, R, l1.device).to(_F)
    diff = lplane - _tile_rows(_tile_lanes(l1, lt), h.G)
    diff = torch.where(diff < 0, diff + Lt, diff)
    return (diff < _tile_rows(_tile_lanes(ln, lt), h.G)).to(_F)


def segment_update_gm(gs: GmStructs, gm, seeds, R: int):
    """Segment flips (kink-pair creation/annihilation), colors in turn
    (``seeds [C, R]``)."""
    h = gs.host
    lt = gm.shape[1] // R
    Lt = float(h.G * lt)
    for c in range(len(h.color_rows)):
        u = _uniform_per_replica(seeds[c], (h.n, 3))  # [R, n, 3]
        u1, u2, u3 = (u[:, :, i].T for i in range(3))  # each [n, R]
        l1 = _draw_boundary(u1, gs.seg_offs[c], gs.seg_cnt[c], h.G, lt)
        l2 = _draw_boundary(u2, gs.seg_offs[c], gs.seg_cnt[c], h.G, lt)
        ln = l2 - l1
        ln = torch.where(ln < 0, ln + Lt, ln)
        vc = gs.seg_valid[c] * gs.color_rows[c]  # [n, 1]
        m = _interval_mask(gs, l1, ln, lt, R) * _tile_rows(vc.expand(h.n, lt * R), h.G)
        D, gmn = _total_deltas_sub(gs, gs.csub[c], gm, m, R)
        acc = glauber(u3, D).to(_F) * vc
        gm = torch.where(_tile_rows(_tile_lanes(acc, lt), h.G) * m > 0, gmn, gm)
    return gm


def line_update_gm(gs: GmStructs, gm, seeds, c: int, R: int):
    """Full-worldline flips of color-c variables."""
    h = gs.host
    lt = gm.shape[1] // R
    crow = gs.color_rows[c]
    m = _tile_rows(crow.expand(h.n, lt * R), h.G)
    D, gmn = _total_deltas_sub(gs, gs.csub[c], gm, m, R)
    acc = glauber(_rows_uniform(seeds, h.n), D).to(_F) * crow
    return torch.where(_tile_rows(_tile_lanes(acc, lt), h.G) * m > 0, gmn, gm)


def slice_update_gm(gs: GmStructs, gm, seeds, tau, c: int, R: int):
    """Per-Trotter-slice flips (do_loop_updates family): color-c variables
    flipped across all G sub-slices of the Trotter slab ``tau [R]`` (the
    slot's ``randint(ksel, ltau)``)."""
    h = gs.host
    lt = gm.shape[1] // R
    cc = torch.arange(lt, device=gm.device).repeat_interleave(R)[None, :]  # [1, lt*R]
    in_slab = (cc == tau.to(_L).repeat(lt)[None, :]).to(_F)
    crow = gs.color_rows[c]
    m = _tile_rows(crow * in_slab, h.G)
    D, gmn = _total_deltas_sub(gs, gs.csub[c], gm, m, R)
    acc = glauber(_rows_uniform(seeds, h.n), D).to(_F) * crow
    return torch.where(_tile_rows(_tile_lanes(acc, lt), h.G) * m > 0, gmn, gm)


def free_var_update_gm(gs: GmStructs, gm, bits, R: int):
    """Uniform resample of variables in no term (constant worldlines), from
    the slot's n Bernoulli bits ``[n, R]`` (its free rows)."""
    if bits.shape[0] == 0:
        return gm
    h = gs.host
    lt = gm.shape[1] // R
    m = _tile_rows(_tile_lanes(bits.to(_F), lt) * gs.free_rows, h.G)
    sel = _tile_rows(gs.free_rows.expand(h.n, lt * R), h.G)
    return torch.where(sel > 0, m, gm)


# ---------------------------------------------------------- term kinks


class GmKinkPhase(NamedTuple):
    """One conflict-free term-kink color in group-major form (host numpy
    arrays and their device tensors; ``sub`` the column subset of the terms
    ``Satt`` attributes, with ``Satt_sub`` restricted to it)."""

    P: int
    kmax: int
    pgroup: np.ndarray  # [P]
    soffs: np.ndarray  # [P, kmax, maxoff]
    scnt: np.ndarray  # [P, kmax]
    pact: np.ndarray  # [P, kmax] bool
    S: tuple  # per slot: [n, P] var<-proposal incidence (f32)
    Satt: np.ndarray  # [P, TT] term-delta attribution (f32)
    sub: Optional[GmColorSub] = None
    Satt_sub: Optional[torch.Tensor] = None  # [P, Tc]
    dev: Optional[dict] = None  # device tensors of the draws


def compile_gm_kinks(comp: Compiled, gs: GmStructs, device="cpu") -> Tuple[GmKinkPhase, ...]:
    h = gs.host
    lut = gs.lut.cpu().numpy()
    out = []
    for tc in comp.tkink:
        P, kmax = tc.pvars.shape
        S = []
        for slot in range(kmax):
            Ss = np.zeros((h.n, P), np.float32)
            for p in range(P):
                if tc.pact[p, slot]:
                    Ss[int(tc.pvars[p, slot]), p] = 1.0
            S.append(Ss)
        Satt = np.zeros((P, h.TT), np.float32)
        row_of = {}
        for tt, (ci, j) in enumerate(h.rows):
            row_of[(ci, j)] = tt
        for ci, (selc, pidx) in enumerate(tc.att):
            for j, p in zip(selc, pidx):
                Satt[int(p), row_of[(ci, int(j))]] = 1.0
        cols = np.nonzero(Satt.any(axis=0))[0]
        sub = Satt_sub = None
        if cols.size:
            sub = _sub(h, cols, lut, device, attribution=False)
            Satt_sub = torch.from_numpy(np.ascontiguousarray(Satt[:, cols])).to(device)
        cnt = np.maximum(tc.scnt, 1)
        dev = dict(pgroup=torch.from_numpy(tc.pgroup.astype(np.int64)).to(device),
                   cnt=torch.from_numpy(cnt.T[:, :, None].astype(np.int64)).to(device),  # [kmax, P, 1]
                   soffs=torch.from_numpy(np.ascontiguousarray(tc.soffs.transpose(1, 0, 2)).astype(np.int64)).to(device),
                   act=torch.from_numpy(tc.pact.T[:, :, None].astype(np.float32)).to(device),  # [kmax, P, 1]
                   S=torch.from_numpy(np.stack(S)).to(device))  # [kmax, n, P]
        out.append(GmKinkPhase(P=P, kmax=kmax, pgroup=tc.pgroup, soffs=tc.soffs, scnt=tc.scnt, pact=tc.pact,
                               S=tuple(S), Satt=Satt, sub=sub, Satt_sub=Satt_sub, dev=dev))
    return tuple(out)


def term_kink_update_gm(gs: GmStructs, kinks, gm, seeds, R: int):
    """Term-kink flips (multi-variable off-diagonal ergodicity), term-kink
    colors in turn (``seeds [ntk, R]``), the proposal geometry of
    ``generic.term_kink_update``."""
    h = gs.host
    lt = gm.shape[1] // R
    Lt = float(h.G * lt)
    for ph, sd in zip(kinks, seeds):
        d = ph.dev
        u = _uniform_per_replica(sd, (ph.P, ph.kmax + 2))  # [R, P, kmax+2]
        slab_t = torch.clamp((u[:, :, 0] * lt).to(torch.int32), max=lt - 1).to(_L)
        t = ((d["pgroup"][None, :] + 1 + h.G * slab_t) % int(Lt)).to(_F).T  # [P, R]
        m_total = torch.zeros_like(gm)
        for slot in range(ph.kmax):
            cnt = d["cnt"][slot]  # [P, 1]
            cap = (cnt * lt).to(_F)
            j = torch.minimum((u[:, :, slot + 1].T * cap).to(torch.int32).to(_L), cap.to(torch.int32).to(_L) - 1)
            base = torch.gather(d["soffs"][slot], 1, j % cnt)
            a = (base + h.G * (j // cnt)).to(_F)  # [P, R]
            ln = t - a
            ln = torch.where(ln < 0, ln + Lt, ln)
            act = d["act"][slot]
            # broadcast (a, ln) from proposal space to variable rows (exact: one proposal a row)
            Ss = d["S"][slot]
            m_total = torch.maximum(m_total, _interval_mask(gs, Ss @ (a * act), Ss @ (ln * act), lt, R))
        gmn = flip_bits(gm, m_total)
        if ph.sub is not None:
            lw0, lw1, _, _ = _lw01_sub(gs, ph.sub, gm, gmn, R)
            dP = ph.Satt_sub @ (lw1 - lw0)
        else:
            dP = torch.from_numpy(ph.Satt).to(gm.device) @ (lw_plane(gs, gmn, R) - lw_plane(gs, gm, R))
        acc = glauber(u[:, :, ph.kmax + 1].T, _sum_slabs(dP, R)).to(_F)  # [P, R]
        acc_v = (d["S"] @ acc).amax(0)  # [n, R]: slots hold disjoint variables
        gm = torch.where(_tile_rows(_tile_lanes(acc_v, lt), h.G) * m_total > 0, gmn, gm)
    return gm


# ------------------------------------------------------------- energy


def _estimator_plane(gs: GmStructs, gm, R: int):
    h = gs.host
    return _lookup(gs, gs.elut, gs.WT @ gm, gs.WT @ out_plane(gm, h.G, h.n, R))  # [TT, lt*R]


def energy_gm(gs: GmStructs, gm, R: int, ltau: int, offset: float):
    """dlnZ/dbeta estimator: per-replica mean over Trotter slices of the
    summed per-term (M T / T) values [R]."""
    plane = _estimator_plane(gs, gm, R)  # [TT, lt*R]
    col = plane.T.contiguous().sum(1)[None]  # [1, lt*R]: a contiguous reduction, its order independent of R
    return float(np.float32(offset)) + _sum_slabs(col, R)[0] / ltau


def term_op_counts_gm(gs: GmStructs, gm, R: int, ltau: int, beta, offsets):
    """Per-term SSE op-count analogue [R, nterms]: beta * (C_t - <H_t>)."""
    per_term = _sum_slabs(_estimator_plane(gs, gm, R), R) / ltau  # [TT, R]
    ev_t = per_term.index_select(0, gs.term_rows).T  # [R, nterms]
    offs = torch.as_tensor(np.asarray(offsets, np.float32), device=gm.device)
    return float(np.float32(beta)) * (offs[None, :] - ev_t)


# -------------------------------------------------------------- sweep


def sweep_gm(gs: GmStructs, kinks, gm, seeds, v0, R: int, do_loop: bool):
    """One full sweep in gm layout from its rows of the key tables
    (``generic.sweep_plan(..., gm=True)``): site x colors x parities, segment
    passes, term-kink passes, line flips, optional slice flips, the free
    variables' resample."""
    h = gs.host
    C = len(h.color_rows)
    ntk = len(kinks)
    col = 0
    for c in range(C):
        for parity in (0, 1):
            gm = site_update_gm(gs, gm, seeds[col], c, parity, R)
            col += 1
    for _ in range(N_SEGMENT_PASSES):
        gm = segment_update_gm(gs, gm, seeds[col:col + C], R)
        col += C
    if ntk:
        for _ in range(N_TERMKINK_PASSES):
            gm = term_kink_update_gm(gs, kinks, gm, seeds[col:col + ntk], R)
            col += ntk
    for c in range(C):
        gm = line_update_gm(gs, gm, seeds[col], c, R)
        col += 1
    w = 0
    if do_loop:
        for c in range(C):
            gm = slice_update_gm(gs, gm, seeds[col], v0[w], c, R)
            col += 1
            w += 1
    return free_var_update_gm(gs, gm, v0[w:], R)


# ------------------------------------------------------------- drivers
#
# Same contract as generic.run_sweeps / run_sweeps_sample /
# run_sweeps_bond_sample; the worldline converts to the bit plane once on
# entry and back once on exit.


def _slice0_pm1(gm, n: int, R: int):
    """Classical sample at Trotter slice l=0 (group 0, slab 0) as +-1 int8 [R, n]."""
    return (gm[:n, :R].T * 2.0 - 1.0).to(torch.int8)


def _drive(gs, kinks, comp, s, keys, T, ltau, do_loop, offset, on_sweep=None):
    R = s.shape[0]
    h = gs.host
    esum = kzero(R, s.device)

    def step(t, gm, seeds, v0):
        nonlocal esum
        gm = sweep_gm(gs, kinks, gm, seeds, v0, R, do_loop)
        esum = kadd(esum, energy_gm(gs, gm, R, ltau, offset))
        if on_sweep is not None:
            on_sweep(t, gm)
        return gm

    with ce.exact_f32_matmul():
        gm, keys = walk(to_gm(s, h.G), keys, T, sweep_plan(comp, ltau, do_loop, gm=True), step)
    return from_gm(gm, h.G, h.n, R), keys, esum


def run_sweeps_gm(gs, kinks, comp, s, keys, timesteps, ltau, do_loop, offset):
    return _drive(gs, kinks, comp, s, keys, int(timesteps), ltau, do_loop, offset)


def run_sweeps_sample_gm(gs, kinks, comp, s, keys, timesteps, sampling_freq, ltau, do_loop, offset):
    T, freq = int(timesteps), int(sampling_freq)
    nsamples = T // freq
    R, n = s.shape[0], gs.host.n
    samples = []

    def record(t, gm):
        if (t + 1) % freq == 0 and t < nsamples * freq:
            samples.append(_slice0_pm1(gm, n, R))

    s, keys, esum = _drive(gs, kinks, comp, s, keys, T, ltau, do_loop, offset, record)
    out = torch.stack(samples, 1) if samples else s.new_empty((R, 0, n))
    return s, keys, esum, out


def run_sweeps_bond_sample_gm(gs, kinks, comp, s, keys, timesteps, sampling_freq, ltau, do_loop, offset,
                              offsets_t, beta):
    freq = int(sampling_freq)
    nsamples = int(timesteps) // freq
    R = s.shape[0]
    samples = []

    def record(t, gm):
        if (t + 1) % freq == 0:
            samples.append(term_op_counts_gm(gs, gm, R, ltau, beta, offsets_t))

    s, keys, esum = _drive(gs, kinks, comp, s, keys, nsamples * freq, ltau, do_loop, offset, record)
    out = (torch.stack(samples, 1) if samples
           else torch.zeros((R, 0, comp.nterms), dtype=_F, device=s.device))
    return s, keys, esum, out


# PMC_GENERIC_GM: "auto" (default) gates on table footprint, "1" forces the
# gm route, "0" forces the classic route. PMC_GM_MAX caps G*n*TT (the
# dominant [G*n, TT] tables; the products' work scales with it, where the
# classic route is linear). The JAX package's settings and default: the port
# takes the same route at every shape. Read at construction time.


def gm_eligible(comp: Compiled, n: int) -> bool:
    """Whether GenericWorldline should run its sweeps on the gm route."""
    mode = os.environ.get("PMC_GENERIC_GM", "auto")
    if mode == "0":
        return False
    if mode == "1":
        return True
    gm_max = int(os.environ.get("PMC_GM_MAX", str(8 * 1024 * 1024)))
    return comp.G * n * comp.nterms <= gm_max
