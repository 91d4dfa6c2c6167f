"""Generic k-local-interaction worldline QMC engine (``QmcRunner``'s backend), on torch.

Counterpart of ``pyisingmontecarlo_tpu/engines/generic.py``: the terms are
Trotterized over G disjoint-support groups,

    e^{-beta H} ~ [ prod_g e^{-dtau H_g} ]^{L_tau},   H = sum_t H_t,

so the imaginary-time axis has ``Lt = L_tau * G`` sub-slices and the transfer
at sub-slice ``l`` applies group ``l % G``, each term through its dense
``2^k x 2^k`` table ``T_t = expm(-dtau M_t)``. The host compile (numpy:
``compile_terms``, ``_compile_term_kinks``, ``regrid_worldline``) is the JAX
module's, array for array, so the group and color order, and with it the key
each phase takes, are the same.

The sweep is the JAX engine's, in plain torch on either device: colored
single-site sub-slice flips (each color, both parities), ``N_SEGMENT_PASSES``
segment passes over the colors, ``N_TERMKINK_PASSES`` term-kink passes over
the term-kink colors, whole-worldline flips per color, per-Trotter-slice flips
per color with ``do_loop``, and the free variables' resample; every parallel
phase accepts by Glauber. A term's transfer weight is a lookup of its packed
``(in, out)`` index in a per-term table that holds the floor wherever the JAX
engine's select chain gives the floor, so the values are the same bits.

Randomness. Each phase draws ``lane_draw31(seed, pos, 0)`` at the flat index
of the draw (``classical._uniform_per_replica``), keyed by the lane seed of
the replica's threefry sub-key for that phase; a segment or term-kink pass
splits its sub-key once per color (a ``KEY_FAN`` slot), a slice phase draws
its slice with ``randint`` (``KEY_SLICE``), and the free-variable phase its
spins with ``bernoulli(sub, 0.5)`` (``KEY_BITS``). ``rng.threefry_chain``
walks the chain of a whole call (``classical.walk``; on the card in one
launch of ``csrc/keychain.cu``). Where a sum of f32 log-weights meets a Glauber test,
it is taken in XLA's CPU order (``ops/wl.xla_sum_last``), and scatter-adds
apply their updates in order, so on the CPU this route equals the JAX classic
route bit for bit in states and keys; energy sums agree to f32 rounding.

``GenericWorldline`` takes the group-major matmul route of
``engines/generic_gm.py`` where ``gm_eligible`` admits the term set (the same
``PMC_GENERIC_GM`` and ``PMC_GM_MAX`` settings and default as the JAX
package), else this module's route.

Energy estimator: E = <sum_t (M_t T_t / T_t)[in, out]> averaged per Trotter
slice, plus the accumulated constant offset of the ``_and_offset`` variants.
Sign condition: T_t >= 0 elementwise (stoquastic M_t); a 1-local term with
positive off-diagonal is sampled by |T| (its sign cancels on a periodic
worldline); any other sign-indefinite term raises ValueError.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..graph import _color_sites_python
from ..ops.wl import xla_sum_last
from ..rng import KEY_BITS, KEY_FAN, KEY_PLAIN, KEY_SLICE, key_data_of, key_tensor
from ..utils.accum import kadd, kfinal, kzero
from .classical import _uniform_per_replica, walk

__all__ = ["TermSet", "GenericWorldline", "expm", "compile_terms", "regrid_worldline", "device_terms",
           "sweep_plan", "sweep", "total_energy", "term_op_counts", "log_weight", "run_sweeps",
           "run_sweeps_sample", "run_sweeps_bond_sample", "DEFAULT_DTAU"]

_F = torch.float32
_L = torch.int64
_NEG = -1.0e9  # log-weight of a forbidden configuration
# Coarser default than the TFIM engine: generic kink dynamics relies on
# segment flips whose acceptance ~ (offdiag * dtau)^2, and Trotter bias at
# 0.1 stays well below the statistical tolerances of the workloads.
DEFAULT_DTAU = 0.1
N_SEGMENT_PASSES = 6  # segment-flip passes per sweep (kink-number mixing)
N_TERMKINK_PASSES = 4  # term-kink passes per sweep (multi-var off-diag mixing)


def expm(m: np.ndarray) -> np.ndarray:
    """Matrix exponential via scaling-and-squaring + Taylor (tiny matrices)."""
    m = np.asarray(m, np.float64)
    norm = np.abs(m).sum(axis=-1).max() if m.size else 0.0
    sq = max(0, int(math.ceil(math.log2(max(norm, 1e-30)))) + 1) if norm > 0.5 else 0
    a = m / (2.0**sq)
    out = np.eye(m.shape[0]) + a
    term = a.copy()
    for k in range(2, 24):
        term = term @ a / k
        out = out + term
    for _ in range(sq):
        out = out @ out
    return out


class TermSet:
    """Host-side registry of k-local interaction terms."""

    def __init__(self, nvars: int):
        self.nvars = nvars
        self.terms: List[dict] = []  # {mat (2^k,2^k) np, vars tuple, offset}
        self.offset = 0.0

    def add(self, mat_flat, nvars_list, diagonal: bool, with_offset: bool) -> None:
        """A flattened 2^k x 2^k (or 2^k diagonal)
        matrix over the listed variables; ``with_offset`` shifts the matrix to
        make the SSE/worldline weights non-negative and records the constant."""
        vs = [int(v) for v in nvars_list]
        k = len(vs)
        if k == 0:
            raise ValueError("Interaction must touch at least one variable")
        if len(set(vs)) != k:
            raise ValueError("Interaction variables must be distinct")
        for v in vs:
            if v < 0 or v >= self.nvars:
                raise ValueError(f"Interaction variable {v} out of bounds")
        dim = 2**k
        mat_flat = np.asarray(mat_flat, np.float64)
        if diagonal:
            if mat_flat.shape != (dim,):
                raise ValueError(
                    f"Diagonal interaction on {k} variables needs {dim} entries, "
                    f"got {mat_flat.shape}"
                )
            mat = np.diag(mat_flat)
        else:
            if mat_flat.shape != (dim * dim,):
                raise ValueError(
                    f"Interaction on {k} variables needs {dim * dim} entries, "
                    f"got {mat_flat.shape}"
                )
            mat = mat_flat.reshape(dim, dim)
        off = 0.0
        if with_offset:
            # shift so the diagonal (hence the SSE weight C - H) is non-negative
            c = float(mat.diagonal().max())
            if c > 0:
                mat = mat - c * np.eye(dim)
                off = c
        offdiag = mat - np.diag(np.diag(mat))
        if k > 1 and offdiag.max() > 1e-12:
            raise ValueError(
                "Multi-variable interaction has positive off-diagonal elements "
                "(non-stoquastic: sign problem). Use the stoquastic form or an "
                "offset variant."
            )
        self.offset += off
        self.terms.append(dict(mat=mat, vars=tuple(vs), offset=off))

    def clone(self) -> "TermSet":
        other = TermSet(self.nvars)
        other.terms = [dict(t) for t in self.terms]
        other.offset = self.offset
        return other


class ArityClass(NamedTuple):
    """Statically-shaped batch of all k-local terms for one arity k.

    Host numpy throughout; ``device_terms`` puts what the sweeps read on a
    device."""

    k: int
    vars: np.ndarray  # [T, k] int32
    logT: np.ndarray  # [T, 2^k, 2^k] f32 (log weights; _NEG where T ~ 0)
    esti: np.ndarray  # [T, 2^k, 2^k] f32 ((M T)/T energy estimator table)
    group: np.ndarray  # [T] int32
    cvar: Tuple[np.ndarray, ...]  # per color: [T] var of that color in term, or -1
    term_ids: np.ndarray  # [T] original term indices (for bond counts)
    diag_only: bool = False  # every term in the class is diagonal (ZZ-style)
    # (in, out) index pairs allowed (non-floor log-weight) for ANY term of the
    # class — the select chain in _term_logw only visits these (host const)
    pairs: np.ndarray = np.zeros((0, 2), np.int32)


class TermKinkColor(NamedTuple):
    """One conflict-free phase of term-kink proposals (see term_kink_update).

    A proposal is a (multi-variable term, off-diagonal flip mask) pair; two
    proposals conflict when some term touches variables of both (their
    acceptance weights would not be separable). All arrays are host numpy
    compile-time constants."""

    pvars: np.ndarray  # [P, kmax] int32 var ids (inactive slots padded)
    pact: np.ndarray  # [P, kmax] bool: slot carries a flipped variable
    pgroup: np.ndarray  # [P] int32 group of the proposing term
    # per (proposal, slot): that variable's kink-capable sub-slice offsets
    # modulo G ([P, kmax, maxoff] padded with 0) and counts ([P, kmax]) — the
    # independent second boundary each flipped variable draws for itself
    soffs: np.ndarray
    scnt: np.ndarray
    # per arity class: (class-local term indices whose weight a proposal of
    # this color can change, the proposal index each is attributed to)
    att: Tuple[Tuple[np.ndarray, np.ndarray], ...]


class Compiled(NamedTuple):
    classes: Tuple[ArityClass, ...]
    touched: np.ndarray  # [nvars, G] bool
    free_vars: np.ndarray  # [nF] vars in no term
    color_sites: Tuple[np.ndarray, ...]
    G: int
    nterms: int
    # segment-flip proposal tables: per color, kink-capable sub-slice offsets
    # modulo G ([Cc, maxoffs] padded with 0) and their counts ([Cc]); a
    # variable's worldline can only change across transfers whose group
    # contains a term acting off-diagonally on it
    kink_offs: Tuple[np.ndarray, ...]
    kink_cnt: Tuple[np.ndarray, ...]
    # [nvars, G] bool: kink of variable v allowed across transfers of group g
    kinkable: np.ndarray
    # term-kink proposal phases (multi-variable off-diagonal ergodicity)
    tkink: Tuple[TermKinkColor, ...]


def _color_conflicts(nvars: int, terms: List[dict]) -> np.ndarray:
    """Vertex coloring of the variable co-occurrence graph (vars sharing a
    term must be in different classes)."""
    pairs = set()
    for t in terms:
        vs = t["vars"]
        for i in range(len(vs)):
            for j in range(i + 1, len(vs)):
                pairs.add((min(vs[i], vs[j]), max(vs[i], vs[j])))
    if not pairs:
        return np.zeros(nvars, np.int32)
    ea = np.array([p[0] for p in pairs], np.int32)
    eb = np.array([p[1] for p in pairs], np.int32)
    return _color_sites_python(nvars, ea, eb)


def _group_terms(terms: List[dict]) -> np.ndarray:
    """Greedy disjoint-support grouping (terms in a group share no variable)."""
    groups = np.full(len(terms), -1, np.int32)
    used: List[set] = []
    for i, t in enumerate(terms):
        vs = set(t["vars"])
        for g, occupied in enumerate(used):
            if not (vs & occupied):
                groups[i] = g
                occupied |= vs
                break
        else:
            groups[i] = len(used)
            used.append(set(vs))
    return groups


def compile_terms(nvars: int, terms: List[dict], dtau: float) -> Compiled:
    if not terms:
        raise ValueError("No interactions added")
    groups = _group_terms(terms)
    G = int(groups.max()) + 1
    colors = _color_conflicts(nvars, terms)
    ncolors = int(colors.max()) + 1
    color_sites = tuple(
        np.nonzero(colors == c)[0].astype(np.int32) for c in range(ncolors)
    )
    touched = np.zeros((nvars, G), bool)
    in_any = np.zeros(nvars, bool)
    offdiag_groups = [set() for _ in range(nvars)]  # groups that can kink v
    for t, g in zip(terms, groups):
        m = t["mat"]
        dim = m.shape[0]
        for slot, v in enumerate(t["vars"]):
            touched[v, g] = True
            in_any[v] = True
            bit = 1 << slot
            # off-diagonal action on v: any matrix element between states
            # differing in v's bit (expm can only couple what M couples
            # through powers, which preserves "which bits can flip" per term)
            if any(
                abs(m[a, a ^ bit]) > 1e-12 or abs(m[a ^ bit, a]) > 1e-12
                for a in range(dim)
            ) or any(
                abs(m[a, b]) > 1e-12
                for a in range(dim)
                for b in range(dim)
                if (a ^ b) & bit and a != b
            ):
                offdiag_groups[v].add(int(g))
    by_k: Dict[int, List[int]] = {}
    for i, t in enumerate(terms):
        by_k.setdefault(len(t["vars"]), []).append(i)
    classes = []
    for k, ids in sorted(by_k.items()):
        T = len(ids)
        vs = np.zeros((T, k), np.int32)
        logT = np.zeros((T, 2**k, 2**k), np.float64)
        esti = np.zeros((T, 2**k, 2**k), np.float64)
        for j, i in enumerate(ids):
            m = terms[i]["mat"]
            vs[j] = terms[i]["vars"]
            tm = expm(-dtau * m)
            if tm.min() < -1e-9:
                if k == 1:
                    tm = np.abs(tm)  # even-flip-parity sign cancellation (exact)
                else:
                    raise ValueError(
                        "Interaction produces negative path weights (sign problem)"
                    )
            tm = np.maximum(tm, 1e-300)
            logT[j] = np.log(tm)
            # clip: at forbidden transitions (tm ~ 1e-300) the ratio can
            # exceed f32 range; those entries are never realized (weight
            # e^-690) but the one-hot contraction multiplies them by 0.0,
            # and 0 * inf would poison the sum with NaN
            esti[j] = np.clip((m @ tm) / tm, -1e30, 1e30)
        cvar = []
        for c in range(ncolors):
            cv = np.full(T, -1, np.int32)
            for j, i in enumerate(ids):
                for slot, v in enumerate(terms[i]["vars"]):
                    if colors[v] == c:
                        cv[j] = v
            cvar.append(cv)
        diag_only = all(
            np.abs(terms[i]["mat"] - np.diag(np.diag(terms[i]["mat"]))).max() < 1e-12
            for i in ids
        )
        # allowed (in, out) pairs: above the clamp floor for some term
        floor = float(np.log(1e-300)) + 1.0
        allowed = (logT > floor).any(axis=0)  # [2^k, 2^k]
        pairs = np.argwhere(allowed).astype(np.int32)
        classes.append(
            ArityClass(
                k=k,
                vars=vs,
                logT=logT.astype(np.float32),
                esti=esti.astype(np.float32),
                group=groups[ids],
                cvar=tuple(cvar),
                term_ids=np.asarray(ids),
                diag_only=diag_only,
                pairs=pairs,
            )
        )
    kink_offs, kink_cnt = [], []
    for sites in color_sites:
        maxoffs = max([1] + [len(offdiag_groups[v]) for v in sites])
        offs = np.zeros((len(sites), maxoffs), np.int32)
        cnt = np.zeros(len(sites), np.int32)
        for j, v in enumerate(sites):
            # capable segment boundaries: sub-slice l with group(l-1) kinkable,
            # i.e. l  ==  (g+1) mod G  (mod G, repeated every Trotter slice)
            gs = sorted((g + 1) % G for g in offdiag_groups[v])
            cnt[j] = len(gs)
            offs[j, : len(gs)] = gs
        kink_offs.append(offs)
        kink_cnt.append(cnt)
    kinkable = np.zeros((nvars, G), bool)
    for v in range(nvars):
        for g in offdiag_groups[v]:
            kinkable[v, g] = True
    tkink = _compile_term_kinks(nvars, terms, groups, by_k, dtau, offdiag_groups)
    return Compiled(
        classes=tuple(classes),
        touched=touched,
        free_vars=np.nonzero(~in_any)[0].astype(np.int32),
        color_sites=color_sites,
        G=G,
        nterms=len(terms),
        kink_offs=tuple(kink_offs),
        kink_cnt=tuple(kink_cnt),
        kinkable=kinkable,
        tkink=tkink,
    )


def _compile_term_kinks(
    nvars, terms, groups, by_k, dtau, offdiag_groups
) -> Tuple[TermKinkColor, ...]:
    """Build the term-kink proposal phases.

    A transfer of a multi-variable off-diagonal term (e.g. an XX bond, whose
    T = cosh I + sinh A only connects a -> a and a -> a^3) can never be
    crossed by single-variable moves: any 1-bit mismatch across it has weight
    ~ e^-690, so site/segment/line flips leave the sampler confined to the
    diagonal sector of every such transfer — the SSE analogue inserts whole
    term applications and has no such barrier. The fix is a move with one
    **common boundary** at a transfer of the term's group (where all mask
    variables toggle jointly, entering the term's antidiagonal) and an
    **independent second boundary per variable**, drawn from that variable's
    own kink-capable positions. The independent boundaries are essential:
    flipping every mask variable over the *same* interval (the obvious move)
    only reaches parallel pairings — a configuration where one variable
    rebalances its kink parity at its own X transfer while its partner
    rebalances elsewhere is separated from parallel pairings by forbidden
    single-mismatch intermediates, and its weight (~ tanh^3 vs tanh^2) showed
    up as a reproducible 20-25% kink-density deficit against exact worldline
    enumeration. Proposals are compiled one per (term, mask); conflict
    coloring (some term touches variables of both proposals) makes each
    phase's parallel Glauber acceptances exactly separable."""
    props: List[Tuple[Tuple[int, ...], int]] = []  # (flipped vars, group)
    for i, t in enumerate(terms):
        k = len(t["vars"])
        if k < 2:
            continue
        tm = expm(-dtau * t["mat"])
        dim = 2**k
        masks = sorted(
            {
                a ^ b
                for a in range(dim)
                for b in range(dim)
                if a != b and abs(tm[a, b]) > 1e-14
            }
        )
        for mvar in masks:
            vs = tuple(t["vars"][slot] for slot in range(k) if (mvar >> slot) & 1)
            props.append((vs, int(groups[i])))
    if not props:
        return ()
    var_terms = [set() for _ in range(nvars)]
    for i, t in enumerate(terms):
        for v in t["vars"]:
            var_terms[v].add(i)
    pterms = []  # terms whose weight proposal p can change
    for vs, _ in props:
        ts = set()
        for v in vs:
            ts |= var_terms[v]
        pterms.append(ts)
    # greedy color: p ~ q iff pterms[p] & pterms[q] (shared affected term)
    colors = np.full(len(props), -1, np.int32)
    color_union: List[set] = []
    for p in range(len(props)):
        for c, occ in enumerate(color_union):
            if not (pterms[p] & occ):
                colors[p] = c
                occ |= pterms[p]
                break
        else:
            colors[p] = len(color_union)
            color_union.append(set(pterms[p]))
    class_ids = {k: ids for k, ids in sorted(by_k.items())}  # class order
    out = []
    G = int(groups.max()) + 1
    for c in range(int(colors.max()) + 1):
        sel = np.nonzero(colors == c)[0]
        kmax = max(len(props[p][0]) for p in sel)
        maxoff = max(
            [1] + [len(offdiag_groups[v]) for p in sel for v in props[p][0]]
        )
        pvars = np.zeros((len(sel), kmax), np.int32)
        pact = np.zeros((len(sel), kmax), bool)
        pgroup = np.zeros(len(sel), np.int32)
        soffs = np.zeros((len(sel), kmax, maxoff), np.int32)
        scnt = np.ones((len(sel), kmax), np.int32)
        var_prop = {}  # var id -> proposal index within this color
        for j, p in enumerate(sel):
            vs, g = props[p]
            pgroup[j] = g
            for slot, v in enumerate(vs):
                pvars[j, slot] = v
                pact[j, slot] = True
                var_prop[v] = j
                gs = sorted((gg + 1) % G for gg in offdiag_groups[v])
                scnt[j, slot] = len(gs)
                soffs[j, slot, : len(gs)] = gs
        att = []
        for k, ids in class_ids.items():
            selc, pidx = [], []
            for jc, i in enumerate(ids):
                owners = {var_prop[v] for v in terms[i]["vars"] if v in var_prop}
                if owners:
                    assert len(owners) == 1, "conflict coloring violated"
                    selc.append(jc)
                    pidx.append(owners.pop())
            att.append((np.asarray(selc, np.int32), np.asarray(pidx, np.int32)))
        out.append(
            TermKinkColor(
                pvars=pvars, pact=pact, pgroup=pgroup,
                soffs=soffs, scnt=scnt, att=tuple(att),
            )
        )
    return tuple(out)


def regrid_worldline(s_old, comp_new: Compiled, Lt_new: int) -> np.ndarray:
    """Resample worldlines [R, nvars, Lt_old] onto a Lt_new sub-slice grid and
    repair kinks the new term set forbids.

    Used when the term set changes mid-run (the reference applies new
    interactions to existing simulators — the operator string survives because
    SSE stores term applications, and a configuration is valid under any
    superset of terms). On the worldline side
    the grid length Lt = ltau * G can change with G, and the new delta
    constraints may forbid kinks at their regridded positions, so: nearest-
    position resample, then a forward pass forcing s[l+1] = s[l] wherever the
    kink across transfer l is not kinkable under the new compilation; any line
    left with a forbidden wrap kink is flattened to its tau=0 value. The result
    has strictly positive weight and the sweeps re-equilibrate from it."""
    R, nvars, Lt_old = s_old.shape
    idx = (np.arange(Lt_new) * Lt_old // Lt_new).astype(np.int32)
    s = np.asarray(s_old)[:, :, idx].copy()
    allowed = comp_new.kinkable[:, np.arange(Lt_new) % comp_new.G]  # [nvars, Lt]
    for l in range(Lt_new - 1):
        forb = ~allowed[:, l]
        if forb.any():
            s[:, forb, l + 1] = s[:, forb, l]
    wrap_bad = (~allowed[:, Lt_new - 1])[None, :] & (s[:, :, -1] != s[:, :, 0])
    s = np.where(wrap_bad[:, :, None], s[:, :, 0:1], s)
    return s


# ------------------------------------------------------------- device tables


def _class_luts(cls: ArityClass):
    """Per-term lookup tables ``[T, 4^k]`` at the packed index ``in * 2^k +
    out``: the log-weights (``_NEG`` wherever the JAX engine's select chain
    gives its floor: outside the class's allowed pairs, or off the diagonal
    of a diagonal class) and the estimator (0.0 there)."""
    T, D = cls.vars.shape[0], 2**cls.k
    if cls.k == 1:
        return cls.logT.reshape(T, 4), cls.esti.reshape(T, 4)
    lut = np.full((T, D * D), _NEG, np.float32)
    elut = np.zeros((T, D * D), np.float32)
    pairs = [(v, v) for v in range(D)] if cls.diag_only else [(int(a), int(b)) for a, b in cls.pairs]
    for a, b in pairs:
        lut[:, a * D + b] = cls.logT[:, a, b]
        elut[:, a * D + b] = cls.esti[:, a, b]
    return lut, elut


class Block(NamedTuple):
    """Terms of one arity class and one group, evaluated together: their
    transfers are the sub-slices ``g + G * c``."""

    g: int
    k: int
    vars: torch.Tensor  # [Tb * k] long, term-major
    lut: torch.Tensor  # [Tb, 4^k] f32 log-weights
    elut: torch.Tensor  # [Tb, 4^k] f32 estimator
    off: torch.Tensor  # [1, Tb, 1] long: each term's row in the flat tables
    w: torch.Tensor  # [1, 2, 1, k, 1] long: weight of the in and out bits in the packed index
    pos: torch.Tensor  # [Tb] long: the terms' positions in the evaluated subset
    terms: np.ndarray  # [Tb] class-local term indices


def _blocks(cls: ArityClass, sel: np.ndarray, luts, device) -> Tuple[Block, ...]:
    """The subset ``sel`` (class-local term indices) of ``cls``, split by group."""
    lut, elut = luts
    D = 2**cls.k
    w = torch.tensor([[D << j for j in range(cls.k)], [1 << j for j in range(cls.k)]], dtype=_L, device=device)
    out = []
    for g in np.unique(cls.group[sel]):
        pos = np.nonzero(cls.group[sel] == g)[0]
        terms = sel[pos]
        out.append(Block(
            g=int(g), k=cls.k, vars=torch.from_numpy(cls.vars[terms].reshape(-1).astype(np.int64)).to(device),
            lut=torch.from_numpy(np.ascontiguousarray(lut[terms])).to(device),
            elut=torch.from_numpy(np.ascontiguousarray(elut[terms])).to(device),
            off=(torch.arange(len(terms), dtype=_L, device=device) * (D * D)).reshape(1, -1, 1),
            w=w.reshape(1, 2, 1, cls.k, 1), pos=torch.from_numpy(pos.astype(np.int64)).to(device), terms=terms))
    return tuple(out)


class DeviceTerms(NamedTuple):
    """What the sweeps read, on one device (``device_terms``)."""

    comp: Compiled
    G: int
    classes: Tuple[Tuple[Block, ...], ...]  # per class: every term, by group
    color_sites: Tuple[torch.Tensor, ...]  # [Cc] long
    color_blocks: Tuple[tuple, ...]  # per color: (block, [Tb] positions in the color class) of terms touching it
    untouched: torch.Tensor  # [nvars, G] bool: the group's transfers leave the variable untouched
    kink_offs: Tuple[torch.Tensor, ...]  # per color [Cc, maxoffs] int32
    tkink: tuple  # per term-kink color (see _tkink_tables)
    free_vars: torch.Tensor  # [nF] long


def _rank_split(idx: np.ndarray, device):
    """Split a scatter's indices into ranks (the r-th occurrence of each
    index), so that adding rank by rank applies duplicate updates in order:
    ``((positions, indices), ...)``, each with distinct indices."""
    seen: Dict[int, int] = {}
    ranks: List[List[int]] = []
    for j, p in enumerate(idx.tolist()):
        r = seen.get(p, 0)
        seen[p] = r + 1
        if r == len(ranks):
            ranks.append([])
        ranks[r].append(j)
    return tuple((torch.tensor(js, dtype=_L, device=device), torch.from_numpy(idx[js].astype(np.int64)).to(device))
                 for js in ranks)


def _tkink_tables(comp: Compiled, luts, device):
    out = []
    for tc in comp.tkink:
        P, kmax = tc.pvars.shape
        slots = []
        for slot in range(kmax):
            sel = np.nonzero(tc.pact[:, slot])[0]
            slots.append((torch.from_numpy(sel.astype(np.int64)).to(device),
                          torch.from_numpy(tc.pvars[sel, slot].astype(np.int64)).to(device)))
        att = []
        for ci, (selc, pidx) in enumerate(tc.att):
            if selc.size == 0:
                att.append(None)
                continue
            att.append((_blocks(comp.classes[ci], selc, luts[ci], device), int(selc.size), _rank_split(pidx, device)))
        cnt = np.maximum(tc.scnt, 1)
        out.append(dict(P=P, kmax=kmax, pgroup=torch.from_numpy(tc.pgroup.astype(np.int64)).to(device),
                        cnt=torch.from_numpy(cnt.astype(np.int64)).to(device),
                        soffs=torch.from_numpy(tc.soffs.astype(np.int64)).to(device), slots=tuple(slots),
                        att=tuple(att)))
    return tuple(out)


def device_terms(comp: Compiled, device) -> DeviceTerms:
    """The compile's tables on ``device``: per-(class, group) blocks for the
    estimators, the flip deltas of each color and the term-kink phases."""
    luts = [_class_luts(cls) for cls in comp.classes]
    nvars = comp.touched.shape[0]
    classes = tuple(_blocks(cls, np.arange(cls.vars.shape[0]), luts[ci], device) for ci, cls in enumerate(comp.classes))
    color_blocks = []
    for c, sites in enumerate(comp.color_sites):
        pos_of = np.full(nvars, -1, np.int64)
        pos_of[sites] = np.arange(sites.shape[0])
        entries = []
        for ci, cls in enumerate(comp.classes):
            cv = cls.cvar[c]
            sel = np.nonzero(cv >= 0)[0]
            for blk in _blocks(cls, sel, luts[ci], device):
                entries.append((blk, torch.from_numpy(pos_of[cv[blk.terms]]).to(device)))
        color_blocks.append(tuple(entries))
    t = lambda a, dt=_L: torch.from_numpy(np.asarray(a)).to(device=device, dtype=dt)  # noqa: E731
    return DeviceTerms(
        comp=comp, G=comp.G, classes=classes, color_sites=tuple(t(x) for x in comp.color_sites),
        color_blocks=tuple(color_blocks), untouched=t(~comp.touched, torch.bool),
        kink_offs=tuple(t(x) for x in comp.kink_offs), tkink=_tkink_tables(comp, luts, device),
        free_vars=t(comp.free_vars))


# ------------------------------------------------------------------ weights


def _group_views(s: torch.Tensor, G: int):
    """[R, n, Lt] -> per-group (in, out) state views, each [R, n, ltau].

    The transfer at sub-slice ``l = G*t + g`` maps state ``s[.., l]`` to
    ``s[.., l+1]``: within a Trotter slice the out-state is the next group's
    plane at the same t; the last group wraps to group 0 of slice t+1."""
    R, n, Lt = s.shape
    s4 = s.reshape(R, n, Lt // G, G)
    ins = [s4[..., g] for g in range(G)]
    outs = [s4[..., g + 1] if g + 1 < G else s4[..., 0].roll(-1, 2) for g in range(G)]
    return ins, outs


def _block_eval(blk: Block, s_in, s_out, energy: bool = False) -> torch.Tensor:
    """A block's log-weights (or estimator values) on one group's state planes
    ``s_in``/``s_out`` [R, n, ltau] -> [R, Tb, ltau]."""
    R, _, lt = s_in.shape
    b = torch.cat([s_in.index_select(1, blk.vars), s_out.index_select(1, blk.vars)], 1)
    code = ((b.reshape(R, 2, -1, blk.k, lt) > 0) * blk.w).sum((1, 3))
    return torch.take(blk.elut if energy else blk.lut, code + blk.off)


def _term_values(blocks, T: int, s, G: int, energy: bool = False) -> torch.Tensor:
    """Per-term log-weights (or estimator values) ``[R, T, Lt]`` of the terms
    of ``blocks`` (T of them) at every transfer, 0.0 where a term's group is
    inactive."""
    R, _, Lt = s.shape
    out = s.new_zeros((R, T, Lt // G, G), dtype=_F)
    ins, outs = _group_views(s, G)
    for blk in blocks:
        out[:, blk.pos, :, blk.g] = _block_eval(blk, ins[blk.g], outs[blk.g], energy)
    return out.reshape(R, T, Lt)


def _delta_logw(untouched, s) -> torch.Tensor:
    """Per-variable delta-constraint log-weights [R, n, Lt] of the variables of
    ``s`` (``untouched`` their [n, G] rows): _NEG where an untouched variable
    changes across a transfer."""
    G = untouched.shape[1]
    free = untouched.repeat(1, s.shape[2] // G)  # [n, Lt]: l -> l % G
    viol = (s != s.roll(-1, 2)) & free[None]
    return torch.where(viol, _NEG, 0.0)


def total_energy(dt: DeviceTerms, s, ltau: int, offset: float) -> torch.Tensor:
    """The estimator per replica [R] (f32): offset + sum_t mean over Trotter slices."""
    e = torch.full((s.shape[0],), float(np.float32(offset)), dtype=_F, device=s.device)
    for blocks, cls in zip(dt.classes, dt.comp.classes):
        e = e + _term_values(blocks, cls.vars.shape[0], s, dt.G, True).sum((1, 2)) / ltau
    return e


def term_op_counts(dt: DeviceTerms, s, ltau: int, beta, offsets) -> torch.Tensor:
    """Per-term SSE op-count analogue [R, nterms]: beta * (C_t - <H_t>)."""
    out = torch.zeros((s.shape[0], dt.comp.nterms), dtype=_F, device=s.device)
    offs = torch.as_tensor(np.asarray(offsets, np.float32), device=s.device)
    for blocks, cls in zip(dt.classes, dt.comp.classes):
        ids = torch.from_numpy(cls.term_ids.astype(np.int64)).to(s.device)
        ev = _term_values(blocks, cls.vars.shape[0], s, dt.G, True).sum(2) / ltau
        out[:, ids] = float(np.float32(beta)) * (offs[ids][None] - ev)
    return out


def log_weight(dt: DeviceTerms, s) -> torch.Tensor:
    """log W(s) [R]."""
    lw = _delta_logw(dt.untouched, s).sum((1, 2))
    for blocks, cls in zip(dt.classes, dt.comp.classes):
        lw = lw + _term_values(blocks, cls.vars.shape[0], s, dt.G).sum((1, 2))
    return lw


# ------------------------------------------------------------------- updates


def glauber(u: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """The decision of every parallel phase of both routes: accept where
    ``u < sigmoid(delta)`` (Glauber: both outcomes keep a positive
    probability, so parallel phases stay irreducible). Every family decides
    through this one function, which chip_smoke.py's card check wraps."""
    return u < torch.sigmoid(delta)


def _flip_delta_per_site(dt: DeviceTerms, s, s_new, c: int) -> torch.Tensor:
    """Per-(color-c var, transfer) log-weight change [R, Cc, Lt] between s and
    s_new (s_new flips only color-c vars, at most one end per transfer). Only
    the terms touching a color-c variable are evaluated, each block on its own
    group's sub-slices; the blocks add in the JAX engine's order (class, then
    group)."""
    sites = dt.color_sites[c]
    R, _, Lt = s.shape
    G = dt.G
    d4 = s.new_zeros((R, sites.shape[0], Lt // G, G), dtype=_F)
    ins, outs = _group_views(s, G)
    ins_n, outs_n = _group_views(s_new, G)
    for blk, dpos in dt.color_blocks[c]:
        g = blk.g
        d4[:, dpos, :, g] += _block_eval(blk, ins_n[g], outs_n[g]) - _block_eval(blk, ins[g], outs[g])
    un = dt.untouched.index_select(0, sites)
    dd = _delta_logw(un, s_new.index_select(1, sites)) - _delta_logw(un, s.index_select(1, sites))
    return d4.reshape(R, -1, Lt) + dd


def site_color_update(dt: DeviceTerms, s, seeds, c: int, parity: int):
    """Glauber on (color-c var, sub-slice of the given parity) positions."""
    sites = dt.color_sites[c]
    Lt = s.shape[2]
    tpar = (torch.arange(Lt, device=s.device) % 2) == parity
    si = s.index_select(1, sites)
    s_new = s.clone()
    s_new[:, sites] = torch.where(tpar, -si, si)
    d = _flip_delta_per_site(dt, s, s_new, c)  # [R, Cc, Lt] per transfer
    dpos = d.roll(1, 2) + d  # a flip at sub-slice l changes transfers l-1 and l
    u = _uniform_per_replica(seeds, (sites.shape[0], Lt))
    acc = glauber(u, dpos) & tpar
    s[:, sites] = torch.where(acc, -si, si)
    return s


def line_color_update(dt: DeviceTerms, s, seeds, c: int):
    """Full-worldline flips of color-c variables (delta-free global move)."""
    sites = dt.color_sites[c]
    si = s.index_select(1, sites)
    s_new = s.clone()
    s_new[:, sites] = -si
    d = xla_sum_last(_flip_delta_per_site(dt, s, s_new, c))  # [R, Cc]
    u = _uniform_per_replica(seeds, (sites.shape[0],))
    acc = glauber(u, d)[:, :, None]
    s[:, sites] = torch.where(acc, -si, si)
    return s


def slice_color_update(dt: DeviceTerms, s, seeds, tau, c: int):
    """Per-Trotter-slice flips (do_loop_updates family): flip a color-c var
    across all G sub-slices of the Trotter slice ``tau`` [R] (the slot's
    ``randint(ksel, ltau)``)."""
    sites = dt.color_sites[c]
    Lt = s.shape[2]
    in_slice = (torch.arange(Lt, device=s.device) // dt.G)[None, :] == tau.to(_L)[:, None]  # [R, Lt]
    si = s.index_select(1, sites)
    s_new = s.clone()
    s_new[:, sites] = torch.where(in_slice[:, None, :], -si, si)
    d = xla_sum_last(_flip_delta_per_site(dt, s, s_new, c))  # [R, Cc]
    u = _uniform_per_replica(seeds, (sites.shape[0],))
    acc = glauber(u, d)[:, :, None] & in_slice[:, None, :]
    s[:, sites] = torch.where(acc, -si, si)
    return s


def segment_color_update(dt: DeviceTerms, s, seeds):
    """Segment flips, colors in turn (``seeds [C, R]``, one a color): each
    (replica, color-c var) flips a contiguous sub-slice interval whose two
    boundaries are drawn uniformly from that variable's kink-capable positions
    (transfers whose group acts off-diagonally on it). Creates and destroys
    kink pairs at arbitrary separations."""
    R, _, Lt = s.shape
    G = dt.G
    ltau = Lt // G
    pos = torch.arange(Lt, device=s.device)[None, None, :]
    for c in range(len(dt.color_sites)):
        sites = dt.color_sites[c]
        Cc = sites.shape[0]
        cnt = dt.comp.kink_cnt[c]
        safe = torch.from_numpy(np.maximum(cnt, 1).astype(np.int64)).to(s.device)
        ncap = safe * ltau  # capable positions per var
        offs = dt.kink_offs[c]
        flat = torch.arange(Cc, device=s.device) * offs.shape[1]
        u = _uniform_per_replica(seeds[c], (Cc, 3))

        def draw(uu):
            j = (uu * ncap[None, :]).to(torch.int32).to(_L)  # [R, Cc]
            base = torch.take(offs, flat[None, :] + j % safe[None, :]).to(_L)
            return base + G * (j // safe[None, :])  # sub-slice position in [0, Lt)

        l1 = draw(u[..., 0])
        l2 = draw(u[..., 1])
        ln = (l2 - l1) % Lt  # 0 => empty proposal (no-op)
        valid = torch.from_numpy(cnt > 0).to(s.device)
        mask = (((pos - l1[..., None]) % Lt) < ln[..., None]) & valid[None, :, None]
        si = s.index_select(1, sites)
        s_new = s.clone()
        s_new[:, sites] = torch.where(mask, -si, si)
        d = xla_sum_last(_flip_delta_per_site(dt, s, s_new, c))  # [R, Cc]
        acc = glauber(u[..., 2], d)[:, :, None]
        s[:, sites] = torch.where(acc & mask, -si, si)
    return s


def _term_delta(dt: DeviceTerms, tk: dict, s, s_new) -> torch.Tensor:
    """Per-proposal log-weight change [R, P] of one term-kink color: each
    attributed term's change summed over the transfers in XLA's order, added
    into its proposal in term order."""
    R = s.shape[0]
    delta = s.new_zeros((R, tk["P"]), dtype=_F)
    for att in tk["att"]:
        if att is None:
            continue
        blocks, T, ranks = att
        dw = xla_sum_last(_term_values(blocks, T, s_new, dt.G) - _term_values(blocks, T, s, dt.G))  # [R, T]
        for js, ps in ranks:
            delta[:, ps] += dw[:, js]
    return delta


def term_kink_update(dt: DeviceTerms, s, seeds, ltau: int):
    """Flip a multi-variable term's off-diagonal mask pattern through one of
    its own transfers, term-kink colors in turn (``seeds [ntk, R]``): the
    common boundary ``t = g + 1 + G*a`` puts the joint toggle of all mask
    variables at a transfer of the proposing term's group g, and each variable
    flips over ``[a_v, t)`` from its own independently drawn kink-capable
    boundary a_v (see ``_compile_term_kinks``). Glauber on the summed change
    of every term the proposal touches."""
    R, _, Lt = s.shape
    G = dt.G
    pos = torch.arange(Lt, device=s.device)[None, None, :]
    for tk, sd in zip(dt.tkink, seeds):
        P, kmax = tk["P"], tk["kmax"]
        u = _uniform_per_replica(sd, (P, kmax + 2))
        slab_t = torch.clamp((u[..., 0] * ltau).to(torch.int32), max=ltau - 1).to(_L)
        t = (tk["pgroup"][None] + 1 + G * slab_t) % Lt  # [R, P]
        s_new = s.clone()
        masks = []
        for slot in range(kmax):
            cnt = tk["cnt"][:, slot]
            cap = cnt * ltau
            j = torch.minimum((u[..., slot + 1] * cap[None]).to(torch.int32).to(_L), cap[None] - 1)  # [R, P]
            offs = tk["soffs"][:, slot, :]
            base = torch.take(offs, (torch.arange(P, device=s.device) * offs.shape[1])[None] + j % cnt[None])
            a = (base + G * (j // cnt[None])) % Lt
            ln = (t - a) % Lt  # 0 => this variable not flipped
            mask = ((pos - a[..., None]) % Lt) < ln[..., None]  # [R, P, Lt]
            masks.append(mask)
            sel, vv = tk["slots"][slot]
            if sel.numel():
                si = s.index_select(1, vv)
                s_new[:, vv] = torch.where(mask.index_select(1, sel), -si, si)
        acc = glauber(u[..., kmax + 1], _term_delta(dt, tk, s, s_new))
        for slot in range(kmax):
            sel, vv = tk["slots"][slot]
            if sel.numel():
                si = s.index_select(1, vv)
                do = acc.index_select(1, sel)[..., None] & masks[slot].index_select(1, sel)
                s[:, vv] = torch.where(do, -si, si)
    return s


def free_var_update(dt: DeviceTerms, s, bits):
    """Variables in no interaction are free spins: their (constant) worldlines
    take the slot's Bernoulli bits ``[nfree, R]`` (1 -> +1)."""
    if dt.free_vars.numel() == 0:
        return s
    newv = (bits.T.to(torch.int8) * 2 - 1)[:, :, None]  # [R, nF, 1]
    s[:, dt.free_vars] = newv.expand(-1, -1, s.shape[2])
    return s


def sweep_plan(comp: Compiled, ltau: int, do_loop: bool, gm: bool = False) -> list:
    """The key-chain slots of one sweep (``rng.threefry_chain``): 2C site
    phases, N_SEGMENT_PASSES fans of C, N_TERMKINK_PASSES fans of the
    term-kink colors (when there are any), C line phases, C slices with
    ``do_loop``, and the free variables' bits (nF of them on this route, n on
    the group-major route, none without free variables)."""
    C, ntk = len(comp.color_sites), len(comp.tkink)
    nF = int(comp.free_vars.shape[0])
    plan = [KEY_PLAIN] * (2 * C) + [(KEY_FAN, C)] * N_SEGMENT_PASSES
    if ntk:
        plan += [(KEY_FAN, ntk)] * N_TERMKINK_PASSES
    plan += [KEY_PLAIN] * C
    if do_loop:
        plan += [(KEY_SLICE, int(ltau))] * C
    return plan + [(KEY_BITS, (comp.touched.shape[0] if gm else nF) if nF else 0)]


def sweep(dt: DeviceTerms, s, seeds, v0, ltau: int, do_loop: bool):
    """One sweep from its rows of the key tables (``sweep_plan``'s order):
    ``seeds [C, R]`` lane seeds, ``v0 [W, R]`` slice draws and bits."""
    C = len(dt.color_sites)
    ntk = len(dt.tkink)
    col = 0
    for c in range(C):
        for parity in (0, 1):
            s = site_color_update(dt, s, seeds[col], c, parity)
            col += 1
    for _ in range(N_SEGMENT_PASSES):
        s = segment_color_update(dt, s, seeds[col:col + C])
        col += C
    if ntk:
        for _ in range(N_TERMKINK_PASSES):
            s = term_kink_update(dt, s, seeds[col:col + ntk], ltau)
            col += ntk
    for c in range(C):
        s = line_color_update(dt, s, seeds[col], c)
        col += 1
    w = 0
    if do_loop:
        for c in range(C):
            s = slice_color_update(dt, s, seeds[col], v0[w], c)
            col += 1
            w += 1
    return free_var_update(dt, s, v0[w:])


# ---------------------------------------------------------------- run functions
#
# ``keys`` is ``[R, 2]`` int32 key data on s's device (``rng.key_tensor``).
# Every run function works on a copy of ``s`` and returns the new state and keys.


def run_sweeps(dt, s, keys, timesteps, ltau, do_loop, offset):
    """``timesteps`` sweeps, the estimator accumulated after each -> ``(s,
    keys, esum)`` (a compensated pair, ``kfinal``)."""
    esum = kzero(s.shape[0], s.device)

    def step(t, x, seeds, v0):
        nonlocal esum
        x = sweep(dt, x, seeds, v0, ltau, do_loop)
        esum = kadd(esum, total_energy(dt, x, ltau, offset))
        return x

    s, keys = walk(s.clone(), keys, timesteps, sweep_plan(dt.comp, ltau, do_loop), step)
    return s, keys, esum


def run_sweeps_sample(dt, s, keys, timesteps, sampling_freq, ltau, do_loop, offset):
    """``run_sweeps`` that records slice 0 after every ``sampling_freq``-th
    sweep (``timesteps // sampling_freq`` samples; the remainder sweeps run
    after the last) -> ``(s, keys, esum, samples [R, nsamples, nvars] int8)``."""
    T, freq = int(timesteps), int(sampling_freq)
    nsamples = T // freq
    esum = kzero(s.shape[0], s.device)
    samples = []

    def step(t, x, seeds, v0):
        nonlocal esum
        x = sweep(dt, x, seeds, v0, ltau, do_loop)
        esum = kadd(esum, total_energy(dt, x, ltau, offset))
        if (t + 1) % freq == 0 and t < nsamples * freq:
            samples.append(x[:, :, 0].clone())
        return x

    s, keys = walk(s.clone(), keys, T, sweep_plan(dt.comp, ltau, do_loop), step)
    out = torch.stack(samples, 1) if samples else s.new_empty((s.shape[0], 0, s.shape[1]))
    return s, keys, esum, out


def run_sweeps_bond_sample(dt, s, keys, timesteps, sampling_freq, ltau, do_loop, offset, offsets_t, beta):
    """``timesteps // sampling_freq`` blocks of ``sampling_freq`` sweeps (the
    remainder is not run, as in the JAX engine), the per-term op counts after
    each -> ``(s, keys, esum, counts [R, nsamples, nterms] f32)``."""
    freq = int(sampling_freq)
    nsamples = int(timesteps) // freq
    esum = kzero(s.shape[0], s.device)
    samples = []

    def step(t, x, seeds, v0):
        nonlocal esum
        x = sweep(dt, x, seeds, v0, ltau, do_loop)
        esum = kadd(esum, total_energy(dt, x, ltau, offset))
        if (t + 1) % freq == 0:
            samples.append(term_op_counts(dt, x, ltau, beta, offsets_t))
        return x

    s, keys = walk(s.clone(), keys, nsamples * freq, sweep_plan(dt.comp, ltau, do_loop), step)
    out = (torch.stack(samples, 1) if samples
           else torch.zeros((s.shape[0], 0, dt.comp.nterms), dtype=_F, device=s.device))
    return s, keys, esum, out


# ---------------------------------------------------------------- host wrapper


class GenericWorldline:
    """A batch of generic-Hamiltonian worldline samplers on one device.

    ``key_data`` is ``[R, 2]`` uint32 threefry key data, kept on the host
    between calls; ``states0`` ``[R, nvars]`` +-1 the classical start,
    constant along tau (a caller may then set ``s`` ``[R, nvars, Lt]``). The
    Trotter grid and the compile are the JAX class's; the sweeps take the
    group-major route where ``gm_eligible`` admits the term set."""

    def __init__(self, termset: TermSet, beta: float, key_data, states0, do_loop_updates: bool,
                 dtau_target=None, device="cuda"):
        from . import generic_gm as gg
        from .worldline import resolve_dtau

        dtau_target = resolve_dtau(dtau_target, default=DEFAULT_DTAU)
        self.ts = termset
        self.beta = float(beta)
        norm = max([1.0] + [float(np.abs(t["mat"]).sum(axis=-1).max()) for t in termset.terms])
        ltau = max(2, int(math.ceil(self.beta * min(norm, 20.0) / dtau_target)))
        self.ltau = ltau + (ltau % 2)
        self.dtau = self.beta / self.ltau
        self.comp = compile_terms(termset.nvars, termset.terms, self.dtau)
        if (self.ltau * self.comp.G) % 2:
            self.ltau += 1
            self.dtau = self.beta / self.ltau
        self.Lt = self.ltau * self.comp.G
        self.device = torch.device(device)
        self.key_data = np.asarray(key_data, np.uint32).reshape(-1, 2).copy()
        self.do_loop = bool(do_loop_updates)
        self.offsets_t = np.array([t["offset"] for t in termset.terms], np.float32)
        s0 = torch.as_tensor(np.asarray(states0, np.int8)).to(self.device)
        self.s = s0[:, :, None].expand(-1, termset.nvars, self.Lt).contiguous()
        self.shard = None  # a parallel.comm.ReplicaShard: s and key_data then hold this rank's block
        self._dt: Optional[DeviceTerms] = None
        self.use_gm = gg.gm_eligible(self.comp, termset.nvars)
        if self.use_gm:
            self.gs = gg.compile_gm(self.comp, termset.nvars, self.device)
            self.kinks = gg.compile_gm_kinks(self.comp, self.gs, self.device) if self.comp.tkink else ()

    @property
    def dt(self) -> DeviceTerms:
        """The classic route's tables (built at first use)."""
        if self._dt is None:
            self._dt = device_terms(self.comp, self.device)
        return self._dt

    @property
    def R(self) -> int:
        return int(self.s.shape[0]) if self.shard is None else self.shard.R

    def _global(self, x):
        return x if self.shard is None else self.shard.gather(x)

    def _run(self, classic, gm, *args):
        """Call a run function of the chosen route from the current keys; keep
        its state and keys. Under a replica shard the run is this rank's block
        and the results are gathered."""
        from . import generic_gm as gg

        keys = key_tensor(self.key_data, self.device)
        if self.use_gm:
            out = getattr(gg, gm)(self.gs, self.kinks, self.comp, self.s, keys, *args)
        else:
            out = classic(self.dt, self.s, keys, *args)
        self.s = out[0]
        self.key_data = key_data_of(out[1])
        return self._global(out[2:])

    def timesteps(self, t: int):
        """t sweeps; returns the time-averaged energy estimator [R] (f64)."""
        t = int(t)
        if t == 0:
            e = total_energy(self.dt, self.s, self.ltau, self.ts.offset)
            return self._global(e).cpu().numpy().astype(np.float64)
        (esum,) = self._run(run_sweeps, "run_sweeps_gm", t, self.ltau, self.do_loop, self.ts.offset)
        return kfinal(esum) / t

    def timesteps_sample_dev(self, t: int, freq: int):
        """-> (energies [R], samples [R, t // freq, nvars] +-1 int8 on the device)."""
        esum, samples = self._run(run_sweeps_sample, "run_sweeps_sample_gm", int(t), int(freq), self.ltau,
                                  self.do_loop, self.ts.offset)
        return kfinal(esum) / max(int(t), 1), samples

    def timesteps_sample(self, t: int, freq: int):
        es, samples = self.timesteps_sample_dev(t, freq)
        return es, (samples == 1).cpu().numpy()

    def bond_sample_dev(self, t: int, freq: int):
        """-> (energies [R], op counts [R, t // freq, nterms] f32 on the device)."""
        esum, samples = self._run(run_sweeps_bond_sample, "run_sweeps_bond_sample_gm", int(t), int(freq), self.ltau,
                                  self.do_loop, self.ts.offset, self.offsets_t, self.beta)
        return kfinal(esum) / max(int(t), 1), samples

    def bond_sample(self, t: int, freq: int):
        """-> (energies [R], counts [R, t // freq, nterms] int64: the rounded
        op counts, clamped at 0)."""
        es, samples = self.bond_sample_dev(t, freq)
        counts = np.maximum(np.rint(samples.cpu().numpy().astype(np.float64)), 0).astype(np.int64)
        return es, counts

    def itime_states(self, g: int) -> np.ndarray:
        """``[Lt, nvars]`` bool: the worldline of replica g."""
        return (self._global(self.s)[g].T == 1).cpu().numpy()
