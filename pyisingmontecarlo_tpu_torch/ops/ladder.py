"""Worldline sweeps of a parallel-tempering ladder: the kernel wrapper, its
plain PyTorch version, and the host-side parameter planes.

Counterpart of ``pyisingmontecarlo_tpu/ops/wl_ladder_pallas.py``. The kernel
is ``csrc/ladder.cu``; ``ladder_sweeps`` launches it for a CUDA tensor (or
raises) and runs ``ladder_sweeps_reference`` for a CPU tensor. Spins are
``s[R, nvars, L]`` int8 in {-1, +1}, as in ``ops/wl.py``; replica r has its
own couplings and (dtau, Ktau, h, p_bond) (``LadderPlanes``).

One sweep:

1. four site phases, one per (site color, tau parity), draw ``d = 0..3``:
   Glauber acceptance in logit form, ``log(u) - log(1 - u) < -dE`` with
   ``dE = (-2 s) * (dt * (F + h) - kt * (s_up + s_dn))`` and F the field
   ``sum_b J_b s_b`` (ring ``fwd + bwd``; torus ``((y+ + y-) + x+) + x-``);
2. two Fortuin-Kasteleyn cluster phases, one per color, draws ``4 + 2c``
   (bond (tau, tau + 1) freezes when aligned and ``u < pb``) and ``5 + 2c``
   (the head flips its cluster when ``log(u) < -dE``), with the slice dE
   ``((-2 s) * dt) * (F + h)`` summed as in ``ops/wl.fk_flips``.

The uniform is ``u = min(f32(u31) * 2^-31 + 2^-32, f32(1 - 1.2e-7))``.

Two routes on the card, chosen by shape alone (``wl.resident_plan``): the
resident kernel (one launch per call, one block per replica with its plane
and couplings in shared memory, the swap features of the final state written
by the kernel) where ``wl.resident_plan`` admits the shape (lines up to
``wl.MAX_LTAU`` slices), else the multi-launch kernels (four launches a
sweep; a line too long for one block's shared memory, ``wl.cluster_long``,
takes the two ``fk_long_*`` launches a color in place of its cluster launch;
then the features of the final state from one launch of
``pt_swap_features`` after the last sweep, which reads the state once in
place of ``swap_features``' dozen torch operations). Both return the
features as int32 and equal the plain version bit for bit. Each takes any
replica count: the route and its plan are chosen from the whole shape, and
its launches run on chunks of replicas below the route's limits
(``replicas.replica_chunks``).

Randomness: the draw ``d`` of a sweep at (tau, i) is
``lane_draw31(seed, pos = tau*nvars + i, ctr = d)``; every sweep has fresh
per-replica seeds (the caller derives them from each replica's threefry key,
split once per sweep), so the counter restarts at 0.

Numerics that must match the JAX kernel bit for bit: the per-replica
dtau, Ktau and p_bond are f64 math cast once to f32 on the host
(``build_planes``); every f32 operation of a phase keeps the JAX order; the
logs are f32 ``log``. Any last-ulp difference (``log`` between libraries, or
an FMA that XLA's CPU code forms) moves a decision only when the two sides of
a comparison fall within that ulp.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import _kernels
from .lanerng import lane_draw31, make_pos_mix
from .replicas import gather_chunks, replica_chunks, rows
from .wl import LONG_LAUNCHES_PER_SWEEP, cluster_long, fk_flips, lattice_fns, long_scratch, resident_plan

__all__ = ["LadderPlanes", "build_planes", "gate", "param_bytes", "swap_features", "ladder_sweeps",
           "ladder_sweeps_reference"]

LAUNCHES_PER_SWEEP = 4  # multi-launch route: 2 site phases (both parities of a color each), 2 cluster phases
# (where the line takes fk_long_*, wl.cluster_long: 2 of those a sweep and
# wl.LONG_LAUNCHES_PER_SWEEP fk_long_* launches, in ladder_sweeps.long_launches)
MAX_POINTS = 1_000_000  # the JAX kernel's gate (wl_ladder_pallas._MAX_POINTS): nvars * L_tau of a replica
_SCALE = 1.0 / 2147483648.0  # 2^-31
_HALF_STEP = 0.5 / 2147483648.0  # 2^-32
_U_MAX = float(np.float32(1.0 - 1.2e-7))  # 1 - 2^-23


class LadderPlanes(NamedTuple):
    """The lattice (``kind`` "ring" or "torus", ``size`` = ring length or
    torus side, ``nvars``, ``ltau``) and each replica's parameters, on one
    device: ``j [R, ndir, nvars]`` f32 outgoing couplings (ring ndir = 1:
    J(i -> i+1); torus ndir = 2: J(i -> y+1), J(i -> x+1)), and ``dt``, ``kt``,
    ``h``, ``pb`` ``[R]`` f32."""

    kind: str
    size: int
    nvars: int
    ltau: int
    j: torch.Tensor
    dt: torch.Tensor
    kt: torch.Tensor
    h: torch.Tensor
    pb: torch.Tensor


def build_planes(kind: str, size: int, nvars: int, edge_a, edge_b, edge_j, betas, gammas, hs,
                 ltau: int, device="cpu") -> LadderPlanes:
    """The ladder's parameters on ``device``. ``edge_j`` is ``[E]`` (shared) or
    ``[R, E]`` (per-replica couplings; a replica's missing edge has J = 0).
    dtau = beta / L, Ktau = -1/2 log tanh(dtau Gamma) and p_bond =
    1 - exp(-2 Ktau) are f64 math, cast once to f32."""
    R = len(betas)
    ndir = 1 if kind == "ring" else 2
    ej = np.asarray(edge_j, np.float64)
    ej = np.broadcast_to(ej, (R, len(edge_a))) if ej.ndim == 1 else ej
    lookup = {}
    for k, (a, b) in enumerate(zip(np.asarray(edge_a), np.asarray(edge_b))):
        lookup[(int(a), int(b))] = lookup[(int(b), int(a))] = k
    jsite = np.zeros((R, ndir, nvars))
    for i in range(nvars):
        if kind == "ring":
            outgoing = ((i + 1) % nvars,)
        else:
            x, y = divmod(i, size)
            outgoing = (x * size + (y + 1) % size, ((x + 1) % size) * size + y)
        for d, nb in enumerate(outgoing):
            k = lookup.get((i, nb))
            if k is not None:
                jsite[:, d, i] = ej[:, k]
    dtau = np.asarray(betas, np.float64) / ltau
    ktau = -0.5 * np.log(np.tanh(dtau * np.asarray(gammas, np.float64)))
    pb = 1.0 - np.exp(-2.0 * ktau)

    def f32(v):
        return torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(device)

    return LadderPlanes(kind, int(size), int(nvars), int(ltau), f32(jsite), f32(dtau), f32(ktau),
                        f32(np.asarray(hs, np.float64)), f32(pb))


def gate(kind_size, nvars: int, ltau: int, R: int = 1) -> Optional[str]:
    """None when the kernel takes this ladder, else the reason it does not: a
    ring or torus (``kind_size`` from ``graph.detect_topology``), L_tau even
    and at least 4, an even number of sites (an even torus side), and at most
    ``MAX_POINTS`` spins a replica: the JAX kernel's gate
    (``supported_ladder``), which takes ``R`` and does not read it, nor does
    this one: the wrapper splits any R into launches
    (``replicas.replica_chunks``)."""
    if kind_size is None:
        return "the union graph is not a periodic ring or square torus"
    if ltau < 4 or ltau % 2:
        return f"L_tau={ltau} is not even and at least 4"
    if nvars % 2 or (kind_size[0] == "torus" and kind_size[1] % 2):
        return f"{nvars} sites (a {kind_size[0]} of side {kind_size[1]}) is not even"
    if nvars * ltau > MAX_POINTS:
        return f"nvars * L_tau = {nvars * ltau} spins a replica exceed {MAX_POINTS}"
    return None


def param_bytes(kind: str, nvars: int) -> int:
    """The resident block's parameter bytes: the replica's couplings ``[ndir, nvars]`` f32."""
    return (1 if kind == "ring" else 2) * nvars * 4


def swap_features(s: torch.Tensor, ea: torch.Tensor, eb: torch.Tensor):
    """``(P [R, E], S [R], A [R])`` int64 of ``s[R, nvars, L]``: the bond
    products summed over tau per edge (``ea``, ``eb``), the spin sum, and the
    aligned time bonds."""
    P = (s[:, ea] * s[:, eb]).sum(2)
    return P, s.sum((1, 2)), (s == s.roll(-1, 2)).sum((1, 2))


def _check(s, seeds, planes: LadderPlanes, T: int, edges):
    """Validate the arguments shared by the kernel and the plain version."""
    if s.dtype != torch.int8 or s.dim() != 3:
        raise ValueError(f"s must be [R, nvars, L] int8, got {tuple(s.shape)} {s.dtype}")
    R, nvars, L = s.shape
    if (nvars, L) != (planes.nvars, planes.ltau):
        raise ValueError(f"s is [R, {nvars}, {L}], the planes are for [R, {planes.nvars}, {planes.ltau}]")
    why = gate((planes.kind, planes.size), nvars, L, R)
    if why:
        raise ValueError(f"the ladder kernel does not take this shape: {why}")
    if seeds.dtype != torch.int32 or tuple(seeds.shape) != (T, R):
        raise ValueError(f"seeds must be [{T}, {R}] int32, got {tuple(seeds.shape)} {seeds.dtype}")
    ndir = 1 if planes.kind == "ring" else 2
    want = {"j": (R, ndir, nvars), "dt": (R,), "kt": (R,), "h": (R,), "pb": (R,)}
    for name, shape in want.items():
        t = getattr(planes, name)
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"planes.{name} must be {list(shape)} float32, got {tuple(t.shape)} {t.dtype}")
    for name, t in [("seeds", seeds)] + [(f"planes.{k}", getattr(planes, k)) for k in want]:
        if t.device != s.device:
            raise ValueError(f"{name} is on {t.device}, s on {s.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not s.is_contiguous():
        raise ValueError("s must be contiguous")
    ea, eb = edges
    for name, t in (("ea", ea), ("eb", eb)):
        if t.dtype != torch.int32 or t.dim() != 1 or t.shape != ea.shape:
            raise ValueError(f"{name} must be [E] int32 like ea, got {tuple(t.shape)} {t.dtype}")
        if t.device != s.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {s.device}")


def _field_fn(planes: LadderPlanes):
    """``field(sf)`` -> the f32 field of ``sf[R, nvars, L]`` in the JAX order."""
    j = planes.j[..., None]  # [R, ndir, nvars, 1]
    if planes.kind == "ring":
        j0 = j[:, 0]

        def field(sf):
            return j0 * sf.roll(-1, 1) + (j0 * sf).roll(1, 1)

        return field
    m = planes.size
    j1 = j[:, 0].reshape(-1, m, m, 1)  # J(i -> y+1), i = x * m + y
    j2 = j[:, 1].reshape(-1, m, m, 1)  # J(i -> x+1)

    def field(sf):
        q = sf.view(sf.shape[0], m, m, -1)
        yp, ym = j1 * q.roll(-1, 2), (j1 * q).roll(1, 2)
        xp, xm = j2 * q.roll(-1, 1), (j2 * q).roll(1, 1)
        return (((yp + ym) + xp) + xm).view(sf.shape)

    return field


def ladder_sweeps_reference(s, seeds, planes: LadderPlanes, T: int, edges):
    """Plain PyTorch version of ``ladder_sweeps``: same arguments, same result."""
    _check(s, seeds, planes, T, edges)
    _, nvars, L = s.shape
    dev = s.device
    color0, _, _ = lattice_fns(planes.kind, planes.size, nvars, dev)
    cmask = (color0, ~color0)
    tau = torch.arange(L, device=dev)[None, :]
    tmask = (tau % 2 == 0, tau % 2 == 1)
    pos1, pos2 = make_pos_mix(tau, torch.arange(nvars, device=dev)[:, None], nvars)
    field = _field_fn(planes)
    dt, kt, h, pb = (v[:, None, None] for v in (planes.dt, planes.kt, planes.h, planes.pb))
    x = s.to(torch.int32)

    for t in range(T):
        seed = seeds[t][:, None, None]

        def uniform(ctr):
            u = lane_draw31(seed, pos1, pos2, ctr).to(torch.float32) * _SCALE + _HALF_STEP
            return u.clamp(max=_U_MAX)

        d = 0
        for color in (0, 1):
            for parity in (0, 1):
                sf = x.to(torch.float32)
                ud = (x.roll(-1, 2) + x.roll(1, 2)).to(torch.float32)
                dE = (-2.0 * sf) * (dt * (field(sf) + h) - kt * ud)
                u = uniform(d)
                acc = (torch.log(u) - torch.log(1.0 - u) < -dE) & cmask[color] & tmask[parity]
                x = torch.where(acc, -x, x)
                d += 1
        for color in (0, 1):
            sf = x.to(torch.float32)
            active = ((x == x.roll(-1, 2)) & (uniform(d) < pb)).to(torch.int32)
            de = ((-2.0 * sf) * dt) * (field(sf) + h)
            x = torch.where(fk_flips(active, de, torch.log(uniform(d + 1))) & cmask[color], -x, x)
            d += 2
    x = x.to(torch.int8)
    return x, swap_features(x, *edges)


def _planes_rows(planes: LadderPlanes, a: int, b: int) -> LadderPlanes:
    """Replicas ``[a, b)`` of ``planes`` (views)."""
    return planes._replace(**{k: getattr(planes, k)[a:b] for k in ("j", "dt", "kt", "h", "pb")})


def _planes_args(planes: LadderPlanes, a: int, b: int):
    """The addresses of replicas ``[a, b)`` of the parameter planes."""
    return [rows(getattr(planes, k), a, b) for k in ("j", "dt", "kt", "h", "pb")]


def _chunk_seeds(seeds, a: int, b: int, R: int):
    """Columns ``[a, b)`` of ``seeds[T, R]``, contiguous (the tensor itself for all of them)."""
    return seeds if (a, b) == (0, R) else seeds[:, a:b].contiguous()


def _run_multi(s, seeds, planes: LadderPlanes, T: int, edges=None):
    """The multi-launch route on a CUDA tensor (``LAUNCHES_PER_SWEEP``
    launches a sweep and chunk of replicas, counted in
    ``ladder_sweeps.launches``; where ``wl.cluster_long``, 2 of them and
    ``wl.LONG_LAUNCHES_PER_SWEEP`` in ``ladder_sweeps.long_launches``); the
    new state. With ``edges``, ``(state, features)``: after a chunk's last
    sweep (T may be 0) one launch of ``pt_swap_features`` a chunk, counted in
    ``ladder_sweeps.feature_launches``, writes its rows of one ``[R, E + 2]``
    int32 tensor, returned as ``_run_resident`` returns it."""
    R, nvars, L = s.shape
    x = s.clone()
    feat, E, eptr = None, 0, (None, None)
    if edges is not None:
        E = edges[0].numel()
        feat = torch.empty((R, E + 2), dtype=torch.int32, device=s.device)
        eptr = tuple(e.data_ptr() for e in edges)
    if R and (T or feat is not None):
        with torch.cuda.device(x.device):
            long = cluster_long(L, _kernels.device_limits(x.device)[0])
            chunks = replica_chunks(R, nvars * L, "long" if long else "multi")
            scratch = long_scratch(x[:chunks[0][1]])
            for a, b in chunks:
                sd = _chunk_seeds(seeds, a, b, R)
                _kernels.call("ladder kernel", lambda lib: lib.ladder_sweeps(
                    rows(x, a, b), sd.data_ptr(), *_planes_args(planes, a, b),
                    None if scratch is None else scratch.data_ptr(), *eptr, rows(feat, a, b),
                    b - a, nvars, L, int(planes.kind == "torus"), planes.size, T, E, _kernels.stream(x)))
                if scratch is not None:  # the library's route: fk_long_*
                    ladder_sweeps.launches += 2 * T
                    ladder_sweeps.long_launches += LONG_LAUNCHES_PER_SWEEP * T
                else:
                    ladder_sweeps.launches += LAUNCHES_PER_SWEEP * T
                ladder_sweeps.feature_launches += int(feat is not None)
    if feat is None:
        return x
    return x, (feat[:, :E], feat[:, E], feat[:, E + 1])


def _run_resident(s, seeds, planes: LadderPlanes, T: int, edges, plan):
    """The resident route on a CUDA tensor (one launch a chunk of replicas,
    counted in ``ladder_sweeps.resident_launches``), with ``plan = (tile,
    bytes)`` from ``wl.resident_plan``; the features are the kernel's (int32
    views of one ``[R, E + 2]`` tensor). ``ladder_sweeps``' result."""
    R, nvars, L = s.shape
    x = s.clone()
    if not (R and T):
        return x, swap_features(x, *edges)
    ea, eb = edges
    E = ea.numel()
    feat = torch.empty((R, E + 2), dtype=torch.int32, device=s.device)
    tile, nbytes = plan
    with torch.cuda.device(x.device):
        for a, b in replica_chunks(R, nvars * L, "ladder_resident"):
            sd = _chunk_seeds(seeds, a, b, R)
            _kernels.call("ladder resident kernel", lambda lib: lib.ladder_resident_sweeps(
                rows(x, a, b), sd.data_ptr(), *_planes_args(planes, a, b), ea.data_ptr(), eb.data_ptr(),
                rows(feat, a, b), b - a, nvars, L, int(planes.kind == "torus"), planes.size, T, E, tile, nbytes,
                _kernels.stream(x)))
            ladder_sweeps.resident_launches += 1
    return x, (feat[:, :E], feat[:, E], feat[:, E + 1])


def ladder_sweeps(s: torch.Tensor, seeds: torch.Tensor, planes: LadderPlanes, T: int, edges):
    """Run ``T`` sweeps on ``s[R, nvars, L]`` int8 (not modified); returns
    ``(state, features)``. ``seeds[T, R]`` int32 keys sweep t's draws (counter
    ``d = 0..7`` within each sweep); ``edges = (ea, eb)`` are ``[E]`` int32
    site indices in ``[0, nvars)``, and the features ``(P [R, E], S [R],
    A [R])`` of the new state are those ``swap_features`` gives (int32 views
    of one ``[R, E + 2]`` tensor from the kernels, int64 on the CPU).

    A CUDA tensor launches ``csrc/ladder.cu`` or raises: the resident kernel
    (one launch, counted in ``ladder_sweeps.resident_launches``) where
    ``wl.resident_plan`` admits the shape, else the multi-launch kernels
    (``LAUNCHES_PER_SWEEP`` a sweep, counted in ``ladder_sweeps.launches``;
    for a line past one block, ``wl.cluster_long``, 2 there and
    ``wl.LONG_LAUNCHES_PER_SWEEP`` in ``ladder_sweeps.long_launches``; the
    features then from ``pt_swap_features``, one launch a chunk, counted in
    ``ladder_sweeps.feature_launches``), each on chunks of replicas below its
    limits (``replicas.replica_chunks``). A CPU tensor runs the plain version,
    in the chunks of the strictest route, ``"long"``."""
    T = int(T)
    _check(s, seeds, planes, T, edges)
    R, nvars, L = s.shape
    if s.device.type == "cpu":
        def run(a, b):
            x, feats = ladder_sweeps_reference(s[a:b], _chunk_seeds(seeds, a, b, R), _planes_rows(planes, a, b), T,
                                               edges)
            return (x, *feats)

        x, *feats = gather_chunks(R, replica_chunks(R, nvars * L, "long"), run)
        return x, tuple(feats)
    if s.device.type != "cuda":
        raise ValueError(f"ladder_sweeps runs on cuda or cpu tensors, got {s.device}")
    plan = resident_plan(nvars, L, R, param_bytes(planes.kind, nvars), *_kernels.device_limits(s.device))
    if plan:
        return _run_resident(s, seeds, planes, T, edges, plan)
    return _run_multi(s, seeds, planes, T, edges=edges)


ladder_sweeps.launches = 0
ladder_sweeps.long_launches = 0
ladder_sweeps.resident_launches = 0
ladder_sweeps.feature_launches = 0
