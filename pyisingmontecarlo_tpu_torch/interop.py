"""Carry a problem across from the JAX package, and spins between numpy and torch.

``lattice_from_reference`` reads a ``pyisingmontecarlo_tpu.Lattice`` by
attribute only (no jax import): its edges, bias, transverse field, initial
state, flags and dtau, and the state of its master seed stream, so that both
objects then draw identical u64 seeds. ``worldline_from_arrays`` builds a
worldline ensemble from a JAX ensemble's state and key data, handed over as
numpy arrays. ``tempering_from_reference`` does both for a
``pyisingmontecarlo_tpu.LatticeTempering``, ``classicising_from_reference``
for a ``pyisingmontecarlo_tpu.ClassicIsing``, ``qmcising_from_reference``
for a ``pyisingmontecarlo_tpu.QmcIsing`` and ``qmcrunner_from_reference`` for
a ``pyisingmontecarlo_tpu.QmcRunner``.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from ._kernels import resolve_device
from .classicising import ClassicIsing
from .engines.worldline import WorldlineEnsemble
from .graph import compile_graph, grid_2d_edges
from .lattice import Lattice
from .qmcising import QmcIsing
from .qmcrunner import QmcRunner
from .tempering import LatticeTempering

__all__ = ["lattice_from_reference", "worldline_from_arrays", "tempering_from_reference",
           "classicising_from_reference", "qmcising_from_reference", "qmcrunner_from_reference", "state_to_torch",
           "state_to_numpy"]


def lattice_from_reference(obj, device="cuda") -> Lattice:
    """A port ``Lattice`` with the problem definition and seed stream of ``obj``."""
    lat = Lattice(obj.edges, seed_gen=obj.rng.seed_gen, use_allocator=obj.use_allocator,
                  dtau=obj.dtau, device=device)
    lat.rng._gen.bit_generator.state = obj.rng._gen.bit_generator.state
    lat.bias = copy.deepcopy(obj.bias)
    lat.transverse = obj.transverse
    lat.initial_state = None if obj.initial_state is None else np.array(obj.initial_state, dtype=bool)
    lat.enable_rvb = bool(obj.enable_rvb)
    lat.enable_heatbath = bool(obj.enable_heatbath)
    lat.enable_cluster = bool(obj.enable_cluster)
    return lat


def worldline_from_arrays(s, key_data, beta: float, gamma: float, h: float, ltau: int, dense,
                          device="cuda") -> WorldlineEnsemble:
    """A worldline ensemble at state ``s[R, nvars, L]`` (+-1) with threefry key
    data ``key_data[R, 2]`` (uint32; ``jax.random.key_data`` of the JAX
    ensemble's keys) on the lattice ``dense`` = ``("ring", n, J)`` or
    ``("torus", L, J)``."""
    kind, size, j = dense
    if kind == "ring":
        edges = [((i, (i + 1) % size), float(j)) for i in range(size)]
    else:
        edges = grid_2d_edges(size, size, float(j))
    s = np.array(s, dtype=np.int8)
    return WorldlineEnsemble(compile_graph(edges), gamma, h, beta, np.asarray(key_data, np.uint32),
                             s.shape[0], ltau=ltau, states=torch.from_numpy(s),
                             device=resolve_device(device))


def tempering_from_reference(obj, device="cuda", state=None) -> LatticeTempering:
    """A port ``LatticeTempering`` with the ladder and seed stream of ``obj``
    (its edges, graphs with their seeds, dtau, swap count, pending
    checkpoint states and master seed stream), so that both then run
    identically. Once ``obj`` has drawn its swap key (its first run), its
    device state must come as ``state``: numpy ``s [R, nvars, L]`` (+-1),
    ``key_data [R, 2]`` and ``swapkey [2]`` (uint32; ``jax.random.key_data``
    of its keys) and ``phase``, the parity of its next swap step."""
    lt = LatticeTempering(obj.edges, seed=obj.seed, use_allocator=obj.use_allocator, dtau=obj.dtau,
                          device=device)
    lt.rng._gen.bit_generator.state = obj.rng._gen.bit_generator.state
    lt.graphs = [dict(g) for g in obj.graphs]
    lt._edge_index = dict(obj._edge_index)
    lt.total_swaps = int(obj.total_swaps)
    restored = getattr(obj, "_restored", None)
    if restored is not None:
        lt._restored = torch.from_numpy(np.array(restored["states"], dtype=np.int8))
    if state is None:
        if obj._swapkey is not None:
            raise ValueError("the reference has run: pass its state (s, key_data, swapkey, phase)")
        return lt
    lt._swapkey = np.asarray(state["swapkey"], np.uint32).reshape(2)
    m = lt._materialize()
    s = torch.from_numpy(np.array(state["s"], dtype=np.int8)).to(m["s"].device)
    if s.shape != m["s"].shape:
        raise ValueError(f"state s is {tuple(s.shape)}, the ladder is {tuple(m['s'].shape)}")
    m["s"] = s.contiguous()
    m["key_data"] = np.asarray(state["key_data"], np.uint32).reshape(-1, 2)
    m["phase"] = int(state["phase"])
    return lt


def classicising_from_reference(obj, key_data, device="cuda") -> ClassicIsing:
    """A port ``ClassicIsing`` in the state of ``obj``: its edges, field, move
    settings, importance flags and master seed stream, its spins, and its
    keys as ``key_data`` ``[R, 2]`` uint32 (``jax.random.key_data(obj._keys)``,
    which the caller reads, as this module imports no jax). Both then run
    identically."""
    ci = ClassicIsing(obj.edges, longitudinal=obj.longitudinal, num_experiments=0, seed=obj.rng.seed_gen,
                      use_basic_moves=obj.use_basic_moves, device=device)
    ci.rng._gen.bit_generator.state = obj.rng._gen.bit_generator.state
    ci.enable_cluster = bool(obj.enable_cluster)
    ci._imp_flags = [bool(f) for f in obj._imp_flags]
    spins = np.array(obj._spins, dtype=np.int8).reshape(-1, ci.nvars)
    kd = np.asarray(key_data, np.uint32).reshape(-1, 2)
    if not len(spins) == len(kd) == len(ci._imp_flags):
        raise ValueError(f"{len(spins)} states, {len(kd)} keys and {len(ci._imp_flags)} flags")
    ci._spins = torch.from_numpy(spins).to(ci.device)
    ci._keys = kd.copy()
    return ci


def qmcising_from_reference(obj, key_data, device="cuda") -> QmcIsing:
    """A port ``QmcIsing`` in the state of ``obj``: its edges, fields, flags,
    Trotter-step target and master seed stream; once materialized its
    worldlines ``s [R, nvars, L]`` and the f32 parameters of its ensemble
    (so the sweeps start from the JAX package's f32 ``dtau``, ``ktau``, ...),
    else its pending initial states; and its keys as ``key_data`` ``[R, 2]``
    uint32 (``jax.random.key_data`` of ``obj._w.keys`` once materialized,
    else of ``obj._keys``; the caller reads it, as this module imports no
    jax). Both then run identically."""
    q = QmcIsing(obj.edges, obj.transverse, obj.longitudinal, num_experiments=0, seed=obj.seed,
                 use_allocator=obj.use_allocator, do_heatbath_updates=obj.enable_heatbath,
                 do_rvb_updates=obj.enable_rvb, dtau=obj.dtau, device=device)
    q.rng._gen.bit_generator.state = obj.rng._gen.bit_generator.state
    kd = np.asarray(key_data, np.uint32).reshape(-1, 2).copy()
    w = obj._w
    if w is not None:
        s = torch.from_numpy(np.array(w.s, dtype=np.int8))
        if s.shape[0] != len(kd):
            raise ValueError(f"{s.shape[0]} worldlines and {len(kd)} keys")
        q._w = q._ensemble(w.beta, s, kd, w.L, params=[np.asarray(x, np.float32) for x in w.p])
        q._w.enable_rvb, q._w.enable_heatbath = bool(w.enable_rvb), bool(w.enable_heatbath)
    elif obj._keys is not None:
        init = np.array(obj._init_states, dtype=np.int8).reshape(-1, q.nvars)
        if len(init) != len(kd):
            raise ValueError(f"{len(init)} initial states and {len(kd)} keys")
        q._keys, q._init_states = kd, init
    return q


def state_to_torch(np_state, device="cpu") -> torch.Tensor:
    """``[R, L, L]`` int8 spins (numpy, any array-like) -> a contiguous tensor."""
    a = np.ascontiguousarray(np_state, dtype=np.int8)
    if a.ndim != 3:
        raise ValueError(f"expected [R, L, L] spins, got shape {a.shape}")
    return torch.from_numpy(a).to(device)


def state_to_numpy(t: torch.Tensor) -> np.ndarray:
    """``[R, L, L]`` int8 spin tensor -> numpy."""
    if t.dtype != torch.int8 or t.dim() != 3:
        raise ValueError(f"expected [R, L, L] int8 spins, got {tuple(t.shape)} {t.dtype}")
    return t.detach().cpu().numpy()


def qmcrunner_from_reference(obj, key_data, device="cuda") -> QmcRunner:
    """A port ``QmcRunner`` in the state of ``obj`` (a
    ``pyisingmontecarlo_tpu.QmcRunner``): its term set and offset, flags,
    Trotter-step target and master seed stream; once materialized its beta and
    worldlines ``s [R, nvars, Lt]``, else its pending initial states; and its
    keys as ``key_data`` ``[R, 2]`` uint32 (``jax.random.key_data`` of
    ``obj._w.keys`` once materialized, else of ``obj._keys``; the caller reads
    it, as this module imports no jax). Both then run identically."""
    q = QmcRunner(obj.nvars, 0, seed=obj.rng.seed_gen, use_allocator=obj.use_allocator,
                  do_loop_updates=obj.do_loop_updates, do_heatbath_updates=obj.do_heatbath_updates, dtau=obj.dtau,
                  device=device)
    q.rng._gen.bit_generator.state = obj.rng._gen.bit_generator.state
    q.terms.terms = [dict(mat=np.array(t["mat"], np.float64), vars=tuple(int(v) for v in t["vars"]),
                          offset=float(t["offset"])) for t in obj.terms.terms]
    q.terms.offset = float(obj.terms.offset)
    kd = np.asarray(key_data, np.uint32).reshape(-1, 2).copy()
    w = obj._w
    if w is not None:
        s = np.array(w.s, dtype=np.int8)
        if s.shape[0] != len(kd):
            raise ValueError(f"{s.shape[0]} worldlines and {len(kd)} keys")
        q._w = q._worldline(w.beta, kd, s[:, :, 0])
        if (q._w.ltau, q._w.Lt) != (w.ltau, w.Lt):
            raise ValueError(f"the port's grid (ltau {q._w.ltau}, Lt {q._w.Lt}) differs from the reference's "
                             f"(ltau {w.ltau}, Lt {w.Lt})")
        q._w.s = torch.from_numpy(s).to(q.device)
        q._w.do_loop = bool(w.do_loop)
    elif obj._keys is not None:
        init = np.array(obj._init_states, dtype=np.int8).reshape(-1, q.nvars)
        if len(init) != len(kd):
            raise ValueError(f"{len(init)} initial states and {len(kd)} keys")
        q._keys, q._init_states = kd, init
    return q
