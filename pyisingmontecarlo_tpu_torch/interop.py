"""Carry a problem across from the JAX package, and spins between numpy and torch.

``lattice_from_reference`` reads a ``pyisingmontecarlo_tpu.Lattice`` by
attribute only (no jax import): its edges, bias, transverse field, initial
state, flags and dtau, and the state of its master seed stream, so that both
objects then draw identical u64 seeds.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from .lattice import Lattice

__all__ = ["lattice_from_reference", "state_to_torch", "state_to_numpy"]


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
