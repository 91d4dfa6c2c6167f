"""Compensated (Neumaier) f32 accumulation for long sweep loops, on torch.

Counterpart of ``pyisingmontecarlo_tpu/utils/accum.py``. A plain f32 running
sum of per-sweep energies loses about log10(n) digits over n sweeps; the pair
``(hi, lo)`` folds every add's exact f32 rounding error into ``lo``, and the
host collapse ``kfinal`` keeps the pair's precision in f64. ``kadd`` keeps the
JAX package's operation order, so on the CPU both give the same pair bit for
bit for the same addends.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["kzero", "kadd", "kfinal"]


def kzero(shape, device="cpu"):
    """A fresh compensated accumulator ``(hi, lo)`` of f32 zeros."""
    return (torch.zeros(shape, dtype=torch.float32, device=device),
            torch.zeros(shape, dtype=torch.float32, device=device))


def kadd(acc, x: torch.Tensor):
    """``acc + x`` with Neumaier error compensation."""
    hi, lo = acc
    s = hi + x
    swap = hi.abs() >= x.abs()
    big = torch.where(swap, hi, x)
    small = torch.where(swap, x, hi)
    return s, lo + ((big - s) + small)


def kfinal(acc) -> np.ndarray:
    """Collapse the pair on the host to numpy f64."""
    hi, lo = acc
    return hi.cpu().numpy().astype(np.float64) + lo.cpu().numpy().astype(np.float64)
