"""Counter-based random draws, as torch tensor functions.

The same hash as ``pyisingmontecarlo_tpu/ops/lanerng.py`` and as the device
function in ``csrc/lanerng.cuh``:

    u31 = h(seed, pos, ctr)

a pure function of a replica's 32-bit seed, a replica-local position and a
draw counter, so a replica's stream does not depend on batch size or launch
layout. ``(pos, ctr)`` maps injectively onto two 32-bit words
``a = seed + pos*P1 + ctr*G1`` and ``b = pos*P2 + ctr*G2`` (odd determinant,
so distinct only mod 2^32); ``a`` goes through the murmur3 fmix32 finalizer and
``b`` is folded in with one more xor-mul-xor round.

Torch has no uint32 arithmetic and its ``>>`` on int32 is arithmetic, so the
words are held in int64 in [0, 2^32): every add and multiply is reduced with
``& 0xFFFFFFFF``, and every shift then acts on a non-negative value, i.e. is
logical. Multiplies by a constant are split into 16-bit halves so no product
exceeds 2^49.
"""

from __future__ import annotations

import torch

__all__ = ["make_pos_mix", "lane_draw31"]

_M32 = 0xFFFFFFFF

# (pos, ctr) -> (a, b) is injective mod 2^32: det([[P1, G1], [P2, G2]]) is odd
_P1 = 0x9E3779B1
_P2 = 0x85EBCA77
_G1 = 0xC2B2AE3D
_G2 = 0x27D4EB2E


def _u32(x: torch.Tensor) -> torch.Tensor:
    """Any integer tensor -> its two's-complement 32-bit word, as int64."""
    return x.to(torch.int64) & _M32


def _mul(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32) (int64) and a constant c."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def make_pos_mix(tau: torch.Tensor, i: torch.Tensor, nvars: int):
    """Position words ``(pos*P1, pos*P2)`` for ``pos = tau*nvars + i``.

    Integer tensors of any dtype in, int64 words in [0, 2^32) out."""
    pos = (_mul(_u32(tau), int(nvars) & _M32) + _u32(i)) & _M32
    return _mul(pos, _P1), _mul(pos, _P2)


def lane_draw31(seed: torch.Tensor, pos1: torch.Tensor, pos2: torch.Tensor, ctr: int) -> torch.Tensor:
    """31-bit non-negative uniform draws (int32) for the host counter ``ctr``.

    ``seed`` is an int32 tensor that broadcasts against the position words."""
    c = int(ctr) & _M32
    a = (_u32(seed) + pos1 + ((c * _G1) & _M32)) & _M32
    x = a ^ (a >> 16)
    x = _mul(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    b = (pos2 + ((c * _G2) & _M32)) & _M32
    x = x ^ b
    x = x ^ (x >> 16)
    x = _mul(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    return (x >> 1).to(torch.int32)
