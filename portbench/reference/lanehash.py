"""The counter hash that keys every kernel draw, in plain torch.

``u31 = h(seed, pos, ctr)``: with ``a = seed + pos*P1 + ctr*G1`` and
``b = pos*P2 + ctr*G2`` (all mod 2^32), ``a`` goes through murmur3's fmix32
finalizer, ``b`` is folded in with one more xor-multiply-xor round, and the
top 31 bits are the draw. Written on int32 tensors: torch's int32 add and
multiply wrap mod 2^32, and a logical right shift is the arithmetic one
masked to the bits that stay.
"""

from __future__ import annotations

import torch

__all__ = ["P1", "P2", "G1", "G2", "wrap32", "pos_words", "draw31"]

P1, P2, G1, G2 = 0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2E
_M1, _M2, _M3 = 0x85EBCA6B, 0xC2B2AE35, 0x7FEB352D


def wrap32(c: int) -> int:
    """The int32 value of the 32-bit word ``c mod 2^32``."""
    c &= 0xFFFFFFFF
    return c - (1 << 32) if c >= 1 << 31 else c


def _shr(x: torch.Tensor, k: int) -> torch.Tensor:
    return (x >> k) & ((1 << (32 - k)) - 1)


def pos_words(pos: torch.Tensor):
    """``(pos*P1, pos*P2)`` as int32 words of an integer position tensor."""
    p = pos.to(torch.int64) & 0xFFFFFFFF
    p = torch.where(p >= 1 << 31, p - (1 << 32), p).to(torch.int32)
    return p * wrap32(P1), p * wrap32(P2)


def draw31(seed: torch.Tensor, pw1: torch.Tensor, pw2: torch.Tensor, ctr) -> torch.Tensor:
    """31-bit draws (int32, non-negative) at counter ``ctr`` (an int, or an
    int32 tensor) for int32 seeds that broadcast against the position words
    of ``pos_words``."""
    if isinstance(ctr, torch.Tensor):
        c1, c2 = ctr * wrap32(G1), ctr * wrap32(G2)
    else:
        c1, c2 = wrap32(ctr * G1), wrap32(ctr * G2)
    a = seed + pw1 + c1
    x = a ^ _shr(a, 16)
    x = x * wrap32(_M1)
    x = x ^ _shr(x, 13)
    x = x * wrap32(_M2)
    x = x ^ _shr(x, 16)
    x = x ^ (pw2 + c2)
    x = x ^ _shr(x, 16)
    x = x * wrap32(_M3)
    x = x ^ _shr(x, 15)
    return _shr(x, 1)
