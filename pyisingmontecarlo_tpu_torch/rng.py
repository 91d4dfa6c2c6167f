"""Master seed stream, threefry keys on the host, and per-replica kernel seeds.

``MasterRng`` is the JAX package's (numpy PCG64, one u64 per experiment), so
the same ``seed_gen`` gives the same u64 seeds in both packages. The JAX
package turns each u64 into a threefry2x32 key; the port keeps the key's two
32-bit words as numpy ``[R, 2]`` uint32 key data and reproduces, bit for bit,
the three threefry operations its paths use: ``fold_in`` (continuing a
replica's stream from one call to the next), ``bernoulli(key, 0.5, (n,))``
(random initial states) and the 32-bit kernel seed of each key. These are
``[R]``-sized host operations done once per call. All further randomness is
the counter hash of ``ops/lanerng.py``.

The graph engines split each replica's key once for every move of every time
step (or phase of every sweep; the generic k-local sweep also splits a
sub-key again per color, draws a slice and draws Bernoulli bits: the fan,
slice and bits slots); ``LatticeTempering`` splits each replica's key once a
sweep and its one swap key once a swap step, drawing ``uniform(sub, (R,))``
(the plain and uniform slots). ``threefry_chain`` walks that chain for a whole call:
on a CUDA tensor in one launch of the kernel of ``csrc/keychain.cu`` (a warp
walks the serial key spine of 32 replicas, others expand each slot's
sub-key into its outputs), on a CPU tensor in its plain numpy version
``threefry_chain_reference``; both write the same tables bit for bit. The
sharded sweeps of ``parallel/`` draw ``uniform(key, shape)`` over whole state
shapes: ``threefry_bits`` makes those bits (or uniforms) for R keys, on a
CUDA tensor in one launch of ``threefry_bits`` of ``csrc/keychain.cu``, on a
CPU tensor by ``random_bits`` / ``uniform_f32``.

Threefry2x32 is the 20-round Threefish-derived block function with the key
schedule ``(k0, k1, k0 ^ k1 ^ 0x1BD11BDA)``. Under jax's partitionable mode
(the default of the JAX version the package is held against), the i-th 32-bit
word of ``random_bits(key, (n,))`` is ``x0 ^ x1`` of the block function at
counter ``(i >> 32, i & 0xFFFFFFFF)``, and ``fold_in(key, d)`` is the block
function of ``key`` at counter ``(0, d)``; ``split(key, 2)[i]`` is the block
function at counter ``(0, i)``.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np
import torch

from . import _kernels

__all__ = [
    "MasterRng",
    "key_data_from_seeds",
    "threefry2x32",
    "fold_all",
    "split_all",
    "random_bits",
    "uniform_f32",
    "random_states",
    "seeds_from_key_data",
    "replica_seeds_i32",
    "randint",
    "KEY_PLAIN",
    "KEY_WORM",
    "KEY_CLUSTER",
    "KEY_FAN",
    "KEY_SLICE",
    "KEY_BITS",
    "KEY_UNIFORM",
    "chain_columns",
    "threefry_chain",
    "threefry_chain_reference",
    "threefry_bits",
    "key_tensor",
    "key_data_of",
]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


class MasterRng:
    """Master seed generator: ``seed_gen=None`` seeds from OS entropy, a
    fixed ``seed_gen`` gives the same seed sequence on every run, and
    successive ``make_seeds`` calls advance the stream."""

    def __init__(self, seed_gen: Optional[int] = None):
        self.reset(seed_gen)

    def reset(self, seed_gen: Optional[int]) -> None:
        self.seed_gen = seed_gen
        self._gen = np.random.Generator(np.random.PCG64(seed_gen))

    def make_seeds(self, num_experiments: int) -> np.ndarray:
        """One u64 per experiment. Returns uint64[n]."""
        n = int(num_experiments)
        if n < 0:
            raise ValueError("num_experiments must be non-negative")
        # one draw per experiment so seed i is independent of the batch size
        return self._gen.integers(0, 2**64, size=n, dtype=np.uint64)

    def next_seed(self) -> int:
        return int(self.make_seeds(1)[0])

    def clone(self) -> "MasterRng":
        other = MasterRng(self.seed_gen)
        other._gen.bit_generator.state = self._gen.bit_generator.state
        return other


def key_data_from_seeds(seeds_u64) -> np.ndarray:
    """uint64[n] experiment seeds -> ``[n, 2]`` uint32 threefry key data
    ``[hi, lo]``: the words of the JAX package's ``keys_from_seeds``."""
    seeds = np.asarray(seeds_u64, dtype=np.uint64)
    hi = (seeds >> np.uint64(32)).astype(np.uint32)
    lo = (seeds & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return np.stack([hi, lo], axis=-1)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(k0, k1, x0, x1):
    """The threefry2x32 block function on broadcastable uint32 arrays: key
    ``(k0, k1)``, counter ``(x0, x1)``; returns the two output words."""
    k0, k1, x0, x1 = (np.asarray(v, dtype=np.uint32) for v in (k0, k1, x0, x1))
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x0 = x0 + ks[0]
        x1 = x1 + ks[1]
        for n in range(5):
            for r in _ROTATIONS[n % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(n + 1) % 3]
            x1 = x1 + ks[(n + 2) % 3] + np.uint32(n + 1)
    return x0, x1


def fold_all(key_data: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)`` for every key of ``[R, 2]`` key data."""
    kd = np.asarray(key_data, dtype=np.uint32)
    d = np.uint32(int(data) & 0xFFFFFFFF)
    y0, y1 = threefry2x32(kd[:, 0], kd[:, 1], np.uint32(0), d)
    return np.stack([y0, y1], axis=-1)


def split_all(key_data: np.ndarray):
    """``jax.random.split(key)`` for every key of ``[R, 2]`` key data ->
    ``(next [R, 2], sub [R, 2])``, the JAX package's ``split_keys``."""
    kd = np.asarray(key_data, dtype=np.uint32).reshape(-1, 2)
    y0, y1 = threefry2x32(kd[:, :1], kd[:, 1:], np.uint32(0), np.arange(2, dtype=np.uint32))
    out = np.stack([y0, y1], axis=-1)  # [R, 2 (next, sub), 2 (words)]
    return out[:, 0], out[:, 1]


def random_bits(key_data: np.ndarray, n: int) -> np.ndarray:
    """``jax.random.bits(key, (n,))`` (32-bit words) for every key -> ``[R, n]`` uint32."""
    kd = np.asarray(key_data, dtype=np.uint32).reshape(-1, 2)
    idx = np.arange(int(n), dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32)[None, :]
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)[None, :]
    y0, y1 = threefry2x32(kd[:, :1], kd[:, 1:], hi, lo)
    return y0 ^ y1


def uniform_f32(key_data: np.ndarray, n: int) -> np.ndarray:
    """``jax.random.uniform(key, (n,))`` (f32 in [0, 1)) for every key ->
    ``[R, n]`` float32: the top 23 bits as the mantissa of a float in [1, 2),
    minus 1."""
    bits = random_bits(key_data, n)
    return ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)


def random_states(key_data: np.ndarray, nvars: int) -> np.ndarray:
    """Random +-1 states ``[R, nvars]`` int8, as the JAX package's
    ``classical.random_states``: +1 where ``bernoulli(key, 0.5, (nvars,))``.

    jax's uniform keeps the top 23 bits as the mantissa of a float in [1, 2)
    and subtracts 1, so ``u < 0.5`` is exactly "the top bit is 0"."""
    bits = random_bits(key_data, nvars)
    return np.where(bits < np.uint32(1 << 31), 1, -1).astype(np.int8)


def seeds_from_key_data(key_data: np.ndarray) -> np.ndarray:
    """``[R, 2]`` key data -> int32[R] kernel seeds ``k0 ^ 0x9E3779B9 ^ (k1 << 1)``:
    the numpy form of the JAX package's ``_pallas_seeds``, bit for bit."""
    kd = np.asarray(key_data, dtype=np.uint32).reshape(-1, 2)
    return (kd[:, 0] ^ np.uint32(0x9E3779B9) ^ (kd[:, 1] << np.uint32(1))).view(np.int32)


def replica_seeds_i32(seeds_u64) -> np.ndarray:
    """uint64[n] experiment seeds -> int32[n] kernel seeds: the JAX package's
    ``_pallas_seeds(keys_from_seeds(seeds))``, bit for bit."""
    return seeds_from_key_data(key_data_from_seeds(seeds_u64))


def randint(key_data: np.ndarray, maxval: int) -> np.ndarray:
    """``jax.random.randint(key, (), 0, maxval)`` (int32) for every key of
    ``[R, 2]`` key data -> int32[R], jax's algorithm bit for bit: the key is
    split in two, 32 random bits drawn from each half, and with ``span =
    maxval`` (1 where ``maxval <= 0``) and ``m = ((2^16 % span)^2) % span`` in
    uint32 arithmetic (so m = 0 for span > 2^16), the value is
    ``((hi % span) * m + lo % span) % span``, every step wrapping mod 2^32."""
    k1, k2 = split_all(key_data)
    hi = random_bits(k1, 1)[:, 0].astype(np.uint64)
    lo = random_bits(k2, 1)[:, 0].astype(np.uint64)
    span = np.uint64(int(maxval) if int(maxval) > 0 else 1)
    m32 = np.uint64(0xFFFFFFFF)
    mult = np.uint64(1 << 16) % span
    mult = (mult * mult & m32) % span
    off = (((hi % span) * mult & m32) + lo % span & m32) % span
    return off.astype(np.int32)


# the moves of a time step, in the order they split the replica's key
KEY_PLAIN, KEY_WORM, KEY_CLUSTER, KEY_FAN, KEY_SLICE, KEY_BITS, KEY_UNIFORM = 0, 1, 2, 3, 4, 5, 6
# the kinds that take a parameter: a plan slot of these is a pair (kind, m or span)
_PARAM_KINDS = (KEY_FAN, KEY_SLICE, KEY_BITS, KEY_UNIFORM)
# bound on a slot's m (a fan's inner splits, a bits or uniform slot's words)
_MAX_M = 1 << 16


def _slot(k):
    """A plan slot -> ``(kind, param)``: KEY_PLAIN, KEY_WORM and KEY_CLUSTER
    are bare ints (param 0); KEY_FAN, KEY_SLICE, KEY_BITS and KEY_UNIFORM
    are pairs ``(kind, m)``, ``(kind, span)``, ``(kind, m)``, ``(kind, m)``."""
    if isinstance(k, (tuple, list)):
        if len(k) != 2:
            raise ValueError(f"a plan slot is a kind or a pair (kind, param), got {k!r}")
        kind, param = int(k[0]), int(k[1])
        if kind not in _PARAM_KINDS:
            raise ValueError(f"slot kind {kind} takes no parameter, got {k!r}")
        if kind == KEY_SLICE and not 0 < param < 2**31:
            raise ValueError(f"a slice slot's span must be in [1, 2^31), got {param}")
        if kind != KEY_SLICE and not 0 <= param <= _MAX_M:
            raise ValueError(f"a fan, bits or uniform slot's m must be in [0, {_MAX_M}], got {param}")
        return kind, param
    kind = int(k)
    if kind not in (KEY_PLAIN, KEY_WORM, KEY_CLUSTER):
        raise ValueError(f"unknown slot kind {k!r} (fan, slice, bits and uniform slots are pairs (kind, param))")
    return kind, 0


def _slot_columns(kind: int, param: int):
    """(lane seeds, int words) one slot writes."""
    return {KEY_PLAIN: (1, 0), KEY_WORM: (1, 1), KEY_CLUSTER: (3, 0), KEY_FAN: (param, 0), KEY_SLICE: (1, 1),
            KEY_BITS: (0, param), KEY_UNIFORM: (0, param)}[kind]


def chain_columns(kinds: Sequence):
    """``(C, W)``: the lane seeds and the int words (worm start sites, slice
    draws, Bernoulli bits, uniforms' f32 bits) a step of this plan writes."""
    cols = [_slot_columns(*_slot(k)) for k in kinds]
    return sum(c for c, _ in cols), sum(w for _, w in cols)


def threefry_chain_reference(key_data: np.ndarray, kinds: Sequence, T: int, nvars: int):
    """The key chain of ``T`` time steps of the plan ``kinds``, in numpy.

    Each slot takes ``keys, sub = split(keys)``; then a KEY_PLAIN slot writes
    the lane seed of ``sub`` (``seeds_from_key_data``); a KEY_WORM slot
    ``ku, k0 = split(sub)`` and writes the lane seed of ``ku`` and the start
    site ``randint(k0, nvars)``; a KEY_CLUSTER slot ``k1, k_e = split(sub)``,
    ``k2, k_g = split(k1)``, ``_, k_f = split(k2)`` and writes the lane seeds
    of ``k_e``, ``k_g``, ``k_f``, in that order. A ``(KEY_FAN, m)`` slot
    walks ``sub, k = split(sub)`` m times and writes the lane seed of each
    ``k``; a ``(KEY_SLICE, span)`` slot is a worm slot that draws
    ``randint(k0, span)``; a ``(KEY_BITS, m)`` slot writes the m words of
    ``bernoulli(sub, 0.5, (m,))`` as 1 or 0 (nothing when m = 0); a
    ``(KEY_UNIFORM, m)`` slot writes the m words of ``uniform(sub, (m,))``
    (``uniform_f32``) as their f32 bit patterns. Returns
    ``(seeds [T, C, R] int32, v0 [T, W, R] int32, key_data [R, 2] uint32)``
    with the keys advanced past the ``T`` steps: the JAX package's splits, bit
    for bit."""
    kd = np.asarray(key_data, dtype=np.uint32).reshape(-1, 2)
    R = kd.shape[0]
    slots = [_slot(k) for k in kinds]
    C, W = chain_columns(kinds)
    seeds = np.empty((T, C, R), np.int32)
    v0 = np.empty((T, W, R), np.int32)
    for t in range(T):
        col = w = 0
        for kind, param in slots:
            kd, sub = split_all(kd)
            if kind == KEY_PLAIN:
                seeds[t, col] = seeds_from_key_data(sub)
            elif kind in (KEY_WORM, KEY_SLICE):
                ku, k0 = split_all(sub)
                seeds[t, col] = seeds_from_key_data(ku)
                v0[t, w] = randint(k0, nvars if kind == KEY_WORM else param)
            elif kind == KEY_CLUSTER:
                k1, k_e = split_all(sub)
                k2, k_g = split_all(k1)
                _, k_f = split_all(k2)
                seeds[t, col:col + 3] = np.stack([seeds_from_key_data(k) for k in (k_e, k_g, k_f)])
            elif kind == KEY_FAN:
                for j in range(param):
                    sub, k = split_all(sub)
                    seeds[t, col + j] = seeds_from_key_data(k)
            elif kind == KEY_BITS:
                v0[t, w:w + param] = (random_bits(sub, param) < np.uint32(1 << 31)).T
            else:
                v0[t, w:w + param] = uniform_f32(sub, param).view(np.int32).T
            c, i = _slot_columns(kind, param)
            col, w = col + c, w + i
    return seeds, v0, kd


def key_tensor(key_data: np.ndarray, device) -> torch.Tensor:
    """``[R, 2]`` uint32 key data -> an int32 tensor of the same bits on ``device``."""
    kd = np.ascontiguousarray(np.asarray(key_data, dtype=np.uint32).reshape(-1, 2))
    return torch.from_numpy(kd.view(np.int32).copy()).to(device)


def key_data_of(keys: torch.Tensor) -> np.ndarray:
    """The inverse of ``key_tensor``: ``[R, 2]`` uint32 key data on the host."""
    return keys.detach().cpu().numpy().astype(np.int32).view(np.uint32).reshape(-1, 2)


@functools.lru_cache(maxsize=64)
def _plan_tensor(plan: tuple, device: torch.device) -> torch.Tensor:
    """The ``[S, 2]`` int32 plan of ``threefry_chain`` on ``device``, copied
    there once per plan (the kernel only reads it)."""
    return torch.tensor(plan, dtype=torch.int32).to(device)


def threefry_chain(keys: torch.Tensor, kinds: Sequence, T: int, nvars: int):
    """``threefry_chain_reference`` on an ``[R, 2]`` int32 key tensor (the bits
    of ``key_tensor``), returning tensors on its device: ``(seeds [T, C, R],
    v0 [T, W, R], keys [R, 2])``.

    A CUDA tensor launches ``threefry_chain`` of ``csrc/keychain.cu`` once
    (counted in ``threefry_chain.launches``; nothing is launched when the
    chain is empty) or raises; a CPU tensor runs the numpy version."""
    slots = [_slot(k) for k in kinds]
    if keys.dim() != 2 or keys.shape[1] != 2 or keys.dtype != torch.int32:
        raise ValueError(f"keys must be [R, 2] int32, got {tuple(keys.shape)} {keys.dtype}")
    if any(kind == KEY_WORM for kind, _ in slots) and not 0 < nvars < 2**31:
        raise ValueError(f"a worm slot's nvars must be in [1, 2^31), got {nvars}")
    if keys.device.type != "cuda":
        seeds, v0, kd = threefry_chain_reference(key_data_of(keys), kinds, int(T), nvars)
        return torch.from_numpy(seeds), torch.from_numpy(v0), key_tensor(kd, keys.device)
    R, T = keys.shape[0], int(T)
    C, W = chain_columns(kinds)
    dev = keys.device
    seeds = torch.empty((T, C, R), dtype=torch.int32, device=dev)
    v0 = torch.empty((T, W, R), dtype=torch.int32, device=dev)
    if R == 0 or T == 0 or not slots:
        return seeds, v0, keys.clone()
    keys_in = keys.contiguous()
    out = torch.empty_like(keys_in)
    plan = _plan_tensor(tuple((kind, int(nvars) if kind == KEY_WORM else param) for kind, param in slots), dev)
    with torch.cuda.device(dev):
        _kernels.call("threefry_chain", lambda lib: lib.threefry_chain(
            keys_in.data_ptr(), out.data_ptr(), plan.data_ptr(), len(slots), T, C, W, R,
            seeds.data_ptr() if C else None, v0.data_ptr() if W else None, _kernels.stream(keys_in)))
    threefry_chain.launches += 1
    return seeds, v0, out


threefry_chain.launches = 0


def threefry_bits(keys: torch.Tensor, n: int, uniform: bool = False) -> torch.Tensor:
    """``random_bits`` (or ``uniform_f32``) of ``n`` counters for every key of
    an ``[R, 2]`` int32 key tensor (the bits of ``key_tensor``), on its
    device: ``[R, n]`` int32 holding the uint32 words, or f32 uniforms.

    A CUDA tensor launches ``threefry_bits`` of ``csrc/keychain.cu`` once
    (counted in ``threefry_bits.launches``) or raises; a CPU tensor runs the
    numpy version."""
    n = int(n)
    if keys.dim() != 2 or keys.shape[1] != 2 or keys.dtype != torch.int32:
        raise ValueError(f"keys must be [R, 2] int32, got {tuple(keys.shape)} {keys.dtype}")
    if n < 0:
        raise ValueError(f"n must be non-negative, got {n}")
    R = keys.shape[0]
    if keys.device.type != "cuda":
        kd = key_data_of(keys)
        out = uniform_f32(kd, n) if uniform else random_bits(kd, n).view(np.int32)
        return torch.from_numpy(np.ascontiguousarray(out)).to(keys.device)
    if R > 65535:
        raise ValueError(f"threefry_bits takes at most 65535 keys, got {R}")
    dev = keys.device
    out = torch.empty((R, n), dtype=torch.float32 if uniform else torch.int32, device=dev)
    if R == 0 or n == 0:
        return out
    keys_in = keys.contiguous()
    with torch.cuda.device(dev):
        _kernels.call("threefry_bits", lambda lib: lib.threefry_bits(
            keys_in.data_ptr(), R, n, int(uniform), out.data_ptr(), _kernels.stream(keys_in)))
    threefry_bits.launches += 1
    return out


threefry_bits.launches = 0
