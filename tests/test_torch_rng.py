"""The torch port's host-side threefry (``rng.py``) against ``jax.random``:
key data from u64 seeds, ``fold_in``, ``bits``, ``bernoulli(key, 0.5)`` initial
states and the kernel seed of each key, all bit for bit (tolerance: none)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")
import jax

from pyisingmontecarlo_tpu import rng as jrng
from pyisingmontecarlo_tpu.engines.classical import random_states as jax_random_states
from pyisingmontecarlo_tpu.ops.lattice2d import _pallas_seeds
from pyisingmontecarlo_tpu_torch import rng as trng

torch.set_num_threads(1)


def _seeds(seed, n):
    u64 = np.random.default_rng(seed).integers(0, 2**64, n, dtype=np.uint64)
    # the extremes of the u64 range, where the hi/lo split and the shifts matter
    return np.concatenate([u64, np.array([0, 2**64 - 1, 2**32 - 1, 2**32], np.uint64)])


@pytest.mark.parametrize("seed,n", [(0, 1), (1, 5), (2, 64)])
def test_key_data_and_kernel_seeds(seed, n):
    seeds = _seeds(seed, n)
    keys = jrng.keys_from_seeds(seeds)
    kd = trng.key_data_from_seeds(seeds)
    assert kd.dtype == np.uint32 and kd.shape == (len(seeds), 2)
    np.testing.assert_array_equal(kd, np.asarray(jax.random.key_data(keys)))
    got = trng.seeds_from_key_data(kd)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(_pallas_seeds(keys)))
    np.testing.assert_array_equal(trng.replica_seeds_i32(seeds), got)


@pytest.mark.parametrize("data", [0, 1, 200, 2000, 2**31 - 1, 2**31 + 7, 2**32 - 1])
def test_fold_all(data):
    seeds = _seeds(3, 9)
    keys = jrng.keys_from_seeds(seeds)
    want = np.asarray(jax.random.key_data(jrng.fold_all(keys, data)))
    np.testing.assert_array_equal(trng.fold_all(trng.key_data_from_seeds(seeds), data), want)


def test_fold_all_chain():
    """Successive folds (a wait buffer, then a sampling run, then more)."""
    seeds = _seeds(4, 6)
    keys = jrng.keys_from_seeds(seeds)
    kd = trng.key_data_from_seeds(seeds)
    for t in (150, 220, 1, 7):
        keys = jrng.fold_all(keys, t)
        kd = trng.fold_all(kd, t)
        np.testing.assert_array_equal(kd, np.asarray(jax.random.key_data(keys)))


@pytest.mark.parametrize("nvars", [1, 7, 8, 65, 256, 4095, 65536])
def test_random_states(nvars):
    """Odd and even widths, small and in the thousands (up to the 256^2 torus)."""
    seeds = _seeds(nvars, 3)
    keys = jrng.keys_from_seeds(seeds)
    got = trng.random_states(trng.key_data_from_seeds(seeds), nvars)
    assert got.dtype == np.int8 and got.shape == (len(seeds), nvars)
    np.testing.assert_array_equal(got, np.asarray(jax_random_states(keys, nvars)))
    assert set(np.unique(got)) == {-1, 1}


def test_random_bits():
    seeds = _seeds(5, 4)
    keys = jrng.keys_from_seeds(seeds)
    want = np.stack([np.asarray(jax.random.bits(k, (300,), jnp.uint32)) for k in keys])
    np.testing.assert_array_equal(trng.random_bits(trng.key_data_from_seeds(seeds), 300), want)


def test_threefry_known_answer():
    """The Threefry-2x32 (20 rounds) known-answer vector of the Random123
    suite, which jax's own tests also check."""
    y0, y1 = trng.threefry2x32(0x13198A2E, 0x03707344, 0x243F6A88, 0x85A308D3)
    assert (int(y0), int(y1)) == (0xC4923A9C, 0x483DF7A0)


@pytest.mark.parametrize("seed,n", [(6, 1), (7, 5), (8, 64)])
def test_split_all(seed, n):
    """``jax.random.split`` of every key (the JAX package's ``split_keys``),
    along a chain of ten splits as the tempering loop takes them."""
    seeds = _seeds(seed, n)
    keys = jrng.keys_from_seeds(seeds)
    kd = trng.key_data_from_seeds(seeds)
    for _ in range(10):
        keys, sub = jrng.split_keys(keys)
        kd, ksub = trng.split_all(kd)
        np.testing.assert_array_equal(kd, np.asarray(jax.random.key_data(keys)))
        np.testing.assert_array_equal(ksub, np.asarray(jax.random.key_data(sub)))


@pytest.mark.parametrize("n", [1, 7, 64, 1000])
def test_uniform_f32(n):
    """``jax.random.uniform(key, (n,))`` of one key (the swap's draw) and of
    several, bit for bit."""
    seeds = _seeds(9, 3)
    keys = jrng.keys_from_seeds(seeds)
    kd = trng.key_data_from_seeds(seeds)
    got = trng.uniform_f32(kd, n)
    assert got.dtype == np.float32 and got.shape == (len(seeds), n)
    want = np.stack([np.asarray(jax.random.uniform(k, (n,))) for k in keys])
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    np.testing.assert_array_equal(trng.uniform_f32(kd[0], n)[0], want[0])
    assert got.min() >= 0.0 and got.max() < 1.0
