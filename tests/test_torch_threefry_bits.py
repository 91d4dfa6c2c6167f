"""``rng.threefry_bits`` (the plain version of ``csrc/keychain.cu``'s
``threefry_bits``, which a CPU tensor takes) against ``jax.random.bits`` and
``jax.random.uniform``, bit for bit: R keys (one row each), sizes that are not
a multiple of the kernel's block of 256, and the flat order of a
multi-dimensional shape as the sharded sweeps draw it. The kernel itself runs
only on the card (``chip_smoke.py`` compare-threefry-bits)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp

from pyisingmontecarlo_tpu_torch import rng

torch.set_num_threads(1)


def _keys(R, seed):
    return rng.key_data_from_seeds(np.random.default_rng(seed).integers(0, 2**64, R, dtype=np.uint64))


@pytest.mark.parametrize("R,n", [(1, 1), (1, 255), (3, 256), (2, 257), (5, 1000), (1, 4097)])
def test_bits_equal_jax(R, n):
    kd = _keys(R, n)
    got = rng.threefry_bits(rng.key_tensor(kd, "cpu"), n)
    assert got.dtype == torch.int32 and got.shape == (R, n)
    for r in range(R):
        want = np.asarray(jax.random.bits(jax.random.wrap_key_data(jnp.asarray(kd[r])), (n,), jnp.uint32))
        np.testing.assert_array_equal(got[r].numpy().view(np.uint32), want)


@pytest.mark.parametrize("shape", [(7,), (3, 5, 7), (2, 8, 15)])
def test_uniform_equals_jax_over_a_shape(shape):
    """One key over a whole state shape, flattened in row-major order."""
    kd = _keys(1, 11)
    n = int(np.prod(shape))
    got = rng.threefry_bits(rng.key_tensor(kd, "cpu"), n, uniform=True)
    assert got.dtype == torch.float32
    want = np.asarray(jax.random.uniform(jax.random.wrap_key_data(jnp.asarray(kd[0])), shape))
    np.testing.assert_array_equal(got.view(shape).numpy(), want)
    assert ((want >= 0) & (want < 1)).all()


def test_split_and_fold_chain_equals_jax():
    """The spatial sweep's key plan: fold_in twice, split, uniform of the subkey."""
    key = jax.random.fold_in(jax.random.fold_in(jax.random.key(7), 3), 1001)
    key, sub = jax.random.split(key)
    kd = rng.fold_all(rng.fold_all(np.array([[0, 7]], np.uint32), 3), 1001)
    kd, kd_sub = rng.split_all(kd)
    np.testing.assert_array_equal(kd, np.asarray(jax.random.key_data(key))[None])
    got = rng.threefry_bits(rng.key_tensor(kd_sub, "cpu"), 40, uniform=True)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(jax.random.uniform(sub, (40,))))


def test_empty_and_bad_keys():
    keys = rng.key_tensor(_keys(2, 1), "cpu")
    assert rng.threefry_bits(keys, 0).shape == (2, 0)
    with pytest.raises(ValueError, match="int32"):
        rng.threefry_bits(keys.to(torch.int64), 4)
    with pytest.raises(ValueError, match=r"\[R, 2\]"):
        rng.threefry_bits(keys.reshape(-1), 4)
    with pytest.raises(ValueError, match="non-negative"):
        rng.threefry_bits(keys, -1)
