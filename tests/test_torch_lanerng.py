"""The torch port's randomness against the JAX package: the lane hash, the
per-replica kernel seeds and the master seed stream, all bit for bit, and the
port's initial states (which replace threefry Bernoulli)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from pyisingmontecarlo_tpu import rng as jrng
from pyisingmontecarlo_tpu.ops import lanerng as jl
from pyisingmontecarlo_tpu.ops import lattice2d as jl2d
from pyisingmontecarlo_tpu_torch import rng as trng
from pyisingmontecarlo_tpu_torch.ops import lanerng as tl
from pyisingmontecarlo_tpu_torch.ops import lattice2d as tl2d

torch.set_num_threads(1)

# counters beyond 2^20 and at the top of the 32-bit range, where an int32
# transcription with arithmetic shifts would go wrong
CTRS = [0, 1, 2, 2**20 + 3, 2**30 - 1, 2**31 - 1]


def _planes(L=16, W=8, nvars=40):
    tau = np.broadcast_to(np.arange(L, dtype=np.int32)[:, None], (L, W))
    i = np.broadcast_to(np.arange(W, dtype=np.int32)[None, :] * 5 + 3, (L, W))
    return np.ascontiguousarray(tau), np.ascontiguousarray(i), nvars


def test_make_pos_mix_bit_exact():
    """Tolerance: none (the 32-bit words must be equal)."""
    tau, i, nvars = _planes()
    j1, j2 = jl.make_pos_mix(jnp.asarray(tau), jnp.asarray(i), nvars)
    t1, t2 = tl.make_pos_mix(torch.from_numpy(tau), torch.from_numpy(i), nvars)
    np.testing.assert_array_equal(np.asarray(j1).view(np.uint32), t1.numpy().astype(np.uint32))
    np.testing.assert_array_equal(np.asarray(j2).view(np.uint32), t2.numpy().astype(np.uint32))


@pytest.mark.parametrize("seed", [0, 1, 123456789, -1, -(2**31)])
def test_lane_draw31_bit_exact(seed):
    """Tolerance: none. Negative int32 seeds and counters >= 2^20 included."""
    tau, i, nvars = _planes()
    j1, j2 = jl.make_pos_mix(jnp.asarray(tau), jnp.asarray(i), nvars)
    t1, t2 = tl.make_pos_mix(torch.from_numpy(tau), torch.from_numpy(i), nvars)
    seed_plane = jnp.full(tau.shape, seed, jnp.int32)
    for ctr in CTRS:
        want = np.asarray(jl.lane_draw31(seed_plane, j1, j2, jnp.int32(np.uint32(ctr).view(np.int32))))
        got = tl.lane_draw31(torch.tensor(seed, dtype=torch.int32), t1, t2, ctr)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"ctr={ctr}")


def test_replica_seeds_i32_bit_exact():
    """Tolerance: none, against ``_pallas_seeds(keys_from_seeds(...))``."""
    seeds = np.random.default_rng(3).integers(0, 2**64, 64, dtype=np.uint64)
    seeds[:3] = [0, 2**64 - 1, 2**32]
    want = np.asarray(jl2d._pallas_seeds(jrng.keys_from_seeds(seeds)))
    got = trng.replica_seeds_i32(seeds)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(jl.replica_seeds_from_keys(jrng.keys_from_seeds(seeds))))


def test_master_rng_matches_jax():
    a, b = jrng.MasterRng(11), trng.MasterRng(11)
    np.testing.assert_array_equal(a.make_seeds(5), b.make_seeds(5))
    ca, cb = a.clone(), b.clone()
    np.testing.assert_array_equal(a.make_seeds(7), b.make_seeds(7))
    np.testing.assert_array_equal(ca.make_seeds(7), cb.make_seeds(7))
    with pytest.raises(ValueError):
        b.make_seeds(-1)


def test_random_states_2d():
    """Each replica's state is a function of its own seed; spins are +-1 with
    p(+1) = 1/2 (tolerance: 6 binomial sigma over 8 x 32^2 sites)."""
    seeds = torch.tensor([7, -3, 2**31 - 1, 0, 99, 5, 6, 8], dtype=torch.int32)
    s = tl2d.random_states_2d(seeds, 32)
    assert s.shape == (8, 32, 32) and s.dtype == torch.int8
    assert set(torch.unique(s).tolist()) == {-1, 1}
    alone = tl2d.random_states_2d(seeds[1:2], 32)
    assert torch.equal(alone[0], s[1])
    n = s.numel()
    assert abs((s == 1).sum().item() - n / 2) < 6 * np.sqrt(n / 4)
    assert not torch.equal(s[0], s[3])
