"""The plain references on tiny inputs, each against the program on the CPU
(its plain version) as a second witness, bit for bit."""

import numpy as np
import pytest
import torch

from portbench.reference import glauber2d, inputs, lanehash, tempering
from portbench.reference import threefry as tf


def test_lane_hash_against_the_program():
    from pyisingmontecarlo_tpu_torch.ops.lanerng import lane_draw31, make_pos_mix

    seed = torch.randint(-2**31, 2**31, (5, 1), dtype=torch.int32, generator=torch.Generator().manual_seed(3))
    pos = torch.arange(0, 3000) * 7919
    for ctr in (0, 5, 2**31 - 1, 2**32 - 1):
        want = lane_draw31(seed, *make_pos_mix(torch.zeros(1, dtype=torch.int64), pos, 0), ctr)
        assert torch.equal(lanehash.draw31(seed, *lanehash.pos_words(pos), ctr), want)
        assert torch.equal(lanehash.draw31(seed, *lanehash.pos_words(pos), torch.tensor(lanehash.wrap32(ctr))), want)


def test_threefry_against_the_program():
    from pyisingmontecarlo_tpu_torch import rng

    seed = 2**32 + 17
    a = tf.master_seeds(np.random.Generator(np.random.PCG64(seed)), 6)
    assert np.array_equal(a, rng.MasterRng(seed).make_seeds(6))
    k = tf.keys_of(a)
    assert np.array_equal(k, rng.key_data_from_seeds(a))
    assert all(np.array_equal(x, y) for x, y in zip(tf.split(k), rng.split_all(k)))
    assert np.array_equal(tf.uniform_f32(k, 33), rng.uniform_f32(k, 33))
    assert np.array_equal(tf.bernoulli_states(k, 40), rng.random_states(k, 40))
    assert np.array_equal(tf.kernel_seeds(k), rng.replica_seeds_i32(a))


def test_inputs():
    from pyisingmontecarlo_tpu_torch.graph import grid_2d_edges

    a, b = inputs.torus_edges(6)
    assert inputs.edge_list(a, b, -1.0) == grid_2d_edges(6, 6, j=-1.0)
    j = inputs.pm_j(2**40 + 1, 1000)
    assert set(np.unique(j)) == {-1.0, 1.0} and np.array_equal(j, inputs.pm_j(2**40 + 1, 1000))
    assert np.allclose(inputs.beta_ladder(0.2, 3.0, 64)[[0, -1]], [0.2, 3.0])


@pytest.mark.parametrize("L,R,T,beta,J", [(8, 3, 5, 0.4, -1.0), (12, 2, 9, 0.7, -1.0), (6, 4, 3, 0.2, 1.0)])
def test_glauber2d_against_the_program(L, R, T, beta, J):
    from pyisingmontecarlo_tpu_torch import Lattice

    seed = 2**31 + 11
    lat = Lattice(inputs.edge_list(*inputs.torus_edges(L), J), seed_gen=seed, device="cpu")
    gen = np.random.Generator(np.random.PCG64(seed))
    for _ in range(2):
        es, ss = lat.run_monte_carlo(beta, T, R)
        k = torch.from_numpy(tf.kernel_seeds(tf.keys_of(tf.master_seeds(gen, R))))
        E, O = glauber2d.sweeps(*glauber2d.initial_states(k, L), k, glauber2d.thresholds([beta] * R, J, 0.0), T)
        s = glauber2d.unpack(E, O)
        assert np.array_equal((s == 1).reshape(R, -1).numpy(), ss)
        assert np.array_equal(glauber2d.energies(s, J, 0.0), es)


def test_glauber2d_thresholds_in_a_lower_precision_differ():
    f32 = glauber2d.thresholds([0.4], -1.0, 0.0)
    bf16 = glauber2d.thresholds([0.4], -1.0, 0.0, torch.bfloat16)
    assert not torch.equal(f32, bf16)


def test_tempering_against_the_program():
    from pyisingmontecarlo_tpu_torch import LatticeTempering

    side, R, seed = 4, 8, 2**32 + 99
    a, b = inputs.torus_edges(side)
    j = inputs.pm_j(seed, len(a))
    betas = inputs.beta_ladder(0.2, 3.0, R)
    lt = LatticeTempering(inputs.edge_list(a, b, j), seed=seed, dtau=0.05, device="cpu")
    for be in betas:
        lt.add_graph(1.0, 0.0, float(be))
    ref = tempering.Ladder(side, a, b, j, betas, 1.0, 0.0, 60, seed, "cpu")
    for T in (3, 4):
        states, energies = lt.qmc_timesteps_sample(T, replica_swap_freq=1)
        rs, re, _ = ref.call(T)
        assert np.array_equal(states, rs) and np.array_equal(energies, re)
        assert lt.get_total_swaps() == ref.total_swaps
        assert np.array_equal(np.stack([lt.get_graph_itime(g) for g in range(R)]), ref.worldlines())
    states, _ = lt.qmc_timesteps_sample(6, replica_swap_freq=1)
    rs, re, _ = ref.call(6, upto=2)
    assert np.array_equal(states[:, :2], rs) and re is None


def test_xla_sum_order():
    x = torch.tensor([[1e8, 1.0, -1e8] + [0.5] * 40], dtype=torch.float32)
    assert tempering.xla_sum_last(x).item() == pytest.approx(20.0, abs=2.0)
    y = torch.arange(5, dtype=torch.float32)[None]
    assert tempering.xla_sum_last(y).item() == 10.0
