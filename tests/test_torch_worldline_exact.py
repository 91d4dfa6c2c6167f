"""The port's quantum engines against exact physics (CPU): the twins of the
cases of tests/test_worldline_exact.py that the JAX package runs on its
generic engine (chains, triangles and pairs: not a uniform ring or torus),
a triangular patch with the RVB move, and the QmcIsing, Lattice and
LatticeTempering parts of tests/test_trotter_bias.py, with the JAX tests'
bounds (4 standard errors plus the stated Trotter slack)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from helpers import dense_tfim_energy, dense_tfim_magnetization
from pyisingmontecarlo_tpu import models as jmodels
from pyisingmontecarlo_tpu_torch import Lattice, LatticeTempering, QmcIsing
from pyisingmontecarlo_tpu_torch.engines import worldline as twl
from test_trotter_bias import trotterized_energy

torch.set_num_threads(1)


def qmc_energy(edges, gamma, h, beta, n=96, t=220, wait=150, seed=0, rvb=False):
    lat = Lattice(edges, seed_gen=seed, device="cpu")
    lat.set_transverse_field(gamma)
    lat.set_enable_rvb_update(rvb)
    if h:
        lat.set_global_bias(h)
    es, _ = lat.run_quantum_monte_carlo_sampling(beta, t, n, sampling_wait_buffer=wait)
    return es.mean(), es.std(ddof=1) / np.sqrt(len(es))


@pytest.mark.parametrize("edges,gamma,h,beta,seed,slack", [
    ([((0, 1), -1.0), ((1, 2), -1.0)], 0.7, 0.4, 1.5, 1, 0.03),  # with a longitudinal field
    ([((0, 1), 1.0), ((1, 2), 1.0), ((0, 2), 1.0)], 0.8, 0.0, 2.0, 2, 0.03),  # frustrated triangle
    ([((0, 1), -0.2)], 2.0, 0.0, 1.5, 3, 0.05),  # strong-field limit
], ids=["longitudinal", "triangle", "strong-field"])
def test_tfim_energy_matches_dense(edges, gamma, h, beta, seed, slack):
    n = max(max(a, b) for (a, b), _ in edges) + 1
    ex = dense_tfim_energy(edges, h, gamma, beta, n)
    em, se = qmc_energy(edges, gamma, h, beta, seed=seed)
    assert abs(em - ex) < 4 * se + slack, (em, ex, se)


def test_tfim_large_beta_energy():
    """beta = 12 on the triangle (L_tau = 240), on the generic route."""
    edges = [((0, 1), -1.0), ((1, 2), -1.0), ((0, 2), -1.0)]
    ex = dense_tfim_energy(edges, 0.0, 0.9, 12.0, 3)
    em, se = qmc_energy(edges, 0.9, 0.0, 12.0, n=64, t=120, wait=80, seed=5)
    assert abs(em - ex) < 4 * se + 0.06, (em, ex, se)


def test_tfim_triangular_patch_with_rvb_matches_dense():
    """A 3 x 3 open triangular patch with the RVB move on."""
    edges = jmodels.triangular_edges(3, j=1.0, periodic=False)
    ex = dense_tfim_energy(edges, 0.0, 1.0, 1.0, 9)
    em, se = qmc_energy(edges, 1.0, 0.0, 1.0, n=64, t=120, wait=80, seed=6, rvb=True)
    assert abs(em - ex) < 4 * se + 0.03, (em, ex, se)


def test_tfim_magnetization():
    edges = [((0, 1), -1.0)]
    beta, gamma, h = 1.5, 0.6, 0.8
    mex = dense_tfim_magnetization(edges, h, gamma, beta, 2)
    lat = Lattice(edges, seed_gen=4, device="cpu")
    lat.set_transverse_field(gamma)
    lat.set_global_bias(h)
    _, ss = lat.run_quantum_monte_carlo_sampling(beta, 300, 128, sampling_wait_buffer=150)
    np.testing.assert_allclose(np.where(ss, 1.0, -1.0).mean(axis=(0, 1)), mex, atol=0.05)


def test_measure_spins_moments():
    lat = Lattice([((0, 1), -1.0)], seed_gen=5, device="cpu")
    lat.set_transverse_field(1.0)
    meas, _ = lat.run_quantum_monte_carlo_and_measure_spins(1.0, 200, 64)
    assert abs(meas.mean()) < 0.15
    meas2, _ = lat.run_quantum_monte_carlo_and_measure_spins(1.0, 200, 64, exponent=2)
    assert 0.5 < meas2.mean() <= 4.0
    meas3, _ = lat.run_quantum_monte_carlo_and_measure_spins(1.0, 200, 64, spin_measurement=(0.0, 1.0))
    assert 0.0 <= meas3.mean() <= 2.0


# ------------------------------------------------------------------ twins of tests/test_trotter_bias.py

def test_dtau_knob_reaches_every_class():
    pair = [((0, 1), -1.0)]
    lat = Lattice(pair, seed_gen=0, dtau=0.5, device="cpu")
    lat.set_transverse_field(1.0)
    assert lat._worldline(2, 2.0).L == twl.choose_ltau(2.0, 1.0, 0.5) == 4
    assert QmcIsing(pair, 1.0, num_experiments=2, seed=0, dtau=0.5, device="cpu")._ensure(2.0).L == 4
    assert QmcIsing(pair, 1.0, num_experiments=2, seed=0, dtau=0.05, device="cpu")._ensure(2.0).L == 40
    lt = LatticeTempering(pair, seed=0, dtau=0.5, device="cpu")
    lt.add_graph(1.0, 0.0, 2.0)
    assert lt._materialize()["s"].shape[2] == 4


def _mc_energy(dtau, n=192, t=260, wait=160, seed=11):
    q = QmcIsing([((0, 1), -1.0)], 1.0, num_experiments=n, seed=seed, dtau=dtau, device="cpu")
    es, _ = q.run_sampling(2.0, t, sampling_wait_buffer=wait)
    return es.mean(), es.std(ddof=1) / np.sqrt(len(es))


def test_engine_tracks_trotterized_exact_at_coarse_dtau():
    ex = dense_tfim_energy([((0, 1), -1.0)], 0.0, 1.0, 2.0, 2)
    et4 = trotterized_energy(4)
    em, se = _mc_energy(0.5)
    assert abs(em - et4) < 4 * se + 0.02, (em, et4, se)
    assert abs(em - ex) > 0.1


def test_engine_converges_to_exact_at_fine_dtau():
    ex = dense_tfim_energy([((0, 1), -1.0)], 0.0, 1.0, 2.0, 2)
    em, se = _mc_energy(0.05)
    assert abs(em - ex) < 4 * se + 0.02, (em, ex, se)
