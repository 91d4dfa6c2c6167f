"""The port's twins of ``examples/`` at small sizes on the CPU.

Where the port's entry point equals the JAX package's on the CPU, the twin's
numbers are held to the same calls through the JAX package, its kernels
forced on in interpret mode: the TFIM chain (``Lattice`` on the worldline
kernel) and the Trotter extrapolation (``QmcIsing`` on it) to the bit, the
glass ladder (``LatticeTempering`` on the ladder kernel) in swaps and samples
to the bit and in energies within 1e-5 relative (tests/test_torch_tempering.py's
bound: f32 sums). The ferromagnet (whose square-torus kernel draws its own
random stream) is held to Onsager, the chain and the 4-ring to dense
diagonalization. And each twin's ``main`` passes the JAX script's defaults
and prints its columns."""

import importlib
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import pyisingmontecarlo_tpu as jpmc
from helpers import dense_tfim_energy
from pyisingmontecarlo_tpu import models as jmodels
from pyisingmontecarlo_tpu_torch.examples import ferromagnet_phase_diagram as ferro
from pyisingmontecarlo_tpu_torch.examples import spin_glass_tempering as glass
from pyisingmontecarlo_tpu_torch.examples import tfim_quantum_phase_transition as tfim
from pyisingmontecarlo_tpu_torch.examples import trotter_extrapolation as trotter
from test_torch_qmcising import jax_on_kernel  # noqa: F401 (fixture)
from test_torch_tempering import jax_on_ladder  # noqa: F401 (fixture)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def _jax_example(name):
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}", REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------------------ against the JAX package

def test_tfim_chain_equals_jax(jax_on_kernel):
    n, beta, gammas, T, R, wait = 8, 1.0, (0.4, 1.3), 10, 4, 5
    got = tfim.run(n, beta, gammas, T, R, wait, device="cpu")
    for row, gamma in zip(got, gammas):
        lat = jpmc.Lattice(jmodels.chain_edges(n, j=-1.0), seed_gen=1)
        lat.set_transverse_field(gamma)
        meas, es = lat.run_quantum_monte_carlo_and_measure_spins(beta, T, R, sampling_wait_buffer=wait, exponent=2)
        want = (gamma, meas.mean() / n**2, es.mean() / n, es.std(ddof=1) / np.sqrt(R) / n)
        np.testing.assert_array_equal(np.array(row), np.array(want))


def test_glass_ladder_equals_jax(jax_on_ladder):
    L, nrep, therm, T, swap_freq, sfreq = 4, 4, 10, 20, 2, 5
    got = glass.run(L, nrep, therm, T, swap_freq, sfreq, device="cpu")
    edges = jmodels.pm_j_spin_glass_edges(L, seed=0)
    lt = jpmc.LatticeTempering(edges, seed=0)
    for b in np.geomspace(0.3, 3.0, nrep):
        lt.add_graph(0.5, 0.0, float(b))
    lt.qmc_timesteps(therm)
    states, energies = lt.qmc_timesteps_sample(T, replica_swap_freq=swap_freq, sampling_freq=sfreq)
    assert got["swaps"] == lt.get_total_swaps() > 0
    assert got["bonds"] == len(edges)
    assert got["coldest_m"] == abs(np.where(states[-1], 1, -1).mean())
    np.testing.assert_allclose(got["energies"], energies, rtol=1e-5)
    assert got["energies"][-1] < got["energies"][0]


def test_trotter_equals_jax(jax_on_kernel):
    jax_script = _jax_example("trotter_extrapolation")
    assert trotter.exact_energy(4, 1.0, 2.0) == jax_script.exact_energy(4, 1.0, 2.0)
    T, R, eq = 20, 8, 5
    ex, rows = trotter.run(0.2, timesteps=T, replicas=R, equilibrate=eq, device="cpu")
    want = []
    for dtau, seed in ((0.2, 7), (0.1, 8)):
        q = jpmc.QmcIsing(jmodels.chain_edges(4, j=-1.0), 1.0, num_experiments=R, seed=seed, dtau=dtau)
        q.run_qmc(2.0, eq)
        es, _ = q.run_sampling(2.0, T, sampling_wait_buffer=0)
        want.append((float(es.mean()), float(es.std(ddof=1) / np.sqrt(len(es)))))
    (e_full, se_full), (e_half, se_half) = want
    want.append(((4.0 * e_half - e_full) / 3.0, np.sqrt(16.0 * se_half**2 + se_full**2) / 3.0))
    assert [label for label, *_ in rows] == ["dtau=0.200", "dtau=0.100", "Richardson"]
    for (_, e, se, bias), (we, wse) in zip(rows, want):
        assert (e, se, bias) == (we, wse, we - ex)


# ------------------------------------------------------------------ physics

def test_ferromagnet_against_onsager():
    """16^2 torus from a random start, 500 sweeps, then 16 replicas sampled
    every 10 of 100 sweeps. At beta = 0.6 <|m|> is within 4 standard errors
    + 0.03 of Onsager's m (the finite-size shift at L = 16 is about +0.003;
    a replica still in two domains after the quench pulls the mean down); at
    beta = 0.30 (disordered) below 0.2 (its finite-size <|m|> ~ sqrt(chi / N))."""
    (b_hot, m_hot, _, exact_hot), (b_cold, m_cold, se_cold, exact_cold) = ferro.run(
        16, (0.30, 0.60), timesteps=100, replicas=16, thermalization_time=500, sampling_freq=10, device="cpu")
    assert exact_hot == 0.0 and m_hot < 0.2, m_hot
    assert abs(m_cold - exact_cold) < 4 * se_cold + 0.03, (m_cold, se_cold, exact_cold)


def test_tfim_chain_against_dense_diagonalization():
    """8-ring at beta = 2: <E>/n within 4 standard errors + 0.01 of dense
    diagonalization (the Trotter bias at dtau = 0.05 is below 0.003 a site),
    and <m_z^2> falls with Gamma."""
    n, beta, gammas = 8, 2.0, (0.4, 1.0, 1.8)
    rows = tfim.run(n, beta, gammas, timesteps=200, replicas=32, sampling_wait_buffer=50, device="cpu")
    edges = jmodels.chain_edges(n, j=-1.0)
    for gamma, _, e, se in rows:
        exact = dense_tfim_energy(edges, 0.0, gamma, beta, n) / n
        assert abs(e - exact) < 4 * se + 0.01, (gamma, e, se, exact)
    m2 = [m for _, m, _, _ in rows]
    assert m2[0] > m2[1] > m2[2], m2


def test_trotter_richardson_against_dense_diagonalization():
    """4-ring, Gamma = 1, beta = 2: the Richardson estimate within 4 of its
    standard errors of the exact energy; the coarse run's bias (O(dtau^2),
    negative) beyond 4 of its own."""
    ex, rows = trotter.run(0.2, timesteps=300, replicas=64, equilibrate=50, device="cpu")
    assert ex == pytest.approx(dense_tfim_energy(jmodels.chain_edges(4, j=-1.0), 0.0, 1.0, 2.0, 4), abs=1e-12)
    (_, _, se_full, bias_full), _, (_, _, se_x, bias_x) = rows
    assert abs(bias_x) < 4 * se_x, (bias_x, se_x)
    assert bias_full < -4 * se_full, (bias_full, se_full)


# ------------------------------------------------------------------ main

# twin -> (argv, the arguments main passes to run, what run returns, the lines main prints)
MAINS = {
    "ferromagnet_phase_diagram": (
        ["--device", "cpu"], ((32,), dict(device="cpu")), [(0.5, 0.9, 0.01, 0.9113)],
        ["# 2D Ising ferromagnet 32x32: <|m|> vs Onsager", "#   beta    <|m|>   stderr  onsager",
         "    0.50   0.9000   0.0100   0.9113"]),
    "tfim_quantum_phase_transition": (
        ["12", "--device", "cpu"], ((12, 8.0), dict(device="cpu")), [(1.0, 0.5, -1.25, 0.01)],
        ["# TFIM chain n=12, beta=8.0: <m_z^2> collapses past Gamma/J = 1", "#  Gamma    <m^2>    <E>/n",
         "    1.00   0.5000  -1.2500"]),
    "spin_glass_tempering": (
        ["--device", "cpu"], ((8, 24), dict(device="cpu")),
        dict(swaps=7, energies=np.array([-1.0, -90.5]), bonds=128, coldest_m=0.02),
        ["# 8x8 +-J glass, 24-rung ladder", "accepted swaps: 7", "coldest-rung <E>: -90.50  (128 bonds)",
         "coldest-rung |m|: 0.020 (glass: should stay small)"]),
    "trotter_extrapolation": (
        ["0.1", "--device", "cpu"], ((0.1, 4, 1.0, 2.0), dict(device="cpu")),
        (-5.0, [("dtau=0.100", -5.1, 0.01, -0.1)]),
        ["# TFIM ring n=4 Gamma=1.0 beta=2.0: exact <E> = -5.00000", "#            run       <E>   stderr      bias",
         "      dtau=0.100  -5.10000  0.01000  -0.10000"]),
}


@pytest.mark.parametrize("name", list(MAINS))
def test_main_passes_defaults_and_prints_the_columns(name, monkeypatch, capsys):
    argv, call, ret, lines = MAINS[name]
    mod = importlib.import_module(f"pyisingmontecarlo_tpu_torch.examples.{name}")
    seen = []
    monkeypatch.setattr(mod, "run", lambda *a, **k: seen.append((a, k)) or ret)
    assert mod.main(argv) == ret
    assert seen == [call]
    assert capsys.readouterr().out.splitlines()[:len(lines)] == lines
