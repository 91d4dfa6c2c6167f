"""The port's ``Lattice`` on the classical graph engine: the four classical
methods against the JAX package's with the same ``seed_gen``, bit for bit
(tolerance: none; integer or dyadic couplings and biases, well under 10^5
Glauber decisions a test), for default moves, basic moves with heat-bath,
cluster updates with individual biases, importance-sampled edge moves, an
initial state and chunked runs; then the physics twins of
tests/test_classical_exact.py, tests/test_edge_move_exact.py,
tests/test_cluster.py and the classical part of tests/test_edge_cases.py
against exact enumeration, within the JAX tests' own bounds."""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import pyisingmontecarlo_tpu as jpmc
import pyisingmontecarlo_tpu_torch as tpmc
from pyisingmontecarlo_tpu import models as jmodels
from pyisingmontecarlo_tpu_torch import rng
from pyisingmontecarlo_tpu_torch.engines import classical as tce
from pyisingmontecarlo_tpu_torch.graph import compile_graph, grid_2d_edges
from pyisingmontecarlo_tpu_torch.interop import lattice_from_reference

torch.set_num_threads(1)

TRI = jmodels.triangular_edges(4, j=1.0)
HETERO = [((a, b), j * (0.5 + 0.25 * ((a + b) % 4))) for (a, b), j in TRI]
CHAIN = [((i, (i + 1) % 7), -1.0) for i in range(7)] + [((0, 3), 0.5)]
BETAS = [(0, 0.2), (9, 1.6)]


def _setup_default(lat):
    return lat


def _setup_cluster_bias(lat):
    lat.set_enable_cluster_updates(True)
    lat.set_individual_bias(2, 0.75)
    lat.set_individual_bias(5, -0.25)
    return lat


def _setup_heatbath(lat):
    lat.set_enable_heatbath_update(True)
    lat.set_global_bias(-0.5)
    return lat


def _setup_initial(lat):
    lat.set_initial_state(np.arange(lat.nvars) % 3 == 0)
    return lat


CASES = [
    ("default", TRI, _setup_default, "run_monte_carlo", (0.9, 9, 5), {}),
    ("default", TRI, _setup_default, "run_monte_carlo_sampling", (0.9, 7, 5),
     dict(thermalization_time=3, sampling_freq=3)),
    ("default", TRI, _setup_default, "run_monte_carlo_annealing", (BETAS, 9, 5), {}),
    ("default", TRI, _setup_default, "run_monte_carlo_annealing_and_get_energies", (BETAS, 9, 5), {}),
    ("clusters, individual biases", TRI, _setup_cluster_bias, "run_monte_carlo_sampling", (0.7, 8, 4),
     dict(sampling_freq=3)),
    ("basic moves, heat-bath", CHAIN, _setup_heatbath, "run_monte_carlo", (1.1, 9, 6),
     dict(only_basic_moves=True)),
    ("importance sampling", HETERO, _setup_default, "run_monte_carlo_annealing", (BETAS, 9, 5),
     dict(edge_move_importance_sampling=True)),
    ("initial state", TRI, _setup_initial, "run_monte_carlo_annealing_and_get_energies", (BETAS, 6, 3), {}),
    ("torus with clusters", grid_2d_edges(4, 4), lambda l: (l.set_enable_cluster_updates(True), l)[1],
     "run_monte_carlo", (0.6, 6, 4), {}),
]


@pytest.mark.parametrize("name,edges,setup,method,args,kwargs", CASES,
                         ids=[f"{c[0]}-{c[3]}" for c in CASES])
def test_classical_methods_equal_jax(name, edges, setup, method, args, kwargs):
    ref = setup(jpmc.Lattice(edges, seed_gen=13))
    port = lattice_from_reference(ref, device="cpu")
    assert not port._fast2d()
    want = getattr(ref, method)(*args, **kwargs)
    got = getattr(port, method)(*args, **kwargs)
    for g, w in zip(got, want):
        assert (g.shape, g.dtype) == (w.shape, w.dtype)
        np.testing.assert_array_equal(g, w)
    assert port.make_seeds(2) == ref.make_seeds(2)  # both master streams advanced alike


def test_chunked_dispatch_bit_exact(monkeypatch):
    """PMC_STEPS_PER_DISPATCH splits a run into pieces; the key chain carries
    over, so the energies and states equal one piece's."""
    want = tpmc.Lattice(TRI, seed_gen=3, device="cpu").run_monte_carlo_annealing_and_get_energies(BETAS, 11, 4)
    monkeypatch.setenv("PMC_STEPS_PER_DISPATCH", "4")
    got = tpmc.Lattice(TRI, seed_gen=3, device="cpu").run_monte_carlo_annealing_and_get_energies(BETAS, 11, 4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_energies_equal_energy_of_states():
    lat = tpmc.Lattice(HETERO, seed_gen=5, device="cpu")
    es, st = lat.run_monte_carlo(1.0, 5, 6)
    s = torch.from_numpy(np.where(st, 1, -1).astype(np.int8))
    want = tce.energy(lat._graph_arrays(), torch.zeros(lat.nvars), s).numpy().astype(np.float64)
    np.testing.assert_array_equal(es, want)


# ------------------------------------------------------------------ physics twins, exact enumeration

def exact_stats(edges, bias, beta):
    nvars = max(max(a, b) for (a, b), _ in edges) + 1
    h = np.asarray(bias) if np.ndim(bias) else np.full(nvars, float(bias))
    s = np.array(list(itertools.product([-1, 1], repeat=nvars)), np.float64)
    E = sum(j * s[:, a] * s[:, b] for (a, b), j in edges) + s @ h
    w = np.exp(-beta * (E - E.min()))
    return float(w @ E / w.sum()), (w @ s) / w.sum()


def check_energy(lat, edges, bias, beta, n=256, t=60, therm=40, bound=0.02, **kw):
    ex, _ = exact_stats(edges, bias, beta)
    es, ss = lat.run_monte_carlo_sampling(beta, t, n, thermalization_time=therm, sampling_freq=2, **kw)
    se = max(es.mean(axis=1).std(ddof=1) / np.sqrt(es.shape[0]), 1e-6)
    assert abs(es.mean() - ex) < 5 * se + bound, (es.mean(), ex, se)
    return np.where(ss, 1, -1)


def test_two_spin_ferromagnet():
    edges = [((0, 1), -1.0)]
    check_energy(tpmc.Lattice(edges, seed_gen=7, device="cpu"), edges, 0.0, 0.7)


def test_triangle_frustrated_with_field():
    edges = [((0, 1), 1.0), ((1, 2), 1.0), ((0, 2), 1.0)]
    lat = tpmc.Lattice(edges, seed_gen=3, device="cpu")
    lat.set_global_bias(0.3)
    check_energy(lat, edges, 0.3, 0.8)


def test_individual_bias_marginals():
    edges = [((0, 1), -0.5), ((1, 2), 0.5), ((2, 3), -1.0), ((0, 3), 0.25)]
    lat = tpmc.Lattice(edges, seed_gen=11, device="cpu")
    lat.set_individual_bias(0, 1.0)
    lat.set_individual_bias(2, -0.7)
    bias = np.array([1.0, 0.0, -0.7, 0.0])
    spins = check_energy(lat, edges, bias, 0.9, n=512, t=80, therm=60)
    np.testing.assert_allclose(spins.reshape(-1, 4).mean(0), exact_stats(edges, bias, 0.9)[1], atol=0.12)


def test_only_basic_moves():
    edges = [((0, 1), -1.0), ((1, 2), -1.0)]
    check_energy(tpmc.Lattice(edges, seed_gen=5, device="cpu"), edges, 0.0, 0.6, only_basic_moves=True)


def test_heatbath_updates():
    edges = [((0, 1), -1.0), ((1, 2), 1.0), ((0, 2), 0.4)]
    lat = tpmc.Lattice(edges, seed_gen=13, device="cpu")
    lat.set_enable_heatbath_update(True)
    check_energy(lat, edges, 0.0, 0.8)


def test_deep_quench_finds_ground_state():
    es, _ = tpmc.Lattice([((i, i + 1), -1.0) for i in range(7)], seed_gen=2, device="cpu").run_monte_carlo(
        8.0, 200, 32)
    assert es.min() == -7.0 and (es == -7.0).mean() > 0.8


def _engine_energies(edges, bias, beta, R, therm, nsamp, seed_mul, **moves):
    """The engine alone on the user-numbered ELL graph (``device_graph``), as
    the JAX package's tests drive it: (therm steps, then nsamp samples)."""
    cg = compile_graph(edges)
    ga = tce.device_graph(cg)
    kd = rng.key_data_from_seeds(np.arange(1, R + 1, dtype=np.uint64) * seed_mul)
    keys = rng.key_tensor(kd, "cpu")
    h = torch.full((cg.nvars,), float(bias))
    margs = dict(dict(nspin_sweeps=0, nedge_sweeps=0, nworms=0, only_basic=False, heatbath=False, wlen=1), **moves)
    s, keys = tce.run_steps(ga, h, tce.random_states(kd, cg.nvars), keys, np.full(therm, beta, np.float32), **margs)
    _, _, es, ss = tce.run_sampling(ga, h, s, keys, beta, nsamp, 1, **margs)
    return es.numpy().astype(np.float64), ss.numpy()


def _assert_exact(es, edges, bias, beta, bound):
    ex, _ = exact_stats(edges, bias, beta)
    se = max(es.mean(axis=1).std(ddof=1) / np.sqrt(es.shape[0]), 1e-6)
    assert abs(es.mean() - ex) < 5 * se + bound, (es.mean(), ex, se)


@pytest.mark.parametrize("edges,bias,beta", [
    (grid_2d_edges(4, 4, j=-1.0), 0.0, 0.35),  # bond-adjacent disjoint pairs: a proper coloring is biased here
    ([((0, 1), 1.0), ((1, 2), 1.0), ((0, 2), 1.0), ((2, 3), -1.0), ((3, 4), 1.0)], 0.25, 0.8),
])
def test_spin_edge_exact(edges, bias, beta):
    es, _ = _engine_energies(edges, bias, beta, 512, 120, 60, 7919, nspin_sweeps=1, nedge_sweeps=1)
    _assert_exact(es, edges, bias, beta, 0.05)


def test_importance_sampled_edge_moves_exact():
    edges = [((0, 1), -2.0), ((1, 2), -0.5), ((2, 3), -1.0), ((3, 0), -0.25), ((0, 2), 1.5)]
    allw = torch.cat(tce.importance_weights(compile_graph(edges)))
    assert allw.min() < 0.99 and allw.max() == 1.0
    cg = compile_graph(edges)
    es, _ = _engine_energies(edges, 0.0, 0.6, 1024, 150, 80, 104729, nspin_sweeps=1, nedge_sweeps=2,
                             iw=tce.importance_weights(cg))
    _assert_exact(es, edges, 0.0, 0.6, 0.02)


@pytest.mark.parametrize("edges,bias,beta", [
    ([((0, 1), -1.0), ((1, 2), -1.0), ((2, 3), -1.0), ((3, 0), -1.0)], 0.4, 0.6),
    ([((0, 1), -1.0), ((1, 2), 1.0), ((0, 2), -1.0), ((2, 3), -0.5)], -0.3, 0.8),
    ([((0, 1), 1.0), ((1, 2), 1.0), ((0, 2), 1.0)], 0.5, 0.9),
])
def test_sw_only_exact(edges, bias, beta):
    """Swendsen-Wang moves alone (the ghost spin carrying the field) sample
    the Gibbs distribution: energy and marginals against enumeration."""
    es, ss = _engine_energies(edges, bias, beta, 512, 80, 50, 2654435761, nclusters=1)
    _assert_exact(es, edges, bias, beta, 0.02)
    assert np.allclose(ss.mean(axis=(0, 1)), exact_stats(edges, bias, beta)[1], atol=0.06)


def test_cluster_updates_fix_deep_quench():
    """16^2 ferromagnet quenched to beta = 1: single flips leave domain walls,
    one SW update a step orders it."""
    edges = grid_2d_edges(16, 16, j=-1.0)
    _, ss = tpmc.Lattice(edges, seed_gen=1, device="cpu").run_monte_carlo_sampling(
        1.0, 40, 64, thermalization_time=100, sampling_freq=4)
    lat = tpmc.Lattice(edges, seed_gen=1, device="cpu")
    lat.set_enable_cluster_updates(True)
    es2, ss2 = lat.run_monte_carlo_sampling(1.0, 40, 64, thermalization_time=100, sampling_freq=4)
    assert np.abs(np.where(ss2, 1, -1).mean(axis=2)).mean() > 0.99
    assert np.abs(np.where(ss, 1, -1).mean(axis=2)).mean() < 0.95
    assert es2.mean() / 256 < -1.98


def test_cluster_determinism():
    edges = [((0, 1), -1.0), ((1, 2), 1.0), ((0, 2), -1.0), ((2, 3), -0.5)]
    outs = []
    for _ in range(2):
        lat = tpmc.Lattice(edges, seed_gen=99, device="cpu")
        lat.set_enable_cluster_updates(True)
        outs.append(lat.run_monte_carlo_sampling(0.7, 20, 16, sampling_freq=2))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def test_clone_preserves_torus_and_cluster_flag():
    lat = tpmc.Lattice(grid_2d_edges(8, 8, j=-1.0), seed_gen=5, device="cpu")
    lat.set_enable_cluster_updates(True)
    c = lat.clone()
    assert c._torus == lat._torus and c.enable_cluster
    assert c.run_monte_carlo(0.5, 5, 4)[1].shape == (4, 64)


# ------------------------------------------------------------------ twins of tests/test_edge_cases.py

def test_isolated_vertex():
    edges = [((0, 2), -1.0)]
    assert list(compile_graph(edges).degree) == [1, 0, 1]
    lat = tpmc.Lattice(edges, seed_gen=0, device="cpu")
    lat.set_individual_bias(1, 3.0)
    _, ss = lat.run_monte_carlo_sampling(2.0, 40, 64, thermalization_time=40)
    assert np.where(ss[:, :, 1], 1.0, -1.0).mean() < -0.95


def test_duplicate_edges_accumulate():
    lat = tpmc.Lattice([((0, 1), -0.5), ((0, 1), -0.5)], seed_gen=0, device="cpu")
    lat.set_initial_state([True, True])
    es, _ = lat.run_monte_carlo(1.0, 0, 2)
    np.testing.assert_allclose(es, -1.0)


def test_zero_timesteps_and_experiments():
    lat = tpmc.Lattice([((0, 1), -1.0)], seed_gen=0, device="cpu")
    assert lat.run_monte_carlo(1.0, 0, 3)[0].shape == (3,)
    es, ss = lat.run_monte_carlo(1.0, 4, 0)
    assert es.shape == (0,) and ss.shape == (0, 2)
    es, ss = lat.run_monte_carlo_sampling(1.0, 3, 2, sampling_freq=5)
    assert es.shape == (2, 0) and ss.shape == (2, 0, 2)


def test_large_bias_no_overflow():
    lat = tpmc.Lattice([((0, 1), -1.0)], seed_gen=0, device="cpu")
    lat.set_global_bias(1e6)
    es, ss = lat.run_monte_carlo(1.0, 20, 4)
    assert np.isfinite(es).all() and not ss.any()


def test_profiling_meter_and_trace(tmp_path):
    """``utils.profiling``: the meter's rates from its counts and clock, and a
    torch.profiler trace of a run written as a Chrome trace."""
    from pyisingmontecarlo_tpu_torch.utils.profiling import SweepMeter, trace

    lat = tpmc.Lattice(TRI, seed_gen=1, device="cpu")
    with trace(str(tmp_path / "tb")) as prof:
        with SweepMeter() as m:
            lat.run_monte_carlo(0.5, 3, 2)
            m.add(sweeps=3, sites=3 * 2 * 16)
    assert (tmp_path / "tb" / "trace.json").stat().st_size > 0
    assert "pmc.lattice.run_monte_carlo" in (tmp_path / "tb" / "trace.json").read_text()
    assert any(e.name.startswith("aten::") for e in prof.events())
    assert m.elapsed > 0 and m.sweeps_per_s == pytest.approx(3 / m.elapsed)
    assert m.updates_per_ns == pytest.approx(96 / (m.elapsed * 1e9)) and "sweeps/s" in m.report()
