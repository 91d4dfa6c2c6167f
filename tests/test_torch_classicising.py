"""The port's ``ClassicIsing`` against the JAX package's with the same seed,
bit for bit (tolerance: none; integer or dyadic couplings and fields) over
two successive calls, after ``add_graph`` with importance flags, with move
knobs, clusters and a sampling run; ``classicising_from_reference``; the
torus path's keys (``fold_in`` by the sweeps, as the JAX package's Pallas
route); the port's ``Lattice`` and ``ClassicIsing`` against the method lists
of tests/test_api_surface.py; and the twins of tests/test_classicising.py,
tests/test_classicising_torus.py, tests/test_worm.py and the ClassicIsing
parts of tests/test_cluster.py and tests/test_edge_cases.py."""

import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import pyisingmontecarlo_tpu as jpmc
import pyisingmontecarlo_tpu_torch as tpmc
from pyisingmontecarlo_tpu import models as jmodels
from pyisingmontecarlo_tpu_torch import ClassicIsing, Lattice
from pyisingmontecarlo_tpu_torch.engines.classical import worm_closure_fraction
from pyisingmontecarlo_tpu_torch.graph import compile_graph, grid_2d_edges
from pyisingmontecarlo_tpu_torch.interop import classicising_from_reference
from pyisingmontecarlo_tpu_torch.models import square_edges
from test_api_surface import CLASSIC, LATTICE

torch.set_num_threads(1)

EDGES = [((0, 1), -1.0), ((1, 2), -1.0), ((2, 3), -1.0), ((3, 0), -1.0)]
TRI = jmodels.triangular_edges(4, j=1.0)


def random_regular_pm_j(n, half_deg, seed):
    rng = np.random.default_rng(seed)
    seen, edges = set(), []
    for _ in range(half_deg):
        perm = rng.permutation(n)
        for i in range(n):
            a, b = int(perm[i]), int(perm[(i + 1) % n])
            key = (min(a, b), max(a, b))
            if a != b and key not in seen:
                seen.add(key)
                edges.append(((a, b), 1.0 if rng.random() < 0.5 else -1.0))
    return edges


def _key_data(ci):
    return np.asarray(jax.random.key_data(ci._keys))


def _same(ref, port):
    np.testing.assert_array_equal(port.get_states(), ref.get_states())
    np.testing.assert_array_equal(port._keys, _key_data(ref))


# ------------------------------------------------------------------ against the JAX package

def test_successive_calls_and_add_graph_equal_jax():
    kw = dict(longitudinal=0.25, num_experiments=3, seed=5)
    ref, port = jpmc.ClassicIsing(TRI, **kw), ClassicIsing(TRI, device="cpu", **kw)
    _same(ref, port)
    for ci in (ref, port):
        ci.run_monte_carlo(0.8, 4)
    _same(ref, port)
    np.testing.assert_array_equal(port.get_energies(), ref.get_energies())
    state = list(np.arange(16) % 2 == 0)
    for ci in (ref, port):
        ci.add_graph(initial_state=state, edge_move_importance_sampling=True)
        ci.add_graph()
    _same(ref, port)
    for ci in (ref, port):
        ci.run_monte_carlo(1.0, 3)
    _same(ref, port)
    want = ref.run_monte_carlo_sampling(0.9, 5, sampling_freq=2)
    got = port.run_monte_carlo_sampling(0.9, 5, sampling_freq=2)
    for g, w in zip(got, want):
        assert (g.shape, g.dtype) == (w.shape, w.dtype)
        np.testing.assert_array_equal(g, w)
    _same(ref, port)


def test_knobs_and_clusters_equal_jax():
    edges = [((a, b), j * (0.5 + 0.25 * (a % 3))) for (a, b), j in TRI]
    ref = jpmc.ClassicIsing(edges, longitudinal=-0.5, num_experiments=4, seed=9)
    ref.set_enable_cluster_updates(True)
    port = classicising_from_reference(ref, _key_data(ref), device="cpu")
    assert port.enable_cluster
    for ci in (ref, port):
        ci.run_monte_carlo(0.7, 3, nspinupdates=40, nedgeupdates=60, nwormupdates=1)
    _same(ref, port)


def test_from_reference_after_runs():
    ref = jpmc.ClassicIsing(TRI, num_experiments=2, seed=1, use_basic_moves=True)
    ref.add_graph(edge_move_importance_sampling=True)
    ref.run_monte_carlo(1.2, 3)
    port = classicising_from_reference(ref, _key_data(ref), device="cpu")
    assert port._imp_flags == [False, False, True] and port.use_basic_moves
    _same(ref, port)
    for ci in (ref, port):
        ci.run_monte_carlo(1.2, 2)
        ci.add_graph()
    _same(ref, port)
    with pytest.raises(ValueError):
        classicising_from_reference(ref, _key_data(ref)[:1], device="cpu")


def test_torus_path_folds_keys():
    """On the torus the kernel's seeds come from the keys, and a call of T
    sweeps leaves each key ``fold_in(key, T)`` (the JAX package's Pallas route)."""
    port = ClassicIsing(grid_2d_edges(8, 8), num_experiments=3, seed=1, device="cpu", use_basic_moves=True)
    keys = jax.random.wrap_key_data(port._keys.copy())
    port.run_monte_carlo(1.0, 5, nspinupdates=2 * 64)
    want = jax.vmap(jax.random.fold_in, in_axes=(0, None))(keys, 10)
    np.testing.assert_array_equal(port._keys, np.asarray(jax.random.key_data(want)))
    port.run_monte_carlo_sampling(1.0, 0)
    np.testing.assert_array_equal(port._keys, np.asarray(jax.random.key_data(want)))


# ------------------------------------------------------------------ the API surface

@pytest.mark.parametrize("cls,spec", [(Lattice, LATTICE), (ClassicIsing, CLASSIC)], ids=["Lattice", "ClassicIsing"])
def test_method_surface(cls, spec):
    """Every method of tests/test_api_surface.py's list, with its parameters
    in order; keyword-only extensions (``device``, ``dtau``) have defaults."""
    for name, required, optional in spec:
        sig = inspect.signature(getattr(cls, name))
        params = [p for p in sig.parameters.values() if p.name != "self"]
        for p in params:
            if p.kind is inspect.Parameter.KEYWORD_ONLY:
                assert p.default is not inspect.Parameter.empty, (cls.__name__, name, p.name)
        names = [p.name for p in params if p.kind is not inspect.Parameter.KEYWORD_ONLY]
        assert names == required + optional, (cls.__name__, name, names)
        for p in params[:len(required)]:
            assert p.default is inspect.Parameter.empty, (cls.__name__, name, p.name)
        for p in params[len(required):len(names)]:
            assert p.default is not inspect.Parameter.empty, (cls.__name__, name, p.name)


def test_exported():
    assert tpmc.ClassicIsing is ClassicIsing and "ClassicIsing" in tpmc.__all__
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the check is for hosts without it")
    with pytest.raises(RuntimeError, match="cuda"):
        ClassicIsing(EDGES)


# ------------------------------------------------------------------ twins of tests/test_classicising.py

def test_constructor_builds_experiments():
    ci = ClassicIsing(EDGES, num_experiments=5, seed=0, device="cpu")
    assert ci.num_graphs == 5 and ci.get_states().shape == (5, 4)


def test_add_graph_with_initial_state():
    ci = ClassicIsing(EDGES, num_experiments=0, seed=0, device="cpu")
    ci.add_graph(initial_state=[True, True, False, False])
    assert ci.num_graphs == 1
    np.testing.assert_array_equal(ci.get_states()[0], [True, True, False, False])
    with pytest.raises(ValueError):
        ci.add_graph(initial_state=[True])


def test_state_persists_across_calls():
    ci = ClassicIsing(EDGES, num_experiments=4, seed=1, device="cpu")
    ci.run_monte_carlo(10.0, 50)
    s1 = ci.get_states()
    ci.run_monte_carlo(10.0, 5, only_basic_moves=True)
    assert (ci.get_energies() == -4.0).all() and (ci.get_states() == s1).all()


def test_run_returns_none_and_sampling_shapes():
    ci = ClassicIsing(EDGES, num_experiments=3, seed=2, device="cpu")
    assert ci.run_monte_carlo(1.0, 5) is None
    es, ss = ci.run_monte_carlo_sampling(1.0, 10, sampling_freq=3)
    assert es.shape == (3, 3) and ss.shape == (3, 3, 4)


def test_move_count_knobs_and_basic_moves():
    ci = ClassicIsing(EDGES, num_experiments=2, seed=3, device="cpu")
    ci.run_monte_carlo(0.5, 3, nspinupdates=10, nedgeupdates=0, nwormupdates=0)
    ci.run_monte_carlo(0.5, 3, nspinupdates=1, nedgeupdates=8, nwormupdates=2)
    ci = ClassicIsing(EDGES, num_experiments=2, seed=4, use_basic_moves=True, device="cpu")
    ci.run_monte_carlo(1.0, 5)
    assert ci.run_monte_carlo_sampling(1.0, 5)[0].shape == (2, 5)


def test_longitudinal_field_thermodynamics():
    ci = ClassicIsing([((0, 1), 0.0)], longitudinal=2.0, num_experiments=64, seed=5, device="cpu")
    ci.run_monte_carlo(2.0, 60)
    assert np.where(ci.get_states(), 1, -1).mean() < -0.9


def test_chunked_dispatch_bit_exact(monkeypatch):
    ref = ClassicIsing(TRI, num_experiments=4, seed=9, device="cpu")
    ref.run_monte_carlo(0.8, 13)
    monkeypatch.setenv("PMC_STEPS_PER_DISPATCH", "5")  # 5 + 5 + 3
    chk = ClassicIsing(TRI, num_experiments=4, seed=9, device="cpu")
    chk.run_monte_carlo(0.8, 13)
    np.testing.assert_array_equal(chk.get_states(), ref.get_states())
    np.testing.assert_array_equal(chk._keys, ref._keys)


def test_empty_container_and_zero_timesteps():
    ci = ClassicIsing(TRI, num_experiments=0, seed=0, device="cpu")
    ci.run_monte_carlo(1.0, 3)
    es, ss = ci.run_monte_carlo_sampling(1.0, 4, sampling_freq=2)
    assert es.shape == (0, 2) and ss.shape == (0, 2, 16) and ci.get_energies().shape == (0,)
    ci = ClassicIsing([((0, 1), -1.0)], num_experiments=2, seed=0, device="cpu")
    s0 = ci.get_states()
    ci.run_monte_carlo(1.0, 0)
    np.testing.assert_array_equal(ci.get_states(), s0)


# ------------------------------------------------------------------ twins of tests/test_classicising_torus.py

def test_fast_path_dispatch_and_physics():
    ci = ClassicIsing(grid_2d_edges(8, 8, j=-1.0), num_experiments=16, seed=0, use_basic_moves=True, device="cpu")
    assert ci._torus == (8, -1.0)
    ci.run_monte_carlo(1.0, 300)
    assert np.abs(np.where(ci.get_states(), 1.0, -1.0).mean(axis=1)).mean() > 0.9
    es, ss = ci.run_monte_carlo_sampling(1.0, 20, sampling_freq=4)
    assert es.shape == (16, 5) and ss.shape == (16, 5, 64)
    np.testing.assert_allclose(es[:, -1], ci.get_energies())
    assert ci._ga is not None  # get_energies built the graph engine's tensors


def test_fast_and_generic_paths_agree_statistically():
    stats = []
    for basic in (True, False):  # True: the torus kernel; False: the graph engine with worms
        ci = ClassicIsing(grid_2d_edges(6, 6, j=-1.0), num_experiments=48, seed=3, use_basic_moves=basic,
                          device="cpu")
        es, _ = ci.run_monte_carlo_sampling(0.35, 40, thermalization_time=400, sampling_freq=8)
        stats.append((es.mean(), es.mean(axis=1).std(ddof=1) / np.sqrt(48)))
    (m1, s1), (m2, s2) = stats
    assert abs(m1 - m2) < 5 * np.hypot(s1, s2) + 0.2, stats


def test_longitudinal_field_on_torus():
    ci = ClassicIsing(grid_2d_edges(8, 8, j=0.25), longitudinal=1.5, num_experiments=16, seed=1,
                      use_basic_moves=True, device="cpu")
    ci.run_monte_carlo(2.0, 200)
    assert np.where(ci.get_states(), 1.0, -1.0).mean() < -0.8


def test_explicit_move_counts_route_to_generic_path():
    ci = ClassicIsing(grid_2d_edges(6, 6, j=-1.0), num_experiments=4, seed=2, device="cpu")
    ci.run_monte_carlo(0.8, 3, nwormupdates=2)
    assert ci._ga is not None


def test_default_args_take_fast_path():
    c = ClassicIsing(square_edges(8, 8), num_experiments=2, seed=1, device="cpu")
    assert c._fast2d(c._move_args(None, None, None, None))
    assert c._fast2d(c._move_args(None, 0, 0, None))
    assert not c._fast2d(c._move_args(None, 64, None, None))
    assert not c._fast2d(c._move_args(None, None, 2, None))
    c.set_enable_cluster_updates(True)
    assert not c._fast2d(c._move_args(None, None, None, None))


# ------------------------------------------------------------------ twins of tests/test_worm.py and test_cluster.py

def test_worm_closure_on_4regular_glass_and_torus():
    assert worm_closure_fraction(compile_graph(random_regular_pm_j(512, 2, seed=7)), trials=4096, seed=1,
                                 device="cpu") >= 0.5
    assert worm_closure_fraction(compile_graph(grid_2d_edges(16, 16, j=-1.0)), trials=4096, seed=2,
                                 device="cpu") >= 0.5


def test_worm_improves_low_T_relaxation_on_glass():
    """Quenched to beta = 4 on the frustrated glass, steps with 16 worms relax
    lower than spin-only steps, by more than 3 combined standard errors."""
    edges = random_regular_pm_j(96, 2, seed=3)
    beta, R, t = 4.0, 2048, 20

    def mean_energy(nworm):
        ci = ClassicIsing(edges, num_experiments=R, seed=11, device="cpu")
        ci.run_monte_carlo(beta, t, nspinupdates=1, nedgeupdates=0, nwormupdates=nworm)
        es, _ = ci.run_monte_carlo_sampling(beta, 1, nspinupdates=0, nedgeupdates=0, nwormupdates=0)
        return float(es.mean()), float(es.std(ddof=1) / np.sqrt(R))

    (e_spin, se_spin), (e_worm, se_worm) = mean_energy(0), mean_energy(16)
    assert e_worm < e_spin - 3 * np.hypot(se_spin, se_worm), (e_worm, e_spin)


def test_classicising_cluster_wiring():
    ci = ClassicIsing(grid_2d_edges(8, 8, j=-1.0), num_experiments=8, seed=3, device="cpu")
    ci.set_enable_cluster_updates(True)
    ci.run_monte_carlo(1.0, 30)
    assert ci.get_energies().mean() / 64 < -1.9
