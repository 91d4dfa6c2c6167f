"""The torch port's ``Lattice`` on the square torus against the JAX package:
the problem and seed stream carried across, energies and return types, the
sampled energy against the JAX package and against exact enumeration, and the
branches that are not ported yet."""

import itertools
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

import pyisingmontecarlo_tpu as jpmc
import pyisingmontecarlo_tpu_torch as tpmc
from pyisingmontecarlo_tpu.graph import grid_2d_edges
from pyisingmontecarlo_tpu.ops import lattice2d as jl2d
from pyisingmontecarlo_tpu_torch.interop import lattice_from_reference, state_to_numpy, state_to_torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pair(L=8, seed=5, h=0.0, init=True):
    ref = jpmc.Lattice(grid_2d_edges(L, L), seed_gen=seed)
    if h:
        ref.set_global_bias(h)
    if init:
        ref.set_initial_state(np.random.default_rng(seed).integers(0, 2, L * L).astype(bool))
    return ref, lattice_from_reference(ref, device="cpu")


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import pyisingmontecarlo_tpu_torch, pyisingmontecarlo_tpu_torch.interop\n"
        "import pyisingmontecarlo_tpu_torch._kernels, pyisingmontecarlo_tpu_torch.ops.lattice2d\n"
        "import pyisingmontecarlo_tpu_torch.ops.wl, pyisingmontecarlo_tpu_torch.engines.worldline\n"
        "import pyisingmontecarlo_tpu_torch.engines.observables, pyisingmontecarlo_tpu_torch.rng\n"
        "import pyisingmontecarlo_tpu_torch.graph, pyisingmontecarlo_tpu_torch.tempering\n"
        "import pyisingmontecarlo_tpu_torch.ops.ladder, pyisingmontecarlo_tpu_torch.utils.cbor\n"
        "import pyisingmontecarlo_tpu_torch.engines.classical, pyisingmontecarlo_tpu_torch.classicising\n"
        "import pyisingmontecarlo_tpu_torch.models, pyisingmontecarlo_tpu_torch.models.lattices\n"
        "import pyisingmontecarlo_tpu_torch.utils.profiling, pyisingmontecarlo_tpu_torch.utils.accum\n"
        "import pyisingmontecarlo_tpu_torch.qmcising, pyisingmontecarlo_tpu_torch.qmcrunner\n"
        "import pyisingmontecarlo_tpu_torch.engines.generic, pyisingmontecarlo_tpu_torch.engines.generic_gm\n"
        "import pyisingmontecarlo_tpu_torch.entry, pyisingmontecarlo_tpu_torch.examples.tau_sharded_tfim\n"
        "import pyisingmontecarlo_tpu_torch.parallel.replica, pyisingmontecarlo_tpu_torch.parallel.tempering\n"
        "import pyisingmontecarlo_tpu_torch.parallel.spatial, pyisingmontecarlo_tpu_torch.parallel.tau\n"
        "import py_monte_carlo_torch, pyisingmontecarlo_tpu_torch._native_graph\n"
        "import pyisingmontecarlo_tpu_torch.examples.ferromagnet_phase_diagram\n"
        "import pyisingmontecarlo_tpu_torch.examples.tfim_quantum_phase_transition\n"
        "import pyisingmontecarlo_tpu_torch.examples.spin_glass_tempering\n"
        "import pyisingmontecarlo_tpu_torch.examples.trotter_extrapolation\n"
        "import os\n"
        "for mode in ('1', '0'):\n"
        "    os.environ['PMC_GENERIC_GM'] = mode\n"
        "    r = pyisingmontecarlo_tpu_torch.QmcRunner(3, 2, seed=0, do_loop_updates=True, device='cpu')\n"
        "    r.add_diagonal_interaction([-1.0, 1.0, 1.0, -1.0], [0, 1])\n"
        "    r.add_interaction([0.0, 0.0, 0.0, -0.5, 0.0, 0.0, -0.5, 0.0, 0.0, -0.5, 0.0, 0.0, -0.5, 0.0, 0.0, 0.0],\n"
        "                      [0, 1])\n"
        "    r.run_sampling(1.0, 2); r.run_bond_sampling(1.0, 2)\n"
        "q = pyisingmontecarlo_tpu_torch.QmcIsing([((0, 1), 1.0), ((1, 2), -1.0)], 1.0, num_experiments=2,\n"
        "                                         do_rvb_updates=True, device='cpu')\n"
        "q.run_qmc(1.0, 2); q.run_cluster(); q.run_rvb(); q.run_bond_sampling(1.0, 2)\n"
        "lt = pyisingmontecarlo_tpu_torch.LatticeTempering([((i, (i + 1) % 4), -1.0) for i in range(4)],\n"
        "                                                  seed=0, device='cpu')\n"
        "lt.add_graph(1.0, 0.0, 0.5)\n"
        "lt.add_graph(1.0, 0.0, 0.6)\n"
        "lt.qmc_timesteps_sample(2)\n"
        "tri = pyisingmontecarlo_tpu_torch.models.triangular_edges(4)\n"
        "lat = pyisingmontecarlo_tpu_torch.Lattice(tri, seed_gen=0, device='cpu')\n"
        "lat.set_enable_cluster_updates(True)\n"
        "lat.run_monte_carlo_annealing_and_get_energies([(0, 0.1), (2, 1.0)], 2, 2)\n"
        "ci = pyisingmontecarlo_tpu_torch.ClassicIsing(tri, num_experiments=2, seed=0, device='cpu')\n"
        "ci.run_monte_carlo_sampling(1.0, 2)\n"
        "pyisingmontecarlo_tpu_torch.engines.classical.worm_closure_fraction(lat.cg, trials=4, device='cpu')\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'pyisingmontecarlo_tpu.')))\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_cuda_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the check is for hosts without it")
    with pytest.raises(RuntimeError, match="cuda"):
        tpmc.Lattice(grid_2d_edges(4, 4))
    with pytest.raises(RuntimeError, match="cuda"):
        tpmc.Lattice(grid_2d_edges(4, 4), device="cuda")


def test_seed_stream_and_problem_carried_across():
    ref, port = _pair(h=0.25)
    assert port._torus == (8, -1.0) and port.bias == ("global", 0.25)
    np.testing.assert_array_equal(port.initial_state, ref.initial_state)
    assert port.make_seeds(4) == ref.make_seeds(4)
    assert port.clone().make_seeds(3) == ref.clone().make_seeds(3)


def test_energies_equal_jax_energy_of_states():
    """Tolerance: none. The port's energies equal the JAX package's
    ``energy_2d`` of the port's own returned states."""
    ref, port = _pair(h=0.3)
    es, st = port.run_monte_carlo(0.4, 20, 6)
    s = np.where(st, 1, -1).astype(np.int8).reshape(6, 8, 8)
    want = np.asarray(jl2d.energy_2d(jnp.asarray(s), -1.0, 0.3), np.float64)
    np.testing.assert_array_equal(es, want)


_BETAS = [(0, 0.1), (10, 1.0)]


@pytest.mark.parametrize(
    "method,args,kwargs",
    [
        ("run_monte_carlo", (0.4, 10, 3), {}),
        ("run_monte_carlo_sampling", (0.4, 12, 3), dict(thermalization_time=4, sampling_freq=5)),
        ("run_monte_carlo_annealing", (_BETAS, 10, 3), {}),
        ("run_monte_carlo_annealing_and_get_energies", (_BETAS, 10, 3), {}),
        ("run_monte_carlo", (0.4, 10, 0), {}),  # zero experiments
        ("run_monte_carlo_sampling", (0.4, 3, 2), dict(sampling_freq=5)),  # freq > timesteps
    ],
)
def test_return_types_match_jax(method, args, kwargs):
    ref, port = _pair(init=False)
    want = getattr(ref, method)(*args, **kwargs)
    got = getattr(port, method)(*args, **kwargs)
    for w, g in zip(want, got):
        assert isinstance(g, np.ndarray)
        assert (g.shape, g.dtype) == (w.shape, w.dtype), (method, g.shape, w.shape)


def test_sampling_continues_the_stream():
    """Thermalization then sampling is one counter stream: the last sample
    equals the state after the same number of plain sweeps (tolerance: none)."""
    _, port = _pair(init=False)
    other = port.clone()
    _, ss = port.run_monte_carlo_sampling(0.5, 6, 4, thermalization_time=5, sampling_freq=3)
    _, st = other.run_monte_carlo(0.5, 11, 4)
    np.testing.assert_array_equal(ss[:, -1], st)


def _mean_se(es):
    return es.mean(), es.std(ddof=1) / np.sqrt(len(es))


@pytest.mark.parametrize("beta", [0.2, 0.44, 0.8])
def test_mean_energy_matches_jax(beta):
    """Same dynamics from the same kind of random start: after 100 sweeps the
    mean energy of 256 replicas on the 8x8 torus agrees with the JAX package's
    within 5 combined standard errors."""
    ref, port = _pair(init=False, seed=17)
    m1, s1 = _mean_se(ref.run_monte_carlo(beta, 100, 256)[0])
    m2, s2 = _mean_se(port.run_monte_carlo(beta, 100, 256)[0])
    assert abs(m1 - m2) < 5 * np.hypot(s1, s2), (beta, m1, m2, s1, s2)


def test_energy_matches_exact_enumeration():
    """4x4 torus at beta=0.3: <E> over 2048 replicas after 100 sweeps is within
    5 standard errors of the exact value from all 2^16 states."""
    L, beta = 4, 0.3
    spins = np.array(list(itertools.product((-1, 1), repeat=L * L)), np.int8).reshape(-1, L, L)
    e = -(spins * np.roll(spins, -1, 1)).sum((1, 2)) - (spins * np.roll(spins, -1, 2)).sum((1, 2))
    w = np.exp(-beta * (e - e.min()))
    exact = (w * e).sum() / w.sum()
    port = tpmc.Lattice(grid_2d_edges(L, L), seed_gen=2, device="cpu")
    m, se = _mean_se(port.run_monte_carlo(beta, 100, 2048)[0])
    assert abs(m - exact) < 5 * se, (m, exact, se)


def test_unported_branches_raise():
    """Every classical branch runs now (the graph engine takes what the torus
    kernel does not), and so do the quantum methods off the worldline kernel's
    lattices (the generic worldline engine), QmcIsing and QmcRunner are
    exported; a name the package lacks raises AttributeError."""
    port = tpmc.Lattice(grid_2d_edges(4, 4), device="cpu")
    for setup in (
        lambda l: l.set_individual_bias(0, 0.5),
        lambda l: l.set_enable_cluster_updates(True),
        lambda l: l.set_enable_heatbath_update(True),
    ):
        lat = port.clone()
        setup(lat)
        assert not lat._fast2d()
        es, st = lat.run_monte_carlo(0.3, 2, 2)
        assert es.shape == (2,) and st.shape == (2, 16)
    chain = tpmc.Lattice([((0, 1), 1.0), ((1, 2), 1.0)], device="cpu")
    es, st = chain.run_monte_carlo_annealing([(0, 0.1)], 2, 2)
    assert es.shape == (2,) and st.shape == (2, 3)
    chain.set_transverse_field(1.0)
    es, st = chain.run_quantum_monte_carlo(1.0, 2, 2)
    assert es.shape == (2,) and np.isfinite(es).all() and st.shape == (2, 3)
    lat = port.clone()
    lat.set_transverse_field(1.0)
    with pytest.raises(ValueError, match="transverse"):
        lat.run_monte_carlo(0.3, 2, 2)
    with pytest.raises(ValueError):
        tpmc.Lattice([], device="cpu")
    assert tpmc.ClassicIsing is not None and tpmc.QmcIsing is not None and tpmc.QmcRunner is not None
    with pytest.raises(AttributeError):
        getattr(tpmc, "NoSuchClass")


def test_state_interop_round_trip():
    s = np.random.default_rng(0).integers(0, 2, (3, 6, 6)).astype(np.int8) * 2 - 1
    t = state_to_torch(s)
    assert t.dtype == torch.int8 and t.is_contiguous()
    np.testing.assert_array_equal(state_to_numpy(t), s)
    with pytest.raises(ValueError):
        state_to_torch(s[0])
