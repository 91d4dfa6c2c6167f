"""The torch port's quantum ``Lattice`` methods and worldline ensemble against
the JAX package's, with the JAX side forced onto its worldline kernel
(``wl_pallas.supported`` and ``supported_sample`` patched to True, Pallas in
interpret mode). The problem and the seed stream are carried across by
``interop.lattice_from_reference``; initial worldlines come from the same
threefry keys, and wait buffers continue the keys with ``fold_in``, so the
energies, states, measures and op counts must be equal (tolerance: none).
The autocorrelations are f32 FFTs on both sides and agree within 1e-4 (the
bound of tests/test_observables.py). Also the branches that are not ported
and the device check."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")
import jax
from jax.experimental.pallas import tpu as pltpu

import pyisingmontecarlo_tpu as jpmc
from pyisingmontecarlo_tpu import rng as jrng
from pyisingmontecarlo_tpu.engines import worldline as jwl
from pyisingmontecarlo_tpu.graph import compile_graph, grid_2d_edges
from pyisingmontecarlo_tpu.ops import wl_pallas as wp
from pyisingmontecarlo_tpu_torch import Lattice
from pyisingmontecarlo_tpu_torch.engines import observables as tobs
from pyisingmontecarlo_tpu_torch.engines import worldline as twl
from pyisingmontecarlo_tpu_torch.interop import lattice_from_reference, worldline_from_arrays

torch.set_num_threads(1)

RING8 = [((i, (i + 1) % 8), -1.0) for i in range(8)]


@pytest.fixture
def jax_on_kernel(monkeypatch):
    """The JAX package's worldline path forced onto its Pallas kernel."""
    monkeypatch.setattr(wp, "supported", lambda *a, **k: True)
    monkeypatch.setattr(wp, "supported_sample", lambda *a, **k: True)
    with pltpu.force_tpu_interpret_mode():
        yield


def _pair(edges, seed, gamma=1.0, h=0.0, init=False):
    ref = jpmc.Lattice(edges, seed_gen=seed)
    ref.set_transverse_field(gamma)
    if h:
        ref.set_global_bias(h)
    if init:
        nvars = ref.nvars
        ref.set_initial_state(np.random.default_rng(seed).integers(0, 2, nvars).astype(bool))
    return ref, lattice_from_reference(ref, device="cpu")


def _assert_equal(want, got):
    for w, g in zip(want, got):
        assert isinstance(g, (np.ndarray, float))
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
        assert np.asarray(g).dtype == np.asarray(w).dtype


def test_run_qmc_and_sampling_with_wait_equal_jax(jax_on_kernel):
    """A ring from random initial states: one plain run, then sampling after
    a wait buffer (the wait's keys are folded before the sampling run)."""
    ref, port = _pair(RING8, 3, h=0.1)
    _assert_equal(ref.run_quantum_monte_carlo(1.0, 6, 3), port.run_quantum_monte_carlo(1.0, 6, 3))
    kw = dict(sampling_wait_buffer=4, sampling_freq=2)
    want = ref.run_quantum_monte_carlo_sampling(1.0, 9, 3, **kw)
    got = port.run_quantum_monte_carlo_sampling(1.0, 9, 3, **kw)
    assert got[1].shape == (3, 4, 8) and got[1].dtype == np.bool_
    _assert_equal(want, got)


def test_measure_spins_and_op_counts_equal_jax(jax_on_kernel):
    ref, port = _pair(RING8, 5, gamma=0.8, init=True)
    kw = dict(sampling_wait_buffer=3, sampling_freq=3, spin_measurement=(0.0, 1.0), exponent=2)
    _assert_equal(ref.run_quantum_monte_carlo_and_measure_spins(1.5, 9, 2, **kw),
                  port.run_quantum_monte_carlo_and_measure_spins(1.5, 9, 2, **kw))
    kw = dict(sampling_wait_buffer=2)
    _assert_equal(ref.average_on_and_off_diagonal_and_consts(1.5, 5, 2, **kw),
                  port.average_on_and_off_diagonal_and_consts(1.5, 5, 2, **kw))
    assert port.get_offset() == ref.get_offset()


def test_bond_autocorrelation_on_torus_close_to_jax(jax_on_kernel):
    """4x4 torus: the same samples on both sides; f32 FFTs, |delta| <= 1e-4."""
    ref, port = _pair(grid_2d_edges(4, 4), 4)
    kw = dict(sampling_wait_buffer=3, sampling_freq=2)
    want = ref.run_quantum_monte_carlo_and_measure_bond_autocorrelation(1.0, 12, 2, **kw)
    got = port.run_quantum_monte_carlo_and_measure_bond_autocorrelation(1.0, 12, 2, **kw)
    assert got.shape == want.shape == (2, 6) and got.dtype == np.float64
    np.testing.assert_allclose(got[:, 0], 1.0, atol=1e-6)
    assert np.abs(got - want).max() <= 1e-4


def test_ensemble_from_jax_arrays_continues_jax_trajectory(jax_on_kernel):
    """``worldline_from_arrays``: a JAX ensemble's state and key data carried
    across mid-run; the next sweeps, samples and keys are the JAX kernel's."""
    keys = jrng.keys_from_seeds(np.array([11, 2**63 + 5], np.uint64))
    ens = jwl.WorldlineEnsemble(compile_graph(RING8), 1.0, 0.0, 1.0, keys, 2)
    assert ens._pallas_dense == ("ring", 8, -1.0)
    ens.timesteps(3)
    port = worldline_from_arrays(np.asarray(ens.s), np.asarray(jax.random.key_data(ens.keys)),
                                 1.0, 1.0, 0.0, ens.L, ("ring", 8, -1.0), device="cpu")
    want_e, want_s = ens.timesteps_sample(7, 2)
    got_e, got_s = port.timesteps_sample(7, 2)
    np.testing.assert_array_equal(got_e, want_e)
    np.testing.assert_array_equal(got_s, want_s)
    np.testing.assert_array_equal(port.key_data, np.asarray(jax.random.key_data(ens.keys)))
    np.testing.assert_array_equal(port.itime_states(1), np.asarray(ens.itime_states(1)))


def test_return_shapes_and_edge_cases():
    """t = 0 (the energy of the start: f32 sums of 160 terms, in another
    order on each side, so |delta| <= 1e-5), freq > timesteps (no samples),
    zero experiments; types as the JAX package's XLA path."""
    ref, port = _pair(RING8, 7)
    want = ref.run_quantum_monte_carlo(1.0, 0, 3)
    got = port.run_quantum_monte_carlo(1.0, 0, 3)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
    for method, args, kw in [
        ("run_quantum_monte_carlo_sampling", (1.0, 3, 2), dict(sampling_freq=5)),
        ("run_quantum_monte_carlo", (1.0, 4, 0), {}),
        ("run_quantum_monte_carlo_and_measure_variable_autocorrelation", (1.0, 6, 2), dict(sampling_freq=2)),
        ("run_quantum_monte_carlo_and_measure_spin_product_autocorrelation", (1.0, 6, 2, [[0, 1], [2]]), {}),
    ]:
        want = getattr(ref, method)(*args, **kw)
        got = getattr(port, method)(*args, **kw)
        for w, g in zip(want if isinstance(want, tuple) else (want,), got if isinstance(got, tuple) else (got,)):
            assert (g.shape, g.dtype) == (w.shape, w.dtype), (method, g.shape, w.shape)


def test_autocorrelation_device_close_to_jax():
    """Same [R, T, C] series, including constant channels (rho = 1): f32 FFTs
    on both sides, |delta| <= 1e-4; and the zero-length series."""
    from pyisingmontecarlo_tpu.engines import observables as jobs

    x = np.where(np.random.default_rng(0).random((3, 37, 5)) < 0.3, -1.0, 1.0).astype(np.float32)
    x[:, :, 4] = 1.0
    want = jobs.autocorrelation_device(jnp.asarray(x))
    got = tobs.autocorrelation_device(torch.from_numpy(x))
    assert got.shape == (3, 37) and got.dtype == np.float64
    assert np.abs(got - want).max() <= 1e-4
    assert tobs.autocorrelation_device(torch.zeros((2, 0, 3))).shape == (2, 0)
    np.testing.assert_array_equal(tobs.pad_autocorr(got, 40), jobs.pad_autocorr(got, 40))


def test_unported_and_invalid_quantum_branches():
    """Graphs off the kernel's lattices and RVB runs take the generic engine
    (tests/test_torch_worldline_generic.py holds it to the JAX package);
    the invalid branches raise."""
    tri = [((0, 1), 1.0), ((1, 2), 1.0), ((0, 2), 1.0)]
    for edges in (tri, grid_2d_edges(4, 4, -1.0)[:-1]):
        lat = Lattice(edges, device="cpu")
        lat.set_transverse_field(1.0)
        es, st = lat.run_quantum_monte_carlo(1.0, 2, 2)
        assert es.shape == (2,) and np.isfinite(es).all() and st.shape == (2, lat.nvars)
    lat = Lattice(RING8, device="cpu")
    lat.set_transverse_field(1.0)
    lat.set_enable_rvb_update(True)
    assert not lat._worldline(2, 1.0).on_kernel()
    es, ss = lat.run_quantum_monte_carlo_sampling(1.0, 2, 2)
    assert es.shape == (2,) and ss.shape == (2, 2, 8)
    lat = Lattice(RING8, device="cpu")
    with pytest.raises(ValueError, match="transverse"):
        lat.run_quantum_monte_carlo(1.0, 2, 2)
    with pytest.raises(ValueError, match="transverse"):
        lat.get_offset()
    lat.set_transverse_field(1.0)
    lat.set_individual_bias(0, 0.5)
    with pytest.raises(ValueError, match="individual"):
        lat.run_quantum_monte_carlo(1.0, 2, 2)
    lat = Lattice(RING8, device="cpu", dtau=2.0)  # L_tau stays >= 4 and even
    lat.set_transverse_field(1.0)
    assert lat.run_quantum_monte_carlo(1.0, 2, 2)[0].shape == (2,)
    assert twl.choose_ltau(2.0, 1.0) == 40 and twl.choose_ltau(0.1, 0.5) == 4


def test_heatbath_flag_has_no_effect_on_the_kernel_path():
    a = Lattice(RING8, seed_gen=9, device="cpu")
    a.set_transverse_field(1.0)
    b = a.clone()
    b.set_enable_heatbath_update(True)
    _assert_equal(a.run_quantum_monte_carlo(1.0, 4, 2), b.run_quantum_monte_carlo(1.0, 4, 2))


def test_worldline_from_arrays_cuda_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the check is for hosts without it")
    s = np.ones((1, 8, 8), np.int8)
    with pytest.raises(RuntimeError, match="cuda"):
        worldline_from_arrays(s, np.zeros((1, 2), np.uint32), 1.0, 1.0, 0.0, 8, ("ring", 8, -1.0))


def test_measure_spins_shorter_than_freq_samples_the_first_sweep():
    """A run shorter than ``sampling_freq`` takes one sample, after the first
    sweep (where the JAX package's XLA path takes it): the first sample of a
    sampling run from the same seeds, and the same energies (tolerance: none)."""
    lat = Lattice(RING8, seed_gen=11, device="cpu")
    lat.set_transverse_field(1.0)
    other = lat.clone()
    meas, es = lat.run_quantum_monte_carlo_and_measure_spins(1.0, 3, 2, sampling_freq=5, exponent=2)
    es2, ss = other.run_quantum_monte_carlo_sampling(1.0, 3, 2, sampling_freq=1)
    np.testing.assert_array_equal(meas, np.where(ss[:, 0], 1.0, -1.0).sum(-1) ** 2)
    np.testing.assert_array_equal(es, es2)
    meas0, es0 = lat.run_quantum_monte_carlo_and_measure_spins(1.0, 0, 2)
    assert meas0.tolist() == [0.0, 0.0] and es0.tolist() == [0.0, 0.0]
