"""The port's ``QmcIsing`` against the JAX package's, and its own checks.

Against the JAX package, bit for bit in states, keys, cluster sizes, RVB
ratios, bond counts and samples (tolerance: none), energies within 2e-6
relative and autocorrelations within 1e-4 (f32 FFTs on both sides), through
``interop.qmcising_from_reference`` (which carries the JAX ensemble's f32
parameters across):

- a run / diagonal / cluster / RVB / sampling / bond-sampling sequence on a
  4-regular +-J glass (n = 32, field 0.3) and on a periodic triangular patch
  (4 x 4, dtau = 1/16), then on the glass full sweeps with RVB on and an
  autocorrelation;
- pending initial states carried before the first run;
- a regrid when beta changes L_tau (``make_params`` is held on its own in
  tests/test_torch_worldline_generic.py; here the ``jax_params`` fixture
  hands the port the JAX package's f32 parameters for the new grid);
- ``add_qmc`` after materialization; ``clone`` independence;
- CBOR files written by the JAX class read by the port's, and the reverse;
- an 8-ring with the JAX side forced onto its worldline kernel, mixing the
  kernel route (``run_qmc``, ``run_sampling``: keys folded) with the generic
  one (diagonal, cluster, RVB: keys split).

Then the twins of tests/test_qmcising.py on the port (CPU), with their
bounds, and an 8-site +-J graph with a field against dense diagonalization."""

import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
from jax.experimental.pallas import tpu as pltpu

import pyisingmontecarlo_tpu as jpmc
import pyisingmontecarlo_tpu_torch as tpmc
from helpers import dense_tfim_energy
from pyisingmontecarlo_tpu import models as jmodels
from pyisingmontecarlo_tpu.engines import worldline as jwl
from pyisingmontecarlo_tpu.ops import wl_pallas as wp
from pyisingmontecarlo_tpu_torch import QmcIsing
from pyisingmontecarlo_tpu_torch.engines import worldline as twl
from pyisingmontecarlo_tpu_torch.interop import qmcising_from_reference
from test_api_surface import QMCISING

torch.set_num_threads(1)

E_RTOL = 2e-6
RING4 = [((i, (i + 1) % 4), -1.0) for i in range(4)]
RING8 = [((i, (i + 1) % 8), -1.0) for i in range(8)]


def glass(n, seed=7):
    r = np.random.default_rng(seed)
    seen, edges = set(), []
    for _ in range(2):
        perm = r.permutation(n)
        for i in range(n):
            a, b = int(perm[i]), int(perm[(i + 1) % n])
            if a != b and (min(a, b), max(a, b)) not in seen:
                seen.add((min(a, b), max(a, b)))
                edges.append(((a, b), 1.0 if r.random() < 0.5 else -1.0))
    return edges


# name -> (edges, transverse, longitudinal, beta, dtau)
PROBLEMS = {
    "glass": (glass(32), 1.0, 0.3, 2.0, None),
    "triangular": (jmodels.triangular_edges(4, j=1.0), 0.7, 0.25, 1.5, 1 / 16),
}


@pytest.fixture
def jax_on_kernel(monkeypatch):
    """The JAX package's worldline path forced onto its Pallas kernel."""
    monkeypatch.setattr(wp, "supported", lambda *a, **k: True)
    monkeypatch.setattr(wp, "supported_sample", lambda *a, **k: True)
    with pltpu.force_tpu_interpret_mode():
        yield


@pytest.fixture
def jax_params(monkeypatch):
    """The port's ensembles built with the JAX package's f32 ``make_params``
    values (torch's and XLA's f32 tanh and log differ in the last ulps)."""
    def carried(betas, gammas, hs, L, device="cpu"):
        return twl.params_from_arrays([np.asarray(x) for x in jwl.make_params(betas, gammas, hs, L)], device)

    monkeypatch.setattr(twl, "make_params", carried)


def _keys(ref):
    k = ref._w.keys if ref._w is not None else ref._keys
    return np.asarray(jax.random.key_data(k))


def _pair(name, R=5, seed=3, **kw):
    edges, gamma, h, beta, dtau = PROBLEMS[name]
    ref = jpmc.QmcIsing(edges, gamma, h, num_experiments=R, seed=seed, dtau=dtau, **kw)
    ref._ensure(beta)
    return ref, qmcising_from_reference(ref, _keys(ref), device="cpu"), beta


def _same_state(ref, port):
    assert port.num_graphs == ref.num_graphs
    np.testing.assert_array_equal(port._w.s.numpy(), np.asarray(ref._w.s))
    np.testing.assert_array_equal(port._w.key_data, _keys(ref))
    for g in (0, ref.num_graphs - 1):
        np.testing.assert_array_equal(port.get_graph_itime(g), ref.get_graph_itime(g))


def _equal(want, got):
    want, got = np.asarray(want), np.asarray(got)
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, want.shape, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------ against the JAX package

def test_method_surface():
    for name, required, optional in QMCISING:
        sig = inspect.signature(getattr(QmcIsing, name))
        params = [p for p in sig.parameters.values() if p.name != "self"]
        for p in params:
            if p.kind is inspect.Parameter.KEYWORD_ONLY:
                assert p.default is not inspect.Parameter.empty, (name, p.name)
        names = [p.name for p in params if p.kind is not inspect.Parameter.KEYWORD_ONLY]
        assert names == required + optional, (name, names)
        for p in params[:len(required)]:
            assert p.default is inspect.Parameter.empty, (name, p.name)
        for p in params[len(required):]:
            assert p.default is not inspect.Parameter.empty, (name, p.name)
    assert "QmcIsing" in tpmc.__all__


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_sequence_equals_jax(name):
    ref, port, beta = _pair(name)
    assert not port._w.on_kernel()
    assert port.run_qmc(beta, 5) is None and ref.run_qmc(beta, 5) is None
    _same_state(ref, port)
    ref.run_diagonal(beta, 3)
    port.run_diagonal(beta, 3)
    _same_state(ref, port)
    for _ in range(2):
        _equal(ref.run_cluster(), port.run_cluster())
    _same_state(ref, port)
    _equal(ref.run_rvb(2, 11), port.run_rvb(2, 11))
    _same_state(ref, port)
    want = ref.run_sampling(beta, 4, sampling_wait_buffer=2, sampling_freq=2)
    got = port.run_sampling(beta, 4, sampling_wait_buffer=2, sampling_freq=2)
    _equal(want[1], got[1])
    np.testing.assert_allclose(got[0], want[0], rtol=E_RTOL)
    assert got[0].dtype == np.float64
    _equal(ref.run_bond_sampling(beta, 4, sampling_wait_buffer=1, sampling_freq=2),
           port.run_bond_sampling(beta, 4, sampling_wait_buffer=1, sampling_freq=2))
    if name != "glass":
        return
    ref.set_enable_rvb(True)
    port.set_enable_rvb(True)
    ref.run_qmc(beta, 2)
    port.run_qmc(beta, 2)
    _same_state(ref, port)
    want = ref.run_quantum_monte_carlo_and_measure_spin_product_autocorrelation(beta, 8, [[0, 1], [2]],
                                                                                sampling_wait_buffer=1,
                                                                                sampling_freq=2)
    got = port.run_quantum_monte_carlo_and_measure_spin_product_autocorrelation(beta, 8, [[0, 1], [2]],
                                                                                sampling_wait_buffer=1,
                                                                                sampling_freq=2)
    assert got.shape == want.shape == (5, 8) and np.abs(got - want).max() <= 1e-4
    _same_state(ref, port)
    assert port.get_offset() == ref.get_offset()


def test_pending_states_carried_before_the_first_run():
    edges, gamma, h, beta, dtau = PROBLEMS["glass"]
    ref = jpmc.QmcIsing(edges, gamma, h, num_experiments=3, seed=4)
    ref.add_qmc()
    port = qmcising_from_reference(ref, _keys(ref), device="cpu")
    assert port._w is None and port.num_graphs == 4
    np.testing.assert_array_equal(port._init_states, np.asarray(ref._init_states))
    wr, wt = ref._ensure(beta), port._ensure(beta)
    assert wt.L == wr.L == 40
    _same_state(ref, port)
    np.testing.assert_array_equal(wt.p.dtau.numpy(), np.asarray(wr.p.dtau))
    port.add_qmc()
    ref.add_qmc()
    _same_state(ref, port)


def test_regrid_equals_jax(jax_params):
    ref, port, beta = _pair("glass", R=3, seed=5)
    ref.run_qmc(beta, 3)
    port.run_qmc(beta, 3)
    ref.run_qmc(1.3, 3)  # L_tau 40 -> 26: nearest-slice resampling, then sweeps
    port.run_qmc(1.3, 3)
    assert port._w.L == ref._w.L == 26
    _same_state(ref, port)
    ref.run_qmc(1.3, 2)
    port.run_qmc(1.3, 2)
    _same_state(ref, port)


def test_add_qmc_after_materialization_equals_jax():
    ref, port, beta = _pair("triangular", R=2, seed=6)
    ref.run_qmc(beta, 2)
    port.run_qmc(beta, 2)
    ref.add_qmc()
    port.add_qmc()
    assert port.num_graphs == 3 and port._w.p.ktau.shape == (3,)
    np.testing.assert_array_equal(port._w.p.ktau.numpy(), np.asarray(ref._w.p.ktau))
    _same_state(ref, port)
    ref.run_qmc(beta, 3)
    port.run_qmc(beta, 3)
    _same_state(ref, port)
    _equal(ref.run_cluster(), port.run_cluster())


def test_clone_independent_and_equal_jax():
    ref, port, beta = _pair("glass", R=2, seed=7)
    port.run_qmc(beta, 2)
    ref.run_qmc(beta, 2)
    other = port.clone()
    before = port._w.s.clone()
    other.run_qmc(beta, 3)
    other.add_qmc()
    assert torch.equal(port._w.s, before) and port.num_graphs == 2
    ref.run_qmc(beta, 3)
    port.run_qmc(beta, 3)
    _same_state(ref, port)
    np.testing.assert_array_equal(other._w.s[:2].numpy(), port._w.s.numpy())


@pytest.mark.parametrize("materialized", [False, True])
def test_cbor_files_cross(tmp_path, materialized):
    """A file the JAX class wrote, read by the port's with the same reseed,
    gives the same worldlines (or pending states), flags and keys as the JAX
    class reading it; and a file the port wrote, the same for both."""
    edges, gamma, h, beta, _ = PROBLEMS["triangular"]
    ref = jpmc.QmcIsing(edges, gamma, h, num_experiments=3, seed=8, do_rvb_updates=True)
    port = QmcIsing(edges, gamma, h, num_experiments=3, seed=8, do_rvb_updates=True, device="cpu")
    np.testing.assert_array_equal(port._init_states, np.asarray(ref._init_states))
    if materialized:
        ref.run_qmc(beta, 2)
        port._ensure(beta)
        port._w.s = torch.from_numpy(np.array(ref._w.s, dtype=np.int8))
    for name, writer in (("jax", ref), ("port", port)):
        path = str(tmp_path / f"{name}.cbor")
        writer.save_to_file(path)
        got = QmcIsing.read_from_file(path, reseed=11, device="cpu")
        want = jpmc.QmcIsing.read_from_file(path, reseed=11)
        assert (got.nvars, got.transverse, got.longitudinal, got.enable_rvb, got.enable_heatbath, got.num_graphs) \
            == (want.nvars, want.transverse, want.longitudinal, want.enable_rvb, want.enable_heatbath, 3)
        assert (got._w is None) == (want._w is None) == (not materialized)
        np.testing.assert_array_equal(got._w.key_data if materialized else got._keys, _keys(want))
        for g in range(3):
            np.testing.assert_array_equal(got.get_graph_itime(g), want.get_graph_itime(g))
            np.testing.assert_array_equal(got.get_graph_itime(g), ref.get_graph_itime(g))


def test_ring_mixes_kernel_and_generic_routes_equal_jax(jax_on_kernel):
    ref = jpmc.QmcIsing(RING8, 1.0, 0.0, num_experiments=3, seed=9)
    ref._ensure(1.0)
    port = qmcising_from_reference(ref, _keys(ref), device="cpu")
    assert port._w.on_kernel() and ref._w._pallas_dense == ("ring", 8, -1.0)
    ref.run_qmc(1.0, 4)
    port.run_qmc(1.0, 4)
    _same_state(ref, port)
    ref.run_diagonal(1.0, 2)
    port.run_diagonal(1.0, 2)
    _equal(ref.run_cluster(), port.run_cluster())
    _equal(ref.run_rvb(2), port.run_rvb(2))
    _same_state(ref, port)
    want = ref.run_sampling(1.0, 6, sampling_freq=2)
    got = port.run_sampling(1.0, 6, sampling_freq=2)
    _equal(want[1], got[1])
    np.testing.assert_array_equal(got[0], want[0])
    _same_state(ref, port)


@pytest.mark.parametrize("graph", ["glass", "ring, RVB"])
def test_lattice_quantum_on_a_graph_and_with_rvb_equals_jax(jax_params, graph):
    """``Lattice``'s quantum methods on a non-uniform graph, then with RVB on
    an 8-ring (both generic), through ``interop.lattice_from_reference``."""
    from pyisingmontecarlo_tpu_torch.interop import lattice_from_reference

    edges, rvb, h = (glass(16, seed=2), False, 0.5) if graph == "glass" else (RING8, True, 0.0)
    ref = jpmc.Lattice(edges, seed_gen=12)
    ref.set_transverse_field(0.9)
    ref.set_global_bias(h)
    ref.set_enable_rvb_update(rvb)
    port = lattice_from_reference(ref, device="cpu")
    want = ref.run_quantum_monte_carlo(1.5, 4, 3)
    got = port.run_quantum_monte_carlo(1.5, 4, 3)
    _equal(want[1], got[1])
    np.testing.assert_allclose(got[0], want[0], rtol=E_RTOL)
    if not rvb:
        kw = dict(sampling_wait_buffer=2, sampling_freq=2)
        want = ref.run_quantum_monte_carlo_sampling(1.5, 4, 2, **kw)
        got = port.run_quantum_monte_carlo_sampling(1.5, 4, 2, **kw)
        _equal(want[1], got[1])
        kw = dict(sampling_wait_buffer=1, sampling_freq=2, spin_measurement=(-0.5, 1.0), exponent=2)
        want = ref.run_quantum_monte_carlo_and_measure_spins(1.5, 5, 2, **kw)
        got = port.run_quantum_monte_carlo_and_measure_spins(1.5, 5, 2, **kw)
        _equal(want[0], got[0])
        want = ref.average_on_and_off_diagonal_and_consts(1.5, 4, 2, sampling_freq=2)
        got = port.average_on_and_off_diagonal_and_consts(1.5, 4, 2, sampling_freq=2)
        np.testing.assert_allclose(got, want, rtol=E_RTOL)


# ------------------------------------------------------------------ twins of tests/test_qmcising.py

def test_constructor_and_counts():
    q = QmcIsing(RING4, 1.0, num_experiments=3, seed=0, device="cpu")
    assert q.num_graphs == 3
    q.add_qmc()
    assert q.num_graphs == 4
    assert QmcIsing(RING4, 1.0, num_experiments=0, device="cpu").run_cluster().shape == (0,)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            QmcIsing(RING4, 1.0)


def test_run_qmc_returns_none_and_sampling():
    q = QmcIsing(RING4, 1.0, num_experiments=4, seed=1, device="cpu")
    assert q.run_qmc(1.0, 5) is None
    es, ss = q.run_sampling(1.0, 12, sampling_freq=3)
    assert es.shape == (4,) and ss.shape == (4, 4, 4) and ss.dtype == bool


def test_sampling_matches_exact():
    q = QmcIsing(RING4, 1.0, num_experiments=96, seed=2, device="cpu")
    es, _ = q.run_sampling(2.0, 200, sampling_wait_buffer=150)
    ex = dense_tfim_energy(RING4, 0.0, 1.0, 2.0, 4)
    se = es.std(ddof=1) / np.sqrt(len(es))
    assert abs(es.mean() - ex) < 4 * se + 0.04, (es.mean(), ex, se)


def test_sampling_matches_exact_on_a_graph_with_a_field():
    """An 8-site non-uniform +-J graph with h != 0 (the generic route)."""
    edges = [((0, 1), -1.0), ((1, 2), 1.0), ((2, 3), -1.0), ((3, 0), -1.0), ((4, 5), 1.0), ((5, 6), -1.0),
             ((6, 7), -1.0), ((7, 4), 1.0), ((0, 4), -0.5), ((2, 6), 1.0)]
    q = QmcIsing(edges, 0.8, 0.3, num_experiments=64, seed=3, device="cpu")
    es, _ = q.run_sampling(1.5, 150, sampling_wait_buffer=100)
    ex = dense_tfim_energy(edges, 0.3, 0.8, 1.5, 8)
    se = es.std(ddof=1) / np.sqrt(len(es))
    assert abs(es.mean() - ex) < 4 * se + 0.03, (es.mean(), ex, se)


def test_run_diagonal_and_cluster_and_rvb():
    q = QmcIsing(RING4, 1.0, num_experiments=5, seed=3, device="cpu")
    q.run_diagonal(1.0, 3)
    sizes = q.run_cluster()
    assert sizes.shape == (5,) and sizes.dtype == np.int64 and (sizes >= 1).all() and (sizes <= q._w.L).all()
    ratios = q.run_rvb(4)
    assert ratios.shape == (5, 4) and ((ratios >= 0) & (ratios <= 1)).all()


def test_bond_sampling_shapes_and_magnitude():
    q = QmcIsing(RING4, 1.0, num_experiments=8, seed=4, device="cpu")
    counts = q.run_bond_sampling(2.0, 20, sampling_wait_buffer=20, sampling_freq=2)
    assert counts.shape == (8, 10, 4) and (counts >= 0).all()
    assert 1.0 < counts.mean() < 6.0


def test_autocorrelation_shapes():
    q = QmcIsing(RING4, 1.0, num_experiments=4, seed=5, device="cpu")
    c = q.run_quantum_monte_carlo_and_measure_variable_autocorrelation(1.0, 30)
    assert c.shape == (4, 30)
    np.testing.assert_allclose(c[:, 0], 1.0, atol=1e-6)
    assert q.run_quantum_monte_carlo_and_measure_bond_autocorrelation(1.0, 25).shape == (4, 25)
    c3 = q.run_quantum_monte_carlo_and_measure_spin_product_autocorrelation(1.0, 20, [[0, 1], [2, 3]],
                                                                            sampling_freq=4)
    assert c3.shape == (4, 20) and (c3[:, 5:] == 0).all()
    with pytest.raises(ValueError):
        q.run_quantum_monte_carlo_and_measure_spin_product_autocorrelation(1.0, 5, [[0, 9]])


def test_get_graph_itime():
    q = QmcIsing(RING4, 1.0, num_experiments=2, seed=6, device="cpu")
    q.run_qmc(1.5, 5)
    it = q.get_graph_itime(0)
    assert it.shape == (30, 4) and it.dtype == bool
    with pytest.raises(ValueError):
        q.get_graph_itime(7)


def test_get_offset():
    q = QmcIsing(RING4, 2.0, longitudinal=0.5, num_experiments=1, seed=7, device="cpu")
    assert q.get_offset() == pytest.approx(4.0 + 4 * 0.5 + 4 * 2.0)
    assert QmcIsing(RING4, 1.0, num_experiments=0, seed=7, device="cpu").get_offset() == 0.0


def test_transverse_must_be_positive():
    with pytest.raises(ValueError):
        QmcIsing(RING4, 0.0, device="cpu")


def test_beta_regrid_preserves_state_validity():
    q = QmcIsing(RING4, 1.0, num_experiments=3, seed=8, device="cpu")
    q.run_qmc(1.0, 5)
    L1 = q._w.L
    q.run_qmc(3.0, 5)
    assert q._w.L > L1
    es, _ = q.run_sampling(3.0, 10)
    assert np.isfinite(es).all()


def test_checkpoint_roundtrip(tmp_path):
    q = QmcIsing(RING4, 1.3, longitudinal=0.2, num_experiments=3, seed=9, do_heatbath_updates=True,
                 do_rvb_updates=True, device="cpu")
    q.run_qmc(1.5, 8)
    path = str(tmp_path / "ck.cbor")
    q.save_to_file(path)
    q2 = QmcIsing.read_from_file(path, reseed=123, device="cpu")
    assert (q2.num_graphs, q2.transverse, q2.longitudinal) == (3, 1.3, 0.2)
    assert q2.enable_heatbath and q2.enable_rvb
    np.testing.assert_array_equal(q2.get_graph_itime(0), q.get_graph_itime(0))
    es, _ = q2.run_sampling(1.5, 5)
    assert np.isfinite(es).all()


def test_checkpoint_io_error():
    q = QmcIsing(RING4, 1.0, num_experiments=1, seed=10, device="cpu")
    with pytest.raises(IOError):
        q.save_to_file("/nonexistent/dir/x.cbor")
    with pytest.raises(IOError):
        QmcIsing.read_from_file("/nonexistent/dir/x.cbor", device="cpu")


def test_clone_independent():
    q = QmcIsing(RING4, 1.0, num_experiments=2, seed=11, device="cpu")
    q.run_qmc(1.0, 3)
    q2 = q.clone()
    np.testing.assert_array_equal(q.get_graph_itime(0), q2.get_graph_itime(0))
    q2.run_qmc(1.0, 5)
    assert q.num_graphs == 2
