"""The port's ``QmcRunner`` against the JAX package's, and its own checks.

A JAX ``QmcRunner`` (ZZ + X + XX on a pair, and a free variable: the
group-major route, a term-kink color and the free-variable slot) is carried
across by ``interop.qmcrunner_from_reference`` before its first run, and the
same sequence then runs on both: ``run_sampling`` with a wait buffer and a
sampling frequency, ``run_bond_sampling``, the three autocorrelations,
``get_graph_itime``, an interaction added after a run (recompile and
regrid), a beta change (nearest-slice regrid), ``add_qmc`` after
materialization, ``clone``, ``set_do_loop_updates``, and a carry across after
materialization. States, samples, bond counts and keys bit for bit
(tolerance: none); energies within 2e-6 of the largest magnitude;
autocorrelations within 1e-4 (f32 FFTs on both sides). The JAX side runs op
by op under ``jax.disable_jit()`` (its drivers take tens of seconds to
compile a call). Then the method surface against tests/test_api_surface.py's
QMCRUNNER list, the empty container, and the argument checks. The physics
checks against dense diagonalization are in test_torch_qmcrunner_dense.py."""

import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import pyisingmontecarlo_tpu as jpmc
import pyisingmontecarlo_tpu_torch as tpmc
from pyisingmontecarlo_tpu_torch.interop import qmcrunner_from_reference
from test_api_surface import QMCRUNNER
from test_torch_generic import _close, x1, xx, zz

torch.set_num_threads(1)


def _build(cls, **kw):
    q = cls(3, 3, seed=5, **kw)
    q.add_diagonal_interaction(zz(-1.0), [0, 1])
    q.add_interaction(x1(0.8), [0])
    q.add_interaction_and_offset(x1(0.8) + np.array([0.3, 0, 0, -0.1]), [1])
    q.add_interaction(xx(0.5), [0, 1])
    return q


def _kd(keys):
    return np.asarray(jax.random.key_data(keys))


@pytest.fixture(scope="module")
def sequence():
    """The same sequence of calls on the JAX runner and on its port: {step: (jax result, port result)}."""
    ref = _build(jpmc.QmcRunner)
    port = qmcrunner_from_reference(ref, _kd(ref._keys), "cpu")
    out = {}

    def both(name, fn):
        with jax.disable_jit():
            a = fn(ref)
        out[name] = (a, fn(port))

    both("sampling", lambda q: q.run_sampling(1.0, 4, sampling_wait_buffer=2, sampling_freq=2))
    out["gm"] = (ref._w.use_gm, port._w.use_gm)
    both("bonds", lambda q: q.run_bond_sampling(1.0, 2, sampling_freq=1))
    both("variable autocorrelation", lambda q: q.run_quantum_monte_carlo_and_measure_variable_autocorrelation(1.0, 4))
    both("spin product autocorrelation",
         lambda q: q.run_quantum_monte_carlo_and_measure_spin_product_autocorrelation(1.0, 3, [[0, 1], [2]],
                                                                                     sampling_freq=1))
    both("bond autocorrelation", lambda q: q.run_quantum_monte_carlo_and_measure_bond_autocorrelation(1.0, 3))
    both("itime", lambda q: q.get_graph_itime(1))
    for q in (ref, port):
        q.add_diagonal_interaction(zz(0.5), [1, 2])  # after a run: recompile and regrid
    both("regrid after add", lambda q: np.asarray(q._w.s))
    both("sampling after add", lambda q: q.run_sampling(1.0, 2))
    both("beta change", lambda q: q.run_sampling(1.5, 2, sampling_freq=1))
    carried = qmcrunner_from_reference(ref, _kd(ref._w.keys), "cpu")
    out["carried"] = (np.asarray(ref._w.s), carried._w.s.numpy(), _kd(ref._w.keys), carried._w.key_data)
    for q in (ref, port):
        q.add_qmc()
        q.set_do_loop_updates(True)
    both("add_qmc, do_loop", lambda q: q.run_sampling(1.5, 2))
    clone = port.clone()
    clone_run = clone.run_sampling(1.5, 1)
    both("after the clone ran", lambda q: q.run_sampling(1.5, 1))
    out["clone"] = (clone_run, out["after the clone ran"][1])
    out["keys"] = (_kd(ref._w.keys), port._w.key_data)
    return out


def _same(a, b, name):
    if isinstance(a, tuple):
        for x, y in zip(a, b):
            _same(x, y, name)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype.kind == b.dtype.kind, (name, a.shape, b.shape, a.dtype, b.dtype)
    if a.dtype.kind == "f":
        _close(b, a)
    else:
        np.testing.assert_array_equal(b, a, err_msg=name)


@pytest.mark.parametrize("step", ["sampling", "bonds", "itime", "regrid after add", "sampling after add",
                                  "beta change", "add_qmc, do_loop", "after the clone ran", "keys"])
def test_sequence_equals_jax(sequence, step):
    a, b = sequence[step]
    _same(a, b, step)
    if step == "sampling":
        assert sequence["gm"] == (True, True)
        assert b[1].shape == (3, 2, 3) and b[1].dtype == np.bool_


@pytest.mark.parametrize("step", ["variable autocorrelation", "spin product autocorrelation", "bond autocorrelation"])
def test_autocorrelations_equal_jax(sequence, step):
    a, b = sequence[step]
    assert b.shape == a.shape and b.dtype == np.float64
    np.testing.assert_allclose(b, a, atol=1e-4)


def test_carry_after_materialization(sequence):
    s_ref, s_port, k_ref, k_port = sequence["carried"]
    np.testing.assert_array_equal(s_port, s_ref)
    np.testing.assert_array_equal(k_port, k_ref)


def test_clone_is_independent(sequence):
    """The clone's run from the shared state equals the original's next run, and left it untouched."""
    _same(sequence["clone"][0], sequence["clone"][1], "clone")


def test_method_surface():
    for name, required, optional in QMCRUNNER:
        fn = getattr(tpmc.QmcRunner, name)
        params = [p for p in inspect.signature(fn).parameters.values()
                  if p.name != "self" and p.kind is not inspect.Parameter.KEYWORD_ONLY]
        assert [p.name for p in params] == required + optional, name
        for p in params[len(required):]:
            assert p.default is not inspect.Parameter.empty, (name, p.name)
        for p in inspect.signature(fn).parameters.values():
            if p.kind is inspect.Parameter.KEYWORD_ONLY:
                assert p.default is not inspect.Parameter.empty
    assert tpmc.QmcRunner is tpmc.qmcrunner.QmcRunner and "QmcRunner" in tpmc.__all__


def test_empty_container_equals_jax():
    out = []
    for cls, kw in ((jpmc.QmcRunner, {}), (tpmc.QmcRunner, dict(device="cpu"))):
        q = cls(3, 0, seed=5, **kw)
        q.add_diagonal_interaction(zz(-1.0), [0, 1])
        q.add_interaction(x1(0.7), [2])
        es, ss = q.run_sampling(1.0, 20, sampling_freq=2)
        out.append((es, ss, q.run_bond_sampling(1.0, 20),
                    q.run_quantum_monte_carlo_and_measure_variable_autocorrelation(1.0, 16),
                    q.run_quantum_monte_carlo_and_measure_spin_product_autocorrelation(1.0, 16, [[0, 1]]),
                    q.run_quantum_monte_carlo_and_measure_bond_autocorrelation(1.0, 16), q.get_offset(), q.num_graphs))
    for a, b in zip(*out):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype
    assert out[1][2].shape == (0, 20, 2) and out[1][1].shape == (0, 10, 3)


def test_offsets_and_argument_checks():
    q = tpmc.QmcRunner(2, 1, seed=3, device="cpu")
    q.add_diagonal_interaction_and_offset(np.array([2.0, -1.0]), [0])
    assert q.get_offset() == pytest.approx(2.0)
    q.add_interaction_and_offset(np.array([1.0, -0.5, -0.5, 0.25]), [1])
    assert q.get_offset() == pytest.approx(3.0)
    with pytest.raises(ValueError):
        q.add_interaction(np.ones(3), [0])
    with pytest.raises(ValueError):
        q.add_interaction(np.zeros(4), [5])
    with pytest.raises(ValueError):
        q.add_interaction(np.zeros(16), [0, 0])
    with pytest.raises(ValueError):
        q.add_interaction(np.array([0, 0, 0, 1, 0, 0, 1, 0, 0, 1, 0, 0, 1, 0, 0, 0.0]), [0, 1])
    with pytest.raises(ValueError):
        tpmc.QmcRunner(0, 1, device="cpu")
    with pytest.raises(ValueError):
        q.get_graph_itime(4)
    with pytest.raises(ValueError):
        q.run_quantum_monte_carlo_and_measure_spin_product_autocorrelation(1.0, 5, [[7]])
    assert q.get_graph_itime(0).shape[1] == 2  # materializes at beta 1


def test_device_default_is_cuda():
    assert inspect.signature(tpmc.QmcRunner).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tpmc.QmcRunner(2, 1)
