"""The port's compensated f32 accumulation (``utils/accum.py``) against the JAX
package's: the same f32 addends give the same ``(hi, lo)`` pair bit for bit
(tolerance: none), over a loop as the sweep functions run it, batched and
scalar; and the twins of tests/test_accum.py (the collapse matches an f64
sum to 1e-9 relative, where a naive f32 sum does not)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp
from jax import lax

from pyisingmontecarlo_tpu.utils import accum as jacc
from pyisingmontecarlo_tpu_torch.utils import accum as tacc

torch.set_num_threads(1)


def _addends(n, shape=(), scale=2.0e6, seed=0):
    rng = np.random.default_rng(seed)
    return (-scale + rng.normal(0.0, abs(scale) * 1e-3, size=(n,) + shape)).astype(np.float32)


def _jax_pair(x):
    def body(acc, v):
        return jacc.kadd(acc, v), None

    acc, _ = lax.scan(body, jacc.kzero(x.shape[1:]), jnp.asarray(x))
    return [np.asarray(a) for a in acc]


def _torch_pair(x):
    acc = tacc.kzero(x.shape[1:])
    for v in torch.from_numpy(x):
        acc = tacc.kadd(acc, v)
    return [a.numpy() for a in acc]


@pytest.mark.parametrize("shape,scale", [((), 2.0e6), ((8,), 2.0e6), ((5,), 3.7), ((3,), -1.0e-3)])
def test_pair_equals_jax_bit_for_bit(shape, scale):
    x = _addends(2048, shape, scale, seed=len(shape) + 1)
    want, got = _jax_pair(x), _torch_pair(x)
    for w, g in zip(want, got):
        assert g.dtype == np.float32 and g.shape == shape
        np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32))
    np.testing.assert_array_equal(tacc.kfinal([torch.from_numpy(a) for a in got]), jacc.kfinal(want))


def test_kfinal_matches_f64_within_1e9():
    x = _addends(16384)
    exact = np.sum(x.astype(np.float64))
    got = float(tacc.kfinal([torch.from_numpy(a) for a in _torch_pair(x)]))
    assert abs(got - exact) / abs(exact) < 1e-9
    naive = np.float32(0.0)
    for v in x:
        naive += v
    assert abs(float(naive) - exact) / abs(exact) > 1e-7


def test_kadd_with_zero_is_identity_and_kzero_device():
    acc = tacc.kzero(4)
    assert all(a.dtype == torch.float32 and a.shape == (4,) and a.device.type == "cpu" for a in acc)
    x = torch.tensor([1.5, -2.25, 1e7, 3.0e-8])
    acc = tacc.kadd(acc, x)
    again = tacc.kadd(acc, torch.zeros(4))
    for a, b in zip(acc, again):
        assert torch.equal(a, b)
    assert tacc.kfinal(again).dtype == np.float64
