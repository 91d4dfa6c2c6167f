"""The port's ``QmcRunner`` on the CPU against dense diagonalization.

The twins of tests/test_qmcrunner.py's physics checks, with their bounds
(<E> within 4 se + 0.05 or 4 se + 0.1 of ``helpers.dense_terms_energy``,
imported unchanged): the TFIM pair, the TFIM 3-chain on the classic route
(forced with ``PMC_GENERIC_GM=0``), XX bonds on a 3-ring, ZZZ triples on a
4-ring, an off-diagonal XXX triple, the diagonal-only classical limit against
exact enumeration, and a free variable sampled uniformly. 96 replicas each,
as there. XX bonds mix slowly (term kinks), so that case keeps the JAX
test's 400 + 400 sweeps; the others are cut to a 100-sweep wait and 200
sampled sweeps (the sweeps equal the JAX engine's bit for bit:
test_torch_generic.py, test_torch_generic_gm.py)."""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from helpers import dense_terms_energy, dense_tfim_energy
from pyisingmontecarlo_tpu_torch import QmcRunner
from test_torch_generic import x1, xx, xxx, zz, zzz

torch.set_num_threads(1)

WAIT, T, R = 100, 200, 96


def _near(es, exact, slack):
    se = es.std(ddof=1) / np.sqrt(len(es))
    assert abs(es.mean() - exact) < 4 * se + slack, (es.mean(), exact, se)


def test_tfim_pair_matches_dense():
    q = QmcRunner(2, R, seed=0, device="cpu")
    q.add_diagonal_interaction(zz(-1.0), [0, 1])
    for i in range(2):
        q.add_interaction(x1(0.8), [i])
    es, ss = q.run_sampling(1.5, T, sampling_wait_buffer=WAIT)
    assert ss.shape == (R, T, 2)
    _near(es, dense_tfim_energy([((0, 1), -1.0)], 0.0, 0.8, 1.5, 2), 0.05)


def test_tfim_chain_classic_route_matches_dense(monkeypatch):
    monkeypatch.setenv("PMC_GENERIC_GM", "0")
    edges = [((0, 1), -1.0), ((1, 2), -1.0)]
    q = QmcRunner(3, R, seed=1, device="cpu")
    for (a, b), j in edges:
        q.add_diagonal_interaction(zz(j), [a, b])
    for i in range(3):
        q.add_interaction(x1(1.0), [i])
    es, _ = q.run_sampling(1.0, T, sampling_wait_buffer=WAIT)
    assert not q._w.use_gm
    _near(es, dense_tfim_energy(edges, 0.0, 1.0, 1.0, 3), 0.05)


def test_offdiag_2local_xx_matches_dense():
    n, beta, gamma, jx = 3, 1.0, 0.7, 0.5
    q = QmcRunner(n, R, seed=6, device="cpu")
    terms = []
    for i in range(n):
        a, b = i, (i + 1) % n
        q.add_diagonal_interaction(zz(-1.0), [a, b])
        q.add_interaction(x1(gamma), [i])
        q.add_interaction(xx(jx), [a, b])
        terms += [(np.diag(zz(-1.0)), (a, b)), (x1(gamma).reshape(2, 2), (i,)), (xx(jx).reshape(4, 4), (a, b))]
    es, _ = q.run_sampling(beta, 400, sampling_wait_buffer=400)
    assert q._w.use_gm
    _near(es, dense_terms_energy(n, terms, beta), 0.1)


def test_3local_zzz_matches_dense():
    n, beta, gamma, k3 = 4, 1.0, 0.8, 0.4
    q = QmcRunner(n, R, seed=7, device="cpu")
    terms = []
    for i in range(n):
        a, b, c = i, (i + 1) % n, (i + 2) % n
        q.add_diagonal_interaction(zz(-1.0), [a, b])
        q.add_interaction(x1(gamma), [i])
        q.add_diagonal_interaction(zzz(k3), [a, b, c])
        terms += [(np.diag(zz(-1.0)), (a, b)), (x1(gamma).reshape(2, 2), (i,)), (np.diag(zzz(k3)), (a, b, c))]
    es, _ = q.run_sampling(beta, T, sampling_wait_buffer=WAIT)
    _near(es, dense_terms_energy(n, terms, beta), 0.1)


def test_offdiag_3local_matches_dense():
    n, beta, gamma = 3, 1.2, 0.6
    q = QmcRunner(n, R, seed=8, device="cpu")
    q.add_interaction(xxx(0.5), [0, 1, 2])
    terms = [(xxx(0.5).reshape(8, 8), (0, 1, 2))]
    for i in range(n):
        q.add_interaction(x1(gamma), [i])
        terms.append((x1(gamma).reshape(2, 2), (i,)))
    es, _ = q.run_sampling(beta, T, sampling_wait_buffer=WAIT)
    _near(es, dense_terms_energy(n, terms, beta), 0.1)


def test_diagonal_only_classical_limit_and_free_variable():
    """Purely diagonal terms: <E> of the classical Boltzmann average; a
    variable in no term samples uniformly."""
    beta, j01, j12, h2 = 0.9, 1.0, -0.7, 0.5
    q = QmcRunner(4, R, seed=2, device="cpu")
    q.add_diagonal_interaction(zz(j01), [0, 1])
    q.add_diagonal_interaction(zz(j12), [1, 2])
    q.add_diagonal_interaction(np.array([-h2, h2]), [2])
    es, ss = q.run_sampling(beta, T, sampling_wait_buffer=WAIT)
    Z = E = 0.0
    for s in itertools.product([-1, 1], repeat=3):
        e = j01 * s[0] * s[1] + j12 * s[1] * s[2] + h2 * s[2]
        Z += np.exp(-beta * e)
        E += np.exp(-beta * e) * e
    _near(es, E / Z, 0.05)
    assert abs(np.where(ss[:, :, 3], 1.0, -1.0).mean()) < 0.12
