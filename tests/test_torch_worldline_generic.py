"""The port's generic colored worldline engine (``engines/worldline.py``)
against the JAX package's, with the same graph, state, keys and f32
parameters (the JAX ``WlParams`` carried across):

- states, keys, cluster sizes, RVB success ratios, bond-operator counts,
  slice-0 samples and measured moments bit for bit (tolerance: none) for every
  move family and run function: full sweeps with and without RVB, sampling, bond
  sampling, moments, operator counts, diagonal sweeps, single clusters, RVB
  sweeps at three attempt budgets, and any piece size of the key chain (the
  run functions whose JAX versions unroll their sweeps at compile time run on one
  graph each, to keep the compile time down);
- the energy estimators within 2e-6 relative: both sides sum f32 terms over
  the lattice in another order (XLA sums ``n * L`` tanh/coth terms, the port
  counts aligned bonds exactly), and the per-sweep sums then go through the
  same compensated pair;
- ``make_params``: ``dtau`` bit for bit, ``ktau`` within the error that a few
  ulps of f32 ``tanh`` (the libraries' ``tanh`` differ by up to 4 ulp and
  ``log`` by 1) carry through ``-1/2 log tanh(a)``.

Inputs are made from numpy seeds on a 4-regular +-J glass (n = 32) and a
periodic triangular patch (4 x 4), at L_tau = 40 with dtau = 0.05 and a field
of 0.3 (not dyadic) and at L_tau = 24 with dtau = 1/16."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from pyisingmontecarlo_tpu import models as jmodels
from pyisingmontecarlo_tpu.engines import classical as jce
from pyisingmontecarlo_tpu.engines import worldline as jwl
from pyisingmontecarlo_tpu.graph import compile_graph as jcompile
from pyisingmontecarlo_tpu.rng import keys_from_seeds, split_keys
from pyisingmontecarlo_tpu.utils.accum import kfinal as jkfinal
from pyisingmontecarlo_tpu_torch import rng
from pyisingmontecarlo_tpu_torch.engines import classical as tce
from pyisingmontecarlo_tpu_torch.engines import worldline as twl
from pyisingmontecarlo_tpu_torch.graph import compile_graph as tcompile
from pyisingmontecarlo_tpu_torch.utils.accum import kfinal as tkfinal

torch.set_num_threads(1)

R = 6
E_RTOL = 2e-6


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


# name -> (edges, beta, gamma, h, L)
GRAPHS = {
    "glass": (glass(32), 2.0, 1.0, 0.3, 40),
    "triangular": (jmodels.triangular_edges(4, j=1.0), 1.5, 0.7, 0.25, 24),
}


class Case:
    """One graph on both sides: graph arrays, f32 parameters, a random
    worldline state and keys from numpy seeds."""

    def __init__(self, name):
        edges, beta, gamma, h, L = GRAPHS[name]
        self.name, self.L = name, L
        self.cgj, self.cgt = jcompile(edges), tcompile(edges)
        n = self.cgj.nvars
        self.gaj, self.gat = jce.device_graph(self.cgj), tce.device_graph(self.cgt)
        self.pj = jwl.make_params(np.full(R, beta), gamma, h, L)
        self.pt = twl.params_from_arrays([np.asarray(x) for x in self.pj], "cpu")
        r = np.random.default_rng(len(name))
        s = r.integers(0, 2, (R, n, L)).astype(np.int8) * 2 - 1
        s[:, : n // 2] = s[:, : n // 2, :1]  # half the lines straight, half random
        self.s = s
        seeds = r.integers(0, 2**64, R, dtype=np.uint64)
        self.keys = keys_from_seeds(seeds)
        self.kd = rng.key_data_from_seeds(seeds)

    def jax_args(self):
        return self.gaj, self.pj, jnp.asarray(self.s), self.keys

    def port_args(self):
        return self.gat, self.pt, torch.from_numpy(self.s.copy()), rng.key_tensor(self.kd, "cpu")

    def same(self, want, got):
        """Bit-equal states and keys of a JAX and a port run function's result."""
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(rng.key_data_of(got[1]), np.asarray(jax.random.key_data(want[1])))


@functools.lru_cache(maxsize=None)
def get_case(name):
    return Case(name)


@pytest.fixture(params=sorted(GRAPHS))
def case(request):
    return get_case(request.param)


def _energy_close(want_pair_or_array, got_pair_or_array):
    w = jkfinal(want_pair_or_array) if isinstance(want_pair_or_array, tuple) else np.asarray(want_pair_or_array)
    g = tkfinal(got_pair_or_array) if isinstance(got_pair_or_array, tuple) else got_pair_or_array.numpy()
    np.testing.assert_allclose(g, w, rtol=E_RTOL, atol=0)


@pytest.mark.parametrize("rvb", [False, True])
def test_run_sweeps_equal_jax(case, rvb):
    want = jwl.run_sweeps(*case.jax_args(), 7, False, True, rvb)
    got = twl.run_sweeps(*case.port_args(), 7, True, rvb)
    case.same(want, got)
    _energy_close(want[2], got[2])


def test_run_sweeps_any_chain_piece_equal_jax(case, monkeypatch):
    """The key chain walked two sweeps at a time gives the same trajectory."""
    want = jwl.run_sweeps(*case.jax_args(), 5, False, True, False)
    monkeypatch.setenv("PMC_STEPS_PER_DISPATCH", "2")
    got = twl.run_sweeps(*case.port_args(), 5, True, False)
    case.same(want, got)


@pytest.mark.parametrize("name", ["glass"])
def test_run_sweeps_sample_equal_jax(name):
    case = get_case(name)
    want = jwl.run_sweeps_sample(*case.jax_args(), 5, 2, False, True, False)
    got = twl.run_sweeps_sample(*case.port_args(), 5, 2, True, False)
    case.same(want, got)
    assert got[3].shape == (R, 2, case.cgt.nvars) and got[3].dtype == torch.int8
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    _energy_close(want[2], got[2])


@pytest.mark.parametrize("name", ["triangular"])
def test_run_sweeps_bond_sample_equal_jax(name):
    case = get_case(name)
    want = jwl.run_sweeps_bond_sample(*case.jax_args(), 7, 2, False, True, False)
    got = twl.run_sweeps_bond_sample(*case.port_args(), 7, 2, True, False)
    case.same(want, got)
    assert got[3].shape == (R, 3, case.cgt.nedges)
    np.testing.assert_array_equal(got[3].numpy().view(np.int32), np.asarray(want[3]).view(np.int32))


@pytest.mark.parametrize("name,exponent,freq", [("glass", 1, 1), ("triangular", 2, 3)])
def test_run_sweeps_measure_equal_jax(name, exponent, freq):
    case = get_case(name)
    want = jwl.run_sweeps_measure(*case.jax_args(), 8, jnp.int32(freq), jnp.float32(-0.5), jnp.float32(1.25),
                                  exponent, False, True, False)
    got = twl.run_sweeps_measure(*case.port_args(), 8, freq, -0.5, 1.25, exponent)
    case.same(want, got)
    np.testing.assert_array_equal(tkfinal(got[3]), jkfinal(want[3]))
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))


@pytest.mark.parametrize("name", ["glass"])
def test_run_sweeps_opcounts_equal_jax(name):
    case = get_case(name)
    want = jwl.run_sweeps_opcounts(*case.jax_args(), 5, 2, False, True, False)
    got = twl.run_sweeps_opcounts(*case.port_args(), 5, 2, True, False)
    case.same(want, got)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=E_RTOL)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))


def test_run_diagonal_sweeps_equal_jax(case):
    want = jwl.run_diagonal_sweeps(*case.jax_args(), 6, False)
    got = twl.run_diagonal_sweeps(*case.port_args(), 6)
    case.same(want, got)


def test_run_single_cluster_equal_jax(case):
    """Eight successive single-cluster steps: states, keys and sizes."""
    gaj, pj, sj, kj = case.jax_args()
    gat, pt, st, kt = case.port_args()
    for _ in range(8):
        sj, kj, zj = jwl.run_single_cluster(gaj, pj, sj, kj)
        st, kt, zt = twl.run_single_cluster(gat, pt, st, kt)
        case.same((sj, kj), (st, kt))
        np.testing.assert_array_equal(zt.numpy(), np.asarray(zj))
        assert ((zt >= 1) & (zt <= case.L)).all()


@pytest.mark.parametrize("name,budget", [("glass", "nedges"), ("triangular", "nedges"), ("glass", 7),
                                         ("glass", "nedges + 3")])
def test_run_rvb_sweeps_equal_jax(name, budget):
    case = get_case(name)
    E = case.cgt.nedges
    ups = {"nedges": E, 7: 7, "nedges + 3": E + 3}[budget]
    want = jwl.run_rvb_sweeps(*case.jax_args(), 4, ups, False)
    got = twl.run_rvb_sweeps(*case.port_args(), 4, ups)
    case.same(want, got)
    assert got[2].shape == (R, 4) and got[2].dtype == torch.float32
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert ((got[2] >= 0) & (got[2] <= 1)).all()


def test_estimators_equal_jax(case):
    """Under ``jax.jit``, as the JAX run functions call them (eager JAX rounds the
    bond counts' mean on its own; compiled, XLA fuses it, see bond_op_counts)."""
    gaj, pj, sj, _ = case.jax_args()
    gat, pt, st, _ = case.port_args()
    np.testing.assert_array_equal(twl.kink_count(st).numpy(), np.asarray(jax.jit(jwl.kink_count)(sj)))
    np.testing.assert_array_equal(twl.bond_op_counts(gat, pt, st).numpy(),
                                  np.asarray(jax.jit(jwl.bond_op_counts)(gaj, pj, sj)))
    for name in ("diagonal_energy", "total_energy", "log_weight"):
        np.testing.assert_allclose(getattr(twl, name)(gat, pt, st).numpy(),
                                   np.asarray(jax.jit(getattr(jwl, name))(gaj, pj, sj)), rtol=E_RTOL, err_msg=name)
    np.testing.assert_allclose(twl.offdiagonal_energy(pt, st).numpy(),
                               np.asarray(jax.jit(jwl.offdiagonal_energy)(pj, sj)), rtol=E_RTOL)


def test_ring_cluster_ids_equal_jax():
    r = np.random.default_rng(3)
    for L, p in ((4, 0.5), (24, 0.8), (40, 0.97), (40, 1.0), (7, 0.0)):
        act = r.random((50, L)) < p
        np.testing.assert_array_equal(twl._ring_cluster_ids(torch.from_numpy(act)).numpy(),
                                      np.asarray(jwl._ring_cluster_ids(jnp.asarray(act))))


def test_key_chain_is_one_split_per_phase(case):
    """The generic sweep's slots: 2C site, C cluster and (RVB) Ec edge phases,
    each one split of the replica's key."""
    C, Ec = len(case.gat.c_sites), len(case.gat.e_a)
    assert twl.sweep_slots(case.gat, True, False) == 3 * C
    assert twl.sweep_slots(case.gat, True, True) == 3 * C + Ec
    keys = case.keys
    for _ in range(twl.sweep_slots(case.gat, True, True)):
        keys, _ = split_keys(keys)
    got = twl.run_sweeps(*case.port_args(), 1, True, True)[1]
    np.testing.assert_array_equal(rng.key_data_of(got), np.asarray(jax.random.key_data(keys)))


def test_make_params_within_tanh_conditioning():
    """dtau bit for bit; ktau within the error of 4 ulp of f32 tanh(a)
    carried through -1/2 log, plus 2 ulp of ktau itself."""
    betas = np.linspace(0.1, 8.0, 80)
    for gamma in (0.3, 0.7, 1.0, 2.0):
        for L in (8, 20, 40, 100):
            want = jwl.make_params(betas, gamma, 0.25, L)
            got = twl.make_params(betas, gamma, 0.25, L)
            for name in ("dtau", "gamma", "h", "beta"):
                np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))
            a = (betas.astype(np.float32) / np.float32(L) * np.float32(gamma)).astype(np.float64)
            th = np.tanh(a).astype(np.float32)
            tol = 4 * np.spacing(th).astype(np.float64) / (2 * np.tanh(a)) + 2 * np.spacing(
                np.abs(np.asarray(want.ktau))).astype(np.float64)
            err = np.abs(got.ktau.numpy().astype(np.float64) - np.asarray(want.ktau, np.float64))
            assert (err <= tol).all(), (gamma, L, float((err / tol).max()))
