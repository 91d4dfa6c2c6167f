"""The port's ``LatticeTempering`` on its generic route (ladders off the
ladder kernel's gate, and ladders with the RVB move) against the JAX
package's generic path, through ``interop.tempering_from_reference``: the
same per-phase key chain, swap keys and initial worldlines, so states,
samples, ``get_graph_itime`` and total swaps are equal (tolerance: none).
The per-replica f32 parameters are the JAX package's (the ``jax_params``
fixture; ``make_params`` is held on its own in
tests/test_torch_worldline_generic.py). Energies: both sides accumulate the
f32 estimator per sweep in a compensated pair, with the lattice sums in
another order, so they agree within 2e-6 relative; autocorrelations are f32
FFTs on both sides, within 1e-4. Also the route choice, the batched graph
arrays (per-replica couplings) against the JAX package's, checkpoints and
clones on the generic route, and per-rung energies of an off-gate ladder
against dense diagonalization."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import pyisingmontecarlo_tpu as jpmc
from helpers import dense_tfim_energy
from pyisingmontecarlo_tpu import tempering as jtemp
from pyisingmontecarlo_tpu.engines import worldline as jwl
from pyisingmontecarlo_tpu.graph import compile_graph_arrays as jcga
from pyisingmontecarlo_tpu_torch import LatticeTempering
from pyisingmontecarlo_tpu_torch import tempering as ttemp
from pyisingmontecarlo_tpu_torch.engines import worldline as twl
from pyisingmontecarlo_tpu_torch.graph import compile_graph_arrays as tcga
from pyisingmontecarlo_tpu_torch.interop import tempering_from_reference

torch.set_num_threads(1)

E_RTOL = 2e-6
RING8 = [((i, (i + 1) % 8), -1.0) for i in range(8)]
# a 10-site +-J graph (not a ring or torus): a ring with three chords
GLASS10 = [((i, (i + 1) % 10), (-1.0) ** (i // 3)) for i in range(10)] + [((0, 5), 1.0), ((2, 7), -1.0),
                                                                             ((3, 8), 0.5)]
LADDERS = {  # edges, betas, gammas, hs, rvb flags, seed, overrides
    "glass off the gate": (GLASS10, [0.8, 0.9, 1.0], [1.0, 0.9, 1.0], [0.25, 0.0, 0.25], [False] * 3, 3,
                           {1: GLASS10[:10] + [((0, 5), 0.5), ((4, 9), 0.5)]}),
    "ring with RVB": (RING8, [0.8, 1.0, 1.2, 1.4], [1.0] * 4, [0.2] * 4, [True, False, True, False], 4, None),
}


@pytest.fixture
def jax_params(monkeypatch):
    """The port's ladders built with the JAX package's f32 ``make_params``."""
    def carried(betas, gammas, hs, L, device="cpu"):
        return twl.params_from_arrays([np.asarray(x) for x in jwl.make_params(betas, gammas, hs, L)], device)

    monkeypatch.setattr(ttemp, "make_params", carried)


def _pair(name):
    edges, betas, gammas, hs, rvb, seed, overrides = LADDERS[name]
    ref = jpmc.LatticeTempering(edges, seed=seed)
    for r, (b, g, h, v) in enumerate(zip(betas, gammas, hs, rvb)):
        ref.add_graph(g, h, b, edges=None if overrides is None else overrides.get(r), enable_rvb_update=v)
    return ref, tempering_from_reference(ref, device="cpu")


def _same_ladder(ref, port):
    for g in range(ref.get_num_graphs()):
        np.testing.assert_array_equal(port.get_graph_itime(g), ref.get_graph_itime(g))
    assert port.get_total_swaps() == ref.get_total_swaps()
    np.testing.assert_array_equal(port._materialize()["key_data"],
                                  np.asarray(jax.random.key_data(ref._materialize()["keys"])))


@pytest.mark.parametrize("name", list(LADDERS))
def test_runs_equal_jax(jax_params, name):
    """Plain stepping, then sampling with swaps every sweep, then with swaps
    and samples every second sweep and a remainder sweep."""
    ref, port = _pair(name)
    port.qmc_timesteps(3)
    ref.qmc_timesteps(3)
    assert "ga" in port._materialize() and "planes" not in port._materialize()
    _same_ladder(ref, port)
    for T, swap_freq, sfreq in ((5, 1, None), (5, 2, 2)):
        want = ref.qmc_timesteps_sample(T, swap_freq, sfreq)
        got = port.qmc_timesteps_sample(T, swap_freq, sfreq)
        assert got[0].shape == want[0].shape == (len(LADDERS[name][1]), T // (sfreq or 1), port.nvars)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[0].dtype == np.bool_ and got[1].dtype == np.float64
        np.testing.assert_allclose(got[1], want[1], rtol=E_RTOL)
        _same_ladder(ref, port)
    assert port.get_total_swaps() > 0


def test_autocorrelation_equal_jax(jax_params):
    ref, port = _pair("glass off the gate")
    kw = dict(sampling_wait_buffer=2, replica_swap_freq=2, sampling_freq=2)
    want = ref.run_quantum_monte_carlo_and_measure_bond_autocorrelation(8, **kw)
    got = port.run_quantum_monte_carlo_and_measure_bond_autocorrelation(8, **kw)
    assert got.shape == (3, 8) and got.dtype == np.float64
    np.testing.assert_allclose(got, want, atol=1e-4)
    _same_ladder(ref, port)


def test_batched_graph_arrays_equal_jax():
    edges, *_ = LADDERS["glass off the gate"]
    ea = np.array([a for (a, _), _ in edges], np.int32)
    eb = np.array([b for (_, b), _ in edges], np.int32)
    jv = np.random.default_rng(2).choice([-1.0, 0.5, 0.0, 2.0], (3, len(edges)))
    want = jtemp.batched_graph_arrays(jcga(10, ea, eb, np.ones(len(ea))), jv)
    got = ttemp.batched_graph_arrays(tcga(10, ea, eb, np.ones(len(ea))), jv)
    for field in want._fields:  # the port also carries the ELL slots' edge ids (slot_eid), which JAX leaves None
        w, g = getattr(want, field), getattr(got, field)
        if w is None:
            continue
        for wi, gi in (zip(w, g) if isinstance(w, tuple) else [(w, g)]):
            np.testing.assert_array_equal(gi.numpy(), np.asarray(wi), err_msg=field)


def test_route_choice():
    """The ladder kernel takes a ring ladder without RVB; RVB on any replica,
    or a union graph that is not a ring or torus, takes the generic route."""
    for edges, rvb, generic in ((RING8, False, False), (RING8, True, True), (GLASS10, False, True)):
        lt = LatticeTempering(edges, seed=1, device="cpu")
        lt.add_graph(1.0, 0.0, 1.0)
        lt.add_graph(1.0, 0.0, 1.5, enable_rvb_update=rvb)
        m = lt._materialize()
        assert ("ga" in m) == generic and ("planes" in m) == (not generic)
        states, es = lt.qmc_timesteps_sample(4)
        assert states.shape == (2, 4, lt.nvars) and np.isfinite(es).all()


def test_checkpoint_and_clone_on_the_generic_route(tmp_path):
    edges, betas, gammas, hs, rvb, seed, overrides = LADDERS["ring with RVB"]
    lt = LatticeTempering(edges, seed=seed, device="cpu")
    for b, g, h, v in zip(betas, gammas, hs, rvb):
        lt.add_graph(g, h, b, enable_rvb_update=v)
    lt.qmc_timesteps_sample(4)
    other = lt.clone()
    before = lt._materialize()["s"].clone()
    other.qmc_timesteps_sample(3)
    assert torch.equal(lt._materialize()["s"], before)
    path = str(tmp_path / "pt.cbor")
    lt.save_to_file(path)
    back = LatticeTempering.read_from_file(path, reseed=5, device="cpu")
    assert [g["rvb"] for g in back.graphs] == rvb and back.get_total_swaps() == lt.get_total_swaps()
    for g in range(4):
        np.testing.assert_array_equal(back.get_graph_itime(g), lt.get_graph_itime(g))
    ref = jpmc.LatticeTempering.read_from_file(path, reseed=5)
    np.testing.assert_array_equal(np.asarray(ref._materialize()["s"]), back._materialize()["s"].numpy())


def test_per_rung_energy_off_the_gate_matches_dense_diagonalization():
    """A 5-site chain ladder (not a ring) with a field, 3 rungs x 16 copies,
    swaps every sweep: each rung's <E> within 5 se + 0.06 of dense
    diagonalization (the bound of the JAX package's tests/test_tempering.py)."""
    chain = [((i, i + 1), -1.0) for i in range(4)]
    betas = [0.8, 1.2, 1.6]
    lt = LatticeTempering(chain, seed=6, device="cpu")
    for _ in range(16):
        for b in betas:
            lt.add_graph(1.0, 0.3, b)
    lt.qmc_timesteps(80)
    _, es = lt.qmc_timesteps_sample(120)
    assert lt.get_total_swaps() > 0
    for k, b in enumerate(betas):
        e = es[k::3]
        ex = dense_tfim_energy(chain, 0.3, 1.0, b, 5)
        se = e.std(ddof=1) / np.sqrt(len(e))
        assert abs(e.mean() - ex) < 5 * se + 0.06, (b, e.mean(), ex, se)
