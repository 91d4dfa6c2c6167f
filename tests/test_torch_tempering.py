"""The torch port's ``LatticeTempering`` against the JAX package's, with the
JAX side forced onto its ladder kernel (``PMC_FORCE_LADDER=1``, Pallas in
interpret mode). The ladder and the seed stream are carried across by
``interop.tempering_from_reference``; the per-sweep seeds, the swap keys and
the initial worldlines come from the same threefry keys, so states, samples,
``get_graph_itime`` and total swaps must be equal (tolerance: none). Energies:
the JAX side sums an f32 estimator per sweep (compensated), the port forms it
once in f64 from exact integer features, so they agree within 1e-5 relative
(the largest difference seen here is 3.4e-7). Autocorrelations are f32 FFTs
on both sides and agree within 1e-4. Also checkpoints (the port's own, the
JAX package's files, regridding), ``clone``, the errors, the per-rung
energies of a 4-ring ladder against dense diagonalization, and the tables a
call makes on the ladder's device (``key_tables_device``) against the numpy
``key_tables``, bit for bit."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")
import jax
from jax.experimental.pallas import tpu as pltpu

import pyisingmontecarlo_tpu as jpmc
from helpers import dense_tfim_energy
from pyisingmontecarlo_tpu.graph import grid_2d_edges
from pyisingmontecarlo_tpu_torch import LatticeTempering
from pyisingmontecarlo_tpu_torch import tempering as tt
from pyisingmontecarlo_tpu_torch.interop import tempering_from_reference
from pyisingmontecarlo_tpu_torch.rng import key_data_from_seeds, key_data_of, key_tensor

torch.set_num_threads(1)

RING8 = [((i, (i + 1) % 8), -1.0) for i in range(8)]
RING4 = [((i, (i + 1) % 4), -1.0) for i in range(4)]
TORUS4 = [(e, float(j)) for (e, _), j in zip(grid_2d_edges(4, 4), np.random.default_rng(0).choice([-1.0, 1.0], 32))]
# replica 1 and 3 with their own dyadic couplings, some edges missing (J = 0)
OVERRIDES = {1: [((0, 1), 0.5), ((1, 2), -1.0), ((3, 4), 1.0), ((4, 5), -0.5), ((6, 7), 1.0), ((7, 0), 0.5)],
             3: [((2, 3), 0.5), ((5, 6), -0.5)]}
LADDERS = {  # edges, betas, gammas, hs, seed, overrides
    "ring8 h": (RING8, [0.8, 1.0, 1.2, 1.4], [1.0] * 4, [0.2] * 4, 3, None),
    "torus4 +-J": (TORUS4, [0.6, 0.7, 0.8, 0.9], [1.0] * 4, [0.1, 0.1, -0.1, 0.0], 4, None),
    "ring8 dyadic overrides": (RING8, [0.8, 1.0, 1.2, 1.4], [1.0, 0.9, 1.0, 1.1], [0.0, 0.2, 0.0, -0.3], 5,
                               OVERRIDES),
}


@pytest.fixture
def jax_on_ladder(monkeypatch):
    """The JAX package's tempering forced onto its Pallas ladder kernel."""
    monkeypatch.setenv("PMC_FORCE_LADDER", "1")
    with pltpu.force_tpu_interpret_mode():
        yield


def _pair(name):
    edges, betas, gammas, hs, seed, overrides = LADDERS[name]
    ref = jpmc.LatticeTempering(edges, seed=seed)
    for r, (b, g, h) in enumerate(zip(betas, gammas, hs)):
        ref.add_graph(g, h, b, edges=None if overrides is None else overrides.get(r))
    return ref, tempering_from_reference(ref, device="cpu")


def _assert_same_ladder(ref, port):
    for g in range(ref.get_num_graphs()):
        np.testing.assert_array_equal(port.get_graph_itime(g), ref.get_graph_itime(g))
    assert port.get_total_swaps() == ref.get_total_swaps()


def _assert_same_sample(want, got):
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].dtype == np.bool_ and got[1].dtype == np.float64
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5)


@pytest.mark.parametrize("name", list(LADDERS))
def test_runs_equal_jax(jax_on_ladder, name):
    """Plain stepping, then sampling with swaps every sweep, then with swaps
    and samples every second sweep (and a remainder sweep)."""
    ref, port = _pair(name)
    ref.qmc_timesteps(3)
    port.qmc_timesteps(3)
    _assert_same_ladder(ref, port)
    for T, swap_freq, sfreq in ((6, 1, None), (7, 2, 2)):
        want = ref.qmc_timesteps_sample(T, swap_freq, sfreq)
        got = port.qmc_timesteps_sample(T, swap_freq, sfreq)
        assert got[0].shape == (4, T // (sfreq or 1), port.nvars)
        _assert_same_sample(want, got)
        _assert_same_ladder(ref, port)
    assert port.get_total_swaps() > 0


def test_continues_from_jax_state(jax_on_ladder):
    """A JAX ladder that has run hands its state across and both continue."""
    ref, _ = _pair("ring8 h")
    ref.qmc_timesteps_sample(5, 1)
    m = ref._materialize()
    state = dict(s=np.asarray(m["s"]), key_data=np.asarray(jax.random.key_data(m["keys"])),
                 swapkey=np.asarray(jax.random.key_data(ref._swapkey)), phase=int(m["phase"]))
    with pytest.raises(ValueError, match="state"):
        tempering_from_reference(ref, device="cpu")
    port = tempering_from_reference(ref, device="cpu", state=state)
    _assert_same_ladder(ref, port)
    _assert_same_sample(ref.qmc_timesteps_sample(6, 2, 3), port.qmc_timesteps_sample(6, 2, 3))
    _assert_same_ladder(ref, port)


def test_autocorrelations_equal_jax(jax_on_ladder):
    ref, port = _pair("ring8 h")
    kw = dict(sampling_wait_buffer=4, replica_swap_freq=2)
    want = ref.run_quantum_monte_carlo_and_measure_variable_autocorrelation(12, **kw)
    got = port.run_quantum_monte_carlo_and_measure_variable_autocorrelation(12, **kw)
    assert got.shape == (4, 12) and got.dtype == np.float64
    np.testing.assert_allclose(got, want, atol=1e-4)
    kw = dict(sampling_freq=2)
    want = ref.run_quantum_monte_carlo_and_measure_bond_autocorrelation(10, **kw)
    got = port.run_quantum_monte_carlo_and_measure_bond_autocorrelation(10, **kw)
    assert got.shape == (4, 10)
    np.testing.assert_allclose(got, want, atol=1e-4)
    _assert_same_ladder(ref, port)


def _port_ladder(seed=0, betas=(0.5, 1.0, 1.5), edges=RING4):
    lt = LatticeTempering(edges, seed=seed, device="cpu")
    for b in betas:
        lt.add_graph(1.0, 0.1, float(b))
    return lt


def test_checkpoint_round_trip(tmp_path):
    lt = _port_ladder(seed=5)
    lt.add_graph(0.8, 0.0, 1.2, edges=[((0, 1), 0.5), ((2, 3), -1.0)], enable_heatbath_update=True)
    lt.qmc_timesteps_sample(10, replica_swap_freq=1)
    path = str(tmp_path / "t.cbor")
    lt.save_to_file(path)
    back = LatticeTempering.read_from_file(path, reseed=7, device="cpu")
    assert back.get_num_graphs() == 4 and back.get_total_swaps() == lt.get_total_swaps()
    for g, h in zip(back.graphs, lt.graphs):
        assert {k: v for k, v in g.items() if k != "seed"} == {k: v for k, v in h.items() if k != "seed"}
    for g in range(4):
        np.testing.assert_array_equal(back.get_graph_itime(g), lt.get_graph_itime(g))
    back.qmc_timesteps(3)  # still runs
    unrun = _port_ladder()
    unrun.save_to_file(path)  # no states yet: the reload draws fresh ones
    assert LatticeTempering.read_from_file(path, reseed=1, device="cpu").get_graph_itime(0).shape == (30, 4)


def test_jax_file_read_by_port_and_regridded(tmp_path, jax_on_ladder):
    """A checkpoint written by the JAX package, read by the port; one saved
    at dtau = 0.1 and read at the default 0.05 doubles L_tau, and both
    packages regrid the saved worldlines alike and run on alike."""
    ref, _ = _pair("ring8 dyadic overrides")
    ref.qmc_timesteps_sample(4, 1)
    path = str(tmp_path / "jax.cbor")
    ref.save_to_file(path)
    got = LatticeTempering.read_from_file(path, reseed=9, device="cpu")
    assert got.get_total_swaps() == ref.get_total_swaps()
    for g, h in zip(got.graphs, ref.graphs):
        assert {k: v for k, v in g.items() if k != "seed"} == {k: v for k, v in h.items() if k != "seed"}
    for g in range(4):
        np.testing.assert_array_equal(got.get_graph_itime(g), ref.get_graph_itime(g))
    coarse = jpmc.LatticeTempering(RING8, seed=8, dtau=0.1)
    for b in (0.8, 1.2):
        coarse.add_graph(1.0, 0.1, b)
    coarse.qmc_timesteps_sample(3, 1)
    coarse.save_to_file(path)
    want = jpmc.LatticeTempering.read_from_file(path, reseed=9)
    got = LatticeTempering.read_from_file(path, reseed=9, device="cpu")
    assert coarse.get_graph_itime(0).shape == (12, 8) and got.get_graph_itime(0).shape == (24, 8)
    _assert_same_ladder(want, got)
    _assert_same_sample(want.qmc_timesteps_sample(3, 1), got.qmc_timesteps_sample(3, 1))
    _assert_same_ladder(want, got)


def test_clone():
    lt = _port_ladder(seed=6)
    lt.qmc_timesteps(3)
    other = lt.clone()
    other.add_graph(1.0, 0.0, 3.0)
    assert lt.get_num_graphs() == 3 and other.get_num_graphs() == 4
    a, b = lt.clone(), lt.clone()
    np.testing.assert_array_equal(a.qmc_timesteps_sample(5)[0], b.qmc_timesteps_sample(5)[0])
    assert a.get_total_swaps() == b.get_total_swaps()
    before = lt.get_graph_itime(1)
    a.qmc_timesteps(4)
    np.testing.assert_array_equal(lt.get_graph_itime(1), before)


def test_shapes_and_counts():
    lt = _port_ladder()
    assert lt.get_num_graphs() == 3 and lt.get_total_swaps() == 0 and lt.cutoff == 4
    states, es = lt.qmc_timesteps_sample(3, sampling_freq=5)
    assert states.shape == (3, 0, 4) and es.shape == (3,) and np.isfinite(es).all()
    states, es = lt.qmc_timesteps_sample(0)
    assert states.shape == (3, 0, 4) and (es == 0).all()
    with pytest.raises(ValueError):
        lt.get_graph_itime(3)


def test_errors():
    lt = LatticeTempering(RING4, seed=0, device="cpu")
    with pytest.raises(ValueError, match="positive"):
        lt.add_graph(0.0, 0.0, 1.0)
    with pytest.raises(ValueError, match="No graphs"):
        lt.qmc_timesteps(5)
    with pytest.raises(ValueError, match="out of bounds"):
        lt.add_graph(1.0, 0.0, 1.0, edges=[((0, 9), 1.0)])
    lt.add_graph(1.0, 0.0, 1.0)
    lt.add_graph(1.0, 0.0, 1.5, enable_rvb_update=True)
    lt.qmc_timesteps(2)  # RVB, a chain and a ring with a diagonal: the generic route
    assert "ga" in lt._materialize()
    chain = LatticeTempering([((0, 1), 1.0), ((1, 2), 1.0), ((2, 3), 1.0)], device="cpu")
    chain.add_graph(1.0, 0.0, 1.0)
    states, es = chain.qmc_timesteps_sample(2)
    assert states.shape == (1, 2, 4) and np.isfinite(es).all()
    ring = LatticeTempering(RING4, device="cpu")
    ring.add_graph(1.0, 0.0, 1.0, edges=[((0, 2), 1.0)])  # a diagonal: no longer a ring
    ring.qmc_timesteps(1)
    assert "ga" in ring._materialize()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            LatticeTempering(RING4)


def test_per_rung_energy_matches_dense_diagonalization():
    """Each rung of a 4-ring ladder with swaps samples its own Boltzmann
    distribution: <E> within 5 se + 0.06 of dense diagonalization (the bound
    of the JAX package's tests/test_tempering.py)."""
    betas = [1.0, 1.5, 2.0, 2.5]
    lt = LatticeTempering(RING4, seed=2, device="cpu")
    for _ in range(6):
        for b in betas:
            lt.add_graph(1.0, 0.0, b)
    lt.qmc_timesteps(150)
    _, energies = lt.qmc_timesteps_sample(250, replica_swap_freq=5)
    energies = energies.reshape(6, len(betas))
    for k, b in enumerate(betas):
        exact = dense_tfim_energy(RING4, 0.0, 1.0, b, 4)
        m, se = energies[:, k].mean(), energies[:, k].std(ddof=1) / np.sqrt(6)
        assert abs(m - exact) < 5 * se + 0.06, (b, m, exact, se)
    assert lt.get_total_swaps() > 0


def _key_data(n, seed):
    return key_data_from_seeds(np.random.default_rng(seed).integers(0, 2**64, n, dtype=np.uint64))


def _assert_same_tables(got, want):
    seeds, uniforms, keys, swapkey = got
    assert seeds.dtype == torch.int32 and uniforms.dtype == torch.float32
    np.testing.assert_array_equal(seeds.numpy(), want[0])
    np.testing.assert_array_equal(uniforms.numpy().view(np.int32), want[1].view(np.int32))
    np.testing.assert_array_equal(key_data_of(keys), want[2])
    np.testing.assert_array_equal(key_data_of(swapkey), want[3][None])


@pytest.mark.parametrize("T,swap_freq", [(0, 1), (1, 1), (7, 1), (0, 3), (1, 3), (7, 3), (0, None), (1, None),
                                         (7, None)])
@pytest.mark.parametrize("R", [1, 33, 64])
def test_device_key_tables_equal_numpy(R, T, swap_freq):
    """``key_tables_device`` on CPU key tensors (``threefry_chain``'s numpy
    version): the seeds, uniforms and both advanced keys of ``key_tables``,
    bit for bit, for ladders across the chain kernel's 32-replica block, and
    nothing counted."""
    kd, sk = _key_data(R, R), _key_data(1, R + 1)[0]
    sf = swap_freq or tt._NEVER
    tt.key_tables_device.launches = 0
    got = tt.key_tables_device(key_tensor(kd, "cpu"), key_tensor(sk, "cpu")[0], T, sf)
    _assert_same_tables(got, tt.key_tables(kd, sk, T, sf))
    assert got[0].shape == (T, R) and got[1].shape == (T // sf, R)
    assert tt.key_tables_device.launches == 0


@pytest.mark.parametrize("R", [1, 33, 64])
def test_device_key_tables_continue_across_calls(R):
    """Two calls of 3 and 4 sweeps continue one chain: the tables of one call
    of 7; and a block of the keys with the whole ladder's uniforms (a shard)."""
    kd, sk = _key_data(R, 2 * R), _key_data(1, 2 * R + 1)[0]
    a = tt.key_tables_device(key_tensor(kd, "cpu"), key_tensor(sk, "cpu")[0], 3, 1)
    b = tt.key_tables_device(a[2], a[3], 4, 1)
    whole = tt.key_tables(kd, sk, 7, 1)
    _assert_same_tables((torch.cat([a[0], b[0]]), torch.cat([a[1], b[1]]), b[2], b[3]), whole)
    block = kd[R // 2:R // 2 + 1]
    got = tt.key_tables_device(key_tensor(block, "cpu"), key_tensor(sk, "cpu")[0], 5, 2, R + 7)
    _assert_same_tables(got, tt.key_tables(block, sk, 5, 2, R + 7))


@pytest.mark.parametrize("rvb", [False, True])
def test_ladder_tables_past_a_uniform_slot(monkeypatch, rvb):
    """A ladder of more rungs than a uniform slot holds makes its tables in
    numpy (``key_tables``, ``swap_uniforms``): the same runs, keys and swap
    key as the tables of ``key_tables_device``, on both routes."""
    lts = []
    for cap in (tt._MAX_M, 2):
        monkeypatch.setattr(tt, "_MAX_M", cap)
        lt = _port_ladder(seed=9)
        lt.add_graph(1.0, 0.0, 2.0, enable_rvb_update=rvb)
        out = lt.qmc_timesteps_sample(5, replica_swap_freq=2)
        lts.append((lt, out))
    (a, out_a), (b, out_b) = lts
    assert ("ga" in a._materialize()) == rvb
    _assert_same_sample(out_a, out_b)
    _assert_same_ladder(a, b)
    np.testing.assert_array_equal(a._materialize()["key_data"], b._materialize()["key_data"])
    np.testing.assert_array_equal(a._swapkey, b._swapkey)
