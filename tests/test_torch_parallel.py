"""The port's multi-device paths (``parallel/``, ``entry.py``) against the JAX package's.

Twins of tests/test_parallel.py. The JAX side runs in this process on its 8
virtual CPU devices; the port's side runs on spawned ranks (``entry.launch``,
gloo on the CPU), one spawn per world size (the module fixtures ``world2``,
``world4``, ``world8``), each rank running the same list of jobs; inputs come
from numpy seeds, or from the JAX objects through ``interop`` before their
first run. The replica-sharded ensembles are in
test_torch_parallel_ensembles.py.

Tolerances: states, samples, bond counts, swap counts, int statistics and
keys bit for bit; sharded port == unsharded port bit for bit in everything,
energies included. Against the JAX package the energies hold the tolerances
of the unsharded twins (tests/test_torch_qmcrunner.py, test_torch_tempering.py,
test_torch_tempering_generic.py: 2e-6 of the largest magnitude for the
generic engines' f32 sums, 1e-5 relative for the ladder route's f64
estimator), since the port forms them in another order.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp

from pyisingmontecarlo_tpu.engines import worldline as jwl
from pyisingmontecarlo_tpu.parallel import mesh as jmesh
from pyisingmontecarlo_tpu.parallel import spatial as jsp
from pyisingmontecarlo_tpu.parallel import tau as jtau
from pyisingmontecarlo_tpu_torch import LatticeTempering, QmcRunner, entry
from pyisingmontecarlo_tpu_torch.examples import tau_sharded_tfim as texample
from pyisingmontecarlo_tpu_torch.parallel import mesh as tmesh
from pyisingmontecarlo_tpu_torch.parallel import replica as trep
from pyisingmontecarlo_tpu_torch.parallel import spatial as tsp
from pyisingmontecarlo_tpu_torch.parallel import tau as ttau
from pyisingmontecarlo_tpu_torch.parallel import tempering as ttp
from test_torch_generic import _close

torch.set_num_threads(1)

RNG = np.random.default_rng(2024)
S16 = RNG.integers(0, 2, (4, 16, 16)).astype(np.int8) * 2 - 1  # spatial: R = 4, 16^2
S10 = RNG.integers(0, 2, (2, 10, 10)).astype(np.int8) * 2 - 1  # 10 columns do not split over 4 ranks
TAU_RING = RNG.integers(0, 2, (6, 8, 16)).astype(np.int8) * 2 - 1  # tau: R = 6, 8-ring, L_tau = 16
TAU_TORUS = RNG.integers(0, 2, (4, 16, 16)).astype(np.int8) * 2 - 1  # R = 4, 4^2 torus, L_tau = 16
SPATIAL = dict(beta=0.4, j=-1.0, h=0.0, sweeps=5)
TAU = dict(beta=1.0, gamma=1.0, j=-1.0, h=0.0, sweeps=6)


def _kd(keys):
    return np.asarray(jax.random.key_data(keys))


def _job(fn, *args, **kw):
    return (fn, args, kw)


def _cpu_job(fn, *args, **kw):
    """A job of an entry point that runs on the card unless given ``device="cpu"``."""
    return _job(fn, *args, device="cpu", **kw)


def _spatial_job(shape, names, s, key, **kw):
    return _cpu_job(entry.on_mesh, shape, names, tsp.sharded_sweeps_2d, torch.from_numpy(s),
                    np.array([0, key], np.uint32), **SPATIAL, **kw)


def _tau_job(shape, names, s, key, **kw):
    return _cpu_job(entry.on_mesh, shape, names, ttau.sharded_wl_sweeps, torch.from_numpy(s),
                    np.array([0, key], np.uint32), mesh_kw="mesh", **{**TAU, **kw})


def _jax_spatial(shape, names, s, key, **kw):
    m = jmesh.make_mesh(shape, names)
    return np.asarray(jsp.sharded_sweeps_2d(m, jnp.asarray(s), jax.random.key(key), **SPATIAL, **kw))


def _jax_tau(shape, names, s, key, **kw):
    m = jmesh.make_mesh(shape, names)
    args = {**TAU, **kw}
    sweeps = args.pop("sweeps")
    return np.asarray(jtau.sharded_wl_sweeps(jnp.asarray(s), jax.random.key(key), m, sweeps=sweeps, **args))


def _all_ranks_equal(results):
    """Every rank's result equals rank 0's, bit for bit; returns rank 0's."""
    for r in results[1:]:
        _same(r, results[0], exact=True)
    return results[0]


def _same(got, want, exact=False, rtol=None):
    """Nested results equal: arrays bit for bit, floats bit for bit when
    ``exact``, else within ``rtol`` (``_close``'s rule when None)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), (got, want)
        for k in want:
            _same(got[k], want[k], exact, rtol)
        return
    if isinstance(want, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(got) == len(want), (got, want)
        for g, w in zip(got, want):
            _same(g, w, exact, rtol)
        return
    if want is None or isinstance(want, (int, str)):
        assert got == want, (got, want)
        return
    g, w = np.asarray(got), np.asarray(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    if g.dtype.kind == "f" and not exact:
        if rtol is None:
            _close(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=rtol)
    else:
        np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def world4():
    """Every 4-rank job in one spawn: {name: rank results}."""
    jobs = {
        "spatial 4": _spatial_job((4,), ("space",), S16, 7),
        "spatial 2x2": _spatial_job((2, 2), ("replica", "space"), S16, 7, replica_axis="replica"),
        "tau ring 4": _tau_job((4,), ("tau",), TAU_RING, 3),
        "tau torus 4": _tau_job((4,), ("tau",), TAU_TORUS, 5, kind="torus", size=4),
        "tau 2x2": _tau_job((2, 2), ("replica", "tau"), TAU_TORUS, 6, kind="torus", size=4, replica_axis="replica"),
        "dryrun tau": _cpu_job(entry.on_mesh, (4,), ("tau",), ttau.dryrun_tau, nvars=6, ltau=8, replicas=3, sweeps=2),
    }
    three = LatticeTempering([((0, 1), -1.0)], seed=0, device="cpu")
    for b in (1.0, 1.5, 2.0):
        three.add_graph(1.0, 0.0, b)
    jobs["error: ladder 3 over 4"] = _cpu_job(entry.drive, three, (4,), ("replica",), ttp.shard_ladder, {}, [])
    six = QmcRunner(4, 6, seed=1, device="cpu")
    six.add_interaction(np.array([0.0, -0.5, -0.5, 0.0]), [0])
    jobs["error: runner 6 over 4"] = _cpu_job(entry.drive, six, (4,), ("replica",), trep.shard_runner, dict(beta=1.0),
                                              [])
    jobs["error: odd slabs"] = _tau_job((4,), ("tau",), TAU_RING[:, :, :12], 1)
    jobs["error: slabs do not divide"] = _tau_job((4,), ("tau",), TAU_RING[:, :, :10], 1)
    jobs["error: odd shard count"] = _tau_job((3,), ("tau",), TAU_RING[:, :, :12], 1)
    jobs["error: columns do not divide"] = _spatial_job((4,), ("space",), S10, 1)
    jobs["error: world too small"] = _job(entry.mesh_layout, tmesh.make_mesh, (64,), ("replica",), device="cpu")
    results = entry.launch(entry.run_all, 4, args=(list(jobs.values()),), device="cpu", timeout=600.0)
    return {name: [r[k] for r in results] for k, name in enumerate(jobs)}


@pytest.fixture(scope="module")
def world2():
    jobs = {
        "spatial 2": _spatial_job((2,), ("space",), S16, 9),
        "tau ring 2": _tau_job((2,), ("tau",), TAU_RING, 4),
        "tau torus 2": _tau_job((2,), ("tau",), TAU_TORUS, 8, kind="torus", size=4),
        "example": _cpu_job(entry.on_mesh, (2,), ("tau",), texample.run, steps=2, sweeps=3),
    }
    results = entry.launch(entry.run_all, 2, args=(list(jobs.values()),), device="cpu", timeout=600.0)
    return {name: [r[k] for r in results] for k, name in enumerate(jobs)}


@pytest.fixture(scope="module")
def world8():
    jobs = {
        "dryrun_multichip": _cpu_job(entry.dryrun_multichip, 8),
        "mesh 8": _job(entry.mesh_layout, tmesh.make_mesh, (8,), ("replica",), device="cpu"),
        "mesh 2x4": _job(entry.mesh_layout, tmesh.make_mesh, (2, 4), ("replica", "space"), device="cpu"),
        "global mesh": _job(entry.mesh_layout, tmesh.global_mesh, device="cpu"),
        "global mesh x y": _job(entry.mesh_layout, tmesh.global_mesh, "replica", (("x", 2), ("y", 2)), device="cpu"),
        "error: global mesh 3": _job(entry.mesh_layout, tmesh.global_mesh, "replica", (("x", 3),), device="cpu"),
        "init_distributed again": _job(tmesh.init_distributed),
        "replica_sharding": _cpu_job(entry.on_mesh, (2, 4), ("replica", "space"), tmesh.replica_sharding, 12,
                                     axis="space"),
    }
    results = entry.launch(entry.run_all, 8, args=(list(jobs.values()),), device="cpu", timeout=600.0)
    return {name: [r[k] for r in results] for k, name in enumerate(jobs)}


# -------------------------------------------------------------- the tests


@pytest.mark.parametrize("name,shape,names,key,kw", [
    ("spatial 2", (2,), ("space",), 9, {}),
    ("spatial 4", (4,), ("space",), 7, {}),
    ("spatial 2x2", (2, 2), ("replica", "space"), 7, dict(replica_axis="replica")),
])
def test_spatial_equals_jax(world2, world4, name, shape, names, key, kw):
    got = _all_ranks_equal((world2 if name == "spatial 2" else world4)[name]).numpy()
    want = _jax_spatial(shape, names, S16, key, **kw)
    assert (want != S16).any()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,shape,names,s,key,kw", [
    ("tau ring 2", (2,), ("tau",), TAU_RING, 4, {}),
    ("tau ring 4", (4,), ("tau",), TAU_RING, 3, {}),
    ("tau torus 2", (2,), ("tau",), TAU_TORUS, 8, dict(kind="torus", size=4)),
    ("tau torus 4", (4,), ("tau",), TAU_TORUS, 5, dict(kind="torus", size=4)),
    ("tau 2x2", (2, 2), ("replica", "tau"), TAU_TORUS, 6, dict(kind="torus", size=4, replica_axis="replica")),
])
def test_tau_equals_jax(world2, world4, name, shape, names, s, key, kw):
    got = _all_ranks_equal((world2 if shape == (2,) else world4)[name]).numpy()
    want = _jax_tau(shape, names, s, key, **kw)
    assert (want != s).any()
    np.testing.assert_array_equal(got, want)


def test_dryrun_tau_equals_jax(world4):
    got = _all_ranks_equal(world4["dryrun tau"])
    assert got.shape == (3, 6, 8) and set(np.unique(got)) <= {-1, 1}
    np.testing.assert_array_equal(got, jtau.dryrun_tau(jmesh.make_mesh((4,), ("tau",)), 6, 8, 3, 2))


@pytest.mark.parametrize("name,match", [
    ("error: ladder 3 over 4", "divisible"), ("error: runner 6 over 4", "divisible"),
    ("error: odd slabs", "even slabs"), ("error: slabs do not divide", "even slabs"),
    ("error: odd shard count", "even shard count"), ("error: columns do not divide", "divisible"),
    ("error: world too small", "needs 64 ranks"),
])
def test_value_errors(world4, name, match):
    results = world4[name]
    if name == "error: odd shard count":  # the rank outside the 3-rank mesh
        assert results[3] == ("ValueError", "this rank is not in the mesh")
        results = results[:3]
    for r in results:
        assert r[0] == "ValueError" and match in r[1], r


def test_dryrun_multichip_eight_ranks(world8):
    """All five stages on every rank; (b) and (c) bit for bit the JAX package's dry runs."""
    out = _all_ranks_equal(world8["dryrun_multichip"])
    assert sorted(out) == ["a", "b", "c", "d", "e"]
    assert out["a"].shape == (16,) and out["d"].shape == (16,)
    np.testing.assert_array_equal(out["b"], jsp.dryrun_spatial(jmesh.make_mesh((8,), ("space",)), 64, 2, 2))
    np.testing.assert_array_equal(out["c"], jsp.dryrun_spatial(jmesh.make_mesh((2, 4), ("replica", "space")),
                                                               32, 4, 1))
    (ej2, kk2), (ej1, kk1) = out["e"]
    assert -8.0 < ej2 < 0.0 and 0.0 < kk2 < 0.5 and np.isfinite([ej1, kk1]).all()


def test_meshes_and_init_distributed(world8):
    assert _all_ranks_equal(world8["mesh 8"]) == (list(range(8)), ("replica",))
    assert _all_ranks_equal(world8["mesh 2x4"]) == ([[0, 1, 2, 3], [4, 5, 6, 7]], ("replica", "space"))
    assert _all_ranks_equal(world8["global mesh"]) == (list(range(8)), ("replica",))
    assert _all_ranks_equal(world8["global mesh x y"]) == ([[[0, 1], [2, 3]], [[4, 5], [6, 7]]], ("replica", "x", "y"))
    for r in world8["error: global mesh 3"]:
        assert r[0] == "ValueError" and "not divisible" in r[1]
    assert world8["init_distributed again"] == [None] * 8
    assert [r.start for r in world8["replica_sharding"]] == [0, 3, 6, 9] * 2


def test_example_twin_equals_jax_two_ranks(world2):
    """examples/tau_sharded_tfim.py's model and loop at 2 slabs, 2 x 3 sweeps."""
    energies, shape = _all_ranks_equal(world2["example"])
    assert shape == (128, 16, 64) and [e[0] for e in energies] == [3, 6]
    from pyisingmontecarlo_tpu.engines import classical as jce
    from pyisingmontecarlo_tpu.graph import compile_graph

    edges = [((i, (i + 1) % 16), -1.0) for i in range(16)]
    m = jmesh.make_mesh((2,), ("tau",))
    s = jax.random.bernoulli(jax.random.key(0), 0.5, (128, 16, 64)).astype(jnp.int8) * 2 - 1
    ga, p = jce.device_graph(compile_graph(edges)), jwl.make_params(np.full(128, 2.0), 1.0, 0.0, 64)
    for step, (done, mean, se) in enumerate(energies):
        s = jtau.sharded_wl_sweeps(s, jax.random.key(step + 1), m, 2.0, 1.0, -1.0, 0.0, sweeps=3)
        e = np.asarray(jwl.total_energy(ga, p, jnp.asarray(np.asarray(s))), np.float64)
        np.testing.assert_allclose([mean, se], [e.mean(), e.std(ddof=1) / np.sqrt(128)], rtol=1e-5)


def test_cuda_rank_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the check is for a host without a GPU")
    with pytest.raises(ValueError, match="GPU of its own"):
        tmesh.init_distributed(device="cuda")


def test_entry_points_default_to_the_card():
    """``launch`` and ``dryrun_multichip`` run on CUDA (NCCL) unless given
    ``device="cpu"``: without a GPU their ranks raise instead of taking the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the check is for a host without a GPU")
    with pytest.raises(RuntimeError, match="GPU of its own"):
        entry.launch(entry.dryrun_multichip, 2, args=(2,), timeout=120.0)
