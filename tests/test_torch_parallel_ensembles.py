"""The port's replica-sharded ensembles (``parallel/replica.py``, ``parallel/tempering.py``) against the JAX package's.

Twins of the ensemble tests of tests/test_parallel.py: ``QmcRunner`` on both
routes, ``QmcIsing`` and the tempering ladder (its ladder-kernel route and
its generic route) sharded over 4 ranks. The JAX side runs in this process
on its 8 virtual CPU devices; the port's side on 4 spawned ranks
(``entry.launch``, gloo on the CPU) in one spawn (``world4``), the objects
carried across from the JAX ones through ``interop`` before their first run.
Clones and one-rank meshes run in this process on a world of one rank
(``one_rank``). Tolerances: test_torch_parallel.py's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from jax.experimental.pallas import tpu as pltpu

import pyisingmontecarlo_tpu as jpmc
from pyisingmontecarlo_tpu.engines import worldline as jwl
from pyisingmontecarlo_tpu.parallel import mesh as jmesh
from pyisingmontecarlo_tpu.parallel import replica as jrep
from pyisingmontecarlo_tpu.parallel import tempering as jtemp
from pyisingmontecarlo_tpu_torch import LatticeTempering, entry
from pyisingmontecarlo_tpu_torch import tempering as ttemp
from pyisingmontecarlo_tpu_torch.engines import worldline as twl
from pyisingmontecarlo_tpu_torch.interop import qmcising_from_reference, qmcrunner_from_reference, \
    tempering_from_reference
from pyisingmontecarlo_tpu_torch.parallel import mesh as tmesh
from pyisingmontecarlo_tpu_torch.parallel import replica as trep
from pyisingmontecarlo_tpu_torch.parallel import tempering as ttp
from test_torch_parallel import _all_ranks_equal, _cpu_job, _kd, _same

torch.set_num_threads(1)

LADDER_RTOL = 1e-5
RUNNER_CALLS = [("run_sampling", (1.0, 6), dict(sampling_freq=2)), ("run_bond_sampling", (1.0, 4), dict(sampling_freq=2)),
                ("get_graph_itime", (5,), {})]
# the classic route's JAX side runs op by op: fewer sweeps
CLASSIC_CALLS = [("run_sampling", (1.0, 4), dict(sampling_freq=2)), ("run_bond_sampling", (1.0, 2), dict(sampling_freq=1)),
                 ("get_graph_itime", (5,), {})]
QMCISING_CALLS = [("run_sampling", (1.2, 8), dict(sampling_freq=2)), ("run_bond_sampling", (1.2, 3), {})]
LADDER_CALLS = [("qmc_timesteps", (2,), {}), ("qmc_timesteps_sample", (6, 1), {}), ("qmc_timesteps_sample", (7, 2, 2), {})]
RING8 = [((i, (i + 1) % 8), -1.0) for i in range(8)]
TIGHT_SWEEPS = 10


def _jax_runner(R=8):
    q = jpmc.QmcRunner(4, R, seed=13)
    zz = np.array([-(1.0 if i & 1 else -1.0) * (1.0 if i & 2 else -1.0) for i in range(4)])
    for i in range(4):
        q.add_diagonal_interaction(zz, [i, (i + 1) % 4])
        q.add_interaction(np.array([0.0, -0.7, -0.7, 0.0]), [i])
    return q


def _port_runner(gm: str):
    """The port of ``_jax_runner()`` materialized at beta 1 on the route ``gm``."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PMC_GENERIC_GM", gm)
        ref = _jax_runner()
        q = qmcrunner_from_reference(ref, _kd(ref._keys), "cpu")
        assert q._ensure(1.0).use_gm == (gm == "1")
    return q


def _jax_qmcising():
    q = jpmc.QmcIsing([((i, (i + 1) % 6), -1.0) for i in range(6)], 1.0, num_experiments=8, seed=31)
    q._ensure(1.2)
    return q


def _jax_ladder(edges=RING8, betas=np.linspace(0.8, 1.2, 8), seed=3, rvb=None):
    lt = jpmc.LatticeTempering(edges, seed=seed)
    for r, b in enumerate(betas):
        lt.add_graph(1.0, 0.2 if rvb else 0.0, float(b), enable_rvb_update=bool(rvb and rvb[r]))
    return lt


RVB_LADDER = dict(betas=[0.8, 1.0, 1.2, 1.4], seed=4, rvb=[True, False, True, False])


def _port_rvb_ladder():
    """The RVB ring ladder (the generic route), materialized with the JAX package's f32 parameters."""
    def carried(betas, gammas, hs, L, device="cpu"):
        return twl.params_from_arrays([np.asarray(x) for x in jwl.make_params(betas, gammas, hs, L)], device)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttemp, "make_params", carried)
        lt = tempering_from_reference(_jax_ladder(**RVB_LADDER), device="cpu")
        assert "ga" in lt._materialize()
    return lt


def _itimes(n):
    return [("get_graph_itime", (g,), {}) for g in range(n)]


def _ladder_run(lt, calls):
    out = [getattr(lt, name)(*args, **kw) for name, args, kw in calls]
    return out + [lt.get_graph_itime(g) for g in range(lt.get_num_graphs())], lt.get_total_swaps()


@pytest.fixture
def jax_on_ladder(monkeypatch):
    """The JAX package's tempering forced onto its Pallas ladder kernel (interpret mode)."""
    monkeypatch.setenv("PMC_FORCE_LADDER", "1")
    with pltpu.force_tpu_interpret_mode():
        yield


# ------------------------------------------------------------------- worlds


@pytest.fixture(scope="module")
def world4():
    """Every 4-rank job of this file in one spawn: {name: rank results}."""
    jobs = {
        "dryrun ladder": _cpu_job(entry.on_mesh, (4,), ("replica",), ttp.dryrun_ladder, replicas_per_device=2, nvars=6,
                                  ltau=8, timesteps=3),
        "dryrun runner": _cpu_job(entry.on_mesh, (4,), ("replica",), trep.dryrun_runner, replicas_per_device=2, nvars=6,
                                  timesteps=2),
    }
    for gm in ("0", "1"):
        calls = RUNNER_CALLS if gm == "1" else CLASSIC_CALLS
        jobs[f"runner gm={gm} sharded"] = _cpu_job(entry.drive, _port_runner(gm), (4,), ("replica",), trep.shard_runner,
                                                   dict(beta=1.0), calls)
        jobs[f"runner gm={gm} unsharded"] = _cpu_job(entry.drive, _port_runner(gm), (4,), ("replica",), None, {}, calls)
    ref = _jax_qmcising()
    jobs["qmcising"] = _cpu_job(entry.drive, qmcising_from_reference(ref, _kd(ref._w.keys), "cpu"), (4,), ("replica",),
                                trep.shard_qmcising, dict(beta=1.2), QMCISING_CALLS)
    for sharded in (True, False):
        key = "sharded" if sharded else "unsharded"
        shard = ttp.shard_ladder if sharded else None
        jobs[f"ladder {key}"] = _cpu_job(entry.drive, tempering_from_reference(_jax_ladder(), device="cpu"), (4,),
                                         ("replica",), shard, {}, LADDER_CALLS + _itimes(8))
        jobs[f"rvb ladder {key}"] = _cpu_job(entry.drive, _port_rvb_ladder(), (4,), ("replica",), shard, {},
                                             LADDER_CALLS + _itimes(4))
    tight = _jax_ladder([((i, (i + 1) % 4), -1.0) for i in range(4)], np.linspace(1.0, 1.1, 8), seed=0)
    jobs["tight ladder"] = _cpu_job(entry.drive, tempering_from_reference(tight, device="cpu"), (4,), ("replica",),
                                    ttp.shard_ladder, {},
                                    [("qmc_timesteps_sample", (TIGHT_SWEEPS,), dict(replica_swap_freq=1))])
    results = entry.launch(entry.run_all, 4, args=(list(jobs.values()),), device="cpu", timeout=600.0)
    return {name: [r[k] for r in results] for k, name in enumerate(jobs)}


@pytest.fixture
def one_rank():
    """A world of one rank in this process (an in-memory store), torn down after the test."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    tmesh.init_distributed(device="cpu")
    yield
    dist.destroy_process_group()


# -------------------------------------------------------------- the tests


@pytest.mark.parametrize("gm", ["0", "1"])
def test_replica_sharded_qmcrunner(world4, monkeypatch, gm):
    """Sharded == unsharded in the port bit for bit, and == the JAX package's
    run: on the gm route its sharded run (shard_map around the jitted
    drivers); on the classic route, whose sharded drivers take minutes to
    compile on the CPU, its unsharded run op by op under ``jax.disable_jit()``
    (tests/test_parallel.py pins the JAX package's sharded run to it, bit for
    bit)."""
    sharded = _all_ranks_equal(world4[f"runner gm={gm} sharded"])
    unsharded = _all_ranks_equal(world4[f"runner gm={gm} unsharded"])
    _same(sharded, unsharded, exact=True)
    monkeypatch.setenv("PMC_GENERIC_GM", gm)
    ref = _jax_runner()
    if gm == "1":
        jrep.shard_runner(ref, jmesh.make_mesh((4,), ("replica",)), beta=1.0)
        want = [getattr(ref, name)(*args, **kw) for name, args, kw in RUNNER_CALLS]
    else:
        with jax.disable_jit():
            want = [getattr(ref, name)(*args, **kw) for name, args, kw in CLASSIC_CALLS]
    assert ref._w.use_gm == (gm == "1")
    _same(sharded[0], want)
    (es, ss), counts = sharded[0][0], sharded[0][1]
    assert es.shape == (8,) and ss.shape[0] == counts.shape[0] == 8 and counts.shape[2] == 8


def test_replica_sharded_qmcising_equals_jax(world4):
    got = _all_ranks_equal(world4["qmcising"])[0]
    ref = _jax_qmcising()
    jrep.shard_qmcising(ref, jmesh.make_mesh((4,), ("replica",)), beta=1.2)
    want = [getattr(ref, name)(*args, **kw) for name, args, kw in QMCISING_CALLS]
    _same(got, want)
    assert got[0][1].shape == (8, 4, 6)


def test_sharded_ladder_equals_jax(world4, jax_on_ladder):
    """The ladder route at 4 ranks (the ladder kernel's plain version on each
    rank's two replicas) against the unsharded port and the JAX package's
    sharded Pallas ladder in interpret mode."""
    sharded, swaps = _all_ranks_equal(world4["ladder sharded"])
    unsharded, swaps1 = _all_ranks_equal(world4["ladder unsharded"])
    _same(sharded, unsharded, exact=True)
    assert swaps == swaps1
    ref = _jax_ladder()
    jtemp.shard_ladder(ref, jmesh.make_mesh((4,), ("replica",)))
    assert ref._materialize()["ladder"]["mesh"] is not None
    want, jswaps = _ladder_run(ref, LADDER_CALLS)
    _same(sharded, want, rtol=LADDER_RTOL)
    assert swaps == jswaps and swaps > 0


def test_sharded_generic_ladder_equals_jax(world4):
    """The RVB ladder (the generic route), one replica a rank, against the
    unsharded port and the JAX package's sharded generic path."""
    sharded, swaps = _all_ranks_equal(world4["rvb ladder sharded"])
    unsharded, swaps1 = _all_ranks_equal(world4["rvb ladder unsharded"])
    _same(sharded, unsharded, exact=True)
    ref = _jax_ladder(**RVB_LADDER)
    jtemp.shard_ladder(ref, jmesh.make_mesh((4,), ("replica",)))
    want, jswaps = _ladder_run(ref, LADDER_CALLS)
    _same(sharded, want)
    assert swaps == swaps1 == jswaps


def test_sharded_ladder_swaps_counted(world4, jax_on_ladder):
    (out,), swaps = _all_ranks_equal(world4["tight ladder"])
    assert swaps > 5
    ref = _jax_ladder([((i, (i + 1) % 4), -1.0) for i in range(4)], np.linspace(1.0, 1.1, 8), seed=0)
    jtemp.shard_ladder(ref, jmesh.make_mesh((4,), ("replica",)))
    want = ref.qmc_timesteps_sample(TIGHT_SWEEPS, replica_swap_freq=1)
    _same(out, want, rtol=LADDER_RTOL)
    assert swaps == ref.get_total_swaps()


def test_dryruns_at_four_ranks(world4):
    esum = _all_ranks_equal(world4["dryrun ladder"])
    assert esum.shape == (8,) and np.isfinite(esum).all()
    es = _all_ranks_equal(world4["dryrun runner"])
    assert es.shape == (8,) and np.isfinite(es).all()


def test_shard_ladder_on_clone_leaves_original_unsharded(one_rank):
    lt = LatticeTempering(RING8, seed=7, device="cpu")
    for b in np.linspace(0.8, 1.2, 8):
        lt.add_graph(1.0, 0.0, float(b))
    lt._materialize()
    other = lt.clone()
    ttp.shard_ladder(other, tmesh.make_mesh((1,), ("replica",), device="cpu"))
    assert "shard" in other._materialize() and "shard" not in lt._materialize()
    twin = lt.clone()
    _same(_ladder_run(other, LADDER_CALLS), _ladder_run(twin, LADDER_CALLS), exact=True)
    lt.qmc_timesteps(1)  # still the unsharded path
    with pytest.raises(ValueError, match="sharded already"):
        ttp.shard_ladder(other, tmesh.make_mesh((1,), ("replica",), device="cpu"))


def test_one_rank_runner_and_qmcising_equal_unsharded(one_rank):
    """On a one-rank mesh (a machine with one GPU) the sharded objects run the unsharded path's numbers."""
    mesh = tmesh.make_mesh((1,), ("replica",), device="cpu")
    a, b = _port_runner("1"), _port_runner("1")
    trep.shard_runner(a, mesh)
    _same([getattr(a, n)(*x, **k) for n, x, k in RUNNER_CALLS], [getattr(b, n)(*x, **k) for n, x, k in RUNNER_CALLS],
          exact=True)
    with pytest.raises(ValueError, match="before sharding"):
        a.add_qmc()
    ref = _jax_qmcising()
    a, b = (qmcising_from_reference(ref, _kd(ref._w.keys), "cpu") for _ in range(2))
    trep.shard_qmcising(a, mesh, beta=1.2)
    b._w.dense = None  # the sharded ensemble's generic route
    _same([getattr(a, n)(*x, **k) for n, x, k in QMCISING_CALLS], [getattr(b, n)(*x, **k) for n, x, k in QMCISING_CALLS],
          exact=True)
    # a beta change regrids this rank's block and keeps the shard (and the generic route)
    b._ensure(2.0)
    b._w.dense = None
    _same(a.run_sampling(2.0, 2), b.run_sampling(2.0, 2), exact=True)
    assert a._w.shard is not None and a.num_graphs == 8
