"""The port's classical graph engine (pyisingmontecarlo_tpu_torch/engines/classical.py)
against the JAX package's, bit for bit (tolerance: none) on integer or dyadic
couplings and fields: each move function and family (spin sweeps on the
dense int, dense hi-only, dense hi+lo and ELL paths; edge sweeps with
importance weights as [Ec] and [R, Ec]; worms; Swendsen-Wang with a field),
the uniforms, energies and initial states, ``run_steps`` against any
chunking, ``run_steps_energies``, ``run_sampling`` with a remainder, and
``worm_closure_fraction``. Inputs come from numpy seeds; each test keeps
well under 10^5 Glauber decisions, so an f32 tie of the sigmoid (the CPU's
and XLA's differ in the last bit at 0.4% of arguments) is not expected."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from pyisingmontecarlo_tpu import models as jmodels
from pyisingmontecarlo_tpu.engines import classical as jce
from pyisingmontecarlo_tpu.graph import compile_graph as jcompile
from pyisingmontecarlo_tpu.rng import keys_from_seeds, split_keys
from pyisingmontecarlo_tpu_torch import rng
from pyisingmontecarlo_tpu_torch.engines import classical as tce
from pyisingmontecarlo_tpu_torch.graph import compile_graph as tcompile

torch.set_num_threads(1)

R = 12


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


TRI = jmodels.triangular_edges(4, j=1.0)
# couplings and fields that are integer, small dyadic (bf16 values: one plane), or dyadic beyond bf16 (two planes)
FAMILIES = {
    "dense int": (TRI, None, 0.25),
    "dense hi": ([((a, b), j * (0.5 + 0.25 * (a % 3))) for (a, b), j in TRI], None, -0.5),
    "dense hi+lo": ([((a, b), j * (1 + 2**-10 * (1 + a % 4))) for (a, b), j in TRI], None, 0.125),
    "ELL": (glass(24), False, 0.25),
}


def _setup(name, sort=True, seed=1):
    edges, dense, h = FAMILIES[name]
    jcg, tcg = jcompile(edges), tcompile(edges)
    jga = jce.device_graph_sorted(jcg, dense=dense) if sort else jce.device_graph(jcg)
    tga = tce.device_graph_sorted(tcg, dense=dense) if sort else tce.device_graph(tcg)
    u64 = np.random.default_rng(seed).integers(0, 2**64, R, dtype=np.uint64)
    keys, kd = keys_from_seeds(u64), rng.key_data_from_seeds(u64)
    s = np.array(jce.random_states(keys, jcg.nvars)).T.copy()  # site-major
    h = np.full(jcg.nvars, h, np.float32)
    return jga, tga, keys, kd, s, h, jcg, tcg


def _sub(keys, kd):
    keys, sub = split_keys(keys)
    kd, ksub = rng.split_all(kd)
    return sub, ksub


def _seeds(kd):
    return torch.from_numpy(rng.seeds_from_key_data(kd))


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_random_states_and_energies():
    jga, tga, keys, kd, s, h, _, _ = _setup("dense hi+lo")
    st = tce.random_states(kd, s.shape[0])
    _eq(st, jce.random_states(keys, s.shape[0]))
    _eq(tce.energy(tga, torch.from_numpy(h), st), jce.energy(jga, jnp.asarray(h), jnp.asarray(st.numpy())))
    _eq(tce._energy_T(tga, torch.from_numpy(h), torch.from_numpy(s)),
        jce._energy_T(jga, jnp.asarray(h), jnp.asarray(s)))


@pytest.mark.parametrize("shape", [(7,), (5, 2), (4, 3)])
def test_uniforms(shape):
    u64 = np.arange(1, R + 1, dtype=np.uint64) * 977
    keys, kd = keys_from_seeds(u64), rng.key_data_from_seeds(u64)
    seeds = _seeds(kd)
    _eq(tce._uniform_lanes(seeds, shape), jce._uniform_lanes(keys, shape))
    _eq(tce._uniform_per_replica(seeds, shape), jce._uniform_per_replica(keys, shape))


@pytest.mark.parametrize("heatbath", [True, False])
def test_accept(heatbath):
    r = np.random.default_rng(3)
    u = r.random((6, R)).astype(np.float32)
    dE = r.integers(-8, 9, (6, R)).astype(np.float32)
    want = jce._accept(jnp.asarray(u), jnp.asarray(dE), jnp.float32(0.75), heatbath)
    _eq(tce._accept(torch.from_numpy(u), torch.from_numpy(dE), 0.75, heatbath), want)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_spin_color_update(family):
    jga, tga, keys, kd, s, h, _, _ = _setup(family)
    for c in range(len(jga.c_sites)):
        sub, ksub = _sub(keys, kd)
        keys, kd = split_keys(keys)[0], rng.split_all(kd)[0]
        want = jce._spin_color_update(jga, jnp.asarray(h), jnp.asarray(s), sub, jnp.float32(0.9), c, True)
        got = tce._spin_color_update(tga, torch.from_numpy(h), torch.from_numpy(s.copy()), _seeds(ksub), 0.9, c,
                                     True)
        _eq(got, want)
        s = np.array(want)


@pytest.mark.parametrize("family,iw", [(f, None) for f in sorted(FAMILIES)]
                         + [(f, w) for f in ("dense hi", "ELL") for w in ("per class", "per replica")])
def test_edge_color_update(family, iw):
    jga, tga, keys, kd, s, h, jcg, tcg = _setup(family, seed=2)
    jw = tw = None
    if iw is not None:
        jw, tw = jce.importance_weights(jcg), tce.importance_weights(tcg)
        if iw == "per replica":
            mask = np.arange(R) % 3 == 0
            jw = tuple(jnp.where(jnp.asarray(mask)[:, None], w[None], 1.0) for w in jw)
            tw = tuple(torch.where(torch.from_numpy(mask)[:, None], w[None], 1.0) for w in tw)
    for c in range(len(jga.e_a)):
        sub, ksub = _sub(keys, kd)
        keys, kd = split_keys(keys)[0], rng.split_all(kd)[0]
        want = jce._edge_color_update(jga, jnp.asarray(h), jnp.asarray(s), sub, jnp.float32(0.7), c, True,
                                      iw=None if jw is None else jw[c])
        got = tce._edge_color_update(tga, torch.from_numpy(h), torch.from_numpy(s.copy()), _seeds(ksub), 0.7, c,
                                     True, iw=None if tw is None else tw[c])
        _eq(got, want)
        s = np.array(want)


def test_importance_weights():
    _, _, _, _, _, _, jcg, tcg = _setup("dense hi")
    for g, w in zip(tce.importance_weights(tcg), jce.importance_weights(jcg)):
        _eq(g, w)


@pytest.mark.parametrize("family", ["dense int", "ELL"])
@pytest.mark.parametrize("heatbath", [False, True])
def test_worm(family, heatbath):
    jga, tga, keys, kd, s, h, _, _ = _setup(family, seed=3)
    n = s.shape[0]
    for wlen in (5, 16):
        sub, ksub = _sub(keys, kd)
        keys, kd = split_keys(keys)[0], rng.split_all(kd)[0]
        ku, k0 = rng.split_all(ksub)
        v0 = torch.from_numpy(rng.randint(k0, n))
        jf, jclosed, ju = jce._worm_walk(jga, sub, wlen, n, R)
        tf, tclosed, tu = tce._worm_walk(tga, _seeds(ku), v0, wlen, n, R)
        _eq(tf, jf)
        _eq(tclosed, jclosed)
        _eq(tu, ju)
        want = jce._worm_update(jga, jnp.asarray(h), jnp.asarray(s), sub, jnp.float32(0.6), wlen, heatbath)
        got = tce._worm_update(tga, torch.from_numpy(h), torch.from_numpy(s), _seeds(ku), v0, 0.6, wlen, heatbath)
        _eq(got, want)
        s = np.array(want)


@pytest.mark.parametrize("family", ["dense int", "dense hi", "ELL"])
def test_sw_cluster_update(family):
    """The labels' convergence is tested once a block of rounds here, after
    every round in the JAX engine: the result is the same."""
    jga, tga, keys, kd, s, h, _, _ = _setup(family, seed=4)
    for beta in (0.3, 1.2):
        sub, ksub = _sub(keys, kd)
        keys, kd = split_keys(keys)[0], rng.split_all(kd)[0]
        k1, k_e = rng.split_all(ksub)
        k2, k_g = rng.split_all(k1)
        _, k_f = rng.split_all(k2)
        want = jce.sw_cluster_update(jga, jnp.asarray(h), jnp.asarray(s), sub, jnp.float32(beta))
        got = tce.sw_cluster_update(tga, torch.from_numpy(h), torch.from_numpy(s), _seeds(k_e), _seeds(k_g),
                                    _seeds(k_f), beta)
        _eq(got, want)
        s = np.array(want)


def test_sw_labels_any_jump_schedule(monkeypatch):
    """The cluster labels, and so the update, do not depend on the doubling
    schedule (a jump every round, every 3rd, every 64th)."""
    jga, tga, keys, kd, s, h, _, _ = _setup("ELL", seed=6)
    seeds = [_seeds(rng.split_all(kd)[i]) for i in range(2)] + [_seeds(kd)]
    outs = []
    for every in (1, 3, 64):
        monkeypatch.setattr(tce, "_SW_JUMP_EVERY", every)
        outs.append(tce.sw_cluster_update(tga, torch.from_numpy(h), torch.from_numpy(s), *seeds, 1.1))
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


def test_time_step_and_step_plan():
    jga, tga, keys, kd, s, h, _, _ = _setup("dense int", seed=5)
    moves = dict(nspin_sweeps=2, nedge_sweeps=1, nworms=2, only_basic=False, heatbath=False, wlen=8, nclusters=1)
    kinds = tce.step_plan(tga, 2, 1, 2, False, 1)
    assert kinds == [0] * (2 * len(tga.c_sites)) + [0] * len(tga.e_a) + [1, 1, 2]
    assert tce.step_plan(tga, 1, 1, 1, True, 1) == [0] * len(tga.c_sites)
    seeds, v0, kd2 = rng.threefry_chain_reference(kd, kinds, 1, s.shape[0])
    want, keys2 = jce.time_step(jga, jnp.asarray(h), jnp.asarray(s), keys, jnp.float32(0.8), **moves)
    got = tce.time_step(tga, torch.from_numpy(h), torch.from_numpy(s), torch.from_numpy(seeds[0]),
                        torch.from_numpy(v0[0]), 0.8, **moves)
    _eq(got, want)
    np.testing.assert_array_equal(kd2, np.asarray(jax.random.key_data(keys2)))


MOVES = {
    "spin": dict(nspin_sweeps=1, nedge_sweeps=0, nworms=0, only_basic=True, heatbath=False, wlen=1),
    "default": dict(nspin_sweeps=1, nedge_sweeps=1, nworms=1, only_basic=False, heatbath=False, wlen=16),
    "sw+heatbath": dict(nspin_sweeps=1, nedge_sweeps=0, nworms=1, only_basic=False, heatbath=True, wlen=16,
                        nclusters=1),
}


def _run_pair(family, moves, T=6, seed=8):
    jga, tga, keys, kd, s, h, _, _ = _setup(family, seed=seed)
    beta = np.linspace(0.2, 1.5, T).astype(np.float32)
    sr = np.ascontiguousarray(s.T)
    return jga, tga, keys, kd, sr, h, beta


@pytest.mark.parametrize("family,moves", [("dense int", "default"), ("dense hi+lo", "spin"), ("ELL", "default"),
                                          ("dense hi", "sw+heatbath")])
def test_run_steps(family, moves):
    jga, tga, keys, kd, s, h, beta = _run_pair(family, moves)
    ws, wk = jce.run_steps(jga, jnp.asarray(h), jnp.asarray(s), keys, jnp.asarray(beta), **MOVES[moves])
    gs, gk = tce.run_steps(tga, torch.from_numpy(h), torch.from_numpy(s), rng.key_tensor(kd, "cpu"), beta,
                           **MOVES[moves])
    _eq(gs, ws)
    np.testing.assert_array_equal(rng.key_data_of(gk), np.asarray(jax.random.key_data(wk)))


def test_run_steps_energies_and_any_chunking(monkeypatch):
    """One JAX run of 7 steps against the port in one piece, in pieces of 1,
    3 and 5 steps (``PMC_STEPS_PER_DISPATCH``), and with a key table of one
    step a piece."""
    jga, tga, keys, kd, s, h, beta = _run_pair("dense int", "default", T=7)
    ws, wk, we = jce.run_steps_energies(jga, jnp.asarray(h), jnp.asarray(s), keys, jnp.asarray(beta),
                                        **MOVES["default"])
    for chunk in ("0", "1", "3", "5"):
        monkeypatch.setenv("PMC_STEPS_PER_DISPATCH", chunk)
        for collect in (True, False):
            out = tce.run_steps_chunked(tga, torch.from_numpy(h), torch.from_numpy(s), rng.key_tensor(kd, "cpu"),
                                        beta, collect_energies=collect, **MOVES["default"])
            _eq(out[0], ws)
            np.testing.assert_array_equal(rng.key_data_of(out[1]), np.asarray(jax.random.key_data(wk)))
            if collect:
                _eq(out[2], we)
    monkeypatch.setattr(tce, "_TABLE_BYTES", 1)
    got = tce.run_steps_energies(tga, torch.from_numpy(h), torch.from_numpy(s), rng.key_tensor(kd, "cpu"), beta,
                                 **MOVES["default"])
    _eq(got[0], ws)
    _eq(got[2], we)


@pytest.mark.parametrize("timesteps,freq", [(7, 3), (4, 5)])
def test_run_sampling(timesteps, freq):
    jga, tga, keys, kd, s, h, _ = _run_pair("ELL", "default")
    want = jce.run_sampling(jga, jnp.asarray(h), jnp.asarray(s), keys, jnp.float32(0.9), timesteps, freq,
                            **MOVES["default"])
    got = tce.run_sampling(tga, torch.from_numpy(h), torch.from_numpy(s), rng.key_tensor(kd, "cpu"), 0.9,
                           timesteps, freq, **MOVES["default"])
    _eq(got[0], want[0])
    np.testing.assert_array_equal(rng.key_data_of(got[1]), np.asarray(jax.random.key_data(want[1])))
    for g, w in zip(got[2:], want[2:]):
        assert tuple(g.shape) == w.shape
        _eq(g, w)


def test_run_steps_zero_steps_and_no_moves():
    _, tga, _, kd, s, h, _ = _run_pair("dense int", "spin")
    keys = rng.key_tensor(kd, "cpu")
    gs, gk = tce.run_steps(tga, torch.from_numpy(h), torch.from_numpy(s), keys, np.zeros(0, np.float32),
                           **MOVES["spin"])
    _eq(gs, s)
    assert torch.equal(gk, keys)
    idle = dict(MOVES["spin"], nspin_sweeps=0)
    gs, gk = tce.run_steps(tga, torch.from_numpy(h), torch.from_numpy(s), keys, np.ones(3, np.float32), **idle)
    _eq(gs, s)
    assert torch.equal(gk, keys)


@pytest.mark.parametrize("edges", [glass(64), jmodels.square_edges(8)])
def test_worm_closure_fraction(edges):
    want = jce.worm_closure_fraction(jcompile(edges), trials=512, seed=3)
    assert tce.worm_closure_fraction(tcompile(edges), trials=512, seed=3, device="cpu") == want


def test_cpu_runs_launch_no_kernel():
    rng.threefry_chain.launches = 0
    _, tga, _, kd, s, h, beta = _run_pair("dense int", "default", T=2)
    tce.run_steps(tga, torch.from_numpy(h), torch.from_numpy(s), rng.key_tensor(kd, "cpu"), beta,
                  **MOVES["default"])
    assert rng.threefry_chain.launches == 0
