"""The torch port's worldline sweeps (``ops/wl.py``) against the JAX package's
Pallas kernel in interpret mode: final spins, energies, samples and the
op-count statistics from the same numpy-made states and seeds, on a ring, a
torus, with a longitudinal field, in the low-Gamma regime where many time
rings are fully frozen, and in the JAX kernel's row-accumulator mode. Also the
host tables, the dispatch-chunk plan, the frozen-ring summation order, the
wrapper's checks, and the physics against dense diagonalization.

Spins, energies and samples must be equal (tolerance: none); the op-count
statistics agree to 1e-12. The one known source of a difference is the last
ulp of f32 ``log`` (XLA's against torch's) in a cluster decision; a mismatch
is reported with the number and places of the differing spins. On the CPU
the wrapper runs the plain version; ``chip_smoke.py`` holds the CUDA kernel
to it on the card."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")
import jax
from jax.experimental.pallas import tpu as pltpu

from helpers import dense_tfim_energy
from pyisingmontecarlo_tpu.ops import wl_pallas as wp
from pyisingmontecarlo_tpu_torch import Lattice
from pyisingmontecarlo_tpu_torch.ops import wl

torch.set_num_threads(1)


def _inputs(seed, R, nvars, L):
    rng = np.random.default_rng(seed)
    s0 = rng.integers(0, 2, (R, nvars, L)).astype(np.int8) * 2 - 1
    seeds = rng.integers(-(2**31), 2**31, R).astype(np.int32)
    return s0, seeds


def _jax_sweeps(s0, seeds, T, dense, beta, gamma, h, L):
    with pltpu.force_tpu_interpret_mode():
        s, e, st = wp.run_wl_sweeps_pallas(jnp.asarray(s0), jnp.asarray(seeds), T, dense, beta, gamma, h, L)
    return np.asarray(s), np.asarray(e), st


def _jax_sample(s0, seeds, freq, ns, rem, dense, beta, gamma, h, L):
    with pltpu.force_tpu_interpret_mode():
        s, e, smp = wp.run_wl_sample_pallas(jnp.asarray(s0), jnp.asarray(seeds), freq, ns, rem,
                                            dense, beta, gamma, h, L)
    return np.asarray(s), np.asarray(e), np.asarray(smp)


def assert_same_spins(want, got, what="spins"):
    """Equal, or fail with the count and the places of the differences (a
    cluster decision moved by the last ulp of f32 log flips a whole cluster)."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    diff = np.argwhere(want != got)
    assert len(diff) == 0, (
        f"{what}: {len(diff)} of {want.size} differ; first at (replica, site, slice) {diff[:8].tolist()}"
    )


CASES = {
    # name: (input seed, dense, R, L, T, beta, gamma, h)
    "ring": (1, ("ring", 8, -1.0), 3, 8, 5, 2.0, 1.0, 0.0),
    "torus-field": (2, ("torus", 4, -1.0), 2, 8, 4, 1.5, 0.8, -0.3),
    # low Gamma: p_bond ~ 0.9975, most rings fully frozen; L_tau > 32 takes
    # the padded-window order of the frozen totals
    "ring-frozen": (3, ("ring", 8, 0.7), 3, 40, 6, 2.0, 0.05, 0.2),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_sweeps_equal_jax_kernel(name):
    seed, dense, R, L, T, beta, gamma, h = CASES[name]
    nvars = dense[1] if dense[0] == "ring" else dense[1] ** 2
    s0, seeds = _inputs(seed, R, nvars, L)
    js, je, jst = _jax_sweeps(s0, seeds, T, dense, beta, gamma, h, L)
    ts, te, tst = wl.run_wl_sweeps(torch.from_numpy(s0), seeds, T, dense, beta, gamma, h, L)
    assert ts.dtype == torch.int8 and tuple(ts.shape) == s0.shape
    assert_same_spins(js, ts)
    assert (js != s0).mean() > 0.2, "spins barely moved"
    np.testing.assert_array_equal(te, je)
    for k in ("diag_mean", "kinks_mean"):
        np.testing.assert_allclose(tst[k], jst[k], rtol=0, atol=1e-12)
    if name == "ring-frozen":
        frozen = (js == js[:, :, :1]).all(axis=2).mean()
        assert frozen > 0.5, f"only {frozen:.2f} of the lines are constant in tau"


def test_sample_equal_jax_kernel():
    """Sampling mode on a torus with h != 0: 4 blocks of 3 sweeps, 2 more."""
    dense, R, L = ("torus", 4, 0.5), 2, 12
    s0, seeds = _inputs(11, R, 16, L)
    js, je, jsmp = _jax_sample(s0, seeds, 3, 4, 2, dense, 1.2, 1.1, 0.25, L)
    ts, te, tsmp = wl.run_wl_sample(torch.from_numpy(s0), seeds, 3, 4, 2, dense, 1.2, 1.1, 0.25, L)
    assert_same_spins(js, ts)
    assert_same_spins(jsmp, tsmp, "samples")
    assert tsmp.shape == (R, 4, 16) and tsmp.dtype == torch.int8
    np.testing.assert_array_equal(te, je)


def test_row_mode_equal_jax_kernel(monkeypatch):
    """The JAX kernel's row-accumulator mode, forced by shrinking its plane
    gate (as tests/test_lanerng.py does); the port's dispatch plan follows
    the same gate."""
    dense, R, L = ("ring", 8, -1.0), 2, 8
    s0, seeds = _inputs(12, R, 8, L)
    monkeypatch.setattr(wp, "_MAX_PLANE_BYTES", 16)
    monkeypatch.setattr(wl, "_ROW_PLANE_BYTES", 16)
    assert wp._acc_rows(8, L) and wl.dispatch_bound(8, L) == (1 << 23) // (2 * L)
    js, je, jst = _jax_sweeps(s0, seeds, 4, dense, 2.0, 1.0, 0.1, L)
    ts, te, tst = wl.run_wl_sweeps(torch.from_numpy(s0), seeds, 4, dense, 2.0, 1.0, 0.1, L)
    assert_same_spins(js, ts)
    np.testing.assert_array_equal(te, je)
    np.testing.assert_allclose(tst["kinks_mean"], jst["kinks_mean"], rtol=0, atol=1e-12)


@pytest.mark.parametrize("j,h,beta,gamma,L", [(-1.0, 0.0, 2.0, 1.0, 40), (0.7, -0.3, 1.5, 0.05, 30)])
def test_tables_equal_jax(j, h, beta, gamma, L):
    dtau, a, ktau = wl.coupling_params(beta, gamma, L)
    thr, cde = wl.site_tables(j, h, dtau, ktau)
    jthr, jcde = wp._site_tables(j, h, dtau, ktau)
    np.testing.assert_array_equal(thr, jthr)
    np.testing.assert_array_equal(cde, jcde[:10])
    assert wl.bond_threshold(ktau) == int(np.int32((1.0 - math.exp(-2.0 * ktau)) * 2147483647.0))
    t = wl.make_tables(("ring", 8, j), 8, beta, gamma, h, L)
    assert t.thr.dtype == torch.int32 and t.cde.dtype == torch.float32


def _jax_schedule(total, L, rows, seeds):
    """``wl_pallas.py:544-553``, transcribed: (seeds, steps) of each dispatch."""
    bound = max(1, (1 << 23) // max(2 * L, 1)) if rows else (1 << 23)
    seed_arr = np.asarray(seeds, np.uint32)
    out, done = [], 0
    while done < total:
        step = min(total - done, bound)
        chunk = seed_arr if done == 0 else seed_arr ^ np.uint32((0x9E3779B9 * (done // bound)) & 0xFFFFFFFF)
        out.append((chunk, step))
        done += step
    return out


@pytest.mark.parametrize("nvars,L", [(256, 40), (65536, 40), (4096, 200)])
def test_chunk_plan_matches_jax_schedule(nvars, L):
    """Totals on both sides of the bound, in both modes (a 256-chain at
    L_tau=40 uses planes, the 256^2 torus rows: its bound is 104857 sweeps)."""
    rows = nvars * L * 4 > 2 * 1024 * 1024
    bound = wl.dispatch_bound(nvars, L)
    assert bound == ((1 << 23) // (2 * L) if rows else 1 << 23)
    if (nvars, L) == (65536, 40):
        assert rows and bound == 104857
    seeds = np.array([0, 1, -5, 2**31 - 1, -(2**31)], np.int32)
    for total in (0, 1, bound - 1, bound, bound + 1, 3 * bound + 17):
        want = _jax_schedule(total, L, rows, seeds)
        got = wl.chunk_plan(total, nvars, L)
        assert [s for _, s in got] == [s for _, s in want]
        for (index, _), (wseeds, _) in zip(got, want):
            np.testing.assert_array_equal(wl.chunk_seeds(seeds, index), wseeds)


def test_chunks_rekey_and_restart_the_counter(monkeypatch):
    """Past the bound, a run equals one dispatch per chunk with re-keyed seeds."""
    dense, R, L = ("ring", 8, -1.0), 2, 8
    s0, seeds = _inputs(13, R, 8, L)
    monkeypatch.setattr(wl, "_EXACT", 3)
    assert [n for _, n in wl.chunk_plan(7, 8, L)] == [3, 3, 1]
    s, e, _ = wl.run_wl_sweeps(torch.from_numpy(s0), seeds, 7, dense, 1.0, 1.0, 0.0, L)
    tables = wl.make_tables(dense, 8, 1.0, 1.0, 0.0, L)
    x = torch.from_numpy(s0)
    for index, step in ((0, 3), (1, 3), (2, 1)):
        ks = torch.from_numpy(wl.chunk_seeds(seeds, index).view(np.int32))
        x, _, _ = wl.wl_sweeps(x, ks, tables, step)
    assert torch.equal(s, x)
    whole, _, _ = wl.wl_sweeps(torch.from_numpy(s0), torch.from_numpy(seeds), tables, 7)
    assert not torch.equal(whole, x)


@pytest.mark.parametrize("L", [4, 8, 30, 32, 34, 40, 64, 66, 100, 1026, 2050, 4096])
def test_xla_sum_order(L):
    """The frozen-ring total: equal to the f32 ``jnp.sum`` of the JAX kernel."""
    x = np.random.default_rng(L).standard_normal((5, L)).astype(np.float32)
    want = np.asarray(jax.jit(lambda a: jnp.sum(a, axis=0, keepdims=True))(x.T))[0]
    np.testing.assert_array_equal(wl.xla_sum_last(torch.from_numpy(x)).numpy(), want)


def test_wrapper_checks():
    tables = wl.make_tables(("ring", 8, -1.0), 8, 1.0, 1.0, 0.0, 8)
    s = torch.ones((2, 8, 8), dtype=torch.int8)
    seeds = torch.zeros(2, dtype=torch.int32)
    wl.wl_sweeps(s, seeds, tables, 1)
    bad = [
        (s.to(torch.int32), seeds, tables, 1, {}),
        (torch.ones((2, 8, 10), dtype=torch.int8), seeds, tables, 1, {}),
        (s, seeds.to(torch.int64), tables, 1, {}),
        (s, seeds[:1], tables, 1, {}),
        (s, seeds, tables, 3, dict(freq=2, nsamples=2)),
        (s, seeds, tables, 3, dict(freq=0, nsamples=1)),
        (s.transpose(1, 2), seeds, tables, 1, {}),
    ]
    for args in bad:
        with pytest.raises(ValueError):
            wl.wl_sweeps(*args[:4], **args[4])
    assert wl.gate(("ring", 8, -1.0), 8, 8) is None
    for dense, nvars, L in [(None, 8, 8), (("ring", 8, -1.0), 8, 6 + 1), (("ring", 8, -1.0), 8, 2),
                            (("ring", 8, -1.0), 8, wl.MAX_PLANE_BYTES // 32 + 2), (("torus", 5, -1.0), 25, 8)]:
        assert wl.gate(dense, nvars, L) is not None


def test_launch_counter_untouched_on_cpu():
    """The counter counts kernel launches only: the plain version adds none."""
    tables = wl.make_tables(("ring", 8, -1.0), 8, 1.0, 1.0, 0.0, 8)
    before = wl.wl_sweeps.launches
    wl.wl_sweeps(torch.ones((1, 8, 8), dtype=torch.int8), torch.zeros(1, dtype=torch.int32), tables, 2)
    assert wl.wl_sweeps.launches == before


@pytest.mark.parametrize("n,seed", [(4, 0), (6, 1)])
def test_energy_matches_dense_diagonalization(n, seed):
    """The plain version's <E> on a ring (J=-1, Gamma=1, beta=2) within 4
    standard errors plus the Trotter allowance of tests/test_worldline_exact.py."""
    edges = [((i, (i + 1) % n), -1.0) for i in range(n)]
    exact = dense_tfim_energy(edges, 0.0, 1.0, 2.0, n)
    lat = Lattice(edges, seed_gen=seed, device="cpu")
    lat.set_transverse_field(1.0)
    es, _ = lat.run_quantum_monte_carlo_sampling(2.0, 200, 64, sampling_wait_buffer=100)
    m, se = es.mean(), es.std(ddof=1) / np.sqrt(len(es))
    assert abs(m - exact) < 4 * se + 0.03, (m, exact, se)
