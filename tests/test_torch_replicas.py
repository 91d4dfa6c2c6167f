"""The replica axis of the port's kernel wrappers (``ops/replicas.py``): the
launches of a call split its replicas into chunks below each route's limits,
and a split call gives the bits of an unsplit one.

- ``replica_chunks`` on a grid of replica counts, shapes and routes: the
  fewest chunks, sizes within one of each other, every limit kept, the
  chunks covering ``[0, R)`` in order.
- With the limits made small (2 or 3 replicas a launch, or 3 replicas' spins
  a launch), R = 5 splits into 2 + 2 + 1 or 3 + 2. The wrappers on the CPU
  run their plain versions through the same split as the card's launches:
  ``sq2d.sweeps_2d`` (hashed draws, sampling, explicit randoms),
  ``wl.wl_sweeps`` (plain and sampling) and ``ladder.ladder_sweeps``
  (states and swap features) equal their unsplit calls, and the JAX
  package's kernels in interpret mode (the square torus's test mode also
  ``numpy_reference``).
- ``Lattice.run_monte_carlo(0.4, 2, 65536)`` on an 8 x 8 torus on the CPU,
  past the 65,535 replicas of one launch: 65,536 energies, each that of its
  state, the first rows those of a 2-replica call.

Tolerance: none; every comparison is bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")
from jax.experimental.pallas import tpu as pltpu

from pyisingmontecarlo_tpu.ops import lanerng as jl
from pyisingmontecarlo_tpu.ops import sq2d_pallas as sp
from pyisingmontecarlo_tpu.ops import wl_ladder_pallas as wlp
from pyisingmontecarlo_tpu.ops import wl_pallas as wp
from pyisingmontecarlo_tpu_torch import Lattice
from pyisingmontecarlo_tpu_torch import rng as trng
from pyisingmontecarlo_tpu_torch.graph import grid_2d_edges
from pyisingmontecarlo_tpu_torch.ops import lattice2d as l2d
from pyisingmontecarlo_tpu_torch.ops import ladder, replicas, sq2d, wl
from test_pallas_interpret import numpy_reference

torch.set_num_threads(1)

# the kernels' shapes of chip_smoke.py's compare-replicas, and shapes at each limit
SHAPES = [1, 16, 64, 1024, 4096, 4 * 4100, 4096 * 800, 144 * 5120, 4 << 20, 1 << 22, 1 << 20]
COUNTS = [0, 1, 2, 5, 511, 512, 656, 2048, 2913, 8590, 65535, 65536, 65600, 131071, 131072, 10**6, 3 * 10**6 + 7]


def _limits_kept(route, per, tiles, size):
    if route in ("sq2d", "multi"):
        return size <= 65535
    if route == "long":
        return size <= 65535 and (size * per < 2**31 or size == 1)
    if route == "wl_resident":
        return size <= 2**31 - 1 and 3 * (size - 1) + 2 <= 2**31 - 1
    if route == "ladder_resident":
        return size <= 2**31 - 1
    return size * tiles < 2**31 and 3 * (size - 1) + 2 <= 2**31 - 1  # wl_tiled


@pytest.mark.parametrize("route", replicas.ROUTES)
def test_replica_chunks_keep_the_limits(route):
    for per in SHAPES:
        for tiles in ((1, 9, 64, 1 << 20) if route == "wl_tiled" else (1,)):
            most = replicas.launch_replicas(route, per, tiles)
            assert most >= 1
            for R in COUNTS:
                chunks = replicas.replica_chunks(R, per, route, tiles)
                assert len(chunks) == -(-R // most)  # the fewest
                ends = [b for _, b in chunks]
                assert [a for a, _ in chunks] == ([0] + ends[:-1] if chunks else [])  # in order, no gap
                assert (ends[-1] if chunks else 0) == R
                sizes = [b - a for a, b in chunks]
                assert not sizes or max(sizes) - min(sizes) <= 1
                assert sizes == sorted(sizes, reverse=True)
                assert all(_limits_kept(route, per, tiles, n) for n in sizes), (route, per, tiles, R, sizes)


def test_replica_chunks_at_the_chip_shapes():
    assert replicas.replica_chunks(65536, 64, "sq2d") == [(0, 32768), (32768, 65536)]
    assert replicas.replica_chunks(65600, 32 * 32, "sq2d") == [(0, 32800), (32800, 65600)]
    assert replicas.replica_chunks(2048, 1024 * 1024, "sq2d") == [(0, 2048)]
    assert replicas.replica_chunks(65600, 4 * 4100, "multi") == [(0, 32800), (32800, 65600)]
    assert replicas.replica_chunks(656, 4096 * 800, "multi") == [(0, 656)]  # 2.15e9 spins, one launch
    assert replicas.replica_chunks(512, 4 << 20, "long") == [(0, 256), (256, 512)]  # fk_long_*: under 2^31 spins
    assert replicas.replica_chunks(511, 4 << 20, "long") == [(0, 511)]
    assert replicas.replica_chunks(2913, 144 * 5120, "multi") == [(0, 2913)]
    assert replicas.replica_chunks(65535, 64, "sq2d") == [(0, 65535)]
    with pytest.raises(ValueError, match="unknown route"):
        replicas.replica_chunks(4, 4, "grid")


# name -> (attribute, value given the spins of a replica) and the chunks of R = 5
SPLITS = {"2 replicas a launch": ("GRID_MAX", lambda per: 2, [2, 2, 1]),
          "3 replicas a launch": ("GRID_MAX", lambda per: 3, [3, 2]),
          "3 replicas' spins a launch": ("LONG_SPINS", lambda per: 3 * per + 1, [3, 2])}
R = 5


def _split(monkeypatch, name, per, route):
    attr, value, want = SPLITS[name]
    monkeypatch.setattr(replicas, attr, value(per))
    got = [b - a for a, b in replicas.replica_chunks(R, per, route)]
    assert got == want, got


def _sq2d_case(seed, L, T):
    rng = np.random.default_rng(seed)
    s0 = (rng.integers(0, 2, (R, L, L)) * 2 - 1).astype(np.int8)
    seeds = rng.integers(-(2**31), 2**31, R).astype(np.int32)
    rb = rng.integers(0, 2**31, (2 * T, L, L // 2), dtype=np.int64).astype(np.int32)
    return s0, seeds, rb


def _jax_thresholds(betas, j, h):
    import jax

    dE = jnp.asarray(sp._dE_values(j, h))
    f = jax.vmap(lambda b: (jax.nn.sigmoid(-b * dE) * 2147483647.0).astype(jnp.int32))
    return np.array(f(jnp.asarray(np.asarray(betas, np.float32))))


def _testbits(s0, rb, betas, j, h):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(sp.run_steps_2d_testbits(jnp.asarray(s0), rb, betas, j, h))


def _hash_planes(seed, L, T, ctr0):
    """The draws of one replica's T sweeps as explicit planes, from the JAX lane hash."""
    W = L // 2
    pos = (np.arange(L)[:, None] * W + np.arange(W)[None, :]).astype(np.int32)
    p1, p2 = jl.make_pos_mix(jnp.zeros((L, W), jnp.int32), jnp.asarray(pos), 0)
    seed_plane = jnp.full((L, W), seed, jnp.int32)
    return np.stack([np.asarray(jl.lane_draw31(seed_plane, p1, p2, jnp.int32(2 * (ctr0 + t) + p)))
                     for t in range(T) for p in (0, 1)])


SQ2D_SPLITS = ["2 replicas a launch", "3 replicas a launch"]


@pytest.mark.parametrize("split", SQ2D_SPLITS)
@pytest.mark.parametrize("mode", ["hash", "sampling", "explicit randoms"])
def test_sq2d_split_equals_unsplit_and_jax(monkeypatch, split, mode):
    L, T, ctr0, j, h = 8, 4, 3, 0.5, -0.3
    betas = np.array([0.3, 0.5, 0.7, 0.9], np.float32)
    s0, seeds, rb = _sq2d_case(len(split) + len(mode), L, T)
    thr = torch.from_numpy(_jax_thresholds(betas, j, h))
    args = dict(s=torch.from_numpy(s0), seeds_i32=torch.from_numpy(seeds), thr=thr, ctr0=ctr0,
                rb=torch.from_numpy(rb) if mode == "explicit randoms" else None,
                samples=2 if mode == "sampling" else None)
    whole = sq2d.sweeps_2d(**args)
    _split(monkeypatch, split, L * L, "sq2d")
    got = sq2d.sweeps_2d(**args)
    for g, w in zip(*((got, whole) if mode == "sampling" else ((got,), (whole,)))):
        assert g.dtype == torch.int8 and torch.equal(g, w)
    state = (got[0] if mode == "sampling" else got).numpy()
    if mode == "explicit randoms":
        for r in range(R):
            np.testing.assert_array_equal(state[r], _testbits(s0[r:r + 1], rb, betas, j, h)[0])
            np.testing.assert_array_equal(state[r], numpy_reference(s0[r], rb, betas, j, h))
    else:
        for r in (0, 1, 2, R - 1):  # each side of every boundary of both splits, and the ends
            planes = _hash_planes(int(seeds[r]), L, T, ctr0)
            np.testing.assert_array_equal(state[r], _testbits(s0[r:r + 1], planes, betas, j, h)[0])
            if mode == "sampling":
                np.testing.assert_array_equal(got[1][r, 0].numpy(),
                                              _testbits(s0[r:r + 1], planes[:4], betas[:2], j, h)[0])
    assert (state != s0).mean() > 0.1, "spins barely moved"


def _wl_case(seed, nvars, L):
    rng = np.random.default_rng(seed)
    s0 = (rng.integers(0, 2, (R, nvars, L)) * 2 - 1).astype(np.int8)
    return s0, rng.integers(-(2**31), 2**31, R).astype(np.int32)


WL_SPLITS = ["2 replicas a launch", "3 replicas' spins a launch"]


@pytest.mark.parametrize("split", WL_SPLITS)
@pytest.mark.parametrize("mode", ["plain", "sampling"])
def test_wl_split_equals_unsplit_and_jax(monkeypatch, split, mode):
    dense, nvars, L, beta, gamma, h = ("torus", 4, -1.0), 16, 8, 1.5, 0.8, -0.3
    s0, seeds = _wl_case(len(split) + len(mode), nvars, L)
    tables = wl.make_tables(dense, nvars, beta, gamma, h, L)
    freq, ns, T = (2, 2, 5) if mode == "sampling" else (0, 0, 4)
    whole = wl.wl_sweeps(torch.from_numpy(s0), torch.from_numpy(seeds), tables, T, freq, ns)
    _split(monkeypatch, split, nvars * L, "long")
    got = wl.wl_sweeps(torch.from_numpy(s0), torch.from_numpy(seeds), tables, T, freq, ns)
    for g, w in zip(got, whole):
        assert g.dtype == w.dtype and torch.equal(g, w)
    with pltpu.force_tpu_interpret_mode():
        if mode == "sampling":
            js, je, jsmp = wp.run_wl_sample_pallas(jnp.asarray(s0), jnp.asarray(seeds), freq, ns, T - freq * ns,
                                                   dense, beta, gamma, h, L)
        else:
            js, je, _ = wp.run_wl_sweeps_pallas(jnp.asarray(s0), jnp.asarray(seeds), T, dense, beta, gamma, h, L)
    if mode == "sampling":
        ts, te, tsmp = wl.run_wl_sample(torch.from_numpy(s0), seeds, freq, ns, T - freq * ns, dense, beta, gamma,
                                        h, L)
        np.testing.assert_array_equal(tsmp.numpy(), np.asarray(jsmp))
    else:
        ts, te, _ = wl.run_wl_sweeps(torch.from_numpy(s0), seeds, T, dense, beta, gamma, h, L)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(ts.numpy(), got[0].numpy())
    np.testing.assert_array_equal(te, np.asarray(je))
    assert (np.asarray(js) != s0).mean() > 0.1, "spins barely moved"


@pytest.mark.parametrize("split", WL_SPLITS)
def test_ladder_split_equals_unsplit_and_jax(monkeypatch, split):
    kind, size, nvars, L, T = "torus", 4, 16, 12, 3
    g = grid_2d_edges(size, size)
    ea, eb = np.array([a for (a, _), _ in g]), np.array([b for (_, b), _ in g])
    rng = np.random.default_rng(len(split))
    jv = np.where(rng.random((R, len(ea))) < 0.25, 0.0, rng.choice([-1.0, -0.5, 0.5, 1.0], (R, len(ea))))
    betas, gammas, hs = np.geomspace(0.4, 2.0, R), np.linspace(0.6, 1.2, R), np.linspace(-0.2, 0.3, R)
    kd = trng.key_data_from_seeds(rng.integers(0, 2**64, R, dtype=np.uint64))
    s0 = np.ascontiguousarray(np.broadcast_to(trng.random_states(kd, nvars)[:, :, None], (R, nvars, L)))
    seeds = []
    for _ in range(T):
        kd, sub = trng.split_all(kd)
        seeds.append(trng.seeds_from_key_data(sub))
    seeds = np.stack(seeds)
    planes = ladder.build_planes(kind, size, nvars, ea, eb, jv, betas, gammas, hs, L)
    edges = tuple(torch.from_numpy(np.asarray(e, np.int32)) for e in (ea, eb))
    whole = ladder.ladder_sweeps(torch.from_numpy(s0), torch.from_numpy(seeds), planes, T, edges)
    _split(monkeypatch, split, nvars * L, "long")
    got = ladder.ladder_sweeps(torch.from_numpy(s0), torch.from_numpy(seeds), planes, T, edges)
    for g, w in zip((got[0], *got[1]), (whole[0], *whole[1])):
        assert g.dtype == w.dtype and torch.equal(g, w)
    jp = wlp.build_planes(kind, size, nvars, ea, eb, jv, betas, gammas, hs, L)
    s = jnp.asarray(s0)
    with pltpu.force_tpu_interpret_mode():
        for t in range(T):
            s = wlp.ladder_sweep(s, jnp.asarray(seeds[t]), jp, kind, size, nvars)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(s))
    for g, w in zip(got[1], ladder.swap_features(torch.from_numpy(np.array(s)), *edges)):
        assert torch.equal(g, w)
    assert (np.asarray(s) != s0).mean() > 0.05, "spins barely moved"


def test_lattice_past_one_launch_of_replicas():
    """The 8 x 8 torus at 65,536 replicas: two launches' worth on the card,
    two chunks of the plain version here."""
    assert len(replicas.replica_chunks(65536, 64, "sq2d")) == 2
    lat = Lattice(grid_2d_edges(8, 8, -1.0), seed_gen=7, device="cpu")
    es, ss = lat.run_monte_carlo(0.4, 2, 65536)
    assert es.shape == (65536,) and ss.shape == (65536, 64)
    s = torch.from_numpy(np.where(ss, 1, -1).astype(np.int8).reshape(-1, 8, 8))
    np.testing.assert_array_equal(es, l2d.energy_2d(s, -1.0, 0.0).numpy().astype(np.float64))
    assert -128 <= es.min() and es.max() <= 128 and len(np.unique(es)) > 10
    es2, ss2 = Lattice(grid_2d_edges(8, 8, -1.0), seed_gen=7, device="cpu").run_monte_carlo(0.4, 2, 2)
    np.testing.assert_array_equal(es[:2], es2)
    np.testing.assert_array_equal(ss[:2], ss2)


def test_initial_torus_states_by_block(monkeypatch):
    """``random_states_2d`` draws a block of replicas at a time, which bounds
    its temporaries at any R: the states are those of one draw."""
    seeds = torch.from_numpy(np.random.default_rng(3).integers(-(2**31), 2**31, 7).astype(np.int32))
    whole = l2d.random_states_2d(seeds, 6)
    monkeypatch.setattr(l2d, "_DRAW_SITES", 2 * 36 + 5)  # 2 replicas a block: 2 + 2 + 2 + 1
    assert torch.equal(l2d.random_states_2d(seeds, 6), whole)
    assert whole.dtype == torch.int8 and set(whole.unique().tolist()) == {-1, 1}
