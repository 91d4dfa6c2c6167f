"""The worldline cluster phase at the multi-launch route's lengths (L_tau of
hundreds to thousands, where no tile of the tiled route fits).

- ``ops/wl.fk_flips`` against a numpy transcription of the JAX kernel's
  cluster phase (``pyisingmontecarlo_tpu/ops/wl_pallas.py:269-296``, whose
  fully frozen total is XLA's own ``jnp.sum``), and ``xla_sum_last`` against
  that sum, at L_tau = 34, 800, 1002 and 4096, with random frozen bonds,
  fully frozen lines and lines with a single thawed bond.
- A numpy model of the algorithm of ``csrc/worldline.cuh``'s ``fk_line``
  (a frozen line summed window by window, the pointer doubling stopped after
  the round that leaves no reach bit, each slice taking the decision of its
  nearest head, word by word) against ``fk_flips``, on the same inputs. It
  checks the algorithm, not the kernel, and is a second copy of it that can
  drift from the CUDA source: the kernel runs only on the card, where
  ``chip_smoke.py`` compare-wl and compare-ladder hold it to the plain
  version bit for bit at each group size it takes.
- ``xla_sum_last`` at the edges of XLA's windows of 32 (one window, one
  level of 32 windows, two levels, the longest line).
- ``run_wl_sweeps`` and ``ladder_sweeps_reference`` against the JAX Pallas
  kernels in interpret mode on a 4x4 torus and an 8-ring, R = 2, 2 sweeps,
  at L_tau = 800 and 1002 (not a multiple of 32), and with lines frozen whole.

Tolerance: none; every comparison is bit for bit (flips, spins, energies).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")
import jax
from jax.experimental.pallas import tpu as pltpu

from pyisingmontecarlo_tpu.graph import grid_2d_edges
from pyisingmontecarlo_tpu.ops import wl_ladder_pallas as wlp
from pyisingmontecarlo_tpu.ops import wl_pallas as wp
from pyisingmontecarlo_tpu_torch import rng as trng
from pyisingmontecarlo_tpu_torch.ops import ladder, wl

torch.set_num_threads(1)

LENGTHS = (34, 800, 1002, 4096)


def _xla_sum(de):
    """XLA's f32 sum over axis 0 of ``de[L, RN]``, as the JAX kernel's ``jnp.sum``."""
    return np.asarray(jax.jit(lambda a: jnp.sum(a, axis=0, keepdims=True))(de))


def _jax_cluster(active, de, log_u):
    """``wl_pallas.py:269-296`` on ``[L, RN]`` planes, in numpy (f32): which
    slices flip."""
    L = active.shape[0]
    ksteps = max(1, int(np.ceil(np.log2(L))))
    tau = np.arange(L)[:, None]
    acc, reach, k = de, active, 1
    for _ in range(ksteps):
        acc = (acc + np.where(reach == 1, np.roll(acc, -k, 0), np.float32(0.0))).astype(np.float32)
        reach = reach & np.roll(reach, -k, 0)
        k *= 2
    allact = np.broadcast_to(active.min(0, keepdims=True), active.shape)
    heads = np.where(allact == 1, (tau == 0).astype(np.int32), 1 - np.roll(active, 1, 0))
    acc = np.where(allact == 1, np.broadcast_to(_xla_sum(de), de.shape), acc)
    prop = np.where((heads == 1) & (log_u < -acc), 1, 0)
    cb, k = np.roll(active, 1, 0), 1
    for _ in range(ksteps):
        prop = prop | (np.roll(prop, k, 0) & cb)
        cb = cb & np.roll(cb, k, 0)
        k *= 2
    return prop == 1


def _fk_line(active, de, log_u):
    """``fk_line`` of ``csrc/worldline.cuh`` on one line, in numpy (f32):
    which slices flip, and the doubling rounds its sum ran."""
    L = len(active)
    W = -(-L // 32)
    K = int(np.ceil(np.log2(L)))
    if active.all():  # one cluster headed at 0: XLA's order, window by window
        if L <= 32:
            parts = de
        else:
            pad = np.zeros(32 * W, np.float32)  # the pads add +0
            pad[(32 * W - L) // 2:(32 * W - L) // 2 + L] = de
            parts = np.array([_in_order(pad[32 * v:32 * v + 32]) for v in range(W)], np.float32)
            if W > 32:
                n2 = -(-W // 32)
                x0 = 32 * np.arange(n2) - (32 * n2 - W) // 2
                parts = np.array([_in_order(parts[max(0, a):min(W, a + 32)]) for a in x0], np.float32)
        return np.full(L, log_u[0] < -_in_order(parts)), 0
    acc, reach, k, rounds = de.copy(), active.astype(bool), 1, 0
    for _ in range(K):  # no addition where reach is clear: the sum is left as it is
        u = (np.arange(L) + k) % L
        acc = np.where(reach, (acc + acc[u]).astype(np.float32), acc)
        reach = reach & reach[u]
        k *= 2
        rounds += 1
        if not reach.any():
            break
    heads = ~np.roll(active, 1).astype(bool)
    decide = heads & (log_u < -acc)
    # each slice takes the decision of its nearest head at or before it, cyclically, word by word
    hw = [int(np.packbits(heads[32 * w:32 * w + 32], bitorder="little").view("<u4")[0])
          if L - 32 * w >= 32 else sum(int(b) << j for j, b in enumerate(heads[32 * w:])) for w in range(W)]
    out = np.zeros(L, bool)
    for t in range(L):
        w, lane = divmod(t, 32)
        m, x = hw[w] & (0xFFFFFFFF >> (31 - lane)), w
        j = 1
        while not m:
            x = (w - j) % W
            m = hw[x]
            j += 1
        out[t] = decide[32 * x + m.bit_length() - 1]
    return out, rounds


def _in_order(v):
    tot = np.float32(0.0)
    for x in v:
        tot = np.float32(tot + x)
    return tot


def _lines(L, seed):
    """``(active, de, log_u)`` of 24 lines ``[RN, L]``: random frozen bonds
    at densities from 0.3 to 0.995 (runs past 2^k for several k), fully
    frozen lines, and lines whose one thawed bond is at 0, L - 2, L - 1 or
    in between. ``de`` takes the values of a cluster table (signed zeros
    among them) or normals; ``log_u`` is the log of an f32 uniform."""
    rng = np.random.default_rng(seed)
    dens = (0.3, 0.6, 0.9, 0.97, 0.99, 0.995)
    active = np.concatenate([(rng.random((2, L)) < p) for p in dens]).astype(np.int32)
    frozen = np.ones((4, L), np.int32)
    single = np.ones((8, L), np.int32)
    for r, t in enumerate((0, L - 2, L - 1, 1, L // 2, L // 3, 31 % L, 33 % L)):
        single[r, t] = 0
    active = np.concatenate([active, frozen, single])
    RN = active.shape[0]
    table = np.float32([-0.4, -0.2, -0.0, 0.0, 0.2, 0.4, 0.1, -0.1, 0.3, -0.3])
    de = np.where(rng.random((RN, L)) < 0.5, rng.choice(table, (RN, L)),
                  0.05 * rng.standard_normal((RN, L))).astype(np.float32)
    u = ((rng.integers(0, 2**31, (RN, L)).astype(np.float32) + np.float32(0.5)) * np.float32(2.0**-31))
    return active, de, np.log(u).astype(np.float32)


@pytest.mark.parametrize("L", LENGTHS)
def test_fk_flips_equals_jax_cluster_phase(L):
    active, de, log_u = _lines(L, L)
    want = _jax_cluster(active.T, de.T, log_u.T).T
    got = wl.fk_flips(torch.from_numpy(active)[None], torch.from_numpy(de)[None], torch.from_numpy(log_u)[None])
    np.testing.assert_array_equal(got[0].numpy(), want)
    assert want.any() and not want.all()
    frozen = active.min(1) == 1
    assert frozen.sum() >= 4 and (want[frozen].all(1) | ~want[frozen].any(1)).all()


# and the edges of XLA's windows of 32: one window, 32 windows (the last
# one-level length), 33 (two levels), the longest even line
@pytest.mark.parametrize("L", LENGTHS + (4, 32, 1024, 1026, 4094))
def test_xla_sum_last_equals_jnp_sum(L):
    _, de, _ = _lines(L, L + 1)
    np.testing.assert_array_equal(wl.xla_sum_last(torch.from_numpy(de)).numpy(), _xla_sum(de.T)[0])


@pytest.mark.parametrize("L", LENGTHS)
def test_group_emulation_equals_fk_flips(L):
    """The numpy model of fk_line's algorithm flips what fk_flips flips; its
    early stops cut rounds (at least on the sparse lines) and never change a
    sum. The kernel itself is held to the plain version on the card."""
    active, de, log_u = _lines(L, L + 2)
    want = wl.fk_flips(torch.from_numpy(active)[None], torch.from_numpy(de)[None],
                       torch.from_numpy(log_u)[None])[0].numpy()
    K = int(np.ceil(np.log2(L)))
    rounds = []
    for r in range(active.shape[0]):
        got, n = _fk_line(active[r], de[r], log_u[r])
        np.testing.assert_array_equal(got, want[r], err_msg=f"line {r}")
        rounds.append(n)
    assert min(rounds[:2]) < K  # density 0.3: the sum stops early
    assert max(rounds) <= K


def _jax_wl(s0, seeds, T, dense, beta, gamma, h, L):
    with pltpu.force_tpu_interpret_mode():
        s, e, _ = wp.run_wl_sweeps_pallas(jnp.asarray(s0), jnp.asarray(seeds), T, dense, beta, gamma, h, L)
    return np.asarray(s), np.asarray(e)


WL_CASES = {
    # name: (input seed, dense, L, beta, gamma, h); R = 2, T = 2
    "torus4 L=800": (1, ("torus", 4, -1.0), 800, 40.0, 1.0, 0.0),
    "torus4 L=1002": (2, ("torus", 4, -1.0), 1002, 50.1, 1.0, 0.2),
    "ring8 L=800": (3, ("ring", 8, -1.0), 800, 40.0, 1.0, -0.1),
    "ring8 L=1002": (4, ("ring", 8, -1.0), 1002, 50.1, 1.0, 0.0),
    # dtau * Gamma = 0.001: p_bond ~ 0.999, lines frozen whole (XLA's order decides them)
    "ring8 frozen L=800": (5, ("ring", 8, 0.7), 800, 40.0, 0.02, 0.2),
}


@pytest.mark.parametrize("name", sorted(WL_CASES))
def test_run_wl_sweeps_equals_jax_kernel(name):
    seed, dense, L, beta, gamma, h = WL_CASES[name]
    nvars = dense[1] if dense[0] == "ring" else dense[1] ** 2
    rng = np.random.default_rng(seed)
    s0 = np.ascontiguousarray(np.broadcast_to((rng.integers(0, 2, (2, nvars, 1)) * 2 - 1).astype(np.int8),
                                              (2, nvars, L)))
    seeds = rng.integers(-(2**31), 2**31, 2).astype(np.int32)
    js, je = _jax_wl(s0, seeds, 2, dense, beta, gamma, h, L)
    ts, te, _ = wl.run_wl_sweeps(torch.from_numpy(s0), seeds, 2, dense, beta, gamma, h, L)
    np.testing.assert_array_equal(ts.numpy(), js)
    np.testing.assert_array_equal(te, je)
    assert (js != s0).mean() > 0.02, "spins barely moved"
    if "frozen" in name:
        assert (js == js[:, :, :1]).all(2).mean() > 0.3, "too few lines frozen whole"


def _edges(kind, size):
    if kind == "ring":
        return np.arange(size), (np.arange(size) + 1) % size
    g = grid_2d_edges(size, size)
    return np.array([a for (a, _), _ in g]), np.array([b for (_, b), _ in g])


LADDER_CASES = [
    # name, kind, size, betas, gammas, hs, L
    ("torus4 +-J L=800", "torus", 4, [30.0, 40.0], [1.0, 1.0], [0.0, 0.2], 800),
    ("torus4 +-J L=1002", "torus", 4, [40.0, 50.1], [1.0, 0.8], [0.1, 0.0], 1002),
    ("ring8 L=800", "ring", 8, [30.0, 40.0], [1.0, 1.2], [0.0, -0.1], 800),
    ("ring8 L=1002 frozen lines", "ring", 8, [50.1, 50.1], [0.02, 0.05], [0.2, 0.0], 1002),
]


@pytest.mark.parametrize("case", LADDER_CASES, ids=[c[0] for c in LADDER_CASES])
def test_ladder_reference_equals_jax_kernel(case):
    name, kind, size, betas, gammas, hs, L = case
    nvars = size if kind == "ring" else size * size
    ea, eb = _edges(kind, size)
    jv = np.random.default_rng(len(name)).choice([-1.0, 1.0], len(ea)) if kind == "torus" else np.full(size, -1.0)
    R, T = len(betas), 2
    kd = trng.key_data_from_seeds(np.random.default_rng(L).integers(0, 2**64, R, dtype=np.uint64))
    s0 = np.ascontiguousarray(np.broadcast_to(trng.random_states(kd, nvars)[:, :, None], (R, nvars, L)))
    seeds = []
    for _ in range(T):
        kd, sub = trng.split_all(kd)
        seeds.append(trng.seeds_from_key_data(sub))
    seeds = np.stack(seeds)
    jp = wlp.build_planes(kind, size, nvars, ea, eb, jv, betas, gammas, hs, L)
    s = jnp.asarray(s0)
    with pltpu.force_tpu_interpret_mode():
        for t in range(T):
            s = wlp.ladder_sweep(s, jnp.asarray(seeds[t]), jp, kind, size, nvars)
    want = np.asarray(s)
    planes = ladder.build_planes(kind, size, nvars, ea, eb, jv, betas, gammas, hs, L)
    edges = tuple(torch.from_numpy(np.asarray(e, np.int32)) for e in (ea, eb))
    got = ladder.ladder_sweeps_reference(torch.from_numpy(s0), torch.from_numpy(seeds), planes, T, edges)[0]
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != s0).mean() > 0.02, "spins barely moved"
    if "frozen" in name:
        assert (want == want[:, :, :1]).all(2).mean() > 0.3, "too few lines frozen whole"
