"""The ladder kernel's plain version, the long-line cluster algorithm and the
kernel route at time lines past 4096 slices, up to the JAX kernel's gate
(nvars * L_tau up to 10^6: L_tau = 250,000 on the 4-ring).

- ``ladder_sweeps_reference`` against the JAX Pallas kernel
  (``wl_ladder_pallas.ladder_sweep``) in interpret mode, R = 2, 2 sweeps: the
  8-ring at L_tau = 5120, the 16-ring at 40,960 and a 6^2 +-J torus at 20,000.
- ``ladder.gate`` against the JAX kernel's rule (``supported_ladder``, whose
  platform test refuses the CPU, so the rule is read from ``_MAX_POINTS``) on
  a grid of shapes on both sides of each edge, at replica counts past 2^31
  spins and past 65,535 replicas, which neither rule reads; a
  ``LatticeTempering`` ladder chooses the kernel route at such counts (its
  decision reads shapes only: no plane built).
- The numpy model (``fk_long_model.py``) of the cluster phase that
  ``csrc/worldline.cuh`` runs for a line too long for one block
  (``fk_long_sums`` and ``fk_long_apply``, two launches a color: segments of
  1024 slices and a halo, the last head before a segment by a look-back,
  leaves of 256 slices summed where they start, each head folding its
  leaves onto its tail, a fully frozen line in XLA's order) against
  ``wl.fk_flips``, at L_tau = 40,960 and 2^20: random frozen
  bonds (runs past 256 and 2^k slices, runs round the ring), lines with a
  single thawed bond (one run of L_tau slices), fully frozen lines. It
  checks the algorithm, not the kernel, and is a second copy of it that can
  drift from the CUDA source: the kernel runs only on the card, where
  ``chip_smoke.py`` compare-longline holds it to the plain version bit for bit.
- ``Lattice`` on the 8-ring at beta = 256 (L_tau = 5120, past the resident
  and tiled routes) takes the kernel route, and its <E> lies within 4 standard
  errors plus the Trotter allowance of tests/test_worldline_exact.py of dense
  diagonalization.

Tolerance: none, but for the <E> of the last test.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")
from jax.experimental.pallas import tpu as pltpu

from fk_long_model import LEAF, fk_long_model
from helpers import dense_tfim_energy
from pyisingmontecarlo_tpu.graph import grid_2d_edges
from pyisingmontecarlo_tpu.ops import wl_ladder_pallas as wlp
from pyisingmontecarlo_tpu_torch import Lattice
from pyisingmontecarlo_tpu_torch import rng as trng
from pyisingmontecarlo_tpu_torch.ops import ladder, wl

torch.set_num_threads(1)


def _edges(kind, size):
    if kind == "ring":
        return np.arange(size), (np.arange(size) + 1) % size
    g = grid_2d_edges(size, size)
    return np.array([a for (a, _), _ in g]), np.array([b for (_, b), _ in g])


LADDER_CASES = [
    # name, kind, size, betas, gammas, hs, L (dtau = beta / L)
    ("ring8 L=5120", "ring", 8, [200.0, 256.0], [1.0, 1.2], [0.0, -0.1], 5120),
    ("ring16 L=40960", "ring", 16, [1500.0, 2048.0], [1.0, 0.8], [0.1, 0.0], 40960),
    ("torus6 +-J L=20000", "torus", 6, [800.0, 1000.0], [1.0, 1.0], [0.0, 0.2], 20000),
]


@pytest.mark.parametrize("case", LADDER_CASES, ids=[c[0] for c in LADDER_CASES])
def test_ladder_reference_equals_jax_kernel(case):
    name, kind, size, betas, gammas, hs, L = case
    nvars = size if kind == "ring" else size * size
    assert ladder.gate((kind, size), nvars, L, 2) is None
    ea, eb = _edges(kind, size)
    jv = np.random.default_rng(len(name)).choice([-1.0, 1.0], len(ea))
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


REPLICAS = (1, 511, 512, 656, 8590, 65536, 10**6)


def _tpu_rule(kind, size, nvars, ltau):
    """``wl_ladder_pallas.supported_ladder`` without its platform test."""
    if ltau < 4 or ltau % 2 or nvars % 2 or (kind == "torus" and size % 2):
        return False
    return ltau * nvars <= wlp._MAX_POINTS


def test_gate_equals_tpu_rule():
    admitted = 0
    for kind, size in (("ring", 4), ("ring", 8), ("ring", 16), ("ring", 144), ("ring", 9), ("torus", 6),
                       ("torus", 12), ("torus", 64), ("torus", 7)):
        nvars = size if kind == "ring" else size * size
        edge = wlp._MAX_POINTS // nvars
        for L in {2, 3, 4, 5, 6, 4096, 4098, 5120, edge - 2, edge - 1, edge, edge + 1, edge + 2, 2 * edge}:
            for R in REPLICAS:
                got = ladder.gate((kind, size), nvars, L, R) is None
                assert got == _tpu_rule(kind, size, nvars, L), (kind, size, L, R)
            admitted += got
    assert admitted > 20
    assert ladder.gate(("ring", 4), 4, 250000) is None  # the 4-ring at the gate's edge
    assert ladder.gate(("ring", 4), 4, 250002) is not None
    # past 2^31 spins in all (R = 8590 at 10^6 spins a replica) and past one launch's 65,535 replicas: the
    # wrapper splits the replicas into launches
    for R in REPLICAS:
        assert ladder.gate(("ring", 4), 4, 250000, R) is None
        assert ladder.gate(("torus", 12), 144, 5120, R) is None


def _tempering(edges, R, beta):
    from pyisingmontecarlo_tpu_torch import LatticeTempering

    lt = LatticeTempering(edges, seed=1, device="cpu")
    for r in range(R):
        lt.add_graph(1.0, 0.0, beta)
    return lt


def test_tempering_takes_the_kernel_at_any_replica_count():
    ring4 = [((i, (i + 1) % 4), -1.0) for i in range(4)]
    lt = _tempering(ring4, 8590, 12500.0)  # dtau = 0.05: L_tau = 250,000, the gate's edge; 8.6e9 spins
    assert lt._ltau() == 250000 and lt._on_kernel()
    g = grid_2d_edges(12, 12)
    glass = [(e, float(j)) for (e, _), j in zip(g, np.random.default_rng(0).choice([-1.0, 1.0], len(g)))]
    assert _tempering(glass, 2913, 256.0)._on_kernel()  # L_tau = 5120: 2.15e9 spins
    assert _tempering(ring4, 65600, 205.0)._on_kernel()  # L_tau = 4100: past one launch's 65,535 replicas
    # the 4-ring at L_tau = 2^20, R = 512: off the kernel by the spins a replica (4 x 2^20 past 10^6), as in
    # the JAX package, whatever R
    assert not _tempering(ring4, 512, 12500.0)._on_kernel(1 << 20)
    assert not _tpu_rule("ring", 4, 4, 1 << 20)


def _lines(L, seed):
    """``(active, de, log_u)`` of 16 lines ``[RN, L]``: random frozen bonds at
    densities from 0.3 to 0.9999 (runs past 256 and past 2^k slices, runs
    round the ring), fully frozen lines, and lines with one thawed bond (at 0,
    L - 2, L - 1, 1, L / 2 or 1023, the end of a segment)."""
    rng = np.random.default_rng(seed)
    active = np.concatenate([rng.random((1, L)) < p for p in (0.3, 0.9, 0.99, 0.995, 0.999, 0.9999, 0.99995)])
    frozen = np.ones((3, L), bool)
    single = np.ones((6, L), bool)
    for r, t in enumerate((0, L - 2, L - 1, 1, L // 2, 1023)):
        single[r, t] = False
    active = np.concatenate([active, frozen, single]).astype(np.int32)
    RN = active.shape[0]
    table = np.float32([-0.4, -0.2, -0.0, 0.0, 0.2, 0.4, 0.1, -0.1, 0.3, -0.3])
    de = np.where(rng.random((RN, L)) < 0.5, rng.choice(table, (RN, L)),
                  0.05 * rng.standard_normal((RN, L))).astype(np.float32)
    u = (rng.integers(0, 2**31, (RN, L)).astype(np.float32) + np.float32(0.5)) * np.float32(2.0**-31)
    return active, de, np.log(u).astype(np.float32)


@pytest.mark.parametrize("L", (40960, 1 << 20))
def test_long_line_model_equals_fk_flips(L):
    active, de, log_u = _lines(L, L)
    if L > 40960:  # fk_flips' 20 rounds dominate: half the lines, every kind among them
        keep = [0, 4, 6, 7, 10, 11, 12, 15]
        active, de, log_u = active[keep], de[keep], log_u[keep]
    want = wl.fk_flips(torch.from_numpy(active)[None], torch.from_numpy(de)[None],
                       torch.from_numpy(log_u)[None])[0].numpy()
    for r in range(active.shape[0]):
        np.testing.assert_array_equal(fk_long_model(active[r], de[r], log_u[r]), want[r], err_msg=f"line {r}")
    runs = [np.diff(np.nonzero(~np.roll(a.astype(bool), 1))[0]) for a in active if not a.all()]
    assert max(int(x.max()) for x in runs if len(x)) > 4 * LEAF  # heads fold several leaves
    assert want.any() and not want.all()


def test_lattice_long_ltau_takes_kernel_route_and_matches_dense():
    """The 8-ring at beta = 256 (J = -1, Gamma = 1): L_tau = 5120, which the
    gate admits and no resident or tiled plan takes, so the card would run the
    multi-launch kernels; here the plain version runs. <E> within 4 standard
    errors plus the Trotter allowance of tests/test_worldline_exact.py."""
    n, beta, R = 8, 256.0, 16
    edges = [((i, (i + 1) % n), -1.0) for i in range(n)]
    lat = Lattice(edges, seed_gen=1, device="cpu")
    lat.set_transverse_field(1.0)
    w = lat._worldline(R, beta)
    assert w.L == 5120 and w.on_kernel()
    es, _ = lat.run_quantum_monte_carlo_sampling(beta, 12, R, sampling_wait_buffer=8)
    exact = dense_tfim_energy(edges, 0.0, 1.0, beta, n)
    m, se = es.mean(), es.std(ddof=1) / np.sqrt(R)
    assert abs(m - exact) < 4 * se + 0.03, (m, se, exact)
